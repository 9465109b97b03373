"""Kernel naming hook for profiler timelines.

``annotate(name)`` opens an NVTX range (``torch.cuda.nvtx.range``) around the
enclosed region when a CUDA device is present, so the kernel dispatch path's
``demm/<op>/<backend>`` names show up on an attached profiler's timeline
(``torch.profiler`` records NVTX ranges as user annotations).  Without a CUDA
device it is a no-op.
"""

from __future__ import annotations

import contextlib

_nvtx_ok = None


def _nvtx_available() -> bool:
    global _nvtx_ok
    if _nvtx_ok is None:
        import torch

        _nvtx_ok = bool(torch.cuda.is_available())
    return _nvtx_ok


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed computation with an NVTX range (CUDA only)."""
    if not _nvtx_available():
        yield
        return
    import torch

    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()
