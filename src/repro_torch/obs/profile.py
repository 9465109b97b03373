"""Kernel naming and opt-in profiling.

``annotate(name)`` opens an NVTX range (``torch.cuda.nvtx.range``) around the
enclosed region when a CUDA device is present, so the kernel dispatch path's
``demm/<op>/<backend>`` names show up on an attached profiler's timeline.
Inside an active :func:`profile` window it also opens a
``torch.profiler.record_function`` range, so host-side work (dispatch, the
decode step's capture) shows up on the trace :func:`profile` writes.  Without
a CUDA device and outside a window it is a no-op.

``profile(trace_dir)`` runs the enclosed region under ``torch.profiler``
(CPU activity, plus CUDA activity where a card is present) and writes a
Chrome/Perfetto trace, ``trace_dir/trace.json``, that ``ui.perfetto.dev`` or
``chrome://tracing`` opens::

    with obs.profile("/tmp/serve_trace"):
        engine.run_until_drained()

The kernels of a replayed CUDA graph appear in it like any other launch.
``launch/serve.py --profile-dir DIR`` is the CLI spelling.
"""

from __future__ import annotations

import contextlib
import os
import threading

TRACE_FILE = "trace.json"

_nvtx_ok = None
_state = threading.local()


def _nvtx_available() -> bool:
    global _nvtx_ok
    if _nvtx_ok is None:
        import torch

        _nvtx_ok = bool(torch.cuda.is_available())
    return _nvtx_ok


def profiling_active() -> bool:
    """True inside a :func:`profile` window (in this thread)."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def profile(trace_dir=None, *, enabled: bool = True):
    """Activate the profiling hooks for the enclosed region.

    With ``trace_dir`` set, the region runs under ``torch.profiler`` (the
    object is what the ``with`` yields, for ``key_averages()``), the device
    is synchronised at its end, and the trace is written to
    ``trace_dir/trace.json``.  Without it, only the ``record_function``
    ranges of :func:`annotate` are switched on (yields None) — useful when
    a profiler is already attached.
    """
    if not enabled:
        yield None
        return
    prof = None
    if trace_dir:
        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = torch_profile(activities=activities)
        prof.__enter__()
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield prof
    finally:
        _state.depth -= 1
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(str(trace_dir),
                                                  TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed computation: an NVTX range (CUDA only), plus a
    ``record_function`` range when a :func:`profile` window is active."""
    with contextlib.ExitStack() as stack:
        if _nvtx_available() or profiling_active():
            import torch

            if _nvtx_available():
                stack.enter_context(torch.cuda.nvtx.range(name))
            if profiling_active():
                stack.enter_context(torch.profiler.record_function(name))
        yield
