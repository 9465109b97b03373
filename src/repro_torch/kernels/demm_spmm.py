"""The paper-orientation spmm ``C = A_sparse @ B`` from the row-packed
stream: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``demm_spmm_pallas`` (``kernels/demm_spmm.py`` of the
JAX package): A (R, K) packed as values/indices (R, G, Ne), B (K, Cd) dense,
C (R, Cd) float32.  There is no CUDA source of its own: it is the block spmm
body (``csrc/demm_block_spmm.cu``) run as one row block of all R rows with the
identity address stream (list slot j is group j, ``a_max = G``) and the
row-packed strides (row ``G·Ne``, group ``Ne``) — nothing is repacked.  The
thread blocks' lanes then take neighbouring groups of one row, whose pairs are
adjacent, so the loads stay coalesced.

Semantics shared by the kernel and :func:`demm_spmm_plain` (the TPU
kernel's): the packed values are rounded to B's dtype, slots of one (row,
group) that share an index are summed in that dtype in slot order, products
and sums are float32, C is float32, ragged shapes are masked in the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels.demm_block_spmm import block_output
from repro_torch.kernels.demm_xwT import (
    _DTYPE_CODE,
    raise_on_launch_error,
    scatter_groups,
)


def _check_spmm_args(values, indices, b, cfg: SparsityConfig):
    if values.ndim != 3 or b.ndim != 2:
        raise ValueError(f"expected values (R, G, Ne) and B (K, Cd), got "
                         f"{tuple(values.shape)} and {tuple(b.shape)}")
    r, g, ne = values.shape
    k, cd = b.shape
    if k != g * cfg.m or ne != cfg.n_effective:
        raise ValueError(
            f"values {tuple(values.shape)} / B {tuple(b.shape)} do not fit "
            f"the pattern {cfg.pattern_name()}: need K == G*M and Ne == "
            f"n_effective")
    if tuple(indices.shape) != tuple(values.shape):
        raise ValueError(f"indices {tuple(indices.shape)} do not match "
                         f"values {tuple(values.shape)}")
    if r < 1 or cd < 1:
        raise ValueError("A and B need at least one row and column")
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"B must be float32 or bfloat16, got {b.dtype}")
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"packed values must be float32 or bfloat16, got "
                        f"{values.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    for name, t in (("values", values), ("indices", indices)):
        if t.device != b.device:
            raise ValueError(f"{name} on {t.device}, B on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return r, g, ne, k, cd


def demm_spmm_plain(values: torch.Tensor, indices: torch.Tensor,
                    b: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the scatter rows in B's dtype
    form the dense (R, K) matrix, then a float32 matmul.  Not a copy of
    ``ref.spmm_ref``, which keeps the values at full precision."""
    r, g, _ = values.shape
    a = scatter_groups(values, indices, cfg.m, b.dtype).reshape(r, g * cfg.m)
    return a @ b.to(torch.float32)


def demm_spmm(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor,
              cfg: SparsityConfig, *, duplicates: bool = True,
              rows_per_block: Optional[int] = None) -> torch.Tensor:
    """C (R, Cd) float32 = A_sparse @ B; A packed (R, G, Ne), B (K, Cd) in
    any strides.

    A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
    takes :func:`demm_spmm_plain`, and only because it lies on the CPU.
    ``duplicates`` and ``rows_per_block`` as for ``demm_block_spmm``.
    """
    r, g, ne, k, cd = _check_spmm_args(values, indices, b, cfg)
    if not b.is_cuda:
        return demm_spmm_plain(values, indices, b, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    c = block_output(b, r)
    # one row block of all R rows, list slot j = group j (no address stream)
    code = lib.demm_block_spmm_launch(
        None, values.data_ptr(), indices.data_ptr(), b.data_ptr(),
        c.data_ptr(), r, k, cd, 1, g, r, cfg.m, ne,
        r * g * ne, ne, g * ne, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), 0, _DTYPE_CODE[b.dtype],
        _DTYPE_CODE[values.dtype], int(bool(duplicates)),
        int(rows_per_block or 0), b.device.index,
        torch.cuda.current_stream(b.device).cuda_stream)
    raise_on_launch_error(code, "demm_spmm")
    demm_spmm.launches += 1
    return c


demm_spmm.launches = 0     # kernel launches (not plain-version calls)
