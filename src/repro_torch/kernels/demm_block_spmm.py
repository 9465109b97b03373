"""The two-level block spmm ``C = A_block @ B``: CUDA kernel wrapper, its plain
PyTorch version and the host-side packing adapter.

Replaces the TPU kernel ``demm_block_spmm_pallas``
(``kernels/demm_block_spmm.py`` of the JAX package).  A is packed by
``core.sparsity.pack_block``: per row block of ``block_r`` rows a list of
``a_max`` active M-groups (``active_groups``, level 1, the address stream)
and, per listed group and row, ``Ne`` ``{value, index}`` pairs (level 2).
The CUDA source is ``csrc/demm_block_spmm.cu`` (body in
``csrc/demm_block_spmm_common.cuh``): a thread block reads its row block's
group ids itself and stages only those groups' rows of B — groups missing
from the list are never read, which is the paper's decoupled read ports at
the device-memory boundary.  At serving batch sizes device-memory bandwidth
bounds it, as it bounds the xwT kernels.

Semantics shared by the kernel and :func:`demm_block_spmm_plain` (the TPU
kernel's): the packed values are rounded to B's dtype and slots of one (row
block, list slot, row) that share an index are summed in that dtype, in slot
order (``demm_xwT.scatter_groups``); every product and the sum over list slots
are float32, so a group listed twice (``a_max > G`` padding) adds after its
product; padded list slots (group 0, all-zero values) add exactly 0; C is
float32 and a ragged ``Cd`` is masked in the kernel, not padded.

B may be any strided view.  The serving caller passes ``B = xᵀ`` (a view of
the activations ``x (Bx, K)``); C then comes back as the transposed view of a
contiguous ``(Cd, R)`` tensor, so ``Cᵀ = x @ Wᵀ`` is contiguous and neither
``xᵀ`` nor ``Cᵀ`` is ever copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparsity import DEFAULT_BLOCK_R, SparsityConfig, pack_block
from repro_torch.kernels.demm_xwT import (
    _DTYPE_CODE,
    raise_on_launch_error,
    scatter_groups,
)


def pack_block_sparse(
    a: np.ndarray, cfg: SparsityConfig, block_r: int = DEFAULT_BLOCK_R,
    a_max: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side two-level packing — a numpy adapter over
    :func:`repro_torch.core.sparsity.pack_block`.

    Returns (active_groups (RB, A_max) int32,
             values (RB, A_max, block_r, Ne),
             indices (RB, A_max, block_r, Ne),
             a_max).
    """
    pw = pack_block(torch.from_numpy(np.asarray(a)), cfg, block_r=block_r,
                    a_max=a_max)
    return (pw.active_groups.numpy(), pw.values.numpy(), pw.indices.numpy(),
            pw.block_geom[1])


def check_block_args(active_groups, values, indices, b, cfg: SparsityConfig,
                     r: int, value_dtypes):
    """Shape/dtype/device/contiguity checks shared by the float and int8
    block wrappers.  Returns (rb, a_max, block_r, ne, k, cd)."""
    if values.ndim != 4 or b.ndim != 2:
        raise ValueError(f"expected values (RB, A_max, block_r, Ne) and B "
                         f"(K, Cd), got {tuple(values.shape)} and "
                         f"{tuple(b.shape)}")
    rb, a_max, block_r, ne = values.shape
    k, cd = b.shape
    if rb * block_r != r or ne != cfg.n_effective or k % cfg.m:
        raise ValueError(
            f"values {tuple(values.shape)} / B {tuple(b.shape)} do not fit "
            f"r={r} and the pattern {cfg.pattern_name()}: need RB*block_r == "
            f"r, Ne == n_effective and K % M == 0")
    if tuple(indices.shape) != tuple(values.shape):
        raise ValueError(f"indices {tuple(indices.shape)} do not match "
                         f"values {tuple(values.shape)}")
    if tuple(active_groups.shape) != (rb, a_max):
        raise ValueError(f"active_groups {tuple(active_groups.shape)} must "
                         f"be (RB, A_max) = {(rb, a_max)}")
    if cd < 1:
        raise ValueError("B needs at least one column")
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"B must be float32 or bfloat16, got {b.dtype}")
    if values.dtype not in value_dtypes:
        raise TypeError(f"packed values must be one of {value_dtypes}, got "
                        f"{values.dtype}")
    for name, t in (("indices", indices), ("active_groups", active_groups)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("values", values), ("indices", indices),
                    ("active_groups", active_groups)):
        if t.device != b.device:
            raise ValueError(f"{name} on {t.device}, B on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rb, a_max, block_r, ne, k, cd


def block_output(b: torch.Tensor, r: int) -> torch.Tensor:
    """An empty float32 C (R, Cd) in B's orientation: for a column-major B
    (``B = xᵀ``) the transposed view of a contiguous (Cd, R) tensor."""
    cd = b.shape[1]
    if b.stride(0) == 1 and cd > 1:
        return torch.empty((cd, r), dtype=torch.float32, device=b.device).T
    return torch.empty((r, cd), dtype=torch.float32, device=b.device)


def block_scatter_dense(active_groups: torch.Tensor, s: torch.Tensor, k: int,
                        r: int) -> torch.Tensor:
    """Add the scatter rows ``s (RB, A_max, block_r, M)`` float32 of every
    list slot into the dense (R, K) float32 matrix at the group its slot
    names (a group listed twice adds twice)."""
    rb, a_max, block_r, m = s.shape
    dense = torch.zeros((rb, block_r, k // m, m), dtype=torch.float32,
                        device=s.device)
    ids = active_groups.to(torch.int64)[:, None, :, None].expand(
        rb, block_r, a_max, m)
    dense.scatter_add_(2, ids, s.transpose(1, 2))
    return dense.reshape(r, k)


def demm_block_spmm_plain(active_groups: torch.Tensor, values: torch.Tensor,
                          indices: torch.Tensor, b: torch.Tensor,
                          cfg: SparsityConfig, *, r: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the scatter rows in B's dtype,
    added into the dense (R, K) matrix in float32, then a float32 matmul.
    Not a copy of ``ref.block_spmm_ref``, which keeps full precision."""
    s = scatter_groups(values, indices, cfg.m, b.dtype)      # (RB,A,br,M)
    a = block_scatter_dense(active_groups, s, b.shape[0], r)
    return a @ b.to(torch.float32)


def demm_block_spmm(active_groups: torch.Tensor, values: torch.Tensor,
                    indices: torch.Tensor, b: torch.Tensor,
                    cfg: SparsityConfig, *, r: int, duplicates: bool = True,
                    rows_per_block: Optional[int] = None) -> torch.Tensor:
    """C (R, Cd) float32 = A_block @ B; values/indices (RB, A_max, block_r,
    Ne) float32 or bfloat16 / int32, active_groups (RB, A_max) int32, B (K,
    Cd) float32 or bfloat16 in any strides.

    A CUDA tensor launches the hand-written kernel (building the library at
    first use) or raises; a CPU tensor takes :func:`demm_block_spmm_plain`,
    and only because it lies on the CPU.  ``duplicates=False`` promises that
    no (row, list slot) holds two non-zero slots at one index
    (``PackedWeight.has_duplicates``) and skips the kernel's summing search.
    ``rows_per_block`` (rows per thread block, dividing 256) is the kernel's
    tunable; left open, the launcher sizes it to the card.
    """
    rb, a_max, block_r, ne, k, cd = check_block_args(
        active_groups, values, indices, b, cfg, r,
        (torch.float32, torch.bfloat16))
    if not b.is_cuda:
        return demm_block_spmm_plain(active_groups, values, indices, b, cfg,
                                     r=r)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    c = block_output(b, r)
    code = lib.demm_block_spmm_launch(
        active_groups.data_ptr(), values.data_ptr(), indices.data_ptr(),
        b.data_ptr(), c.data_ptr(), r, k, cd, rb, a_max, block_r, cfg.m, ne,
        a_max * block_r * ne, block_r * ne, ne, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), 1, _DTYPE_CODE[b.dtype],
        _DTYPE_CODE[values.dtype], int(bool(duplicates)),
        int(rows_per_block or 0), b.device.index,
        torch.cuda.current_stream(b.device).cuda_stream)
    raise_on_launch_error(code, "demm_block_spmm")
    demm_block_spmm.launches += 1
    return c


demm_block_spmm.launches = 0     # kernel launches (not plain-version calls)
