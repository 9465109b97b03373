"""The two-level block spmm ``C = A_block @ B``: CUDA kernel wrapper, its plain
PyTorch version and the host-side packing adapter.

Replaces the TPU kernel ``demm_block_spmm_pallas``
(``kernels/demm_block_spmm.py`` of the JAX package).  A is packed by
``core.sparsity.pack_block``: per row block of ``block_r`` rows a list of
``a_max`` active M-groups (``active_groups``, level 1, the address stream)
and, per listed group and row, ``Ne`` ``{value, index}`` pairs (level 2).
The CUDA source is ``csrc/demm_block_spmm.cu``, with two bodies picked by
:func:`block_body`:

* ``cluster`` (``csrc/demm_block_cluster.cuh``, K4's body) at serving batch,
  B = xᵀ with at most :data:`CLUSTER_MAX_CD` columns: a cluster of CTAs per
  row block, each requesting its contiguous slice of values and indices with
  bulk copies at entry and loading only its own groups' x segments with
  16-byte loads, the partial tiles added through distributed shared memory;
* ``gather`` (``csrc/demm_block_spmm_common.cuh``) otherwise: a thread block
  reads its row block's group ids itself and stages only those groups' rows
  of B.

Either way groups missing from the list are never read — the paper's
decoupled read ports at the device-memory boundary.  At serving batch sizes
device-memory bandwidth bounds both, as it bounds the xwT kernels.

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
    prefix_pitch,
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
    """Shape/dtype/device/layout checks shared by the float and int8 block
    wrappers: active_groups contiguous; values and indices contiguous, or
    prefix views of one stored pitch (a draft tier).  Returns (rb, a_max,
    block_r, ne, pitch, k, cd)."""
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
    if not active_groups.is_contiguous():
        raise ValueError("active_groups must be contiguous")
    pitch = prefix_pitch(values, "values")
    if prefix_pitch(indices, "indices") != pitch:
        raise ValueError(f"values and indices are stored at different "
                         f"pitches: {values.stride()} vs {indices.stride()}")
    return rb, a_max, block_r, ne, pitch, k, cd


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


# Widest B (activation rows) the cluster body takes: its partial tiles and
# register sums are sized for at most 8 columns (the launcher's ``cd <= 8``;
# a test holds the two equal).
CLUSTER_MAX_CD = 8


def cluster_fits(cd: int, m: int, block_r: int, ne: int, b_size: int,
                 value_size: int, b_col_stride: int) -> bool:
    """:func:`cluster_takes` on shapes and element sizes alone (B = xᵀ,
    every array 16-byte aligned): ``cd`` columns of B of ``b_size`` bytes,
    ``b_col_stride`` elements between them (x's row length K), values of
    ``value_size`` bytes, ``ne`` pairs stored per (list slot, row) (a tier
    view's stored pitch: its spans are copied whole).  The autotuner reads a
    problem's body here."""
    return (cd <= CLUSTER_MAX_CD
            and (cd == 1 or (b_col_stride * b_size) % 16 == 0)
            and (m * b_size) % 16 == 0
            and (block_r * ne * value_size) % 16 == 0
            and block_r % 4 == 0 and 256 % block_r == 0)


def cluster_takes(values: torch.Tensor, indices: torch.Tensor,
                  b: torch.Tensor, m: int,
                  scales: Optional[torch.Tensor] = None) -> bool:
    """What the bulk-copy cluster body (``csrc/demm_block_cluster.cuh``, K2's
    and K4's) can take, for 1-, 2- and 4-byte values alike: B = xᵀ (B's rows,
    x's columns, contiguous) of at most :data:`CLUSTER_MAX_CD` columns; x's
    rows, every copied span and every array 16-byte aligned — ``M``
    activations, a (list slot, row block)'s ``block_r·Ne`` values (``block_r
    ·Ne·value bytes``) and, as ``block_r`` is a multiple of 4, its indices and
    its ``block_r`` scales; ``block_r`` a power of two up to 256.  The C++
    ``cluster_takes`` refuses what lies outside this."""
    block_r, ne = values.shape[-2], prefix_pitch(values, "values")
    arrays = (values, indices, b) + (() if scales is None else (scales,))
    return (b.stride(0) == 1
            and cluster_fits(b.shape[1], m, block_r, ne, b.element_size(),
                             values.element_size(), b.stride(1))
            and all(t.data_ptr() % 16 == 0 for t in arrays))


def block_body(active_groups: Optional[torch.Tensor], values: torch.Tensor,
               indices: torch.Tensor, b: torch.Tensor, m: int) -> str:
    """Which CUDA body :func:`demm_block_spmm` runs: ``"cluster"`` in the
    block layout (``active_groups`` given, values (RB, A_max, block_r, Ne))
    where :func:`cluster_takes` holds — serving batch, B = xᵀ — and
    ``"gather"`` otherwise, always for the row-packed layout that K5 runs
    through the same launcher with the identity address stream.  This is the
    one statement of the rule: the CUDA launcher only refuses what the
    cluster body cannot take."""
    if (active_groups is not None and values.ndim == 4
            and cluster_takes(values, indices, b, m)):
        return "cluster"
    return "gather"


def demm_block_spmm(active_groups: torch.Tensor, values: torch.Tensor,
                    indices: torch.Tensor, b: torch.Tensor,
                    cfg: SparsityConfig, *, r: int, duplicates: bool = True,
                    rows_per_block: Optional[int] = None,
                    cluster_size: Optional[int] = None) -> torch.Tensor:
    """C (R, Cd) float32 = A_block @ B; values/indices (RB, A_max, block_r,
    Ne) float32 or bfloat16 / int32, active_groups (RB, A_max) int32, B (K,
    Cd) float32 or bfloat16 in any strides.

    A CUDA tensor launches the hand-written kernel (building the library at
    first use; the body :func:`block_body` names) or raises; a CPU tensor
    takes :func:`demm_block_spmm_plain`, and only because it lies on the CPU.
    ``duplicates=False`` promises that no (row, list slot) holds two non-zero
    slots at one index (``PackedWeight.has_duplicates``) and skips the
    kernel's summing search.  ``values`` and ``indices`` may be a draft
    tier's prefix view ``[..., :t]`` (``demm_xwT.prefix_pitch``), read in
    place at their stored pitch.  ``rows_per_block`` (rows per thread block,
    dividing 256) tunes the gather body, ``cluster_size`` (CTAs per row
    block, 1-8) the cluster body; left open, the launcher sizes them to the
    card.
    """
    return demm_block_spmm_on(None, active_groups, values, indices, b, cfg,
                              r=r, duplicates=duplicates,
                              rows_per_block=rows_per_block,
                              cluster_size=cluster_size)


def demm_block_spmm_on(body: Optional[str], active_groups: torch.Tensor,
                       values: torch.Tensor, indices: torch.Tensor,
                       b: torch.Tensor, cfg: SparsityConfig, *, r: int,
                       duplicates: bool = True,
                       rows_per_block: Optional[int] = None,
                       cluster_size: Optional[int] = None) -> torch.Tensor:
    """:func:`demm_block_spmm` on a named body (``"cluster"``, only where
    :func:`block_body` picks it, or ``"gather"``; ``None``: the chosen one)
    — a measurement hook for timing one body against the other
    (``chip_smoke.py --sweep``), not a serving entry point.  A launch counts
    on ``demm_block_spmm.launches``."""
    rb, a_max, block_r, ne, pitch, k, cd = check_block_args(
        active_groups, values, indices, b, cfg, r,
        (torch.float32, torch.bfloat16))
    chosen = block_body(active_groups, values, indices, b, cfg.m)
    if body not in (None, "cluster", "gather"):
        raise ValueError(f"body must be 'cluster' or 'gather', got {body!r}")
    if body == "cluster" and chosen != "cluster":
        raise ValueError("the cluster body does not take these arguments "
                         "(block_body)")
    if not b.is_cuda:
        return demm_block_spmm_plain(active_groups, values, indices, b, cfg,
                                     r=r)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    c = block_output(b, r)
    # 0: the gather body; -1: the cluster body, its size left to the launcher
    cluster = (int(cluster_size or -1) if (body or chosen) == "cluster"
               else 0)
    code = lib.demm_block_spmm_launch(
        active_groups.data_ptr(), values.data_ptr(), indices.data_ptr(),
        b.data_ptr(), c.data_ptr(), r, k, cd, rb, a_max, block_r, cfg.m, ne,
        a_max * block_r * pitch, block_r * pitch, pitch, b.stride(0),
        b.stride(1),
        c.stride(0), c.stride(1), 1, _DTYPE_CODE[b.dtype],
        _DTYPE_CODE[values.dtype], int(bool(duplicates)),
        int(rows_per_block or 0), cluster, b.device.index,
        torch.cuda.current_stream(b.device).cuda_stream)
    raise_on_launch_error(code, "demm_block_spmm")
    demm_block_spmm.launches += 1
    demm_block_spmm.body_launches[body or chosen] += 1
    return c


demm_block_spmm.launches = 0     # kernel launches (not plain-version calls)
demm_block_spmm.body_launches = {"cluster": 0, "gather": 0}   # the same, by body
