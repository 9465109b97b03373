"""The paper-orientation spmm ``C = A_sparse @ B`` from the row-packed
stream: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``demm_spmm_pallas`` (``kernels/demm_spmm.py`` of the
JAX package): A (R, K) packed as values/indices (R, G, Ne), B (K, Cd) dense,
C (R, Cd) float32.  Two CUDA bodies, picked by :func:`spmm_body`:

* ``tiled`` (``csrc/demm_spmm_tc.cu``, body ``csrc/demm_spmm_tc.cuh``) for a
  bfloat16 B of at least :data:`TILED_MIN_CD` columns whose rows are
  contiguous and 16-byte aligned: the TPU kernel's own shape on Hopper — per
  group a TMA-staged B tile and a scatter tile S built in shared memory, one
  ``wgmma`` tile product per group into float32 registers.  The dense tile
  product is its floor; on the H100 the placing of the pairs into S holds
  it well above that (``PERF.md``).
* ``gather`` — every other B (float32, which tensor cores would compute in
  TF32; few columns, where it beats the dense product; strided or misaligned
  rows): the block spmm body (``csrc/demm_block_spmm.cu``) run as one row
  block of all R rows with the identity address stream (list slot j is group
  j, ``a_max = G``) and the row-packed strides — nothing is repacked.

Semantics shared by both bodies and :func:`demm_spmm_plain` (the TPU
kernel's): the packed values are rounded to B's dtype, slots of one (row,
group) that share an index are summed in that dtype in slot order, products
and sums are float32, C is float32, ragged shapes are masked in the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


# The tiled body's limits: B columns from which it is chosen (below, the
# gather body is faster and the tile mostly empty; measured on the H100,
# `chip_smoke.py --sweep`), the widest group (stages of the tile must fit
# shared memory) and the most pairs per (row, group) its summing search
# holds in registers (``kTcMaxM`` / ``kTcMaxNe`` in ``csrc/demm_spmm_tc.cuh``;
# a test holds the two equal).
TILED_MIN_CD = 64
TILED_MAX_M = 128
TILED_MAX_NE = 8


def tiled_fits(g: int, ne: int, m: int, b_bf16: bool, b_row_bytes: int,
               value_size: int) -> bool:
    """:func:`_tiled_takes` on shapes and element sizes alone (B's rows
    contiguous, every array 16-byte aligned): ``b_row_bytes`` bytes between
    B's rows, values of ``value_size`` bytes.  The autotuner reads a
    problem's body here."""
    return (b_bf16 and b_row_bytes % 16 == 0
            and (g * ne * value_size) % 16 == 0 and (g * ne * 4) % 16 == 0
            and m <= TILED_MAX_M and ne <= TILED_MAX_NE)


def _tiled_takes(values: torch.Tensor, indices: torch.Tensor,
                 b: torch.Tensor, m: int) -> bool:
    """What the tiled body can take at all — the terms of its tensor maps and
    of ``wgmma``: a bfloat16 B (K, Cd) whose rows are contiguous and 16-byte
    aligned; values and indices whose rows (G·Ne pairs) are 16-byte aligned;
    groups of at most ``TILED_MAX_M`` columns; at most ``TILED_MAX_NE``
    pairs."""
    g, ne = values.shape[1], values.shape[2]
    return (b.ndim == 2 and b.stride(1) == 1
            and tiled_fits(g, ne, m, b.dtype == torch.bfloat16,
                           b.stride(0) * b.element_size(),
                           values.element_size())
            and all(t.data_ptr() % 16 == 0 for t in (b, values, indices)))


def spmm_body(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor,
              m: int) -> str:
    """Which CUDA body :func:`demm_spmm` runs: ``"tiled"`` when the tiled
    body takes the arguments (:func:`_tiled_takes`) and B has at least
    ``TILED_MIN_CD`` columns, ``"gather"`` otherwise.  A float32 B stays on
    ``gather`` because tensor cores would compute it in TF32 and change the
    numbers; so does a strided or misaligned one, and a narrow one, where the
    gather body beats the dense product.  This is the one statement of the
    rule: the CUDA launcher only refuses what its body cannot take."""
    if _tiled_takes(values, indices, b, m) and b.shape[1] >= TILED_MIN_CD:
        return "tiled"
    return "gather"


def demm_spmm(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor,
              cfg: SparsityConfig, *, duplicates: bool = True,
              rows_per_block: Optional[int] = None,
              tile: Optional[Tuple[int, int]] = None,
              stages: Optional[int] = None) -> torch.Tensor:
    """C (R, Cd) float32 = A_sparse @ B; A packed (R, G, Ne), B (K, Cd) in
    any strides.

    A CUDA tensor launches the hand-written kernel (the body
    :func:`spmm_body` names) or raises; a CPU tensor takes
    :func:`demm_spmm_plain`, and only because it lies on the CPU.
    ``duplicates`` as for ``demm_block_spmm`` (both bodies: ``False`` skips
    the summing search) and ``rows_per_block`` (the gather body's).  The
    tiled body's tunables: ``tile`` = (columns per thread block, 128 or 256;
    consumer warpgroups of 64 rows, 1 or 2) and ``stages`` (2-4); left open,
    the launcher sizes them to the card.
    """
    return demm_spmm_on(None, values, indices, b, cfg, duplicates=duplicates,
                        rows_per_block=rows_per_block, tile=tile,
                        stages=stages)


def demm_spmm_on(body: Optional[str], values: torch.Tensor,
                 indices: torch.Tensor, b: torch.Tensor, cfg: SparsityConfig,
                 *, duplicates: bool = True,
                 rows_per_block: Optional[int] = None,
                 tile: Optional[Tuple[int, int]] = None,
                 stages: Optional[int] = None,
                 groups_per_stage: Optional[int] = None) -> torch.Tensor:
    """:func:`demm_spmm` with the choices it leaves to the launcher fixed —
    a measurement hook (``chip_smoke.py --sweep``, the card-only tests), not
    a serving entry point.  ``body`` (``"tiled"``, only where
    :func:`_tiled_takes` holds, or ``"gather"``; ``None``:
    :func:`spmm_body`'s) and the tiled body's ``groups_per_stage``
    (M-groups per pipeline stage, more than 1 only when M is a multiple of
    16, at most 256 K rows).  A launch counts on ``demm_spmm.launches``."""
    r, g, ne, k, cd = _check_spmm_args(values, indices, b, cfg)
    if body is None:
        body = spmm_body(values, indices, b, cfg.m)
    elif body not in ("tiled", "gather"):
        raise ValueError(f"body must be 'tiled' or 'gather', got {body!r}")
    elif body == "tiled" and not _tiled_takes(values, indices, b, cfg.m):
        raise ValueError("the tiled body takes a bfloat16 B with contiguous, "
                         "16-byte aligned rows, 16-byte aligned rows of "
                         "values and indices, M <= 128 and Ne <= 8")
    if not b.is_cuda:
        return demm_spmm_plain(values, indices, b, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    c = block_output(b, r)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    if body == "tiled":
        tile_n, warpgroups = tile or (0, 0)
        code = lib.demm_spmm_tc_launch(
            values.data_ptr(), _DTYPE_CODE[values.dtype], indices.data_ptr(),
            b.data_ptr(), c.data_ptr(), r, k, cd, cfg.m, ne, b.stride(0),
            c.stride(0), c.stride(1), int(bool(duplicates)), int(tile_n),
            int(warpgroups), int(groups_per_stage or 0), int(stages or 0),
            b.device.index, stream)
    else:
        # one row block of all R rows, list slot j = group j (no address
        # stream), on K2's gather body (block_body(None, ...) == "gather":
        # cluster 0)
        code = lib.demm_block_spmm_launch(
            None, values.data_ptr(), indices.data_ptr(), b.data_ptr(),
            c.data_ptr(), r, k, cd, 1, g, r, cfg.m, ne,
            r * g * ne, ne, g * ne, b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), 0, _DTYPE_CODE[b.dtype],
            _DTYPE_CODE[values.dtype], int(bool(duplicates)),
            int(rows_per_block or 0), 0, b.device.index, stream)
    raise_on_launch_error(code, "demm_spmm")
    demm_spmm.launches += 1
    return c


demm_spmm.launches = 0     # kernel launches (not plain-version calls)
