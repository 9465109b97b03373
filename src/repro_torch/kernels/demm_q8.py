"""The int8 packed serving matmuls (w8a16): CUDA kernel wrappers and their
plain PyTorch versions, for both packed layouts.

* :func:`demm_xwT_q8` — ``y = x @ W_q8ᵀ`` from the row-packed stream; replaces
  the TPU kernel ``demm_xwT_q8_pallas`` (``kernels/demm_q8.py`` of the JAX
  package); CUDA source ``csrc/demm_xwt_q8.cu``.  At serving batch
  (``demm_xwT.xwt_body`` given the scales) it runs K1's bulk-copy row-tile
  body (``csrc/demm_xwt_bulk.cuh``): about one CTA per SM, each requesting
  its rows' int8 values, indices and per-group scales with bulk copies at
  entry, x staged once per CTA; at wider bfloat16 x K1's wide body
  (``csrc/demm_xwt_wide.cuh``), each pair's scaled weight decoded once per
  launch into shared memory; otherwise K1's gather body.
* :func:`demm_block_spmm_q8` — ``C = A_q8 @ B`` from the two-level block
  layout; replaces ``demm_block_spmm_q8_pallas`` of the same module; CUDA
  source ``csrc/demm_block_spmm_q8.cu``.  At serving batch
  (:func:`block_q8_body`) it runs the bulk-copy cluster body
  (``csrc/demm_block_cluster.cuh``): a cluster of CTAs per row block, each
  requesting its contiguous slice of values, indices and scales with bulk
  copies at entry and loading the x segments of its own groups meanwhile,
  the partial tiles added through distributed shared memory; otherwise K2's
  gather body.

Weights are int8, activations keep their serving dtype; only the int8 values,
the indices (and the address stream) and the float32 scales cross device
memory and the dequantisation happens in registers.  Like the float kernels
they are bound on an H100 by the packed bytes over device-memory bandwidth —
int8 values cut those bytes from 8 to 5 per pair.

Semantics shared by the kernels and their plain versions (the TPU kernels'):
the int8 values of one group are summed at their local column in the
activation dtype (exact up to ±256; slot order, rounding after each add —
``scatter_groups``), that sum is multiplied by the unit's scale cast to the
activation dtype and rounded to it, then the float32-accumulated product of
the float kernels follows.  The scale unit is the output row ``scales[o]`` or
the (row, group) ``scales[o, g]`` for xwT, the (row block, list slot, row)
``scales[i, j, r]`` for the block layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig, expand_scales
from repro_torch.kernels.demm_block_spmm import (
    block_output,
    block_scatter_dense,
    check_block_args,
    cluster_takes,
)
from repro_torch.kernels.demm_xwT import (
    _DTYPE_CODE,
    BODY_CODE,
    WIDE_TILES,
    check_body,
    check_xwT_args,
    raise_on_launch_error,
    round_to,
    scatter_groups,
    xwt_body,
)


def _check_scales(scales, x, shapes):
    if tuple(scales.shape) not in shapes:
        raise ValueError(f"scales must have one of the shapes {shapes}, got "
                         f"{tuple(scales.shape)}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    if scales.device != x.device:
        raise ValueError(f"scales on {scales.device}, x on {x.device}")
    if not scales.is_contiguous():
        raise ValueError("scales must be contiguous")


def _scaled(s: torch.Tensor, scales: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Scatter rows times their scales, both in ``dtype``'s rounding."""
    return round_to(s * round_to(scales.to(torch.float32), dtype), dtype)


def demm_xwT_q8_plain(x: torch.Tensor, values: torch.Tensor,
                      indices: torch.Tensor, scales: torch.Tensor,
                      cfg: SparsityConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the int8 scatter rows in the
    activation dtype times their row's or group's scale (rounded) form the
    dense (O, K) weight, then a float32 matmul."""
    o, g, _ = values.shape
    s = scatter_groups(values, indices, cfg.m, x.dtype)          # (O, G, M)
    w = _scaled(s, expand_scales(scales, values), x.dtype)
    return x.to(torch.float32) @ w.reshape(o, g * cfg.m).T


def demm_xwT_q8(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                scales: torch.Tensor, cfg: SparsityConfig, *,
                duplicates: bool = True,
                rows_per_block: Optional[int] = None) -> torch.Tensor:
    """y (Bx, O) float32 = x (Bx, K) @ W_q8ᵀ; int8 values (O, G, Ne) with
    float32 scales (O,) or (O, G); values and indices contiguous or a draft
    tier's prefix view (``demm_xwT.prefix_pitch``).

    A CUDA tensor launches the hand-written kernel (the body
    ``demm_xwT.xwt_body`` names given the scales: K1's bulk row-tile body at
    serving batch, its wide body at wider bfloat16 x, its gather body
    otherwise) or raises; a CPU tensor takes
    :func:`demm_xwT_q8_plain`, and only because it lies on the CPU.
    ``duplicates`` and ``rows_per_block`` as for ``demm_xwT``.
    """
    return demm_xwT_q8_on(None, x, values, indices, scales, cfg,
                          duplicates=duplicates,
                          rows_per_block=rows_per_block)


def demm_xwT_q8_on(body: Optional[str], x: torch.Tensor,
                   values: torch.Tensor, indices: torch.Tensor,
                   scales: torch.Tensor, cfg: SparsityConfig, *,
                   duplicates: bool = True,
                   rows_per_block: Optional[int] = None,
                   chunks: Optional[int] = None,
                   lanes: Optional[int] = None,
                   tile: Optional[int] = None) -> torch.Tensor:
    """:func:`demm_xwT_q8` on a named body (``"bulk"`` or ``"wide"``, only
    where ``xwt_body`` picks it, or ``"gather"``; ``None``: the chosen one),
    the bulk body's ``chunks`` (row chunks per CTA; left open, the whole
    tile, or a ring where it does not fit) and ``lanes`` (slot lanes per
    row, 8 or 16; left open, 8 where a chunk holds more than 32 rows, so
    that one pass of the CTA's 512 threads takes them) and the wide body's
    ``tile`` (x rows per tile, 32, 64 or 128) — a measurement hook for
    timing one body against the other and the tunables (``chip_smoke.py
    --sweep``), and the tuner's way to a tunable, not a serving entry point.
    A launch counts on ``demm_xwT_q8.launches`` and by body on
    ``demm_xwT_q8.body_launches``."""
    bx, k, o, g, ne, pitch = check_xwT_args(x, values, indices, cfg,
                                            (torch.int8,))
    _check_scales(scales, x, ((o,), (o, g)))
    chosen = xwt_body(x, values, indices, cfg.m, duplicates=duplicates,
                      scales=scales)
    check_body(body, chosen)
    if tile not in (None, *WIDE_TILES):
        raise ValueError(f"tile must be one of {WIDE_TILES}, got {tile!r}")
    if lanes not in (None, 8, 16):
        raise ValueError(f"lanes must be 8 or 16, got {lanes!r}")
    if not x.is_cuda:
        return demm_xwT_q8_plain(x, values, indices, scales, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    y = torch.empty((bx, o), dtype=torch.float32, device=x.device)
    code = lib.demm_xwt_q8_launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(),
        scales.data_ptr(), y.data_ptr(), bx, k, o, g, cfg.m, ne, pitch,
        _DTYPE_CODE[x.dtype], 1 if scales.ndim == 1 else g,
        int(bool(duplicates)), int(rows_per_block or 0),
        BODY_CODE[body or chosen], int(chunks or 0), int(lanes or 0),
        int(tile or 0), x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_launch_error(code, "demm_xwt_q8")
    demm_xwT_q8.launches += 1
    demm_xwT_q8.body_launches[body or chosen] += 1
    return y


demm_xwT_q8.launches = 0     # kernel launches (not plain-version calls)
demm_xwT_q8.body_launches = {"bulk": 0, "wide": 0, "gather": 0}  # by body


def demm_block_spmm_q8_plain(active_groups: torch.Tensor,
                             values: torch.Tensor, indices: torch.Tensor,
                             scales: torch.Tensor, b: torch.Tensor,
                             cfg: SparsityConfig, *, r: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`demm_block_spmm_q8`: the int8 scatter
    rows in B's dtype times their (row block, list slot, row) scale
    (rounded), added into the dense (R, K) matrix in float32, then a float32
    matmul."""
    s = scatter_groups(values, indices, cfg.m, b.dtype)      # (RB,A,br,M)
    s = _scaled(s, scales[..., None], b.dtype)
    a = block_scatter_dense(active_groups, s, b.shape[0], r)
    return a @ b.to(torch.float32)


def block_q8_body(values: torch.Tensor, indices: torch.Tensor,
                  scales: torch.Tensor, b: torch.Tensor, m: int) -> str:
    """Which CUDA body :func:`demm_block_spmm_q8` runs: ``"cluster"`` where
    the cluster body takes the int8 values, the indices, the scales and B
    (``demm_block_spmm.cluster_takes``: serving batch, B = xᵀ with at most
    ``CLUSTER_MAX_CD`` columns, every copied span 16-byte aligned),
    ``"gather"`` (K2's body) otherwise.  This is the one statement of the
    rule: ``csrc/demm_block_cluster.cuh::cluster_takes`` only refuses what
    the cluster body cannot take."""
    return ("cluster" if cluster_takes(values, indices, b, m, scales)
            else "gather")


def demm_block_spmm_q8(active_groups: torch.Tensor, values: torch.Tensor,
                       indices: torch.Tensor, scales: torch.Tensor,
                       b: torch.Tensor, cfg: SparsityConfig, *, r: int,
                       duplicates: bool = True,
                       rows_per_block: Optional[int] = None,
                       cluster_size: Optional[int] = None) -> torch.Tensor:
    """C (R, Cd) float32 = A_q8 @ B from the block layout with int8 values
    (RB, A_max, block_r, Ne) and float32 scales (RB, A_max, block_r).

    Same contract as ``demm_block_spmm`` (B may be any strided view, C comes
    back in B's orientation, values and indices may be a draft tier's prefix
    view); a CPU tensor takes
    :func:`demm_block_spmm_q8_plain`, and only because it lies on the CPU.
    The body is :func:`block_q8_body`'s; ``rows_per_block`` tunes the gather
    body, ``cluster_size`` (CTAs per row block, 1-8) the cluster body; left
    open, the launcher sizes them to the card.
    """
    return demm_block_spmm_q8_on(None, active_groups, values, indices,
                                 scales, b, cfg, r=r, duplicates=duplicates,
                                 rows_per_block=rows_per_block,
                                 cluster_size=cluster_size)


def demm_block_spmm_q8_on(body: Optional[str], active_groups: torch.Tensor,
                          values: torch.Tensor, indices: torch.Tensor,
                          scales: torch.Tensor, b: torch.Tensor,
                          cfg: SparsityConfig, *, r: int,
                          duplicates: bool = True,
                          rows_per_block: Optional[int] = None,
                          cluster_size: Optional[int] = None) -> torch.Tensor:
    """:func:`demm_block_spmm_q8` on a named body (``"cluster"``, only where
    :func:`block_q8_body` picks it, or ``"gather"``; ``None``: the chosen
    one) — a measurement hook for timing one body against the other
    (``chip_smoke.py --sweep``), not a serving entry point.  A launch counts
    on ``demm_block_spmm_q8.launches``."""
    rb, a_max, block_r, ne, pitch, k, cd = check_block_args(
        active_groups, values, indices, b, cfg, r, (torch.int8,))
    _check_scales(scales, b, ((rb, a_max, block_r),))
    chosen = block_q8_body(values, indices, scales, b, cfg.m)
    if body not in (None, "cluster", "gather"):
        raise ValueError(f"body must be 'cluster' or 'gather', got {body!r}")
    if body == "cluster" and chosen != "cluster":
        raise ValueError("the cluster body does not take these arguments "
                         "(block_q8_body)")
    if not b.is_cuda:
        return demm_block_spmm_q8_plain(active_groups, values, indices,
                                        scales, b, cfg, r=r)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    c = block_output(b, r)
    # 0: the gather body; -1: the cluster body, its size left to the launcher
    cluster = (int(cluster_size or -1) if (body or chosen) == "cluster"
               else 0)
    code = lib.demm_block_spmm_q8_launch(
        active_groups.data_ptr(), values.data_ptr(), indices.data_ptr(),
        scales.data_ptr(), b.data_ptr(), c.data_ptr(), r, k, cd, rb, a_max,
        block_r, cfg.m, ne, pitch, b.stride(0), b.stride(1), c.stride(0),
        c.stride(1),
        _DTYPE_CODE[b.dtype], int(bool(duplicates)),
        int(rows_per_block or 0), cluster, b.device.index,
        torch.cuda.current_stream(b.device).cuda_stream)
    raise_on_launch_error(code, "demm_block_spmm_q8")
    demm_block_spmm_q8.launches += 1
    return c


demm_block_spmm_q8.launches = 0     # kernel launches (not plain-version calls)
