"""Relaxed N:M structured sparsity — formats, pruning, packing (PyTorch).

A matrix A follows *relaxed structured sparsity* N:M when every group of M
contiguous elements along the contraction dimension of each row holds at most
N non-zeros.  The packed representation stores, per (row, group), exactly N
``{value, col_idx}`` pairs (zero-padded when fewer non-zeros exist), which is
what the DeMM engine streams: values feed the multipliers, indices feed the
read ports.

Shapes
------
dense   A        : (R, K)            with K % M == 0, G = K // M groups
packed  values   : (R, G, N)         same dtype as A
packed  indices  : (R, G, N) int32   local column index within the group,
                                     in [0, M); padded slots point at 0 with
                                     value 0 (contributing nothing).

Ported so far: the row-packed ``xwT`` layout, the two-level ``block`` layout
(:func:`pack_block`) and the int8-quantized form of both.  Contraction-dim
sharding and draft-tier views of the JAX package come with later slices of
the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Relaxed structured sparsity pattern N:M with k-reconfiguration.

    The *native* engine pattern is ``n:m``.  ``k`` > 1 means the engine is
    reconfigured to serve the denser ``k*n : m`` pattern in ``k`` passes over
    the same pre-loaded B block (paper §II-B).  The *effective* number of
    non-zeros per group is ``n_effective = n * k``.
    """

    n: int = 8
    m: int = 128
    k: int = 1

    def __post_init__(self):
        if self.n < 1 or self.m < 1 or self.k < 1:
            raise ValueError(f"n, m, k must be >= 1, got {self}")
        if self.n * self.k > self.m:
            raise ValueError(
                f"effective non-zeros n*k={self.n * self.k} exceeds group size m={self.m}"
            )

    @property
    def n_effective(self) -> int:
        return self.n * self.k

    @property
    def density(self) -> float:
        return self.n_effective / self.m

    @property
    def sparsity(self) -> float:
        return 1.0 - self.density

    def pattern_name(self) -> str:
        if self.k == 1:
            return f"{self.n}:{self.m}"
        return f"{self.n_effective}:{self.m} (as {self.k}x{self.n}:{self.m})"

    def packed_bytes(self, rows: int, cols: int, value_bytes: int = 2,
                     index_bytes: int = 1) -> int:
        """Device-memory footprint of the packed representation."""
        groups = cols // self.m
        return rows * groups * self.n_effective * (value_bytes + index_bytes)

    def dense_bytes(self, rows: int, cols: int, value_bytes: int = 2) -> int:
        return rows * cols * value_bytes

    def compression_ratio(self, value_bytes: int = 2, index_bytes: int = 1) -> float:
        """Dense/packed byte ratio — the lever on a memory-bound matmul."""
        return (self.m * value_bytes) / (self.n_effective * (value_bytes + index_bytes))


def _check_dims(shape, m: int):
    if len(shape) != 2:
        raise ValueError(f"expected 2-D matrix, got shape {tuple(shape)}")
    if shape[1] % m == 0:
        return
    raise ValueError(f"contraction dim {shape[1]} not divisible by group size {m}")


# ---------------------------------------------------------------------------
# Pattern validation / mask utilities
# ---------------------------------------------------------------------------

def group_nonzero_counts(a: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Non-zero count per (row, group): shape (R, G)."""
    _check_dims(a.shape, cfg.m)
    r, kdim = a.shape
    return (a.reshape(r, kdim // cfg.m, cfg.m) != 0).sum(-1)


def satisfies_pattern(a: torch.Tensor, cfg: SparsityConfig) -> bool:
    """True iff every (row, group) has at most n_effective non-zeros."""
    return bool((group_nonzero_counts(a, cfg) <= cfg.n_effective).all())


def prune_mask(a: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Magnitude top-``n_effective``-per-group boolean mask with A's shape.

    Keep the largest-|w| N elements of every M-block of every row.  Ties are
    broken by column order (first occurrence wins).  The threshold is the
    *value* of the ne-th largest magnitude, which does not depend on the
    order ``torch.topk`` returns equal elements in.
    """
    _check_dims(a.shape, cfg.m)
    r, kdim = a.shape
    g = kdim // cfg.m
    ne = cfg.n_effective
    mag = a.reshape(r, g, cfg.m).abs()
    thresh = torch.topk(mag, ne, dim=-1).values[..., ne - 1: ne]   # (R, G, 1)
    # Exact zeros are never kept — and are excluded *before* the tie
    # resolution: an under-full group (the relaxed "at most N" case) has
    # threshold 0, and its zeros must not crowd out the genuine non-zeros
    # sitting later in the group.
    keep = (mag >= thresh) & (mag > 0)
    # Resolve ties: if >ne elements meet the threshold, keep the first ones.
    over = torch.cumsum(keep.to(torch.int32), dim=-1)
    keep = keep & (over <= ne)
    return keep.reshape(r, kdim)


def prune(a: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Magnitude-prune ``a`` to the N:M pattern (dense output, zeros inserted)."""
    return torch.where(prune_mask(a, cfg), a, torch.zeros((), dtype=a.dtype,
                                                          device=a.device))


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedSparse:
    """Packed relaxed-structured-sparse matrix (the DeMM input stream)."""

    values: torch.Tensor    # (R, G, Ne)
    indices: torch.Tensor   # (R, G, Ne) int32, local in [0, M)
    cfg: SparsityConfig
    shape: tuple            # dense (R, K)


def pack(a: torch.Tensor, cfg: SparsityConfig) -> PackedSparse:
    """Pack a dense matrix that satisfies (or is pruned to) N:M into
    ``{values, indices}``.

    Elements beyond the ``n_effective`` magnitude-largest per group are
    dropped (i.e. ``pack(prune(a)) == pack(a)``); use
    :func:`satisfies_pattern` first if lossless packing must be asserted.

    The selection is a *stable* descending sort, so among equal magnitudes
    the lowest column wins.  ``torch.topk`` promises no order among ties; in
    an under-full group the zeros tie, and which zero is picked decides where
    the padded slot sits among the sorted indices.
    """
    _check_dims(a.shape, cfg.m)
    r, kdim = a.shape
    g = kdim // cfg.m
    ne = cfg.n_effective
    grp = a.reshape(r, g, cfg.m)
    order = torch.sort(grp.abs(), dim=-1, descending=True, stable=True).indices
    idx = torch.sort(order[..., :ne], dim=-1).values     # canonical order
    vals = torch.gather(grp, -1, idx)                    # (R, G, Ne)
    # Padded slots (zero values) are pointed at column 0 with value 0.
    nz = vals != 0
    vals = torch.where(nz, vals, torch.zeros((), dtype=a.dtype, device=a.device))
    idx = torch.where(nz, idx, torch.zeros((), dtype=idx.dtype, device=a.device))
    return PackedSparse(values=vals.contiguous(),
                        indices=idx.to(torch.int32).contiguous(), cfg=cfg,
                        shape=(r, kdim))


def unpack(values: torch.Tensor, indices: torch.Tensor, cfg: SparsityConfig,
           shape: tuple) -> torch.Tensor:
    """Scatter a packed representation back to a dense (R, K) matrix.
    Duplicate indices accumulate (in the dtype of ``values``)."""
    r, kdim = shape
    g = kdim // cfg.m
    ne = cfg.n_effective
    assert tuple(values.shape) == (r, g, ne), (tuple(values.shape), (r, g, ne))
    dense = torch.zeros((r, g, cfg.m), dtype=values.dtype, device=values.device)
    dense.scatter_add_(-1, indices.to(torch.int64), values)
    return dense.reshape(r, kdim)


# ---------------------------------------------------------------------------
# PackedWeight — the first-class packed-weight module
# ---------------------------------------------------------------------------

# ``xwT`` is the serving orientation (y = x @ W^T with W row-sparse along the
# contraction dim); ``block`` is the two-level block-sparse format — per
# row-block active-group lists (level 1) over the usual relaxed N:M packed
# pairs (level 2), converted ahead of time by :func:`pack_block`.
LAYOUT_XWT = "xwT"
LAYOUT_BLOCK = "block"
LAYOUTS = (LAYOUT_XWT, LAYOUT_BLOCK)

# Row-block height for the block layout; pack_block clamps it to the largest
# power-of-two divisor of the row count.
DEFAULT_BLOCK_R = 128

# Known quantized value dtypes.  ``None`` (the default) means ``values``
# carries full-precision floats; ``"int8"`` means symmetric int8 with a
# ``scales`` tensor (per output row, or per (row, group)) — see
# ``repro_torch.quant``.
QDTYPE_INT8 = "int8"
QDTYPES = (QDTYPE_INT8,)


def expand_scales(scales: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Broadcast per-unit quantization scales over the packed value axes.

    The scale shape is a prefix of the values shape, so units owning one
    trailing axis (per-group xwT, the block layout's per-(row-block, group,
    row)) add one axis and per-row xwT units add two.
    """
    if scales.ndim == values.ndim - 1:
        return scales[..., None]
    return scales[..., None, None]


def holds_duplicates(values: torch.Tensor, indices: torch.Tensor) -> bool:
    """True when some group (last axis) holds two non-zero slots at one
    index.  Such slots are summed in the activation dtype before their
    product (the TPU kernel's scatter matrix); a zero slot sharing an index
    changes nothing, so ``pack``'s padded slots do not count.  One vectorised
    pass and one host sync."""
    nz = values != 0
    found = torch.zeros((), dtype=torch.bool, device=values.device)
    for d in range(1, indices.shape[-1]):
        found |= ((indices[..., d:] == indices[..., :-d])
                  & nz[..., d:] & nz[..., :-d]).any()
    return bool(found)


class PackedWeight(nn.Module):
    """A packed relaxed-N:M sparse weight: the paper's ``{value, col_idx}``
    stream as a first-class object.

    ``values`` / ``indices`` (plus ``active_groups`` for the block layout and
    ``scales`` for a quantized weight) are buffers, so ``.to(device)`` and
    ``state_dict`` see them; the :class:`SparsityConfig` (including
    k-reconfiguration), the dense ``(out, in)`` shape, the ``layout`` tag, the
    block geometry and ``qdtype`` are plain static attributes, available to
    kernel dispatch without touching the tensors.

    Shapes: for the ``xwT`` layout ``values``/``indices`` are ``(O, G, Ne)``
    with ``G = in_features // cfg.m`` and ``Ne = cfg.n_effective``.  For the
    ``block`` layout they are ``(RB, A_max, block_r, Ne)`` with
    ``active_groups (RB, A_max) int32`` — the level-1 address stream that
    decides which activation blocks the kernel reads at all — and the static
    ``block_geom = (block_r, a_max)``.  When ``qdtype`` is set, ``values``
    holds int8 and ``scales`` is float32 of shape ``(O,)`` (per output row,
    the default) or ``(O, G)`` (per group) for ``xwT``, ``(RB, A_max,
    block_r)`` (per row-block × group × row) for ``block``; the dense weight
    is ``scales ⊙ values`` broadcast over the packed axes and the kernels
    dequantize in-register (w8a16).

    ``has_duplicates`` records, once, whether some group holds two non-zero
    slots at one index (:func:`holds_duplicates`); dispatch passes it to the
    kernels, which skip their duplicate fold when it is False — always, for
    what :func:`pack` and :func:`pack_block` produce.
    """

    def __init__(self, values: torch.Tensor, indices: torch.Tensor, *,
                 cfg: SparsityConfig, dense_shape,
                 layout: str = LAYOUT_XWT,
                 active_groups: Optional[torch.Tensor] = None,
                 block_geom=None,
                 scales: Optional[torch.Tensor] = None,
                 qdtype: Optional[str] = None,
                 has_duplicates: Optional[bool] = None):
        super().__init__()
        if not isinstance(cfg, SparsityConfig):
            raise TypeError(f"cfg must be a SparsityConfig, got {type(cfg)}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; expected {LAYOUTS}")
        if qdtype is None:
            if scales is not None:
                raise ValueError(
                    "scales only apply to quantized weights; set qdtype "
                    "(repro_torch.quant.quantize_packed does both)")
        else:
            if qdtype not in QDTYPES:
                raise ValueError(
                    f"unknown qdtype {qdtype!r}; expected one of {QDTYPES}")
            if scales is None:
                raise ValueError(
                    f"qdtype={qdtype!r} needs the scales tensor; quantize "
                    "with repro_torch.quant.quantize_packed")
        dense_shape = tuple(int(d) for d in dense_shape)
        if len(dense_shape) != 2:
            raise ValueError(f"dense_shape must be 2-D (out, in), got "
                             f"{dense_shape}")
        vshape = tuple(values.shape)
        if layout == LAYOUT_BLOCK:
            if active_groups is None:
                raise ValueError(
                    "block layout needs the active_groups tensor (the "
                    "level-1 address stream); pack with pack_block")
            if block_geom is None:
                if len(vshape) != 4:
                    raise ValueError(
                        "block layout needs block_geom=(block_r, a_max) or "
                        "(RB, A_max, block_r, Ne) values to derive it from")
                block_geom = (vshape[2], vshape[1])
            block_geom = (int(block_geom[0]), int(block_geom[1]))
            br, amax = block_geom
            want = (dense_shape[0] // br, amax, br, cfg.n_effective)
            if dense_shape[0] % br or dense_shape[1] % cfg.m or vshape != want:
                raise ValueError(
                    f"values shape {vshape} is inconsistent with "
                    f"block_geom={block_geom} over dense {dense_shape} at "
                    f"cfg={cfg.pattern_name()}: expected {want}")
            if tuple(active_groups.shape) != want[:2]:
                raise ValueError(
                    f"active_groups shape {tuple(active_groups.shape)} does "
                    f"not match values {vshape}: expected {want[:2]}")
            scale_shapes = (vshape[:-1],)
        else:
            if active_groups is not None or block_geom is not None:
                raise ValueError(
                    f"active_groups/block_geom only apply to the "
                    f"{LAYOUT_BLOCK!r} layout, not {layout!r}")
            want = (dense_shape[0], dense_shape[1] // cfg.m, cfg.n_effective)
            if dense_shape[1] % cfg.m or vshape != want:
                raise ValueError(
                    f"values shape {vshape} is inconsistent with the packed "
                    f"layout of cfg={cfg.pattern_name()} over dense "
                    f"{dense_shape}: expected {want}")
            # per output row (O,) or per (row, group) (O, G)
            scale_shapes = (vshape[:-2], vshape[:-1])
        if tuple(indices.shape) != vshape:
            raise ValueError(f"indices shape {tuple(indices.shape)} does not "
                             f"match values {vshape}")
        if scales is not None and tuple(scales.shape) not in scale_shapes:
            raise ValueError(
                f"scales shape {tuple(scales.shape)} does not match values "
                f"{vshape} for the {layout!r} layout: expected one of "
                f"{scale_shapes} (per output row / per group for xwT, per "
                f"row-block × group × row for block)")
        self.register_buffer("values", values)
        self.register_buffer("indices", indices)
        self.register_buffer("active_groups", active_groups)
        self.register_buffer("scales", scales)
        self.cfg = cfg
        self.dense_shape = dense_shape
        self.layout = layout
        self.block_geom = block_geom
        self.qdtype = qdtype
        self.has_duplicates = (holds_duplicates(values, indices)
                               if has_duplicates is None
                               else bool(has_duplicates))

    # ---- static geometry -------------------------------------------------
    @property
    def out_features(self) -> int:
        return self.dense_shape[0]

    @property
    def in_features(self) -> int:
        return self.dense_shape[1]

    @property
    def groups(self) -> int:
        return self.in_features // self.cfg.m

    def replace(self, **kw) -> "PackedWeight":
        out = {"values": self.values, "indices": self.indices,
               "cfg": self.cfg, "dense_shape": self.dense_shape,
               "layout": self.layout, "active_groups": self.active_groups,
               "block_geom": self.block_geom, "scales": self.scales,
               "qdtype": self.qdtype}
        if "values" not in kw and "indices" not in kw:
            out["has_duplicates"] = self.has_duplicates
        out.update(kw)
        return PackedWeight(out.pop("values"), out.pop("indices"), **out)

    def extra_repr(self) -> str:
        geom = f", block_geom={self.block_geom}" if self.block_geom else ""
        q = f", qdtype={self.qdtype!r}" if self.qdtype else ""
        return (f"values={tuple(self.values.shape)}, "
                f"cfg={self.cfg.pattern_name()!r}, "
                f"dense_shape={self.dense_shape}, layout={self.layout!r}"
                f"{geom}{q}")

    # ---- conversions -----------------------------------------------------
    @classmethod
    def from_dense(cls, w: torch.Tensor, cfg: SparsityConfig,
                   layout: str = LAYOUT_XWT, *,
                   block_r: Optional[int] = None,
                   a_max: Optional[int] = None) -> "PackedWeight":
        """Prune (if needed) and pack a dense 2-D weight into ``layout``."""
        if layout == LAYOUT_BLOCK:
            return pack_block(w, cfg, block_r=block_r, a_max=a_max)
        p = pack(prune(w, cfg), cfg)
        return cls(p.values, p.indices, cfg=cfg, dense_shape=w.shape,
                   layout=layout)

    def dequantized_values(self) -> torch.Tensor:
        """``values`` with quantization scales applied (float32 for a
        quantized weight; the raw values otherwise).  The scale shape is a
        prefix of the values shape, so the units are told apart by rank."""
        if self.qdtype is None:
            return self.values
        vals = self.values.to(torch.float32)
        return vals * expand_scales(self.scales, vals)

    def to_dense(self) -> torch.Tensor:
        """Scatter back to the dense weight (dequantizing if needed)."""
        if self.layout == LAYOUT_BLOCK:
            return unpack_block(self.active_groups, self.dequantized_values(),
                                self.indices, self.cfg, self.dense_shape)
        return unpack(self.dequantized_values(), self.indices, self.cfg,
                      self.dense_shape)


# ---------------------------------------------------------------------------
# Two-level block packing (the "block" layout)
# ---------------------------------------------------------------------------

def _choose_block_r(rows: int, cap: int = DEFAULT_BLOCK_R) -> int:
    """Largest power-of-two divisor of ``rows``, capped at ``cap``."""
    br = 1
    while br * 2 <= cap and rows % (br * 2) == 0:
        br *= 2
    return br


def _group_activity(w: torch.Tensor, block_r: int, m: int) -> torch.Tensor:
    """Active-group mask ``(RB, G)`` of ``w (R, K)``: a group is active when
    any row of the row block has a non-zero in it."""
    r, k = w.shape
    blocks = w.reshape(r // block_r, block_r, k // m, m)
    return (blocks != 0).any(dim=3).any(dim=1)


def _needed_a_max(activity: torch.Tensor) -> int:
    """Max active groups over every row block (>= 1)."""
    return max(1, int(activity.sum(dim=-1).max()))


def pack_block(a: torch.Tensor, cfg: SparsityConfig, *,
               block_r: Optional[int] = None,
               a_max: Optional[int] = None) -> PackedWeight:
    """Ahead-of-time two-level conversion to the ``block`` layout.

    Level 1: per ``block_r``-row block, the sorted list of *active* M-groups
    (groups where any row of the block has a non-zero) — the address stream
    that decides which activation blocks the kernel reads at all.  Level 2:
    within each listed group, the usual relaxed N:M ``{values, indices}``
    pairs (magnitude top-``n_effective`` per row, like :func:`pack`).

    ``a_max`` bounds the list length; by default it is the densest row
    block's active count.  An ``a_max`` larger than ``G`` pads with inactive
    slots (matching an existing checkpoint's geometry); one below the active
    count raises.  Padded slots point at group 0 with all-zero values and
    contribute nothing.

    The selections are stable sorts — groups by (active first, then group
    id), slots by (magnitude descending, then column) — so that values,
    indices and ``active_groups`` equal the JAX package's bit for bit
    (``jnp.argsort(stable=True)`` and ``jax.lax.top_k``), ties included.
    """
    _check_dims(a.shape, cfg.m)
    r, kdim = a.shape
    g = kdim // cfg.m
    ne = cfg.n_effective
    if block_r is None:
        block_r = _choose_block_r(r)
    if r % block_r:
        raise ValueError(f"rows {r} not divisible by block_r={block_r}")
    rb = r // block_r
    activity = _group_activity(a, block_r, cfg.m)               # (RB, G)
    needed = _needed_a_max(activity)
    a_max = needed if a_max is None else int(a_max)
    if needed > a_max:
        raise ValueError(f"a_max={a_max} < {needed} active groups in the "
                         "densest row block")

    # Stable sort by (active desc, group id asc): actives first, ascending.
    sel_w = min(a_max, g)
    order = torch.sort(-activity.to(torch.int32), dim=-1,
                       stable=True).indices[:, :sel_w]          # (RB, sel_w)
    active = torch.gather(activity, -1, order)
    if a_max > sel_w:
        # a_max beyond the group count: pad with inactive slots.
        pad = a_max - sel_w
        order = torch.nn.functional.pad(order, (0, pad))
        active = torch.nn.functional.pad(active, (0, pad))
    ag = torch.where(active, order, torch.zeros_like(order)).to(torch.int32)

    grp = a.reshape(rb, block_r, g, cfg.m).transpose(1, 2)       # (RB,G,br,M)
    sel = torch.gather(grp, 1, order[:, :, None, None].expand(
        rb, a_max, block_r, cfg.m))                              # (RB,A,br,M)
    top = torch.sort(sel.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :ne]
    idx = torch.sort(top, dim=-1).values
    vals = torch.gather(sel, -1, idx)
    # Padded slots alias group 0: zero them so they contribute nothing.
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    vals = torch.where(active[:, :, None, None], vals, zero)
    idx = torch.where(vals != 0, idx, torch.zeros_like(idx))
    return PackedWeight(vals.contiguous(), idx.to(torch.int32).contiguous(),
                        cfg=cfg, dense_shape=(r, kdim), layout=LAYOUT_BLOCK,
                        active_groups=ag.contiguous(),
                        block_geom=(block_r, a_max))


def unpack_block(active_groups: torch.Tensor, values: torch.Tensor,
                 indices: torch.Tensor, cfg: SparsityConfig,
                 shape: tuple) -> torch.Tensor:
    """Scatter a two-level block packing back to a dense (R, K) matrix.
    Duplicate indices and duplicate active-group ids accumulate (in the dtype
    of ``values``); padded all-zero slots contribute 0."""
    r, kdim = shape
    rb, a_max, block_r, _ = values.shape
    g = kdim // cfg.m
    assert rb * block_r == r, (tuple(values.shape), shape)
    per_slot = torch.zeros((rb, a_max, block_r, cfg.m), dtype=values.dtype,
                           device=values.device)
    per_slot.scatter_add_(-1, indices.to(torch.int64), values)
    dense = torch.zeros((rb, block_r, g, cfg.m), dtype=values.dtype,
                        device=values.device)
    ids = active_groups.to(torch.int64)[:, None, :, None].expand(
        rb, block_r, a_max, cfg.m)
    dense.scatter_add_(2, ids, per_slot.transpose(1, 2))
    return dense.reshape(r, kdim)


# ---------------------------------------------------------------------------
# Host-side helpers (numpy; used by tests and tooling)
# ---------------------------------------------------------------------------

def random_sparse_dense(rng: np.random.Generator, rows: int, cols: int,
                        cfg: SparsityConfig, dtype=np.float32) -> np.ndarray:
    """A dense matrix exactly satisfying N:M (each group gets <= n_effective
    non-zeros at uniformly random positions)."""
    _check_dims((rows, cols), cfg.m)
    g = cols // cfg.m
    out = np.zeros((rows, g, cfg.m), dtype=dtype)
    ne = cfg.n_effective
    for rr in range(rows):
        for gg in range(g):
            nnz = rng.integers(0, ne + 1)
            if nnz:
                pos = rng.choice(cfg.m, size=nnz, replace=False)
                out[rr, gg, pos] = rng.standard_normal(nnz).astype(dtype)
    return out.reshape(rows, cols)
