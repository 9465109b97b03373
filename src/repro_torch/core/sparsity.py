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

Ported: the row-packed ``xwT`` layout, the two-level ``block`` layout
(:func:`pack_block`; :func:`pack_block_stacked` packs a stack of weights
per slice with one shared ``a_max``), the int8-quantized form of both, draft-tier views
(``PackedWeight.tier_ne``, :func:`tier_sort_packed`, :func:`narrow_tier`)
and contraction-dim sharding (:func:`shard_packed_row_parallel`,
:func:`unshard_packed`, :func:`shard_slice`: the per-shard active-group
renumbering of row-parallel weights that ``repro_torch.sharding`` places).
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


def unpack_packed(p: PackedSparse) -> torch.Tensor:
    return unpack(p.values, p.indices, p.cfg, p.shape)


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

    ``tier_ne`` makes the node a *draft-tier view* (``repro_torch.spec``):
    the same tensors, read through only the first ``tier_ne`` of the
    ``n_effective`` pairs of every group (:func:`narrow_tier`, at dispatch).
    It lies in ``[1, n_effective]``; the full tier is stored as ``None``.

    Contraction-dim sharding (``repro_torch.sharding``): ``shard_axis`` (a
    mesh dim name, e.g. ``"model"``) marks the *shard-stacked* form that
    :func:`shard_packed_row_parallel` produces: every tensor carries a
    leading dim of size ``shards``, slice ``s`` the packing of columns
    ``[s*K/S, (s+1)*K/S)`` renumbered to its local frame; ``dense_shape``
    stays the global ``(O, K)`` and, for the ``block`` layout,
    ``block_geom[1]`` is the shared per-shard ``a_max``.  A *local* slice
    (:func:`shard_slice`) has ``shard_axis`` None, the shard-local
    ``dense_shape`` and keeps ``shards`` as provenance, so that dispatch and
    tuning keys (``|s{n}``) tell a shard-local problem from a global one.
    """

    def __init__(self, values: torch.Tensor, indices: torch.Tensor, *,
                 cfg: SparsityConfig, dense_shape,
                 layout: str = LAYOUT_XWT,
                 active_groups: Optional[torch.Tensor] = None,
                 block_geom=None,
                 scales: Optional[torch.Tensor] = None,
                 qdtype: Optional[str] = None,
                 has_duplicates: Optional[bool] = None,
                 tier_ne: Optional[int] = None,
                 shard_axis: Optional[str] = None, shards: int = 1):
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
        shards = int(shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        vshape = tuple(values.shape)
        # the shard-stacked form: a leading shard dim over per-shard
        # packings of K / shards columns each
        lead, local = (), dense_shape
        if shard_axis is not None:
            if not isinstance(shard_axis, str):
                raise TypeError(f"shard_axis must be a mesh dim name (str) "
                                f"or None, got {shard_axis!r}")
            if shards < 2:
                raise ValueError(
                    "shard_axis set but shards < 2; the shard-stacked form "
                    "needs the shard-count dim (shard_packed_row_parallel)")
            if dense_shape[1] % shards:
                raise ValueError(f"K={dense_shape[1]} does not split into "
                                 f"{shards} shards")
            if vshape[:1] != (shards,):
                raise ValueError(
                    f"shard-stacked {layout} values {vshape} carry "
                    f"{vshape[0] if vshape else 0} shard slices, expected "
                    f"shards={shards}")
            lead, local = (shards,), (dense_shape[0],
                                      dense_shape[1] // shards)
            vshape = vshape[1:]
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
            want = (local[0] // br, amax, br, cfg.n_effective)
            if local[0] % br or local[1] % cfg.m or vshape != want:
                raise ValueError(
                    f"values shape {lead + vshape} is inconsistent with "
                    f"block_geom={block_geom} over dense {dense_shape} at "
                    f"cfg={cfg.pattern_name()}: expected {lead + want}")
            if tuple(active_groups.shape) != lead + want[:2]:
                raise ValueError(
                    f"active_groups shape {tuple(active_groups.shape)} does "
                    f"not match values {lead + vshape}: expected "
                    f"{lead + want[:2]}")
            scale_shapes = (lead + vshape[:-1],)
        else:
            if active_groups is not None or block_geom is not None:
                raise ValueError(
                    f"active_groups/block_geom only apply to the "
                    f"{LAYOUT_BLOCK!r} layout, not {layout!r}")
            want = (local[0], local[1] // cfg.m, cfg.n_effective)
            if local[1] % cfg.m or vshape != want:
                raise ValueError(
                    f"values shape {lead + vshape} is inconsistent with the "
                    f"packed layout of cfg={cfg.pattern_name()} over dense "
                    f"{dense_shape}: expected {lead + want}")
            # per output row (O,) or per (row, group) (O, G)
            scale_shapes = (lead + vshape[:-2], lead + vshape[:-1])
        vshape = lead + vshape
        if tuple(indices.shape) != vshape:
            raise ValueError(f"indices shape {tuple(indices.shape)} does not "
                             f"match values {vshape}")
        if scales is not None and tuple(scales.shape) not in scale_shapes:
            raise ValueError(
                f"scales shape {tuple(scales.shape)} does not match values "
                f"{vshape} for the {layout!r} layout: expected one of "
                f"{scale_shapes} (per output row / per group for xwT, per "
                f"row-block × group × row for block)")
        if tier_ne is not None:
            tier_ne = int(tier_ne)
            if not 1 <= tier_ne <= cfg.n_effective:
                raise ValueError(
                    f"tier_ne={tier_ne} outside [1, n_effective="
                    f"{cfg.n_effective}] of cfg={cfg.pattern_name()}")
            if tier_ne == cfg.n_effective:
                tier_ne = None      # the full tier is the canonical no-view
        self.register_buffer("values", values)
        self.register_buffer("indices", indices)
        self.register_buffer("active_groups", active_groups)
        self.register_buffer("scales", scales)
        self.cfg = cfg
        self.dense_shape = dense_shape
        self.layout = layout
        self.block_geom = block_geom
        self.qdtype = qdtype
        self.tier_ne = tier_ne
        self.shard_axis = shard_axis
        self.shards = shards
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
               "qdtype": self.qdtype, "tier_ne": self.tier_ne,
               "shard_axis": self.shard_axis, "shards": self.shards}
        if "values" not in kw and "indices" not in kw:
            out["has_duplicates"] = self.has_duplicates
        out.update(kw)
        return PackedWeight(out.pop("values"), out.pop("indices"), **out)

    def extra_repr(self) -> str:
        geom = f", block_geom={self.block_geom}" if self.block_geom else ""
        q = f", qdtype={self.qdtype!r}" if self.qdtype else ""
        tier = f", tier_ne={self.tier_ne}" if self.tier_ne else ""
        shard = (f", shard_axis={self.shard_axis!r}"
                 if self.shard_axis else "")
        shard += f", shards={self.shards}" if self.shards > 1 else ""
        return (f"values={tuple(self.values.shape)}, "
                f"cfg={self.cfg.pattern_name()!r}, "
                f"dense_shape={self.dense_shape}, layout={self.layout!r}"
                f"{geom}{q}{tier}{shard}")

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
        """Scatter back to the dense weight (dequantizing if needed); a
        draft-tier view densifies only its tier prefix, a shard-stacked
        weight is merged back to the global packing first
        (:func:`unshard_packed`)."""
        if self.tier_ne is not None:
            return narrow_tier(self).to_dense()
        if self.shard_axis is not None:
            return unshard_packed(self).to_dense()
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


def pack_block_stacked(w: torch.Tensor, cfg: SparsityConfig, *,
                       block_r: Optional[int] = None,
                       a_max: Optional[int] = None):
    """:func:`pack_block` for layer-stacked weights ``(*lead, O, K)``.

    The port's modules hold one 2-D weight per layer, so where the JAX
    package returns one node with stacked children this returns the list of
    per-slice block ``PackedWeight`` nodes, in the row-major order of the lead
    axes (``w.reshape(-1, O, K)[i]``).  All slices share one ``a_max`` (the
    most active groups of any row block of the stack, unless given), so
    each equals the JAX package's stacked children sliced.  Always a list:
    a 2-D ``w`` gives a list of one."""
    o, kdim = int(w.shape[-2]), int(w.shape[-1])
    _check_dims((o, kdim), cfg.m)
    if block_r is None:
        block_r = _choose_block_r(o)
    if o % block_r:
        raise ValueError(f"rows {o} not divisible by block_r={block_r}")
    wf = w.reshape(-1, o, kdim)
    needed = max(_needed_a_max(_group_activity(s, block_r, cfg.m))
                 for s in wf)
    if a_max is None:
        a_max = needed
    elif needed > int(a_max):
        raise ValueError(f"a_max={a_max} < {needed} active groups in the "
                         "densest row block of the stack")
    return [pack_block(s, cfg, block_r=block_r, a_max=a_max) for s in wf]


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
# Contraction-dim sharding: the per-shard active-group renumbering pass
# ---------------------------------------------------------------------------
#
# Row-parallel (y = x @ Wᵀ with the contraction dim split over ranks) is where
# packed weights resist a plain slice: xwT indices are group-local, so the G
# axis slices consistently, but the block layout's active_groups hold
# data-dependent *global* group ids — a rank owning columns [s*K/S,
# (s+1)*K/S) must drop foreign groups and renumber the rest to its local
# frame before the kernel's address stream makes sense.  These passes
# produce the shard-stacked form (a leading dim of size S, each slice
# renumbered over K_local = K / S) that ``kernels.ops._demm_matmul_sharded``
# (one process) and ``repro_torch.sharding`` (a rank keeps its slice)
# consume; partial products are summed over the shards.  They run on the host
# side of serving (once, before anything is captured), on any device, in the
# tensors' own dtype.

def _block_live_slots(pw: PackedWeight) -> torch.Tensor:
    """The per-slot liveness mask ``(..., RB, A)`` of a block weight: a slot
    is live iff any of its packed values is non-zero — exact for float
    packings (an active group keeps >= 1 non-zero, padded slots are all
    zero), unreliable for int8, where quantization may round a group's
    survivors to zero."""
    if pw.qdtype is not None:
        raise NotImplementedError(
            "renumbering quantized block weights is not supported (the "
            "all-zero-slot liveness test is unreliable under int8); "
            "ShardingPlan.renumber_params leaves them whole")
    return (pw.values != 0).any(dim=-1).any(dim=-1)


def _compact(live: torch.Tensor, width: int):
    """Stable front-compaction of the live slots along the last axis: the
    first ``width`` slot ids with live ones first (original order kept) and
    the liveness of each."""
    order = torch.sort((~live).to(torch.int8), dim=-1,
                       stable=True).indices[..., :width]
    return order, torch.gather(live, -1, order)


def _take_slots(vals, idx, order, mask):
    """Values and indices of the slots ``order`` (RB, A') of a block weight;
    dead slots zeroed, an index kept only where its value is non-zero."""
    rb, a, br, ne = order.shape[0], order.shape[1], *vals.shape[-2:]
    at = order[:, :, None, None].expand(rb, a, br, ne)
    v = torch.where(mask[:, :, None, None], torch.gather(vals, 1, at),
                    torch.zeros((), dtype=vals.dtype, device=vals.device))
    i = torch.where(v != 0, torch.gather(idx, 1, at),
                    torch.zeros((), dtype=idx.dtype, device=idx.device))
    return v, i.to(torch.int32)


def shard_packed_row_parallel(pw: PackedWeight, num_shards: int, *,
                              axis: str = "model") -> PackedWeight:
    """Reshard a row-parallel packed weight over the contraction dim.

    Returns the shard-stacked form: every tensor gains a leading dim of size
    ``num_shards``, slice ``s`` holding the packing of columns ``[s*K/S,
    (s+1)*K/S)`` renumbered to its local frame.  ``xwT`` needs only a
    reshape (indices are group-local; per-row scales are repeated per
    slice, per-group scales split with their groups); ``block`` runs the
    renumbering pass: per (row-block, shard), foreign active groups are
    dropped, surviving global ids are rebased by the shard's group offset,
    and all shards share one per-shard ``a_max`` (the densest local list).
    ``dense_shape`` stays global.  An int8 block weight raises
    ``NotImplementedError``, as in the JAX package."""
    num_shards = int(num_shards)
    if num_shards == 1:
        return pw
    if pw.shard_axis is not None:
        raise ValueError(f"{pw!r} is already shard-stacked")
    g = pw.groups
    if g % num_shards:
        raise ValueError(
            f"cannot split {g} groups (K={pw.in_features}, M={pw.cfg.m}) "
            f"over {num_shards} shards")
    gl = g // num_shards
    kw = dict(shard_axis=axis, shards=num_shards,
              has_duplicates=pw.has_duplicates)

    if pw.layout == LAYOUT_XWT:
        def reshard(x):   # (O, G, Ne) -> (S, O, Gl, Ne)
            return x.reshape(x.shape[0], num_shards, gl,
                             x.shape[-1]).transpose(0, 1).contiguous()
        scales = pw.scales
        if scales is not None:
            if scales.ndim == 2:                  # per group (O, G)
                scales = scales.reshape(-1, num_shards, gl).transpose(0, 1)
            else:                                 # per row (O,): repeated
                scales = scales[None].expand(num_shards, -1)
            scales = scales.contiguous()
        return pw.replace(values=reshard(pw.values),
                          indices=reshard(pw.indices), scales=scales, **kw)

    live = _block_live_slots(pw)
    ag = pw.active_groups.to(torch.int64)
    shard_of = torch.div(ag, gl, rounding_mode="floor")
    a_max = pw.block_geom[1]
    per = [_compact(live & (shard_of == s), a_max)
           for s in range(num_shards)]
    a_local = max(1, *(int(m.sum(-1).max()) for _, m in per))
    out_v, out_i, out_a = [], [], []
    for s, (order, mask) in enumerate(per):
        order, mask = order[..., :a_local], mask[..., :a_local]
        ag_s = torch.gather(ag, -1, order) - s * gl
        out_a.append(torch.where(mask, ag_s, 0).to(torch.int32))
        v, i = _take_slots(pw.values, pw.indices, order, mask)
        out_v.append(v)
        out_i.append(i)
    return pw.replace(values=torch.stack(out_v), indices=torch.stack(out_i),
                      active_groups=torch.stack(out_a),
                      block_geom=(pw.block_geom[0], a_local), **kw)


def unshard_packed(pw: PackedWeight) -> PackedWeight:
    """Merge a shard-stacked weight back to the global packing (the inverse
    renumbering).  Exact round trip up to ``a_max`` re-tightening and the
    canonical active-list order — compare via :meth:`PackedWeight.to_dense`.
    A weight that is not shard-stacked comes back unchanged."""
    if pw.shard_axis is None:
        return pw
    s_count = pw.shards
    kw = dict(shard_axis=None, shards=1, has_duplicates=pw.has_duplicates)
    if pw.layout == LAYOUT_XWT:
        def merge(x):     # (S, O, Gl, Ne) -> (O, G, Ne)
            x = x.transpose(0, 1)
            return x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        scales = pw.scales
        if scales is not None:
            scales = (scales.transpose(0, 1).reshape(scales.shape[1], -1)
                      if scales.ndim == 3 else scales[0]).contiguous()
        return pw.replace(values=merge(pw.values), indices=merge(pw.indices),
                          scales=scales, **kw)

    live = _block_live_slots(pw)                       # (S, RB, Al)
    gl = pw.groups // s_count
    a_loc = pw.block_geom[1]
    rb = live.shape[1]
    # the per-shard lists concatenated along A in shard order (each slice
    # ascending within its chunk, so the merged list is globally ascending)
    offs = (torch.arange(s_count, device=live.device) * gl)[:, None, None]
    ag_m = (pw.active_groups.to(torch.int64) + offs).transpose(0, 1) \
        .reshape(rb, s_count * a_loc)

    def cat(x):           # (S, RB, Al, br, Ne) -> (RB, S*Al, br, Ne)
        return x.transpose(0, 1).reshape(rb, s_count * a_loc, *x.shape[-2:])

    live_m = live.transpose(0, 1).reshape(rb, s_count * a_loc)
    a_max = max(1, int(live_m.sum(-1).max()))
    order, mask = _compact(live_m, a_max)
    v, i = _take_slots(cat(pw.values), cat(pw.indices), order, mask)
    ag_g = torch.where(mask, torch.gather(ag_m, -1, order), 0)
    return pw.replace(values=v, indices=i,
                      active_groups=ag_g.to(torch.int32),
                      block_geom=(pw.block_geom[0], a_max), **kw)


def shard_slice(pw: PackedWeight, s: int) -> PackedWeight:
    """Slice ``s`` of a shard-stacked weight as a *local* PackedWeight
    (views of the stacked tensors, no copy): ``dense_shape`` becomes the
    shard-local ``(O, K // shards)``, ``shards`` is kept as provenance
    (tuning keys include it) and ``shard_axis`` is None, so that standard
    kernel dispatch applies."""
    if pw.shard_axis is None:
        raise ValueError(f"{pw!r} is not shard-stacked")
    o, k = pw.dense_shape

    def take(x):
        return None if x is None else x[s]

    return PackedWeight(
        take(pw.values), take(pw.indices), cfg=pw.cfg,
        dense_shape=(o, k // pw.shards), layout=pw.layout,
        active_groups=take(pw.active_groups), block_geom=pw.block_geom,
        scales=take(pw.scales), qdtype=pw.qdtype,
        has_duplicates=pw.has_duplicates, shards=pw.shards)


# ---------------------------------------------------------------------------
# Sparser-tier views (repro_torch.spec): one buffer, two densities
# ---------------------------------------------------------------------------
#
# The inverse direction of the paper's §II-B reconfiguration: where
# ``reconfigure_k`` serves a *denser* kN:M pattern in k passes, a *tier view*
# serves a sparser pattern from the same stored stream by reading only the
# first ``tier_ne`` of the ``n_effective`` {value, col_idx} pairs per group.
# ``tier_ne`` is a static attribute of PackedWeight — the tensors are
# untouched, so a draft-tier node shares the full tier's tensors and the
# narrowing happens at dispatch (``kernels/ops.demm_matmul_packed``), as a
# strided prefix view that the kernels read in place.  For the prefix to be
# the magnitude-top-``tier_ne`` slice, the per-group entry order must be
# magnitude-descending — ``tier_sort_packed`` establishes that invariant
# once (full-tier compute is order-independent in exact arithmetic: the
# plain versions scatter, the kernels sum over the Ne axis).

def tier_order(pw: PackedWeight) -> torch.Tensor:
    """The permutation of every group's pairs that :func:`tier_sort_packed`
    applies: by descending ``|value|``, stable.  Int8 magnitudes go through
    float32 (``abs`` of int8 -128 overflows in int8); zero-padded slots sort
    last; equal magnitudes keep their order."""
    mag = (pw.values.to(torch.float32) if pw.qdtype is not None
           else pw.values).abs()
    return torch.sort(-mag, dim=-1, stable=True).indices


def tier_sort_packed(pw: PackedWeight) -> PackedWeight:
    """Reorder every group's {value, col_idx} pairs by descending |value|
    (:func:`tier_order`), both layouts.

    Numerically a no-op for full-tier compute in exact arithmetic; it makes
    any prefix ``[:t]`` of the Ne axis the exact magnitude-top-``t``
    sub-pattern, which is what a ``tier_ne`` draft view reads.  The sort key
    is the raw packed magnitude — valid for quantized weights too, because
    the scale is constant along the Ne axis (per row / per group / per (rb,
    g, row)).  Returns a new node with new tensors
    (``repro_torch.spec.tier_sort_tree`` sorts in place)."""
    order = tier_order(pw)
    return pw.replace(
        values=torch.take_along_dim(pw.values, order, dim=-1),
        indices=torch.take_along_dim(pw.indices, order, dim=-1),
        has_duplicates=pw.has_duplicates)


def narrow_tier(pw: PackedWeight) -> PackedWeight:
    """Materialize a ``tier_ne`` view: the Ne axis sliced to the tier
    prefix and the config retagged as the sparser ``tier_ne:M`` pattern.
    The slices are *views* (``[..., :t]``) that share the full tier's
    storage — nothing is copied; the kernels read the prefix in place at the
    stored pitch.  Called by kernel dispatch (``kernels/ops.py``); the full
    tier (``tier_ne`` None) comes back unchanged."""
    t = pw.tier_ne
    if t is None:
        return pw
    # a prefix holds no duplicate the full tier lacks: no host sync here
    return pw.replace(
        values=pw.values[..., :t], indices=pw.indices[..., :t],
        cfg=SparsityConfig(n=t, m=pw.cfg.m, k=1), tier_ne=None,
        has_duplicates=pw.has_duplicates)


def reconfigure_k(p: PackedSparse, k: int) -> PackedSparse:
    """View a packed kN:M matrix as ``k`` sequential N:M passes.

    Mirrors the paper's §II-B reconfiguration: an engine with N read ports
    serves a kN:M pattern by reading the same B block k times.  The packed
    (R, G, kN) tensors are reshaped to (R, G*k, N) views consumed pass by
    pass; numerically ``sum_k demm(pass_k) == demm(full)``.
    """
    ne = p.cfg.n_effective
    if ne % k:
        raise ValueError(f"cannot split n_effective={ne} into k={k} passes")
    n_pass = ne // k
    r, g, _ = p.values.shape
    return dataclasses.replace(
        p,
        values=p.values.reshape(r, g * k, n_pass),
        indices=p.indices.reshape(r, g * k, n_pass),
        cfg=SparsityConfig(n=n_pass, m=p.cfg.m, k=k),
    )


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
