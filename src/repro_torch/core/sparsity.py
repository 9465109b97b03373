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

Ported so far: the row-packed ``xwT`` layout and its int8-quantized form.
The two-level block layout, contraction-dim sharding and draft-tier views of
the JAX package come with later slices of the port.
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
# contraction dim); ``block`` is the two-level block-sparse format, named here
# so that requests for it fail with a clear message until it is ported.
LAYOUT_XWT = "xwT"
LAYOUT_BLOCK = "block"
LAYOUTS = (LAYOUT_XWT, LAYOUT_BLOCK)

# Known quantized value dtypes.  ``None`` (the default) means ``values``
# carries full-precision floats; ``"int8"`` means symmetric int8 with a
# ``scales`` tensor (per output row, or per (row, group)) — see
# ``repro_torch.quant``.
QDTYPE_INT8 = "int8"
QDTYPES = (QDTYPE_INT8,)


def expand_scales(scales: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Broadcast per-unit quantization scales over the packed value axes.

    The scale shape is a prefix of the values shape, so per-group scales add
    one axis and per-row scales add two.
    """
    if scales.ndim == values.ndim - 1:
        return scales[..., None]
    return scales[..., None, None]


class PackedWeight(nn.Module):
    """A packed relaxed-N:M sparse weight: the paper's ``{value, col_idx}``
    stream as a first-class object.

    ``values`` / ``indices`` (and ``scales`` for a quantized weight) are
    buffers, so ``.to(device)`` and ``state_dict`` see them; the
    :class:`SparsityConfig` (including k-reconfiguration), the dense
    ``(out, in)`` shape, the ``layout`` tag and ``qdtype`` are plain static
    attributes, available to kernel dispatch without touching the tensors.

    Shapes (``xwT`` layout): ``values``/``indices`` are ``(O, G, Ne)`` with
    ``G = in_features // cfg.m`` and ``Ne = cfg.n_effective``.  When
    ``qdtype`` is set, ``values`` holds int8 and ``scales`` is float32 of
    shape ``(O,)`` (per output row, the default) or ``(O, G)`` (per group);
    the dense weight is ``scales ⊙ values`` broadcast over the packed axes and
    the kernels dequantize in-register (w8a16).
    """

    def __init__(self, values: torch.Tensor, indices: torch.Tensor, *,
                 cfg: SparsityConfig, dense_shape,
                 layout: str = LAYOUT_XWT,
                 scales: Optional[torch.Tensor] = None,
                 qdtype: Optional[str] = None):
        super().__init__()
        if not isinstance(cfg, SparsityConfig):
            raise TypeError(f"cfg must be a SparsityConfig, got {type(cfg)}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; expected {LAYOUTS}")
        if layout == LAYOUT_BLOCK:
            raise NotImplementedError(
                "the block layout is not ported yet (it comes with the "
                "block-spmm kernel slice); pack with layout='xwT'")
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
        want = (dense_shape[0], dense_shape[1] // cfg.m, cfg.n_effective)
        if dense_shape[1] % cfg.m or vshape != want:
            raise ValueError(
                f"values shape {vshape} is inconsistent with the packed "
                f"layout of cfg={cfg.pattern_name()} over dense "
                f"{dense_shape}: expected {want}")
        if tuple(indices.shape) != vshape:
            raise ValueError(f"indices shape {tuple(indices.shape)} does not "
                             f"match values {vshape}")
        if scales is not None and tuple(scales.shape) not in (vshape[:-2],
                                                              vshape[:-1]):
            raise ValueError(
                f"scales shape {tuple(scales.shape)} does not match values "
                f"{vshape}: expected {vshape[:-2]} (per output row) or "
                f"{vshape[:-1]} (per group)")
        self.register_buffer("values", values)
        self.register_buffer("indices", indices)
        self.register_buffer("scales", scales)
        self.cfg = cfg
        self.dense_shape = dense_shape
        self.layout = layout
        self.qdtype = qdtype

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
               "layout": self.layout, "scales": self.scales,
               "qdtype": self.qdtype}
        out.update(kw)
        return PackedWeight(out.pop("values"), out.pop("indices"), **out)

    def extra_repr(self) -> str:
        q = f", qdtype={self.qdtype!r}" if self.qdtype else ""
        return (f"values={tuple(self.values.shape)}, "
                f"cfg={self.cfg.pattern_name()!r}, "
                f"dense_shape={self.dense_shape}, layout={self.layout!r}{q}")

    # ---- conversions -----------------------------------------------------
    @classmethod
    def from_dense(cls, w: torch.Tensor, cfg: SparsityConfig,
                   layout: str = LAYOUT_XWT) -> "PackedWeight":
        """Prune (if needed) and pack a dense 2-D weight into ``layout``."""
        p = pack(prune(w, cfg), cfg)
        return cls(p.values, p.indices, cfg=cfg, dense_shape=w.shape,
                   layout=layout)

    def dequantized_values(self) -> torch.Tensor:
        """``values`` with quantization scales applied (float32 for a
        quantized weight; the raw values otherwise)."""
        if self.qdtype is None:
            return self.values
        vals = self.values.to(torch.float32)
        return vals * expand_scales(self.scales, vals)

    def to_dense(self) -> torch.Tensor:
        """Scatter back to the dense weight (dequantizing if needed)."""
        return unpack(self.dequantized_values(), self.indices, self.cfg,
                      self.dense_shape)


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
