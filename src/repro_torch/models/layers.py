"""Shared layer primitives: norms, RoPE, embeddings, (sparse) MLP.

Parameters live in small ``nn.Module``s; every ``init_*`` builds one from an
explicit ``torch.Generator`` on an explicit device and has a matching
``apply_*`` (the module's ``forward``).  Weight matrices that fall inside the
arch's ``sparse_scope`` are created through the DeMM sparse-linear paths —
masked dense for training-form weights, packed for serving
(``repro_torch.core.sparse_linear``).
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import choose_group
from repro_torch.core import sparse_linear as sl
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.core.sparsity import PackedWeight, SparsityConfig
from repro_torch.sharding.context import get_context


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Linear with optional DeMM sparsity
# ---------------------------------------------------------------------------

# group boundaries must align to tensor-parallel shards: a contraction dim
# split over up to 16 ranks (``repro_torch.sharding``) keeps whole groups
PRODUCTION_TP = 16


def linear_sparsity(in_f: int, sparse: Optional[SparsityConfig],
                    name: str = "linear") -> Optional[SparsityConfig]:
    """The group config a sparse linear of contraction dim ``in_f`` really
    gets: M is aligned to ``in_f // PRODUCTION_TP`` whenever the dim divides
    (row-parallel weights shard K, and a group that straddles a shard
    boundary would force a gather of the weight to compute its mask), at the
    requested density, keeping a requested k-reconfiguration when it
    divides."""
    if sparse is None:
        return None
    k_align = in_f // PRODUCTION_TP if in_f % PRODUCTION_TP == 0 else in_f
    cfg = choose_group(k_align, sparse.density, sparse.m)
    if sparse.k > 1:
        if cfg.n_effective % sparse.k == 0:
            cfg = SparsityConfig(cfg.n_effective // sparse.k, cfg.m, sparse.k)
        else:
            warnings.warn(
                f"requested k={sparse.k} reconfiguration cannot be kept "
                f"for {name}: the group config adapted to the "
                f"contraction dim ({cfg.pattern_name()}) has "
                f"n_effective={cfg.n_effective} not divisible by k; "
                "storing k=1", stacklevel=2)
    return cfg


def init_linear(in_f: int, out_f: int, *, sparse: Optional[SparsityConfig],
                generator: torch.Generator, device, dtype=torch.float32,
                name: str = "linear") -> sl.SparseLinear:
    """Weight (out_f, in_f).  When ``sparse`` is set, the effective group
    config is adapted to the contraction dim (:func:`linear_sparsity`), the
    weight is initialized pre-pruned to the pattern, and the resolved config
    is stored on the node so it survives pack → serve end to end."""
    cfg = linear_sparsity(in_f, sparse, name)
    if cfg is not None:
        return sl.init_sparse(in_f, out_f, cfg, generator=generator,
                              device=device, dtype=dtype)
    return sl.init_dense(in_f, out_f, generator=generator, device=device,
                         dtype=dtype)


def apply_linear(node, x, policy: Optional[ExecPolicy] = None):
    """Apply a linear node (dense, masked-sparse, or PackedWeight) under an
    :class:`ExecPolicy` (the default policy when none is given)."""
    return sl.apply(node, x, policy)


def pack_linear(node):
    """Convert a (sparse) trained linear to the packed DeMM serving form; a
    packed or dense node is returned as it is."""
    if isinstance(node, PackedWeight):
        return node
    cfg = sl.node_sparsity(node)
    if cfg is None:
        return node
    return sl.pack_params(node, cfg)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)

    def forward(self, x, eps: float = 1e-6):
        dt = x.dtype
        x = x.to(torch.float32)
        var = x.square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + eps)
        return (x * self.scale.to(torch.float32)).to(dt)


def init_rmsnorm(d: int, *, device, dtype=torch.float32) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


def apply_rmsnorm(norm: RMSNorm, x, eps: float = 1e-6):
    return norm(x, eps)


class LayerNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x, eps: float = 1e-5):
        dt = x.dtype
        x = x.to(torch.float32)
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps)
        return (y * self.scale + self.bias).to(dt)


def init_layernorm(d: int, *, device, dtype=torch.float32) -> LayerNorm:
    return LayerNorm(torch.ones((d,), dtype=dtype, device=device),
                     torch.zeros((d,), dtype=dtype, device=device))


def apply_layernorm(norm: LayerNorm, x, eps: float = 1e-5):
    return norm(x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _cached_freqs(head_dim: int, theta: float, device: str) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(Dh/2,) inverse frequencies, float32 (computed once per device)."""
    return _cached_freqs(head_dim, float(theta), str(device or "cpu"))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(sin, cos), each (B, T, 1, Dh/2) float32, for positions (B, T) or
    (T,).  A decode step computes them once and every layer reuses them."""
    freqs = rope_freqs(head_dim, theta, positions.device)   # (Dh/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs   # (B,T,Dh/2)
    return (torch.sin(angles)[:, :, None, :],
            torch.cos(angles)[:, :, None, :])


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (B, T) or (T,).  Rotates the two halves
    of the head dim against each other (not interleaved pairs), in float32.
    ``tables`` takes precomputed :func:`rope_tables` of the same positions."""
    sin, cos = tables if tables is not None else \
        rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table, requires_grad=False)
        # dtype -> (table version, table storage, cast copy): the
        # unembedding's cast of the table, made once per dtype rather than
        # on every decode step, and made again if the table changes
        self._casts = {}

    def forward(self, tokens):
        if getattr(self, "tp_sharded", False):
            return self._vocab_parallel(tokens)
        if torch.is_grad_enabled() and self.table.requires_grad:
            # under grad: the embedding op, whose backward sums the rows of
            # repeated tokens in a fixed order on the card (an indexed read's
            # backward accumulates with atomics, in no fixed order)
            return torch.nn.functional.embedding(tokens, self.table)
        return self.table[tokens]

    def _vocab_parallel(self, tokens):
        """The lookup of a table split over the tp ranks by vocabulary rows
        (``ShardingPlan.shard_params``): each rank looks up the tokens its
        block holds, zeros elsewhere, and the ranks' rows are summed
        (adding zeros is exact)."""
        ctx = get_context()
        n = self.table.shape[0]
        local = tokens - ctx.tp_rank * n
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        if torch.is_grad_enabled() and self.table.requires_grad:
            # the embedding op's backward (rows summed in a fixed order);
            # a token outside this rank's rows reads row 0 or n - 1, and its
            # zeroed gradient adds exactly 0 there
            rows = torch.nn.functional.embedding(local, self.table)
        else:
            rows = self.table[local]
        rows = torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return ctx.reduce_tp(rows)

    def table_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The table in ``dtype``, the same values ``table.to(dtype)``
        gives, cast once and kept."""
        t = self.table
        if t.dtype == dtype:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return t.to(dtype)      # a training step: the cast carries grad
        # an inference tensor has no version counter (nor can it change
        # outside inference mode)
        key = (None if t.is_inference() else t._version, t.data_ptr())
        hit = self._casts.get(dtype)
        if hit is None or hit[0] != key:
            hit = self._casts[dtype] = (key, t.detach().to(dtype))
        return hit[1]


def init_embedding(vocab: int, d: int, *, generator: torch.Generator, device,
                   dtype=torch.float32) -> Embedding:
    return Embedding(torch.randn((vocab, d), generator=generator,
                                 device=device, dtype=dtype) * 0.02)


def apply_embedding(emb: Embedding, tokens):
    return emb(tokens)


def apply_unembedding(emb: Embedding, x, true_vocab: Optional[int] = None):
    """Logits = x @ tableᵀ (a plain dense product).  When the table is padded
    (padded_vocab > true_vocab), the padded columns are masked to a large
    negative so greedy decode can never select them.  A table split over
    the tp ranks by vocabulary rows gives each rank its block of the logits,
    gathered into the whole ``(.., V)`` on every rank (an ``all_reduce`` of
    zero-filled buffers: exact, in float32).  Under grad the gather's
    backward keeps this rank's block of the logits' gradient, and x's
    gradient is summed over the ranks' blocks."""
    if getattr(emb, "tp_sharded", False):
        ctx = get_context()
        logits = ctx.copy_tp(x) @ emb.table_as(x.dtype).T
        logits = ctx.gather_tp(logits.to(torch.float32))
    else:
        logits = x @ emb.table_as(x.dtype).T
    if true_vocab is not None and true_vocab < logits.shape[-1]:
        logits[..., true_vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Gated MLP (dense or DeMM-sparse)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, gate, up, down):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down

    def forward(self, x, policy: Optional[ExecPolicy] = None):
        g = apply_linear(self.gate, x, policy)
        u = apply_linear(self.up, x, policy)
        # SiLU in float32, then back to the activation dtype
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) \
            * u.to(x.dtype)
        return apply_linear(self.down, h, policy)


def init_mlp(d: int, d_ff: int, *, sparse, generator: torch.Generator, device,
             dtype=torch.float32) -> MLP:
    kw = dict(sparse=sparse, generator=generator, device=device, dtype=dtype)
    return MLP(init_linear(d, d_ff, name="gate", **kw),
               init_linear(d, d_ff, name="up", **kw),
               init_linear(d_ff, d, name="down", **kw))


def apply_mlp(mlp: MLP, x, *, policy: Optional[ExecPolicy] = None):
    return mlp(x, policy)
