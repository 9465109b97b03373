"""The active sharding context: the mesh, its groups and this rank's place.

Model code stays mesh-agnostic; the engines install a
:class:`ShardingContext` (:func:`use_mesh`) around every step, and the few
places that need explicit distribution read it: the placed linears
(``core.sparse_linear``), the vocab-parallel embedding and logits
(``models.layers``), attention's local head counts (``models.attention``) and
the pipelined decode step (``models.transformer``).  With no context
installed, everything is single-process.

The JAX package is single-controller: GSPMD places every leaf and inserts
the collectives, and its ``constrain`` is a layout hint.  Here every rank
runs the same program on its own shard (SPMD over ``torch.distributed``), so
the collectives are explicit — :meth:`ShardingContext.all_reduce`,
:meth:`gather` — and the hints become checks (:func:`check_heads`).

Collectives use only ``all_reduce`` (and, in the pipeline, ``send`` /
``recv`` of host tensors): a ``gloo`` group takes CUDA tensors in
``all_reduce`` and ``broadcast`` only.  A gather is therefore an
``all_reduce`` of zero-filled buffers, each rank writing its own block:
adding zeros is exact.  A ``reduce_scatter`` (ZeRO-1's gradient reduction)
is an ``all_reduce`` and then this rank's slice.

Training differentiates through the tensor-parallel collectives, Megatron's
pair of conjugate operators: every tp rank computes the same loss, and a
replicated activation's gradient is the whole, equal on every rank.

* :meth:`ShardingContext.reduce_tp` (a row-parallel product's partial sums;
  the vocab-parallel lookup): forward the sum over tp, backward the
  gradient passed through;
* :meth:`ShardingContext.copy_tp` (the input of a column-parallel product):
  forward the identity, backward the sum over tp of the ranks' partial
  gradients;
* :meth:`ShardingContext.gather_tp` (the vocab-parallel logits, the
  experts' outputs): forward the exact gather, backward this rank's block.

With no gradient recorded they are the serving path's in-place collectives.

A context made on a :class:`CensusMesh` (the dry-run census,
``launch.census``) is one rank's view of a mesh that no process group backs:
:meth:`ShardingContext._all_reduce`, the one place every collective goes
through, records each collective on the mesh (its kind, payload bytes,
calling function and the model function that led to it) and returns the
tensor unchanged.  Nothing else learns of the census.

Long-context decode (``seq_shard_cache``, the JAX package's flag): the dense
KV caches are split by position over ``data`` and attention combines the
ranks' partial softmaxes (``models.attention.combine_partials``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import Optional

import torch


def _records_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _ReduceTP(torch.autograd.Function):
    """Sum over tp; the backward passes the gradient through."""

    @staticmethod
    def forward(fctx, x, ctx):
        return ctx.all_reduce(x.clone())

    @staticmethod
    def backward(fctx, g):
        return g, None


class _CopyTP(torch.autograd.Function):
    """The identity; the backward sums the gradient over tp."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.shctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.shctx.all_reduce(g.clone()), None


class _GatherTP(torch.autograd.Function):
    """The exact gather over tp along ``dim``; the backward keeps this
    rank's block of the gradient."""

    @staticmethod
    def forward(fctx, x, ctx, dim):
        fctx.shctx, fctx.dim = ctx, dim
        return ctx.gather(x, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.shctx.local_block(g, fctx.dim).contiguous(), None, None


class _MeanDP(torch.autograd.Function):
    """The mean over dp; the backward passes the gradient through (the
    step's mean of the ranks' gradients divides it)."""

    @staticmethod
    def forward(fctx, x, ctx):
        return ctx.dp_mean_(x.clone())

    @staticmethod
    def backward(fctx, g):
        return g, None


class CensusMesh:
    """A mesh of ``shape`` and dim ``names`` (``(16, 16)`` ``("data",
    "model")``, or ``(2, 16, 16)`` with ``pod``) seen from the rank at
    coordinate 0 of every dim, with no process group behind it: the
    ``DeviceMesh`` methods the port calls (``mesh_dim_names``, ``size``,
    ``get_local_rank``, ``get_group``, ``get_coordinate``).  A context
    made on it records its collectives in :attr:`records` (``(kind,
    payload bytes, calling function, model function)``) instead of running
    them."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and dim names "
                             f"{tuple(names)} differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)
        self.records = []

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_local_rank(self, name=None) -> int:
        return 0

    def get_group(self, name=None):
        return None

    def get_coordinate(self):
        return [0] * len(self.shape)

    def record(self, kind: str, nbytes: int, name: str, site: str):
        self.records.append((kind, int(nbytes), name, site))


# the context's collective primitives: a recorded collective is named after
# the nearest caller outside them, and placed at the nearest function of
# the models that led to it, past the shared linear (the caller's name where
# none did)
_PRIMITIVES = frozenset(("_all_reduce", "all_reduce", "gather", "dp_reduce_"))
_MODELS = os.path.join("repro_torch", "models", "")


def _caller_names():
    f = sys._getframe(2)
    while f is not None and f.f_code.co_name in _PRIMITIVES:
        f = f.f_back
    name = f.f_code.co_qualname if f is not None else "?"
    while f is not None and (_MODELS not in f.f_code.co_filename
                             or f.f_code.co_name == "apply_linear"):
        f = f.f_back
    return name, (f.f_code.co_qualname if f is not None else name)


@dataclasses.dataclass
class ShardingContext:
    """One rank's view of a mesh.  ``tp`` / ``pp`` are the degrees of the
    ``model`` and ``pipe`` dims, ``*_rank`` this rank's coordinate on them
    and ``*_group`` the process group along them (None at degree 1)."""

    mesh: object = None            # torch.distributed DeviceMesh
    tp: int = 1
    tp_rank: int = 0
    tp_group: object = None
    pp: int = 1
    pp_rank: int = 0
    pp_group: object = None
    pp_ranks: tuple = ()           # global ranks of this rank's pipe dim
    shard_heads: bool = True       # num_kv_heads % tp == 0
    num_heads: int = 0
    num_kv_heads: int = 0
    dp: int = 1
    dp_rank: int = 0
    dp_group: object = None
    seq_shard_cache: bool = False  # dense KV caches split by position over dp
    collectives: int = 0           # collectives issued through this context
    collective_bytes: int = 0      # their payload (float32 for 16-bit data)

    @property
    def transport_on_host(self) -> bool:
        """Whether point-to-point traffic must go through host tensors
        (``gloo``: its ``send`` / ``recv`` take CPU tensors only)."""
        import torch.distributed as dist
        return dist.get_backend(self.pp_group) == "gloo"

    @property
    def q_heads_split(self) -> bool:
        """Whether the query heads split over tp (else attention runs
        whole on every rank: the JAX package's ``_constrain_heads`` case
        3)."""
        return self.num_heads % self.tp == 0

    def local_heads(self) -> int:
        """This rank's query heads: its block when they split over tp, all
        of them when they do not (q, k and v gathered)."""
        return self.num_heads // self.tp if self.q_heads_split \
            else self.num_heads

    def local_kv_heads(self) -> int:
        """This rank's KV heads: its block when they split over tp, all of
        them when they do not (k and v gathered, or wk / wv replicated)."""
        return self.num_kv_heads // self.tp if self.shard_heads \
            else self.num_kv_heads

    def check_head_counts(self):
        """The head counts checked before anything is split: the query
        heads must form whole groups of the KV heads."""
        if self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.num_heads} query heads do not form "
                             f"groups of {self.num_kv_heads} KV heads")

    def kv_head_index(self) -> Optional[torch.Tensor]:
        """For whole K/V (KV heads that do not split over tp) beside split
        query heads: the KV head each local query head reads (None when the
        local K/V already line up with the local query heads)."""
        if self.shard_heads or not self.q_heads_split:
            return None
        hq, group = self.local_heads(), self.num_heads // self.num_kv_heads
        first = self.tp_rank * hq
        return torch.arange(first, first + hq) // group

    def _all_reduce(self, y: torch.Tensor, group, op=None) -> torch.Tensor:
        """``op`` (a sum by default) of ``y`` over ``group``, in place;
        returns it.  A 16-bit tensor is reduced in float32 (``gloo`` sums
        float32; the values round once, on the way back)."""
        import torch.distributed as dist
        op = dist.ReduceOp.SUM if op is None else op
        wide_bytes = y.numel() * 4 \
            if y.dtype in (torch.bfloat16, torch.float16) else y.nbytes
        self.collectives += 1
        self.collective_bytes += wide_bytes
        if isinstance(self.mesh, CensusMesh):
            self.mesh.record("all-reduce", wide_bytes, *_caller_names())
            return y
        if y.dtype in (torch.bfloat16, torch.float16):
            wide = y.to(torch.float32)
            dist.all_reduce(wide, op=op, group=group)
            return y.copy_(wide)
        dist.all_reduce(y, op=op, group=group)
        return y

    def all_reduce(self, y: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``y`` over the tp group, in place; returns it."""
        return self._all_reduce(y, self.tp_group, op)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate every tp rank's ``x`` along ``dim`` in rank order
        (an ``all_reduce`` of zero-filled buffers: exact)."""
        dim = dim % x.ndim
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.tp
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, self.tp_rank * n, n).copy_(x)
        return self.all_reduce(full)

    def dp_reduce_(self, y: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``y`` over the dp group, in place; returns it."""
        return self._all_reduce(y, self.dp_group, op)

    def reduce_tp(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of ``y`` over tp: in place when no gradient is recorded,
        else a new tensor whose backward passes the gradient through."""
        if self.tp == 1:
            return y
        if _records_grad(y):
            return _ReduceTP.apply(y, self)
        return self.all_reduce(y)

    def copy_tp(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, whose gradient is summed over tp (the input of a
        column-parallel product under grad)."""
        if self.tp == 1 or not _records_grad(x):
            return x
        return _CopyTP.apply(x, self)

    def gather_tp(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """:meth:`gather`, whose backward keeps this rank's block of the
        gradient."""
        if self.tp == 1:
            return x
        if _records_grad(x):
            return _GatherTP.apply(x, self, dim % x.ndim)
        return self.gather(x, dim)

    def dp_mean_(self, y: torch.Tensor) -> torch.Tensor:
        """The mean of ``y`` over the dp group, in place; returns it."""
        if self.dp > 1:
            self._all_reduce(y, self.dp_group).div_(self.dp)
        return y

    def dp_mean(self, y: torch.Tensor) -> torch.Tensor:
        """The mean of ``y`` over dp as a new tensor; under grad its
        backward passes the gradient through (the MoE aux loss)."""
        if self.dp == 1:
            return y
        if _records_grad(y):
            return _MeanDP.apply(y, self)
        return self.dp_mean_(y.clone())

    def dp_gather_(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every dp rank's block of ``t`` along ``dim`` into ``t`` (this
        rank's block written, the others' summed in from zero-filled
        buffers: exact), in place; returns it."""
        n = t.shape[dim] // self.dp
        full = torch.zeros_like(t)
        full.narrow(dim, self.dp_rank * n, n).copy_(
            t.narrow(dim, self.dp_rank * n, n))
        return t.copy_(self._all_reduce(full, self.dp_group))

    def local_block(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a whole ``y`` along ``dim``."""
        n = y.shape[dim]
        if n % self.tp:
            raise ValueError(f"dim of {n} does not split over tp={self.tp}")
        n //= self.tp
        return y.narrow(dim, self.tp_rank * n, n)


_CTX: Optional[ShardingContext] = None


def get_context() -> Optional[ShardingContext]:
    return _CTX


@contextlib.contextmanager
def use_mesh(ctx: ShardingContext):
    """Install ``ctx`` for the duration of the block (the engines wrap every
    step in it)."""
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield ctx
    finally:
        _CTX = prev


def make_context(mesh, *, num_kv_heads: int = 16, num_heads: int = 0,
                 seq_shard_cache: bool = False) -> ShardingContext:
    """This rank's :class:`ShardingContext` on ``mesh`` (a DeviceMesh, or a
    :class:`CensusMesh`, whose dims are named ``model`` and optionally
    ``pipe`` and ``data``).  ``seq_shard_cache``: long-context decode, the
    dense KV caches split by position over ``data``."""
    names = mesh.mesh_dim_names
    if "pod" in names:
        raise NotImplementedError(
            "a 'pod' mesh dim: the port's contexts take dp over 'data' only")

    def dim(name):
        if name not in names:
            return 1, 0, None
        return (mesh.size(names.index(name)), mesh.get_local_rank(name),
                mesh.get_group(name))

    tp, tp_rank, tp_group = dim("model")
    pp, pp_rank, pp_group = dim("pipe")
    dp, dp_rank, dp_group = dim("data")
    pp_ranks = ()
    if pp > 1:
        import torch.distributed as dist
        pp_ranks = tuple(dist.get_process_group_ranks(pp_group))
    return ShardingContext(
        mesh=mesh, tp=tp, tp_rank=tp_rank,
        tp_group=tp_group if tp > 1 else None,
        pp=pp, pp_rank=pp_rank, pp_group=pp_group, pp_ranks=pp_ranks,
        shard_heads=num_kv_heads % tp == 0,
        num_heads=num_heads or num_kv_heads, num_kv_heads=num_kv_heads,
        dp=dp, dp_rank=dp_rank, dp_group=dp_group if dp > 1 else None,
        seq_shard_cache=seq_shard_cache)


def check_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """The counterpart of the JAX package's ``constrain`` on a (B, S, H, Dh)
    tensor: there a GSPMD layout hint, here a check that the head axis holds
    the count this rank computes with (its local heads under a context).
    Returns ``x``."""
    if x.shape[2] != heads:
        raise ValueError(f"head axis holds {x.shape[2]} heads, expected "
                         f"{heads} on this rank")
    return x
