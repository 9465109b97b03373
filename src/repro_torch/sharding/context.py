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
adding zeros is exact.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


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
    kv_replicated: bool = False    # wk / wv whole on every rank

    @property
    def transport_on_host(self) -> bool:
        """Whether point-to-point traffic must go through host tensors
        (``gloo``: its ``send`` / ``recv`` take CPU tensors only)."""
        import torch.distributed as dist
        return dist.get_backend(self.pp_group) == "gloo"

    def local_heads(self) -> int:
        """This rank's query heads."""
        if self.num_heads % self.tp:
            raise NotImplementedError(
                f"{self.num_heads} query heads do not split over tp="
                f"{self.tp}; the head-dim fallback of the JAX package is not "
                "ported")
        return self.num_heads // self.tp

    def local_kv_heads(self) -> int:
        """This rank's KV heads: its block when the KV heads split over tp,
        all of them when wk / wv are replicated and they do not."""
        if self.shard_heads:
            return self.num_kv_heads // self.tp
        if self.kv_replicated:
            return self.num_kv_heads
        raise NotImplementedError(
            f"{self.num_kv_heads} KV heads do not split over tp={self.tp}: "
            "serve this arch under ShardingPlan(attn_kv_replicated=True) "
            "(the JAX package's head-dim fallback is not ported)")

    def kv_head_index(self) -> Optional[torch.Tensor]:
        """For replicated K/V whose heads do not split over tp: the KV head
        each local query head reads (None when the local K/V already line up
        with the local query heads)."""
        if self.shard_heads:
            return None
        hq, group = self.local_heads(), self.num_heads // self.num_kv_heads
        first = self.tp_rank * hq
        return torch.arange(first, first + hq) // group

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum ``y`` over the tp group, in place; returns it.  A 16-bit
        tensor is summed in float32 (``gloo`` sums float32; the values
        round once, on the way back)."""
        import torch.distributed as dist
        if y.dtype in (torch.bfloat16, torch.float16):
            wide = y.to(torch.float32)
            dist.all_reduce(wide, group=self.tp_group)
            return y.copy_(wide)
        dist.all_reduce(y, group=self.tp_group)
        return y

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
                 kv_replicated: bool = False) -> ShardingContext:
    """This rank's :class:`ShardingContext` on ``mesh`` (a DeviceMesh whose
    dims are named ``model`` and optionally ``pipe``)."""
    names = mesh.mesh_dim_names

    def dim(name):
        if name not in names:
            return 1, 0, None
        return (mesh.size(names.index(name)), mesh.get_local_rank(name),
                mesh.get_group(name))

    tp, tp_rank, tp_group = dim("model")
    pp, pp_rank, pp_group = dim("pipe")
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
        kv_replicated=kv_replicated)


def check_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """The counterpart of the JAX package's ``constrain`` on a (B, S, H, Dh)
    tensor: there a GSPMD layout hint, here a check that the head axis holds
    the count this rank computes with (its local heads under a context).
    Returns ``x``."""
    if x.shape[2] != heads:
        raise ValueError(f"head axis holds {x.shape[2]} heads, expected "
                         f"{heads} on this rank")
    return x
