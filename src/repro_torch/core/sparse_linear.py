"""SparseLinear — the paper's technique as a first-class layer.

One entry point,

    y = apply(node, x, policy)

where ``node`` is either

* a :class:`SparseLinear` — the dense/masked form: a dense ``w (O, K)``
  parameter plus an optional :class:`SparsityConfig` applied as a mask in the
  forward pass, or
* a :class:`~repro_torch.core.sparsity.PackedWeight` — the DeMM packed
  serving form, whose forward pass streams only packed bytes,

and :class:`ExecPolicy` carries the execution choice (``mode`` for
dense-weight nodes, kernel ``backend``, optional sparsity-config overrides).

``pack_params`` converts a masked layer to a ``PackedWeight``.  The matmul
convention is ``y = x @ W^T`` with W of shape (out, in): W is the sparse
matrix A of the paper (row-sparse along the contraction dim) and the
activations are the dense matrix B.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.core.pruning import masked_weight
from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    LAYOUT_XWT,
    PackedWeight,
    SparsityConfig,
    pack,
    pack_block,
    prune,
)
from repro_torch.sharding.context import get_context

MODES = ("dense", "masked", "packed")


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """How a (sparse) linear is executed.

    * ``mode``    — ``dense`` | ``masked`` | ``packed``.  Only meaningful for
      dense-weight nodes (``dense`` skips the N:M mask, ``masked``/``packed``
      apply it); a :class:`PackedWeight` node always executes the packed
      DeMM path regardless of mode.
    * ``backend`` — kernel backend for packed matmuls: any name registered
      in ``repro_torch.tune`` (``reference``, ``cuda``).
    * ``cfg_overrides`` — optional :class:`SparsityConfig` field overrides
      (e.g. ``{"k": 2}``) applied to the node's stored config before the
      mask/kernel runs.  For packed nodes the override must preserve
      ``n_effective`` (the packed array layout is fixed at pack time).
    * ``plan`` — an optional ``repro_torch.sharding.ShardingPlan``: the
      engines place the model and its decode state by it
      (``serve.protocol.EngineBase._setup_plan``).

    Hashable; ``cfg_overrides`` dicts are normalized to sorted item tuples.
    """

    mode: str = "masked"
    backend: str = "reference"
    cfg_overrides: Union[tuple, Mapping[str, int]] = ()
    plan: Optional[object] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected {MODES}")
        if isinstance(self.cfg_overrides, Mapping):
            object.__setattr__(self, "cfg_overrides",
                               tuple(sorted(self.cfg_overrides.items())))
        else:
            object.__setattr__(self, "cfg_overrides",
                               tuple(self.cfg_overrides))

    def replace(self, **kw) -> "ExecPolicy":
        return dataclasses.replace(self, **kw)

    def resolve_cfg(self, cfg: SparsityConfig) -> SparsityConfig:
        if not self.cfg_overrides:
            return cfg
        return dataclasses.replace(cfg, **dict(self.cfg_overrides))


DEFAULT_POLICY = ExecPolicy()
DENSE_POLICY = ExecPolicy(mode="dense")


def resolve_policy(policy: Optional[ExecPolicy] = None,
                   mode: Optional[str] = None,
                   backend: Optional[str] = None) -> ExecPolicy:
    """Normalize the (policy | mode/backend kwargs) calling conventions into
    one :class:`ExecPolicy`."""
    if policy is not None:
        if mode is not None or backend is not None:
            raise ValueError(
                "pass either policy= or the mode=/backend= kwargs, not both")
        return policy
    if mode is None and backend is None:
        return DEFAULT_POLICY
    return ExecPolicy(mode=mode or DEFAULT_POLICY.mode,
                      backend=backend or DEFAULT_POLICY.backend)


# ---------------------------------------------------------------------------
# The dense / masked node, and its init
# ---------------------------------------------------------------------------

class SparseLinear(nn.Module):
    """Dense-weight linear node: ``w (O, K)`` plus the optional N:M pattern
    (``sparsity``) that masked execution applies and packing uses."""

    def __init__(self, w: torch.Tensor,
                 sparsity: Optional[SparsityConfig] = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.sparsity = sparsity

    def extra_repr(self) -> str:
        sp = self.sparsity.pattern_name() if self.sparsity else None
        return f"w={tuple(self.w.shape)}, sparsity={sp!r}"

    def forward(self, x, policy: Optional[ExecPolicy] = None):
        return apply(self, x, policy)


def init_dense(in_features: int, out_features: int, *,
               generator: torch.Generator, device, dtype=torch.float32,
               scale: Optional[float] = None) -> SparseLinear:
    scale = scale if scale is not None else in_features ** -0.5
    w = torch.randn((out_features, in_features), generator=generator,
                    device=device, dtype=dtype) * scale
    return SparseLinear(w)


def init_sparse(in_features: int, out_features: int, cfg: SparsityConfig, *,
                generator: torch.Generator, device, dtype=torch.float32,
                scale: Optional[float] = None) -> SparseLinear:
    """Initialize a masked-mode sparse linear (dense weight pre-pruned to the
    pattern, which is also applied in the forward pass)."""
    node = init_dense(in_features, out_features, generator=generator,
                      device=device, dtype=dtype, scale=scale)
    return SparseLinear(prune(node.w.data, cfg), cfg)


def node_sparsity(node) -> Optional[SparsityConfig]:
    """The SparsityConfig of a linear node, or None for a plain dense one."""
    if isinstance(node, PackedWeight):
        return node.cfg
    return getattr(node, "sparsity", None)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def apply(node, x: torch.Tensor,
          policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """Unified linear application: dense, masked, or packed-DeMM, chosen by
    the node's type and the :class:`ExecPolicy`.  A node that
    ``ShardingPlan.shard_params`` placed (``tp_kind`` set) runs its part of
    the tensor-parallel product (:func:`_apply_placed`)."""
    policy = policy or DEFAULT_POLICY
    kind = getattr(node, "tp_kind", None)
    if kind is not None:
        return _apply_placed(node, x, policy, kind)
    return _apply_local(node, x, policy)


def _apply_local(node, x, policy: ExecPolicy, reduce=None):
    """The node's product on this rank's tensors; ``reduce`` (a sharding
    context) sums the partial products over its tp group first, in
    float32."""
    if isinstance(node, PackedWeight):
        return _apply_packed(node, x, policy, reduce)
    cfg = node_sparsity(node)
    if cfg is None or policy.mode == "dense":
        y = apply_dense(node, x)
    else:
        y = apply_masked(node, x, policy.resolve_cfg(cfg))
    if reduce is not None:
        y = reduce.reduce_tp(y.to(torch.float32)).to(x.dtype)
    return y


# what ``ShardingPlan.shard_params`` sets on a placed linear (a view of a
# node that shares its tensors, a draft tier's, carries them too)
PLACEMENT_ATTRS = ("tp_kind", "tp_sharded", "tp_gather")


def _in_features(node) -> int:
    return node.in_features if isinstance(node, PackedWeight) \
        else node.w.shape[1]


def _apply_placed(node, x, policy: ExecPolicy, kind: str):
    """Megatron-style application of a placed linear on this rank.  ``col``:
    x whole, the output this rank's block of rows (a node left whole
    computes all of them and keeps its block); with ``tp_gather`` (a
    projection whose consumer runs whole on every rank: the mixers' and
    frontends' inputs, q / k / v whose heads do not split over tp) the
    whole output, gathered from the blocks.  ``row``: x this rank's chunk
    of the contraction dim (a whole x is cut to it) and the partial
    products summed over the tp group (a node left whole gathers a chunk
    and needs no sum).  ``replicated``: x whole, the output whole.  Under
    grad the collectives are the context's differentiable ones: a
    column-parallel input's gradient is summed over tp, a row-parallel sum
    passes its gradient through, a gathered x keeps this rank's block of
    its gradient."""
    ctx = get_context()
    if ctx is None or ctx.tp == 1:
        raise RuntimeError(
            f"a linear placed as {kind!r} by a sharding plan ran outside its "
            "sharding context (the engines install it around every step)")
    sharded = node.tp_sharded
    if kind == "row":
        fits = x.shape[-1] == _in_features(node)
        if sharded:
            return _apply_local(node, x if fits else ctx.local_block(x),
                                policy, reduce=ctx)
        return _apply_local(node, x if fits else ctx.gather_tp(x), policy)
    if kind == "col" and sharded:
        y = _apply_local(node, ctx.copy_tp(x), policy)
        return ctx.gather_tp(y) if node.tp_gather else y
    y = _apply_local(node, x, policy)
    if kind == "col" and not node.tp_gather:
        return ctx.local_block(y)
    return y


def apply_dense(node: SparseLinear, x: torch.Tensor) -> torch.Tensor:
    return x @ node.w.to(x.dtype).T


def apply_masked(node: SparseLinear, x: torch.Tensor,
                 cfg: SparsityConfig) -> torch.Tensor:
    return x @ masked_weight(node.w, cfg).to(x.dtype).T


def _reconfigure(pw: PackedWeight, cfg: SparsityConfig) -> PackedWeight:
    """Re-tag a packed weight with ``cfg``, allowing only layout-preserving
    (same n_effective, same m) reconfigurations — the packed array shape is
    fixed at pack time.  Both layouts: the block geometry and address stream
    are carried over unchanged."""
    if cfg == pw.cfg:
        return pw
    if cfg.n_effective != pw.cfg.n_effective or cfg.m != pw.cfg.m:
        raise ValueError(
            f"config {cfg.pattern_name()} changes the packed layout of a "
            f"{pw.cfg.pattern_name()} weight; only n_effective-preserving "
            "reconfigurations apply to an already-packed weight")
    return pw.replace(cfg=cfg)


def _apply_packed(pw: PackedWeight, x: torch.Tensor,
                  policy: ExecPolicy, reduce=None) -> torch.Tensor:
    from repro_torch.kernels import ops

    pw = _reconfigure(pw, policy.resolve_cfg(pw.cfg))
    xs = x.reshape(-1, x.shape[-1]).contiguous()
    y = ops.demm_matmul_packed(xs, pw, backend=policy.backend)
    if reduce is not None:      # the kernels' float32 partial products
        y = reduce.reduce_tp(y)
    return y.reshape(*x.shape[:-1], pw.out_features).to(x.dtype)


def apply_packed(pw: PackedWeight, x: torch.Tensor,
                 cfg: Optional[SparsityConfig] = None,
                 backend: str = "reference") -> torch.Tensor:
    """Packed application of a :class:`PackedWeight`, re-tagged with
    ``cfg`` first when one is given (an ``n_effective``-preserving
    reconfiguration, :func:`_reconfigure`).  New code should call
    :func:`apply` with ``ExecPolicy(backend=...)``."""
    if not isinstance(pw, PackedWeight):
        raise TypeError(f"apply_packed expects a PackedWeight, got "
                        f"{type(pw)}")
    if cfg is not None:
        pw = _reconfigure(pw, cfg)
    return _apply_packed(pw, x, ExecPolicy(mode="packed", backend=backend))


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_params(node: SparseLinear,
                cfg: Optional[SparsityConfig] = None,
                layout: str = LAYOUT_XWT, *, block_r: Optional[int] = None,
                a_max: Optional[int] = None) -> PackedWeight:
    """Convert a masked layer to the packed DeMM serving form.

    ``layout="block"`` runs the two-level conversion
    (``core.sparsity.pack_block``, which selects the top-``n_effective`` of
    every (row, group) itself, as the JAX package's block packer does) with
    ``block_r`` rows per row block and ``a_max`` list slots (both derived
    from the weight when left open)."""
    cfg = cfg or node_sparsity(node)
    if cfg is None:
        raise ValueError("pack_params needs a SparsityConfig (node carries "
                         "no sparsity metadata and none was passed)")
    if layout == LAYOUT_BLOCK:
        return pack_block(node.w.data, cfg, block_r=block_r, a_max=a_max)
    if layout != LAYOUT_XWT:
        raise ValueError(f"unknown layout {layout!r}")
    w = prune(node.w.data, cfg)
    packed = pack(w, cfg)
    return PackedWeight(packed.values, packed.indices, cfg=cfg,
                        dense_shape=w.shape, layout=LAYOUT_XWT)


def sparse_weights(model: nn.Module) -> dict:
    """``{dotted name of the weight: SparsityConfig}`` of every masked-form
    sparse linear (a :class:`SparseLinear` with a pattern) in ``model``, in
    module order: the nodes that premasking, scheduled masks, fake
    quantization and packing act on.  Packed nodes are not listed."""
    return {f"{name}.w" if name else "w": mod.sparsity
            for name, mod in model.named_modules()
            if isinstance(mod, SparseLinear) and mod.sparsity is not None}
