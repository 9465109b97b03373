"""ShardingPlan: one serializable object describing how a model is placed.

A :class:`ShardingPlan` gathers the parallelism degrees (``tp`` / ``pp`` /
``dp``), the KV-replication policy for archs whose KV head count does not
divide tp, and per-node kind overrides (regex -> col / row / replicated).
Plans are frozen and hashable (they ride on ``ExecPolicy``) and round-trip
through JSON at the JAX package's version (they ride in the checkpoint
manifest); the JSON's mesh dim names and renumber policy are the JAX
package's defaults, written and accepted as constants.  ``dp`` is carried
for the checkpoint manifest and the mesh; the engines take the plan's tp x
pp slice (data parallelism in serving is ``serve.router.ReplicaRouter``).

Placement is SPMD: one process per rank, each holding only its shard.
:meth:`ShardingPlan.make_mesh` builds a ``torch.distributed`` DeviceMesh from
the initialised default process group; :meth:`shard_params` renumbers the
row-parallel packed weights and then keeps, on this rank, only its block of
every tensor per :meth:`param_specs` — what ``device_put`` with a
``NamedSharding`` leaves on one device in the JAX package — and marks each
linear with its kind (``tp_kind``) and whether it holds a block
(``tp_sharded``), which ``core.sparse_linear.apply`` reads.  Under ``pp``
each rank keeps only its stage's layers.

Training (:meth:`ShardingPlan.place_for_training`) places the same blocks,
records where each tensor of the placed model is split, and returns a
:class:`TrainLayout`: the ZeRO-1 blocks of the moments on this dp rank
(``partitioning.opt_state_specs``), the batch rows of this dp rank, the
gradients' mean over dp, the global norm of a tree split over tp, the
exact gather of the updated blocks over dp and of whole leaves over tp (a
checkpoint), all on ``all_reduce`` (an ``all_reduce`` and a slice stands
for ``reduce_scatter``, which ``gloo`` lacks).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import torch
from torch import nn

from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    PackedWeight,
    shard_packed_row_parallel,
    shard_slice,
)
from repro_torch.sharding import context as shctx
from repro_torch.sharding.partitioning import (
    Spec,
    StackSpec,
    _linear_kind_impl,
    _param_specs_impl,
    path_of,
    spec_block,
)

# the mesh dim names and renumber policy of the JAX package's default plan:
# the rule table and the context name these dims, and row-parallel packed
# weights are always renumbered
TP_AXIS, PP_AXIS, DP_AXIS = "model", "pipe", "data"
RENUMBER = "renumber"

_PLAN_VERSION = 1


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialised)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DroppedLayer(nn.Module):
    """What a pipeline rank keeps of a layer another stage owns: nothing."""


def _set_module(root: nn.Module, name: str, new: nn.Module):
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, new)


def _block(t: torch.Tensor, spec, rank: int, degree: int, axis: str):
    """This rank's block of ``t`` along every dim ``spec`` splits over
    ``axis`` (a copy, so that the whole tensor can be freed)."""
    for d, ax in enumerate(spec):
        if ax == axis:
            n = t.shape[d] // degree
            t = t.narrow(d, rank * n, n)
    return t.clone()


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How a model's params, decode state and collectives are laid out.

    ``kind_overrides`` is a tuple of ``(path_regex, kind)`` pairs checked
    before the rule table (first match wins); kinds are ``"col"`` /
    ``"row"`` / ``"replicated"``.  Row-parallel packed weights are
    renumbered when ``tp > 1`` (the per-shard active-group pass), so that
    their contraction dim really splits.
    """

    tp: int = 1
    pp: int = 1
    dp: int = 1
    attn_kv_replicated: bool = False
    kind_overrides: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        for name in ("tp", "pp", "dp"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        object.__setattr__(
            self, "kind_overrides",
            tuple((str(p), str(k)) for p, k in self.kind_overrides))
        for _, k in self.kind_overrides:
            if k not in ("col", "row", "replicated"):
                raise ValueError(f"bad kind override {k!r}")

    # -- geometry -----------------------------------------------------------

    def device_degree(self) -> int:
        return self.tp * self.pp * self.dp

    def make_mesh(self):
        """The ``(dp, pp, tp)`` DeviceMesh over the default process group's
        first ranks, or None for a plan of degree 1.  Dims are named as in
        the JAX package; ``model`` is always there, ``data`` and ``pipe``
        only at a degree above 1.  A plan of more ranks than the world
        (a world of one process included) raises: nothing runs a multi-rank
        plan on fewer ranks."""
        n = self.device_degree()
        if n == 1:
            return None
        world = world_size()
        if world < n:
            raise ValueError(
                f"plan needs {n} ranks (tp={self.tp} pp={self.pp} "
                f"dp={self.dp}), only {world} in the process group; start "
                f"one process per rank (torchrun --nproc-per-node {n})")
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
        shape, names = [], []
        for degree, name in ((self.dp, DP_AXIS), (self.pp, PP_AXIS)):
            if degree > 1:
                shape.append(degree)
                names.append(name)
        shape.append(self.tp)
        names.append(TP_AXIS)
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if world == n:
            return init_device_mesh(device_type, tuple(shape),
                                    mesh_dim_names=tuple(names))
        return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                          mesh_dim_names=tuple(names))

    def context(self, mesh, *, num_kv_heads: int = 16,
                num_heads: int = 0) -> shctx.ShardingContext:
        """This rank's ShardingContext on ``mesh``, to install
        (``shctx.use_mesh``) around every step."""
        return shctx.make_context(mesh, num_kv_heads=num_kv_heads,
                                  num_heads=num_heads,
                                  kv_replicated=self.attn_kv_replicated)

    # -- classification / specs --------------------------------------------

    def linear_kind(self, path: str) -> str:
        """col / row / replicated of a linear module path: the overrides
        first, then the shared rule table."""
        for pat, kind in self.kind_overrides:
            if re.search(pat, path):
                return kind
        return _linear_kind_impl(
            path, attn_kv_replicated=self.attn_kv_replicated)

    def _axis_degree(self, name) -> int:
        return {TP_AXIS: self.tp, PP_AXIS: self.pp,
                DP_AXIS: self.dp}.get(name, 1)

    def param_specs(self, model) -> dict:
        """``{path: Spec}`` of every tensor of ``model`` under this plan
        (``{module path: {tensor name: Spec}}`` for a PackedWeight).  Call
        on the renumbered model (:meth:`renumber_params`).  Specs are
        sanitised against the tensors' shapes: a dim the rule table would
        split whose size does not divide the degree stays whole (a block
        weight of one row block under tp 2, say)."""
        specs = _param_specs_impl(
            model, attn_kv_replicated=self.attn_kv_replicated,
            kind_fn=self.linear_kind)
        tensors = {path_of(n): t for n, t in list(model.named_parameters())
                   + list(model.named_buffers())}

        def sane(spec, shape):
            parts = list(spec) + [None] * (len(shape) - len(spec))
            return Spec(*(ax if ax is None
                          or shape[i] % self._axis_degree(ax) == 0 else None
                          for i, ax in enumerate(parts)))

        return {p: ({c: sane(s, tensors[f"{p}/{c}"].shape)
                     for c, s in spec.items()} if isinstance(spec, dict)
                    else sane(spec, tensors[p].shape))
                for p, spec in specs.items()}

    # -- packed-weight renumbering -----------------------------------------

    def renumber_params(self, model):
        """Rewrite, in place, every row-parallel PackedWeight of ``model``
        into the shard-stacked, locally renumbered form
        (:func:`~repro_torch.core.sparsity.shard_packed_row_parallel`), so
        that its contraction dim splits over the ``model`` dim.  Returns
        ``model``.  No-op at ``tp == 1``.  Nodes the pass cannot shard stay
        whole: group count not a multiple of ``tp``, already shard-stacked
        nodes, int8 block nodes (as in the JAX package)."""
        if self.tp == 1:
            return model
        for name, pw in list(model.named_modules()):
            if (not isinstance(pw, PackedWeight) or pw.shard_axis is not None
                    or self.linear_kind(path_of(name)) != "row"
                    or pw.groups % self.tp
                    or (pw.layout == LAYOUT_BLOCK and pw.qdtype is not None)):
                continue
            _set_module(model, name, shard_packed_row_parallel(
                pw, self.tp, axis=TP_AXIS))
        return model

    def shard_params(self, model, mesh=None):
        """Renumber ``model`` (:meth:`renumber_params`) and, on a mesh, keep
        only this rank's block of every tensor (in place; returns
        ``model``).  Without a mesh the renumbered model stays whole: its
        shard-stacked weights then run the sequential sum over their slices
        (``ops._demm_matmul_sharded``'s meshless path)."""
        model = self.renumber_params(model)
        if mesh is None:
            return model
        ctx = self.context(mesh)
        if ctx.tp > 1:
            self._keep_tp_blocks(model, ctx.tp_rank)
        if ctx.pp > 1:
            self._keep_stage(model, ctx.pp_rank)
        return model

    def place_for_training(self, model, mesh) -> "TrainLayout":
        """Place ``model`` for a training step under this plan (in place:
        this rank's tp blocks, every one a training tensor) and return its
        :class:`TrainLayout` on ``mesh``.  A model placed before under the
        same plan is not placed again.  What the step cannot differentiate
        under tp raises ``NotImplementedError`` by name: a family other
        than the decoder LM or a frontend, wk / wv replicated, a
        column-parallel linear left whole (its gradient would be partial on
        every rank); and a pipeline dim (the step is data x model, as the
        JAX package's)."""
        if self.pp > 1:
            raise NotImplementedError(
                "a train step under pp > 1: the step runs data x model, as "
                "the JAX package's (sharding.pipeline.pipeline_apply is the "
                "differentiable schedule)")
        cfg = getattr(model, "cfg", None)
        if self.tp > 1 and (type(model).__name__ != "DecoderLM"
                            or cfg.frontend is not None):
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) under tp={self.tp}: distributed "
                "training covers the decoder LM (dense and MoE); Mamba2's "
                "and xLSTM's split state and the frontends are not ported")
        if self.tp > 1 and (self.attn_kv_replicated
                            or cfg.num_kv_heads % self.tp):
            raise NotImplementedError(
                f"{cfg.num_kv_heads} KV heads over tp={self.tp} with wk / "
                "wv replicated: a training step needs the KV heads split")
        if mesh is None or mesh.get_coordinate() is None:
            raise ValueError("place_for_training needs a mesh this rank is "
                             "in (ShardingPlan.make_mesh)")
        ctx = self.context(mesh, num_kv_heads=cfg.num_kv_heads,
                           num_heads=cfg.num_heads)
        if getattr(model, "placed_plan", None) != self:
            self.shard_params(model, mesh)
            model.placed_plan = self
        whole = [n for n, m in model.named_modules()
                 if getattr(m, "tp_kind", None) == "col"
                 and not m.tp_sharded]
        if whole:
            raise NotImplementedError(
                f"column-parallel {whole[:4]} left whole (its output rows "
                f"do not split over tp={self.tp}): its gradient would be "
                "partial on every rank")
        return TrainLayout(ctx, model)

    def _keep_tp_blocks(self, model, rank: int):
        from repro_torch.core.sparse_linear import SparseLinear
        from repro_torch.models.layers import Embedding
        from repro_torch.models.moe import MoE

        tp, axis = self.tp, TP_AXIS
        specs = self.param_specs(model)
        handled = set()
        # where each tensor of the placed model is split: dotted name ->
        # (its split dim, or None; whether it is a slice of a shard stack)
        placement = {}

        def keep(mod, attr, spec, name):
            setattr(mod, attr, nn.Parameter(
                _block(getattr(mod, attr).data, spec, rank, tp, axis),
                requires_grad=False))
            placement[name] = (spec.index(axis), False)

        for name, mod in list(model.named_modules()):
            p = path_of(name)
            dotted = f"{name}." if name else ""
            if isinstance(mod, PackedWeight):
                new, sharded = self._local_packed(mod, specs[p], rank)
                new.tp_kind, new.tp_sharded = self.linear_kind(p), sharded
                _set_module(model, name, new)
                for c, spec in specs[p].items():
                    if mod.shard_axis is not None:
                        placement[dotted + c] = (None, True)
                    elif axis in spec:
                        placement[dotted + c] = (spec.index(axis), False)
                handled.add(p)
            elif isinstance(mod, SparseLinear):
                spec = specs[f"{p}/w"]
                mod.tp_kind = self.linear_kind(p)
                mod.tp_sharded = axis in spec
                if mod.tp_sharded:
                    self._check_whole_groups(mod, spec, name)
                    keep(mod, "w", spec, dotted + "w")
                handled.add(f"{p}/w")
            elif isinstance(mod, Embedding):
                spec = specs[f"{p}/table"]
                if axis in spec:
                    keep(mod, "table", spec, dotted + "table")
                    mod._casts.clear()
                    mod.tp_sharded = True
                handled.add(f"{p}/table")
            elif isinstance(mod, MoE):
                # expert parallelism: this rank's E / tp experts
                # (models.moe._apply_moe_ep); whole when E does not split
                mod.tp_sharded = False
                for attr in ("w_gate", "w_up", "w_down"):
                    spec = specs[f"{p}/{attr}"]
                    if axis in spec:
                        keep(mod, attr, spec, dotted + attr)
                        mod.tp_sharded = True
                    handled.add(f"{p}/{attr}")
        model.tp_placement = placement
        left = [p for p, s in specs.items() if p not in handled
                and not isinstance(s, dict) and axis in s]
        if left:
            raise NotImplementedError(
                f"tensors {left[:4]} split over {axis!r} outside a linear or "
                "an embedding (a family the port does not serve under tp)")

    def _check_whole_groups(self, lin, spec, name: str):
        """A row-split masked weight's block must hold whole N:M groups
        (``layers.linear_sparsity`` aligns M to K / 16), or its mask would
        straddle the ranks."""
        cfg = lin.sparsity
        if cfg is None or spec.index(TP_AXIS) != 1:
            return
        k = lin.w.shape[1] // self.tp
        if k % cfg.m:
            raise ValueError(
                f"{name}: a block of {k} of its {lin.w.shape[1]} input "
                f"features over tp={self.tp} does not hold whole groups of "
                f"M={cfg.m} ({cfg.pattern_name()})")

    def _local_packed(self, pw: PackedWeight, specs: dict, rank: int):
        """(this rank's PackedWeight, whether it holds a block) of ``pw``
        under its ``specs``."""
        tp, axis = self.tp, TP_AXIS
        if pw.shard_axis is not None:            # renumbered: row-parallel
            loc = shard_slice(pw, rank)
            tensors = {n: getattr(loc, n).clone() for n in specs}
            return loc.replace(**tensors, has_duplicates=pw.has_duplicates), \
                True
        dims = {s.index(axis) for s in specs.values() if axis in s}
        if not dims:
            return pw, False
        tensors = {n: _block(getattr(pw, n), specs[n], rank, tp, axis)
                   for n in specs}
        o, k = pw.dense_shape
        if specs["values"].index(axis) == 0:     # column-parallel rows
            return pw.replace(**tensors, dense_shape=(o // tp, k),
                              has_duplicates=pw.has_duplicates), True
        # xwT split on its group axis (not renumbered): a shard-local slice
        return pw.replace(**tensors, dense_shape=(o, k // tp), shards=tp,
                          has_duplicates=pw.has_duplicates), True

    def _keep_stage(self, model, rank: int):
        """Keep stage ``rank``'s contiguous ``L / pp`` layers of ``model``
        and drop the others (their tensors are freed)."""
        layers = model.layers
        n = len(layers)
        if n % self.pp:
            raise ValueError(f"{n} layers do not split into pp={self.pp} "
                             "stages")
        per = n // self.pp
        for i in range(n):
            if not rank * per <= i < (rank + 1) * per:
                layers[i] = DroppedLayer()

    # -- decode state -------------------------------------------------------

    def decode_state_specs(self, state, *, num_kv_heads: int):
        """Spec tree of a decode state: KV tensors (dense caches (L, B, S,
        Hkv, Dh) and paged arenas (L, Np, P, Hkv, Dh), heads at axis 3)
        split their head axis over ``model`` when the head count divides
        tp; under ``pp`` a dense cache also splits its layer axis over
        ``pipe`` (each stage holds its layers' caches); everything else
        (positions, block tables) is whole."""
        shard_heads = self.tp > 1 and num_kv_heads % self.tp == 0

        def one(leaf, kv):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            parts = [None] * leaf.ndim
            if kv and leaf.ndim == 5:
                if shard_heads and leaf.shape[3] == num_kv_heads:
                    parts[3] = TP_AXIS
                if self.pp > 1:
                    parts[0] = PP_AXIS
            return Spec(*parts)

        def walk(node, kv=False):
            if isinstance(node, dict):
                return {k: walk(v, kv or k in ("k", "v")) for k, v in
                        node.items()}
            return one(node, kv)

        return walk(state)

    def shard_decode_state(self, make, device, mesh, *, num_kv_heads: int):
        """This rank's block of a fresh decode state per
        :meth:`decode_state_specs`, allocated at its local shape: the whole
        state is never built.  ``make(device=...)`` builds the whole fresh
        state (``model.init_decode_state`` with its arguments bound); it
        runs on the meta device for the shapes, dtypes and the non-tensor
        leaves.  A fresh dense or paged state is all zeros, so every block
        is allocated as zeros.  Without a mesh: ``make(device=device)``."""
        if mesh is None:
            return make(device=device)
        whole = make(device="meta")
        kind = whole["caches"]["kind"]
        if kind not in ("full", "paged"):
            raise NotImplementedError(
                f"a {kind!r} decode state under a sharding plan: "
                "distributed serving covers the full and paged caches")
        ctx = self.context(mesh)
        specs = self.decode_state_specs(whole, num_kv_heads=num_kv_heads)
        degree = {TP_AXIS: ctx.tp, PP_AXIS: ctx.pp}

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            if not isinstance(node, torch.Tensor):
                return node
            shape = [n // degree.get(ax, 1) for n, ax in zip(node.shape,
                                                               spec)]
            return torch.zeros(shape, dtype=node.dtype, device=device)

        return walk(whole, specs)

    # -- serialization ------------------------------------------------------

    def to_json(self) -> dict:
        """The JAX package's plan JSON (its mesh dim names and renumber
        policy, as constants)."""
        return {
            "version": _PLAN_VERSION,
            "tp": self.tp, "pp": self.pp, "dp": self.dp,
            "tp_axis": TP_AXIS, "pp_axis": PP_AXIS, "dp_axis": DP_AXIS,
            "attn_kv_replicated": self.attn_kv_replicated,
            "renumber": RENUMBER,
            "kind_overrides": [list(kv) for kv in self.kind_overrides],
        }

    @classmethod
    def from_json(cls, d: dict) -> "ShardingPlan":
        v = d.get("version", _PLAN_VERSION)
        if v > _PLAN_VERSION:
            raise ValueError(f"unknown ShardingPlan version {v}")
        fixed = {"tp_axis": TP_AXIS, "pp_axis": PP_AXIS, "dp_axis": DP_AXIS,
                 "renumber": RENUMBER}
        other = {k: d[k] for k, want in fixed.items()
                 if d.get(k, want) != want}
        if other:
            raise ValueError(f"plan JSON sets {other}; the port reads only "
                             f"the JAX package's defaults {fixed}")
        return cls(
            tp=int(d.get("tp", 1)), pp=int(d.get("pp", 1)),
            dp=int(d.get("dp", 1)),
            attn_kv_replicated=bool(d.get("attn_kv_replicated", False)),
            kind_overrides=tuple(
                (p, k) for p, k in d.get("kind_overrides", [])),
        )


class TrainLayout:
    """Where a training step's tensors live on this rank, and the
    collectives that put them together.

    Built by :meth:`ShardingPlan.place_for_training` from the placed
    model's record of its splits (``model.tp_placement``: dotted name ->
    (split dim, slice of a shard stack)).  A tensor is *split over tp* when
    the rank holds a block of it (its gradient's squares are summed over
    tp in the global norm; whole, equal on every tp rank, otherwise).  Its
    ZeRO-1 dim is the one ``partitioning.opt_state_specs`` puts ``data`` on
    for the rank's block (the largest whole dim the dp degree divides), or
    None: then its moments are whole on every dp rank."""

    def __init__(self, ctx, model):
        from repro_torch.sharding.partitioning import opt_state_specs
        from repro_torch.train.train_loop import train_params

        self.ctx = ctx
        self.placement = dict(getattr(model, "tp_placement", {}))
        shapes = {n: tuple(t.shape) for n, t in train_params(model).items()}
        specs = {}
        for n, shape in shapes.items():
            d, _ = self.placement.get(n, (None, False))
            specs[n] = Spec(*(TP_AXIS if i == d else None
                              for i in range(len(shape))))
        zero = (opt_state_specs(specs, shapes, ctx.dp) if ctx.dp > 1
                else specs)
        self.zero_dim = {n: (list(z).index(DP_AXIS) if DP_AXIS in z
                             else None) for n, z in zero.items()}

    # -- what is where -------------------------------------------------------

    def split(self, name: str) -> bool:
        """Whether this rank holds a block of ``name`` (not all of it)."""
        return self.ctx.tp > 1 and name in self.placement

    def local_rows(self, batch: dict) -> dict:
        """This dp rank's rows of a global batch (every rank makes the same
        global batch; rank d takes the d-th of dp equal runs of rows)."""
        dp, r = self.ctx.dp, self.ctx.dp_rank
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % dp:
                raise ValueError(f"batch of {b} rows does not split over "
                                 f"dp={dp}")
            out[k] = v[r * (b // dp):(r + 1) * (b // dp)]
        return out

    def zero_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This dp rank's ZeRO-1 block of ``t`` (a view), or ``t``."""
        d = self.zero_dim.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.ctx.dp
        return t.narrow(d, self.ctx.dp_rank * n, n)

    # -- collectives ---------------------------------------------------------

    def mean_grads_(self, grads: dict) -> dict:
        """Each gradient's mean over dp, in place (every dp rank then holds
        the whole mean; the update reads its ZeRO-1 block of it)."""
        for g in grads.values():
            if g is not None:
                self.ctx.dp_mean_(g)
        return grads

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The whole model's gradient norm: the squares of split tensors
        summed over tp, those of whole tensors (equal on every tp rank)
        counted once."""
        split = [g.to(torch.float32).square().sum()
                 for n, g in grads.items() if self.split(n)]
        whole = [g.to(torch.float32).square().sum()
                 for n, g in grads.items() if not self.split(n)]
        dev = next(iter(grads.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if split:
            total = self.ctx.all_reduce(torch.stack(split).sum())
        if whole:
            total = total + torch.stack(whole).sum()
        return torch.sqrt(total)

    def tp_max(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The max of the 0-d ``t`` over the tp ranks holding blocks of
        ``name`` (``t`` itself for a whole tensor)."""
        if not self.split(name):
            return t
        import torch.distributed as dist
        return self.ctx.all_reduce(t.clone(), op=dist.ReduceOp.MAX)

    def gather_updated_(self, params: dict):
        """Every dp rank's updated ZeRO-1 blocks into ``params``, in place
        (exact: zero-filled buffers summed)."""
        for n, p in params.items():
            d = self.zero_dim.get(n)
            if d is not None:
                self.ctx.dp_gather_(p, d)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's tp block (exact
        gather; a shard stack's slices stacked), on every tp rank."""
        if not self.split(name):
            return t
        d, stacked = self.placement[name]
        if stacked:
            return self.ctx.gather(t[None], 0)
        return self.ctx.gather(t, d)

    def gather_whole_to(self, name: str, t: torch.Tensor, dst: int,
                        moment: bool = False):
        """The whole tensor of which ``t`` is this rank's block (its tp
        block, and with ``moment`` its ZeRO-1 block of that), on the host
        of rank ``dst``, the mesh's first rank, only (None elsewhere): the
        blocks go to ``dst`` by one ``gather`` of host tensors (over the
        world, which must be the mesh; a tensor whole over dp only from dst's
        dp row, over its tp group), and ``dst`` writes each into its
        :meth:`block_of` (cheaper than :meth:`whole`'s sums on every rank)."""
        import torch.distributed as dist

        grid = self.ctx.mesh.mesh
        if dist.get_world_size() != grid.numel() or grid.flatten()[0] != dst:
            raise ValueError("gathering a checkpoint needs the world to be "
                             "the mesh and dst its first rank")
        me = dist.get_rank() == dst
        spec = self.spec(name, t.ndim, moment)
        host = t.detach().to("cpu").contiguous()
        if DP_AXIS not in spec:
            # whole over dp: the tp blocks of dp row 0 (dst's own row)
            # are all there is to gather
            if self.ctx.dp_rank != 0:
                return None
            if not self.split(name):
                return host if me else None
            ranks = grid.reshape(-1, grid.shape[-1])[0].tolist()
            group = self.ctx.tp_group
        else:
            ranks, group = grid.flatten().tolist(), None
        blocks = [torch.empty_like(host) for _ in ranks] if me else None
        self.ctx.collectives += 1
        dist.gather(host, blocks, dst=dst, group=group)
        if not me:
            return None
        degree = self._degree()
        shape = ([1] if isinstance(spec, StackSpec) else []) + list(host.shape)
        whole = torch.empty([n * degree.get(ax, 1)
                             for n, ax in zip(shape, spec)], dtype=host.dtype)
        names = list(self.ctx.mesh.mesh_dim_names)
        for r, b in zip(ranks, blocks):
            coord = dict(zip(names, [int(i) for i in
                                     (grid == r).nonzero()[0]]))
            self.block_of(name, whole, moment, coord).copy_(b)
        return whole

    def whole_tree(self, tree: dict, dst: int = 0) -> dict:
        """A training state ``{"params": {name: block}, "opt": AdamWState,
        ...}`` with every leaf whole on the host of rank ``dst``
        (:meth:`gather_whole_to`; call on every rank), None on the others;
        any other entry is taken as it is."""
        import torch.distributed as dist

        def whole(d, moment=False):
            got = {n: self.gather_whole_to(n, t, dst, moment)
                   for n, t in d.items()}
            return got if dist.get_rank() == dst else None

        out = dict(tree)
        if "params" in tree:
            out["params"] = whole(tree["params"])
        opt = tree.get("opt")
        if opt is not None:
            comp = opt.compression
            out["opt"] = opt._replace(
                m=whole(opt.m, True), v=whole(opt.v, True),
                compression=None if comp is None else whole(comp))
        return out

    def _degree(self) -> dict:
        return {TP_AXIS: self.ctx.tp, DP_AXIS: self.ctx.dp}

    def spec(self, name: str, ndim: int, moment: bool = False) -> Spec:
        """``name``'s spec as this rank holds it, ``ndim`` its block's
        rank: its split dim over ``model`` (a shard stack's slice: a
        :class:`StackSpec`), and with ``moment`` its ZeRO-1 dim over
        ``data``."""
        d, stacked = self.placement.get(name, (None, False))
        split = self.split(name)
        parts = [TP_AXIS if split and not stacked and i == d else None
                 for i in range(ndim)]
        z = self.zero_dim.get(name) if moment else None
        if z is not None:
            parts[z] = DP_AXIS
        if split and stacked:
            return StackSpec(TP_AXIS, *parts)
        return Spec(*parts)

    def block_of(self, name: str, whole, moment: bool = False,
                 coord: dict = None):
        """The block of the whole leaf ``whole`` (a tensor or a numpy
        array, as a checkpoint holds it) that this rank holds (:meth:`spec`),
        or the mesh coordinate ``coord`` ({mesh dim name: index}): a view."""
        stacked = self.split(name) and self.placement[name][1]
        spec = self.spec(name, whole.ndim - int(stacked), moment)
        if coord is None:
            coord = {TP_AXIS: self.ctx.tp_rank, DP_AXIS: self.ctx.dp_rank}
        return spec_block(whole, spec, coord, self._degree(), name)

    def state_specs(self, tree: dict) -> dict:
        """The spec tree of a training state ``{"params", "opt", ...}`` as
        this rank holds it (``fault_tolerance.elastic_restore`` keeps these
        blocks): parameters and compression residuals by :meth:`spec`,
        moments also split over ``data`` on their ZeRO-1 dim; any other
        entry whole."""
        def specs(d, moment=False):
            return {n: self.spec(n, t.ndim, moment) for n, t in d.items()}

        out = {k: None for k in tree}
        if "params" in tree:
            out["params"] = specs(tree["params"])
        opt = tree.get("opt")
        if opt is not None:
            comp = opt.compression
            out["opt"] = opt._replace(
                step=None, m=specs(opt.m, True), v=specs(opt.v, True),
                compression=None if comp is None else specs(comp))
        return out


def single_device_plan() -> ShardingPlan:
    """The trivial plan (tp = pp = dp = 1): ``make_mesh()`` is None and
    every transform is the identity."""
    return ShardingPlan()
