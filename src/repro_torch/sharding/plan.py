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
import math
import re
from typing import Tuple

import torch
from torch import nn

from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    PackedWeight,
    select_rows,
    shard_packed_row_parallel,
    shard_slice,
)
from repro_torch.sharding import context as shctx
from repro_torch.sharding.partitioning import (
    GATHER,
    SPLIT,
    WHOLE,
    BlockRowMap,
    RowMap,
    Spec,
    StackSpec,
    _linear_kind_impl,
    _param_specs_impl,
    path_of,
    spec_block,
    spec_put,
)

# the mesh dim names and renumber policy of the JAX package's default plan:
# the rule table and the context name these dims, and row-parallel packed
# weights are always renumbered
TP_AXIS, PP_AXIS, DP_AXIS = "model", "pipe", "data"
RENUMBER = "renumber"

_PLAN_VERSION = 1

# the keys under which a decode state holds KV tensors (..., Hkv, Dh)
_KV_KEYS = ("k", "v", "global_k", "global_v")
# column-parallel projections whose output a rank uses whole (module paths):
# the frontends' (the mixers' inputs are decided per mixer, by its heads)
_GATHERED = r"(patch_proj|frame_proj)$"


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
    ``axis`` (a ``RowMap`` dim: its rows of the map), as a copy, so that the
    whole tensor can be freed."""
    return spec_block(t, spec, {axis: rank}, {axis: degree}).clone()


def _spec_dim(spec):
    """The dim ``spec`` places over ``model`` (a name or a RowMap), or
    None."""
    return next((d for d, ax in enumerate(spec)
                 if ax == TP_AXIS or isinstance(ax, RowMap)), None)


@dataclasses.dataclass(frozen=True)
class MixerSplit:
    """A model's recurrent mixers split by heads over tp (:func:`mixer_split`):
    ``kind`` ``mamba2`` or ``mlstm``, the heads, the inner width ``di`` and
    Mamba2's B / C width ``state``."""

    kind: str
    heads: int
    di: int
    state: int = 0

    def mamba2_rows(self):
        """(``in_proj``'s rows, ``conv_w``'s channels): ``[z, x, B, C,
        dt]`` with z, x and dt the rank's heads' and B, C whole; the conv
        over ``[x, B, C]``."""
        di, bc = self.di, 2 * self.state
        return (RowMap((di, SPLIT), (di, SPLIT), (bc, WHOLE),
                       (self.heads, SPLIT)),
                RowMap((di, SPLIT), (bc, WHOLE)))


def mixer_split(cfg, tp: int):
    """How ``cfg``'s recurrent mixers run under ``tp``: split by heads (a
    :class:`MixerSplit`) where their heads divide tp, else None (whole on
    every rank, their projections gathered; sLSTM always).  The one source
    of the placement of the mixers' tensors and of their decode states."""
    from repro_torch.models.ssm import MLSTM_PF

    s = cfg.ssm
    if tp == 1 or s is None:
        return None
    if cfg.family == "hybrid":
        di = s.expand * cfg.d_model
        split = MixerSplit("mamba2", di // s.head_dim, di, s.state_dim)
    elif cfg.family == "ssm":
        split = MixerSplit("mlstm", cfg.num_heads, MLSTM_PF * cfg.d_model)
    else:
        return None
    return split if split.heads % tp == 0 else None


def _out_rows(node) -> int:
    """The size of dim 0 of a linear's weight as the rule table splits it:
    a packed node's values (a ``block`` node's row blocks), else its
    output features."""
    return node.values.shape[0] if isinstance(node, PackedWeight) \
        else node.w.shape[0]


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
                                  num_heads=num_heads)

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
        :class:`TrainLayout` on ``mesh`` (a ``pod`` dim joins ``data`` in
        dp).  A model placed before under the same plan is not placed again.
        Every family trains under tp, with the mixers split by heads where
        they divide, the head fallback, wk / wv replicated and column
        blocks left whole (their gradients summed over tp where each rank
        reads them in part); a packed ``block`` node whose rows were
        re-blocked by heads trains by its re-blocked rows (a
        ``partitioning.BlockRowMap``).  Refused by name: a pipeline dim
        (the step is data x model, as the JAX package's)."""
        if self.pp > 1:
            raise NotImplementedError(
                "a train step under pp > 1: the step runs data x model, as "
                "the JAX package's (sharding.pipeline.pipeline_apply is the "
                "differentiable schedule)")
        cfg = getattr(model, "cfg", None)
        if mesh is None or mesh.get_coordinate() is None:
            raise ValueError("place_for_training needs a mesh this rank is "
                             "in (ShardingPlan.make_mesh)")
        ctx = self.context(mesh, num_kv_heads=cfg.num_kv_heads,
                           num_heads=cfg.num_heads)
        if getattr(model, "placed_plan", None) != self:
            self.shard_params(model, mesh)
            model.placed_plan = self
        return TrainLayout(ctx, model)

    def _gathered(self, path: str, node) -> dict:
        """The role of a projection whose consumer runs whole on every rank
        (the frontends' inputs, q / k / v whose heads do not split, the
        projections of a mixer that runs whole): a column-parallel one's
        output rows gathered whole (one ``gather`` segment), or, where its
        rows do not split over tp, computed whole on every rank."""
        if self.linear_kind(path) != "col":
            return {}
        if _out_rows(node) % self.tp:
            return dict(tp_kind="replicated")
        o = node.out_features if isinstance(node, PackedWeight) \
            else node.w.shape[0]
        return dict(tp_rows=RowMap((o, GATHER)))

    def _roles(self, model, cfg):
        """How each placed linear of ``model`` runs under tp, decided per
        mixer and per attention: ``{linear path: {attr: value}}`` of the
        placement attributes (``tp_rows``, ``tp_partial``, ``tp_local_in``,
        see ``core.sparse_linear._apply_placed``; ``tp_kind`` where it
        differs from the rule table's), and ``{tensor path: Spec}`` of the
        mixers' own tensors split by heads.

        Where :func:`mixer_split` splits a Mamba2 mixer, ``in_proj`` keeps
        the rank's rows of z, x and dt and all of B and C
        (:meth:`MixerSplit.mamba2_rows`), ``conv_w`` its x channels and B /
        C's, ``A_log`` / ``D`` / ``dt_bias`` and the gated norm's scale the
        rank's heads'.  Where it splits an mLSTM: ``up``'s ``xm`` rows
        gathered (every head reads every channel) and ``z`` the rank's,
        ``wq`` / ``wk`` / ``wv`` the rank's heads' rows on the rank's own
        input (``tp_local_in``), ``w_if`` whole (the rank takes its heads'
        gates), the norm's scale split.  Otherwise a mixer runs whole on
        every rank (its projections gathered, :meth:`_gathered`), as do
        sLSTM and the frontends' inputs.  q / k / v whose heads do not split
        are gathered (the JAX package's ``_constrain_heads``); k / v read
        by split query heads are read in part (``tp_partial``)."""
        from repro_torch.models.ssm import MLSTM, SLSTM, Mamba2

        tp = self.tp
        roles, specs = {}, {}
        for name, mod in model.named_modules():
            p = path_of(name)
            if re.search(_GATHERED, p):
                roles[p] = self._gathered(p, mod)
            elif isinstance(mod, Mamba2):
                split = mixer_split(cfg, tp)
                if split is None:
                    roles[f"{p}/in_proj"] = self._gathered(f"{p}/in_proj",
                                                           mod.in_proj)
                    continue
                rows, chans = split.mamba2_rows()
                roles[f"{p}/in_proj"] = dict(tp_rows=rows)
                specs[f"{p}/conv_w"] = Spec(None, chans)
                for t in ("A_log", "D", "dt_bias", "norm/scale"):
                    specs[f"{p}/{t}"] = Spec(TP_AXIS)
            elif isinstance(mod, MLSTM):
                split = mixer_split(cfg, tp)
                if split is None:
                    for lin in ("up", "wq", "wk", "wv"):
                        roles[f"{p}/{lin}"] = self._gathered(
                            f"{p}/{lin}", getattr(mod, lin))
                    continue
                roles[f"{p}/up"] = dict(
                    tp_partial=True,
                    tp_rows=RowMap((split.di, GATHER), (split.di, SPLIT)))
                for lin in ("wq", "wk", "wv"):
                    roles[f"{p}/{lin}"] = dict(tp_local_in=True)
                roles[f"{p}/w_if"] = dict(tp_partial=True, tp_local_in=True)
                specs[f"{p}/norm/scale"] = Spec(TP_AXIS)
            elif isinstance(mod, SLSTM):
                roles[f"{p}/w_in"] = self._gathered(f"{p}/w_in", mod.w_in)
            elif cfg is not None and re.search(r"(attn|xattn)$", p):
                q_split = cfg.num_heads % tp == 0
                kv_split = cfg.num_kv_heads % tp == 0
                kv_gather = not kv_split and not self.attn_kv_replicated
                if not q_split:
                    roles[f"{p}/wq"] = self._gathered(f"{p}/wq", mod.wq)
                for lin in ("wk", "wv"):
                    role = (self._gathered(f"{p}/{lin}", getattr(mod, lin))
                            if kv_gather or not q_split else {})
                    roles[f"{p}/{lin}"] = dict(role, tp_partial=q_split and (
                        kv_gather or self.attn_kv_replicated))
        return roles, specs

    def _keep_tp_blocks(self, model, rank: int):
        from repro_torch.core.sparse_linear import SparseLinear
        from repro_torch.models.layers import Embedding
        from repro_torch.models.moe import MoE
        from repro_torch.models.ssm import MLSTM, Mamba2

        tp, axis = self.tp, TP_AXIS
        cfg = getattr(model, "cfg", None)
        specs = self.param_specs(model)
        roles, mixer_specs = self._roles(model, cfg)
        handled = set()
        # where each tensor of the placed model is split: dotted name ->
        # (its split dim, or None; whether it is a slice of a shard stack);
        # the RowMap of a dim placed by one; the whole tensors whose
        # gradient each rank holds in part
        placement, rows_of, partial = {}, {}, set()

        def keep(mod, attr, spec, name):
            setattr(mod, attr, nn.Parameter(
                _block(getattr(mod, attr).data, spec, rank, tp, axis),
                requires_grad=False))
            d = _spec_dim(spec)
            placement[name] = (d, False)
            if isinstance(spec[d], RowMap):
                rows_of[name] = spec[d]

        def set_role(mod, p, sharded):
            role = roles.get(p, {})
            kind = role.get("tp_kind", self.linear_kind(p))
            mod.tp_kind, mod.tp_sharded = kind, sharded
            mod.tp_rows = role.get("tp_rows")
            # a column block left whole keeps its block of the output
            mod.tp_partial = role.get("tp_partial", False) or (
                kind == "col" and not sharded)
            mod.tp_local_in = role.get("tp_local_in", False)

        for name, mod in list(model.named_modules()):
            p = path_of(name)
            dotted = f"{name}." if name else ""
            # a map whose rank-local part is one block places its tensors
            # as a plain split
            rows = roles.get(p, {}).get("tp_rows")
            mapped = None if rows is None or rows.is_block else rows
            if isinstance(mod, PackedWeight):
                new, sharded = self._local_packed(mod, specs[p], rank, mapped)
                set_role(new, p, sharded)
                _set_module(model, name, new)
                for c, spec in specs[p].items():
                    if mapped is not None:
                        # a block node's rows, re-blocked: its float tensors
                        # (values, scales) by their blocks
                        if mod.layout == LAYOUT_BLOCK and c not in (
                                "values", "scales"):
                            continue
                        placement[dotted + c] = (0, False)
                        rows_of[dotted + c] = mapped if \
                            mod.layout != LAYOUT_BLOCK else BlockRowMap(
                                [(n // new.block_geom[0], k)
                                 for n, k in mapped],
                                mod.block_geom[0], new.block_geom[0])
                    elif mod.shard_axis is not None:
                        placement[dotted + c] = (None, True)
                    elif axis in spec:
                        placement[dotted + c] = (spec.index(axis), False)
                    if new.tp_partial and not sharded:
                        partial.add(dotted + c)
                handled.add(p)
            elif isinstance(mod, SparseLinear):
                spec = specs[f"{p}/w"]
                if mapped is not None:
                    spec = Spec(mapped, None)
                sharded = axis in spec or mapped is not None
                set_role(mod, p, sharded)
                if sharded:
                    self._check_whole_groups(mod, spec, name)
                    keep(mod, "w", spec, dotted + "w")
                elif mod.tp_partial:
                    partial.add(dotted + "w")
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
            elif isinstance(mod, (Mamba2, MLSTM)):
                # split by heads (its tensors per _roles), or whole on every
                # rank where the rule table would split them
                own = {n[len(p) + 1:]: s for n, s in mixer_specs.items()
                       if n.startswith(f"{p}/")}
                for n, spec in own.items():
                    owner, attr = ((mod.norm, "scale") if n == "norm/scale"
                                   else (mod, n))
                    keep(owner, attr, spec, dotted + n.replace("/", "."))
                    if owner is mod.norm:
                        owner.tp_sharded = True
                if isinstance(mod, MLSTM) and own:
                    partial.add(dotted + "conv_w")
                handled.update(f"{p}/{n}" for n in ("conv_w", "A_log", "D",
                                                    "dt_bias"))
        model.tp_placement = placement
        model.tp_row_maps = rows_of
        model.tp_partial_grads = partial
        left = [p for p, s in specs.items() if p not in handled
                and not isinstance(s, dict) and axis in s]
        if left:
            raise ValueError(
                f"tensors {left[:4]} split over {axis!r} outside a linear, an "
                "embedding, the experts or a Mamba2 mixer: the placement "
                "keeps no block of them")

    def _check_whole_groups(self, lin, spec, name: str):
        """A row-split masked weight's block must hold whole N:M groups
        (``layers.linear_sparsity`` aligns M to K / 16), or its mask would
        straddle the ranks."""
        cfg = lin.sparsity
        if cfg is None or _spec_dim(spec) != 1:
            return
        k = lin.w.shape[1] // self.tp
        if k % cfg.m:
            raise ValueError(
                f"{name}: a block of {k} of its {lin.w.shape[1]} input "
                f"features over tp={self.tp} does not hold whole groups of "
                f"M={cfg.m} ({cfg.pattern_name()})")

    def _local_packed(self, pw: PackedWeight, specs: dict, rank: int,
                      rows=None):
        """(this rank's PackedWeight, whether it holds a block) of ``pw``
        under its ``specs``, or its output rows of the RowMap ``rows``
        (``core.sparsity.select_rows``)."""
        tp, axis = self.tp, TP_AXIS
        if rows is not None:
            # a block node is re-blocked alike on every rank: at the gcd of
            # its block_r and every rank's pieces
            nb = None if pw.layout != LAYOUT_BLOCK else math.gcd(
                pw.block_geom[0], *(v for r in range(tp)
                                    for s, n, _ in rows.pieces(r, tp)
                                    for v in (s, n)))
            return select_rows(pw, [(s, n) for s, n, _ in
                                    rows.pieces(rank, tp)], block_r=nb), True
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

    def decode_state_specs(self, state, cfg, *, num_kv_heads: int):
        """Spec tree of a decode state: every KV tensor (under a ``k``,
        ``v``, ``global_k`` or ``global_v`` key: dense caches (L, B, S, Hkv,
        Dh), paged arenas (L, Np, P, Hkv, Dh), ring buffers, the hybrid's
        shared-block caches, each (..., Hkv, Dh)) splits its head axis over
        ``model`` when the head count divides tp, as the JAX package splits
        axis 3 of its 5-D ones; under ``pp`` a dense cache also splits its
        layer axis over ``pipe`` (each stage holds its layers' caches).
        The recurrent states of the mixers that ``cfg`` (the model's config)
        splits by heads (:func:`mixer_split`, as the placement does) split
        too: Mamba2's ``h`` (..., B, H, P, N) by heads and its ``conv``
        window (..., B, K - 1, C) by the rank's x channels with B's and C's
        whole (a ``RowMap``); mLSTM's ``C``, ``n`` and ``m`` by heads.
        Everything else (positions, ring slot
        positions, block tables, the conv window of xm, sLSTM's state, the
        encoder's output) is whole."""
        shard_heads = self.tp > 1 and num_kv_heads % self.tp == 0
        mixer = self._mixer_state_parts(cfg)

        def one(leaf, kv, part):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            parts = [None] * leaf.ndim
            if kv and leaf.ndim >= 4:
                if shard_heads and leaf.shape[-2] == num_kv_heads:
                    parts[-2] = TP_AXIS
                if self.pp > 1 and leaf.ndim == 5:
                    parts[0] = PP_AXIS
            if part is not None:
                parts[part[0]] = part[1]
            return Spec(*parts)

        def walk(node, kv=False, parts=None):
            if isinstance(node, dict):
                return {k: walk(v, kv or k in _KV_KEYS,
                                (parts or {}).get(k, mixer.get(k)))
                        for k, v in node.items()}
            return one(node, kv, parts)

        return walk(state)

    def _mixer_state_parts(self, cfg) -> dict:
        """``{state key: {leaf key: (axis, spec part)}}`` of the recurrent
        states of ``cfg``'s mixers split by heads under this plan."""
        split = mixer_split(cfg, self.tp)
        if split is None:
            return {}
        if split.kind == "mamba2":
            _, chans = split.mamba2_rows()
            mamba = {"h": (-3, TP_AXIS), "conv": (-1, chans)}
            return {"ssm": mamba, "ssm_tail": mamba}
        return {"mlstm": {"C": (-3, TP_AXIS), "n": (-2, TP_AXIS),
                          "m": (-1, TP_AXIS)}}

    def shard_decode_state(self, make, device, mesh, cfg, *,
                           num_kv_heads: int):
        """This rank's block of a fresh decode state per
        :meth:`decode_state_specs` (``cfg``: the model's config), allocated
        at its local shape: the whole state is
        never built.  ``make(device=...)`` builds the whole fresh state
        (``model.init_decode_state`` with its arguments bound); it runs on
        the meta device for the shapes, dtypes and the non-tensor leaves.
        Every element of a fresh leaf holds one value, which its block is
        filled with: the models say which (``models.families.STATE_FILL``:
        a ring's empty slots, the xLSTM stabilisers; else 0).  Without a
        mesh: ``make(device=device)``."""
        from repro_torch.models.families import STATE_FILL

        if mesh is None:
            return make(device=device)
        whole = make(device="meta")
        ctx = self.context(mesh)
        specs = self.decode_state_specs(whole, cfg,
                                        num_kv_heads=num_kv_heads)
        degree = {TP_AXIS: ctx.tp, PP_AXIS: ctx.pp}

        def walk(node, spec, name=None):
            if isinstance(node, dict):
                return {k: walk(v, spec[k], k) for k, v in node.items()}
            if not isinstance(node, torch.Tensor):
                return node
            shape = [ax.local_size(ctx.tp) if isinstance(ax, RowMap)
                     else n // degree.get(ax, 1)
                     for n, ax in zip(node.shape, spec)]
            return torch.full(shape, STATE_FILL.get(name, 0),
                              dtype=node.dtype, device=device)

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
    (split dim, slice of a shard stack); ``model.tp_row_maps``: the
    ``RowMap`` of a dim a mixer's rows are placed by;
    ``model.tp_partial_grads``: the whole tensors each rank reads only in
    part).  A tensor is *split over tp*
    when the rank holds a block of it (its gradient's squares are summed
    over tp in the global norm; whole, equal on every tp rank, otherwise).
    Its ZeRO-1 dim is the one ``partitioning.opt_state_specs`` puts
    ``data`` on for the rank's block (the largest whole dim the dp degree
    divides), or None: then its moments are whole on every dp rank.

    One rule for the gradients over tp: a tensor every rank holds whole
    but reads only in part (``tp_partial``; the ``whole`` pieces of a
    RowMap: Mamba2's B / C rows and channels) has a partial gradient on
    each rank, summed over tp (:meth:`sum_partial_`); a tensor used whole
    by math every rank runs alike has its whole gradient already."""

    def __init__(self, ctx, model):
        from repro_torch.sharding.partitioning import opt_state_specs
        from repro_torch.train.train_loop import train_params

        self.ctx = ctx
        self.placement = dict(getattr(model, "tp_placement", {}))
        self.rows = dict(getattr(model, "tp_row_maps", {}))
        self.partial = set(getattr(model, "tp_partial_grads", ()))
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

    def _whole_pieces(self, name: str, t: torch.Tensor):
        """Views of ``t``, this rank's part of ``name``, at the ``whole``
        pieces of its RowMap (the positions every tp rank holds alike)."""
        rows = self.rows.get(name)
        if rows is None or self.ctx.tp == 1:
            return []
        d = self.placement[name][0]
        return [t.narrow(d, s, n) for s, n in rows.local_whole(self.ctx.tp)]

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

    def sum_partial_(self, grads: dict) -> dict:
        """The gradients each rank holds in part (``tp_partial`` tensors, a
        RowMap's ``whole`` pieces) summed over tp, in place, in one float32
        all-reduce."""
        if self.ctx.tp == 1:
            return grads
        views = []
        for n, g in grads.items():
            if g is None:
                continue
            if n in self.partial:
                views.append(g)
            else:
                views.extend(self._whole_pieces(n, g))
        if views:
            flat = torch.cat([v.reshape(-1).to(torch.float32)
                              for v in views])
            self.ctx.all_reduce(flat)
            off = 0
            for v in views:
                v.copy_(flat[off:off + v.numel()].view(v.shape))
                off += v.numel()
        return grads

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
        counted once, and a RowMap's ``whole`` pieces once."""
        split, whole = [], []
        for n, g in grads.items():
            sq = g.to(torch.float32).square().sum()
            if not self.split(n):
                whole.append(sq)
                continue
            pieces = [v.to(torch.float32).square().sum()
                      for v in self._whole_pieces(n, g)]
            if pieces:      # counted once: off the summed part
                once = torch.stack(pieces).sum()
                sq = sq - once
                whole.append(once)
            split.append(sq)
        dev = next(iter(grads.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if split:
            total = self.ctx.all_reduce(torch.stack(split).sum())
        if whole:
            total = total + torch.stack(whole).sum()
        return torch.sqrt(total)

    def tp_max(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the tp ranks holding blocks of
        ``name`` (``t`` itself for a whole tensor): a 0-d amax, or the (O,
        1) per-row amax of a row-parallel weight."""
        if not self.split(name):
            return t
        import torch.distributed as dist
        return self.ctx.all_reduce(t.clone(), op=dist.ReduceOp.MAX)

    def row_amax(self, name: str, amax: torch.Tensor) -> torch.Tensor:
        """The per-row amax of ``name`` over the whole row: its max over tp
        for a row-parallel weight (the contraction dim split), else
        ``amax`` (fake quantization's per-row int8 scale)."""
        if self.split(name) and self.placement[name] == (1, False):
            return self.tp_max(name, amax)
        return amax

    def gather_updated_(self, params: dict):
        """Every dp rank's updated ZeRO-1 blocks into ``params``, in place
        (exact: zero-filled buffers summed)."""
        for n, p in params.items():
            d = self.zero_dim.get(n)
            if d is not None:
                self.ctx.dp_gather_(p, d)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's tp block (exact
        gather; a shard stack's slices stacked; a RowMap's pieces put in
        place, its ``whole`` pieces once), on every tp rank."""
        if not self.split(name):
            return t
        d, stacked = self.placement[name]
        if stacked:
            return self.ctx.gather(t[None], 0)
        rows = self.rows.get(name)
        if rows is None:
            return self.ctx.gather(t, d)
        own = t.clone()
        if self.ctx.tp_rank:
            for v in self._whole_pieces(name, own):
                v.zero_()
        shape = list(t.shape)
        shape[d] = rows.size
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        full.index_copy_(d, rows.index(self.ctx.tp_rank, self.ctx.tp,
                                       t.device), own)
        full = self.ctx.all_reduce(full)
        if isinstance(rows, BlockRowMap):
            return rows.unreblocked(full)
        return full

    def _coord(self, rank=None) -> dict:
        """{``model``: tp index, ``data``: dp index} of this rank, or of the
        global ``rank`` of the mesh (dp row-major over ``pod`` x
        ``data``)."""
        if rank is None:
            return {TP_AXIS: self.ctx.tp_rank, DP_AXIS: self.ctx.dp_rank}
        grid = self.ctx.mesh.mesh
        at = dict(zip(self.ctx.mesh.mesh_dim_names,
                      [int(i) for i in (grid == rank).nonzero()[0]]))
        return {TP_AXIS: at.get(TP_AXIS, 0),
                DP_AXIS: at.get("pod", 0) * self.ctx.data
                + at.get(DP_AXIS, 0)}

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
        whole = torch.empty(self.whole_shape(name, host.shape, moment),
                            dtype=host.dtype)
        for r, b in zip(ranks, blocks):
            spec_put(whole, spec, self._coord(r), self._degree(), b, name)
        return whole

    def whole_shape(self, name: str, shape, moment: bool = False) -> list:
        """The whole leaf's shape of a block of ``shape``."""
        spec = self.spec(name, len(shape), moment)
        degree = self._degree()
        lead = [1] if isinstance(spec, StackSpec) else []
        out = [ax.size if isinstance(ax, RowMap) else n * degree.get(ax, 1)
               for n, ax in zip(lead + list(shape), spec)]
        if spec and isinstance(spec[0], BlockRowMap):
            return spec[0].whole_shape(out)
        return out

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
        rank: its split dim over ``model`` (a RowMap where its rows follow
        one; a shard stack's slice: a :class:`StackSpec`), and with
        ``moment`` its ZeRO-1 dim over ``data``."""
        d, stacked = self.placement.get(name, (None, False))
        split = self.split(name)
        part = self.rows.get(name, TP_AXIS)
        parts = [part if split and not stacked and i == d else None
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
        or the mesh coordinate ``coord`` ({``model``: tp index, ``data``: dp
        index}): a view (a copy along a RowMap dim)."""
        stacked = self.split(name) and self.placement[name][1]
        spec = self.spec(name, whole.ndim - int(stacked), moment)
        return spec_block(whole, spec, coord or self._coord(),
                          self._degree(), name)

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
