"""Partitioning rules: parameter-path patterns -> :class:`Spec`.

Megatron-style TP over the ``model`` dim: column-parallel q/k/v and gate/up
(output rows split), row-parallel wo and down (contraction dim split),
vocab-parallel embedding and unembedding, everything else replicated.  The
rule table is the JAX package's letter for letter; its ``PartitionSpec``
becomes :class:`Spec`, a tuple of the port's own (per dim, a mesh dim name
or None).

Rules are matched on the '/'-joined parameter path (the port's dotted
module names split: ``layers/0/attn/wq/w``), first match wins.  Packed
weights are matched structurally: the module path picks col / row /
replicated through the same rules and the (O, G, Ne) or (RB, A, br, Ne)
geometry places the dims.  The port keeps no stacked layer axis, so the
JAX package's leading stack dims do not occur here (``_base_ndim`` still
counts them, for the same specs on the same arities).
"""

from __future__ import annotations

import re

from repro_torch.core.sparsity import LAYOUT_BLOCK, PackedWeight


class Spec(tuple):
    """How one tensor is split over the mesh: per dim, the mesh dim name
    it is split over, or None (whole)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"{type(self).__name__}(" + ", ".join(map(repr, self)) + ")"


class StackSpec(Spec):
    """The spec of a shard stack (a renumbered row-parallel packed
    tensor): dim 0 is the stack, one slice per index of its mesh dim, and a
    rank holds its slice without the stack dim (where the JAX package's
    device holds the slice under a stack dim of 1)."""


def spec_block(whole, spec, coord: dict, degree: dict, path: str = ""):
    """The block of ``whole`` (a tensor or a numpy array) that the mesh
    coordinate ``coord`` ({mesh dim name: index}) holds under ``spec`` on a
    mesh of ``degree`` ({mesh dim name: size}), as a view; ``whole`` itself
    for a None spec.  ``path`` names the leaf in errors."""
    if spec is None:
        return whole
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, tuple):           # a dim over several mesh dims
            if len(ax) != 1:
                raise NotImplementedError(f"{path}: dim {d} over mesh dims "
                                          f"{ax}")
            ax = ax[0]
        if whole.shape[d] % degree[ax]:
            raise ValueError(f"{path}: dim {d} of {whole.shape[d]} does not "
                             f"split over {ax}={degree[ax]}")
        n = whole.shape[d] // degree[ax]
        index = [slice(None)] * whole.ndim
        index[d] = slice(coord[ax] * n, (coord[ax] + 1) * n)
        whole = whole[tuple(index)]
    if isinstance(spec, StackSpec):
        if whole.shape[0] != 1:
            raise ValueError(f"{path}: a shard stack of "
                             f"{whole.shape[0] * degree[spec[0]]} slices over "
                             f"{spec[0]}={degree[spec[0]]}")
        whole = whole[0]
    return whole


# (regex on path, spec builder(ndim) -> Spec, or "col" / "row")
def _rules():
    return [
        # embeddings / unembedding: vocab-sharded
        (r"(embed|unembed)/table", lambda nd: Spec("model", None)),
        # MoE expert tensors (E, in, out): EP over model
        (r"moe/w_(gate|up|down)", lambda nd: Spec("model", None, None)),
        (r"moe/router/w", lambda nd: Spec(None, None)),
        # attention projections: column-parallel q/k/v, row-parallel o
        (r"(attn|xattn)/w[qkv]/w", "col"),
        (r"(attn|xattn)/wo/w", "row"),
        # MLP: column-parallel gate/up, row-parallel down
        (r"mlp/(gate|up)/w", "col"),
        (r"mlp/down/w", "row"),
        # mamba: column-parallel in_proj, row-parallel out_proj
        (r"mamba/in_proj/w", "col"),
        (r"mamba/out_proj/w", "row"),
        (r"mamba/conv_w", lambda nd: Spec(None, "model")),
        (r"mamba/(A_log|D|dt_bias)", lambda nd: Spec("model",)),
        # xlstm blocks
        (r"(blk)/(up|wq|wk|wv|w_in)/w", "col"),
        (r"(blk)/(down)/w", "row"),
        (r"blk/w_if/w", lambda nd: Spec(None, None)),
        (r"blk/r$", lambda nd: Spec(None, None, None)),  # tiny sLSTM
        # frontends / misc projections: column-parallel
        (r"(patch_proj|frame_proj)/w", "col"),
        # norms, biases, scalars: replicated
        (r".*", lambda nd: Spec(*([None] * nd))),
    ]


def _col_spec(ndim: int) -> Spec:
    """Column-parallel: the output dim (axis 0 of (out, in)) split."""
    return Spec(*(["model"] + [None] * (ndim - 1)))


def _row_spec(ndim: int) -> Spec:
    """Row-parallel: the contraction dim (axis 1 of (out, in)) split."""
    if ndim == 1:
        return Spec(None)
    return Spec(*([None, "model"] + [None] * (ndim - 2)))


def spec_for_path(path: str, ndim: int) -> Spec:
    for pat, builder in _rules():
        if re.search(pat, path):
            if builder == "col":
                return _col_spec(ndim)
            if builder == "row":
                return _row_spec(ndim)
            parts = list(builder(ndim)) + [None] * ndim
            return Spec(*parts[:ndim])
    return Spec(*([None] * ndim))


def _linear_kind_impl(path: str, *, attn_kv_replicated: bool = False) -> str:
    """col / row / replicated of the linear whose module path is ``path``."""
    probe = path.rstrip("/") + "/w"
    if attn_kv_replicated and re.search(r"(attn|xattn)/w[kv]/w", probe):
        return "replicated"
    for pat, builder in _rules():
        if re.search(pat, probe):
            return builder if builder in ("col", "row") else "replicated"
    return "replicated"


def _packed_spec(kind: str, extra: int = 0) -> Spec:
    """values / indices (O, G, Ne): column-parallel splits the output axis
    O, row-parallel the group axis G (groups tile the contraction dim)."""
    core = {"col": ["model", None, None], "row": [None, "model", None]}.get(
        kind, [None, None, None])
    return Spec(*([None] * extra + core))


def _block_packed_specs(kind: str, extra: int = 0):
    """(values / indices, active_groups) specs of the block layout:
    column-parallel splits the row-block axis RB (each rank owns whole row
    blocks and their address streams).  A row-parallel block weight that
    was not renumbered stays whole: its active-group ids address *global*
    groups (``ShardingPlan.renumber_params`` makes the shard-stacked form,
    placed by :func:`_shard_stacked_specs`)."""
    if kind == "col":
        core, ag = ["model", None, None, None], ["model", None]
    else:
        core, ag = [None] * 4, [None] * 2
    return Spec(*([None] * extra + core)), Spec(*([None] * extra + ag))


def _shard_stacked_specs(pw: PackedWeight) -> dict:
    """The renumbered shard-stacked form: every tensor split on its leading
    shard dim, over ``pw.shard_axis``, so that each rank holds exactly its
    locally renumbered slice."""
    out = {"values": pw.values, "indices": pw.indices}
    if pw.layout == LAYOUT_BLOCK:
        out["active_groups"] = pw.active_groups
    if pw.qdtype is not None:
        out["scales"] = pw.scales
    return {n: Spec(pw.shard_axis, *([None] * (t.ndim - 1)))
            for n, t in out.items()}


def packed_weight_specs(pw: PackedWeight, kind: str) -> dict:
    """``{tensor name: Spec}`` of a PackedWeight under ``kind``.  A
    quantized node's ``scales`` follow the values: column-parallel splits
    their leading output axis; row-parallel splits per-group xwT scales on
    their group axis and keeps per-row scales whole.  A shard-stacked node
    is placed on its own shard dim whatever ``kind``."""
    if pw.shard_axis is not None:
        return _shard_stacked_specs(pw)
    if pw.layout == LAYOUT_BLOCK:
        spec, ag_spec = _block_packed_specs(kind)
        out = {"values": spec, "indices": spec, "active_groups": ag_spec}
        if pw.qdtype is not None:
            out["scales"] = Spec(*(["model", None, None] if kind == "col"
                                   else [None] * 3))
        return out
    spec = _packed_spec(kind)
    out = {"values": spec, "indices": spec}
    if pw.qdtype is not None:
        if pw.scales.ndim == 2:          # per group (O, G)
            core = {"col": ["model", None], "row": [None, "model"]}.get(
                kind, [None, None])
        else:                            # per row (O,)
            core = ["model"] if kind == "col" else [None]
        out["scales"] = Spec(*core)
    return out


def _base_ndim(path: str, nd: int) -> int:
    """Arity of the unstacked tensor for this path."""
    if re.search(r"moe/w_(gate|up|down)", path):
        return 3
    if re.search(r"blk/r$", path):
        return 3
    if re.search(r"conv_w", path):
        return 2
    if re.search(r"(embed|unembed)/table", path):
        return 2
    if re.search(r"/w$", path):
        return 2
    if re.search(r"(scale|bias|A_log|D$|dt_bias)", path):
        return 1
    return min(nd, 2)


def path_of(name: str) -> str:
    """The rule table's path of a dotted module or parameter name."""
    return name.replace(".", "/")


def _param_specs_impl(model, *, attn_kv_replicated: bool = False,
                      kind_fn=None) -> dict:
    """``{path: Spec}`` of every tensor of ``model`` that is not inside a
    PackedWeight, and ``{module path: {tensor name: Spec}}`` of every
    PackedWeight.  ``kind_fn`` (path -> col / row / replicated) overrides
    the rule table for PackedWeight nodes (``ShardingPlan.kind_overrides``);
    ``attn_kv_replicated`` keeps K / V projection weights whole."""
    if kind_fn is None:
        def kind_fn(p):
            return _linear_kind_impl(p, attn_kv_replicated=attn_kv_replicated)

    out = {}
    packed = set()
    for name, mod in model.named_modules():
        if isinstance(mod, PackedWeight):
            out[path_of(name)] = packed_weight_specs(mod, kind_fn(
                path_of(name)))
            packed.add(name)
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        owner = name.rsplit(".", 1)[0] if "." in name else ""
        if owner in packed:
            continue
        p = path_of(name)
        nd = t.ndim
        base_nd = _base_ndim(p, nd)
        if attn_kv_replicated and re.search(r"(attn|xattn)/w[kv]/w", p):
            base = Spec(*([None] * base_nd))
        else:
            base = spec_for_path(p, base_nd)
        out[p] = Spec(*([None] * (nd - base_nd) + list(base)))
    return out


def opt_state_specs(pspecs: dict, param_shapes: dict = None,
                    data_degree: int = 16) -> dict:
    """ZeRO-1: the optimizer moments' specs, each parameter's spec with the
    largest still-whole dim whose size the data degree divides split over
    ``data`` (the gradients are reduced onto that block and the updated
    blocks gathered back).  ``pspecs`` is ``{path: Spec}`` (a PackedWeight's
    ``{path: {tensor name: Spec}}`` too) and ``param_shapes`` the same keys'
    shapes (tensors or tuples); without shapes, the first whole dim is
    taken unchecked (the JAX package's fallback).  A parameter with no such
    dim keeps its spec (its moments stay whole over ``data``)."""

    def one(spec, shape=None):
        parts = list(spec)
        candidates = [i for i, s in enumerate(parts) if s is None]
        if shape is not None:
            dims = tuple(getattr(shape, "shape", shape))
            candidates = [i for i in candidates
                          if i < len(dims) and dims[i] % data_degree == 0]
            # the largest divisible dim (best balance); ties to the first
            candidates.sort(key=lambda i: -dims[i])
        if candidates:
            parts[candidates[0]] = "data"
            return Spec(*parts)
        return spec

    out = {}
    for path, spec in pspecs.items():
        shape = None if param_shapes is None else param_shapes[path]
        if isinstance(spec, dict):
            out[path] = {n: one(s, None if shape is None else shape[n])
                         for n, s in spec.items()}
        else:
            out[path] = one(spec, shape)
    return out


def batch_axes(mesh) -> tuple:
    """The data-parallel dims present in ``mesh`` (a DeviceMesh, or
    anything with ``mesh_dim_names``): ``pod`` and ``data``."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, ndim: int, *, seq_axis=None,
               seq_shard: bool = False) -> Spec:
    """A batch tensor's spec: the leading dim over the data-parallel dims
    (a tuple of names, as the JAX package writes it); with ``seq_shard``
    the sequence dim ``seq_axis`` over ``data`` instead (long-context
    decode) and the batch dim over ``pod`` only."""
    names = mesh.mesh_dim_names or ()
    parts = [batch_axes(mesh)] + [None] * (ndim - 1)
    if seq_shard and seq_axis is not None:
        parts[0] = "pod" if "pod" in names else None
        parts[seq_axis] = "data"
    return Spec(*parts)


def cache_spec(mesh, ndim: int, *, batch_axis: int = 1, head_axis: int = 3,
               seq_axis: int = 2, shard_heads: bool,
               seq_shard: bool = False) -> Spec:
    """A KV cache's spec ((L, B, S, H, Dh) by default): the batch dim over
    the data-parallel dims, the heads over ``model`` when the arch's KV
    heads divide tp (``shard_heads``); with ``seq_shard`` (long-context
    decode) the sequence dim over ``data`` instead and the batch dim over
    ``pod`` only, where the mesh has one."""
    names = mesh.mesh_dim_names or ()
    parts = [None] * ndim
    if seq_shard:
        parts[seq_axis] = "data"
        if "pod" in names:
            parts[batch_axis] = "pod"
    else:
        parts[batch_axis] = batch_axes(mesh)
    if shard_heads:
        parts[head_axis] = "model"
    return Spec(*parts)
