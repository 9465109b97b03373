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

    def __getnewargs__(self):          # pickled as its parts
        return tuple(self)

    def __repr__(self):
        return f"{type(self).__name__}(" + ", ".join(map(repr, self)) + ")"


class StackSpec(Spec):
    """The spec of a shard stack (a renumbered row-parallel packed
    tensor): dim 0 is the stack, one slice per index of its mesh dim, and a
    rank holds its slice without the stack dim (where the JAX package's
    device holds the slice under a stack dim of 1)."""


# the kinds of a RowMap segment
SPLIT, GATHER, WHOLE = "split", "gather", "whole"


class RowMap(tuple):
    """A dim placed over ``model`` whose rank-local part is not one block:
    the whole dim as a run of segments ``(length, kind)``, kind ``split``
    (the rank holds its block of the segment), ``gather`` (it holds its
    block, and a product's output rows there are gathered whole) or
    ``whole`` (every rank holds all of it).  The rank's local dim is its
    pieces in segment order.  Mamba2's ``in_proj`` rows are ``z, x`` split,
    ``B, C`` whole, ``dt`` split; mLSTM's ``up`` rows ``xm`` gathered, ``z``
    split.  A ``RowMap`` stands in a :class:`Spec` where a split dim names
    ``model``."""

    def __new__(cls, *segments):
        segs = tuple((int(n), str(k)) for n, k in segments)
        for _, k in segs:
            if k not in (SPLIT, GATHER, WHOLE):
                raise ValueError(f"unknown RowMap segment kind {k!r}")
        return super().__new__(cls, segs)

    def __getnewargs__(self):          # pickled as its segments
        return tuple(self)

    def __repr__(self):
        return "RowMap(" + ", ".join(f"({n}, {k!r})" for n, k in self) + ")"

    @property
    def size(self) -> int:
        return sum(n for n, _ in self)

    @property
    def is_block(self) -> bool:
        """Whether the rank's part is one block of the dim (one segment,
        not ``whole``): the dim is placed as a plain split over
        ``model``."""
        return len(self) == 1 and self[0][1] != WHOLE

    def pieces(self, rank: int, tp: int):
        """``(whole start, length, kind)`` of each piece rank ``rank``
        holds, in local order."""
        out, off = [], 0
        for n, k in self:
            if k == WHOLE:
                out.append((off, n, k))
            else:
                if n % tp:
                    raise ValueError(f"a segment of {n} does not split over "
                                     f"tp={tp}")
                out.append((off + rank * (n // tp), n // tp, k))
            off += n
        return out

    def local_size(self, tp: int) -> int:
        return sum(n for _, n, _ in self.pieces(0, tp))

    def index(self, rank: int, tp: int, device=None):
        """The whole dim's positions rank ``rank`` holds, in local order."""
        import torch
        return torch.cat([torch.arange(s, s + n, device=device)
                          for s, n, _ in self.pieces(rank, tp)])

    def local_whole(self, tp: int):
        """``(local start, length)`` of the ``whole`` pieces: the positions
        every rank holds alike."""
        out, off = [], 0
        for _, n, k in self.pieces(0, tp):
            if k == WHOLE:
                out.append((off, n))
            off += n
        return out


class BlockRowMap(RowMap):
    """A :class:`RowMap` over the rows of a ``block``-layout packed tensor
    (``values`` (RB, A, block_r, Ne), ``scales`` (RB, A, block_r)) whose
    rank-local part was re-blocked at ``nb`` rows a block
    (``core.sparsity.select_rows``): the whole tensor read as (RB x block_r
    / nb, A, nb, ...) blocks (:meth:`reblocked`), its segments count those
    blocks, and it stands at dim 0 of a :class:`Spec` for dims 0 and 2
    together."""

    def __new__(cls, segments, block_r: int, nb: int):
        self = super().__new__(cls, *segments)
        self.block_r, self.nb = int(block_r), int(nb)
        return self

    def __getnewargs__(self):
        return tuple(self), self.block_r, self.nb

    def __repr__(self):
        return (f"BlockRowMap({tuple(self)}, block_r={self.block_r}, "
                f"nb={self.nb})")

    def reblocked(self, x):
        """(RB, A, block_r, ...) -> (RB x f, A, nb, ...), f = block_r / nb:
        each new block inside one old block (a copy; a tensor or a numpy
        array)."""
        f = self.block_r // self.nb
        rb, a = x.shape[:2]
        rest = tuple(x.shape[3:])
        return x.reshape(rb, a, f, self.nb, *rest).swapaxes(1, 2).reshape(
            rb * f, a, self.nb, *rest)

    def unreblocked(self, x):
        """The inverse of :meth:`reblocked`."""
        f = self.block_r // self.nb
        rbf, a = x.shape[:2]
        rest = tuple(x.shape[3:])
        return x.reshape(rbf // f, f, a, self.nb, *rest).swapaxes(1, 2) \
            .reshape(rbf // f, a, self.block_r, *rest)

    def whole_shape(self, shape) -> list:
        """The whole tensor's shape of its re-blocked ``shape``."""
        f = self.block_r // self.nb
        return [shape[0] // f, shape[1], self.block_r, *shape[3:]]


def _dim_index(ax, n: int, coord: dict, degree: dict, path: str, d: int):
    """The positions of a dim of ``n`` that ``coord`` holds under the spec
    part ``ax``: a slice, or an index array (a :class:`RowMap`)."""
    if isinstance(ax, RowMap):
        if ax.size != n:
            raise ValueError(f"{path}: dim {d} of {n} is not the RowMap's "
                             f"{ax.size}")
        return ax.index(coord["model"], degree["model"]).numpy()
    if isinstance(ax, tuple):           # a dim over several mesh dims
        if len(ax) != 1:
            raise NotImplementedError(f"{path}: dim {d} over mesh dims {ax}")
        ax = ax[0]
    if n % degree[ax]:
        raise ValueError(f"{path}: dim {d} of {n} does not split over "
                         f"{ax}={degree[ax]}")
    k = n // degree[ax]
    return slice(coord[ax] * k, (coord[ax] + 1) * k)


def spec_put(whole, spec, coord: dict, degree: dict, block, path: str = ""):
    """Write ``block`` into the block of ``whole`` that :func:`spec_block`
    reads (in place, ``whole`` a tensor or a numpy array)."""
    if spec and isinstance(spec[0], BlockRowMap):
        ax = spec[0]
        view = ax.reblocked(whole)
        spec_put(view, Spec(RowMap(*ax), *spec[1:]), coord, degree, block,
                 path)
        whole[...] = ax.unreblocked(view)
        return whole
    if isinstance(spec, StackSpec):
        block = block[None]
    index = [slice(None)] * whole.ndim
    arrays = []
    for d, ax in enumerate(spec or ()):
        if ax is not None:
            index[d] = _dim_index(ax, whole.shape[d], coord, degree, path, d)
            if not isinstance(index[d], slice):
                arrays.append(d)
    if len(arrays) > 1:
        raise NotImplementedError(f"{path}: RowMaps on dims {arrays}")
    if arrays:                  # an index array: the dim moves to the front
        d = arrays[0]
        view = whole[tuple(index[:d] + [slice(None)] + index[d + 1:])]
        import torch
        if isinstance(whole, torch.Tensor):
            view.index_copy_(d, torch.as_tensor(index[d]), block)
        else:
            view[(slice(None),) * d + (index[d],)] = block
        return whole
    whole[tuple(index)] = block
    return whole


def spec_block(whole, spec, coord: dict, degree: dict, path: str = ""):
    """The block of ``whole`` (a tensor or a numpy array) that the mesh
    coordinate ``coord`` ({mesh dim name: index}) holds under ``spec`` on a
    mesh of ``degree`` ({mesh dim name: size}), as a view (a copy along a
    :class:`RowMap` dim); ``whole`` itself for a None spec.  ``path`` names
    the leaf in errors."""
    if spec is None:
        return whole
    if spec and isinstance(spec[0], BlockRowMap):
        whole = spec[0].reblocked(whole)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        idx = _dim_index(ax, whole.shape[d], coord, degree, path, d)
        if isinstance(idx, slice):
            whole = whole[(slice(None),) * d + (idx,)]
        elif hasattr(whole, "index_select"):
            import torch
            whole = whole.index_select(d, torch.as_tensor(
                idx, device=whole.device))
        else:
            whole = whole.take(idx, axis=d)
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
