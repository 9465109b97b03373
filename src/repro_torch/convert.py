"""Turn a parameter tree of the JAX package into the port's modules.

``from_jax_params(tree, cfg)`` takes the decoder's parameter tree with every
leaf already a numpy array — the caller runs ``np.asarray`` over it and
unwraps the JAX package's two node types, so that nothing here imports that
package:

* a sparse linear's static pattern (``{"w": ..., "sparsity": Static(cfg)}``)
  arrives as ``"sparsity": (n, m, k)`` (or any object with ``n``/``m``/``k``
  attributes);
* a packed weight arrives as a dict ``{"values", "indices", "cfg": (n, m, k),
  "dense_shape": (O, K), "layout": "xwT" | "block", "qdtype": None | "int8",
  "scales": array | None}``, a block weight also with ``"active_groups"``
  and ``"block_geom": (block_r, a_max)``.

The JAX package stacks the layers on a leading axis — ``w (L, O, K)``,
``values (L, O, G, Ne)`` or ``(L, RB, A_max, block_r, Ne)``,
``active_groups (L, RB, A_max)`` — for its layer scan; this un-stacks that
axis into the port's per-layer ``nn.ModuleList``.  A stacked block weight
keeps the stack's shared ``a_max`` in every layer.  Dense, masked, packed
(both layouts) and packed+int8 trees are handled.  It is how tests give both
packages the same weights (the port's own ``torch.Generator`` init cannot
reproduce ``jax.random``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.core.sparsity import PackedWeight, SparsityConfig
from repro_torch.device import require_device
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embedding, RMSNorm
from repro_torch.models.transformer import DecoderLM, TBlock


def _sparsity(spec) -> SparsityConfig:
    if isinstance(spec, SparsityConfig):
        return spec
    if isinstance(spec, (tuple, list)):
        return SparsityConfig(*(int(v) for v in spec))
    return SparsityConfig(int(spec.n), int(spec.m), int(spec.k))


def _tensor(a, device, layer=None) -> torch.Tensor:
    a = np.asarray(a)
    if layer is not None:
        a = a[layer]
    return torch.from_numpy(np.array(a)).to(device)   # np.array copies


def _is_packed(node) -> bool:
    return isinstance(node, dict) and "values" in node and "indices" in node


def _linear(node, device, layer=None):
    """One linear node of layer ``layer`` (None: the node is not stacked)."""
    if _is_packed(node):
        scales = node.get("scales")
        ag = node.get("active_groups")
        geom = node.get("block_geom")
        return PackedWeight(
            _tensor(node["values"], device, layer),
            _tensor(node["indices"], device, layer).to(torch.int32),
            cfg=_sparsity(node["cfg"]), dense_shape=node["dense_shape"],
            layout=node.get("layout", "xwT"),
            active_groups=(None if ag is None else
                           _tensor(ag, device, layer).to(torch.int32)),
            block_geom=None if geom is None else tuple(geom),
            scales=None if scales is None else _tensor(scales, device, layer),
            qdtype=node.get("qdtype"))
    sp = node.get("sparsity")
    return SparseLinear(_tensor(node["w"], device, layer),
                        None if sp is None else _sparsity(sp))


def _norm(node, device, layer=None) -> RMSNorm:
    return RMSNorm(_tensor(node["scale"], device, layer))


def _block(layers, i: int, device) -> TBlock:
    a, m = layers["attn"], layers["mlp"]
    return TBlock(
        _norm(layers["ln1"], device, i),
        Attention(*(_linear(a[k], device, i)
                    for k in ("wq", "wk", "wv", "wo"))),
        _norm(layers["ln2"], device, i),
        MLP(*(_linear(m[k], device, i) for k in ("gate", "up", "down"))))


def from_jax_params(tree, cfg: ArchConfig, *, device="cuda") -> DecoderLM:
    """Build the port's :class:`DecoderLM` of ``cfg`` from the JAX package's
    ``DecoderLM`` parameter tree (numpy leaves, see the module docstring).

    Like the port's other entry points it builds on the card unless the
    caller asks for the CPU by name (``device="cpu"``); without a card the
    default raises."""
    device = require_device(device)
    layers = tree["layers"]
    extra = set(layers) - {"ln1", "attn", "ln2", "mlp"}
    if extra:
        raise NotImplementedError(
            f"layer entries {sorted(extra)} belong to model families that "
            "are not ported yet")
    return DecoderLM(
        cfg,
        Embedding(_tensor(tree["embed"]["table"], device)),
        Embedding(_tensor(tree["unembed"]["table"], device)),
        _norm(tree["final_norm"], device),
        [_block(layers, i, device) for i in range(cfg.num_layers)])
