"""Turn a parameter tree of the JAX package into the port's modules.

``from_jax_params(tree, cfg)`` takes a model's parameter tree (any family:
the decoder, with experts or the vision stub's ``patch_proj``; the
encoder-decoder; the Mamba2 hybrid; the xLSTM) with every leaf already a
numpy array — the caller runs ``np.asarray`` over it and
unwraps the JAX package's two node types, so that nothing here imports that
package:

* a sparse linear's static pattern (``{"w": ..., "sparsity": Static(cfg)}``)
  arrives as ``"sparsity": (n, m, k)`` (or any object with ``n``/``m``/``k``
  attributes);
* a packed weight arrives as a dict ``{"values", "indices", "cfg": (n, m, k),
  "dense_shape": (O, K), "layout": "xwT" | "block", "qdtype": None | "int8",
  "scales": array | None}``, a block weight also with ``"active_groups"``
  and ``"block_geom": (block_r, a_max)``, a draft-tier view also with
  ``"tier_ne": t`` (absent or None: the full tier).

The JAX package stacks the layers on a leading axis — ``w (L, O, K)``,
``values (L, O, G, Ne)`` or ``(L, RB, A_max, block_r, Ne)``,
``active_groups (L, RB, A_max)`` — for its layer scan (``layers``,
``enc_layers``, ``dec_layers``, ``periods``; an xLSTM period's ``mlstm``
blocks on a second axis); this un-stacks those axes into the port's
``nn.ModuleList``s.  The hybrid's ``shared`` block is not stacked.  A stacked block weight
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
from repro_torch.models.families import MixerLayer, XLSTMPeriod
from repro_torch.models.layers import MLP, Embedding, RMSNorm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import MLSTM, SLSTM, Mamba2
from repro_torch.models.transformer import DecoderLM, TBlock


def _sparsity(spec) -> SparsityConfig:
    if isinstance(spec, SparsityConfig):
        return spec
    if isinstance(spec, (tuple, list)):
        return SparsityConfig(*(int(v) for v in spec))
    return SparsityConfig(int(spec.n), int(spec.m), int(spec.k))


def _tensor(a, device, layer=None) -> torch.Tensor:
    """The leaf ``a``, or its entry ``layer`` of the stacked axes (an int,
    or a tuple for nested stacks), as a tensor on ``device`` (a copy)."""
    a = np.asarray(a)
    for i in (() if layer is None else
              layer if isinstance(layer, tuple) else (layer,)):
        a = a[i]
    return torch.from_numpy(np.array(a)).to(device)


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
            qdtype=node.get("qdtype"), tier_ne=node.get("tier_ne"))
    sp = node.get("sparsity")
    return SparseLinear(_tensor(node["w"], device, layer),
                        None if sp is None else _sparsity(sp))


def _norm(node, device, layer=None) -> RMSNorm:
    return RMSNorm(_tensor(node["scale"], device, layer))


def _attention(node, device, layer) -> Attention:
    return Attention(*(_linear(node[k], device, layer)
                       for k in ("wq", "wk", "wv", "wo")))


def _block(layers, i, device) -> TBlock:
    """Block ``i`` of a stacked block tree (``layers``, ``enc_layers`` or
    ``dec_layers``; ``i`` None for the hybrid's unstacked shared block)."""
    parts = {}
    if "xattn" in layers:
        parts["ln_x"] = _norm(layers["ln_x"], device, i)
        parts["xattn"] = _attention(layers["xattn"], device, i)
    if "moe" in layers:
        m = layers["moe"]
        parts["moe"] = MoE(_linear(m["router"], device, i),
                           *(_tensor(m[k], device, i)
                             for k in ("w_gate", "w_up", "w_down")))
    else:
        m = layers["mlp"]
        parts["mlp"] = MLP(*(_linear(m[k], device, i)
                             for k in ("gate", "up", "down")))
    return TBlock(_norm(layers["ln1"], device, i),
                  _attention(layers["attn"], device, i),
                  _norm(layers["ln2"], device, i), **parts)


def _mamba(node, device, i) -> Mamba2:
    return Mamba2(_linear(node["in_proj"], device, i),
                  *(_tensor(node[k], device, i)
                    for k in ("conv_w", "A_log", "D", "dt_bias")),
                  _norm(node["norm"], device, i),
                  _linear(node["out_proj"], device, i))


def _mlstm(node, device, i) -> MLSTM:
    return MLSTM(_linear(node["up"], device, i),
                 _tensor(node["conv_w"], device, i),
                 *(_linear(node[k], device, i)
                   for k in ("wq", "wk", "wv", "w_if")),
                 _norm(node["norm"], device, i),
                 _linear(node["down"], device, i))


def _slstm(node, device, i) -> SLSTM:
    return SLSTM(_linear(node["w_in"], device, i),
                 _tensor(node["r"], device, i), _norm(node["norm"], device, i),
                 _linear(node["down"], device, i))


def _block_keys(cfg: ArchConfig, cross: bool = False) -> set:
    keys = {"ln1", "attn", "ln2", "moe" if cfg.moe is not None else "mlp"}
    return keys | {"ln_x", "xattn"} if cross else keys


def _check_keys(node, want: set, what: str):
    extra = set(node) - want
    if extra:
        raise ValueError(f"{what}: entries {sorted(extra)} do not belong to "
                         "this config's tree")


def from_jax_params(tree, cfg: ArchConfig, *, device="cuda"):
    """Build the port's model of ``cfg`` (the class ``build_model`` picks)
    from the JAX package's parameter tree of the same family (numpy
    leaves, see the module docstring).

    Like the port's other entry points it builds on the card unless the
    caller asks for the CPU by name (``device="cpu"``); without a card the
    default raises."""
    from repro_torch.models.families import EncDecLM, HybridLM, XLSTMLM

    device = require_device(device)
    emb = [Embedding(_tensor(tree[k]["table"], device))
           for k in ("embed", "unembed")]
    final_norm = _norm(tree["final_norm"], device)
    if cfg.family == "audio":
        enc, dec = tree["enc_layers"], tree["dec_layers"]
        _check_keys(enc, _block_keys(cfg), "enc_layers")
        _check_keys(dec, _block_keys(cfg, cross=True), "dec_layers")
        return EncDecLM(
            cfg, _linear(tree["frame_proj"], device),
            [_block(enc, i, device) for i in range(cfg.encoder_layers)],
            _norm(tree["enc_norm"], device), *emb,
            [_block(dec, i, device) for i in range(cfg.num_layers)],
            final_norm)
    if cfg.family == "hybrid":
        layers = tree["layers"]
        return HybridLM(
            cfg, *emb,
            [MixerLayer(_norm(layers["ln"], device, i),
                        mamba=_mamba(layers["mamba"], device, i))
             for i in range(cfg.num_layers)],
            _block(tree["shared"], None, device), final_norm)
    if cfg.family == "ssm":
        per = tree["periods"]
        period, n_periods = XLSTMLM.layout(cfg)
        m, sl = per["mlstm"], per["slstm"]
        return XLSTMLM(cfg, *emb, [XLSTMPeriod(
            [MixerLayer(_norm(m["ln"], device, (p, i)),
                        blk=_mlstm(m["blk"], device, (p, i)))
             for i in range(period - 1)],
            MixerLayer(_norm(sl["ln"], device, p),
                       blk=_slstm(sl["blk"], device, p)))
            for p in range(n_periods)], final_norm)
    layers = tree["layers"]
    _check_keys(layers, _block_keys(cfg), "layers")
    patch = tree.get("patch_proj")
    return DecoderLM(
        cfg, *emb, final_norm,
        [_block(layers, i, device) for i in range(cfg.num_layers)],
        patch_proj=None if patch is None else _linear(patch, device))
