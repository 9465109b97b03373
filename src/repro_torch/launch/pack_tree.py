"""Whole-model conversion to the DeMM packed serving form.

``pack_tree(model)`` walks the module tree and replaces every sparse linear
(a :class:`~repro_torch.core.sparse_linear.SparseLinear` that carries a
pattern) by a :class:`~repro_torch.core.sparsity.PackedWeight`, **in place**:
each dense weight is dropped as soon as it is packed, so a full-width model
never holds both forms.  ``quantize="int8"`` additionally quantizes every
packed node (``repro_torch.quant``): int8 values + scales + the ``qdtype``
tag, served by the w8a16 kernels.  ``layout`` selects the packed format:
``"xwT"`` (default, the row-packed serving stream) or ``"block"`` (the
two-level format of ``core.sparsity.pack_block`` — per row-block
active-group lists deciding which activation blocks the kernel reads).  The
port's modules hold one 2-D weight per layer, so every layer is packed on its
own, each with its own ``a_max`` unless one is given.

``pack_tree_shapes(model)`` is the shape-only twin (the JAX package's
``jax.eval_shape`` of ``pack_tree``, used by the dry-run census,
``launch.dryrun``): it packs a model on the meta device from the weights'
shapes alone, nothing pruned or packed from values.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core import sparse_linear as sl
from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    LAYOUT_XWT,
    LAYOUTS,
    QDTYPES,
    PackedWeight,
    _check_dims,
    _choose_block_r,
)


def pack_tree(module: nn.Module, layout: str = LAYOUT_XWT, *,
              block_r: Optional[int] = None, a_max: Optional[int] = None,
              quantize: Optional[str] = None, granularity: str = "per_row"):
    """Convert every sparse linear under ``module`` to a PackedWeight.

    ``block_r`` / ``a_max`` fix the block geometry for ``layout="block"``.
    ``quantize`` (e.g. ``"int8"``) quantizes each packed node on the fly and
    ``granularity`` picks the xwT scale unit (``per_row`` | ``per_group``);
    block nodes always take their per-(row-block, group, row) scales.
    Already-packed nodes pass through (and are quantized if requested).
    Returns ``module`` (or its packed replacement when ``module`` itself is a
    sparse linear).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected {LAYOUTS}")

    def q(pw: PackedWeight) -> PackedWeight:
        if quantize is None:
            return pw
        from repro_torch.quant import quantize_tree
        return quantize_tree(pw, quantize, granularity=granularity)

    def convert(node: nn.Module) -> nn.Module:
        if isinstance(node, PackedWeight):
            return q(node)
        if isinstance(node, sl.SparseLinear):
            cfg = sl.node_sparsity(node)
            if cfg is None:
                return node
            return q(sl.pack_params(node, cfg, layout, block_r=block_r,
                                    a_max=a_max))
        for name, child in list(node.named_children()):
            new = convert(child)
            if new is not child:
                setattr(node, name, new)
        return node

    return convert(module)


def _packed_shapes(node: sl.SparseLinear, cfg, layout: str, *, block_r,
                   a_max, quantize, granularity, path: str) -> PackedWeight:
    """The PackedWeight ``pack_params`` (then ``quantize_tree``) makes of
    ``node``, as meta tensors of its shapes and dtypes."""
    o, k = node.w.shape
    _check_dims((o, k), cfg.m)
    g, ne = k // cfg.m, cfg.n_effective

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    vdtype = torch.int8 if quantize else node.w.dtype
    if layout == LAYOUT_BLOCK:
        if a_max is None:
            raise ValueError(
                f"{path}: a block node's list length a_max depends on the "
                "weight's values (its densest row block); pass a_max to "
                "pack_tree_shapes")
        br = block_r if block_r is not None else _choose_block_r(o)
        if o % br:
            raise ValueError(f"{path}: rows {o} not divisible by "
                             f"block_r={br}")
        shape = (o // br, a_max, br, ne)
        scales = meta(shape[:-1], torch.float32) if quantize else None
        return PackedWeight(
            meta(shape, vdtype), meta(shape, torch.int32), cfg=cfg,
            dense_shape=(o, k), layout=LAYOUT_BLOCK,
            active_groups=meta(shape[:2], torch.int32),
            block_geom=(br, a_max), scales=scales, qdtype=quantize,
            has_duplicates=False)
    shape = (o, g, ne)
    scales = None
    if quantize:
        scales = meta((o, g) if granularity == "per_group" else (o,),
                      torch.float32)
    return PackedWeight(meta(shape, vdtype), meta(shape, torch.int32),
                        cfg=cfg, dense_shape=(o, k), layout=LAYOUT_XWT,
                        scales=scales, qdtype=quantize, has_duplicates=False)


def pack_tree_shapes(model: nn.Module, layout: str = LAYOUT_XWT, *,
                     block_r: Optional[int] = None,
                     a_max: Optional[int] = None,
                     quantize: Optional[str] = None,
                     granularity: str = "per_row"):
    """:func:`pack_tree`'s packed model with no value computed: every sparse
    linear under ``model`` (a model on the meta device,
    ``launch.specs.meta_model``) becomes a :class:`PackedWeight` of meta
    tensors of the packed shapes and dtypes — values and int32 indices
    ``(O, G, Ne)`` (``xwT``) or ``(RB, a_max, block_r, Ne)`` with
    ``active_groups (RB, a_max)`` (``block``), int8 values and float32
    scales under ``quantize="int8"`` — with the static attributes packing
    sets (no duplicates).  In place, as :func:`pack_tree`; returns
    ``model``.  A block node's ``a_max`` depends on the weight's values, so
    ``layout="block"`` needs it given (else ValueError); ``block_r``
    defaults to the packer's own choice from the row count."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected {LAYOUTS}")
    if quantize is not None and quantize not in QDTYPES:
        raise ValueError(f"unknown quantize {quantize!r}; expected one of "
                         f"{QDTYPES}")
    off_meta = [n for n, t in list(model.named_parameters())
                + list(model.named_buffers()) if t.device.type != "meta"]
    if off_meta:
        raise ValueError(f"pack_tree_shapes takes a model on the meta "
                         f"device; {off_meta[:3]} are not")

    def convert(node: nn.Module, path: str) -> nn.Module:
        if isinstance(node, sl.SparseLinear):
            cfg = sl.node_sparsity(node)
            if cfg is None:
                return node
            return _packed_shapes(node, cfg, layout, block_r=block_r,
                                  a_max=a_max, quantize=quantize,
                                  granularity=granularity, path=path)
        for name, child in list(node.named_children()):
            new = convert(child, f"{path}.{name}" if path else name)
            if new is not child:
                setattr(node, name, new)
        return node

    return convert(model, "")
