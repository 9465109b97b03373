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
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.core import sparse_linear as sl
from repro_torch.core.sparsity import LAYOUT_XWT, LAYOUTS, PackedWeight


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
