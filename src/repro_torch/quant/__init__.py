"""``repro_torch.quant`` — symmetric int8 quantization of packed weights.

Entry points: :func:`quantize_packed` / :func:`quantize_tree` (one packed
weight / every packed node of a module tree; data-free amax calibration by
default), :func:`activation_calibration` (an observer that picks per-unit
clip ratios from sample activations) and :func:`dequantize_packed`.
"""

from repro_torch.core.sparsity import QDTYPE_INT8, QDTYPES
from repro_torch.quant.quantize import (
    CLIP_GRID,
    GRANULARITIES,
    QMAX,
    activation_calibration,
    amax_scales,
    dequantize_packed,
    quantize_packed,
    quantize_tree,
)

__all__ = ["CLIP_GRID", "GRANULARITIES", "QDTYPES", "QDTYPE_INT8", "QMAX",
           "activation_calibration", "amax_scales", "dequantize_packed",
           "quantize_packed", "quantize_tree"]
