"""``repro_torch.quant`` — symmetric int8 quantization of packed weights."""

from repro_torch.quant.quantize import (
    GRANULARITIES,
    QMAX,
    amax_scales,
    dequantize_packed,
    quantize_packed,
)

__all__ = ["GRANULARITIES", "QMAX", "amax_scales", "dequantize_packed",
           "quantize_packed"]
