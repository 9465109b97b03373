"""Symmetric int8 quantization of packed relaxed-N:M sparse weights.

Granularity follows the packed layout:

* ``xwT``   — by default one scale per output row, ``scales (O,)``: the row
  is the reduction unit of the serving matmul ``y = x @ Wᵀ``, so a per-row
  scale folds into the kernel as one multiply per packed value.
  ``granularity="per_group"`` refines this to one scale per (row, M-group),
  ``scales (O, G)``: each group's Ne values share one exponent, which matters
  exactly when a row mixes large and small groups; the kernel cost is
  unchanged.
* ``block`` — one scale per (row-block, list slot, row), ``scales (RB, A_max,
  block_r)``, already per group; ``per_group`` does not apply and raises.

Quantization is symmetric round-to-nearest(-even): ``q = clip(round(v / s),
±127)`` with ``s = amax / 127`` (data-free).  Padded slots (value 0) quantize
to 0 and keep contributing nothing; a genuine weight that rounds to 0 merely
drops below the quantization floor.

Observers and activation calibration are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    QDTYPE_INT8,
    QDTYPES,
    PackedWeight,
    expand_scales,
)

QMAX = 127.0

_EPS = 1e-12

GRANULARITIES = ("per_row", "per_group")


def _check_granularity(pw: PackedWeight, granularity: str):
    if granularity not in GRANULARITIES:
        raise ValueError(f"unknown granularity {granularity!r}; expected "
                         f"one of {GRANULARITIES}")
    if granularity == "per_group" and pw.layout == LAYOUT_BLOCK:
        raise ValueError(
            "granularity only applies to the xwT layout; block scales are "
            "already per (row-block, group, row)")


def _reduce_axes(pw: PackedWeight, granularity: str = "per_row"):
    """Packed axes reduced away by one scale unit."""
    if pw.layout == LAYOUT_BLOCK or granularity == "per_group":
        return (-1,)
    return (-2, -1)


def amax_scales(pw: PackedWeight, granularity: str = "per_row") -> torch.Tensor:
    """Data-free calibration: ``amax / 127`` per scale unit (float32).

    Zero rows (fully padded slots) get a scale of ``1/127`` so the divide
    stays finite; their values are all 0 and quantize to 0 regardless.
    """
    _check_granularity(pw, granularity)
    amax = pw.values.to(torch.float32).abs().amax(
        dim=_reduce_axes(pw, granularity))
    return torch.where(amax > _EPS, amax, torch.ones_like(amax)) / QMAX


def _quantize_values(pw: PackedWeight, scales: torch.Tensor) -> torch.Tensor:
    q = torch.round(pw.values.to(torch.float32)
                    / expand_scales(scales, pw.values))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def quantize_packed(pw: PackedWeight, qdtype: str = QDTYPE_INT8, *,
                    granularity: str = "per_row") -> PackedWeight:
    """Quantize a float packed weight to ``qdtype`` (int8 today).

    Returns a new ``PackedWeight`` with int8 ``values``, a float32 ``scales``
    tensor — ``(O,)`` for ``per_row`` (the default), ``(O, G)`` for
    ``per_group``, ``(RB, A_max, block_r)`` for a block weight — and the
    ``qdtype`` tag; ``indices``, ``active_groups`` and the static attributes
    are shared unchanged.
    """
    if qdtype not in QDTYPES:
        raise ValueError(f"unknown qdtype {qdtype!r}; expected {QDTYPES}")
    if pw.qdtype is not None:
        raise ValueError(f"weight is already quantized ({pw.qdtype!r}); "
                         "dequantize_packed first to re-calibrate")
    _check_granularity(pw, granularity)
    scales = amax_scales(pw, granularity).to(torch.float32)
    return pw.replace(values=_quantize_values(pw, scales), scales=scales,
                      qdtype=qdtype)


def dequantize_packed(pw: PackedWeight) -> PackedWeight:
    """Back to the float packed form (float32 values, no scales)."""
    if pw.qdtype is None:
        return pw
    return pw.replace(values=pw.dequantized_values(), scales=None,
                      qdtype=None)
