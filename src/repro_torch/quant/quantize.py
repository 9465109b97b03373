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
±127)`` with ``s = amax / 127`` (data-free) or an observer-provided scale.
Padded slots (value 0) quantize to 0 and keep contributing nothing; a
genuine weight that rounds to 0 merely drops below the quantization floor.

The optional activation-calibration observer (:func:`activation_calibration`)
searches a small clip grid per scale unit, weighting each packed slot's
quantization error by the mean square of the calibration activations at the
slot's *global* column (the diagonal approximation of the output MSE).  It
needs no labels and no backward pass — a handful of activation rows from the
serving distribution is enough.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from repro_torch.core.sparsity import (
    LAYOUT_BLOCK,
    QDTYPE_INT8,
    QDTYPES,
    PackedWeight,
    expand_scales,
)

QMAX = 127.0
# Clip ratios searched by the activation observer (1.0 = plain amax).
CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8)

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
                    observer: Optional[Callable] = None,
                    granularity: str = "per_row") -> PackedWeight:
    """Quantize a float packed weight to ``qdtype`` (int8 today).

    ``observer`` maps the float ``PackedWeight`` to per-unit scales (see
    :func:`activation_calibration`); by default the data-free
    :func:`amax_scales` pass is used.  Returns a new ``PackedWeight`` with
    int8 ``values``, a float32 ``scales`` tensor — ``(O,)`` for ``per_row``
    (the default), ``(O, G)`` for ``per_group``, ``(RB, A_max, block_r)``
    for a block weight; an observer's output shape wins over
    ``granularity`` — and the ``qdtype`` tag; ``indices``,
    ``active_groups`` and the static attributes are shared unchanged.
    """
    if qdtype not in QDTYPES:
        raise ValueError(f"unknown qdtype {qdtype!r}; expected {QDTYPES}")
    if pw.qdtype is not None:
        raise ValueError(f"weight is already quantized ({pw.qdtype!r}); "
                         "dequantize_packed first to re-calibrate")
    _check_granularity(pw, granularity)
    scales = (observer(pw) if observer is not None
              else amax_scales(pw, granularity)).to(torch.float32)
    return pw.replace(values=_quantize_values(pw, scales), scales=scales,
                      qdtype=qdtype)


def dequantize_packed(pw: PackedWeight) -> PackedWeight:
    """Back to the float packed form (float32 values, no scales)."""
    if pw.qdtype is None:
        return pw
    return pw.replace(values=pw.dequantized_values(), scales=None,
                      qdtype=None)


def quantize_tree(module, qdtype: str = QDTYPE_INT8, *,
                  observer: Optional[Callable] = None,
                  granularity: str = "per_row"):
    """Quantize every :class:`PackedWeight` under ``module`` (as
    ``launch.pack_tree`` leaves them), **in place**; everything else passes
    through.  Already-quantized nodes are left untouched.  ``granularity``
    applies to xwT-layout nodes (block nodes are per group already).
    Returns ``module``, or its quantized replacement when ``module`` itself
    is a ``PackedWeight``."""
    if isinstance(module, PackedWeight):
        if module.qdtype is not None:
            return module
        gran = "per_row" if module.layout == LAYOUT_BLOCK else granularity
        return quantize_packed(module, qdtype, observer=observer,
                               granularity=gran)
    if isinstance(module, nn.Module):
        for name, child in list(module.named_children()):
            new = quantize_tree(child, qdtype, observer=observer,
                                granularity=granularity)
            if new is not child:
                setattr(module, name, new)
    return module


# ---------------------------------------------------------------------------
# Activation calibration
# ---------------------------------------------------------------------------

def _slot_columns(pw: PackedWeight) -> torch.Tensor:
    """Global contraction-dim column of every packed slot (same shape as
    ``indices``): ``group_id * M + local_index``."""
    m = pw.cfg.m
    if pw.layout == LAYOUT_BLOCK:
        # active_groups (RB, A_max) carries the group ids.
        return (pw.active_groups[..., None, None] * m
                + pw.indices).to(torch.int32)
    gids = torch.arange(pw.groups, dtype=torch.int32,
                        device=pw.indices.device)[:, None]      # (G, 1)
    return (gids * m + pw.indices).to(torch.int32)


def activation_calibration(x: torch.Tensor,
                           grid: Sequence[float] = CLIP_GRID,
                           granularity: str = "per_row") -> Callable:
    """Observer factory: pick per-unit clip ratios from sample activations.

    ``x`` is a small ``(B, K)`` batch drawn from the serving distribution.
    For every scale unit the observer evaluates each clip ratio ``c`` in
    ``grid`` on the weighted quantization error

        err(c) = Σ_slots (deq_c(v) - v)² · mean(x²)[column(slot)]

    — the diagonal approximation of the output MSE ``‖x (W - Ŵ)ᵀ‖²`` — and
    keeps ``c * amax_scale`` of the least error (the first of equal ones).
    Clipping below amax trades a few saturated outliers for a finer grid on
    the bulk, which wins exactly when the activation mass says the bulk
    matters more.
    """
    act_sq = x.to(torch.float32).square().mean(dim=0)              # (K,)

    def observer(pw: PackedWeight) -> torch.Tensor:
        base = amax_scales(pw, granularity)
        axes = _reduce_axes(pw, granularity)
        v = pw.values.to(torch.float32)
        w = act_sq[_slot_columns(pw).to(torch.int64)]    # per-slot weight
        errs = []
        for c in grid:
            s = expand_scales(base * c, pw.values)
            deq = torch.clamp(torch.round(v / s), -QMAX, QMAX) * s
            errs.append(((deq - v).square() * w).sum(dim=axes))
        best = torch.argmin(torch.stack(errs), dim=0)   # first minimum
        ratios = torch.tensor(grid, dtype=torch.float32,
                              device=base.device)[best]
        return base * ratios

    return observer
