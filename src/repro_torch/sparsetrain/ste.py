"""Straight-through fake quantization matching ``repro_torch.quant``.

QAT runs the *serving* arithmetic in the forward pass while keeping
full-precision weights and straight-through gradients in the backward pass.
The fake quantization here is bit-identical to what
``quant.quantize_packed`` serves — the same scale (``amax / 127`` with the
same zero-row guard), the same rounding (``torch.round``, half to even),
the same clip (±127).  Packing keeps exactly the non-zero (masked) entries of
each row or group, so the amax of a *masked dense* row equals the amax of
its packed values, and fake quantization of the masked training weight and
real quantization of the packed serving weight land on the same grid.

Granularities mirror ``repro_torch.quant`` for the xwT layout: ``per_row``
(one scale per output row, the serving default) and ``per_group`` (one per
(row, M-group)).

Gradients: the round is straight-through (identity); the clip passes the
gradient of weights on the grid, ±127 included, and stops that of weights
strictly beyond it; the scale is a constant (detached amax), matching the
data-free calibration that recomputes it from the weights at pack time.
"""

from __future__ import annotations

import torch

QMAX = 127.0
_EPS = 1e-12  # identical zero-row guard to repro_torch.quant.amax_scales

GRANULARITIES = ("per_row", "per_group")


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even, with a straight-through (identity) gradient."""
    return _SteRound.apply(x)


def amax_scale(w: torch.Tensor, dim, keepdim: bool = True,
               amax_reduce=None) -> torch.Tensor:
    """``amax / 127`` over ``dim`` with the quantizer's zero-row guard
    (all-zero units get scale 1/127 so the divide stays finite).
    ``amax_reduce`` maps the amax first (a row split over ranks: its max
    over them)."""
    amax = w.to(torch.float32).abs().amax(dim=dim, keepdim=keepdim)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    return torch.where(amax > _EPS, amax, torch.ones_like(amax)) / QMAX


def fake_quant(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize ``w`` on the int8 grid of ``scales``
    (broadcastable to ``w``), straight-through backward.

    The clip is *inclusive* straight-through: a weight landing exactly on
    ±127 (every row or group maximum does, under amax scales) keeps its full
    gradient, while weights strictly beyond the grid get zero."""
    s = scales.detach().to(torch.float32)
    r = ste_round(w.to(torch.float32) / s)
    q = torch.where(r.abs() <= QMAX, r, r.detach().clamp(-QMAX, QMAX))
    return (q * s).to(w.dtype)


def fake_quant_weight(w: torch.Tensor, *, m: int = 0,
                      granularity: str = "per_row",
                      amax_reduce=None) -> torch.Tensor:
    """Fake-quantize a (…, O, K) dense weight on the grid its packed form
    will serve at: ``per_row`` scales over the whole contraction dim K
    (``amax_reduce``: the row's amax over the ranks holding parts of it);
    ``per_group`` needs the sparsity group size ``m`` and scales per (row,
    M-group), the units ``quant.amax_scales`` uses on the packed layout."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"unknown granularity {granularity!r}; expected "
                         f"one of {GRANULARITIES}")
    if granularity == "per_row":
        return fake_quant(w, amax_scale(w, dim=-1, amax_reduce=amax_reduce))
    if m <= 0:
        raise ValueError("per_group fake quantization needs the sparsity "
                         "group size m")
    if w.shape[-1] % m:
        raise ValueError(f"contraction dim {w.shape[-1]} not divisible by "
                         f"group size m={m}")
    wg = w.reshape(*w.shape[:-1], w.shape[-1] // m, m)
    return fake_quant(wg, amax_scale(wg, dim=-1)).reshape(w.shape)
