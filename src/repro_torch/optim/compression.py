"""Gradient compression for data-parallel reduction.

Two schemes, as the JAX package's:

* :func:`topk_with_error_feedback` — keep the top-|g| fraction per tensor,
  add the dropped mass to a residual that is re-injected next step (error
  feedback keeps the scheme convergent).  Applied before the DP reduction,
  it cuts all-reduce volume by about 1 / fraction.

* :func:`int8_roundtrip` / :func:`compressed_psum_int8` — symmetric
  per-tensor int8 quantization.  ``compressed_psum_int8`` is the building
  block of a compressed all-reduce over a process group: each rank
  quantizes locally with the group's largest scale, the int8 payloads are
  summed as int32 (exact) and dequantized.

Trees are dicts of named tensors.  "Per tensor" is the JAX package's
tensor: its layers are stacked on a leading axis, so the port's per-layer
tensors of one name (``layers.0.mlp.gate.w``, ``layers.1.mlp.gate.w``,
...: the dotted names equal but for their numeric parts,
:func:`stack_groups`) share one max and one top-k selection.  Under a
training layout (``sharding.plan.TrainLayout``) a tensor split over tp is
compressed as a whole, as GSPMD computes the JAX package's: its max is
the max over the tp ranks, and its top-k threshold is taken from the
exact gather of its magnitudes, so that every rank keeps its block of the
whole tensor's selection.
"""

from __future__ import annotations

import torch


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _kth_largest(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest element of the 1-d ``a`` (``jax.lax.top_k(a,
    k)[0][-1]``)."""
    return torch.kthvalue(a, a.numel() - k + 1).values


def stack_groups(names) -> dict:
    """``{key: [names]}``: the names that are one stacked tensor of the
    JAX package's tree, keyed by the dotted name with its numeric parts
    (layer indices) replaced by ``*``, in order."""
    groups = {}
    for n in names:
        key = ".".join("*" if p.isdigit() else p for p in n.split("."))
        groups.setdefault(key, []).append(n)
    return groups


def topk_with_error_feedback(grads: dict, residuals, fraction: float, *,
                             layout=None):
    """Per-tensor magnitude top-k with error feedback.  Returns ``(sent,
    new residuals)``: each gradient plus its residual (float32), kept where
    its magnitude reaches the k-th largest of its stacked tensor's (k =
    max(1, int(fraction x numel))), the rest carried in the residual."""
    sent, resid = {}, {}
    g32 = {}
    for n, g in grads.items():
        r = None if residuals is None else residuals.get(n)
        if not _is_float(g):
            sent[n], resid[n] = g, r
        else:
            g32[n] = g.to(torch.float32) + (r if r is not None else 0.0)
    for members in stack_groups(g32).values():
        mags = [g32[n].abs() if layout is None
                else layout.whole(n, g32[n].abs()) for n in members]
        flat = torch.cat([m.reshape(-1) for m in mags])
        del mags
        k = max(1, int(fraction * flat.numel()))
        thresh = _kth_largest(flat, k)
        del flat
        for n in members:
            g = g32.pop(n)
            kept = torch.where(g.abs() >= thresh, g,
                               torch.zeros((), device=g.device))
            sent[n], resid[n] = kept.to(grads[n].dtype), g - kept
    return sent, resid


def int8_quantize(x: torch.Tensor, amax=None):
    """``(q int8, scale)``: symmetric per-tensor quantization with scale
    ``max(|x|.max(), 1e-12) / 127`` (``amax`` gives the max instead)."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_roundtrip(grads: dict, *, layout=None) -> dict:
    """Quantize and dequantize every tensor with its stacked tensor's
    scale (the numerics of a compressed all-reduce, on one rank)."""
    out = {n: g for n, g in grads.items() if not _is_float(g)}
    floats = [n for n, g in grads.items() if _is_float(g)]
    for members in stack_groups(floats).values():
        amax = torch.stack([grads[n].to(torch.float32).abs().max()
                            for n in members]).max()
        if layout is not None:
            amax = layout.tp_max(members[0], amax)
        for n in members:
            q, scale = int8_quantize(grads[n].to(torch.float32), amax)
            out[n] = (q.to(torch.float32) * scale).to(grads[n].dtype)
    return {n: out[n] for n in grads}


def compressed_psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8-compressed sum of ``x`` over ``group`` (a
    ``torch.distributed`` process group; None: the default group): each
    rank quantizes locally with the largest scale of the group (an
    ``all_reduce`` of MAX), the int8 payloads are summed as int32 (exact)
    and dequantized, float32.  On a ``gloo`` group of CUDA tensors the
    reductions go through the host."""
    import torch.distributed as dist

    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, group=group)
    return q.to(torch.float32) * scale
