"""GPipe-style pipeline parallelism over the ``pipe`` dim of a mesh.

Stages are contiguous layer groups, one per rank of the sharding context's
``pipe`` dim; microbatches stream through a chain of point-to-point sends
with the classic ``(num_microbatches + num_stages - 1)``-tick schedule:
stage ``s`` applies microbatch ``m`` at tick ``m + s``.  Bubble fraction
``(S - 1) / (M + S - 1)``.

SPMD as in the JAX package's ``shard_map`` (every rank runs every tick),
with two differences of idiom.  The JAX package runs each stage on bubble
ticks too and discards the state update with a validity mask; here the
rank knows on the host which ticks are bubbles and masks the stage itself
(it does not run), so a bubble tick cannot touch the caches.  And the ring
of ``ppermute`` becomes ``send`` / ``recv`` from each stage to the next
(the last stage's edge back to the first carries nothing stage 0 reads);
on a ``gloo`` group these go through host tensors, which is the transport
(gloo's ``send`` / ``recv`` take CPU tensors only), not a fallback.  The
last stage's outputs reach every rank by a ``broadcast``.

:func:`pipeline_apply` is the differentiable schedule (the JAX package's,
whose permutes are linear): its forward runs the stage on each microbatch
without recording history, keeping the stage's inputs; its backward runs
the GPipe schedule in reverse — the last stage first, each stage
recomputing its forward on a microbatch under grad and sending the input's
gradient up the chain to the stage before — and sums the stage parameters'
gradients over the microbatches.  The loss is taken as computed on every
rank from the broadcast outputs (the gradient at the outputs is the last
stage's own), and the input's gradient, stage 0's, is broadcast to every
rank.
"""

from __future__ import annotations

from typing import Callable

import torch


def _send_recv(out, ctx, inbox, reverse: bool = False):
    """Send ``out`` to the next stage and receive the previous stage's
    output into ``inbox`` (None on stage 0); returns the received tensor.
    ``reverse``: down the chain instead (to the stage before, from the
    stage after; None on the last stage)."""
    import torch.distributed as dist

    rank, n = ctx.pp_rank, ctx.pp
    step = -1 if reverse else 1
    to, frm = rank + step, rank - step
    host = ctx.transport_on_host
    pending = None
    if 0 <= to < n:
        payload = out.to("cpu") if host else out.contiguous()
        pending = dist.isend(payload, ctx.pp_ranks[to], group=ctx.pp_group)
    got = None
    if 0 <= frm < n:
        buf = inbox.to("cpu") if host else inbox
        dist.recv(buf, ctx.pp_ranks[frm], group=ctx.pp_group)
        got = buf.to(inbox.device) if host else buf
    if pending is not None:
        pending.wait()
    return got


def pipeline_apply_stateful(stage_fn: Callable, x: torch.Tensor, ctx, *,
                            aux=None) -> torch.Tensor:
    """Run this rank's stage of a microbatched pipeline.

    ``x`` (num_microbatches, mb, ...) is the input of stage 0 (every rank
    holds it); ``stage_fn(x_mb, aux_mb, mb_idx) -> y_mb`` applies this
    rank's stage to microbatch ``mb_idx`` (shape preserved) and may update
    the stage's state in place — it runs exactly once per microbatch, at
    tick ``mb_idx + stage``, never on a bubble tick.  ``aux``
    (num_microbatches, ...) carries per-microbatch side inputs (decode
    positions), indexed with the stage's live microbatch.  Returns the last
    stage's outputs (num_microbatches, mb, ...) on every rank."""
    import torch.distributed as dist

    rank, n = ctx.pp_rank, ctx.pp
    num_mb = x.shape[0]
    outputs = torch.zeros_like(x)
    inbox = torch.zeros_like(x[0])
    zeros = torch.zeros_like(x[0])
    for t in range(num_mb + n - 1):
        m = t - rank                     # this stage's live microbatch
        if 0 <= m < num_mb:
            inp = x[m] if rank == 0 else inbox
            out = stage_fn(inp, None if aux is None else aux[m], m)
            if rank == n - 1:
                outputs[m] = out
        else:
            out = zeros                  # a bubble: the stage does not run
        got = _send_recv(out, ctx, inbox)
        if got is not None:
            inbox = got
    # the last stage's outputs to every rank, in float32 (gloo's broadcast
    # of a CUDA tensor; 16-bit values round-trip exactly)
    wide = outputs.to(torch.float32)
    dist.broadcast(wide, ctx.pp_ranks[-1], group=ctx.pp_group)
    return wide.to(x.dtype)


def _broadcast(t: torch.Tensor, ctx, src_stage: int) -> torch.Tensor:
    """``t`` of stage ``src_stage`` on every rank of the pipe dim, in
    float32 (gloo's broadcast of a CUDA tensor; 16-bit values round-trip
    exactly)."""
    import torch.distributed as dist

    wide = t.to(torch.float32)
    dist.broadcast(wide, ctx.pp_ranks[src_stage], group=ctx.pp_group)
    return wide.to(t.dtype)


class _Pipeline(torch.autograd.Function):
    """The differentiable GPipe schedule (see the module docstring)."""

    @staticmethod
    def forward(fctx, stage_fn, ctx, names, x, *tensors):
        rank, n = ctx.pp_rank, ctx.pp
        num_mb = x.shape[0]
        params = dict(zip(names, tensors))
        outputs = torch.zeros_like(x)
        inbox = torch.zeros_like(x[0])
        zeros = torch.zeros_like(x[0])
        inputs = [None] * num_mb
        for t in range(num_mb + n - 1):
            m = t - rank
            if 0 <= m < num_mb:
                inputs[m] = x[m] if rank == 0 else inbox.clone()
                out = stage_fn(params, inputs[m])
                if rank == n - 1:
                    outputs[m] = out
            else:
                out = zeros
            got = _send_recv(out, ctx, inbox)
            if got is not None:
                inbox = got
        fctx.stage_fn, fctx.shctx, fctx.names = stage_fn, ctx, names
        fctx.save_for_backward(*inputs, *tensors)
        fctx.num_mb = num_mb
        return _broadcast(outputs, ctx, n - 1)

    @staticmethod
    def backward(fctx, grad_out):
        ctx, num_mb = fctx.shctx, fctx.num_mb
        rank, n = ctx.pp_rank, ctx.pp
        saved = fctx.saved_tensors
        inputs, tensors = saved[:num_mb], saved[num_mb:]
        params = {k: t.detach().requires_grad_(t.requires_grad)
                  for k, t in zip(fctx.names, tensors)}
        wants = [p for p in params.values() if p.requires_grad]
        dparams = [torch.zeros_like(p) for p in wants]
        dx = torch.zeros_like(grad_out)
        inbox = torch.zeros_like(grad_out[0])
        zeros = torch.zeros_like(grad_out[0])
        for t in range(num_mb + n - 1):
            m = t - (n - 1 - rank)          # the last stage goes first
            if 0 <= m < num_mb:
                g = grad_out[m] if rank == n - 1 else inbox.clone()
                inp = inputs[m].detach().requires_grad_(True)
                with torch.enable_grad():
                    out = fctx.stage_fn(params, inp)
                    got = torch.autograd.grad(out, [inp, *wants], g,
                                              allow_unused=True)
                din = got[0]
                for acc, gi in zip(dparams, got[1:]):
                    if gi is not None:
                        acc += gi
                if rank == 0:
                    dx[m] = din
            else:
                din = zeros
            recv = _send_recv(din, ctx, inbox, reverse=True)
            if recv is not None:
                inbox = recv
        dx = _broadcast(dx, ctx, 0)
        it = iter(dparams)
        dtensors = [next(it) if p.requires_grad else None
                    for p in params.values()]
        return (None, None, None, dx, *dtensors)


def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor,
                   ctx) -> torch.Tensor:
    """Returns ``stage_{S-1}(...stage_0(x))`` with shapes preserved, on every
    rank of the sharding context's ``pipe`` dim.

    ``stage_fn(stage_params, x_mb) -> y_mb``; ``stage_params`` is this
    rank's stage's tensors (a dict; the JAX package passes the stack and
    ``shard_map`` hands each rank its slice); ``x`` (num_microbatches, mb,
    ...) the input of stage 0, on every rank.  Differentiable in ``x`` and
    in ``stage_params`` (see the module docstring): the stage's gradients
    are this rank's, summed over the microbatches."""
    names = list(stage_params)
    return _Pipeline.apply(stage_fn, ctx, names, x,
                           *[stage_params[k] for k in names])
