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
"""

from __future__ import annotations

from typing import Callable

import torch


def _send_recv(out, ctx, inbox):
    """Send ``out`` to the next stage and receive the previous stage's
    output into ``inbox`` (None on stage 0); returns the received tensor."""
    import torch.distributed as dist

    rank, n = ctx.pp_rank, ctx.pp
    host = ctx.transport_on_host
    pending = None
    if rank < n - 1:
        payload = out.to("cpu") if host else out.contiguous()
        pending = dist.isend(payload, ctx.pp_ranks[rank + 1],
                             group=ctx.pp_group)
    got = None
    if rank > 0:
        buf = inbox.to("cpu") if host else inbox
        dist.recv(buf, ctx.pp_ranks[rank - 1], group=ctx.pp_group)
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
