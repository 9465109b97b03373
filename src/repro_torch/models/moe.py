"""Mixture-of-Experts with sort-based (dropping) token dispatch — the local
path of the JAX package's ``models/moe.py``.

Each token's router softmax picks its top-k experts (ties to the lower
expert index, as ``jax.lax.top_k``), whose gates are renormalised to sum to
1.  The (token, expert) pairs are sorted by expert (stably), each takes its
rank among its expert's pairs, and a pair whose rank reaches the capacity
``int(capacity_factor * N * k / E) or 1`` is dropped (its share of the
token's output is 0; the block's residual passes the token on).  The kept
tokens are gathered into an (E, C, D) buffer, every expert's gated FFN runs
on its C rows as one batched product (the experts are dense, as in the
reference: no DeMM kernel), and the outputs come back weighted by their
gates.  The Switch load-balancing loss ``coef * E * sum(mean prob * share
of first choices)`` comes with the output.

Nothing here reads a device value on the host and no shape depends on the
routing, so a decode step with experts is capturable.

The combine differs from the reference's in order only: the reference adds
each pair's weighted output into its token's row with a scatter-add in
expert order; here the k contributions of every token are put back in
(token, choice) order and summed over the choices, the same sum in another
float32 order, and one without atomics (a CUDA ``index_add_`` adds in no
fixed order, and a captured step would not replay its eager run bit for
bit).

Expert parallelism (:func:`_apply_moe_ep`, which :func:`apply_moe` takes
under a sharding context whose tp degree divides the expert count, as the
reference's, in serving and in training): each tp rank holds E / tp experts
(``ShardingPlan`` places them), routing is local to the rank's dp shard of
the batch (a serving engine has no dp group: every rank routes all of a
tick's tokens, at one rank's capacity), every rank
builds the same (E, C, D) buffer, runs its experts on their rows, and the
ranks' outputs are gathered (exact) before the same combine.  Under grad
the gather's backward keeps the rank's experts' block and the dispatched
tokens' gradient is summed over tp (the router's, computed whole on every
rank, is not).  The aux loss is averaged over dp.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.core.pruning import top_k_stable
from repro_torch.core.sparse_linear import DENSE_POLICY
from repro_torch.models.layers import apply_linear, init_linear


class MoE(nn.Module):
    """Router (a dense linear, D -> E) and the experts' weights, (E, in,
    out) each, as the reference stores them."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router = router
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)


def init_moe(d: int, cfg: MoEConfig, *, generator: torch.Generator, device,
             dtype=torch.float32) -> MoE:
    """Random weights: the router as ``init_linear`` makes a dense one, the
    experts normal with scale in_features ** -0.5.  (The reference takes a
    ``sparse`` argument it does not use: router and experts are dense.)"""
    e, f = cfg.num_experts, cfg.d_ff_expert

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype) * scale

    router = init_linear(d, e, sparse=None, generator=generator,
                         device=device, dtype=dtype, name="router")
    return MoE(router, normal((e, d, f), d ** -0.5),
               normal((e, d, f), d ** -0.5), normal((e, f, d), f ** -0.5))


def capacity_of(cfg: MoEConfig, n_tok: int) -> int:
    """Rows per expert: ``int(capacity_factor * N * k / E) or 1``."""
    return int(cfg.capacity_factor * n_tok * cfg.experts_per_token
               / cfg.num_experts) or 1


def apply_moe(moe: MoE, x, cfg: MoEConfig, *,
              capacity: Optional[int] = None):
    """x (B, T, D) -> (y (B, T, D), aux loss 0-d float32).  Under a sharding
    context whose tp degree divides the expert count, the expert-parallel
    path (:func:`_apply_moe_ep`); else the local one."""
    from repro_torch.sharding.context import get_context

    ctx = get_context()
    if ctx is not None and cfg.num_experts % ctx.tp == 0:
        return _apply_moe_ep(moe, x, cfg, ctx, capacity=capacity)
    return _apply_moe_local(moe, x, cfg, capacity=capacity)


def _apply_moe_ep(moe: MoE, x, cfg: MoEConfig, ctx, *,
                  capacity: Optional[int] = None):
    """The expert-parallel path on this rank: ``x`` is its dp shard's rows
    (B_local, T, D), ``moe`` holds its E / tp experts (all E at tp 1).
    Capacity defaults to ``max(1, int(capacity_factor * n_local * k /
    E))`` of the local tokens, as the reference's; the aux loss is the
    mean over dp of the shards'."""
    e, tp = cfg.num_experts, ctx.tp
    if tp > 1 and moe.w_gate.shape[0] * tp != e:
        raise ValueError(
            f"expert parallelism over tp={tp} needs this rank's {e // tp} "
            f"experts, the module holds {moe.w_gate.shape[0]} (place it "
            "with ShardingPlan.shard_params, as the engines do, or "
            "place_for_training)")
    if capacity is None:
        n_local = x.shape[0] * x.shape[1]
        capacity = max(1, int(cfg.capacity_factor * n_local
                              * cfg.experts_per_token / e))
    return _apply_moe_local(moe, x, cfg, capacity=capacity, ctx=ctx)


def _apply_moe_local(moe: MoE, x, cfg: MoEConfig, *,
                     capacity: Optional[int] = None, ctx=None):
    """x (B, T, D) -> (y (B, T, D), aux loss 0-d float32): the reference's
    local path (``apply_moe`` without a sharding context): routing, the
    sort-based dispatch, the experts and the combine.  ``capacity``
    overrides :func:`capacity_of`'s rows per expert.  With ``ctx`` (from
    :func:`_apply_moe_ep`): this rank's experts' rows of the buffer, their
    outputs gathered over tp, the aux loss averaged over dp."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n_tok = b * t
    dev, dt = x.device, x.dtype
    xf = x.reshape(n_tok, d)

    logits = apply_linear(moe.router, xf, DENSE_POLICY).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (N, E)
    gate_vals, top_e = top_k_stable(probs, k)                 # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- load-balancing auxiliary loss (Switch) ----
    experts = torch.arange(e, device=dev)
    me = probs.mean(0)                                        # (E,)
    ce = (top_e[:, :1] == experts).to(torch.float32).mean(0)  # (E,)
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)
    if ctx is not None:
        aux = ctx.dp_mean(aux)

    # ---- sort-based dispatch ----
    if capacity is None:
        capacity = capacity_of(cfg, n_tok)
    flat_e = top_e.reshape(-1)                                # (N*k,)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    sg = gate_vals.reshape(-1)[order]
    stok = torch.div(order, k, rounding_mode="floor")       # its token
    # rank within the expert: the pairs are sorted by expert, so the rank
    # is the distance to the expert's first pair
    pos = torch.arange(n_tok * k, device=dev) - torch.searchsorted(se, se)
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, e * capacity)

    # the experts' input: under expert parallelism a rank's experts see
    # only their rows, so its gradient is summed over tp
    xe = xf if ctx is None else ctx.copy_tp(xf)
    buf = torch.zeros((e * capacity + 1, d), dtype=dt, device=dev)
    buf[slot] = xe[stok]                          # overflow -> the last row
    buf = buf[:-1].reshape(e, capacity, d)
    if ctx is not None and ctx.tp > 1:            # this rank's experts
        e_loc = e // ctx.tp
        buf = buf[ctx.tp_rank * e_loc:(ctx.tp_rank + 1) * e_loc]

    # ---- expert FFN (batched over the experts) ----
    g = torch.bmm(buf, moe.w_gate.to(dt))
    u = torch.bmm(buf, moe.w_up.to(dt))
    h = torch.nn.functional.silu(g.to(torch.float32)).to(dt) * u
    out = torch.bmm(h, moe.w_down.to(dt))                     # (E, C, D)
    if ctx is not None:
        out = ctx.gather_tp(out, 0)

    # ---- return gather + weighted combine, in (token, choice) order ----
    out_flat = out.reshape(e * capacity, d)
    gathered = torch.where(keep[:, None],
                           out_flat[slot.clamp(max=e * capacity - 1)],
                           torch.zeros((), dtype=dt, device=dev))
    contrib = gathered.to(torch.float32) * sg[:, None]        # sorted order
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib                                 # a permutation
    y = unsorted.reshape(n_tok, k, d).sum(1)
    return y.reshape(b, t, d).to(dt), aux
