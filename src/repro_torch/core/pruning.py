"""Pruning schedules for relaxed N:M structured sparsity.

Two training-time paths, both of which produce weights that satisfy the
pattern and can be packed losslessly for DeMM serving:

* **Straight-through masked training** — the weight is kept dense; the
  forward pass multiplies by the top-N:M magnitude mask, the backward pass
  passes gradients straight through to the dense weight (so pruned weights
  keep receiving gradient and may re-enter the pattern later).  The masked
  execution mode uses the same projection, so a masked model and its packed
  form compute the same function.

* **RigL-style prune/regrow** — the mask is updated every ``update_every``
  steps: drop the smallest-magnitude kept weights, regrow at the positions
  with the largest dense-gradient magnitude, keeping exactly N per M group.

The top-k selections here are stable (among equal scores the lower column
wins), as the JAX package's ``lax.top_k`` is, so both give the same masks
bit for bit, ties included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig, prune_mask


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    cfg: SparsityConfig
    update_every: int = 100          # RigL mask-update cadence (steps)
    regrow_fraction: float = 0.3     # fraction of kept slots reconsidered
    stop_update_after: Optional[int] = None  # freeze mask late in training


class _StraightThroughMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mask):
        return w * mask.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        # the gradient reaches the dense weight unmasked; the mask has none
        return g, None


def straight_through_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``w * mask`` whose gradient passes to ``w`` unmasked."""
    return _StraightThroughMask.apply(w, mask)


def masked_weight(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Forward-time N:M projection with straight-through gradients: ``w``
    times its top-N:M mask, recomputed from the current weight every call
    ("soft" N:M, as SR-STE-style methods use)."""
    return straight_through_mask(w, prune_mask(w.detach(), cfg))


def top_k_stable(score: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the lower
    index first among equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot_set(shape, idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.bool, device=idx.device)
    return out.scatter_(-1, idx, on)


@torch.no_grad()
def rigl_update_mask(w: torch.Tensor, mask: torch.Tensor, grad: torch.Tensor,
                     sched: PruneSchedule) -> torch.Tensor:
    """One RigL mask update: drop smallest kept |w|, regrow largest |grad|.

    Operates per (row, group): scores kept slots by |w|, candidate slots by
    |grad|, and re-selects the top ``n_effective`` of the union with
    ``regrow_fraction`` of the budget reserved for gradient-selected slots.
    The result always satisfies the N:M pattern exactly.
    """
    cfg = sched.cfg
    r, kdim = w.shape
    g = kdim // cfg.m
    ne = cfg.n_effective
    n_regrow = max(1, int(round(sched.regrow_fraction * ne)))
    n_keep = ne - n_regrow
    shape = (r, g, cfg.m)
    neg = torch.tensor(float("-inf"), dtype=w.dtype, device=w.device)

    wg = w.reshape(shape).abs()
    gg = grad.reshape(shape).abs().to(w.dtype)
    mg = mask.reshape(shape).to(torch.bool)

    # Keep the n_keep largest-|w| currently-active slots...
    keep_vals, keep_idx = top_k_stable(torch.where(mg, wg, neg), n_keep)
    keep_oh = _one_hot_set(shape, keep_idx, keep_vals > neg)
    # ...and regrow the n_regrow largest-|grad| slots not kept.
    grow_vals, grow_idx = top_k_stable(torch.where(keep_oh, neg, gg), n_regrow)
    grow_oh = _one_hot_set(shape, grow_idx, grow_vals > neg)
    return (keep_oh | grow_oh).reshape(r, kdim)


def init_mask(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    return prune_mask(w, cfg)


def maybe_update_mask(step, w: torch.Tensor, mask: torch.Tensor,
                      grad: torch.Tensor, sched: PruneSchedule) -> torch.Tensor:
    """Apply the RigL update when the schedule says so (``step`` an int or
    a 0-d tensor, read on the host)."""
    step = int(step)
    due = step % sched.update_every == 0
    if sched.stop_update_after is not None:
        due = due and step < sched.stop_update_after
    return rigl_update_mask(w, mask, grad, sched) if due else mask
