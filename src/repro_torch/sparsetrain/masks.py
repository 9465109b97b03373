"""Gradual N:M sparsification schedules over ``core/pruning.py``.

The model trains dense for a warmup, is pruned to a coarse relaxed pattern
(larger groups — the paper's N:256), then annealed to the serving pattern
(N:128), with the mask refreshed from weight magnitude every
``update_every`` steps (straight-through gradients keep pruned weights
alive, so the pattern tracks the weights) and frozen late in training so
the final weights settle on a fixed support.  Phase configs may also carry
the paper's k-reconfiguration (``"8:128:2"`` = 16:128 served as 2 passes of
8:128).

Everything here is **host-driven and deterministic**: phase and refresh
decisions are pure functions of the integer step, and the masks are pure
functions of (weights, phase config), so the supervisor's restore-and-replay
fault tolerance reproduces the uninterrupted mask trajectory bitwise.  The
mask state rides the checkpoint through ``train/checkpoint.py`` (see
``recipes.SparseTrainer``).

Trees: the parameters are a dict of named tensors (``train_loop.
train_params``) and ``sparsity`` maps the name of every sparse linear's
weight to its stored :class:`SparsityConfig`
(``core.sparse_linear.sparse_weights(model)``); a mask tree is a dict of
bool tensors under the same names, one per sparse weight.

Per-node resolution: layers adapt their group size to the contraction dim
(``configs.base.choose_group``), so a schedule phase is resolved against
each node's own config:

* the **final** phase always resolves to the node's stored config — the
  pattern the model will be packed and served at;
* an intermediate phase applies verbatim where its group size divides the
  node's contraction dim, and falls back to a density-matched pattern at the
  node's native group size otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.pruning import straight_through_mask
from repro_torch.core.sparsity import SparsityConfig, prune_mask


@dataclasses.dataclass(frozen=True)
class SparsifyPhase:
    """One schedule phase: from ``start`` (inclusive) the masks follow
    ``cfg`` (``None`` = dense warmup, no masking)."""

    start: int
    cfg: Optional[SparsityConfig] = None

    def name(self) -> str:
        if self.cfg is None:
            return f"dense@{self.start}"
        n, m, k = self.cfg.n, self.cfg.m, self.cfg.k
        pat = f"{n}:{m}" if k == 1 else f"{n}:{m}:{k}"
        return f"{pat}@{self.start}"


@dataclasses.dataclass(frozen=True)
class SparsifySchedule:
    phases: Tuple[SparsifyPhase, ...]
    update_every: int = 25            # within-phase magnitude-mask refresh
    freeze_after: Optional[int] = None  # stop refreshing late in training

    def __post_init__(self):
        if not self.phases:
            raise ValueError("schedule needs at least one phase")
        starts = [p.start for p in self.phases]
        if starts != sorted(starts) or len(set(starts)) != len(starts):
            raise ValueError(f"phase starts must be strictly increasing, "
                             f"got {starts}")
        if self.phases[0].start != 0:
            raise ValueError("the first phase must start at step 0")
        if self.phases[-1].cfg is None:
            raise ValueError("the final phase must carry a SparsityConfig "
                             "(the pattern the model is packed at)")
        if self.update_every < 1:
            raise ValueError(f"update_every must be >= 1, "
                             f"got {self.update_every}")

    def phase_index(self, step: int) -> int:
        idx = 0
        for i, p in enumerate(self.phases):
            if step >= p.start:
                idx = i
        return idx

    def cfg_at(self, step: int) -> Optional[SparsityConfig]:
        return self.phases[self.phase_index(step)].cfg

    def spec(self) -> str:
        """Canonical string form — checkpointed so a resume can verify it
        is continuing the same schedule."""
        phases = ",".join(p.name() for p in self.phases)
        freeze = "-" if self.freeze_after is None else str(self.freeze_after)
        return f"{phases}|every{self.update_every}|freeze{freeze}"


def parse_pattern(s: str) -> SparsityConfig:
    """``"8:128"`` or ``"8:128:2"`` (k-reconfiguration) → SparsityConfig."""
    parts = s.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"cannot parse sparsity pattern {s!r}; expected "
                         "'n:m' or 'n:m:k'")
    n, m = int(parts[0]), int(parts[1])
    k = int(parts[2]) if len(parts) == 3 else 1
    return SparsityConfig(n, m, k)


def anneal_schedule(final_cfg: SparsityConfig, total_steps: int, *,
                    warmup_frac: float = 0.15, target_frac: float = 0.5,
                    freeze_frac: float = 0.9,
                    update_every: int = 25) -> SparsifySchedule:
    """The default 3-phase anneal: dense → N:2M (coarse groups) → N:M,
    frozen at ``freeze_frac`` of training so the surviving weights fine-tune
    on a fixed support."""
    t1 = max(1, int(total_steps * warmup_frac))
    t2 = max(t1 + 1, int(total_steps * target_frac))
    coarse = SparsityConfig(final_cfg.n, final_cfg.m * 2, final_cfg.k)
    return SparsifySchedule(
        phases=(SparsifyPhase(0, None), SparsifyPhase(t1, coarse),
                SparsifyPhase(t2, final_cfg)),
        update_every=update_every,
        freeze_after=max(t2 + 1, int(total_steps * freeze_frac)))


def parse_schedule(spec: str, total_steps: int, *, update_every: int = 25,
                   freeze_after: Optional[int] = None) -> SparsifySchedule:
    """Build a schedule from a command-line spec.

    ``"8:128"``                       → :func:`anneal_schedule` to 8:128.
    ``"dense@0,8:256@50,8:128@150"``  → explicit phases (the final phase's
    pattern is the serving target).

    ``freeze_after`` stops within-phase mask refreshes from that step on.
    For explicit phases it defaults to 90% of ``total_steps`` (past the last
    phase start) so the final support settles before baking.
    """
    if "@" not in spec:
        sched = anneal_schedule(parse_pattern(spec), total_steps,
                                update_every=update_every)
        if freeze_after is not None:
            sched = dataclasses.replace(sched, freeze_after=freeze_after)
        return sched
    phases = []
    for part in spec.split(","):
        pat, _, start = part.partition("@")
        if not start:
            raise ValueError(f"phase {part!r} needs an '@step' suffix")
        cfg = None if pat.strip() == "dense" else parse_pattern(pat.strip())
        phases.append(SparsifyPhase(int(start), cfg))
    if phases and phases[-1].start >= total_steps:
        raise ValueError(
            f"final phase starts at step {phases[-1].start} but the run is "
            f"only {total_steps} steps — the serving pattern would never "
            "apply (and the final bake would fail); extend --steps or move "
            "the phase earlier")
    if freeze_after is None:
        freeze_after = max(phases[-1].start + 1, int(total_steps * 0.9))
    return SparsifySchedule(phases=tuple(phases), update_every=update_every,
                            freeze_after=freeze_after)


# ---------------------------------------------------------------------------
# Per-node phase resolution
# ---------------------------------------------------------------------------

def node_phase_cfg(phase_cfg: Optional[SparsityConfig],
                   node_cfg: SparsityConfig, kdim: int,
                   is_final: bool) -> Optional[SparsityConfig]:
    """Resolve a schedule phase against one layer's stored config."""
    if phase_cfg is None:
        return None
    if is_final:
        return node_cfg
    if kdim % phase_cfg.m == 0:
        return phase_cfg
    ne = min(node_cfg.m, max(1, round(phase_cfg.density * node_cfg.m)))
    return SparsityConfig(ne, node_cfg.m, 1)


# ---------------------------------------------------------------------------
# Mask trees (one bool tensor per sparse weight)
# ---------------------------------------------------------------------------

def map_sparse_nodes(params: dict, sparsity: dict, fn) -> dict:
    """``{name: fn(params[name], cfg)}`` over the sparse weights, in
    ``sparsity``'s order: the single home of the sparse-node traversal."""
    return {name: fn(params[name], cfg) for name, cfg in sparsity.items()}


def build_masks(params: dict, sparsity: dict, schedule: SparsifySchedule,
                phase: int) -> dict:
    """Magnitude top-N:M masks for every sparse weight at ``phase``.

    Dense-phase masks are all-ones (straight-through identity), so one
    train step serves the whole schedule — only mask *contents* change
    across phases, never the tree."""
    phase_cfg = schedule.phases[phase].cfg
    is_final = phase == len(schedule.phases) - 1

    @torch.no_grad()
    def one(w, cfg):
        pcfg = node_phase_cfg(phase_cfg, cfg, int(w.shape[-1]), is_final)
        if pcfg is None:
            return torch.ones(w.shape, dtype=torch.bool, device=w.device)
        return prune_mask(w, pcfg)

    return map_sparse_nodes(params, sparsity, one)


def apply_mask_tree(params: dict, masks: dict) -> dict:
    """Straight-through masking of every sparse weight with its entry of a
    :func:`build_masks` tree (the gradient reaches the dense weight
    unmasked, so pruned weights can re-enter on the next refresh)."""
    return {name: straight_through_mask(p, masks[name]) if name in masks
            else p for name, p in params.items()}


@torch.no_grad()
def bake_masks(params: dict, masks: dict) -> dict:
    """Permanently zero the pruned weights (the pre-packing projection:
    after baking, every sparse linear satisfies its mask's pattern exactly
    and packs losslessly)."""
    return {name: p * masks[name].to(p.dtype) if name in masks else p
            for name, p in params.items()}


# ---------------------------------------------------------------------------
# Mask state: the checkpointable schedule position
# ---------------------------------------------------------------------------

def _scalar(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def init_mask_state(params: dict, sparsity: dict,
                    schedule: SparsifySchedule, step: int = 0) -> dict:
    phase = schedule.phase_index(step)
    return {"masks": build_masks(params, sparsity, schedule, phase),
            "phase": _scalar(phase), "last_update": _scalar(step)}


def update_mask_state(params: dict, sparsity: dict, state: dict,
                      schedule: SparsifySchedule, step: int):
    """Deterministic host-side mask refresh.  Returns ``(state, changed)``.

    A refresh happens on phase transitions (always — the schedule must
    advance even after ``freeze_after``) and every ``update_every`` steps
    within a sparse phase until ``freeze_after``.
    """
    phase = schedule.phase_index(step)
    cur = int(state["phase"])
    frozen = (schedule.freeze_after is not None
              and step >= schedule.freeze_after)
    due = phase != cur or (
        not frozen and schedule.phases[phase].cfg is not None
        and step - int(state["last_update"]) >= schedule.update_every)
    if not due:
        return state, False
    return {"masks": build_masks(params, sparsity, schedule, phase),
            "phase": _scalar(phase), "last_update": _scalar(step)}, True
