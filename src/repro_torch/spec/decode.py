"""Draft → verify decode: the speculative window over one packed model.

One speculation window per engine tick (both engines share this module):

1. **draft** — γ sequential decode steps run with the *draft-tier* model
   (``spec.tiers.derive_draft_tier``; the same tensors, a narrower address
   stream), each proposing the next token with the replay-safe coupled
   sampler.  Draft steps write draft-quality KV into the shared cache —
   deliberately: there is no second decode state, no draft re-prefill after
   preemption, zero extra KV memory.
2. **verify** — ONE full-tier program re-feeds the whole window
   (:func:`make_multistep`: the W = γ+1 token columns through W decode
   steps, captured as one CUDA graph on a CUDA engine), rewriting every
   window position's KV with full-tier values and producing exact logits
   for each.  The port's decode state is written in place, so the engine
   moves ``pos`` back to the window's start before the verify: the verify
   runs from the pre-draft positions, as the JAX package's does from its
   pre-draft state.
3. **accept** — per lane, the committed tokens are the full-tier coupled
   samples; a drafted token survives iff it equals that sample, and the
   first mismatch truncates the window (the mismatching position still
   commits its full-tier token, so every window commits ≥ 1 token and an
   all-accepted window commits γ+1 — the bonus token).  The engine then
   sets each lane's ``pos`` to its last *valid* input, so stale draft KV
   beyond it is invisible (attention masks by ``pos``) and is overwritten by
   the next window.

Because the committed token at every position is exactly what the
non-speculative engine would emit (greedy argmax at temperature 0, the
Gumbel-max coupled sample otherwise), speculation changes dispatch count
and latency — never the token stream.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs.

    * ``draft`` — the sparser tier pattern, e.g. ``"6:16"`` to draft at 6:16
      from a model packed at 8:16.  Every packed node sharing the pattern's
      M and denser than its N drafts at the tier; the rest stay at the full
      tier.
    * ``gamma`` — tokens drafted per window; a window verifies γ+1
      positions in one full-tier program.
    """

    draft: str = "8:128"
    gamma: int = 4

    def __post_init__(self):
        from repro_torch.spec.tiers import parse_tier

        parse_tier(self.draft)          # validate eagerly
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")


def guard_cache_kinds(state, allowed=("full", "paged")):
    """Refuse decode states speculation cannot roll back.

    The accept step undoes rejected draft writes by resetting ``pos``: that
    only works when history is *position-addressable* — full and paged
    attention caches mask reads by ``pos`` and rewrite any position.  Ring
    buffers (swa / local_global) lose the entries a rejected write
    overwrote, and O(1) recurrent states (SSM / mLSTM) fold every input in
    irreversibly; both would silently diverge from the non-speculative
    stream.  Walks the state's ``{"kind": "<name>"}`` cache tags (plain
    strings in the port).
    """
    kinds = set()

    def walk(x):
        if isinstance(x, dict):
            k = x.get("kind")
            if isinstance(k, str):
                kinds.add(k)
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(state)
    bad = sorted(kinds - set(allowed))
    if bad or not kinds:
        raise NotImplementedError(
            f"speculative decoding requires position-addressable KV caches "
            f"(kinds {sorted(allowed)}); this decode state has "
            f"{bad or 'no tagged caches'} — ring buffers and recurrent "
            f"states cannot roll back rejected draft writes")
    return kinds


def make_multistep(model, policy):
    """The verify program: ``(state, tokens (B, W)) -> (logits (B, W, V),
    state)`` — W ``model.decode_step`` calls, one per token column, the KV
    caches written in place and the returned state carrying the advanced
    positions (the input state's ``pos`` tensor is not written).

    Built on ``decode_step``, so every cache kind the engines serve (dense,
    paged — with its active mask and null-page redirection) verifies through
    its ordinary decode path; ``W`` is only a shape, and a CUDA engine
    captures one graph per width it uses.
    """

    def multistep(state, tokens):
        logits = []
        for j in range(tokens.shape[1]):
            out, state = model.decode_step(state, tokens[:, j:j + 1],
                                           policy=policy)
            logits.append(out[:, 0])
        return torch.stack(logits, dim=1), state

    return multistep


class SpecMetrics:
    """The obs families of the speculative decoder."""

    def __init__(self, registry):
        m = registry
        self.drafted = m.counter(
            "spec_draft_tokens_total",
            help="draft-tier proposals fed to verification")
        self.accepted = m.counter(
            "spec_accepted_tokens_total",
            help="drafted tokens that matched the full-tier sample")
        self.rejected = m.counter(
            "spec_rejected_tokens_total",
            help="drafted tokens replaced by the full-tier sample")
        self.acceptance = m.histogram(
            "spec_acceptance_ratio",
            help="per-window accepted/drafted ratio",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        self.tokens_per_dispatch = m.gauge(
            "spec_tokens_per_dispatch",
            help="committed tokens per full-tier (verify) dispatch, "
                 "running mean")
        # goodput accounting (repro_torch.obs.slo): every drafted-but-
        # uncommitted proposal is draft-tier work thrown away.  Distinct
        # from spec_rejected_tokens_total, which counts only *examined*
        # drafts — drafts past a window truncation point are wasted too.
        self.wasted = m.counter(
            "serve_wasted_tokens_total",
            help="tokens of work the engine re-did or discarded, by cause",
            cause="spec_reject")
        self._committed_total = 0
        self._verify_dispatches = 0

    def observe_wasted(self, n: int):
        """Account ``n`` draft proposals discarded without commit."""
        self.wasted.inc(n)

    def observe_window(self, drafted: int, accepted: int, committed: int):
        """Account one speculation window (one verify dispatch)."""
        self.drafted.inc(drafted)
        self.accepted.inc(accepted)
        self.rejected.inc(drafted - accepted)
        if drafted:
            self.acceptance.observe(accepted / drafted)
        self._committed_total += committed
        self._verify_dispatches += 1
        self.tokens_per_dispatch.set(
            self._committed_total / self._verify_dispatches)
