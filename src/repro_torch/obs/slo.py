"""Per-request phase attribution, SLO pass/fail, and goodput accounting.

"Where did this request's time go" decomposes a completed
:class:`~repro_torch.serve.Request`'s lifecycle timestamps into phases:

* ``queue_wait``        — submit → first slot claim
* ``prefill``           — first claim → first generated token
* ``decode``            — first token → completion
* ``preempt_reprefill`` — time lost to preemption round-trips (eviction →
  requeue → re-claim → re-ingesting already-processed tokens), accumulated
  by a preempting engine in ``req.preempt_overhead_s``; also *counted inside*
  ``prefill``/``decode`` above, so it is reported as an overlay, not a
  fifth disjoint slice.

Token accounting separates *useful* work (prompt tokens ingested once +
committed output tokens) from *wasted* work the serving stack re-did or
threw away: ``req.wasted_prefill_tokens`` (tokens re-fed after a
preemption evicted their KV pages) and ``req.rejected_draft_tokens``
(draft-tier proposals the verifier rejected).  Engines that preempt or
speculate mirror the same quantities live as
``serve_wasted_tokens_total{cause=preempt|spec_reject}`` counters; :func:`slo_report` rolls them into ``serve_goodput_ratio`` =
useful / (useful + wasted) and judges each request against
:class:`SLOConfig` (TTFT / e2e deadlines in milliseconds, matching the
``--slo-ttft-ms`` / ``--slo-e2e-ms`` serve flags).

Phase latencies aggregate through
:class:`~repro_torch.obs.sketch.QuantileSketch` (:func:`phase_sketches`), so
serve_bench percentile breakdowns merge exactly across runs and replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

from repro_torch.obs.sketch import DEFAULT_ALPHA, QuantileSketch

__all__ = [
    "PHASES", "SLOConfig", "phase_sketches", "request_phases",
    "request_tokens", "slo_report",
]

PHASES = ("queue_wait", "prefill", "decode", "preempt_reprefill")

REPORT_QUANTILES = (0.5, 0.9, 0.99)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-request latency objectives (milliseconds); None = not enforced."""
    ttft_ms: Optional[float] = None
    e2e_ms: Optional[float] = None

    def enabled(self) -> bool:
        return self.ttft_ms is not None or self.e2e_ms is not None


def request_phases(req) -> Dict[str, float]:
    """Phase durations (seconds) for one request; phases whose boundary
    timestamps are missing (incomplete request) are omitted."""
    out: Dict[str, float] = {}
    sub, claim = req.submit_ts, req.claim_ts
    first, done = req.first_token_ts, req.complete_ts
    if sub is not None and claim is not None:
        out["queue_wait"] = max(0.0, claim - sub)
    if claim is not None and first is not None:
        out["prefill"] = max(0.0, first - claim)
    if first is not None and done is not None:
        out["decode"] = max(0.0, done - first)
    overhead = getattr(req, "preempt_overhead_s", 0.0) or 0.0
    if overhead > 0.0:
        out["preempt_reprefill"] = overhead
    if sub is not None and done is not None:
        out["e2e"] = max(0.0, done - sub)
    if sub is not None and first is not None:
        out["ttft"] = max(0.0, first - sub)
    return out


def request_tokens(req) -> Dict[str, int]:
    """Useful vs wasted token counts for one request."""
    useful = len(req.prompt) + len(req.output or ())
    return {
        "useful": useful,
        "wasted_preempt": int(getattr(req, "wasted_prefill_tokens", 0) or 0),
        "wasted_spec_reject": int(
            getattr(req, "rejected_draft_tokens", 0) or 0),
    }


def phase_sketches(requests: Iterable,
                   alpha: float = DEFAULT_ALPHA
                   ) -> Dict[str, QuantileSketch]:
    """One mergeable sketch per phase (plus ``ttft``/``e2e``) over
    ``requests`` — the aggregation serve_bench reports and merges."""
    sketches: Dict[str, QuantileSketch] = {}
    for req in requests:
        for phase, dt in request_phases(req).items():
            sk = sketches.get(phase)
            if sk is None:
                sk = sketches[phase] = QuantileSketch(alpha=alpha)
            sk.observe(dt)
    return sketches


def _percentile_entry(sk: QuantileSketch,
                      qs: Sequence[float] = REPORT_QUANTILES) -> dict:
    out = {f"p{int(q * 100)}": sk.quantile(q) for q in qs}
    out["mean"] = sk.sum / sk.count if sk.count else None
    out["count"] = sk.count
    return out


def slo_report(requests: Sequence, slo: Optional[SLOConfig] = None,
               metrics=None, alpha: float = DEFAULT_ALPHA) -> dict:
    """The SLO / goodput / phase-breakdown report serve_bench embeds in its
    JSON and ``launch/serve.py --slo-report`` prints.

    Judges *completed* requests against ``slo`` (a request passes iff it
    meets every enabled deadline), aggregates phase latencies into
    sketch-backed percentiles, and computes the goodput ratio.  When a
    :class:`~repro_torch.obs.MetricsRegistry` is given, the verdicts are also
    published on it: ``serve_goodput_ratio`` gauge,
    ``serve_slo_pass_total`` / ``serve_slo_fail_total{slo=ttft|e2e}``
    counters.
    """
    slo = slo or SLOConfig()
    done = [r for r in requests if r.complete_ts is not None]
    useful = wasted_preempt = wasted_spec = 0
    for r in requests:
        toks = request_tokens(r)
        useful += toks["useful"]
        wasted_preempt += toks["wasted_preempt"]
        wasted_spec += toks["wasted_spec_reject"]
    wasted = wasted_preempt + wasted_spec
    ratio = useful / (useful + wasted) if (useful + wasted) else None

    n_pass = fail_ttft = fail_e2e = 0
    for r in done:
        ph = request_phases(r)
        ok = True
        if slo.ttft_ms is not None and ph.get("ttft") is not None \
                and ph["ttft"] * 1e3 > slo.ttft_ms:
            fail_ttft += 1
            ok = False
        if slo.e2e_ms is not None and ph.get("e2e") is not None \
                and ph["e2e"] * 1e3 > slo.e2e_ms:
            fail_e2e += 1
            ok = False
        n_pass += ok

    report = {
        "requests": len(requests),
        "completed": len(done),
        "preempted_requests": sum(
            1 for r in requests if getattr(r, "preempts", 0)),
        "goodput": {
            "useful_tokens": useful,
            "wasted_tokens": {"preempt": wasted_preempt,
                              "spec_reject": wasted_spec},
            "ratio": ratio,
        },
        "phases": {phase: _percentile_entry(sk)
                   for phase, sk in sorted(
                       phase_sketches(requests, alpha=alpha).items())},
    }
    if slo.enabled():
        report["slo"] = {
            "ttft_ms": slo.ttft_ms,
            "e2e_ms": slo.e2e_ms,
            "pass": n_pass,
            "fail": len(done) - n_pass,
            "fail_ttft": fail_ttft,
            "fail_e2e": fail_e2e,
            "attainment": (n_pass / len(done)) if done else None,
        }
    if metrics is not None:
        if ratio is not None:
            metrics.gauge(
                "serve_goodput_ratio",
                help="useful / (useful + wasted) tokens").set(ratio)
        if slo.enabled():
            metrics.counter("serve_slo_pass_total",
                            help="completed requests meeting every enabled "
                                 "SLO").inc(n_pass)
            if fail_ttft:
                metrics.counter("serve_slo_fail_total",
                                help="SLO deadline misses by objective",
                                slo="ttft").inc(fail_ttft)
            if fail_e2e:
                metrics.counter("serve_slo_fail_total",
                                help="SLO deadline misses by objective",
                                slo="e2e").inc(fail_e2e)
    return report
