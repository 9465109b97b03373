"""Traffic-replay serving benchmark of the PyTorch/CUDA port: the paged
engine against the dense-cache engine (the counterpart of
``serve_bench.py``).

    PYTHONPATH=src python benchmarks/torch_serve_bench.py \\
        --trace benchmarks/traces/tiny_trace.jsonl [--full] \\
        [--packed [--layout block] [--quantize int8]] \\
        [--backend auto --autotune] [--compute-dtype bfloat16] \\
        [--sparsity 8:16 --spec 6:16 [--spec-gamma 4]] \\
        [--device cuda|cpu] [--out PATH]

The main path's sizes (full width, pages of 16, max_len 512, a fully
provisioned arena, bfloat16, a few hundred Poisson arrivals):

    PYTHONPATH=src python benchmarks/torch_serve_bench.py --full --packed \\
        --autotune --compute-dtype bfloat16 --requests 200 --rate 0.1 \\
        --max-prompt 256 --max-new 16 --max-len 512 --page-size 16

Replays traffic (a committed JSONL trace, or Poisson arrivals synthesized
from ``--seed``/``--rate``) through both serving engines of the port on the
same model and prompts:

* the dense :class:`~repro_torch.serve.serve_loop.ServeEngine` (one
  ``num_slots x max_len`` cache, prompts ingested a token per tick through
  the decode step), and
* the :class:`~repro_torch.paged.PagedServeEngine` (shared paged KV arena,
  chunked prefill as a second program, scheduled admission + preemption).

On a CUDA device both engines capture their programs as CUDA graphs (each
engine is warmed by one short request first, so captures stay out of the
timed replay).  Arrivals are logical engine ticks, so admission order,
preemptions and every token are deterministic; only latencies differ.  It
writes ``BENCH_serve_h100.json`` (``--device cpu``:
``results/BENCH_serve_torch_cpu.json``, out of the repository's tracked
files: a CPU run measures no device) with, per engine, p50/p99 TTFT and
end-to-end latency, decode tokens/s and prefill tokens/s (a prefill-only
drain, ``max_new=1``), and the checks of ``serve_bench.py``:

* ``token_identical`` — both engines emitted the same tokens for every
  request (a failure otherwise, in float32; ``requests_identical`` is the
  share of requests that agree);
* ``prefill_speedup`` — chunked-prefill tokens/s over token-by-token ingest
  (``--min-prefill-speedup`` makes it a gate);
* ``rel`` — same-host paged/dense ratios (lower is better).

Compute is float32 by default, as ``serve_bench.py`` runs it.
``--compute-dtype bfloat16`` runs what serving runs; token identity is then
reported and not a failure: in bfloat16, random-weight logits tie often
enough that the two engines' attention (a dense cache against gathered
pages), which sums in another order, flips greedy tokens.  ``--packed``
serves the packed weights through the
kernels (``--backend cuda``, or ``auto`` with ``--autotune``, which tunes at
the decode batch in each engine's constructor).

``--spec N:M`` (with ``--packed``) adds the speculative leg of
``serve_bench.py``: a packed non-speculative dense engine and a packed
speculative one (``repro_torch.spec``, draft tier N:M, ``--spec-gamma``
tokens a window) replay the same trace, and the leg reports the acceptance
rate, committed tokens per full-tier (verify) dispatch and the spec /
non-spec tokens/s ratio, gating token identity (float32) and
``--min-acceptance``.  Pair it with ``--sparsity`` (e.g. ``--sparsity 8:16
--spec 6:16``) so that the packed pattern has a tier the draft can narrow.
The packed model is tier-sorted once before any leg runs, so every leg
reads the same pair order.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

DEFAULT_TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "traces", "tiny_trace.jsonl")
_WARM_UID = 10 ** 9


def load_trace(path: str):
    reqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            reqs.append(json.loads(line))
    for i, r in enumerate(reqs):
        for key in ("uid", "arrival_tick", "prompt_len", "max_new"):
            if key not in r:
                raise ValueError(f"{path}:{i}: missing {key!r}")
        r.setdefault("priority", 1)
    return sorted(reqs, key=lambda r: (r["arrival_tick"], r["uid"]))


def poisson_trace(n: int, rate: float, seed: int, max_prompt: int,
                  max_new: int):
    """``n`` arrivals with exponential inter-arrival ticks."""
    rng = np.random.default_rng(seed)
    tick, reqs = 0, []
    for uid in range(n):
        tick += int(rng.exponential(1.0 / max(rate, 1e-6)))
        reqs.append({"uid": uid, "arrival_tick": tick,
                     "prompt_len": int(rng.integers(4, max_prompt + 1)),
                     "max_new": max_new,
                     "priority": int(rng.integers(0, 3))})
    return reqs


def make_prompt(seed: int, uid: int, length: int, vocab: int) -> np.ndarray:
    """Per-request deterministic prompt: replayable from (seed, uid), as
    ``serve_bench.py`` and ``launch.serve --trace-replay`` draw them."""
    return np.random.default_rng((seed, uid)).integers(0, vocab, length,
                                                       dtype=np.int32)


def _requests(trace, seed, vocab, uid_offset=0, max_new=None):
    from repro_torch.serve import Request

    return [(r["arrival_tick"],
             Request(uid=r["uid"] + uid_offset,
                     prompt=make_prompt(seed, r["uid"], r["prompt_len"],
                                        vocab),
                     max_new_tokens=max_new or r["max_new"],
                     priority=r["priority"]))
            for r in trace]


def _busy(engine) -> bool:
    if any(r is not None for r in engine.active):
        return True
    queue = getattr(engine, "queue", None)
    return len(queue if queue is not None else engine.sched) > 0


def replay(engine, pairs, sync, max_ticks=100000):
    """Tick-driven replay: submit at each request's arrival tick, step until
    drained.  Returns (wall seconds, ticks, peak arena occupancy)."""
    pending = sorted(pairs, key=lambda p: p[0])
    peak_occ, ticks, i = 0.0, 0, 0
    sync()
    t0 = time.perf_counter()
    while i < len(pending) or _busy(engine):
        while i < len(pending) and pending[i][0] <= ticks:
            engine.submit(pending[i][1])
            i += 1
        engine.step()
        ticks += 1
        if hasattr(engine, "kv"):
            peak_occ = max(peak_occ, engine.kv.occupancy())
        if ticks >= max_ticks:
            raise RuntimeError(f"replay did not drain in {max_ticks} ticks")
    sync()
    return time.perf_counter() - t0, ticks, peak_occ


def _warmup(engine, vocab, uid):
    """One short request: builds the kernels and captures the programs."""
    from repro_torch.serve import Request

    engine.submit(Request(uid=uid, prompt=make_prompt(0, uid, 4, vocab),
                          max_new_tokens=2))
    engine.run_until_drained()


def percentiles(xs):
    if not xs:
        return {"p50_s": None, "p99_s": None}
    return {"p50_s": float(np.percentile(xs, 50)),
            "p99_s": float(np.percentile(xs, 99))}


def lat_stats(reqs):
    ttft = [r.first_token_ts - r.submit_ts for r in reqs
            if r.first_token_ts is not None]
    e2e = [r.complete_ts - r.submit_ts for r in reqs
           if r.complete_ts is not None]
    return ({f"ttft_{k}": v for k, v in percentiles(ttft).items()} |
            {f"e2e_{k}": v for k, v in percentiles(e2e).items()})


def main(argv=None) -> int:
    import torch

    from repro_torch.configs.base import ARCH_IDS, get_arch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.device import nvidia_smi_line, require_device
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.obs.metrics import MetricsRegistry, run_metadata
    from repro_torch.obs.slo import SLOConfig, slo_report
    from repro_torch.paged import PagedServeConfig, SchedConfig
    from repro_torch.serve import ServeConfig, make_engine

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm_3b")
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: reduced)")
    ap.add_argument("--trace", default=None, metavar="JSONL",
                    help="replay this trace (default: Poisson arrivals); "
                         "lines of {uid, arrival_tick, prompt_len, max_new, "
                         "priority}")
    ap.add_argument("--requests", type=int, default=12,
                    help="Poisson mode: number of synthesized arrivals")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson mode: mean arrivals per tick")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompt tokens and Poisson arrivals")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=8,
                    help="Poisson mode: tokens generated per request")
    ap.add_argument("--max-prompt", type=int, default=40,
                    help="Poisson mode: max synthesized prompt length")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-pages", type=int, default=None,
                    help="arena pages incl. the null page (default: fully "
                         "provisioned; undersize it to exercise preemption)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--scheduler", choices=("fcfs", "priority"),
                    default="fcfs")
    ap.add_argument("--packed", action="store_true",
                    help="serve the packed weights through the DeMM kernels")
    ap.add_argument("--layout", choices=("xwT", "block"), default="xwT")
    ap.add_argument("--quantize", choices=("int8",), default=None)
    ap.add_argument("--backend", default="cuda",
                    help="packed matmul backend: cuda, reference or auto")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the packed weights at the decode batch in "
                         "each engine's constructor (implies --backend "
                         "auto)")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="float32 (token identity a gate) or bfloat16 "
                         "(what serving runs; token identity reported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without one) or cpu")
    ap.add_argument("--out", default=None,
                    help="output JSON (default BENCH_serve_h100.json; "
                         "--device cpu: results/BENCH_serve_torch_cpu.json)")
    ap.add_argument("--min-prefill-speedup", type=float, default=None,
                    help="fail unless chunked prefill beats token-by-token "
                         "ingest by this factor (tokens/s)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None)
    ap.add_argument("--slo-e2e-ms", type=float, default=None)
    ap.add_argument("--sparsity", default=None, metavar="N:M",
                    help="override the arch's N:M pattern on every sparse "
                         "linear (pair with --spec so that the draft tier "
                         "can narrow the packed weights)")
    ap.add_argument("--spec", default=None, metavar="N:M",
                    help="run the speculative leg with this draft tier "
                         "(needs --packed; repro_torch.spec)")
    ap.add_argument("--spec-gamma", type=int, default=4,
                    help="tokens drafted per speculation window")
    ap.add_argument("--min-acceptance", type=float, default=0.5,
                    help="spec leg: fail if the draft acceptance rate is at "
                         "or below this")
    args = ap.parse_args(argv)
    if args.autotune:
        args.backend = "auto"
    if (args.quantize or args.backend == "auto" or args.spec) \
            and not args.packed:
        ap.error("--quantize / --backend auto / --autotune / --spec apply "
                 "to the packed weights; add --packed")
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    out_path = args.out or (os.path.join("results",
                                         "BENCH_serve_torch_cpu.json")
                            if device.type == "cpu"
                            else "BENCH_serve_h100.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    trace = (load_trace(args.trace) if args.trace else
             poisson_trace(args.requests, args.rate, args.seed,
                           args.max_prompt, args.max_new))
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    if args.sparsity:
        from repro_torch.core.sparsity import SparsityConfig
        from repro_torch.spec import parse_tier
        n, m = parse_tier(args.sparsity)
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(n, m, 1))
    model = build_model(cfg, device=device, seed=args.seed)
    if args.packed:
        pack_tree(model, layout=args.layout, quantize=args.quantize)
    if args.spec:
        from repro_torch.spec import SpecConfig, tier_sort_tree
        spec = SpecConfig(draft=args.spec, gamma=args.spec_gamma)
        tier_sort_tree(model)    # in place: every leg reads this order
    policy = ExecPolicy(mode="packed" if args.packed else "masked",
                        backend=args.backend)
    vocab = cfg.vocab_size
    prompt_tokens = sum(r["prompt_len"] for r in trace)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    slo_cfg = SLOConfig(ttft_ms=args.slo_ttft_ms, e2e_ms=args.slo_e2e_ms)
    legs = {}
    for name in ("paged", "legacy"):
        reg = MetricsRegistry()
        if name == "paged":
            config = PagedServeConfig(
                num_slots=args.slots, max_len=args.max_len,
                page_size=args.page_size, num_pages=args.max_pages,
                prefill_chunk=args.prefill_chunk,
                sched=SchedConfig(policy=args.scheduler))
        else:
            config = ServeConfig(num_slots=args.slots, max_len=args.max_len)
        t0 = time.perf_counter()
        engine = make_engine(model, config, policy=policy, metrics=reg,
                             device=device, autotune=args.autotune)
        build_s = time.perf_counter() - t0
        _warmup(engine, vocab, _WARM_UID)
        dt, ticks, occ = replay(engine, _requests(trace, args.seed, vocab),
                                sync)
        reqs = [r for r in engine.completed if r.uid < _WARM_UID]
        tokens = sum(len(r.output) for r in reqs)
        # prefill-only drain: ingest throughput (max_new=1 ends each
        # request on its first token)
        pf_dt, _, _ = replay(engine, [(0, r) for _, r in _requests(
            trace, args.seed, vocab, uid_offset=2 * _WARM_UID, max_new=1)],
            sync)
        stats = {**lat_stats(reqs), "slo_report": slo_report(reqs, slo_cfg),
                 "tokens_per_sec": tokens / dt,
                 "prefill_tokens_per_sec": prompt_tokens / pf_dt,
                 "ticks": ticks, "build_s": build_s,
                 "outputs": {r.uid: list(r.output) for r in reqs}}
        if name == "paged":
            stats.update({
                "preempts": int(reg.counter("serve_preempt_total").value),
                "peak_occupancy": occ,
                "fragmentation": engine.kv.fragmentation(),
                "prefill_dispatches": engine.prefill.dispatches,
                "captures": [engine.captures, engine.prefill.captures]})
        legs[name] = stats
        del engine
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the speculative leg (packed weights, draft tier = --spec) ----------
    spec_stats = None
    if args.spec:
        runs = {}
        for name, leg_spec in (("base", None), ("spec", spec)):
            engine = make_engine(
                model, ServeConfig(num_slots=args.slots, max_len=args.max_len),
                policy=policy, metrics=MetricsRegistry(), device=device,
                spec=leg_spec)
            _warmup(engine, vocab, _WARM_UID)
            dt, _, _ = replay(engine, _requests(trace, args.seed, vocab),
                              sync)
            reqs = [r for r in engine.completed if r.uid < _WARM_UID]
            runs[name] = (engine, reqs, dt)
        (_, b_reqs, b_dt), (s_eng, s_reqs, s_dt) = runs["base"], runs["spec"]
        b_tps = sum(len(r.output) for r in b_reqs) / b_dt
        s_tps = sum(len(r.output) for r in s_reqs) / s_dt
        sm = s_eng._spec_metrics
        spec_stats = {
            **lat_stats(s_reqs),
            "slo_report": slo_report(s_reqs, slo_cfg),
            "draft": args.spec, "gamma": args.spec_gamma,
            "tier_report": str(s_eng.tier_report),
            "tokens_per_sec": s_tps,
            "baseline_tokens_per_sec": b_tps,
            "speedup": s_tps / b_tps,
            "drafted": int(sm.drafted.value),
            "accepted": int(sm.accepted.value),
            "acceptance_rate": sm.accepted.value / max(sm.drafted.value, 1),
            "tokens_per_dispatch": (sm._committed_total
                                    / max(sm._verify_dispatches, 1)),
            "verify_dispatches": sm._verify_dispatches,
            "spec_captures": s_eng.spec_captures,
            "token_identical": ({r.uid: list(r.output) for r in s_reqs}
                                == {r.uid: list(r.output) for r in b_reqs}),
        }
        del runs, s_eng
        if device.type == "cuda":
            torch.cuda.empty_cache()

    paged, legacy = legs["paged"], legs["legacy"]
    p_out, l_out = paged.pop("outputs"), legacy.pop("outputs")
    token_identical = p_out == l_out
    identical = sum(p_out[u] == l_out.get(u) for u in p_out) / len(p_out)
    speedup = (paged["prefill_tokens_per_sec"]
               / legacy["prefill_tokens_per_sec"])
    rel = {"ttft_p99": paged["ttft_p99_s"] / legacy["ttft_p99_s"],
           "e2e_p99": paged["e2e_p99_s"] / legacy["e2e_p99_s"],
           "tps": legacy["tokens_per_sec"] / paged["tokens_per_sec"],
           "prefill": 1.0 / speedup}
    blob = {
        "meta": {**run_metadata(), "arch": cfg.name, "full": args.full,
                 "num_layers": cfg.num_layers, "d_model": cfg.d_model,
                 "compute_dtype": cfg.compute_dtype, "seed": args.seed,
                 "device": str(device),
                 "device_kind": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                 "nvidia_smi_name_power_limit": (
                     nvidia_smi_line() if device.type == "cuda" else None),
                 "torch": torch.__version__,
                 "trace": args.trace or "poisson", "requests": len(trace),
                 "prompt_tokens": prompt_tokens, "slots": args.slots,
                 "max_len": args.max_len, "page_size": args.page_size,
                 "max_pages": args.max_pages,
                 "prefill_chunk": args.prefill_chunk,
                 "scheduler": args.scheduler, "packed": args.packed,
                 "sparsity": args.sparsity,
                 "layout": args.layout, "quantize": args.quantize,
                 "backend": args.backend, "autotune": args.autotune,
                 "generated_by": "benchmarks/torch_serve_bench.py "
                                 + " ".join(sys.argv[1:] if argv is None
                                            else argv)},
        "paged": paged,
        "legacy": legacy,
        "rel": rel,
        "token_identical": token_identical,
        "requests_identical": identical,
        "prefill_speedup": speedup,
        "spec": spec_stats,
    }
    with open(out_path, "w") as f:
        json.dump(blob, f, indent=2)

    print(f"replayed {len(trace)} requests ({prompt_tokens} prompt tokens) "
          f"on {cfg.name} ({cfg.num_layers} layers, {cfg.compute_dtype}, "
          f"{device}) [{args.scheduler}]")
    for name, s in (("paged", paged), ("legacy", legacy)):
        print(f"  {name:6s} ttft p50/p99 {s['ttft_p50_s'] * 1e3:8.1f}/"
              f"{s['ttft_p99_s'] * 1e3:8.1f} ms   e2e p99 "
              f"{s['e2e_p99_s'] * 1e3:8.1f} ms   {s['tokens_per_sec']:8.1f} "
              f"tok/s   prefill {s['prefill_tokens_per_sec']:9.1f} tok/s")
    print(f"  paged: {paged['preempts']} preempts, peak occupancy "
          f"{paged['peak_occupancy']:.2f}, {paged['prefill_dispatches']} "
          f"prefill dispatches")
    print(f"  prefill speedup {speedup:.2f}x, token_identical="
          f"{token_identical} ({identical:.1%} of requests)")
    if spec_stats:
        print(f"  spec   draft {spec_stats['draft']} gamma "
              f"{spec_stats['gamma']}: acceptance "
              f"{spec_stats['acceptance_rate']:.3f} "
              f"({spec_stats['accepted']}/{spec_stats['drafted']}), "
              f"{spec_stats['tokens_per_dispatch']:.2f} tokens/dispatch, "
              f"{spec_stats['tokens_per_sec']:8.1f} tok/s "
              f"({spec_stats['speedup']:.2f}x packed non-spec), "
              f"token_identical={spec_stats['token_identical']}")
    print(f"wrote {out_path}")

    failures = []
    if not token_identical and cfg.compute_dtype == "float32":
        diff = sorted(u for u in p_out if p_out[u] != l_out.get(u))
        failures.append(f"paged vs dense decode outputs differ (uids {diff})")
    if args.min_prefill_speedup and speedup < args.min_prefill_speedup:
        failures.append(f"prefill speedup {speedup:.2f}x < required "
                        f"{args.min_prefill_speedup}x")
    if spec_stats:
        if (not spec_stats["token_identical"]
                and cfg.compute_dtype == "float32"):
            failures.append("speculative decode diverged from the packed "
                            "non-spec stream")
        if spec_stats["acceptance_rate"] <= args.min_acceptance:
            failures.append(
                f"spec acceptance {spec_stats['acceptance_rate']:.3f} <= "
                f"required {args.min_acceptance}")
        if spec_stats["tokens_per_dispatch"] <= 1.0:
            failures.append(
                f"spec tokens/dispatch {spec_stats['tokens_per_dispatch']:.2f}"
                " <= 1 (speculation commits no extra tokens per full-tier "
                "dispatch)")
    if failures:
        print("\nFAIL:")
        for msg in failures:
            print(f"  {msg}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
