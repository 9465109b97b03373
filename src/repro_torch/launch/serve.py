"""Batched serving command line of the PyTorch/CUDA port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \\
        --full --packed [--layout block] [--quantize int8]

``--packed`` converts every sparse weight to the paper's packed DeMM form
before serving: the decode projections then stream only packed bytes.
``--layout block`` packs into the two-level block format instead of the
row-packed ``xwT`` stream: per row block, the list of active M-groups decides
which activation blocks the block-spmm kernel reads at all.
``--quantize int8`` additionally quantizes the packed values to symmetric
int8 (``repro_torch.quant``) — the projections then stream int8 bytes and
dequantize in-register (w8a16 kernel); ``--quantize-granularity per_group``
refines the scales from per-row to per-(row, group).

``--backend cuda`` (the default) runs every packed projection through the
hand-written CUDA kernels; ``--backend reference`` runs their plain PyTorch
versions.  ``--device`` defaults to ``cuda`` and the program refuses to start
without a CUDA device; ``--device cpu`` runs on the CPU on purpose (reduced
configs, tests).

On a CUDA device the engine captures its decode step once as a CUDA graph
and replays it every tick (``repro_torch.serve.serve_loop``).

``--paged`` swaps the dense-cache loop for the paged serving engine
(``repro_torch.paged``): a shared paged KV arena sized by
``--page-size``/``--max-pages``, chunked prefill (``--prefill-chunk`` tokens
per dispatch, the chunk program captured once as a second CUDA graph), and a
``--scheduler fcfs|priority`` admission/preemption policy (with
``--trace-replay``, the priorities come from the trace).

``--temperature``/``--top-k`` select replay-safe coupled sampling (0 =
greedy).  ``--trace-replay trace.jsonl`` replays a
``benchmarks/serve_bench.py`` trace at its logical arrival ticks, with prompt
tokens derived deterministically from ``(--seed, uid)``, as the JAX package's
serving program does.

Observability (``repro_torch.obs``): ``--metrics-out m.json`` writes the
process-wide metrics snapshot after the drain (a ``.prom`` suffix selects
Prometheus text exposition), ``--trace-out t.jsonl`` dumps the JSONL event
trace (``python -m repro_torch.obs.export t.jsonl --check`` converts it to a
Perfetto trace and checks its request attribution), ``--profile-dir d/``
wraps serving in a ``torch.profiler`` trace (``d/trace.json``),
``--slo-report`` (or a deadline, ``--slo-ttft-ms`` / ``--slo-e2e-ms``)
prints the SLO / goodput / phase-latency report, and ``--flight-dir d/``
attaches a flight recorder whose tick watchdog dumps its event rings on a
stall (``--watchdog-threshold``), a crash or SIGTERM; ``--force-stall``
proves the stall -> dump path after the drain.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.device import require_device
from repro_torch.launch.pack_tree import pack_tree
from repro_torch.models.families import build_model
from repro_torch.paged import PagedServeConfig, SchedConfig
from repro_torch.serve import Request, ServeConfig, make_engine


def _load_trace(path: str):
    """benchmarks/serve_bench.py trace format: JSONL rows of
    {uid, arrival_tick, prompt_len, max_new[, priority]}."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append(json.loads(line))
    return sorted(rows, key=lambda r: (r["arrival_tick"], r["uid"]))


def _trace_prompt(seed: int, uid: int, length: int, vocab: int):
    """Per-request deterministic prompt, replayable from (seed, uid) —
    matches benchmarks/serve_bench.py so replays are comparable."""
    return np.random.default_rng((seed, uid)).integers(
        0, vocab, length, dtype=np.int32)


def run_serve(model, vocab_size: int, *, packed: bool = True,
              layout: str = "xwT", quantize=None,
              granularity: str = "per_row", backend: str = "cuda",
              requests: int = 8, slots: int = 4, max_new: int = 16,
              max_len: int = 128, seed: int = 0, temperature: float = 0.0,
              top_k: int = 0, device="cuda", metrics=None,
              paged: bool = False, page_size: int = 16, max_pages=None,
              prefill_chunk: int = 32, scheduler: str = "fcfs",
              trace_replay=None, recorder=None):
    """Pack (optionally) and serve ``requests`` random prompts; returns the
    drained engine.  The reusable core of ``main()``.

    ``model`` must already live on ``device``.  ``device`` defaults to
    ``"cuda"``: without a CUDA device this raises before anything runs, and
    the CPU is used only when ``device="cpu"`` is passed.  ``packed=True``
    packs the model's sparse linears **in place** (``launch.pack_tree``).
    Prompt tokens are drawn with numpy from ``seed``, the same way the JAX
    package's serving program draws them.  ``paged=True`` serves through
    :class:`repro_torch.paged.PagedServeEngine` (shared KV arena of
    ``max_pages`` pages of ``page_size`` tokens, chunked prefill of
    ``prefill_chunk`` tokens, ``scheduler`` admission) instead of the
    dense-cache loop.  ``trace_replay`` submits a
    serve_bench-format JSONL trace at its logical arrival ticks instead of
    ``requests`` random prompts (prompt tokens from ``(seed, uid)``).
    ``recorder`` (a :class:`~repro_torch.obs.FlightRecorder`) is attached
    to the engine.
    """
    device = require_device(device)
    mode = "masked"
    if packed:
        model = pack_tree(model, layout=layout, quantize=quantize,
                          granularity=granularity)
        mode = "packed"
    policy = ExecPolicy(mode=mode, backend=backend)
    if paged:
        serve_cfg = PagedServeConfig(
            num_slots=slots, max_len=max_len, page_size=page_size,
            num_pages=max_pages, prefill_chunk=prefill_chunk,
            temperature=temperature, top_k=top_k, seed=seed,
            sched=SchedConfig(policy=scheduler))
    else:
        serve_cfg = ServeConfig(num_slots=slots, max_len=max_len,
                                temperature=temperature, top_k=top_k,
                                seed=seed)
    engine = make_engine(model, serve_cfg, policy=policy, device=device,
                         metrics=metrics, recorder=recorder)
    if trace_replay:
        rows = _load_trace(trace_replay)
        t0 = time.time()
        tick, i = 0, 0
        while i < len(rows):
            while i < len(rows) and rows[i]["arrival_tick"] <= tick:
                r = rows[i]
                engine.submit(Request(
                    uid=r["uid"],
                    prompt=_trace_prompt(seed, r["uid"], r["prompt_len"],
                                         vocab_size),
                    max_new_tokens=r["max_new"],
                    priority=r.get("priority", 1)))
                i += 1
            engine.step()
            tick += 1
        engine.drain_ticks = tick + engine.run_until_drained()
    else:
        rng = np.random.default_rng(seed)
        for i in range(requests):
            prompt = rng.integers(0, vocab_size, rng.integers(4, 12),
                                  dtype=np.int32)
            engine.submit(Request(uid=i, prompt=prompt,
                                  max_new_tokens=max_new))
        t0 = time.time()
        engine.drain_ticks = engine.run_until_drained()
    # decode-only wall time (packing / engine build excluded), so reported
    # tok/s stays comparable across runs
    engine.drain_seconds = time.time() - t0
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm_3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompt tokens and "
                         "the sampler")
    ap.add_argument("--paged", action="store_true",
                    help="serve through repro_torch.paged.PagedServeEngine: "
                         "shared paged KV arena + chunked prefill + "
                         "scheduled admission/preemption (full-attention "
                         "archs only)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="--paged: tokens per KV arena page")
    ap.add_argument("--max-pages", type=int, default=None,
                    help="--paged: arena pages incl. the reserved null page "
                         "(default: fully provisioned for the slots; "
                         "undersize to exercise preemption)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="--paged: prompt tokens per prefill dispatch")
    ap.add_argument("--scheduler", choices=("fcfs", "priority"),
                    default="fcfs",
                    help="--paged: admission policy (priority preempts "
                         "lower-priority requests for higher ones)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy); sampling is "
                         "replay-safe — randomness is keyed on (seed, "
                         "request, position)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k mask for temperature sampling (0 = full "
                         "vocab)")
    ap.add_argument("--sparsity", default=None, metavar="N:M",
                    help="override the arch's N:M sparsity pattern before "
                         "init/packing (e.g. 8:16)")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--layout", choices=("xwT", "block"), default="xwT",
                    help="packed-weight layout for --packed: the row-packed "
                         "xwT stream or the two-level block format "
                         "(pack_block; dispatches the block-spmm kernel)")
    ap.add_argument("--quantize", choices=("int8",), default=None,
                    help="quantize the packed values (repro_torch.quant): "
                         "int8 symmetric with scales, served by the w8a16 "
                         "xwT_q8 / xwT_block_q8 kernels")
    ap.add_argument("--quantize-granularity",
                    choices=("per_row", "per_group"), default="per_row",
                    help="xwT scale unit for --quantize (block is always per "
                         "row-block x group x row)")
    ap.add_argument("--full", action="store_true",
                    help="serve the full (non-reduced) config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused when no CUDA device is "
                         "present) or cpu")
    # valid backends come from the registry, so variants added via
    # repro_torch.tune.register_variant are immediately servable
    from repro_torch import tune
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot here after the drain "
                         "(.prom/.txt => Prometheus text exposition, "
                         "anything else => JSON)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the JSONL event trace (request lifecycle "
                         "spans/events) here")
    ap.add_argument("--trace-replay", default=None, metavar="JSONL",
                    help="replay this serve_bench-format trace ({uid, "
                         "arrival_tick, prompt_len, max_new, priority} "
                         "rows) at its logical ticks instead of --requests "
                         "random prompts")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serve run "
                         "into DIR/trace.json (Perfetto / chrome://tracing)")
    ap.add_argument("--slo-report", action="store_true",
                    help="print the SLO / goodput / phase-latency report "
                         "after the drain (repro_torch.obs.slo); implied by "
                         "--slo-ttft-ms/--slo-e2e-ms")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="time-to-first-token deadline in ms; completed "
                         "requests are judged pass/fail against it")
    ap.add_argument("--slo-e2e-ms", type=float, default=None,
                    help="end-to-end (submit -> complete) deadline in ms")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="attach a flight recorder (repro_torch.obs): "
                         "bounded per-subsystem event rings + a tick stall "
                         "watchdog; stalls, crashes, and SIGTERM dump "
                         "rings+metrics+metadata here")
    ap.add_argument("--watchdog-threshold", type=float, default=8.0,
                    help="--flight-dir: declare a stall when tick silence "
                         "exceeds this multiple of the EWMA tick interval "
                         "(floored at 1s)")
    ap.add_argument("--force-stall", action="store_true",
                    help="--flight-dir: after the drain, stop beating the "
                         "watchdog and wait for it to trip (proves the "
                         "stall->dump path); exits nonzero if no dump "
                         "appears")
    args = ap.parse_args(argv)
    if args.force_stall and not args.flight_dir:
        ap.error("--force-stall needs --flight-dir (there is no watchdog "
                 "to trip without a flight recorder)")
    if args.quantize and not args.packed:
        ap.error("--quantize applies to the packed serving form; add "
                 "--packed")
    # fail invalid layout/backend pairs here, not deep inside the first
    # decode step
    op = "xwT_block" if args.layout == "block" else "xwT"
    if args.quantize:
        op += "_q8"
    valid = {v.name for v in tune.variants_for(op)}
    if args.backend not in valid:
        ap.error(f"--backend {args.backend} is not a registered {op} "
                 f"variant for --layout {args.layout}"
                 + (f" --quantize {args.quantize}" if args.quantize else "")
                 + f" (valid: {sorted(valid)})")
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    log = obs.get_logger("launch.serve")
    recorder = None
    if args.flight_dir:
        recorder = obs.FlightRecorder(
            args.flight_dir, watchdog_threshold=args.watchdog_threshold)
        recorder.install_signal_handlers()
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.sparsity:
        from repro_torch.core.sparsity import SparsityConfig
        from repro_torch.spec.tiers import parse_tier
        n, m = parse_tier(args.sparsity)
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(n, m, 1))
    model = build_model(cfg, device=device, seed=args.seed)
    profile_ctx = (obs.profile(args.profile_dir) if args.profile_dir
                   else contextlib.nullcontext())
    guard_ctx = (recorder.guard() if recorder is not None
                 else contextlib.nullcontext())
    with profile_ctx, guard_ctx:
        engine = run_serve(model, cfg.vocab_size, packed=args.packed,
                           layout=args.layout, quantize=args.quantize,
                           granularity=args.quantize_granularity,
                           backend=args.backend, requests=args.requests,
                           slots=args.slots, max_new=args.max_new,
                           max_len=args.max_len, seed=args.seed,
                           temperature=args.temperature, top_k=args.top_k,
                           device=device, paged=args.paged,
                           page_size=args.page_size,
                           max_pages=args.max_pages,
                           prefill_chunk=args.prefill_chunk,
                           scheduler=args.scheduler,
                           trace_replay=args.trace_replay,
                           recorder=recorder)
    dt = engine.drain_seconds
    mode = "packed" if args.packed else "masked"
    total_tokens = sum(len(r.output) for r in engine.completed)
    tag = mode if not args.quantize else f"{mode}+{args.quantize}"
    if args.paged:
        tag += "+paged"
    log.info("served", requests=len(engine.completed), tokens=total_tokens,
             seconds=round(dt, 3),
             tok_s=round(total_tokens / max(dt, 1e-9), 1), mode=tag,
             backend=args.backend, device=str(device))
    for r in engine.completed[:3]:
        log.info(f"  req {r.uid}: prompt[:4]={r.prompt[:4].tolist()} "
                 f"-> {r.output[:8]}")
    slo_cfg = obs.SLOConfig(ttft_ms=args.slo_ttft_ms, e2e_ms=args.slo_e2e_ms)
    if args.slo_report or slo_cfg.enabled():
        report = obs.slo_report(engine.completed, slo_cfg,
                                metrics=engine.metrics)
        log.info("slo report\n" + json.dumps(report, indent=2))
    if args.metrics_out:
        engine.metrics.write(args.metrics_out)
        log.info("wrote metrics snapshot", path=args.metrics_out)
    if args.trace_out:
        engine.metrics.trace.write(args.trace_out)
        log.info("wrote event trace", path=args.trace_out)
    if args.profile_dir:
        log.info("wrote profiler trace", dir=args.profile_dir)
    if recorder is not None:
        if args.force_stall:
            # the drain is done, nothing beats the watchdog any more: the
            # stall must be detected and dumped on its own
            log.info("forcing a stall", flight_dir=args.flight_dir)
            if not recorder.wait_for_dump(timeout=30.0):
                recorder.close()
                raise SystemExit(
                    "--force-stall: no flight dump appeared within 30s")
            log.info("flight dump written", dumps=recorder.dumps)
        recorder.close()


if __name__ == "__main__":
    main()
