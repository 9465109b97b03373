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

``--temperature``/``--top-k`` select replay-safe coupled sampling (0 =
greedy).  ``--metrics-out m.json`` writes the process-wide metrics snapshot
after the drain (a ``.prom`` suffix selects Prometheus text exposition) and
``--trace-out t.jsonl`` dumps the JSONL event trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.device import require_device
from repro_torch.launch.pack_tree import pack_tree
from repro_torch.models.families import build_model
from repro_torch.serve import Request, ServeConfig, make_engine


def run_serve(model, vocab_size: int, *, packed: bool = True,
              layout: str = "xwT", quantize=None,
              granularity: str = "per_row", backend: str = "cuda",
              requests: int = 8, slots: int = 4, max_new: int = 16,
              max_len: int = 128, seed: int = 0, temperature: float = 0.0,
              top_k: int = 0, device="cuda", metrics=None):
    """Pack (optionally) and serve ``requests`` random prompts; returns the
    drained engine.  The reusable core of ``main()``.

    ``model`` must already live on ``device``.  ``device`` defaults to
    ``"cuda"``: without a CUDA device this raises before anything runs, and
    the CPU is used only when ``device="cpu"`` is passed.  ``packed=True``
    packs the model's sparse linears **in place** (``launch.pack_tree``).
    Prompt tokens are drawn with numpy from ``seed``, the same way the JAX
    package's serving program draws them.
    """
    device = require_device(device)
    mode = "masked"
    if packed:
        model = pack_tree(model, layout=layout, quantize=quantize,
                          granularity=granularity)
        mode = "packed"
    policy = ExecPolicy(mode=mode, backend=backend)
    serve_cfg = ServeConfig(num_slots=slots, max_len=max_len,
                            temperature=temperature, top_k=top_k, seed=seed)
    engine = make_engine(model, serve_cfg, policy=policy, device=device,
                         metrics=metrics)
    rng = np.random.default_rng(seed)
    for i in range(requests):
        prompt = rng.integers(0, vocab_size, rng.integers(4, 12),
                              dtype=np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
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
    args = ap.parse_args(argv)
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
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.sparsity:
        from repro_torch.core.sparsity import SparsityConfig
        from repro_torch.spec.tiers import parse_tier
        n, m = parse_tier(args.sparsity)
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(n, m, 1))
    model = build_model(cfg, device=device, seed=args.seed)
    engine = run_serve(model, cfg.vocab_size, packed=args.packed,
                       layout=args.layout, quantize=args.quantize,
                       granularity=args.quantize_granularity,
                       backend=args.backend, requests=args.requests,
                       slots=args.slots, max_new=args.max_new,
                       max_len=args.max_len, seed=args.seed,
                       temperature=args.temperature, top_k=args.top_k,
                       device=device)
    dt = engine.drain_seconds
    mode = "packed" if args.packed else "masked"
    total_tokens = sum(len(r.output) for r in engine.completed)
    tag = mode if not args.quantize else f"{mode}+{args.quantize}"
    log.info("served", requests=len(engine.completed), tokens=total_tokens,
             seconds=round(dt, 3),
             tok_s=round(total_tokens / max(dt, 1e-9), 1), mode=tag,
             backend=args.backend, device=str(device))
    for r in engine.completed[:3]:
        log.info(f"  req {r.uid}: prompt[:4]={r.prompt[:4].tolist()} "
                 f"-> {r.output[:8]}")
    if args.metrics_out:
        engine.metrics.write(args.metrics_out)
        log.info("wrote metrics snapshot", path=args.metrics_out)
    if args.trace_out:
        engine.metrics.trace.write(args.trace_out)
        log.info("wrote event trace", path=args.trace_out)


if __name__ == "__main__":
    main()
