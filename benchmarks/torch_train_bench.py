"""Training-step benchmark of the PyTorch/CUDA port (the counterpart of
``train_bench.py``): packed-vs-dense step time (``repro_torch.sparsetrain``).

Measures one reduced-config model under the training execution modes, on
the card by default (refused without one), and writes
``BENCH_train_h100.json`` with the card's name and power limit in it:

* ``dense``            — plain dense training step (the baseline).
* ``masked_premask``   — straight-through N:M premasking.
* ``sparsify``         — scheduled masks (``sparsetrain.masks``) applied in
  the step; the mask refresh is timed apart (it amortizes over
  ``update_every`` steps).
* ``sparsify_qat``     — scheduled masks + int8 fake-quant (``ste.py``).
* ``packed_finetune_xwT`` / ``packed_finetune_block`` — a value-only
  fine-tuning step *directly on the packed form* (the gradient through
  ``ExecPolicy(mode="packed")``: K1 / K2 in the forward on the card,
  ``sparsetrain.vjp``'s backward), on one representative layer matmul.
* ``dense_layer`` — the same grad step of that layer on its dense weight
  (``x @ w.T``), the baseline the two packed cases are divided by
  (``ratios_vs_dense_layer``); the model modes are divided by ``dense``
  (``ratios_vs_dense``).

The model is the reduced config, as ``train_bench.py`` runs it: at its
widths a step is mostly launch overhead.  ``--full`` adds the four model
modes at the arch's full width (``model_full_width``; stablelm_3b takes
about 60 GB of device memory).

Each step is timed on the host clock with ``torch.cuda.synchronize()``
before every clock read: the first call apart (``first_ms``: the kernel
library's build, allocator warm-up), then ``warmup`` calls, then the mean
of ``iters`` calls.  The train step updates the parameters in place, so
successive calls train on; the time of a step does not depend on the
values.  ``--device cpu`` runs the same harness on the CPU (wall time of
PyTorch's CPU kernels; writes ``BENCH_train_torch_cpu.json``).

    PYTHONPATH=src python benchmarks/torch_train_bench.py [--quick]
        [--full] [--device cpu] [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEFAULT_OUT = "BENCH_train_h100.json"


def _time(fn, dev, warmup=2, iters=5):
    """``(first_call_ms, steady_ms)``, host clock, the device synchronized
    before every clock read."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(max(0, warmup - 1)):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return first_ms, (time.perf_counter() - t0) / iters * 1e3


def bench_model_steps(arch: str, batch: int, seq: int, warmup: int,
                      iters: int, dev, full: bool = False):
    from repro_torch.configs.base import get_arch
    from repro_torch.core.sparse_linear import ExecPolicy, sparse_weights
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models.families import build_model
    from repro_torch.optim import adamw
    from repro_torch.sparsetrain import init_mask_state, parse_schedule
    from repro_torch.sparsetrain.masks import build_masks
    from repro_torch.train.train_loop import make_train_step, train_params

    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    model = build_model(cfg, device=dev, seed=0)
    params = train_params(model)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=100, warmup_steps=5)
    opt = adamw.init(opt_cfg, params)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch)
    b = global_batch(data_cfg, 0)
    sparsity = sparse_weights(model)

    sched = parse_schedule("2:16", 100)
    masks = init_mask_state(params, sparsity, sched, 60)["masks"]  # final

    cases = []

    def add(name, step_fn, *extra):
        compile_ms, ms = _time(lambda: step_fn(params, opt, b, 0, *extra),
                               dev, warmup=warmup, iters=iters)
        cases.append({"name": name, "step_ms": round(ms, 3),
                      "first_ms": round(compile_ms, 3)})
        print(f"  {name:24s} {ms:9.2f} ms/step "
              f"(first call {compile_ms:7.0f} ms)", flush=True)

    add("dense", make_train_step(model, opt_cfg,
                                 policy=ExecPolicy(mode="dense")))
    add("masked_premask", make_train_step(model, opt_cfg))
    add("sparsify", make_train_step(model, opt_cfg), masks)
    add("sparsify_qat",
        make_train_step(model, opt_cfg, fake_quant="int8"), masks)

    # mask-refresh cost (amortized over schedule.update_every steps)
    _, refresh_ms = _time(
        lambda: build_masks(params, sparsity, sched, len(sched.phases) - 1),
        dev, warmup=1, iters=1)
    print(f"  {'mask_refresh (1x)':24s} {refresh_ms:9.2f} ms "
          f"(every {sched.update_every} steps)", flush=True)
    return cfg, cases, refresh_ms, sched.update_every


def bench_packed_finetune(warmup: int, iters: int, dev):
    """Value-only fine-tuning grad step directly on the packed forms, and
    the same step of the layer's dense weight."""
    from repro_torch.core import sparse_linear as sl
    from repro_torch.core.sparse_linear import ExecPolicy, SparseLinear
    from repro_torch.core.sparsity import (SparsityConfig, pack_block,
                                           random_sparse_dense)

    cfg = SparsityConfig(8, 128)
    rng = np.random.default_rng(0)
    o, k, bsz = 256, 512, 64
    w = torch.from_numpy(random_sparse_dense(rng, o, k, cfg)).to(dev)
    x = torch.from_numpy(rng.standard_normal((bsz, k)).astype(
        np.float32)).to(dev)
    y_t = torch.from_numpy(rng.standard_normal((bsz, o)).astype(
        np.float32)).to(dev)
    pol = ExecPolicy(mode="packed",
                     backend="cuda" if dev.type == "cuda" else "reference")
    out = []

    def dense_step():
        wd = w.detach().requires_grad_(True)
        y = x @ wd.T
        (g,) = torch.autograd.grad(((y - y_t) ** 2).mean(), [wd])
        return wd.detach() - 1e-3 * g

    compile_ms, ms = _time(dense_step, dev, warmup=warmup, iters=iters)
    out.append({"name": "dense_layer", "step_ms": round(ms, 3),
                "first_ms": round(compile_ms, 3)})
    print(f"  {'dense_layer':24s} {ms:9.2f} ms/step ({o}x{k}, batch {bsz}, "
          f"x @ w.T)", flush=True)
    for layout, pw in (("xwT", sl.pack_params(SparseLinear(w, cfg), cfg)),
                       ("block", pack_block(w, cfg))):
        def step(pw=pw):
            v = pw.values.detach().requires_grad_(True)
            y = sl.apply(pw.replace(values=v, has_duplicates=False), x, pol)
            (g,) = torch.autograd.grad(((y - y_t) ** 2).mean(), [v])
            return v.detach() - 1e-3 * g

        compile_ms, ms = _time(step, dev, warmup=warmup, iters=iters)
        out.append({"name": f"packed_finetune_{layout}",
                    "step_ms": round(ms, 3),
                    "first_ms": round(compile_ms, 3)})
        print(f"  {'packed_finetune_' + layout:24s} {ms:9.2f} ms/step "
              f"({o}x{k}, batch {bsz}, backend {pol.backend})", flush=True)
    return out


def _ratios(cases, base):
    """Each case's step time over ``base``'s, from one list of cases."""
    by_name = {c["name"]: c["step_ms"] for c in cases}
    return {name: round(ms / by_name[base], 3) for name, ms in by_name.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--quick", action="store_true",
                    help="smoke: fewer iters, smaller batch")
    ap.add_argument("--full", action="store_true",
                    help="also time the model modes at the arch's full "
                         "width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without a CUDA device) or "
                         "cpu")
    ap.add_argument("--out", default=None,
                    help=f"output JSON (default {DEFAULT_OUT}; --device "
                         "cpu: BENCH_train_torch_cpu.json)")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch, args.seq, args.warmup, args.iters = 2, 32, 1, 3

    from repro_torch import obs
    from repro_torch.device import nvidia_smi_line, require_device

    try:
        dev = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    on_card = dev.type == "cuda"
    out_path = args.out or (DEFAULT_OUT if on_card
                            else "BENCH_train_torch_cpu.json")
    card = nvidia_smi_line() if on_card else None
    print(f"train-step benchmark: arch={args.arch} (reduced) "
          f"batch={args.batch} seq={args.seq} on {dev}"
          + (f" ({card})" if card else ""))
    cfg, cases, refresh_ms, update_every = bench_model_steps(
        args.arch, args.batch, args.seq, args.warmup, args.iters, dev)
    layer_cases = bench_packed_finetune(args.warmup, args.iters, dev)
    full = None
    if args.full:
        print(f"full width: arch={args.arch}", flush=True)
        _, full_cases, full_refresh_ms, _ = bench_model_steps(
            args.arch, args.batch, args.seq, args.warmup, args.iters, dev,
            full=True)
        full = {"cases": full_cases,
                "ratios_vs_dense": _ratios(full_cases, "dense"),
                "mask_refresh_ms": round(full_refresh_ms, 3),
                "peak_device_gb": (round(torch.cuda.max_memory_allocated(
                    dev) / 1e9, 3) if on_card else None)}

    blob = {
        # run_metadata first: the explicit keys below win on collision
        "meta": {**obs.run_metadata(),
                 "arch": cfg.name, "reduced": True, "batch": args.batch,
                 "seq": args.seq, "warmup": args.warmup,
                 "iters": args.iters,
                 "platform": "gpu" if on_card else "cpu",
                 "device": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                 "nvidia_smi_name_power_limit": card,
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "timing": "host clock, torch.cuda.synchronize() before "
                           "every clock read",
                 "generated_by": "benchmarks/torch_train_bench.py"
                                 + (" --quick" if args.quick else "")
                                 + f" --device {dev.type}"
                                 + (" --full" if args.full else ""),
                 "mask_refresh_ms": round(refresh_ms, 3),
                 "mask_update_every": update_every},
        "cases": cases + layer_cases,
        "ratios_vs_dense": _ratios(cases, "dense"),
        "ratios_vs_dense_layer": _ratios(layer_cases, "dense_layer"),
    }
    if full is not None:
        blob["model_full_width"] = full
    with open(out_path, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out_path} (sparsify/dense = "
          f"{blob['ratios_vs_dense']['sparsify']}, sparsify_qat/dense = "
          f"{blob['ratios_vs_dense']['sparsify_qat']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
