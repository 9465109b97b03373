"""Kernel benchmarks of the PyTorch/CUDA port (the counterpart of
``kernel_bench.py``).

Two modes:

* **structural + measured** (``run()``: ``python
  benchmarks/torch_kernel_bench.py [--device cpu]``; ``python -m
  benchmarks.torch_run`` prints its rows too): for ``kernel_bench.py``'s ``CASES`` the dense (bf16)
  and packed weight bytes in the port's storage (bf16 values, int32
  indices); on the card each case's K1 (``demm_xwT``) device time against
  one bf16 ``torch.matmul`` on the dense weight and against the byte bound
  at 3.35 TB/s, and K1 against its plain version at 512x1024, 8:128 (the
  round trip).  ``--device cpu`` gives the byte rows only.
* **autotune** (``--autotune``; ``run_autotune()``):

    PYTHONPATH=src python benchmarks/torch_kernel_bench.py --autotune \\
        [--quick | --sweep] [--device cuda|cpu] [--out PATH]

For every distinct problem of the port's configs' packed projections —
today full-width ``stablelm_3b`` (``repro_torch.configs``): 2560x2560 and
6912x2560 at 5:80, 2560x6912 at 3:48 — in the four serving ops (``xwT``,
``xwT_q8`` per-row scales, ``xwT_block``, ``xwT_block_q8``) at the decode
batch (4 rows) and the prefill chunk (32 rows), and the paper-orientation
``spmm`` with B of 4 and of 256 columns, it measures

  1. the dense baseline, ``torch.matmul`` of the activations against the
     dense weight in the activation dtype (what serving pays without the
     packed format),
  2. the heuristic default dispatch (``repro_torch.tune.heuristic_default``:
     ``cuda`` with the wrappers' own heuristics on the card),
  3. the full autotuner (``repro_torch.tune.autotune_*``), which always
     measures the default too, so tuned <= default in its own table
     (``default.us`` and ``tuned.us`` both come from that table); the
     least of a few replays over several candidates favours the winner, so
     where the tuner picks other params than the default both are timed
     again in turns (default, tuned, tuned, default: ``turns_us``),

every one of them on the card as the tuner measures: a ring of operand
copies larger than L2, captured once as a CUDA graph and replayed between
CUDA events (device time per launch).  Activations are bfloat16, as served.
Each case also records how the tuner's ranking model
(``repro_torch.tune.estimate_us``) placed the fastest measured candidate:
``model.best_rank`` (1 = the model's first choice among the non-default
candidates) and ``model.top_us`` — for a measurement budget of 5 and of 8
candidates, the fastest time among the defaults plus the model's best
ranked — against ``tuned.us``.  ``--sweep`` measures every candidate that
survives the geometry and shared-memory checks, so those two say what the
ranking costs (``BENCH_kernels_h100_sweep.json``).
It writes ``BENCH_kernels_h100.json`` in ``kernel_bench.py``'s case schema
(``_case_entry``), so the unchanged ``benchmarks/compare_bench.py`` reads
it, with the card's name and power limit (``nvidia-smi``) in its header.
Tuned entries persist in the port's tuning cache (``--cache``, default
``results/tune_cache_torch.json``).

``--quick``: the 2560x2560 shape only (10 cases), fewer candidates.
``--device cpu`` runs on the CPU on purpose: the plain version is the only
candidate there, measured on wall time at the reduced config's shapes —
a check of the harness, not a measurement of the kernels.
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
import torch  # noqa: E402

DEFAULT_OUT = "BENCH_kernels_h100.json"

# Published peak memory rate of one H100 SXM (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12


def _cases():
    """``kernel_bench.py``'s CASES: (name, out, in, batch_tokens, pattern)."""
    from repro_torch.core.sparsity import SparsityConfig

    return [
        ("mlp_gate_decode", 6912, 2560, 8, SparsityConfig(8, 128)),
        ("mlp_down_decode", 2560, 6912, 8, SparsityConfig(8, 128)),
        ("attn_qkv_decode", 4096, 4096, 8, SparsityConfig(8, 128)),
        ("mlp_gate_prefill", 6912, 2560, 2048, SparsityConfig(8, 128)),
        ("finegrained_1:4", 4096, 4096, 8, SparsityConfig(1, 4)),
    ]


def _random_packed(rng, o, k, sp, device):
    """A random weight pruned to N:M: its packed values (bf16) and indices
    (int32), and the dense bf16 weight they unpack to."""
    from repro_torch.core.sparsity import pack, prune, unpack

    dense = prune(torch.from_numpy(rng.standard_normal(
        (o, k), dtype=np.float32)).to(device), sp)
    p = pack(dense, sp)
    vals = p.values.to(torch.bfloat16).contiguous()
    return vals, p.indices, unpack(vals, p.indices, sp, (o, k))


def run(verbose: bool = True, device: str = "cuda"):
    """``(name, value, derived)`` rows: per case the dense/packed weight
    byte ratio; on the card also K1's device time (us) against one bf16
    ``torch.matmul`` on the dense weight and the byte bound, and the round
    trip of K1 against its plain version."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.device import nvidia_smi_line, require_device
    from repro_torch.kernels.demm_xwT import demm_xwT, demm_xwT_plain
    from repro_torch.tune.autotune import measure, operand_ring

    dev = require_device(device)
    on_card = dev.type == "cuda"
    card = nvidia_smi_line() if on_card else None
    rows = []
    rng = np.random.default_rng(0)
    for name, o, k, bt, sp in _cases():
        g = k // sp.m
        dense_w_bytes = o * k * 2                            # bf16
        packed_bytes = o * g * sp.n_effective * (2 + 4)      # bf16 + int32
        rows.append((f"kernel_{name}_bytes_dense_over_packed",
                     dense_w_bytes / packed_bytes,
                     f"w_bytes {dense_w_bytes} -> {packed_bytes}"))
        if verbose:
            print(f"{name:22s} weights {dense_w_bytes / 1e6:7.2f}MB -> "
                  f"{packed_bytes / 1e6:6.2f}MB packed (bf16 values, int32 "
                  f"indices)", flush=True)
        if not on_card:
            continue
        vals, idx, w = _random_packed(rng, o, k, sp, dev)
        x = torch.from_numpy(rng.standard_normal((bt, k))).to(
            dev, torch.bfloat16)
        us = measure([lambda v=v, i=i: demm_xwT(x, v, i, sp,
                                                duplicates=False)
                      for v, i in operand_ring((vals, idx))]) * 1e6
        dense_us = measure([lambda wt=wt: torch.matmul(x, wt.T)
                            for (wt,) in operand_ring((w,))]) * 1e6
        nbytes = packed_bytes + x.nbytes + bt * o * 4        # y float32
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        label = f"{card}; dense {dense_us:.2f}us; bound {bound_us:.2f}us"
        rows.append((f"kernel_{name}_h100_us", us, label))
        rows.append((f"kernel_{name}_h100_dense_over_packed", dense_us / us,
                     label))
        if verbose:
            print(f"{name:22s} K1 {us:9.2f}us | bf16 matmul {dense_us:9.2f}"
                  f"us | bound {bound_us:8.2f}us | {card}", flush=True)
        del vals, idx, w, x
    if on_card:
        # the round trip: K1 against its plain version on the same operands
        sp = SparsityConfig(8, 128)
        vals, idx, _ = _random_packed(rng, 512, 1024, sp, dev)
        x = torch.from_numpy(rng.standard_normal((128, 1024)).astype(
            np.float32)).to(dev)
        t0 = time.perf_counter()
        got = demm_xwT(x, vals, idx, sp, duplicates=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = demm_xwT_plain(x, vals, idx, sp)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        rows.append(("kernel_cuda_roundtrip", dt * 1e6,
                     f"allclose=True; {card}"))
        if verbose:
            print(f"K1 vs its plain version (512x1024 @ 8:128, x float32): "
                  f"{dt * 1e3:.1f}ms first call, allclose [ok]; {card}")
    return rows


# the architectures whose projection shapes the bench measures: its own
# list, so that porting another config does not change its cases (the
# committed BENCH_kernels_h100*.json files hold these)
ARCHS = ("stablelm_3b",)


def projection_shapes(arch: str, device, reduced: bool):
    """(label, O, K, SparsityConfig) of the distinct packed projections of
    ``arch`` (one layer built on ``device``), the pattern adapted per
    projection as ``layers.init_linear`` does."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core import sparse_linear as sl
    from repro_torch.models.families import build_model

    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(dataclasses.replace(cfg, num_layers=1),
                        device=device, seed=0)

    seen, out = set(), []
    for name, mod in model.named_modules():
        if isinstance(mod, sl.SparseLinear):
            sp = sl.node_sparsity(mod)
            if sp is None:
                continue
            o, k = mod.w.shape
            if (o, k, sp) not in seen:
                seen.add((o, k, sp))
                out.append((f"{arch}_{name.split('.')[-1]}", o, k, sp))
    del model
    return out


def _measure_dense(x, w, warmup, iters):
    """``torch.matmul(x, wᵀ)`` over a ring of dense weight copies."""
    from repro_torch.tune.autotune import measure, operand_ring

    ring = operand_ring((w,))
    return measure([lambda wt=wt: torch.matmul(x, wt.T) for (wt,) in ring],
                   warmup=warmup, iters=iters)


def _turns(res, tensors, make_call, warmup, iters):
    """Where the tuner picked other params than the default: both timed
    again on a fresh ring, in turns (default, tuned, tuned, default), us."""
    from repro_torch import tune
    from repro_torch.tune.autotune import measure, operand_ring

    default = res.default
    if (res.best.backend, res.best.params) == (default.backend,
                                               default.params):
        return None
    ring = operand_ring(tensors)
    calls = {name: [make_call(tune.get_variant(res.problem.op, backend), ops,
                              params) for ops in ring]
             for name, backend, params in (
                 ("default", default.backend, default.params),
                 ("tuned", res.best.backend, res.best.params))}
    turns = {"default": [], "tuned": []}
    for name in ("default", "tuned", "tuned", "default"):
        turns[name].append(measure(calls[name], warmup=warmup,
                                   iters=iters) * 1e6)
    return turns


def _model_rank(res):
    """Where the ranking model put the fastest measured candidate of the
    selected backend, and the fastest time a measurement budget of 5 and of
    8 candidates (the defaults first, then the model's best ranked) would
    have found in this table."""
    from repro_torch import tune

    best = min((c for c in res.candidates if c.status == "measured"
                and c.backend == res.best.backend),
               key=lambda c: c.measured_s)
    defaults = [c for c in res.candidates if c.status == "measured"
                and c.params == tune.get_variant(
                    res.problem.op, c.backend).default_params(res.problem)]
    ranked = sorted((c for c in res.candidates if c.est_us is not None
                     and c not in defaults
                     and c.status not in ("pruned_geometry", "pruned_smem")),
                    key=lambda c: c.est_us)
    top = {}
    for budget in (5, 8):
        chosen = defaults + ranked[:max(0, budget - len(defaults))]
        times = [c.measured_s for c in chosen if c.status == "measured"
                 and c.backend == res.best.backend]
        # None: the budget reaches a candidate this run did not measure
        top[budget] = (min(times) * 1e6 if all(
            c.status in ("measured", "refused") for c in chosen) else None)
    return {"best_rank": (None if best in defaults
                          else ranked.index(best) + 1),
            "ranked": len(ranked), "top_us": top}


def _case_entry(name, key, shape, t_dense, res, verbose, turns=None):
    """The tuned-vs-default-vs-dense record of ``kernel_bench.py`` (one
    schema for every op — ``compare_bench.py`` parses it).  ``default`` and
    ``tuned`` are the tuner's own table; ``turns_us`` the two timed again
    in turns."""
    default = res.default
    default_us = default.measured_s * 1e6
    entry = {
        "name": name,
        "problem": key,
        "shape": shape,
        "dense_us": t_dense * 1e6,
        "dense_compile_us": None,
        "default": {"backend": default.backend, "params": default.params,
                    "us": default_us, "compile_us": None},
        "tuned": {"backend": res.best.backend, "params": res.best.params,
                  "us": res.best.measured_us},
        "tuned_vs_default": default_us / res.best.measured_us,
        "dense_vs_tuned": t_dense * 1e6 / res.best.measured_us,
        "turns_us": turns,
        "model": _model_rank(res),
        "candidates": res.table(),
    }
    if verbose:
        again = ("" if turns is None else
                 f" | turns default {turns['default']} tuned "
                 f"{turns['tuned']}")
        print(f"{name:34s} dense {t_dense * 1e6:9.2f}us | default "
              f"{default.backend:9s} {default_us:9.2f}us | tuned "
              f"{res.best.backend}{res.best.params} "
              f"{res.best.measured_us:9.2f}us "
              f"({entry['tuned_vs_default']:.3f}x vs default){again}",
              flush=True)
    return entry


def run_autotune(quick: bool = False, out_path: str = DEFAULT_OUT,
                 device: str = "cuda", verbose: bool = True, warmup: int = 1,
                 iters: "int | None" = None, cache_path=None,
                 sweep: bool = False):
    from repro_torch import obs, tune
    from repro_torch.core.sparsity import (PackedWeight, pack, pack_block,
                                           prune)
    from repro_torch.device import nvidia_smi_line, require_device
    from repro_torch.quant import quantize_packed
    from repro_torch.tune.autotune import measure, operand_ring

    dev = require_device(device)
    iters = iters or (3 if quick else 5)
    max_measure = 10 ** 6 if sweep else 4 if quick else 8
    kw = dict(max_measure=max_measure, warmup=warmup, iters=iters,
              persist=True)
    tune.set_default_cache(tune.TuneCache(cache_path))
    on_card = dev.type == "cuda"
    shapes = [s for arch in ARCHS
              for s in projection_shapes(arch, dev, reduced=not on_card)]
    if quick:
        shapes = shapes[:1]
    xdtype = torch.bfloat16
    rng = np.random.default_rng(0)
    results = []
    t_start = time.time()
    for label, o, k, sp in shapes:
        w = prune(torch.from_numpy(rng.standard_normal((o, k))).to(
            dev, torch.float32), sp)
        packed = pack(w, sp)
        vals, idx = packed.values.contiguous(), packed.indices.contiguous()
        pw_float = PackedWeight(vals, idx, cfg=sp, dense_shape=(o, k))
        qx = quantize_packed(pw_float)
        blk = pack_block(w, sp)
        qblk = quantize_packed(blk)
        w_x = w.to(xdtype)
        for bx in (4, 32):
            x = torch.from_numpy(rng.standard_normal((bx, k))).to(dev, xdtype)
            t_dense = _measure_dense(x, w_x, warmup, iters)
            shape = {"out": o, "k": k, "batch": bx,
                     "pattern": sp.pattern_name()}
            for op, node in (("xwT", pw_float), ("xwT_q8", qx),
                             ("xwT_block", blk), ("xwT_block_q8", qblk)):
                tensors = ((node.values, node.indices, node.active_groups,
                            node.scales) if node.layout == "block" else
                           (node.values, node.indices, node.scales))

                def make_call(v, ops, params, x=x):
                    args = [t for t in ops if t is not None]
                    return lambda: v.call(x, *args, sp, (o, k),
                                          duplicates=False, **params)

                if op == "xwT_block" or op == "xwT_block_q8":
                    res = tune.autotune_xwT_block(x, node, **kw)
                elif op == "xwT_q8":
                    res = tune.autotune_xwT_q8(x, node.values, node.indices,
                                               node.scales, sp, (o, k),
                                               duplicates=False, **kw)
                else:
                    res = tune.autotune_xwT(x, node.values, node.indices, sp,
                                            (o, k), duplicates=False, **kw)
                extra = ({"block_geom": list(node.block_geom)}
                         if node.layout == "block" else {})
                if node.qdtype:
                    extra["qdtype"] = node.qdtype
                results.append(_case_entry(
                    f"{label}_{op}_bx{bx}", tune.problem_key(res.problem),
                    {**shape, **extra}, t_dense, res, verbose,
                    _turns(res, tensors, make_call, warmup, iters)))
        # the paper orientation C = A @ B, with B of 4 and of 256 columns
        a_x = w.to(xdtype)
        for cd in (4, 256):
            b = torch.from_numpy(rng.standard_normal((k, cd))).to(dev, xdtype)
            ring = operand_ring((a_x,))
            t_dense = measure([lambda a=a: torch.matmul(a, b)
                               for (a,) in ring], warmup=warmup, iters=iters)
            del ring

            def make_call(v, ops, params, b=b):
                return lambda: v.call(*ops, b, sp, (o, k), duplicates=False,
                                      **params)

            res = tune.autotune_spmm(vals, idx, b, sp, (o, k),
                                     duplicates=False, **kw)
            results.append(_case_entry(
                f"{label}_spmm_cd{cd}", tune.problem_key(res.problem),
                {"out": o, "k": k, "batch": cd,
                 "pattern": sp.pattern_name()},
                t_dense, res, verbose,
                _turns(res, (vals, idx), make_call, warmup, iters)))
        del w, packed, pw_float, qx, blk, qblk, w_x, a_x
        if on_card:
            torch.cuda.empty_cache()
    blob = {
        "platform": "gpu" if on_card else "cpu",
        "device": {"kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "nvidia_smi_name_power_limit": (nvidia_smi_line()
                                                   if on_card else None)},
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "archs": list(ARCHS),
        "activations": "bfloat16",
        "generated_by": "benchmarks/torch_kernel_bench.py --autotune"
                        + (" --quick" if quick else "")
                        + (" --sweep" if sweep else "")
                        + f" --device {dev.type}",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "seconds": time.time() - t_start,
        "meta": obs.run_metadata(),
        "cases": results,
    }
    with open(out_path, "w") as f:
        json.dump(blob, f, indent=2)
    if verbose:
        print(f"wrote {out_path} ({len(results)} cases, platform="
              f"{blob['platform']}, {blob['device']})")
    return blob


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--autotune", action="store_true",
                    help="measure tuned vs default vs dense over the port's "
                         "projection shapes and write the BENCH file "
                         "(without it: the rows of run())")
    ap.add_argument("--quick", action="store_true",
                    help="one projection shape, fewer candidates")
    ap.add_argument("--sweep", action="store_true",
                    help="measure every candidate that survives the "
                         "geometry and shared-memory checks (no ranking "
                         "cut): what the ranking model's cut costs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without a CUDA device) or "
                         "cpu (the plain version at reduced shapes)")
    ap.add_argument("--out", default=None,
                    help=f"output JSON (default {DEFAULT_OUT}; --quick: "
                         "BENCH_kernels_h100_quick.json; --device cpu: "
                         "BENCH_kernels_torch_cpu.json)")
    ap.add_argument("--cache", default=None,
                    help="tuning cache file (default: the port's, "
                         "$REPRO_TORCH_TUNE_CACHE or "
                         "results/tune_cache_torch.json)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed CUDA-graph replays per candidate")
    args = ap.parse_args(argv)
    if args.quick and args.sweep:
        ap.error("--quick and --sweep do not go together")
    out = args.out
    if out is None:
        out = ("BENCH_kernels_torch_cpu.json" if args.device == "cpu"
               else "BENCH_kernels_h100_quick.json" if args.quick
               else "BENCH_kernels_h100_sweep.json" if args.sweep
               else DEFAULT_OUT)
    try:
        if not args.autotune:       # the structural + measured rows
            run(device=args.device)
            return 0
        run_autotune(quick=args.quick, out_path=out, device=args.device,
                     iters=args.iters, cache_path=args.cache,
                     sweep=args.sweep)
    except RuntimeError as e:
        if "no CUDA device" in str(e):
            ap.error(str(e))
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
