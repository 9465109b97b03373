#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below, about two minutes
    python3 chip_smoke.py --sweep    # also time the kernels' one tunable

Needs a CUDA device and ``nvcc``; imports only ``repro_torch`` (from ``src/``
beside this file).  Each phase raises on failure, so the exit code is non-zero
unless all of them held:

1. device   — require CUDA; print the card's name and power limit.
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
              and load the library.
3. kernels  — ``demm_xwT`` and ``demm_xwT_q8`` (per-row and per-group scales)
              against their plain PyTorch versions on the card, at the three
              projection shapes of full-width stablelm_3b and the reduced 2:16
              shape, Bx in {1, 4, 37, 256}, x in float32 and bfloat16, plus
              duplicate indices, an all-padded row, a contraction dim that
              needs several shared-memory chunks, non-default tiles and
              bfloat16 packed values.
              Tolerances: float32 rtol/atol 1e-4 (summation order), bfloat16
              rtol/atol 2e-2.
4. serve    — full-width stablelm_3b, random weights from a seed, packed,
              backend ``cuda``: 4 requests x 8 new tokens on 4 slots; every
              request completes inside the true vocab and the float kernel was
              launched exactly 7 x 32 x ticks times.
5. serve q8 — the same with int8 values (per-row scales) and the int8 kernel.
6. agree    — full width, 2 layers, float32 compute: backend ``cuda`` and
              backend ``reference`` give allclose logits on every tick (rtol
              1e-3) and identical greedy token streams.
7. times    — per kernel and shape at Bx = 4 with bfloat16 activations (what
              the main path launches): CUDA-event medians of the kernel over a
              ring of weight copies larger than L2 (so every launch reads its
              weights from device memory, as a decode step does), replayed
              from a CUDA graph so that device time is measured and not the
              time Python takes to issue a launch (that is ``eager_ms``); the
              byte / operation bound, the plain version, and ``torch.matmul``
              against the dense weight in the same dtype as a yardstick the
              port never calls.

The last three lines are: the card as ``nvidia-smi`` names it, one JSON object
``{"kernels": [...], "serve": [...], "agree": {...}}`` (per kernel: launches on
the main path, error, times, bound; per serve run: ticks, decode-step time,
tokens/s), and one JSON object ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50e6

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (label, O, K, n, m) — what layers.init_linear gives full-width stablelm_3b
MAIN_SHAPES = [("wq/wk/wv/wo", 2560, 2560, 5, 80),
               ("gate/up", 6912, 2560, 5, 80),
               ("down", 2560, 6912, 3, 48)]
LAYER_MIX = {"wq/wk/wv/wo": 4, "gate/up": 2, "down": 1}   # launches per layer
REDUCED_SHAPE = ("reduced", 256, 128, 2, 16)
BATCHES = (1, 4, 37, 256)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_packed(o, k, n, m, gen, *, duplicates=False):
    """Random packed weight on the card: distinct sorted indices per group
    (or, with ``duplicates``, every slot of a group on one column, values
    quarter-integers, row 0 all padded)."""
    import torch
    g = k // m
    dev = gen.device
    if duplicates:
        idx = torch.randint(0, m, (o, g, 1), generator=gen, device=dev)
        idx = idx.expand(o, g, n).contiguous()
        vals = torch.randint(1, 9, (o, g, n), generator=gen, device=dev) / 4.0
        vals = vals * (torch.randint(0, 2, (o, g, n), generator=gen,
                                     device=dev) * 2 - 1)
        vals[0] = 0
        idx[0] = 0
    else:
        scores = torch.rand((o, g, m), generator=gen, device=dev)
        idx = scores.topk(n, dim=-1).indices.sort(dim=-1).values
        vals = torch.randn((o, g, n), generator=gen, device=dev)
    return vals.to(torch.float32).contiguous(), idx.to(torch.int32).contiguous()


def make_q8(o, g, n, per_group, gen):
    import torch
    dev = gen.device
    q = torch.randint(-127, 128, (o, g, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    shape = (o, g) if per_group else (o,)
    scales = torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.001
    return q, scales.to(torch.float32)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(gen):
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels.demm_q8 import demm_xwT_q8, demm_xwT_q8_plain
    from repro_torch.kernels.demm_xwT import demm_xwT, demm_xwT_plain

    err = {"demm_xwT": 0.0, "demm_xwT_q8": 0.0}
    n_cases = 0

    def compare(name, got, want, dtype, what, main):
        nonlocal n_cases
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: bad output {got.dtype} "
                                 f"{tuple(got.shape)}")
        torch.testing.assert_close(got, want, **TOL[dtype],
                                   msg=lambda m: f"{name} {what}: {m}")
        if main:
            err[name] = max(err[name], float((got - want).abs().max()))
        n_cases += 1

    def run_shape(label, o, k, n, m, batches, *, duplicates=False, main=False,
                  rows_per_block=None, values_dtype=torch.float32):
        cfg = SparsityConfig(n, m)
        g = k // m
        vals, idx = make_packed(o, k, n, m, gen, duplicates=duplicates)
        vals = vals.to(values_dtype)
        for bx in batches:
            for dtype in ("float32", "bfloat16"):
                x = torch.randn((bx, k), generator=gen, device=gen.device)
                x = x.to(getattr(torch, dtype))
                what = (f"{label} O={o} K={k} {n}:{m} Bx={bx} x={dtype}"
                        + (" duplicates" if duplicates else "")
                        + (f" rows_per_block={rows_per_block}"
                           if rows_per_block else ""))
                compare("demm_xwT",
                        demm_xwT(x, vals, idx, cfg,
                                 rows_per_block=rows_per_block),
                        demm_xwT_plain(x, vals, idx, cfg), dtype, what, main)
                for per_group in (False, True):
                    q, scales = make_q8(o, g, n, per_group, gen)
                    if duplicates:
                        q[0] = 0
                    compare("demm_xwT_q8",
                            demm_xwT_q8(x, q, idx, scales, cfg,
                                        rows_per_block=rows_per_block),
                            demm_xwT_q8_plain(x, q, idx, scales, cfg), dtype,
                            what + (" per_group" if per_group else " per_row"),
                            main)

    for shape in MAIN_SHAPES:
        run_shape(*shape, BATCHES, main=True)
    run_shape(*REDUCED_SHAPE, BATCHES, main=True)
    # K = 128 projections of the reduced config come out as 1:8
    run_shape("reduced 1:8", 384, 128, 1, 8, (4, 37))
    # duplicate indices and an all-padded row
    run_shape(*REDUCED_SHAPE, (4, 37), duplicates=True)
    run_shape(*MAIN_SHAPES[2], (4,), duplicates=True)
    # x tile larger than a block's shared memory: the group loop runs in chunks
    run_shape("chunked", 520, 16384, 8, 128, (8, 13))
    # non-default tiles, ragged against O
    run_shape("tiles", 1000, 2560, 5, 80, (4,), rows_per_block=8)
    run_shape("tiles", 1000, 2560, 5, 80, (3,), rows_per_block=72)
    # packed values already in bfloat16
    run_shape("bf16 values", 300, 2560, 5, 80, (4,),
              values_dtype=torch.bfloat16)
    # 8:16-style override pattern (dense-ish groups), tiny M
    run_shape("8:16", 384, 256, 8, 16, (2, 5))
    run_shape("1:1", 64, 32, 1, 1, (2,))
    return err, n_cases


# ---------------------------------------------------------------------------
# phases 4-6: serving
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels.demm_q8 import demm_xwT_q8
    from repro_torch.kernels.demm_xwT import demm_xwT
    demm_xwT.launches = 0
    demm_xwT_q8.launches = 0


def read_counts():
    from repro_torch.kernels.demm_q8 import demm_xwT_q8
    from repro_torch.kernels.demm_xwT import demm_xwT
    return {"demm_xwT": demm_xwT.launches, "demm_xwT_q8": demm_xwT_q8.launches}


def serve_full_width(model, cfg, *, quantize, expect):
    """Drive run_serve once; check the outputs and the launch counts."""
    import torch
    from repro_torch import obs
    from repro_torch.launch.serve import run_serve

    requests, max_new = 4, 8
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    engine = run_serve(model, cfg.vocab_size, packed=True, quantize=quantize,
                       backend="cuda", requests=requests, slots=4,
                       max_new=max_new, max_len=64, seed=0, device="cuda",
                       metrics=obs.MetricsRegistry())
    counts = read_counts()               # ... and just after
    ticks = engine.drain_ticks
    if len(engine.completed) != requests:
        raise AssertionError(f"{len(engine.completed)} of {requests} "
                             "requests completed")
    for r in engine.completed:
        if len(r.output) != max_new:
            raise AssertionError(f"request {r.uid}: {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token outside the true "
                                 f"vocab: {r.output}")
    import numpy as np
    if not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError("non-finite logits")
    want = 7 * cfg.num_layers * ticks
    other = ({"demm_xwT", "demm_xwT_q8"} - {expect}).pop()
    if counts[expect] != want or counts[other] != 0:
        raise AssertionError(
            f"launch counts {counts} after {ticks} ticks: expected "
            f"{expect}={want} (7 x {cfg.num_layers} x ticks), {other}=0")
    tokens = sum(len(r.output) for r in engine.completed)
    return {
        "quantize": quantize, "ticks": ticks, "tokens": tokens,
        "drain_s": engine.drain_seconds,
        "tick_ms_mean": 1e3 * engine.drain_seconds / ticks,
        "decode_step_ms_p50": 1e3 * engine._sk_tok.quantile(0.5),
        "tokens_per_s": tokens / engine.drain_seconds,
        "launches": counts[expect],
        "first_output": engine.completed[0].output,
    }


def serve_collect(model, cfg, backend):
    """Greedy serve on 2 slots, keeping every tick's logits."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, make_engine

    engine = make_engine(model, ServeConfig(num_slots=2, max_len=48),
                         policy=ExecPolicy(mode="packed", backend=backend),
                         device="cuda", metrics=obs.MetricsRegistry())
    rng = np.random.default_rng(1)
    for i in range(3):
        prompt = rng.integers(0, cfg.vocab_size, rng.integers(4, 9),
                              dtype=np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
    logits = []
    while engine.queue or any(r is not None for r in engine.active):
        engine.step()
        logits.append(engine.last_logits.copy())
    return logits, {r.uid: list(r.output) for r in engine.completed}


def check_backends_agree(cfg_full):
    import numpy as np
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model

    cfg = dataclasses.replace(cfg_full, num_layers=2, compute_dtype="float32")
    model = pack_tree(build_model(cfg, device="cuda", seed=1))
    la, ta = serve_collect(model, cfg, "cuda")
    lb, tb = serve_collect(model, cfg, "reference")
    if len(la) != len(lb):
        raise AssertionError(f"tick counts differ: {len(la)} vs {len(lb)}")
    worst = 0.0
    for t, (a, b) in enumerate(zip(la, lb)):
        a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
        if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(
                f"tick {t}: logits differ between backends, max abs "
                f"{np.abs(a - b).max()}")
        worst = max(worst, float(np.abs(a - b).max()))
    if ta != tb:
        raise AssertionError(f"token streams differ: {ta} vs {tb}")
    return {"ticks": len(la), "max_abs_logit_diff": worst, "streams": len(ta)}


def profile_ticks(model, cfg, ticks=5):
    """``--profile``: a steady window of decode ticks on 4 full slots, first
    on the host clock, then under ``torch.profiler``; prints the device-busy
    share and the kernels that take the device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, make_engine

    engine = make_engine(model, ServeConfig(num_slots=4, max_len=64),
                         policy=ExecPolicy(mode="packed", backend="cuda"),
                         device="cuda", metrics=obs.MetricsRegistry())
    rng = np.random.default_rng(0)
    for i in range(4):
        engine.submit(Request(uid=i, max_new_tokens=50, prompt=rng.integers(
            0, cfg.vocab_size, 4, dtype=np.int32)))
    for _ in range(6):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    plain_tick_ms = 1e3 * (time.perf_counter() - t0) / ticks
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    ka = prof.key_averages()
    # kernel rows only: an op's row repeats the time of the kernels it launched
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in ka
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in dev)
    report = {
        "ticks": ticks, "tick_ms_unprofiled": plain_tick_ms,
        "tick_ms_profiled": wall_ms / ticks,
        "device_ms_per_tick": dev_ms / ticks,
        "device_busy_share_unprofiled": dev_ms / ticks / plain_tick_ms,
        "device_launches_per_tick": sum(r[2] for r in dev) / ticks,
        "top_device_ms_per_tick": [
            {"name": k[:70], "ms": t / ticks, "calls": c / ticks}
            for k, t, c in dev[:12]],
    }
    log(f"[profile] {json.dumps(report)}")
    return report


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------

def time_ring(calls, passes=7):
    """Device time and host-issued time of one call, in ms.

    The ring of calls is captured once into a CUDA graph and the graph is
    replayed between two CUDA events: the launches then run back to back on
    the device, so the quotient is the calls' device time and not the time
    Python takes to issue them.  The second number is the same ring issued
    eagerly from Python, which is what a caller that launches one by one
    waits for.  Both are medians over ``passes``."""
    import torch

    def timed(run):
        times = []
        for _ in range(passes):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / len(calls))
        return statistics.median(times)

    def eager():
        for c in calls:
            c()

    eager()                              # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    return timed(graph.replay), timed(eager)


def ring_size(nbytes, target=4 * L2_BYTES, lo=4, hi=128):
    return int(min(hi, max(lo, -(-target // nbytes))))


def time_shape(label, o, k, n, m, gen, *, rows_sweep=()):
    """Times of K1 and K3 at one shape, Bx = 4, bfloat16 activations."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, unpack
    from repro_torch.kernels.demm_q8 import demm_xwT_q8, demm_xwT_q8_plain
    from repro_torch.kernels.demm_xwT import demm_xwT, demm_xwT_plain

    bx, cfg, g = 4, SparsityConfig(n, m), k // m
    x = torch.randn((bx, k), generator=gen, device=gen.device).to(torch.bfloat16)
    vals, idx = make_packed(o, k, n, m, gen)
    q, scales = make_q8(o, g, n, False, gen)
    nnz = int((vals != 0).sum())
    y_bytes = bx * o * 4
    out = {}
    for name in ("demm_xwT", "demm_xwT_q8"):
        if name == "demm_xwT":
            w_bytes = vals.nbytes + idx.nbytes
            copies = ring_size(w_bytes)
            vr = list(vals.repeat(copies, 1, 1, 1).unbind(0))
            ir = list(idx.repeat(copies, 1, 1, 1).unbind(0))
            kern = [lambda v=v, i=i, **kw: demm_xwT(x, v, i, cfg, **kw)
                    for v, i in zip(vr, ir)]
            plain = [lambda v=v, i=i: demm_xwT_plain(x, v, i, cfg)
                     for v, i in list(zip(vr, ir))[:8]]
        else:
            w_bytes = q.nbytes + idx.nbytes + scales.nbytes
            copies = ring_size(w_bytes)
            vr = list(q.repeat(copies, 1, 1, 1).unbind(0))
            ir = list(idx.repeat(copies, 1, 1, 1).unbind(0))
            sr = list(scales.repeat(copies, 1).unbind(0))
            kern = [lambda v=v, i=i, sc=sc, **kw:
                    demm_xwT_q8(x, v, i, sc, cfg, **kw)
                    for v, i, sc in zip(vr, ir, sr)]
            plain = [lambda v=v, i=i, sc=sc:
                     demm_xwT_q8_plain(x, v, i, sc, cfg)
                     for v, i, sc in list(zip(vr, ir, sr))[:8]]
        nbytes = x.nbytes + w_bytes + y_bytes
        ops = 2 * bx * nnz
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / PEAK_OPS_PER_S["bfloat16"]
        ms, eager_ms = time_ring(kern)
        entry = {
            "shape": label, "O": o, "K": k, "pattern": f"{n}:{m}", "Bx": bx,
            "x_dtype": "bfloat16", "ring_copies": copies, "bytes": nbytes,
            "ms": ms, "eager_ms": eager_ms,
            "plain_ms": time_ring(plain, passes=3)[0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_GBps": nbytes / ms / 1e6,
        }
        if rows_sweep:
            entry["rows_per_block_ms"] = {
                str(r): time_ring([lambda c=c, r=r: c(rows_per_block=r)
                                   for c in kern], passes=5)[0]
                for r in rows_sweep}
        out[name] = entry
        del vr, ir, kern, plain
    # yardstick: one dense matmul against the unpacked weight, x's dtype
    w = unpack(vals, idx, cfg, (o, k)).to(torch.bfloat16)
    copies = ring_size(w.nbytes, lo=4, hi=32)
    wr = [wt.T for wt in w.repeat(copies, 1, 1).unbind(0)]
    lib = time_ring([lambda wt=wt: torch.matmul(x, wt) for wt in wr])[0]
    for e in out.values():
        e["library_ms"] = lib
    del wr
    torch.cuda.empty_cache()
    return out


def layer_entry(name, source, replaces, per_shape, launches, max_abs_err):
    """One line of the ``kernels`` report: the seven launches of one decoder
    layer (4 + 2 + 1 over the three shapes) summed, per-shape rows beside."""
    def total(key):
        return sum(LAYER_MIX[e["shape"]] * e[key] for e in per_shape)
    bound_by = {e["bound_by"] for e in per_shape}
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err,
        "work": "the 7 packed projections of one stablelm_3b decoder layer "
                "(4 x 2560x2560 5:80, 2 x 6912x2560 5:80, 1 x 2560x6912 "
                "3:48), Bx=4, bfloat16 activations, weights read from "
                "device memory",
        "ms": total("ms"), "eager_ms": total("eager_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
        "library_ms": total("library_ms"),
        "shapes": per_shape,
    }


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time rows_per_block in {8, 16, 24, 32, 48, 64} "
                         "for every kernel and shape")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a steady window of decode ticks of "
                         "the packed model with torch.profiler")
    ap.add_argument("--stop-after", type=int, default=None, metavar="PHASE",
                    help="development aid: stop after this phase (3: build "
                         "and check the kernels only); prints no result line")
    args = ap.parse_args(argv)
    t_start = time.time()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 2

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.families import build_model

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind} x{torch.cuda.device_count()}; nvidia-smi "
        f"name, power.limit: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # 2. build
    t0 = time.time()
    _build.load_library()
    built = _build.build_seconds
    log(f"[2 build] kernel library ready in {time.time() - t0:.1f} s "
        + (f"(nvcc: {built:.1f} s)" if built is not None else "(reused)"))

    # 3. kernels vs plain versions
    t0 = time.time()
    errs, n_cases = check_kernels(gen)
    log(f"[3 kernels] {n_cases} comparisons against the plain versions held "
        f"(f32 {TOL['float32']}, bf16 {TOL['bfloat16']}); max abs err at the "
        f"main-path shapes: {errs}; {time.time() - t0:.1f} s")

    if args.stop_after is not None and args.stop_after <= 3:
        log(f"stopped after phase 3 as asked ({time.time() - t_start:.1f} s)")
        return 0

    # 4./5. serve at full width
    cfg = get_arch("stablelm_3b")
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[4 serve] built {cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}) in "
        f"{time.time() - t0:.1f} s; "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak")
    serve_f = serve_full_width(model, cfg, quantize=None, expect="demm_xwT")
    log(f"[4 serve] packed, backend cuda: {json.dumps(serve_f)}")
    if args.profile:
        profile_ticks(model, cfg)
    serve_q = serve_full_width(model, cfg, quantize="int8",
                               expect="demm_xwT_q8")
    log(f"[5 serve q8] packed+int8, backend cuda: {json.dumps(serve_q)}")
    del model
    torch.cuda.empty_cache()

    # 6. backends agree end to end
    agree = check_backends_agree(get_arch("stablelm_3b"))
    log(f"[6 agree] cuda vs reference, 2 layers float32: {json.dumps(agree)}")

    # 7. times
    sweep = (8, 16, 24, 32, 48, 64) if args.sweep else ()
    per_kernel = {"demm_xwT": [], "demm_xwT_q8": []}
    for shape in MAIN_SHAPES:
        timed = time_shape(*shape, gen, rows_sweep=sweep)
        for name, entry in timed.items():
            per_kernel[name].append(entry)
            log(f"[7 times] {name} {json.dumps(entry)}")
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        layer_entry("demm_xwT", csrc + "demm_xwt.cu",
                    "src/repro/kernels/demm_spmm.py:180",
                    per_kernel["demm_xwT"], serve_f["launches"],
                    errs["demm_xwT"]),
        layer_entry("demm_xwT_q8", csrc + "demm_xwt_q8.cu",
                    "src/repro/kernels/demm_q8.py:79",
                    per_kernel["demm_xwT_q8"], serve_q["launches"],
                    errs["demm_xwT_q8"]),
    ]
    log(f"[done] {time.time() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels, "serve": [serve_f, serve_q],
                    "agree": agree}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
