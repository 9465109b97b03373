#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below, a few minutes
    python3 chip_smoke.py --sweep    # also time the kernels' tunables
    python3 chip_smoke.py --compare-with DIR   # K1-K5 here against DIR's

Needs a CUDA device and ``nvcc``; imports only ``repro_torch`` (from ``src/``
beside this file).  Each phase raises on failure, so the exit code is non-zero
unless all of them held:

1. device   — require CUDA; print the card's name and power limit.
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, all started together) and load the
              library.
3. kernels  — all five kernels against their plain PyTorch versions on the
              card, x / B in float32 and bfloat16, Bx (or Cd) in {1, 4, 37,
              256}:
              * ``demm_xwT`` and ``demm_xwT_q8`` (per-row and per-group
                scales) at the three projection shapes of full-width
                stablelm_3b and the reduced 2:16 shape, as the main path
                launches them (``duplicates=False``), plus duplicate indices
                with non-quarter-integer values (the summing instantiation),
                an all-padded row, a contraction dim that needs several
                shared-memory chunks, non-default tiles and bfloat16 packed
                values;
              * ``demm_block_spmm``, ``demm_block_spmm_q8`` (serving
                orientation, B = xᵀ) at the same shapes with the block
                geometry of ``pack_block``, plus weights with inactive
                (row-block, group) tiles (a_max < G) and an all-zero row
                block, ``a_max > G`` padding, duplicate indices with
                non-quarter-integer values, and B stored (K, Cd);
              * ``demm_spmm`` (paper orientation, B (K, Cd)) at the same
                shapes, plus duplicate indices;
              * the redesigned bodies, each asserted to be the one taken:
                K5's tiled tensor-core body (bf16 B, Cd in {64, 200, 256,
                1024}, R = 100, M in {8, 16, 40, 48, 80}, duplicates, every
                tile, stage count and groups per stage) while a float32 B
                and a transposed B take the gather body, and K5 at narrow B
                never takes K2's cluster body; K2's and K4's cluster body at
                Bx in {1, 4, 8} with inactive tiles, an all-zero row block,
                a_max > G, duplicates and every cluster size; K1's and K3's
                bulk row-tile body at Bx <= 8 (K3 with per-row and per-group
                scales; chunk counts, one-row and ragged tiles, a ring of
                row chunks larger than shared memory, duplicates) while Bx >
                8 and an x tile larger than shared memory take the gather
                body.
              Tolerances: float32 rtol/atol 1e-4 (summation order), bfloat16
              rtol/atol 2e-2.
4. serve    — full-width stablelm_3b, random weights from a seed, packed,
              backend ``cuda``: 4 requests x 8 new tokens on 4 slots through
              ``run_serve``, whose engine captures its decode step once as a
              CUDA graph and replays it every tick; every request completes
              inside the true vocab; the wrappers launched the float kernel
              exactly 7 x 32 x (warm-up steps + 1 capture) times, no other
              kernel, every launch on its serving body (K1 bulk, K2
              cluster); a ``torch.profiler`` window of 3 replays then shows
              7 x 32 x 3 launches of that kernel on the device, by its
              kernel name and on its serving body, and no other DeMM kernel,
              while no wrapper is called.
   4g graph — on the same packed model: the captured step's tokens equal
              the eager step's and its logits are bit-equal on every tick.
5. serve q8 — the same with int8 values (per-row scales) and the int8 kernel
              (K3 every launch on its bulk body); 5g the same graph check.
   4b/5b    — the same two with ``--layout block`` on a fresh model of the
              same seed: float through ``demm_block_spmm``, int8 through
              ``demm_block_spmm_q8`` (both on the cluster body).
   5c spmm  — ``ops.demm_spmm`` (the paper orientation's entry point),
              backend ``cuda``, on the seven projection shapes of one layer
              with B of 4 and of 256 columns: exactly 14 launches of
              ``demm_spmm`` and results equal to backend ``reference``.
6. agree    — full width, 2 layers, float32 compute, per layout: backend
              ``cuda`` and backend ``reference`` give allclose logits on every
              tick (rtol 1e-3) and identical greedy token streams; the xwT and
              block layouts give the same greedy tokens through their kernels.
   6g graph — the same 2-layer float32 model in the four serving modes
              (both layouts, float and int8): the captured step's tokens
              equal the eager step's and backend ``reference``'s; its logits
              are bit-equal to the eager step's and allclose (rtol 1e-3) to
              the reference's.
   6f flight — ``repro_torch.launch.serve`` as a user runs it, full width,
              ``--profile-dir --flight-dir --force-stall --slo-report``:
              exactly one stall dump, and the profiler's trace holds the
              kernels of the warm-up step and of every graph replay by name
              (7 x 32 x (1 + ticks) of K1 on its bulk body).
   6p paged — ``repro_torch.launch.serve --full --packed --paged`` replaying
              the committed tiny trace with priorities on 16 pages of 8
              tokens: all 12 requests complete, at least one preemption.
8. paged    — in each of the four modes, on phase 4/5's packed model: the
              paged engine (``make_engine(model, PagedServeConfig(...))``;
              4 slots, pages of 16, max_len 512, chunks of 32) serves 8
              prompts of 40-400 tokens (each ending on a partial chunk), 16
              new tokens each.  Counted from reset to drain: one capture of
              the prefill chunk and one of the decode step; the wrappers
              launch the mode's kernel 7 x 32 x 2 times for each program
              (warm-up + capture; the chunk's x of 32 rows on the gather
              body, the step's on its serving body), nothing else; chunks
              dispatched = sum of ceil(len / 32).  A second pass on the
              same engine gives TTFT per request and prompt tokens/s;
              profiled windows show 224 gather-body launches of the kernel
              per chunk replay and 224 serving-body launches per decode
              replay on the device, with device time, busy share and the
              kernels that take it; the page gather is timed alone; the
              dense engine ingests the same prompts token by token for
              comparison; and both captured programs give the eager
              programs' logits bit for bit (4 of the prompts).
   8g       — 2 layers, float32, the four modes: paged tokens equal the
              dense engine's and backend ``reference``'s (logits allclose,
              rtol 1e-3), and a 13-page arena preempts and keeps the tokens.
7. times    — per kernel and shape at Bx = 4 with bfloat16 activations (what
              the main path launches; K5 at Cd = 4 and 256): CUDA-event
              medians of the kernel over a ring of weight copies larger than
              L2 (so every launch reads its weights from device memory, as a
              decode step does), replayed from a CUDA graph so that device
              time is measured and not the time Python takes to issue a launch
              (that is ``eager_ms``); the byte / operation bound, the plain
              version, and ``torch.matmul`` against the dense weight in the
              same dtype as a yardstick the port never calls; K3 with
              per-row and with per-group scales.  K5's tiled
              body does the dense count of operations at Cd = 256; the floor
              that sets (2 R K Cd at the bf16 peak, computed, not measured)
              is printed on a line of its own, outside the ``kernels`` line,
              as is the launch floor: an empty kernel at K1's and K3's bulk
              grids and an empty cluster launch at K2's, timed the same way.
   7p       — K1-K4 at x of 32 rows, as a prefill chunk launches them, each
              asserted to run its gather body: the same timing rows
              (``prefill_bx32`` of each kernel in the ``kernels`` line).

The last three lines are: the card as ``nvidia-smi`` names it, one JSON object
``{"kernels": [...], "serve": [...], "agree": {...}, "graph": {...},
"flight": {...}, "paged": [...], "paged_gates": {...}, "paged_cli": {...}}``
(per kernel: wrapper launches on the dense and the paged path, error, times,
bound, its gather body at Bx = 32; per serve run: ticks, decode-step time,
tokens/s, device launches per replay), and one JSON object ``{"ok": true,
"device": ...}``.

``--profile`` also profiles a steady window of decode ticks of the four
serving modes, the captured step and the eager step in turns (graph, eager,
eager, graph), and prints a table: host-clock tick, device time per tick,
device busy share, device launches per tick, tokens/s.
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
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50e6
DEVICE = "cuda"

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

KERNELS = ("demm_xwT", "demm_xwT_q8", "demm_block_spmm", "demm_block_spmm_q8",
           "demm_spmm")


def kernel_fns():
    """name -> (kernel wrapper, plain version)."""
    from repro_torch.kernels import demm_block_spmm as kb
    from repro_torch.kernels import demm_q8 as kq
    from repro_torch.kernels import demm_spmm as ks
    from repro_torch.kernels import demm_xwT as kx
    return {
        "demm_xwT": (kx.demm_xwT, kx.demm_xwT_plain),
        "demm_xwT_q8": (kq.demm_xwT_q8, kq.demm_xwT_q8_plain),
        "demm_block_spmm": (kb.demm_block_spmm, kb.demm_block_spmm_plain),
        "demm_block_spmm_q8": (kq.demm_block_spmm_q8,
                               kq.demm_block_spmm_q8_plain),
        "demm_spmm": (ks.demm_spmm, ks.demm_spmm_plain),
    }


def make_packed(o, k, n, m, gen, *, duplicates=False):
    """Random packed weight on the card: distinct sorted indices per group
    (or, with ``duplicates``, every slot of a group on one column, values
    standard normal — their sums are not exact in bfloat16 — row 0 all
    padded)."""
    import torch
    g = k // m
    dev = gen.device
    if duplicates:
        idx = torch.randint(0, m, (o, g, 1), generator=gen, device=dev)
        idx = idx.expand(o, g, n).contiguous()
        vals = torch.randn((o, g, n), generator=gen, device=dev)
        vals[0] = 0
        idx[0] = 0
    else:
        scores = torch.rand((o, g, m), generator=gen, device=dev)
        idx = scores.topk(n, dim=-1).indices.sort(dim=-1).values
        vals = torch.randn((o, g, n), generator=gen, device=dev)
    return vals.to(torch.float32).contiguous(), idx.to(torch.int32).contiguous()


def make_dense(o, k, n, m, gen):
    """A random dense (O, K) weight on the card that satisfies n:m."""
    from repro_torch.core.sparsity import SparsityConfig, unpack
    vals, idx = make_packed(o, k, n, m, gen)
    return unpack(vals, idx, SparsityConfig(n, m), (o, k))


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
    from repro_torch.core.sparsity import SparsityConfig, pack_block
    from repro_torch.kernels.demm_block_spmm import block_body
    from repro_torch.kernels.demm_q8 import block_q8_body, demm_xwT_q8_on
    from repro_torch.kernels.demm_spmm import spmm_body
    from repro_torch.kernels.demm_xwT import demm_xwT_on, xwt_body
    from repro_torch.quant import quantize_packed

    fns = kernel_fns()
    err = {name: 0.0 for name in KERNELS}
    bodies = {name: set() for name in KERNELS}
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

    def run_xwt(label, o, k, n, m, batches, *, duplicates=False, main=False,
                rows_per_block=None, values_dtype=torch.float32, expect=None,
                tunables=(), lanes=()):
        """K1 and K3 (per-row and per-group scales) on one random packed
        weight.  Each must take the body ``expect`` names (None: ``bulk`` at
        Bx <= 8 where x's tile takes at most half a block's shared memory and
        K3's int8 rows and per-group scale rows are 16-byte multiples,
        ``gather`` at Bx > 8, either between); ``tunables``: keyword
        arguments of the bulk body (rows per CTA, chunks), each through the
        measurement hooks; ``lanes``: K3's slot lanes per row, each forced
        at the default tile (the tunables' tiles reach the launcher's own
        choice of 8 or 16)."""
        cfg = SparsityConfig(n, m)
        g = k // m
        kern, plain = fns["demm_xwT"]
        kern_q, plain_q = fns["demm_xwT_q8"]
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
                body = xwt_body(x, vals, idx, m, duplicates=duplicates)
                tile = 8 if duplicates else 1 << (bx - 1).bit_length()
                want_body = expect or (
                    "gather" if bx > 8 else "bulk" if tile * k
                    * x.element_size() <= BULK_SMEM_BYTES // 2 else body)
                if body != want_body:
                    raise AssertionError(f"{what}: K1 would take its {body} "
                                         "body")
                bodies["demm_xwT"].add(body)
                want = plain(x, vals, idx, cfg)
                # the main path says duplicates=False; duplicates take the
                # instantiation that sums them
                compare("demm_xwT",
                        kern(x, vals, idx, cfg, duplicates=duplicates,
                             rows_per_block=rows_per_block),
                        want, dtype, f"{what} {body}", main)
                for tun in tunables if body == "bulk" else ():
                    compare("demm_xwT",
                            demm_xwT_on("bulk", x, vals, idx, cfg,
                                        duplicates=duplicates, **tun),
                            want, dtype, f"{what} bulk {tun}", main)
                for per_group in (False, True):
                    q, scales = make_q8(o, g, n, per_group, gen)
                    if duplicates:
                        q[0] = 0
                    what_q = what + (" per_group" if per_group else " per_row")
                    body = xwt_body(x, q, idx, m, duplicates=duplicates,
                                    scales=scales)
                    spans = (g * n) % 16 == 0 and (g % 4 == 0 or not per_group)
                    want_body = expect or (
                        "gather" if bx > 8 else "bulk" if spans and tile * k
                        * x.element_size() <= BULK_SMEM_BYTES // 2 else body)
                    if body != want_body:
                        raise AssertionError(f"{what_q}: K3 would take its "
                                             f"{body} body")
                    bodies["demm_xwT_q8"].add(body)
                    want = plain_q(x, q, idx, scales, cfg)
                    compare("demm_xwT_q8",
                            kern_q(x, q, idx, scales, cfg,
                                   duplicates=duplicates,
                                   rows_per_block=rows_per_block),
                            want, dtype, f"{what_q} {body}", main)
                    q8_tunables = [*tunables,
                                   *(dict(lanes=ln) for ln in lanes)]
                    for tun in q8_tunables if body == "bulk" else ():
                        compare("demm_xwT_q8",
                                demm_xwT_q8_on("bulk", x, q, idx, scales, cfg,
                                               duplicates=duplicates, **tun),
                                want, dtype, f"{what_q} bulk {tun}", main)

    def run_block(what, pw, batches, main=False, paper_b=False,
                  cluster_sizes=(None,), dtypes=("float32", "bfloat16")):
        """K2 and K4 on one block packing, B = xᵀ (or B (K, Cd)); both take
        the cluster body in the serving orientation at Bx <= 8."""
        o, k = pw.dense_shape
        kern, plain = fns["demm_block_spmm"]
        kern_q, plain_q = fns["demm_block_spmm_q8"]
        qw = quantize_packed(pw)
        for bx in batches:
            for dtype in dtypes:
                x = torch.randn((bx, k), generator=gen, device=gen.device)
                b = (x.T.contiguous() if paper_b else x.T).to(
                    getattr(torch, dtype))
                tag = (f"{what} O={o} K={k} {pw.cfg.pattern_name()} "
                       f"block_geom={pw.block_geom} Cd={bx} B={dtype}")
                serving = "cluster" if bx <= 8 and not paper_b else "gather"
                body = block_q8_body(qw.values, qw.indices, qw.scales, b,
                                     pw.cfg.m)
                body2 = block_body(pw.active_groups, pw.values, pw.indices,
                                   b, pw.cfg.m)
                if (body, body2) != (serving, serving):
                    raise AssertionError(f"{tag}: K4 / K2 would take their "
                                         f"{body} / {body2} bodies")
                bodies["demm_block_spmm_q8"].add(body)
                bodies["demm_block_spmm"].add(body2)
                want = plain(pw.active_groups, pw.values, pw.indices, b,
                             pw.cfg, r=o)
                for cs in cluster_sizes:
                    compare("demm_block_spmm",
                            kern(pw.active_groups, pw.values, pw.indices, b,
                                 pw.cfg, r=o, duplicates=pw.has_duplicates,
                                 cluster_size=cs), want, dtype,
                            f"{tag} {body2}"
                            + (f" cluster_size={cs}" if cs else ""), main)
                want = plain_q(qw.active_groups, qw.values, qw.indices,
                               qw.scales, b, qw.cfg, r=o)
                for cs in cluster_sizes:
                    compare("demm_block_spmm_q8",
                            kern_q(qw.active_groups, qw.values, qw.indices,
                                   qw.scales, b, qw.cfg, r=o,
                                   duplicates=qw.has_duplicates,
                                   cluster_size=cs), want, dtype,
                            f"{tag} {body}"
                            + (f" cluster_size={cs}" if cs else ""), main)

    def run_spmm(label, o, k, n, m, batches, *, duplicates=False, main=False,
                 dtypes=("float32", "bfloat16"), transposed=False,
                 expect=None, tunables=(None,)):
        """K5 with B (K, Cd) (or the transpose of a (Cd, K) tensor); with
        ``expect`` ("tiled" or "gather") the body a bfloat16 B must take (a
        float32 B always takes the gather body).  ``tunables``: (tile,
        groups per stage, stages) of the tiled body, each through the
        measurement hook; None: the wrapper's defaults."""
        from repro_torch.kernels.demm_spmm import demm_spmm_on
        cfg = SparsityConfig(n, m)
        kern, plain = fns["demm_spmm"]
        vals, idx = make_packed(o, k, n, m, gen, duplicates=duplicates)
        for cd in batches:
            for dtype in dtypes:
                shape = (cd, k) if transposed else (k, cd)
                b = torch.randn(shape, generator=gen, device=gen.device)
                b = b.to(getattr(torch, dtype))
                b = b.T if transposed else b
                body = spmm_body(vals, idx, b, m)
                if expect is not None and body != (
                        expect if dtype == "bfloat16" else "gather"):
                    raise AssertionError(f"{label} Cd={cd} B={dtype}: K5 "
                                         f"would take its {body} body")
                # K5's gather body is K2's launcher with the identity
                # address stream: never the cluster body
                if block_body(None, vals, idx, b, m) != "gather":
                    raise AssertionError(f"{label} Cd={cd}: K5 would take "
                                         "K2's cluster body")
                bodies["demm_spmm"].add(body)
                want = plain(vals, idx, b, cfg)
                for tun in tunables:
                    if tun is None:
                        got = kern(vals, idx, b, cfg, duplicates=duplicates)
                    else:
                        tile, ng, st = tun
                        got = demm_spmm_on(None, vals, idx, b, cfg,
                                           duplicates=duplicates, tile=tile,
                                           groups_per_stage=ng, stages=st)
                    compare("demm_spmm", got, want, dtype,
                            f"{label} R={o} K={k} {n}:{m} Cd={cd} B={dtype} "
                            f"{body}" + (" duplicates" if duplicates else "")
                            + (f" tile={tile} groups_per_stage={ng} "
                               f"stages={st}" if tun else ""),
                            main)

    for shape in MAIN_SHAPES + [REDUCED_SHAPE]:
        run_xwt(*shape, BATCHES, main=True)
    # K = 128 projections of the reduced config come out as 1:8
    run_xwt("reduced 1:8", 384, 128, 1, 8, (4, 37))
    # duplicate indices and an all-padded row
    run_xwt(*REDUCED_SHAPE, (4, 37), duplicates=True)
    run_xwt(*MAIN_SHAPES[2], (1, 4, 8), duplicates=True,
            tunables=[dict(chunks=4), dict(rows_per_block=7)],
            lanes=BULK_LANES)
    # x tile larger than a block's shared memory: the gather body's group
    # loop runs in chunks (and the bulk body does not take it)
    run_xwt("chunked", 520, 16384, 8, 128, (8, 13), expect="gather")
    # non-default tiles, ragged against O
    run_xwt("tiles", 1000, 2560, 5, 80, (4,), rows_per_block=8)
    run_xwt("tiles", 1000, 2560, 5, 80, (3,), rows_per_block=72)
    # the bulk body's tunables at the three main shapes: rows per CTA (one
    # row; ragged; more than fit at once: a ring), chunks
    for label, o, k, n, m in MAIN_SHAPES:
        run_xwt(label + " bulk tunables", o, k, n, m, (1, 4, 8),
                tunables=[dict(chunks=c) for c in BULK_CHUNKS]
                + [dict(rows_per_block=r) for r in (1, 7, 160)]
                + [dict(rows_per_block=40, chunks=3)], lanes=BULK_LANES)
    # a tile far larger than shared memory: the ring of row chunks
    run_xwt("bulk ring", 3000, 6912, 3, 48, (4,),
            tunables=[dict(rows_per_block=3000), dict(rows_per_block=1000,
                                                      chunks=16)],
            lanes=BULK_LANES)
    # packed values already in bfloat16
    run_xwt("bf16 values", 300, 2560, 5, 80, (4,), values_dtype=torch.bfloat16)
    # 8:16-style override pattern (dense-ish groups), tiny M
    run_xwt("8:16", 384, 256, 8, 16, (2, 5))
    run_xwt("1:1", 64, 32, 1, 1, (2,))

    # the block layout: the main-path shapes as pack_block packs them, then
    # inactive tiles with an all-zero row block, a_max > G and duplicates
    for label, o, k, n, m in MAIN_SHAPES + [REDUCED_SHAPE]:
        cfg = SparsityConfig(n, m)
        g = k // m
        dense = make_dense(o, k, n, m, gen)
        pw = pack_block(dense, cfg)
        run_block(label, pw, BATCHES, main=True)
        br = pw.block_geom[0]
        keep = torch.rand((o // br, 1, g, 1), generator=gen,
                          device=gen.device) > 0.3
        keep[:, :, 1] = False            # at least one inactive group
        sparse = (dense.reshape(o // br, br, g, m) * keep).reshape(o, k)
        sparse[br:2 * br] = 0
        inactive = pack_block(sparse, cfg)
        if inactive.block_geom[1] >= g:
            raise AssertionError(f"{label}: no inactive group left")
        run_block(label + " inactive tiles + all-zero row block", inactive,
                  (1, 4, 8, 37))
        run_block(label + " a_max > G", pack_block(dense, cfg, a_max=g + 3),
                  (1, 4, 8))
        run_block(label + " B (K, Cd)", pw, (37,), paper_b=True)
        dv = torch.randn(pw.values.shape, generator=gen, device=gen.device)
        di = pw.indices[..., :1].expand(pw.indices.shape).contiguous()
        dv[0, :, 0] = 0
        dup = pw.replace(values=dv, indices=di)
        if not dup.has_duplicates:
            raise AssertionError("duplicate case holds no duplicates")
        run_block(label + " duplicates", dup, (1, 4, 8))
        if label != REDUCED_SHAPE[0]:
            # every cluster size, one stage ring (size 1 at 2560 x 6912),
            # both K2 and K4
            run_block(label + " cluster sizes", pw, (1, 4, 8),
                      cluster_sizes=CLUSTER_SIZES)
        run_spmm(label, o, k, n, m, BATCHES, main=True)
        run_spmm(label, o, k, n, m, (4,), duplicates=True)

    # K5's tiled body: ragged R, M of 16, 48, 80 and two that are not
    # multiples of 16 (zero rows written by the kernel), duplicates summed as
    # they are placed, every tile and stage count; a float32 B and a
    # transposed B take the gather body
    for n, m, g in ((2, 16, 10), (3, 48, 8), (5, 80, 8), (2, 40, 6),
                    (1, 8, 12)):
        run_spmm(f"tiled {n}:{m}", 100, g * m, n, m, (64, 200, 256, 1024),
                 dtypes=("bfloat16",), expect="tiled")
    run_spmm("tiled duplicates", 100, 640, 5, 80, (200,), duplicates=True,
             dtypes=("bfloat16",), expect="tiled")
    # every tile, groups per stage and stage count (8 groups: 3 or 5 per
    # stage leave a last stage of fewer groups), each (tile, groups per
    # stage, stages) one that fits a block's shared memory
    run_spmm("tiled tunables", 300, 640, 5, 80, (320,), dtypes=("bfloat16",),
             expect="tiled", tunables=(
                 ((128, 1), 1, 4), ((128, 1), 2, 3), ((128, 1), 3, 2),
                 ((128, 2), 1, 4), ((128, 2), 2, 2), ((256, 1), 1, 4),
                 ((256, 1), 1, 3), ((256, 2), 1, 3)))
    run_spmm("tiled tunables", 300, 384, 3, 48, (320,), dtypes=("bfloat16",),
             expect="tiled", tunables=(
                 ((128, 1), 4, 2), ((128, 1), 5, 2), ((256, 1), 2, 2),
                 ((256, 2), 2, 2)))
    run_spmm("gather float32 B", 100, 640, 5, 80, (256,),
             dtypes=("float32",), expect="gather")
    run_spmm("gather transposed B", 100, 640, 5, 80, (256,),
             dtypes=("bfloat16",), transposed=True, expect="gather")
    # rows of pairs not 16-byte aligned (G x Ne = 30): the gather body
    run_spmm("gather unaligned pair rows", 100, 480, 5, 80, (256,),
             dtypes=("bfloat16",), expect="gather")
    for name, want in (("demm_xwT", {"bulk", "gather"}),
                       ("demm_xwT_q8", {"bulk", "gather"}),
                       ("demm_block_spmm", {"cluster", "gather"}),
                       ("demm_spmm", {"tiled", "gather"}),
                       ("demm_block_spmm_q8", {"cluster", "gather"})):
        if bodies[name] != want:
            raise AssertionError(f"{name} ran the bodies {bodies[name]}, "
                                 f"expected {want}")
    return err, n_cases


# ---------------------------------------------------------------------------
# phases 4-6: serving
# ---------------------------------------------------------------------------

def reset_counts():
    for kern, _ in kernel_fns().values():
        kern.launches = 0
        for body in getattr(kern, "body_launches", {}):
            kern.body_launches[body] = 0


def read_counts():
    return {name: kern.launches for name, (kern, _) in kernel_fns().items()}


def read_body_counts():
    """Launches by body of the kernels that count them (K1, K2, K3)."""
    return {name: dict(kern.body_launches)
            for name, (kern, _) in kernel_fns().items()
            if hasattr(kern, "body_launches")}


# the body each serving kernel must run at Bx = 4 (K4's body is told apart
# on the device only, by its kernel name; K5 does not serve)
SERVING_BODY = {"demm_xwT": "bulk", "demm_xwT_q8": "bulk",
                "demm_block_spmm": "cluster", "demm_block_spmm_q8": "cluster"}


def device_kernel_of(name: str):
    """(kernel, body) of a DeMM kernel as the profiler names it on the card
    (the CUDA function's name and its weight policy), else None."""
    head = name.split("(")[0]
    q8 = "Int8" in head
    if "xwt_bulk_kernel" in head:
        return ("demm_xwT_q8" if q8 else "demm_xwT"), "bulk"
    if "xwt_kernel" in head:
        return ("demm_xwT_q8" if q8 else "demm_xwT"), "gather"
    if "block_cluster_kernel" in head:
        return ("demm_block_spmm_q8" if q8 else "demm_block_spmm"), "cluster"
    if "block_spmm_kernel" in head:
        return ("demm_block_spmm_q8" if q8 else "demm_block_spmm"), "gather"
    if "spmm_tc_kernel" in head:
        return "demm_spmm", "tiled"
    return None


def device_kernel_counts(prof) -> dict:
    """Launches of each (kernel, body) in a torch.profiler window."""
    import torch
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kb = device_kernel_of(e.key)
        if kb is not None:
            counts[kb] = counts.get(kb, 0) + e.count
    return counts


def profiled_replays(engine, cfg, expect, ticks=3):
    """A ``torch.profiler`` window of ``ticks`` graph replays on a drained
    engine given 4 new requests: each replay must launch the expected kernel
    7 x layers times on its serving body on the device, and no other DeMM
    kernel, while no wrapper is called (the Python counters stay put)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request

    rng = np.random.default_rng(7)
    for i in range(4):
        engine.submit(Request(uid=100 + i, max_new_tokens=50,
                              prompt=rng.integers(0, cfg.vocab_size, 3,
                                                  dtype=np.int32)))
    engine.step()                        # claims the slots; a replay
    torch.cuda.synchronize()
    before = read_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"graph replays called a kernel wrapper: "
                             f"{before} -> {read_counts()}")
    got = device_kernel_counts(prof)
    want = {(expect, SERVING_BODY[expect]): 7 * cfg.num_layers * ticks}
    if got != want:
        raise AssertionError(
            f"{ticks} profiled replays launched {got} on the device: expected "
            f"{want} (7 x {cfg.num_layers} per replay, nothing else)")
    return got[(expect, SERVING_BODY[expect])] // ticks


def serve_full_width(model, cfg, *, layout, quantize, expect):
    """Drive run_serve once; check the outputs, that the wrappers launched
    the expected kernel 7 x layers times in each of the warm-up step(s) and
    the capture of the decode step (K1, K2, K3 on their serving bodies) and
    nothing else, and that each replay of the captured step ran it on the
    device 7 x layers times on its serving body (a profiled window)."""
    import torch
    from repro_torch import obs
    from repro_torch.launch.serve import run_serve
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    requests, max_new = 4, 8
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    engine = run_serve(model, cfg.vocab_size, packed=True, layout=layout,
                       quantize=quantize, backend="cuda", requests=requests,
                       slots=4, max_new=max_new, max_len=64, seed=0,
                       device=DEVICE, metrics=obs.MetricsRegistry())
    counts = read_counts()               # ... and just after
    body_counts = read_body_counts()
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
    if engine._graph is None:
        raise AssertionError("the CUDA engine did not capture its step")
    want = {name: 0 for name in KERNELS}
    want[expect] = 7 * cfg.num_layers * (CAPTURE_WARMUP + 1)
    if counts != want:
        raise AssertionError(
            f"launch counts {counts} after {ticks} ticks: expected {want} "
            f"(7 x {cfg.num_layers} x ({CAPTURE_WARMUP} warm-up step(s) + "
            f"1 capture) of {expect}, nothing else)")
    body = SERVING_BODY[expect]
    if expect in body_counts and body_counts[expect][body] != want[expect]:
        raise AssertionError(f"{expect} launches by body "
                             f"{body_counts[expect]}: expected all "
                             f"{want[expect]} on its {body} body")
    tokens = sum(len(r.output) for r in engine.completed)
    entry = {
        "layout": layout, "quantize": quantize, "ticks": ticks,
        "tokens": tokens, "drain_s": engine.drain_seconds,
        "tick_ms_mean": 1e3 * engine.drain_seconds / ticks,
        "decode_step_ms_p50": 1e3 * engine._sk_tok.quantile(0.5),
        "tokens_per_s": tokens / engine.drain_seconds,
        "launches": counts[expect],
        "body": body,
        "first_output": engine.completed[0].output,
    }
    entry["device_launches_per_replay"] = profiled_replays(engine, cfg,
                                                           expect)
    return entry


def spmm_path(gen):
    """Phase 5c: the paper orientation's entry point, ``ops.demm_spmm``,
    backend ``cuda``, on the seven projection shapes of one layer with B of
    4 and of 256 columns; the launch count and backend ``reference``."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import ops

    problems = []
    for label, o, k, n, m in MAIN_SHAPES:
        for _ in range(LAYER_MIX[label]):
            vals, idx = make_packed(o, k, n, m, gen)
            for cd in (4, 256):
                b = torch.randn((k, cd), generator=gen, device=gen.device)
                problems.append((vals, idx, b.to(torch.bfloat16),
                                 SparsityConfig(n, m), (o, k)))
    torch.cuda.synchronize()
    reset_counts()                       # just before the path ...
    outs = [ops.demm_spmm(v, i, b, cfg, shape, backend="cuda",
                          duplicates=False)
            for v, i, b, cfg, shape in problems]
    torch.cuda.synchronize()
    counts = read_counts()               # ... and just after
    want = {name: 0 for name in KERNELS}
    want["demm_spmm"] = len(problems)
    if counts != want:
        raise AssertionError(f"ops.demm_spmm launch counts {counts}, "
                             f"expected {want}")
    worst = 0.0
    for out, (v, i, b, cfg, shape) in zip(outs, problems):
        ref = ops.demm_spmm(v, i, b, cfg, shape, backend="reference")
        torch.testing.assert_close(out, ref, **TOL["bfloat16"])
        worst = max(worst, float((out - ref).abs().max()))
    return {"calls": len(problems), "launches": counts["demm_spmm"],
            "max_abs_err_vs_reference": worst}


def serve_collect(model, cfg, backend, eager=False):
    """Greedy serve on 2 slots, keeping every tick's logits; ``eager`` runs
    the decode step eagerly instead of replaying its captured graph (the
    engine's measurement hook)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    engine = ServeEngine(model, ServeConfig(num_slots=2, max_len=48),
                         policy=ExecPolicy(mode="packed", backend=backend),
                         device=DEVICE, metrics=obs.MetricsRegistry(),
                         _eager=eager)
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
    report, tokens = {}, {}
    for layout in ("xwT", "block"):
        model = pack_tree(build_model(cfg, device=DEVICE, seed=1),
                          layout=layout)
        la, ta = serve_collect(model, cfg, "cuda")
        lb, tb = serve_collect(model, cfg, "reference")
        if len(la) != len(lb):
            raise AssertionError(f"{layout}: tick counts differ: {len(la)} vs "
                                 f"{len(lb)}")
        worst = 0.0
        for t, (a, b) in enumerate(zip(la, lb)):
            a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
            if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                raise AssertionError(
                    f"{layout} tick {t}: logits differ between backends, max "
                    f"abs {np.abs(a - b).max()}")
            worst = max(worst, float(np.abs(a - b).max()))
        if ta != tb:
            raise AssertionError(f"{layout}: token streams differ: {ta} vs "
                                 f"{tb}")
        report[layout] = {"ticks": len(la), "max_abs_logit_diff": worst,
                          "streams": len(ta)}
        tokens[layout] = ta
    if tokens["xwT"] != tokens["block"]:
        raise AssertionError(f"xwT and block layouts give different tokens: "
                             f"{tokens['xwT']} vs {tokens['block']}")
    report["xwT_tokens_equal_block_tokens"] = True
    return report


def graph_vs_eager(model, cfg, label):
    """Phase 4g/5g: the captured step against the eager step on the same
    model: the same tokens, and bit-equal logits on every tick.  Returns
    the report and the captured step's logits and tokens."""
    import numpy as np

    lg, tg = serve_collect(model, cfg, "cuda")
    le, te = serve_collect(model, cfg, "cuda", eager=True)
    if len(lg) != len(le) or tg != te:
        raise AssertionError(f"{label}: graph and eager steps give different "
                             f"tokens: {tg} vs {te}")
    for t, (a, b) in enumerate(zip(lg, le)):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{label} tick {t}: graph and eager logits differ, max abs "
                f"{np.abs(a - b).max()}")
    return {"mode": label, "ticks": len(lg), "streams": len(tg),
            "tokens_equal": True, "logits_bit_equal": True}, lg, tg


def check_graph_modes(cfg_full):
    """Phase 6g: full width, 2 layers, float32 compute, in the four serving
    modes: the captured step's tokens equal the eager step's and backend
    ``reference``'s (its logits bit-equal to the eager step's, allclose to
    the reference's at rtol 1e-3)."""
    import numpy as np
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model

    cfg = dataclasses.replace(cfg_full, num_layers=2, compute_dtype="float32")
    report = {}
    for layout in ("xwT", "block"):
        for quantize in (None, "int8"):
            label = f"{layout}" + (f"+{quantize}" if quantize else "")
            model = pack_tree(build_model(cfg, device=DEVICE, seed=1),
                              layout=layout, quantize=quantize)
            entry, lg, tg = graph_vs_eager(model, cfg, label)
            lr, tr = serve_collect(model, cfg, "reference")
            if tg != tr:
                raise AssertionError(f"{label}: graph cuda and reference "
                                     f"tokens differ: {tg} vs {tr}")
            worst = 0.0
            for t, (a, b) in enumerate(zip(lg, lr)):
                a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
                if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                    raise AssertionError(
                        f"{label} tick {t}: graph logits differ from the "
                        f"reference's, max abs {np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
            entry["tokens_equal_reference"] = True
            entry["max_abs_logit_diff_vs_reference"] = worst
            report[label] = entry
    return report


def flight_run(cfg):
    """Phase 6f: ``launch.serve`` as a user runs it, at full width with
    ``--profile-dir``, ``--flight-dir``, ``--slo-report`` and one forced
    stall: exactly one flight dump, and the profiler trace holds the
    kernels of every replay of the captured step by name (7 x layers of K1
    on its bulk body for the warm-up step and each tick)."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch.serve import main as serve_main

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    flight, prof = (os.path.join(out_dir, d) for d in ("flight", "profile"))
    metrics_out = os.path.join(out_dir, "metrics.json")
    prev = obs.default_registry()
    obs.set_default_registry(obs.MetricsRegistry())
    try:
        serve_main(["--arch", cfg.name, "--full", "--packed", "--requests",
                    "4", "--max-new", "8", "--max-len", "64",
                    "--profile-dir", prof, "--flight-dir", flight,
                    "--force-stall", "--slo-report", "--metrics-out",
                    metrics_out])
        return read_flight_run(cfg, flight, prof, metrics_out)
    finally:
        obs.set_default_registry(prev)
        shutil.rmtree(out_dir, ignore_errors=True)


def read_flight_run(cfg, flight, prof, metrics_out):
    """Check what :func:`flight_run`'s serve program left behind."""
    from repro_torch.obs.profile import TRACE_FILE
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    dumps = sorted(os.listdir(flight))
    if dumps != ["flight-0001-stall-serve_tick"]:
        raise AssertionError(f"expected one stall dump, found {dumps}")
    for f in ("rings.json", "metrics.json", "meta.json"):
        if not os.path.exists(os.path.join(flight, dumps[0], f)):
            raise AssertionError(f"flight dump without {f}")
    with open(metrics_out) as f:
        snap = json.load(f)
    (tick_hist,) = [h for h in snap["histograms"]
                    if h["name"] == "serve_tick_seconds"]
    ticks = tick_hist["count"]
    with open(os.path.join(prof, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kb = device_kernel_of(e.get("name", ""))
            if kb is not None:
                kernels[kb] = kernels.get(kb, 0) + 1
    want = {("demm_xwT", "bulk"): 7 * cfg.num_layers * (CAPTURE_WARMUP
                                                        + ticks)}
    if kernels != want:
        raise AssertionError(
            f"profiler trace of {ticks} ticks holds DeMM kernels {kernels}: "
            f"expected {want} (the warm-up step and every replay)")
    graph_launches = sum(1 for e in events
                         if "cudaGraphLaunch" in str(e.get("name", "")))
    return {"ticks": ticks, "dumps": dumps,
            "trace_kernels": sum(kernels.values()),
            "graph_launches_in_trace": graph_launches,
            "trace_bytes": os.path.getsize(os.path.join(prof, TRACE_FILE))}


def profile_ticks(model, cfg, label, ticks=5, eager=False):
    """``--profile``: a steady window of decode ticks on 4 full slots, first
    on the host clock, then under ``torch.profiler``; prints the device-busy
    share and the kernels that take the device time, under ``label`` (the
    serving mode).  ``eager`` runs the eager step in place of the graph."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    engine = ServeEngine(model, ServeConfig(num_slots=4, max_len=64),
                         policy=ExecPolicy(mode="packed", backend="cuda"),
                         device=DEVICE, metrics=obs.MetricsRegistry(),
                         _eager=eager)
    rng = np.random.default_rng(0)
    for i in range(4):
        engine.submit(Request(uid=i, max_new_tokens=50, prompt=rng.integers(
            0, cfg.vocab_size, 4, dtype=np.int32)))
    for _ in range(6):
        engine.step()
    torch.cuda.synchronize()
    tok0 = engine._m_tokens.value
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    plain_tick_ms = 1e3 * (time.perf_counter() - t0) / ticks
    tokens_per_s = (engine._m_tokens.value - tok0) / (plain_tick_ms * ticks
                                                      / 1e3)
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
        "mode": label, "step": "eager" if eager else "graph",
        "ticks": ticks, "tick_ms_unprofiled": plain_tick_ms,
        "tokens_per_s_unprofiled": tokens_per_s,
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
# phase 8: the paged engine (chunked prefill and decode, two captured graphs)
# ---------------------------------------------------------------------------

PAGED = dict(num_slots=4, max_len=512, page_size=16, prefill_chunk=32)
PAGED_REQUESTS, PAGED_NEW = 8, 16
# the body each serving kernel runs in a prefill chunk: x of 32 rows
PREFILL_BODY = "gather"


def paged_prompts(vocab, n=PAGED_REQUESTS, seed=11, lo=40, hi=400,
                  chunk=PAGED["prefill_chunk"]):
    """``n`` prompts of ``lo`` to ``hi`` tokens from a seeded generator, none
    a multiple of the chunk: every request takes several chunks and ends on
    a partial one."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    lengths[lengths % chunk == 0] += 1
    return [rng.integers(0, vocab, int(t), dtype=np.int32) for t in lengths]


def paged_engine(model, backend="cuda", eager=False, **cfg):
    """A paged engine through ``make_engine`` (as a user builds one), or the
    eager-programs measurement hook."""
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import make_engine

    config = PagedServeConfig(**{**PAGED, **cfg})
    policy = ExecPolicy(mode="packed", backend=backend)
    if eager:
        return PagedServeEngine(model, config, policy=policy, device=DEVICE,
                                metrics=obs.MetricsRegistry(), _eager=True)
    return make_engine(model, config, policy=policy, device=DEVICE,
                       metrics=obs.MetricsRegistry())


def submit_all(engine, prompts, max_new, uid0=0):
    from repro_torch.serve import Request
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new))


def drain_recording(engine, prompts, max_new):
    """Serve ``prompts`` (uid = index) to the end, keeping every logits row
    the sampler reads, in call order, as (program, uid, position, row):
    ``"prefill"`` for a request's last chunk, ``"decode"`` for a decode
    step's lane.  (The rows of masked lanes are not kept: they may read the
    null page, whose content is not deterministic.)  Returns (that list,
    {uid: tokens})."""
    import numpy as np

    seen, program = [], ["decode"]
    finish, sample = engine._finish_prefill, engine.sampler.sample

    def in_prefill(*args):
        program[0] = "prefill"
        try:
            return finish(*args)
        finally:
            program[0] = "decode"

    def record(logits, uid, pos):
        seen.append((program[0], uid, pos, np.array(logits, copy=True)))
        return sample(logits, uid, pos)

    engine._finish_prefill = in_prefill
    engine.sampler = types.SimpleNamespace(sample=record)  # (a frozen dataclass)
    submit_all(engine, prompts, max_new)
    engine.run_until_drained()
    del engine._finish_prefill              # no reference cycle left
    return seen, {r.uid: list(r.output) for r in engine.completed}


def pass_report(engine, requests, t0, t1):
    """Time to first token per request (ms, by uid), prompt tokens per
    second until the last first token, and tokens per second over the pass
    [t0, t1] (host clock) of ``requests``."""
    reqs = sorted(requests, key=lambda r: r.uid)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    last_first = max(r.first_token_ts for r in reqs)
    first_submit = min(r.submit_ts for r in reqs)
    return {
        "ttft_ms": [1e3 * (r.first_token_ts - r.submit_ts) for r in reqs],
        "prompt_tokens": prompt_tokens,
        "prompt_tokens_per_s": prompt_tokens / (last_first - first_submit),
        "drain_s": t1 - t0,
        "tokens_per_s": sum(len(r.output) for r in reqs) / (t1 - t0),
    }


def profiled_window(engine, ticks):
    """``ticks`` engine ticks under ``torch.profiler``: device ms, DeMM
    device launches by (kernel, body), the program dispatches in the window
    and the kernels that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    p0, d0 = engine.prefill.dispatches, engine._m_disp_decode.value
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"prefill_dispatches": engine.prefill.dispatches - p0,
            "decode_dispatches": int(engine._m_disp_decode.value - d0),
            "device_ms": sum(r[1] for r in rows),
            "device_launches": sum(r[2] for r in rows),
            "demm": device_kernel_counts(prof),
            "top": [{"name": k[:70], "ms": t, "calls": c}
                    for k, t, c in rows[:14]]}


def paged_windows(engine, cfg, expect):
    """On a drained engine whose programs are captured: 4 requests of 129
    prompt tokens (5 chunks each) and 50 new tokens.  Tick 1 (host clock,
    synchronised) and tick 2 (profiled) run 4 non-final chunks each and no
    decode step; once all 4 decode, 5 ticks on the host clock and 5 under
    the profiler.  Each prefill replay must launch the mode's kernel 7 x
    layers times on the gather body and each decode replay 7 x layers times
    on its serving body, on the device, and no other DeMM kernel."""
    import numpy as np
    import torch

    per = 7 * cfg.num_layers
    rng = np.random.default_rng(5)
    submit_all(engine, [rng.integers(0, cfg.vocab_size, 129, dtype=np.int32)
                        for _ in range(4)], 50, uid0=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / 4
    pre = profiled_window(engine, 1)
    want = {(expect, PREFILL_BODY): per * 4}
    if (pre["prefill_dispatches"], pre["decode_dispatches"]) != (4, 0) \
            or pre["demm"] != want:
        raise AssertionError(f"prefill window: {pre['prefill_dispatches']} "
                             f"chunks, {pre['decode_dispatches']} steps, "
                             f"DeMM launches {pre['demm']}: expected 4, 0, "
                             f"{want}")
    while not engine._decode_mask.all():
        engine.step()
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    tok0 = engine._m_tokens.value
    t0 = time.perf_counter()
    for _ in range(5):
        engine.step()
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / 5
    tokens_per_s = (engine._m_tokens.value - tok0) / (5 * tick_ms / 1e3)
    dec = profiled_window(engine, 5)
    want = {(expect, SERVING_BODY[expect]): per * 5}
    if (dec["prefill_dispatches"], dec["decode_dispatches"]) != (0, 5) \
            or dec["demm"] != want:
        raise AssertionError(f"decode window: {dec['prefill_dispatches']} "
                             f"chunks, {dec['decode_dispatches']} steps, "
                             f"DeMM launches {dec['demm']}: expected 0, 5, "
                             f"{want}")
    engine.run_until_drained()
    return {
        "prefill_chunk": {
            "ms_host_clock": chunk_ms,
            "device_ms": pre["device_ms"] / 4,
            "device_launches": pre["device_launches"] / 4,
            "demm_launches_by_body": {f"{k}/{b}": n // 4 for (k, b), n
                                      in pre["demm"].items()},
            "top_device_ms": [{**t, "ms": t["ms"] / 4, "calls": t["calls"] / 4}
                              for t in pre["top"]]},
        "decode_tick": {
            "ms_host_clock": tick_ms, "tokens_per_s": tokens_per_s,
            "device_ms": dec["device_ms"] / 5,
            "busy_share": dec["device_ms"] / 5 / tick_ms,
            "device_launches": dec["device_launches"] / 5,
            "demm_launches_by_body": {f"{k}/{b}": n // 5 for (k, b), n
                                      in dec["demm"].items()},
            "top_device_ms": [{**t, "ms": t["ms"] / 5, "calls": t["calls"] / 5}
                              for t in dec["top"]]},
    }


def page_gather_ms(engine, cfg):
    """Device time of the decode step's page gathers, timed alone, with
    every slot's block-table row full of distinct pages (all slots at
    ``max_len``: the most a tick gathers; a ring over the layers' arenas,
    which exceed L2): K and V of every layer, per tick.  Its bound is the
    bytes of those pages read once and of the gathered caches written
    once."""
    import torch
    from repro_torch.models.attention import gather_pages

    caches = engine.state["caches"]
    slots, nblk = caches["block_table"].shape
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    bt = (torch.randperm(engine.layout.usable_pages, generator=gen,
                         device=DEVICE)[:slots * nblk] + 1).view(slots, nblk)
    calls = [lambda a=a: gather_pages(a, bt)
             for name in ("k", "v") for a in caches[name].unbind(0)]
    ms = time_ring(calls)[0]
    one = gather_pages(caches["k"][0], bt)
    nbytes = 2 * one.nbytes             # distinct pages read, copy written
    del one
    torch.cuda.empty_cache()
    return {"ms_per_gather": ms, "gathers_per_tick": len(calls),
            "ms_per_tick": ms * len(calls), "bytes_per_gather": nbytes,
            "bound_ms_per_tick": 1e3 * nbytes * len(calls) / HBM_BYTES_PER_S}


def graph_equals_eager_paged(model, cfg, prompts, max_new, label):
    """Both captured programs against the eager programs on the same model
    and prompts: bit-equal logits of every request's last chunk and of every
    decode step, the same tokens, one capture of each program."""
    import numpy as np

    graph = paged_engine(model)
    lg, tg = drain_recording(graph, prompts, max_new)
    le, te = drain_recording(paged_engine(model, eager=True), prompts,
                             max_new)
    if (graph.captures, graph.prefill.captures) != (1, 1):
        raise AssertionError(f"{label}: captures {graph.captures} (decode), "
                             f"{graph.prefill.captures} (prefill); expected "
                             "one each")
    if [e[:3] for e in lg] != [e[:3] for e in le] or tg != te:
        raise AssertionError(f"{label}: graph and eager programs give "
                             f"different tokens: {tg} vs {te}")
    for (kind, uid, pos, a), (*_, b) in zip(lg, le):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{label} {kind} logits of request {uid} at {pos}: graph "
                f"and eager differ, max abs {np.abs(a - b).max()}")
    return {"prefill_logits_bit_equal": sum(e[0] == "prefill" for e in lg),
            "decode_logits_bit_equal": sum(e[0] == "decode" for e in lg),
            "tokens_equal": True, "captures": [1, 1]}


def paged_full_width(model, cfg, mode, expect):
    """Phase 8: the paged engine at full width on ``model`` (packed as
    ``mode``), 8 prompts of 40-400 tokens, 16 new tokens each.  The first
    pass, counted from reset to drain, builds and captures both programs:
    the wrappers launch ``expect`` 7 x layers x 2 times in each program's
    warm-up and capture (the prefill chunk's on the gather body, the
    step's on its serving body) and nothing else.  A second pass on the
    same engine is timed (TTFT, prompt tokens/s); then the profiled windows,
    the page gather alone, the dense engine's token-by-token ingest of the
    same prompts, and the captured programs against the eager ones."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import ServeConfig, make_engine

    prompts = paged_prompts(cfg.vocab_size)
    chunks = sum(-(-len(p) // PAGED["prefill_chunk"]) for p in prompts)
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    engine = paged_engine(model)
    submit_all(engine, prompts, PAGED_NEW)
    t0 = time.perf_counter()
    ticks = engine.run_until_drained()
    t1 = time.perf_counter()
    counts = read_counts()               # ... and just after
    body_counts = read_body_counts()
    first = pass_report(engine, engine.completed, t0, t1)
    if len(engine.completed) != len(prompts):
        raise AssertionError(f"{len(engine.completed)} of {len(prompts)} "
                             "requests completed")
    for r in engine.completed:
        if len(r.output) != PAGED_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: {r.output}")
    if not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError("non-finite logits")
    if (engine.captures, engine.prefill.captures) != (1, 1):
        raise AssertionError(f"captures: decode {engine.captures}, prefill "
                             f"{engine.prefill.captures}; expected 1 and 1")
    if engine.prefill.dispatches != chunks:
        raise AssertionError(f"{engine.prefill.dispatches} chunks "
                             f"dispatched, expected {chunks}")
    per = 7 * cfg.num_layers
    want = {name: 0 for name in KERNELS}
    want[expect] = 4 * per
    if counts != want:
        raise AssertionError(f"paged launch counts {counts}: expected {want}"
                             " (7 x layers x (warm-up + capture) of each of "
                             "the two programs, nothing else)")
    serving = SERVING_BODY[expect]
    if expect in body_counts and body_counts[expect] != {
            PREFILL_BODY: 2 * per, serving: 2 * per}:
        raise AssertionError(f"{expect} launches by body "
                             f"{body_counts[expect]}: expected {2 * per} "
                             f"gather (prefill), {2 * per} {serving}")
    decode_ticks = int(engine._m_disp_decode.value)
    # the second pass: both programs captured
    n0 = len(engine.completed)
    submit_all(engine, prompts, PAGED_NEW, uid0=100)
    t0 = time.perf_counter()
    engine.run_until_drained()
    t1 = time.perf_counter()
    second = pass_report(engine, engine.completed[n0:], t0, t1)
    same = {r.uid - 100: r.output for r in engine.completed[n0:]} == {
        r.uid: r.output for r in engine.completed[:n0]}
    if not same:
        raise AssertionError(f"{mode}: the second pass gave other tokens")
    entry = {
        "mode": mode, "kernel": expect,
        "prompt_lengths": [len(p) for p in prompts],
        "chunks": chunks, "ticks": ticks, "decode_steps": decode_ticks,
        "launches": counts[expect],
        "launches_by_body": body_counts.get(expect),
        "captures": [engine.captures, engine.prefill.captures],
        "first_pass": first, "second_pass": second,
        "first_output": engine.completed[0].output}
    entry.update(paged_windows(engine, cfg, expect))
    entry["page_gather"] = page_gather_ms(engine, cfg)
    del engine
    torch.cuda.empty_cache()
    # the dense engine ingesting the same prompts token by token, its
    # decode step captured first by a one-token request
    dense = make_engine(model, ServeConfig(num_slots=PAGED["num_slots"],
                                           max_len=PAGED["max_len"]),
                        policy=ExecPolicy(mode="packed", backend="cuda"),
                        device=DEVICE, metrics=obs.MetricsRegistry())
    submit_all(dense, prompts[:1], 1, uid0=500)
    dense.run_until_drained()
    submit_all(dense, prompts, PAGED_NEW)
    t0 = time.perf_counter()
    dense_ticks = dense.run_until_drained()
    t1 = time.perf_counter()
    entry["dense_token_by_token"] = {
        **pass_report(dense, dense.completed[1:], t0, t1),
        "ticks": dense_ticks}
    del dense
    torch.cuda.empty_cache()
    entry["graph_vs_eager"] = graph_equals_eager_paged(
        model, cfg, prompts[:4], 8, mode)
    return entry


def paged_gates(cfg_full):
    """Phase 8g: 2 layers, float32 compute, the four serving modes, 6
    prompts of 40-112 tokens, 8 new tokens, chunks of 32 on pages of 16
    (max_len 128): the paged engine's tokens equal the dense engine's
    (token-by-token ingest; NBLK x page_size = max_len) and backend
    ``reference``'s (logits allclose, rtol 1e-3), and an arena of 13 pages
    preempts at least once and still gives the uninterrupted tokens."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.serve import ServeConfig, make_engine

    cfg = dataclasses.replace(cfg_full, num_layers=2, compute_dtype="float32")
    prompts = paged_prompts(cfg.vocab_size, n=6, seed=2, hi=112)
    report = {}
    for layout in ("xwT", "block"):
        for quantize in (None, "int8"):
            label = layout + (f"+{quantize}" if quantize else "")
            model = pack_tree(build_model(cfg, device=DEVICE, seed=1),
                              layout=layout, quantize=quantize)
            eng = paged_engine(model, max_len=128)
            lg, tg = drain_recording(eng, prompts, 8)
            lr, tr = drain_recording(
                paged_engine(model, backend="reference", max_len=128),
                prompts, 8)
            if tg != tr:
                raise AssertionError(f"{label}: paged cuda and reference "
                                     f"tokens differ: {tg} vs {tr}")
            worst = 0.0
            for (kind, *_, a), (*_, b) in zip(lg, lr):
                a, b = a[..., :cfg.vocab_size], b[..., :cfg.vocab_size]
                if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                    raise AssertionError(f"{label} {kind}: logits differ "
                                         f"from the reference's, max abs "
                                         f"{np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
            dense = make_engine(model, ServeConfig(num_slots=4, max_len=128),
                                policy=ExecPolicy(mode="packed",
                                                  backend="cuda"),
                                device=DEVICE, metrics=obs.MetricsRegistry())
            submit_all(dense, prompts, 8)
            dense.run_until_drained()
            td = {r.uid: list(r.output) for r in dense.completed}
            if td != tg:
                raise AssertionError(f"{label}: paged and dense tokens "
                                     f"differ: {tg} vs {td}")
            small = paged_engine(model, max_len=128, num_pages=13)
            _, tp = drain_recording(small, prompts, 8)
            preempts = small.metrics.counter("serve_preempt_total").value
            if preempts < 1 or tp != tg:
                raise AssertionError(f"{label}: {preempts} preemptions, "
                                     f"tokens {tp} vs {tg}")
            report[label] = {
                "streams": len(tg), "paged_equals_dense": True,
                "cuda_equals_reference": True,
                "max_abs_logit_diff_vs_reference": worst,
                "preemptions": preempts, "preempted_tokens_equal": True,
                "captures": [eng.captures, eng.prefill.captures]}
    return report


def paged_cli(cfg):
    """Phase 6p: ``launch.serve --full --packed --paged`` as a user runs
    it, replaying the committed tiny trace with priorities on an arena of
    16 pages of 8 tokens (it preempts), with the SLO report: every request
    completes, at least one preemption, both programs dispatched."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch.serve import main as serve_main

    trace = os.path.join(HERE, "benchmarks", "traces", "tiny_trace.jsonl")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_paged_")
    metrics_out = os.path.join(out_dir, "metrics.json")
    prev = obs.default_registry()
    obs.set_default_registry(obs.MetricsRegistry())
    try:
        serve_main(["--arch", cfg.name, "--full", "--packed", "--paged",
                    "--trace-replay", trace, "--max-len", "96",
                    "--page-size", "8", "--max-pages", "16",
                    "--scheduler", "priority", "--slo-report",
                    "--metrics-out", metrics_out])
        with open(metrics_out) as f:
            snap = json.load(f)
    finally:
        obs.set_default_registry(prev)
        shutil.rmtree(out_dir, ignore_errors=True)
    counters = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                for c in snap["counters"]}
    got = {"completed": counters[("serve_requests_completed_total", ())],
           "preemptions": counters[("serve_preempt_total", ())],
           "prefill_dispatches": counters[("serve_step_dispatch_total",
                                           (("program", "prefill"),))],
           "decode_dispatches": counters[("serve_step_dispatch_total",
                                          (("program", "decode"),))]}
    if got["completed"] != 12 or got["preemptions"] < 1 \
            or got["prefill_dispatches"] < 12 or got["decode_dispatches"] < 1:
        raise AssertionError(f"launch.serve --paged: {got}")
    return got


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


def timed_entry(meta, kern, plain, nbytes, ops, *, sweep=(), variants=None):

    """One timing row: the kernel over its ring (graph replay and eager),
    the plain version over the first copies, and the bound from the bytes
    each input and output must cross once and the operations at the bf16
    peak.  ``sweep`` times ``rows_per_block`` values; ``variants`` maps a
    key of the row to {label: keyword arguments of the call} and times
    each (a launcher's refusal is recorded; any other error fails the run
    where it happens)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S["bfloat16"]
    ms, eager_ms = time_ring(kern)
    entry = {**meta, "ring_copies": len(kern), "bytes": nbytes, "ms": ms,
             "eager_ms": eager_ms,
             "plain_ms": time_ring(plain[:8], passes=3)[0],
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "achieved_GBps": nbytes / ms / 1e6}
    if sweep:
        entry["rows_per_block_ms"] = {
            str(r): time_ring([lambda c=c, r=r: c(rows_per_block=r)
                               for c in kern], passes=5)[0]
            for r in sweep}
    if variants:
        from repro_torch.kernels.demm_xwT import LaunchRefused
    for key, cases in (variants or {}).items():
        entry[key] = {}
        for label, kw in cases.items():
            try:
                entry[key][label] = time_ring(
                    [lambda c=c, kw=kw: c(**kw) for c in kern], passes=5)[0]
            except LaunchRefused as e:    # e.g. stages that do not fit
                entry[key][label] = f"refused: {e}"
    return entry


def ring(tensors, nbytes):
    """Copies of ``tensors`` (a tuple) enough to exceed L2 several times."""
    copies = ring_size(nbytes)
    return list(zip(*(t.repeat(copies, *([1] * t.ndim)).unbind(0)
                      for t in tensors)))


def shape_inputs(label, o, k, n, m, gen, bx=4):
    """The Bx = 4 (or ``bx``) bf16 activations and one random packed weight
    (float, and int8 with per-row and with per-group scales) of a projection
    shape, with the timing rows' metadata."""
    import torch
    g = k // m
    x = torch.randn((bx, k), generator=gen, device=gen.device).to(torch.bfloat16)
    vals, idx = make_packed(o, k, n, m, gen)
    q, per_row = make_q8(o, g, n, False, gen)
    scales = {"per_row": per_row, "per_group": make_q8(o, g, n, True, gen)[1]}
    meta = {"shape": label, "O": o, "K": k, "pattern": f"{n}:{m}", "Bx": bx,
            "x_dtype": "bfloat16"}
    return x, vals, idx, q, scales, meta


def time_xwt(x, vals, idx, q, scales, cfg, meta, *, sweep=()):
    """K1 and K3 as the main path launches them, K3 with each of the
    ``scales`` ({"per_row": (O,), "per_group": (O, G)}); with the sweep on,
    both kernels' bulk-body tunables (rows per CTA, chunks) and their gather
    body, K3's also at the gather body's rows per block ``sweep``.  (A
    checkout from before the duplicate repair has no ``duplicates`` flag:
    its one instantiation is the main path's; one from before K3's bulk
    body has no K3 hook and runs the gather body.)"""
    import inspect
    from repro_torch.kernels import demm_q8 as kq
    from repro_torch.kernels import demm_xwT as kx
    demm_xwT_q8, demm_xwT_q8_plain = kq.demm_xwT_q8, kq.demm_xwT_q8_plain

    demm_xwT, demm_xwT_plain = kx.demm_xwT, kx.demm_xwT_plain
    main = ({"duplicates": False}
            if "duplicates" in inspect.signature(demm_xwT).parameters else {})
    bx, o = x.shape[0], vals.shape[0]
    nnz = int((vals != 0).sum())
    y_bytes = bx * o * 4
    out = {}
    w_bytes = vals.nbytes + idx.nbytes
    r = ring((vals, idx), w_bytes)

    def k1(v, i, body=None, **kw):
        if body is None and "chunks" not in kw:
            return demm_xwT(x, v, i, cfg, **main, **kw)
        return kx.demm_xwT_on(body, x, v, i, cfg, **main, **kw)

    variants = None
    if sweep:
        variants = {
            "bulk_rows_ms": {str(n): {"rows_per_block": n} for n in BULK_ROWS},
            "bulk_chunks_ms": {str(c): {"chunks": c} for c in BULK_CHUNKS},
            "gather_body_ms": {"default": {"body": "gather"}}}
    out["demm_xwT"] = [timed_entry(
        {**meta, "body": kx.xwt_body(x, vals, idx, cfg.m, **main)
         if hasattr(kx, "xwt_body") else "gather"},
        [lambda v=v, i=i, **kw: k1(v, i, **kw) for v, i in r],
        [lambda v=v, i=i: demm_xwT_plain(x, v, i, cfg) for v, i in r],
        x.nbytes + w_bytes + y_bytes, 2 * bx * nnz, variants=variants)]
    has_bulk = hasattr(kq, "demm_xwT_q8_on")

    def k3(v, i, sc, body=None, **kw):
        if body is None and not {"chunks", "lanes"} & kw.keys():
            return demm_xwT_q8(x, v, i, sc, cfg, **main, **kw)
        return kq.demm_xwT_q8_on(body, x, v, i, sc, cfg, **main, **kw)

    if sweep and has_bulk:
        variants = {**variants, "bulk_lanes_ms": {
            str(n): {"lanes": n} for n in BULK_LANES}, "gather_body_ms": {
            "default": {"body": "gather"},
            **{f"rows_per_block={n}": {"body": "gather", "rows_per_block": n}
               for n in sweep}}}
    out["demm_xwT_q8"] = []
    for unit, sc0 in scales.items():
        w_bytes = q.nbytes + idx.nbytes + sc0.nbytes
        r = ring((q, idx, sc0), w_bytes)
        body = (kx.xwt_body(x, q, idx, cfg.m, scales=sc0, **main)
                if has_bulk else "gather")
        out["demm_xwT_q8"].append(timed_entry(
            {**meta, "scales": unit, "body": body},
            [lambda v=v, i=i, sc=sc, **kw: k3(v, i, sc, **kw)
             for v, i, sc in r],
            [lambda v=v, i=i, sc=sc: demm_xwT_q8_plain(x, v, i, sc, cfg)
             for v, i, sc in r],
            x.nbytes + w_bytes + y_bytes, 2 * bx * nnz,
            sweep=() if has_bulk else sweep, variants=variants))
        del r
    return out


# --sweep: the redesigned bodies' tunables
CLUSTER_SIZES = (1, 2, 4, 8)
BULK_CHUNKS = (1, 2, 4, 16)
BULK_LANES = (8, 16)
BULK_ROWS = (8, 12, 16, 20, 24, 32, 40, 53, 64)
BULK_SMEM_BYTES = 232448     # an H100 block's shared memory (opt-in)
TC_TILES = ((128, 1), (128, 2), (256, 1), (256, 2))
TC_GROUPS = (1, 2, 3, 4)
TC_STAGES = (2, 3, 4)
SPMM_CROSSOVER_CDS = (16, 32, 64, 128, 256)


def time_block(x, vals, idx, cfg, meta, *, sweep=False):
    """K2 and K4 on the block layout of the same weight as ``vals, idx``
    (every group active, a_max = G), B = xᵀ as serving passes it; with the
    sweep on, also their cluster sizes and gather body.  Returns the dense
    weight and {kernel: [timing row]}."""
    from repro_torch.core.sparsity import pack_block, unpack
    from repro_torch.kernels.demm_block_spmm import (block_body,
                                                     demm_block_spmm_on)
    from repro_torch.kernels.demm_q8 import demm_block_spmm_q8_on
    from repro_torch.quant import quantize_packed

    fns = kernel_fns()
    bx, o, k = x.shape[0], vals.shape[0], x.shape[1]
    nnz = int((vals != 0).sum())
    y_bytes = bx * o * 4
    out = {}
    variants = ({"cluster_size_ms": {
        str(c): {"cluster_size": c} for c in CLUSTER_SIZES},
        "gather_body_ms": {"default": {"body": "gather"}}}
        if sweep else None)
    dense = unpack(vals, idx, cfg, (o, k))
    pw = pack_block(dense, cfg)
    bmeta = {**meta, "block_geom": list(pw.block_geom)}
    xt = x.T
    kern, plain = fns["demm_block_spmm"]
    w_bytes = pw.values.nbytes + pw.indices.nbytes + pw.active_groups.nbytes
    r = ring((pw.active_groups, pw.values, pw.indices), w_bytes)

    def k2(a, v, i, body=None, **kw):
        if body is None:
            return kern(a, v, i, xt, cfg, r=o, duplicates=False, **kw)
        return demm_block_spmm_on(body, a, v, i, xt, cfg, r=o,
                                  duplicates=False, **kw)

    out["demm_block_spmm"] = [timed_entry(
        {**bmeta, "body": block_body(pw.active_groups, pw.values, pw.indices,
                                     xt, cfg.m)},
        [lambda a=a, v=v, i=i, **kw: k2(a, v, i, **kw) for a, v, i in r],
        [lambda a=a, v=v, i=i: plain(a, v, i, xt, cfg, r=o) for a, v, i in r],
        x.nbytes + w_bytes + y_bytes, 2 * bx * nnz, variants=variants)]
    qw = quantize_packed(pw)
    kern, plain = fns["demm_block_spmm_q8"]
    w_bytes = (qw.values.nbytes + qw.indices.nbytes + qw.active_groups.nbytes
               + qw.scales.nbytes)
    r = ring((qw.active_groups, qw.values, qw.indices, qw.scales), w_bytes)

    def k4(a, v, i, sc, body=None, **kw):
        if body is None:
            return kern(a, v, i, sc, xt, cfg, r=o, duplicates=False, **kw)
        return demm_block_spmm_q8_on(body, a, v, i, sc, xt, cfg, r=o,
                                     duplicates=False, **kw)

    out["demm_block_spmm_q8"] = [timed_entry(
        bmeta,
        [lambda a=a, v=v, i=i, sc=sc, **kw: k4(a, v, i, sc, **kw)
         for a, v, i, sc in r],
        [lambda a=a, v=v, i=i, sc=sc: plain(a, v, i, sc, xt, cfg, r=o)
         for a, v, i, sc in r],
        x.nbytes + w_bytes + y_bytes, 2 * bx * nnz, variants=variants)]
    return dense, out


def library_ms(x, dense):
    """The yardstick of K1-K4: one bf16 ``torch.matmul`` of x against the
    dense weight, over a ring of weight copies larger than L2."""
    import torch
    w = dense.to(torch.bfloat16)
    wr = [wt.T for wt in w.repeat(ring_size(w.nbytes, hi=32), 1, 1).unbind(0)]
    return time_ring([lambda wt=wt: torch.matmul(x, wt) for wt in wr])[0]


def time_gather_bodies(label, o, k, n, m, gen, bx=32):
    """K1-K4 at one projection shape with x of ``bx`` rows (bf16), as a
    prefill chunk launches them: every one of them on its gather body (the
    bulk and cluster bodies take at most 8 rows), K3 with per-row scales as
    served.  Rows as :func:`time_shape`'s, with the library yardstick."""
    from repro_torch.core.sparsity import SparsityConfig

    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen,
                                                 bx=bx)
    out = time_xwt(x, vals, idx, q, {"per_row": scales["per_row"]}, cfg,
                   meta)
    dense, blocks = time_block(x, vals, idx, cfg, meta)
    out.update(blocks)
    out["demm_block_spmm_q8"][0]["body"] = "gather"   # told apart on device
    lib = library_ms(x, dense)
    for entries in out.values():
        for e in entries:
            e["library_ms"] = lib
            if e["body"] != "gather":
                raise AssertionError(f"{label} at Bx = {bx}: {e['body']} "
                                     "body, expected the gather body")
    return out


def time_shape(label, o, k, n, m, gen, *, sweep=(), block_sweep=()):
    """Times of the five kernels at one projection shape: K1-K4 at Bx = 4
    with bfloat16 activations, as the main path launches them; K5 at
    Cd = 4 and 256 with B (K, Cd) bfloat16.  With the sweep on, also K4's
    cluster sizes and its gather body, K5's tiles, groups per stage and
    stages at Cd = 256 (through the kernels' measurement hooks), and
    both K5 bodies at Cd from 16 to 256 (where the tiled body starts to
    win)."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels.demm_spmm import demm_spmm_on, spmm_body

    fns = kernel_fns()
    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen)
    nnz = int((vals != 0).sum())
    out = time_xwt(x, vals, idx, q, scales, cfg, meta, sweep=sweep)

    dense, blocks = time_block(x, vals, idx, cfg, meta, sweep=bool(sweep))
    out.update(blocks)
    lib = library_ms(x, dense)
    for entries in out.values():
        for e in entries:
            e["library_ms"] = lib
    w = dense.to(torch.bfloat16)

    # K5, the paper orientation C = A @ B, with B of 4 and 256 columns; its
    # yardstick is the dense bf16 product A @ B
    kern, plain = fns["demm_spmm"]
    w_bytes = vals.nbytes + idx.nbytes
    r = ring((vals, idx), w_bytes)
    wr = list(w.repeat(ring_size(w.nbytes, hi=32), 1, 1).unbind(0))
    out["demm_spmm"] = []

    def k5(v, i, b, body=None, groups_per_stage=None, **kw):
        if body is None and groups_per_stage is None:
            return kern(v, i, b, cfg, duplicates=False, **kw)
        return demm_spmm_on(body, v, i, b, cfg, duplicates=False,
                            groups_per_stage=groups_per_stage, **kw)

    for cd in (4, 256):
        b = torch.randn((k, cd), generator=gen, device=gen.device)
        b = b.to(torch.bfloat16)
        tiled = spmm_body(vals, idx, b, m) == "tiled"
        variants = None
        if sweep and tiled:
            # columns x rows / groups per stage / stages
            variants = {"tile_groups_stages_ms": {
                f"{t[0]}x{64 * t[1]}/{ng}/{st}":
                    {"tile": t, "groups_per_stage": ng, "stages": st}
                for t in TC_TILES for ng in TC_GROUPS for st in TC_STAGES}}
        e = timed_entry(
            {**meta, "Bx": cd, "Cd": cd, "B_dtype": "bfloat16",
             "body": spmm_body(vals, idx, b, m)},
            [lambda v=v, i=i, b=b, **kw: k5(v, i, b, **kw) for v, i in r],
            [lambda v=v, i=i, b=b: plain(v, i, b, cfg) for v, i in r],
            b.nbytes + w_bytes + o * cd * 4, 2 * cd * nnz,
            sweep=() if tiled else block_sweep, variants=variants)
        e["library_ms"] = time_ring(
            [lambda wt=wt, b=b: torch.matmul(wt, b) for wt in wr])[0]
        out["demm_spmm"].append(e)
    if sweep:
        # both bodies at widths around the switch (TILED_MIN_CD)
        cross = {}
        for cd in SPMM_CROSSOVER_CDS:
            b = torch.randn((k, cd), generator=gen,
                            device=gen.device).to(torch.bfloat16)
            cross[str(cd)] = {
                body: time_ring([lambda v=v, i=i, b=b, body=body:
                                 k5(v, i, b, body=body) for v, i in r],
                                passes=5)[0]
                for body in ("tiled", "gather")}
        out["demm_spmm"][-1]["body_ms_by_cd"] = cross
    del r, wr, w, dense
    torch.cuda.empty_cache()
    return out


def launch_floor():
    """An empty kernel launched at K1's and K3's bulk grid (about one CTA
    per SM, as ``csrc/demm_xwt_bulk.cuh`` sizes it) and at K2's cluster grid
    (a cluster of ``cl_auto_csize`` CTAs per row block), each with the
    dynamic shared memory the kernel asks for at Bx = 4 bf16, timed by the
    same graph replay as the kernels: what a launch of that shape costs
    before any work.  ms per shape and per layer."""
    import torch
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.demm_xwT import raise_on_launch_error

    lib = load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def empty(blocks, threads, csize, smem):
        def call():
            raise_on_launch_error(lib.demm_empty_launch(
                blocks, threads, csize, smem, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream), "demm_empty")
        return call

    out = {"demm_xwT": {}, "demm_xwT_q8": {}, "demm_block_spmm": {}}
    for label, o, k, n, m in MAIN_SHAPES:
        g, bx, block_r = k // m, 4, 128
        rows = -(-o // sms)
        x1 = bx * k * 2                                  # bf16 x, transposed
        smem1 = min(BULK_SMEM_BYTES, 128 + x1 + rows * g * n * 8)  # fp32 + int32
        smem3 = min(BULK_SMEM_BYTES, 128 + x1 + rows * g * n * 5)  # int8, int32
        rb = o // block_r
        csize = 2
        while csize < 8 and rb * csize < sms:
            csize *= 2
        per = -(-g // csize)
        smem2 = (16 + ((256 // block_r + 1) * block_r * bx + 8) * 4
                 + per * (block_r * n * 8 + bx * m * 2))
        grids = {"demm_xwT": (-(-o // rows), 512, 1, smem1),
                 "demm_xwT_q8": (-(-o // rows), 512, 1, smem3),
                 "demm_block_spmm": (rb * csize, 256, csize, smem2)}
        for name, (blocks, threads, cs, smem) in grids.items():
            ms = time_ring([empty(blocks, threads, cs, smem)] * 64)[0]
            out[name][label] = {"blocks": blocks, "threads": threads,
                                "cluster": cs, "smem": smem, "ms": ms}
    for name, per_shape in out.items():
        per_shape["per_layer_ms"] = sum(LAYER_MIX[lb] * e["ms"]
                                        for lb, e in per_shape.items())
    return out


def layer_entry(name, source, replaces, per_shape, launches, max_abs_err, *,
                work, source_wide=None):
    """One line of the ``kernels`` report: the seven launches of one decoder
    layer (4 + 2 + 1 over the three shapes) at Bx (Cd) = 4 summed, every
    per-shape row beside; for K5 also the layer at Cd = 256 (``*_wide``,
    run by the body in ``source_wide``), for K3 also the layer with
    per-group scales (``*_per_group``; the main figures are per-row, as
    served)."""
    def total(key, cd=4, scales="per_row"):
        return sum(LAYER_MIX[e["shape"]] * e[key] for e in per_shape
                   if e["Bx"] == cd and e.get("scales", "per_row") == scales)
    bound_by = {e["bound_by"] for e in per_shape if e["Bx"] == 4}
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err, "work": work,
        "ms": total("ms"), "eager_ms": total("eager_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
        "library_ms": total("library_ms"),
    }
    if any(e.get("scales") == "per_group" for e in per_shape):
        entry.update({f"{key}_per_group": total(key, scales="per_group")
                      for key in ("ms", "plain_ms", "bound_ms", "library_ms")})
    if any(e["Bx"] == 256 for e in per_shape):
        entry["source_wide"] = source_wide
        entry.update({f"{key}_wide": total(key, 256) for key in (
            "ms", "plain_ms", "bound_ms", "library_ms")})
    entry["shapes"] = per_shape
    return entry


# ---------------------------------------------------------------------------

COMPARED = ("demm_xwT", "demm_xwT_q8", "demm_xwT_q8/per_group",
            "demm_block_spmm", "demm_block_spmm_q8", "demm_spmm@4",
            "demm_spmm@256")


def kernel_times(label, o, k, n, m, gen):
    """Device time of each kernel at one projection shape as the main path
    launches it (K1-K4 at Bx = 4, bf16 x; K5 with B (K, 4) and (K, 256)
    bf16), defaults and ``duplicates=False`` only, so that an older
    checkout's wrappers take the same calls."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, pack_block, unpack
    from repro_torch.kernels.demm_block_spmm import demm_block_spmm
    from repro_torch.kernels.demm_q8 import demm_block_spmm_q8
    from repro_torch.kernels.demm_spmm import demm_spmm
    from repro_torch.quant import quantize_packed

    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen)
    out = {name + ("/per_group" if row.get("scales") == "per_group" else ""):
           row["ms"]
           for name, rows in time_xwt(x, vals, idx, q, scales, cfg,
                                      meta).items() for row in rows}
    pw = pack_block(unpack(vals, idx, cfg, (o, k)), cfg)
    qw = quantize_packed(pw)
    xt = x.T
    r = ring((pw.active_groups, pw.values, pw.indices),
             pw.values.nbytes + pw.indices.nbytes)
    out["demm_block_spmm"] = time_ring(
        [lambda a=a, v=v, i=i: demm_block_spmm(a, v, i, xt, cfg, r=o,
                                               duplicates=False)
         for a, v, i in r])[0]
    r = ring((qw.active_groups, qw.values, qw.indices, qw.scales),
             qw.values.nbytes + qw.indices.nbytes + qw.scales.nbytes)
    out["demm_block_spmm_q8"] = time_ring(
        [lambda a=a, v=v, i=i, sc=sc: demm_block_spmm_q8(
            a, v, i, sc, xt, cfg, r=o, duplicates=False)
         for a, v, i, sc in r])[0]
    r = ring((vals, idx), vals.nbytes + idx.nbytes)
    for cd in (4, 256):
        b = torch.randn((k, cd), generator=gen,
                        device=gen.device).to(torch.bfloat16)
        out[f"demm_spmm@{cd}"] = time_ring(
            [lambda v=v, i=i, b=b: demm_spmm(v, i, b, cfg, duplicates=False)
             for v, i in r])[0]
    del r, pw, qw
    torch.cuda.empty_cache()
    return out


def times_of(src: str) -> dict:
    """``--times-of SRC`` (one process per checkout): K1-K5 per layer,
    built and imported from the checkout whose ``src/`` is SRC."""
    sys.path.insert(0, os.path.abspath(src))
    sys.path.remove(os.path.join(HERE, "src"))
    import torch
    import repro_torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    per = {name: 0.0 for name in COMPARED}
    for label, o, k, n, m in MAIN_SHAPES:
        for name, ms in kernel_times(label, o, k, n, m, gen).items():
            per[name] += LAYER_MIX[label] * ms
    return {"package": repro_torch.__file__, **per}


def compare_with(other: str):
    """``--compare-with DIR``: K1-K5 per layer of the checkout at DIR and of
    this one, each in its own process (its own build), in the turns DIR,
    this, this, DIR; prints one JSON line and the ratios."""
    runs = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times-of",
             os.path.join(root, "src")],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"--times-of {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        runs.append({"root": root,
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
    log(f"[compare] ms per layer, in turns: {json.dumps(runs)}")
    summary = {}
    for name in COMPARED:
        parent = [runs[0][name], runs[3][name]]
        this = [runs[1][name], runs[2][name]]
        summary[name] = {
            "parent_ms": parent, "this_ms": this,
            "speedup": statistics.mean(parent) / statistics.mean(this),
            "parent_spread": abs(parent[0] - parent[1]) / min(parent),
            "this_vs_parent": (statistics.mean(this) - statistics.mean(parent))
            / statistics.mean(parent)}
    log(f"[compare] summary: {json.dumps(summary)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the tunables: K1's and K3's bulk body "
                         "(rows per CTA, chunks; K3's slot lanes per row) "
                         "against their gather body, K3's gather body at "
                         "rows_per_block in {8, 16, 24, 32, 48, 64}, K2's "
                         "and K4's cluster sizes against their gather body, "
                         "K5's rows_per_block in {8, 16, 32, 64} at Cd = 4, "
                         "its tile and stages at Cd = 256, and both K5 "
                         "bodies at Cd 16-256")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a steady window of decode ticks of "
                         "the four serving modes (both layouts, float and "
                         "int8) with torch.profiler, the captured step and "
                         "the eager step in turns")
    ap.add_argument("--stop-after", type=int, default=None, metavar="PHASE",
                    help="development aid: stop after this phase (3: build "
                         "and check the kernels only); prints no result line")
    ap.add_argument("--compare-with", default=None, metavar="DIR",
                    help="development aid: time K1-K5 of the checkout at DIR "
                         "against this one's, in turns, and stop; prints no "
                         "result line")
    ap.add_argument("--times-of", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.time()
    if args.times_of:
        print(json.dumps(times_of(args.times_of)), flush=True)
        return 0

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
    gen = torch.Generator(device=DEVICE)
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

    if args.compare_with:
        compare_with(args.compare_with)
        log(f"stopped after the comparison as asked "
            f"({time.time() - t_start:.1f} s)")
        return 0

    if args.stop_after is not None and args.stop_after <= 3:
        log(f"stopped after phase 3 as asked ({time.time() - t_start:.1f} s)")
        return 0

    # 4./5. serve at full width, xwT layout; 4b/5b block layout on a fresh
    # model of the same seed (packing is in place)
    cfg = get_arch("stablelm_3b")
    serve, graph, profiles, paged = {}, {}, [], {}
    for layout in ("xwT", "block"):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=DEVICE, seed=0)
        torch.cuda.synchronize()
        log(f"[4 serve] built {cfg.name} ({cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}) in "
            f"{time.time() - t0:.1f} s; "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak")
        float_kernel, q8_kernel = (("demm_xwT", "demm_xwT_q8")
                                   if layout == "xwT" else
                                   ("demm_block_spmm", "demm_block_spmm_q8"))
        for kernel, quantize in ((float_kernel, None), (q8_kernel, "int8")):
            mode = f"--layout {layout}" + (f" --quantize {quantize}"
                                           if quantize else "")
            t0 = time.time()
            # the model is packed (then quantized) in place
            serve[kernel] = serve_full_width(
                model, cfg, layout=layout, quantize=quantize, expect=kernel)
            phase = "[5 serve q8]" if quantize else "[4 serve]"
            log(f"{phase} packed {mode}, backend cuda ({time.time() - t0:.1f}"
                f" s with packing): {json.dumps(serve[kernel])}")
            graph[mode] = graph_vs_eager(model, cfg, mode)[0]
            log(f"[{phase[1]}g graph] {json.dumps(graph[mode])}")
            t0 = time.time()
            paged[mode] = paged_full_width(model, cfg, mode, kernel)
            log(f"[8 paged] {mode} ({time.time() - t0:.1f} s): "
                f"{json.dumps(paged[mode])}")
            if args.profile:             # graph and eager, paired
                for eager in (False, True, True, False):
                    profiles.append(profile_ticks(model, cfg, mode,
                                                  eager=eager))
        del model
        torch.cuda.empty_cache()
    spmm = spmm_path(gen)
    log(f"[5c spmm] ops.demm_spmm, backend cuda: {json.dumps(spmm)}")

    # 6. backends agree end to end
    agree = check_backends_agree(get_arch("stablelm_3b"))
    log(f"[6 agree] cuda vs reference, 2 layers float32: {json.dumps(agree)}")
    graph["2 layers float32"] = check_graph_modes(get_arch("stablelm_3b"))
    log(f"[6g graph] graph vs eager vs reference, 2 layers float32, four "
        f"modes: {json.dumps(graph['2 layers float32'])}")
    t0 = time.time()
    paged_gate = paged_gates(get_arch("stablelm_3b"))
    log(f"[8g paged] paged vs dense vs reference, preemption, 2 layers "
        f"float32, four modes ({time.time() - t0:.1f} s): "
        f"{json.dumps(paged_gate)}")
    log("[8 paged] mode | TTFT ms median (dense) | prompt tok/s (dense) | "
        "chunk ms host / device | decode tick ms host / device | busy | "
        "page gather ms/tick")
    for mode, r in paged.items():
        sp, dn = r["second_pass"], r["dense_token_by_token"]
        log(f"[8 paged] {mode} | {statistics.median(sp['ttft_ms']):.1f} "
            f"({statistics.median(dn['ttft_ms']):.1f}) | "
            f"{sp['prompt_tokens_per_s']:.0f} "
            f"({dn['prompt_tokens_per_s']:.0f}) | "
            f"{r['prefill_chunk']['ms_host_clock']:.3f} / "
            f"{r['prefill_chunk']['device_ms']:.3f} | "
            f"{r['decode_tick']['ms_host_clock']:.3f} / "
            f"{r['decode_tick']['device_ms']:.3f} | "
            f"{100 * r['decode_tick']['busy_share']:.1f} % | "
            f"{r['page_gather']['ms_per_tick']:.3f}")
    if profiles:
        log("[profile] mode | step | tick ms (host) | device ms/tick | busy "
            "| launches/tick | tokens/s")
        for r in profiles:
            log(f"[profile] {r['mode']} | {r['step']} | "
                f"{r['tick_ms_unprofiled']:.3f} | "
                f"{r['device_ms_per_tick']:.3f} | "
                f"{100 * r['device_busy_share_unprofiled']:.1f} % | "
                f"{r['device_launches_per_tick']:.0f} | "
                f"{r['tokens_per_s_unprofiled']:.1f}")

    # 6f. the serve program with its observability flags, a forced stall
    t0 = time.time()
    flight = flight_run(cfg)
    log(f"[6f flight] launch.serve --full --profile-dir --flight-dir "
        f"--force-stall ({time.time() - t0:.1f} s): {json.dumps(flight)}")
    t0 = time.time()
    cli = paged_cli(cfg)
    log(f"[6p paged cli] launch.serve --full --packed --paged "
        f"--trace-replay ({time.time() - t0:.1f} s): {json.dumps(cli)}")

    # 7. times
    sweep = (8, 16, 24, 32, 48, 64) if args.sweep else ()
    block_sweep = (8, 16, 32, 64) if args.sweep else ()
    per_kernel = {name: [] for name in KERNELS}
    for shape in MAIN_SHAPES:
        timed = time_shape(*shape, gen, sweep=sweep, block_sweep=block_sweep)
        for name, entries in timed.items():
            for entry in entries:
                per_kernel[name].append(entry)
                log(f"[7 times] {name} {json.dumps(entry)}")
    gather32 = {name: [] for name in KERNELS[:4]}
    for shape in MAIN_SHAPES:
        for name, entries in time_gather_bodies(*shape, gen).items():
            for entry in entries:
                gather32[name].append(entry)
                log(f"[7p gather Bx=32] {name} {json.dumps(entry)}")
    csrc = "src/repro_torch/kernels/csrc/"
    layer = ("the 7 packed projections of one stablelm_3b decoder layer "
             "(4 x 2560x2560 5:80, 2 x 6912x2560 5:80, 1 x 2560x6912 3:48), "
             "{}, weights read from device memory")
    serving = layer.format("Bx=4, bfloat16 activations")
    launches = {name: run["launches"] for name, run in serve.items()}
    launches["demm_spmm"] = spmm["launches"]
    sources = {
        "demm_xwT": (csrc + "demm_xwt.cu",
                     "src/repro/kernels/demm_spmm.py:180", serving),
        "demm_xwT_q8": (csrc + "demm_xwt_bulk.cuh",
                        "src/repro/kernels/demm_q8.py:79",
                        serving + ", int8 values with per-row scales, the "
                        "bulk row-tile body launched by demm_xwt_q8.cu; "
                        "*_per_group: scales (O, G)"),
        "demm_block_spmm": (csrc + "demm_block_spmm.cu",
                            "src/repro/kernels/demm_block_spmm.py:85",
                            serving + ", block layout"),
        "demm_block_spmm_q8": (csrc + "demm_block_spmm_q8.cu",
                               "src/repro/kernels/demm_q8.py:162",
                               serving + ", block layout"),
        "demm_spmm": (csrc + "demm_block_spmm.cu",
                      "src/repro/kernels/demm_spmm.py:111",
                      layer.format("C = A @ B with B (K, 4) bfloat16, the "
                                   "gather body of demm_block_spmm.cu; "
                                   "*_wide: B (K, 256), the tiled body of "
                                   "source_wide")),
    }
    kernels = [layer_entry(name, src, replaces, per_kernel[name],
                           launches[name], errs[name], work=work,
                           source_wide=csrc + "demm_spmm_tc.cu")
               for name, (src, replaces, work) in sources.items()]
    for entry in kernels:
        rows = gather32.get(entry["name"])
        if rows is None:
            continue
        # the paged engine: wrapper launches over its counted pass, and the
        # gather body at Bx = 32, as a prefill chunk launches it, per layer
        entry["launches_paged"] = sum(r["launches"] for r in paged.values()
                                      if r["kernel"] == entry["name"])
        entry["prefill_bx32"] = {
            "body": "gather", **{key: sum(LAYER_MIX[e["shape"]] * e[key]
                                          for e in rows)
                                 for key in ("ms", "plain_ms", "bound_ms",
                                             "library_ms")},
            "shapes": rows}
    # K5's tiled body does the dense count of operations: its floor, worked
    # from the shapes (not a measurement, so not in the kernels line)
    floor = {label: 1e3 * 2 * o * k * 256 / PEAK_OPS_PER_S["bfloat16"]
             for label, o, k, _, _ in MAIN_SHAPES}
    log(f"[7 times] launch floor, an empty kernel at each redesigned "
        f"kernel's grid and shared memory, graph replay, ms: "
        f"{json.dumps(launch_floor())}")
    log(f"[7 times] demm_spmm Cd=256 dense tile-product floor, 2 R K Cd at "
        f"the bf16 peak, computed from the shapes, ms: {json.dumps(floor)}; "
        f"per layer {sum(LAYER_MIX[s] * t for s, t in floor.items())}")
    log(f"[done] {time.time() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels, "serve": list(serve.values()),
                    "spmm": spmm, "agree": agree, "graph": graph,
                    "flight": flight, "paged": list(paged.values()),
                    "paged_gates": paged_gate, "paged_cli": cli}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
