"""Measured autotuning of DeMM kernel variants.

Pipeline (per problem):

  1. **Enumerate** — every registered variant that supports the problem
     (``cuda`` on a CUDA problem, ``reference`` on the CPU, and the
     measure-only ``block_spmm`` of op ``spmm``) × the cartesian grid of its
     tunables (the body's own: :func:`repro_torch.tune.registry.cuda_body`),
     plus its default ``{}`` (the wrapper's own heuristic).
  2. **Prune** — drop candidates whose launch geometry the launcher refuses
     (``cluster_size`` outside 1-8, ``rows_per_block`` of a block gather
     body that does not divide its 256 threads, ...; ``pruned_geometry``)
     and those whose dynamic shared memory, counted as the launchers count
     it (:func:`smem_bytes`), exceeds what an H100 thread block may opt in
     to (``pruned_smem``); rank the survivors with the first-order model of
     :func:`estimate_us` and keep the ``max_measure`` most promising.  The
     defaults are always kept, so tuned-against-default is a measured pair.
  3. **Measure** — on a CUDA problem, in the regime serving runs in: a ring
     of operand copies larger than L2 (each launch reads its weight from
     device memory, as a decode step does), captured once as a CUDA graph
     and replayed between CUDA events; the score is device time per launch,
     the least over ``iters`` replays.  A Python loop around the calls would
     measure the 30-50 us of issuing a launch, not the 6-50 us it runs.  On
     the CPU, wall time of ``iters`` calls after ``warmup`` (the reference
     variant only).  Measure-only candidates do their host work (the
     repack) before the window; only their launches are timed.
  4. **Select & persist** — the fastest *dispatchable* measured candidate is
     written to the tuning cache keyed by the full problem.  The heuristic
     default is always measured, so the tuned choice is never slower than
     the default in the tuner's own table.

Every candidate is checked before it is timed: its output on the ring's
first operands must agree with the heuristic default's (the default runs
first) within :data:`AGREE_TOL`, and on the card the dynamic shared memory
its launcher asked for must equal what :func:`smem_bytes` counted for it
(the model that pruned the grid).  Either failing raises.

What breaks is not swallowed: a launcher's refusal raised before anything
is launched (:class:`repro_torch.kernels.demm_xwT.LaunchRefused`) marks the
candidate ``refused`` and the tuner goes on; anything else (a CUDA fault is
sticky and poisons every later launch of the process) is re-raised.  A
default that cannot be measured raises.  Tuning inside a CUDA-graph capture
raises: measurement happens only in explicit ``autotune_*`` calls (an
engine's constructor, ``--autotune``, the bench scripts), never at dispatch.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.sparsity import SparsityConfig, holds_duplicates
from repro_torch.tune.cache import (TuneCache, TunedConfig, default_cache,
                                    heuristic_default)
from repro_torch.tune.registry import (KernelVariant, Problem, cuda_body,
                                       get_variant, variants_for)

# An H100's dynamic shared memory per thread block (opt-in) and per SM, and
# its SM count: what the launchers read from the device at run time.
DEFAULT_SMEM_BUDGET = 232448
SMEM_PER_SM = 233472
H100_SMS = 132
# How closely a candidate's output must agree with the heuristic default's on
# the same operands (by activation dtype): the tolerances the kernels are held
# to against their plain versions (``chip_smoke.py`` phase 3).  The tunables
# change only the order of a reduction.
AGREE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Ring of operand copies a measurement replays: larger than the 50 MB L2.
L2_BYTES = 50e6
RING_TARGET_BYTES = 2 * L2_BYTES
RING_MAX = 128

_THREADS = 256            # gather bodies (demm_xwt_common.cuh kThreads)
_BULK_THREADS = 512       # bulk body
_BULK_HEAD = 128
_BULK_MAX_STAGES = 16
_TC_PAIR_SLOTS = 4
_TC_MAX_GROUPS = 3
_TC_MAX_K = 256


def _x_tile(n: int) -> int:
    """The activation tile of ``n`` rows: the smallest of 1, 2, 4, 8 that
    covers it (8 beyond)."""
    return next((t for t in (1, 2, 4, 8) if n <= t), 8)


def _tile_of(p: Problem) -> int:
    """The x (or B) tile the launch takes: the widest with duplicates."""
    return 8 if p.duplicates else _x_tile(p.rows)


def _cl_auto_csize(rb: int, a_max: int) -> int:
    c = 2
    while c < 8 and rb * c < H100_SMS:
        c <<= 1
    return min(c, a_max)


# ---- the tiled body's accounting (csrc/demm_spmm_tc.cuh) ------------------

def _tc_pair_cols(n: int, elem: int) -> int:
    per16 = 16 // elem
    return (n + 2 * per16 - 2) // per16 * per16


def _tc_smem(bn, wgs, kst, stages, ng, ne, vb) -> int:
    pair_slot = 64 * wgs * (_tc_pair_cols(ng * ne, vb) * vb
                            + _tc_pair_cols(ng * ne, 4) * 4)
    return (1024 + stages * ((bn // 64) * kst * 128 + 64 * wgs * kst * 2)
            + _TC_PAIR_SLOTS * pair_slot + (2 * stages + _TC_PAIR_SLOTS) * 8)


def _tc_kst(m: int, ng: int) -> int:
    return -(-m // 16) * 16 if ng == 1 else ng * m


def _tc_plan(p: Problem, params: Dict[str, int], budget: int):
    """(tile_n, warpgroups, groups per stage, K rows per stage, stages) as
    the launcher picks them (``tc_auto_tile`` / ``tc_auto_groups`` /
    ``tc_auto_stages``); stages 0 when not even two fit."""
    _, m, _ = p.sparsity
    ne, g, vb = p.cfg.n_effective, p.groups, p.v_bytes
    bn, wgs = params.get("tile_n"), params.get("warpgroups")
    if not bn or not wgs:
        auto = (128, 1)
        for t_bn, t_wgs in ((256, 2), (128, 2), (256, 1), (128, 1)):
            tiles = -(-p.out // (64 * t_wgs)) * -(-p.rows // t_bn)
            if tiles >= H100_SMS:
                auto = (t_bn, t_wgs)
                break
        bn, wgs = bn or auto[0], wgs or auto[1]
    stages = params.get("stages") or 0
    tiles = -(-p.out // (64 * wgs)) * -(-p.rows // bn)
    ng = 1
    if not (m % 16 or (bn == 128 and wgs == 1 and tiles > H100_SMS)):
        want = stages or 2
        while (ng < g and ng < _TC_MAX_GROUPS and (ng + 1) * m <= _TC_MAX_K
               and _tc_pair_cols((ng + 1) * ne, 2) <= 256
               and _tc_smem(bn, wgs, (ng + 1) * m, want, ng + 1, ne,
                            vb) <= budget):
            ng += 1
    kst = _tc_kst(m, ng)
    if not stages:
        fallback = 0
        for s in (4, 3, 2):
            need = _tc_smem(bn, wgs, kst, s, ng, ne, vb)
            if need > budget:
                continue
            fallback = fallback or s
            if wgs == 2 or bn == 256 or 2 * (need + 1024) <= SMEM_PER_SM:
                stages = s
                break
        stages = stages or fallback
    return bn, wgs, ng, kst, stages


def _block_gather_smem(p: Problem, a_max: int, cd: int, budget: int) -> int:
    _, m, _ = p.sparsity
    bt = 8 if p.duplicates else _x_tile(cd)
    red = _THREADS * bt * 4
    slot = m * bt * p.x_bytes

    def tile(c):
        return -(-c * slot // 16) * 16

    half = budget // 2
    if half < tile(1) + red:
        half = budget
    chunk = max(1, (half - red - 16) // slot)
    return tile(min(chunk, a_max)) + red


def smem_bytes(problem: Problem, variant: str,
               params: Dict[str, int],
               budget: int = DEFAULT_SMEM_BUDGET) -> int:
    """Dynamic shared memory (bytes) one thread block of the candidate asks
    for, counted as its launcher counts it (``demm_xwT.xwt_body_of``:
    ``BULK_SMEM_BYTES``, the x tile, the rows of pairs in flight; the
    stage plans of ``csrc/demm_xwt_bulk.cuh::bulk_plan``,
    ``demm_block_cluster.cuh::cl_plan``, ``demm_spmm_tc.cuh::tc_smem_bytes``
    and the gather bodies' staging).  Where the launcher would refuse for
    want of room, the least it would need — which exceeds ``budget``.  The
    plain version and measure-only repacks count 0."""
    p = problem
    if variant != "cuda":
        return 0
    _, m, _ = p.sparsity
    ne, g = p.cfg.n_effective, p.groups
    body = cuda_body(p)
    if body == "bulk":
        scale_row = 4 * g if p.quantized and p.group_scales else 0
        row_bytes = g * ne * (p.v_bytes + 4) + scale_row
        fixed = _BULK_HEAD + -(-p.k // 16) * 16 * _tile_of(p) * p.x_bytes
        if fixed + 2 * row_bytes > budget:
            return fixed + 2 * row_bytes
        avail = budget - fixed
        rows = min(params.get("rows_per_block") or -(-p.out // H100_SMS),
                   p.out)
        chunks = params.get("chunks") or 0
        per = min(-(-rows // chunks) if chunks > 0 else rows, rows)
        if per * _BULK_MAX_STAGES < rows:
            per = -(-rows // _BULK_MAX_STAGES)
        nchunks = -(-rows // per)
        stages = nchunks
        if nchunks * per * row_bytes > avail:            # a ring
            if 2 * per * row_bytes > avail:
                per = avail // (2 * row_bytes)
            nchunks = -(-rows // per)
            stages = min(avail // (per * row_bytes), _BULK_MAX_STAGES,
                         nchunks)
        return fixed + stages * per * row_bytes
    if body == "cluster":
        bt = 8 if p.duplicates else _x_tile(p.rows)
        lanes = _THREADS // p.block_r
        fixed = 16 + ((lanes + 1) * p.block_r * bt + 8) * 4
        cs = params.get("cluster_size") or _cl_auto_csize(
            p.out // p.block_r, p.a_max)
        per_cta = -(-p.a_max // max(1, cs))
        slot = (p.block_r * ne * (p.v_bytes + 4)
                + (p.block_r * 4 if p.quantized else 0))
        x_slot = p.rows * m * p.x_bytes
        whole = fixed + per_cta * (slot + x_slot)
        if whole <= budget:
            return whole
        if fixed + 2 * slot + x_slot > budget:
            return fixed + 2 * slot + x_slot
        chunk = (budget - fixed) // (2 * slot + x_slot)
        return fixed + chunk * (2 * slot + x_slot)
    if body == "tiled":
        bn, wgs, ng, kst, stages = _tc_plan(p, params, budget)
        return _tc_smem(bn, wgs, kst, stages or 2, ng, ne, p.v_bytes)
    if p.op in ("xwT", "xwT_q8"):
        group_bytes = m * _tile_of(p) * p.x_bytes
        if group_bytes > budget:
            return group_bytes
        return min(g, budget // group_bytes) * group_bytes
    if p.op == "spmm":              # K2's gather body, identity stream
        return _block_gather_smem(p, g, p.rows, budget)
    return _block_gather_smem(p, p.a_max, p.rows, budget)


def geometry_refusal(problem: Problem, variant: str,
                     params: Dict[str, int]) -> Optional[str]:
    """Why the launcher would refuse the candidate's launch geometry, or
    ``None``: the checks the C launchers make on a tunable before they
    launch."""
    p = problem
    rows = params.get("rows_per_block")
    if rows is not None and rows < 1:
        return f"rows_per_block {rows} < 1"
    if variant == "block_spmm":
        br = params.get("block_r", 128)
        return (None if br >= 1 and p.out % min(br, p.out) == 0
                else f"block_r {br} does not divide R = {p.out}")
    if variant != "cuda":
        return None
    body = cuda_body(p)
    cs = params.get("cluster_size")
    if cs is not None and not 1 <= cs <= 8:
        return f"cluster_size {cs} outside 1-8 (an H100 cluster)"
    if (rows is not None and body == "gather"
            and p.op not in ("xwT", "xwT_q8")
            and (rows > _THREADS or _THREADS % rows)):
        return f"rows_per_block {rows} does not divide {_THREADS} threads"
    if params.get("chunks", 1) < 1:
        return f"chunks {params['chunks']} < 1"
    if params.get("lanes", 8) not in (8, 16):
        return f"lanes {params['lanes']} not 8 or 16"
    if params.get("tile_n", 128) not in (128, 256):
        return f"tile_n {params['tile_n']} not 128 or 256"
    if params.get("warpgroups", 1) not in (1, 2):
        return f"warpgroups {params['warpgroups']} not 1 or 2"
    if not 2 <= params.get("stages", 2) <= 4:
        return f"stages {params['stages']} outside 2-4"
    return None


# ---- ranking ---------------------------------------------------------------

_HBM_BYTES_PER_US = 3.35e6                  # 3.35 TB/s
_SM_HBM = _HBM_BYTES_PER_US / H100_SMS      # an SM's share
_SM_L2 = 3 * _SM_HBM                        # L2 reads, about 3x HBM's rate
_PASS_US = 0.5                              # a pass: barrier + shuffle tree
_LAUNCH_US = 2.0


def estimate_us(problem: Problem, params: Dict[str, int]) -> float:
    """First-order H100 model used to rank candidates of one body (not a
    prediction of their time): every SM streams its thread blocks' packed
    bytes from device memory at its share of 3.35 TB/s and their staged
    activations from L2 at three times that, one wave of resident blocks
    after another; each block also pays 0.5 us per pass of its threads over
    its rows (a barrier and a shuffle tree), overlapped across the blocks
    resident on an SM; plus 2 us of launch.  So it penalises a last wave
    that leaves SMs idle, blocks that restage x, and passes — what the
    tunables trade against each other.  The packed bytes per row are G·Ne
    (value + 4-byte index) bytes."""
    p = problem
    _, m, _ = p.sparsity
    ne, g = p.cfg.n_effective, p.groups
    row_bytes = g * ne * (p.v_bytes + 4)
    body = cuda_body(p)
    resident = 1
    if body == "bulk":
        rows = min(params.get("rows_per_block")
                   or -(-p.out // H100_SMS), p.out)
        ctas = -(-p.out // rows)
        chunks = params.get("chunks") or 1
        chunk_rows = -(-rows // chunks)
        lanes = params.get("lanes") or (8 if chunk_rows > 32 else 16)
        passes = chunks * -(-chunk_rows // (_BULK_THREADS // lanes))
        w_bytes, x_bytes = rows * row_bytes, p.k * _tile_of(p) * p.x_bytes
    elif body == "cluster":
        rb = p.out // p.block_r
        cs = params.get("cluster_size") or _cl_auto_csize(rb, p.a_max)
        ctas = rb * cs
        per_cta = -(-p.a_max // cs)
        w_bytes = p.block_r * per_cta * ne * (p.v_bytes + 4)
        x_bytes = per_cta * m * p.rows * p.x_bytes
        passes = 1 + cs                     # compute, DSMEM reduction
    elif body == "tiled":
        bn, wgs, ng, kst, stages = _tc_plan(p, params, DEFAULT_SMEM_BUDGET)
        ctas = -(-p.out // (64 * wgs)) * -(-p.rows // bn)
        w_bytes = 64 * wgs * row_bytes
        x_bytes = p.k * bn * p.x_bytes
        # the producer places each group's pairs once per column tile
        passes = -(-g // ng) * (1 + 2 / max(stages, 2)) * 0.1 * wgs
        resident = 2 if (bn == 128 and wgs == 1) else 1
    elif p.op in ("xwT", "xwT_q8"):
        bt = _tile_of(p)
        smem = smem_bytes(p, "cuda", params)
        resident = max(1, min(4, DEFAULT_SMEM_BUDGET // max(smem, 1)))
        # the launcher's auto_rows_per_block: whole warps' worth of rows
        rows = params.get("rows_per_block") or 8 * -(
            -p.out // (8 * H100_SMS * resident))
        ctas = -(-p.out // rows) * -(-p.rows // bt)
        w_bytes, x_bytes = rows * row_bytes, p.k * bt * p.x_bytes
        passes = -(-rows // (_THREADS // 32))
    else:                                   # block gather (and K5 narrow)
        a_max = p.a_max or g
        block_r = p.block_r or p.out
        bt = 8 if p.duplicates else _x_tile(p.rows)
        rows = params.get("rows_per_block") or 32   # auto_block_rows, most
        ctas = (p.out // block_r) * -(-block_r // rows) * -(-p.rows // bt)
        w_bytes = rows * a_max * ne * (p.v_bytes + 4)
        x_bytes = a_max * m * bt * p.x_bytes
        passes = -(-a_max // max(1, _THREADS // rows))
        resident = 2
    per_sm = -(-ctas // H100_SMS)
    return (per_sm * (w_bytes / _SM_HBM + x_bytes / _SM_L2)
            + -(-per_sm // resident) * passes * _PASS_US + _LAUNCH_US)


# ---- measurement -----------------------------------------------------------

def ring_size(nbytes: int, target: float = RING_TARGET_BYTES) -> int:
    """Copies of ``nbytes`` of operands that exceed L2 (at least 2)."""
    return int(min(RING_MAX, max(2, math.ceil(target / max(nbytes, 1)))))


def operand_ring(tensors: Sequence[Optional[torch.Tensor]]) -> List[tuple]:
    """Copies of ``tensors`` enough to exceed L2 (CUDA), or the tensors
    themselves once (CPU).  ``None`` entries stay ``None``."""
    present = [t for t in tensors if t is not None]
    if not present or not present[0].is_cuda:
        return [tuple(tensors)]
    copies = ring_size(sum(t.nbytes for t in present))
    return [tuple(None if t is None else t.clone() for t in tensors)
            for _ in range(copies)]


def measure(calls: Sequence[Callable[[], torch.Tensor]], *,
            warmup: int = 1, iters: int = 5) -> float:
    """Seconds per call.

    CUDA (the calls' first result lies on a CUDA device): ``warmup`` eager
    passes on a side stream, then the whole ring captured once into a CUDA
    graph (``serve_loop.capture_graph``: the garbage collector held off) and
    replayed ``iters`` times between CUDA events; the least replay over the
    number of calls.  The device runs the launches back to back, each on
    its own operand copies, so this is device time per launch as a serving
    replay sees it.  CPU: ``warmup`` calls, then the least of ``iters``
    wall-time measurements of one call."""
    if not calls:
        raise ValueError("nothing to measure")
    first = calls[0]()
    if not first.is_cuda:
        for _ in range(max(0, warmup - 1)):
            first = calls[0]()
        best = float("inf")
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            calls[0]()
            best = min(best, time.perf_counter() - t0)
        return best
    from repro_torch.serve.serve_loop import capture_graph

    device = first.device
    del first

    def ring():
        out = None
        for c in calls:
            out = c()
        return out

    graph, _ = capture_graph(ring, [], device, warmup=max(1, warmup))
    graph.replay()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(1, iters)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / len(calls))
    del graph
    return best


@dataclasses.dataclass
class Candidate:
    backend: str
    params: Dict[str, int]
    smem: int = 0
    est_us: Optional[float] = None
    measured_s: Optional[float] = None
    # pruned_geometry | pruned_smem | pruned_rank | measured | refused
    status: str = "enumerated"
    note: str = ""

    def row(self) -> dict:
        return {"backend": self.backend, "params": dict(self.params),
                "smem_bytes": self.smem, "est_us": self.est_us,
                "measured_us": (None if self.measured_s is None
                                else self.measured_s * 1e6),
                "status": self.status, "note": self.note}


@dataclasses.dataclass
class TuneResult:
    problem: Problem
    best: TunedConfig
    candidates: List[Candidate]

    @property
    def best_us(self) -> float:
        return self.best.measured_us

    @property
    def default(self) -> Candidate:
        """The dispatchable heuristic default's measured candidate."""
        d = heuristic_default(self.problem)
        return next(c for c in self.candidates if c.backend == d.backend
                    and c.params == d.params and c.status == "measured")

    def table(self) -> List[dict]:
        return [c.row() for c in self.candidates]


def _param_grid(variant: KernelVariant, problem: Problem) -> List[Dict]:
    space = variant.param_space(problem)
    default = variant.default_params(problem)
    if not space:
        return [default]
    names = sorted(space)
    out = [dict(zip(names, vals))
           for vals in itertools.product(*(space[n] for n in names))]
    if default not in out:
        out.append(default)
    return out


def enumerate_candidates(problem: Problem,
                         include_measure_only: bool = True) -> List[Candidate]:
    return [Candidate(backend=v.name, params=params)
            for v in variants_for(problem.op, problem,
                                  include_measure_only=include_measure_only)
            for params in _param_grid(v, problem)]


def prune_candidates(problem: Problem, cands: List[Candidate], *,
                     smem_budget: int = DEFAULT_SMEM_BUDGET,
                     max_measure: int = 8) -> List[Candidate]:
    """Launch-geometry and shared-memory checks, then the ranking of
    :func:`estimate_us`; keeps the defaults of each variant unconditionally
    so tuned-against-default is always a measured pair."""
    defaults = {v.name: v.default_params(problem)
                for v in variants_for(problem.op, problem,
                                      include_measure_only=True)}
    survivors = []
    for c in cands:
        reason = geometry_refusal(problem, c.backend, c.params)
        if reason is not None:
            c.status, c.note = "pruned_geometry", reason
            continue
        c.smem = smem_bytes(problem, c.backend, c.params, smem_budget)
        if c.smem > smem_budget:
            c.status = "pruned_smem"
            c.note = f"{c.smem} bytes of shared memory > {smem_budget}"
            continue
        c.est_us = (estimate_us(problem, c.params)
                    if c.params and c.backend == "cuda" else None)
        survivors.append(c)
    keep = [c for c in survivors if defaults.get(c.backend) == c.params]
    rest = sorted((c for c in survivors if c not in keep),
                  key=lambda c: (c.est_us is None, c.est_us or 0.0))
    limit = max(max_measure, len(keep))
    for c in rest:
        if len(keep) < limit:
            keep.append(c)
        else:
            c.status = "pruned_rank"
    return keep


def _check_not_capturing():
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "autotune inside a CUDA-graph capture: measure before the "
            "engine captures (backend='auto' only looks up at dispatch)")


def _check_output(problem: Problem, c: Candidate, got: torch.Tensor,
                  want: Optional[torch.Tensor]) -> None:
    """Raise unless ``c``'s output ``got`` agrees with the heuristic
    default's ``want`` (:data:`AGREE_TOL`) and, for a ``cuda`` candidate on
    the card, unless its launcher asked for the shared memory
    :func:`smem_bytes` counted."""
    from repro_torch.tune.cache import problem_key

    what = f"{c.backend}{c.params} on {problem_key(problem)}"
    if c.backend == "cuda" and got.is_cuda:
        from repro_torch.kernels._build import last_launch_smem

        counted = smem_bytes(problem, c.backend, c.params)
        launched = last_launch_smem()
        if launched != counted:
            raise RuntimeError(
                f"autotune: smem_bytes counts {counted} bytes for {what}; "
                f"its launcher asked for {launched}: the model of the "
                "launchers' plans has drifted from csrc/")
    if want is None:
        return
    tol = AGREE_TOL.get(problem.dtype, AGREE_TOL["float32"])
    if got.shape != want.shape or not torch.allclose(got, want, **tol):
        err = (float((got - want).abs().max()) if got.shape == want.shape
               else f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
        raise RuntimeError(f"autotune: {what} disagrees with the heuristic "
                           f"default's output: max abs err {err} ({tol})")


def _autotune(problem: Problem,
              make_calls: Callable[[Candidate], List[Callable]],
              *, smem_budget: int, max_measure: int, warmup: int, iters: int,
              cache: Optional[TuneCache], persist: bool) -> TuneResult:
    from repro_torch import obs
    from repro_torch.kernels.demm_xwT import LaunchRefused

    _check_not_capturing()
    m = obs.metrics()
    measurements = m.counter("tune_autotune_measurements_total",
                             help="candidate kernels timed by autotune",
                             op=problem.op)
    cands = enumerate_candidates(problem)
    keep = prune_candidates(problem, cands, smem_budget=smem_budget,
                            max_measure=max_measure)
    default = heuristic_default(problem)

    def is_default(c):
        return c.backend == default.backend and c.params == default.params

    measure_only = {v.name for v in variants_for(
        problem.op, problem, include_measure_only=True) if v.measure_only}
    keep.sort(key=lambda c: not is_default(c))   # the others are held to it
    want = None
    for c in keep:
        try:
            calls = make_calls(c)
            out = calls[0]()
            _check_output(problem, c, out, None if is_default(c) else want)
            if is_default(c):
                want = out
            c.measured_s = measure(calls, warmup=warmup, iters=iters)
            c.status = "measured"
            measurements.inc()
        except LaunchRefused as e:   # refused before any launch: go on
            c.status, c.note = "refused", str(e)[:200]
            if is_default(c):
                raise RuntimeError(
                    f"autotune: the heuristic default of {problem} was "
                    f"refused: {e}") from e
        m.trace.event("autotune_measure", op=problem.op, backend=c.backend,
                      params=dict(c.params), status=c.status,
                      us=(None if c.measured_s is None
                          else c.measured_s * 1e6))
    measured = [c for c in keep if c.status == "measured"
                and c.backend not in measure_only]
    if not any(is_default(c) for c in measured):
        raise RuntimeError(f"autotune: the heuristic default "
                           f"{default.backend}{default.params} of {problem} "
                           "was not measured")
    best_c = min(measured, key=lambda c: c.measured_s)
    best = TunedConfig(backend=best_c.backend, params=dict(best_c.params),
                       measured_us=best_c.measured_s * 1e6, source="tuned")
    m.trace.event("autotune_select", op=problem.op, backend=best.backend,
                  params=dict(best.params), us=best.measured_us)
    cache = cache or default_cache()
    cache.put(problem, best, persist=persist)
    return TuneResult(problem=problem, best=best, candidates=cands)


def _dup(values, indices, duplicates):
    return (holds_duplicates(values, indices) if duplicates is None
            else bool(duplicates))


def autotune_xwT(x: torch.Tensor, values: torch.Tensor,
                 indices: torch.Tensor, cfg: SparsityConfig,
                 w_shape: Tuple[int, int], *,
                 duplicates: Optional[bool] = None,
                 smem_budget: int = DEFAULT_SMEM_BUDGET, max_measure: int = 8,
                 warmup: int = 1, iters: int = 5,
                 cache: Optional[TuneCache] = None,
                 persist: bool = True, shards: int = 1) -> TuneResult:
    """Tune ``y = x @ W_sparseᵀ`` for the concrete operands given, on their
    device.  ``duplicates`` (default: whether the operands hold any,
    ``holds_duplicates``) is what every candidate launches with; ``shards``
    keys a shard-local problem."""
    dup = _dup(values, indices, duplicates)
    problem = Problem.for_xwT(x.shape, w_shape, cfg, x.dtype, x.device,
                              duplicates=dup, shards=shards,
                              value_bytes=values.element_size())
    ring = operand_ring((values, indices))

    def make_calls(c: Candidate):
        v = get_variant("xwT", c.backend)
        return [lambda vv=vv, ii=ii: v.call(x, vv, ii, cfg, tuple(w_shape),
                                            duplicates=dup, **c.params)
                for vv, ii in ring]

    return _autotune(problem, make_calls, smem_budget=smem_budget,
                     max_measure=max_measure, warmup=warmup, iters=iters,
                     cache=cache, persist=persist)


def autotune_xwT_q8(x: torch.Tensor, values: torch.Tensor,
                    indices: torch.Tensor, scales: torch.Tensor,
                    cfg: SparsityConfig, w_shape: Tuple[int, int], *,
                    duplicates: Optional[bool] = None,
                    smem_budget: int = DEFAULT_SMEM_BUDGET,
                    max_measure: int = 8, warmup: int = 1, iters: int = 5,
                    cache: Optional[TuneCache] = None,
                    persist: bool = True, shards: int = 1) -> TuneResult:
    """Tune ``y = x @ W_q8ᵀ`` (int8 values + scales (O,) or (O, G)); keyed
    under the distinct ``xwT_q8`` op so float entries are never shadowed;
    ``shards`` keys a shard-local problem."""
    dup = _dup(values, indices, duplicates)
    problem = Problem.for_xwT(x.shape, w_shape, cfg, x.dtype, x.device,
                              quantized=True, duplicates=dup, shards=shards,
                              group_scales=scales.ndim == 2)
    ring = operand_ring((values, indices, scales))

    def make_calls(c: Candidate):
        v = get_variant("xwT_q8", c.backend)
        return [lambda vv=vv, ii=ii, ss=ss: v.call(
            x, vv, ii, ss, cfg, tuple(w_shape), duplicates=dup, **c.params)
            for vv, ii, ss in ring]

    return _autotune(problem, make_calls, smem_budget=smem_budget,
                     max_measure=max_measure, warmup=warmup, iters=iters,
                     cache=cache, persist=persist)


def autotune_xwT_block(x: torch.Tensor, pw, *,
                       smem_budget: int = DEFAULT_SMEM_BUDGET,
                       max_measure: int = 8, warmup: int = 1, iters: int = 5,
                       cache: Optional[TuneCache] = None,
                       persist: bool = True) -> TuneResult:
    """Tune ``y = x @ Wᵀ`` for a block-layout
    :class:`~repro_torch.core.sparsity.PackedWeight` (geometry, pattern,
    quantization and duplicates come from the weight — a quantized node
    tunes the ``xwT_block_q8`` op)."""
    problem = Problem.for_xwT_block(x.shape, pw, x.dtype, x.device)
    cfg, w_shape, dup = pw.cfg, tuple(pw.dense_shape), pw.has_duplicates
    ring = operand_ring((pw.values, pw.indices, pw.active_groups, pw.scales))

    def make_calls(c: Candidate):
        v = get_variant(problem.op, c.backend)
        return [lambda ops=ops: v.call(
            x, *(t for t in ops if t is not None), cfg, w_shape,
            duplicates=dup, **c.params) for ops in ring]

    return _autotune(problem, make_calls, smem_budget=smem_budget,
                     max_measure=max_measure, warmup=warmup, iters=iters,
                     cache=cache, persist=persist)


def autotune_spmm(values: torch.Tensor, indices: torch.Tensor,
                  b: torch.Tensor, cfg: SparsityConfig,
                  a_shape: Tuple[int, int], *,
                  duplicates: Optional[bool] = None,
                  smem_budget: int = DEFAULT_SMEM_BUDGET, max_measure: int = 8,
                  warmup: int = 1, iters: int = 5,
                  cache: Optional[TuneCache] = None,
                  persist: bool = True) -> TuneResult:
    """Tune ``C = A_sparse @ B`` for the concrete operands given.  The
    measure-only ``block_spmm`` candidates repack A on the host before their
    window (``KernelVariant.prepare``); only their K2 launches are timed."""
    dup = _dup(values, indices, duplicates)
    problem = Problem.for_spmm(a_shape, b.shape, cfg, b.dtype, b.device,
                               duplicates=dup,
                               value_bytes=values.element_size())

    ring = operand_ring((values, indices))

    def make_calls(c: Candidate):
        v = get_variant("spmm", c.backend)
        if v.prepare is not None:
            ops, launch = v.prepare(values, indices, b, cfg, tuple(a_shape),
                                    duplicates=dup, **c.params)
            return [lambda o=o: launch(*o) for o in operand_ring(ops)]
        return [lambda vv=vv, ii=ii: v.call(vv, ii, b, cfg, tuple(a_shape),
                                            duplicates=dup, **c.params)
                for vv, ii in ring]

    return _autotune(problem, make_calls, smem_budget=smem_budget,
                     max_measure=max_measure, warmup=warmup, iters=iters,
                     cache=cache, persist=persist)
