"""Cycle-accurate analytical performance models of the four engines the
paper evaluates: DeMM, S2TA, VEGETA, SPOTS.

This reproduces the paper's evaluation methodology: CNN layers are lowered to
im2col GEMMs ``C[R,P] = A_sparse[R,K] @ B[K,P]`` (A = weights, R = output
channels, K = Ci*kh*kw, P = output spatial positions), a *real* sparsity mask
is drawn per layer, and each engine's schedule is counted in cycles **from
the actual mask** (violations of an engine's native pattern cost extra
passes/cycles, exactly as the paper describes for rows exceeding 8:128).
All engines are resource-equalized at 512 multiply-add units (paper §III-A).

Modeling assumptions (documented per engine below; these are first-order
schedule models, not RTL):

* **DeMM(N, M, C, k)** — input-stationary.  For every (column-tile of C
  outputs) × (M-group of K): pre-load the M×C memory block through the single
  write port (M cycles), then stream the packed rows of A: a row with ``z``
  non-zeros in this group takes ``ceil(z / N)`` cycles (the k-reconfigured
  time-sharing of the N read ports; z <= kN native, arbitrary z still
  processed in consecutive cycles); rows with z = 0 are never streamed.
  A small pipeline drain (mult + log2(N) adder-tree stages) per group-tile.

* **VEGETA-S (32×16, weight-stationary, native ns:ms)** — each PE holds
  ``ns`` non-zeros covering an ``ms``-wide dense K-segment, so one array load
  covers 32*ms of K for 16 output channels.  A group with z > ns non-zeros
  forces ceil(z/ns) sequential passes for the whole tile (the array is
  bulk-synchronous).  Per pass: 32-cycle weight preload + P input columns +
  fill/drain skew of (32+16).

* **S2TA (output-stationary tensor array, DBB ns:ms, 8-MAC dot PEs)** —
  a 4×16 tensor-PE array (the paper's "S2TA-4×16×4_8×4") × 8 lanes =
  512 MACs computing a 4×16 (R×P) output tile with 8-deep dot units; the
  DBB stream covers 8 blocks of ms per cycle when the pattern holds, and a
  block with z > ns non-zeros costs ceil(z/ns) slots.  Successive tiles are
  pipelined; per-tile overhead is the output drain (4 cycles) only.

* **SPOTS (128×4, reconfigured as four 32×4 parallel blocks)** — systolic
  GEMM with zero-*group* skipping at contiguous 1×4 granularity along K,
  decided per row-pair lane (two 2-row lanes per 4-wide tile, synchronous:
  the tile streams the max of its lanes' compressed K).  The paper notes
  this skipping is ineffective for fine-grained N:M where no contiguous
  zero groups exist.  Per tile: 32-cycle preload + compressed input stream +
  (32+4) skew, four unit tiles in flight (LPT-balanced).

Calibration (DESIGN.md §7): with these parameters the
ResNet50 @95%-unstructured (≈8:128) comparison lands at 17.1 / 56.1 / 65.2 %
overall-latency improvement vs S2TA / VEGETA / SPOTS against the paper's
claimed 18 / 54 / 67 % — every engine within ~2 points without per-layer
fitting.  The free parameters are physical (tile shapes, buffer counts,
skew) and were set once, globally, from the engine descriptions.

The models are validated against the paper's headline claims in
``benchmarks/torch_fig6_resnet50.py`` and
``benchmarks/torch_fig8_finegrained.py``.

A copy of the JAX package's numpy-only model with its one import pointed
at this package: the masks are numpy draws in the same order, so every
cycle count equals the JAX package's bit for bit.  These are the paper's
modelled 512-MAC engines at 500 MHz, not a model of the H100.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import numpy as np

from repro_torch.core.sparsity import SparsityConfig

CLOCK_HZ = 500e6  # paper §III-B: all engines at 500 MHz


# ---------------------------------------------------------------------------
# Workloads: CNN layers as im2col GEMMs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmShape:
    name: str
    r: int       # output channels (rows of sparse A)
    k: int       # Ci * kh * kw (contraction)
    p: int       # output spatial positions (dense columns)
    count: int = 1   # how many identical layers in the network
    sparse: bool = True  # first conv / classifier often kept dense


def resnet50_gemms() -> list[GemmShape]:
    """ResNet50 @ 224×224 — every conv lowered to im2col GEMM."""
    out = [GemmShape("conv1_7x7", 64, 3 * 49, 112 * 112, 1, sparse=False)]
    # (stage, in_ch, mid_ch, out_ch, spatial, blocks)
    stages = [
        ("conv2", 64, 64, 256, 56, 3),
        ("conv3", 256, 128, 512, 28, 4),
        ("conv4", 512, 256, 1024, 14, 6),
        ("conv5", 1024, 512, 2048, 7, 3),
    ]
    for name, cin, mid, cout, hw, blocks in stages:
        p = hw * hw
        # first block: 1x1 reduce from cin, others from cout
        out.append(GemmShape(f"{name}_b0_1x1a", mid, cin, p))
        out.append(GemmShape(f"{name}_1x1a", mid, cout, p, count=blocks - 1))
        out.append(GemmShape(f"{name}_3x3", mid, mid * 9, p, count=blocks))
        out.append(GemmShape(f"{name}_1x1b", cout, mid, p, count=blocks))
        out.append(GemmShape(f"{name}_proj", cout, cin, p))  # downsample proj
    out.append(GemmShape("fc", 1000, 2048, 1, sparse=False))
    return out


def convnext_t_gemms() -> list[GemmShape]:
    """ConvNeXt-T @ 224×224 — stem, downsamples, and per-block
    dwconv7x7 (grouped; modeled per-channel) + pw expand/reduce."""
    dims = [96, 192, 384, 768]
    depths = [3, 3, 9, 3]
    hw = [56, 28, 14, 7]
    out = [GemmShape("stem_4x4", 96, 3 * 16, 56 * 56, 1, sparse=False)]
    for s, (d, n, h) in enumerate(zip(dims, depths, hw)):
        p = h * h
        # depthwise 7x7: per-channel 1×49 dot; modeled as GEMM R=d, K=49
        # with block-diagonal semantics (weights sparse-prunable).
        out.append(GemmShape(f"s{s}_dw7x7", d, 49, p, count=n))
        out.append(GemmShape(f"s{s}_pw_up", 4 * d, d, p, count=n))
        out.append(GemmShape(f"s{s}_pw_down", d, 4 * d, p, count=n))
        if s < 3:
            out.append(GemmShape(f"s{s}_down_2x2", dims[s + 1], d * 4,
                                 hw[s + 1] * hw[s + 1]))
    out.append(GemmShape("head", 1000, 768, 1, sparse=False))
    return out


# ---------------------------------------------------------------------------
# Mask generators
# ---------------------------------------------------------------------------

def unstructured_mask(rng: np.random.Generator, r: int, k: int,
                      sparsity: float) -> np.ndarray:
    """RigL-style unstructured mask at a given sparsity (uniform placement —
    the paper's 95% ResNet50 workload; ERK reweighting is a second-order
    effect for schedule counting)."""
    return rng.random((r, k)) > sparsity


def nm_mask(rng: np.random.Generator, r: int, k: int, n: int, m: int,
            ) -> np.ndarray:
    """Exact fine-grained N:M mask (n non-zeros per m-block, random slots)."""
    g = math.ceil(k / m)
    mask = np.zeros((r, g, m), bool)
    scores = rng.random((r, g, m))
    idx = np.argsort(-scores, axis=-1)[..., :n]
    np.put_along_axis(mask, idx, True, axis=-1)
    return mask.reshape(r, g * m)[:, :k]


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _pad_groups(mask: np.ndarray, m: int) -> np.ndarray:
    """(R, K) -> (R, G, m) with zero padding."""
    r, k = mask.shape
    g = math.ceil(k / m)
    padded = np.zeros((r, g * m), bool)
    padded[:, :k] = mask
    return padded.reshape(r, g, m)


class Engine:
    name: str = "engine"
    macs: int = 512

    def gemm_cycles(self, shape: GemmShape, mask: np.ndarray) -> int:
        raise NotImplementedError

    def network_cycles(self, gemms: Iterable[GemmShape],
                       mask_fn: Callable[[GemmShape], np.ndarray]) -> dict:
        per_layer = {}
        for s in gemms:
            mask = (np.ones((s.r, s.k), bool) if not s.sparse
                    else mask_fn(s))
            per_layer[s.name] = self.gemm_cycles(s, mask) * s.count
        return per_layer


@dataclasses.dataclass
class DeMMEngine(Engine):
    """DeMM(N, M, C, k) — paper §II; input-stationary."""

    n: int = 8
    m: int = 128
    c: int = 64
    k: int = 8
    pipe: int = 6  # read + multiply + ceil(log2(N)) adder stages + writeback

    def __post_init__(self):
        self.name = f"DeMM({self.n},{self.m},{self.c},{self.k})"

    def gemm_cycles(self, shape: GemmShape, mask: np.ndarray) -> int:
        col_tiles = math.ceil(shape.p / self.c)
        groups = _pad_groups(mask, self.m)               # (R, G, M)
        nnz = groups.sum(-1)                              # (R, G)
        # ceil(z/N) cycles per row per group; z=0 rows are not streamed.
        row_cycles = -(-nnz // self.n)                    # ceil div, 0 -> 0
        per_group = self.m + row_cycles.sum(0) + self.pipe  # (G,)
        return int(col_tiles * per_group.sum())


@dataclasses.dataclass
class VegetaEngine(Engine):
    """VEGETA-S (32×16 weight-stationary) with native ns:ms support."""

    ns: int = 1
    ms: int = 16
    rows: int = 32
    cols: int = 16

    def __post_init__(self):
        self.name = f"VEGETA-S({self.ns}:{self.ms})"

    def gemm_cycles(self, shape: GemmShape, mask: np.ndarray) -> int:
        k_cov = self.rows * self.ms                       # K per array load
        groups = _pad_groups(mask, self.ms)               # (R, G, ms)
        nnz = groups.sum(-1)                              # (R, G)
        passes_rg = np.maximum(-(-nnz // self.ns), 1)     # per (row, group)
        g_per_tile = k_cov // self.ms                     # 32 groups per load
        gtot = nnz.shape[1]
        total = 0
        for kt in range(math.ceil(gtot / g_per_tile)):
            gsl = slice(kt * g_per_tile, min((kt + 1) * g_per_tile, gtot))
            for rt in range(math.ceil(shape.r / self.cols)):
                rsl = slice(rt * self.cols, min((rt + 1) * self.cols, shape.r))
                passes = int(passes_rg[rsl, gsl].max())
                total += passes * (self.rows + shape.p + self.rows + self.cols)
        return total


@dataclasses.dataclass
class S2TAEngine(Engine):
    """S2TA output-stationary tensor array with DBB ns:ms, 8-MAC dot PEs."""

    ns: int = 1
    ms: int = 16
    tile_r: int = 4
    tile_p: int = 16
    lanes: int = 8   # blocks processed per cycle when pattern holds
    drain: int = 4

    def __post_init__(self):
        self.name = f"S2TA({self.ns}:{self.ms})"

    def gemm_cycles(self, shape: GemmShape, mask: np.ndarray) -> int:
        groups = _pad_groups(mask, self.ms)
        nnz = groups.sum(-1)                              # (R, G)
        slots_rg = np.maximum(-(-nnz // self.ns), 1)      # DBB slots per block
        gtot = nnz.shape[1]
        total = 0
        p_tiles = math.ceil(shape.p / self.tile_p)
        for rt in range(math.ceil(shape.r / self.tile_r)):
            rsl = slice(rt * self.tile_r, min((rt + 1) * self.tile_r, shape.r))
            # bulk-synchronous across the tile: slots = max over rows
            slots = slots_rg[rsl].max(0)                  # (G,)
            k_cycles = math.ceil(int(slots.sum()) / self.lanes)
            total += p_tiles * (k_cycles + self.drain)
        return total


@dataclasses.dataclass
class SpotsEngine(Engine):
    """SPOTS — 128×4 systolic GEMM as four parallel 32×4 blocks with
    contiguous zero-group skipping (1×4 groups along K, per row-pair lane)."""

    unit_rows: int = 32
    unit_cols: int = 4
    units: int = 4
    group: int = 4
    skip_rows: int = 2   # rows per skipping lane (2 lanes per 4-wide tile)

    def __post_init__(self):
        self.name = "SPOTS"

    def gemm_cycles(self, shape: GemmShape, mask: np.ndarray) -> int:
        groups = _pad_groups(mask, self.group)            # (R, G4, 4)
        any_nz = groups.any(-1)                           # (R, G4)
        tile_cycles = []
        for rt in range(math.ceil(shape.r / self.unit_cols)):
            rsl = slice(rt * self.unit_cols,
                        min((rt + 1) * self.unit_cols, shape.r))
            sub = any_nz[rsl]
            # a K-group is skipped per lane when all lane rows are zero
            # there; the tile's lanes are synchronous -> max over lanes.
            keffs = []
            for lr in range(0, sub.shape[0], self.skip_rows):
                lane = sub[lr:lr + self.skip_rows]
                keffs.append(int(lane.any(0).sum()) * self.group)
            k_eff = max(keffs) if keffs else 0
            k_tiles = max(1, math.ceil(k_eff / self.unit_rows))
            tile_cycles.append(
                k_tiles * (self.unit_rows + shape.p
                           + self.unit_rows + self.unit_cols))
        # four units run tiles in parallel
        tile_cycles = np.asarray(tile_cycles)
        per_unit = np.zeros(self.units)
        for c in np.sort(tile_cycles)[::-1]:              # LPT balance
            per_unit[per_unit.argmin()] += c
        return int(per_unit.max())


# ---------------------------------------------------------------------------
# Tile-ranking estimate (the JAX package's tuner ranks its tiles with it;
# the port's tuner ranks candidates with its own H100 model,
# ``repro_torch.tune.autotune.estimate_us``)
# ---------------------------------------------------------------------------

def demm_tile_cycles(r: int, k: int, p: int, cfg: SparsityConfig,
                     block_cols: int, seed: int = 0) -> int:
    """First-order cycle estimate of the software DeMM schedule for one
    GEMM ``C[r, p] = A_sparse[r, k] @ B[k, p]`` tiled at ``block_cols``
    output columns per step.

    This reuses :class:`DeMMEngine` with its column-tile width C set to the
    TPU kernel's output-column block (``block_c`` for spmm, ``block_b``
    for the xwT orientation): the engine's pre-load + stream count then
    mirrors that kernel's per-grid-step B-block residency and packed-row
    streaming.  The mask is a representative exact N:M draw at the config's
    density — the estimate ranks tile candidates, it does not predict wall
    time.
    """
    rng = np.random.default_rng(seed)
    mask = nm_mask(rng, r, k, cfg.n_effective, cfg.m)
    eng = DeMMEngine(n=cfg.n_effective, m=cfg.m, c=max(1, block_cols),
                     k=1)
    return eng.gemm_cycles(GemmShape("tile_est", r, k, p), mask)


# ---------------------------------------------------------------------------
# Experiment drivers (used by benchmarks/)
# ---------------------------------------------------------------------------

def PAPER_ENGINES_RELAXED():
    """The four §III-A designs, resource-equalized at 512 MACs.

    S2TA and VEGETA use the paper's "equivalent 1:16 density"; VEGETA-S-·-2's
    two weight buffers per PE make its effective violation-absorbing block
    2:32 (same density, double the per-pass flexibility).
    """
    return [
        DeMMEngine(8, 128, 64, 8),
        S2TAEngine(1, 16),
        VegetaEngine(2, 32),
        SpotsEngine(),
    ]


def FINEGRAINED_ENGINES(n: int, m: int):
    """Fig. 8 setup: VEGETA/S2TA configured natively at the workload's
    fine-grained n:m (their optimal conditions); DeMM(8,128,·,8) serves the
    same density via k-reconfiguration (n:m == (128//m*n):128)."""
    return [
        DeMMEngine(8, 128, 64, 8),
        S2TAEngine(n, m),
        VegetaEngine(n, m),
    ]


def run_network(engines, gemms, mask_fn, seed=0):
    """Returns {engine: {layer: cycles}} with a shared mask draw."""
    rng = np.random.default_rng(seed)
    masks = {}
    for s in gemms:
        masks[s.name] = (np.ones((s.r, s.k), bool) if not s.sparse
                         else mask_fn(rng, s))
    return {
        e.name: e.network_cycles(gemms, lambda s: masks[s.name])
        for e in engines
    }


def improvement(results: dict, ours: str, other: str) -> float:
    """Paper metric: 1 - latency(ours)/latency(other), overall network."""
    t_ours = sum(results[ours].values())
    t_other = sum(results[other].values())
    return 1.0 - t_ours / t_other
