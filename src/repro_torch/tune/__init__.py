"""``repro_torch.tune`` — kernel registry, autotuner, and dispatch cache.

The software analogue of the paper's DeMM(N, M, C, k) reconfiguration: the
engine wins by matching its datapath shape to the sparsity pattern, and the
CUDA kernels win by matching their tunables (rows per thread block, row
chunks, slot lanes, cluster size, tile and stages) to the (shape, dtype,
N:M pattern, platform) instance.  This package owns that choice:

  * :mod:`repro_torch.tune.registry` — registered kernel variants + the
    tunables of each CUDA body.
  * :mod:`repro_torch.tune.autotune` — enumerate → shared-memory / geometry
    prune → rank → measure on CUDA-graph replays → select and persist.
  * :mod:`repro_torch.tune.cache`    — JSON-persistent (op, shapes, dtype,
    pattern, platform) → (backend, params) cache with heuristic fallback.

``kernels/ops.py`` resolves ``backend="auto"`` through :func:`resolve_xwT`
and its siblings: a pure cache/heuristic lookup on static shapes, run at the
warm-up step and at the capture of an engine's programs, never at a replay.
Measurement happens only in explicit ``autotune_*`` calls (an engine built
with ``autotune=True``, ``launch/serve.py --autotune``,
``benchmarks/torch_kernel_bench.py --autotune``), whose results persist for
later processes.
"""

from __future__ import annotations

from repro_torch.core.sparsity import SparsityConfig
from repro_torch.tune.autotune import (
    DEFAULT_SMEM_BUDGET,
    Candidate,
    TuneResult,
    autotune_spmm,
    autotune_xwT,
    autotune_xwT_block,
    autotune_xwT_q8,
    enumerate_candidates,
    estimate_us,
    geometry_refusal,
    measure,
    prune_candidates,
    smem_bytes,
)
from repro_torch.tune.cache import (
    TuneCache,
    TunedConfig,
    default_cache,
    heuristic_default,
    problem_key,
    set_default_cache,
)
from repro_torch.tune.registry import (
    OPS,
    KernelVariant,
    Problem,
    backend_names,
    cuda_body,
    get_variant,
    platform_of,
    register_variant,
    variants_for,
)

__all__ = [
    "DEFAULT_SMEM_BUDGET", "OPS", "Candidate", "KernelVariant", "Problem",
    "TuneCache", "TuneResult", "TunedConfig", "autotune_packed_tree",
    "autotune_spmm", "autotune_xwT", "autotune_xwT_block", "autotune_xwT_q8",
    "backend_names", "cuda_body", "default_cache", "enumerate_candidates",
    "estimate_us", "geometry_refusal", "get_variant", "heuristic_default",
    "measure", "platform_of", "problem_key", "prune_candidates",
    "register_variant", "resolve_spmm", "resolve_xwT", "resolve_xwT_block",
    "resolve_xwT_q8", "set_default_cache", "smem_bytes", "variants_for",
]


def _dispatchable(p: Problem) -> TunedConfig:
    """The cache's answer for ``p``, held to what the problem's platform may
    dispatch: an entry naming a variant that does not support it (a
    ``reference`` entry for a CUDA problem, edited in by hand) raises — the
    plain version never runs on a CUDA tensor."""
    choice = default_cache().resolve(p)
    v = get_variant(p.op, choice.backend)
    if v.measure_only or not v.supported(p):
        raise RuntimeError(
            f"backend='auto' resolved {problem_key(p)} to {choice.backend!r}, "
            f"which does not dispatch on {p.platform!r}; fix or clear the "
            f"tuning cache ({default_cache().path})")
    return choice


def resolve_xwT(x_shape, w_shape, cfg: SparsityConfig, dtype,
                shards: int = 1, *, device=None,
                duplicates: bool = False) -> TunedConfig:
    """Static (backend, params) choice for ``backend="auto"`` xwT dispatch
    on ``device`` (the activations' device; ``None``: the CPU).  Never
    measures: tuning-cache hit or heuristic default."""
    return _dispatchable(Problem.for_xwT(x_shape, w_shape, cfg, dtype,
                                         device, shards=shards,
                                         duplicates=duplicates))


def resolve_xwT_q8(x_shape, w_shape, cfg: SparsityConfig, dtype,
                   shards: int = 1, *, device=None,
                   duplicates: bool = False) -> TunedConfig:
    """Static (backend, params) choice for ``backend="auto"`` dispatch of an
    int8-quantized xwT weight — its own ``xwT_q8`` cache key, so float and
    quantized tunings coexist.  Never measures."""
    return _dispatchable(Problem.for_xwT(x_shape, w_shape, cfg, dtype,
                                         device, quantized=True,
                                         shards=shards,
                                         duplicates=duplicates))


def resolve_spmm(a_shape, b_shape, cfg: SparsityConfig, dtype, *,
                 device=None, duplicates: bool = False) -> TunedConfig:
    """Static (backend, params) choice for ``backend="auto"`` spmm dispatch
    (the measure-only ``block_spmm`` is never the answer)."""
    return _dispatchable(Problem.for_spmm(a_shape, b_shape, cfg, dtype,
                                          device, duplicates=duplicates))


def resolve_xwT_block(x_shape, pw, dtype, *, device=None) -> TunedConfig:
    """Static (backend, params) choice for ``backend="auto"`` dispatch of a
    block-layout :class:`~repro_torch.core.sparsity.PackedWeight` — keyed by
    the full problem including the pack-time block geometry.  Never
    measures."""
    return _dispatchable(Problem.for_xwT_block(x_shape, pw, dtype, device))


def autotune_packed_tree(module, batch: int, dtype=None, *,
                         persist: bool = True, **tune_kw) -> dict:
    """Pre-tune every distinct packed-weight matmul shape under a module.

    Walks ``module`` for :class:`~repro_torch.core.sparsity.PackedWeight`
    nodes (as ``launch.pack_tree`` produces them) and runs
    :func:`autotune_xwT` / :func:`autotune_xwT_q8` (or
    :func:`autotune_xwT_block`, which covers float and quantized block
    nodes) once per distinct key — (O, K, pattern[, block geometry], qdtype,
    duplicates), all read from the node — with an activation batch of
    ``batch`` rows drawn with numpy from seed 0 on the node's device, so a
    later dispatch with ``backend="auto"`` resolves every layer from
    measured entries instead of heuristics.  Each node is measured with its
    own ``has_duplicates``.  ``dtype`` defaults to the activation dtype the
    projections receive: the module's ``cfg.compute_dtype`` (a
    ``DecoderLM``), else float32.  Every ring of operand copies is freed
    before this returns (call it before an engine captures anything).
    Returns {problem_key: TuneResult}.
    """
    import gc

    import numpy as np
    import torch

    from repro_torch.core.sparsity import (LAYOUT_BLOCK, PackedWeight,
                                           shard_slice)

    if dtype is None:
        cfg = getattr(module, "cfg", None)
        dtype = getattr(cfg, "compute_dtype", None) or "float32"
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    seen = {}

    def x_for(pw: PackedWeight, k: int):
        return torch.from_numpy(np.random.default_rng(0).standard_normal(
            (batch, k))).to(pw.values.device, dtype)

    for pw in (mod for mod in module.modules()
               if isinstance(mod, PackedWeight)):
        if pw.shard_axis is not None:
            # a renumbered weight runs its slices: tune the shard-local
            # problem (every slice shares its shapes and key)
            pw = shard_slice(pw, 0)
        o, k = pw.dense_shape
        dev = pw.values.device
        if pw.layout == LAYOUT_BLOCK:
            p = Problem.for_xwT_block((batch, k), pw, dtype, dev)
            key = problem_key(p)
            if key not in seen:
                seen[key] = autotune_xwT_block(x_for(pw, k), pw,
                                               persist=persist, **tune_kw)
            continue
        quant = pw.qdtype is not None
        p = Problem.for_xwT((batch, k), (o, k), pw.cfg, dtype, dev,
                            quantized=quant, shards=pw.shards,
                            duplicates=pw.has_duplicates)
        key = problem_key(p)
        if key in seen:
            continue
        if quant:
            seen[key] = autotune_xwT_q8(
                x_for(pw, k), pw.values, pw.indices, pw.scales, pw.cfg,
                (o, k), duplicates=pw.has_duplicates, persist=persist,
                shards=pw.shards, **tune_kw)
        else:
            seen[key] = autotune_xwT(
                x_for(pw, k), pw.values, pw.indices, pw.cfg, (o, k),
                duplicates=pw.has_duplicates, persist=persist,
                shards=pw.shards, **tune_kw)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return seen
