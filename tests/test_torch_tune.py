"""``repro_torch.tune`` against the JAX package's ``repro.tune``, on the CPU.

* the registry: a ``"cuda"`` problem offers only the hand-written kernel, a
  ``"cpu"`` problem only the plain version; ``cuda_body`` agrees with the
  wrappers' own body rules; the measure-only ``block_spmm`` is measured and
  never dispatched;
* the pruner: ``smem_bytes`` grows with the tile, an oversize or
  ill-shaped candidate is pruned on a ``Problem(platform="cuda")`` built
  here, without a launch;
* the cache: round trip, schema invalidation, atomic save, the port's own
  default path; ``heuristic_default`` per platform; ``problem_key`` equal
  to ``repro.tune.problem_key`` letter for letter;
* ``autotune_packed_tree`` on a reduced stablelm_3b in the four serving
  modes yields the JAX package's set of keys (its measurement stubbed);
  refusals, faults and captures in the tuner;
* ``backend="auto"`` through ``ops``, both engines (tokens equal to the JAX
  engines' under ``auto``), ``launch.serve --autotune``, and the two bench
  scripts (``compare_bench.py`` and ``validate_metrics.py`` unchanged).

float32 compute where tokens are compared.  The card-only twins are in
``tests/test_torch_cuda.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.tune as jtune
import repro.tune.autotune as jautotune
from repro import obs as jobs
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro.core.sparsity import pack_block as jpack_block
from repro.launch.pack_tree import pack_tree as jpack_tree
from repro.launch.serve import run_serve as jax_run_serve

from _torch_port import jax_model_and_params, reduced_pair, to_torch_model
from repro_torch import obs as tobs
from repro_torch import tune
from repro_torch.core.sparsity import SparsityConfig, pack, pack_block, prune
from repro_torch.kernels import ops
from repro_torch.kernels.demm_xwT import LaunchRefused
from repro_torch.launch.serve import run_serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("xwT", "xwT_q8", "xwT_block", "xwT_block_q8", "spmm")


@pytest.fixture
def cache(tmp_path):
    """A fresh default tuning cache in a temporary file for the test."""
    c = tune.TuneCache(str(tmp_path / "tune_cache_torch.json"))
    tune.set_default_cache(c)
    yield c
    tune.set_default_cache(None)


@pytest.fixture
def registry():
    """A fresh default metrics registry (the cache's counters' home)."""
    reg, prev = tobs.MetricsRegistry(), tobs.default_registry()
    tobs.set_default_registry(reg)
    yield reg
    tobs.set_default_registry(prev)


def _problem(op, platform, rows=4, out=2560, k=2560, n=5, m=80, **kw):
    cfg = SparsityConfig(n, m)
    if op == "spmm":
        return tune.Problem.for_spmm((out, k), (k, rows), cfg,
                                     torch.bfloat16, platform, **kw)
    if op.startswith("xwT_block"):
        return tune.Problem(op=op, rows=rows, out=out, k=k, dtype="bfloat16",
                            sparsity=(n, m, 1), platform=platform,
                            block_r=128, a_max=k // m, **kw)
    return tune.Problem.for_xwT((rows, k), (out, k), cfg, torch.bfloat16,
                                platform, quantized=op == "xwT_q8", **kw)


# ---------------------------------------------------------------------------
# registry and platform filtering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("platform,want", [("cuda", ["cuda"]),
                                           ("cpu", ["reference"])])
def test_platform_filters_the_dispatchable_variants(op, platform, want):
    p = _problem(op, platform)
    assert [v.name for v in tune.variants_for(op, p)] == want
    with_measure_only = [v.name for v in tune.variants_for(
        op, p, include_measure_only=True)]
    assert with_measure_only == (sorted(want + ["block_spmm"])
                                 if op == "spmm" else want)
    assert tune.backend_names(op) == ("cuda", "reference")


@pytest.mark.parametrize("where,want", [
    (torch.zeros(1), "cpu"), (torch.device("cuda", 1), "cuda"),
    ("cuda:0", "cuda"), ("cpu", "cpu"), (None, "cpu")])
def test_platform_comes_from_the_operands_device(where, want):
    assert tune.platform_of(where) == want


@pytest.mark.parametrize("op,rows,body", [
    ("xwT", 4, "bulk"), ("xwT", 32, "gather"), ("xwT_q8", 8, "bulk"),
    ("xwT_q8", 9, "gather"), ("xwT_block", 4, "cluster"),
    ("xwT_block", 32, "gather"), ("xwT_block_q8", 1, "cluster"),
    ("spmm", 4, "gather"), ("spmm", 256, "tiled")])
def test_cuda_body_follows_the_wrappers_rules(op, rows, body):
    """The body a problem names is the one the wrapper picks for tensors of
    that shape (the wrappers' rules run on CPU tensors without a launch)."""
    from repro_torch.kernels.demm_block_spmm import block_body
    from repro_torch.kernels.demm_q8 import block_q8_body
    from repro_torch.kernels.demm_spmm import spmm_body
    from repro_torch.kernels.demm_xwT import xwt_body

    p = _problem(op, "cuda", rows=rows, out=256, k=1280)
    assert tune.cuda_body(p) == body
    cfg = SparsityConfig(5, 80)
    w = prune(torch.randn(256, 1280), cfg)
    x = torch.randn(rows, 1280).to(torch.bfloat16)
    if op == "spmm":
        pk = pack(w, cfg)
        assert spmm_body(pk.values, pk.indices, x.T.contiguous(), 80) == body
    elif op.startswith("xwT_block"):
        pw = pack_block(w, cfg, block_r=128)
        if op == "xwT_block":
            got = block_body(pw.active_groups, pw.values, pw.indices, x.T, 80)
        else:
            got = block_q8_body(pw.values.to(torch.int8), pw.indices,
                                torch.ones(pw.values.shape[:-1]), x.T, 80)
        assert got == body
    else:
        pk = pack(w, cfg)
        v = pk.values.to(torch.int8) if op == "xwT_q8" else pk.values
        assert xwt_body(x, v, pk.indices, 80, duplicates=False,
                        scales=torch.ones(256) if op == "xwT_q8"
                        else None) == body


@pytest.mark.parametrize("op", OPS)
def test_param_space_holds_the_bodys_tunables(op):
    for rows in (4, 32, 256):
        p = _problem(op, "cuda", rows=rows)
        space = tune.get_variant(op, "cuda").param_space(p)
        body = tune.cuda_body(p)
        want = {"bulk": {"rows_per_block", "chunks"}
                | ({"lanes"} if op == "xwT_q8" else set()),
                "gather": {"rows_per_block"}, "cluster": {"cluster_size"},
                "tiled": {"tile_n", "warpgroups", "stages"}}[body]
        assert set(space) == want
        assert tune.get_variant(op, "cuda").default_params(p) == {}
        assert tune.get_variant(op, "reference").param_space(p) == {}


# ---------------------------------------------------------------------------
# pruning: shared memory and launch geometry, without a launch
# ---------------------------------------------------------------------------

def test_smem_grows_with_the_tile():
    p = _problem("xwT", "cuda")                      # bulk body
    rows = [tune.smem_bytes(p, "cuda", {"rows_per_block": r, "chunks": 1})
            for r in (8, 16, 32, 64)]
    assert rows == sorted(rows) and rows[0] < rows[-1]
    p = _problem("spmm", "cuda", rows=256, m=128, n=8, k=2560)   # tiled
    tiles = [tune.smem_bytes(p, "cuda", {"tile_n": bn, "warpgroups": wg,
                                         "stages": 2})
             for bn, wg in ((128, 1), (256, 1), (256, 2))]
    assert tiles == sorted(tiles) and tiles[0] < tiles[-1]
    p = _problem("xwT_block", "cuda")                # cluster body
    cl = [tune.smem_bytes(p, "cuda", {"cluster_size": c}) for c in (8, 4, 2)]
    assert cl == sorted(cl)
    assert tune.smem_bytes(p, "reference", {}) == 0


def test_prune_rejects_oversize_and_ill_shaped_candidates():
    p = _problem("spmm", "cuda", rows=256, m=128, n=8, k=2560)
    big = {"tile_n": 256, "warpgroups": 2, "stages": 4}
    assert tune.smem_bytes(p, "cuda", big) > tune.DEFAULT_SMEM_BUDGET
    cands = [tune.Candidate("cuda", {}), tune.Candidate("cuda", big),
             tune.Candidate("cuda", {"tile_n": 128, "warpgroups": 1,
                                     "stages": 5})]
    keep = tune.prune_candidates(p, cands)
    assert [c.params for c in keep] == [{}]
    assert [c.status for c in cands[1:]] == ["pruned_smem",
                                            "pruned_geometry"]
    q = _problem("xwT_block", "cuda", rows=32)       # gather body
    cands = [tune.Candidate("cuda", {"rows_per_block": 48}),
             tune.Candidate("cuda", {"rows_per_block": 64})]
    tune.prune_candidates(q, cands)
    assert cands[0].status == "pruned_geometry"      # 256 % 48 != 0
    assert tune.geometry_refusal(_problem("xwT_block", "cuda"), "cuda",
                                 {"cluster_size": 16}) is not None


@pytest.mark.parametrize("op", OPS)
def test_prune_keeps_the_default_and_ranks_at_most_max_measure(op):
    p = _problem(op, "cuda")
    cands = tune.enumerate_candidates(p)
    keep = tune.prune_candidates(p, cands, max_measure=3)
    assert {} in [c.params for c in keep if c.backend == "cuda"]
    assert len(keep) <= 3 + (op == "spmm")           # + block_spmm default
    assert all(c.est_us is None or c.est_us > 0 for c in keep)
    assert all(c.status in ("enumerated", "pruned_rank", "pruned_smem",
                            "pruned_geometry") for c in cands)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "c.json")
    c = tune.TuneCache(path)
    p = _problem("xwT", "cuda")
    cfg = tune.TunedConfig("cuda", {"rows_per_block": 20, "chunks": 1},
                           measured_us=4.3, source="tuned")
    c.put(p, cfg, persist=True)
    again = tune.TuneCache(path)
    assert again.get(p) == cfg
    assert len(again) == 1
    # memoised heuristics stay in memory, never on disk
    again.resolve(_problem("xwT", "cuda", rows=8))
    again.save()
    assert list(json.load(open(path))["entries"]) == [tune.problem_key(p)]


def test_cache_schema_bump_invalidates(tmp_path, monkeypatch):
    from repro_torch.tune import cache as tcache
    path = str(tmp_path / "c.json")
    p = _problem("xwT", "cuda")
    tune.TuneCache(path).put(p, tune.TunedConfig("cuda", {}, 1.0, "tuned"),
                             persist=True)
    monkeypatch.setattr(tcache, "SCHEMA_VERSION", tcache.SCHEMA_VERSION + 1)
    fresh = tune.TuneCache(path)
    assert fresh.load() == 0 and fresh.get(p) is None


def test_cache_save_is_atomic(tmp_path, monkeypatch):
    path = tmp_path / "c.json"
    c = tune.TuneCache(str(path))
    p = _problem("xwT", "cuda")
    c.put(p, tune.TunedConfig("cuda", {}, 1.0, "tuned"), persist=True)
    before = path.read_text()

    def broken(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", broken)
    c.put(_problem("xwT", "cuda", rows=8),
          tune.TunedConfig("cuda", {"chunks": 2}, 2.0, "tuned"))
    with pytest.raises(OSError):
        c.save()
    assert path.read_text() == before                  # old file intact
    assert sorted(os.listdir(tmp_path)) == ["c.json"]   # no temp file left


def test_cache_has_its_own_default_path(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    assert tune.TuneCache().path == os.path.join("results",
                                                 "tune_cache_torch.json")
    assert tune.TuneCache().path != jtune.TuneCache(path=None).path
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "x.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    assert tune.TuneCache().path == str(tmp_path / "x.json")


@pytest.mark.parametrize("op", OPS)
def test_heuristic_default_per_platform(op):
    assert tune.heuristic_default(_problem(op, "cuda")) == tune.TunedConfig(
        "cuda", {})
    assert tune.heuristic_default(_problem(op, "cpu")) == tune.TunedConfig(
        "reference", {})


def test_resolve_counts_hits_and_misses(cache, registry):
    p = _problem("xwT", "cpu")
    assert cache.resolve(p).backend == "reference"      # miss, memoised
    assert cache.resolve(p).backend == "reference"      # hit
    snap = registry.snapshot(meta=False)["counters"]
    got = {c["name"]: c["value"] for c in snap
           if c["name"].startswith("tune_cache_")}
    assert got["tune_cache_hits_total"] == 1
    assert got["tune_cache_misses_total"] == 1
    events = registry.trace.named("tune_cache_resolve")
    assert [e["outcome"] for e in events] == ["miss", "hit"]
    assert events[0]["key"] == tune.problem_key(p)


# ---------------------------------------------------------------------------
# problem keys against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,out,k,n,m,dtype", [
    (4, 2560, 2560, 5, 80, "bfloat16"), (32, 6912, 2560, 5, 80, "bfloat16"),
    (1, 128, 256, 2, 16, "float32"), (7, 64, 32, 4, 16, "float32")])
@pytest.mark.parametrize("quantized", [False, True])
def test_xwT_keys_equal_the_jax_packages(rows, out, k, n, m, dtype,
                                         quantized):
    tp = tune.Problem.for_xwT((rows, k), (out, k), SparsityConfig(n, m),
                              getattr(torch, dtype), "cpu",
                              quantized=quantized)
    jp = jtune.Problem.for_xwT((rows, k), (out, k), JSparsityConfig(n, m),
                               dtype, "cpu", quantized=quantized)
    assert tune.problem_key(tp) == jtune.problem_key(jp)
    dup = tune.Problem.for_xwT((rows, k), (out, k), SparsityConfig(n, m),
                               getattr(torch, dtype), "cpu",
                               quantized=quantized, duplicates=True)
    assert tune.problem_key(dup) == jtune.problem_key(jp) + "|dup"


@pytest.mark.parametrize("cd,r,k,n,m", [(4, 256, 128, 2, 16),
                                        (256, 2560, 2560, 5, 80),
                                        (3, 100, 96, 3, 48)])
def test_spmm_keys_equal_the_jax_packages(cd, r, k, n, m):
    tp = tune.Problem.for_spmm((r, k), (k, cd), SparsityConfig(n, m),
                               torch.float32, "cpu")
    jp = jtune.Problem.for_spmm((r, k), (k, cd), JSparsityConfig(n, m),
                                "float32", "cpu")
    assert tune.problem_key(tp) == jtune.problem_key(jp)


@pytest.mark.parametrize("block_r,a_max", [(128, None), (64, 6)])
@pytest.mark.parametrize("quantized", [False, True])
def test_block_keys_equal_the_jax_packages(block_r, a_max, quantized):
    from repro.quant import quantize_packed as jquantize
    from repro_torch.quant import quantize_packed

    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 160)).astype(np.float32)
    cfg = SparsityConfig(5, 80)
    tw = pack_block(prune(torch.from_numpy(w), cfg), cfg, block_r=block_r,
                    a_max=a_max)
    jw = jpack_block(np.asarray(prune(torch.from_numpy(w), cfg)),
                     JSparsityConfig(5, 80), block_r=block_r, a_max=a_max)
    if quantized:
        tw, jw = quantize_packed(tw), jquantize(jw)
    for rows in (1, 4, 32):
        tp = tune.Problem.for_xwT_block((rows, 160), tw, torch.float32)
        jp = jtune.Problem.for_xwT_block((rows, 160), jw, "float32", "cpu")
        assert tune.problem_key(tp) == jtune.problem_key(jp)


# ---------------------------------------------------------------------------
# autotune_packed_tree against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = reduced_pair()
    jmodel, params = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, params


@pytest.mark.parametrize("layout,quantize", [("xwT", None), ("xwT", "int8"),
                                             ("block", None),
                                             ("block", "int8")])
def test_packed_tree_keys_equal_the_jax_packages(reduced, cache, tmp_path,
                                                 monkeypatch, layout,
                                                 quantize):
    _, tcfg, _, params = reduced
    # the JAX tuner's interpret-mode candidates would take minutes: stub
    # its measurement (its enumeration, pruning and keys are what count)
    monkeypatch.setattr(jautotune, "measure",
                        lambda thunk, warmup=2, iters=5: 1e-3)
    jcache = jtune.TuneCache(str(tmp_path / "jax.json"))
    jtune.set_default_cache(jcache)
    try:
        packed = jpack_tree(params, layout=layout, quantize=quantize)
        want = jtune.autotune_packed_tree(packed, 4, persist=False)
    finally:
        jtune.set_default_cache(None)
    model = to_torch_model(packed, tcfg)
    got = tune.autotune_packed_tree(model, 4, persist=False)
    assert set(got) == set(want) and len(got) == 3
    for key, res in got.items():
        assert res.best.backend == "reference"
        assert res.best.source == "tuned"
        assert cache.get(res.problem) == res.best
        assert res.best_us == res.default.measured_s * 1e6


def test_packed_tree_keys_carry_duplicates(cache):
    from repro_torch.core.sparsity import PackedWeight

    cfg = SparsityConfig(2, 16)
    v = torch.ones(8, 2, 2)
    i = torch.zeros(8, 2, 2, dtype=torch.int32)      # both slots at column 0
    mod = torch.nn.Module()
    mod.a = PackedWeight(v, i, cfg=cfg, dense_shape=(8, 32))
    mod.b = PackedWeight(v, i.clone() + torch.tensor([0, 1],
                                                     dtype=torch.int32),
                         cfg=cfg, dense_shape=(8, 32))
    got = tune.autotune_packed_tree(mod, 2, torch.float32, persist=False)
    assert sorted(got) == ["xwT|r2|o8|k32|float32|2:16:1|cpu",
                           "xwT|r2|o8|k32|float32|2:16:1|cpu|dup"]


# ---------------------------------------------------------------------------
# the tuner's handling of refusals, faults and captures
# ---------------------------------------------------------------------------

def _small_xwT():
    cfg = SparsityConfig(2, 16)
    pk = pack(prune(torch.randn(32, 64), cfg), cfg)
    return torch.randn(4, 64), pk.values, pk.indices, cfg


def test_a_refused_candidate_is_recorded_and_tuning_goes_on(cache,
                                                            monkeypatch):
    from repro_torch.tune import autotune as tat

    real = tat.measure
    calls = []

    def measure(calls_, warmup=1, iters=5):
        calls.append(1)
        if len(calls) == 2:     # block_spmm's default, after the heuristic's
            raise LaunchRefused("demm_block_spmm: inconsistent shapes")
        return real(calls_, warmup=warmup, iters=iters)

    monkeypatch.setattr(tat, "measure", measure)
    x, v, i, cfg = _small_xwT()
    res = tune.autotune_spmm(v, i, x.T.contiguous(), cfg, (32, 64),
                             persist=False)
    statuses = sorted(c.status for c in res.candidates)
    assert statuses.count("refused") == 1 and "measured" in statuses
    assert res.best.backend == "reference"


def test_a_refused_default_or_a_fault_raises(cache, monkeypatch):
    from repro_torch.tune import autotune as tat

    x, v, i, cfg = _small_xwT()

    def refuse(calls, warmup=1, iters=5):
        raise LaunchRefused("refused")

    monkeypatch.setattr(tat, "measure", refuse)
    with pytest.raises(RuntimeError, match="default"):
        tune.autotune_xwT(x, v, i, cfg, (32, 64), persist=False)

    def fault(calls, warmup=1, iters=5):
        raise RuntimeError("demm_xwt: CUDA launch failed with error 700")

    monkeypatch.setattr(tat, "measure", fault)
    with pytest.raises(RuntimeError, match="error 700"):
        tune.autotune_xwT(x, v, i, cfg, (32, 64), persist=False)


@pytest.mark.parametrize("fault", ["offset", "nan"])
def test_a_candidate_that_disagrees_with_the_default_raises(cache,
                                                            monkeypatch,
                                                            fault):
    """Every candidate's output is held to the heuristic default's before
    it is timed: a measure-only repack whose launch is off by one (or NaN)
    stops the tuning instead of being timed."""
    import dataclasses
    from repro_torch.tune import registry as treg

    real = treg._REGISTRY[("spmm", "block_spmm")]

    def prepare(*args, **kw):
        ops_, launch = real.prepare(*args, **kw)
        bad = (lambda c: c + 1.0) if fault == "offset" else (
            lambda c: c * float("nan"))
        return ops_, lambda *o: bad(launch(*o))

    monkeypatch.setitem(treg._REGISTRY, ("spmm", "block_spmm"),
                        dataclasses.replace(real, prepare=prepare))
    x, v, i, cfg = _small_xwT()
    with pytest.raises(RuntimeError, match="disagrees with the heuristic"):
        tune.autotune_spmm(v, i, x.T.contiguous(), cfg, (32, 64),
                           persist=False)
    assert not cache._mem


@pytest.mark.parametrize("drift", [0, 16])
def test_the_shared_memory_model_is_held_to_the_launcher(monkeypatch, drift):
    """On the card a ``cuda`` candidate's launcher reports the dynamic
    shared memory it asked for; the tuner raises unless ``smem_bytes``
    counted the same (the launcher's answer stubbed here)."""
    import types
    from repro_torch.kernels import _build
    from repro_torch.tune import autotune as tat

    p = _problem("xwT", "cuda")
    c = tat.Candidate("cuda", {"rows_per_block": 20, "chunks": 2})
    counted = tune.smem_bytes(p, "cuda", c.params)
    monkeypatch.setattr(_build, "last_launch_smem",
                        lambda: counted + drift)
    on_card = types.SimpleNamespace(is_cuda=True)
    if drift:
        with pytest.raises(RuntimeError, match="drifted"):
            tat._check_output(p, c, on_card, None)
    else:
        tat._check_output(p, c, on_card, None)


def test_tuning_inside_a_capture_raises(cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    x, v, i, cfg = _small_xwT()
    with pytest.raises(RuntimeError, match="capture"):
        tune.autotune_xwT(x, v, i, cfg, (32, 64), persist=False)


def test_measure_only_variant_is_measured_never_dispatched(cache):
    x, v, i, cfg = _small_xwT()
    b = x.T.contiguous()
    res = tune.autotune_spmm(v, i, b, cfg, (32, 64), persist=False)
    block = [c for c in res.candidates if c.backend == "block_spmm"]
    assert any(c.status == "measured" for c in block)
    assert res.best.backend == "reference"
    with pytest.raises(ValueError, match="measure-only"):
        ops.demm_spmm(v, i, b, cfg, (32, 64), backend="block_spmm")
    got = tune.get_variant("spmm", "block_spmm").call(v, i, b, cfg, (32, 64),
                                                      block_r=16)
    torch.testing.assert_close(got, ops.demm_spmm(v, i, b, cfg, (32, 64)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# backend="auto" through ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,quantize", [("xwT", None), ("xwT", "int8"),
                                             ("block", None),
                                             ("block", "int8")])
def test_ops_auto_resolves_and_counts_the_resolved_backend(cache, registry,
                                                           layout, quantize):
    from repro_torch.core.sparsity import PackedWeight
    from repro_torch.quant import quantize_packed

    cfg = SparsityConfig(2, 16)
    w = prune(torch.randn(128, 64), cfg)
    pk = pack(w, cfg)
    pw = (pack_block(w, cfg) if layout == "block" else
          PackedWeight(pk.values, pk.indices, cfg=cfg, dense_shape=(128, 64)))
    if quantize:
        pw = quantize_packed(pw)
    x = torch.randn(4, 64)
    got = ops.demm_matmul_packed(x, pw, backend="auto")
    torch.testing.assert_close(got, ops.demm_matmul_packed(x, pw),
                               rtol=0, atol=0)
    counters = {(c["name"], c["labels"].get("backend")): c["value"]
                for c in registry.snapshot(meta=False)["counters"]}
    assert counters[("kernel_dispatch_total", "reference")] == 2
    assert ("kernel_dispatch_total", "auto") not in counters


def test_auto_never_runs_the_plain_version_on_a_cuda_problem(cache):
    """A cache entry naming ``reference`` for a CUDA problem (edited in by
    hand) raises at resolution; the lookup itself needs no card."""
    cfg = SparsityConfig(5, 80)
    p = tune.Problem.for_xwT((4, 2560), (2560, 2560), cfg, torch.bfloat16,
                             "cuda")
    assert tune.resolve_xwT((4, 2560), (2560, 2560), cfg, torch.bfloat16,
                            device="cuda").backend == "cuda"
    cache.put(p, tune.TunedConfig("reference", {}, 1.0, "tuned"))
    with pytest.raises(RuntimeError, match="does not dispatch on 'cuda'"):
        tune.resolve_xwT((4, 2560), (2560, 2560), cfg, torch.bfloat16,
                         device="cuda")
    cpu = tune.Problem.for_xwT((4, 2560), (2560, 2560), cfg, torch.bfloat16)
    cache.put(cpu, tune.TunedConfig("cuda", {}, 1.0, "tuned"))
    with pytest.raises(RuntimeError, match="does not dispatch on 'cpu'"):
        tune.resolve_xwT((4, 2560), (2560, 2560), cfg, torch.bfloat16)


def test_tuned_params_merge_with_the_calls_own(cache, monkeypatch):
    import dataclasses
    from repro_torch.tune import registry as treg

    seen = {}
    x, v, i, cfg = _small_xwT()
    p = tune.Problem.for_xwT(x.shape, (32, 64), cfg, x.dtype)
    cache.put(p, tune.TunedConfig("reference", {"rows_per_block": 8}, 1.0,
                                  "tuned"))
    real = treg._REGISTRY[("xwT", "reference")]
    monkeypatch.setitem(treg._REGISTRY, ("xwT", "reference"),
                        dataclasses.replace(real, call=lambda *a, **kw: (
                            seen.update(kw), real.call(*a, **kw))[1]))
    ops.demm_matmul_xwT(x, v, i, cfg, (32, 64), "auto", duplicates=False)
    assert seen == {"rows_per_block": 8, "duplicates": False}


# ---------------------------------------------------------------------------
# the engines and the serving program under auto
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layout,quantize", [("xwT", None),
                                             ("block", "int8")])
def test_engines_under_auto_match_the_jax_engines(reduced, cache, paged,
                                                  layout, quantize):
    jcfg, tcfg, jmodel, params = reduced
    run = dict(packed=True, layout=layout, quantize=quantize, requests=4,
               slots=4, max_new=5, max_len=64, seed=2, paged=paged,
               page_size=8, prefill_chunk=16)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jprev, tprev = jobs.default_registry(), tobs.default_registry()
    jobs.set_default_registry(jreg)
    tobs.set_default_registry(treg)
    jtune.set_default_cache(jtune.TuneCache(cache.path + ".jax"))
    try:
        jeng = jax_run_serve(jmodel, params, jcfg.vocab_size,
                             backend="auto", **run)
        teng = run_serve(to_torch_model(params, tcfg), tcfg.vocab_size,
                         backend="auto", autotune=True, device="cpu", **run)
    finally:
        jobs.set_default_registry(jprev)
        tobs.set_default_registry(tprev)
        jtune.set_default_cache(None)
    want = {r.uid: list(r.output) for r in jeng.completed}
    got = {r.uid: list(r.output) for r in teng.completed}
    assert got == want and len(got) == 4
    counters = {(c["name"], c["labels"].get("backend")): c["value"]
                for c in treg.snapshot(meta=False)["counters"]}
    assert counters[("kernel_dispatch_total", "reference")] > 0
    assert counters[("tune_autotune_measurements_total", None)] == 3
    # decode-width problems were tuned by the engine: every lookup of them
    # hits the cache
    decode = [e for e in treg.trace.named("tune_cache_resolve")
              if "|r4|" in e["key"]]
    assert decode and all(e["outcome"] == "hit" for e in decode)


def test_make_engine_and_both_engines_take_autotune(reduced, cache):
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import ServeConfig, ServeEngine, make_engine

    _, tcfg, _, params = reduced
    model = pack_tree(to_torch_model(params, tcfg))
    pol = ExecPolicy(mode="packed", backend="auto")
    for config, kind in ((ServeConfig(num_slots=3, max_len=32), ServeEngine),
                         (PagedServeConfig(num_slots=2, max_len=32,
                                           page_size=8), PagedServeEngine)):
        eng = make_engine(model, config, policy=pol, device="cpu",
                          autotune=True, metrics=tobs.MetricsRegistry())
        assert isinstance(eng, kind)
        keys = {k for k in cache._mem if k.startswith("xwT|")}
        assert {f"|r{config.num_slots}|" in k for k in keys} >= {True}
    # a masked model has nothing to tune
    make_engine(to_torch_model(params, tcfg), ServeConfig(num_slots=5),
                device="cpu", autotune=True, metrics=tobs.MetricsRegistry())
    assert not any("|r5|" in k for k in cache._mem)


def test_cli_autotune_implies_auto(cache, registry, tmp_path, monkeypatch,
                                   capsys):
    from repro_torch.launch.serve import main

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    tune.set_default_cache(None)            # the default reads the env var
    out = tmp_path / "m.json"
    main(["--device", "cpu", "--requests", "2", "--max-new", "3",
          "--max-len", "24", "--packed", "--autotune",
          "--metrics-out", str(out)])
    log = capsys.readouterr().out
    assert "served" in log and "auto" in log
    snap = json.loads(out.read_text())
    counters = {(c["name"], c["labels"].get("backend")): c["value"]
                for c in snap["counters"]}
    assert counters[("kernel_dispatch_total", "reference")] > 0
    assert counters[("tune_cache_hits_total", None)] > 0
    assert counters[("tune_autotune_measurements_total", None)] == 3
    entries = json.load(open(tmp_path / "t.json"))["entries"]
    assert len(entries) == 3 and all("|r4|" in k and k.endswith("|cpu")
                                     for k in entries)
    tune.set_default_cache(None)


def test_cli_auto_snapshot_passes_validate_metrics(cache, tmp_path):
    """``launch.serve --backend auto --metrics-out`` on the CPU, checked by
    the unchanged ``benchmarks/validate_metrics.py``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "t.json"))
    out = tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "2", "--max-new", "3", "--max-len", "24", "--packed",
         "--layout", "block", "--backend", "auto", "--metrics-out",
         str(out)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run(
        [sys.executable, "benchmarks/validate_metrics.py", str(out),
         "--require-counter", "tune_cache_hits_total",
         "--require-counter", "tune_cache_misses_total",
         "--require-counter", "kernel_dispatch_total",
         "--require-counter", "serve_requests_completed_total"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the bench scripts
# ---------------------------------------------------------------------------

def _bench(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune_cache.json"))
    return subprocess.run([sys.executable] + args, env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_kernel_bench_writes_what_compare_bench_reads(tmp_path):
    out = tmp_path / "k.json"
    proc = _bench(["benchmarks/torch_kernel_bench.py", "--autotune",
                   "--quick", "--device", "cpu", "--out", str(out),
                   "--cache", str(tmp_path / "c.json")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    blob = json.loads(out.read_text())
    assert blob["platform"] == "cpu" and len(blob["cases"]) == 10
    for case in blob["cases"]:
        assert case["tuned"]["backend"] == "reference"
        assert case["tuned_vs_default"] >= 1.0
        assert case["dense_us"] > 0
        # one measurement of the default: the tuner's own
        assert case["default"]["us"] == case["tuned"]["us"]
        assert case["turns_us"] is None
        assert case["model"]["best_rank"] is None
    proc = _bench(["benchmarks/compare_bench.py", str(out), str(out)],
                  tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_bench_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _bench(["benchmarks/torch_kernel_bench.py", "--autotune",
                   "--out", str(tmp_path / "k.json")], tmp_path)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_serve_bench_replays_the_trace_on_both_engines(tmp_path):
    out = tmp_path / "s.json"
    proc = _bench(["benchmarks/torch_serve_bench.py", "--device", "cpu",
                   "--trace", "benchmarks/traces/tiny_trace.jsonl",
                   "--max-pages", "16", "--packed", "--backend", "auto",
                   "--autotune", "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    blob = json.loads(out.read_text())
    assert blob["token_identical"] is True
    assert blob["paged"]["preempts"] >= 1
    for leg in ("paged", "legacy"):
        for key in ("ttft_p50_s", "ttft_p99_s", "e2e_p99_s",
                    "tokens_per_sec", "prefill_tokens_per_sec"):
            assert blob[leg][key] > 0
    assert blob["prefill_speedup"] > 0 and set(blob["rel"]) == {
        "ttft_p99", "e2e_p99", "tps", "prefill"}
    assert blob["meta"]["backend"] == "auto"


def test_serve_bench_refuses_spec_by_name(tmp_path):
    proc = _bench(["benchmarks/torch_serve_bench.py", "--device", "cpu",
                   "--spec", "6:16"], tmp_path)
    assert proc.returncode == 2 and "--spec" in proc.stderr
    assert "not ported" in proc.stderr
