"""Distributed serving of the port against the JAX package.

Single-process: the per-shard renumbering (bit for bit with
``repro.core.sparsity``), the sharded packed matmul's meshless path, the
plan's classification, specs and JSON, the checkpoint manifest, the tuning
key of a shard-local problem, the engine factory and the replica router.

Multi-rank: one spawned two-rank ``gloo`` world on the CPU
(``repro_torch.sharding.world.spawn_world``; the ranks import no jax, see
``_torch_dist_worker.py``) serves TP=2 in both layouts, TP=2 with wk / wv
replicated, PP=2 and the paged engine at TP=2 under preemption; the parent
holds every rank's tokens to the JAX package's single-device tokens from
the same weights, and the port's own tp=1 tokens.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sparsity as jsp
from repro.sharding.plan import ShardingPlan as JShardingPlan

from _torch_port import jax_model_and_params, reduced_pair, to_torch_model
from repro_torch import obs as tobs
from repro_torch.core import sparsity as tsp
from repro_torch.sharding.partitioning import Spec
from repro_torch.sharding.plan import ShardingPlan

CFG = (2, 8, 1)


def _dense(rng, o, k, n=2, m=8, empty=0.3):
    """An N:M-sparse (o, k) weight with some groups all zero."""
    w = rng.standard_normal((o, k)).astype(np.float32)
    g = k // m
    mask = np.zeros((o, g, m), np.float32)
    for r in range(o):
        for gi in range(g):
            if rng.random() >= empty:
                mask[r, gi, rng.choice(m, n, replace=False)] = 1
    return (w.reshape(o, g, m) * mask).reshape(o, k)


def _pair(w, layout, quant=None):
    """(JAX PackedWeight, port PackedWeight) of the same dense weight."""
    jc, tc = jsp.SparsityConfig(*CFG), tsp.SparsityConfig(*CFG)
    if layout == "block":
        jp = jsp.pack_block(jnp.asarray(w), jc, block_r=8)
        tp = tsp.pack_block(torch.tensor(w), tc, block_r=8)
    else:
        jp = jsp.PackedWeight.from_dense(jnp.asarray(w), jc)
        tp = tsp.PackedWeight.from_dense(torch.tensor(w), tc)
    if quant:
        from repro.quant import quantize_packed as jq
        from repro_torch.quant import quantize_packed as tq
        jp, tp = jq(jp, granularity=quant), tq(tp, granularity=quant)
    return jp, tp


CHILDREN = ("values", "indices", "active_groups", "scales")
RENUMBER_CASES = {"xwT": ("xwT", None), "block": ("block", None),
                  "xwT_int8": ("xwT", "per_row"),
                  "xwT_int8_per_group": ("xwT", "per_group")}


# ---------------------------------------------------------------------------
# renumbering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", list(RENUMBER_CASES))
def test_renumbering_matches_jax_bit_for_bit(case, shards):
    layout, quant = RENUMBER_CASES[case]
    jp, tp = _pair(_dense(np.random.default_rng(shards), 16, 64), layout,
                   quant)
    js = jsp.shard_packed_row_parallel(jp, shards)
    ts = tsp.shard_packed_row_parallel(tp, shards)
    assert (ts.shard_axis, ts.shards) == ("model", shards)
    assert ts.block_geom == js.block_geom
    for name in CHILDREN:
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
    # the inverse, and every local slice, as the JAX package's
    ju, tu = jsp.unshard_packed(js), tsp.unshard_packed(ts)
    for name in CHILDREN:
        if getattr(ju, name) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(ju, name)),
                                          getattr(tu, name).numpy(), name)
    np.testing.assert_array_equal(ts.to_dense().numpy(),
                                  tp.to_dense().numpy())
    for s in range(shards):
        jl, tl = jsp.shard_slice(js, s), tsp.shard_slice(ts, s)
        assert tl.dense_shape == jl.dense_shape == (16, 64 // shards)
        assert (tl.shard_axis, tl.shards) == (None, shards)
        np.testing.assert_array_equal(np.asarray(jl.to_dense()),
                                      tl.to_dense().numpy())


def test_block_renumbering_rebases_groups_and_tightens_a_max():
    _, tp = _pair(_dense(np.random.default_rng(1), 16, 64, empty=0.6),
                  "block")
    ts = tsp.shard_packed_row_parallel(tp, 2)
    ag = ts.active_groups
    assert ag.min() >= 0 and ag.max() < tp.groups // 2
    assert ts.block_geom[1] <= tp.block_geom[1]
    assert ts.values.shape[:2] == (2, tp.values.shape[0])


def test_renumbering_refuses_what_jax_refuses():
    rng = np.random.default_rng(4)
    _, tp = _pair(_dense(rng, 8, 64), "xwT")                # 8 groups
    with pytest.raises(ValueError):
        tsp.shard_packed_row_parallel(tp, 3)
    with pytest.raises(ValueError, match="already shard-stacked"):
        tsp.shard_packed_row_parallel(
            tsp.shard_packed_row_parallel(tp, 2), 2)
    _, tq = _pair(_dense(rng, 16, 64), "block", "per_row")
    with pytest.raises(NotImplementedError):
        tsp.shard_packed_row_parallel(tq, 2)
    with pytest.raises(ValueError, match="not shard-stacked"):
        tsp.shard_slice(tp, 0)
    with pytest.raises(ValueError, match="shard slices"):
        tp.replace(shard_axis="model", shards=2)


# ---------------------------------------------------------------------------
# the sharded packed matmul, meshless
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(RENUMBER_CASES))
def test_sharded_matmul_meshless_matches_jax(case):
    from repro.kernels.ops import demm_matmul_packed as jmatmul
    from repro_torch.kernels import ops
    layout, quant = RENUMBER_CASES[case]
    rng = np.random.default_rng(3)
    jp, tp = _pair(_dense(rng, 16, 64), layout, quant)
    js = jsp.shard_packed_row_parallel(jp, 2)
    ts = tsp.shard_packed_row_parallel(tp, 2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    want = np.asarray(jmatmul(jnp.asarray(x), js))
    tobs.default_registry().reset()
    got = ops._demm_matmul_sharded(torch.tensor(x), ts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # dispatch goes there on shard_axis, and equals the unsharded product
    np.testing.assert_array_equal(
        ops.demm_matmul_packed(torch.tensor(x), ts).numpy(), got)
    np.testing.assert_allclose(
        got, ops.demm_matmul_packed(torch.tensor(x), tp).numpy(),
        rtol=1e-4, atol=1e-5)


def test_shard_local_tune_key_matches_jax():
    from repro.tune import Problem as JProblem, problem_key as jkey
    from repro_torch.tune import Problem, problem_key
    jp, tp = _pair(_dense(np.random.default_rng(8), 16, 64), "block")
    jl = jsp.shard_slice(jsp.shard_packed_row_parallel(jp, 2), 0)
    tl = tsp.shard_slice(tsp.shard_packed_row_parallel(tp, 2), 0)
    k_local = problem_key(Problem.for_xwT_block((4, 32), tl, torch.float32))
    assert k_local == jkey(JProblem.for_xwT_block((4, 32), jl, jnp.float32))
    assert k_local.endswith("|s2")
    assert k_local != problem_key(Problem.for_xwT_block((4, 64), tp,
                                                        torch.float32))
    jx, tx = _pair(_dense(np.random.default_rng(9), 16, 64), "xwT")
    tlx = tsp.shard_slice(tsp.shard_packed_row_parallel(tx, 2), 1)
    p = Problem.for_xwT((4, 32), tlx.dense_shape, tlx.cfg, torch.float32,
                        shards=tlx.shards)
    jp2 = JProblem.for_xwT((4, 32), tlx.dense_shape, jsp.SparsityConfig(
        *CFG), jnp.float32, shards=2)
    assert problem_key(p) == jkey(jp2) and problem_key(p).endswith("|s2")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _strip_stack(spec, path):
    """The JAX package's spec of a layer-stacked leaf without its leading
    stack dim (the port keeps one module per layer)."""
    parts = list(spec)
    return tuple(parts[1:]) if path.startswith("layers") else tuple(parts)


@pytest.fixture(scope="module")
def packed_pair():
    """{layout: (JAX packed params, port packed model)} of reduced
    stablelm_3b, float32 compute, the same weights."""
    from repro.launch.pack_tree import pack_tree as jpack
    from repro_torch.launch.pack_tree import pack_tree as tpack
    jcfg, tcfg = reduced_pair()
    jmodel, params = jax_model_and_params(jcfg)
    out = {}
    for layout in ("xwT", "block"):
        jp = jpack(params, layout=layout)
        out[layout] = (jp, tpack(to_torch_model(params, tcfg),
                                 layout=layout))
    return jcfg, tcfg, jmodel, params, out


def _jax_specs_by_port_path(jplan, jparams, n_layers):
    """The JAX plan's specs keyed by the port's paths: per layer, the
    stacked leaf's spec without its stack dim; a PackedWeight node as
    {child: spec}."""
    import jax
    from repro.core.treeutil import key_path_str
    specs = jplan.param_specs(jparams)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jsp.PackedWeight)
        or type(x).__name__ == "PartitionSpec")[0]
    out = {}
    for path, spec in flat:
        p = key_path_str(path)
        if isinstance(spec, jsp.PackedWeight):
            kids = {c: tuple(getattr(spec, c)) for c in CHILDREN
                    if getattr(spec, c) is not None}
            base = p[:-2] if p.endswith("/w") else p
        else:
            kids, base = tuple(spec), p
        if p.startswith("layers/"):
            for i in range(n_layers):
                q = base.replace("layers/", f"layers/{i}/", 1)
                out[q] = ({c: s[1:] for c, s in kids.items()}
                          if isinstance(kids, dict) else kids[1:])
        else:
            out[base] = kids
    return out


@pytest.mark.parametrize("renumber", [False, True])
@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_linear_kind_and_specs_match_jax(packed_pair, layout, renumber):
    import copy
    jcfg, tcfg, _, _, models = packed_pair
    jparams, tmodel = models[layout]
    jplan, plan = JShardingPlan(tp=2), ShardingPlan(tp=2)
    if renumber:
        jparams = jplan.renumber_params(jparams)
        tmodel = plan.renumber_params(copy.deepcopy(tmodel))
    want = _jax_specs_by_port_path(jplan, jparams, tcfg.num_layers)
    got = plan.param_specs(tmodel)
    assert all(isinstance(s, Spec) for v in got.values()
               for s in (v.values() if isinstance(v, dict) else [v]))
    got = {p: ({c: tuple(s) for c, s in v.items()} if isinstance(v, dict)
               else tuple(v)) for p, v in got.items()}
    assert got == want
    kinds = {p: plan.linear_kind(p) for p, v in got.items()
             if isinstance(v, dict)}
    assert kinds == {p: jplan.linear_kind(p) for p in kinds}
    assert {"col", "row"} <= set(kinds.values())
    stacked = [p for p in kinds if getattr(tmodel.get_submodule(
        p.replace("/", ".")), "shard_axis", None)]
    assert bool(stacked) == renumber
    if renumber:
        assert all(kinds[p] == "row" for p in stacked)


def test_plan_json_overrides_and_policy():
    from repro_torch.core.sparse_linear import ExecPolicy
    kw = dict(tp=2, pp=2, dp=3, attn_kv_replicated=True,
              kind_overrides=(("x/w", "col"),))
    plan = ShardingPlan(**kw)
    assert plan.to_json() == JShardingPlan(**kw).to_json()
    assert ShardingPlan.from_json(json.loads(json.dumps(
        plan.to_json()))) == plan
    assert ShardingPlan.from_json(JShardingPlan(**kw).to_json()) == plan
    with pytest.raises(ValueError):
        ShardingPlan.from_json({**plan.to_json(), "version": 2})
    over = ShardingPlan(tp=2, kind_overrides=(("mlp/down", "replicated"),))
    assert over.linear_kind("mlp/down") == "replicated"
    assert over.linear_kind("mlp/up") == "col"
    assert ShardingPlan(tp=2, attn_kv_replicated=True).linear_kind(
        "layers/0/attn/wk") == "replicated"
    for bad in (dict(tp=0), dict(kind_overrides=(("a", "diag"),))):
        with pytest.raises(ValueError):
            ShardingPlan(**bad)
    # the JSON's dim names and renumber policy are the JAX package's
    # defaults; a plan JSON with others is refused, not read as the default
    for other in (dict(renumber="replicate"), dict(tp_axis="m")):
        with pytest.raises(ValueError, match="defaults"):
            ShardingPlan.from_json({**plan.to_json(), **other})
    pol = ExecPolicy(mode="packed", backend="auto", plan=ShardingPlan(tp=2))
    assert hash(pol) == hash(pol.replace()) and pol.plan.tp == 2
    assert ShardingPlan().make_mesh() is None


def test_plan_larger_than_the_world_raises(packed_pair):
    from repro_torch.serve import ServeConfig, make_engine
    for plan in (ShardingPlan(tp=2), ShardingPlan(pp=2),
                 ShardingPlan(tp=2, dp=2)):
        with pytest.raises(ValueError, match="ranks"):
            plan.make_mesh()
    _, tcfg, _, params, _ = packed_pair
    with pytest.raises(ValueError, match="ranks"):
        make_engine(to_torch_model(params, tcfg), ServeConfig(2, 16),
                    device="cpu", plan=ShardingPlan(tp=2),
                    metrics=tobs.MetricsRegistry())


def test_renumbered_model_serves_meshless(packed_pair):
    """A renumbered model on one process runs its row-parallel weights as
    the sequential sum over their slices: the same tokens."""
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.serve import Request, ServeConfig, make_engine
    _, tcfg, _, params, _ = packed_pair
    prompt = np.arange(1, 7, dtype=np.int32)
    out = []
    for renumber in (False, True):
        model = pack_tree(to_torch_model(params, tcfg), layout="block")
        if renumber:
            ShardingPlan(tp=2).shard_params(model)
            assert sum(getattr(m, "shard_axis", None) == "model"
                       for m in model.modules()) == 2 * tcfg.num_layers
        eng = make_engine(model, ServeConfig(num_slots=1, max_len=16),
                          policy=ExecPolicy(mode="packed"), device="cpu",
                          metrics=tobs.MetricsRegistry())
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
        eng.run_until_drained()
        out.append(eng.completed[0].output)
    assert out[0] == out[1] and len(out[0]) == 5


def test_decode_state_specs():
    plan = ShardingPlan(tp=2)
    state = {"caches": {"kind": "full", "k": torch.zeros(2, 3, 8, 4, 5),
                        "v": torch.zeros(2, 3, 8, 4, 5)},
             "pos": torch.zeros(3)}
    specs = plan.decode_state_specs(state, num_kv_heads=4)
    assert specs["caches"]["k"] == Spec(None, None, None, "model", None)
    assert specs["pos"] == Spec(None) and specs["caches"]["kind"] == "full"
    assert ShardingPlan(tp=2).decode_state_specs(
        state, num_kv_heads=3)["caches"]["v"] == Spec(*[None] * 5)
    assert ShardingPlan(pp=2).decode_state_specs(
        state, num_kv_heads=4)["caches"]["k"][0] == "pipe"


class _OneDimMesh:
    """What ``sharding.context.make_context`` reads of a DeviceMesh: a
    ``model`` dim of two ranks, this process rank 1 on it."""
    mesh_dim_names = ("model",)

    def size(self, dim):
        return 2

    def get_local_rank(self, name):
        return 1

    def get_group(self, name):
        return None


def test_shard_decode_state_allocates_the_local_block(packed_pair):
    _, tcfg, _, params, _ = packed_pair
    from repro_torch.paged import PagedLayout
    model = to_torch_model(params, tcfg)
    layout = PagedLayout.for_serve(16, page_size=4, num_pages=6,
                                   num_slots=2)
    hkv = tcfg.num_kv_heads
    for kw in (dict(), dict(paged=layout)):
        whole = model.init_decode_state(2, 16, dtype=torch.float32, **kw)
        made = []

        def make(**k):
            made.append(str(k["device"]))
            return model.init_decode_state(2, 16, dtype=torch.float32,
                                           **kw, **k)

        local = ShardingPlan(tp=2).shard_decode_state(
            make, "cpu", _OneDimMesh(), num_kv_heads=hkv)
        assert made == ["meta"]
        for name in ("k", "v"):
            want = list(whole["caches"][name].shape)
            want[3] //= 2
            got = local["caches"][name]
            assert list(got.shape) == want and got.device.type == "cpu"
            assert not got.any() and got.dtype == torch.float32
        assert local["caches"]["kind"] == whole["caches"]["kind"]
        for name, t in whole["caches"].items():
            if isinstance(t, torch.Tensor) and name not in ("k", "v"):
                assert torch.equal(local["caches"][name], t)
        assert torch.equal(local["pos"], whole["pos"])
    # without a mesh: the whole state, made on the device
    st = ShardingPlan(tp=2).shard_decode_state(
        lambda **k: model.init_decode_state(2, 16, **k), "cpu", None,
        num_kv_heads=hkv)
    assert st["caches"]["k"].shape[3] == hkv


def test_context_head_counts():
    from repro_torch.sharding.context import ShardingContext
    ctx = ShardingContext(tp=2, tp_rank=1, num_heads=6, num_kv_heads=3,
                          shard_heads=False)
    with pytest.raises(NotImplementedError, match="attn_kv_replicated"):
        ctx.local_kv_heads()
    ctx.kv_replicated = True
    assert ctx.local_heads() == 3 and ctx.local_kv_heads() == 3
    # global query heads 3, 4, 5 read KV heads 1, 2, 2
    assert ctx.kv_head_index().tolist() == [1, 2, 2]
    with pytest.raises(NotImplementedError, match="head-dim"):
        ShardingContext(tp=4, num_heads=6, num_kv_heads=6).local_heads()


# ---------------------------------------------------------------------------
# checkpoint manifest
# ---------------------------------------------------------------------------

def test_manifest_round_trip(tmp_path):
    from repro_torch.train import checkpoint as ckpt
    _, tp = _pair(_dense(np.random.default_rng(7), 16, 64), "block")
    plan = ShardingPlan(tp=2)
    tree = {"mlp": {"down": {"w": tsp.shard_packed_row_parallel(tp, 2)}}}
    ckpt.save(tree, str(tmp_path), 5, plan=plan)
    assert ckpt.load_plan(str(tmp_path)) == plan
    assert ckpt.load_plan(str(tmp_path), 5) == plan
    restored = ckpt.restore(tree, str(tmp_path), 5)["mlp"]["down"]["w"]
    assert (restored.shard_axis, restored.shards) == ("model", 2)
    np.testing.assert_array_equal(restored.to_dense().numpy(),
                                  tp.to_dense().numpy())
    # what the JAX package reads from the port's manifest
    from repro.train import checkpoint as jckpt
    assert jckpt.load_plan(str(tmp_path)) == JShardingPlan(tp=2)
    ckpt.save({"w": torch.zeros(2)}, str(tmp_path / "plain"), 1)
    assert ckpt.load_plan(str(tmp_path / "plain")) is None
    assert ckpt.load_plan(str(tmp_path / "nope")) is None


# ---------------------------------------------------------------------------
# the factory and the replica router
# ---------------------------------------------------------------------------

def test_make_engine_plan_and_replica_arguments(packed_pair):
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.paged import PagedServeConfig
    from repro_torch.serve import ServeConfig, make_engine
    _, tcfg, _, params, _ = packed_pair
    model = to_torch_model(params, tcfg)
    for config in (ServeConfig(num_slots=2, max_len=32),
                   PagedServeConfig(num_slots=2, max_len=32)):
        with pytest.raises(ValueError, match="conflicts"):
            make_engine(model, config, device="cpu",
                        plan=ShardingPlan(tp=2),
                        policy=ExecPolicy(plan=ShardingPlan(pp=2)))
        with pytest.raises(TypeError):
            make_engine(model, config, device="cpu", plan=object())
        with pytest.raises(ValueError, match="replicas"):
            make_engine(model, config, device="cpu", replicas=2,
                        metrics=tobs.MetricsRegistry())
    # a plan of degree 1 is the single-process engine
    eng = make_engine(model, ServeConfig(num_slots=2, max_len=32),
                      device="cpu", plan=ShardingPlan(),
                      metrics=tobs.MetricsRegistry())
    assert eng.mesh is None and eng.policy.plan == ShardingPlan()


@pytest.mark.parametrize("paged", [False, True])
def test_router_round_robin_and_merged_metrics(packed_pair, paged):
    from repro_torch.paged import PagedServeConfig
    from repro_torch.serve import (ReplicaRouter, Request, ServeConfig,
                                   make_engine)
    _, tcfg, _, params, _ = packed_pair
    model = to_torch_model(params, tcfg)
    config = (PagedServeConfig(num_slots=2, max_len=32, page_size=8)
              if paged else ServeConfig(num_slots=2, max_len=32))
    router = make_engine(model, config, device="cpu", replicas=2)
    assert isinstance(router, ReplicaRouter)
    single = make_engine(model, config, device="cpu",
                         metrics=tobs.MetricsRegistry())
    for eng in (router, single):
        for uid in range(4):
            eng.submit(Request(uid=uid, prompt=np.array([2, 7, 1 + uid],
                                                        np.int32),
                               max_new_tokens=2))
        eng.run_until_drained()
    assert sorted(r.uid for r in router.completed) == [0, 1, 2, 3]
    # round-robin: even uids on replica 0, odd on replica 1
    assert sorted(r.uid for r in router.replicas[0].completed) == [0, 2]
    assert router.replicas[1]._trace_labels() == {"replica": "1"}
    # the replicas share the model: request by request, the single
    # engine's tokens
    assert {r.uid: r.output for r in router.completed} == \
        {r.uid: r.output for r in single.completed}
    snap = router.metrics.snapshot(meta=False)
    gauges = {(e["name"], e["labels"].get("replica"))
              for e in snap["gauges"]}
    assert ("serve_replica_slots_active", "0") in gauges
    assert ("serve_replica_tokens_per_second", "1") in gauges
    routed = [e for e in snap["counters"]
              if e["name"] == "serve_router_requests_total"]
    assert routed and routed[0]["value"] == 4
    toks = {e["labels"]["replica"]: e["value"]
            for e in snap["counters"] if e["name"] == "serve_tokens_total"}
    assert set(toks) == {"0", "1"} and sum(toks.values()) == 8
    merged = [e for e in snap["sketches"]
              if e["name"] == "serve_e2e_seconds_sketch"
              and "replica" not in e["labels"]]
    assert merged and merged[0]["count"] == 4
    assert router.queue_depth == 0 and router.tick() == 0


# ---------------------------------------------------------------------------
# the two-rank world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(packed_pair):
    """The JAX package's single-device tokens of every leg (computed here),
    the port's tp=1 tokens, and the two ranks' results."""
    import _torch_dist_worker as w
    from _torch_port import jax_tree_to_numpy
    from repro.launch.serve import run_serve as jrun
    from repro_torch.launch.serve import run_serve
    from repro_torch.sharding.world import spawn_world

    jcfg, tcfg, jmodel, params, _ = packed_pair
    want, port = {}, {}
    for leg, run, kw in (("tp2_xwT", w.RUN, dict(layout="xwT")),
                         ("tp2_block", w.RUN, dict(layout="block")),
                         ("tp2_masked", w.RUN, dict(packed=False)),
                         ("pp2", w.PP_RUN, dict(layout="xwT")),
                         ("paged_tp2", w.PAGED_RUN, dict(layout="block"))):
        kw = {"packed": True, **kw}
        want[leg] = w.streams(jrun(jmodel, params, jcfg.vocab_size,
                                   backend="reference", **run, **kw))
        port[leg] = w.streams(run_serve(
            to_torch_model(params, tcfg), tcfg.vocab_size,
            backend="reference", device="cpu",
            metrics=tobs.MetricsRegistry(), **run, **kw))
    ranks = spawn_world(w.serve_legs, 2, (jax_tree_to_numpy(params),),
                        timeout_s=240)
    return want, port, ranks


@pytest.mark.parametrize("leg", ["tp2_xwT", "tp2_block", "tp2_masked",
                                 "pp2", "paged_tp2"])
def test_multi_rank_tokens_match_jax(world, leg):
    want, port, ranks = world
    assert len(want[leg]) >= 3
    assert port[leg] == want[leg]
    for r in ranks:
        assert r[leg] == want[leg], (r["rank"], leg)


def test_multi_rank_ranks_agree_and_hold_their_shards(world, packed_pair):
    want, _, ranks = world
    _, _, _, _, models = packed_pair
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" for r in ranks)
    for layout in ("xwT", "block"):
        whole = {n: sum(t.nbytes for t in (m.values, m.indices,
                                           m.active_groups, m.scales)
                        if t is not None)
                 for n, m in models[layout][1].named_modules()
                 if isinstance(m, tsp.PackedWeight)}
        for r in ranks:
            held = r[f"tp2_{layout}_bytes"]
            assert set(held) == set(whole)
            kinds = {k for k, _, _ in held.values()}
            assert kinds == {"col", "row"}
            for name, (kind, sharded, nbytes) in held.items():
                m = models[layout][1].get_submodule(name)
                # a block weight of one row block stays whole, as the JAX
                # plan's sanitised spec keeps it; every other splits
                split = kind == "row" or m.values.shape[0] % 2 == 0
                assert sharded == split, (layout, name)
                assert (nbytes < whole[name]) == split, (layout, name)
            assert any(not s for _, s, _ in held.values()) == (
                layout == "block")
            assert r[f"tp2_{layout}_labels"] == {
                "tp_shard": f"{r['rank']}:2"}
            assert r[f"tp2_{layout}_eager"] == [1]
    # KV heads replicated (wk / wv whole, each rank its block of heads)
    assert all(r["tp2_kv_replicated"] == want["tp2_xwT"] for r in ranks)
    for r in ranks:
        assert r["pp2_layers"] == 1 and r["pp2_cache_layers"] == 1
        assert r["paged_tp2_preempts"] > 0
        # the arena's head axis split: 2 of the 4 KV heads on each rank
        assert r["paged_tp2_arena"][3] == 2
    assert ranks[0]["paged_tp2"] == ranks[1]["paged_tp2"]


def test_multi_rank_kv_heads_that_do_not_split(world):
    _, _, ranks = world
    for r in ranks:
        assert r["kv1_refused"] and "attn_kv_replicated" in r["kv1_refused"]
        assert r["kv1_tp2"] == r["kv1_tp1"] and len(r["kv1_tp1"]) == 3


def test_multi_rank_sharded_matmul_under_the_group(world):
    """The row-parallel packed matmul as the engine runs it (a placed
    rank-local slice, x's chunk, the partial products summed over the tp
    group) and the meshless sequential sum give the unsharded product on
    every rank."""
    import _torch_dist_worker as w
    _, _, ranks = world
    for r in ranks:
        m = dict(r["sharded_matmul"])
        # this rank's renumbered slice of the 24 x 64 weight: (O, G / 2, Ne)
        kind, sharded, axis, shards, shape = m.pop("placed")
        assert (kind, sharded, axis, shards) == ("row", True, None, 2)
        m_ = w.torch_cfg().sparsity.m
        assert shape[0] == 24 and shape[1] * 2 * m_ == 64
        assert set(m) == {"meshless", "group"}
        for path, err in m.items():
            assert err <= 2e-5, (r["rank"], path, err)


def test_multi_rank_decode_state_is_built_local(world):
    """A rank allocates only its block of the decode state: every
    ``init_decode_state`` call of a plan engine's construction is on the
    meta device (the local blocks are allocated from its shapes)."""
    _, _, ranks = world
    for r in ranks:
        for leg in ("pp2", "paged_tp2"):
            assert set(r[f"{leg}_state_devices"]) == {"meta"}, (r["rank"],
                                                                 leg)


def test_kernel_library_builds_once_per_world(world):
    _, _, ranks = world
    assert sum(r["build_count"] for r in ranks) == 1
    assert ranks[0]["build_count"] == 1
