"""Every family the port serves, served under ``ShardingPlan(tp=2)``, against
the JAX package.

Single-process: the rule table's specs of the families' tensors (Mamba2's
``conv_w`` / ``A_log`` / ``D`` / ``dt_bias``, the xLSTM blocks, the experts,
the frontends' projections, cross-attention) against the JAX plan's; the
decode state's specs for the windowed and recurrent trees; every family's
state allocated at its local shape with its fresh values; the refusals
that stay (the reference's).

Multi-rank: one spawned two-rank ``gloo`` world on the CPU
(``repro_torch.sharding.world.spawn_world``; the ranks import no jax, see
``_torch_dist_worker.family_legs``) serves, at tp 2, reduced float32
configs from the JAX package's weights: MoE (olmoe, expert parallel, room
for every token), the Mamba2 hybrid (through its shared block, block
layout), xLSTM (int8), vision, encoder-decoder (dense and paged engines),
gemma3's ``local_global`` past its 8-slot rings, ``swa``, one KV head
(case 2 of the JAX package's ``_constrain_heads``: k / v gathered), 3 query
heads over 1 KV head (case 3: q / k / v gathered, attention whole), and
speculation on both engines.  Every rank's token streams equal the JAX
package's single-device tokens; the speculative streams equal the plain
tp streams, their draft tiers read the rank's slices in place; every rank
holds less than the whole model; the frontends' prefills match the JAX
package's logits (rtol / atol 1e-4, float32).
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as w
from _torch_port import (family_batch, family_pair, jax_model_and_params,
                         jax_tree_to_numpy)
from repro_torch.configs.base import ARCH_IDS
from repro_torch.sharding.partitioning import Spec
from repro_torch.sharding.plan import ShardingPlan

TOL = dict(rtol=1e-4, atol=1e-4)
LEGS = list(w.FAMILY_LEGS)
SPEC_LEGS = [leg for leg in LEGS if leg.startswith("spec")]
# the column-parallel projections whose output each rank gathers, by leg:
# the mixers split by heads gather only mLSTM's xm (``up``'s first half)
# and sLSTM's input
GATHERED = {
    "moe": set(), "swa": set(), "spec": set(), "spec_paged": set(),
    "hybrid": set(), "vision": {"patch_proj"},
    "encdec": {"frame_proj"}, "encdec_paged": {"frame_proj"},
    "xlstm": {"blk.up", "blk.w_in"},
    # reduced gemma3's one KV head: wk / wv of one 32-row block, which does
    # not split, run whole on every rank (nothing gathered)
    "local_global": set(), "kv1": {"attn.wk", "attn.wv"},
    "heads3": {"attn.wq", "attn.wk", "attn.wv"},
}


def _leg_pair(leg):
    """(JAX config, port config) of the leg."""
    jcfg, tcfg = family_pair(w.FAMILY_LEGS[leg][0])
    return w.family_leg_cfg(leg, jcfg), w.family_leg_cfg(leg, tcfg)


@pytest.fixture(scope="module")
def world():
    """The JAX package's single-device tokens of every leg and prefill
    logits of the frontend legs (computed here), and the two ranks'
    results."""
    from repro.core.sparse_linear import ExecPolicy as JPolicy
    from repro.launch.pack_tree import pack_tree as jpack
    from repro.launch.serve import run_serve as jrun
    from repro_torch.sharding.world import spawn_world

    models, trees, batches = {}, {}, {}
    for leg in LEGS:
        jcfg, tcfg = _leg_pair(leg)
        models[leg] = jcfg, *jax_model_and_params(jcfg)
        trees[leg] = jax_tree_to_numpy(models[leg][2])
        if leg in w.PREFILL_LEGS:
            batches[leg] = family_batch(tcfg, t=12, seed=2)
            del batches[leg]["targets"]
    # the ranks serve while this process runs the JAX package
    got = {}

    def ranks():
        try:
            got["ranks"] = spawn_world(w.family_legs, 2, (trees, batches),
                                       timeout_s=300)
        except Exception as e:       # raised again below
            got["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    want, prefill = {}, {}
    try:
        for leg, (jcfg, jmodel, params) in models.items():
            want[leg] = w.streams(jrun(jmodel, params, jcfg.vocab_size,
                                       backend="reference",
                                       **w.family_run(leg)))
            if leg in batches:
                logits, _ = jmodel.prefill(
                    jpack(params),
                    {k: jnp.asarray(v) for k, v in batches[leg].items()},
                    policy=JPolicy(mode="packed"))
                prefill[leg] = np.asarray(logits)
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    return want, prefill, got["ranks"]


@pytest.mark.parametrize("leg", LEGS)
def test_tokens_match_jax(world, leg):
    want, _, ranks = world
    assert len(want[leg]) == w.family_run(leg)["requests"]
    assert all(len(t) == w.FAMILY_RUN["max_new"] for t in want[leg].values())
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r[leg] == want[leg], (r["rank"], leg)


@pytest.mark.parametrize("leg", SPEC_LEGS)
def test_speculation_keeps_the_tokens_and_reads_the_slices(world, leg):
    """Speculation under tp 2 commits the plain tp stream, which is the
    JAX package's; every narrowed node of the draft model shares its
    tensors with the rank's placed node (a prefix view of the rank's
    renumbered or column slice, no copy) and runs as it is placed."""
    want, _, ranks = world
    for r in ranks:
        assert r[f"{leg}_spec"] == r[leg] == want[leg], r["rank"]
        d = r[f"{leg}_draft"]
        assert d["narrowed"] > 0
        assert d["shared"] == d["placed"] == d["narrowed"]
        held, whole = r[f"{leg}_spec_bytes"]
        assert d["slice_bytes"] < held < whole


@pytest.mark.parametrize("leg", LEGS)
def test_each_rank_holds_its_block(world, leg):
    """A rank holds less than three quarters of the packed model one rank
    holds: the projections, experts and vocab split, the norms, Mamba2's
    and xLSTM's per-channel tensors and block weights of an odd count of
    row blocks whole."""
    _, _, ranks = world
    for r in ranks:
        held, whole = r[f"{leg}_bytes"]
        assert 0 < held < 0.75 * whole, (leg, held, whole)


@pytest.mark.parametrize("leg", LEGS)
def test_gathered_projections(world, leg):
    """The column-parallel projections whose output a rank gathers: mLSTM's
    xm and sLSTM's input, the frontends' inputs and the heads that do not
    split, where their rows split (Mamba2's ``in_proj`` and mLSTM's ``wq``
    / ``wk`` / ``wv`` are split by heads and not gathered)."""
    _, _, ranks = world
    got = {".".join(n.split(".")[-2:]) for n in ranks[0][f"{leg}_gathered"]}
    assert got == GATHERED[leg]
    assert ranks[0][f"{leg}_gathered"] == ranks[1][f"{leg}_gathered"]


@pytest.mark.parametrize("leg", [leg for leg in LEGS
                                 if "paged" not in leg])
def test_decode_state_is_split_where_the_heads_divide(world, leg):
    """Every KV tensor of a rank's state holds half the KV heads when they
    divide tp (full caches, rings, gemma3's global caches, the hybrid's
    shared-block caches) and all of them when they do not; the recurrent
    states of the mixers split by heads hold half the heads (Mamba2's
    ``h``, mLSTM's ``C``, ``n``, ``m``) and Mamba2's conv window half its x
    channels beside all of B's and C's; every other tensor is whole (the
    conv window of mLSTM's xm, sLSTM's state)."""
    from repro_torch.models.families import build_model

    _, tcfg = _leg_pair(leg)
    whole = w.state_held(build_model(tcfg, device="cpu").init_decode_state(
        w.FAMILY_RUN["slots"], w.FAMILY_RUN["max_len"], dtype=torch.float32,
        device="meta"))
    kv = tcfg.num_kv_heads
    local = kv // 2 if kv % 2 == 0 else kv
    halve = {"h": -3, "C": -3, "n": -2, "m": -1}
    _, _, ranks = world
    for r in ranks:
        held = r[f"{leg}_state"]
        assert held.keys() == whole.keys()
        for path, shape in whole.items():
            top, key = path.split("/")[0], path.split("/")[-1]
            shape = list(shape)
            if key in ("k", "v", "global_k", "global_v"):
                shape[-2] = local
            elif top in ("ssm", "ssm_tail", "mlstm") and key in halve:
                shape[halve[key]] //= 2
            elif top in ("ssm", "ssm_tail") and key == "conv":
                di = tcfg.ssm.expand * tcfg.d_model
                shape[-1] = di // 2 + 2 * tcfg.ssm.state_dim
            assert held[path] == tuple(shape), (path, held[path], shape)


@pytest.mark.parametrize("leg", w.PREFILL_LEGS)
def test_frontend_prefill_under_tp(world, leg):
    """``prefill`` with the frontend's inputs under the engine's context
    (the vision stub's ``patch_proj``, the encoder's ``frame_proj`` and its
    non-causal blocks, the cross-attention): the JAX package's logits."""
    _, prefill, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r[f"{leg}_prefill"], prefill[leg], **TOL)
    np.testing.assert_array_equal(ranks[0][f"{leg}_prefill"],
                                  ranks[1][f"{leg}_prefill"])


# ---------------------------------------------------------------------------
# single-process: the rule table, the decode state, the head counts
# ---------------------------------------------------------------------------

# the keys under which a family's JAX tree stacks a leading axis
STACKED = ("layers", "enc_layers", "dec_layers", "periods", "mlstm")
CHILDREN = ("values", "indices", "active_groups", "scales")
FAMILIES = ("olmoe_1b_7b", "zamba2_7b", "xlstm_125m", "internvl2_1b",
            "seamless_m4t_medium")


def _jax_key(port_path):
    """(the JAX tree's path of a port path, the stack dims it drops): the
    layer index after each stacked key removed."""
    parts, out, drop = port_path.split("/"), [], 0
    i = 0
    while i < len(parts):
        out.append(parts[i])
        if parts[i] in STACKED and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            drop += 1
            i += 1
        i += 1
    return "/".join(out), drop


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_specs_match_jax(arch):
    """The port's ``param_specs`` of a packed (xwT) family model, every
    tensor and every packed node, equal the JAX plan's specs of the same
    tree with its stacked layer axes dropped (``_base_ndim`` on Mamba2's
    ``conv_w``, ``A_log``, ``D``, ``dt_bias``)."""
    import jax
    from repro.core import sparsity as jsp
    from repro.core.treeutil import key_path_str
    from repro.launch.pack_tree import pack_tree as jpack
    from repro.sharding.plan import ShardingPlan as JShardingPlan
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.pack_tree import pack_tree

    jcfg, tcfg = family_pair(arch)
    _, params = jax_model_and_params(jcfg)
    jparams = jpack(params)
    flat = jax.tree_util.tree_flatten_with_path(
        JShardingPlan(tp=2).param_specs(jparams),
        is_leaf=lambda x: isinstance(x, jsp.PackedWeight)
        or type(x).__name__ == "PartitionSpec")[0]
    want = {}
    for path, spec in flat:
        p = key_path_str(path)
        if isinstance(spec, jsp.PackedWeight):
            want[p[:-2] if p.endswith("/w") else p] = {
                c: tuple(getattr(spec, c)) for c in CHILDREN
                if getattr(spec, c) is not None}
        else:
            want[p] = tuple(spec)
    model = pack_tree(from_jax_params(jax_tree_to_numpy(params), tcfg,
                                      device="cpu"))
    got = ShardingPlan(tp=2).param_specs(model)
    assert any(isinstance(s, dict) for s in got.values())
    for p, spec in got.items():
        key, drop = _jax_key(p)
        ref = want[key]
        if isinstance(spec, dict):
            assert {c: tuple(s) for c, s in spec.items()} == {
                c: s[drop:] for c, s in ref.items()}, p
        else:
            assert tuple(spec) == ref[drop:], p


def test_decode_state_specs_windowed_and_recurrent():
    """Every KV tensor (dense, ring, 6-D local ring, global caches) splits
    its head axis when the heads divide tp; ring positions, the recurrent
    states of a config whose mixers do not split (gemma3's: none) and the
    encoder's output stay whole."""
    from repro_torch.configs.base import get_arch
    cfg = get_arch("gemma3_1b").reduced()
    plan = ShardingPlan(tp=2)
    z = torch.zeros
    state = {"caches": {"kind": "local_global",
                        "local": {"k": z(2, 1, 3, 8, 4, 5),
                                  "v": z(2, 1, 3, 8, 4, 5),
                                  "slot_pos": z(2, 1, 3, 8)},
                        "tail": {"k": z(1, 3, 8, 4, 5), "v": z(1, 3, 8, 4, 5),
                                 "slot_pos": z(1, 3, 8)},
                        "global_k": z(2, 3, 16, 4, 5),
                        "global_v": z(2, 3, 16, 4, 5)},
             "ssm": {"h": z(2, 3, 3, 4, 4, 5), "conv": z(2, 3, 3, 3, 4)},
             "enc_out": z(3, 4, 8), "pos": z(3)}
    specs = plan.decode_state_specs(state, cfg, num_kv_heads=4)
    c = specs["caches"]
    assert c["local"]["k"] == Spec(None, None, None, None, "model", None)
    assert c["tail"]["v"] == Spec(None, None, None, "model", None)
    assert c["global_k"] == Spec(None, None, None, "model", None)
    for s in (c["local"]["slot_pos"], specs["ssm"]["h"], specs["ssm"]["conv"],
              specs["enc_out"]):
        assert all(a is None for a in s)
    # heads that do not divide: everything whole
    whole = plan.decode_state_specs(state, cfg, num_kv_heads=3)
    assert all(a is None for a in whole["caches"]["local"]["k"])


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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_decode_state_keeps_the_fresh_values(arch):
    """Every architecture's state allocated at its local shape from the
    meta device (the mixers' states split by heads too) holds the fresh
    state's values (``STATE_FILL``: -1 in ring slot positions, the xLSTM
    stabilisers at -1e30; zeros elsewhere), so a state leaf that starts
    elsewhere and is missing there fails here."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.dryrun import local_shape
    from repro_torch.models.families import build_model

    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    whole = model.init_decode_state(2, 16, dtype=torch.float32)
    local = ShardingPlan(tp=2).shard_decode_state(
        lambda **k: model.init_decode_state(2, 16, dtype=torch.float32, **k),
        "cpu", _OneDimMesh(), num_kv_heads=cfg.num_kv_heads, cfg=cfg)
    specs = ShardingPlan(tp=2).decode_state_specs(
        whole, num_kv_heads=cfg.num_kv_heads, cfg=cfg)

    def walk(a, b, spec, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], spec[k], f"{path}/{k}")
        elif isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype and b.device.type == "cpu", path
            assert b.shape == local_shape(a.shape, spec, {"model": 2}), path
            lo, hi = a.min(), a.max()
            assert lo == hi and (b == lo).all(), path
        else:
            assert a == b, path

    walk(whole, local, specs)


def test_serving_refusals_are_the_references():
    """What a plan still refuses, as the JAX package does: tp with pp,
    speculation under pp, pp off the decoder LM's full cache."""
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.models.families import build_model
    from repro_torch.serve.protocol import EngineBase

    def setup(arch, plan, spec=None, **over):
        _, tcfg = family_pair(arch)
        eng = EngineBase()
        eng.model = build_model(dataclasses.replace(tcfg, **over),
                                device="cpu")
        eng._setup_plan(ExecPolicy(plan=plan), spec)

    with pytest.raises(NotImplementedError, match="pick one"):
        setup("stablelm_3b", ShardingPlan(tp=2, pp=2))
    with pytest.raises(NotImplementedError, match="pp>1"):
        setup("stablelm_3b", ShardingPlan(pp=2), spec=object())
    for arch in ("zamba2_7b", "gemma3_1b"):
        with pytest.raises(NotImplementedError, match="pipelined"):
            setup(arch, ShardingPlan(pp=2))
