"""Distributed training of the port against the JAX package.

Single-process: ZeRO-1's ``opt_state_specs`` against the reference's for
every leaf of reduced stablelm_3b and olmoe_1b_7b, the batch specs, the
shape-only stand-ins of ``launch/specs.py``, compression against the
reference's on one rank, and ``launch.train --compression`` on the CPU.

Multi-rank: one spawned four-rank ``gloo`` world on the CPU, tp 2 x dp 2
(``repro_torch.sharding.world.spawn_world``; the ranks import no jax, see
``_torch_dist_worker.py``).  Its legs: the masked train step of reduced
stablelm_3b (the reference's weights) with ZeRO-1 moments, held to the JAX
package's single-device step (the single-device half of the reference's
``test_tp_dp_train_step_matches_single_device``, whose distributed half
does not run here) and to the port's one-rank step; one int8 and one topk
step; compression of a whole and a tp-split tensor; the state saved from
the world, restored whole in one process and under ``ShardingPlan(tp=2)``
on two ranks; the packed fine-tuning step's gradients, and its state
saved and restored under tp 2 (shard stacks at their slices' shapes); a
MoE model's step and the reference's MoE test through the expert-parallel
path; ``pipeline_apply`` over four stages; ``compressed_psum_int8``; the
meshes of ``launch/mesh.py``; a row block that does not hold whole
groups; batch 1 decoded with its KV cache split by position over data = 2
(``seq_shard_cache``) against one rank's whole-cache decode; the dry-run
census's collectives of a decode step under tp 2 against what the real
context counted; every family, the head fallbacks and int8 fake
quantization trained under tp 2 x dp 2 against the JAX package's
single-device step and the port's one rank, the hybrid's state restored
under tp 2 (its row-mapped leaves), the hybrid packed in the ``block``
layout and fine-tuned by its re-blocked rows; and a pod 2 x data 1 x
model 2 mesh's step and tick.

Tolerances, float32 throughout: against the JAX package the reference's
own (loss 1e-3, parameters rtol / atol 5e-3; the MoE test rtol / atol
2e-2); against the port's one rank, loss and grad_norm relative 1e-5 (the
sums run in another order over the ranks), parameters within 2 x lr x
steps (AdamW's first steps are about lr x sign(g), and a gradient near 0
may flip under another order), the MoE path and the pipeline 1e-5; the
family legs' AdamW moments norm-wise 1e-5 (v 2e-5) and their updates
:data:`UPDATE_REL`; compression, checkpoints and restores bit for bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.sharding import partitioning as jpart
from repro.sharding.plan import ShardingPlan as JShardingPlan
from repro.train.train_loop import make_train_step as jmake_train_step

import _torch_dist_worker as w
from _torch_port import (family_named, jax_model_and_params,
                         jax_tree_to_numpy, port_named, reduced_pair,
                         to_torch_model)
from repro_torch.models.families import build_model
from repro_torch.optim import adamw
from repro_torch.optim import compression as tcomp
from repro_torch.sharding import partitioning as tpart
from repro_torch.sharding.partitioning import Spec
from repro_torch.sharding.plan import ShardingPlan
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_loop import train_params

REL = 1e-5
BOUND = 2 * w.STEP_KW["lr"] * w.TRAIN_STEPS


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------

def _jax_named_specs(specs, stacked_from):
    """The reference's spec tree as ``{port name: spec}``, its stacked
    layer axis split off (the port keeps no stack axis)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, jax.sharding.PartitionSpec):
            out[prefix] = tuple(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)

    walk(specs, "")
    named = {}
    for k, spec in out.items():
        if k.startswith("layers."):
            rest = k[len("layers."):]
            assert spec[0] in (None, ()), (k, spec)   # never on the stack
            for i in range(stacked_from):
                named[f"layers.{i}.{rest}"] = spec[1:]
        else:
            named[k] = spec
    return named


@pytest.mark.parametrize("data_degree", [2, 4])
@pytest.mark.parametrize("arch", ["stablelm_3b", "olmoe_1b_7b"])
def test_opt_state_specs_match_jax(arch, data_degree):
    """ZeRO-1 specs of every leaf: the moments split over ``data`` on the
    same dim as the reference's (its stacked layer axis aside)."""
    from _torch_port import family_pair
    jcfg, tcfg = family_pair(arch)
    jmodel, jparams = jax_model_and_params(jcfg)
    jspecs = JShardingPlan().param_specs(jparams)
    want = _jax_named_specs(
        jpart.opt_state_specs(jspecs, jparams, data_degree),
        jcfg.num_layers)
    model = build_model(tcfg, device="cpu", seed=0)
    pspecs = ShardingPlan().param_specs(model)
    shapes = {tpart.path_of(n): t.shape
              for n, t in train_params(model).items()}
    got = tpart.opt_state_specs(pspecs, shapes, data_degree)
    assert set(want) == {n.replace("/", ".") for n in got}
    for n, spec in got.items():
        assert tuple(spec) == want[n.replace("/", ".")], n


def test_opt_state_specs_fallback_and_batch_specs():
    """Without shapes the first whole dim (the reference's fallback); the
    batch specs of a data x model mesh and of a long-context decode."""
    assert tpart.opt_state_specs({"a": Spec("model", None)})["a"] == \
        Spec("model", "data")
    assert tpart.opt_state_specs({"b": Spec(None)}, {"b": (3,)}, 2)["b"] == \
        Spec(None)

    class Mesh:
        mesh_dim_names = ("data", "model")

    assert tpart.batch_axes(Mesh()) == ("data",)
    assert tpart.batch_spec(Mesh(), 2) == Spec(("data",), None)
    assert tpart.batch_spec(Mesh(), 3, seq_axis=1, seq_shard=True) == \
        Spec(None, "data", None)


@pytest.mark.parametrize("arch", ["stablelm_3b", "internvl2_1b",
                                  "seamless_m4t_medium", "olmoe_1b_7b"])
def test_launch_specs_match_jax(arch):
    """Batch, token, parameter and decode-state stand-ins: the reference's
    shapes and dtypes, on the meta device."""
    from _torch_port import family_pair
    from repro.configs.base import ShapeConfig
    from repro.launch import specs as jspecs
    from repro_torch.launch import specs as tspecs
    jcfg, tcfg = family_pair(arch)
    shape = ShapeConfig("c", seq_len=32, global_batch=4, kind="train")
    bshape = tspecs.BatchShape(4, 32)
    for fn in ("train_batch_specs", "prefill_batch_specs"):
        want = getattr(jspecs, fn)(jcfg, shape)
        got = getattr(tspecs, fn)(tcfg, bshape)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (fn, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
    tok = tspecs.decode_token_specs(bshape)
    assert tuple(tok.shape) == jspecs.decode_token_specs(shape).shape
    jmodel, _ = jax_model_and_params(jcfg)
    want = family_named(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                     jspecs.param_shapes(jmodel)))
    got = tspecs.param_shapes(tcfg)
    assert set(got) == set(want)
    for n, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[n].shape
    if arch == "stablelm_3b":
        state = tspecs.decode_state_shapes(tspecs.meta_model(tcfg), bshape)
        jstate = jspecs.decode_state_shapes(jmodel, shape)
        assert tuple(state["caches"]["k"].shape) == \
            jstate["caches"]["k"].shape
        assert state["caches"]["k"].device.type == "meta"


def _comp_grads():
    _, tcfg = reduced_pair()
    shapes = {n: t.shape for n, t in train_params(
        build_model(tcfg, device="cpu", seed=0)).items()}
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal(shapes[n]).astype(np.float32)
            for n in w.COMP_NAMES}


def test_compression_matches_jax_bit_for_bit():
    """topk with error feedback (two steps: the residual re-injected) and
    the int8 round trip on one rank, bit for bit with the reference's."""
    g = _comp_grads()
    jg = {n: jnp.asarray(v) for n, v in g.items()}
    tg = {n: torch.tensor(v) for n, v in g.items()}
    jsent, jres = jcomp.topk_with_error_feedback(jg, None, 0.05)
    tsent, tres = tcomp.topk_with_error_feedback(tg, None, 0.05)
    jsent2, _ = jcomp.topk_with_error_feedback(jg, jres, 0.05)
    tsent2, _ = tcomp.topk_with_error_feedback(tg, tres, 0.05)
    jrt, trt = jcomp.int8_roundtrip(jg), tcomp.int8_roundtrip(tg)
    for n in g:
        for a, b in ((tsent, jsent), (tres, jres), (tsent2, jsent2),
                     (trt, jrt)):
            np.testing.assert_array_equal(a[n].numpy(), np.asarray(b[n]))
    q, s = tcomp.int8_quantize(tg[w.COMP_NAMES[0]])
    jq, js = jcomp.int8_quantize(jg[w.COMP_NAMES[0]])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_adamw_update_with_compression_matches_jax(scheme):
    """One AdamW update with compression (applied before the norm)."""
    jcfg, tcfg = reduced_pair()
    _, jparams = jax_model_and_params(jcfg)
    params = {n: torch.tensor(v) for n, v in port_named(jparams).items()}
    rng = np.random.default_rng(3)
    grads = {n: rng.standard_normal(p.shape).astype(np.float32) * 1e-2
             for n, p in params.items()}
    kw = dict(w.STEP_KW, compression=scheme)
    jc = jadamw.AdamWConfig(**kw)
    jtree = jax.tree.map(jnp.asarray, jparams)
    jg = _unnamed(grads, jparams)       # the port's names onto its tree
    jp, jo, jm = jax.jit(lambda g, o, p: jadamw.update(jc, g, o, p))(
        jg, jadamw.init(jc, jtree), jtree)
    tc = adamw.AdamWConfig(**kw)
    tp, to, tm = adamw.update(tc, {n: torch.tensor(v)
                                   for n, v in grads.items()},
                              adamw.init(tc, params), params)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    want = port_named(jp)
    for n, p in tp.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=1e-6, atol=1e-9)
    if scheme == "topk":
        res = port_named(jo.compression)
        for n, r in to.compression.items():
            np.testing.assert_allclose(r.numpy(), res[n], rtol=1e-6,
                                       atol=1e-9)
    else:
        assert to.compression is None


def _unnamed(named, jtree):
    """``{port name: array}`` onto the reference's (stacked) tree."""
    from repro.core.sparsity import Static

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, Static) or node is None:
            return node
        if prefix.startswith("layers."):
            rest = prefix[len("layers."):]
            n = node.shape[0]
            return jnp.stack([jnp.asarray(named[f"layers.{i}.{rest}"])
                              for i in range(n)])
        return jnp.asarray(named[prefix])

    return walk(jtree, "")


def test_train_cli_compression_runs_on_the_cpu(tmp_path):
    """``launch.train --compression`` on the CPU, both schemes: the
    launcher's own check that the loss falls holds, and topk's residuals
    ride the checkpoint."""
    from repro_torch.launch.train import main
    for scheme in ("int8", "topk"):
        d = str(tmp_path / scheme)
        out = main(["--device", "cpu", "--steps", "12", "--batch", "8",
                    "--seq", "32", "--lr", "3e-3", "--ckpt-dir", d,
                    "--ckpt-every", "12", "--compression", scheme])
        assert out["losses"][-1] < out["losses"][0]
        with open(os.path.join(d, "step_00000012", "manifest.json")) as f:
            paths = {e["path"] for e in __import__("json").load(f)["leaves"]
                     if e["kind"] == "array"}
        assert any(p.startswith("opt/compression/") for p in paths) == \
            (scheme == "topk")


# ---------------------------------------------------------------------------
# the four-rank world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX package's single-device steps, the port's one-rank steps
    (computed here) and the four ranks' results."""
    from repro_torch.sharding.world import spawn_world

    jcfg, tcfg = reduced_pair()
    jmodel, jparams = jax_model_and_params(jcfg)
    tree = jax_tree_to_numpy(jparams)
    # the JAX package's single-device step (the reference test's half)
    jc = jadamw.AdamWConfig(**w.STEP_KW)
    jstep = jax.jit(jmake_train_step(jmodel, jc, num_microbatches=2))
    jp, jo, jmetrics = jparams, jadamw.init(jc, jparams), []
    for i, b in enumerate(w.train_batches(tcfg.vocab_size)):
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()},
                          i)
        jmetrics.append((float(m["loss"]), float(m["grad_norm"])))
    # the port's one rank: the same steps, then int8 and topk
    one = {}
    model = to_torch_model(jparams, tcfg)
    one["metrics"], params, opt, _ = w.run_steps(model, tcfg.vocab_size)
    one["params"] = {n: p.clone() for n, p in params.items()}
    one["m"] = {n: t.clone() for n, t in opt.m.items()}
    for scheme, first in (("int8", w.TRAIN_STEPS),
                          ("topk", w.TRAIN_STEPS + 1)):
        m, params, opt, _ = w.run_steps(model, tcfg.vocab_size,
                                        compression=scheme, first=first,
                                        steps=1, opt_state=opt)
        one[f"{scheme}_metrics"] = m
        one[f"{scheme}_params"] = {n: p.clone() for n, p in params.items()}
    # the packed step's gradients at the values, one rank
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.train.train_loop import make_train_step
    pm = pack_tree(to_torch_model(jparams, tcfg))
    pstep = make_train_step(pm, adamw.AdamWConfig(**w.STEP_KW),
                            num_microbatches=2, policy=w._packed_policy())
    loss, _, g = pstep.grads(train_params(pm), w.train_batches(
        tcfg.vocab_size, 1)[0])
    one["packed"] = {"loss": float(loss), "grads": g}
    # a MoE model's one rank: the world's dp x microbatch chunks in order
    mcfg = w.torch_cfg_of("olmoe_1b_7b")
    one["moe_metrics"] = w.run_steps(build_model(mcfg, device="cpu", seed=0),
                                     mcfg.vocab_size, microbatches=4)[0]
    rng = np.random.default_rng(11)
    fam_models = {leg: _family_jax(leg) for leg in w.FAMILY_TRAIN}
    args = {"tree": tree, "comp": _comp_grads(),
            "families": {leg: jax_tree_to_numpy(m[2])
                         for leg, m in fam_models.items()},
            "ckpt_dir": str(tmp_path_factory.mktemp("dist_ckpt")),
            "moe": _moe_args(),
            "pipe": {"w": rng.standard_normal(
                (4, w.PIPE["d"], w.PIPE["d"])).astype(np.float32) * 0.3,
                     "x": rng.standard_normal(
                         (w.PIPE["num_mb"], w.PIPE["mb"], w.PIPE["d"])
                     ).astype(np.float32),
                     "cot": rng.standard_normal(
                         (w.PIPE["num_mb"], w.PIPE["mb"], w.PIPE["d"])
                     ).astype(np.float32)},
            "psum_x": rng.standard_normal((4, 64)).astype(np.float32)}
    # the ranks train while this process runs the JAX package's and the
    # port's one-rank steps of the family legs
    got = {}

    def ranks():
        try:
            got["ranks"] = spawn_world(w.train_legs, 4, (args,),
                                       timeout_s=300)
        except Exception as e:       # raised again below
            got["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        families = {leg: _family_single(leg, *m)
                    for leg, m in fam_models.items()}
        block = _block_single(*fam_models["hybrid"])
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    return {"jax": (jmetrics, jp), "one": one, "ranks": got["ranks"],
            "args": args, "cfg": tcfg, "families": families, "block": block}


def _family_jax(leg):
    """(JAX config, port config, JAX model, its params) of a family leg."""
    from _torch_port import family_pair
    arch = w.FAMILY_TRAIN[leg][0]
    jcfg, tcfg = (w.family_train_cfg(leg, c) for c in family_pair(arch))
    jmodel, jparams = jax_model_and_params(jcfg)
    return jcfg, tcfg, jparams, jmodel


def _family_single(leg, jcfg, tcfg, jparams, jmodel):
    """The JAX package's single-device steps of a family leg and the port's
    one-rank steps, from the same weights and numpy batches: {"start":
    named params before the steps, "jax": (metrics, named params, named
    moments m, v), "one": (metrics, params, m, v)}."""
    step_kw = w.FAMILY_TRAIN[leg][3]
    jc = jadamw.AdamWConfig(**w.STEP_KW)
    jstep = jax.jit(jmake_train_step(jmodel, jc, num_microbatches=2,
                                     **step_kw))
    jp, jo, jmetrics = jparams, jadamw.init(jc, jparams), []
    batches = w.family_train_batches(tcfg)
    for i, b in enumerate(batches):
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()},
                          i)
        jmetrics.append((float(m["loss"]), float(m["grad_norm"])))
    metrics, params, opt, _ = w.run_steps(
        to_torch_model(jparams, tcfg), tcfg.vocab_size,
        steps=w.FAMILY_STEPS, batches=batches, **step_kw)

    def np_(d):
        return {n: t.numpy().copy() for n, t in d.items()}

    return {"start": family_named(jparams),
            "jax": (jmetrics, family_named(jp), family_named(jo.m),
                    family_named(jo.v)),
            "one": (metrics, np_(params), np_(opt.m), np_(opt.v))}


def _block_single(jcfg, tcfg, jparams, jmodel):
    """The port's one-rank packed fine-tuning steps of the hybrid leg in the
    ``block`` layout, from the same weights and batches as the world's:
    {"start": params before, "one": (metrics, params, moments m)}."""
    from repro_torch.launch.pack_tree import pack_tree

    model = pack_tree(to_torch_model(jparams, tcfg), layout="block")
    start = {n: p.numpy().copy() for n, p in train_params(model).items()}
    metrics, params, opt, _ = w.run_steps(
        model, tcfg.vocab_size, steps=w.FAMILY_STEPS,
        batches=w.family_train_batches(tcfg), mode="packed")
    return {"start": start, "one": (
        metrics, {n: p.numpy().copy() for n, p in params.items()},
        {n: t.numpy().copy() for n, t in opt.m.items()})}


def _moe_args():
    jparams = jmoe.init_moe(jax.random.PRNGKey(0), w.MOE_D,
                            JMoEConfig(**w.MOE_EP), sparse=None)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), w.MOE_X))
    cot = np.random.default_rng(2).standard_normal(w.MOE_X).astype(
        np.float32)
    return {"tree": jax_tree_to_numpy(jparams), "x": x, "cot": cot}


def test_tp_dp_step_matches_jax_single_device(world):
    """The world's masked steps against the JAX package's single-device
    step from the same weights: loss within 1e-3, parameters rtol / atol
    5e-3 (the reference test's own bounds)."""
    jmetrics, jp = world["jax"]
    want = port_named(jp)
    for r in world["ranks"]:
        for (loss, _, _), (jloss, _) in zip(r["metrics"], jmetrics):
            assert abs(loss - jloss) < 1e-3
    for n, p in world["ranks"][0]["whole_params"].items():
        np.testing.assert_allclose(p, want[n], rtol=5e-3, atol=5e-3)


def test_tp_dp_step_matches_one_rank(world):
    """Against the port's one rank: loss and grad_norm (so the clip factor)
    relative 1e-5 at every step on every rank, the whole parameters
    gathered on rank 0 within 2 x lr x steps."""
    one = world["one"]
    for r in world["ranks"]:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert _rel(got[0], want[0]) < REL and \
                _rel(got[1], want[1]) < REL, (got, want)
            clip = min(1.0, 1.0 / got[1])
            assert _rel(clip, min(1.0, 1.0 / want[1])) < REL
    for n, p in world["ranks"][0]["whole_params"].items():
        assert np.abs(p - one["params"][n].numpy()).max() <= BOUND, n


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_steps_match_one_rank(world, scheme):
    one = world["one"]
    for r in world["ranks"]:
        got, want = r[f"{scheme}_metrics"][0], one[f"{scheme}_metrics"][0]
        assert _rel(got[0], want[0]) < REL and _rel(got[1], want[1]) < REL
    for n, p in world["ranks"][0][f"{scheme}_params"].items():
        assert np.abs(p - one[f"{scheme}_params"][n].numpy()).max() \
            <= 2 * BOUND, n


def test_zero1_moments_are_half_the_tp_block(world):
    """ZeRO-1: a rank's moments are half its tp block (every leaf of the
    reduced model has a dim dp = 2 divides); the whole moments gathered
    over dp and tp are the one rank's moments up to rounding (rtol 1e-3,
    atol 1e-5 of the leaf's largest: gradients summed in another order)."""
    one = world["one"]
    for r in world["ranks"]:
        assert r["moment_bytes"] * 2 == r["tp_block_bytes"]
        assert r["tp_block_bytes"] < r["model_bytes"]
        assert all(d is not None for d in r["zero_dims"].values())
    for n, m in world["ranks"][0]["whole_m"].items():
        want = one["m"][n].numpy()
        np.testing.assert_allclose(m, want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max())
    split = world["ranks"][0]["split"]
    assert split["layers.0.attn.wq.w"] and split["embed.table"]
    assert not split["layers.0.ln1.scale"] and not split["final_norm.scale"]


def test_compression_of_split_tensors_matches_jax(world):
    """topk and int8 of a tensor split over tp and of a whole one, each
    rank compressing its block: the gathered result is the reference's
    on the whole tensor, bit for bit."""
    g = {n: jnp.asarray(v) for n, v in world["args"]["comp"].items()}
    sent, resid = jcomp.topk_with_error_feedback(g, None, 0.05)
    rt = jcomp.int8_roundtrip(g)
    for r in world["ranks"]:
        assert r["split"][w.COMP_NAMES[0]] and not r["split"][w.COMP_NAMES[1]]
        for n in w.COMP_NAMES:
            np.testing.assert_array_equal(r["comp"]["topk"][n],
                                          np.asarray(sent[n]))
            np.testing.assert_array_equal(r["comp"]["resid"][n],
                                          np.asarray(resid[n]))
            np.testing.assert_array_equal(r["comp"]["int8"][n],
                                          np.asarray(rt[n]))


def test_world_checkpoint_restores_whole_and_elastic(world):
    """The state saved from the world (rank 0 writes whole leaves): a
    one-process restore reads it bit-equal to the parameters and moments
    gathered on rank 0, and ``elastic_restore`` under tp 2 on two ranks gives each
    its block of every leaf, bit for bit; the ranks outside the smaller
    mesh restore nothing."""
    tcfg = world["cfg"]
    d = world["args"]["ckpt_dir"]
    model = build_model(tcfg, device="cpu", seed=1)
    params = train_params(model)
    template = {"params": params, "opt": adamw.init(
        adamw.AdamWConfig(**w.STEP_KW), params)}
    got = ckpt.restore(template, d, w.TRAIN_STEPS)
    r0 = world["ranks"][0]
    assert ckpt.load_plan(d, w.TRAIN_STEPS) == ShardingPlan(tp=2, dp=2)
    for n, t in got["params"].items():
        np.testing.assert_array_equal(t.numpy(), r0["whole_params"][n])
    for n, t in got["opt"].m.items():
        np.testing.assert_array_equal(t.numpy(), r0["whole_m"][n])
    small = [r for r in world["ranks"] if "restored" in r]
    assert [r["rank"] for r in small] == [0, 1]
    for r in small:
        tp_rank = r["rank"]
        for key, whole in (("params", got["params"]), ("m", got["opt"].m)):
            for n, t in r["restored"][key].items():
                want = whole[n].numpy()
                split = r["restored"]["split"][n]
                if split is not None:
                    dim = split[0]
                    k = want.shape[dim] // 2
                    want = np.take(want, range(tp_rank * k,
                                               (tp_rank + 1) * k), axis=dim)
                np.testing.assert_array_equal(t, want)


def test_packed_state_restores_under_a_smaller_plan(world):
    """A packed step's state saved from the world, restored by
    ``elastic_restore`` under tp 2 on two ranks: every leaf at its
    template's shape (a shard stack's slice without the stack dim), the
    parameters bit-equal to the rank's own, and the moments, whole over
    the one dp rank, to the world's two ZeRO-1 blocks of the same tp rank
    side by side."""
    ranks = {tuple(r["coords"]): r for r in world["ranks"]}
    small = [r for r in world["ranks"] if "packed_restored" in r]
    assert [r["rank"] for r in small] == [0, 1]
    stacks = small[0]["packed_state"]["stacks"]
    assert stacks and all(n.endswith((".wo.values", ".down.values"))
                          for n in stacks)
    for r in small:
        got, own = r["packed_restored"], r["packed_state"]
        tp_rank = r["coords"][1]
        for n, shape in got["template"].items():
            assert got["params"][n].shape == shape, n
            np.testing.assert_array_equal(got["params"][n],
                                          own["params"][n])
        for n, m in got["m"].items():
            assert m.shape == got["v"][n].shape == got["template"][n], n
            z = own["zero_dims"][n]
            blocks = [ranks[(d, tp_rank)]["packed_state"]["m"][n]
                      for d in (0, 1)]
            want = blocks[0] if z is None else np.concatenate(blocks, z)
            np.testing.assert_array_equal(m, want)


def test_packed_step_grads_match_one_rank(world):
    """The packed fine-tuning step (``mode="packed"``, xwT): the gradients
    at each rank's packed values (a column-parallel block of rows, a
    row-parallel renumbered slice of groups) against the one rank's
    gradients at the same slots, relative L2 1e-5."""
    one = world["one"]["packed"]
    for r in world["ranks"]:
        assert _rel(r["packed"]["loss"], one["loss"]) < REL
        dp_rank, tp_rank = r["coords"]
        for n, g in r["packed"]["grads"].items():
            want = one["grads"][n].numpy()
            split = r["packed"]["placement"][n]
            if split is not None:
                dim, stacked = split
                if stacked:       # the renumbered slice: its run of groups
                    gl = want.shape[1] // 2
                    want = want[:, tp_rank * gl:(tp_rank + 1) * gl]
                else:
                    k = want.shape[dim] // 2
                    want = np.take(want, range(tp_rank * k,
                                               (tp_rank + 1) * k), axis=dim)
            err = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert err < REL, (n, err)
    kinds = {split[1] for r in world["ranks"]
             for split in r["packed"]["placement"].values() if split}
    assert kinds == {True, False}


def test_moe_step_matches_one_rank(world):
    """A MoE model's steps with the experts split over tp (expert
    parallel, routing per dp shard): loss, grad_norm and the aux loss
    against the one rank's over the same chunks of rows."""
    for r in world["ranks"]:
        assert r["moe_experts"][0] == 2           # 4 experts over tp 2
        for got, want in zip(r["moe_metrics"], world["one"]["moe_metrics"]):
            for a, b in zip(got, want):
                assert _rel(a, b) < REL, (got, want)


def test_moe_expert_parallel_matches_jax_and_local(world):
    """The reference's MoE test through ``apply_moe`` under the world's
    context (expert parallel: 4 experts a rank, 2 rows of x a dp rank):
    outputs and gradients against the reference's ``_apply_moe_local`` at
    capacity 64 (rtol / atol 2e-2, as there) and the port's local path
    (1e-5)."""
    from repro_torch.configs.base import MoEConfig
    args = world["args"]["moe"]
    jcfg = JMoEConfig(**w.MOE_EP)
    jp = jax.tree.map(jnp.asarray, args["tree"])
    x, cot = jnp.asarray(args["x"]), jnp.asarray(args["cot"])

    def jloss(p, x):
        y, _ = jmoe._apply_moe_local(p, x, jcfg, capacity=w.MOE_CAPACITY)
        return (y * cot).sum(), y

    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, x)
    jwant = {"y": np.asarray(jy), "router.w": np.asarray(jg["router"]["w"]),
             "w_gate": np.asarray(jg["w_gate"]),
             "w_up": np.asarray(jg["w_up"]),
             "w_down": np.asarray(jg["w_down"]), "x": np.asarray(jgx)}
    ty, tg = w.moe_grads(w.moe_module(args["tree"]), torch.tensor(args["x"]),
                         MoEConfig(**w.MOE_EP), capacity=w.MOE_CAPACITY,
                         cot=torch.tensor(args["cot"]))
    twant = dict({k: v.numpy() for k, v in tg.items()}, y=ty.numpy())
    for r in world["ranks"]:
        leg = r["moe_leg"]
        rows, ex = slice(*leg["rows"]), slice(*leg["experts"])
        for k in ("y", "router.w", "w_gate", "w_up", "w_down", "x"):
            pick = (lambda a: a[rows]) if k in ("y", "x") else \
                (lambda a: a[ex]) if k.startswith("w_") else (lambda a: a)
            np.testing.assert_allclose(leg[k], pick(jwant[k]), rtol=2e-2,
                                       atol=2e-2, err_msg=k)
            np.testing.assert_allclose(leg[k], pick(twant[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_pipeline_apply_matches_sequential(world):
    """``pipeline_apply`` over four stages: outputs on every rank and the
    gradients at each stage's weight and at x against autograd through
    the sequential composition, 1e-5."""
    a = world["args"]["pipe"]
    ws = [torch.tensor(v).requires_grad_(True) for v in a["w"]]
    x = torch.tensor(a["x"]).requires_grad_(True)
    y = x
    for wi in ws:
        y = torch.tanh(y @ wi)
    grads = torch.autograd.grad((y * torch.tensor(a["cot"])).sum(),
                                ws + [x])
    for r in world["ranks"]:
        leg = r["pipeline"]
        np.testing.assert_allclose(leg["y"], y.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(leg["gw"], grads[leg["stage"]].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(leg["gx"], grads[-1].numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert sorted(r["pipeline"]["stage"] for r in world["ranks"]) == \
        [0, 1, 2, 3]


def test_compressed_psum_int8(world):
    """The int8-compressed sum over the four ranks within 8 x scale of the
    exact sum (the reference test's bound)."""
    x = world["args"]["psum_x"]
    scale = np.abs(x).max() / 127
    for r in world["ranks"]:
        assert np.abs(r["psum"] - x.sum(0)).max() < scale * 8


def test_meshes_and_refusals(world):
    """``make_test_mesh`` over the world; ``make_production_mesh`` refused
    in a world of 4 (it needs 256) and in one process; a row block not
    holding whole groups refused by name."""
    from repro_torch.launch.mesh import make_test_mesh
    for r in world["ranks"]:
        m = r["meshes"]
        assert m["names"] == ("data", "model") and m["shape"] == (2, 2)
        assert m["coord"] == r["coords"]
        assert "256 ranks" in m["production"]
        assert "mlp.down" in r["whole_groups"] and \
            "whole groups" in r["whole_groups"]
    with pytest.raises(ValueError, match="4 ranks"):
        make_test_mesh()


def test_seq_sharded_decode_matches_one_rank(world):
    """Batch 1 decoded with the cache split by position over data = 2 (and
    the heads over model = 2): float32 tokens equal one rank's whole-cache
    decode, logits within 1e-5; each dp rank's block holds its half of the
    positions, written only there."""
    for r in world["ranks"]:
        leg = r["seq_shard"]
        assert leg["tokens"] == leg["want_tokens"]
        assert leg["logits_gap"] <= 1e-5
        assert leg["k_block"][2] == w.SEQ_LEN // 2
        dp_rank = r["coords"][0]
        half = w.SEQ_LEN // 2
        want = [p for p in range(w.SEQ_STEPS)
                if dp_rank * half <= p < (dp_rank + 1) * half]
        assert leg["written"] == want


def test_census_collectives_equal_the_real_context(world):
    """One dense decode step under ShardingPlan(tp=2): the census's recorded
    collectives equal, in count and payload bytes, what the real context
    counted for the same step."""
    legs = [r["census"] for r in world["ranks"] if r["census"] is not None]
    assert len(legs) == 2
    for leg in legs:
        assert leg["real"][0] > 0
        assert leg["census"] == leg["real"] == leg["census_context"]
        assert leg["census_ring_bytes"] == 2 * leg["real"][1]
        assert leg["names"] == ["ShardingContext.gather_tp",
                                "ShardingContext.reduce_tp"]


# ---------------------------------------------------------------------------
# every family, the head fallbacks and fake quantization under tp 2 x dp 2;
# a pod mesh
# ---------------------------------------------------------------------------

# the update AdamW applies, m / (sqrt(v) + eps), divides a gradient's rounding
# by eps where the gradient is near 0: another order of the sums moves such
# elements by up to lr, so a leaf's update is held norm-wise at UPDATE_REL
# (a wrong sign, a missed sum or no update is off by about 1 or more); the
# moments, linear in each step's clipped gradient (v in its square), hold
# every gradient at REL (v at 2 REL)
UPDATE_REL = 1e-2


def _norm_rel(got, want):
    """||got - want|| / ||want|| over a leaf (0 where both are 0)."""
    den = np.linalg.norm(want.ravel())
    num = np.linalg.norm((got - want).ravel())
    return 0.0 if num == 0 else num / max(den, 1e-30)


@pytest.mark.parametrize("leg", list(w.FAMILY_TRAIN))
def test_family_step_matches_jax_and_one_rank(world, leg):
    """A family leg's masked steps under tp 2 x dp 2 (the mixers split by
    heads, the frontends, cross-attention, one KV head gathered, wk / wv
    replicated, int8 fake quantization with the whole row's scale): loss
    and grad_norm relative 1e-5 at every step on every rank against the JAX
    package's single-device step and the port's one rank; of every leaf,
    gathered whole on rank 0, the AdamW moments m and v (each step's
    gradients) norm-wise within 1e-5 / 2e-5 of the one rank's and no
    further from the JAX package's than the one rank's are plus that, and
    the update the steps made within :data:`UPDATE_REL` likewise."""
    fam = world["families"][leg]
    (jmetrics, jparams, jm, jv), (ometrics, oparams, om, ov) = \
        fam["jax"], fam["one"]
    for r in world["ranks"]:
        got = r["families"][leg]["metrics"]
        assert len(got) == w.FAMILY_STEPS
        for g, j, o in zip(got, jmetrics, ometrics):
            for want in (j, o):
                assert _rel(g[0], want[0]) < REL and \
                    _rel(g[1], want[1]) < REL, (leg, g, want)
    r0 = world["ranks"][0]["families"][leg]
    whole, start = r0["whole_params"], fam["start"]
    assert whole.keys() == oparams.keys() <= jparams.keys()
    for n in whole:
        upd = {k: p[n] - start[n] for k, p in (("tp", whole), ("one", oparams),
                                                ("jax", jparams))}
        for got, one, ref, bound in ((r0["whole_m"][n], om[n], jm[n], REL),
                                     (r0["whole_v"][n], ov[n], jv[n],
                                      2 * REL),
                                     (upd["tp"], upd["one"], upd["jax"],
                                      UPDATE_REL)):
            assert _norm_rel(got, one) <= bound, (n, _norm_rel(got, one))
            assert _norm_rel(got, ref) <= _norm_rel(one, ref) + bound, \
                (n, _norm_rel(got, ref), _norm_rel(one, ref))
        assert np.abs(upd["tp"]).max() > 0, n


def test_family_legs_place_what_they_exercise(world):
    """What each leg holds: Mamba2's ``in_proj`` and ``conv_w`` by their
    row maps and nothing gathered; mLSTM's ``up`` by its row map, ``w_if``
    and ``conv_w`` read in part (their gradients summed over tp), only
    ``up`` and sLSTM's ``w_in`` gathered; one KV head gathered; wk / wv
    replicated read in part; every rank less than the whole model."""
    legs = world["ranks"][0]["families"]
    h = legs["hybrid"]
    assert "layers.0.mamba.in_proj.w" in h["rows"]
    assert "layers.0.mamba.conv_w" in h["rows"] and h["gathered"] == []
    x = legs["xlstm"]
    assert "periods.0.mlstm.0.blk.up.w" in x["rows"]
    assert {"periods.0.mlstm.0.blk.w_if.w",
            "periods.0.mlstm.0.blk.conv_w"} <= set(x["partial"])
    assert {n.rsplit(".", 1)[-1] for n in x["gathered"]} == {"up", "w_in"}
    assert {n.rsplit(".", 2)[-2] + "." + n.rsplit(".", 1)[-1]
            for n in legs["kv1"]["gathered"]} == {"attn.wk", "attn.wv"}
    assert "layers.0.attn.wk.w" in legs["kv_replicated"]["partial"]
    for leg, got in legs.items():
        whole = sum(p.nbytes for p in got["whole_params"].values())
        assert 0 < got["held"] < whole, leg


def test_hybrid_world_checkpoint_restores_whole(world):
    """The hybrid leg's state saved from the world (rank 0 writes whole
    leaves, the row-mapped ``in_proj`` and ``conv_w`` put together by their
    maps, B / C once): a one-process restore reads it bit-equal to the
    parameters and moments gathered on rank 0, and to the leaves' shapes
    of a whole model."""
    fam = world["families"]["hybrid"]
    r0 = world["ranks"][0]["families"]["hybrid"]
    from repro_torch.configs.base import get_arch
    tcfg = w.family_train_cfg("hybrid", get_arch("zamba2_7b").reduced())
    params = train_params(build_model(tcfg, device="cpu", seed=1))
    template = {"params": params, "opt": adamw.init(
        adamw.AdamWConfig(**w.STEP_KW), params)}
    got = ckpt.restore(template, world["args"]["ckpt_dir"] + "_hybrid",
                       w.FAMILY_STEPS)
    assert got["params"].keys() == fam["one"][1].keys()
    for n, t in got["params"].items():
        np.testing.assert_array_equal(t.numpy(), r0["whole_params"][n])
    for n, t in got["opt"].m.items():
        np.testing.assert_array_equal(t.numpy(), r0["whole_m"][n])


def _tp_block(whole, spec, tp_rank, tp=2):
    """The block of the numpy leaf ``whole`` that tp rank ``tp_rank`` holds
    under ``spec`` (written out here, not through the port's own
    ``spec_block``): a ``model`` dim its ``tp_rank``-th of tp equal runs; a
    row map's dim, segment by segment, all of a ``whole`` segment and its
    run of any other (a block node's map over its blocks of ``nb``
    rows); a shard stack's slice without its stack dim."""
    if spec and hasattr(spec[0], "block_r"):
        # a re-blocked block node's rows: (RB, A, block_r, ...) read as
        # blocks of nb rows, then the map's blocks
        f = spec[0].block_r // spec[0].nb
        rb, a, rest = whole.shape[0], whole.shape[1], whole.shape[3:]
        whole = whole.reshape(rb, a, f, spec[0].nb, *rest).swapaxes(
            1, 2).reshape(rb * f, a, spec[0].nb, *rest)
    for d, part in enumerate(spec):
        if part == "model":
            k = whole.shape[d] // tp
            whole = np.take(whole, range(tp_rank * k, (tp_rank + 1) * k),
                            axis=d)
        elif part is not None:
            idx, off = [], 0
            for n, kind in part:
                k = n if kind == "whole" else n // tp
                first = off if kind == "whole" else off + tp_rank * k
                idx.extend(range(first, first + k))
                off += n
            assert off == whole.shape[d]
            whole = np.take(whole, idx, axis=d)
    if isinstance(spec, tpart.StackSpec):
        assert whole.shape[0] == 1
        whole = whole[0]
    return whole


def test_hybrid_state_restores_under_a_smaller_plan(world):
    """The hybrid leg's state saved from the tp 2 x dp 2 world, restored by
    ``elastic_restore`` under ``ShardingPlan(tp=2)`` on the first two
    ranks: every leaf, the row-mapped ``in_proj`` and ``conv_w`` too, is
    bit-equal to its rows of the whole leaf gathered on rank 0 (B / C
    whole on both ranks); the other ranks restore nothing."""
    r0 = world["ranks"][0]["families"]["hybrid"]
    small = [r for r in world["ranks"]
             if r["families"]["hybrid"]["restored"] is not None]
    assert [r["rank"] for r in small] == [0, 1]
    for r in small:
        got = r["families"]["hybrid"]["restored"]
        specs = got["specs"]
        assert any(isinstance(p, tuple) for p in
                   specs["layers.0.mamba.in_proj.w"])
        for key, whole in (("params", r0["whole_params"]),
                           ("m", r0["whole_m"])):
            assert got[key].keys() == whole.keys()
            for n, t in got[key].items():
                np.testing.assert_array_equal(
                    t, _tp_block(whole[n], specs[n], r["rank"]), err_msg=n)


def test_block_packed_hybrid_trains_by_reblocked_rows(world):
    """The hybrid leg packed in the ``block`` layout and fine-tuned under tp
    2 x dp 2: its Mamba2 ``in_proj`` nodes re-blocked by heads (a
    ``BlockRowMap``: 8-row blocks of the 16-row ones, B / C whole); loss
    and grad_norm relative 1e-5 of the port's one rank at every step on
    every rank; every leaf, gathered whole on rank 0 (the re-blocked rows
    put back in their blocks), its moment m norm-wise within 1e-5 and its
    update within :data:`UPDATE_REL` of the one rank's, but the renumbered
    row-parallel shard stacks, whose slots are not the one rank's (their
    gradients: ``test_packed_step_grads_match_one_rank``); the state saved
    from the world and restored by ``elastic_restore`` under tp 2 on the
    first two ranks bit-equal to its rows of the whole leaves."""
    blk = world["block"]
    ometrics, oparams, om = blk["one"]
    for r in world["ranks"]:
        got = r["block"]
        assert "layers.0.mamba.in_proj.values" in got["reblocked"]
        for g, want in zip(got["metrics"], ometrics):
            assert _rel(g[0], want[0]) < REL and _rel(g[1], want[1]) < REL, \
                (g, want)
    r0 = world["ranks"][0]["block"]
    assert r0["whole_params"].keys() == oparams.keys()
    assert r0["stacks"] and r0["reblocked"]
    for n, p in r0["whole_params"].items():
        if n in r0["stacks"]:
            continue
        assert _norm_rel(r0["whole_m"][n], om[n]) <= REL, n
        assert _norm_rel(p - blk["start"][n], oparams[n] - blk["start"][n]) \
            <= UPDATE_REL, n
    small = [r for r in world["ranks"] if r["block"]["restored"] is not None]
    assert [r["rank"] for r in small] == [0, 1]
    for r in small:
        got = r["block"]["restored"]
        spec = got["specs"]["layers.0.mamba.in_proj.values"]
        assert (spec[0].block_r, spec[0].nb) == (16, 8)
        for key, whole in (("params", r0["whole_params"]),
                           ("m", r0["whole_m"])):
            for n, t in got[key].items():
                np.testing.assert_array_equal(
                    t, _tp_block(whole[n], got["specs"][n], r["rank"]),
                    err_msg=n)


def test_pod_mesh_step_and_tick_match_one_rank(world):
    """A pod 2 x data 1 x model 2 mesh: dp over pod x data (the rank's dp
    index row-major), one masked step against the port's one-rank first
    step (loss and grad_norm relative 1e-5), and one decode tick of each
    dp rank's slots against one whole model's (logits 1e-5, tokens equal,
    the KV heads split)."""
    one = world["one"]["metrics"][0]
    for r in world["ranks"]:
        pod = r["pod"]
        assert pod["dp"] == (2, r["rank"] // 2) and pod["tp_rank"] == \
            r["rank"] % 2
        got = pod["metrics"][0]
        assert _rel(got[0], one[0]) < REL and _rel(got[1], one[1]) < REL
        assert pod["tick_rows"] == (2 * (r["rank"] // 2),
                                    2 * (r["rank"] // 2) + 2)
        assert pod["tick_gap"] <= 1e-5
        assert pod["tick_tokens"][0] == pod["tick_tokens"][1]
        assert pod["cache_heads"] == world["cfg"].num_kv_heads // 2
