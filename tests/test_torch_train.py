"""Port vs JAX package: the training path — ``softmax_xent``,
``DecoderLM.train_loss`` and its gradients (full, swa and local_global
attention; remat full / dots / none), AdamW, the train step with
microbatches, the data pipeline, checkpoints, the supervisor's restarts, and
the ``launch.train`` → ``launch.serve --ckpt-dir`` command lines.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port, on the CPU; weights reach the port through
``repro_torch.convert.from_jax_params``.  Models are reduced, float32
compute.  Tolerances, float32 throughout:
  * loss and gradients rtol 1e-5, atol 1e-5 x the leaf's largest |gradient|
    (sums over positions and heads in another order; an element near 0 has
    no relative precision to keep);
  * one AdamW update rtol 1e-6, atol 1e-9;
  * three train steps: losses rtol 1e-5; parameters: every element within
    lr / 10 (well under one step's size), and 99.9 % of them within 1e-6.
    Adam divides m by sqrt(v) + eps, which turns a rounding difference in a
    gradient near 0 into a difference of up to about lr in that element's
    step (its sign can flip), so a few elements cannot be held tighter than
    a fraction of lr while the rest agree to float32 rounding;
  * data tokens, checkpoints and restarts exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.sparse_linear import ExecPolicy as JExecPolicy
from repro.data import pipeline as jpipe
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.train_loop import make_train_step as jmake_train_step

from _torch_port import (jax_model_and_params, port_named, to_torch_model)
from repro_torch.configs.base import get_arch
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.core.sparsity import PackedWeight, SparsityConfig
from repro_torch.core.treeutil import Static, key_path_str
from repro_torch.data import pipeline as tpipe
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.quant import quantize_packed
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (StragglerMonitor,
                                               SupervisorConfig,
                                               TrainingSupervisor,
                                               inject_failure_once)
from repro_torch.train.train_loop import (load_params, make_eval_step,
                                          make_train_step, premask_params,
                                          train_params)

ARCHS = {
    "stablelm_3b": {},
    "h2o_danube_1_8b": dict(window=8),
    "gemma3_1b": dict(local_global_ratio=1, num_layers=3, local_window=8),
}
MASKED = ExecPolicy(mode="masked")


def _pair(arch, **over):
    over = {"compute_dtype": "float32", **ARCHS[arch], **over}
    return (dataclasses.replace(jax_get_arch(arch).reduced(), **over),
            dataclasses.replace(get_arch(arch).reduced(), **over))


def _batch(vocab, b=4, t=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, t)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for n, g in got.items():
        r = want[n]
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=n)


def assert_params_close(got: dict, want: dict, lr: float):
    """Every element within lr / 10, 99.9 % within 1e-6 (module
    docstring)."""
    n_all = n_far = 0
    for n, p in got.items():
        d = np.abs(p.numpy() - want[n])
        assert d.max() <= lr / 10, (n, float(d.max()))
        n_all += d.size
        n_far += int((d > 1e-6).sum())
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def _port_loss_and_grads(model, batch, policy=MASKED):
    leaves = {n: p.clone().requires_grad_(True)
              for n, p in train_params(model).items()}
    loss, metrics = torch.func.functional_call(
        model, leaves, (_torch_batch(batch),), {"policy": policy})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {n: g.numpy() for n, g in zip(leaves, grads)})


# ---------------------------------------------------------------------------
# loss and gradients (models/transformer.py)
# ---------------------------------------------------------------------------

def test_softmax_xent_matches():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    logits[..., 45:] = -1e30                  # a padded vocabulary
    targets = rng.integers(0, 45, (3, 7)).astype(np.int32)
    want = float(jtf.softmax_xent(jnp.asarray(logits), jnp.asarray(targets)))
    got = ttf.softmax_xent(torch.from_numpy(logits),
                           torch.from_numpy(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    half = ttf.softmax_xent(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(targets))
    assert half.dtype == torch.float32


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_loss_and_grads_match(arch):
    """``train_loss`` (masked, straight-through) and its gradient at every
    parameter, against ``jax.grad`` of the reference's."""
    jcfg, tcfg = _pair(arch)
    jmodel, jparams = jax_model_and_params(jcfg)
    batch = _batch(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jb, policy=JExecPolicy(mode="masked")),
        has_aux=True)(jparams)
    model = to_torch_model(jparams, tcfg)
    loss, metrics, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["xent"]), float(jmet["xent"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    _assert_grads_close(grads, port_named(jgrads))


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma3_1b"])
def test_remat_modes_give_the_same_grads(arch):
    """full, dots and none: the same loss and gradients bit for bit (the
    recomputed forward is the first one again); through the layers'
    checkpoints the gradients reach the substituted (masked) tensors."""
    _, tcfg = _pair(arch)
    _, jparams = jax_model_and_params(_pair(arch)[0])
    batch = _batch(tcfg.vocab_size)
    out = {}
    for remat in ("none", "full", "dots"):
        model = to_torch_model(jparams, dataclasses.replace(tcfg,
                                                            remat=remat))
        out[remat] = _port_loss_and_grads(model, batch)
    for remat in ("full", "dots"):
        assert float(out[remat][0]) == float(out["none"][0])
        for n, g in out["none"][2].items():
            np.testing.assert_array_equal(out[remat][2][n], g, err_msg=n)
    with pytest.raises(ValueError, match="remat"):
        _port_loss_and_grads(to_torch_model(
            jparams, dataclasses.replace(tcfg, remat="some")), batch)


def test_serving_records_no_history():
    """The whole-sequence prefill under inference mode builds no graph, and
    an embedding table requiring no grad keeps its cast cache."""
    _, tcfg = _pair("stablelm_3b", compute_dtype="bfloat16")
    model = to_torch_model(jax_model_and_params(_pair("stablelm_3b")[0])[1],
                           tcfg)
    with torch.inference_mode():
        logits, _ = model.prefill(_torch_batch(_batch(tcfg.vocab_size)))
    assert logits.grad_fn is None
    assert not any(p.requires_grad for p in model.parameters())
    assert model.unembed.table_as(torch.bfloat16) is \
        model.unembed.table_as(torch.bfloat16)


# ---------------------------------------------------------------------------
# AdamW (optim/adamw.py)
# ---------------------------------------------------------------------------

def test_adamw_schedule_matches():
    cfgs = [dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
            dict(lr=3e-4, warmup_steps=5, total_steps=4),
            dict(lr=1e-3, warmup_steps=1, total_steps=12)]
    for kw in cfgs:
        for step in (0, 1, 3, 5, 10, 11, 50, 100, 150):
            got = adamw.schedule(adamw.AdamWConfig(**kw), step)
            want = jadamw.schedule(jadamw.AdamWConfig(**kw),
                                   jnp.asarray(step))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(adamw.schedule(cfg, 100)) == pytest.approx(0.1)
    with pytest.raises(ValueError, match="unknown gradient compression"):
        adamw.AdamWConfig(compression="fp8")
    assert adamw.AdamWConfig(compression="topk").topk_fraction == 0.05


@pytest.mark.parametrize("clip", [1.0, None, 1e3])
def test_adamw_update_matches(clip):
    """One update on the same grads, twice in a row (the second with bias
    correction past step 1), out of place and in place."""
    rng = np.random.default_rng(1)
    shapes = {"a.w": (16, 32), "b.scale": (32,), "c.table": (64, 16)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: (rng.standard_normal(s) * 0.3).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jst = jadamw.init(jcfg, jp)
    tp = tp0 = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    tst = adamw.init(tcfg, tp)
    tp2 = {n: t.clone() for n, t in tp.items()}
    tst2 = adamw.init(tcfg, tp2)
    for g in grads:
        jp, jst, jm = jadamw.update(jcfg, {n: jnp.asarray(v) for n, v in
                                           g.items()}, jst, jp)
        tg = {n: torch.from_numpy(v) for n, v in g.items()}
        tp, tst, tm = adamw.update(tcfg, tg, tst, tp)
        tp2, tst2, _ = adamw.update(tcfg, tg, tst2, tp2, inplace=True)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for n in shapes:
            for got, want in ((tp[n], jp[n]), (tst.m[n], jst.m[n]),
                              (tst.v[n], jst.v[n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9, err_msg=n)
            assert torch.equal(tp[n], tp2[n])
    assert int(tst.step) == int(jst.step) == 2
    # out of place leaves the inputs alone
    assert all(np.array_equal(tp0[n].numpy(), params[n]) for n in shapes)


# ---------------------------------------------------------------------------
# the train step (train/train_loop.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_the_reference(microbatches):
    """Three masked train steps (premask, microbatches accumulating
    float32 grads) against the reference's jitted step."""
    jcfg, tcfg = _pair("stablelm_3b")
    jmodel, jparams = jax_model_and_params(jcfg)
    model = to_torch_model(jparams, tcfg)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jmake_train_step(jmodel, jadamw.AdamWConfig(**kw),
                                     num_microbatches=microbatches))
    step = make_train_step(model, adamw.AdamWConfig(**kw),
                           num_microbatches=microbatches)
    jp, params = jparams, train_params(model)
    jopt = jadamw.init(jadamw.AdamWConfig(**kw), jp)
    opt = adamw.init(adamw.AdamWConfig(**kw), params)
    for i in range(3):
        batch = _batch(tcfg.vocab_size, seed=i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, i)
        params, opt, m = step(params, opt, batch, i)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert_params_close(params, port_named(jp), kw["lr"])
    # the step updated the model's own tensors in place
    assert all(params[n].data_ptr() == t.data_ptr()
               for n, t in train_params(model).items())


def test_premask_and_eval_step():
    """premask re-applies the pattern to a densified weight; the eval step
    gives the step's loss without touching the parameters."""
    _, tcfg = _pair("stablelm_3b")
    model = to_torch_model(jax_model_and_params(_pair("stablelm_3b")[0])[1],
                           tcfg)
    params = train_params(model)
    from repro_torch.core.sparse_linear import sparse_weights
    sparsity = sparse_weights(model)
    name = "layers.0.mlp.gate.w"
    dense = dict(params, **{name: torch.ones_like(params[name])})
    masked = premask_params(dense, sparsity)[name]
    assert float((masked == 0).float().mean()) > 0.5
    batch = _batch(tcfg.vocab_size)
    before = {n: p.clone() for n, p in params.items()}
    met = make_eval_step(model, policy=MASKED)(params, batch)
    loss, _, _ = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(float(met["loss"]), float(loss), rtol=1e-6)
    assert all(torch.equal(before[n], p) for n, p in params.items())


def test_packed_fine_tuning_grads_and_step():
    """Training the packed model (``mode="packed"``): the packed values are
    parameters and their gradient is the reference's ``jax.grad`` through
    its packed ``train_loss`` (the reference's own packed train step cannot
    differentiate its integer index leaves, so the gradient is taken at the
    values alone); one step keeps the padded slots at 0."""
    from repro.launch.pack_tree import pack_tree as jpack_tree
    from repro_torch.launch.pack_tree import pack_tree
    jcfg, tcfg = _pair("stablelm_3b")
    jmodel, jparams = jax_model_and_params(jcfg)
    jpacked = jpack_tree(jparams)
    batch = _batch(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jwq = jpacked["layers"]["attn"]["wq"]

    def loss_of(values):
        layers = dict(jpacked["layers"], attn=dict(
            jpacked["layers"]["attn"], wq=jwq.replace(values=values)))
        return jmodel.train_loss(dict(jpacked, layers=layers), jb,
                                 policy=JExecPolicy(mode="packed"))[0]

    jloss, jgrad = jax.value_and_grad(loss_of)(jwq.values)
    model = pack_tree(to_torch_model(jparams, tcfg))
    loss, _, grads = _port_loss_and_grads(model, batch,
                                          ExecPolicy(mode="packed"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_close(
        {f"layers.{i}.attn.wq.values": grads[f"layers.{i}.attn.wq.values"]
         for i in range(tcfg.num_layers)},
        {f"layers.{i}.attn.wq.values": np.asarray(jgrad[i])
         for i in range(tcfg.num_layers)})
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    step = make_train_step(model, adamw.AdamWConfig(**kw),
                           policy=ExecPolicy(mode="packed"))
    with torch.no_grad():                     # pad a few slots (value 0)
        model.layers[0].attn.wq.values[:3, 0] = 0.0
    pad = model.layers[0].attn.wq.values == 0
    params = train_params(model)
    assert "layers.0.attn.wq.values" in params
    params, _, m = step(params, adamw.init(adamw.AdamWConfig(**kw), params),
                        batch, 0)
    v0 = model.layers[0].attn.wq.values
    assert bool(pad.any()) and torch.equal(v0 == 0, pad)


# ---------------------------------------------------------------------------
# data (data/pipeline.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structured", [True, False])
def test_data_tokens_bit_identical(structured):
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=8),
               dict(vocab_size=50304, seq_len=33, global_batch=4, seed=7)):
        jc = jpipe.DataConfig(structured=structured, **kw)
        tc = tpipe.DataConfig(structured=structured, **kw)
        for step in (0, 1, 9):
            a, b = jpipe.global_batch(jc, step), tpipe.global_batch(tc, step)
            for k in ("tokens", "targets"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            for h in range(4):
                np.testing.assert_array_equal(
                    jpipe.host_batch(jc, step, h, 4)["tokens"],
                    tpipe.host_batch(tc, step, h, 4)["tokens"])
    it = tpipe.DataIterator(tc)
    it.seek(9)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  tpipe.global_batch(tc, 9)["tokens"])
    assert it.step == 10


# ---------------------------------------------------------------------------
# checkpoints (train/checkpoint.py)
# ---------------------------------------------------------------------------

def _packed_block_q8():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    return quantize_packed(PackedWeight.from_dense(
        w, SparsityConfig(2, 16, 2), layout="block", block_r=8))


def test_checkpoint_roundtrip_with_packed_and_static_nodes(tmp_path):
    _, tcfg = _pair("stablelm_3b")
    model = to_torch_model(jax_model_and_params(_pair("stablelm_3b")[0])[1],
                           tcfg)
    params = train_params(model)
    opt = adamw.init(adamw.AdamWConfig(), params)
    pw = _packed_block_q8()
    half = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    tree = {"params": params, "opt": opt,
            "extra": {"pw": pw, "spec": Static("2:16|every25"),
                      "mask": params["layers.0.attn.wq.w"] > 0,
                      "half": half, "none": None}}
    path = ckpt.save(tree, str(tmp_path), 5)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.load_plan(str(tmp_path)) is None
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    files = {e["path"]: e.get("file") for e in manifest["leaves"]}
    assert files["params/layers/0/attn/wq/w"] == \
        "params__layers__0__attn__wq__w.npy"
    assert "opt/step" in files and "opt/m/embed/table" in files
    node = next(e for e in manifest["nodes"] if e["path"] == "extra/pw")
    assert node["cfg"] == {"n": 2, "m": 16, "k": 2}
    assert node["qdtype"] == "int8" and node["layout"] == "block"
    # a stale template: other sparsity metadata, zeroed tensors
    stale = pw.replace(values=torch.zeros_like(pw.values),
                       cfg=SparsityConfig(4, 16, 1))
    template = {"params": {n: torch.zeros_like(p) for n, p in params.items()},
                "opt": adamw.init(adamw.AdamWConfig(), params),
                "extra": {"pw": stale, "spec": Static("other"),
                          "mask": torch.zeros_like(tree["extra"]["mask"]),
                          "half": torch.zeros_like(half), "none": None}}
    back = ckpt.restore(template, str(tmp_path), 5)
    for n, p in params.items():
        assert torch.equal(back["params"][n], p)
        assert torch.equal(back["opt"].m[n], opt.m[n])
    assert int(back["opt"].step) == 0
    rp = back["extra"]["pw"]
    assert isinstance(rp, PackedWeight) and rp.cfg == pw.cfg
    assert (rp.qdtype, rp.layout, rp.block_geom, rp.dense_shape) == \
        (pw.qdtype, pw.layout, pw.block_geom, pw.dense_shape)
    for c in ("values", "indices", "active_groups", "scales"):
        assert torch.equal(getattr(rp, c), getattr(pw, c))
    assert back["extra"]["spec"] == Static("2:16|every25")
    assert torch.equal(back["extra"]["mask"], tree["extra"]["mask"])
    assert back["extra"]["half"].dtype == torch.bfloat16
    assert torch.equal(back["extra"]["half"], half)
    assert back["extra"]["none"] is None
    assert key_path_str(("params", "layers.0.attn.wq.w")) == \
        "params/layers/0/attn/wq/w"


def test_checkpoint_atomic_commit_and_async(tmp_path):
    params = {"a.w": torch.ones(4, 4), "b": torch.zeros(3)}
    os.makedirs(tmp_path / "step_00000009.tmp")      # a save that died
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save({"p": params}, str(tmp_path), 1)
    assert not [d for d in os.listdir(tmp_path)
                if d.endswith(".tmp") and "00000001" in d]
    fut = ckpt.save_async({"p": params}, str(tmp_path), 2)
    params["a.w"].add_(1.0)            # an in-place update after the call
    fut.result(timeout=60)
    assert ckpt.latest_step(str(tmp_path)) == 2
    back = ckpt.restore({"p": {"a.w": torch.empty(4, 4), "b": None}},
                        str(tmp_path), 2)
    assert torch.equal(back["p"]["a.w"], torch.ones(4, 4))


# ---------------------------------------------------------------------------
# fault tolerance (train/fault_tolerance.py)
# ---------------------------------------------------------------------------

def test_restart_resumes_bitwise(tmp_path):
    """An injected failure and restore reproduce the uninterrupted
    trajectory bit for bit (async saves; the step updates in place)."""
    jcfg, tcfg = _pair("stablelm_3b")
    _, jparams = jax_model_and_params(jcfg)
    model = to_torch_model(jparams, tcfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=1)
    data_cfg = tpipe.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                global_batch=4)
    step = make_train_step(model, opt_cfg)
    start = {n: p.clone() for n, p in train_params(model).items()}

    def run(ckpt_dir, injector):
        params = {n: p.clone() for n, p in start.items()}
        opt = adamw.init(opt_cfg, params)
        sup = TrainingSupervisor(
            SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=4,
                             async_save=True), step, data_cfg)
        return sup.run(params, opt, 12, failure_injector=injector)

    p_ok, o_ok, _, r_ok = run(str(tmp_path / "a"), None)
    p_f, o_f, _, r_f = run(str(tmp_path / "b"), inject_failure_once(9))
    assert r_ok == 0 and r_f == 1
    for n in p_ok:
        assert torch.equal(p_ok[n], p_f[n]), n
        assert torch.equal(o_ok.v[n], o_f.v[n]), n


def test_straggler_monitor_flags_and_rebalances():
    from repro_torch import obs
    reg = obs.MetricsRegistry()
    mon = StragglerMonitor(num_hosts=8, threshold=1.4, metrics=reg)
    for _ in range(5):
        times = np.full(8, 1.0)
        times[3] = 2.5
        mon.record(times)
    rep = mon.report()
    assert rep.flagged_hosts == [3]
    assert rep.suggestion[3] < 0.5 and rep.suggestion[0] == 1.0
    assert reg.gauge("train_stragglers_flagged").value == 1


# ---------------------------------------------------------------------------
# the command lines (launch/train.py, launch/serve.py --ckpt-dir)
# ---------------------------------------------------------------------------

def test_train_cli_then_serve_the_checkpoint(tmp_path, capsys):
    """``launch.train --device cpu`` trains (the loss falls) and
    checkpoints; ``launch.serve --device cpu --ckpt-dir`` serves exactly the
    tokens that the trained parameters in memory give."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import run_serve
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.families import build_model

    d = str(tmp_path / "ckpt")
    out = train_main(["--device", "cpu", "--steps", "12", "--batch", "8",
                      "--seq", "32", "--lr", "3e-3", "--ckpt-dir", d,
                      "--ckpt-every", "5", "--metrics-out",
                      str(tmp_path / "m.json")])
    assert out["reduced"] and out["restarts"] == 0
    assert out["losses"][-1] < out["losses"][0]
    assert ckpt.latest_step(d) == 12 and out["ckpt_bytes"] > 0
    assert json.load(open(tmp_path / "m.json"))["counters"]
    args = ["--device", "cpu", "--ckpt-dir", d, "--packed", "--backend",
            "reference", "--requests", "3", "--max-new", "4", "--max-len",
            "24"]
    engine = serve_main(args)
    served = {r.uid: r.output for r in engine.completed}
    cfg = get_arch("stablelm_3b").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    load_params(model, out["params"])
    mem = run_serve(model, cfg.vocab_size, packed=True, backend="reference",
                    requests=3, max_new=4, max_len=24, device="cpu")
    assert served == {r.uid: r.output for r in mem.completed}
    # a checkpoint of another arch or shape is refused by name
    with pytest.raises(SystemExit):
        serve_main(args + ["--arch", "gemma3_1b"])
    assert "lacks" in capsys.readouterr().err
    from repro_torch.launch.serve import restore_checkpoint
    other = build_model(dataclasses.replace(cfg, d_ff=128), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        restore_checkpoint(other, d)


def test_sparsify_qat_cli_bakes_verified_masks(tmp_path):
    from repro_torch.launch.train import main as train_main
    d = str(tmp_path / "ckpt")
    out = train_main(["--device", "cpu", "--steps", "8", "--batch", "4",
                      "--seq", "16", "--lr", "3e-3", "--ckpt-dir", d,
                      "--sparsify", "8:128", "--qat", "int8",
                      "--sparsify-update-every", "2"])
    assert out["sparse_linears_verified"] == 14
    from repro_torch.launch.serve import main as serve_main
    for layout in ("xwT", "block"):
        engine = serve_main(["--device", "cpu", "--ckpt-dir", d, "--packed",
                             "--quantize", "int8", "--layout", layout,
                             "--backend", "reference", "--requests", "2",
                             "--max-new", "3", "--max-len", "24"])
        assert len(engine.completed) == 2
