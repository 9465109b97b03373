"""Port vs JAX package: the packed ops' gradients, pruning, fake quantization,
sparsification schedules and the sparse trainer (``repro_torch.sparsetrain``,
``repro_torch.core.pruning``, the backward of ``repro_torch.kernels.ops``).

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port, on the CPU.  Tolerances: gradients of one packed
op rtol/atol 1e-5 (float32 products summed in another order); masks, fake
quantization, schedules and restarts exact.  Models are reduced
``stablelm_3b`` in float32 compute; a few steps each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpruning
from repro.core.sparsity import PackedWeight as JPackedWeight
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro.core.sparsity import pack_block as jpack_block
from repro.core.sparsity import random_sparse_dense
from repro.kernels import ops as jops
from repro.optim import adamw as jadamw
from repro.quant import quantize_packed as jquantize_packed
from repro.sparsetrain import SparseTrainRecipe as JRecipe
from repro.sparsetrain import SparseTrainer as JTrainer
from repro.sparsetrain import masks as jmasks
from repro.sparsetrain import ste as jste
from repro.sparsetrain import vjp as jvjp

from _torch_port import (jax_model_and_params, port_named, reduced_pair,
                         to_torch_model)
from repro_torch.core import pruning as tpruning
from repro_torch.core.sparse_linear import sparse_weights
from repro_torch.core.sparsity import (PackedWeight, SparsityConfig,
                                       pack_block, satisfies_pattern, unpack)
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ops as tops
from repro_torch.launch.pack_tree import pack_tree
from repro_torch.optim import adamw
from repro_torch.quant import quantize_packed
from repro_torch.sparsetrain import (SparseTrainRecipe, SparseTrainer,
                                     anneal_schedule, build_masks,
                                     fake_quant_weight, init_mask_state,
                                     parse_pattern, parse_schedule,
                                     update_mask_state)
from repro_torch.sparsetrain import masks as tmasks
from repro_torch.train.fault_tolerance import (SupervisorConfig,
                                               TrainingSupervisor,
                                               inject_failure_once)
from repro_torch.train.train_loop import train_params

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
CFG = (2, 16)


def _data(key=0, o=24, k=64, b=5, underfull=False):
    """A weight satisfying 2:16 (``underfull``: every third group holds one
    non-zero, so packing pads slots), x and dy."""
    rng = np.random.default_rng(key)
    w = random_sparse_dense(rng, o, k, JSparsityConfig(*CFG))
    if underfull:
        g = w.reshape(o, k // 16, 16)
        for r in range(o):
            for j in range(r % 3, k // 16, 3):
                nz = np.flatnonzero(g[r, j])
                g[r, j, nz[1:]] = 0
        w = g.reshape(o, k)
    x = rng.standard_normal((b, k)).astype(np.float32)
    dy = rng.standard_normal((b, o)).astype(np.float32)
    return w.astype(np.float32), x, dy


def _jax_packed(w, layout):
    cfg = JSparsityConfig(*CFG)
    if layout == "block":
        return jpack_block(jnp.asarray(w), cfg, block_r=8)
    return JPackedWeight.from_dense(jnp.asarray(w), cfg)


def _port_packed(jpw, grad=True):
    """The port's PackedWeight of the same arrays, float values (and
    scales) requiring grad."""
    def t(a, dtype=None, req=False):
        out = torch.from_numpy(np.array(a))
        out = out.to(dtype) if dtype is not None else out
        return out.requires_grad_(req and grad and out.is_floating_point())

    scales = None if jpw.scales is None else t(jpw.scales, req=True)
    ag = (None if jpw.active_groups is None
          else t(jpw.active_groups, torch.int32))
    return PackedWeight(
        t(jpw.values, req=jpw.qdtype is None), t(jpw.indices, torch.int32),
        cfg=SparsityConfig(*CFG), dense_shape=jpw.dense_shape,
        layout=jpw.layout, active_groups=ag, block_geom=jpw.block_geom,
        scales=scales, qdtype=jpw.qdtype)


def _jax_grads(jpw, x, dy, argnames):
    """jax.grad of sum(y * dy) through the reference forward of the JAX
    package's packed op, w.r.t. x and the named operands."""
    cfg, shape = jpw.cfg, tuple(jpw.dense_shape)

    def f(xx, vv, ss):
        if jpw.layout == "block":
            if jpw.qdtype is None:
                y = jvjp.xwT_block_grad(xx, vv, jpw.indices,
                                        jpw.active_groups, cfg, shape)
            else:
                y = jvjp.xwT_block_q8_grad(xx, jpw.values, jpw.indices,
                                           jpw.active_groups, ss, cfg, shape)
        elif jpw.qdtype is None:
            y = jops.demm_matmul_xwT(xx, vv, jpw.indices, cfg, shape)
        else:
            y = jvjp.xwT_q8_grad(xx, jpw.values, jpw.indices, ss, cfg, shape)
        return jnp.sum(y * dy)

    argnums = tuple({"x": 0, "values": 1, "scales": 2}[a] for a in argnames)
    gs = jax.grad(f, argnums=argnums)(jnp.asarray(x), jpw.values, jpw.scales)
    return [np.asarray(g) for g in gs]


def _port_grads(pw, x, dy, backend, argnames):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tops.demm_matmul_packed(xt, pw, backend=backend)
    ops = {"x": xt, "values": pw.values, "scales": pw.scales}
    gs = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                             [ops[a] for a in argnames])
    return [g.numpy() for g in gs]


# ---------------------------------------------------------------------------
# the packed ops' gradients (kernels/ops.py, sparsetrain/vjp.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_float_packed_grads_match(layout, backend):
    """dx and dvalues through the port's op (backend ``cuda`` on CPU
    tensors runs the kernel's plain version) equal ``jax.grad`` through the
    reference's."""
    w, x, dy = _data()
    jpw = _jax_packed(w, layout)
    want = _jax_grads(jpw, x, dy, ("x", "values"))
    got = _port_grads(_port_packed(jpw), x, dy, backend, ("x", "values"))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, **GRAD_TOL)


@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_padded_slots_get_zero_gradient(layout):
    w, x, dy = _data(key=3, underfull=True)
    pw = _port_packed(_jax_packed(w, layout))
    pad = (pw.values == 0).detach()
    assert bool(pad.any())
    (gv,) = _port_grads(pw, x, dy, "reference", ("values",))
    assert (gv[pad.numpy()] == 0).all()
    assert (gv[~pad.numpy()] != 0).any()


@pytest.mark.parametrize("granularity", ["per_row", "per_group"])
def test_q8_grads_match(granularity):
    """The int8 xwT op: dx and dL/dscales as the reference's; the int8
    values get none."""
    w, x, dy = _data(key=1)
    jq = jquantize_packed(_jax_packed(w, "xwT"), granularity=granularity)
    want = _jax_grads(jq, x, dy, ("x", "scales"))
    pq = _port_packed(jq)
    assert not pq.values.requires_grad          # int8
    got = _port_grads(pq, x, dy, "reference", ("x", "scales"))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, **GRAD_TOL)


def test_block_q8_grads_match():
    w, x, dy = _data(key=2, o=32)
    jq = jquantize_packed(_jax_packed(w, "block"))
    want = _jax_grads(jq, x, dy, ("x", "scales"))
    got = _port_grads(_port_packed(jq), x, dy, "cuda", ("x", "scales"))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, **GRAD_TOL)


def test_grad_mode_decides_whether_history_is_recorded():
    """Serving (inference mode, or no operand requiring grad) calls the
    variant directly; under grad the output carries the op's backward; a
    draft-tier view refuses grad."""
    w, x, _ = _data()
    pw = _port_packed(_jax_packed(w, "xwT"))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        assert tops.demm_matmul_packed(xt, pw).grad_fn is None
    with torch.no_grad():
        assert tops.demm_matmul_packed(xt, pw).grad_fn is None
    assert tops.demm_matmul_packed(xt, _port_packed(
        _jax_packed(w, "xwT"), grad=False)).grad_fn is None
    assert tops.demm_matmul_packed(xt, pw).grad_fn is not None
    with pytest.raises(ValueError, match="serving-only"):
        tops.demm_matmul_packed(xt, pw.replace(tier_ne=1))
    with torch.no_grad():
        tops.demm_matmul_packed(xt, pw.replace(tier_ne=1))


# ---------------------------------------------------------------------------
# pruning (core/pruning.py)
# ---------------------------------------------------------------------------

def test_straight_through_mask_and_masked_weight():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((16, 64)).astype(np.float32)
    w[:, ::5] = w[:, 1::5][:, :w[:, ::5].shape[1]]        # ties in magnitude
    cfg = SparsityConfig(*CFG)
    want = np.asarray(jpruning.masked_weight(jnp.asarray(w),
                                             JSparsityConfig(*CFG)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tpruning.masked_weight(wt, cfg)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got.sum(), wt)
    np.testing.assert_array_equal(g.numpy(), np.ones_like(w))
    mask = torch.from_numpy(np.array(jpruning.init_mask(
        jnp.asarray(w), JSparsityConfig(*CFG))))
    assert torch.equal(tpruning.init_mask(torch.from_numpy(w), cfg), mask)


@pytest.mark.parametrize("n,m,frac", [(2, 16, 0.3), (4, 16, 0.5),
                                      (1, 8, 0.3)])
def test_rigl_update_mask_bit_equal_with_ties(n, m, frac):
    """Kept slots by |w|, regrown ones by |grad|, ties (equal magnitudes,
    zero gradients) resolved as ``lax.top_k`` resolves them."""
    rng = np.random.default_rng(n * 100 + m)
    w = np.round(rng.standard_normal((12, 4 * m)), 1).astype(np.float32)
    grad = np.round(rng.standard_normal((12, 4 * m)), 1).astype(np.float32)
    grad[:, ::3] = 0.0
    jcfg = JSparsityConfig(n, m)
    mask = np.array(jpruning.init_mask(jnp.asarray(w), jcfg))
    jsched = jpruning.PruneSchedule(jcfg, regrow_fraction=frac)
    want = np.asarray(jpruning.rigl_update_mask(
        jnp.asarray(w), jnp.asarray(mask), jnp.asarray(grad), jsched))
    tsched = tpruning.PruneSchedule(SparsityConfig(n, m),
                                    regrow_fraction=frac)
    got = tpruning.rigl_update_mask(torch.from_numpy(w),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(grad), tsched)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.reshape(12, 4, m).sum(-1) == n).all()
    # on schedule: due at multiples of update_every, not after the stop
    sched = dataclasses.replace(tsched, update_every=4, stop_update_after=9)
    args = (torch.from_numpy(w), torch.from_numpy(mask),
            torch.from_numpy(grad), sched)
    assert torch.equal(tpruning.maybe_update_mask(8, *args), got)
    assert torch.equal(tpruning.maybe_update_mask(6, *args),
                       torch.from_numpy(mask))
    assert torch.equal(tpruning.maybe_update_mask(12, *args),
                       torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# fake quantization (sparsetrain/ste.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("granularity", ["per_row", "per_group"])
def test_fake_quant_is_the_served_int8_grid(granularity):
    """Fake quantization of the masked weight equals the dequantized image
    of the port's packed int8 weight and the reference's fake quantization,
    bit for bit."""
    w, _, _ = _data(key=5)
    cfg = SparsityConfig(*CFG)
    fq = fake_quant_weight(torch.from_numpy(w), m=cfg.m,
                           granularity=granularity)
    q = quantize_packed(PackedWeight.from_dense(torch.from_numpy(w), cfg),
                        granularity=granularity)
    np.testing.assert_array_equal(fq.numpy(), q.to_dense().numpy())
    ref = jste.fake_quant_weight(jnp.asarray(w), m=cfg.m,
                                 granularity=granularity)
    np.testing.assert_array_equal(fq.numpy(), np.asarray(ref))


def test_fake_quant_gradient_matches():
    """Straight-through round, inclusive clip: all ones on amax scales;
    weights beyond a tighter grid get none, as in the reference."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((8, 32)).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_(True)
    (g,) = torch.autograd.grad(fake_quant_weight(wt).sum(), wt)
    np.testing.assert_array_equal(g.numpy(), np.ones_like(w))
    s = np.full((8, 1), 0.005, np.float32)        # clips the large weights
    from repro_torch.sparsetrain.ste import fake_quant
    (g,) = torch.autograd.grad(
        fake_quant(wt, torch.from_numpy(s)).sum(), wt)
    want = jax.grad(lambda v: jnp.sum(jste.fake_quant(v, jnp.asarray(s))))(
        jnp.asarray(w))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert (g.numpy() == 0).any()


# ---------------------------------------------------------------------------
# schedules and mask state (sparsetrain/masks.py)
# ---------------------------------------------------------------------------

def test_schedules_parse_as_the_reference():
    for spec, total, kw in [("8:128", 100, {}), ("8:128:2", 40, {}),
                            ("dense@0,8:256@50,8:128@150", 200, {}),
                            ("2:16", 12, {"update_every": 3,
                                          "freeze_after": 7})]:
        got = parse_schedule(spec, total, **kw)
        want = jmasks.parse_schedule(spec, total, **kw)
        assert got.spec() == want.spec()
        assert [got.phase_index(s) for s in range(total + 2)] == \
            [want.phase_index(s) for s in range(total + 2)]
    p = parse_pattern("8:128:2")
    assert (p.n, p.m, p.k) == (8, 128, 2)
    assert anneal_schedule(p, 10).spec() == \
        jmasks.anneal_schedule(JSparsityConfig(8, 128, 2), 10).spec()
    for bad in ("8", "8:128:2:1"):
        with pytest.raises(ValueError):
            parse_pattern(bad)
    with pytest.raises(ValueError, match="final phase"):
        parse_schedule("dense@0,2:16@20", 10)
    with pytest.raises(ValueError, match="'@step'"):
        parse_schedule("dense@0,2:16", 10)
    for phases in ((), (tmasks.SparsifyPhase(1, SparsityConfig(2, 16)),),
                   (tmasks.SparsifyPhase(0, None),)):
        with pytest.raises(ValueError):
            tmasks.SparsifySchedule(phases=phases)
    for phase_cfg, node, k, final in [((2, 32), (2, 16), 64, False),
                                      ((2, 32), (3, 48), 144, False),
                                      ((2, 32), (2, 16), 48, True),
                                      (None, (2, 16), 64, False)]:
        got = tmasks.node_phase_cfg(
            None if phase_cfg is None else SparsityConfig(*phase_cfg),
            SparsityConfig(*node), k, final)
        want = jmasks.node_phase_cfg(
            None if phase_cfg is None else JSparsityConfig(*phase_cfg),
            JSparsityConfig(*node), k, final)
        assert (got is None and want is None) or \
            (got.n, got.m, got.k) == (want.n, want.m, want.k)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = reduced_pair()
    jmodel, jparams = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, jparams


def test_masks_and_state_cadence_match_the_reference(small):
    """Masks at every phase bit-equal to the reference's; refreshes on
    phase transitions and every ``update_every`` steps until the freeze,
    at the same steps."""
    jcfg, tcfg, _, jparams = small
    model = to_torch_model(jparams, tcfg)
    params, sparsity = train_params(model), sparse_weights(model)
    spec = "dense@0,2:32@2,2:16@5"
    sched = dataclasses.replace(parse_schedule(spec, 20, update_every=3),
                                freeze_after=9)
    jsched = dataclasses.replace(jmasks.parse_schedule(spec, 20,
                                                       update_every=3),
                                 freeze_after=9)
    for phase in range(3):
        got = build_masks(params, sparsity, sched, phase)
        # the reference's mask sits in place of the sparse node ({"w", ...})
        want = {n + ".w": m for n, m in port_named(
            jmasks.build_masks(jparams, jsched, phase)).items()}
        assert set(got) == set(want)
        for n, m in got.items():
            np.testing.assert_array_equal(m.numpy(), want[n])
            if phase == 2:
                assert satisfies_pattern((params[n] * m).reshape(
                    -1, m.shape[-1]), sparsity[n])
    state = init_mask_state(params, sparsity, sched, 0)
    jstate = jmasks.init_mask_state(jparams, jsched, 0)
    for step in range(1, 14):
        state, changed = update_mask_state(params, sparsity, state, sched,
                                           step)
        jstate, jchanged = jmasks.update_mask_state(jparams, jstate, jsched,
                                                    step)
        assert changed == jchanged, step
        assert int(state["phase"]) == int(jstate["phase"])
        assert int(state["last_update"]) == int(jstate["last_update"])


# ---------------------------------------------------------------------------
# the sparse trainer (sparsetrain/recipes.py)
# ---------------------------------------------------------------------------

def _batch(vocab, seed=0, b=4, t=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, t)).astype(np.int32)}


def test_sparse_trainer_with_qat_matches_the_reference(small):
    """Four steps across the dense → 2:32 → 2:16 schedule with int8 QAT:
    the same losses (rtol 1e-5) and parameters (atol 1e-5, a tenth of one
    step's size, lr 1e-4) as the reference's SparseTrainer."""
    jcfg, tcfg, jmodel, jparams = small
    model = to_torch_model(jparams, tcfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, total_steps=4, warmup_steps=1)
    jopt_cfg = jadamw.AdamWConfig(lr=1e-4, total_steps=4, warmup_steps=1)
    spec = "dense@0,2:32@1,2:16@2"
    trainer = SparseTrainer(model, opt_cfg, SparseTrainRecipe(
        parse_schedule(spec, 4, update_every=1), qat="int8"))
    jtrainer = JTrainer(jmodel, jopt_cfg, JRecipe(
        jmasks.parse_schedule(spec, 4, update_every=1), qat="int8"))
    params = train_params(model)
    trainer.init_state(params)
    jtrainer.init_state(jparams)
    opt, jopt, jp = adamw.init(opt_cfg, params), jadamw.init(
        jopt_cfg, jparams), jparams
    for step in range(4):
        batch = _batch(tcfg.vocab_size, seed=step)
        params, opt, m = trainer.train_step(params, opt, batch, step)
        jp, jopt, jm = jtrainer.train_step(
            jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()}, step)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    want = port_named(jp)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0, atol=1e-5,
                                   err_msg=n)


def _run_sparse(model, params, opt_cfg, data_cfg, ckpt_dir, steps,
                injector=None, spec="2:16", update_every=25):
    trainer = SparseTrainer(model, opt_cfg, SparseTrainRecipe(
        parse_schedule(spec, steps, update_every=update_every), qat="int8"))
    params = {n: p.clone() for n, p in params.items()}
    trainer.init_state(params)
    opt = adamw.init(opt_cfg, params)
    sup = TrainingSupervisor(SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=4),
                             trainer.train_step, data_cfg,
                             extra_state=trainer)
    p, o, _, restarts = sup.run(params, opt, steps, failure_injector=injector)
    return p, o, trainer, restarts


def test_resume_mid_schedule_bitwise(tmp_path, small):
    """A failure and restore mid-schedule reproduce the uninterrupted run
    bit for bit: parameters, AdamW state and mask state."""
    _, tcfg, _, jparams = small
    model = to_torch_model(jparams, tcfg)
    params = train_params(model)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=12, warmup_steps=1)
    data_cfg = DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                          global_batch=4)
    p_ok, o_ok, tr_ok, r_ok = _run_sparse(model, params, opt_cfg, data_cfg,
                                          str(tmp_path / "a"), 12)
    p_f, o_f, tr_f, r_f = _run_sparse(model, params, opt_cfg, data_cfg,
                                      str(tmp_path / "b"), 12,
                                      injector=inject_failure_once(9))
    assert r_ok == 0 and r_f == 1
    for n in p_ok:
        assert torch.equal(p_ok[n], p_f[n]), n
        assert torch.equal(o_ok.m[n], o_f.m[n]) and \
            torch.equal(o_ok.v[n], o_f.v[n]), n
    assert int(o_ok.step) == int(o_f.step) == 12
    assert int(tr_ok.state["phase"]) == int(tr_f.state["phase"])
    assert int(tr_ok.state["last_update"]) == \
        int(tr_f.state["last_update"])
    for n, m in tr_ok.state["masks"].items():
        assert torch.equal(m, tr_f.state["masks"][n]), n


def test_resume_with_a_different_schedule_raises(small):
    _, tcfg, _, jparams = small
    model = to_torch_model(jparams, tcfg)
    params = train_params(model)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=6, warmup_steps=1)
    a = SparseTrainer(model, opt_cfg,
                      SparseTrainRecipe(parse_schedule("2:16", 6)))
    a.init_state(params)
    b = SparseTrainer(model, opt_cfg, SparseTrainRecipe(
        parse_schedule("2:16", 6, update_every=7)))
    with pytest.raises(ValueError, match="schedule"):
        b.load_extra_state(a.extra_state())
    with pytest.raises(RuntimeError, match="init_state"):
        b.train_step(params, None, None, 0)
    with pytest.raises(ValueError, match="QAT"):
        SparseTrainRecipe(parse_schedule("2:16", 6), qat="int4")


def test_finalize_bakes_masks_then_packs(small):
    """finalize() makes every sparse weight satisfy its pattern, so it
    packs losslessly: the packed model's loss equals the masked one's."""
    _, tcfg, _, jparams = small
    model = to_torch_model(jparams, tcfg)
    params = train_params(model)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    trainer = SparseTrainer(model, opt_cfg,
                            SparseTrainRecipe(parse_schedule("2:16", 4)))
    trainer.init_state(params, step=3)            # the final phase
    baked = trainer.finalize(params)
    from repro_torch.launch.train import verify_final_masks
    assert verify_final_masks(baked, trainer.sparsity) == 14
    from repro_torch.train.train_loop import load_params
    load_params(model, baked)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(tcfg.vocab_size).items()}
    with torch.no_grad():
        masked, _ = model.train_loss(batch)
        for n, w in baked.items():
            if n in trainer.sparsity:
                packed = PackedWeight.from_dense(w, trainer.sparsity[n])
                np.testing.assert_array_equal(
                    unpack(packed.values, packed.indices, packed.cfg,
                           packed.dense_shape).numpy(), w.numpy())
        pack_tree(model)
        packed_loss, _ = model.train_loss(batch)
    np.testing.assert_allclose(float(packed_loss), float(masked), rtol=1e-6)
