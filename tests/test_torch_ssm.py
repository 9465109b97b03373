"""Port vs JAX package: the state-space mixers (``models/ssm.py``: Mamba2's
SSD chunked sequence form and its step, mLSTM's stabilised chunked form and
its step, sLSTM's time loop and its step) and the two recurrent families
built on them (``zamba2_7b``: Mamba2 layers with one shared attention
block; ``xlstm_125m``: periods of mLSTM blocks and one sLSTM block).

The same inputs, made with numpy from a seed, go through the JAX function and
its port on the CPU; weights reach the port through
``repro_torch.convert.from_jax_params`` (a mixer alone through its node
converter).  Reduced configs, float32 compute.  Tolerances: mixer outputs
and states rtol/atol 1e-5 (the chunked scans' sums in another order);
``train_loss`` rtol 1e-5 and its gradients as ``test_torch_train.py`` holds
them; prefill and decode logits and the recurrent states rtol/atol 1e-4
(through every layer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_linear import ExecPolicy as JPolicy
from repro.models import ssm as jssm

from _torch_port import (assert_grads_close, decode_both, family_batch,
                         family_pair, family_setup, jax_model_and_params,
                         loss_and_grads_both, state_arrays, to_torch_model,
                         torch_batch)
from repro_torch import convert
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.models import ssm as tssm
from repro_torch.models.families import HybridLM, XLSTMLM
from repro_torch.train.train_loop import train_params

MIX = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
D = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(t, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, t, D)).astype(
        np.float32)


def _assert_states(got: dict, want: dict, tol=MIX):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------

MAMBA = dict(expand=2, state=8, head_dim=16)


@pytest.fixture(scope="module")
def mamba():
    params = jssm.init_mamba2(jax.random.PRNGKey(0), D, conv=4, **MAMBA)
    # a nonzero A_log, D and dt_bias (the reference initialises 0, 1, 0)
    rng = np.random.default_rng(5)
    for k in ("A_log", "D", "dt_bias"):
        params[k] = jnp.asarray(rng.uniform(-1, 1, params[k].shape),
                                jnp.float32)
    return params, convert._mamba(_np(params), "cpu", None)


@pytest.mark.parametrize("t,chunk", [(20, 8), (8, 8), (5, 16)])
def test_mamba2_seq_matches(mamba, t, chunk):
    """SSD chunked over T = 20 in chunks of 8 (the last one padded), one
    whole chunk, and one chunk longer than the sequence."""
    params, port = mamba
    x = _inputs(t)
    want = jssm.apply_mamba2_seq(params, jnp.asarray(x), chunk=chunk,
                                 **MAMBA)
    got = tssm.apply_mamba2_seq(port, torch.from_numpy(x), chunk=chunk,
                                **MAMBA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX)


def test_mamba2_seq_gradients_stay_finite_where_the_decay_overflows(mamba):
    """A chunk of 64 steps with dt about 20 a step: above the diagonal the
    chunk's log decay reaches +1,260 and its exp overflows.  The outputs
    equal the reference's; the port masks before the exp, so every
    gradient is finite, where the reference's ``where`` after the exp gives
    nan (0 x inf in the backward; a forward-identical difference, filed in
    ROADMAP Queue 3)."""
    import copy
    params, port = mamba
    params = dict(params, dt_bias=jnp.full_like(params["dt_bias"], 20.0),
                  A_log=jnp.zeros_like(params["A_log"]))
    port = copy.deepcopy(port)
    port.dt_bias.data.fill_(20.0)
    port.A_log.data.zero_()
    x = _inputs(64, seed=3)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y = jssm.apply_mamba2_seq(p, xx, chunk=64, **MAMBA)
        return (y * cot).sum(), y

    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(x))
    leaves = {"conv_w": port.conv_w, "A_log": port.A_log,
              "dt_bias": port.dt_bias, "D": port.D}
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tssm.apply_mamba2_seq(port, xt, chunk=64, **MAMBA)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                [*leaves.values(), xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **MIX)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not np.isfinite(np.asarray(jgx)).all()


def test_mamba2_steps_match_and_write_the_state_in_place(mamba):
    params, port = mamba
    x = _inputs(4, seed=1)
    jst = jssm.init_mamba2_state(2, D, conv=4, **MAMBA)
    tst = tssm.init_mamba2_state(2, D, conv=4, **MAMBA)
    ptrs = {k: v.data_ptr() for k, v in tst.items()}
    for i in range(4):
        want, jst = jssm.apply_mamba2_step(params, jnp.asarray(x[:, i:i + 1]),
                                           jst, **MAMBA)
        got, out = tssm.apply_mamba2_step(port, torch.from_numpy(
            x[:, i:i + 1]), tst, **MAMBA)
        assert out is tst and {k: v.data_ptr() for k, v in tst.items()} \
            == ptrs
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX)
        _assert_states(tst, jst)


def test_mamba2_step_promotes_a_bf16_input_against_a_float32_state(mamba):
    """bf16 activations meet the engines' float32 conv window: the window
    is concatenated in float32 and the conv output cast back, as
    ``jnp.concatenate`` promotes (the state keeps its dtype)."""
    params, port = mamba
    x = _inputs(1, seed=2)
    want, jst = jssm.apply_mamba2_step(
        params, jnp.asarray(x, jnp.bfloat16),
        jssm.init_mamba2_state(2, D, conv=4, **MAMBA), **MAMBA)
    tst = tssm.init_mamba2_state(2, D, conv=4, **MAMBA)
    got, _ = tssm.apply_mamba2_step(
        port, torch.from_numpy(x).to(torch.bfloat16), tst, **MAMBA)
    assert got.dtype == torch.bfloat16 and tst["conv"].dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(tst["conv"].numpy(),
                               np.asarray(jst["conv"], np.float32))


@pytest.fixture(scope="module")
def mlstm():
    params = jssm.init_mlstm(jax.random.PRNGKey(1), D, heads=4)
    return params, convert._mlstm(_np(params), "cpu", None)


@pytest.mark.parametrize("t,chunk", [(20, 8), (6, 16)])
def test_mlstm_seq_matches(mlstm, t, chunk):
    params, port = mlstm
    x = _inputs(t, seed=3)
    want = jssm.apply_mlstm_seq(params, jnp.asarray(x), heads=4, chunk=chunk)
    got = tssm.apply_mlstm_seq(port, torch.from_numpy(x), heads=4,
                               chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX)


def test_mlstm_steps_match(mlstm):
    params, port = mlstm
    x = _inputs(4, seed=4)
    jst = jssm.init_mlstm_state(2, D, heads=4)
    tst = tssm.init_mlstm_state(2, D, heads=4)
    for i in range(4):
        want, jst = jssm.apply_mlstm_step(params, jnp.asarray(x[:, i:i + 1]),
                                          jst, heads=4)
        got, _ = tssm.apply_mlstm_step(port, torch.from_numpy(x[:, i:i + 1]),
                                       tst, heads=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX)
        _assert_states(tst, jst)


@pytest.fixture(scope="module")
def slstm():
    params = jssm.init_slstm(jax.random.PRNGKey(2), D, heads=4)
    return params, convert._slstm(_np(params), "cpu", None)


def test_slstm_seq_and_steps_match(slstm):
    params, port = slstm
    x = _inputs(7, seed=5)
    want = jssm.apply_slstm_seq(params, jnp.asarray(x), heads=4)
    got = tssm.apply_slstm_seq(port, torch.from_numpy(x), heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX)
    jst = jssm.init_slstm_state(2, D, heads=4)
    tst = tssm.init_slstm_state(2, D, heads=4)
    for i in range(3):
        want, jst = jssm.apply_slstm_step(params, jnp.asarray(x[:, i:i + 1]),
                                          jst, heads=4)
        got, _ = tssm.apply_slstm_step(port, torch.from_numpy(x[:, i:i + 1]),
                                       tst, heads=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX)
        _assert_states(tst, jst)


# ---------------------------------------------------------------------------
# the families: zamba2 (hybrid), xlstm (ssm)
# ---------------------------------------------------------------------------

ARCHS = ("zamba2_7b", "xlstm_125m")


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return (request.param, *family_setup(request.param))


def test_reduced_layouts_are_the_reference_ones():
    """``reduced()`` gives the reference's shapes: zamba2 5 layers at
    ``shared_attn_every`` 2 (2 periods and a tail of 1), xlstm
    ``num_layers = slstm_every``; and the full configs' layouts."""
    for arch in ARCHS:
        jcfg, tcfg = family_pair(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    z = family_pair("zamba2_7b")[1]
    assert (z.num_layers, z.shared_attn_every) == (5, 2)
    x = family_pair("xlstm_125m")[1]
    assert x.num_layers == x.ssm.slstm_every == 4
    from repro_torch.configs.base import get_arch
    full = get_arch("zamba2_7b")
    assert HybridLM.layout(full) == (6, 13, 3)
    assert XLSTMLM.layout(get_arch("xlstm_125m")) == (4, 3)


def test_train_loss_and_grads_match(family):
    arch, jcfg, tcfg, jmodel, params = family
    batch = family_batch(tcfg, t=20)        # past a chunk of 16
    (loss, met, grads), (jloss, jmet, jgrads) = loss_and_grads_both(
        jmodel, params, to_torch_model(params, tcfg), batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(met) == set(jmet) == {"xent"}
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("arch,remat", [("zamba2_7b", "none"),
                                         ("xlstm_125m", "dots")])
def test_remat_modes_give_the_same_grads(arch, remat):
    """The period bodies under remat ``full`` (the config's) against
    ``none`` (zamba2) and ``dots`` (xlstm): the same loss and gradients bit
    for bit, the shared block's included."""
    jcfg, tcfg, jmodel, params = family_setup(arch)
    batch = torch_batch(family_batch(tcfg, t=8))

    def run(cfg):
        model = to_torch_model(params, cfg)
        leaves = {n: p.clone().requires_grad_(True)
                  for n, p in train_params(model).items()}
        loss, _ = torch.func.functional_call(
            model, leaves, (batch,), {"policy": ExecPolicy(mode="masked")})
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    loss0, g0 = run(tcfg)
    loss1, g1 = run(dataclasses.replace(tcfg, remat=remat))
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_prefill_matches_and_equals_decoding_the_prompt(family):
    """Prefill's last logits against the reference's, and against the
    port's own token-by-token decode of the same prompt (the reference's
    invariant, ``tests/test_models_smoke.py``, here in float32)."""
    arch, jcfg, tcfg, jmodel, params = family
    tokens = family_batch(tcfg, b=1, t=10, seed=3)["tokens"]
    jlogits, _ = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, policy=JPolicy(mode="masked")))(
        params, jnp.asarray(tokens))
    tmodel = to_torch_model(params, tcfg)
    policy = ExecPolicy(mode="masked")
    with torch.inference_mode():
        logits, state = tmodel.prefill({"tokens": torch.from_numpy(
            tokens).long()}, policy=policy)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        assert state["pos"].tolist() == [0]
        state = tmodel.init_decode_state(1, 16, dtype=torch.float32)
        for i in range(tokens.shape[1]):
            step, state = tmodel.decode_step(
                state, torch.from_numpy(tokens[:, i:i + 1]).long(),
                policy=policy)
    np.testing.assert_allclose(step.numpy(), logits.numpy(), **TOL)


# the block layout's packing is the JAX side's slowest step: one block
# mode a family
DECODE_CASES = ([("zamba2_7b", m) for m in ("dense", "masked", "packed",
                                             "packed_int8",
                                             "packed_block_int8")]
                + [("xlstm_125m", m) for m in ("masked", "packed_block")])


@pytest.mark.parametrize("arch,mode", DECODE_CASES)
def test_decode_steps_and_states_match(arch, mode):
    jcfg, tcfg, jmodel, params = family_setup(arch)
    steps, tstate, jstate, _ = decode_both(jmodel, params, tcfg, mode,
                                           steps=2)
    for got, want in steps:
        np.testing.assert_allclose(got, want, **TOL)
    got, want = state_arrays(tstate), state_arrays(jstate)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_decode_writes_the_recurrent_state_in_place(family):
    """Every tensor of the returned state is the input state's own (what a
    captured step replays), and it moved."""
    arch, jcfg, tcfg, jmodel, params = family
    tmodel = to_torch_model(params, tcfg)
    state = tmodel.init_decode_state(2, 8, dtype=torch.float32)
    before = {k: v.copy() for k, v in state_arrays(state).items()}
    ids = {k: id(v) for k, v in _leaves(state).items()}
    with torch.inference_mode():
        _, new = tmodel.decode_step(state, torch.ones((2, 1), dtype=torch.long))
    assert {k: id(v) for k, v in _leaves(new).items() if k != "/pos"} == \
        {k: i for k, i in ids.items() if k != "/pos"}
    moved = {k for k, v in state_arrays(state).items()
             if not np.array_equal(v, before[k])}
    assert moved == set(before) - {"/pos"}


def _leaves(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}/{k}"] = v
    return out


def test_bf16_prefill_gap_is_the_references():
    """In bfloat16 compute, prefill's last logits and token-by-token
    decode's differ by rounding that grows with depth (``chip_smoke.py``
    13d bounds it at full width).  The port's gap is the reference's own:
    zamba2 at 7 layers (a period of 6, the full config's, and a tail of 1)
    and 32 tokens, the same weights, both gaps measured as relative L2 over
    the true vocab, the port's within 10% of the reference's.  The reference
    is compiled without XLA's excess precision (on the CPU XLA otherwise
    keeps bfloat16 intermediates of a fusion in float32, where torch rounds
    each op): then the two gaps agree to a few percent, an extra bfloat16
    rounding in the Mamba2 step takes the port's a quarter further, and a
    wrong state or mask gives a gap of order 1."""
    jcfg, tcfg = family_pair("zamba2_7b", compute_dtype="bfloat16",
                             num_layers=7, shared_attn_every=6)
    jmodel, params = jax_model_and_params(jcfg)
    tmodel = to_torch_model(params, tcfg)
    tokens = family_batch(tcfg, b=1, t=32, seed=5)["tokens"]
    v = tcfg.vocab_size
    rounded = {"xla_allow_excess_precision": False}

    def gap(a, b):
        a, b = a[0, 0, :v], b[0, 0, :v]
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    jtok = jnp.asarray(tokens)
    jpre = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t})[0]).lower(
        params, jtok).compile(rounded)(params, jtok)
    jst = jmodel.init_decode_state(1, 33, dtype=jnp.float32)
    jstep = jax.jit(lambda p, s, t: jmodel.decode_step(p, s, t)).lower(
        params, jst, jtok[:, :1]).compile(rounded)
    for i in range(tokens.shape[1]):
        jdec, jst = jstep(params, jst, jtok[:, i:i + 1])
    with torch.inference_mode():
        tpre, _ = tmodel.prefill({"tokens": torch.from_numpy(tokens).long()})
        tst = tmodel.init_decode_state(1, 33, dtype=torch.float32)
        for i in range(tokens.shape[1]):
            tdec, tst = tmodel.decode_step(
                tst, torch.from_numpy(tokens[:, i:i + 1]).long())
    want = gap(np.asarray(jpre, np.float32), np.asarray(jdec, np.float32))
    got = gap(tpre.float().numpy(), tdec.float().numpy())
    print("bf16 prefill gap: port", got, "reference", want)
    assert 0 < want < 0.1 and want / 1.1 <= got <= 1.1 * want, (got, want)
