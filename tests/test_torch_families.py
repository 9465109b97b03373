"""Port vs JAX package: the encoder-decoder family (``seamless_m4t_medium``:
``encode``, ``train_loss``, ``prefill``, ``decode_step``), and the six new
architectures through the slice as a whole: token streams through
``ServeEngine`` (all six) and the paged engine (the three attention-cache
families: MoE, vision, encoder-decoder), the paged and speculative refusals
of the recurrent families, and speculation on the others (training:
``test_torch_family_train.py``).

The same inputs, made with numpy from a seed, go through the JAX package
and the port on the CPU; weights reach the port through
``repro_torch.convert.from_jax_params``.  Reduced configs, float32 compute.
Tolerances: ``train_loss`` rtol 1e-5 and its gradients as
``test_torch_train.py`` holds them; encoder output, prefill and decode
logits rtol/atol 1e-4; token streams exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.sparse_linear import ExecPolicy as JPolicy
from repro.launch.serve import run_serve as jax_run_serve

from _torch_port import (assert_grads_close, decode_both, family_batch,
                         family_setup, loss_and_grads_both, to_torch_model,
                         torch_batch)
from repro_torch import obs as tobs
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch.pack_tree import pack_tree
from repro_torch.launch.serve import run_serve
from repro_torch.paged import PagedServeConfig
from repro_torch.serve import ServeConfig, make_engine
from repro_torch.spec import SpecConfig

TOL = dict(rtol=1e-4, atol=1e-4)
NEW_ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e", "internvl2_1b",
             "seamless_m4t_medium", "zamba2_7b", "xlstm_125m")
PAGED_ARCHS = ("olmoe_1b_7b", "internvl2_1b", "seamless_m4t_medium")
RECURRENT = ("zamba2_7b", "xlstm_125m")


# ---------------------------------------------------------------------------
# the encoder-decoder family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encdec():
    return family_setup("seamless_m4t_medium")


def test_encdec_train_loss_and_grads_match(encdec):
    jcfg, tcfg, jmodel, params = encdec
    batch = family_batch(tcfg, t=12)
    (loss, met, grads), (jloss, jmet, jgrads) = loss_and_grads_both(
        jmodel, params, to_torch_model(params, tcfg), batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(met) == set(jmet) == {"xent"}
    assert_grads_close(grads, jgrads)


def test_encdec_encode_and_prefill_match(encdec):
    """The encoder's output (non-causal blocks over the frames), and
    prefill's logits and the ``enc_out`` its fresh state carries."""
    jcfg, tcfg, jmodel, params = encdec
    batch = family_batch(tcfg, t=12, seed=4)
    del batch["targets"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jstate = jmodel.prefill(params, jb,
                                     policy=JPolicy(mode="masked"))
    tmodel = to_torch_model(params, tcfg)
    policy = ExecPolicy(mode="masked")
    with torch.inference_mode():
        logits, state = tmodel.prefill(torch_batch(batch), policy=policy)
        enc = tmodel.encode(torch_batch(batch)["frames"], policy=policy)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(state["enc_out"].numpy(),
                               np.asarray(jstate["enc_out"]), **TOL)
    np.testing.assert_array_equal(enc.numpy(), state["enc_out"].numpy())
    assert state["caches"]["k"].shape == jstate["caches"]["k"].shape


@pytest.mark.parametrize("mode", ["dense", "masked", "packed",
                                  "packed_block_int8"])
def test_encdec_decode_steps_match(encdec, mode):
    """Decode with the cross-attention reading a random ``enc_out``."""
    jcfg, tcfg, jmodel, params = encdec
    steps, tstate, jstate, _ = decode_both(jmodel, params, tcfg, mode,
                                           steps=2)
    for got, want in steps:
        np.testing.assert_allclose(got, want, **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tstate["caches"][key].numpy(),
                                   np.asarray(jstate["caches"][key]), **TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

RUN = dict(requests=3, slots=2, max_new=4, max_len=24, seed=3)


def _streams(engine):
    return {r.uid: (r.prompt.tolist(), list(r.output))
            for r in engine.completed}


def _both(arch, **kw):
    jcfg, tcfg, jmodel, params = family_setup(arch)
    prev = jobs.default_registry(), tobs.default_registry()
    jobs.set_default_registry(jobs.MetricsRegistry())
    tobs.set_default_registry(tobs.MetricsRegistry())
    try:
        jeng = jax_run_serve(jmodel, params, jcfg.vocab_size,
                             backend="reference", **kw)
        teng = run_serve(to_torch_model(params, tcfg), tcfg.vocab_size,
                         backend="reference", device="cpu", **kw)
    finally:
        jobs.set_default_registry(prev[0])
        tobs.set_default_registry(prev[1])
    return _streams(jeng), _streams(teng), teng


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_engine_token_streams_identical(arch):
    """Packed (xwT) greedy serving, 3 requests on 2 slots (a slot is
    reused: its recurrent state or caches reset), the same token streams
    through the JAX package's engine and the port's."""
    want, got, engine = _both(arch, packed=True, **RUN)
    assert len(got) == RUN["requests"]
    assert all(len(out) == RUN["max_new"] for _, out in got.values())
    assert got == want
    assert engine.drain_ticks > 0


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_engine_token_streams_identical(arch):
    """The paged engine (chunked prefill, the paged decode step; the
    encoder-decoder's chunk cross-attends to its slot's ``enc_out``)."""
    want, got, engine = _both(arch, packed=True, paged=True, page_size=8,
                              prefill_chunk=16, **{**RUN, "requests": 4,
                                                   "max_len": 48})
    assert got == want and len(got) == 4
    assert engine.prefill.dispatches > 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_families_refuse_paging_and_speculation(arch):
    """A recurrent state has nothing to page and cannot roll back a
    rejected draft: both engines refuse it, with the reference's
    messages."""
    from repro.launch.pack_tree import pack_tree as jax_pack_tree
    from repro.paged import PagedServeConfig as JPagedServeConfig
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import make_engine as jax_make_engine
    from repro.spec import SpecConfig as JSpecConfig

    jcfg, tcfg, jmodel, params = family_setup(arch)
    tmodel = to_torch_model(params, tcfg)
    with pytest.raises(NotImplementedError,
                       match="paged KV cache is attention-only") as jerr:
        jax_make_engine(jmodel, params, JPagedServeConfig(num_slots=1,
                                                          max_len=16))
    with pytest.raises(NotImplementedError) as terr:
        make_engine(tmodel, PagedServeConfig(num_slots=1, max_len=16),
                    device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="position-addressable"):
        jax_make_engine(jmodel, jax_pack_tree(params),
                        JServeConfig(num_slots=1, max_len=16),
                        spec=JSpecConfig("1:16", 2))
    with pytest.raises(NotImplementedError, match="no tagged caches"):
        make_engine(pack_tree(tmodel), ServeConfig(num_slots=1, max_len=16),
                    device="cpu", spec=SpecConfig("1:16", 2))


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_speculation_keeps_the_tokens(arch):
    """Weights at 8:16 (``init_linear`` adapts it to 4:8 at d_model 128),
    drafted at 3:8: the speculative engines (dense and paged) commit the
    plain engine's greedy tokens (the reference's invariant).  The experts
    get room for every token (capacity factor E / k): with capacity drops a
    token's output depends on the other lanes' tokens in its step, which a
    verify window changes (in the reference too)."""
    _, tcfg, _, _ = family_setup(arch)
    cfg = dataclasses.replace(tcfg, sparsity=SparsityConfig(8, 16, 1))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts
            / cfg.moe.experts_per_token))
    from repro_torch.models.families import build_model

    out = {}
    for label, kw in (("plain", {}),
                      ("spec", dict(spec_draft="3:8", spec_gamma=3)),
                      ("spec paged", dict(spec_draft="3:8", spec_gamma=3,
                                          paged=True, page_size=8))):
        engine = run_serve(build_model(cfg, device="cpu", seed=1),
                           cfg.vocab_size, packed=True, backend="reference",
                           device="cpu", metrics=tobs.MetricsRegistry(),
                           **{**RUN, "max_len": 32}, **kw)
        out[label] = {r.uid: list(r.output) for r in engine.completed}
    assert out["spec"] == out["plain"] == out["spec paged"]
