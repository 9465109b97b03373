"""The ported slice as a whole: the same prompts through the JAX package's
``run_serve`` and the port's ``run_serve(device="cpu", backend="reference")``
with converted weights give identical token streams — greedy for masked,
packed and packed+int8 serving in both packed layouts (row-packed ``xwT`` and
two-level ``block``), and sampled at temperature 0.8 / top-k 8
(the sampler is numpy Philox on both sides).  float32 compute on both sides:
bf16 logit grids flip argmax ties between programs.
"""

import numpy as np
import pytest

from repro import obs as jobs
from repro.launch.serve import run_serve as jax_run_serve

from _torch_port import jax_model_and_params, reduced_pair, to_torch_model
from repro_torch import obs as tobs
from repro_torch.launch.serve import run_serve
from repro_torch.serve import (Engine, Request, ServeConfig, ServeEngine,
                               make_engine)

RUN = dict(requests=5, slots=2, max_new=6, max_len=32, seed=3)
CASES = {
    "masked": dict(packed=False),
    "packed": dict(packed=True),
    "packed_int8": dict(packed=True, quantize="int8"),
    "packed_int8_per_group": dict(packed=True, quantize="int8",
                                  granularity="per_group"),
    "packed_block": dict(packed=True, layout="block"),
    "packed_block_int8": dict(packed=True, layout="block", quantize="int8"),
    "packed_sampled": dict(packed=True, temperature=0.8, top_k=8),
    "masked_sampled": dict(packed=False, temperature=0.8, top_k=8),
}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = reduced_pair()
    jmodel, params = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, params


def _streams(engine):
    return {r.uid: (r.prompt.tolist(), list(r.output))
            for r in engine.completed}


def _counter_names(registry):
    return {c["name"] for c in registry.snapshot(meta=False)["counters"]}


@pytest.mark.parametrize("case", list(CASES))
def test_token_streams_identical(setup, case):
    jcfg, tcfg, jmodel, params = setup
    kw = CASES[case]
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jprev, tprev = jobs.default_registry(), tobs.default_registry()
    jobs.set_default_registry(jreg)
    tobs.set_default_registry(treg)
    try:
        jeng = jax_run_serve(jmodel, params, jcfg.vocab_size,
                             backend="reference", **RUN, **kw)
        teng = run_serve(to_torch_model(params, tcfg), tcfg.vocab_size,
                         backend="reference", device="cpu", **RUN, **kw)
    finally:
        jobs.set_default_registry(jprev)
        tobs.set_default_registry(tprev)
    want, got = _streams(jeng), _streams(teng)
    assert len(got) == RUN["requests"]
    assert all(len(out) == RUN["max_new"] for _, out in got.values())
    assert got == want
    assert [r.uid for r in teng.completed] == [r.uid for r in jeng.completed]
    assert teng.drain_ticks > 0
    # same counter families on both sides (the dispatch counter only exists
    # once a packed matmul was dispatched)
    assert _counter_names(treg) == _counter_names(jreg)
    gauges = {g["name"] for g in treg.snapshot(meta=False)["gauges"]}
    assert {"serve_slots_active", "serve_tokens_per_second"} <= gauges


def test_engine_protocol_and_slot_reuse(setup):
    _, tcfg, _, params = setup
    model = to_torch_model(params, tcfg)
    reg = tobs.MetricsRegistry()
    eng = make_engine(model, ServeConfig(num_slots=1, max_len=24),
                      device="cpu", metrics=reg)
    assert isinstance(eng, ServeEngine) and isinstance(eng, Engine)
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, tcfg.vocab_size, 9, dtype=np.int32)
    p2 = rng.integers(0, tcfg.vocab_size, 5, dtype=np.int32)
    eng.submit(Request(uid=0, prompt=p1, max_new_tokens=5))
    eng.submit(Request(uid=1, prompt=p2, max_new_tokens=5))
    eng.drain()
    fresh = make_engine(model, ServeConfig(num_slots=1, max_len=24),
                        device="cpu", metrics=tobs.MetricsRegistry())
    fresh.submit(Request(uid=1, prompt=p2, max_new_tokens=5))
    fresh.run_until_drained()
    assert eng.completed[1].output == fresh.completed[0].output
    assert eng.last_logits.shape == (1, tcfg.padded_vocab)
    # max_len ends a request early; eos ends it at once
    short = make_engine(model, ServeConfig(num_slots=1, max_len=8),
                        device="cpu", metrics=tobs.MetricsRegistry())
    short.submit(Request(uid=0, prompt=p2, max_new_tokens=50))
    short.run_until_drained()
    assert len(short.completed[0].output) == 8 - 1 - len(p2) + 1
    eos = fresh.completed[0].output[0]
    e2 = make_engine(model, ServeConfig(num_slots=1, max_len=24),
                     device="cpu", metrics=tobs.MetricsRegistry())
    e2.submit(Request(uid=1, prompt=p2, max_new_tokens=5, eos_id=eos))
    e2.run_until_drained()
    assert e2.completed[0].output == [eos]


def test_unported_engine_options_raise(setup):
    _, tcfg, _, params = setup
    model = to_torch_model(params, tcfg)
    cfg = ServeConfig(num_slots=1, max_len=8)
    for kw in ({"plan": object()}, {"replicas": 2}, {"spec": object()}):
        with pytest.raises(NotImplementedError):
            make_engine(model, cfg, device="cpu", **kw)

    class PagedServeConfig:
        pass

    with pytest.raises(NotImplementedError):
        make_engine(model, PagedServeConfig(), device="cpu")
    with pytest.raises(TypeError):
        make_engine(model, object(), device="cpu")
