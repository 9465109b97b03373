"""The ported slice as a whole: the same prompts through the JAX package's
``run_serve`` and the port's ``run_serve(device="cpu", backend="reference")``
with converted weights give identical token streams — greedy for masked,
packed and packed+int8 serving in both packed layouts (row-packed ``xwT`` and
two-level ``block``), and sampled at temperature 0.8 / top-k 8
(the sampler is numpy Philox on both sides).  float32 compute on both sides:
bf16 logit grids flip argmax ties between programs.
"""

import os

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

    # the paged engine is ported: only its unported options are refused
    from repro_torch.paged import PagedServeConfig
    with pytest.raises(NotImplementedError):
        make_engine(model, PagedServeConfig(), device="cpu", spec=object())

    class OtherConfig:
        pass

    for config in (OtherConfig(), object()):
        with pytest.raises(TypeError):
            make_engine(model, config, device="cpu")


# ---------------------------------------------------------------------------
# trace replay + flight recorder + SLO report: the serving loop in full
# ---------------------------------------------------------------------------

TRACE = "benchmarks/traces/tiny_trace.jsonl"


def _replay(run, recorder_cls, registry_cls, obs_mod, tmp, *args, **kw):
    """One trace replay with its own default registry and a flight
    recorder; returns (engine, registry, recorder), the recorder closed."""
    reg = registry_cls()
    prev = obs_mod.default_registry()
    obs_mod.set_default_registry(reg)
    rec = recorder_cls(str(tmp), metrics=reg)
    try:
        eng = run(*args, trace_replay=TRACE, recorder=rec, **kw)
    finally:
        rec.close()
        obs_mod.set_default_registry(prev)
    return eng, reg, rec


@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_trace_replay_with_recorder_matches_jax(setup, tmp_path, layout):
    from repro.obs import slo as jslo
    from repro_torch.obs import export as texport
    from repro_torch.obs import slo as tslo

    jcfg, tcfg, jmodel, params = setup
    kw = dict(packed=True, layout=layout, backend="reference", slots=4,
              max_len=96, seed=5)
    jeng, _, jrec = _replay(jax_run_serve, jobs.FlightRecorder,
                            jobs.MetricsRegistry, jobs, tmp_path / "j",
                            jmodel, params, jcfg.vocab_size, **kw)
    teng, treg, trec = _replay(run_serve, tobs.FlightRecorder,
                               tobs.MetricsRegistry, tobs, tmp_path / "t",
                               to_torch_model(params, tcfg),
                               tcfg.vocab_size, device="cpu", **kw)
    want, got = _streams(jeng), _streams(teng)
    assert len(got) == 12 and got == want
    # the CPU engine stays eager: nothing captured
    assert teng._graph is None and not teng._use_graph
    # every tick beat the watchdog first; no stall, so no dump
    assert teng._watchdog.beats == teng.drain_ticks > 0
    assert jeng._watchdog.beats == teng._watchdog.beats
    assert trec.dumps == jrec.dumps == []
    assert not teng._watchdog._thread.is_alive()
    # the recorder's serve ring holds the engine's lifecycle events
    assert {e["name"] for e in trec.rings["serve"]} >= {
        "request_submit", "request_claim", "request_first_token",
        "request_complete"}
    # every dispatch and lifecycle event carries a submitted request's id
    assert texport.check_propagation(treg.trace.events) == []
    by_uid = {r.uid: r for r in jeng.completed}
    for r in teng.completed:
        assert tslo.request_tokens(r) == jslo.request_tokens(by_uid[r.uid])
        assert r.priority == by_uid[r.uid].priority
    tr = tslo.slo_report(teng.completed)
    jr = jslo.slo_report(jeng.completed)
    assert tr["goodput"] == jr["goodput"]
    assert (tr["requests"], tr["completed"]) == (jr["requests"],
                                                 jr["completed"]) == (12, 12)
    assert tr["phases"].keys() == jr["phases"].keys()


def test_trace_prompt_and_load_match_jax():
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    assert tserve._load_trace(TRACE) == jserve._load_trace(TRACE)
    for uid in range(4):
        np.testing.assert_array_equal(tserve._trace_prompt(3, uid, 7, 500),
                                      jserve._trace_prompt(3, uid, 7, 500))


def test_cli_trace_replay_slo_report_and_forced_stall(tmp_path, caplog,
                                                      capsys):
    from repro_torch.launch.serve import main
    from repro_torch.obs.export import check_propagation, load_events

    flight = tmp_path / "flight"
    trace_out = tmp_path / "t.jsonl"
    prev = tobs.default_registry()
    tobs.set_default_registry(tobs.MetricsRegistry())
    try:
        main(["--device", "cpu", "--packed", "--trace-replay", TRACE,
              "--slo-report", "--slo-ttft-ms", "1e6", "--flight-dir",
              str(flight), "--force-stall", "--trace-out", str(trace_out),
              "--profile-dir", str(tmp_path / "prof")])
    finally:
        tobs.set_default_registry(prev)
    dumps = sorted(os.listdir(flight))
    assert dumps == ["flight-0001-stall-serve_tick"]
    assert sorted(os.listdir(flight / dumps[0])) == [
        "meta.json", "metrics.json", "rings.json"]
    _, events = load_events(str(trace_out))
    assert check_propagation(events) == []
    assert (tmp_path / "prof" / "trace.json").exists()
    out = capsys.readouterr()
    text = out.out + out.err + caplog.text
    assert '"attainment": 1.0' in text
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--force-stall"])   # needs --flight-dir
