"""Port vs JAX package: the stdlib observability modules.

``repro_torch.obs.{slo,export,recorder}`` keep their own copies of the JAX
package's modules; these tests feed both the same inputs and require the same
answers: SLO / phase / token reports as equal dicts, Chrome traces, span trees
and propagation checks as equal values, watchdog decisions on one injected
clock, and flight dumps with the same files, rings and keys.  ``profile``
writes a ``torch.profiler`` trace (CPU activity here).  Every watchdog a test
starts is stopped before it returns.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import export as jexport
from repro.obs import recorder as jrecorder
from repro.obs import slo as jslo
from repro.serve import Request as JRequest

from repro_torch import obs as tobs
from repro_torch.obs import export as texport
from repro_torch.obs import recorder as trecorder
from repro_torch.obs import slo as tslo
from repro_torch.serve import Request as TRequest


# ---------------------------------------------------------------------------
# slo
# ---------------------------------------------------------------------------

def _req(sub=0.0, claim=0.1, first=0.4, done=1.0, prompt=8, out=4,
         wasted=0, rejected=0, overhead=0.0, preempts=0):
    return SimpleNamespace(
        submit_ts=sub, claim_ts=claim, first_token_ts=first,
        complete_ts=done, prompt=list(range(prompt)),
        output=list(range(out)), wasted_prefill_tokens=wasted,
        rejected_draft_tokens=rejected, preempt_overhead_s=overhead,
        preempts=preempts)


def _random_requests(seed, n):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        sub = float(rng.uniform(0, 1))
        claim = sub + float(rng.exponential(0.2))
        first = claim + float(rng.exponential(0.3))
        done = first + float(rng.exponential(1.0))
        kind = rng.integers(0, 4)
        reqs.append(_req(
            sub, claim, None if kind == 0 else first,
            None if kind <= 1 else done, prompt=int(rng.integers(1, 20)),
            out=int(rng.integers(0, 9)), wasted=int(rng.integers(0, 3)) * 4,
            rejected=int(rng.integers(0, 5)),
            overhead=float(rng.uniform(0, 0.2)) if kind == 3 else 0.0,
            preempts=int(kind == 3)))
    return reqs


REQUEST_SETS = {
    "mixed": [_req(done=0.5),
              _req(first=0.9, done=2.5, wasted=12, preempts=1, overhead=0.3),
              _req(first=None, done=None),
              _req(done=1.2, rejected=6)],
    "empty": [],
    "random_a": _random_requests(0, 25),
    "random_b": _random_requests(7, 60),
}
SLOS = [(None, None), (500.0, None), (None, 2000.0), (500.0, 2000.0),
        (0.0, 0.0)]


@pytest.mark.parametrize("ttft,e2e", SLOS)
@pytest.mark.parametrize("which", list(REQUEST_SETS))
def test_slo_report_equals_reference(which, ttft, e2e):
    reqs = REQUEST_SETS[which]
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    want = jslo.slo_report(reqs, jslo.SLOConfig(ttft, e2e), metrics=jreg)
    got = tslo.slo_report(reqs, tslo.SLOConfig(ttft, e2e), metrics=treg)
    assert got == want
    assert treg.snapshot(meta=False) == jreg.snapshot(meta=False)


@pytest.mark.parametrize("which", list(REQUEST_SETS))
def test_request_phases_tokens_and_sketches_equal_reference(which):
    reqs = REQUEST_SETS[which]
    for r in reqs:
        assert tslo.request_phases(r) == jslo.request_phases(r)
        assert tslo.request_tokens(r) == jslo.request_tokens(r)
    want, got = jslo.phase_sketches(reqs), tslo.phase_sketches(reqs)
    assert sorted(got) == sorted(want)
    for phase in want:
        assert got[phase].to_entry() == want[phase].to_entry()


def test_request_fields_equal_reference():
    """The port's Request carries every field of the JAX package's (the
    obs-v2 waste fields and priority that slo reads), with the same
    defaults."""
    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else None) for f in dataclasses.fields(cls)}
    assert fields(TRequest) == fields(JRequest)
    r = TRequest(uid=3, prompt=np.arange(5, dtype=np.int32))
    r.output = [1, 2]
    j = JRequest(uid=3, prompt=np.arange(5, dtype=np.int32))
    j.output = [1, 2]
    assert tslo.request_tokens(r) == jslo.request_tokens(j)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _events(seed):
    """A synthetic event list: two requests' lifecycles, spans, a replica
    label, kernel dispatches with and without a known trace id."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.uniform(0.001, 0.01, 16)).tolist()
    ev = [
        {"name": "request_submit", "ts": ts[0], "wall": 1.0, "uid": 0,
         "trace_id": "t0", "prompt_len": 5},
        {"name": "request_submit", "ts": ts[1], "wall": 1.0, "uid": 1,
         "trace_id": "t1", "replica": "1"},
        {"name": "kernel_dispatch", "ts": ts[2], "wall": 1.0, "op": "xwT",
         "backend": "cuda", "trace_id": "t0"},
        {"name": "request_claim", "ts": ts[3], "wall": 1.0, "uid": 0,
         "slot": 0, "trace_id": "t0"},
        {"name": "request", "ph": "span", "ts": ts[4], "dur": 0.25,
         "wall": 1.0, "uid": 0, "trace_id": "t0", "span_id": "s0",
         "tokens": 3},
        {"name": "spec_commit", "ts": ts[5], "wall": 1.0, "uid": 1,
         "trace_id": "t1", "replica": "1", "committed": 2},
        {"name": "logger_line", "ts": ts[6], "wall": 1.0},
        {"name": "request_complete", "ts": ts[7], "wall": 1.0, "uid": 1,
         "tokens": 2, "trace_id": "t1", "replica": "1"},
    ]
    if seed % 2:
        ev.append({"name": "kernel_dispatch", "ts": ts[8], "wall": 1.0,
                   "op": "xwT_block"})                       # no trace id
        ev.append({"name": "prefill_chunk", "ts": ts[9], "wall": 1.0,
                   "trace_id": "unknown"})                   # foreign id
    rng.shuffle(ev)
    return ev


EVENT_SETS = {"clean": _events(0), "faulty": _events(1), "empty": [],
              "no_submit": [{"name": "kernel_dispatch", "ts": 0.5,
                             "trace_id": "x"}],
              "nothing_checked": [{"name": "logger_line", "ts": 0.1}]}


@pytest.mark.parametrize("which", list(EVENT_SETS))
def test_export_equals_reference(which):
    ev = EVENT_SETS[which]
    assert texport.to_chrome_trace(ev) == jexport.to_chrome_trace(ev)
    assert texport.span_trees(ev) == jexport.span_trees(ev)
    assert texport.check_propagation(ev) == jexport.check_propagation(ev)
    assert (texport.check_propagation(ev) == []) == (which == "clean")


@pytest.mark.parametrize("check", [False, True])
@pytest.mark.parametrize("which", ["clean", "faulty"])
def test_export_cli_equals_reference(tmp_path, which, check):
    path = tmp_path / "t.jsonl"
    lines = [{"name": "_trace_header", "dropped": 3}] + EVENT_SETS[which]
    path.write_text("\n".join(json.dumps(e) for e in lines) + "\n")
    assert texport.load_events(str(path)) == jexport.load_events(str(path))
    flags = ["--check"] if check else []
    rc_t = texport.main([str(path), "-o", str(tmp_path / "t.json"), *flags])
    rc_j = jexport.main([str(path), "-o", str(tmp_path / "j.json"), *flags])
    assert rc_t == rc_j == (1 if check and which == "faulty" else 0)
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


# ---------------------------------------------------------------------------
# recorder: watchdog on an injected clock, rings, dumps
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


# ("beat", seconds the clock moves first) or ("check", seconds past the
# clock at which to check, the clock left where it is)
WATCH_SCRIPTS = {
    "arms_after_second_beat": [("check", 0), ("beat", 1), ("check", 1e6),
                               ("beat", 5), ("check", 0.01), ("check", 50),
                               ("check", 100), ("beat", 0), ("check", 50)],
    "ewma_tracks_intervals": [("beat", 0)] + [("beat", 0.05)] * 6
                             + [("check", 0.3), ("check", 0.8),
                                ("check", 1.2), ("beat", 2.0),
                                ("check", 1.1), ("check", 30)],
    "slow_then_fast": [("beat", 0), ("beat", 3.0), ("beat", 0.01),
                       ("check", 2.0), ("beat", 0.01), ("check", 25.0),
                       ("check", 1.0)],
}


@pytest.mark.parametrize("threshold,min_stall", [(8.0, 1.0), (2.0, 0.5),
                                                 (4.0, 0.001)])
@pytest.mark.parametrize("script", list(WATCH_SCRIPTS))
def test_watchdog_decisions_equal_reference(monkeypatch, script, threshold,
                                            min_stall):
    clock = _Clock()
    monkeypatch.setattr(jrecorder, "time", clock)
    monkeypatch.setattr(trecorder, "time", clock)
    # a poll far away: the test drives check() itself
    dogs = [mod.Watchdog("w", on_stall=lambda w: None, threshold=threshold,
                         min_stall_s=min_stall, poll_s=3600.0)
            for mod in (jrecorder, trecorder)]
    try:
        seen = {0: [], 1: []}
        for op, dt in WATCH_SCRIPTS[script]:
            if op == "beat":
                clock.now += dt
            for i, wd in enumerate(dogs):
                if op == "beat":
                    wd.beat()
                    seen[i].append(("after", wd.stall_after()))
                else:
                    seen[i].append((op, wd.check(now=clock.now + dt)))
                seen[i].append(wd.state())
        assert seen[1] == seen[0]
        assert any(d is True for op, d in
                   (x for x in seen[1] if isinstance(x, tuple))
                   if op == "check")
    finally:
        for wd in dogs:
            wd.stop()
    assert not any(wd._thread.is_alive() for wd in dogs)


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "wall")}


def _dump_both(tmp_path, ring_size, events, reason):
    """The same events through a recorder of each package; returns the
    dump directories."""
    outs = []
    for name, mod, obs in (("jax", jrecorder, jobs), ("torch", trecorder,
                                                      tobs)):
        reg = obs.MetricsRegistry()
        rec = mod.FlightRecorder(str(tmp_path / name), metrics=reg,
                                 ring_size=ring_size)
        rec.attach_trace(reg.trace)
        wd = rec.watchdog("serve_tick", poll_s=3600.0)
        for e in events:
            reg.trace.event(e["name"], **{k: v for k, v in e.items()
                                          if k != "name"})
        wd.beat()
        outs.append(rec.dump(reason))
        rec.close()
        assert not wd._thread.is_alive()
    return outs


@pytest.mark.parametrize("ring_size", [1, 3, 512])
def test_recorder_dump_layout_equals_reference(tmp_path, ring_size):
    events = ([{"name": "request_step", "i": i} for i in range(5)]
              + [{"name": "kernel_dispatch", "op": "xwT"},
                 {"name": "train_step", "step": 1},
                 {"name": "autotune_search"}, {"name": "other"}])
    jdir, tdir = _dump_both(tmp_path, ring_size, events, "unit test/1")
    assert os.path.basename(tdir) == os.path.basename(jdir) \
        == "flight-0001-unit-test-1"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) \
        == ["meta.json", "metrics.json", "rings.json"]

    def load(d, f):
        with open(os.path.join(d, f)) as fh:
            return json.load(fh)

    jr, tr = load(jdir, "rings.json"), load(tdir, "rings.json")
    assert {k: [_strip(e) for e in v] for k, v in tr.items()} == \
        {k: [_strip(e) for e in v] for k, v in jr.items()}
    assert len(tr["serve"]) == min(ring_size, 5)
    jm, tm = load(jdir, "meta.json"), load(tdir, "meta.json")
    for key in ("reason", "ring_sizes"):
        assert tm[key] == jm[key]
    # run metadata names each package's own stack; the recorder's keys match
    assert set(jm) - set(jobs.run_metadata()) == \
        set(tm) - set(tobs.run_metadata()) == {"reason", "watchdogs",
                                               "ring_sizes"}
    assert [sorted(w) for w in tm["watchdogs"]] == \
        [sorted(w) for w in jm["watchdogs"]]
    assert [(w["name"], w["beats"], w["stalls"]) for w in tm["watchdogs"]] \
        == [(w["name"], w["beats"], w["stalls"]) for w in jm["watchdogs"]]
    assert sorted(load(tdir, "metrics.json")) == \
        sorted(load(jdir, "metrics.json"))


@pytest.mark.parametrize("exc", [RuntimeError, KeyboardInterrupt])
def test_recorder_guard_on_crash_equals_reference(tmp_path, exc):
    dumps = []
    for name, mod, obs in (("jax", jrecorder, jobs), ("torch", trecorder,
                                                      tobs)):
        rec = mod.FlightRecorder(str(tmp_path / name),
                                 metrics=obs.MetricsRegistry())
        with pytest.raises(exc):
            with rec.guard():
                raise exc("boom")
        rec.close()
        dumps.append([os.path.relpath(d, tmp_path / name)
                      for d in rec.dumps])
    assert dumps[1] == dumps[0] == [f"flight-0001-crash-{exc.__name__}"]


def test_recorder_stall_dumps_once_and_subsystems_route_alike(tmp_path):
    for name in ("kernel_dispatch", "autotune_x", "tune_y", "checkpoint_z",
                 "train_step", "restart", "straggler", "request_submit",
                 "request", "serve_tick", "spec_commit", "prefill_chunk",
                 "misc_thing", ""):
        assert trecorder.subsystem_of(name) == jrecorder.subsystem_of(name)
    reg = tobs.MetricsRegistry()
    rec = tobs.FlightRecorder(str(tmp_path), metrics=reg)
    rec.attach_trace(reg.trace)
    wd = rec.watchdog("serve_tick", threshold=2.0, min_stall_s=0.05,
                      poll_s=0.01)
    try:
        reg.trace.event("request_submit", uid=0)
        wd.beat()
        wd.beat()                      # armed; then silence -> stall
        assert rec.wait_for_dump(timeout=10.0)
    finally:
        rec.close()
    assert not wd._thread.is_alive()
    assert len(rec.dumps) == 1
    (c,) = [e for e in reg.snapshot(meta=False)["counters"]
            if e["name"] == "obs_watchdog_stalls_total"]
    assert c["value"] == 1 and c["labels"] == {"watch": "serve_tick"}


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

def test_profile_writes_a_trace_and_marks_the_window(tmp_path):
    from repro_torch.obs.profile import TRACE_FILE

    assert not tobs.profiling_active()
    with tobs.profile(str(tmp_path / "p")) as prof:
        assert tobs.profiling_active()
        with tobs.annotate("demm/xwT/reference"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not tobs.profiling_active()
    assert prof is not None
    with open(tmp_path / "p" / TRACE_FILE) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "demm/xwT/reference" in names
    assert any(str(n).startswith("aten::") for n in names)
    with tobs.profile(None) as none:
        assert none is None and tobs.profiling_active()
    with tobs.profile(str(tmp_path / "q"), enabled=False) as off:
        assert off is None and not tobs.profiling_active()
    assert not (tmp_path / "q").exists()
