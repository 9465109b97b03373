"""The paged serving path of the port against the JAX package's, on the CPU.

Each test of ``tests/test_paged.py`` has its counterpart here, with inputs
made from a seed with numpy and handed to both packages:

* the host bookkeeping (``PagedLayout``, ``PageAllocator``, ``PagedKVCache``,
  ``Scheduler``) driven through the same seeded sequence of calls on both
  sides, compared exactly after every call;
* the device indexing (``gather_pages``, ``scatter_token_pages``,
  ``scatter_chunk_pages``) and ``flash_attention`` with a nonzero
  ``q_offset``, float32, atol 1e-6;
* ``DecoderLM.prefill_chunk`` and the paged ``decode_step``: logits and
  arena against the JAX model's on a reduced float32 stablelm_3b whose
  weights ``convert.from_jax_params`` carries across, rtol/atol 2e-5
  (float32 sums taken in another order);
* the engine: token streams identical to the JAX ``PagedServeEngine`` (and
  to the port's dense engine), greedy and sampled, with and without
  preemption, under both scheduling policies, with equal dispatch counts;
  submit validation and arena exhaustion raise.

float32 compute on both sides: bf16 logit grids flip argmax ties between
programs.  The card-only twins (each program captured once, graph equals
eager) are in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.launch.serve import run_serve as jax_run_serve
from repro.models import attention as jattn
from repro.paged import (ChunkedPrefill as JChunkedPrefill,
                         PageAllocator as JPageAllocator,
                         PagedKVCache as JPagedKVCache,
                         PagedLayout as JPagedLayout,
                         PagedServeConfig as JPagedServeConfig,
                         PagedServeEngine as JPagedServeEngine,
                         SchedConfig as JSchedConfig,
                         Scheduler as JScheduler)
from repro.serve.serve_loop import Request as JRequest

from _torch_port import jax_model_and_params, reduced_pair, to_torch_model
from repro_torch import obs as tobs
from repro_torch.launch.serve import run_serve
from repro_torch.models import attention as tattn
from repro_torch.paged import (NULL_PAGE, ChunkedPrefill, PageAllocator,
                               PagedKVCache, PagedLayout, PagedServeConfig,
                               PagedServeEngine, SchedConfig, Scheduler)
from repro_torch.serve import (Engine, Request, ServeConfig, ServeEngine,
                               make_engine)

TOL = dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# kv_cache: layout, allocator, arena bookkeeping — exact equality with JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size,num_pages,max_blocks",
                         [(8, 17, 6), (1, 2, 1), (16, 129, 32), (5, 9, 7)])
def test_layout_matches_jax(page_size, num_pages, max_blocks):
    t = PagedLayout(page_size, num_pages, max_blocks)
    j = JPagedLayout(page_size, num_pages, max_blocks)
    assert (t.usable_pages, t.tokens_per_seq) == (j.usable_pages,
                                                  j.tokens_per_seq)
    for n in range(0, 3 * page_size + 2):
        assert t.pages_for(n) == j.pages_for(n)
    for max_len in (1, 31, 32, 33, 96, 512):
        for slots in (1, 4):
            for pages in (None, 13):
                assert dataclasses.astuple(PagedLayout.for_serve(
                    max_len, page_size=page_size, num_pages=pages,
                    num_slots=slots)) == dataclasses.astuple(
                    JPagedLayout.for_serve(max_len, page_size=page_size,
                                           num_pages=pages, num_slots=slots))


@pytest.mark.parametrize("bad", [(0, 4, 2), (8, 1, 2), (8, 4, 0)])
def test_layout_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        JPagedLayout(*bad)
    with pytest.raises(ValueError):
        PagedLayout(*bad)


def _alloc_state(a):
    return (list(a._free), a.pages_free, a.pages_used, a.alloc_total,
            a.free_total, a.alloc_failures)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_through_a_call_sequence(seed):
    rng = np.random.default_rng(seed)
    t, j = PageAllocator(9), JPageAllocator(9)
    held_t, held_j = [], []
    for _ in range(200):
        if rng.random() < 0.55:
            n = int(rng.integers(0, 5))
            gt, gj = t.alloc(n), j.alloc(n)
            assert gt == gj
            if gt:
                held_t.append(gt)
                held_j.append(gj)
        elif held_t:
            k = int(rng.integers(len(held_t)))
            t.free(held_t.pop(k))
            j.free(held_j.pop(k))
        assert _alloc_state(t) == _alloc_state(j)
        tokens = int(rng.integers(0, 80))
        assert t.fragmentation(tokens, 8) == j.fragmentation(tokens, 8)
    for bad in ([0], [9]):
        with pytest.raises(ValueError):
            t.free(bad)
    if t._free:
        with pytest.raises(ValueError):           # double free
            t.free([t._free[0]])
    with pytest.raises(ValueError):
        t.alloc(-1)
    assert NULL_PAGE == 0


def _kv_state(kv):
    return (kv.table.tolist(), kv.tokens.tolist(),
            [kv.slot_pages(s) for s in range(kv.num_slots)], kv.pages_free,
            kv.pages_used, kv.occupancy(), kv.fragmentation())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_kv_cache_matches_jax_through_a_call_sequence(seed):
    rng = np.random.default_rng(seed)
    layout = dict(page_size=4, num_pages=11, max_blocks=5)
    t = PagedKVCache(PagedLayout(**layout), num_slots=3)
    j = JPagedKVCache(JPagedLayout(**layout), num_slots=3)
    for _ in range(300):
        slot = int(rng.integers(3))
        op = rng.choice(["grow", "note", "trim", "release"],
                        p=[0.5, 0.2, 0.2, 0.1])
        tokens = int(rng.integers(0, 21))
        if op == "grow":
            assert t.ensure_capacity(slot, tokens) == \
                j.ensure_capacity(slot, tokens)
        elif op == "note":
            t.note_tokens(slot, tokens)
            j.note_tokens(slot, tokens)
        elif op == "trim":
            assert t.trim(slot, tokens) == j.trim(slot, tokens)
        else:
            assert t.release(slot) == j.release(slot)
        assert _kv_state(t) == _kv_state(j)
    with pytest.raises(ValueError):                # past max_blocks
        t.ensure_capacity(0, 21)


def test_arena_capacity_release_and_fragmentation():
    layout = PagedLayout(page_size=4, num_pages=7, max_blocks=4)  # 6 usable
    kv = PagedKVCache(layout, num_slots=2)
    assert kv.ensure_capacity(0, 5)         # 2 pages
    kv.note_tokens(0, 5)
    assert kv.pages_used == 2
    assert kv.fragmentation() == pytest.approx(3 / 8)
    assert kv.ensure_capacity(1, 16)        # the remaining 4 pages
    kv.note_tokens(1, 16)
    assert not kv.ensure_capacity(0, 9)     # would need a 3rd page: none left
    assert kv.release(1) == 4
    assert kv.ensure_capacity(0, 9)
    assert kv.table[0, 0] != NULL_PAGE
    kv.release(0)
    assert kv.pages_used == 0
    assert np.all(kv.table == NULL_PAGE)


# ---------------------------------------------------------------------------
# scheduler: ordering, requeue stability, victims — exact equality with JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fcfs", "priority"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_matches_jax_through_a_call_sequence(policy, seed):
    rng = np.random.default_rng(seed)
    t, j = Scheduler(SchedConfig(policy=policy)), \
        JScheduler(JSchedConfig(policy=policy))
    popped = []           # (torch request, jax request), in pop order
    uid = 0
    for _ in range(150):
        op = rng.choice(["submit", "pop", "requeue", "victim"])
        if op == "submit":
            prio = int(rng.integers(0, 3))
            t.submit(Request(uid=uid, prompt=np.zeros(2, np.int32),
                             priority=prio))
            j.submit(JRequest(uid=uid, prompt=np.zeros(2, np.int32),
                              priority=prio))
            uid += 1
        elif op == "pop":
            rt, rj = t.pop(), j.pop()
            assert (rt is None) == (rj is None)
            if rt is not None:
                assert rt.uid == rj.uid
                popped.append((rt, rj))
        elif op == "requeue" and popped:
            rt, rj = popped.pop(int(rng.integers(len(popped))))
            t.requeue(rt)
            j.requeue(rj)
        elif op == "victim" and popped:
            inc = int(rng.integers(0, 3))
            kw_t = kw_j = {}
            if rng.random() < 0.5:
                kw_t = {"incoming": Request(uid=-1, prompt=None,
                                            priority=inc)}
                kw_j = {"incoming": JRequest(uid=-1, prompt=None,
                                             priority=inc)}
            assert t.victim([(s, r) for s, (r, _) in enumerate(popped)],
                            **kw_t) == \
                j.victim([(s, r) for s, (_, r) in enumerate(popped)], **kw_j)
        assert len(t) == len(j)
        assert (None if t.peek() is None else t.peek().uid) == \
            (None if j.peek() is None else j.peek().uid)
        assert t.stage == j.stage and t.preempts_of == j.preempts_of
        assert t.seq_of == j.seq_of
    with pytest.raises(ValueError):
        t.submit(Request(uid=0, prompt=np.zeros(2, np.int32)))


def test_sched_config_validation():
    with pytest.raises(ValueError):
        SchedConfig(policy="lifo")
    with pytest.raises(ValueError):
        SchedConfig(prefill_chunks_per_tick=0)


# ---------------------------------------------------------------------------
# device indexing and flash attention against the JAX functions
# ---------------------------------------------------------------------------

def _arena(rng, np_, p=4, h=2, d=8):
    return rng.standard_normal((np_, p, h, d)).astype(np.float32)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(0)
    arena = _arena(rng, 9)
    table = rng.integers(0, 9, (3, 5)).astype(np.int32)
    want = np.asarray(jattn.gather_pages(jnp.asarray(arena),
                                         jnp.asarray(table)))
    got = tattn.gather_pages(torch.from_numpy(arena),
                             torch.from_numpy(table.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("active", [None, (True, False, True)])
def test_scatter_token_pages_matches_jax(active):
    rng = np.random.default_rng(1)
    arena = _arena(rng, 9)
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    pos = np.array([5, 2, 11], np.int32)
    new = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    act = None if active is None else np.array(active)
    want = np.asarray(jattn.scatter_token_pages(
        jnp.asarray(arena), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(new), None if act is None else jnp.asarray(act)))
    got = torch.from_numpy(arena.copy())
    out = tattn.scatter_token_pages(
        got, torch.from_numpy(table.astype(np.int64)),
        torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(new),
        None if act is None else torch.from_numpy(act))
    assert out is got                                 # written in place
    # page 0 takes the masked lanes' writes; it is never read unmasked
    keep = slice(None) if act is None else slice(1, None)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("pos0,n_valid", [(0, 6), (3, 6), (8, 2), (9, 6)])
def test_scatter_chunk_pages_matches_jax(pos0, n_valid):
    rng = np.random.default_rng(2)
    arena = _arena(rng, 9)
    row = np.array([3, 5, 1, 7], np.int32)             # 16 positions
    new = rng.standard_normal((6, 2, 8)).astype(np.float32)
    want = np.asarray(jattn.scatter_chunk_pages(
        jnp.asarray(arena), jnp.asarray(row), jnp.int32(pos0),
        jnp.asarray(new), jnp.int32(n_valid)))
    got = torch.from_numpy(arena.copy())
    tattn.scatter_chunk_pages(got, torch.from_numpy(row.astype(np.int64)),
                              torch.tensor([pos0]), torch.from_numpy(new),
                              torch.tensor([n_valid]))
    np.testing.assert_allclose(got.numpy()[1:], want[1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("q_offset,window", [(0, -1), (13, -1), (40, -1),
                                             (21, 9)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_flash_attention_matches_jax(q_offset, window, hq, hkv):
    rng = np.random.default_rng(q_offset + hq)
    t, s, dh = 8, 48, 16
    q = rng.standard_normal((2, t, hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, dh)).astype(np.float32)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_offset, q_chunk=4, kv_chunk=16))
    for offset in (q_offset, torch.tensor([q_offset])):
        got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True,
                                    window=window, q_offset=offset)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model's paged programs against the JAX DecoderLM's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = reduced_pair()
    jmodel, params = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, params, to_torch_model(params, tcfg)


def _states(jmodel, tmodel, slots=2, max_len=48, page_size=8, grow=(8, 30)):
    """A JAX and a port paged decode state with the same block table."""
    jl = JPagedLayout.for_serve(max_len, page_size=page_size,
                                num_slots=slots)
    tl = PagedLayout.for_serve(max_len, page_size=page_size, num_slots=slots)
    kv = PagedKVCache(tl, slots)
    for s, n in enumerate(grow):
        assert kv.ensure_capacity(s, n)
    js = jmodel.init_decode_state(slots, max_len, dtype=jnp.float32,
                                  paged=jl)
    js["caches"] = {**js["caches"],
                    "block_table": jnp.asarray(kv.table.astype(np.int32))}
    ts = tmodel.init_decode_state(slots, max_len, dtype=torch.float32,
                                  paged=tl)
    ts["caches"]["block_table"].copy_(torch.from_numpy(
        kv.table.astype(np.int64)))
    return js, ts


def _assert_arenas(js, ts):
    for name in ("k", "v"):   # page 0 (the null page) is never read
        np.testing.assert_allclose(ts["caches"][name].numpy()[:, 1:],
                                   np.asarray(js["caches"][name])[:, 1:],
                                   **TOL)


def test_prefill_chunk_matches_jax(setup):
    """Chunks of 8 of a 19-token prompt into slot 1 (a full chunk, then a
    partial one): the last valid position's logits, the positions and the
    arena, after every chunk."""
    jcfg, tcfg, jmodel, params, tmodel = setup
    js, ts = _states(jmodel, tmodel)
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, 19)
    with torch.inference_mode():
        for fed in (0, 8, 16):
            part = prompt[fed:fed + 8]
            buf = np.zeros(8, np.int64)
            buf[:len(part)] = part
            jl, js = jmodel.prefill_chunk(params, js,
                                          jnp.asarray(buf, jnp.int32), 1,
                                          len(part))
            tl, new = tmodel.prefill_chunk(
                ts, torch.from_numpy(buf), torch.tensor([1]),
                torch.tensor([len(part)]))
            ts["pos"].copy_(new["pos"])
            assert tl.shape == (1, 1, tcfg.padded_vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist()
            _assert_arenas(js, ts)
    assert ts["pos"].tolist() == [0, 19]


def test_paged_decode_step_matches_jax(setup):
    """The paged decode step with one lane active and one masked: logits,
    positions (only the active lane advances) and arena."""
    jcfg, tcfg, jmodel, params, tmodel = setup
    js, ts = _states(jmodel, tmodel)
    js = {**js, "pos": jnp.asarray([5, 3], jnp.int32),
          "caches": {**js["caches"],
                     "active": jnp.asarray([True, False])}}
    ts["pos"].copy_(torch.tensor([5, 3]))
    ts["caches"]["active"].copy_(torch.tensor([True, False]))
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        for _ in range(3):
            tok = rng.integers(0, tcfg.vocab_size, (2, 1))
            jl, js = jmodel.decode_step(params, js,
                                        jnp.asarray(tok, jnp.int32))
            tl, new = tmodel.decode_step(ts, torch.from_numpy(tok))
            ts["pos"].copy_(new["pos"])
            np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                       **TOL)
            assert ts["pos"].tolist() == np.asarray(js["pos"]).tolist()
            _assert_arenas(js, ts)
    assert ts["pos"].tolist() == [8, 3]


def test_chunked_prefill_equals_token_by_token_paged_decode(setup):
    """Chunked paged prefill of a sequence gives the logits that feeding it
    token by token through the paged decode step gives (both ports)."""
    _, tcfg, jmodel, _, tmodel = setup
    tokens = np.arange(1, 12) % tcfg.vocab_size
    _, ts = _states(jmodel, tmodel, slots=1, grow=(12,))
    pf = ChunkedPrefill(tmodel, chunk=4)
    logits_pf, _ = pf.ingest(ts, tokens, 0)
    assert pf.dispatches == 3 and pf.captures == 0
    _, st = _states(jmodel, tmodel, slots=1, grow=(12,))
    st["caches"]["active"].fill_(True)
    with torch.inference_mode():
        for t in tokens:
            logits_st, new = tmodel.decode_step(st, torch.tensor([[int(t)]]))
            st["pos"].copy_(new["pos"])
    np.testing.assert_allclose(logits_pf[0, 0].numpy(),
                               logits_st[0, 0].numpy(), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):           # bound to its first state
        pf.step(st, tokens, 0, 0)


def test_chunked_prefill_requires_capable_model():
    class NoPrefill:
        pass

    for cls in (ChunkedPrefill, JChunkedPrefill):
        with pytest.raises(NotImplementedError):
            cls(NoPrefill())
    with pytest.raises(ValueError):
        ChunkedPrefill(NoPrefill(), chunk=0)


def test_paged_init_rejects_non_full_attention(setup):
    _, tcfg, _, _, tmodel = setup
    layout = PagedLayout.for_serve(32, page_size=8, num_slots=1)
    st = tmodel.init_decode_state(1, 32, dtype=torch.float32, paged=layout)
    assert st["caches"]["k"].shape == (tcfg.num_layers, 5, 8,
                                       tcfg.num_kv_heads,
                                       tcfg.resolved_head_dim)
    assert st["caches"]["block_table"].shape == (1, 4)
    assert st["caches"]["active"].dtype == torch.bool
    cfg = tmodel.cfg
    tmodel.cfg = dataclasses.replace(cfg, attention="swa")
    try:
        with pytest.raises(NotImplementedError):
            tmodel.init_decode_state(1, 32, paged=layout)
    finally:
        tmodel.cfg = cfg
    dense = tmodel.init_decode_state(1, 32)
    with pytest.raises(NotImplementedError):
        tmodel.prefill_chunk(dense, torch.zeros(4, dtype=torch.int64), 0, 1)


# ---------------------------------------------------------------------------
# the engine against the JAX PagedServeEngine
# ---------------------------------------------------------------------------

def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in lengths]


def _serve(engine, prompts, req_cls, max_new=6, priorities=False):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(uid=i, prompt=p, max_new_tokens=max_new,
                              priority=i % 3 if priorities else 1))
    engine.run_until_drained(max_ticks=2000)
    return {r.uid: list(r.output) for r in engine.completed}


def _dispatches(snapshot):
    return {c["labels"]["program"]: c["value"]
            for c in snapshot["counters"]
            if c["name"] == "serve_step_dispatch_total"}


ENGINE_CASES = {
    # mixed prompt lengths, fully provisioned arena
    "greedy": dict(lengths=(5, 23, 11, 37, 17), slots=4),
    "sampled": dict(lengths=(5, 23, 11, 37, 17), slots=4,
                    temperature=0.8, top_k=8),
    # an undersized arena forces page-eviction preemption
    "preempt": dict(lengths=(5, 23, 11, 37), slots=4, num_pages=13),
    "preempt_sampled": dict(lengths=(5, 23, 11, 37), slots=4, num_pages=13,
                            temperature=0.8, top_k=8),
    # admission order with preemptions: priorities from the requests
    "fcfs": dict(lengths=(5, 23, 11, 37), slots=2, num_pages=13,
                 priorities=True),
    "priority": dict(lengths=(5, 23, 11, 37), slots=2, num_pages=13,
                     priorities=True, policy="priority"),
}


@pytest.fixture(scope="module")
def engine_runs(setup):
    """Each case through the JAX engine and the port's, once."""
    jcfg, tcfg, jmodel, params, tmodel = setup
    out = {}
    for name, case in ENGINE_CASES.items():
        case = dict(case)
        prompts = _prompts(tcfg, case.pop("lengths"))
        prio = case.pop("priorities", False)
        policy = case.pop("policy", "fcfs")
        kw = dict(num_slots=case.pop("slots"), max_len=96, page_size=8,
                  prefill_chunk=16, **case)
        jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
        jeng = JPagedServeEngine(jmodel, params, JPagedServeConfig(
            sched=JSchedConfig(policy=policy), **kw), metrics=jreg)
        teng = PagedServeEngine(tmodel, PagedServeConfig(
            sched=SchedConfig(policy=policy), **kw), device="cpu",
            metrics=treg)
        out[name] = dict(
            want=_serve(jeng, prompts, JRequest, priorities=prio),
            got=_serve(teng, prompts, Request, priorities=prio),
            jeng=jeng, teng=teng, jreg=jreg, treg=treg, prompts=prompts)
    return out


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_match_jax(engine_runs, case):
    run = engine_runs[case]
    teng, jeng = run["teng"], run["jeng"]
    assert run["got"] == run["want"]
    assert len(run["got"]) == len(run["prompts"])
    assert all(len(t) == 6 for t in run["got"].values())
    assert [r.uid for r in teng.completed] == [r.uid for r in jeng.completed]
    assert teng.prefill.dispatches == jeng.prefill.dispatches
    assert _dispatches(run["treg"].snapshot()) == \
        _dispatches(run["jreg"].snapshot())
    for name in ("serve_preempt_total", "serve_prefill_tokens_total",
                 "serve_tokens_total"):
        assert run["treg"].counter(name).value == \
            run["jreg"].counter(name).value
    assert [r.wasted_prefill_tokens for r in teng.completed] == \
        [r.wasted_prefill_tokens for r in jeng.completed]
    # the CPU engine stays eager: nothing captured
    assert teng._graph is None and teng.captures == teng.prefill.captures == 0
    assert teng.kv.pages_used == 0 and teng.tick_count == jeng.tick_count


def test_preemption_and_policies_keep_the_tokens(engine_runs):
    assert engine_runs["preempt"]["treg"].counter(
        "serve_preempt_total").value >= 1
    uninterrupted = {u: t for u, t in engine_runs["greedy"]["got"].items()
                     if u < 4}
    assert engine_runs["preempt"]["got"] == uninterrupted
    assert engine_runs["preempt_sampled"]["got"] == {
        u: t for u, t in engine_runs["sampled"]["got"].items() if u < 4}
    assert engine_runs["fcfs"]["got"] == engine_runs["priority"]["got"] == \
        uninterrupted


def test_paged_matches_the_dense_engine(setup, engine_runs):
    """With max_len a multiple of page_size, both attention reductions run
    over the same length: the dense engine (token-by-token ingest) gives the
    paged engine's tokens in float32."""
    _, tcfg, _, _, tmodel = setup
    run = engine_runs["greedy"]
    dense = _serve(ServeEngine(tmodel, ServeConfig(num_slots=4, max_len=96),
                               device="cpu", metrics=tobs.MetricsRegistry()),
                   run["prompts"], Request)
    assert dense == run["got"]


def test_prefill_dispatch_is_chunked(engine_runs):
    run = engine_runs["greedy"]
    want = sum(-(-len(p) // 16) for p in run["prompts"])
    assert run["teng"].prefill.dispatches == want
    by_prog = _dispatches(run["treg"].snapshot())
    assert by_prog["prefill"] == want and by_prog["decode"] >= 1


def test_kernel_dispatch_counts_every_executed_matmul(setup):
    """On the CPU every executed packed matmul is counted (the JAX package
    counts once per trace; see ROADMAP Queue 3): 7 projections a layer in
    every prefill chunk and every decode step."""
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree

    jcfg, tcfg, _, params, _ = setup
    model = pack_tree(to_torch_model(params, tcfg))

    def dispatch_total():
        return sum(c["value"] for c in tobs.metrics().snapshot()["counters"]
                   if c["name"] == "kernel_dispatch_total")

    for lengths in ((4, 9), (31, 17)):
        before = dispatch_total()
        eng = PagedServeEngine(model, PagedServeConfig(
            num_slots=2, max_len=96, page_size=8, prefill_chunk=16),
            policy=ExecPolicy(mode="packed"), device="cpu",
            metrics=tobs.MetricsRegistry())
        _serve(eng, _prompts(tcfg, lengths), Request)
        runs = eng.prefill.dispatches + eng._m_disp_decode.value
        assert dispatch_total() - before == 7 * tcfg.num_layers * runs


def test_submit_validation(setup):
    _, tcfg, _, _, tmodel = setup
    eng = PagedServeEngine(tmodel, PagedServeConfig(
        num_slots=1, max_len=32, page_size=8, num_pages=3), device="cpu",
        metrics=tobs.MetricsRegistry())
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=np.zeros(40, np.int32)))
    with pytest.raises(RuntimeError):
        # needs 3 pages at peak; the arena only has 2 usable
        eng.submit(Request(uid=2, prompt=np.zeros(17, np.int32),
                           max_new_tokens=4))
    eng.submit(Request(uid=3, prompt=np.zeros(5, np.int32),
                       max_new_tokens=2))
    with pytest.raises(ValueError):               # uid already submitted
        eng.submit(Request(uid=3, prompt=np.zeros(5, np.int32),
                           max_new_tokens=2))


def test_arena_exhaustion_without_preemption_raises(setup):
    _, tcfg, _, _, tmodel = setup
    eng = PagedServeEngine(
        tmodel, PagedServeConfig(num_slots=2, max_len=64, page_size=8,
                                 num_pages=9, prefill_chunk=16,
                                 sched=SchedConfig(preempt=False)),
        device="cpu", metrics=tobs.MetricsRegistry())
    for i, p in enumerate(_prompts(tcfg, (20, 20))):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    with pytest.raises(RuntimeError, match="preemption disabled"):
        eng.run_until_drained(max_ticks=2000)


def test_make_engine_builds_the_paged_engine(setup):
    _, tcfg, _, params, tmodel = setup
    cfg = PagedServeConfig(num_slots=2, max_len=32, page_size=8)
    eng = make_engine(tmodel, cfg, device="cpu",
                      metrics=tobs.MetricsRegistry())
    assert isinstance(eng, PagedServeEngine) and isinstance(eng, Engine)
    # speculative decoding is ported (it was refused by name before): the
    # paged engine with spec=, built directly and through make_engine,
    # serves the stream of the one without it
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.core.sparsity import PackedWeight
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.spec import SpecConfig, tier_sort_tree
    packed = tier_sort_tree(pack_tree(to_torch_model(params, tcfg)))
    # the densest node's pattern: the draft narrows it
    pw = max((m for m in packed.modules()
              if isinstance(m, PackedWeight)),
             key=lambda m: m.cfg.n_effective)
    spec = SpecConfig(f"{pw.cfg.n_effective // 2}:{pw.cfg.m}", gamma=3)
    policy = ExecPolicy(mode="packed", backend="reference")
    streams = []
    for build, s in ((PagedServeEngine, None), (PagedServeEngine, spec),
                     (make_engine, spec)):
        e = build(packed, cfg, device="cpu", policy=policy, spec=s,
                  metrics=tobs.MetricsRegistry())
        for i, p in enumerate(_prompts(tcfg, (9, 5, 7))):
            e.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        e.run_until_drained()
        streams.append({r.uid: list(r.output) for r in e.completed})
        assert isinstance(e, PagedServeEngine)
    assert streams[0] == streams[1] == streams[2]
    assert e.tier_report.narrowed > 0
    assert e._spec_metrics._verify_dispatches > 0
    # autotune is ported: the engine builds (the masked model here has no
    # packed weight to tune; tests/test_torch_tune.py tunes packed ones)
    eng = PagedServeEngine(tmodel, cfg, device="cpu", autotune=True,
                           metrics=tobs.MetricsRegistry())
    assert isinstance(eng, PagedServeEngine)
    with pytest.raises(ValueError):              # the model is on the CPU
        PagedServeEngine(tmodel, cfg, device="meta")


# ---------------------------------------------------------------------------
# the serving program: run_serve(paged=True) and the CLI flags
# ---------------------------------------------------------------------------

TRACE = "benchmarks/traces/tiny_trace.jsonl"


@pytest.mark.parametrize("kw", [
    dict(packed=True),
    dict(packed=True, layout="block", quantize="int8"),
    dict(packed=True, max_pages=16, scheduler="priority",
         trace_replay=TRACE),
    dict(packed=False, temperature=0.8, top_k=8, max_pages=16,
         trace_replay=TRACE),
])
def test_run_serve_paged_matches_jax(setup, kw):
    from repro.obs import slo as jslo
    from repro_torch.obs import slo as tslo

    jcfg, tcfg, jmodel, params, _ = setup
    run = dict(requests=5, slots=4, max_new=6, max_len=96, seed=3,
               paged=True, page_size=8, prefill_chunk=16, **kw)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jprev, tprev = jobs.default_registry(), tobs.default_registry()
    jobs.set_default_registry(jreg)
    tobs.set_default_registry(treg)
    try:
        jeng = jax_run_serve(jmodel, params, jcfg.vocab_size,
                             backend="reference", **run)
        teng = run_serve(to_torch_model(params, tcfg), tcfg.vocab_size,
                         backend="reference", device="cpu", **run)
    finally:
        jobs.set_default_registry(jprev)
        tobs.set_default_registry(tprev)
    want = {r.uid: (r.prompt.tolist(), list(r.output))
            for r in jeng.completed}
    got = {r.uid: (r.prompt.tolist(), list(r.output))
           for r in teng.completed}
    assert isinstance(teng, PagedServeEngine)
    assert got == want and len(got) == (12 if "trace_replay" in kw else 5)
    by_uid = {r.uid: r for r in jeng.completed}
    for r in teng.completed:
        assert r.priority == by_uid[r.uid].priority
        assert r.preempts == by_uid[r.uid].preempts
        assert tslo.request_tokens(r) == jslo.request_tokens(by_uid[r.uid])
    assert teng.drain_ticks > 0
    if "trace_replay" in kw:
        assert treg.counter("serve_preempt_total").value >= 1
        assert tslo.slo_report(teng.completed)["goodput"] == \
            jslo.slo_report(jeng.completed)["goodput"]


def test_cli_paged_trace_replay_slo_report_and_flight_dir(tmp_path, caplog,
                                                          capsys):
    from repro_torch.launch.serve import main
    from repro_torch.obs.export import check_propagation, load_events

    flight = tmp_path / "flight"
    trace_out = tmp_path / "t.jsonl"
    metrics_out = tmp_path / "m.json"
    prev = tobs.default_registry()
    tobs.set_default_registry(tobs.MetricsRegistry())
    try:
        main(["--device", "cpu", "--packed", "--paged", "--page-size", "8",
              "--max-pages", "16", "--prefill-chunk", "16", "--max-len",
              "96", "--scheduler", "priority", "--trace-replay", TRACE,
              "--slo-report", "--flight-dir", str(flight), "--trace-out",
              str(trace_out), "--metrics-out", str(metrics_out)])
    finally:
        tobs.set_default_registry(prev)
    _, events = load_events(str(trace_out))
    assert check_propagation(events) == []
    names = {e["name"] for e in events}
    assert {"request_prefill", "prefill_chunk", "request_schedule",
            "request_preempt", "request_resume"} <= names
    import json
    snap = json.loads(metrics_out.read_text())
    counters = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                for c in snap["counters"]}
    assert counters[("serve_preempt_total", ())] >= 1
    assert counters[("serve_step_dispatch_total",
                     (("program", "prefill"),))] > 0
    assert {g["name"] for g in snap["gauges"]} >= {
        "kv_pages_free", "kv_arena_occupancy", "kv_page_fragmentation"}
    assert not flight.exists() or list(flight.iterdir()) == []
    out = capsys.readouterr()
    assert "packed+paged" in out.out + out.err + caplog.text
    assert '"goodput"' in out.out + out.err + caplog.text
