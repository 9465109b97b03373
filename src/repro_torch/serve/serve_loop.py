"""Batched serving with continuous slot-based batching.

The engine owns a fixed decode batch of ``num_slots`` sequences.  Requests
(prompts) are queued; a free slot is claimed, its cache region reset, the
prompt prefilled token-by-token (the decode step doubles as a prefill-by-steps
path so the engine needs exactly one program), then generation proceeds until
EOS/max_tokens and the slot frees.

The packed-DeMM serving path is selected by handing the engine a model whose
sparse linears are ``PackedWeight`` nodes (``launch.pack_tree``) plus an
``ExecPolicy(mode="packed", backend=...)``: every projection in the decode
step then reads only packed bytes.

Each tick runs the decode step under ``torch.inference_mode()`` and
synchronises with the device once, when it pulls the logits (and the slot
positions) to the host; sampling happens there.

A sharding plan (``ExecPolicy(plan=ShardingPlan(...))``, or ``make_engine(
plan=...)``) places the model and the decode state on this rank
(``protocol.EngineBase._setup_plan``); under ``pp`` the step is the model's
``decode_step_pipelined``.  Such an engine steps eagerly.

The compiled step.  The JAX package compiles the decode step into one
program (``jax.jit``).  Its counterpart here is a CUDA graph: a CUDA engine
captures ``model.decode_step`` once, at its first tick (under the first
lane's trace context, where the JAX package traces), after one eager
warm-up step on a side stream that builds the kernels and runs their
one-off set-up (:func:`capture_graph`, which the paged engine shares); it
then restores the decode state to what ``init_decode_state`` made and
replays the graph on every tick.  The graph
reads and writes static tensors that live as long as the engine: the next
tokens (filled each tick from a pinned host buffer), the KV caches, the
slot positions ``state["pos"]`` (the captured region writes the advanced
positions back into that same tensor) and the logits it leaves.  A failure
to capture or replay raises; the engine never runs the step eagerly in its
place.  ``ServeEngine(_eager=True)`` runs the eager step on the card as a
measurement and test hook.  The CPU engine is always eager.  Host-side
counters (``kernel_dispatch_total``, the kernels' ``launches``) move during
the warm-up and the capture only, not on replays: the JAX package's
once-per-trace meaning.

Sampling: ``ServeConfig(temperature=, top_k=, seed=)`` selects the replay-safe
coupled sampler (``repro_torch.spec.sampling``) — greedy argmax at
``temperature == 0``.  Speculative decoding: pass
``spec=SpecConfig(draft="N:M", gamma=G)`` and the engine drafts γ tokens per
tick with the *draft-tier* view of the same packed tensors, then verifies the
whole window in one full-tier program (``repro_torch.spec.decode``).  The
committed stream is token-identical to the non-speculative engine at any
temperature.  On a CUDA engine the draft step and each verify width are
graphs of their own (:class:`SpecPrograms`); the plain step is captured only
if a window ever clamps to a plain step near ``max_len``.

Observability (``repro_torch.obs``): the engine instruments the full request
lifecycle on its :class:`~repro_torch.obs.MetricsRegistry` (the process
default unless ``metrics=`` is given) — queue wait submit→first-claim,
per-token decode latency, time-to-first-token, tick duration histograms;
slot-occupancy and tokens/sec gauges; request/token counters — and emits
``request_submit`` / ``request_claim`` / ``request_first_token`` /
``request_complete`` events plus one ``request`` span per request on the
registry's event trace.  ``ServeEngine(recorder=)`` attaches a
:class:`~repro_torch.obs.FlightRecorder`, whose tick watchdog ``step()``
beats first thing (on the host, outside the graph).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import require_device
from repro_torch.serve.protocol import EngineBase

# eager steps a CUDA engine runs on a side stream before it captures its step
CAPTURE_WARMUP = 1


class Staged:
    """Device tensors that a captured program reads, refilled from the host.

    Each :meth:`push` writes numpy values into pinned host buffers (plain
    ones on the CPU) and copies them into ``targets`` without blocking.  A
    pinned buffer may be rewritten only once its last copy has run, so a
    push first waits on the event recorded after the previous one's copies:
    the host then runs at most one program ahead of the device.
    """

    def __init__(self, *targets: torch.Tensor):
        self.targets = targets
        self.cuda = targets[0].device.type == "cuda"
        self._stage = [torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=self.cuda) for t in targets]
        self._views = [s.numpy() for s in self._stage]
        self._copied = None

    def push(self, *values):
        if self._copied is not None:
            self._copied.synchronize()
        for view, value in zip(self._views, values):
            view[...] = value
        for target, stage in zip(self.targets, self._stage):
            target.copy_(stage, non_blocking=self.cuda)
        if self.cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor leaf of a decode state (nested dicts; the ``kind`` tags
    and a paged layout are not tensors), in the dicts' order: the same
    order for two states that one ``init_decode_state`` made."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in state_tensors(v)]
    return []


def capture_graph(fn, written, device, warmup: int = CAPTURE_WARMUP):
    """Capture ``fn`` (no arguments; returns a tensor) into a CUDA graph.

    ``warmup`` eager calls on a side stream first build the kernel library
    and run every launcher's one-off set-up (shared-memory opt-ins, cached
    device attributes), as ``torch.cuda.graphs`` documents, and make
    whatever ``fn`` caches on the device (a capture runs nothing).  They
    write the state that ``fn`` writes, so the tensors ``written`` (all of
    it) are copied before and restored after.  Returns (graph, the output
    tensor the replays rewrite).  Any failure raises.

    The garbage collector runs before the capture and not during it: a
    collection that frees a dead engine (its pinned buffers, its graphs)
    makes CUDA calls that a capture forbids, and the capture is lost."""
    saved = [t.clone() for t in written]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    for t, before in zip(written, saved):
        t.copy_(before)
    return graph, out


class SpecPrograms:
    """The draft step, the verify program and the speculation window of a
    speculative engine, shared by :class:`ServeEngine` and
    ``paged.PagedServeEngine``.  The engine provides ``model``, ``policy``,
    ``cfg``, ``device``, ``metrics``, ``state``, ``_use_graph``,
    ``_decode(model, tokens)`` (its decode step on its static tensors) and
    the request loop's slots, sampler, next tokens, metrics and
    ``_complete``.  On a CUDA engine each program
    is a graph of its own: the draft step (its kernels read other operands
    than the full step's, so it cannot replay that graph) captured the
    first time it runs, and the verify program once for each window width
    W, when W first runs, each with its own static (slots, W) token buffer
    and memory pool (the widths are captured lazily, so their replays do
    not come in the order of their captures)."""

    def _setup_spec(self, spec):
        """The draft model (a view of the sorted model), the verify
        program, the static token inputs of the draft and verify programs
        and the ``spec_*`` metric families."""
        from repro_torch.spec.decode import (SpecMetrics, guard_cache_kinds,
                                             make_multistep)
        from repro_torch.spec.tiers import derive_draft_tier

        guard_cache_kinds(self.state)
        self.draft_model, self.tier_report = derive_draft_tier(self.model,
                                                               spec.draft)
        self._multistep = make_multistep(self.model, self.policy)
        self._spec_metrics = SpecMetrics(self.metrics)
        slots = self.cfg.num_slots
        self._draft_tok = torch.zeros((slots, 1), dtype=torch.int64,
                                      device=self.device)
        self._draft_in = Staged(self._draft_tok)
        self._window = {}        # W -> (static (slots, W) tokens, Staged)
        self._spec_graphs = {}   # "draft" or W -> (graph, logits output)
        self.spec_captures = {"draft": 0, "verify": {}}
        # ticks by window width W (1: a plain step, near max_len)
        self.spec_windows = {}
        self.last_window_logits = None

    def _written(self):
        """The state tensors every program writes, which a capture's
        warm-up restores."""
        caches = self.state["caches"]
        return [caches["k"], caches["v"], self.state["pos"]]

    def _spec_program(self, key, fn) -> torch.Tensor:
        """Run a draft or verify program: on a CUDA engine the replay of
        its graph (captured here the first time ``key`` runs), else ``fn``
        eagerly."""
        if not self._use_graph:
            return fn()
        hit = self._spec_graphs.get(key)
        if hit is None:
            hit = self._spec_graphs[key] = capture_graph(
                fn, self._written(), self.device)
            if key == "draft":
                self.spec_captures["draft"] += 1
            else:
                v = self.spec_captures["verify"]
                v[key] = v.get(key, 0) + 1
        hit[0].replay()
        return hit[1]

    def _run_draft(self, tokens: np.ndarray) -> np.ndarray:
        """One draft-tier decode step of the whole batch on ``tokens``
        (slots,); returns its logits (slots, V) on the host."""
        self._draft_in.push(tokens[:, None])
        return self._spec_program(
            "draft", lambda: self._decode(self.draft_model,
                                          self._draft_tok)).cpu().numpy()

    def _run_verify(self, window: np.ndarray) -> np.ndarray:
        """The full-tier verify program over ``window`` (slots, W) from the
        positions in ``state["pos"]``; returns logits (slots, W, V) on the
        host."""
        w = window.shape[1]
        if w not in self._window:
            toks = torch.zeros((self.cfg.num_slots, w), dtype=torch.int64,
                               device=self.device)
            self._window[w] = (toks, Staged(toks))
        toks, staged = self._window[w]
        staged.push(window)

        def verify():
            logits, new = self._multistep(self.state, toks)
            self.state["pos"].copy_(new["pos"])
            return logits.to(torch.float32)

        return self._spec_program(w, verify).cpu().numpy()

    def _spec_gamma(self, top: int) -> int:
        """γ_eff of this tick's window: γ clamped so that no lane (``top``:
        the largest position among them) writes past ``max_len``.  Counts
        the tick in ``spec_windows`` by its width (1: a plain step, when
        γ_eff < 1)."""
        g_eff = min(self._spec.gamma, self.cfg.max_len - 1 - top)
        w = g_eff + 1 if g_eff >= 1 else 1
        self.spec_windows[w] = self.spec_windows.get(w, 0) + 1
        return g_eff

    def _speculate(self, lanes, pos0, g_eff, *, prompt_input, push_pos0,
                   lane_end, dispatched=None):
        """One speculation window over ``lanes`` (``spec.decode`` sets out
        the three stages): γ_eff draft-tier steps propose tokens, one
        full-tier verify program checks every window position from the
        pre-draft positions ``pos0``, then each lane commits its accepted
        prefix + the correcting/bonus token.  The draft steps write the
        state in place (KV at the window's positions, the advanced ``pos``),
        so ``push_pos0()`` moves ``pos`` back before the verify, which
        rewrites every window position's KV.

        What differs between the engines comes in as callables:
        ``prompt_input(i, j)`` is the prompt token lane ``i`` feeds as window
        input ``j + 1`` (None once its prompt is fed: the draft proposes
        there); ``lane_end(i, p, valid, finished)`` takes a lane's window
        start ``p`` and the window inputs it keeps; ``dispatched``: the
        draft and verify dispatch counters, if the engine has them."""
        t0 = time.perf_counter()
        W = g_eff + 1
        window = np.zeros((self.cfg.num_slots, W), np.int64)
        window[:, 0] = self._next_tok[:, 0]
        is_draft = np.zeros((self.cfg.num_slots, g_eff), bool)
        drafts = []
        with obs.use_context(self._request_context(self.active[lanes[0]])):
            for j in range(g_eff):
                d_logits = self._run_draft(window[:, j])
                drafts.append(d_logits)
                if dispatched:
                    dispatched[0].inc()
                for i in lanes:
                    tok = prompt_input(i, j)
                    if tok is None:
                        # the draft proposes with the SAME (rid, pos) key
                        # the verifier samples with — acceptance iff equal
                        tok = self.sampler.sample(
                            d_logits[i], self.active[i].uid,
                            int(pos0[i]) + j + 1)
                        is_draft[i, j] = True
                    window[i, j + 1] = tok
            push_pos0()
            f_logits = self._run_verify(window)
        if dispatched:
            dispatched[1].inc()
        self.last_logits = f_logits[:, 0]
        self.last_window_logits = {"lanes": list(lanes),
                                   "draft": np.stack(drafts),
                                   "verify": f_logits}
        window_dt = time.perf_counter() - t0
        now = time.monotonic()
        drafted = accepted = committed = 0
        for i in lanes:
            req = self.active[i]
            p = int(pos0[i])
            valid, finished = W, False  # window inputs this lane keeps
            lane_accepted = lane_committed = 0
            for j in range(W):
                nxt = prompt_input(i, j)
                if nxt is not None:     # input j + 1 is still the prompt's
                    self._m_prefill.inc()
                    if j == g_eff:      # the window ends mid-prompt
                        self._next_tok[i, 0] = nxt
                    continue
                tok = self.sampler.sample(f_logits[i, j], req.uid, p + j + 1)
                if j < g_eff and is_draft[i, j]:
                    drafted += 1
                    ok = int(window[i, j + 1]) == tok
                    accepted += ok
                    lane_accepted += ok
                req.output.append(tok)
                committed += 1
                lane_committed += 1
                self._m_tokens.inc()
                if len(req.output) == 1:
                    req.first_token_ts = now
                    self._m_ttft.observe(now - req.submit_ts)
                    self._sk_ttft.observe(now - req.submit_ts)
                    self.trace.event("request_first_token", uid=req.uid,
                                     trace_id=req.trace_id)
                if (len(req.output) >= req.max_new_tokens or
                        (req.eos_id is not None and tok == req.eos_id) or
                        p + j + 1 >= self.cfg.max_len - 1):
                    valid, finished = j + 1, True
                    self._complete(i, req, now)
                    break
                if j < g_eff and int(window[i, j + 1]) != tok:
                    # the first mismatch truncates the window; the committed
                    # full-tier token opens the next one
                    valid = j + 1
                    self._next_tok[i, 0] = tok
                    break
                if j == g_eff:
                    # every draft accepted: the bonus token rides along
                    self._next_tok[i, 0] = tok
            lane_end(i, p, valid, finished)
            # every drafted-but-uncommitted proposal is wasted work
            # (drafts past a truncation point too, discarded unexamined)
            lane_rejected = int(is_draft[i].sum()) - lane_accepted
            if lane_rejected > 0:
                req.rejected_draft_tokens += lane_rejected
                self._spec_metrics.observe_wasted(lane_rejected)
            if lane_committed:
                self.trace.event("spec_commit", uid=req.uid,
                                 trace_id=req.trace_id,
                                 committed=lane_committed,
                                 accepted=lane_accepted,
                                 rejected=lane_rejected)
        if committed:
            per_tok = window_dt / committed
            for _ in range(committed):
                self._m_tok_lat.observe(per_tok)
                self._sk_tok.observe(per_tok)
        self._spec_metrics.observe_window(drafted, accepted, committed)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    priority: int = 1           # 0 = highest; a scheduler's policy
    # filled by the engine:
    output: Optional[list] = None
    # lifecycle timestamps (time.monotonic seconds), filled by the engine:
    submit_ts: Optional[float] = None
    claim_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    complete_ts: Optional[float] = None
    # correlates every trace event emitted on this request's behalf
    trace_id: Optional[str] = None
    # waste / phase attribution (repro_torch.obs.slo):
    preempts: int = 0                 # times evicted by a paged scheduler
    wasted_prefill_tokens: int = 0    # tokens re-ingested after preemption
    rejected_draft_tokens: int = 0    # draft proposals the verifier threw away
    preempt_overhead_s: float = 0.0   # evict -> resumed-re-prefill round trips
    preempt_ts: Optional[float] = None   # open preemption episode start


@dataclasses.dataclass
class ServeConfig:
    num_slots: int = 4
    max_len: int = 256
    temperature: float = 0.0    # 0 means greedy
    top_k: int = 0              # 0 = full vocab
    seed: int = 0               # sampling seed (keys the per-position RNG)


class ServeEngine(SpecPrograms, EngineBase):
    def __init__(self, model, cfg: ServeConfig, *, policy=None, metrics=None,
                 device="cuda", recorder=None, autotune: bool = False,
                 spec=None, _eager: bool = False):
        from repro_torch.core.sparse_linear import resolve_policy
        from repro_torch.spec.sampling import ReplaySafeSampler

        self.device = require_device(device)
        if model.device.type != self.device.type:
            raise ValueError(
                f"model lives on {model.device} but the engine was asked "
                f"for {self.device}; build or move the model there first")
        self.model = model
        self.cfg = cfg
        self.policy = resolve_policy(policy)
        self._spec = spec
        # policy.plan: renumber and place the model on this rank before
        # anything is tuned, allocated or captured
        self._setup_plan(self.policy, spec)
        if spec is not None:
            # the tier-sort invariant (every group's pairs magnitude-
            # descending, in place) before anything is tuned or captured,
            # so that the draft's prefix is exact magnitude pruning
            from repro_torch.spec.tiers import tier_sort_tree
            tier_sort_tree(model)
        if autotune and self.policy.mode == "packed":
            # measure every packed weight at the decode batch before the
            # cache is allocated and anything is captured, so that
            # backend="auto" resolves from measured entries at the warm-up
            # step and the capture
            from repro_torch import tune
            tune.autotune_packed_tree(model, cfg.num_slots)
        # the KV cache is float32 whatever the compute dtype; this rank's
        # block of it under a plan
        self.state = self._place_state(
            model.device, batch=cfg.num_slots, max_len=cfg.max_len,
            dtype=torch.float32)
        # what a claimed slot is reset to: each state tensor's slot axis
        # (where a one-slot and a two-slot state's shapes differ, both made
        # on the meta device, without memory) and the one value the fresh
        # state holds in it (0 for caches and ``pos``, -1 for ``slot_pos``)
        one, two = (model.init_decode_state(n, cfg.max_len,
                                            dtype=torch.float32,
                                            device="meta") for n in (1, 2))
        self._slot_init = []
        for cur, a, b in zip(state_tensors(self.state), state_tensors(one),
                             state_tensors(two)):
            ax = next((d for d, (m, n) in enumerate(zip(a.shape, b.shape))
                       if m != n), None)
            if ax is None:
                continue
            lo, hi = (v.item() for v in cur.aminmax())
            if lo != hi:
                raise ValueError(f"a fresh decode state tensor of shape "
                                 f"{tuple(cur.shape)} holds more than one "
                                 f"value ({lo} .. {hi})")
            self._slot_init.append((cur, ax, lo))
        # the next tokens: the host loop writes ``_next_tok``, a numpy view
        # of a (pinned, on a CUDA engine) host buffer that is copied into
        # the step's static input each tick (on the CPU they are one tensor)
        self._tok_host = torch.zeros((cfg.num_slots, 1), dtype=torch.int64,
                                     pin_memory=self.device.type == "cuda")
        self._next_tok = self._tok_host.numpy()
        self._tokens = self._tok_host.to(self.device)
        self._use_graph = (self.device.type == "cuda" and not _eager
                           and not self.multi_rank)
        self._graph = None       # captured at the first tick
        if self.plan is not None and self.plan.pp > 1:
            pp = self.plan.pp
            self._step_fn = lambda state, tokens, policy: \
                model.decode_step_pipelined(state, tokens, policy=policy,
                                            pp=pp)
        else:
            self._step_fn = None     # the model's decode_step
        self._logits = None      # the graph's logits output (slots, V) f32
        self.captures = 0        # captures of the plain decode step
        self.queue: deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * cfg.num_slots
        self._fed: List[int] = [0] * cfg.num_slots    # prompt tokens fed
        self.completed: List[Request] = []
        self.last_logits: Optional[np.ndarray] = None  # (slots, V) of last tick
        self.sampler = ReplaySafeSampler(temperature=cfg.temperature,
                                         top_k=cfg.top_k, seed=cfg.seed)
        # -- observability (instruments fetched once) -----------------------
        self.metrics = metrics if metrics is not None else obs.metrics()
        m = self.metrics
        self.trace = m.trace
        self._spans = {}                              # uid -> open Span
        self._m_submitted = m.counter(
            "serve_requests_submitted_total", help="requests accepted")
        self._m_completed = m.counter(
            "serve_requests_completed_total", help="requests fully decoded")
        self._m_tokens = m.counter(
            "serve_tokens_total", help="generated (decode) tokens")
        self._m_prefill = m.counter(
            "serve_prefill_tokens_total", help="prompt tokens prefilled")
        self._m_queue_wait = m.histogram(
            "serve_queue_wait_seconds", help="submit -> first slot claim")
        self._m_ttft = m.histogram(
            "serve_time_to_first_token_seconds",
            help="submit -> first generated token")
        self._m_tok_lat = m.histogram(
            "serve_decode_token_seconds",
            help="decode-step latency per generated token")
        self._m_tick = m.histogram(
            "serve_tick_seconds", help="full engine tick duration")
        self._m_slots = m.gauge(
            "serve_slots_active", help="occupied decode slots")
        self._m_tps = m.gauge(
            "serve_tokens_per_second",
            help="decode throughput of the last run_until_drained window")
        # sketch-backed latency percentiles (the fixed-bucket histograms
        # above stay for rate/dashboard queries)
        self._sk_ttft = m.sketch(
            "serve_ttft_seconds_sketch",
            help="submit -> first token (quantile sketch)")
        self._sk_tok = m.sketch(
            "serve_decode_token_seconds_sketch",
            help="per-generated-token decode latency (quantile sketch)")
        self._sk_e2e = m.sketch(
            "serve_e2e_seconds_sketch",
            help="submit -> completion (quantile sketch)")
        self._setup_recorder(recorder)
        self._report_eager(m)
        if self._shctx is not None:
            self.step = self._wrap_step(self.step)
        if spec is not None:
            self._setup_spec(spec)
            self._pos_in = Staged(self.state["pos"])

    def submit(self, req: Request):
        req.output = []
        req.submit_ts = time.monotonic()
        ctx = self._request_context(req)   # mints req.trace_id
        self.queue.append(req)
        self._m_submitted.inc()
        with obs.use_context(ctx):
            self._spans[req.uid] = self.trace.span("request", uid=req.uid)
            self.trace.event("request_submit", uid=req.uid,
                             prompt_len=len(req.prompt))

    def _claim_slots(self):
        for i in range(self.cfg.num_slots):
            if self.active[i] is None and self.queue:
                req = self.queue.popleft()
                self.active[i] = req
                self._fed[i] = 0
                self._reset_slot(i)
                self._next_tok[i, 0] = req.prompt[0]
                req.claim_ts = time.monotonic()
                self._m_queue_wait.observe(req.claim_ts - req.submit_ts)
                self.trace.event("request_claim", uid=req.uid, slot=i,
                                 trace_id=req.trace_id)

    def _reset_slot(self, i):
        """Restore slot ``i``'s region of every state tensor to its initial
        value, in place: position 0, zeroed caches, ring slots empty
        (``slot_pos`` -1).  (Attention masks stale entries by position;
        resetting keeps the state equal to the reference's.)"""
        for cur, ax, value in self._slot_init:
            cur.select(ax, i).fill_(value)

    def _written(self):
        """Every tensor of the decode state: what a capture's warm-up
        writes and restores (the caches of any kind, ring positions and
        ``pos``)."""
        return state_tensors(self.state)

    def _complete(self, i, req, now):
        req.complete_ts = now
        self.completed.append(req)
        self.active[i] = None
        self._m_completed.inc()
        self._sk_e2e.observe(now - req.submit_ts)
        self.trace.event("request_complete", uid=req.uid,
                         tokens=len(req.output), trace_id=req.trace_id)
        span = self._spans.pop(req.uid, None)
        if span is not None:
            span.end(tokens=len(req.output))

    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick: one decode step for the whole batch.  Returns the
        number of active slots.  The whole tick runs in inference mode (the
        slot reset and the step rewrite the engine's state tensors in
        place).  The flight recorder's watchdog is beaten first."""
        t_tick = time.perf_counter()
        self._beat()
        self._claim_slots()
        lanes = [i for i, r in enumerate(self.active) if r is not None]
        self._m_slots.set(len(lanes))
        if not lanes:
            return 0
        if self._spec is not None:
            # a copy: on the CPU the state's tensor is the host array
            pos0 = self.state["pos"].cpu().numpy().copy()
            g_eff = self._spec_gamma(max(int(pos0[i]) for i in lanes))
            if g_eff >= 1:
                return self._spec_window(t_tick, lanes, pos0, g_eff)
            # a lane is one token from max_len: a plain step instead
        return self._plain_step(t_tick, lanes)

    def _plain_step(self, t_tick, lanes) -> int:
        t0 = time.perf_counter()
        # batched dispatch: attributed to the first active lane's request
        with obs.use_context(self._request_context(self.active[lanes[0]])):
            logits = self._run_step()
            # the tick's one device sync: logits and positions to the host
            logits = logits.cpu().numpy()
            pos = self.state["pos"].cpu().numpy()
        self.last_logits = logits
        step_dt = time.perf_counter() - t0
        now = time.monotonic()
        for i in lanes:
            req = self.active[i]
            self._fed[i] += 1
            if self._fed[i] < len(req.prompt):
                # still prefilling: feed the next prompt token
                self._next_tok[i, 0] = req.prompt[self._fed[i]]
                self._m_prefill.inc()
                continue
            # the emitted token occupies sequence index _fed[i] (== pos)
            tok = self.sampler.sample(logits[i], req.uid, self._fed[i])
            req.output.append(tok)
            self._next_tok[i, 0] = tok
            self._m_tokens.inc()
            self._m_tok_lat.observe(step_dt)
            self._sk_tok.observe(step_dt)
            if len(req.output) == 1:
                req.first_token_ts = now
                self._m_ttft.observe(now - req.submit_ts)
                self._sk_ttft.observe(now - req.submit_ts)
                self.trace.event("request_first_token", uid=req.uid,
                                 trace_id=req.trace_id)
            done = (len(req.output) >= req.max_new_tokens or
                    (req.eos_id is not None and tok == req.eos_id) or
                    int(pos[i]) >= self.cfg.max_len - 1)
            if done:
                self._complete(i, req, now)
        self._m_slots.set(sum(r is not None for r in self.active))
        self._m_tick.observe(time.perf_counter() - t_tick)
        return sum(r is not None for r in self.active)

    def _run_step(self) -> torch.Tensor:
        """One decode step of the whole batch from ``_next_tok``: a replay
        of the captured graph on a CUDA engine (captured here at the first
        tick), else the eager step.  Returns the logits (slots, V) float32
        on the device."""
        if self._tokens is not self._tok_host:
            # pinned -> device; the host buffer is next written after this
            # tick's device sync, so the copy need not block
            self._tokens.copy_(self._tok_host, non_blocking=True)
        if not self._use_graph:
            return self._decode()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        return self._logits

    def _decode(self, model=None, tokens=None) -> torch.Tensor:
        """The decode step on the engine's static tensors: the KV caches
        are written in place and the advanced positions are copied back into
        ``state["pos"]``, so the step reads and writes the same tensors
        every time (what a CUDA graph needs).  ``model`` / ``tokens``: the
        draft model and its token input (default: the full model and
        ``_tokens``)."""
        tokens = self._tokens if tokens is None else tokens
        if model is None and self._step_fn is not None:
            logits, new = self._step_fn(self.state, tokens, self.policy)
        else:
            logits, new = (model or self.model).decode_step(
                self.state, tokens, policy=self.policy)
        self.state["pos"].copy_(new["pos"])
        return logits[:, 0].to(torch.float32)

    def _capture(self, warmup: int = CAPTURE_WARMUP):
        """Capture :meth:`_decode` into a CUDA graph, once per engine
        (:func:`capture_graph`); the KV caches and the positions are
        restored afterwards to what they held before: at the first tick,
        what ``init_decode_state`` made."""
        self._graph, self._logits = capture_graph(
            self._decode, self._written(), self.device, warmup)
        self.captures += 1

    def _spec_window(self, t_tick, lanes, pos0, g_eff) -> int:
        """One speculation window (:meth:`SpecPrograms._speculate`).  A lane
        still in its prompt feeds its next prompt tokens as window inputs
        (they commit nothing); ``pos`` is pushed back to ``pos0`` before
        the verify and to each lane's last valid input after it (stale
        draft KV beyond it is masked by attention and overwritten by the
        next window)."""
        new_pos = np.asarray(pos0, np.int64).copy()

        def prompt_input(i, j):
            req, fed = self.active[i], self._fed[i] + j + 1
            return req.prompt[fed] if fed < len(req.prompt) else None

        def lane_end(i, p, valid, finished):
            self._fed[i] += valid
            new_pos[i] = p + valid

        self._speculate(lanes, pos0, g_eff, prompt_input=prompt_input,
                        push_pos0=lambda: self._pos_in.push(pos0),
                        lane_end=lane_end)
        self._pos_in.push(new_pos)
        self._m_slots.set(sum(r is not None for r in self.active))
        self._m_tick.observe(time.perf_counter() - t_tick)
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_ticks: int = 10000):
        ticks = 0
        t0 = time.perf_counter()
        tok0 = self._m_tokens.value
        while (self.queue or any(r is not None for r in self.active)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        dt = time.perf_counter() - t0
        if dt > 0:
            self._m_tps.set((self._m_tokens.value - tok0) / dt)
        return ticks
