"""PagedServeEngine: scheduled serving over a paged KV arena.

The engine tick is admit → prefill → decode:

1. **admit** — the scheduler hands over queued requests in policy order; a
   free slot is claimed and pages for the prompt are allocated (admission
   may preempt a strictly lower-priority running request under the
   ``priority`` policy).
2. **prefill** — up to ``prefill_chunks_per_tick`` chunk dispatches are
   spent round-robin over prefilling slots (``repro_torch.paged.prefill``);
   the final chunk's logits yield the request's first generated token.
3. **decode** — one batched decode step over every decode-ready slot; lanes
   still prefilling (or empty) are masked out by the ``active`` mask and
   their writes go to the null page, so the two programs interleave freely
   within a tick.

Speculative decoding (``spec=SpecConfig(...)``): the decode phase drafts γ
tokens with the draft-tier view of the packed tensors, verifies the window in
one full-tier program, commits each lane's accepted prefix + the
correcting/bonus token and trims the pages beyond the committed tokens in the
same tick (``repro_torch.spec.decode``); the stream is token-identical to the
plain decode at any temperature, preemption included.

Page exhaustion preempts: the victim's pages are freed, the request is
requeued with its prompt + generated-so-far output, and a later admission
re-prefills it — the preempt/resume cycle is token-identical to an
uninterrupted run at any temperature, because sampling randomness is keyed
on (request, position), not on a sequential stream
(``repro_torch.spec.sampling``).

The two programs.  The JAX package compiles the decode step and the prefill
chunk once each (``jax.jit``).  On a CUDA engine each is captured once as a
CUDA graph — the decode step at the first decode tick (as
``ServeEngine._capture`` does, under the first lane's trace context), the
chunk at the first chunk (``ChunkedPrefill``) — and replayed after.  Both
graphs read the decode state's static tensors: the arena, written in place,
and the control tensors ``pos``, ``block_table`` and ``active``.  The host
keeps their mirrors (``_pos``, ``kv.table``, ``_decode_mask``) and copies
them, with the next tokens, into those same tensors before each program runs
(``_sync_control``, through pinned buffers).  A failure to capture or replay
raises; nothing runs the step eagerly in its place.  ``_eager=True`` runs
both programs eagerly on the card (a measurement and test hook); the CPU
engine is always eager.

``autotune=True`` measures every packed weight at ``num_slots`` rows
before the arena is allocated and anything is captured
(``repro_torch.tune.autotune_packed_tree``); under ``backend="auto"`` the
decode step then resolves from measured entries and the prefill chunk's
problems by heuristic, as in the reference.  With ``spec=`` the draft step
and each verify width are graphs of their own (``serve_loop.SpecPrograms``),
all reading the same control tensors; the plain decode step is captured only
if a window clamps to a plain step near ``max_len``.  A sharding plan of tp
ranks places the model and splits the arena's head axis on each rank
(``serve.protocol.EngineBase._setup_plan``); such an engine runs both
programs eagerly.
Layering: this module never imports ``repro_torch.models``; the model is
handed in by the caller.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import require_device
from repro_torch.paged.kv_cache import PagedKVCache, PagedLayout
from repro_torch.paged.prefill import ChunkedPrefill
from repro_torch.paged.scheduler import SchedConfig, Scheduler, Stage
from repro_torch.serve.protocol import EngineBase
from repro_torch.serve.serve_loop import (Request, SpecPrograms, Staged,
                                          capture_graph)


@dataclasses.dataclass
class PagedServeConfig:
    num_slots: int = 4
    max_len: int = 256
    page_size: int = 16
    num_pages: Optional[int] = None   # None: fully provisioned (no sharing)
    prefill_chunk: int = 32
    temperature: float = 0.0    # 0 means greedy
    top_k: int = 0              # 0 = full vocab
    seed: int = 0               # sampling seed (keys the per-position RNG)
    sched: SchedConfig = dataclasses.field(default_factory=SchedConfig)


class PagedServeEngine(SpecPrograms, EngineBase):
    """Slot-batched serving with a shared paged KV arena.

    Same surface as :class:`~repro_torch.serve.serve_loop.ServeEngine`
    (``submit`` / ``step`` / ``run_until_drained`` / ``completed``) plus the
    paged internals: ``kv`` (arena bookkeeping), ``sched`` (admission /
    preemption policy), ``prefill`` (the chunk program) and ``captures``
    (captures of the decode step: one on a CUDA engine; with ``spec=``,
    ``spec_captures`` counts the draft step's and each verify width's).
    """

    def __init__(self, model, cfg: PagedServeConfig, *, policy=None,
                 metrics=None, device="cuda", recorder=None,
                 autotune: bool = False, spec=None, _eager: bool = False):
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
        if spec is not None:
            # the tier-sort invariant before the plan places anything and
            # before anything is tuned or captured
            from repro_torch.spec.tiers import tier_sort_tree
            tier_sort_tree(model)
        # policy.plan: place the model on this rank before anything else
        self._setup_plan(self.policy, spec)
        if self.plan is not None and self.plan.pp > 1:
            raise NotImplementedError(
                "pp > 1 applies to the dense-cache engine (the pipelined "
                "decode step over dense caches), not the paged arena")
        if autotune and self.policy.mode == "packed":
            # at the decode batch, before the arena and any capture; the
            # prefill chunk's problems then resolve by heuristic, as in the
            # reference
            from repro_torch import tune
            tune.autotune_packed_tree(model, cfg.num_slots)
        self.layout = PagedLayout.for_serve(
            cfg.max_len, page_size=cfg.page_size, num_pages=cfg.num_pages,
            num_slots=cfg.num_slots)
        self.kv = PagedKVCache(self.layout, cfg.num_slots)
        # the arena is float32 whatever the compute dtype; this rank's
        # block of its head axis under a plan
        self.state = self._place_state(
            model.device, batch=cfg.num_slots, max_len=cfg.max_len,
            dtype=torch.float32, paged=self.layout)
        caches = self.state["caches"]
        self._tokens = torch.zeros((cfg.num_slots, 1), dtype=torch.int64,
                                   device=model.device)
        self._control = Staged(self.state["pos"], caches["block_table"],
                               caches["active"], self._tokens)
        _eager = _eager or self.multi_rank
        self._use_graph = self.device.type == "cuda" and not _eager
        self._graph = None       # the decode step, captured at its first tick
        self._logits = None      # the graph's logits output (slots, V) f32
        self.captures = 0
        self.prefill = ChunkedPrefill(model, chunk=cfg.prefill_chunk,
                                      policy=self.policy, eager=_eager)
        self.sched = Scheduler(cfg.sched)
        # host mirrors of the control tensors (pushed before each program)
        self._pos = np.zeros((cfg.num_slots,), np.int64)
        self._decode_mask = np.zeros((cfg.num_slots,), bool)
        self._next_tok = np.zeros((cfg.num_slots, 1), np.int64)
        self.active: List[Optional[Request]] = [None] * cfg.num_slots
        self._work: List[Optional[np.ndarray]] = [None] * cfg.num_slots
        self._fed = [0] * cfg.num_slots       # work tokens ingested
        self.completed: List[Request] = []
        self.last_logits: Optional[np.ndarray] = None  # last decode tick's
        self.tick_count = 0
        self.sampler = ReplaySafeSampler(temperature=cfg.temperature,
                                         top_k=cfg.top_k, seed=cfg.seed)
        # -- observability (the dense engine's names + paged families) -----
        self.metrics = metrics if metrics is not None else obs.metrics()
        m = self.metrics
        self.trace = m.trace
        self._spans = {}
        self._m_submitted = m.counter(
            "serve_requests_submitted_total", help="requests accepted")
        self._m_completed = m.counter(
            "serve_requests_completed_total", help="requests fully decoded")
        self._m_tokens = m.counter(
            "serve_tokens_total", help="generated (decode) tokens")
        self._m_prefill_tok = m.counter(
            "serve_prefill_tokens_total", help="prompt tokens prefilled")
        self._m_preempt = m.counter(
            "serve_preempt_total",
            help="requests preempted by page eviction")
        self._m_disp_prefill = m.counter(
            "serve_step_dispatch_total",
            help="program invocations per program", program="prefill")
        self._m_disp_decode = m.counter(
            "serve_step_dispatch_total",
            help="program invocations per program", program="decode")
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
        self._m_queue_depth = m.gauge(
            "serve_queue_depth", help="requests waiting for a slot/pages")
        self._m_pages_free = m.gauge(
            "kv_pages_free", help="unallocated KV arena pages")
        self._m_occupancy = m.gauge(
            "kv_arena_occupancy",
            help="fraction of usable arena pages allocated")
        self._m_frag = m.gauge(
            "kv_page_fragmentation",
            help="allocated-but-empty token-slot fraction (last-page slack)")
        self._m_tps = m.gauge(
            "serve_tokens_per_second",
            help="decode throughput of the last run_until_drained window")
        # goodput accounting: tokens whose KV a preemption evicted — the
        # resume re-ingests them, so they are work done twice
        self._m_wasted_preempt = m.counter(
            "serve_wasted_tokens_total",
            help="tokens of work the engine re-did or discarded, by cause",
            cause="preempt")
        self._sk_ttft = m.sketch(
            "serve_ttft_seconds_sketch",
            help="submit -> first token (quantile sketch)")
        self._sk_tok = m.sketch(
            "serve_decode_token_seconds_sketch",
            help="per-generated-token decode latency (quantile sketch)")
        self._sk_e2e = m.sketch(
            "serve_e2e_seconds_sketch",
            help="submit -> completion (quantile sketch)")
        self._m_pages_free.set(self.kv.pages_free)
        self._setup_recorder(recorder)
        self._report_eager(m)
        if self._shctx is not None:
            self.step = self._wrap_step(self.step)
        if spec is not None:
            self._setup_spec(spec)

    def _setup_spec(self, spec):
        """:meth:`SpecPrograms._setup_spec` and the draft and verify
        dispatch counters."""
        super()._setup_spec(spec)
        m = self.metrics
        self._m_disp_draft = m.counter(
            "serve_step_dispatch_total",
            help="program invocations per program", program="draft")
        self._m_disp_verify = m.counter(
            "serve_step_dispatch_total",
            help="program invocations per program", program="verify")

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if len(req.prompt) > self.cfg.max_len - 1:
            raise ValueError(
                f"request {req.uid}: prompt of {len(req.prompt)} tokens "
                f"exceeds max_len-1 = {self.cfg.max_len - 1}")
        peak = min(len(req.prompt) + req.max_new_tokens, self.cfg.max_len)
        need = self.layout.pages_for(peak)
        if need > min(self.layout.usable_pages, self.layout.max_blocks):
            raise RuntimeError(
                f"request {req.uid} needs {need} pages at peak ({peak} "
                f"tokens) but the arena has only "
                f"{self.layout.usable_pages} usable pages "
                f"(max_blocks={self.layout.max_blocks}) — it could never "
                f"complete even with every other sequence evicted; raise "
                f"--max-pages or --page-size")
        req.output = []
        req.submit_ts = time.monotonic()
        ctx = self._request_context(req)   # mints req.trace_id
        self.sched.submit(req)
        self._m_submitted.inc()
        self._m_queue_depth.set(len(self.sched))
        with obs.use_context(ctx):
            self._spans[req.uid] = self.trace.span("request", uid=req.uid)
            self.trace.event("request_submit", uid=req.uid,
                             prompt_len=len(req.prompt),
                             priority=req.priority)

    # -- device-control sync ------------------------------------------------

    def _sync_control(self):
        """Copy the host mirrors (positions, block tables, decode mask) and
        the next tokens into the static tensors both programs read: values
        only, into the same tensors every time."""
        self._control.push(self._pos, self.kv.table, self._decode_mask,
                           self._next_tok)

    def _page_gauges(self):
        self._m_pages_free.set(self.kv.pages_free)
        self._m_occupancy.set(self.kv.occupancy())
        self._m_frag.set(self.kv.fragmentation())

    # -- lifecycle transitions ----------------------------------------------

    def _claim(self, slot: int, req: Request):
        work = (np.concatenate([np.asarray(req.prompt, np.int64),
                                np.asarray(req.output, np.int64)])
                if req.output else np.asarray(req.prompt, np.int64))
        self.active[slot] = req
        self._work[slot] = work
        self._fed[slot] = 0
        self._pos[slot] = 0
        self._decode_mask[slot] = False
        self.kv.note_tokens(slot, 0)
        now = time.monotonic()
        if req.claim_ts is None:
            self._m_queue_wait.observe(now - req.submit_ts)
        req.claim_ts = now
        self.sched.stage[req.uid] = Stage.SCHEDULED
        self.trace.event("request_schedule", uid=req.uid, slot=slot,
                         resume_tokens=len(req.output),
                         trace_id=req.trace_id)
        if req.preempts > 0:
            # a preempt-resume: the whole work buffer is a re-ingest
            self.trace.event("request_resume", uid=req.uid, slot=slot,
                             resume_tokens=len(work),
                             trace_id=req.trace_id)

    def _preempt(self, slot: int):
        req = self.active[slot]
        freed = self.kv.release(slot)
        # every token already ingested into the evicted pages is work the
        # resume must redo — charge it to the preempt waste cause now,
        # while the ingest depth is still known
        evicted_tokens = int(self._pos[slot])
        req.preempts += 1
        req.preempt_ts = time.monotonic()
        if evicted_tokens > 0:
            req.wasted_prefill_tokens += evicted_tokens
            self._m_wasted_preempt.inc(evicted_tokens)
        self.active[slot] = None
        self._work[slot] = None
        self._decode_mask[slot] = False
        self._pos[slot] = 0
        self.sched.stage[req.uid] = Stage.PREEMPTED
        self.sched.requeue(req)
        self._m_preempt.inc()
        self._m_queue_depth.set(len(self.sched))
        self._page_gauges()
        self.trace.event("request_preempt", uid=req.uid, slot=slot,
                         pages_freed=freed, tokens_done=len(req.output),
                         tokens_evicted=evicted_tokens,
                         trace_id=req.trace_id)

    def _complete(self, slot: int, req: Request, now: float):
        req.complete_ts = now
        self.completed.append(req)
        self.kv.release(slot)
        self.active[slot] = None
        self._work[slot] = None
        self._decode_mask[slot] = False
        self._pos[slot] = 0
        self._m_completed.inc()
        self._sk_e2e.observe(now - req.submit_ts)
        self._page_gauges()
        self.sched.stage[req.uid] = Stage.COMPLETE
        self.trace.event("request_complete", uid=req.uid,
                         tokens=len(req.output),
                         preempts=self.sched.preempts_of[req.uid],
                         trace_id=req.trace_id)
        span = self._spans.pop(req.uid, None)
        if span is not None:
            span.end(tokens=len(req.output))

    # -- tick phases --------------------------------------------------------

    def _admit(self):
        while len(self.sched):
            free = next((i for i in range(self.cfg.num_slots)
                         if self.active[i] is None), None)
            if free is None:
                # priority admission: preempt a strictly worse running req
                if not self.cfg.sched.preempt:
                    break
                incoming = self.sched.peek()
                victim = self.sched.victim(
                    [(s, r) for s, r in enumerate(self.active)
                     if r is not None], incoming=incoming)
                if victim is None:
                    break
                self._preempt(victim)
                continue
            req = self.sched.peek()
            work_len = len(req.prompt) + len(req.output or ())
            if not self.kv.ensure_capacity(free, work_len):
                if not self.cfg.sched.preempt:
                    break
                victim = self.sched.victim(
                    [(s, r) for s, r in enumerate(self.active)
                     if r is not None], incoming=req)
                if victim is None:
                    break
                self._preempt(victim)
                continue
            self._claim(free, self.sched.pop())
            self._m_queue_depth.set(len(self.sched))
            self._page_gauges()

    def _finish_prefill(self, slot: int, req: Request, logits: np.ndarray,
                        now: float):
        """Final chunk done: sample the next token from its logits (V,)
        (first generated token for a fresh request; the continuation token
        for a preempt-resume).  The sampler key is the token's absolute
        sequence index (= the work length), so a resume re-draws the
        identical token the uninterrupted run committed there."""
        tok = self.sampler.sample(logits, req.uid, int(self._pos[slot]))
        req.output.append(tok)
        self._next_tok[slot, 0] = tok
        self._m_tokens.inc()
        if req.preempt_ts is not None:
            # the eviction round trip (requeue -> re-claim -> re-prefill)
            # ends here; attribute it for the slo phase breakdown
            req.preempt_overhead_s += now - req.preempt_ts
            req.preempt_ts = None
        if len(req.output) == 1:
            req.first_token_ts = now
            self._m_ttft.observe(now - req.submit_ts)
            self._sk_ttft.observe(now - req.submit_ts)
            self.trace.event("request_first_token", uid=req.uid,
                             trace_id=req.trace_id)
        if (len(req.output) >= req.max_new_tokens or
                (req.eos_id is not None and tok == req.eos_id)):
            self._complete(slot, req, now)
            return
        self._decode_mask[slot] = True
        self.sched.stage[req.uid] = Stage.DECODE

    def _run_prefill(self):
        budget = self.cfg.sched.prefill_chunks_per_tick
        while budget > 0:
            slots = [i for i in range(self.cfg.num_slots)
                     if self.active[i] is not None
                     and not self._decode_mask[i]]
            if not slots:
                return
            for i in slots:
                if budget <= 0:
                    return
                req = self.active[i]
                if self._fed[i] == 0:
                    self.sched.stage[req.uid] = Stage.PREFILL
                    self.trace.event("request_prefill", uid=req.uid, slot=i,
                                     trace_id=req.trace_id,
                                     tokens=len(self._work[i]),
                                     chunks=self.prefill.num_chunks(
                                         len(self._work[i])))
                self._sync_control()
                was = self._fed[i]
                # chunk dispatch under the owning request's context: the
                # prefill_chunk event (and the capture's kernel_dispatch
                # events) carry its trace_id
                with obs.use_context(self._request_context(req)):
                    logits, _, fed = self.prefill.step(
                        self.state, self._work[i], was, i)
                    self.trace.event("prefill_chunk", uid=req.uid, slot=i,
                                     fed_from=was, fed_to=fed)
                self._fed[i] = fed
                self._pos[i] = fed
                self.kv.note_tokens(i, fed)
                self._m_disp_prefill.inc()
                self._m_prefill_tok.inc(fed - was)
                budget -= 1
                if fed == len(self._work[i]):
                    # the device sync of a request's last chunk
                    self._finish_prefill(i, req, logits[0, 0].cpu().numpy(),
                                         time.monotonic())
            self._page_gauges()

    def _grow_or_preempt(self, tokens_for):
        """Grow every decoding slot's pages to hold ``tokens_for(i)``
        tokens; exhaustion preempts the policy's victim (possibly the
        grower, which drops out of the decode mask)."""
        for i in range(self.cfg.num_slots):
            while (self._decode_mask[i]
                   and not self.kv.ensure_capacity(i, tokens_for(i))):
                if not self.cfg.sched.preempt:
                    raise RuntimeError(
                        "KV arena exhausted with preemption disabled "
                        "(sched.preempt=False); raise --max-pages")
                victim = self.sched.victim(
                    [(s, r) for s, r in enumerate(self.active)
                     if r is not None])
                self._preempt(victim)

    def _decode(self, model=None, tokens=None) -> torch.Tensor:
        """The decode step on the engine's static tensors: the arena is
        written in place and the advanced positions are copied back into
        ``state["pos"]``.  Returns the (slots, V) float32 logits.  ``model``
        / ``tokens``: the draft model and its token input (default: the full
        model and ``_tokens``)."""
        logits, new = (model or self.model).decode_step(
            self.state, self._tokens if tokens is None else tokens,
            policy=self.policy)
        self.state["pos"].copy_(new["pos"])
        return logits[:, 0].to(torch.float32)

    def _run_decode(self) -> int:
        """The decode phase: one speculation window over the decode-ready
        lanes with ``spec=``, clamped so that no lane's window crosses
        ``max_len`` (a plain step where it cannot draft a token), else one
        batched decode step."""
        if self._spec is not None and self._decode_mask.any():
            g_eff = self._spec_gamma(max(
                int(self._pos[i]) for i in range(self.cfg.num_slots)
                if self._decode_mask[i]))
            if g_eff >= 1:
                return self._run_decode_spec(g_eff)
            # a lane is one token from max_len: a plain step instead
        return self._run_decode_plain()

    def _run_decode_plain(self) -> int:
        """One batched decode step over the decode-ready lanes."""
        self._grow_or_preempt(lambda i: int(self._pos[i]) + 1)
        if not self._decode_mask.any():
            return 0
        self._sync_control()
        t0 = time.perf_counter()
        first = next(i for i in range(self.cfg.num_slots)
                     if self._decode_mask[i])
        # batched dispatch: attributed to the first decode-ready lane
        with obs.use_context(self._request_context(self.active[first])):
            if self._use_graph:
                if self._graph is None:
                    self._graph, self._logits = capture_graph(
                        self._decode, self._written(), self.device)
                    self.captures += 1
                self._graph.replay()
                logits = self._logits
            else:
                logits = self._decode()
            logits = logits.cpu().numpy()            # the device sync
        self.last_logits = logits
        step_dt = time.perf_counter() - t0
        self._m_disp_decode.inc()
        now = time.monotonic()
        n = 0
        for i in range(self.cfg.num_slots):
            if not self._decode_mask[i]:
                continue
            n += 1
            req = self.active[i]
            self._pos[i] += 1
            self.kv.note_tokens(i, int(self._pos[i]))
            tok = self.sampler.sample(logits[i], req.uid, int(self._pos[i]))
            req.output.append(tok)
            self._next_tok[i, 0] = tok
            self._m_tokens.inc()
            self._m_tok_lat.observe(step_dt)
            self._sk_tok.observe(step_dt)
            if (len(req.output) >= req.max_new_tokens or
                    (req.eos_id is not None and tok == req.eos_id) or
                    int(self._pos[i]) >= self.cfg.max_len - 1):
                self._complete(i, req, now)
        self._page_gauges()
        return n

    def _run_decode_spec(self, g_eff: int) -> int:
        """One speculation window over the decode-ready lanes
        (:meth:`SpecPrograms._speculate`): grow pages for the whole window
        first; the control tensors are pushed again before the verify (the
        draft steps advanced ``pos`` in place); after the commit, each lane
        still serving goes back to its last valid input and its pages
        beyond the committed tokens are trimmed (same tick — rejected
        drafts never hold arena capacity across ticks)."""
        # positions pos .. pos+g_eff are written -> pos+g_eff+1 tokens
        self._grow_or_preempt(lambda i: int(self._pos[i]) + g_eff + 1)
        lanes = [i for i in range(self.cfg.num_slots)
                 if self._decode_mask[i]]
        if not lanes:
            return 0
        self._sync_control()

        def lane_end(i, p, valid, finished):
            if not finished:
                self._pos[i] = p + valid
                self.kv.note_tokens(i, p + valid)
                self.kv.trim(i, p + valid)

        self._speculate(lanes, self._pos.copy(), g_eff,
                        prompt_input=lambda i, j: None,
                        push_pos0=self._sync_control, lane_end=lane_end,
                        dispatched=(self._m_disp_draft, self._m_disp_verify))
        self._page_gauges()
        return len(lanes)

    # -- public loop --------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick (admit → prefill → decode).  Returns the number
        of occupied slots after the tick.  The flight recorder's watchdog is
        beaten first, on the host."""
        t_tick = time.perf_counter()
        self._beat()
        self.tick_count += 1
        self._admit()
        self._run_prefill()
        self._run_decode()
        n_active = sum(r is not None for r in self.active)
        self._m_slots.set(n_active)
        self._m_queue_depth.set(len(self.sched))
        self._m_tick.observe(time.perf_counter() - t_tick)
        return n_active

    def run_until_drained(self, max_ticks: int = 10000):
        ticks = 0
        t0 = time.perf_counter()
        tok0 = self._m_tokens.value
        while (len(self.sched) or any(r is not None for r in self.active)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        dt = time.perf_counter() - t0
        if dt > 0:
            self._m_tps.set((self._m_tokens.value - tok0) / dt)
        return ticks
