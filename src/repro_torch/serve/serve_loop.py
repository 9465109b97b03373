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
``temperature == 0``.

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


class ServeEngine(EngineBase):
    def __init__(self, model, cfg: ServeConfig, *, policy=None, metrics=None,
                 device="cuda", recorder=None, autotune: bool = False,
                 _eager: bool = False):
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
        if autotune and self.policy.mode == "packed":
            # measure every packed weight at the decode batch before the
            # cache is allocated and anything is captured, so that
            # backend="auto" resolves from measured entries at the warm-up
            # step and the capture
            from repro_torch import tune
            tune.autotune_packed_tree(model, cfg.num_slots)
        # the KV cache is float32 whatever the compute dtype
        self.state = model.init_decode_state(
            cfg.num_slots, cfg.max_len, dtype=torch.float32,
            device=model.device)
        # the next tokens: the host loop writes ``_next_tok``, a numpy view
        # of a (pinned, on a CUDA engine) host buffer that is copied into
        # the step's static input each tick (on the CPU they are one tensor)
        self._tok_host = torch.zeros((cfg.num_slots, 1), dtype=torch.int64,
                                     pin_memory=self.device.type == "cuda")
        self._next_tok = self._tok_host.numpy()
        self._tokens = self._tok_host.to(self.device)
        self._use_graph = self.device.type == "cuda" and not _eager
        self._graph = None       # captured at the first tick
        self._logits = None      # the graph's logits output (slots, V) f32
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
        """Restore slot ``i``'s state region to its initial value: position
        0 and a zeroed cache row.  (KV caches self-mask stale entries through
        ``cache_len``; zeroing keeps the state equal to the reference's.)
        The state's tensors are rewritten in place."""
        caches = self.state["caches"]
        caches["k"][:, i] = 0
        caches["v"][:, i] = 0
        self.state["pos"][i] = 0

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

    def _decode(self) -> torch.Tensor:
        """The decode step on the engine's static tensors: the KV caches
        are written in place and the advanced positions are copied back
        into ``state["pos"]``, so the step reads and writes the same tensors
        every time (what a CUDA graph needs)."""
        logits, new = self.model.decode_step(self.state, self._tokens,
                                             policy=self.policy)
        self.state["pos"].copy_(new["pos"])
        return logits[:, 0].to(torch.float32)

    def _capture(self, warmup: int = CAPTURE_WARMUP):
        """Capture :meth:`_decode` into a CUDA graph, once per engine
        (:func:`capture_graph`); the KV caches and the positions are
        restored afterwards to what they held before: at the first tick,
        what ``init_decode_state`` made."""
        caches = self.state["caches"]
        self._graph, self._logits = capture_graph(
            self._decode, [caches["k"], caches["v"], self.state["pos"]],
            self.device, warmup)

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
