"""Shared serving-engine protocol.

Every engine speaks the same surface:

    submit(req)            enqueue a Request
    step() -> int          one engine tick; returns occupied slots
    run_until_drained()    tick until queue + slots are empty
    tick() / drain()       aliases for the above (the protocol names)
    completed              finished Requests, in completion order
    metrics                a MetricsRegistry

so drivers (``launch/serve.py``, benchmarks) hold any of them behind one
variable.  :class:`EngineBase` provides the aliases, the per-request trace
contexts with their attribution labels, flight-recorder attachment, and the
:class:`~repro_torch.sharding.plan.ShardingPlan` plumbing both engines
share: resolving ``policy.plan`` into a mesh and this rank's sharding
context, placing the model and the decode state, and installing the
context around every step.

Distribution is SPMD: every rank of a plan's world builds the same engine
and feeds it the same requests; the logits are whole and equal on every
rank after the vocab gather, so every rank samples the same tokens.  An
engine of a multi-rank plan steps eagerly: a ``gloo`` collective cannot be
captured in a CUDA graph (and capturing NCCL's needs a GPU per rank).
"""

from __future__ import annotations

import functools
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Engine(Protocol):
    """Structural type of a serving engine (isinstance-checkable)."""

    def submit(self, req) -> None: ...
    def step(self) -> int: ...
    def run_until_drained(self, max_ticks: int = 10000) -> int: ...


class EngineBase:
    """Protocol aliases + per-request trace contexts shared by the engines.

    Subclasses implement ``submit`` / ``step`` / ``run_until_drained``.

    Observability plumbing lives here too: per-engine trace attribution
    labels (``replica`` once a router stamps the engine), per-request
    :class:`~repro_torch.obs.context.TraceContext` roots, and optional
    flight-recorder attachment (:meth:`_setup_recorder`), whose tick
    watchdog ``step()`` beats first thing, on the host.
    """

    replica_id = None    # set by a data-parallel router on its replicas
    _recorder = None     # FlightRecorder (launch --flight-dir)
    _watchdog = None     # stall watchdog beaten once per step()
    plan = None          # ShardingPlan from policy.plan (or None)
    mesh = None          # the plan's DeviceMesh (None on one rank)
    _shctx = None        # this rank's ShardingContext, around every step

    # -- protocol aliases ---------------------------------------------------

    def tick(self) -> int:
        """Protocol alias for :meth:`step`."""
        return self.step()

    def drain(self, max_ticks: int = 10000) -> int:
        """Protocol alias for :meth:`run_until_drained`."""
        return self.run_until_drained(max_ticks)

    # -- trace attribution --------------------------------------------------

    def set_replica(self, i: int):
        """Stamp this engine as data-parallel replica ``i``: every later
        trace context (and so every event) carries ``replica=i``."""
        self.replica_id = int(i)
        if self._watchdog is not None:
            # recorder attached before the router stamped us: rename so
            # flight dumps tell the per-replica tick watchdogs apart
            self._watchdog.name = f"serve_tick_r{self.replica_id}"

    def _trace_labels(self) -> dict:
        """Topology labels attached to this engine's trace contexts: the
        replica, and this rank's tp shard / pp stage of its plan's extent
        (``"<rank>:<degree>"``; each rank is a process of its own here)."""
        out = {}
        if self.replica_id is not None:
            out["replica"] = str(self.replica_id)
        ctx = self._shctx
        if ctx is not None:
            if ctx.tp > 1:
                out["tp_shard"] = f"{ctx.tp_rank}:{ctx.tp}"
            if ctx.pp > 1:
                out["pp_stage"] = f"{ctx.pp_rank}:{ctx.pp}"
        return out

    def _request_context(self, req):
        """The request's root TraceContext (creating ``req.trace_id`` on
        first use); entered around every dispatch done on its behalf."""
        from repro_torch.obs.context import TraceContext, new_trace_id
        if getattr(req, "trace_id", None) is None:
            req.trace_id = new_trace_id()
        return TraceContext(req.trace_id, span_id=req.trace_id,
                            labels=tuple(sorted(
                                self._trace_labels().items())))

    def _setup_recorder(self, recorder):
        """Attach a FlightRecorder: tap this engine's trace into its rings
        and register a per-engine tick watchdog (beaten by ``step()``)."""
        self._recorder = recorder
        if recorder is None:
            return
        recorder.attach_trace(self.trace)
        name = "serve_tick" if self.replica_id is None \
            else f"serve_tick_r{self.replica_id}"
        self._watchdog = recorder.watchdog(name)

    def _beat(self):
        if self._watchdog is not None:
            self._watchdog.beat()

    # -- plan plumbing ------------------------------------------------------

    def _head_counts(self):
        cfg = getattr(self.model, "cfg", None)
        return (int(getattr(cfg, "num_kv_heads", 16) or 16),
                int(getattr(cfg, "num_heads", 0) or 0))

    @property
    def multi_rank(self) -> bool:
        """Whether this engine is one rank of a multi-rank plan."""
        return self.mesh is not None

    def _setup_plan(self, policy, spec=None):
        """Resolve ``policy.plan``: build the mesh and this rank's sharding
        context, and place ``self.model`` (renumbered, this rank's blocks,
        this stage's layers).  Identity for a plan-less policy or a plan of
        degree 1.  ``dp`` is not realised here: data parallelism is
        replica-level (``serve.router.ReplicaRouter``), so an engine takes
        the plan's tp x pp slice.  What the slice does not serve raises
        ``NotImplementedError`` by name."""
        import dataclasses

        plan = getattr(policy, "plan", None)
        self.plan = plan
        if plan is None or plan.tp * plan.pp == 1:
            return
        cfg = self.model.cfg
        what = None
        if type(self.model).__name__ != "DecoderLM" or cfg.moe is not None \
                or cfg.frontend is not None:
            what = (f"{cfg.name} ({cfg.family}): distributed serving covers "
                    "the dense DecoderLM; serving MoE under a plan (expert "
                    "parallelism trains, models.moe._apply_moe_ep), "
                    "Mamba2's and xLSTM's split state and the frontends "
                    "under a plan are not ported yet (ROADMAP Queue 1 item "
                    "4c)")
        elif cfg.attention != "full":
            what = (f"{cfg.name}'s {cfg.attention!r} attention under a "
                    "sharding plan: distributed serving covers full "
                    "attention (dense and paged caches)")
        elif plan.tp > 1 and plan.pp > 1:
            what = ("combined tp > 1 and pp > 1 (the JAX package refuses it "
                    "too); pick one")
        elif spec is not None:
            what = "speculative decoding under a sharding plan"
        if what is not None:
            raise NotImplementedError(what)
        engine_plan = (plan if plan.dp == 1
                       else dataclasses.replace(plan, dp=1))
        self.mesh = engine_plan.make_mesh()
        nkv, nh = self._head_counts()
        self._shctx = engine_plan.context(self.mesh, num_kv_heads=nkv,
                                          num_heads=nh)
        # the head counts are checked before anything is split
        self._shctx.local_heads()
        self._shctx.local_kv_heads()
        # the model is placed once: replicas of one rank share it
        placed = getattr(self.model, "placed_by", None)
        if placed is None:
            engine_plan.shard_params(self.model, self.mesh)
            self.model.placed_by = engine_plan
        elif placed != engine_plan:
            raise ValueError(f"the model was placed under {placed}, not "
                             f"{engine_plan}")

    def _place_state(self, device, **kw):
        """A fresh decode state (``self.model.init_decode_state(**kw)`` on
        ``device``); under a plan only this rank's block of it (KV head axis
        over tp when it divides, the layer axis over pp), allocated at its
        local shape."""
        make = functools.partial(self.model.init_decode_state, **kw)
        if self.mesh is None:
            return make(device=device)
        nkv, _ = self._head_counts()
        return self.plan.shard_decode_state(make, device, self.mesh,
                                            num_kv_heads=nkv)

    def _wrap_step(self, fn):
        """``fn`` run under this rank's sharding context (every collective
        of the step reads it)."""
        from repro_torch.sharding import context as shctx
        ctx = self._shctx

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with shctx.use_mesh(ctx):
                return fn(*a, **k)

        return wrapped

    def _report_eager(self, metrics):
        """A multi-rank engine steps eagerly: say so, on a gauge and in the
        log."""
        if not self.multi_rank:
            return
        from repro_torch import obs
        metrics.gauge("serve_step_eager",
                      help="1 when the engine steps eagerly (a multi-rank "
                           "plan: its collectives are not captured)",
                      reason="multi_rank").set(1)
        ctx = self._shctx
        obs.get_logger("serve").info(
            "multi-rank plan: stepping eagerly, no CUDA graph",
            tp=ctx.tp, pp=ctx.pp, tp_rank=ctx.tp_rank, pp_rank=ctx.pp_rank)


def greedy_token(logits_row: np.ndarray) -> int:
    """The shared greedy sampler (argmax over the vocab axis)."""
    return int(np.argmax(logits_row))
