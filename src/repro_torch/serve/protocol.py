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
contexts with their attribution labels, and flight-recorder attachment.
The sharding-plan plumbing of the JAX package is not ported yet.
"""

from __future__ import annotations

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

    # -- protocol aliases ---------------------------------------------------

    def tick(self) -> int:
        """Protocol alias for :meth:`step`."""
        return self.step()

    def drain(self, max_ticks: int = 10000) -> int:
        """Protocol alias for :meth:`run_until_drained`."""
        return self.run_until_drained(max_ticks)

    # -- trace attribution --------------------------------------------------

    def _trace_labels(self) -> dict:
        """Topology labels attached to this engine's trace contexts."""
        out = {}
        if self.replica_id is not None:
            out["replica"] = str(self.replica_id)
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


def greedy_token(logits_row: np.ndarray) -> int:
    """The shared greedy sampler (argmax over the vocab axis)."""
    return int(np.argmax(logits_row))
