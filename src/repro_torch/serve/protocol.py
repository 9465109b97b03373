"""Shared serving-engine protocol.

Every engine speaks the same surface:

    submit(req)            enqueue a Request
    step() -> int          one engine tick; returns occupied slots
    run_until_drained()    tick until queue + slots are empty
    tick() / drain()       aliases for the above (the protocol names)
    completed              finished Requests, in completion order
    metrics                a MetricsRegistry

so drivers (``launch/serve.py``, benchmarks) hold any of them behind one
variable.  :class:`EngineBase` provides the aliases and the per-request trace
contexts.  Sharding-plan plumbing, replica labels and flight-recorder
attachment of the JAX package are not ported yet.
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
    """

    # -- protocol aliases ---------------------------------------------------

    def tick(self) -> int:
        """Protocol alias for :meth:`step`."""
        return self.step()

    def drain(self, max_ticks: int = 10000) -> int:
        """Protocol alias for :meth:`run_until_drained`."""
        return self.run_until_drained(max_ticks)

    # -- trace attribution --------------------------------------------------

    def _request_context(self, req):
        """The request's root TraceContext (creating ``req.trace_id`` on
        first use); entered around every dispatch done on its behalf."""
        from repro_torch.obs.context import TraceContext, new_trace_id
        if getattr(req, "trace_id", None) is None:
            req.trace_id = new_trace_id()
        return TraceContext(req.trace_id, span_id=req.trace_id, labels=())


def greedy_token(logits_row: np.ndarray) -> int:
    """The shared greedy sampler (argmax over the vocab axis)."""
    return int(np.argmax(logits_row))
