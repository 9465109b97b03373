"""Request-scoped trace context, propagated via ``contextvars``.

A :class:`TraceContext` names the request a piece of work belongs to
(``trace_id``), the span doing the work (``span_id`` / ``parent_id``), and
topology attribution labels (``replica`` / ``tp_shard`` / ``pp_stage``).
The serving engines create a root context at ``submit()`` and re-enter it
(:func:`use`) around every dispatch done on the request's behalf — chunked
prefill steps, batched decode / draft / verify programs — so events emitted
*anywhere below* (``kernel_dispatch`` at jit-trace time, autotune and
tune-cache events, scheduler events) inherit the owning request's
``trace_id`` without any of those layers knowing about requests.

:class:`~repro_torch.obs.trace.EventTrace` splices :func:`current` into every
event whose explicit attrs don't already carry a ``trace_id``, which is the
only coupling point; everything else is plain ``contextvars`` so the
context survives threads started with ``contextvars.copy_context`` and
nested ``with use(...)`` blocks restore the outer context on exit.

Batched dispatches serve several requests at once; the engines attribute
the *dispatch* to the first active lane's context and additionally emit
per-lane events with explicit ``trace_id`` attrs, so per-request span trees
stay complete while the kernel-level events remain single-parented.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
from typing import Dict, Iterator, Optional, Tuple

__all__ = [
    "TraceContext", "current", "current_context", "new_span_id",
    "new_trace_id", "use",
]

_counter = itertools.count(1)
_counter_lock = threading.Lock()


def _next() -> int:
    with _counter_lock:
        return next(_counter)


def new_trace_id() -> str:
    """Process-unique trace id (pid-salted so DP replica processes and
    multi-host runs don't collide when traces are merged offline)."""
    return f"t{os.getpid():x}-{_next():x}"


def new_span_id() -> str:
    return f"s{_next():x}"


class TraceContext:
    """Immutable (trace_id, span_id, parent_id, labels) tuple-alike."""

    __slots__ = ("trace_id", "span_id", "parent_id", "labels")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.trace_id = trace_id
        self.span_id = span_id or new_span_id()
        self.parent_id = parent_id
        self.labels = tuple(labels)

    @classmethod
    def root(cls, trace_id: Optional[str] = None,
             **labels) -> "TraceContext":
        """A new root span; fresh ``trace_id`` unless one is supplied."""
        lk = tuple(sorted((k, str(v)) for k, v in labels.items()
                          if v is not None))
        return cls(trace_id or new_trace_id(), labels=lk)

    def child(self, **labels) -> "TraceContext":
        """A child span under this one (same trace, new span id)."""
        lk = dict(self.labels)
        lk.update((k, str(v)) for k, v in labels.items() if v is not None)
        return TraceContext(self.trace_id, new_span_id(), self.span_id,
                            tuple(sorted(lk.items())))

    def with_labels(self, **labels) -> "TraceContext":
        """Same span, extra attribution labels (replica / tp / pp)."""
        lk = dict(self.labels)
        lk.update((k, str(v)) for k, v in labels.items() if v is not None)
        return TraceContext(self.trace_id, self.span_id, self.parent_id,
                            tuple(sorted(lk.items())))

    def attrs(self) -> Dict[str, str]:
        """The event attrs this context contributes (spliced by
        ``EventTrace.event`` when not explicitly present)."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        out.update(self.labels)
        return out

    def __repr__(self):
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, parent_id={self.parent_id!r}, "
                f"labels={dict(self.labels)!r})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id
                and self.labels == other.labels)

    def __hash__(self):
        return hash((self.trace_id, self.span_id, self.parent_id,
                     self.labels))


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("repro_torch_obs_trace_context", default=None)


def current() -> Optional[TraceContext]:
    """The active :class:`TraceContext`, or None outside any request."""
    return _current.get()


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Enter ``ctx`` for the dynamic extent of the block (None = no-op,
    so call sites don't need to branch on 'is tracing attributed here')."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


current_context = current   # re-exported as ``repro_torch.obs.current_context``
