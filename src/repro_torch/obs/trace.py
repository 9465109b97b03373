"""JSONL event tracing: point events and duration spans.

An :class:`EventTrace` is an in-memory ring of JSON-able event dicts with
monotonic timestamps, optionally streamed to a JSONL sink as they happen.
Two record shapes:

* point events — ``trace.event("request_submit", uid=3)`` →
  ``{"name": ..., "ts": <monotonic s>, "wall": <epoch s>, ...attrs}``
* spans — ``with trace.span("request", uid=3): ...`` (or manual
  ``s = trace.span(...); ...; s.end()``) → one event with ``"ph": "span"``,
  ``ts`` at span *start*, and ``"dur"`` seconds.

Timestamps come from ``time.monotonic()`` so orderings and durations are
immune to wall-clock steps; ``wall`` is carried for cross-host correlation
only.  The ring is bounded (default 64k events) so a long-running server
cannot grow without limit — attach a file sink (``EventTrace(path=...)`` or
``set_sink``) to keep everything.  Overflow is *counted*, not silent:
``trace.dropped`` tracks evicted events, an ``on_drop`` callback lets the
owning registry surface it as ``trace_events_dropped_total``, and
:meth:`EventTrace.write` prepends a ``_trace_header`` line whenever events
were lost so offline consumers know the file is a suffix.

Every event additionally splices the active request's
:class:`~repro_torch.obs.context.TraceContext` (``trace_id`` / ``span_id`` /
attribution labels) unless the caller passed an explicit ``trace_id`` —
that one hook is how kernel-dispatch, autotune, and tune-cache events get
correlated to the serving request that triggered them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Iterator, List, Optional


def _context_attrs(attrs: dict) -> dict:
    """Attrs contributed by the ambient TraceContext (empty if none or if
    the caller already attributed the event explicitly)."""
    if "trace_id" in attrs:
        return {}
    from repro_torch.obs import context as _context
    ctx = _context.current()
    return ctx.attrs() if ctx is not None else {}


class Span:
    """A duration measurement; emits one span event on :meth:`end`.

    Usable as a context manager or via explicit ``end()`` (the serve engine
    opens a request span at submit and ends it at completion, ticks apart).
    ``end()`` is idempotent — the first call wins.
    """

    __slots__ = ("_trace", "name", "attrs", "t0", "wall0", "ended")

    def __init__(self, trace: "EventTrace", name: str, attrs: dict):
        self._trace = trace
        self.name = name
        self.attrs = {**_context_attrs(attrs), **attrs}
        self.t0 = time.monotonic()
        self.wall0 = time.time()
        self.ended = False

    def event(self, name: str, **attrs):
        """A point event tagged as belonging to this span."""
        return self._trace.event(name, span=self.name, **{**self.attrs,
                                                          **attrs})

    def end(self, **attrs) -> Optional[dict]:
        if self.ended:
            return None
        self.ended = True
        rec = {"name": self.name, "ph": "span", "ts": self.t0,
               "wall": self.wall0, "dur": time.monotonic() - self.t0,
               **self.attrs, **attrs}
        self._trace._emit(rec)
        return rec

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class EventTrace:
    """Bounded in-memory event ring with an optional JSONL file sink."""

    def __init__(self, path: Optional[str] = None, max_events: int = 65536):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._file = None
        self.dropped = 0
        # called as on_drop(n) after ring eviction; the owning registry uses
        # it to bump trace_events_dropped_total (lazily — no counter family
        # exists until loss actually happens)
        self.on_drop: Optional[Callable[[int], None]] = None
        # called as tap(rec) on every emit; the flight recorder uses it to
        # route events into per-subsystem rings
        self.tap: Optional[Callable[[dict], None]] = None
        if path:
            self.set_sink(path)

    # -- recording ----------------------------------------------------------

    def _emit(self, rec: dict):
        with self._lock:
            evicting = (self._events.maxlen is not None
                        and len(self._events) == self._events.maxlen)
            if evicting:
                self.dropped += 1
            self._events.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec, default=str) + "\n")
                self._file.flush()
            on_drop, tap = self.on_drop, self.tap
        if evicting and on_drop is not None:
            on_drop(1)
        if tap is not None:
            tap(rec)

    def event(self, name: str, **attrs) -> dict:
        rec = {"name": name, "ts": time.monotonic(), "wall": time.time(),
               **_context_attrs(attrs), **attrs}
        self._emit(rec)
        return rec

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    # -- access / persistence -----------------------------------------------

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def named(self, name: str) -> List[dict]:
        return [e for e in self.events if e.get("name") == name]

    def clear(self):
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def set_sink(self, path: Optional[str]):
        """Stream every subsequent event to ``path`` as JSON lines (append);
        ``None`` detaches the sink."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if path:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._file = open(path, "a")

    def write(self, path: str) -> int:
        """Dump the buffered events to ``path`` as JSONL; returns #events.
        If the ring overflowed, a ``_trace_header`` line records how many
        events were dropped (oldest-first), so the dump is marked as a
        suffix rather than a complete history.  (Events already streamed by
        a sink are not deduplicated — use one mechanism or the other per
        file.)"""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            if dropped:
                f.write(json.dumps({"name": "_trace_header",
                                    "dropped": dropped,
                                    "events": len(events),
                                    "wall": time.time()}) + "\n")
            for rec in events:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(events)

    def __len__(self):
        with self._lock:
            return len(self._events)

    def __iter__(self) -> Iterator[dict]:
        return iter(self.events)
