"""Flight recorder: bounded per-subsystem event rings, stall watchdogs,
and crash/signal dumps.

When a serving engine wedges (a deadlocked collective, a runaway compile, a
scheduler live-lock) the interesting evidence is the last few hundred
events *before* the hang — exactly what a post-mortem restart loses.  The
:class:`FlightRecorder` taps the registry's
:class:`~repro_torch.obs.trace.EventTrace` (``trace.tap``) and routes every event
into a small per-subsystem ring (``serve`` / ``kernels`` / ``tune`` /
``train`` / ``misc``), so a dump is cheap, bounded, and still contains each
subsystem's recent history even when one of them is noisy.

Stall detection (:class:`Watchdog`): the instrumented loop calls
``beat()`` once per engine tick / supervisor step; a background thread
compares the time since the last beat against ``threshold ×`` an EWMA of
recent beat intervals (the EWMA idiom of the JAX package's straggler
monitor), floored at
``min_stall_s`` so microsecond ticks don't make the threshold trigger on
scheduling jitter.  One dump is produced per stall episode (re-armed by
the next beat).

A dump (``dump(reason)``) is a directory under the recorder's
``flight_dir``::

    flight-0001-stall-serve_tick/
        rings.json      # {subsystem: [event, ...]} — most recent last
        metrics.json    # full MetricsRegistry snapshot at dump time
        meta.json       # run metadata + reason + watchdog states

Crash dumps: wrap the serving loop in ``with recorder.guard():`` —
any exception dumps ``reason="crash"`` before propagating.  Signal dumps:
``install_signal_handlers()`` chains SIGTERM/SIGINT to a dump.  Normal
shutdown calls ``close()``, which stops the watchdog threads so a clean
exit never produces a spurious stall dump.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["FlightRecorder", "Watchdog", "subsystem_of"]

DEFAULT_RING_SIZE = 512

# event-name prefix → subsystem ring (first match wins; order matters:
# spec/prefill/request are serve-side, kernel dispatch is its own ring so
# noisy compile bursts don't evict scheduler history)
_SUBSYSTEM_PREFIXES = (
    ("kernel_", "kernels"),
    ("autotune_", "tune"),
    ("tune_", "tune"),
    ("checkpoint_", "train"),
    ("train_", "train"),
    ("restart", "train"),
    ("straggler", "train"),
    ("request_", "serve"),
    ("request", "serve"),
    ("serve_", "serve"),
    ("spec_", "serve"),
    ("prefill_", "serve"),
)


def subsystem_of(name: str) -> str:
    for prefix, subsystem in _SUBSYSTEM_PREFIXES:
        if name.startswith(prefix):
            return subsystem
    return "misc"


class Watchdog:
    """Detects a stalled loop from missing ``beat()`` calls.

    Armed after the *second* beat (the first interval is dominated by
    the engine's one-off kernel build and CUDA-graph capture, so one beat is
    not enough to call silence a stall); stalled when the time since the last beat exceeds
    ``max(threshold * ewma(beat interval), min_stall_s)``.  Fires
    ``on_stall(self)`` once per episode from a daemon poll thread.
    """

    EWMA_ALPHA = 0.3   # the straggler monitor's smoothing

    def __init__(self, name: str, on_stall: Callable[["Watchdog"], None],
                 *, threshold: float = 8.0, min_stall_s: float = 1.0,
                 poll_s: float = 0.05):
        self.name = name
        self.threshold = float(threshold)
        self.min_stall_s = float(min_stall_s)
        self._on_stall = on_stall
        self._lock = threading.Lock()
        self._last: Optional[float] = None
        self._ewma: Optional[float] = None
        self.beats = 0
        self.stalls = 0
        self._fired = False          # one dump per stall episode
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._poll_loop, args=(poll_s,),
            name=f"watchdog-{name}", daemon=True)
        self._thread.start()

    def beat(self):
        now = time.monotonic()
        with self._lock:
            if self._last is not None:
                dt = now - self._last
                self._ewma = dt if self._ewma is None else (
                    self.EWMA_ALPHA * dt
                    + (1.0 - self.EWMA_ALPHA) * self._ewma)
            self._last = now
            self.beats += 1
            self._fired = False      # re-arm: the loop is alive again

    def stall_after(self) -> float:
        """Seconds of beat silence that count as a stall right now."""
        with self._lock:
            ewma = self._ewma or 0.0
        return max(self.threshold * ewma, self.min_stall_s)

    def check(self, now: Optional[float] = None) -> bool:
        """True iff currently stalled (armed + beat silence past the
        threshold).  Exposed for deterministic tests; the poll thread calls
        this too."""
        now = time.monotonic() if now is None else now
        with self._lock:
            # armed only once an interval estimate exists (>= 2 beats):
            # the first interval holds the one-off build and capture,
            # which a single-beat arm would misread as a stall
            if self._last is None or self._ewma is None or self._fired:
                return False
            ewma = self._ewma
            stalled = (now - self._last) > max(self.threshold * ewma,
                                               self.min_stall_s)
            if stalled:
                self._fired = True
                self.stalls += 1
        return stalled

    def _poll_loop(self, poll_s: float):
        while not self._stop.wait(poll_s):
            if self.check():
                try:
                    self._on_stall(self)
                except Exception:    # noqa: BLE001 — a failing dump must
                    pass             # not kill the watchdog thread

    def state(self) -> dict:
        with self._lock:
            return {"name": self.name, "beats": self.beats,
                    "stalls": self.stalls, "ewma_s": self._ewma,
                    "threshold": self.threshold,
                    "min_stall_s": self.min_stall_s,
                    "last_beat_age_s": (
                        None if self._last is None
                        else time.monotonic() - self._last)}

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


class FlightRecorder:
    """Bounded per-subsystem rings + watchdogs + dump-on-{stall,crash,signal}.

    One recorder serves a whole process (all engines / the supervisor share
    it via the launch programs' ``--flight-dir``); ``attach_trace`` taps a
    registry's event stream, ``watchdog(name)`` hands the instrumented loop
    a beat target.
    """

    def __init__(self, flight_dir: str, metrics=None,
                 ring_size: int = DEFAULT_RING_SIZE,
                 watchdog_threshold: float = 8.0):
        self.flight_dir = flight_dir
        self._metrics = metrics
        self.ring_size = int(ring_size)
        self.watchdog_threshold = float(watchdog_threshold)
        self._lock = threading.Lock()
        self.rings: Dict[str, deque] = {}
        self._watchdogs: List[Watchdog] = []
        self.dumps: List[str] = []
        self._dump_event = threading.Event()
        self._seq = itertools.count(1)
        self._closed = False

    # -- event capture ------------------------------------------------------

    def _metrics_registry(self):
        if self._metrics is None:
            from repro_torch import obs
            self._metrics = obs.metrics()
        return self._metrics

    def record(self, subsystem: str, rec: dict):
        with self._lock:
            ring = self.rings.get(subsystem)
            if ring is None:
                ring = self.rings[subsystem] = deque(maxlen=self.ring_size)
            ring.append(rec)

    def _tap(self, rec: dict):
        self.record(subsystem_of(str(rec.get("name", ""))), rec)

    def attach_trace(self, trace):
        """Route every event of ``trace`` into the rings (chains any
        existing tap so multiple consumers compose)."""
        prev = getattr(trace, "tap", None)
        if prev is self._tap:
            return
        if prev is None:
            trace.tap = self._tap
        else:
            def chained(rec, _prev=prev):
                _prev(rec)
                self._tap(rec)
            trace.tap = chained

    # -- watchdogs ----------------------------------------------------------

    def watchdog(self, name: str, *, threshold: Optional[float] = None,
                 min_stall_s: float = 1.0, poll_s: float = 0.05) -> Watchdog:
        """A stall watchdog whose trip dumps a flight directory.
        ``threshold`` defaults to the recorder's ``watchdog_threshold``."""
        if threshold is None:
            threshold = self.watchdog_threshold
        def on_stall(wd: Watchdog):
            self._metrics_registry().counter(
                "obs_watchdog_stalls_total",
                help="stall episodes detected by flight-recorder watchdogs",
                watch=wd.name).inc()
            self.dump(f"stall-{wd.name}")

        wd = Watchdog(name, on_stall, threshold=threshold,
                      min_stall_s=min_stall_s, poll_s=poll_s)
        with self._lock:
            self._watchdogs.append(wd)
        return wd

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str) -> str:
        """Write rings + metrics snapshot + run metadata; returns the dump
        directory path."""
        from repro_torch.obs.metrics import run_metadata

        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)
        out = os.path.join(self.flight_dir,
                           f"flight-{next(self._seq):04d}-{safe}")
        os.makedirs(out, exist_ok=True)
        with self._lock:
            rings = {name: list(ring) for name, ring in self.rings.items()}
            watchdogs = [wd.state() for wd in self._watchdogs]
        with open(os.path.join(out, "rings.json"), "w") as f:
            json.dump(rings, f, indent=2, default=str)
        try:
            metrics_snap = self._metrics_registry().snapshot()
        except Exception as e:  # noqa: BLE001 — metrics must not block a dump
            metrics_snap = {"error": f"{type(e).__name__}: {e}"}
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(metrics_snap, f, indent=2, default=str)
        meta = {**run_metadata(), "reason": reason,
                "watchdogs": watchdogs,
                "ring_sizes": {k: len(v) for k, v in rings.items()}}
        with open(os.path.join(out, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        try:
            self._metrics_registry().counter(
                "flight_dumps_total", help="flight-recorder dumps written",
                reason=safe).inc()
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            self.dumps.append(out)
        self._dump_event.set()
        return out

    def wait_for_dump(self, timeout: float) -> bool:
        """Block until at least one dump has been written (the forced-stall
        run / tests)."""
        return self._dump_event.wait(timeout)

    @contextlib.contextmanager
    def guard(self):
        """Dump ``reason="crash"`` on any escaping exception."""
        try:
            yield self
        except BaseException as e:
            self.dump(f"crash-{type(e).__name__}")
            raise

    def install_signal_handlers(self, signals=(signal.SIGTERM,)):
        """Dump on delivery of ``signals``, then chain to the previous
        handler (or re-raise the default behavior).  Main thread only."""
        for signum in signals:
            prev = signal.getsignal(signum)

            def handler(num, frame, _prev=prev):
                self.dump(f"signal-{num}")
                if callable(_prev):
                    _prev(num, frame)
                else:
                    signal.signal(num, signal.SIG_DFL)
                    signal.raise_signal(num)

            signal.signal(signum, handler)

    def close(self):
        """Stop watchdog threads (normal shutdown — no stall dump races
        after the loops exit)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            watchdogs = list(self._watchdogs)
        for wd in watchdogs:
            wd.stop()
