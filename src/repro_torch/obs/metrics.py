"""Dependency-free metrics primitives: counters, gauges, histograms.

A :class:`MetricsRegistry` owns named metric *families*; a family plus one
label set is one instrument.  Instruments are cheap handles (plain Python
objects sharing the registry lock), so hot paths fetch them once and call
``inc()``/``set()``/``observe()`` per event — the serve tick observes a few
histograms per step, which is noise next to a jitted decode step.

Two exporters render the same registry state:

* :meth:`MetricsRegistry.snapshot` — a JSON-able dict (``meta`` +
  ``counters``/``gauges``/``histograms`` entry lists), the format written by
  ``launch/serve.py --metrics-out`` and validated by
  ``benchmarks/validate_metrics.py`` against
  ``benchmarks/metrics_schema.json``.
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  (``# TYPE`` lines, ``{label="value"}`` pairs, cumulative ``_bucket{le=}``
  histogram series).

Histograms use *fixed* buckets declared at first registration (default:
:data:`DEFAULT_TIME_BUCKETS`, exponential 100µs…60s — decode ticks, queue
waits, and train steps all land mid-range).  Fixed buckets keep ``observe``
O(log buckets) with no allocation and make snapshots mergeable across
processes.

The fourth family kind is the quantile **sketch**
(:class:`~repro_torch.obs.sketch.QuantileSketch`, DDSketch-style): registered via
``registry.sketch(name, alpha=..., **labels)``, exported in the snapshot
under ``"sketches"`` and as Prometheus summary-style quantile series, and
*exactly* mergeable — the DP replica router merges per-replica sketches
into combined percentiles identical to a single sketch over all
observations.  Serving latency percentiles (TTFT / per-token decode / e2e)
report through sketches; the fixed-bucket histogram instruments stay for
dashboard compatibility and cheap rate queries.
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.sketch import DEFAULT_ALPHA, QuantileSketch

# Exponential-ish time buckets in seconds: 100µs .. 60s.  Decode ticks on
# CPU land around 1-100ms, train steps 10ms-10s, queue waits anywhere.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_KINDS = ("counter", "gauge", "histogram", "sketch")

# Quantiles rendered in the Prometheus exposition for sketch families.
SKETCH_QUANTILES = (0.5, 0.9, 0.99)


def run_metadata() -> dict:
    """Host/platform/version stamp shared by metrics snapshots and the
    benchmark JSONs, so artifacts from different machines are comparable."""
    import platform as _platform
    import socket

    import torch

    on_gpu = torch.cuda.is_available()
    return {
        "host": socket.gethostname(),
        "platform": "gpu" if on_gpu else "cpu",
        # the shared snapshot schema (benchmarks/metrics_schema.json) names
        # the stack's JAX version; the port runs without JAX
        "jax": "not used",
        "device": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": _platform.python_version(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


class Counter:
    """Monotonically increasing count (use a Gauge for values that go down)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1):
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (slot occupancy, tokens/sec)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)


class Histogram:
    """Fixed-bucket histogram; ``counts[i]`` counts observations with
    ``value <= buckets[i]`` (exclusive of earlier buckets); ``counts[-1]``
    is the +Inf overflow bucket."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.RLock, buckets: Sequence[float]):
        self._lock = lock
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        v = float(v)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def cumulative(self) -> List[int]:
        """Cumulative ``le`` counts (Prometheus semantics), +Inf last."""
        out, acc = [], 0
        with self._lock:
            for c in self.counts:
                acc += c
                out.append(acc)
        return out


class _Family:
    __slots__ = ("kind", "help", "buckets", "alpha", "children")

    def __init__(self, kind: str, help_text: str,
                 buckets: Optional[Tuple[float, ...]],
                 alpha: Optional[float] = None):
        self.kind = kind
        self.help = help_text
        self.buckets = buckets
        self.alpha = alpha
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                                    "\\n")


def _label_str(labels: Dict[str, str], extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


class MetricsRegistry:
    """Thread-safe registry of counter/gauge/histogram families.

    ``registry.counter(name, **labels)`` registers on first use and returns
    the same instrument for the same (name, labels) afterwards; a name can
    hold only one kind.  The registry also owns an
    :class:`~repro_torch.obs.trace.EventTrace` (``registry.trace``) so one object
    threads both numeric metrics and the JSONL event stream through a
    subsystem.
    """

    def __init__(self, trace=None):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        if trace is None:
            from repro_torch.obs.trace import EventTrace
            trace = EventTrace()
        self.trace = trace
        # Surface ring overflow as a counter — registered lazily on the
        # first actual drop so registries that never overflow stay clean.
        if getattr(trace, "on_drop", None) is None:
            trace.on_drop = lambda n: self.counter(
                "trace_events_dropped_total",
                help="trace events evicted from the bounded ring").inc(n)

    # -- registration / lookup ----------------------------------------------

    def _get(self, kind: str, name: str, help_text: str,
             labels: Dict[str, str],
             buckets: Optional[Sequence[float]] = None,
             alpha: Optional[float] = None):
        lk = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind, help_text,
                              tuple(buckets) if buckets else None, alpha)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            child = fam.children.get(lk)
            if child is None:
                if kind == "counter":
                    child = Counter(self._lock)
                elif kind == "gauge":
                    child = Gauge(self._lock)
                elif kind == "sketch":
                    child = QuantileSketch(self._lock,
                                           alpha=fam.alpha or DEFAULT_ALPHA)
                else:
                    child = Histogram(self._lock,
                                      fam.buckets or DEFAULT_TIME_BUCKETS)
                fam.children[lk] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        """``buckets`` is honored on first registration of ``name``; later
        calls reuse the family's fixed buckets (snapshots stay mergeable)."""
        return self._get("histogram", name, help, labels, buckets)

    def sketch(self, name: str, help: str = "",
               alpha: Optional[float] = None, **labels) -> QuantileSketch:
        """A mergeable quantile sketch (DDSketch-style; see
        :mod:`repro_torch.obs.sketch`).  ``alpha`` (relative-error bound) is
        honored on first registration of ``name``; later calls reuse the
        family's alpha so per-replica sketches stay exactly mergeable."""
        return self._get("sketch", name, help, labels, alpha=alpha)

    def reset(self, *, clear_trace: bool = True):
        """Drop every family (tests / fresh measurement windows)."""
        with self._lock:
            self._families.clear()
        if clear_trace:
            self.trace.clear()

    # -- exporters ----------------------------------------------------------

    def snapshot(self, *, meta: bool = True) -> dict:
        counters, gauges, hists, sketches = [], [], [], []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                for lk in sorted(fam.children):
                    child = fam.children[lk]
                    entry = {"name": name, "labels": dict(lk)}
                    if fam.kind == "counter":
                        counters.append({**entry, "value": child.value})
                    elif fam.kind == "gauge":
                        gauges.append({**entry, "value": child.value})
                    elif fam.kind == "sketch":
                        sketches.append({**entry, **child.to_entry()})
                    else:
                        hists.append({**entry,
                                      "buckets": list(child.buckets),
                                      "counts": list(child.counts),
                                      "sum": child.sum,
                                      "count": child.count})
        out = {"counters": counters, "gauges": gauges, "histograms": hists,
               "sketches": sketches}
        if meta:
            out["meta"] = run_metadata()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                # sketches render as Prometheus summaries (quantile series)
                kind = "summary" if fam.kind == "sketch" else fam.kind
                lines.append(f"# TYPE {name} {kind}")
                for lk in sorted(fam.children):
                    child = fam.children[lk]
                    labels = dict(lk)
                    ls = _label_str(labels)
                    if fam.kind in ("counter", "gauge"):
                        lines.append(f"{name}{ls} {child.value:g}")
                        continue
                    if fam.kind == "sketch":
                        for q in SKETCH_QUANTILES:
                            v = child.quantile(q)
                            if v is not None:
                                lines.append(
                                    f"{name}"
                                    f"{_label_str(labels, {'quantile': f'{q:g}'})}"
                                    f" {v:g}")
                        lines.append(f"{name}_sum{ls} {child.sum:g}")
                        lines.append(f"{name}_count{ls} {child.count}")
                        continue
                    cum = child.cumulative()
                    for b, c in zip(child.buckets, cum):
                        lines.append(
                            f"{name}_bucket"
                            f"{_label_str(labels, {'le': f'{b:g}'})} {c}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(labels, {'le': '+Inf'})} {cum[-1]}")
                    lines.append(f"{name}_sum{ls} {child.sum:g}")
                    lines.append(f"{name}_count{ls} {child.count}")
        return "\n".join(lines) + "\n"

    def write(self, path: str):
        """Write a snapshot; ``.prom``/``.txt`` suffixes select Prometheus
        text exposition, anything else the JSON snapshot."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if path.endswith((".prom", ".txt")):
            blob = self.to_prometheus()
        else:
            blob = json.dumps(self.snapshot(), indent=2)
        with open(path, "w") as f:
            f.write(blob)

    def __len__(self):
        with self._lock:
            return sum(len(f.children) for f in self._families.values())


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide registry — the one the kernel dispatch path, the tuning
    cache, and the launch drivers share (mirrors ``tune.default_cache``)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def set_default_registry(reg: Optional[MetricsRegistry]):
    """Swap the process-wide registry (tests; isolated measurement runs)."""
    global _default
    with _default_lock:
        _default = reg
