"""``repro_torch.obs`` — metrics, event tracing, structured logging, kernel
naming.

Dependency-free (stdlib only, plus ``torch`` for the NVTX hook and the run
metadata stamp):

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` with counters,
  gauges, fixed-bucket histograms and quantile sketches; JSON-snapshot and
  Prometheus-text exporters.
* :mod:`repro_torch.obs.trace`   — JSONL event trace (:class:`Span` /
  ``event()`` with monotonic timestamps), attached to each registry as
  ``.trace``.
* :mod:`repro_torch.obs.context` — contextvar trace context (``trace_id`` /
  span ids / attribution labels) created per request at ``submit()``.
* :mod:`repro_torch.obs.sketch`  — :class:`QuantileSketch`, a mergeable
  relative-error quantile sketch.
* :mod:`repro_torch.obs.log`     — level-filtered structured logger used by
  the ``launch/`` programs.
* :mod:`repro_torch.obs.profile` — ``annotate(name)`` names DeMM kernels on
  profiler timelines through NVTX ranges; ``profile(trace_dir)`` writes a
  ``torch.profiler`` Chrome/Perfetto trace of the enclosed region.
* :mod:`repro_torch.obs.slo`     — per-request phase attribution, goodput /
  wasted-token accounting, SLO pass-fail reports.
* :mod:`repro_torch.obs.recorder` — :class:`FlightRecorder` (bounded
  per-subsystem event rings + stall watchdogs + crash/signal dumps).
* :mod:`repro_torch.obs.export`  — JSONL trace → Perfetto/Chrome trace JSON
  (``python -m repro_torch.obs.export``).

The process-wide default registry (:func:`metrics`) is what the kernel
dispatch counters and the serve engine share by default, so
``launch/serve.py --metrics-out metrics.json`` captures one coherent
snapshot.  Tests construct their own :class:`MetricsRegistry` or swap the
default with :func:`set_default_registry`.
"""

from __future__ import annotations

from repro_torch.obs.context import TraceContext, current_context, new_trace_id
from repro_torch.obs.context import use as use_context
from repro_torch.obs.log import LEVELS, StructuredLogger, get_logger
from repro_torch.obs.metrics import (
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    run_metadata,
    set_default_registry,
)
from repro_torch.obs.profile import annotate, profile, profiling_active
from repro_torch.obs.recorder import FlightRecorder, Watchdog
from repro_torch.obs.sketch import QuantileSketch
from repro_torch.obs.slo import (SLOConfig, phase_sketches, request_phases,
                                 slo_report)
from repro_torch.obs.trace import EventTrace, Span

__all__ = [
    "DEFAULT_TIME_BUCKETS", "Counter", "EventTrace", "FlightRecorder",
    "Gauge", "Histogram", "LEVELS", "MetricsRegistry", "QuantileSketch",
    "SLOConfig", "Span", "StructuredLogger", "TraceContext", "Watchdog",
    "annotate", "current_context", "default_registry", "event",
    "get_logger", "metrics", "new_trace_id", "phase_sketches", "profile",
    "profiling_active", "request_phases", "run_metadata",
    "set_default_registry", "slo_report", "use_context",
]


def metrics() -> MetricsRegistry:
    """The process-wide default :class:`MetricsRegistry` (see module doc)."""
    return default_registry()


def event(name: str, **attrs) -> dict:
    """Record a point event on the default registry's trace."""
    return default_registry().trace.event(name, **attrs)
