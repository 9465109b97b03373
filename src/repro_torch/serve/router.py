"""ReplicaRouter: data-parallel serving over N engine replicas.

The router is the ``dp`` leg of a :class:`~repro_torch.sharding.plan.
ShardingPlan` realised at the engine level, in one process: each replica is
a full engine (its own decode state, KV arena, scheduler and, on a CUDA
device, its own captured programs) over one **shared** model — one set of
weights in memory, N decode batches draining it — and the router
round-robins submissions across them.

It speaks the same engine protocol (``submit`` / ``step`` /
``run_until_drained`` + the ``tick`` / ``drain`` aliases), so
``launch/serve.py --replicas N`` holds a router where it held an engine.
Observability: each replica gets its **own**
:class:`~repro_torch.obs.MetricsRegistry`, and :attr:`ReplicaRouter.metrics`
merges them into one snapshot with a ``replica="<i>"`` label on every
per-replica family, plus router-level gauges:

    serve_replica_slots_active{replica=i}    occupied slots per replica
    serve_replica_tokens_per_second{replica=i}
    serve_router_requests_total              requests routed
    serve_router_replicas                    replica count
"""

from __future__ import annotations

from typing import Callable, List

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.sketch import QuantileSketch
from repro_torch.serve.protocol import EngineBase


class _MergedMetrics:
    """Snapshot / write facade over the replicas' registries and the
    router's own.  Merging happens at snapshot time — instruments stay owned
    by the engine that increments them, so the hot path is untouched."""

    def __init__(self, router: "ReplicaRouter"):
        self._router = router

    def _merged(self) -> MetricsRegistry:
        out = MetricsRegistry()

        def copy_from(reg: MetricsRegistry, extra_labels: dict):
            snap = reg.snapshot(meta=False)
            for e in snap["counters"]:
                c = out.counter(e["name"], **{**e["labels"], **extra_labels})
                c.value = e["value"]
            for e in snap["gauges"]:
                out.gauge(e["name"],
                          **{**e["labels"], **extra_labels}).set(e["value"])
            for e in snap["histograms"]:
                h = out.histogram(e["name"], buckets=e["buckets"],
                                  **{**e["labels"], **extra_labels})
                h.counts = list(e["counts"])
                h.sum = e["sum"]
                h.count = e["count"]
            for e in snap.get("sketches", ()):
                part = QuantileSketch.from_entry(e)
                # the per-replica labelled copy ...
                out.sketch(e["name"], alpha=part.alpha,
                           **{**e["labels"], **extra_labels}).merge(part)
                # ... and the exact bucket-wise merge into the combined
                # (replica-less) instrument: its percentiles equal one
                # sketch that saw every replica's observations
                if "replica" in extra_labels:
                    out.sketch(e["name"], alpha=part.alpha,
                               **e["labels"]).merge(part)

        for i, eng in enumerate(self._router.replicas):
            copy_from(eng.metrics, {"replica": str(i)})
        copy_from(self._router._registry, {})
        return out

    def snapshot(self, *, meta: bool = True) -> dict:
        return self._merged().snapshot(meta=meta)

    def to_prometheus(self) -> str:
        return self._merged().to_prometheus()

    def write(self, path: str):
        self._merged().write(path)

    @property
    def trace(self):
        # the router-level trace (replica traces stay on their registries)
        return self._router._registry.trace


class ReplicaRouter(EngineBase):
    """Round-robin data-parallel front over N serving engines.

    Build with :func:`make_replicas` (or any list of protocol-speaking
    engines).  ``step`` ticks every replica; ``run_until_drained`` drains
    them all.  ``completed`` concatenates in replica order (uid ``k`` lands
    on replica ``k % N`` under pure round-robin)."""

    def __init__(self, replicas: List):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = list(replicas)
        # stamp each engine with its replica id so that every trace context
        # it mints (and so every event) carries replica=<i>
        for i, eng in enumerate(self.replicas):
            if hasattr(eng, "set_replica"):
                eng.set_replica(i)
        self._rr = 0
        self._registry = MetricsRegistry()
        self.metrics = _MergedMetrics(self)
        n = len(self.replicas)
        self._m_routed = self._registry.counter(
            "serve_router_requests_total", help="requests routed to replicas")
        self._registry.gauge(
            "serve_router_replicas", help="engine replicas behind the router"
        ).set(n)
        self._m_slots = [self._registry.gauge(
            "serve_replica_slots_active",
            help="occupied decode slots per replica", replica=str(i))
            for i in range(n)]
        self._m_tps = [self._registry.gauge(
            "serve_replica_tokens_per_second",
            help="decode throughput per replica over the last drain window",
            replica=str(i)) for i in range(n)]

    # -- engine protocol ----------------------------------------------------

    def submit(self, req):
        eng = self.replicas[self._rr]
        self._rr = (self._rr + 1) % len(self.replicas)
        self._m_routed.inc()
        eng.submit(req)

    def step(self) -> int:
        n_active = 0
        for i, eng in enumerate(self.replicas):
            n = eng.step()
            self._m_slots[i].set(n)
            n_active += n
        return n_active

    def run_until_drained(self, max_ticks: int = 10000):
        ticks = 0
        for i, eng in enumerate(self.replicas):
            ticks = max(ticks, eng.run_until_drained(max_ticks))
            self._m_slots[i].set(0)
            tps = getattr(eng, "_m_tps", None)
            if tps is not None:
                self._m_tps[i].set(tps.value)
        return ticks

    @property
    def completed(self) -> list:
        return [r for eng in self.replicas for r in eng.completed]

    @property
    def queue_depth(self) -> int:
        def depth(eng):
            q = getattr(eng, "queue", None)
            if q is not None:
                return len(q)
            sched = getattr(eng, "sched", None)
            return len(sched) if sched is not None else 0
        return sum(depth(e) for e in self.replicas)


def make_replicas(n: int, factory: Callable[[MetricsRegistry], object]
                  ) -> ReplicaRouter:
    """Build N replicas through ``factory(metrics_registry)`` — the factory
    must pass the registry to the engine it builds (each replica gets its
    own, so that the merged snapshot can label families per replica) — and
    wrap them in a :class:`ReplicaRouter`."""
    return ReplicaRouter([factory(MetricsRegistry()) for _ in range(n)])
