"""Persistent tuning cache + heuristic defaults.

Tuning results are keyed by the full static problem description —
``(op, rows, out, k, dtype, n:m:k_reconfig, platform)``, plus the block
geometry, the shard count and ``|dup`` where they apply — and stored

  * in memory (process-lifetime memoization, no cost on the dispatch path),
  * on disk as JSON (survives processes; a serving job starts with the
    configs its benchmark run measured).

A key reads letter for letter as the JAX package's for the same problem,
except for the ``|dup`` suffix, which only a weight that may hold duplicate
indices gets.  The file is the port's own (``results/tune_cache_torch.json``,
``$REPRO_TORCH_TUNE_CACHE``), never the JAX package's: the backend names
differ (``cuda`` against ``pallas``).

When no measurement exists for a key the cache answers with
:func:`heuristic_default` — ``cuda`` with the wrapper's own heuristics on a
CUDA problem, ``reference`` on the CPU — so ``backend="auto"`` is always
resolvable; tuning only ever *improves* the choice.

The JSON file carries a schema version; a version bump (or any key-scheme
change) invalidates stale entries instead of misreading them.

Observability (``repro_torch.obs``): every :meth:`TuneCache.resolve`
increments ``tune_cache_hits_total`` / ``tune_cache_misses_total`` (labeled
by op) on the default registry and leaves a ``tune_cache_resolve`` event
(with the problem's key), and :meth:`TuneCache.load` counts file loads and
entries — so a serving run's ``--metrics-out`` snapshot shows how its
``backend="auto"`` decisions were sourced.  Saves are atomic via a *uniquely
named* temp file + ``os.replace``, so concurrent runs sharing one cache path
cannot interleave partial writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Dict, Optional

from repro_torch.tune.registry import Problem, variants_for


def _counter(name: str, help_text: str = "", **labels):
    from repro_torch import obs

    return obs.metrics().counter(name, help=help_text, **labels)


SCHEMA_VERSION = 1

ENV_PATH = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_PATH = os.path.join("results", "tune_cache_torch.json")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One resolved dispatch decision for a Problem."""

    backend: str
    params: Dict[str, int]
    measured_us: Optional[float] = None   # None => heuristic, not measured
    source: str = "heuristic"             # "heuristic" | "tuned" | "cache"

    def to_json(self) -> dict:
        return {"backend": self.backend, "params": dict(self.params),
                "measured_us": self.measured_us, "source": self.source}

    @classmethod
    def from_json(cls, d: dict) -> "TunedConfig":
        return cls(backend=d["backend"], params=dict(d.get("params", {})),
                   measured_us=d.get("measured_us"),
                   source=d.get("source", "cache"))


def problem_key(p: Problem) -> str:
    n, m, kr = p.sparsity
    key = (f"{p.op}|r{p.rows}|o{p.out}|k{p.k}|{p.dtype}"
           f"|{n}:{m}:{kr}|{p.platform}")
    if p.block_r:
        # block geometry is fixed at pack time, so two packings of the same
        # weight are distinct dispatch problems
        key += f"|b{p.block_r}x{p.a_max}"
    if p.shards > 1:
        key += f"|s{p.shards}"
    if p.duplicates:
        # the summing instantiation (and, on the bulk body, the widest x
        # tile) is another kernel: params measured without duplicates may
        # not fit with them.  Every other key stays the reference's.
        key += "|dup"
    return key


def heuristic_default(p: Problem) -> TunedConfig:
    """Best unmeasured guess: the hand-written kernel with the wrapper's own
    heuristics (``cuda``, ``{}``) on a CUDA problem, the plain version
    (``reference``) on the CPU."""
    preferred = ("cuda",) if p.platform == "cuda" else ("reference",)
    for name in preferred:
        for v in variants_for(p.op, p):
            if v.name == name:
                return TunedConfig(name, v.default_params(p))
    raise RuntimeError(f"no supported variant for {p}")


class TuneCache:
    """Two-level (memory + JSON file) cache of :class:`TunedConfig`."""

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else os.environ.get(
            ENV_PATH, DEFAULT_PATH)
        self._mem: Dict[str, TunedConfig] = {}
        self._lock = threading.Lock()
        self._loaded = False

    # -- persistence --------------------------------------------------------

    def load(self) -> int:
        """Merge on-disk entries into memory; returns #entries loaded."""
        with self._lock:
            self._loaded = True
            if not self.path or not os.path.exists(self.path):
                return 0
            try:
                with open(self.path) as f:
                    blob = json.load(f)
            except (OSError, json.JSONDecodeError):
                return 0
            if blob.get("version") != SCHEMA_VERSION:
                return 0
            n = 0
            for key, entry in blob.get("entries", {}).items():
                try:
                    self._mem.setdefault(key, TunedConfig.from_json(entry))
                    n += 1
                except (KeyError, TypeError):
                    continue
        _counter("tune_cache_loads_total",
                 "cache files loaded from disk").inc()
        _counter("tune_cache_entries_loaded_total",
                 "tuning entries merged from disk").inc(n)
        return n

    def save(self):
        """Write the measured entries (memoized heuristics stay in memory)
        atomically: a uniquely named temp file, then ``os.replace``."""
        with self._lock:
            if not self.path:
                return
            d = os.path.dirname(self.path) or "."
            os.makedirs(d, exist_ok=True)
            blob = {"version": SCHEMA_VERSION,
                    "entries": {k: v.to_json() for k, v in self._mem.items()
                                if v.source != "heuristic"}}
            fd, tmp = tempfile.mkstemp(
                dir=d, prefix=os.path.basename(self.path) + ".", suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(blob, f, indent=2, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # -- lookup / update ----------------------------------------------------

    def _ensure_loaded(self):
        if not self._loaded:
            self.load()

    def get(self, p: Problem) -> Optional[TunedConfig]:
        self._ensure_loaded()
        with self._lock:
            return self._mem.get(problem_key(p))

    def put(self, p: Problem, cfg: TunedConfig, *, persist: bool = False):
        self._ensure_loaded()
        with self._lock:
            self._mem[problem_key(p)] = cfg
        if persist:
            self.save()

    def invalidate(self, p: Problem):
        self._ensure_loaded()
        with self._lock:
            self._mem.pop(problem_key(p), None)

    def clear(self):
        with self._lock:
            self._mem.clear()

    def resolve(self, p: Problem) -> TunedConfig:
        """Cache hit or heuristic default — never measures, a pure host
        lookup (the port resolves at the warm-up step and at the capture,
        never at a replay)."""
        # register both families up front so a snapshot always shows the
        # hit/miss pair even when one side is still zero
        hits = _counter("tune_cache_hits_total",
                        "resolve() served from cache (incl. memoized "
                        "heuristics)", op=p.op)
        misses = _counter("tune_cache_misses_total",
                          "resolve() fell back to a fresh heuristic default",
                          op=p.op)
        from repro_torch import obs

        key = problem_key(p)
        hit = self.get(p)
        if hit is not None:
            hits.inc()
            obs.metrics().trace.event("tune_cache_resolve", op=p.op,
                                      outcome="hit", backend=hit.backend,
                                      key=key)
            return hit
        misses.inc()
        cfg = heuristic_default(p)
        obs.metrics().trace.event("tune_cache_resolve", op=p.op,
                                  outcome="miss", backend=cfg.backend,
                                  key=key)
        # memoize the heuristic so repeated lookups skip the registry walk,
        # but never persist it: a later autotune run should win.
        with self._lock:
            self._mem.setdefault(key, cfg)
        return cfg

    def __len__(self):
        with self._lock:
            return len(self._mem)


_default_cache: Optional[TuneCache] = None
_default_lock = threading.Lock()


def default_cache() -> TuneCache:
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = TuneCache()
        return _default_cache


def set_default_cache(cache: Optional[TuneCache]):
    """Swap the process-wide cache (tests; custom cache paths)."""
    global _default_cache
    with _default_lock:
        _default_cache = cache
