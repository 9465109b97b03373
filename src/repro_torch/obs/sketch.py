"""Mergeable relative-error quantile sketch (DDSketch-style, stdlib-only).

Fixed-bucket histograms answer "how many decode ticks were under
25ms" but quantiles read off them are only as good as the bucket edges —
a p99 between 2.5s and 5s is reported as "somewhere in [2.5, 5]".  The
sketch replaces that with a *relative* accuracy guarantee: every quantile
estimate ``q̂`` satisfies ``|q̂ - q| <= alpha * q`` regardless of scale,
using geometrically-spaced buckets ``(γ^(i-1), γ^i]`` with
``γ = (1+α)/(1-α)`` and the index map ``i = ceil(log_γ(v))``.  Buckets are
a sparse dict, so a sketch over µs-to-minutes latencies stays a few hundred
ints.

Sketches are **exactly mergeable**: merging is bucket-wise integer
addition, so merging per-replica sketches in any grouping or order yields
bit-identical bucket state — the DP router's combined percentiles equal
those of one sketch that saw every observation (the property the
exact-merge test in ``tests/test_obs_v2.py`` pins).  Compare histograms,
whose merge is also exact, but whose *accuracy* is fixed by bucket edges;
and t-digests, whose merge is order-dependent.

Values must be >= 0 (these are latencies / sizes); values below
``MIN_VALUE`` (1e-9 s — sub-nanosecond) land in a dedicated zero bucket.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence

__all__ = ["DEFAULT_ALPHA", "MIN_VALUE", "QuantileSketch"]

DEFAULT_ALPHA = 0.01   # 1% relative error; ~900 buckets span 1µs..1h
MIN_VALUE = 1e-9


class QuantileSketch:
    """DDSketch-style quantile sketch; thread-safe under the given lock.

    Registered as the fourth :class:`~repro_torch.obs.metrics.MetricsRegistry`
    family kind (``registry.sketch(name, **labels)``); also usable
    standalone (``QuantileSketch()`` makes its own lock).
    """

    __slots__ = ("_lock", "alpha", "gamma", "_log_gamma", "bins",
                 "zero_count", "count", "sum", "min", "max")

    def __init__(self, lock: Optional[threading.RLock] = None,
                 alpha: float = DEFAULT_ALPHA):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"sketch alpha must be in (0, 1), got {alpha}")
        self._lock = lock if lock is not None else threading.RLock()
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.bins: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording ----------------------------------------------------------

    def _index(self, v: float) -> int:
        return math.ceil(math.log(v) / self._log_gamma)

    def observe(self, v: float):
        v = float(v)
        if v < 0.0:
            raise ValueError(f"sketch values must be >= 0, got {v}")
        with self._lock:
            if v <= MIN_VALUE:
                self.zero_count += 1
            else:
                i = self._index(v)
                self.bins[i] = self.bins.get(i, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    # -- queries ------------------------------------------------------------

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (0 <= q <= 1); None when empty.
        Relative error <= alpha for values above ``MIN_VALUE``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            rank = q * (self.count - 1)       # 0-indexed rank, nearest-rank
            if rank < self.zero_count:
                return 0.0
            acc = self.zero_count
            for i in sorted(self.bins):
                acc += self.bins[i]
                if acc > rank:
                    # midpoint of (γ^(i-1), γ^i]: relative error <= alpha
                    return 2.0 * self.gamma ** i / (self.gamma + 1.0)
            return self.max                   # numerically unreachable guard

    def quantiles(self, qs: Sequence[float]) -> Dict[float, Optional[float]]:
        return {q: self.quantile(q) for q in qs}

    # -- merge / serialization ----------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (bucket-wise addition; exact).  Both
        sketches must share ``alpha`` — merging across resolutions would
        silently void the error bound."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha "
                f"({self.alpha} vs {other.alpha})")
        with self._lock:
            for i, c in other.bins.items():
                self.bins[i] = self.bins.get(i, 0) + c
            self.zero_count += other.zero_count
            self.count += other.count
            self.sum += other.sum
            if other.min < self.min:
                self.min = other.min
            if other.max > self.max:
                self.max = other.max
        return self

    def to_entry(self) -> dict:
        """JSON-able state (the snapshot ``sketches`` entry body)."""
        with self._lock:
            return {
                "alpha": self.alpha,
                "bins": {str(i): c for i, c in sorted(self.bins.items())},
                "zero_count": self.zero_count,
                "count": self.count,
                "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
            }

    @classmethod
    def from_entry(cls, entry: dict,
                   lock: Optional[threading.RLock] = None) -> "QuantileSketch":
        """Rebuild from :meth:`to_entry` output (router merge, bench
        cross-run merge)."""
        sk = cls(lock, alpha=float(entry["alpha"]))
        sk.bins = {int(i): int(c) for i, c in entry.get("bins", {}).items()}
        sk.zero_count = int(entry.get("zero_count", 0))
        sk.count = int(entry.get("count", 0))
        sk.sum = float(entry.get("sum", 0.0))
        sk.min = math.inf if entry.get("min") is None else float(entry["min"])
        sk.max = (-math.inf if entry.get("max") is None
                  else float(entry["max"]))
        return sk

    def copy(self) -> "QuantileSketch":
        return QuantileSketch.from_entry(self.to_entry())

    def __len__(self):
        return self.count

    def __repr__(self):
        return (f"QuantileSketch(alpha={self.alpha}, count={self.count}, "
                f"bins={len(self.bins)})")
