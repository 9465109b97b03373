"""Admission + scheduling policy for the paged serve engine.

The scheduler is pure host logic: it owns the wait queue, the request
lifecycle stages, and the preemption-victim policy; the engine owns slots,
pages, and device state.  Two policies:

* ``fcfs``     — strict arrival order; preemption (decode page growth when
  the arena is full) evicts the *youngest* active request.
* ``priority`` — lower ``Request.priority`` number wins; ties break by
  arrival order.  Admission may preempt a strictly lower-priority active
  request; decode-growth preemption evicts the worst (priority, youngest).

A preempted request keeps its original arrival sequence number, so on
requeue it sorts ahead of later arrivals of the same priority — combined
with greedy decoding and re-prefill of prompt + generated-so-far, the
preempt/resume cycle is deterministic and token-identical.  (A copy of the
JAX package's ``paged/scheduler.py``: pure Python.)
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, Iterable, List, Optional, Tuple


class Stage:
    """Request lifecycle stages (trace-event / test vocabulary)."""

    QUEUED = "queued"
    SCHEDULED = "scheduled"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    COMPLETE = "complete"


@dataclasses.dataclass
class SchedConfig:
    policy: str = "fcfs"              # "fcfs" | "priority"
    preempt: bool = True              # page-eviction preemption allowed
    prefill_chunks_per_tick: int = 4  # prefill/decode interleave budget

    def __post_init__(self):
        if self.policy not in ("fcfs", "priority"):
            raise ValueError(
                f"scheduler policy must be 'fcfs' or 'priority', got "
                f"{self.policy!r}")
        if self.prefill_chunks_per_tick < 1:
            raise ValueError("prefill_chunks_per_tick must be >= 1")


class Scheduler:
    def __init__(self, cfg: Optional[SchedConfig] = None):
        self.cfg = cfg or SchedConfig()
        self._heap: List[Tuple[Tuple[int, int], object]] = []
        self._arrival = itertools.count()
        self.seq_of: Dict[int, int] = {}      # uid -> arrival seq (stable)
        self.stage: Dict[int, str] = {}       # uid -> Stage.*
        self.preempts_of: Dict[int, int] = {} # uid -> times preempted

    # -- queue --------------------------------------------------------------

    def _key(self, req) -> Tuple[int, int]:
        seq = self.seq_of[req.uid]
        prio = req.priority if self.cfg.policy == "priority" else 0
        return (prio, seq)

    def submit(self, req):
        if req.uid in self.seq_of:
            raise ValueError(f"request uid {req.uid} already submitted")
        self.seq_of[req.uid] = next(self._arrival)
        self.preempts_of[req.uid] = 0
        self.stage[req.uid] = Stage.QUEUED
        heapq.heappush(self._heap, (self._key(req), req))

    def requeue(self, req):
        """Put a preempted request back; its original arrival seq means it
        re-runs before same-priority work that arrived after it."""
        self.preempts_of[req.uid] += 1
        self.stage[req.uid] = Stage.QUEUED
        heapq.heappush(self._heap, (self._key(req), req))

    def peek(self):
        return self._heap[0][1] if self._heap else None

    def pop(self):
        return heapq.heappop(self._heap)[1] if self._heap else None

    def __len__(self):
        return len(self._heap)

    # -- preemption policy --------------------------------------------------

    def victim(self, candidates: Iterable[Tuple[int, object]], *,
               incoming=None) -> Optional[int]:
        """Pick the preemption victim among active ``(slot, request)`` pairs:
        the worst by (priority, youngest arrival).  With ``incoming`` set
        (admission-time preemption) only a strictly lower-priority victim
        qualifies — equal-priority admission never thrashes running work.
        Returns the victim's slot, or None."""
        worst = None
        for slot, req in candidates:
            key = (req.priority if self.cfg.policy == "priority" else 0,
                   self.seq_of[req.uid])
            if worst is None or key > worst[0]:
                worst = (key, slot, req)
        if worst is None:
            return None
        if incoming is not None:
            if self.cfg.policy != "priority":
                return None
            if incoming.priority >= worst[2].priority:
                return None
        return worst[1]
