"""Convert repro_torch.obs JSONL traces into Perfetto/Chrome trace JSON.

The JSONL event trace (``--trace-out``, :mod:`repro_torch.obs.trace`) is
trace-id-correlated: every event emitted on a request's behalf carries the
owning request's ``trace_id`` (spliced by :mod:`repro_torch.obs.context`).  This
module renders those events in the Chrome trace event format — one virtual
*thread* per request, span events as ``"ph": "X"`` complete events, point
events as instants — which ``https://ui.perfetto.dev`` (or
``chrome://tracing``) opens directly::

    python -m repro_torch.launch.serve ... --trace-out serve_trace.jsonl
    python -m repro_torch.obs.export serve_trace.jsonl -o serve_perfetto.json

``--check`` additionally validates trace-context propagation: every kernel-dispatch, scheduler, prefill-chunk,
and spec event must carry a ``trace_id`` introduced by some
``request_submit`` — a regression here means a dispatch path lost its
request attribution.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

__all__ = [
    "check_propagation", "load_events", "span_trees", "to_chrome_trace",
]

# Events that MUST be attributable to a submitted request (--check).
# kernel_dispatch fires at the first dispatch of each (op, backend) -- on a
# CUDA engine, while the decode step is captured -- under the dispatching
# request's context; the request_*/prefill_/spec_ families are emitted by the engines
# with explicit trace_id attrs.
CHECKED_PREFIXES = ("kernel_dispatch", "request", "prefill_", "spec_")


def load_events(path: str) -> Tuple[Optional[dict], List[dict]]:
    """Read a JSONL trace; returns ``(header, events)`` where ``header`` is
    the ``_trace_header`` drop marker if present (else None)."""
    header, events = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("name") == "_trace_header":
                header = rec
            else:
                events.append(rec)
    return header, events


def _subsystem(name: str) -> str:
    from repro_torch.obs.recorder import subsystem_of
    return subsystem_of(name)


def to_chrome_trace(events: List[dict]) -> dict:
    """Chrome trace event format: ``pid`` = replica (0 when unlabeled),
    one ``tid`` per ``trace_id`` (tid 0 collects unattributed events),
    spans as complete ("X") events, points as thread-scoped instants."""
    if events:
        t0 = min(float(e["ts"]) for e in events)
    else:
        t0 = 0.0
    tids: Dict[str, int] = {}
    tid_meta: Dict[Tuple[int, int], str] = {}
    out: List[dict] = []

    def tid_of(e) -> int:
        trace_id = e.get("trace_id")
        if trace_id is None:
            return 0
        if trace_id not in tids:
            tids[trace_id] = len(tids) + 1
        return tids[trace_id]

    for e in events:
        name = str(e.get("name", "?"))
        pid = int(e.get("replica", 0) or 0)
        tid = tid_of(e)
        if tid != 0 and (pid, tid) not in tid_meta:
            uid = e.get("uid")
            label = f"req uid={uid} " if uid is not None else "req "
            tid_meta[(pid, tid)] = label + str(e.get("trace_id"))
        args = {k: v for k, v in e.items()
                if k not in ("name", "ts", "wall", "ph", "dur")}
        base = {"name": name, "cat": _subsystem(name), "pid": pid,
                "tid": tid, "ts": (float(e["ts"]) - t0) * 1e6, "args": args}
        if e.get("ph") == "span":
            out.append({**base, "ph": "X",
                        "dur": float(e.get("dur", 0.0)) * 1e6})
        else:
            out.append({**base, "ph": "i", "s": "t"})
    for (pid, tid), label in sorted(tid_meta.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": label}})
    for pid in sorted({ev["pid"] for ev in out}):
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"replica {pid}"}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def span_trees(events: List[dict]) -> Dict[str, List[dict]]:
    """Events grouped per ``trace_id`` in timestamp order — the per-request
    span tree (submit → admit → prefill chunks → draft/verify → complete,
    including preempt/resume)."""
    trees: Dict[str, List[dict]] = {}
    for e in events:
        trace_id = e.get("trace_id")
        if trace_id is not None:
            trees.setdefault(trace_id, []).append(e)
    for tree in trees.values():
        tree.sort(key=lambda e: float(e["ts"]))
    return trees


def check_propagation(events: List[dict]) -> List[str]:
    """Validate that every checked event carries a trace_id introduced by a
    ``request_submit``; returns human-readable violations (empty = pass)."""
    known = {e["trace_id"] for e in events
             if e.get("name") == "request_submit" and "trace_id" in e}
    problems: List[str] = []
    checked = 0
    for i, e in enumerate(events):
        name = str(e.get("name", ""))
        if not name.startswith(CHECKED_PREFIXES):
            continue
        checked += 1
        trace_id = e.get("trace_id")
        if trace_id is None:
            problems.append(f"event #{i} {name!r}: missing trace_id")
        elif trace_id not in known:
            problems.append(
                f"event #{i} {name!r}: trace_id {trace_id!r} not "
                f"introduced by any request_submit")
    if checked == 0:
        problems.append(
            "no checked events found (expected at least request_submit "
            "lifecycle events in a serve trace)")
    if not known:
        problems.append("no request_submit events with trace_id found")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Convert a repro_torch.obs JSONL trace to Perfetto/Chrome "
                    "trace JSON; --check gates trace-context propagation.")
    ap.add_argument("trace", help="input JSONL trace (--trace-out file)")
    ap.add_argument("-o", "--out", default=None,
                    help="output Chrome-trace JSON path "
                         "(default: <trace>.perfetto.json)")
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) unless every kernel_dispatch/"
                         "scheduler/spec event carries a known request "
                         "trace_id")
    args = ap.parse_args(argv)

    header, events = load_events(args.trace)
    if header is not None:
        print(f"note: trace ring dropped {header.get('dropped')} events "
              f"before this dump", file=sys.stderr)

    out_path = args.out or (args.trace + ".perfetto.json")
    chrome = to_chrome_trace(events)
    with open(out_path, "w") as f:
        json.dump(chrome, f)
    trees = span_trees(events)
    print(f"wrote {out_path}: {len(chrome['traceEvents'])} trace events, "
          f"{len(trees)} request span trees")

    if args.check:
        problems = check_propagation(events)
        if problems:
            for p in problems[:20]:
                print(f"check: {p}", file=sys.stderr)
            extra = len(problems) - 20
            if extra > 0:
                print(f"check: ... and {extra} more", file=sys.stderr)
            return 1
        print(f"check: OK — {len(trees)} traces, all checked events "
              f"carry a known request trace_id")
    return 0


if __name__ == "__main__":
    sys.exit(main())
