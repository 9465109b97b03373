"""Roofline table of the port's dry-run census (the counterpart of
``roofline.py``): read the census JSONL (``repro_torch.launch.dryrun``) and
print the per-(arch x shape) three-term roofline table against one H100's
roofs, with the bytes a rank holds against the card's 80 GB.

Usage: PYTHONPATH=src python -m benchmarks.torch_roofline [results/torch_dryrun.jsonl]

The JSONL is written by
``PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/torch_dryrun.jsonl``
(add ``--packed`` for packed decode cells).  A cell's last record wins; a
dense and a packed record of one decode cell are rows of their own.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.dryrun import HBM_BYTES  # noqa: E402

RESULTS = "results/torch_dryrun.jsonl"


def load(path=RESULTS):
    recs = {}
    if not os.path.exists(path):
        return recs
    for line in open(path):
        line = line.strip()
        if not line:
            continue
        r = json.loads(line)
        key = (r.get("arch"), r.get("shape"), r.get("mesh"),
               bool(r.get("packed", False)))
        recs[key] = r  # last record wins (reruns)
    return recs


def table(recs, mesh="pod16x16"):
    rows = []
    for (arch, shape, m, packed), r in sorted(recs.items()):
        if m != mesh or "error" in r:
            continue
        rl = r["roofline"]
        peak = r["memory_analysis"]["peak_bytes"]
        rows.append({
            "arch": arch, "shape": shape, "packed": packed,
            "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
            "collective_s": rl["collective_s"], "dominant": rl["dominant"],
            "useful_ratio": r.get("useful_flops_ratio", 0.0),
            "peak_gb": peak / 1e9, "hbm_share": peak / HBM_BYTES,
            "census_s": r.get("census_s", 0.0),
            "roofline_fraction": rl["compute_s"] / max(
                rl["compute_s"], rl["memory_s"], rl["collective_s"]),
        })
    return rows


def run(verbose=True, path=RESULTS):
    """Print the table (``verbose``) and return the ``roofline_<arch>_
    <shape>`` rows (``_packed`` for a packed decode cell): (name, compute
    share of the largest term in %, dominant term)."""
    recs = load(path)
    rows = table(recs)
    out = []
    if verbose:
        print(f"{'arch':24s}{'shape':13s}{'pk':>3s}{'compute':>11s}"
              f"{'memory':>11s}{'collect':>11s}  {'dominant':13s}"
              f"{'useful':>7s}{'frac':>7s}{'GB/rank':>9s}{'/80GB':>7s}"
              f"{'census_s':>9s}")
        for r in rows:
            print(f"{r['arch']:24s}{r['shape']:13s}"
                  f"{'y' if r['packed'] else '-':>3s}"
                  f"{r['compute_s']:11.3e}{r['memory_s']:11.3e}"
                  f"{r['collective_s']:11.3e}  {r['dominant']:13s}"
                  f"{r['useful_ratio']:7.3f}{r['roofline_fraction']:7.3f}"
                  f"{r['peak_gb']:9.2f}{r['hbm_share']:7.2f}"
                  f"{r['census_s']:9.1f}")
    for r in rows:
        name = f"roofline_{r['arch']}_{r['shape']}" + (
            "_packed" if r["packed"] else "")
        out.append((name, r["roofline_fraction"] * 100,
                    f"dominant={r['dominant']}"))
    errors = [(k, v["error"][:100]) for k, v in recs.items() if "error" in v]
    if verbose and errors:
        print(f"\n{len(errors)} cells with errors:")
        for k, e in errors:
            print(" ", k[:3], e)
    return out


if __name__ == "__main__":
    run(path=sys.argv[1] if len(sys.argv) > 1 else RESULTS)
