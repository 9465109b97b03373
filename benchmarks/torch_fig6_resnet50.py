"""Fig. 6 reproduction: per-layer ResNet50 latency @ relaxed 8:128 (95%
RigL-style unstructured masks), DeMM(8,128,64,8) vs S2TA vs VEGETA vs SPOTS,
all at 512 MACs / 500 MHz.

Paper claims (overall latency improvement of DeMM): 18% vs S2TA, 54% vs
VEGETA, 67% vs SPOTS.

The PyTorch port's copy of ``fig6_resnet50.py``, on the port's perf model
(``repro_torch.core.perfmodel``): the same rows under the same names, equal
to the JAX package's (the same seed draws the same masks).  These are the
paper's modelled engines at 500 MHz, not a measurement of any device.

    PYTHONPATH=src python benchmarks/torch_fig6_resnet50.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.perfmodel import (  # noqa: E402
    CLOCK_HZ,
    PAPER_ENGINES_RELAXED,
    improvement,
    resnet50_gemms,
    run_network,
    unstructured_mask,
)

PAPER_CLAIMS = {"S2TA": 0.18, "VEGETA": 0.54, "SPOTS": 0.67}


def run(verbose: bool = True):
    gemms = resnet50_gemms()
    engines = PAPER_ENGINES_RELAXED()
    results = run_network(
        engines, gemms,
        lambda rng, s: unstructured_mask(rng, s.r, s.k, 0.95), seed=0)
    names = [e.name for e in engines]
    rows = []
    if verbose:
        print(f"{'layer':<16}" + "".join(f"{n:>22}" for n in names))
        for s in gemms:
            print(f"{s.name:<16}" + "".join(
                f"{results[n][s.name]:>22,}" for n in names))
    totals = {n: sum(results[n].values()) for n in names}
    out = {}
    for n in names:
        us = totals[n] / CLOCK_HZ * 1e6
        rows.append((f"fig6_total_{n}", us, f"cycles={totals[n]}"))
    for other, claim in zip(names[1:], ("18%", "54%", "67%")):
        imp = improvement(results, names[0], other)
        key = other.split("(")[0].replace("-S", "")
        rows.append((f"fig6_improvement_vs_{key}", imp * 100,
                     f"paper_claim={claim}"))
        if verbose:
            print(f"DeMM improvement vs {other}: {imp*100:.1f}% "
                  f"(paper: {claim})")
    return rows


if __name__ == "__main__":
    run()
