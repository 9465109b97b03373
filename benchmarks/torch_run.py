"""Benchmark harness entry point of the PyTorch/CUDA port (the counterpart of
``run.py``) — one function per paper table/figure.

Prints ``name,value,derived`` CSV rows:
  * fig6_*     — Fig. 6 reproduction (relaxed 8:128 vs S2TA/VEGETA/SPOTS)
  * fig8_*     — Fig. 8 reproduction (fine-grained 1:8/1:4/1:2)
  * kernel_*   — packed vs dense weight bytes; on the card K1's device time
                 against one bf16 ``torch.matmul`` and the byte bound
                 (``torch_kernel_bench.run``)
  * roofline_* — per-(arch x shape) roofline fractions of the port's
                 dry-run census (``torch_roofline``; reads
                 results/torch_dryrun.jsonl, skipped if absent)

The figures are the paper's modelled 512-MAC engines at 500 MHz
(``repro_torch.core.perfmodel``), equal to the JAX package's.  The kernel
rows run on the card by default (refused without one); ``--device cpu``
prints the figure rows and the byte rows only.

``--autotune [--quick]`` additionally drives the port's autotuner over its
projection shapes and writes ``BENCH_kernels_h100.json``
(``torch_kernel_bench.run_autotune``).

    PYTHONPATH=src python -m benchmarks.torch_run [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None) -> int:
    from benchmarks import (torch_fig6_resnet50, torch_fig8_finegrained,
                            torch_kernel_bench, torch_roofline)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--roofline", default=torch_roofline.RESULTS,
                    metavar="JSONL",
                    help="the dry-run census's records (default "
                         f"{torch_roofline.RESULTS})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without a CUDA device) or "
                         "cpu (the figure and byte rows only)")
    args = ap.parse_args(argv)

    from repro_torch.device import require_device
    try:
        require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    rows = []
    print("== Fig. 6: relaxed 8:128 on ResNet50 (paper: 18/54/67%) ==")
    f6 = torch_fig6_resnet50.run(verbose=False)
    rows += f6
    for name, val, derived in f6:
        print(f"{name},{val:.2f},{derived}")

    print("== Fig. 8: fine-grained 1:8/1:4/1:2 (ResNet50+ConvNeXt) ==")
    f8 = torch_fig8_finegrained.run(verbose=False)
    rows += f8
    for name, val, derived in f8:
        print(f"{name},{val:.2f},{derived}")

    print("== DeMM kernel benchmarks ==")
    kb = torch_kernel_bench.run(verbose=False, device=args.device)
    rows += kb
    for name, val, derived in kb:
        print(f"{name},{val:.2f},{derived}")

    print("== Roofline (from the dry-run census) ==")
    rl = torch_roofline.run(verbose=False, path=args.roofline)
    rows += rl
    for name, val, derived in rl:
        print(f"{name},{val:.2f},{derived}")
    if not rl:
        print("roofline_skipped,0,run python -m repro_torch.launch.dryrun "
              "--all --out results/torch_dryrun.jsonl first")

    if args.autotune:
        print("== Autotune (repro_torch.tune over the port's shapes) ==")
        out = ("BENCH_kernels_torch_cpu.json" if args.device == "cpu"
               else "BENCH_kernels_h100_quick.json" if args.quick
               else torch_kernel_bench.DEFAULT_OUT)
        blob = torch_kernel_bench.run_autotune(
            quick=args.quick, out_path=out, device=args.device,
            verbose=False)
        for case in blob["cases"]:
            name = f"autotune_{case['name']}_vs_default"
            rows.append((name, case["tuned_vs_default"],
                         f"tuned={case['tuned']['backend']}"))
            print(f"{name},{case['tuned_vs_default']:.2f},"
                  f"tuned={case['tuned']['backend']}{case['tuned']['params']}")

    print(f"== total: {len(rows)} benchmark rows ==")
    return 0


if __name__ == "__main__":
    sys.exit(main())
