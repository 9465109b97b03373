"""Serve a small model with batched requests on the PyTorch/CUDA port,
comparing every supported serving path — dense-masked, packed xwT, two-level
block, and int8-quantized block (sparsity × quantization) — then the paged
serving engine (shared KV arena + chunked prefill + preemption) against the
dense-cache engine.

Both sections compute in float32, where greedy decoding gives the masked
and the packed paths the same tokens, and the paged engine the dense
engine's tokens; int8 values round the weights, so the int8 path is held to
an agreement rate only.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.sparse_linear import ExecPolicy  # noqa: E402
from repro_torch.device import require_device  # noqa: E402
from repro_torch.launch.pack_tree import pack_tree  # noqa: E402
from repro_torch.models.families import build_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.paged import PagedServeConfig, PagedServeEngine  # noqa: E402
from repro_torch.serve.serve_loop import (  # noqa: E402
    Request,
    ServeConfig,
    ServeEngine,
)


def run_engine(model, mode, backend, requests, dev):
    eng = ServeEngine(model, ServeConfig(num_slots=4, max_len=64),
                      policy=ExecPolicy(mode=mode, backend=backend),
                      device=dev)
    for r in requests:
        eng.submit(Request(uid=r.uid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens))
    t0 = time.time()
    eng.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in eng.completed)
    return {r.uid: list(r.output) for r in eng.completed}, toks / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without a CUDA device) or "
                         "cpu")
    args = ap.parse_args(argv)
    try:
        dev = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    backend = "cuda" if dev.type == "cuda" else "reference"

    cfg = dataclasses.replace(get_arch("gemma3_1b").reduced(),
                              compute_dtype="float32")
    rng = np.random.default_rng(0)
    requests = [Request(uid=i,
                        prompt=rng.integers(0, cfg.vocab_size, 8,
                                            dtype=np.int32),
                        max_new_tokens=12)
                for i in range(8)]

    def fresh():
        return build_model(cfg, device=dev, seed=0)

    out_m, tps_m = run_engine(fresh(), "masked", backend, requests, dev)
    out_p, tps_p = run_engine(pack_tree(fresh()), "packed", backend,
                              requests, dev)
    # the two-level block layout: active-group lists decide which activation
    # blocks the kernel reads
    out_b, tps_b = run_engine(pack_tree(fresh(), layout="block"), "packed",
                              backend, requests, dev)
    # sparsity × quantization: the block layout with int8 values + scales,
    # dequantised in registers by the w8a16 kernels
    out_q, tps_q = run_engine(pack_tree(fresh(), layout="block",
                                        quantize="int8"),
                              "packed", backend, requests, dev)

    sp = cfg.sparsity
    print(f"arch {cfg.name} (reduced, float32), sparsity "
          f"{sp.pattern_name()}, backend {backend} on {dev}")
    print(f"masked-dense serving: {len(out_m)} reqs, {tps_m:.1f} tok/s")
    print(f"packed-DeMM  serving: {len(out_p)} reqs, {tps_p:.1f} tok/s")
    print(f"block-DeMM   serving: {len(out_b)} reqs, {tps_b:.1f} tok/s")
    print(f"block+int8   serving: {len(out_q)} reqs, {tps_q:.1f} tok/s")
    agree_q = np.mean([np.mean(np.asarray(out_b[u]) == np.asarray(out_q[u]))
                       for u in out_b])
    assert out_p == out_m, "packed and masked tokens differ"
    assert out_b == out_p, "block and xwT packed tokens differ"
    assert agree_q > 0.6, "int8 path diverged beyond quantization noise"
    print(f"masked == packed xwT == block tokens; block vs block+int8 "
          f"agreement {agree_q:.1%}")
    for uid in sorted(out_m)[:3]:
        print(f"  req {uid}: {out_m[uid]}")

    paged_section(dev, backend)


def paged_section(dev, backend):
    """Paged serving vs the dense-cache engine: mixed prompt lengths, an
    arena deliberately too small for all four sequences (at least one
    preemption by page eviction), and token equality — greedy
    preempt/resume is deterministic."""
    cfg = dataclasses.replace(get_arch("stablelm_3b").reduced(),
                              compute_dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 23, 11, 37)]          # mixed prompt lengths

    def submit_all(eng):
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        t0 = time.time()
        eng.run_until_drained()
        return {r.uid: list(r.output) for r in eng.completed}, \
            time.time() - t0

    policy = ExecPolicy(mode="packed", backend=backend)
    dense = ServeEngine(pack_tree(build_model(cfg, device=dev, seed=0)),
                        ServeConfig(num_slots=4, max_len=96), policy=policy,
                        device=dev, metrics=MetricsRegistry())
    out_dense, dt_d = submit_all(dense)

    reg = MetricsRegistry()
    paged = PagedServeEngine(
        pack_tree(build_model(cfg, device=dev, seed=0)),
        PagedServeConfig(num_slots=4, max_len=96, page_size=8,
                         num_pages=13,     # too small: forces eviction
                         prefill_chunk=16),
        policy=policy, device=dev, metrics=reg)
    out_paged, dt_p = submit_all(paged)

    preempts = int(reg.counter("serve_preempt_total").value)
    chunks = sum(-(-len(p) // 16) for p in prompts)
    print(f"\npaged serving ({cfg.name}, float32, packed): arena of "
          f"{paged.layout.usable_pages} x {paged.layout.page_size}-token "
          f"pages shared by {len(prompts)} requests")
    print(f"  chunked prefill: {paged.prefill.dispatches} dispatches for "
          f"{sum(len(p) for p in prompts)} prompt tokens "
          f"(sum ceil(T/16) = {chunks}, plus re-prefill after preemption; "
          f"the dense engine feeds token by token)")
    print(f"  preemptions: {preempts} (page eviction -> requeue -> "
          f"re-prefill of prompt + generated-so-far)")
    print(f"  dense {dt_d:.2f}s vs paged {dt_p:.2f}s to drain")
    assert preempts >= 1, "undersized arena should have preempted"
    assert out_paged == out_dense, "paged serving must be token-identical"
    print("  token-identical with the dense engine: "
          f"{len(out_paged)}/{len(prompts)} requests")
    for uid in sorted(out_paged)[:2]:
        print(f"  req {uid}: {out_paged[uid]}")


if __name__ == "__main__":
    main()
