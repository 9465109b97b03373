"""Quickstart of the PyTorch/CUDA port: the paper's technique end to end.

1. Build a relaxed 8:128-sparse matrix, pack it, and run the DeMM engine.
2. Hold the paper-orientation CUDA kernel (K5, ``ops.demm_spmm``) against
   its plain PyTorch version on the card (``--device cpu``: the plain
   version against the unpack-and-matmul oracle).
3. Train a tiny sparse LM for a few steps and serve it with packed weights.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.demm import DeMMConfig, demm_spmm  # noqa: E402
from repro_torch.core.sparsity import (  # noqa: E402
    SparsityConfig,
    pack,
    random_sparse_dense,
    satisfies_pattern,
)
from repro_torch.device import require_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.demm_spmm import demm_spmm_plain  # noqa: E402
from repro_torch.kernels.ref import spmm_ref  # noqa: E402


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
    on_card = dev.type == "cuda"

    print("=" * 70)
    print("1. Relaxed structured sparsity + the decoupled engine")
    print("=" * 70)
    cfg = SparsityConfig(n=8, m=128)
    rng = np.random.default_rng(0)
    a = random_sparse_dense(rng, rows=256, cols=512, cfg=cfg)
    b = rng.standard_normal((512, 128)).astype(np.float32)
    print(f"pattern {cfg.pattern_name()}: density {cfg.density:.3%}, "
          f"packed compression {cfg.compression_ratio(2, 4):.1f}x "
          "(bf16 values + int32 indices, the port's storage)")
    a_t, b_t = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    assert satisfies_pattern(a_t, cfg)

    packed = pack(a_t, cfg)
    print(f"packed: values {tuple(packed.values.shape)}, indices "
          f"{tuple(packed.indices.shape)}")
    out = demm_spmm(packed, b_t)                   # row-wise product-first
    np.testing.assert_allclose(out.cpu().numpy(), a @ b, rtol=1e-4,
                               atol=1e-4)
    print("DeMM row-wise product-first == dense matmul  [ok]")

    engine = DeMMConfig(n=8, m=128, c=64, k=8)     # the paper's DeMM(8,128,64,8)
    print(f"engine DeMM(8,128,64,8): {engine.multipliers} MACs, supports "
          f"8:128 through {engine.k * engine.n}:128 (k-reconfiguration)")

    print()
    print("=" * 70)
    if on_card:
        print("2. The CUDA kernel (K5) vs its plain version on the card")
    else:
        print("2. K5's plain version vs the oracle (--device cpu)")
    print("=" * 70)
    t0 = time.time()
    backend = "cuda" if on_card else "reference"
    got = ops.demm_spmm(packed.values, packed.indices, b_t, cfg, (256, 512),
                        backend=backend, duplicates=False)
    want = (demm_spmm_plain(packed.values, packed.indices, b_t, cfg)
            if on_card else
            spmm_ref(packed.values, packed.indices, b_t, cfg, (256, 512)))
    if on_card:
        torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    print(f"ops.demm_spmm (backend {backend}) == "
          f"{'plain version' if on_card else 'oracle'}  [ok]  "
          f"({time.time() - t0:.1f}s"
          + (f", {torch.cuda.get_device_name(dev)})" if on_card else ")"))

    print()
    print("=" * 70)
    print("3. Sparse LM: train (masked) -> pack -> serve (DeMM)")
    print("=" * 70)
    from repro_torch.configs.base import get_arch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.core.sparsity import PackedWeight
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.optim import adamw
    from repro_torch.serve.serve_loop import Request, ServeConfig, ServeEngine
    from repro_torch.train.train_loop import make_train_step, train_params

    arch = get_arch("stablelm_3b").reduced()
    model = build_model(arch, device=dev, seed=0)
    params = train_params(model)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    opt = adamw.init(opt_cfg, params)
    step = make_train_step(model, opt_cfg)
    batch = {
        "tokens": rng.integers(0, arch.vocab_size, (4, 32)),
        "targets": rng.integers(0, arch.vocab_size, (4, 32)),
    }
    losses = []
    for i in range(8):
        params, opt, m = step(params, opt, batch, i)
        losses.append(float(m["loss"]))
    print(f"masked-sparse training: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce the loss"

    pack_tree(model)   # sparse linears -> PackedWeight modules, in place
    pws = [mod for mod in model.modules() if isinstance(mod, PackedWeight)]
    print(f"packed weights are modules ({len(pws)} nodes), e.g. {pws[0]}")
    eng = ServeEngine(model, ServeConfig(num_slots=2, max_len=48),
                      policy=ExecPolicy(mode="packed", backend=backend),
                      device=dev)
    eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=8))
    eng.run_until_drained()
    out = eng.completed[0].output
    assert len(out) == 8, out
    print(f"packed-DeMM serving (backend {backend}): generated {out}")
    print("\nquickstart complete.")


if __name__ == "__main__":
    main()
