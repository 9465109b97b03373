"""Prune a dense model to relaxed N:M, fine-tune with RigL mask updates,
and pack for DeMM serving — the model-compression workflow the paper's
engine targets, on the PyTorch/CUDA port.

Run:  PYTHONPATH=src python examples/torch_prune_and_pack.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.pruning import (  # noqa: E402
    PruneSchedule,
    init_mask,
    maybe_update_mask,
)
from repro_torch.core.sparsity import (  # noqa: E402
    PackedWeight,
    SparsityConfig,
    prune,
    satisfies_pattern,
)
from repro_torch.device import require_device  # noqa: E402
from repro_torch.launch.pack_tree import pack_tree  # noqa: E402
from repro_torch.models.families import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.train_loop import (  # noqa: E402
    make_train_step,
    train_params,
)


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

    # Stage 1: dense-ish baseline (the reduced config inits pre-pruned;
    # one dense matrix shows the pruning step explicitly).
    cfg = get_arch("h2o_danube_1_8b").reduced()
    model = build_model(cfg, device=dev, seed=0)
    sp = SparsityConfig(2, 16)

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    w = torch.randn((64, 128), generator=gen, device=dev)
    print(f"dense w: {float((w != 0).float().mean()):.2%} non-zero")

    # Stage 2: magnitude-prune to the relaxed pattern
    wp = prune(w, sp)
    assert satisfies_pattern(wp, sp)
    print(f"pruned to {sp.pattern_name()}: "
          f"{float((wp != 0).float().mean()):.2%} non-zero, pattern valid")

    # Stage 3: RigL-style mask evolution during (simulated) training
    sched = PruneSchedule(cfg=sp, update_every=2, regrow_fraction=0.3)
    mask = init_mask(w, sp)
    for step in range(6):
        fake_grad = torch.randn(w.shape, generator=gen, device=dev)
        mask = maybe_update_mask(step, w, mask, fake_grad, sched)
        dens = float(mask.float().mean())
        assert satisfies_pattern(torch.where(mask, w, 0.0), sp)
    print(f"RigL mask updates keep the pattern exact (density {dens:.2%})")

    # Stage 4: brief sparse fine-tune of the full model + pack for serving
    params = train_params(model)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    opt = adamw.init(opt_cfg, params)
    step_fn = make_train_step(model, opt_cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)),
             "targets": rng.integers(0, cfg.vocab_size, (4, 32))}
    for i in range(4):
        params, opt, m = step_fn(params, opt, batch, i)
    print(f"fine-tuned 4 steps (loss {float(m['loss']):.3f})")

    pack_tree(model)                    # in place
    pws = [mod for mod in model.modules() if isinstance(mod, PackedWeight)]
    total_dense = sum(2 * pw.out_features * pw.in_features for pw in pws)
    # bf16 value + int32 index per slot: the port's storage
    total_packed = sum(pw.values.numel() * (2 + 4) for pw in pws)
    print(f"packed {len(pws)} sparse layers (pattern "
          f"{pws[0].cfg.pattern_name()}): {total_dense / 1e6:.2f}MB dense "
          f"-> {total_packed / 1e6:.2f}MB packed "
          f"({total_dense / total_packed:.1f}x smaller weight stream)")


if __name__ == "__main__":
    main()
