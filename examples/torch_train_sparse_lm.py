"""End-to-end driver on the PyTorch/CUDA port: gradually sparsify a small LM
to relaxed 8:128 DeMM sparsity (``repro_torch.sparsetrain``), then serve it
packed.

An xlstm-family config (4 layers, d_model 256, vocab 8192, 8:128 on every
projection) trained on the synthetic pipeline with the supervisor stack
(checkpoints + deterministic resume + the schedule state riding every
checkpoint), a gradual dense → 8:256 → 8:128 magnitude-pruning schedule,
and — after baking the final masks — packed **block-layout** serving
through ``launch.serve.run_serve``, asserting the trained model generates.

Run:  PYTHONPATH=src python examples/torch_train_sparse_lm.py [--steps 300]
      [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.device import require_device  # noqa: E402
from repro_torch.launch.serve import run_serve  # noqa: E402
from repro_torch.launch.train import verify_final_masks  # noqa: E402
from repro_torch.models.families import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sparsetrain import (  # noqa: E402
    SparseTrainRecipe,
    SparseTrainer,
)
from repro_torch.sparsetrain.masks import anneal_schedule  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    SupervisorConfig,
    TrainingSupervisor,
    inject_failure_once,
)
from repro_torch.train.train_loop import (  # noqa: E402
    load_params,
    train_params,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="results/sparse_lm_ckpt")
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused without a CUDA device) or "
                         "cpu")
    args = ap.parse_args(argv)
    try:
        dev = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    backend = "cuda" if dev.type == "cuda" else "reference"

    # the xlstm-125m arch narrowed, with the paper's relaxed sparsity on
    # every projection
    cfg = dataclasses.replace(
        get_arch("xlstm_125m"),
        num_layers=4, d_model=256, num_heads=4, vocab_size=8192,
        sparsity=SparsityConfig(8, 128, 1),
    )
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=32))
    model = build_model(cfg, device=dev, seed=0)
    params = train_params(model)
    n = sum(p.numel() for p in params.values())
    print(f"model: {cfg.name}-style, {n / 1e6:.1f}M params, "
          f"sparsity {cfg.sparsity.pattern_name()}, on {dev}")

    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=args.steps,
                                warmup_steps=args.steps // 20)
    opt = adamw.init(opt_cfg, params)

    # Gradual sparsification: dense warmup → coarse 8:256 → serving 8:128,
    # mask refreshed every 25 steps and frozen for the last 10%.
    schedule = anneal_schedule(cfg.sparsity, args.steps)
    print(f"sparsify schedule: {schedule.spec()}")
    trainer = SparseTrainer(model, opt_cfg,
                            SparseTrainRecipe(schedule=schedule))
    trainer.init_state(params)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)

    # keyed by step so supervisor restarts replaying steps overwrite
    # instead of duplicating entries (same rule as launch/train.py)
    loss_by_step = {}
    t0 = time.time()

    def logging_step(p, o, b, s):
        p, o, m = trainer.train_step(p, o, b, s)
        loss_by_step[s] = float(m["loss"])
        if s % 25 == 0:
            print(f"step {s:4d}  loss {loss_by_step[s]:.4f}  "
                  f"({time.time() - t0:.0f}s)")
        return p, o, m

    sup = TrainingSupervisor(
        SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50),
        logging_step, data_cfg, extra_state=trainer)
    injector = (inject_failure_once(args.inject_failure)
                if args.inject_failure else None)
    params, opt, _, restarts = sup.run(params, opt, args.steps,
                                       failure_injector=injector)
    first, last = loss_by_step[0], loss_by_step[max(loss_by_step)]
    print(f"\nfinal loss {last:.4f} (started {first:.4f}), "
          f"restarts={restarts}")
    # pruning phases cause transient spikes: require learning vs init OR
    # recovery within the final (serving-pattern) phase — same rule as
    # launch/train.py
    t_final = min(schedule.phases[-1].start, max(loss_by_step))
    assert last < first or last < loss_by_step[t_final], \
        "loss must decrease (vs step 0 or vs the final phase's start)"

    # Bake the final masks into the model and serve it through
    # launch.serve's engine on the two-level block layout.
    params = trainer.finalize(params)
    n_sparse = verify_final_masks(params, trainer.sparsity)
    load_params(model, params)
    print(f"final masks satisfy 8:128 exactly on {n_sparse} sparse linears")
    engine = run_serve(model, cfg.vocab_size, packed=True, layout="block",
                       backend=backend, requests=4, slots=2, max_new=6,
                       max_len=64, device=dev)
    assert len(engine.completed) == 4, "block-packed serving must drain"
    assert all(len(r.output) == 6 for r in engine.completed)
    print(f"served {len(engine.completed)} requests on the block-packed "
          f"trained model (backend {backend}), e.g. "
          f"{engine.completed[0].output}")


if __name__ == "__main__":
    main()
