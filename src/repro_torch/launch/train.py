"""End-to-end training command line of the PyTorch/CUDA port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \\
        --steps 4 --batch 2 --seq 256 --ckpt-dir results/ckpt

trains the full-width model on the card (``--device`` defaults to ``cuda``,
and the program refuses to start without a CUDA device); ``--device cpu``
trains on the CPU on purpose, and then reduced (the tiny same-family config)
unless ``--full`` is given.  ``--arch`` takes every architecture: a
``vision`` frontend's batches get ``patch_embeds`` and the ``audio``
family's ``frames`` (:func:`add_frontend_inputs`, from a numpy generator
seeded 0, as the reference makes them).

The step is the JAX package's default: masked dense with the N:M masks
applied once per step, straight-through gradients, AdamW with global-norm
clipping and a warmup + cosine schedule, per-layer rematerialization
(``cfg.remat``), under a :class:`~repro_torch.train.fault_tolerance.
TrainingSupervisor` that checkpoints every ``--ckpt-every`` steps and at the
end (``step_NNNNNNNN/`` with ``manifest.json`` and one ``.npy`` per leaf:
params, AdamW state and, with ``--sparsify``, the mask state).

Sparsity-aware training (``repro_torch.sparsetrain``)::

    python -m repro_torch.launch.train --sparsify 8:128 --qat int8

``--sparsify`` drives a gradual magnitude-pruning schedule (default 3-phase
anneal dense → N:2M → N:M; explicit phases via
``dense@0,8:256@50,8:128@150``) whose mask state rides every checkpoint;
``--qat int8`` adds straight-through fake quantization on the serving int8
grid.  The final checkpoint has the masks baked in (every sparse weight
satisfies its N:M pattern exactly, verified), so it packs and serves
directly::

    python -m repro_torch.launch.serve --ckpt-dir results/ckpt --packed \\
        --quantize int8

The loss must fall (against step 0, or under ``--sparsify`` against the
start of the final phase), or the program fails.  ``--metrics-out m.json``
writes the metrics snapshot (step-time and checkpoint-duration histograms,
restart and failure counters); ``--flight-dir`` attaches a flight recorder
with a train-step stall watchdog.  ``--compression topk|int8`` compresses
the gradients before AdamW's norm (``optim/compression.py``), as the
reference's launcher does (one rank).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.device import require_device


def add_frontend_inputs(cfg, batch: dict, rng) -> dict:
    """The stub frontends' inputs of a batch, as the reference's
    ``launch.train.add_frontend_inputs`` makes them from its numpy
    generator: ``patch_embeds`` (B, num_patches, D) for a ``vision``
    frontend, ``frames`` (B, T / encoder_seq_divisor, D) for the ``audio``
    family, standard normal float32."""
    if cfg.frontend == "vision":
        b, t = batch["tokens"].shape
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b, t = batch["tokens"].shape
        batch["frames"] = rng.standard_normal(
            (b, t // cfg.encoder_seq_divisor, cfg.d_model)).astype(np.float32)
    return batch


def verify_final_masks(params: dict, sparsity: dict) -> int:
    """Raise unless every sparse weight satisfies its stored N:M pattern
    exactly (call after ``SparseTrainer.finalize``).  Returns the count."""
    from repro_torch.core.sparsity import satisfies_pattern

    for name, cfg in sparsity.items():
        if not satisfies_pattern(params[name], cfg):
            raise AssertionError(
                f"final mask of {name} violates {cfg.pattern_name()}")
    return len(sparsity)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def main(argv=None) -> dict:
    """Train; returns a summary (losses and aux losses by step, step
    seconds, restarts, the
    final checkpoint's directory, bytes and save seconds, the device's peak
    memory) and, under ``"params"``, the trained parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm_3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (the default with "
                         "--device cpu)")
    ap.add_argument("--full", action="store_true",
                    help="the full config, also with --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refused when no CUDA device is "
                         "present) or cpu")
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", choices=("topk", "int8"),
                    default=None,
                    help="gradient compression before the norm: top-k with "
                         "error feedback or an int8 round trip")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--sparsify", default=None, metavar="SCHEDULE",
                    help="gradual N:M sparsification: a target pattern "
                         "('8:128', '8:128:2') for the default dense → "
                         "N:2M → N:M anneal, or explicit phases "
                         "('dense@0,8:256@50,8:128@150')")
    ap.add_argument("--sparsify-update-every", type=int, default=25,
                    help="within-phase magnitude-mask refresh cadence")
    ap.add_argument("--sparsify-freeze-after", type=int, default=None,
                    help="stop mask refreshes from this step on (default: "
                         "90%% of --steps)")
    ap.add_argument("--qat", choices=("int8",), default=None,
                    help="straight-through fake quantization on the int8 "
                         "serving grid (requires --sparsify)")
    ap.add_argument("--qat-granularity", choices=("per_row", "per_group"),
                    default="per_row")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot here after training; "
                         ".prom/.txt => Prometheus text, else JSON")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="attach a flight recorder: a train_step stall "
                         "watchdog + bounded event rings, dumped here on "
                         "stall/crash/SIGTERM")
    ap.add_argument("--watchdog-threshold", type=float, default=8.0,
                    help="--flight-dir: declare a stall when step silence "
                         "exceeds this multiple of the EWMA step interval")
    args = ap.parse_args(argv)
    if args.qat and not args.sparsify:
        ap.error("--qat rides the sparsify training path; add --sparsify")
    if args.reduced and args.full:
        ap.error("--reduced and --full are mutually exclusive")
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    # the full config on the card; on the CPU reduced unless --full
    reduced = args.reduced or (device.type == "cpu" and not args.full)

    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.families import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import (SupervisorConfig,
                                                   TrainingSupervisor)
    from repro_torch.train.train_loop import make_train_step, train_params

    log = obs.get_logger("launch.train")
    cfg = get_arch(args.arch)
    if reduced:
        cfg = cfg.reduced()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device=device, seed=0)
    params = train_params(model)
    n_params = sum(p.numel() for p in params.values())
    log.info("arch", name=cfg.name, params_m=round(n_params / 1e6, 1),
             sparsity=(cfg.sparsity.pattern_name() if cfg.sparsity
                       else None),
             reduced=reduced, device=str(device))

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5),
                                compression=args.compression)
    opt_state = adamw.init(opt_cfg, params)

    trainer = None
    if args.sparsify:
        from repro_torch.sparsetrain import SparseTrainRecipe, SparseTrainer
        from repro_torch.sparsetrain.masks import parse_schedule

        schedule = parse_schedule(args.sparsify, args.steps,
                                  update_every=args.sparsify_update_every,
                                  freeze_after=args.sparsify_freeze_after)
        log.info("sparsify schedule", spec=schedule.spec(),
                 **({"qat": f"{args.qat}/{args.qat_granularity}"}
                    if args.qat else {}))
        recipe = SparseTrainRecipe(schedule=schedule, qat=args.qat,
                                   qat_granularity=args.qat_granularity)
        trainer = SparseTrainer(model, opt_cfg, recipe,
                                num_microbatches=args.microbatches)
        trainer.init_state(params)
        step_fn = trainer.train_step
    else:
        from repro_torch.core.sparse_linear import ExecPolicy
        step_fn = make_train_step(model, opt_cfg,
                                  num_microbatches=args.microbatches,
                                  policy=ExecPolicy(mode="masked"))

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    rng = np.random.default_rng(0)
    recorder = None
    if args.flight_dir:
        recorder = obs.FlightRecorder(
            args.flight_dir, watchdog_threshold=args.watchdog_threshold)
        recorder.install_signal_handlers()
    sup = TrainingSupervisor(
        SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        step_fn, data_cfg,
        to_batch=lambda b: add_frontend_inputs(cfg, b, rng),
        extra_state=trainer, recorder=recorder,
        metrics=obs.MetricsRegistry())      # this run's steps and saves only

    t0 = time.time()
    loss_by_step = {}       # keyed by step: a restart's replays overwrite
    aux_by_step = {}        # the experts' load-balancing loss, if any
    orig_step = sup.train_step

    def logging_step(p, o, b, s):
        p, o, m = orig_step(p, o, b, s)
        loss_by_step[s] = float(m["loss"])
        if "aux" in m:
            aux_by_step[s] = float(m["aux"])
        if s % args.log_every == 0:
            log.info(f"step {s:5d}", loss=round(loss_by_step[s], 4),
                     gnorm=round(float(m["grad_norm"]), 3),
                     lr=float(f"{float(m['lr']):.2e}"),
                     elapsed_s=round(time.time() - t0, 1))
        return p, o, m

    sup.train_step = logging_step
    params, opt_state, metrics, restarts = sup.run(params, opt_state,
                                                   args.steps)
    first, last = loss_by_step[0], loss_by_step[max(loss_by_step)]
    log.info("done", final_loss=round(last, 4), first_loss=round(first, 4),
             restarts=restarts)
    if not np.isfinite(list(loss_by_step.values())).all():
        raise AssertionError(f"non-finite loss: {loss_by_step}")
    if trainer is None:
        if not last < first:
            raise AssertionError(
                f"training must reduce loss ({first} -> {last})")
    else:
        # pruning phases cause transient loss spikes, so a very short
        # schedule may end above its dense-warmup start: require learning
        # against step 0 OR within the final (serving-pattern) phase
        t_final = min(trainer.recipe.schedule.phases[-1].start,
                      max(loss_by_step))
        if not (last < first or last < loss_by_step[t_final]):
            raise AssertionError(
                "training must reduce loss (vs step 0 or vs the final "
                "sparsity phase's start)")

    n_sparse = None
    if trainer is not None:
        # bake the final masks (hard zeros) so that the committed checkpoint
        # satisfies the N:M patterns exactly and packs losslessly
        params = trainer.finalize(params)
        n_sparse = verify_final_masks(params, trainer.sparsity)
        t = time.perf_counter()
        ckpt.save({"params": params, "opt": opt_state,
                   "extra": trainer.extra_state()},
                  args.ckpt_dir, args.steps)
        save_seconds = time.perf_counter() - t
        log.info("final masks verified; baked checkpoint re-saved",
                 sparse_linears=n_sparse, step=args.steps)

    trace = sup.metrics.trace
    seconds_by_step = {e["step"]: e["seconds"]
                       for e in trace.named("train_step")}
    if trainer is None:
        save_seconds = trace.named("checkpoint_save")[-1]["seconds"]
    final = os.path.join(args.ckpt_dir, f"step_{args.steps:08d}")
    summary = {
        "arch": cfg.name, "reduced": reduced, "device": str(device),
        "n_params": n_params, "restarts": restarts,
        "losses": [loss_by_step[s] for s in sorted(loss_by_step)],
        "aux": [aux_by_step[s] for s in sorted(aux_by_step)],
        "step_seconds": [seconds_by_step[s] for s in sorted(seconds_by_step)],
        "ckpt_dir": args.ckpt_dir, "ckpt_step": args.steps,
        "ckpt_bytes": _dir_bytes(final),
        "ckpt_save_seconds": save_seconds,
        "sparse_linears_verified": n_sparse,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "params": params,
    }
    log.info("checkpoint", dir=final, bytes=summary["ckpt_bytes"],
             save_s=round(summary["ckpt_save_seconds"], 2))
    if args.metrics_out:
        sup.metrics.write(args.metrics_out)
        log.info("wrote metrics snapshot", path=args.metrics_out)
    if recorder is not None:
        recorder.close()
    return summary


if __name__ == "__main__":
    main()
