"""The dry-run census: every (arch x shape x mesh) cell's program on one
rank, counted without a card, a process group or an allocation.

The JAX package lowers and compiles each cell on a 256- or 512-device fake
mesh and reads XLA's memory, cost and collective analysis
(``launch/dryrun.py``).  The port's counterpart builds the cell's model on
the meta device, places it by its own ``ShardingPlan`` for the rank at
coordinate 0 of every mesh dim of a :class:`~repro_torch.sharding.context.
CensusMesh`, and runs the cell's real step there — the train step
(``train.train_loop.make_train_step``, ZeRO-1 moments over ``data``), the
masked prefill, or the dense or packed decode step — under the census
(``launch.census``), which counts FLOPs, bytes, collectives and live bytes.

Usage:
    python -m repro_torch.launch.dryrun --arch stablelm_3b --shape decode_32k [--packed] [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--packed] [--out results/torch_dryrun.jsonl]

Each cell prints one JSON record with the JAX package's keys
(``census_s`` in place of ``compile_s``): ``memory_analysis`` (bytes per
rank), ``cost_analysis`` (FLOPs and bytes per rank), ``collectives`` (bytes
per rank by kind), ``roofline`` (the three terms in seconds against the
roofs of one H100, :data:`ROOF`), ``model_flops`` and
``useful_flops_ratio``.  A cell the port refuses (``NotImplementedError``)
is a record ``{"arch", "shape", "mesh", "error"}``, as the JAX package
records a failed cell; the CLI exits 0 all the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import torch

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    applicable_shapes,
    get_arch,
)

# The roofs of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet, dense rates,
# at the full 700 W power limit): bf16 tensor-core FLOP/s, HBM3 bytes/s and
# NVLink bytes/s each way.  A 16-way ``model`` dim spans two hosts of 8
# cards, whose link is slower than NVLink and not measured here: there
# ``collective_s`` is a lower bound.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
ROOF = ("NVIDIA H100 SXM 80GB data sheet, dense, 700 W: 989e12 FLOP/s "
        "bf16, 3.35e12 B/s HBM3, 450e9 B/s NVLink each way; collective_s "
        "is a lower bound where the 16-way model dim spans two hosts of 8")
HBM_BYTES = 80e9          # one H100's device memory


def make_census_mesh(multi_pod: bool = False):
    """The production mesh's shape and dim names as a census mesh: (data
    16, model 16), or (pod 2, data 16, model 16)."""
    from repro_torch.sharding.context import CensusMesh

    if multi_pod:
        return CensusMesh((2, 16, 16), ("pod", "data", "model"))
    return CensusMesh((16, 16), ("data", "model"))


def _dim(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


# ---------------------------------------------------------------------------
# Decode-state placement, inferred by probes (the JAX package's rule)
# ---------------------------------------------------------------------------

def _axis_of_change(a, b):
    if not isinstance(a, torch.Tensor):
        return None
    return next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y), None)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured dict trees."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def decode_state_specs(model, shape, mesh, *, seq_shard: bool):
    """(spec tree, the state on the meta device) of ``model``'s decode state
    at ``shape`` on ``mesh``, as the JAX package infers it: the batch axis
    (found by a probe at batch + 1) over the data-parallel dims, or, with
    ``seq_shard``, the sequence axis (a probe at seq_len + 1) over them; and
    a ``model`` dim on the second-from-last axis (heads), else the last,
    where its size is a multiple of tp and not used.  Non-tensor leaves get
    an empty spec.  The port itself splits only KV heads over ``model``
    (:func:`local_state_specs`)."""
    from repro_torch.sharding.partitioning import Spec, batch_axes

    b = shape.global_batch
    base = model.init_decode_state(b, shape.seq_len, device="meta")
    probe_b = model.init_decode_state(b + 1, shape.seq_len, device="meta")
    probe_s = model.init_decode_state(b, shape.seq_len + 1, device="meta")
    tp = _dim(mesh, "model")
    dp_axes = batch_axes(mesh)
    dp_total = math.prod(_dim(mesh, a) for a in dp_axes)
    dp_part = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def one(leaf, pb, ps):
        if not isinstance(leaf, torch.Tensor):
            return Spec()
        nd = leaf.ndim
        parts = [None] * nd
        batch_ax = _axis_of_change(leaf, pb)
        seq_ax = _axis_of_change(leaf, ps)
        used = set()
        if seq_shard and seq_ax is not None and \
                leaf.shape[seq_ax] % dp_total == 0:
            parts[seq_ax] = dp_part
            used.add(seq_ax)
        elif batch_ax is not None and leaf.shape[batch_ax] % dp_total == 0:
            parts[batch_ax] = dp_part
            used.add(batch_ax)
        used |= {a for a in (batch_ax, seq_ax) if a is not None}
        for ax in ([nd - 2, nd - 1] if nd >= 2 else []):
            if ax in used:
                continue
            if leaf.shape[ax] % tp == 0 and leaf.shape[ax] >= tp:
                parts[ax] = "model"
                break
        return Spec(*parts)

    return _tree_map(one, base, probe_b, probe_s), base


def local_state_specs(model, shape, mesh, plan, *, seq_shard: bool):
    """(spec tree, the whole state on the meta device) of the decode state
    as the port places it on a rank: the data-parallel parts of
    :func:`decode_state_specs` (the batch over ``pod`` x ``data``, or with
    ``seq_shard`` the sequence over ``data``) and the ``model`` parts of
    ``plan.decode_state_specs`` (KV heads where they divide tp, the
    recurrent states of the mixers split by heads; ring positions whole)."""
    from repro_torch.sharding.partitioning import Spec

    specs, base = decode_state_specs(model, shape, mesh, seq_shard=seq_shard)
    heads = plan.decode_state_specs(base, model.cfg,
                                    num_kv_heads=model.cfg.num_kv_heads)
    pod = "pod" in mesh.mesh_dim_names

    def one(ref, port, leaf):
        if not isinstance(leaf, torch.Tensor):
            return Spec()
        # the positions of a sequence-sharded cache split over data alone
        # (``partitioning.cache_spec``; the reference's probe takes pod too)
        parts = [("data" if seq_shard and pod and p == ("pod", "data")
                  else p) if p not in (None, "model") else None
                 for p in ref]
        for i, p in enumerate(port):
            if p is not None:
                parts[i] = p
        return Spec(*parts)

    return _tree_map(one, specs, heads, base), base


def _degree(mesh) -> dict:
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def local_shape(shape, spec, degree: dict):
    """A tensor's block shape under ``spec`` on a mesh of ``degree``."""
    from repro_torch.sharding.partitioning import RowMap

    out = []
    for n, ax in zip(shape, list(spec) + [None] * len(shape)):
        if isinstance(ax, RowMap):
            out.append(ax.local_size(degree["model"]))
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                if n % degree[a]:
                    raise ValueError(f"dim of {n} does not split over "
                                     f"{a}={degree[a]}")
                n //= degree[a]
        out.append(n)
    return tuple(out)


def local_state(specs, whole, mesh):
    """The rank's decode state on the meta device: every tensor of
    ``whole`` at its block shape under ``specs``."""
    degree = _degree(mesh)

    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty(local_shape(leaf.shape, spec, degree),
                           dtype=leaf.dtype, device="meta")

    return _tree_map(one, specs, whole)


def local_blocks(specs, whole, mesh):
    """This rank's blocks of a whole decode state under ``specs``
    (:func:`local_state_specs`) on ``mesh`` (a DeviceMesh this rank is in),
    as tensors of their own."""
    from repro_torch.sharding.partitioning import spec_block

    names = mesh.mesh_dim_names
    coord = {n: mesh.get_local_rank(n) for n in names}
    degree = _degree(mesh)

    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return spec_block(leaf, spec, coord, degree).clone()

    return _tree_map(one, specs, whole)


def _local_rows(tree, dp: int):
    """Each tensor's leading rows of one dp rank (whole when the rows do
    not split), on the meta device."""
    def one(t):
        b = t.shape[0]
        rows = b // dp if b % dp == 0 else b
        return torch.empty((rows, *t.shape[1:]), dtype=t.dtype,
                           device="meta")

    return {k: one(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def lower_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               num_microbatches: int = 8, packed: bool = False,
               opt_override=None, arch_override: dict | None = None):
    """The census record of one cell (see the module docstring).  Raises
    what the port raises for a cell it does not run."""
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch import census
    from repro_torch.launch import specs as specs_mod
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.plan import ShardingPlan

    cfg = get_arch(arch_id)
    if arch_override:
        cfg = dataclasses.replace(cfg, **arch_override)
    shape = SHAPES[shape_name]
    mesh = make_census_mesh(multi_pod)
    seq_shard = shape.kind == "decode" and shape.global_batch == 1
    ctx = shctx.make_context(mesh, num_kv_heads=cfg.num_kv_heads,
                             num_heads=cfg.num_heads,
                             seq_shard_cache=seq_shard)
    tp, dp = ctx.tp, ctx.dp
    kv_repl = (cfg.num_kv_heads % tp != 0 and cfg.num_heads % tp == 0
               and shape.kind != "decode")
    model = specs_mod.meta_model(cfg)
    mem = {}

    if shape.kind == "train":
        from repro_torch.optim import adamw
        from repro_torch.train.train_loop import make_train_step, train_params

        opt_cfg = opt_override or adamw.AdamWConfig()
        plan = ShardingPlan(tp=tp, dp=dp)
        # placed on the census mesh first, so that the step finds its mesh
        # (train_loop.plan_mesh) and makes no process group
        plan.place_for_training(model, mesh)
        model.train_mesh = mesh
        step = make_train_step(model, opt_cfg,
                               num_microbatches=num_microbatches, plan=plan,
                               policy=ExecPolicy(mode="masked"))
        params = train_params(model)
        # the step counter is read on the host (the schedule): a CPU tensor
        opt = adamw.init(opt_cfg, params, layout=step.layout)._replace(
            step=torch.zeros((), dtype=torch.int32))
        batch = specs_mod.train_batch_specs(cfg, shape)
        rows = _local_rows(batch, dp)
        _, a, secs = census.run(
            step, params, opt, batch, 0, mesh=mesh,
            arguments=(params, opt, rows))
        mem["param_bytes"] = census.tree_bytes(params)
        mem["opt_bytes"] = census.tree_bytes(opt)
    elif shape.kind == "prefill":
        ShardingPlan(tp=tp, attn_kv_replicated=kv_repl).shard_params(
            model, mesh)
        batch = _local_rows(specs_mod.prefill_batch_specs(cfg, shape), dp)
        policy = ExecPolicy(mode="masked")

        def prefill_fn(batch):
            # the fresh state prefill returns is sized to one position: the
            # JAX package's program outputs the logits only, and drops it
            with shctx.use_mesh(ctx), torch.no_grad():
                logits, _ = model.prefill(batch, max_len=1, policy=policy)
            return logits

        _, a, secs = census.run(prefill_fn, batch, mesh=mesh,
                                arguments=(model, batch))
        mem["param_bytes"] = census.tree_bytes(model)
    else:
        plan = ShardingPlan(tp=tp)
        if packed:
            from repro_torch.launch.pack_tree import pack_tree_shapes
            pack_tree_shapes(model)
        plan.shard_params(model, mesh)
        specs, whole = local_state_specs(model, shape, mesh, plan,
                                         seq_shard=seq_shard)
        state = local_state(specs, whole, mesh)
        ref_specs, _ = decode_state_specs(model, shape, mesh,
                                          seq_shard=seq_shard)
        tokens = specs_mod.decode_token_specs(shape)
        if shape.global_batch % dp == 0:
            tokens = _local_rows({"t": tokens}, dp)["t"]
        policy = ExecPolicy(mode="packed" if packed else "dense")

        def decode_fn(state, tokens):
            with shctx.use_mesh(ctx), torch.no_grad():
                return model.decode_step(state, tokens, policy=policy)

        _, a, secs = census.run(decode_fn, state, tokens, mesh=mesh,
                                arguments=(model, state, tokens))
        mem["param_bytes"] = census.tree_bytes(model)
        mem["state_bytes"] = census.tree_bytes(state)
        mem["state_bytes_reference_specs"] = census.tree_bytes(
            local_state(ref_specs, whole, mesh))
    return record(cfg, arch_id, shape_name, shape, a, secs, mem,
                  multi_pod=multi_pod, packed=packed,
                  num_microbatches=num_microbatches,
                  arch_override=arch_override)


def record(cfg, arch_id, shape_name, shape, a, secs, mem, *, multi_pod,
           packed, num_microbatches, arch_override=None) -> dict:
    """The JSON record of a census :class:`~repro_torch.launch.census.
    Analysis` ``a`` (the JAX package's keys, H100 roofs)."""
    coll = a.to_dict()["collectives"]
    flops = float(a.flops)
    bytes_acc = float(a.bytes_accessed)
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": bytes_acc / HBM_BW,
             "collective_s": coll["total_bytes"] / LINK_BW}
    dominant = max(terms, key=terms.get)
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "arch_override": arch_override or {},
        "num_microbatches": num_microbatches,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "kind": shape.kind,
        "packed": packed,
        "census_s": round(secs, 3),
        "memory_analysis": {
            "argument_bytes": int(a.argument_bytes),
            "output_bytes": int(a.output_bytes),
            "temp_bytes": int(a.peak_live_bytes),
            "peak_bytes": int(a.peak_bytes),
            **mem,
        },
        "cost_analysis": {"flops": flops, "bytes_accessed": bytes_acc,
                          "matmul_flops": float(a.matmul_flops),
                          "ops": a.ops,
                          "packed_launches": dict(a.packed_launches),
                          "unknown_trip_loops": a.unknown_trip_loops},
        "collectives": coll,
        "collectives_by_name": a.collectives_by_name,
        "collectives_by_site": a.collectives_by_site,
        "roofline": dict(terms, dominant=dominant),
        "roof": ROOF,
        "model_flops": _model_flops(cfg, shape),
    }
    rec["useful_flops_ratio"] = (
        rec["model_flops"] / (flops * _n_chips(multi_pod)) if flops else 0.0)
    return rec


def _n_chips(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per step; decode
    processes global_batch tokens, train/prefill global_batch x seq
    (2·N·D outside training)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * tokens)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="decode cells: DeMM packed weights (xwT)")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in applicable_shapes(get_arch(a)):
                cells.append((a, s, False))
                cells.append((a, s, True))
    else:
        cells.append((args.arch, args.shape, args.multi_pod))

    sink = open(args.out, "a") if args.out else sys.stdout
    for arch, shape, mp in cells:
        try:
            rec = lower_cell(arch, shape, multi_pod=mp, packed=args.packed,
                             num_microbatches=args.microbatches)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": arch, "shape": shape,
                   "mesh": "pod2x16x16" if mp else "pod16x16",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), file=sink, flush=True)
    if args.out:
        sink.close()
    # error cells are recorded in the JSONL; exit 0, so that a script
    # looping over cells records each one once
    return 0


if __name__ == "__main__":
    sys.exit(main())
