"""What each rank of the multi-rank CPU tests runs (imports the port only:
the ranks never import jax; the JAX package's tokens come from the parent).

Every leg serves the reduced stablelm_3b in float32 compute from the same
weights (the JAX package's, converted in the rank), backend ``reference``,
under a plan over the two-rank ``gloo`` world, and reports the token
streams and what the rank holds."""

import dataclasses
import os

RUN = dict(requests=3, slots=4, max_new=6, max_len=32, seed=0)
PP_RUN = dict(RUN, requests=4)
PAGED_RUN = dict(requests=4, slots=4, max_new=8, max_len=64, seed=0,
                 paged=True, page_size=8, max_pages=8, scheduler="priority")
# a port-only leg: one KV head (it does not split over 2 ranks), wk / wv
# replicated
KV1 = dict(num_kv_heads=1)


def torch_cfg(**over):
    from repro_torch.configs.base import get_arch
    return dataclasses.replace(get_arch("stablelm_3b").reduced(),
                               compute_dtype="float32", **over)


def streams(engine):
    return {r.uid: list(r.output) for r in engine.completed}


def placed_bytes(model):
    """{module name: (tp_kind, bytes this rank holds)} of every placed
    packed linear."""
    from repro_torch.core.sparsity import PackedWeight
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, PackedWeight) and hasattr(mod, "tp_kind"):
            out[name] = (mod.tp_kind, mod.tp_sharded, sum(
                t.nbytes for t in (mod.values, mod.indices,
                                   mod.active_groups, mod.scales)
                if t is not None))
    return out


def serve_legs(rank, nprocs, init, tree):
    import torch

    from repro_torch import obs
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.serve import run_serve
    from repro_torch.models.families import build_model
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.sharding.world import init_world

    torch.set_num_threads(1)
    world = init_world("cpu", rank=rank, world_size=nprocs, init_method=init)
    cfg = torch_cfg()

    def serve(run, plan, model=None, **kw):
        model = model if model is not None else from_jax_params(
            tree, cfg, device="cpu")
        eng = run_serve(model, cfg.vocab_size, backend="reference",
                        device="cpu", plan=plan,
                        metrics=obs.MetricsRegistry(), **run, **kw)
        return eng

    out = {"backend": world.backend, "rank": world.rank}
    tp2 = ShardingPlan(tp=2)
    for layout in ("xwT", "block"):
        eng = serve(RUN, tp2, packed=True, layout=layout)
        out[f"tp2_{layout}"] = streams(eng)
        out[f"tp2_{layout}_bytes"] = placed_bytes(eng.model)
        out[f"tp2_{layout}_labels"] = eng._trace_labels()
        out[f"tp2_{layout}_eager"] = [
            g["value"] for g in eng.metrics.snapshot(meta=False)["gauges"]
            if g["name"] == "serve_step_eager"]
    eng = serve(RUN, ShardingPlan(tp=2, attn_kv_replicated=True),
                packed=True, layout="xwT")
    out["tp2_kv_replicated"] = streams(eng)
    out["tp2_masked"] = streams(serve(RUN, tp2, packed=False))
    out["sharded_matmul"] = sharded_matmul_leg(eng)
    eng, out["pp2_state_devices"] = spy_state_devices(
        lambda: serve(PP_RUN, ShardingPlan(pp=2), packed=True, layout="xwT"))
    out["pp2"] = streams(eng)
    out["pp2_layers"] = sum(type(m).__name__ == "TBlock"
                            for m in eng.model.layers)
    out["pp2_cache_layers"] = eng.state["caches"]["k"].shape[0]
    eng, out["paged_tp2_state_devices"] = spy_state_devices(
        lambda: serve(PAGED_RUN, tp2, packed=True, layout="block"))
    out["paged_tp2"] = streams(eng)
    out["paged_tp2_preempts"] = sum(
        c["value"] for c in eng.metrics.snapshot(meta=False)["counters"]
        if c["name"] == "serve_preempt_total")
    out["paged_tp2_arena"] = tuple(eng.state["caches"]["k"].shape)
    # one KV head: refused without attn_kv_replicated, served with it; the
    # port's own seeded init on both ranks, held to its tp=1 stream
    kv1 = torch_cfg(**KV1)
    base = run_serve(build_model(kv1, device="cpu", seed=1), kv1.vocab_size,
                     backend="reference", device="cpu", packed=True,
                     metrics=obs.MetricsRegistry(), **RUN)
    out["kv1_tp1"] = streams(base)
    try:
        run_serve(build_model(kv1, device="cpu", seed=1), kv1.vocab_size,
                  backend="reference", device="cpu", packed=True, plan=tp2,
                  metrics=obs.MetricsRegistry(), **RUN)
        out["kv1_refused"] = None
    except NotImplementedError as e:
        out["kv1_refused"] = str(e)
    eng = run_serve(build_model(kv1, device="cpu", seed=1), kv1.vocab_size,
                    backend="reference", device="cpu", packed=True,
                    plan=ShardingPlan(tp=2, attn_kv_replicated=True),
                    metrics=obs.MetricsRegistry(), **RUN)
    out["kv1_tp2"] = streams(eng)
    out["build_count"] = build_once_leg(rank, os.path.dirname(
        init[len("file://"):]))
    return out


def sharded_matmul_leg(engine):
    """A row-parallel packed linear on the engine's path: a whole weight
    placed by ``ShardingPlan.shard_params`` on the engine's mesh (this rank
    keeps its renumbered slice) and applied by ``sparse_linear.apply``
    under the engine's tp context to x's chunk of the contraction dim (the
    partial products summed over the group), and the whole renumbered
    weight's meshless sequential sum (``ops._demm_matmul_sharded``): the
    largest difference of each from the unsharded product, and what the
    placed node holds."""
    import copy

    import numpy as np
    import torch
    from torch import nn

    from repro_torch.core.sparse_linear import apply
    from repro_torch.core.sparsity import (PackedWeight,
                                           shard_packed_row_parallel)
    from repro_torch.kernels import ops
    from repro_torch.sharding.context import use_mesh

    rng = np.random.default_rng(5)
    w = torch.tensor(rng.standard_normal((24, 64)), dtype=torch.float32)
    pw = PackedWeight.from_dense(w, torch_cfg().sparsity)
    x = torch.tensor(rng.standard_normal((3, 64)), dtype=torch.float32)
    whole = ops.demm_matmul_packed(x, pw)
    out = {"meshless": float((ops._demm_matmul_sharded(
        x, shard_packed_row_parallel(pw, 2)) - whole).abs().max())}
    holder = nn.Module()
    holder.mlp = nn.Module()
    holder.mlp.down = copy.deepcopy(pw)
    engine.plan.shard_params(holder, engine.mesh)
    node, ctx = holder.mlp.down, engine._shctx
    out["placed"] = (node.tp_kind, node.tp_sharded, node.shard_axis,
                     node.shards, tuple(node.values.shape))
    with use_mesh(ctx):
        chunk = x[:, ctx.tp_rank * 32:(ctx.tp_rank + 1) * 32]
        out["group"] = float((apply(node, chunk) - whole).abs().max())
    return out


def spy_state_devices(build):
    """``build()`` with every ``DecoderLM.init_decode_state`` call's device
    recorded: (its result, the devices)."""
    from repro_torch.models.transformer import DecoderLM

    seen = []
    orig = DecoderLM.init_decode_state

    def spy(self, *a, **k):
        seen.append(str(k.get("device")))
        return orig(self, *a, **k)

    DecoderLM.init_decode_state = spy
    try:
        return build(), seen
    finally:
        DecoderLM.init_decode_state = orig


def build_once_leg(rank, workdir):
    """``_build.load_library_once`` with ``load_library`` stubbed: a
    "build" takes a while and leaves a file; a rank finding the file loads
    it.  Returns the builds this rank made."""
    import time

    import torch.distributed as dist

    from repro_torch.kernels import _build

    marker = os.path.join(workdir, "libstub.so")
    made = []

    def stub():
        if not os.path.exists(marker):
            time.sleep(0.5)              # long enough to race without a wait
            made.append(rank)
            with open(marker + f".{rank}", "w") as f:
                f.write("built")
            os.replace(marker + f".{rank}", marker)
        return marker

    real = _build.load_library
    _build.load_library = stub
    try:
        _build.load_library_once()
    finally:
        _build.load_library = real
    dist.barrier()
    return len(made)
