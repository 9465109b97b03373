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
# a port-only leg: one KV head (it does not split over 2 ranks), k / v
# gathered or wk / wv replicated
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
    # one KV head: served with k / v gathered (the head fallback) and with
    # wk / wv replicated; the port's own seeded init on both ranks, held to
    # its tp=1 stream
    kv1 = torch_cfg(**KV1)
    base = run_serve(build_model(kv1, device="cpu", seed=1), kv1.vocab_size,
                     backend="reference", device="cpu", packed=True,
                     metrics=obs.MetricsRegistry(), **RUN)
    out["kv1_tp1"] = streams(base)
    eng = run_serve(build_model(kv1, device="cpu", seed=1), kv1.vocab_size,
                    backend="reference", device="cpu", packed=True, plan=tp2,
                    metrics=obs.MetricsRegistry(), **RUN)
    out["kv1_fallback"] = streams(eng)
    out["kv1_fallback_cache"] = tuple(eng.state["caches"]["k"].shape)
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


# ---------------------------------------------------------------------------
# distributed training: one four-rank world, tp 2 x dp 2
# ---------------------------------------------------------------------------

STEP_KW = dict(lr=1e-3, total_steps=10, warmup_steps=1)
TRAIN_BATCH = (8, 16)            # the reference's test: global batch 8 x 16
TRAIN_STEPS = 3
# the names of the compression leg's gradients: one split over tp (rows),
# one whole on every rank
COMP_NAMES = ("layers.0.mlp.gate.w", "layers.0.ln1.scale")
# the reference's MoE test: 8 experts top-2, d_ff 32, d 64, x (4, 8, 64)
MOE_EP = dict(num_experts=8, experts_per_token=2, d_ff_expert=32)
MOE_D, MOE_X, MOE_CAPACITY = 64, (4, 8, 64), 64
# the reference's pipeline test at 4 stages: 4 microbatches of 2 x 16
PIPE = dict(num_mb=4, mb=2, d=16)


def train_batches(vocab, n=TRAIN_STEPS, shape=TRAIN_BATCH):
    """The steps' global batches, made with numpy from the step's index."""
    import numpy as np

    out = []
    for i in range(n):
        rng = np.random.default_rng(i)
        out.append({"tokens": rng.integers(0, vocab, shape, dtype=np.int32),
                    "targets": rng.integers(0, vocab, shape,
                                            dtype=np.int32)})
    return out


def run_steps(model, vocab, *, plan=None, microbatches=2, compression=None,
              first=0, steps=TRAIN_STEPS, opt_state=None, mode="masked"):
    """``steps`` masked train steps of ``model`` (batches ``first`` on) under
    ``plan`` (None: one rank).  Returns (per-step [loss, grad_norm, aux],
    params, opt state, the step)."""
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step, train_params

    opt_cfg = adamw.AdamWConfig(**STEP_KW, compression=compression)
    step = make_train_step(model, opt_cfg, num_microbatches=microbatches,
                           plan=plan, policy=ExecPolicy(mode=mode))
    params = train_params(model)
    fresh = adamw.init(opt_cfg, params, layout=step.layout)
    opt = fresh if opt_state is None else opt_state._replace(
        compression=fresh.compression)
    metrics = []
    for i, b in enumerate(train_batches(vocab, first + steps)[first:]):
        params, opt, m = step(params, opt, b, first + i)
        metrics.append([float(m["loss"]), float(m["grad_norm"]),
                        float(m["aux"])])
    return metrics, params, opt, step


def _np(d):
    """Copies as numpy (a CPU tensor's ``numpy()`` shares its storage,
    which later steps update in place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def train_legs(rank, nprocs, init, args):
    """Every leg of the distributed-training tests on this rank (see
    ``test_torch_dist_train.py``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import from_jax_params
    from repro_torch.models.families import build_model
    from repro_torch.optim import compression as comp
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.sharding.world import init_world
    from repro_torch.train import checkpoint as ckpt

    torch.set_num_threads(1)
    world = init_world("cpu", rank=rank, world_size=nprocs, init_method=init)
    cfg = torch_cfg()
    plan = ShardingPlan(tp=2, dp=2)
    out = {"rank": world.rank}

    # the masked step, then one int8 and one topk step, the state saved
    model = from_jax_params(args["tree"], cfg, device="cpu")
    before = sum(t.nbytes for t in model.parameters())
    metrics, params, opt, step = run_steps(model, cfg.vocab_size, plan=plan)
    lay, ctx = step.layout, step.context
    out["coords"] = (ctx.dp_rank, ctx.tp_rank)
    out["metrics"] = metrics
    out["tp_block_bytes"] = sum(t.nbytes for t in params.values())
    out["model_bytes"] = before
    out["moment_bytes"] = sum(t.nbytes for t in opt.m.values())
    out["zero_dims"] = dict(lay.zero_dim)
    out["split"] = {n: lay.split(n) for n in params}
    out["collectives_per_step"] = ctx.collectives / TRAIN_STEPS
    state = {"params": params, "opt": opt}
    ckpt.save(state, args["ckpt_dir"], TRAIN_STEPS, plan=plan, layout=lay)
    whole = lay.whole_tree(state)            # on rank 0
    if world.rank == 0:
        out["whole_params"] = _np(whole["params"])
        out["whole_m"] = _np(whole["opt"].m)
    for scheme, first in (("int8", TRAIN_STEPS), ("topk", TRAIN_STEPS + 1)):
        m, params, opt, _ = run_steps(model, cfg.vocab_size, plan=plan,
                                      compression=scheme, first=first,
                                      steps=1, opt_state=opt)
        out[f"{scheme}_metrics"] = m
        whole = lay.whole_tree({"params": params})["params"]
        if world.rank == 0:
            out[f"{scheme}_params"] = _np(whole)

    # compression of a whole and of a tp-split tensor, bit for bit
    grads = {}
    for n in COMP_NAMES:
        g = torch.tensor(args["comp"][n])
        if lay.split(n):
            d = lay.placement[n][0]
            k = g.shape[d] // 2
            g = g.narrow(d, ctx.tp_rank * k, k)
        grads[n] = g.clone()
    sent, resid = comp.topk_with_error_feedback(grads, None, 0.05,
                                                layout=lay)
    rt = comp.int8_roundtrip(grads, layout=lay)
    out["comp"] = {"topk": _np({n: lay.whole(n, t) for n, t in sent.items()}),
                   "resid": _np({n: lay.whole(n, t)
                                 for n, t in resid.items()}),
                   "int8": _np({n: lay.whole(n, t) for n, t in rt.items()})}

    # the state restored under tp 2 on the first two ranks (a smaller mesh)
    small = ShardingPlan(tp=2)
    mesh = small.make_mesh()
    if mesh.get_coordinate() is not None:
        from repro_torch.optim import adamw
        from repro_torch.train.fault_tolerance import elastic_restore
        from repro_torch.train.train_loop import train_params

        m2 = from_jax_params(args["tree"], cfg, device="cpu")
        lay2 = small.place_for_training(m2, mesh)
        p2 = train_params(m2)
        template = {"params": p2, "opt": adamw.init(
            adamw.AdamWConfig(**STEP_KW), p2, layout=lay2)}
        got = elastic_restore(template, args["ckpt_dir"], TRAIN_STEPS, mesh,
                              lay2.state_specs(template))
        out["restored"] = {"params": _np(got["params"]),
                           "m": _np(got["opt"].m),
                           "split": {n: lay2.placement.get(n)
                                     for n in p2}}
    dist.barrier()

    # the packed fine-tuning step's gradients at the packed values
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step, train_params

    pm = pack_tree(from_jax_params(args["tree"], cfg, device="cpu"))
    pstep = make_train_step(pm, adamw.AdamWConfig(**STEP_KW),
                            num_microbatches=2, plan=plan,
                            policy=_packed_policy())
    loss, _, g = pstep.grads(train_params(pm), train_batches(
        cfg.vocab_size, 1)[0])
    out["packed"] = {"loss": float(loss), "grads": _np(
        {n: t for n, t in g.items() if n.endswith("values")}),
        "placement": {n: pstep.layout.placement.get(n) for n in g}}

    # one packed step, its state saved and restored under tp 2 on the
    # first two ranks: the shard stacks come back at their slices' shapes
    play = pstep.layout
    pparams = train_params(pm)
    popt = adamw.init(adamw.AdamWConfig(**STEP_KW), pparams, layout=play)
    pparams, popt, _ = pstep(pparams, popt, train_batches(
        cfg.vocab_size, 1)[0], 0)
    pck = args["ckpt_dir"] + "_packed"
    ckpt.save({"params": pparams, "opt": popt}, pck, 1, plan=plan,
              layout=play)
    out["packed_state"] = {
        "params": _np(pparams), "m": _np(popt.m),
        "zero_dims": dict(play.zero_dim),
        "stacks": [n for n in pparams
                   if play.split(n) and play.placement[n][1]]}
    if mesh.get_coordinate() is not None:
        from repro_torch.train.fault_tolerance import elastic_restore

        pm2 = pack_tree(from_jax_params(args["tree"], cfg, device="cpu"))
        lay2 = small.place_for_training(pm2, mesh)
        p2 = train_params(pm2)
        template = {"params": p2, "opt": adamw.init(
            adamw.AdamWConfig(**STEP_KW), p2, layout=lay2)}
        got = elastic_restore(template, pck, 1, mesh,
                              lay2.state_specs(template))
        out["packed_restored"] = {
            "params": _np(got["params"]), "m": _np(got["opt"].m),
            "v": _np(got["opt"].v),
            "template": {n: tuple(t.shape) for n, t in p2.items()}}
    dist.barrier()

    # a MoE model's step, expert parallel (its experts split over tp)
    mcfg = torch_cfg_of("olmoe_1b_7b")
    moe_model = build_model(mcfg, device="cpu", seed=0)
    m, _, _, mstep = run_steps(moe_model, mcfg.vocab_size, plan=plan)
    out["moe_metrics"] = m
    out["moe_experts"] = tuple(moe_model.layers[0].moe.w_gate.shape)
    out["moe_leg"] = moe_ep_leg(mstep.context, args["moe"])

    out["pipeline"] = pipeline_leg(args["pipe"])
    x = torch.tensor(args["psum_x"][world.rank])
    out["psum"] = comp.compressed_psum_int8(x).numpy()
    out["meshes"] = mesh_leg()
    out["whole_groups"] = whole_groups_leg()
    out["seq_shard"] = seq_shard_leg(args["tree"])
    out["census"] = census_collectives_leg(args["tree"])
    return out


def _packed_policy():
    from repro_torch.core.sparse_linear import ExecPolicy
    return ExecPolicy(mode="packed")


def torch_cfg_of(arch):
    from repro_torch.configs.base import get_arch
    return dataclasses.replace(get_arch(arch).reduced(),
                               compute_dtype="float32")


def moe_module(tree):
    """The port's MoE module of the reference's ``init_moe`` tree."""
    import torch

    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.models.moe import MoE

    return MoE(SparseLinear(torch.tensor(tree["router"]["w"])),
               *(torch.tensor(tree[k]) for k in ("w_gate", "w_up",
                                                  "w_down")))


def moe_grads(moe, x, cfg, *, capacity, cot, ctx=None):
    """(y, gradients of sum(y * cot) at the router, the experts and x)
    through ``apply_moe``: the expert-parallel path under ``ctx``, else the
    local one."""
    import contextlib

    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.context import use_mesh

    named = {"router.w": moe.router.w, "w_gate": moe.w_gate,
             "w_up": moe.w_up, "w_down": moe.w_down}
    for t in named.values():
        t.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    with (use_mesh(ctx) if ctx is not None else contextlib.nullcontext()):
        y, _ = moe_mod.apply_moe(moe, x, cfg, capacity=capacity)
    got = torch.autograd.grad((y * cot).sum(), [*named.values(), x])
    return y.detach(), dict(zip([*named, "x"], got))


def moe_ep_leg(ctx, args):
    """The reference's MoE test on this rank: its experts' block of the
    reference's weights, its dp shard's rows of x, through the
    expert-parallel path; the parameters' gradients summed over dp (the
    loss is the sum over every token)."""
    import torch

    from repro_torch.configs.base import MoEConfig

    cfg = MoEConfig(**MOE_EP)
    moe = moe_module(args["tree"])
    e_loc = cfg.num_experts // ctx.tp
    with torch.no_grad():
        for k in ("w_gate", "w_up", "w_down"):
            w = getattr(moe, k)
            setattr(moe, k, torch.nn.Parameter(
                w[ctx.tp_rank * e_loc:(ctx.tp_rank + 1) * e_loc].clone(),
                requires_grad=False))
    rows = slice(ctx.dp_rank * 2, ctx.dp_rank * 2 + 2)
    x = torch.tensor(args["x"])[rows]
    cot = torch.tensor(args["cot"])[rows]
    y, g = moe_grads(moe, x, cfg, capacity=MOE_CAPACITY, cot=cot, ctx=ctx)
    for n in ("router.w", "w_gate", "w_up", "w_down"):
        ctx.dp_mean_(g[n]).mul_(ctx.dp)
    return {"rows": (rows.start, rows.stop), "experts": (
        ctx.tp_rank * e_loc, (ctx.tp_rank + 1) * e_loc), "y": y.numpy(),
        **{k: v.numpy() for k, v in g.items()}}


def pipeline_leg(args):
    """``pipeline_apply`` over the four ranks as four stages (a ``pipe``
    dim of 4): the outputs on this rank, and the gradients of sum(y * cot)
    at this stage's weight and at x."""
    import torch

    from repro_torch.sharding.pipeline import pipeline_apply
    from repro_torch.sharding.plan import ShardingPlan

    plan = ShardingPlan(pp=4)
    ctx = plan.context(plan.make_mesh())
    w = torch.tensor(args["w"][ctx.pp_rank]).requires_grad_(True)
    x = torch.tensor(args["x"]).requires_grad_(True)

    def stage_fn(p, xm):
        return torch.tanh(xm @ p["w"])

    y = pipeline_apply(stage_fn, {"w": w}, x, ctx)
    gw, gx = torch.autograd.grad((y * torch.tensor(args["cot"])).sum(),
                                 [w, x])
    return {"stage": ctx.pp_rank, "y": y.detach().numpy(),
            "gw": gw.numpy(), "gx": gx.numpy()}


def mesh_leg():
    """``launch.mesh`` in a world of four ranks: the 2 x 2 test mesh, and
    the production mesh refused (it needs 256)."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
           "coord": tuple(mesh.get_coordinate())}
    try:
        make_production_mesh()
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    return out


def whole_groups_leg():
    """A row-parallel masked linear whose block would not hold whole
    groups (K = 64 over tp 2 at M = 64): placing it raises, by name."""
    import torch
    from torch import nn

    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.sharding.plan import ShardingPlan

    plan = ShardingPlan(tp=2, dp=2)
    holder = nn.Module()
    holder.mlp = nn.Module()
    holder.mlp.down = SparseLinear(torch.ones(8, 64), SparsityConfig(8, 64))
    try:
        plan.shard_params(holder, plan.make_mesh())
        return None
    except ValueError as e:
        return str(e)


# ---------------------------------------------------------------------------
# every family served under tp 2: one two-rank world
# ---------------------------------------------------------------------------

FAMILY_RUN = dict(requests=3, slots=2, max_new=5, max_len=24, seed=3)
FAMILY_PAGED_RUN = dict(FAMILY_RUN, requests=4, max_len=48, paged=True,
                        page_size=8, prefill_chunk=16)
# leg -> (arch, config overrides, run_serve keywords); every leg float32,
# backend reference, packed.  ``no_drop``: the experts get room for every
# token (capacity factor E / k).  gemma3 past its 8-slot rings (positions
# up to 15 in a 24-long run); its one KV head and the kv1 leg's are case 2
# of the head fallback, heads3 (3 query heads, 1 KV head) case 3.  The spec
# legs pack at 8:16 (4:8 at d_model 128) and draft at 3:8.
FAMILY_LEGS = {
    "moe": ("olmoe_1b_7b", {"no_drop": True}, {}),
    "hybrid": ("zamba2_7b", {}, dict(layout="block")),
    "xlstm": ("xlstm_125m", {}, dict(quantize="int8")),
    "vision": ("internvl2_1b", {}, {}),
    "encdec": ("seamless_m4t_medium", {}, {}),
    "encdec_paged": ("seamless_m4t_medium", {}, FAMILY_PAGED_RUN),
    "local_global": ("gemma3_1b", {"local_window": 8}, dict(layout="block")),
    "swa": ("h2o_danube_1_8b", {"window": 8}, {}),
    "kv1": ("stablelm_3b", {"num_kv_heads": 1}, dict(quantize="int8")),
    "heads3": ("stablelm_3b", {"num_heads": 3, "num_kv_heads": 1}, {}),
    "spec": ("stablelm_3b", {"sparsity": (8, 16, 1)}, {}),
    "spec_paged": ("stablelm_3b", {"sparsity": (8, 16, 1)},
                   FAMILY_PAGED_RUN),
}
SPEC_DRAFT = dict(spec_draft="3:8", spec_gamma=3)
# the legs whose model prefills a batch with a frontend's inputs under the
# engine's context (the vision stub's patch_proj, the encoder's frame_proj)
PREFILL_LEGS = ("vision", "encdec")


def family_leg_cfg(leg, cfg):
    """``cfg`` (either package's reduced ``arch`` config) with the leg's
    overrides, in float32 compute."""
    _, over, _ = FAMILY_LEGS[leg]
    over = dict(over, compute_dtype="float32")
    if over.pop("no_drop", False):
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts
            / cfg.moe.experts_per_token)
    if "sparsity" in over:
        over["sparsity"] = type(cfg.sparsity)(*over["sparsity"])
    return dataclasses.replace(cfg, **over)


def family_run(leg):
    """The leg's ``run_serve`` keywords (packed, without the spec draft)."""
    return {**FAMILY_RUN, "packed": True, **FAMILY_LEGS[leg][2]}


def family_legs(rank, nprocs, init, trees, batches):
    """Every leg of ``test_torch_dist_serve_families.py`` on this rank:
    the JAX package's weights of each leg (``trees``) served under
    ``ShardingPlan(tp=2)``; the token streams, the bytes this rank holds
    against the whole model's, and per leg what it exercises."""
    import torch

    from repro_torch import obs
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import from_jax_params
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.launch.serve import run_serve
    from repro_torch.sharding.context import use_mesh
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.sharding.world import init_world

    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world_size=nprocs, init_method=init)
    tp2 = ShardingPlan(tp=2)
    out = {"rank": rank}
    for leg, tree in trees.items():
        arch = FAMILY_LEGS[leg][0]
        cfg = family_leg_cfg(leg, get_arch(arch).reduced())
        spec = SPEC_DRAFT if leg.startswith("spec") else {}
        runs = [("plain", {})] + ([("spec", spec)] if spec else [])
        run = family_run(leg)
        # what one rank holds of the packed model
        whole = model_bytes(pack_tree(
            from_jax_params(tree, cfg, device="cpu"),
            layout=run.get("layout", "xwT"), quantize=run.get("quantize")))
        for tag, extra in runs:
            model = from_jax_params(tree, cfg, device="cpu")
            eng = run_serve(model, cfg.vocab_size, backend="reference",
                            device="cpu", plan=tp2,
                            metrics=obs.MetricsRegistry(), **run, **extra)
            key = leg if tag == "plain" else f"{leg}_spec"
            out[key] = streams(eng)
            out[f"{key}_bytes"] = (model_bytes(eng.model), whole)
        if spec:
            out[f"{leg}_draft"] = draft_views(eng)
        if leg in batches:
            batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                     else torch.from_numpy(v)
                     for k, v in batches[leg].items()}
            with use_mesh(eng._shctx), torch.inference_mode():
                logits, _ = eng.model.prefill(batch, policy=ExecPolicy(
                    mode="packed", backend="reference"))
            out[f"{leg}_prefill"] = logits.numpy()
        out[f"{leg}_state"] = state_held(eng.state)
        out[f"{leg}_gathered"] = sorted(
            n for n, m in eng.model.named_modules()
            if getattr(m, "tp_gather", False))
    return out


def model_bytes(model) -> int:
    """Bytes of every tensor ``model`` holds (parameters and buffers,
    packed nodes included)."""
    return sum(t.nbytes for t in list(model.parameters())
               + list(model.buffers()))


def state_held(state, prefix=""):
    """{path: shape} of every tensor of a decode state."""
    import torch
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(state_held(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = tuple(v.shape)
    return out


def draft_views(engine):
    """What a speculative engine's draft model reads: for every narrowed
    packed node, whether its values and indices are the placed full
    node's tensors (the rank's slice, read in place) and the bytes of that
    slice; and the narrowed nodes that carry their placement."""
    full = dict(engine.model.named_modules())
    shared, placed, nbytes, narrowed = 0, 0, 0, 0
    for name, d in engine.draft_model.named_modules():
        if getattr(d, "tier_ne", None) is None:
            continue
        f = full[name]
        narrowed += 1
        shared += d.values is f.values and d.indices is f.indices
        placed += (getattr(d, "tp_kind", None) == f.tp_kind
                   and d.tp_sharded == f.tp_sharded)
        nbytes += f.values.nbytes + f.indices.nbytes
    return {"narrowed": narrowed, "shared": shared, "placed": placed,
            "slice_bytes": nbytes}


# the sequence-sharded decode leg: batch 1, a cache of SEQ_LEN positions
# split over data = 2, SEQ_STEPS greedy steps from token 1 (positions on
# both ranks' blocks)
SEQ_LEN, SEQ_STEPS = 16, 12


def _greedy(model, state, steps, ctx=None):
    """``steps`` greedy dense decode steps of batch 1 from token 1 under
    ``ctx`` (None: one rank): (tokens, logits of every step)."""
    import contextlib

    import torch

    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.sharding.context import use_mesh

    tok = torch.ones((1, 1), dtype=torch.int64)
    tokens, logits = [], []
    with torch.no_grad(), (use_mesh(ctx) if ctx is not None
                           else contextlib.nullcontext()):
        for _ in range(steps):
            lg, state = model.decode_step(state, tok,
                                          policy=ExecPolicy(mode="dense"))
            logits.append(lg[0, 0].clone())
            tok = lg[:, -1:].argmax(-1)
            tokens.append(int(tok))
    return tokens, torch.stack(logits)


def seq_shard_leg(tree):
    """Reduced stablelm_3b decodes batch 1 with its cache split by
    position over data = 2 (and its heads over model = 2): tokens and
    logits against one rank's whole-cache decode, and the positions this
    rank's cache block holds."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import dryrun
    from repro_torch.sharding.context import make_context
    from repro_torch.sharding.plan import ShardingPlan

    cfg = torch_cfg()
    whole = from_jax_params(tree, cfg, device="cpu")
    want_tokens, want_logits = _greedy(
        whole, whole.init_decode_state(1, SEQ_LEN, dtype=torch.float32),
        SEQ_STEPS)
    plan = ShardingPlan(tp=2, dp=2)
    mesh = plan.make_mesh()
    model = from_jax_params(tree, cfg, device="cpu")
    ShardingPlan(tp=2).shard_params(model, mesh)
    ctx = make_context(mesh, num_kv_heads=cfg.num_kv_heads,
                       num_heads=cfg.num_heads, seq_shard_cache=True)
    shape = ShapeConfig("long", SEQ_LEN, 1, "decode")
    specs, _ = dryrun.local_state_specs(model, shape, mesh, plan,
                                        seq_shard=True)
    state = dryrun.local_blocks(
        specs, model.init_decode_state(1, SEQ_LEN, dtype=torch.float32),
        mesh)
    tokens, logits = _greedy(model, state, SEQ_STEPS, ctx)
    written = (state["caches"]["k"][0, 0].abs().sum((-1, -2)) > 0)
    return {"tokens": tokens, "want_tokens": want_tokens,
            "logits_gap": float((logits - want_logits).abs().max()),
            "k_block": tuple(state["caches"]["k"].shape),
            "written": [ctx.dp_rank * SEQ_LEN // 2 + i
                        for i in written.nonzero()[:, 0].tolist()],
            "collectives": ctx.collectives}


def census_collectives_leg(tree):
    """One dense decode step of reduced stablelm_3b under ShardingPlan(tp=2)
    on the first two ranks: what the real context counted (collectives,
    payload bytes) and what the census recorded for the same step on a
    census mesh of the same shape (None off the mesh)."""
    import torch

    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import census
    from repro_torch.launch.specs import meta_model
    from repro_torch.sharding.context import (CensusMesh, make_context,
                                              use_mesh)
    from repro_torch.sharding.plan import ShardingPlan

    cfg = torch_cfg()
    plan = ShardingPlan(tp=2)
    mesh = plan.make_mesh()
    if mesh.get_coordinate() is None:
        return None
    policy = ExecPolicy(mode="dense")
    kw = dict(num_kv_heads=cfg.num_kv_heads, num_heads=cfg.num_heads)

    def one_step(model, mesh, device):
        plan.shard_params(model, mesh)
        ctx = make_context(mesh, **kw)
        state = plan.shard_decode_state(
            lambda device: model.init_decode_state(3, 8, device=device),
            device, mesh, num_kv_heads=cfg.num_kv_heads)
        tokens = torch.ones((3, 1), dtype=torch.int64, device=device)

        def step(state, tokens):
            with torch.no_grad(), use_mesh(ctx):
                return model.decode_step(state, tokens, policy=policy)

        return ctx, step, state, tokens

    ctx, step, state, tokens = one_step(
        from_jax_params(tree, cfg, device="cpu"), mesh, "cpu")
    step(state, tokens)
    cmesh = CensusMesh((2,), ("model",))
    cctx, cstep, cstate, ctokens = one_step(meta_model(cfg), cmesh, "meta")
    _, a, _ = census.run(cstep, cstate, ctokens, mesh=cmesh)
    return {"real": (ctx.collectives, ctx.collective_bytes),
            "census_context": (cctx.collectives, cctx.collective_bytes),
            "census": (a.collectives["all-reduce"]["count"],
                       sum(rec[1] for rec in cmesh.records)),
            "census_ring_bytes": a.collectives["all-reduce"]["bytes"],
            "names": sorted({rec[2] for rec in cmesh.records})}
