"""The training step: premasking, microbatches, straight-through gradients and
AdamW.

``make_train_step(model, opt_cfg, num_microbatches=...)`` builds
``train_step(params, opt_state, batch, step, masks=None)``:

  * ``params`` is a dict of named float tensors (:func:`train_params`: the
    module tree's parameters and float buffers, e.g. a packed weight's float
    values, under their dotted names);
  * the N:M masks are applied **once per step at one site**, and the model
    runs on the masked tensors through ``torch.func.functional_call`` in
    ``dense`` mode; the loss is differentiated at the masked (and
    fake-quantized) tensors and that gradient is the dense parameters' —
    straight through, as the JAX package's step takes it;
  * the batch is split into ``num_microbatches`` chunks whose float32
    gradients are summed and divided by their number (this bounds activation
    memory, as the JAX package's scan does);
  * the loss is the model's ``train_loss``; AdamW (``optim.adamw``) updates
    the parameters and moments **in place** and returns them.

On a CUDA tensor a packed forward launches its kernel (K1-K4) and its
backward is tensor ops beside it (``kernels/ops.py``,
``sparsetrain/vjp.py``); the masked dense step launches no DeMM kernel, as
in the reference.

Under a sharding plan (``plan=ShardingPlan(tp=..., dp=...)``) the step is
SPMD over ``torch.distributed``, one process per rank:
``ShardingPlan.place_for_training`` keeps this rank's tp blocks of the
model (its ``train_params`` are those blocks) and gives the step's
:class:`~repro_torch.sharding.plan.TrainLayout`.  Each dp rank takes its
rows of the global batch (every rank is handed the same one) and splits
them into the microbatches; the loss runs under the plan's sharding
context (Megatron's collectives under autograd, the experts
expert-parallel); the gradients are averaged over dp (replicated tensors'
gradients are whole on every tp rank and are not summed over tp); AdamW
updates this rank's ZeRO-1 blocks (``adamw.init(..., layout=
step.layout)`` allocates them) and gathers the updated blocks; the loss
and metrics are the global batch's.  The reference's ``jax.jit`` with
shardings reaches the same math through GSPMD from one process.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw


def train_params(model) -> dict:
    """The tensors a training step updates: every parameter and every float
    buffer of ``model`` (a packed weight's float values and scales), by
    dotted name, detached from autograd (they share the module's storage)."""
    out = {n: p.detach() for n, p in model.named_parameters()}
    out.update((n, b.detach()) for n, b in model.named_buffers()
               if b.is_floating_point())
    return out


@torch.no_grad()
def load_params(model, params: dict):
    """Copy ``params`` into ``model``'s tensors of the same names (shapes
    must match)."""
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    for name, t in params.items():
        dst = own[name]
        if tuple(dst.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit "
                             f"the model's {tuple(dst.shape)}")
        if dst.data_ptr() != t.data_ptr():
            dst.copy_(t)


def premask_params(params: dict, sparsity: dict) -> dict:
    """Apply the N:M straight-through masks ONCE per step.

    Weights are constant within a step, so recomputing the top-k mask in
    every microbatch and remat pass is waste — masking here and running the
    model in ``dense`` mode keeps identical semantics (the straight-through
    gradients reach the dense weight through this one masking site)."""
    from repro_torch.core.pruning import masked_weight

    out = dict(params)
    for name, cfg in sparsity.items():
        out[name] = masked_weight(params[name], cfg)
    return out


def _device_batch(batch: dict, device) -> dict:
    """The batch on ``device``: integer entries (tokens, targets) as int64,
    float entries (a frontend's ``patch_embeds`` or ``frames``) as they
    are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device=device, dtype=None if t.is_floating_point()
                      else torch.int64)
    return out


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    num_microbatches: int = 1, policy=None, mode=None,
                    backend=None, premask: bool = True, fake_quant=None,
                    qat_granularity: str = "per_row", plan=None):
    """Build ``train_step(params, opt_state, batch, step, masks=None) ->
    (params, opt_state, metrics)``.

    ``masks`` (optional, a ``sparsetrain.masks.build_masks`` tree) replaces
    the per-step top-k premasking with externally scheduled masks — the
    gradual-sparsification path: the schedule driver refreshes the mask tree
    on its own cadence and the step applies it straight through.
    ``fake_quant`` (``"int8"``) adds QAT: after masking, every sparse weight
    is fake-quantized on the int8 grid its packed serving form will use
    (``sparsetrain.qat``), at ``qat_granularity``.  ``params`` and the
    optimizer state are updated in place.  Metrics are 0-d tensors: loss,
    xent, aux, grad_norm, lr.

    ``plan`` (a ``ShardingPlan`` of tp x dp ranks) places ``model`` for
    training on this rank and makes the step distributed (see the module
    docstring); the step carries ``layout`` (its ``TrainLayout``, None
    without a plan), ``context`` (the sharding context) and ``grads(params,
    batch, masks=None) -> (loss, metrics, grads)``, the step's gradients
    (averaged over dp) without the update.
    """
    import contextlib

    from repro_torch.core.sparse_linear import resolve_policy, sparse_weights
    from repro_torch.sharding import context as shctx
    from repro_torch.sparsetrain.qat import validate_qat

    validate_qat(fake_quant, qat_granularity)
    policy = resolve_policy(policy, mode, backend)
    mode = policy.mode
    use_premask = premask and mode == "masked"
    # with premasking the model runs in dense mode on the masked tensors
    inner_policy = policy.replace(mode="dense") if use_premask else policy
    layout = ctx = None
    if plan is not None and plan.device_degree() > 1:
        if fake_quant is not None and plan.tp > 1:
            raise NotImplementedError(
                "fake quantization under tp > 1: a row-parallel weight's "
                "per-row int8 scale spans the ranks")
        layout = plan.place_for_training(model, plan_mesh(plan, model))
        ctx = layout.ctx
    sparsity = sparse_weights(model)
    device = model.device

    def loss_and_grads(leaves, mb):
        with torch.enable_grad(), (shctx.use_mesh(ctx) if ctx is not None
                                   else contextlib.nullcontext()):
            loss, metrics = torch.func.functional_call(
                model, leaves, (mb,), {"policy": inner_policy})
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

    def step_grads(params, batch, masks=None):
        """(loss, metrics, grads) of the step at ``params`` on ``batch``:
        the gradients averaged over the microbatches (and over dp)."""
        batch = _device_batch(batch, device)
        if layout is not None:
            batch = layout.local_rows(batch)
        with torch.no_grad():
            if masks is not None:
                if not use_premask:
                    raise ValueError(
                        "scheduled masks need mode='masked' with premask="
                        "True (the inner model must run dense so the mask "
                        "is applied exactly once)")
                from repro_torch.sparsetrain.masks import apply_mask_tree
                fwd_params = apply_mask_tree(params, masks)
            elif use_premask:
                fwd_params = premask_params(params, sparsity)
            else:
                fwd_params = dict(params)
            if fake_quant is not None:
                from repro_torch.sparsetrain import qat
                fwd_params = qat.fake_quant_params(fwd_params, sparsity,
                                                   qat_granularity)
        # the masking is straight-through: the gradient of the loss at the
        # masked (and fake-quantized) tensors IS the dense parameters'
        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in fwd_params.items()}
        del fwd_params
        if num_microbatches == 1:
            loss, metrics, grads = loss_and_grads(leaves, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % num_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{num_microbatches} microbatches")
            per = b // num_microbatches
            grads, losses, metricses = {}, [], []
            for i in range(num_microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss_i, met_i, g = loss_and_grads(leaves, mb)
                for n, gi in g.items():
                    if gi is None:
                        continue
                    gi = gi.to(torch.float32)
                    grads[n] = gi if n not in grads else grads[n] + gi
                losses.append(loss_i)
                metricses.append(met_i)
            grads = {n: g / num_microbatches for n, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        del leaves
        if layout is not None:       # the global batch's
            layout.mean_grads_(grads)
            loss = ctx.dp_mean_(loss.clone())
            metrics = {k: ctx.dp_mean_(v.clone()) for k, v in metrics.items()}
        return loss, metrics, grads

    def train_step(params, opt_state, batch, step, masks=None):
        del step  # the schedule reads opt_state.step
        loss, metrics, grads = step_grads(params, batch, masks)
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, opt_state, params, inplace=True, layout=layout)
        return new_params, new_opt, dict(metrics, loss=loss, **opt_metrics)

    train_step.layout, train_step.context = layout, ctx
    train_step.grads = step_grads
    return train_step


def plan_mesh(plan, model):
    """The DeviceMesh a model is trained on under ``plan``: made once per
    model (``ShardingPlan.make_mesh``) and kept on it, so that another step
    of the same model and plan reuses its process groups."""
    mesh = getattr(model, "train_mesh", None)
    if mesh is None or getattr(model, "placed_plan", None) != plan:
        mesh = model.train_mesh = plan.make_mesh()
    return mesh


def make_eval_step(model, *, policy=None, mode=None, backend=None):
    """``eval_step(params, batch) -> metrics`` (loss, xent, aux) without
    gradients."""
    from repro_torch.core.sparse_linear import resolve_policy

    policy = resolve_policy(policy, mode, backend)
    device = model.device

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = torch.func.functional_call(
            model, params, (_device_batch(batch, device),),
            {"policy": policy})
        return dict(metrics, loss=loss)

    return eval_step
