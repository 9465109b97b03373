"""Autograd functions for the packed ops, so that a packed forward is
differentiable for every layout (``kernels/ops.py`` dispatches here when a
call records autograd history):

* ``xwT_grad``          — the row-packed layout.  Forward: the dispatched
  variant (on a CUDA tensor K1); backward: dx = dy @ W_dense in dy's dtype,
  and dvalues is the gather of the float32 dyᵀx at the packed coordinates.

* ``xwT_block_grad``    — the two-level block layout.  Forward: the
  dispatched variant (on a CUDA tensor K2); backward through the
  :func:`~repro_torch.core.sparsity.unpack_block` scatter: dx = dy @
  W_dense, and dvalues is the gather of dyᵀx at each slot's (row-block,
  active-group, local-index) coordinate.  Duplicate active-group ids
  accumulate in the forward scatter, so the per-slot gather *is* the exact
  gradient of that linear map.  ``indices`` and ``active_groups`` (the
  address streams) get none.

* ``xwT_q8_grad`` / ``xwT_block_q8_grad`` — the int8 twins (K3, K4).  The
  int8 ``values`` get no gradient, like the indices, but dx flows through
  the *dequantized* dense weight and ``scales`` (a float operand) receives
  dL/ds = Σ_slots gather(dyᵀx) · int_value.  Padded slots (value 0)
  contribute nothing to either.

Every backward is plain tensor ops with float32 accumulation; the forward is
whatever variant the dispatch picked.  The padding rule is one for all:
slots with value 0 get exactly 0, so the packed pattern never densifies
during fine-tuning.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import expand_scales, unpack, unpack_block


def dense_cotangent(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dW = dyᵀ @ x in float32: the dense-weight cotangent every packed
    backward gathers from."""
    return dy.T.to(torch.float32) @ x.to(torch.float32)


def gather_block_slots(dw: torch.Tensor, indices: torch.Tensor,
                       active_groups: torch.Tensor, m: int) -> torch.Tensor:
    """Gather the (O, K) dense cotangent at every block-layout slot: result
    (RB, A_max, block_r, Ne), aligned with the packed values."""
    rb, a_max, block_r, _ = indices.shape
    o, k = dw.shape
    assert o == rb * block_r, (tuple(dw.shape), tuple(indices.shape))
    g = k // m
    dw_g = dw.reshape(rb, block_r, g, m).transpose(1, 2)      # (RB,G,br,M)
    ag = active_groups.to(torch.int64)[:, :, None, None].expand(
        rb, a_max, block_r, m)
    sel = torch.take_along_dim(dw_g, ag, dim=1)               # (RB,A,br,M)
    return torch.take_along_dim(sel, indices.to(torch.int64), dim=-1)


def _zero_padded(dvalues: torch.Tensor, values: torch.Tensor):
    return torch.where(values != 0, dvalues,
                       torch.zeros((), dtype=dvalues.dtype,
                                   device=dvalues.device))


def _slot_sum(dslot, vals_f, scales, values):
    """dL/ds: the slots sharing a scale, summed (per-row xwT scales own two
    packed axes, every other unit one)."""
    dims = (-1,) if scales.ndim == values.ndim - 1 else (-2, -1)
    return (dslot * vals_f).sum(dim=dims).to(scales.dtype)


class _XwT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, cfg, w_shape, call, params):
        ctx.save_for_backward(x, values, indices)
        ctx.cfg, ctx.w_shape = cfg, w_shape
        return call(x, values, indices, cfg, w_shape, **params)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices = ctx.saved_tensors
        cfg, (o, k) = ctx.cfg, ctx.w_shape
        dx = dvalues = None
        if ctx.needs_input_grad[0]:
            w = unpack(values, indices, cfg, (o, k))          # (O, K)
            dx = (dy @ w.to(dy.dtype)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dvalues = torch.take_along_dim(
                dense_cotangent(dy, x).reshape(o, k // cfg.m, cfg.m),
                indices.to(torch.int64), dim=-1).to(values.dtype)
            # padded slots (value 0 at index 0) must not accumulate
            # gradient, or they would densify the pattern
            dvalues = _zero_padded(dvalues, values)
        return dx, dvalues, None, None, None, None, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, active_groups, cfg, w_shape, call,
                params):
        ctx.save_for_backward(x, values, indices, active_groups)
        ctx.cfg, ctx.w_shape = cfg, w_shape
        return call(x, values, indices, active_groups, cfg, w_shape,
                    **params)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, active_groups = ctx.saved_tensors
        cfg, w_shape = ctx.cfg, ctx.w_shape
        dx = dvalues = None
        if ctx.needs_input_grad[0]:
            w = unpack_block(active_groups, values.to(torch.float32),
                             indices, cfg, w_shape)
            dx = (dy.to(torch.float32) @ w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dvalues = gather_block_slots(
                dense_cotangent(dy, x), indices, active_groups,
                cfg.m).to(values.dtype)
            # padded / inactive slots (value 0, aliased at group 0 index 0)
            dvalues = _zero_padded(dvalues, values)
        return dx, dvalues, None, None, None, None, None, None


class _Q8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, scales, cfg, w_shape, call, params):
        ctx.save_for_backward(x, values, indices, scales)
        ctx.cfg, ctx.w_shape = cfg, w_shape
        return call(x, values, indices, scales, cfg, w_shape, **params)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, scales = ctx.saved_tensors
        cfg, (o, k) = ctx.cfg, ctx.w_shape
        vals_f = values.to(torch.float32)
        dx = dscales = None
        if ctx.needs_input_grad[0]:
            w = unpack(vals_f * expand_scales(scales, values), indices, cfg,
                       (o, k))
            dx = (dy.to(torch.float32) @ w).to(x.dtype)
        if ctx.needs_input_grad[3]:
            dslot = torch.take_along_dim(
                dense_cotangent(dy, x).reshape(o, k // cfg.m, cfg.m),
                indices.to(torch.int64), dim=-1)              # (O, G, Ne)
            dscales = _slot_sum(dslot, vals_f, scales, values)
        return dx, None, None, dscales, None, None, None, None


class _BlockQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, active_groups, scales, cfg, w_shape,
                call, params):
        ctx.save_for_backward(x, values, indices, active_groups, scales)
        ctx.cfg, ctx.w_shape = cfg, w_shape
        return call(x, values, indices, active_groups, scales, cfg, w_shape,
                    **params)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, active_groups, scales = ctx.saved_tensors
        cfg, w_shape = ctx.cfg, ctx.w_shape
        vals_f = values.to(torch.float32)
        dx = dscales = None
        if ctx.needs_input_grad[0]:
            w = unpack_block(active_groups, vals_f * scales[..., None],
                             indices, cfg, w_shape)
            dx = (dy.to(torch.float32) @ w).to(x.dtype)
        if ctx.needs_input_grad[4]:
            dslot = gather_block_slots(dense_cotangent(dy, x), indices,
                                       active_groups, cfg.m)
            dscales = (dslot * vals_f).sum(dim=-1).to(scales.dtype)
        return dx, None, None, None, dscales, None, None, None, None


def _call_of(op: str, backend: str):
    from repro_torch import tune

    return tune.get_variant(op, backend).call


def xwT_grad(x, values, indices, cfg, w_shape, backend="reference",
             params=None):
    """y = x @ W_sparseᵀ through the registered ``xwT`` variant ``backend``
    (with its ``params``), differentiable in x and the float values."""
    return _XwT.apply(x, values, indices, cfg, tuple(w_shape),
                      _call_of("xwT", backend), dict(params or {}))


def xwT_block_grad(x, values, indices, active_groups, cfg, w_shape,
                   backend="reference", params=None):
    """y = x @ W_blockᵀ through the registered ``xwT_block`` variant
    ``backend`` (with its ``params``), differentiable in x and the float
    values."""
    return _Block.apply(x, values, indices, active_groups, cfg,
                        tuple(w_shape), _call_of("xwT_block", backend),
                        dict(params or {}))


def xwT_q8_grad(x, values, indices, scales, cfg, w_shape,
                backend="reference", params=None):
    """y = x @ W_q8ᵀ, differentiable in x and scales (values are int8)."""
    return _Q8.apply(x, values, indices, scales, cfg, tuple(w_shape),
                     _call_of("xwT_q8", backend), dict(params or {}))


def xwT_block_q8_grad(x, values, indices, active_groups, scales, cfg,
                      w_shape, backend="reference", params=None):
    """y = x @ W_block_q8ᵀ, differentiable in x and scales."""
    return _BlockQ8.apply(x, values, indices, active_groups, scales, cfg,
                          tuple(w_shape), _call_of("xwT_block_q8", backend),
                          dict(params or {}))
