"""AdamW with global-norm clipping and a warmup + cosine schedule.

Functional in form, as the JAX package's: ``update(cfg, grads, state,
params)`` returns ``(new_params, new_state, metrics)``; the trees are dicts
of named float tensors and the moments are float32 whatever the parameter
dtype.  The formula and its order are the reference's: global-norm clip,
then m and v in float32, bias correction, then the decoupled decay inside
``delta``::

    m = b1·m + (1-b1)·g           v = b2·v + (1-b2)·g²
    delta = (m / (1-b1ᵗ)) / (sqrt(v / (1-b2ᵗ)) + eps) + wd·p
    p = p - lr·delta

(``torch.optim.AdamW`` decays before the step and rounds elsewhere, so it
is not used.)  The update runs as ``torch._foreach_*`` passes over chunks of
the leaves — a few launches per chunk instead of per tensor, with the
temporaries of one chunk alive at a time.  ``inplace=True`` writes the new
parameters and moments into the given tensors (the training step does, so
that a full-width model's state is not held twice).

Gradient compression (``compression="topk" | "int8"``,
``optim/compression.py``) is applied to the gradients before the norm, as
the reference's update applies it; ``topk`` keeps its error-feedback
residuals in the state (``compression``, float32, at each parameter's
placement).

Under a sharding plan (``layout``, a ``sharding.plan.TrainLayout``) the
tensors are this rank's tp blocks: the norm is the whole model's (the
squares of split tensors summed over tp), compression sees whole tensors,
the moments are this dp rank's ZeRO-1 blocks (:func:`init` allocates only
those), the update computes on the matching blocks of the parameters and
gradients, and the updated blocks are gathered over dp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# elements of the float32 temporaries one foreach pass holds at a time
_CHUNK_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    m: dict
    v: dict
    compression: Optional[dict] = None   # topk's error-feedback residuals


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # gradient compression (see optim/compression.py)
    compression: Optional[str] = None     # None | "topk" | "int8"
    topk_fraction: float = 0.05

    def __post_init__(self):
        if self.compression not in (None, "topk", "int8"):
            raise ValueError(f"unknown gradient compression "
                             f"{self.compression!r}; expected topk or int8")


def _f32(v) -> np.float32:
    return np.float32(v)


def schedule(cfg: AdamWConfig, step) -> np.float32:
    """Learning rate at ``step`` (an int or a 0-d tensor): linear warmup,
    then cosine decay to ``min_lr_ratio``, in float32 arithmetic as the
    reference's."""
    s = _f32(int(step))
    warm = np.minimum(s / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = np.clip((s - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0), _f32(1))
    cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * prog))
    return _f32(cfg.lr) * warm * (_f32(cfg.min_lr_ratio)
                                  + (_f32(1) - _f32(cfg.min_lr_ratio)) * cos)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def init(cfg: AdamWConfig, params: dict, *, layout=None) -> AdamWState:
    """Zero moments, float32 (under ``layout`` this dp rank's ZeRO-1 blocks
    of them), and with ``topk`` compression zero residuals at each
    parameter's placement."""
    def zeros(block):
        return {n: torch.zeros((layout.zero_block(n, p) if block and layout
                                else p).shape, dtype=torch.float32,
                               device=p.device)
                for n, p in params.items() if _is_float(p)}

    dev = next(iter(params.values())).device if params else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(True), v=zeros(True),
                      compression=(zeros(False) if cfg.compression == "topk"
                                   else None))


def global_norm(tree: dict, *, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (under ``layout`` the whole model's: ``TrainLayout.global_norm``)."""
    if layout is not None:
        return layout.global_norm({n: g for n, g in tree.items()
                                   if _is_float(g)})
    sq = [g.to(torch.float32).square().sum() for g in tree.values()
          if _is_float(g)]
    return torch.sqrt(torch.stack(sq).sum())


def _chunks(names, params):
    """``names`` in runs of at most ``_CHUNK_ELEMS`` elements."""
    run, size = [], 0
    for n in names:
        k = params[n].numel()
        if run and size + k > _CHUNK_ELEMS:
            yield run
            run, size = [], 0
        run.append(n)
        size += k
    if run:
        yield run


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict,
           *, inplace: bool = False, layout=None):
    """Returns ``(new_params, new_state, metrics)``; metrics ``grad_norm``
    (before clipping) and ``lr``, 0-d float32 tensors.  ``layout`` (a
    ``TrainLayout``): the tensors are this rank's blocks and ``grads``
    already the mean over dp (see the module docstring)."""
    from repro_torch.optim import compression as comp_mod

    step = int(state.step) + 1
    names = [n for n, p in params.items()
             if _is_float(p) and grads.get(n) is not None]
    grads = {n: grads[n] for n in names}
    comp_state = state.compression
    if cfg.compression == "topk":
        grads, comp_state = comp_mod.topk_with_error_feedback(
            grads, comp_state, cfg.topk_fraction, layout=layout)
    elif cfg.compression == "int8":
        grads = comp_mod.int8_roundtrip(grads, layout=layout)
    gnorm = global_norm(grads, layout=layout)
    write_p = inplace
    if layout is not None:             # update the blocks of whole_params
        whole_params = params if inplace else {n: p.clone()
                                               for n, p in params.items()}
        write_p = True
        params = {n: layout.zero_block(n, p)
                  for n, p in whole_params.items()}
        grads = {n: layout.zero_block(n, g) for n, g in grads.items()}
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = schedule(cfg, step)
    b1c = _f32(1) - _f32(cfg.b1) ** _f32(step)
    b2c = _f32(1) - _f32(cfg.b2) ** _f32(step)

    new_p, new_m, new_v = dict(params), dict(state.m), dict(state.v)
    for run in _chunks(names, params):
        p = [params[n] for n in run]
        g = [grads[n].to(torch.float32) for n in run]
        if scale is not None:
            g = torch._foreach_mul(g, scale)
        m = [state.m[n] for n in run]
        v = [state.v[n] for n in run]
        if not inplace:
            m = [t.clone() for t in m]
            v = [t.clone() for t in v]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - cfg.b2)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, g2)
        del g, g2
        vh = torch._foreach_div(v, float(b2c))
        torch._foreach_sqrt_(vh)
        torch._foreach_add_(vh, cfg.eps)
        delta = torch._foreach_div(m, float(b1c))
        torch._foreach_div_(delta, vh)
        del vh
        p32 = [t.to(torch.float32) for t in p]
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
        del p32
        torch._foreach_mul_(delta, float(lr))
        delta = [d.to(t.dtype) for d, t in zip(delta, p)]
        if write_p:
            torch._foreach_sub_(p, delta)
        else:
            p = torch._foreach_sub(p, delta)
        for n, pi, mi, vi in zip(run, p, m, v):
            new_p[n], new_m[n], new_v[n] = pi, mi, vi
    if layout is not None:                 # the blocks were updated in place
        layout.gather_updated_(whole_params)
        new_p = whole_params
    step_t = torch.full((), step, dtype=torch.int32, device=state.step.device)
    return new_p, AdamWState(step=step_t, m=new_m, v=new_v,
                             compression=comp_state), {
        "grad_norm": gnorm,
        "lr": torch.tensor(lr, dtype=torch.float32)}
