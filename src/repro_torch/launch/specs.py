"""Shape-only stand-ins for every input of a (config x shape) cell.

The JAX package's ``jax.ShapeDtypeStruct`` / ``jax.eval_shape`` stand-ins
become meta-device tensors here: shapes and dtypes, no storage, nothing
computed.  The shape of a cell is a ``configs.base.ShapeConfig`` (the
JAX package's, with its ``SHAPES`` and ``applicable_shapes``), a
:class:`BatchShape` (the two fields these functions read) or anything with
``global_batch`` and ``seq_len``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

META = torch.device("meta")


class BatchShape(NamedTuple):
    """The global batch and sequence length of a cell."""

    global_batch: int
    seq_len: int


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg, shape) -> dict:
    """A training batch: tokens and targets (B, T) int32; a ``vision``
    frontend's text shortened by its patches and ``patch_embeds`` (B, P, D)
    float32; the ``audio`` family's ``frames`` (B, T / divisor, D)."""
    gb, t = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        t_text = t - cfg.num_patches
        return {"tokens": _meta((gb, t_text), torch.int32),
                "targets": _meta((gb, t_text), torch.int32),
                "patch_embeds": _meta((gb, cfg.num_patches, cfg.d_model),
                                      torch.float32)}
    batch = {"tokens": _meta((gb, t), torch.int32),
             "targets": _meta((gb, t), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = _meta((gb, t // cfg.encoder_seq_divisor,
                                 cfg.d_model), torch.float32)
    return batch


def prefill_batch_specs(cfg, shape) -> dict:
    """A prefill batch: :func:`train_batch_specs` without the targets."""
    b = train_batch_specs(cfg, shape)
    b.pop("targets", None)
    return b


def decode_token_specs(shape) -> torch.Tensor:
    """One decode step's tokens (B, 1) int32."""
    return _meta((shape.global_batch, 1), torch.int32)


def meta_model(cfg):
    """``cfg``'s model built on the meta device (no weight allocated)."""
    from repro_torch.models.families import build_model

    return build_model(cfg, device=META, generator=torch.Generator())


def param_shapes(model_or_cfg) -> dict:
    """``{dotted name: meta tensor}`` of every parameter and float buffer a
    training step updates (``train.train_loop.train_params``): of the given
    model, or of a config's model built on the meta device."""
    from repro_torch.train.train_loop import train_params

    model = (model_or_cfg if isinstance(model_or_cfg, torch.nn.Module)
             else meta_model(model_or_cfg))
    return {n: _meta(t.shape, t.dtype)
            for n, t in train_params(model).items()}


def decode_state_shapes(model, shape) -> dict:
    """The decode state of ``shape.global_batch`` slots and ``seq_len``
    positions on the meta device."""
    return model.init_decode_state(shape.global_batch, shape.seq_len,
                                   device=META)
