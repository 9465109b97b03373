"""Model construction by architecture family (only ``dense`` is ported)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig


def build_model(cfg: ArchConfig, *, device,
                generator: Optional[torch.Generator] = None, seed: int = 0):
    """A randomly initialised model of ``cfg`` on ``device``."""
    from repro_torch.models.transformer import DecoderLM

    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (only 'dense')")
    return DecoderLM.init(cfg, device=device, generator=generator, seed=seed)
