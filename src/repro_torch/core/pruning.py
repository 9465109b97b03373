"""Forward-time N:M projection of a dense weight.

The masked execution mode keeps the weight dense and multiplies it by its
top-N:M magnitude mask in the forward pass, so a masked model and its packed
form compute the same function.  Forward only: the straight-through gradient
and the RigL prune/regrow schedule of the JAX package come with the training
slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import SparsityConfig, prune_mask


def masked_weight(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """``w`` times its top-N:M mask, recomputed from the current weight."""
    return w * prune_mask(w, cfg).to(w.dtype)
