"""Pure-PyTorch oracles for the DeMM kernels: unpack to dense, upcast both
sides to float32, dense matmul.

These mirror the JAX package's ``kernels/ref.py``.  They differ from the
kernels' *plain versions* (``demm_xwT.demm_xwT_plain``,
``demm_q8.demm_xwT_q8_plain``) only under bf16 activations: the kernels round
the packed values to the activation type before the product, the oracles do
not.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import SparsityConfig, expand_scales, unpack


def xwT_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
            cfg: SparsityConfig, w_shape) -> torch.Tensor:
    """y = x @ W_sparseᵀ via unpack-to-dense (fp32 accum)."""
    w = unpack(values, indices, cfg, tuple(w_shape))
    return x.to(torch.float32) @ w.to(torch.float32).T


def xwT_q8_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
               scales: torch.Tensor, cfg: SparsityConfig,
               w_shape) -> torch.Tensor:
    """y = x @ W_q8ᵀ with per-output-row (O,) or per-group (O, G) scales:
    dequant + float ref."""
    vals = values.to(torch.float32) * expand_scales(scales, values)
    return xwT_ref(x, vals, indices, cfg, w_shape)
