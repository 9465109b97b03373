"""Pure-PyTorch oracles for the DeMM kernels: unpack to dense, upcast both
sides to float32, dense matmul.

These mirror the JAX package's ``kernels/ref.py``.  They differ from the
kernels' *plain versions* (``demm_xwT_plain``, ``demm_xwT_q8_plain``,
``demm_block_spmm[_q8]_plain``, ``demm_spmm_plain``) only under bf16
activations: the kernels round the packed values to the activation type
before the product, the oracles do not.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import (SparsityConfig, expand_scales, unpack,
                                       unpack_block)


def spmm_ref(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor,
             cfg: SparsityConfig, a_shape) -> torch.Tensor:
    """C = A_sparse @ B via unpack-to-dense then dense matmul (fp32 accum)."""
    a = unpack(values, indices, cfg, tuple(a_shape))
    return a.to(torch.float32) @ b.to(torch.float32)


def xwT_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
            cfg: SparsityConfig, w_shape) -> torch.Tensor:
    """y = x @ W_sparseᵀ via unpack-to-dense (fp32 accum)."""
    w = unpack(values, indices, cfg, tuple(w_shape))
    return x.to(torch.float32) @ w.to(torch.float32).T


def block_spmm_ref(active_groups, values, indices, b, cfg: SparsityConfig,
                   r: int) -> torch.Tensor:
    """Oracle for the two-level block-sparse format: scatter every listed
    group back to dense (``core.sparsity.unpack_block``), then matmul."""
    a = unpack_block(active_groups, values, indices, cfg, (r, b.shape[0]))
    return a.to(torch.float32) @ b.to(torch.float32)


def xwT_q8_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
               scales: torch.Tensor, cfg: SparsityConfig,
               w_shape) -> torch.Tensor:
    """y = x @ W_q8ᵀ with per-output-row (O,) or per-group (O, G) scales:
    dequant + float ref."""
    vals = values.to(torch.float32) * expand_scales(scales, values)
    return xwT_ref(x, vals, indices, cfg, w_shape)


def block_spmm_q8_ref(active_groups, values, indices, scales, b,
                      cfg: SparsityConfig, r: int) -> torch.Tensor:
    """Two-level block oracle with per-(row-block, group, row) scales
    (RB, A_max, block_r): dequant + float ref."""
    vals = values.to(torch.float32) * scales[..., None]
    return block_spmm_ref(active_groups, vals, indices, b, cfg, r)
