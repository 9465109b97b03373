"""The int8 packed serving matmul ``y = x @ W_q8ᵀ`` (w8a16): CUDA kernel
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``demm_xwT_q8_pallas`` (``kernels/demm_q8.py`` of the
JAX package; its block-layout twin waits for a later slice).  The CUDA source
is ``csrc/demm_xwt_q8.cu``.  Weights are int8, activations keep their serving
dtype; only the int8 values, the indices and the float32 scales cross device
memory and the dequantisation happens in registers.  Like the float kernel it
is bound on an H100 by the packed bytes over device-memory bandwidth — int8
values cut those bytes from 8 to 5 per pair.

Semantics shared by the kernel and :func:`demm_xwT_q8_plain`: the int8 value
is cast to the activation dtype (exact), multiplied by its scale — ``scales[o]``
or ``scales[o, g]`` — cast to the activation dtype, the product rounded to the
activation dtype, then the float32-accumulated dot of the float kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig, expand_scales, unpack
from repro_torch.kernels.demm_xwT import (
    _DTYPE_CODE,
    check_xwT_args,
    raise_on_launch_error,
)


def _check_scales(scales, x, o, g):
    if tuple(scales.shape) not in ((o,), (o, g)):
        raise ValueError(f"scales must be (O,)={(o,)} or (O, G)={(o, g)}, "
                         f"got {tuple(scales.shape)}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    if scales.device != x.device:
        raise ValueError(f"scales on {scales.device}, x on {x.device}")
    if not scales.is_contiguous():
        raise ValueError("scales must be contiguous")


def demm_xwT_q8_plain(x: torch.Tensor, values: torch.Tensor,
                      indices: torch.Tensor, scales: torch.Tensor,
                      cfg: SparsityConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dequantise every packed value in
    the activation dtype (value × its row's or group's scale, rounded), scatter
    (duplicates accumulating in float32) into the dense (O, K) weight, then a
    float32 matmul."""
    o, g, _ = values.shape
    vals = values.to(x.dtype) * expand_scales(scales.to(x.dtype), values)
    w = unpack(vals.to(torch.float32), indices, cfg, (o, g * cfg.m))
    return x.to(torch.float32) @ w.T


def demm_xwT_q8(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                scales: torch.Tensor, cfg: SparsityConfig, *,
                rows_per_block: Optional[int] = None) -> torch.Tensor:
    """y (Bx, O) float32 = x (Bx, K) @ W_q8ᵀ; int8 values (O, G, Ne) with
    float32 scales (O,) or (O, G).

    A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
    takes :func:`demm_xwT_q8_plain`, and only because it lies on the CPU.
    """
    bx, k, o, g, ne = check_xwT_args(x, values, indices, cfg, (torch.int8,))
    _check_scales(scales, x, o, g)
    if not x.is_cuda:
        return demm_xwT_q8_plain(x, values, indices, scales, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    y = torch.empty((bx, o), dtype=torch.float32, device=x.device)
    code = lib.demm_xwt_q8_launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(),
        scales.data_ptr(), y.data_ptr(), bx, k, o, g, cfg.m, ne,
        _DTYPE_CODE[x.dtype], 1 if scales.ndim == 1 else g, int(rows_per_block or 0),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_launch_error(code, "demm_xwt_q8")
    demm_xwT_q8.launches += 1
    return y


demm_xwT_q8.launches = 0     # kernel launches (not plain-version calls)
