"""The packed serving matmul ``y = x @ W_sparseᵀ``: CUDA kernel wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``demm_xwT_pallas`` (``kernels/demm_spmm.py`` of the
JAX package).  The CUDA source is ``csrc/demm_xwt.cu`` (body in
``csrc/demm_xwt_common.cuh``); on an H100 the work at decode batch sizes is
one pass over the packed bytes, so device-memory bandwidth bounds it, and the
kernel reads each ``{value, index}`` pair once, coalesced, against an
activation tile held in shared memory.

Semantics shared by the kernel and :func:`demm_xwT_plain`:

* ``y[b, o] = Σ_g Σ_n values[o, g, n] · x[b, g·M + indices[o, g, n]]``;
  duplicate indices accumulate, a padded slot (value 0 at index 0) adds 0;
* the packed values are rounded to the activation dtype before the product,
  products and sums are float32, the output is float32 whatever the inputs
  (the caller casts back).  The TPU kernel sums *duplicate* indices of one
  group in the activation dtype before its product; here they too add in
  float32 — the same number whenever a group holds no duplicates, which is
  all ``pack`` ever produces;
* ragged shapes are masked inside the kernel; nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig, unpack

# dtype codes of the C interface (csrc/demm_xwt_common.cuh, enum DType)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ERRORS = {-1: "unsupported dtype",
           -2: "inconsistent shapes (or more than 65535 x 8 activation rows)",
           -3: "one M-group of the activation tile exceeds the shared "
               "memory a block may use"}

def check_xwT_args(x, values, indices, cfg: SparsityConfig, value_dtypes):
    """Shape/dtype/device/contiguity checks shared by the float and int8
    wrappers.  Returns (bx, k, o, g, ne)."""
    if x.ndim != 2 or values.ndim != 3:
        raise ValueError(f"expected x (Bx, K) and values (O, G, Ne), got "
                         f"{tuple(x.shape)} and {tuple(values.shape)}")
    bx, k = x.shape
    o, g, ne = values.shape
    if k != g * cfg.m or ne != cfg.n_effective:
        raise ValueError(
            f"x {tuple(x.shape)} / values {tuple(values.shape)} do not fit "
            f"the pattern {cfg.pattern_name()}: need K == G*M and "
            f"Ne == n_effective")
    if tuple(indices.shape) != tuple(values.shape):
        raise ValueError(f"indices {tuple(indices.shape)} do not match "
                         f"values {tuple(values.shape)}")
    if bx < 1:
        raise ValueError("x needs at least one row")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"activations must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if values.dtype not in value_dtypes:
        raise TypeError(f"packed values must be one of {value_dtypes}, got "
                        f"{values.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    for name, t in (("values", values), ("indices", indices)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("values", values), ("indices", indices)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return bx, k, o, g, ne


def raise_on_launch_error(code: int, kernel: str):
    if code == 0:
        return
    if code < 0:
        raise RuntimeError(f"{kernel}: {_ERRORS.get(code, code)}")
    raise RuntimeError(f"{kernel}: CUDA launch failed with error {code}")


def demm_xwT_plain(x: torch.Tensor, values: torch.Tensor,
                   indices: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: round the packed values to the
    activation dtype, scatter them (duplicates accumulating in float32) into
    the dense (O, K) weight, then a float32 matmul.  Not a copy of
    ``ref.xwT_ref``, which keeps the values at full precision."""
    o, g, _ = values.shape
    w = unpack(values.to(x.dtype).to(torch.float32), indices, cfg,
               (o, g * cfg.m))
    return x.to(torch.float32) @ w.T


def demm_xwT(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
             cfg: SparsityConfig, *,
             rows_per_block: Optional[int] = None) -> torch.Tensor:
    """y (Bx, O) float32 = x (Bx, K) @ W_sparseᵀ, W packed (O, G, Ne).

    A CUDA tensor launches the hand-written kernel (building the library at
    first use) or raises; a CPU tensor takes :func:`demm_xwT_plain`, and only
    because it lies on the CPU.  ``rows_per_block`` is the kernel's one
    tunable (output rows per thread block); left open, the launcher sizes it
    to the card.
    """
    bx, k, o, g, ne = check_xwT_args(x, values, indices, cfg,
                                     (torch.float32, torch.bfloat16))
    if not x.is_cuda:
        return demm_xwT_plain(x, values, indices, cfg)
    from repro_torch.kernels._build import load_library

    lib = load_library()
    y = torch.empty((bx, o), dtype=torch.float32, device=x.device)
    code = lib.demm_xwt_launch(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
        bx, k, o, g, cfg.m, ne, _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[values.dtype], int(rows_per_block or 0), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_launch_error(code, "demm_xwt")
    demm_xwT.launches += 1
    return y


demm_xwT.launches = 0     # kernel launches (not plain-version calls)
