"""Kernel variant registry — how backend strings resolve to implementations.

Every packed-matmul implementation is registered as a :class:`KernelVariant`
under ``(op, name)``; ``kernels/ops.py`` dispatches through :func:`get_variant`
instead of matching raw backend strings, so a new variant plugs in with one
``register_variant`` call and is immediately a valid ``--backend``.

Ops and uniform signatures
--------------------------
``xwT``          : call(x, values, indices, cfg, w_shape, **params) -> (B, O)
``xwT_q8``       : call(x, values, indices, scales, cfg, w_shape, **params)
                   -> (B, O) — int8 values + scales (O,) or (O, G).
``xwT_block``    : call(x, values, indices, active_groups, cfg, w_shape,
                   **params) -> (B, O) — the two-level block layout, served
                   as ``(W_block @ xᵀ)ᵀ``.
``xwT_block_q8`` : call(x, values, indices, active_groups, scales, cfg,
                   w_shape, **params) -> (B, O) — scales (RB, A_max, block_r).
``spmm``         : call(values, indices, b, cfg, a_shape, **params) -> (R, Cd)
                   — the paper orientation C = A_sparse @ B.

Backends: ``reference`` is the kernel's plain PyTorch version on whatever
device the tensors lie; ``cuda`` is the hand-written kernel (on a CPU tensor
its wrapper runs the plain version, and only because the tensor is on the
CPU).  ``params`` reach the kernel (``duplicates``, ``rows_per_block``, and
the redesigned bodies' ``tile`` / ``stages`` for ``spmm`` and
``cluster_size`` for ``xwT_block_q8``); the plain versions ignore them.
Problem descriptions, the tuning cache, autotuning, ``auto`` and the
measure-only ``block_spmm`` variant of ``spmm`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

OPS = ("xwT", "xwT_q8", "xwT_block", "xwT_block_q8", "spmm")


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One registered implementation of a DeMM op."""

    op: str
    name: str
    call: Callable
    description: str = ""


_REGISTRY: Dict[Tuple[str, str], KernelVariant] = {}


def register_variant(variant: KernelVariant, *, overwrite: bool = False):
    if variant.op not in OPS:
        raise ValueError(f"unknown op {variant.op!r}; expected one of {OPS}")
    key = (variant.op, variant.name)
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"variant {key} already registered")
    _REGISTRY[key] = variant
    return variant


def get_variant(op: str, name: str) -> KernelVariant:
    try:
        return _REGISTRY[(op, name)]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r} for op {op!r}; registered: "
            f"{sorted(n for (o, n) in _REGISTRY if o == op)}") from None


def variants_for(op: str) -> Sequence[KernelVariant]:
    """All registered variants of ``op``, sorted by name."""
    return [v for (o, _), v in sorted(_REGISTRY.items()) if o == op]


def backend_names(op: str) -> Tuple[str, ...]:
    return tuple(v.name for v in variants_for(op))


def _register_builtin_variants():
    from repro_torch.kernels.demm_block_spmm import (demm_block_spmm,
                                                     demm_block_spmm_plain)
    from repro_torch.kernels.demm_q8 import (demm_block_spmm_q8,
                                             demm_block_spmm_q8_plain,
                                             demm_xwT_q8, demm_xwT_q8_plain)
    from repro_torch.kernels.demm_spmm import demm_spmm, demm_spmm_plain
    from repro_torch.kernels.demm_xwT import demm_xwT, demm_xwT_plain

    register_variant(KernelVariant(
        op="xwT", name="reference",
        call=lambda x, values, indices, cfg, w_shape, **_:
            demm_xwT_plain(x, values, indices, cfg),
        description="plain PyTorch scatter + float32 matmul"))
    register_variant(KernelVariant(
        op="xwT", name="cuda",
        call=lambda x, values, indices, cfg, w_shape, **params:
            demm_xwT(x, values, indices, cfg, **params),
        description="hand-written CUDA kernel (csrc/demm_xwt.cu)"))
    register_variant(KernelVariant(
        op="xwT_q8", name="reference",
        call=lambda x, values, indices, scales, cfg, w_shape, **_:
            demm_xwT_q8_plain(x, values, indices, scales, cfg),
        description="plain PyTorch int8 scatter + scale + float32 matmul"))
    register_variant(KernelVariant(
        op="xwT_q8", name="cuda",
        call=lambda x, values, indices, scales, cfg, w_shape, **params:
            demm_xwT_q8(x, values, indices, scales, cfg, **params),
        description="hand-written CUDA kernel, int8 values dequantised "
                    "in-register (csrc/demm_xwt_q8.cu)"))

    # The block ops serve y = (W_block @ xᵀ)ᵀ: xᵀ and the result's transpose
    # are views, so nothing is copied (demm_block_spmm.block_output).
    register_variant(KernelVariant(
        op="xwT_block", name="reference",
        call=lambda x, values, indices, ag, cfg, w_shape, **_:
            demm_block_spmm_plain(ag, values, indices, x.T, cfg,
                                  r=w_shape[0]).T,
        description="plain PyTorch two-level scatter + float32 matmul"))
    register_variant(KernelVariant(
        op="xwT_block", name="cuda",
        call=lambda x, values, indices, ag, cfg, w_shape, **params:
            demm_block_spmm(ag, values, indices, x.T, cfg, r=w_shape[0],
                            **params).T,
        description="hand-written CUDA kernel reading the active-group "
                    "address stream (csrc/demm_block_spmm.cu)"))
    register_variant(KernelVariant(
        op="xwT_block_q8", name="reference",
        call=lambda x, values, indices, ag, scales, cfg, w_shape, **_:
            demm_block_spmm_q8_plain(ag, values, indices, scales, x.T, cfg,
                                     r=w_shape[0]).T,
        description="plain PyTorch int8 two-level scatter + scale + float32 "
                    "matmul"))
    register_variant(KernelVariant(
        op="xwT_block_q8", name="cuda",
        call=lambda x, values, indices, ag, scales, cfg, w_shape, **params:
            demm_block_spmm_q8(ag, values, indices, scales, x.T, cfg,
                               r=w_shape[0], **params).T,
        description="hand-written CUDA kernel, int8 values dequantised "
                    "in-register: at serving batch a cluster of CTAs per row "
                    "block with bulk copies in flight and a distributed "
                    "shared-memory reduction (csrc/demm_block_cluster.cuh), "
                    "else the gather body (csrc/demm_block_spmm_q8.cu)"))
    register_variant(KernelVariant(
        op="spmm", name="reference",
        call=lambda values, indices, b, cfg, a_shape, **_:
            demm_spmm_plain(values, indices, b, cfg),
        description="plain PyTorch scatter + float32 matmul"))
    register_variant(KernelVariant(
        op="spmm", name="cuda",
        call=lambda values, indices, b, cfg, a_shape, **params:
            demm_spmm(values, indices, b, cfg, **params),
        description="hand-written CUDA kernel: for a wide bf16 B the tiled "
                    "tensor-core body, TMA-staged B tiles and wgmma on the "
                    "scatter tile (csrc/demm_spmm_tc.cu); else the block-spmm "
                    "gather body with the identity address stream "
                    "(csrc/demm_block_spmm.cu)"))


_register_builtin_variants()
