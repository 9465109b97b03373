"""Kernel variant registry — how backend strings resolve to implementations.

Every packed-matmul implementation is registered as a :class:`KernelVariant`
under ``(op, name)``; ``kernels/ops.py`` dispatches through :func:`get_variant`
instead of matching raw backend strings, so a new variant plugs in with one
``register_variant`` call and is immediately a valid ``--backend``.

Ops and uniform signatures
--------------------------
``xwT``    : call(x, values, indices, cfg, w_shape, **params) -> (B, O)
``xwT_q8`` : call(x, values, indices, scales, cfg, w_shape, **params)
             -> (B, O) — int8 values + scales (O,) or (O, G).

Backends: ``reference`` is the kernel's plain PyTorch version on whatever
device the tensors lie; ``cuda`` is the hand-written kernel (on a CPU tensor
its wrapper runs the plain version, and only because the tensor is on the
CPU).  Problem descriptions, the tuning cache, autotuning and ``auto`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

OPS = ("xwT", "xwT_q8")


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
    from repro_torch.kernels.demm_q8 import demm_xwT_q8, demm_xwT_q8_plain
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


_register_builtin_variants()
