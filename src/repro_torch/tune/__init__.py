"""``repro_torch.tune`` — the kernel variant registry (tuning cache and
autotuner are not ported yet)."""

from repro_torch.tune.registry import (
    OPS,
    KernelVariant,
    backend_names,
    get_variant,
    register_variant,
    variants_for,
)

__all__ = ["OPS", "KernelVariant", "backend_names", "get_variant",
           "register_variant", "variants_for"]
