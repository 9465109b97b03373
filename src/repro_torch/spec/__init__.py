"""``repro_torch.spec`` — self-speculative decoding from one packed model.

The draft model is the *same* :class:`~repro_torch.core.sparsity.PackedWeight`
tensors read at a sparser density tier (``tier_ne`` narrows the per-group
address stream at dispatch — prefix views the kernels read in place, no
weight copy), the verifier is the full tier, and a replay-safe coupled
sampler makes the committed stream token-identical to non-speculative
decoding at any temperature.  Enabled through
``serve.make_engine(..., spec=SpecConfig(...))`` or ``launch/serve.py
--spec-draft N:M --spec-gamma G``.

* :mod:`repro_torch.spec.tiers`    — draft-tier derivation (tensor-sharing view)
* :mod:`repro_torch.spec.sampling` — counter-based (request, position)-keyed RNG
* :mod:`repro_torch.spec.decode`   — draft→verify window, the verify program
"""

from repro_torch.spec.decode import SpecConfig, SpecMetrics, make_multistep
from repro_torch.spec.sampling import ReplaySafeSampler, position_noise
from repro_torch.spec.tiers import (
    TierReport,
    derive_draft_tier,
    parse_tier,
    tier_sort_tree,
)

__all__ = [
    "SpecConfig", "SpecMetrics", "ReplaySafeSampler", "TierReport",
    "derive_draft_tier", "make_multistep", "parse_tier", "position_noise",
    "tier_sort_tree",
]
