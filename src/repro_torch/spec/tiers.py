"""Draft-tier derivation: a sparser view of a packed model, zero weight copy.

The inverse of the paper's §II-B k-reconfiguration.  ``reconfigure_k`` lets
a DeMM(N, M, C, k) engine serve the *denser* kN:M pattern in k passes over
one stored ``{value, col_idx}`` stream; a **draft tier** reads the *same*
stream at a sparser pattern by consuming only the first ``tier_ne`` pairs
per group.  ``tier_ne`` is a static attribute of
:class:`~repro_torch.core.sparsity.PackedWeight`, so the draft model's
packed nodes share the full model's tensors (``draft.values is
full.values``, one ``data_ptr``) and the narrowing happens at dispatch
(``kernels/ops.demm_matmul_packed``), as prefix views that the kernels read
in place at the stored pitch.  One weight buffer, two density tiers: the
self-speculative serving trick that fixed fine-grained engines cannot
express.

The prefix-read is exact magnitude pruning only if each group's pairs are
ordered magnitude-descending; :func:`tier_sort_tree` establishes that
invariant once per model (full-tier compute does not depend on the order in
exact arithmetic — the plain versions scatter, the kernels sum over the Ne
axis).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import torch
from torch import nn

from repro_torch.core.sparse_linear import PLACEMENT_ATTRS
from repro_torch.core.sparsity import PackedWeight, tier_order


def parse_tier(spec: str) -> Tuple[int, int]:
    """``"8:128"`` -> ``(8, 128)`` — the draft pattern N:M."""
    try:
        n_s, m_s = spec.split(":")
        n, m = int(n_s), int(m_s)
    except ValueError:
        raise ValueError(
            f"draft tier must be 'N:M' (e.g. '8:128'), got {spec!r}")
    if n < 1 or m < 1 or n > m:
        raise ValueError(f"draft tier {spec!r}: need 1 <= N <= M")
    return n, m


def _packed_nodes(model: nn.Module):
    return [mod for mod in model.modules() if isinstance(mod, PackedWeight)]


def tier_sort_tree(model: nn.Module) -> nn.Module:
    """Reorder every PackedWeight's per-group pairs magnitude-descending
    (``core.sparsity.tier_order``), **in place**, and return ``model``.
    Idempotent.

    In place because a full-width model holds gigabytes of packed weights
    and a sorted copy beside them would double that: each node's values and
    indices are rewritten through one permutation, a transient the size of
    that node.  The tensors keep their storage, so views of them and graphs
    captured on them stay valid (a graph then reads the sorted order)."""
    with torch.no_grad():
        for pw in _packed_nodes(model):
            order = tier_order(pw)
            pw.values.copy_(torch.take_along_dim(pw.values, order, dim=-1))
            pw.indices.copy_(torch.take_along_dim(pw.indices, order, dim=-1))
    return model


@dataclasses.dataclass(frozen=True)
class TierReport:
    """What the derivation pass did to a packed model."""

    narrowed: int = 0        # nodes retagged to the draft tier
    full: int = 0            # packed nodes left at the full tier
    other: int = 0           # tensors outside packed nodes (untouched)

    def __str__(self):
        return (f"{self.narrowed} node(s) at the draft tier, "
                f"{self.full} at the full tier, {self.other} dense")


def derive_draft_tier(model: nn.Module, draft: str):
    """Walk a packed model and produce the draft-tier view.

    Every k-reconfigurable :class:`PackedWeight` — one whose group size
    matches the draft pattern's M and whose ``n_effective`` exceeds the
    draft N — becomes ``pw.replace(tier_ne=N)``: a node whose tensors ARE
    the full node's.  Nodes the draft pattern cannot narrow (another M,
    already at or below the draft density) stay the full tier, and every
    other tensor is counted in ``other``.  The draft model is a shallow
    tree: a module is copied only on the path to a narrowed node (its
    children dict copied, its tensors shared); every other module is the
    very object of ``model``.

    Returns ``(draft_model, TierReport)``.  Raises if the pattern narrows
    nothing — a draft identical to the full tier would verify itself.
    """
    n, m = parse_tier(draft)
    counts = {"narrowed": 0, "full": 0, "other": 0}

    def one(mod: nn.Module) -> nn.Module:
        if isinstance(mod, PackedWeight):
            if mod.cfg.m == m and mod.cfg.n_effective > n:
                counts["narrowed"] += 1
                view = mod.replace(tier_ne=n)
                # a node placed by a sharding plan: the view of its slice
                # runs as it does
                for attr in PLACEMENT_ATTRS:
                    if hasattr(mod, attr):
                        setattr(view, attr, getattr(mod, attr))
                return view
            counts["full"] += 1
            return mod
        counts["other"] += (len(list(mod.parameters(recurse=False)))
                            + len(list(mod.buffers(recurse=False))))
        swapped = {}
        for name, child in mod.named_children():
            new = one(child)
            if new is not child:
                swapped[name] = new
        if not swapped:
            return mod
        out = copy.copy(mod)
        out._modules = copy.copy(mod._modules)
        out._modules.update(swapped)
        return out

    out = one(model)
    report = TierReport(**counts)
    if report.narrowed == 0:
        raise ValueError(
            f"draft tier {draft!r} narrows no PackedWeight in this tree "
            f"({report}); the packed pattern must share M with the draft "
            f"and be denser than it (pack with e.g. --sparsity "
            f"{2 * n}:{m})")
    return out, report
