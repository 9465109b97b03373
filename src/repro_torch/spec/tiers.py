"""Sparsity-tier helpers (only the ``N:M`` parser is ported so far; draft
tiers come with the speculative-decoding slice)."""

from __future__ import annotations

from typing import Tuple


def parse_tier(spec: str) -> Tuple[int, int]:
    """``"8:128"`` -> ``(8, 128)`` — a sparsity pattern N:M."""
    try:
        n_s, m_s = spec.split(":")
        n, m = int(n_s), int(m_s)
    except ValueError:
        raise ValueError(
            f"pattern must be 'N:M' (e.g. '8:128'), got {spec!r}")
    if n < 1 or m < 1 or n > m:
        raise ValueError(f"pattern {spec!r}: need 1 <= N <= M")
    return n, m
