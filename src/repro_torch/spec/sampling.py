"""Replay-safe sampling: counter-based RNG keyed on (request, position).

A scheduler that preempts requests needs a
preempt → re-prefill → resume cycle replays the *identical* token stream.
Greedy decode gets that for free; stochastic sampling needs the randomness
itself to be a pure function of where in which request it is drawn, not of
how many draws happened before it.  Stateful PRNG streams (split-per-step
framework keys, a shared generator) break on resume; a **counter-based** generator
keyed on ``(seed, request_id, position)`` does not — numpy's Philox is
exactly that (its stream is specified and stable across platforms and
versions), so the noise for token position ``p`` of request ``r`` is the
same no matter when, where, or how many times it is drawn.

Sampling itself is **Gumbel-max coupled**: the committed token at position
``p`` is ``argmax(logits/T + g)`` over the top-k mask, with ``g`` the
position-keyed Gumbel noise.  That is an exact draw from the
temperature/top-k distribution *and* a deterministic function of
``(logits, seed, rid, p)`` — which buys two guarantees at once:

* **replay safety** — resume recomputes the same full-tier logits (greedy
  prefill is deterministic) and the same noise, hence the same token;
* **speculative acceptance** (``repro_torch.spec.decode``) — the draft tier
  proposes with the *same* key on its draft logits, and verification
  accepts iff the proposal equals the full-tier coupled sample.  The
  committed stream is therefore token-identical to the non-speculative
  sampled stream by construction (classical stochastic rejection sampling
  cannot make that bit-exact promise under preemption, because the draft
  distribution depends on how the speculation windows happen to align).

At ``temperature == 0`` every path degenerates to argmax, so speculative
and non-speculative greedy are trivially token-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 1e-12


def position_noise(seed: int, rid: int, pos: int, n: int) -> np.ndarray:
    """Gumbel(0, 1) noise of shape ``(n,)`` for token position ``pos`` of
    request ``rid`` — a pure function of ``(seed, rid, pos)``.

    Philox is counter-based: the 2-word key carries (seed, rid), the
    128-bit counter carries the position, so no sequential stream state
    exists to lose on preemption."""
    bits = np.random.Philox(counter=[np.uint64(pos), 0, 0, 0],
                            key=[np.uint64(seed & 0xFFFFFFFFFFFFFFFF),
                                 np.uint64(rid & 0xFFFFFFFFFFFFFFFF)])
    u = np.random.Generator(bits).random(n)
    return -np.log(-np.log(u + _EPS) + _EPS)


@dataclasses.dataclass(frozen=True)
class ReplaySafeSampler:
    """Temperature / top-k token sampler with the replay contract above.

    ``sample(logits_row, rid, pos)`` returns the committed token for
    sequence position ``pos`` (the 0-based index the token occupies in
    prompt+output order) of request ``rid``.  ``temperature == 0`` is
    greedy argmax (``top_k`` ignored).
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = full vocab), got "
                             f"{self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def sample(self, logits_row: np.ndarray, rid: int, pos: int) -> int:
        z = np.asarray(logits_row, np.float64)
        if self.greedy:
            return int(np.argmax(z))
        z = z / self.temperature
        if 0 < self.top_k < z.shape[-1]:
            # deterministic top-k: stable sort breaks value ties by index
            keep = np.argsort(-z, kind="stable")[: self.top_k]
            masked = np.full_like(z, -np.inf)
            masked[keep] = z[keep]
            z = masked
        g = position_noise(self.seed, rid, pos, z.shape[-1])
        return int(np.argmax(z + g))
