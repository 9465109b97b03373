"""Deterministic synthetic-token data pipeline with O(1) skip-ahead.

Every batch is a pure function of (seed, step), so fault-tolerant resume is
exact: restoring a checkpoint at step S and continuing produces bitwise the
same training trajectory as an uninterrupted run.  Hosts slice their local
shard of the global batch by index, so no data is exchanged between hosts.

The port's own copy of the JAX package's numpy pipeline: the same tokens,
bit for bit, for every (seed, step).  Batches are numpy int32 arrays; the
training step moves them to the model's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # noisy-Markov stream: next = (a·prev + c) mod V with prob (1-noise),
    # uniform otherwise — learnable structure (cross-entropy floor well
    # below ln V) while staying a pure function of (seed, step).
    structured: bool = True
    noise: float = 0.2


def _philox(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=[cfg.seed, step]))


def global_batch(cfg: DataConfig, step: int) -> dict:
    """The full (global_batch, seq) batch for a step — deterministic."""
    rng = _philox(cfg, step)
    shape = (cfg.global_batch, cfg.seq_len + 1)
    if not cfg.structured:
        toks = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    else:
        v = cfg.vocab_size
        a, c = 6364136223846793005 % v or 1, 1442695040888963407 % v
        toks = np.empty(shape, np.int32)
        toks[:, 0] = rng.integers(0, v, cfg.global_batch)
        noise = rng.random(shape) < cfg.noise
        rand = rng.integers(0, v, shape, dtype=np.int32)
        for t in range(1, shape[1]):
            nxt = (toks[:, t - 1].astype(np.int64) * a + c) % v
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def host_batch(cfg: DataConfig, step: int, host_index: int,
               host_count: int) -> dict:
    """This host's slice (contiguous rows) of the step's global batch."""
    assert cfg.global_batch % host_count == 0
    per = cfg.global_batch // host_count
    full = global_batch(cfg, step)
    sl = slice(host_index * per, (host_index + 1) * per)
    return {k: v[sl] for k, v in full.items()}


class DataIterator:
    """Stateful view with skip-ahead — the supervisor resumes by seeking."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def seek(self, step: int):
        self.step = step

    def __next__(self):
        b = global_batch(self.cfg, self.step)
        self.step += 1
        return b

    def __iter__(self):
        return self
