"""Functional model of the DeMM engine (paper §II), in PyTorch.

This is the *architectural* model of the engine: it computes sparse×dense
products in exactly the decoupled, row-wise product-first order the hardware
uses, with the two stages made explicit:

  stage 1 (memory)   — the N read ports: ``col_idx`` addresses the
                       pre-loaded M×C block of B, returning N rows of C
                       elements each;
  stage 2 (compute)  — N×C multipliers scale each read row by its non-zero
                       value; C N-input adder trees reduce to one output row.

The CUDA kernels in ``repro_torch.kernels`` are the fast versions; this
module is the semantics model, the engine the paper's cycle model
(``core.perfmodel``) counts, and what ``chip_smoke.py`` holds the
paper-orientation kernel against on the paper's CNN GEMMs.  Plain functions
on tensors, on whatever device the tensors lie on, differentiable by
autograd in ``values`` and ``b``.

Engine configuration mirrors the paper's DeMM(N, M, C, k):
  N — read ports / multiplier rows (non-zeros processed per cycle)
  M — group width = rows of B pre-loaded per block
  C — columns of B processed in parallel (output lanes)
  k — reconfiguration factor: kN:M patterns run in k passes per row

The order of the sums is the JAX package's: the Ne read rows of a group
first (in the accumulator dtype ``promote_types(values.dtype, float32)``),
then the groups, group-major.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sparsity import (PackedSparse, SparsityConfig, pack,
                                       prune, reconfigure_k)


@dataclasses.dataclass(frozen=True)
class DeMMConfig:
    """DeMM(N, M, C, k) — paper §II-B."""

    n: int = 8
    m: int = 128
    c: int = 64
    k: int = 8

    @property
    def multipliers(self) -> int:
        # The paper equalizes designs by MAC count: N*C multipliers.
        return self.n * self.c

    @property
    def sparsity(self) -> SparsityConfig:
        return SparsityConfig(n=self.n, m=self.m, k=1)

    def supports(self, pat: SparsityConfig) -> bool:
        """A DeMM(N,M,·,k) engine serves any pattern n':M with n' <= k*N."""
        return pat.m == self.m and pat.n_effective <= self.n * self.k


# ---------------------------------------------------------------------------
# The two decoupled stages
# ---------------------------------------------------------------------------

def read_ports(b_block: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """Stage 1 — the N-read-port memory block.

    b_block : (M, C)  pre-loaded rows of B (the engine's memory contents)
    col_idx : (..., N) integer addresses in [0, M)
    returns : (..., N, C) — each read port outputs one full row of B.
    """
    return b_block[col_idx.to(torch.int64)]


def multiply_reduce(read_rows: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Stage 2 — N×C multipliers + C N-input adder trees.

    read_rows : (..., N, C)
    values    : (..., N)
    returns   : (..., C)
    """
    acc_dtype = torch.promote_types(values.dtype, torch.float32)
    prods = read_rows.to(acc_dtype) * values[..., None].to(acc_dtype)
    return prods.sum(dim=-2)


def _group_contribs(values: torch.Tensor, indices: torch.Tensor,
                    b_blocks: torch.Tensor) -> torch.Tensor:
    """Every group's contribution through the two stages: values / indices
    (R, G, N), b_blocks (G, M, C) -> (G, R, C).  Group ``g``'s rows read
    only its own block, as the reference's vmap over groups does."""
    g = b_blocks.shape[0]
    gid = torch.arange(g, device=indices.device)[None, :, None]
    rows = b_blocks[gid, indices.to(torch.int64)]          # (R, G, N, C)
    return multiply_reduce(rows, values).transpose(0, 1)   # (G, R, C)


# ---------------------------------------------------------------------------
# Whole-matrix products in row-wise product-first order
# ---------------------------------------------------------------------------

def _b_blocks(packed: PackedSparse, b: torch.Tensor) -> torch.Tensor:
    kdim = packed.shape[1]
    if b.ndim != 2 or b.shape[0] != kdim:
        raise ValueError(f"B {tuple(b.shape)} does not fit A of shape "
                         f"{tuple(packed.shape)}")
    g = packed.values.shape[1]
    return b.reshape(g, packed.cfg.m, b.shape[1])


def demm_spmm(packed: PackedSparse, b: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A_sparse @ B with A packed as {values, indices}.

    A is (R, K) packed to (R, G, Ne); B is (K, Cdim).  The product is formed
    group by group (each group = one pre-loaded M-row memory block of B),
    each group contributing via the two decoupled stages.  Padded slots carry
    value 0 and contribute nothing.
    """
    contribs = _group_contribs(packed.values, packed.indices,
                               _b_blocks(packed, b))         # (G, R, C)
    return contribs.sum(dim=0).to(out_dtype)


def demm_spmm_dense_a(a: torch.Tensor, b: torch.Tensor, cfg: SparsityConfig,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Convenience: prune+pack a dense A on the fly, then demm_spmm."""
    return demm_spmm(pack(prune(a, cfg), cfg), b, out_dtype=out_dtype)


def demm_spmm_k_passes(packed: PackedSparse, b: torch.Tensor, k: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The k-reconfigured schedule (paper §II-B): a kN:M packed matrix is
    consumed in k sequential N:M passes that time-share the read ports.

    Numerically identical to ``demm_spmm(packed, b)`` up to the order of the
    float32 sums; exists to validate the reconfiguration semantics and to
    drive the perf model's cycle counts.  Each pass holds only N of the Ne
    read rows, so its intermediates are 1/k of :func:`demm_spmm`'s.
    """
    ne = packed.cfg.n_effective
    if ne % k:
        raise ValueError(f"k={k} does not divide n_effective={ne}")
    split = reconfigure_k(packed, k)
    r = packed.shape[0]
    g = packed.values.shape[1]
    b_blocks = _b_blocks(packed, b)
    vals = split.values.reshape(r, g, k, ne // k)
    idx = split.indices.reshape(r, g, k, ne // k)

    acc = torch.zeros((r, b.shape[1]), dtype=torch.float32, device=b.device)
    for pass_i in range(k):
        contribs = _group_contribs(vals[:, :, pass_i], idx[:, :, pass_i],
                                   b_blocks)
        acc = acc + contribs.sum(dim=0)
    return acc.to(out_dtype)
