"""Attention: grouped-query decode against a dense KV cache, causal chunk
attention for prefill, and the paged-arena paths.

Decode computes one new token against a cache of S past tokens, as one stable
softmax reduction over S.  A prefill chunk of T queries attends to a cache of
S positions under the causal mask (:func:`flash_attention`).  Scores and
softmax are float32.  These are plain tensor ops here as they are plain array
ops in the JAX package.

The paged KV cache: one arena of fixed-size pages shared by every sequence,
reached through per-sequence block tables (``repro_torch.paged``).  The JAX
package builds a new arena on every write; here the arena is one tensor for
the engine's life and the writes go into it in place, which is what a CUDA
graph that replays the step needs.

Window semantics: ``window`` <= 0 or None means unbounded (full causal); a
positive window w lets position t attend to [t-w+1, t].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import (apply_linear, apply_rope, init_linear,
                                       rope_tables)

NEG_INF = -1e30


def _windowed(window) -> bool:
    return window is not None and window > 0


def _gqa_scores(q, k):
    """q: (B, Tq, Hq, Dh), k: (B, S, Hkv, Dh) -> (B, Hq, Tq, S), float32."""
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, tq, hkv, group, dh)
    s = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(b, hkv * group, tq, k.shape[1])


def _gqa_out(p, v):
    """p: (B, Hq, Tq, S), v: (B, S, Hkv, Dh) -> (B, Tq, Hq, Dh), float32."""
    b, hq, tq, s = p.shape
    hkv = v.shape[2]
    group = hq // hkv
    pg = p.reshape(b, hkv, group, tq, s)
    o = torch.einsum("bhgts,bshd->bthgd", pg, v.to(torch.float32))
    return o.reshape(b, tq, hq, v.shape[-1])


def decode_attention(q, k_cache, v_cache, cache_len, *, window=-1):
    """One-token attention against the cache.

    q (B, 1, Hq, Dh); caches (B, S, Hkv, Dh); ``cache_len`` (B,) valid
    lengths with the new token already written.
    """
    b, s, hkv, dh = k_cache.shape
    scale = dh ** -0.5
    logits = _gqa_scores(q, k_cache) * scale          # (B, Hq, 1, S)
    pos = torch.arange(s, device=q.device)[None, :]   # (1, S)
    valid = pos < cache_len[:, None]
    if _windowed(window):
        valid = valid & (pos > cache_len[:, None] - 1 - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype,
                                    device=logits.device))
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - m)
    out = _gqa_out(p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30), v_cache)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    q_offset=0):
    """Causal attention of T queries against S keys.  Returns (B, T, Hq, Dh)
    in q's dtype.

    q (B, T, Hq, Dh); k, v (B, S, Hkv, Dh).  ``q_offset`` is the absolute
    position of ``q[:, 0]`` (a prefill continuation): an int or a tensor of
    one element on q's device, so that a captured program reads it anew on
    every replay.  Query t sees key s iff s <= q_offset + t (and, with a
    window, s > q_offset + t - window): the triangle inside the chunk and
    every earlier chunk.  For a query at t < n_valid of a padded chunk this
    excludes every position at or beyond ``q_offset + n_valid``, which holds
    nothing this sequence wrote.

    The JAX package runs the same mask as an online softmax over KV chunks
    (so that 32k-token prefill fits); a serving chunk of 32 queries against
    at most ``max_len`` keys fits whole, so this is one masked softmax, the
    normalisation applied after the value product as there.
    """
    b, t, hq, dh = q.shape
    s = k.shape[1]
    scale = dh ** -0.5
    logits = _gqa_scores(q, k) * scale                  # (B, Hq, T, S)
    if causal or _windowed(window):
        q_pos = (torch.arange(t, device=q.device) + q_offset)[:, None]
        kv_pos = torch.arange(s, device=q.device)[None, :]
        mask = (kv_pos <= q_pos if causal else
                torch.ones((t, s), dtype=torch.bool, device=q.device))
        if _windowed(window):
            mask = mask & (kv_pos > q_pos - window)
        logits = torch.where(mask[None, None], logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1).clamp_min(1e-30)               # (B, Hq, T)
    out = _gqa_out(p, v) / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV cache indexing
# ---------------------------------------------------------------------------
#
# Page 0 is the reserved null page: block-table entries of positions not yet
# allocated point there, and the writes of masked lanes (empty or prefilling
# slots in a decode step, padded rows of a prefill chunk) are redirected
# there.  Several of them can land on one row of page 0 in one indexed write,
# so its content is not deterministic; it is never read unmasked.

NULL_PAGE = 0


def gather_pages(arena: torch.Tensor, block_table: torch.Tensor):
    """Per-sequence caches gathered from the shared arena.

    arena (Np, P, Hkv, Dh); block_table (B, NBLK) page ids in sequence order.
    Returns (B, NBLK*P, Hkv, Dh), where position ``s`` holds the KV of
    absolute token position ``s`` (a copy).
    """
    b, nblk = block_table.shape
    p = arena.shape[1]
    return arena[block_table].reshape(b, nblk * p, *arena.shape[2:])


def _page_of(table: torch.Tensor, apos: torch.Tensor, p: int):
    """Block index of absolute positions ``apos``, kept inside the table: a
    live lane never addresses past it, and an index past it would fault on
    the device (the JAX package's gather clamps it)."""
    return (torch.div(apos, p, rounding_mode="floor")
            .clamp(max=table.shape[-1] - 1))


def scatter_token_pages(arena: torch.Tensor, block_table: torch.Tensor,
                        pos: torch.Tensor, new: torch.Tensor,
                        active: Optional[torch.Tensor] = None):
    """Write one token per sequence into its page, in place (decode step).

    new (B, 1, Hkv, Dh) goes to absolute positions pos (B,).  Lanes with
    ``active`` False (empty slots, slots still prefilling) are redirected to
    the null page so that a batched step cannot touch their pages.  Returns
    ``arena``.
    """
    p = arena.shape[1]
    page = block_table.gather(1, _page_of(block_table, pos, p)[:, None])[:, 0]
    if active is not None:
        page = torch.where(active, page, NULL_PAGE)
    arena[page, pos % p] = new[:, 0].to(arena.dtype)
    return arena


def scatter_chunk_pages(arena: torch.Tensor, row_table: torch.Tensor,
                        pos0: torch.Tensor, new: torch.Tensor,
                        n_valid: torch.Tensor):
    """Write a K-token prefill chunk of ONE sequence into its pages, in place.

    new (K, Hkv, Dh) for absolute positions pos0..pos0+K-1 (``pos0`` and
    ``n_valid`` one-element tensors, or ints); rows >= n_valid (the padding
    of a last partial chunk) go to the null page.  row_table (NBLK,): this
    sequence's block-table row.  Returns ``arena``.
    """
    k = new.shape[0]
    p = arena.shape[1]
    rows = torch.arange(k, device=arena.device)
    apos = rows + pos0
    page = torch.where(rows < n_valid, row_table[_page_of(row_table, apos, p)],
                       NULL_PAGE)
    arena[page, apos % p] = new.to(arena.dtype)
    return arena


# ---------------------------------------------------------------------------
# Attention block (init + decode / prefill apply)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attention(d: int, num_heads: int, num_kv_heads: int, head_dim: int,
                   *, sparse=None, generator: torch.Generator, device,
                   dtype=torch.float32) -> Attention:
    kw = dict(sparse=sparse, generator=generator, device=device, dtype=dtype)
    return Attention(
        init_linear(d, num_heads * head_dim, name="wq", **kw),
        init_linear(d, num_kv_heads * head_dim, name="wk", **kw),
        init_linear(d, num_kv_heads * head_dim, name="wv", **kw),
        init_linear(num_heads * head_dim, d, name="wo", **kw))


def _project_qkv(attn: Attention, x, kv_x, num_heads, num_kv_heads, head_dim,
                 policy):
    b, t, _ = x.shape
    skv = kv_x.shape[1]
    q = apply_linear(attn.wq, x, policy=policy)
    k = apply_linear(attn.wk, kv_x, policy=policy)
    v = apply_linear(attn.wv, kv_x, policy=policy)
    return (q.reshape(b, t, num_heads, head_dim),
            k.reshape(b, skv, num_kv_heads, head_dim),
            v.reshape(b, skv, num_kv_heads, head_dim))


def _write_kv(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor):
    """Replace row ``pos[b]`` of ``cache[b]`` with ``new[b, 0]``, in place.

    The JAX package blends with a one-hot of ``pos`` over the S axis, which
    replaces (never accumulates into) the row and writes nothing when ``pos``
    lies past the cache; an indexed in-place write of the same row gives the
    same cache without copying it.  Rows past the cache (an idle slot whose
    position keeps advancing) are kept as they are.
    """
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos.clamp(max=s - 1)
    inside = (pos < s)[:, None, None]
    cache[rows, idx] = torch.where(inside, new[:, 0].to(cache.dtype),
                                   cache[rows, idx])


def apply_attention_decode(attn: Attention, x, cache, pos, *, num_heads,
                           num_kv_heads, head_dim, rope_theta, window=-1,
                           policy=None, rope=None):
    """One-token decode.  cache: {"k": (B,S,Hkv,Dh), "v": ...}, updated in
    place; pos: (B,) index at which to write the new KV (== current length).
    ``rope`` takes the ``rope_tables`` of ``pos[:, None]`` when the caller has
    them already (they are the same for every layer of a step).
    Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(attn, x, x, num_heads, num_kv_heads,
                                   head_dim, policy)
    if rope is None:
        rope = rope_tables(pos[:, None], head_dim, rope_theta)
    q = apply_rope(q, pos[:, None], rope_theta, rope)
    k_new = apply_rope(k_new, pos[:, None], rope_theta, rope)
    _write_kv(cache["k"], pos, k_new)
    _write_kv(cache["v"], pos, v_new)
    out = decode_attention(q, cache["k"], cache["v"], pos + 1, window=window)
    out = out.reshape(b, 1, num_heads * head_dim)
    out = apply_linear(attn.wo, out, policy=policy)
    return out, cache


def apply_attention_decode_paged(attn: Attention, x, arena_k, arena_v,
                                 block_table, active, pos, *, num_heads,
                                 num_kv_heads, head_dim, rope_theta,
                                 policy=None, rope=None):
    """One-token decode against a paged KV arena.

    arena_k/arena_v (Np, P, Hkv, Dh), written in place; block_table (B,
    NBLK); active (B,) bool decode mask; pos (B,) absolute write positions.
    The new KV goes into the owning page (the null page for inactive
    lanes), then every sequence's cache is gathered back and attention runs
    as in the dense-cache path (unbounded window: only full-attention caches
    are paged): the same masks over the same length when ``NBLK * P``
    equals the dense ``max_len``.  ``rope`` as in
    :func:`apply_attention_decode`.  Returns (out (B,1,D), (arena_k,
    arena_v)).
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(attn, x, x, num_heads, num_kv_heads,
                                   head_dim, policy)
    if rope is None:
        rope = rope_tables(pos[:, None], head_dim, rope_theta)
    q = apply_rope(q, pos[:, None], rope_theta, rope)
    k_new = apply_rope(k_new, pos[:, None], rope_theta, rope)
    scatter_token_pages(arena_k, block_table, pos, k_new, active)
    scatter_token_pages(arena_v, block_table, pos, v_new, active)
    k_c = gather_pages(arena_k, block_table)
    v_c = gather_pages(arena_v, block_table)
    out = decode_attention(q, k_c, v_c, pos + 1)
    out = out.reshape(b, 1, num_heads * head_dim)
    out = apply_linear(attn.wo, out, policy=policy)
    return out, (arena_k, arena_v)


def apply_attention_prefill_paged(attn: Attention, x, arena_k, arena_v,
                                  row_table, pos0, n_valid, *, num_heads,
                                  num_kv_heads, head_dim, rope_theta,
                                  policy=None, rope=None):
    """One K-token prefill chunk of ONE sequence against the paged arena.

    x (1, K, D): the embedded chunk at absolute positions pos0..pos0+K-1
    (``pos0``, ``n_valid``: one-element tensors; rows >= n_valid are the
    padding of a last partial chunk, whose KV goes to the null page).  The
    chunk's KV is written into the sequence's pages first, then the K
    queries attend to the gathered cache with ``q_offset=pos0``
    (:func:`flash_attention`).  ``rope`` takes the :func:`rope_tables` of
    the chunk's positions when the caller has them.  Returns (out (1, K,
    D), (arena_k, arena_v)).
    """
    b, k_tok, _ = x.shape
    q, k_new, v_new = _project_qkv(attn, x, x, num_heads, num_kv_heads,
                                   head_dim, policy)
    apos = (torch.arange(k_tok, device=x.device) + pos0)[None, :]
    if rope is None:
        rope = rope_tables(apos, head_dim, rope_theta)
    q = apply_rope(q, apos, rope_theta, rope)
    k_new = apply_rope(k_new, apos, rope_theta, rope)
    scatter_chunk_pages(arena_k, row_table, pos0, k_new[0], n_valid)
    scatter_chunk_pages(arena_v, row_table, pos0, v_new[0], n_valid)
    k_c = gather_pages(arena_k, row_table[None])
    v_c = gather_pages(arena_v, row_table[None])
    out = flash_attention(q, k_c, v_c, causal=True, q_offset=pos0)
    out = out.reshape(b, k_tok, num_heads * head_dim)
    return apply_linear(attn.wo, out, policy=policy), (arena_k, arena_v)


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  *, device, dtype=torch.bfloat16):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
