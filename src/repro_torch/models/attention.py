"""Attention: grouped-query attention with full, sliding-window and
local:global patterns; decode against a dense KV cache, whole-sequence and
chunked prefill through a chunked online-softmax attention, and the
paged-arena paths.

Decode computes one new token against a cache of S past tokens, as one stable
softmax reduction over S.  Prefill (a whole sequence, or a chunk of one that
continues at ``q_offset``) runs :func:`flash_attention`: an outer loop over
query chunks and an inner loop over key chunks with an online-softmax
accumulator, so that the scores held at once are O(q_chunk * kv_chunk)
instead of O(T * S); with a window known when the call is made, the inner
loop visits only the key chunks that meet the band.  Scores and softmax are
float32.  These are plain tensor ops here as they are plain array ops in the
JAX package.

The paged KV cache: one arena of fixed-size pages shared by every sequence,
reached through per-sequence block tables (``repro_torch.paged``).  The JAX
package builds a new arena on every write; here the arena is one tensor for
the engine's life and the writes go into it in place, which is what a CUDA
graph that replays the step needs.

Window semantics: ``window`` <= 0 or None means unbounded (full causal); a
positive window w lets position t attend to [t-w+1, t].

Tensor parallelism (``repro_torch.sharding``): under a sharding context of tp
ranks every rank projects its ``num_heads // tp`` query heads and its block
of the KV heads (:func:`local_heads`), attends with them and feeds its chunk
of the heads to the row-parallel ``wo``.  Where the heads do not split, the
JAX package's ``_constrain_heads`` fallback: KV heads that do not divide tp
are whole on every rank (wk / wv column-parallel and their outputs gathered,
or with ``ShardingPlan(attn_kv_replicated=True)`` whole weights), and each
local query head reads its own KV head (:func:`_kv_for_queries`); query heads
that do not divide tp either gather q too, attention runs whole on every
rank and each rank feeds its chunk of the output's columns to ``wo``.  The
placement gathers (one ``gather`` segment of a projection's ``tp_rows``);
the layout hint is here a check of the local head count
(``sharding.context.check_heads``).

Long-context decode (a context with ``seq_shard_cache``): each dense KV
cache is split by position over ``data``, and one decode step writes the
new token on the rank that holds its position, takes each rank's partial
softmax (:func:`decode_attention_partial`) and combines them with three
all-reduces over ``data`` (:func:`combine_partials`): the flash-decode
combine that GSPMD derives from the JAX package's single stable-softmax
reduction over S.  Ring buffers stay whole (their length does not grow
with the sequence).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import (apply_linear, apply_rope, init_linear,
                                       rope_tables)
from repro_torch.sharding.context import check_heads, get_context

NEG_INF = -1e30


def _windowed(window) -> bool:
    return window is not None and window > 0


def local_heads(num_heads: int, num_kv_heads: int):
    """(query heads, KV heads) this rank computes with: all of them without
    a sharding context, its blocks under tp."""
    ctx = get_context()
    if ctx is None or ctx.tp == 1:
        return num_heads, num_kv_heads
    return ctx.local_heads(), ctx.local_kv_heads()


def _kv_for_queries(k):
    """K (or V) (B, S, Hkv, Dh) lined up with this rank's query heads: as
    it is, unless its heads are whole on every rank while the query heads
    split (KV heads that do not split over tp), where each local query head
    takes the KV head its global index maps to (B, S, Hq_local, Dh)."""
    ctx = get_context()
    index = None if ctx is None or ctx.tp == 1 else ctx.kv_head_index()
    if index is None:
        return k
    return k.index_select(2, index.to(k.device))


def _gqa_scores(q, k):
    """q: (B, Tq, Hq, Dh), k: (B, S, Hkv, Dh) -> (B, Hq, Tq, S), float32."""
    k = _kv_for_queries(k)
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, tq, hkv, group, dh)
    s = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(b, hkv * group, tq, k.shape[1])


def _gqa_out(p, v):
    """p: (B, Hq, Tq, S), v: (B, S, Hkv, Dh) -> (B, Tq, Hq, Dh), float32."""
    v = _kv_for_queries(v)
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


def decode_attention_partial(q, k_cache, v_cache, cache_len, *, window=-1,
                             positions=None, first: int = 0):
    """One block's partial softmax of one-token attention: the flash-decode
    split of :func:`decode_attention` over a cache whose positions are
    spread over ranks (long-context decode, ``seq_shard_cache``).

    The block's S slots hold absolute positions ``positions`` (B, S) — a
    ring's ``slot_pos``, -1 when empty — or, by default, ``first`` ..
    ``first + S - 1`` (a rank's block of a dense cache).  The masks are
    :func:`decode_attention`'s on those positions.  Returns, float32, the
    block's max logit ``m`` (B, Hq, 1, 1), its sum ``l`` of e^(logit - m)
    (B, Hq, 1, 1) and its unnormalised output ``o`` = the sum of e^(logit -
    m) v (B, 1, Hq, Dh); :func:`combine_partials` merges the blocks."""
    s, dh = k_cache.shape[1], k_cache.shape[-1]
    logits = _gqa_scores(q, k_cache) * dh ** -0.5     # (B, Hq, 1, S)
    if positions is None:
        positions = torch.arange(first, first + s, device=q.device)[None, :]
    valid = (positions >= 0) & (positions < cache_len[:, None])
    if _windowed(window):
        valid = valid & (positions > cache_len[:, None] - 1 - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, dtype=logits.dtype,
                                    device=logits.device))
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - m)
    return m, p.sum(dim=-1, keepdim=True), _gqa_out(p, v_cache)


def combine_partials(m, l, o, reduce):
    """Merge the blocks' partial softmaxes (:func:`decode_attention_partial`)
    into the attention output (B, 1, Hq, Dh), float32: ``reduce(t, op)``
    reduces ``t`` over the blocks in place — ``op`` ``ReduceOp.MAX``, or
    None for a sum (``ShardingContext.data_reduce_``: three all-reduces over
    ``data``, the combine GSPMD derives from the JAX package's single
    reduction).  M = max m; L = sum of l e^(m - M); O = sum of o e^(m - M);
    the output is O / L.  A block with no valid position (m = NEG_INF)
    weighs e^(NEG_INF - M) = 0."""
    import torch.distributed as dist

    big = reduce(m.clone(), dist.ReduceOp.MAX)
    w = torch.exp(m - big)
    l_all = reduce(l * w, None)
    o_all = reduce(o * w.transpose(-3, -2), None)
    return o_all / l_all.transpose(-3, -2).clamp_min(1e-30)


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    static_window: Optional[int] = None, q_offset=0,
                    q_chunk: int = 512, kv_chunk: int = 1024):
    """Chunked online-softmax attention of T queries against S keys.
    Returns (B, T, Hq, Dh) in q's dtype.

    q (B, T, Hq, Dh); k, v (B, S, Hkv, Dh).  The queries go in chunks of
    ``q_chunk`` and, for each, the keys in chunks of ``kv_chunk`` with a
    running (max, sum, output) accumulator in float32, so that the scores
    held at once are (B, Hq, q_chunk, kv_chunk) whatever T and S; T and S
    are padded to whole chunks and the padded keys masked.  Query t sees
    key s iff s <= q_offset + t when ``causal`` and, with a window w > 0, s
    > q_offset + t - w.

    ``q_offset`` is the absolute position of ``q[:, 0]`` (a prefill
    continuation): an int, or a tensor of one element on q's device so that
    a captured program reads it anew on every replay.  Nothing here reads
    it on the host and no shape depends on it.

    ``static_window`` (an int known when the call is made: the sliding-
    window archs, gemma3's local layers) sets the window and makes the key
    loop visit only the ``min(n_kv, (W + q_chunk - 2) // kv_chunk + 2)``
    chunks that can meet a query chunk's band, from the one holding position
    ``q0 - W + 1`` clipped into the key range, instead of all ``S /
    kv_chunk``.  The band's first chunk depends on ``q_offset``: with a
    tensor ``q_offset`` the chunk is gathered by a device index.
    """
    b, t, hq, dh = q.shape
    s = k.shape[1]
    dev, out_dtype = q.device, q.dtype
    scale = dh ** -0.5
    q_chunk = min(q_chunk, t)
    kv_chunk = min(kv_chunk, s)
    tp = -(-t // q_chunk) * q_chunk
    sp = -(-s // kv_chunk) * kv_chunk
    # float32 once here: the products below take float32 operands (exact
    # casts), so that the loops cast nothing
    f32 = torch.float32
    qp = torch.nn.functional.pad(q.to(f32), (0, 0, 0, 0, 0, tp - t))
    kp = torch.nn.functional.pad(k.to(f32), (0, 0, 0, 0, 0, sp - s))
    vp = torch.nn.functional.pad(v.to(f32), (0, 0, 0, 0, 0, sp - s))
    n_q, n_kv = tp // q_chunk, sp // kv_chunk
    if static_window is not None and static_window > 0:
        window = static_window
        n_band = min(n_kv, (static_window + q_chunk - 2) // kv_chunk + 2)
    else:
        n_band = n_kv
    windowed = _windowed(window)
    q_pos_base = torch.arange(q_chunk, device=dev)
    band_base = torch.arange(n_band * kv_chunk, device=dev)
    neg = torch.full((), NEG_INF, dtype=f32, device=dev)
    outs = []
    for qi in range(n_q):
        qc = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = q_pos_base + qi * q_chunk + q_offset
        if n_band < n_kv:
            # the first chunk that can hold position q0 - W + 1
            first = qi * q_chunk + q_offset - window + 1
            if isinstance(first, torch.Tensor):
                base = torch.div(first, kv_chunk, rounding_mode="floor") \
                    .clamp(0, n_kv - n_band)
            else:
                base = min(max(first // kv_chunk, 0), n_kv - n_band)
        else:
            base = 0
        # the positions of the band's keys and the mask of the whole band,
        # (q_chunk, n_band * kv_chunk), once per query chunk
        kv_pos = (band_base + base * kv_chunk).reshape(-1)
        mask = (kv_pos < s)[None, :]                   # padding
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if windowed:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        acc = torch.zeros((b, hq, q_chunk, dh), dtype=f32, device=dev)
        m_run = torch.full((b, hq, q_chunk), NEG_INF, dtype=f32, device=dev)
        l_run = torch.zeros((b, hq, q_chunk), dtype=f32, device=dev)
        for j in range(n_band):
            cols = slice(j * kv_chunk, (j + 1) * kv_chunk)
            if isinstance(base, torch.Tensor):
                kc = kp.index_select(1, kv_pos[cols])
                vc = vp.index_select(1, kv_pos[cols])
            else:
                ki = base + j
                kc = kp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
                vc = vp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            logits = _gqa_scores(qc, kc) * scale      # (B, Hq, qc, kc) f32
            logits = torch.where(mask[None, None, :, cols], logits, neg)
            m_new = torch.maximum(m_run, logits.max(dim=-1).values)
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _gqa_out(p, vc).transpose(1, 2)
            m_run = m_new
        out = acc / l_run.clamp_min(1e-30)[..., None]     # (B, Hq, qc, Dh)
        outs.append(out.transpose(1, 2))                   # (B, qc, Hq, Dh)
    out = torch.cat(outs, dim=1)[:, :t] if n_q > 1 else outs[0][:, :t]
    return out.to(out_dtype)


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
    """q (B, T, Hq, Dh), k and v (B, S, Hkv, Dh) at this rank's head counts
    (:func:`local_heads`)."""
    b, t, _ = x.shape
    skv = kv_x.shape[1]
    hq, hkv = local_heads(num_heads, num_kv_heads)
    q = apply_linear(attn.wq, x, policy=policy).reshape(b, t, -1, head_dim)
    k = apply_linear(attn.wk, kv_x, policy=policy).reshape(b, skv, -1,
                                                           head_dim)
    v = apply_linear(attn.wv, kv_x, policy=policy).reshape(b, skv, -1,
                                                           head_dim)
    ctx = get_context()
    if k.shape[2] != hkv and ctx is not None:
        # wk / wv whole on every rank whose heads do split: this rank's
        k, v = ctx.local_block(k, 2), ctx.local_block(v, 2)
    return (check_heads(q, hq), check_heads(k, hkv), check_heads(v, hkv))


def apply_attention(attn: Attention, x, *, num_heads, num_kv_heads,
                    head_dim, rope_theta, positions=None, causal=True,
                    window=-1, static_window=None, kv_x=None, policy=None,
                    q_chunk=512, kv_chunk=1024):
    """Whole-sequence self-attention (``kv_x`` None) or cross-attention
    (``kv_x`` an encoder's output; non-causal, no rotary embedding) of x (B,
    T, D) -> (B, T, D).  ``positions`` (T,) or (B, T) default to 0..T-1;
    ``window`` / ``static_window`` as :func:`flash_attention` takes them."""
    b, t, _ = x.shape
    cross = kv_x is not None
    q, k, v = _project_qkv(attn, x, kv_x if cross else x, num_heads,
                           num_kv_heads, head_dim, policy)
    if not cross:
        if positions is None:
            positions = torch.arange(t, device=x.device)
        rope = rope_tables(positions, head_dim, rope_theta)
        q = apply_rope(q, positions, rope_theta, rope)
        k = apply_rope(k, positions, rope_theta, rope)
    out = flash_attention(q, k, v, causal=causal and not cross,
                          window=window, static_window=static_window,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.reshape(b, t, -1)
    return apply_linear(attn.wo, out, policy=policy)


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
    Under a context with ``seq_shard_cache`` and a ``data`` dim the cache
    is this rank's block of positions (block ``data_rank`` of ``data``
    equal blocks; a ``pod`` dim splits the batch instead): only the rank
    that holds ``pos`` writes, and the ranks' partial softmaxes are
    combined over ``data`` (:func:`combine_partials`).
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
    ctx = get_context()
    if ctx is not None and ctx.seq_shard_cache and ctx.data > 1:
        # this rank's block of positions [r S, (r + 1) S) of the cache: the
        # owner writes the new token, every rank its partial softmax
        s = cache["k"].shape[1]
        first = ctx.data_rank * s
        local = pos - first
        local = torch.where(local >= 0, local, s)    # not this rank's: past
        _write_kv(cache["k"], local, k_new)
        _write_kv(cache["v"], local, v_new)
        m, l, o = decode_attention_partial(q, cache["k"], cache["v"],
                                           pos + 1, window=window,
                                           first=first)
        out = combine_partials(m, l, o, ctx.data_reduce_).to(q.dtype)
    else:
        _write_kv(cache["k"], pos, k_new)
        _write_kv(cache["v"], pos, v_new)
        out = decode_attention(q, cache["k"], cache["v"], pos + 1,
                               window=window)
    out = out.reshape(b, 1, -1)
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
    out = out.reshape(b, 1, -1)
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
    (:func:`flash_attention` in one query chunk and one key chunk of the
    whole gathered length, unbanded: nothing about it depends on ``pos0``
    but the mask, so the chunk stays capturable).  One key chunk because
    eager PyTorch and a CUDA graph do not fuse the online softmax's
    per-chunk steps as XLA does: the reference's ``kv_chunk=128`` costs
    the chunk more launches and device time and saves nothing at a
    (1, H, K, S) float32 score tile.  ``rope`` takes the
    :func:`rope_tables` of the chunk's positions when the caller has them.
    Returns (out (1, K, D), (arena_k, arena_v)).
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
    out = flash_attention(q, k_c, v_c, causal=True, q_offset=pos0,
                          q_chunk=k_tok, kv_chunk=k_c.shape[1])
    out = out.reshape(b, k_tok, -1)
    return apply_linear(attn.wo, out, policy=policy), (arena_k, arena_v)


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  *, device, dtype=torch.bfloat16):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
