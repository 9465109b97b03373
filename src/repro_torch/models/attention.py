"""Attention: grouped-query decode against a dense KV cache.

Decode computes one new token against a cache of S past tokens, as one stable
softmax reduction over S.  Scores and softmax are float32.  These are plain
tensor ops here as they are plain array ops in the JAX package; chunked
flash-style prefill attention and the paged-cache paths are not ported yet.

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


# ---------------------------------------------------------------------------
# Attention block (init + decode apply)
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


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  *, device, dtype=torch.bfloat16):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
