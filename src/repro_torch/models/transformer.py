"""Model assembly: the decoder LM of the ``dense`` family.

    model = build_model(cfg, device=...)          # models/families.py
    state = model.init_decode_state(batch, max_len)
    logits, state = model.decode_step(state, tokens, policy=ExecPolicy(...))

    state = model.init_decode_state(batch, max_len, paged=PagedLayout(...))
    logits, state = model.prefill_chunk(state, tokens, slot, n_valid)

``DecoderLM`` is an ``nn.Module`` whose layers sit in an ``nn.ModuleList`` (a
Python loop over layers takes the place of the JAX package's scan over a
stacked layer axis).  Decode against full-attention append caches,
``(L, B, S, Hkv, Dh)``, or against a paged KV arena ``(L, Np, P, Hkv, Dh)``
with per-slot block tables, and chunked prefill into the paged arena are
ported; whole-sequence prefill, training loss, windowed ring buffers,
experts and the other families come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_linear import resolve_policy
from repro_torch.device import require_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_embedding,
    apply_mlp,
    apply_rmsnorm,
    apply_unembedding,
    dtype_of,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    rope_tables,
)


class TBlock(nn.Module):
    """Standard transformer block: attention + gated MLP, pre-norm."""

    def __init__(self, ln1, attn_block, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_block, ln2, mlp


def init_tblock(cfg: ArchConfig, *, generator: torch.Generator, device,
                dtype=torch.float32) -> TBlock:
    d = cfg.d_model
    sp = cfg.sparsity
    return TBlock(
        init_rmsnorm(d, device=device, dtype=dtype),
        attn.init_attention(
            d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            sparse=sp if "attn_qkv" in cfg.sparse_scope else None,
            generator=generator, device=device, dtype=dtype),
        init_rmsnorm(d, device=device, dtype=dtype),
        init_mlp(d, cfg.d_ff,
                 sparse=sp if "mlp" in cfg.sparse_scope else None,
                 generator=generator, device=device, dtype=dtype))


def _check_ported(cfg: ArchConfig):
    if (cfg.attention != "full" or cfg.moe is not None or cfg.ssm is not None
            or cfg.frontend is not None or cfg.encoder_layers):
        raise NotImplementedError(
            f"{cfg.name}: only dense full-attention decoders are ported so "
            f"far (attention={cfg.attention!r}, moe={cfg.moe is not None}, "
            f"ssm={cfg.ssm is not None}, frontend={cfg.frontend!r})")


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, embed, unembed, final_norm, layers):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = embed
        self.unembed = unembed
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)

    @classmethod
    def init(cls, cfg: ArchConfig, *, device,
             generator: Optional[torch.Generator] = None,
             seed: int = 0) -> "DecoderLM":
        """Random weights from ``generator`` (or a fresh one seeded with
        ``seed``), created on ``device`` layer by layer so that nothing but
        the weights themselves is ever resident."""
        _check_ported(cfg)
        device = require_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
        dtype = dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device, dtype=dtype)
        return cls(
            cfg,
            init_embedding(cfg.padded_vocab, cfg.d_model, **kw),
            init_embedding(cfg.padded_vocab, cfg.d_model, **kw),
            init_rmsnorm(cfg.d_model, device=device, dtype=dtype),
            [init_tblock(cfg, **kw) for _ in range(cfg.num_layers)])

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ---- serving ----
    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, device=None, paged=None):
        """Decode state: per-layer append caches stacked on a leading layer
        axis plus the per-slot write position.

        ``paged`` (a ``repro_torch.paged.PagedLayout``) swaps the per-slot
        caches for one shared arena of pages per layer, ``(L, Np, P, Hkv,
        Dh)``, with a block table (B, NBLK) and a decode mask ``active``
        (B,) bool; only full-attention caches are paged, as in the JAX
        package."""
        cfg = self.cfg
        device = device if device is not None else self.device
        hkv, dh, l = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
        pos = torch.zeros((batch,), dtype=torch.int64, device=device)
        if paged is not None:
            if cfg.attention != "full":
                raise NotImplementedError(
                    f"paged KV cache needs attention='full' (got "
                    f"{cfg.attention!r}): windowed ring buffers are already "
                    f"O(window) per slot")
            shape = (l, paged.num_pages, paged.page_size, hkv, dh)
            return {
                "caches": {
                    "kind": "paged", "layout": paged,
                    "k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device),
                    "block_table": torch.zeros((batch, paged.max_blocks),
                                               dtype=torch.int64,
                                               device=device),
                    "active": torch.zeros((batch,), dtype=torch.bool,
                                          device=device)},
                "pos": pos,
            }
        shape = (l, batch, max_len, hkv, dh)
        return {
            "caches": {"kind": "full",
                       "k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)},
            "pos": pos,
        }

    def _decode_ffn(self, blk: TBlock, x, policy):
        h = apply_rmsnorm(blk.ln2, x)
        h = apply_mlp(blk.mlp, h, policy=policy)
        return x + h

    def _decode_full_layer(self, blk: TBlock, x, cache, pos, window, policy,
                           rope=None):
        cfg = self.cfg
        h = apply_rmsnorm(blk.ln1, x)
        h, nc = attn.apply_attention_decode(
            blk.attn, h, cache, pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=window, policy=policy, rope=rope)
        return self._decode_ffn(blk, x + h, policy), nc

    def _decode_paged_layer(self, blk: TBlock, x, arena_k, arena_v, bt,
                            active, pos, policy, rope=None):
        cfg = self.cfg
        h = apply_rmsnorm(blk.ln1, x)
        h, _ = attn.apply_attention_decode_paged(
            blk.attn, h, arena_k, arena_v, bt, active, pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            policy=policy, rope=rope)
        return self._decode_ffn(blk, x + h, policy)

    def decode_step(self, state, tokens, *, policy=None):
        """One token per slot: tokens (B, 1) -> logits (B, 1, V).  The KV
        caches (or the paged arena) in ``state`` are updated in place; the
        returned state carries them and the advanced positions: every slot
        advances by one with dense caches, only the ``active`` lanes with a
        paged arena (prefilling and empty slots keep their position, and
        their writes went to the null page)."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        dtype = dtype_of(cfg.compute_dtype)
        x = apply_embedding(self.embed, tokens).to(dtype)
        pos = state["pos"]
        caches = state["caches"]
        kind = caches["kind"]
        if kind not in ("full", "paged"):
            raise NotImplementedError(
                f"decode cache kind {kind!r} is not ported yet")
        # the rotary tables depend on the positions only: once per step
        rope = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
        for i, blk in enumerate(self.layers):
            # caches["k"][i] is a view: the layer writes into it in place
            if kind == "paged":
                x = self._decode_paged_layer(
                    blk, x, caches["k"][i], caches["v"][i],
                    caches["block_table"], caches["active"], pos, policy,
                    rope)
            else:
                x, _ = self._decode_full_layer(
                    blk, x, {"k": caches["k"][i], "v": caches["v"][i]}, pos,
                    -1, policy, rope)
        x = apply_rmsnorm(self.final_norm, x)
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        step = caches["active"].to(pos.dtype) if kind == "paged" else 1
        return logits, {"caches": caches, "pos": pos + step}

    def prefill_chunk(self, state, tokens, slot, n_valid, *, policy=None):
        """Ingest one K-token chunk of a single sequence into its pages.

        ``tokens`` is a fixed-size (K,) chunk, padded past ``n_valid``;
        ``slot`` and ``n_valid`` are one-element (or 0-d) tensors on the
        state's device, or ints, so that one captured program serves every
        chunk of every request: nothing here reads a device value on the
        host, and no shape depends on ``n_valid``.  The arena in ``state``
        is written in place.  Returns the logits at the last *valid*
        position, (1, 1, V), so that the final chunk yields the first
        sampled token, and the state with ``pos[slot]`` advanced by
        ``n_valid`` (a new tensor, as :meth:`decode_step` returns).
        """
        policy = resolve_policy(policy)
        cfg = self.cfg
        caches = state["caches"]
        if caches["kind"] != "paged":
            raise NotImplementedError(
                "prefill_chunk requires a paged decode state "
                "(init_decode_state(..., paged=PagedLayout))")
        dtype = dtype_of(cfg.compute_dtype)
        dev = state["pos"].device
        slot = torch.as_tensor(slot, dtype=torch.int64, device=dev).reshape(1)
        n_valid = torch.as_tensor(n_valid, dtype=torch.int64,
                                  device=dev).reshape(1)
        pos0 = state["pos"].index_select(0, slot)                 # (1,)
        row = caches["block_table"].index_select(0, slot)[0]      # (NBLK,)
        x = apply_embedding(self.embed, tokens[None]).to(dtype)  # (1, K, D)
        apos = (torch.arange(tokens.shape[0], device=dev) + pos0)[None, :]
        rope = rope_tables(apos, cfg.resolved_head_dim, cfg.rope_theta)
        for i, blk in enumerate(self.layers):
            h = apply_rmsnorm(blk.ln1, x)
            h, _ = attn.apply_attention_prefill_paged(
                blk.attn, h, caches["k"][i], caches["v"][i], row, pos0,
                n_valid, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                policy=policy, rope=rope)
            x = self._decode_ffn(blk, x + h, policy)
        x = apply_rmsnorm(self.final_norm, x)
        last = x.index_select(1, n_valid - 1)                     # (1, 1, D)
        logits = apply_unembedding(self.unembed, last, cfg.vocab_size)
        return logits, {"caches": caches,
                        "pos": state["pos"].index_add(0, slot, n_valid)}
