"""Model construction by architecture family, and the three families beside
the decoder LM: ``EncDecLM`` (seamless-m4t), ``HybridLM`` (zamba2) and
``XLSTMLM`` (xlstm), with ``DecoderLM``'s interface (``init``,
``train_loss`` = ``forward``, ``prefill``, ``init_decode_state``,
``decode_step``; ``EncDecLM`` also ``encode`` and the paged
``prefill_chunk``).

Their decode states are the JAX package's trees.  The recurrent states are
written in place by the step forms (``models/ssm.py``), as the KV caches
are: an engine keeps one state for its life and a captured step replays
reads and writes of its tensors.  The hybrid's and the xLSTM's states carry
no ``kind`` tag, and both refuse a paged layout, as the reference does (a
recurrent state has nothing to page), so speculation refuses them too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_linear import resolve_policy
from repro_torch.device import require_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_embedding, apply_linear,
                                       apply_rmsnorm, apply_unembedding,
                                       dtype_of, init_embedding, init_linear,
                                       init_rmsnorm, rope_tables)
from repro_torch.models.transformer import (FULL_WINDOW, LM, RING_EMPTY,
                                            TBlock, apply_tblock_seq,
                                            block_ffn, init_tblock,
                                            remat_call, softmax_xent)

# the one value every element of a fresh decode state's leaf holds, by the
# leaf's key in the state trees of every family here (any other leaf: 0):
# a ring slot's position (``transformer.init_ring_cache``) and the mLSTM /
# sLSTM stabilisers (``ssm.init_mlstm_state``, ``init_slstm_state``).  A
# state builder whose leaf starts elsewhere adds it here
STATE_FILL = {"slot_pos": RING_EMPTY, "m": ssm_mod.NEG_BIG}


def _generator(device, generator, seed):
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    return generator


def _views(tree: dict, *idx) -> dict:
    """The ``[idx]`` view of every tensor of a state dict."""
    return {k: v[idx] for k, v in tree.items()}


def _arange(x):
    return torch.arange(x.shape[1], device=x.device)


def _cross_ffn(cfg: ArchConfig, blk: TBlock, x, enc_out, policy):
    """A decoder block's cross-attention to ``enc_out`` and its feed-forward,
    each pre-norm and residual (the decode and chunk paths, after their
    self-attention)."""
    h = apply_rmsnorm(blk.ln_x, x)
    h = attn.apply_attention(
        blk.xattn, h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=False, window=-1, kv_x=enc_out, policy=policy)
    x = x + h
    return x + block_ffn(blk, x, cfg, policy)[0]


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t): audio-stub encoder + cross-attn decoder
# ---------------------------------------------------------------------------

class EncDecLM(LM):
    def __init__(self, cfg: ArchConfig, frame_proj, enc_layers, enc_norm,
                 embed, unembed, dec_layers, final_norm):
        super().__init__()
        self.cfg = cfg
        self.frame_proj = frame_proj
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_norm = enc_norm
        self.embed = embed
        self.unembed = unembed
        self.dec_layers = nn.ModuleList(dec_layers)
        self.final_norm = final_norm

    @classmethod
    def init(cls, cfg: ArchConfig, *, device,
             generator: Optional[torch.Generator] = None, seed: int = 0):
        device = require_device(device)
        dtype = dtype_of(cfg.param_dtype)
        kw = dict(generator=_generator(device, generator, seed),
                  device=device, dtype=dtype)
        d = cfg.d_model
        return cls(
            cfg, init_linear(d, d, sparse=None, name="frame_proj", **kw),
            [init_tblock(cfg, **kw) for _ in range(cfg.encoder_layers)],
            init_rmsnorm(d, device=device, dtype=dtype),
            init_embedding(cfg.padded_vocab, d, **kw),
            init_embedding(cfg.padded_vocab, d, **kw),
            [init_tblock(cfg, cross=True, **kw)
             for _ in range(cfg.num_layers)],
            init_rmsnorm(d, device=device, dtype=dtype))

    def encode(self, frames, *, policy=None):
        """frames (B, S_src, D): stub audio embeddings -> the encoder's
        output (B, S_src, D) in the compute dtype (non-causal blocks)."""
        cfg = self.cfg
        x = apply_linear(self.frame_proj,
                         frames.to(dtype_of(cfg.compute_dtype)))
        positions = _arange(x)
        for blk in self.enc_layers:
            x, _ = remat_call(cfg.remat, apply_tblock_seq, [blk], x, cfg=cfg,
                              window=FULL_WINDOW, positions=positions,
                              causal=False, policy=policy)
        return apply_rmsnorm(self.enc_norm, x)

    def _decode_seq(self, tokens, enc_out, *, policy):
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens).to(enc_out.dtype)
        positions = _arange(x)
        for blk in self.dec_layers:
            x, _ = remat_call(cfg.remat, apply_tblock_seq, [blk], x, cfg=cfg,
                              window=FULL_WINDOW, positions=positions,
                              enc_out=enc_out, policy=policy)
        return apply_rmsnorm(self.final_norm, x)

    def train_loss(self, batch, *, policy=None):
        """``(loss, {"xent"})`` of ``batch`` ({"frames" (B, S, D), "tokens",
        "targets" (B, T)})."""
        policy = resolve_policy(policy)
        enc_out = self.encode(batch["frames"], policy=policy)
        x = self._decode_seq(batch["tokens"], enc_out, policy=policy)
        logits = apply_unembedding(self.unembed, x, self.cfg.vocab_size)
        loss = softmax_xent(logits, batch["targets"])
        return loss, {"xent": loss}

    def prefill(self, batch, *, max_len: Optional[int] = None, policy=None):
        """The last position's logits and a fresh decode state holding the
        encoder's output (the self-attention caches are not filled, as in
        the reference)."""
        policy = resolve_policy(policy)
        enc_out = self.encode(batch["frames"], policy=policy)
        x = self._decode_seq(batch["tokens"], enc_out, policy=policy)
        logits = apply_unembedding(self.unembed, x[:, -1:],
                                   self.cfg.vocab_size)
        state = self.init_decode_state(x.shape[0], max_len or x.shape[1] + 1,
                                       enc_len=enc_out.shape[1])
        state["enc_out"] = enc_out
        return logits, state

    def init_decode_state(self, batch: int, max_len: int,
                          enc_len: Optional[int] = None,
                          dtype=torch.bfloat16, device=None, paged=None):
        """Self-attention caches (``full`` (L, B, S, Hkv, Dh), or a paged
        arena as ``DecoderLM``'s), the encoder's output ``enc_out`` (B,
        enc_len, D) — a dense per-slot tensor either way, read-only context
        — and ``pos``."""
        cfg = self.cfg
        device = device if device is not None else self.device
        hkv, dh, l = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
        enc_len = enc_len or max_len // cfg.encoder_seq_divisor
        if paged is not None:
            shape = (l, paged.num_pages, paged.page_size, hkv, dh)
            caches = {
                "kind": "paged", "layout": paged,
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "block_table": torch.zeros((batch, paged.max_blocks),
                                           dtype=torch.int64, device=device),
                "active": torch.zeros((batch,), dtype=torch.bool,
                                      device=device)}
        else:
            shape = (l, batch, max_len, hkv, dh)
            caches = {"kind": "full",
                      "k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
        return {"caches": caches,
                "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=dtype, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int64,
                                   device=device)}

    def decode_step(self, state, tokens, *, policy=None):
        """One token per slot: tokens (B, 1) -> logits (B, 1, V); the caches
        are written in place (a paged arena: only the ``active`` lanes
        advance)."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens).to(dtype_of(cfg.compute_dtype))
        pos, enc_out, caches = state["pos"], state["enc_out"], state["caches"]
        paged = caches["kind"] == "paged"
        rope = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
        heads = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.resolved_head_dim,
                     rope_theta=cfg.rope_theta, policy=policy, rope=rope)
        for i, blk in enumerate(self.dec_layers):
            h = apply_rmsnorm(blk.ln1, x)
            if paged:
                h, _ = attn.apply_attention_decode_paged(
                    blk.attn, h, caches["k"][i], caches["v"][i],
                    caches["block_table"], caches["active"], pos, **heads)
            else:
                h, _ = attn.apply_attention_decode(
                    blk.attn, h, {"k": caches["k"][i], "v": caches["v"][i]},
                    pos, window=FULL_WINDOW, **heads)
            x = _cross_ffn(cfg, blk, x + h, enc_out, policy)
        x = apply_rmsnorm(self.final_norm, x)
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        step = caches["active"].to(pos.dtype) if paged else 1
        return logits, {"caches": caches, "enc_out": enc_out,
                        "pos": pos + step}

    def prefill_chunk(self, state, tokens, slot, n_valid, *, policy=None):
        """Chunked paged prefill of one decoder sequence (see
        ``DecoderLM.prefill_chunk``); cross-attention reads the slot's dense
        ``enc_out`` row."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        caches = state["caches"]
        if caches["kind"] != "paged":
            raise NotImplementedError(
                "prefill_chunk requires a paged decode state")
        dev = state["pos"].device
        slot = torch.as_tensor(slot, dtype=torch.int64, device=dev).reshape(1)
        n_valid = torch.as_tensor(n_valid, dtype=torch.int64,
                                  device=dev).reshape(1)
        pos0 = state["pos"].index_select(0, slot)
        row = caches["block_table"].index_select(0, slot)[0]
        enc_slot = state["enc_out"].index_select(0, slot)        # (1, S, D)
        x = apply_embedding(self.embed, tokens[None]).to(
            dtype_of(cfg.compute_dtype))
        apos = (torch.arange(tokens.shape[0], device=dev) + pos0)[None, :]
        rope = rope_tables(apos, cfg.resolved_head_dim, cfg.rope_theta)
        for i, blk in enumerate(self.dec_layers):
            h = apply_rmsnorm(blk.ln1, x)
            h, _ = attn.apply_attention_prefill_paged(
                blk.attn, h, caches["k"][i], caches["v"][i], row, pos0,
                n_valid, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                policy=policy, rope=rope)
            x = _cross_ffn(cfg, blk, x + h, enc_slot, policy)
        x = apply_rmsnorm(self.final_norm, x)
        last = x.index_select(1, n_valid - 1)
        logits = apply_unembedding(self.unembed, last, cfg.vocab_size)
        return logits, {"caches": caches, "enc_out": state["enc_out"],
                        "pos": state["pos"].index_add(0, slot, n_valid)}


# ---------------------------------------------------------------------------
# Hybrid (zamba2): Mamba2 backbone + one SHARED attention+MLP block
# ---------------------------------------------------------------------------

class MixerLayer(nn.Module):
    """A pre-norm residual mixer layer: ``ln`` and the mixer, named as the
    reference names it (``mamba``, or ``blk`` in an xLSTM period)."""

    def __init__(self, ln, **mixer):
        super().__init__()
        self.ln = ln
        (name, mod), = mixer.items()
        setattr(self, name, mod)


class HybridLM(LM):
    """Mamba2 backbone with ONE shared attention+MLP block (``shared``, a
    single module) applied after every ``shared_attn_every``-th mamba layer:
    ``n_periods`` periods of that many mamba layers and the shared block,
    then a tail of the leftover mamba layers (zamba2: 13 periods of 6 and 3).
    The shared block keeps one KV cache per period."""

    def __init__(self, cfg: ArchConfig, embed, unembed, layers, shared,
                 final_norm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.unembed = unembed
        self.layers = nn.ModuleList(layers)
        self.shared = shared
        self.final_norm = final_norm

    @classmethod
    def init(cls, cfg: ArchConfig, *, device,
             generator: Optional[torch.Generator] = None, seed: int = 0):
        device = require_device(device)
        dtype = dtype_of(cfg.param_dtype)
        kw = dict(generator=_generator(device, generator, seed),
                  device=device, dtype=dtype)
        s, d = cfg.ssm, cfg.d_model
        sp = cfg.sparsity if "mlp" in cfg.sparse_scope else None
        layers = [MixerLayer(
            init_rmsnorm(d, device=device, dtype=dtype),
            mamba=ssm_mod.init_mamba2(
                d, expand=s.expand, state=s.state_dim, head_dim=s.head_dim,
                conv=s.conv_dim, sparse=sp, **kw))
            for _ in range(cfg.num_layers)]
        return cls(cfg, init_embedding(cfg.padded_vocab, d, **kw),
                   init_embedding(cfg.padded_vocab, d, **kw), layers,
                   init_tblock(cfg, **kw),
                   init_rmsnorm(d, device=device, dtype=dtype))

    def _ssm_kwargs(self):
        s = self.cfg.ssm
        return dict(expand=s.expand, state=s.state_dim, head_dim=s.head_dim)

    @staticmethod
    def layout(cfg: ArchConfig):
        """(period, n_periods, n_tail)."""
        period = cfg.shared_attn_every
        n_p = cfg.num_layers // period
        return period, n_p, cfg.num_layers - n_p * period

    def _mamba_layer(self, blk: MixerLayer, x, *, policy):
        h = ssm_mod.apply_mamba2_seq(
            blk.mamba, apply_rmsnorm(blk.ln, x), chunk=self.cfg.ssm.chunk,
            policy=policy, **self._ssm_kwargs())
        return x + h

    def _period_seq(self, *mods_x, positions, policy):
        """One period over the sequence x: its mamba layers, then the shared
        block (``mods_x``: the layers, the shared block, x)."""
        *blks, shared, x = mods_x
        for blk in blks:
            x = self._mamba_layer(blk, x, policy=policy)
        x, _ = apply_tblock_seq(shared, x, self.cfg, window=FULL_WINDOW,
                                positions=positions, policy=policy)
        return x

    def _seq(self, tokens, *, policy):
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens).to(
            dtype_of(cfg.compute_dtype))
        positions = _arange(x)
        period, n_p, _ = self.layout(self.cfg)
        for p in range(n_p):
            mods = list(self.layers[p * period:(p + 1) * period])
            x = remat_call(cfg.remat, self._period_seq, mods + [self.shared],
                           x, positions=positions, policy=policy)
        for blk in self.layers[n_p * period:]:       # the tail, not remat
            x = self._mamba_layer(blk, x, policy=policy)
        return apply_rmsnorm(self.final_norm, x)

    def train_loss(self, batch, *, policy=None):
        policy = resolve_policy(policy)
        x = self._seq(batch["tokens"], policy=policy)
        logits = apply_unembedding(self.unembed, x, self.cfg.vocab_size)
        loss = softmax_xent(logits, batch["targets"])
        return loss, {"xent": loss}

    def prefill(self, batch, *, max_len: Optional[int] = None, policy=None):
        """The last position's logits and a fresh decode state, as the
        reference returns them (the recurrent state is not carried)."""
        policy = resolve_policy(policy)
        x = self._seq(batch["tokens"], policy=policy)
        logits = apply_unembedding(self.unembed, x[:, -1:],
                                   self.cfg.vocab_size)
        return logits, self.init_decode_state(x.shape[0],
                                              max_len or x.shape[1] + 1)

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, device=None, paged=None):
        """{"ssm": mamba states (n_periods, period, B, ...), "ssm_tail":
        (max(n_tail, 1), B, ...), "attn": the shared block's caches per
        period {"k", "v"} (n_periods, B, S, Hkv, Dh), "pos"}."""
        if paged is not None:
            raise NotImplementedError(
                "paged KV cache is attention-only; HybridLM's Mamba2 "
                "backbone carries O(1) recurrent state per slot (nothing to "
                "page) and its single shared-attn cache is future work")
        cfg = self.cfg
        s = cfg.ssm
        device = device if device is not None else self.device
        period, n_p, n_tail = self.layout(self.cfg)
        kw = dict(expand=s.expand, state=s.state_dim, head_dim=s.head_dim,
                  conv=s.conv_dim, dtype=dtype, device=device)
        shape = (n_p, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {
            "ssm": ssm_mod.init_mamba2_state(batch, cfg.d_model,
                                             lead=(n_p, period), **kw),
            "ssm_tail": ssm_mod.init_mamba2_state(
                batch, cfg.d_model, lead=(max(n_tail, 1),), **kw),
            "attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)},
            "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
        }

    def _mamba_step(self, blk: MixerLayer, x, st, *, policy):
        h, _ = ssm_mod.apply_mamba2_step(
            blk.mamba, apply_rmsnorm(blk.ln, x), st, policy=policy,
            **self._ssm_kwargs())
        return x + h

    def decode_step(self, state, tokens, *, policy=None):
        """One token per slot; every state tensor is written in place."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens).to(
            dtype_of(cfg.compute_dtype))
        pos = state["pos"]
        period, n_p, n_tail = self.layout(self.cfg)
        shared = self.shared
        rope = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
        for p in range(n_p):
            for i in range(period):
                x = self._mamba_step(self.layers[p * period + i], x,
                                     _views(state["ssm"], p, i),
                                     policy=policy)
            h = apply_rmsnorm(shared.ln1, x)
            h, _ = attn.apply_attention_decode(
                shared.attn, h, _views(state["attn"], p), pos,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                window=FULL_WINDOW, policy=policy, rope=rope)
            x = x + h
            x = x + block_ffn(shared, x, cfg, policy)[0]
        for j in range(n_tail):
            x = self._mamba_step(self.layers[n_p * period + j], x,
                                 _views(state["ssm_tail"], j), policy=policy)
        x = apply_rmsnorm(self.final_norm, x)
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        return logits, {"ssm": state["ssm"], "ssm_tail": state["ssm_tail"],
                        "attn": state["attn"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# xLSTM: periodic superblocks of (slstm_every - 1) mLSTM + 1 sLSTM
# ---------------------------------------------------------------------------

class XLSTMPeriod(nn.Module):
    """One superblock: ``mlstm`` (slstm_every - 1 layers) then ``slstm``."""

    def __init__(self, mlstm, slstm):
        super().__init__()
        self.mlstm = nn.ModuleList(mlstm)
        self.slstm = slstm


class XLSTMLM(LM):
    def __init__(self, cfg: ArchConfig, embed, unembed, periods, final_norm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.unembed = unembed
        self.periods = nn.ModuleList(periods)
        self.final_norm = final_norm

    @staticmethod
    def layout(cfg: ArchConfig):
        """(period, n_periods): ``num_layers`` must be a multiple of
        ``slstm_every``."""
        period = cfg.ssm.slstm_every
        if cfg.num_layers % period:
            raise ValueError(f"xlstm layer count {cfg.num_layers} must be a "
                             f"multiple of slstm_every ({period})")
        return period, cfg.num_layers // period

    @classmethod
    def init(cls, cfg: ArchConfig, *, device,
             generator: Optional[torch.Generator] = None, seed: int = 0):
        device = require_device(device)
        dtype = dtype_of(cfg.param_dtype)
        kw = dict(generator=_generator(device, generator, seed),
                  device=device, dtype=dtype)
        d, heads = cfg.d_model, cfg.num_heads
        sp = cfg.sparsity if "mlp" in cfg.sparse_scope else None
        period, n_periods = cls.layout(cfg)

        def norm():
            return init_rmsnorm(d, device=device, dtype=dtype)

        periods = [XLSTMPeriod(
            [MixerLayer(norm(), blk=ssm_mod.init_mlstm(
                d, heads=heads, sparse=sp, **kw))
             for _ in range(period - 1)],
            MixerLayer(norm(), blk=ssm_mod.init_slstm(
                d, heads=heads, sparse=sp, **kw)))
            for _ in range(n_periods)]
        return cls(cfg, init_embedding(cfg.padded_vocab, d, **kw),
                   init_embedding(cfg.padded_vocab, d, **kw), periods,
                   init_rmsnorm(d, device=device, dtype=dtype))

    def _period_seq(self, per: XLSTMPeriod, x, *, policy):
        cfg = self.cfg
        for sub in per.mlstm:
            x = x + ssm_mod.apply_mlstm_seq(
                sub.blk, apply_rmsnorm(sub.ln, x), heads=cfg.num_heads,
                chunk=cfg.ssm.chunk, policy=policy)
        return x + ssm_mod.apply_slstm_seq(
            per.slstm.blk, apply_rmsnorm(per.slstm.ln, x),
            heads=cfg.num_heads, policy=policy)

    def _seq(self, tokens, *, policy):
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens).to(
            dtype_of(cfg.compute_dtype))
        for per in self.periods:
            x = remat_call(cfg.remat, self._period_seq, [per], x,
                           policy=policy)
        return apply_rmsnorm(self.final_norm, x)

    def train_loss(self, batch, *, policy=None):
        policy = resolve_policy(policy)
        x = self._seq(batch["tokens"], policy=policy)
        logits = apply_unembedding(self.unembed, x, self.cfg.vocab_size)
        loss = softmax_xent(logits, batch["targets"])
        return loss, {"xent": loss}

    def prefill(self, batch, *, max_len: Optional[int] = None, policy=None):
        """The last position's logits and a fresh decode state, as the
        reference returns them."""
        policy = resolve_policy(policy)
        x = self._seq(batch["tokens"], policy=policy)
        logits = apply_unembedding(self.unembed, x[:, -1:],
                                   self.cfg.vocab_size)
        return logits, self.init_decode_state(x.shape[0], max_len or 1)

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, device=None, paged=None):
        """{"mlstm": (n_periods, slstm_every - 1, B, ...), "slstm":
        (n_periods, B, ...), "pos"}; ``max_len`` does not size anything (the
        state is O(1) a slot)."""
        del max_len
        if paged is not None:
            raise NotImplementedError(
                "paged KV cache is attention-only; xLSTM decode state is "
                "O(1) recurrent per slot (nothing to page)")
        cfg = self.cfg
        device = device if device is not None else self.device
        period, n_periods = self.layout(cfg)
        return {
            "mlstm": ssm_mod.init_mlstm_state(
                batch, cfg.d_model, heads=cfg.num_heads,
                conv=cfg.ssm.conv_dim, dtype=dtype, device=device,
                lead=(n_periods, period - 1)),
            "slstm": ssm_mod.init_slstm_state(
                batch, cfg.d_model, heads=cfg.num_heads, device=device,
                lead=(n_periods,)),
            "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
        }

    def decode_step(self, state, tokens, *, policy=None):
        """One token per slot; every state tensor is written in place."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        x = apply_embedding(self.embed, tokens).to(
            dtype_of(cfg.compute_dtype))
        for p, per in enumerate(self.periods):
            for i, sub in enumerate(per.mlstm):
                out, _ = ssm_mod.apply_mlstm_step(
                    sub.blk, apply_rmsnorm(sub.ln, x),
                    _views(state["mlstm"], p, i), heads=cfg.num_heads,
                    policy=policy)
                x = x + out
            out, _ = ssm_mod.apply_slstm_step(
                per.slstm.blk, apply_rmsnorm(per.slstm.ln, x),
                _views(state["slstm"], p), heads=cfg.num_heads,
                policy=policy)
            x = x + out
        x = apply_rmsnorm(self.final_norm, x)
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        return logits, {"mlstm": state["mlstm"], "slstm": state["slstm"],
                        "pos": state["pos"] + 1}


def build_model(cfg: ArchConfig, *, device,
                generator: Optional[torch.Generator] = None, seed: int = 0):
    """A randomly initialised model of ``cfg`` on ``device``: ``EncDecLM``
    for the ``audio`` family, ``HybridLM`` for ``hybrid``, ``XLSTMLM`` for
    ``ssm``, else ``DecoderLM`` (``dense``, ``moe``, ``vlm``)."""
    from repro_torch.models.transformer import DecoderLM

    cls = {"audio": EncDecLM, "hybrid": HybridLM,
           "ssm": XLSTMLM}.get(cfg.family, DecoderLM)
    return cls.init(cfg, device=device, generator=generator, seed=seed)
