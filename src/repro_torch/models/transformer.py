"""Model assembly: the decoder LM of the ``dense`` family.

    model = build_model(cfg, device=...)          # models/families.py
    logits, state = model.prefill({"tokens": tokens}, max_len=...)
    state = model.init_decode_state(batch, max_len)
    logits, state = model.decode_step(state, tokens, policy=ExecPolicy(...))

    state = model.init_decode_state(batch, max_len, paged=PagedLayout(...))
    logits, state = model.prefill_chunk(state, tokens, slot, n_valid)

``DecoderLM`` is an ``nn.Module`` whose layers sit in an ``nn.ModuleList`` (a
Python loop over layers takes the place of the JAX package's scan over a
stacked layer axis).  Attention is full, sliding-window (``swa``: every
layer sees the last ``window`` positions) or ``local_global`` (gemma3:
periods of ``local_global_ratio`` local layers with ``local_window`` and one
global layer, then a tail of local layers).

Decode caches:

* full-attention layers — append caches ``(B, S, Hkv, Dh)``, stacked on a
  leading layer axis, or a paged KV arena ``(L, Np, P, Hkv, Dh)`` with
  per-slot block tables (full attention only);
* windowed layers — ring buffers ``(B, W, Hkv, Dh)`` with the absolute
  position each slot holds (``slot_pos``, -1 when empty), stacked as the JAX
  package stacks them (``ring`` (L, ...) for ``swa``; ``local`` (n_periods,
  ratio, ...), ``tail`` and ``global_k`` / ``global_v`` for
  ``local_global``).

Whole-sequence prefill, decode against any of these caches, chunked
prefill into the paged arena and the training loss (``train_loss``, also
the module's ``forward``, so that ``torch.func.functional_call`` runs it on
substituted parameters) are ported; experts and the other families come
with later slices.

Training under grad rematerializes per layer (``cfg.remat``): ``full``
recomputes a layer's forward in the backward pass, ``dots`` saves the
matmul outputs without batch dims (``aten.mm`` / ``addmm``, as
``dots_with_no_batch_dims_saveable`` does in the JAX package) and
recomputes the rest, ``none`` keeps everything.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_linear import resolve_policy
from repro_torch.device import require_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_embedding,
    apply_linear,
    apply_mlp,
    apply_rmsnorm,
    apply_rope,
    apply_unembedding,
    dtype_of,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    rope_tables,
)

# the windows a decode layer may take: ``FULL_WINDOW`` is unbounded
FULL_WINDOW = -1


# ---------------------------------------------------------------------------
# Ring-buffer (windowed) KV cache
# ---------------------------------------------------------------------------

def init_ring_cache(batch: int, window: int, hkv: int, dh: int, *, device,
                    dtype=torch.bfloat16, lead=()):
    """A ring of ``window`` slots per sequence, (*lead, B, W, Hkv, Dh), and
    the absolute position each slot holds, (*lead, B, W) int32, -1 when
    empty."""
    shape = (*lead, batch, window, hkv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((*lead, batch, window), -1,
                                   dtype=torch.int32, device=device)}


def ring_decode_attention(attn_block, x, cache, pos, *, cfg: ArchConfig,
                          window: int, policy, rope=None):
    """One-token attention against a ring-buffer cache of W slots, written
    in place: the new K and V go to slot ``pos % W`` of each sequence and
    ``slot_pos`` records ``pos`` there (the JAX package blends with a
    one-hot of the slot over W; an indexed write of the same row gives the
    same cache without copying it).  The mask comes from the stored
    positions: a slot is seen iff it holds a position in (pos - window,
    pos].  ``rope`` takes the :func:`rope_tables` of ``pos[:, None]`` when
    the caller has them.  Returns (out (B, 1, D), cache)."""
    b = x.shape[0]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = attn._project_qkv(attn_block, x, x, hq, hkv, dh,
                                        policy)
    if rope is None:
        rope = rope_tables(pos[:, None], dh, cfg.rope_theta)
    q = apply_rope(q, pos[:, None], cfg.rope_theta, rope)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta, rope)
    k_c, v_c, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    rows = torch.arange(b, device=x.device)
    slot = pos % k_c.shape[1]                                  # (B,)
    k_c[rows, slot] = k_new[:, 0].to(k_c.dtype)
    v_c[rows, slot] = v_new[:, 0].to(v_c.dtype)
    slot_pos[rows, slot] = pos.to(slot_pos.dtype)
    p_now = pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= p_now) & \
        (slot_pos > p_now - window)
    logits = attn._gqa_scores(q, k_c) * dh ** -0.5            # (B,Hq,1,W)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), attn.NEG_INF, dtype=logits.dtype,
                                    device=logits.device))
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - m)
    out = attn._gqa_out(p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30),
                        v_c)
    out = out.reshape(b, 1, hq * dh).to(x.dtype)
    return apply_linear(attn_block.wo, out, policy=policy), cache


def layer_windows(cfg: ArchConfig) -> list:
    """The attention window of each layer (:data:`FULL_WINDOW`: unbounded),
    as the JAX package's ``layer_windows`` gives them."""
    l = cfg.num_layers
    if cfg.attention == "swa":
        return [cfg.window] * l
    if cfg.attention == "local_global":
        period = cfg.local_global_ratio + 1
        return [FULL_WINDOW if i % period == cfg.local_global_ratio
                else cfg.local_window for i in range(l)]
    return [FULL_WINDOW] * l


class TBlock(nn.Module):
    """Standard transformer block: attention + gated MLP, pre-norm."""

    def __init__(self, ln1, attn_block, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_block, ln2, mlp

    def forward(self, x, cfg, **kw):
        """:func:`apply_tblock_seq` of this block."""
        return apply_tblock_seq(self, x, cfg, **kw)


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


def apply_tblock_seq(blk: TBlock, x, cfg: ArchConfig, *, window,
                     positions=None, static_window=None, policy):
    """A block over a whole sequence x (B, T, D): causal self-attention
    (the JAX package's cross-attention branch and non-causal encoder blocks
    belong to the encoder-decoder family, not ported) and the gated MLP,
    each pre-norm and residual."""
    h = apply_rmsnorm(blk.ln1, x)
    h = attn.apply_attention(
        blk.attn, h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, window=window, static_window=static_window,
        policy=policy)
    x = x + h
    h = apply_mlp(blk.mlp, apply_rmsnorm(blk.ln2, x), policy=policy)
    return x + h


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products without batch dims, recompute
    everything else."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(blk: TBlock, x, cfg: ArchConfig, **kw):
    """One block over x under ``cfg.remat`` (plain when nothing records
    gradients: grad mode off, or neither x nor a tensor of the block
    requiring grad).

    The block's tensors are passed to the checkpoint as inputs and put back
    into the block (``functional_call``) each time it runs: the backward
    pass recomputes after a caller's ``functional_call`` has restored the
    module's own tensors, and must see the ones of the forward pass."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}; expected none, full "
                         "or dots")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return apply_tblock_seq(blk, x, cfg, **kw)
    tensors = {**dict(blk.named_parameters()), **dict(blk.named_buffers())}
    if not (x.requires_grad
            or any(t.requires_grad for t in tensors.values())):
        return apply_tblock_seq(blk, x, cfg, **kw)
    names = list(tensors)

    def run(x, *ts):
        return torch.func.functional_call(blk, dict(zip(names, ts)),
                                          (x, cfg), kw)

    extra = {}
    if cfg.remat == "dots":
        extra["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.checkpoint(run, x, *tensors.values(), use_reentrant=False,
                            **extra)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over every position, in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].to(torch.int64),
                                dim=-1)[..., 0]
    return (lse - gold).mean()


def _check_ported(cfg: ArchConfig):
    if (cfg.attention not in ("full", "swa", "local_global")
            or cfg.moe is not None or cfg.ssm is not None
            or cfg.frontend is not None or cfg.encoder_layers):
        raise NotImplementedError(
            f"{cfg.name}: only dense decoders (full, swa or local_global "
            f"attention) are ported so far (attention={cfg.attention!r}, "
            f"moe={cfg.moe is not None}, ssm={cfg.ssm is not None}, "
            f"frontend={cfg.frontend!r})")


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

    # ---- whole-sequence forward ----
    def _lg_layout(self):
        """local_global layout: (period, n_periods, n_tail)."""
        cfg = self.cfg
        period = cfg.local_global_ratio + 1
        n_p = cfg.num_layers // period
        return period, n_p, cfg.num_layers - n_p * period

    def _backbone_seq(self, x, *, positions, policy):
        """The layers and the final norm over x (B, T, D).  Windowed layers
        take their window as ``static_window``, so their attention visits
        only the key chunks that meet the band: every layer of ``swa``,
        gemma3's local layers (a period's first ``ratio`` and the tail)."""
        cfg = self.cfg
        for blk, window in zip(self.layers, layer_windows(cfg)):
            x = _remat_layer(
                blk, x, cfg, window=window,
                static_window=None if window == FULL_WINDOW else window,
                positions=positions, policy=policy)
        return apply_rmsnorm(self.final_norm, x)

    def _embed_inputs(self, batch, dtype):
        """The embedded tokens (B, T, D) of ``batch["tokens"]`` (text only:
        the vision stub's patch embeddings belong to a family not ported)."""
        return apply_embedding(self.embed, batch["tokens"]).to(dtype)

    # ---- training ----
    def train_loss(self, batch, *, policy=None):
        """``(loss + aux, {"xent", "aux"})`` of ``batch`` ({"tokens",
        "targets"} (B, T)): the mean next-token cross-entropy of the whole
        sequence (aux is 0 for the dense decoders, the experts' load-balance
        loss in the JAX package's MoE family)."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        dtype = dtype_of(cfg.compute_dtype)
        x = self._embed_inputs(batch, dtype)
        t = x.shape[1]
        x = self._backbone_seq(x, positions=torch.arange(t, device=x.device),
                               policy=policy)
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        loss = softmax_xent(logits, batch["targets"])
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss + aux, {"xent": loss, "aux": aux}

    def forward(self, batch, *, policy=None):
        """The training loss (:meth:`train_loss`)."""
        return self.train_loss(batch, policy=policy)

    # ---- serving ----
    def prefill(self, batch, *, max_len: Optional[int] = None, policy=None):
        """Whole-sequence prefill of ``batch["tokens"]`` (B, T): the logits
        of the last position, (B, 1, V), and a fresh decode state for
        ``max_len`` positions (T + 1 by default), as the JAX package's
        ``prefill`` returns them: that does not fill the cache either."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        dtype = dtype_of(cfg.compute_dtype)
        x = self._embed_inputs(batch, dtype)
        b, t = x.shape[0], x.shape[1]
        x = self._backbone_seq(
            x, positions=torch.arange(t, device=x.device), policy=policy)
        logits = apply_unembedding(self.unembed, x[:, -1:], cfg.vocab_size)
        return logits, self.init_decode_state(b, max_len or t + 1,
                                              dtype=dtype)

    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, device=None, paged=None):
        """Decode state: the caches of the config's attention kind (see the
        module docstring) plus the per-slot write position ``pos`` (B,).

        ``paged`` (a ``repro_torch.paged.PagedLayout``) swaps the per-slot
        caches for one shared arena of pages per layer, ``(L, Np, P, Hkv,
        Dh)``, with a block table (B, NBLK) and a decode mask ``active``
        (B,) bool; only full-attention caches are paged, as in the JAX
        package.  A ``local_global`` state keeps the JAX package's dummies:
        a one-layer ``tail`` without tail layers, one global cache without a
        whole period."""
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

        def ring(*lead):
            w = int(cfg.local_window if cfg.attention == "local_global"
                    else cfg.window)
            return init_ring_cache(batch, w, hkv, dh, device=device,
                                   dtype=dtype, lead=lead)

        def full(n):
            shape = (n, batch, max_len, hkv, dh)
            return (torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))

        if cfg.attention == "swa":
            caches = {"kind": "swa", "ring": ring(l)}
        elif cfg.attention == "local_global":
            period, n_p, n_tail = self._lg_layout()
            gk, gv = full(max(n_p, 1))
            caches = {"kind": "local_global",
                      "local": ring(n_p, period - 1),
                      "tail": ring(max(n_tail, 1)),
                      "global_k": gk, "global_v": gv}
        else:
            k, v = full(l)
            caches = {"kind": "full", "k": k, "v": v}
        return {"caches": caches, "pos": pos}

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

    def _decode_ring_layer(self, blk: TBlock, x, cache, pos, window, policy,
                           rope=None):
        h = apply_rmsnorm(blk.ln1, x)
        h, nc = ring_decode_attention(blk.attn, h, cache, pos, cfg=self.cfg,
                                      window=window, policy=policy,
                                      rope=rope)
        return self._decode_ffn(blk, x + h, policy), nc

    def _layer_cache(self, caches, i: int):
        """Layer ``i``'s cache in ``caches``, as views of the stacked
        tensors (the layer writes into them in place) and the window it
        decodes with: ``(kind, cache, window)``, ``kind`` "ring" or
        "full"."""
        cfg = self.cfg
        kind = caches["kind"]
        if kind == "swa":
            ring = caches["ring"]
            return "ring", {n: t[i] for n, t in ring.items()}, cfg.window
        if kind == "local_global":
            period, n_p, _ = self._lg_layout()
            p, r = divmod(i, period)
            if p >= n_p:
                tail = caches["tail"]
                return ("ring", {n: t[i - n_p * period]
                                 for n, t in tail.items()},
                        cfg.local_window)
            if r < period - 1:
                local = caches["local"]
                return ("ring", {n: t[p, r] for n, t in local.items()},
                        cfg.local_window)
            return ("full", {"k": caches["global_k"][p],
                             "v": caches["global_v"][p]}, FULL_WINDOW)
        return "full", {"k": caches["k"][i], "v": caches["v"][i]}, \
            FULL_WINDOW

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
        caches, ring buffers or paged arena in ``state`` are updated in
        place; the returned state carries them and the advanced positions:
        every slot advances by one with per-slot caches (an idle slot keeps
        writing its own ring or cache row, as in the JAX package), only the
        ``active`` lanes with a paged arena (prefilling and empty slots keep
        their position, and their writes went to the null page)."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        dtype = dtype_of(cfg.compute_dtype)
        x = apply_embedding(self.embed, tokens).to(dtype)
        pos = state["pos"]
        caches = state["caches"]
        kind = caches["kind"]
        if kind not in ("full", "paged", "swa", "local_global"):
            raise NotImplementedError(
                f"decode cache kind {kind!r} is not ported yet")
        # the rotary tables depend on the positions only: once per step
        rope = rope_tables(pos[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
        for i, blk in enumerate(self.layers):
            # every cache below is a view: the layer writes into it in place
            if kind == "paged":
                x = self._decode_paged_layer(
                    blk, x, caches["k"][i], caches["v"][i],
                    caches["block_table"], caches["active"], pos, policy,
                    rope)
                continue
            layer_kind, cache, window = self._layer_cache(caches, i)
            if layer_kind == "ring":
                x, _ = self._decode_ring_layer(blk, x, cache, pos, window,
                                               policy, rope)
            else:
                x, _ = self._decode_full_layer(blk, x, cache, pos, window,
                                               policy, rope)
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
