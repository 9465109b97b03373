"""Model assembly: the decoder LM (the ``dense``, ``moe`` and ``vlm``
families), the transformer block and the per-block rematerialisation that
every family shares.

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
global layer, then a tail of local layers).  A block's feed-forward is the
gated MLP or, with ``cfg.moe``, the experts (``models/moe.py``), whose
load-balancing loss ``train_loss`` adds; a ``vision`` frontend prepends the
projected patch embeddings (``batch["patch_embeds"]``) to the tokens, and
the loss skips their positions.

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
substituted parameters) are ported.

Distribution (``repro_torch.sharding``): under a sharding context of tp
ranks every layer runs on this rank's heads and blocks of the projections
(``full`` and ``paged`` caches, their head axis split);
:meth:`DecoderLM.decode_step_pipelined` runs the layers as ``pp`` pipeline
stages, each rank holding its ``L / pp`` layers and their caches.

Training under grad rematerializes per block (``cfg.remat``, through
:func:`remat_call`): ``full`` recomputes a block's forward in the backward
pass, ``dots`` saves the matmul outputs without batch dims (``aten.mm`` /
``addmm``, as ``dots_with_no_batch_dims_saveable`` does in the JAX package)
and recomputes the rest, ``none`` keeps everything.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    apply_embedding,
    apply_linear,
    apply_mlp,
    apply_rmsnorm,
    apply_rope,
    apply_unembedding,
    dtype_of,
    init_embedding,
    init_linear,
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
    """Transformer block, pre-norm: attention, then the gated MLP (``mlp``)
    or the experts (``moe``); a decoder block of the encoder-decoder family
    also cross-attends to the encoder's output (``ln_x``, ``xattn``)
    between the two."""

    def __init__(self, ln1, attn_block, ln2, mlp=None, *, moe=None,
                 ln_x=None, xattn=None):
        super().__init__()
        self.ln1, self.attn, self.ln2 = ln1, attn_block, ln2
        if xattn is not None:
            self.ln_x, self.xattn = ln_x, xattn
        if moe is not None:
            self.moe = moe
        else:
            self.mlp = mlp


def init_tblock(cfg: ArchConfig, *, cross: bool = False,
                generator: torch.Generator, device,
                dtype=torch.float32) -> TBlock:
    """A block of ``cfg``: attention sparse when ``attn_qkv`` is in the
    sparse scope, the MLP when ``mlp`` is (the experts are dense), and with
    ``cross`` a dense cross-attention."""
    d = cfg.d_model
    sp = cfg.sparsity
    kw = dict(generator=generator, device=device, dtype=dtype)
    heads = (d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    parts = dict(
        ln1=init_rmsnorm(d, device=device, dtype=dtype),
        attn_block=attn.init_attention(
            *heads, sparse=sp if "attn_qkv" in cfg.sparse_scope else None,
            **kw),
        ln2=init_rmsnorm(d, device=device, dtype=dtype))
    if cross:
        parts["ln_x"] = init_rmsnorm(d, device=device, dtype=dtype)
        parts["xattn"] = attn.init_attention(*heads, sparse=None, **kw)
    if cfg.moe is not None:
        parts["moe"] = moe_mod.init_moe(d, cfg.moe, **kw)
    else:
        parts["mlp"] = init_mlp(
            d, cfg.d_ff, sparse=sp if "mlp" in cfg.sparse_scope else None,
            **kw)
    return TBlock(**parts)


def block_ffn(blk: TBlock, x, cfg: ArchConfig, policy):
    """The block's feed-forward of x (pre-norm ``ln2``, no residual): (out,
    aux), aux the experts' load-balancing loss, a 0-d tensor, or the number
    0.0 for an MLP (no kernel is spent on a zero)."""
    h = apply_rmsnorm(blk.ln2, x)
    if hasattr(blk, "moe"):
        return moe_mod.apply_moe(blk.moe, h, cfg.moe)
    return apply_mlp(blk.mlp, h, policy=policy), 0.0


def apply_tblock_seq(blk: TBlock, x, cfg: ArchConfig, *, window,
                     positions=None, enc_out=None, causal=True,
                     static_window=None, policy):
    """A block over a whole sequence x (B, T, D): self-attention (causal
    unless ``causal`` is False, as in the encoder), the cross-attention to
    ``enc_out`` when the block has one (non-causal, no rotary embedding),
    and the feed-forward, each pre-norm and residual.  Returns (x, aux)."""
    h = apply_rmsnorm(blk.ln1, x)
    h = attn.apply_attention(
        blk.attn, h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, causal=causal, window=window,
        static_window=static_window, policy=policy)
    x = x + h
    if hasattr(blk, "xattn") and enc_out is not None:
        h = apply_rmsnorm(blk.ln_x, x)
        h = attn.apply_attention(
            blk.xattn, h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, causal=False, window=-1,
            kv_x=enc_out, policy=policy)
        x = x + h
    h, aux = block_ffn(blk, x, cfg, policy)
    return x + h, aux


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products without batch dims, recompute
    everything else."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class _Bound(nn.Module):
    """``fn(*modules, *args)`` as a module's forward: what a checkpoint
    re-enters with ``functional_call`` on the modules' tensors."""

    def __init__(self, fn, modules):
        super().__init__()
        self.fn = fn
        self.mods = nn.ModuleList(modules)

    def forward(self, *args, **kw):
        return self.fn(*self.mods, *args, **kw)


def remat_call(remat: str, fn, modules, x, **kw):
    """``fn(*modules, x, **kw)`` under ``remat`` (a config's ``remat``): a
    layer, or a whole period of layers (the hybrid's mamba layers and
    shared block, an xLSTM superblock) as the JAX package checkpoints its
    scan bodies.  Plain when
    nothing records gradients (grad mode off, or neither x nor a tensor of
    the modules requiring grad).

    The modules' tensors are passed to the checkpoint as inputs and put
    back into them (``functional_call``) each time ``fn`` runs: the backward
    pass recomputes after a caller's ``functional_call`` has restored the
    modules' own tensors, and must see the ones of the forward pass."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}; expected none, full "
                         "or dots")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*modules, x, **kw)
    bound = _Bound(fn, modules)
    tensors = {**dict(bound.named_parameters()),
               **dict(bound.named_buffers())}
    if not (x.requires_grad
            or any(t.requires_grad for t in tensors.values())):
        return fn(*modules, x, **kw)
    names = list(tensors)

    def run(x, *ts):
        return torch.func.functional_call(bound, dict(zip(names, ts)),
                                          (x,), kw)

    extra = {}
    if remat == "dots":
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


def _check_tp_cache_kind(kind: str):
    """Under tensor parallelism only the ``full`` and ``paged`` caches are
    served (the windowed rings are not split over ranks yet)."""
    from repro_torch.sharding.context import get_context

    ctx = get_context()
    if ctx is not None and ctx.tp > 1 and kind not in ("full", "paged"):
        raise NotImplementedError(
            f"decode cache kind {kind!r} under tp={ctx.tp} is not ported: "
            "tensor-parallel serving covers the full and paged caches")


class LM(nn.Module):
    """What every family's model shares: the device its embedding lives on,
    and ``forward`` = ``train_loss`` (what ``functional_call`` runs)."""

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, batch, *, policy=None):
        """The training loss (:meth:`train_loss`)."""
        return self.train_loss(batch, policy=policy)


class DecoderLM(LM):
    def __init__(self, cfg: ArchConfig, embed, unembed, final_norm, layers,
                 patch_proj=None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.unembed = unembed
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        if patch_proj is not None:      # the vision stub's frontend
            self.patch_proj = patch_proj

    @classmethod
    def init(cls, cfg: ArchConfig, *, device,
             generator: Optional[torch.Generator] = None,
             seed: int = 0) -> "DecoderLM":
        """Random weights from ``generator`` (or a fresh one seeded with
        ``seed``), created on ``device`` layer by layer so that nothing but
        the weights themselves is ever resident."""
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
            [init_tblock(cfg, **kw) for _ in range(cfg.num_layers)],
            patch_proj=(init_linear(cfg.d_model, cfg.d_model, sparse=None,
                                    name="patch_proj", **kw)
                        if cfg.frontend == "vision" else None))

    # ---- whole-sequence forward ----
    def _lg_layout(self):
        """local_global layout: (period, n_periods, n_tail)."""
        cfg = self.cfg
        period = cfg.local_global_ratio + 1
        n_p = cfg.num_layers // period
        return period, n_p, cfg.num_layers - n_p * period

    def _backbone_seq(self, x, *, positions, policy):
        """The layers and the final norm over x (B, T, D), and the sum of
        the layers' aux losses.  Windowed layers take their window as
        ``static_window``, so their attention visits only the key chunks
        that meet the band: every layer of ``swa``, gemma3's local layers (a
        period's first ``ratio`` and the tail)."""
        cfg = self.cfg
        aux = 0.0
        for blk, window in zip(self.layers, layer_windows(cfg)):
            x, a = remat_call(
                cfg.remat, apply_tblock_seq, [blk], x, cfg=cfg,
                window=window, static_window=None if window == FULL_WINDOW else window,
                positions=positions, policy=policy)
            aux = aux + a
        return apply_rmsnorm(self.final_norm, x), aux

    def _embed_inputs(self, batch, dtype):
        """The embedded tokens (B, T, D) of ``batch["tokens"]``; with the
        vision frontend, ``batch["patch_embeds"]`` (B, P, D) projected by
        ``patch_proj`` and put in front (B, P + T, D)."""
        x = apply_embedding(self.embed, batch["tokens"]).to(dtype)
        if self.cfg.frontend == "vision":
            pe = apply_linear(self.patch_proj,
                              batch["patch_embeds"].to(dtype))
            x = torch.cat([pe, x], dim=1)
        return x

    # ---- training ----
    def train_loss(self, batch, *, policy=None):
        """``(loss + aux, {"xent", "aux"})`` of ``batch`` ({"tokens",
        "targets"} (B, T), and "patch_embeds" with the vision frontend):
        the mean next-token cross-entropy over the text positions, and the
        experts' load-balancing loss summed over the layers (0 without
        experts)."""
        policy = resolve_policy(policy)
        cfg = self.cfg
        dtype = dtype_of(cfg.compute_dtype)
        x = self._embed_inputs(batch, dtype)
        t = x.shape[1]
        x, aux = self._backbone_seq(
            x, positions=torch.arange(t, device=x.device), policy=policy)
        if cfg.frontend == "vision":   # only the text positions carry loss
            x = x[:, cfg.num_patches:]
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        loss = softmax_xent(logits, batch["targets"])
        if not torch.is_tensor(aux):   # no experts
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss + aux, {"xent": loss, "aux": aux}

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
        x, _ = self._backbone_seq(
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
        return x + block_ffn(blk, x, self.cfg, policy)[0]

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
        _check_tp_cache_kind(kind)
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

    def decode_step_pipelined(self, state, tokens, *, policy=None,
                              pp: int = 2):
        """Pipeline-parallel :meth:`decode_step` (full-attention caches).

        The layers form ``pp`` contiguous stages, one per rank of the
        sharding context's ``pipe`` dim; the decode batch is split into
        ``pp`` slot microbatches streamed through the GPipe schedule
        (:func:`repro_torch.sharding.pipeline.pipeline_apply_stateful`).
        This rank holds its stage's ``L / pp`` layers and their caches
        (``state["caches"]`` of ``L / pp`` layers) and writes only the slot
        rows of its live microbatch, so the logits and caches are what the
        sequential step gives.  Embedding, final norm and unembedding run
        on every rank.  Requires ``num_layers % pp == 0`` and ``batch % pp
        == 0``; without a ``pipe`` dim of ``pp`` ranks in the active context
        it is :meth:`decode_step` (the same math, as the JAX package falls
        back on one device)."""
        from repro_torch.sharding.context import get_context
        from repro_torch.sharding.pipeline import pipeline_apply_stateful

        policy = resolve_policy(policy)
        cfg = self.cfg
        caches = state["caches"]
        if caches["kind"] != "full":
            raise NotImplementedError(
                "decode_step_pipelined supports the dense full-attention "
                "cache (windowed / paged layouts pipeline their stages with "
                "other per-stage state)")
        ctx = get_context()
        if ctx is None or ctx.pp != pp:
            return self.decode_step(state, tokens, policy=policy)
        b, l = tokens.shape[0], cfg.num_layers
        if l % pp or b % pp:
            raise ValueError(
                f"decode_step_pipelined: num_layers ({l}) and batch ({b}) "
                f"must both divide pp ({pp})")
        l_loc, mb = l // pp, b // pp
        first = ctx.pp_rank * l_loc
        if caches["k"].shape[0] != l_loc:
            raise ValueError(
                f"this stage's caches hold {caches['k'].shape[0]} layers, "
                f"expected {l_loc} (place the state with the plan)")
        dtype = dtype_of(cfg.compute_dtype)
        pos = state["pos"]
        x = apply_embedding(self.embed, tokens).to(dtype)

        def stage_fn(x_mb, pos_mb, mb_idx):
            rows = slice(mb_idx * mb, (mb_idx + 1) * mb)
            rope = rope_tables(pos_mb[:, None], cfg.resolved_head_dim,
                               cfg.rope_theta)
            for li in range(l_loc):
                # views of this microbatch's rows: written in place
                cache = {"k": caches["k"][li, rows],
                         "v": caches["v"][li, rows]}
                x_mb, _ = self._decode_full_layer(
                    self.layers[first + li], x_mb, cache, pos_mb,
                    FULL_WINDOW, policy, rope)
            return x_mb

        y = pipeline_apply_stateful(stage_fn, x.reshape(pp, mb, *x.shape[1:]),
                                    ctx, aux=pos.reshape(pp, mb))
        x = apply_rmsnorm(self.final_norm, y.reshape(b, *y.shape[2:]))
        logits = apply_unembedding(self.unembed, x, cfg.vocab_size)
        return logits, {"caches": caches, "pos": pos + 1}

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
