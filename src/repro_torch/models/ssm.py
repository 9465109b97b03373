"""State-space mixers: Mamba2 (SSD chunked form) and xLSTM (mLSTM + sLSTM),
as the JAX package's ``models/ssm.py`` computes them.

Every mixer has three entry points:
  init_*           — an ``nn.Module`` of parameters;
  apply_*_seq      — the whole sequence (train / prefill): Mamba2 and mLSTM
                     chunked (a Python loop over chunks in place of the
                     reference's scan), sLSTM a loop over time steps;
  apply_*_step     — one token against an O(1) recurrent state.

The step forms write the new state **into the state's own tensors**
(``copy_``) and return them: the engines keep one decode state for their
life and a captured step replays reads and writes of those very tensors
(the reference returns new arrays).

Mixed dtypes follow ``jnp``'s promotion: an activation in the compute dtype
(bfloat16 on the card) meeting a float32 state or parameter computes in
float32 (:func:`_ein` casts the operands of a product to their promoted
type, which ``torch.einsum`` does not do itself), and results are cast back
where the reference casts them.  Every projection goes through
``apply_linear`` (dense, masked or packed: K1-K4 on the card).

Under a sharding plan that splits a mixer by heads
(``sharding.plan.ShardingPlan``) a rank holds its heads' rows of the
projections, its heads' per-head tensors and its heads' block of every
state, and the mixer computes on them: the local sizes come from the
module's own tensors (Mamba2's heads from ``A_log``, mLSTM's from ``z``
against ``xm``), the gated norm sums its squares over tp
(``layers.RMSNorm``), and the row-parallel ``out_proj`` / ``down`` sum the
heads' outputs.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (apply_linear, apply_rmsnorm,
                                       init_linear, init_rmsnorm)
from repro_torch.sharding.context import get_context

F32 = torch.float32
MLSTM_PF = 2        # mLSTM's up-projection factor: inner width MLSTM_PF x D
NEG_BIG = -1e30     # the stabilisers' initial value (one fill value a leaf)


def _ein(eq: str, *ops):
    """``torch.einsum`` on the operands cast to their promoted dtype, as
    ``jnp.einsum`` promotes them."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _cat(a, b):
    """``jnp.concatenate`` of two tensors along axis 1 (promoted dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=1)


def _silu32(x, dtype):
    return torch.nn.functional.silu(x.to(F32)).to(dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _log_sigmoid(x):
    """log sigmoid(x) = ``-softplus(-x)``."""
    return -_softplus(-x)


def _normal(shape, scale, *, generator, device, dtype):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype) * scale


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def _causal_conv(x, w):
    """Depthwise causal conv along T, then SiLU.  x (B, T, C); w (K, C)."""
    k, t = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + t, :] * w[i]
    return _silu32(out, x.dtype)


def _conv_step(hist, w, dtype):
    """The causal conv's output of a one-token step over the carried window
    ``hist`` (B, K, C), as (B, 1, C) in ``dtype``."""
    return _silu32((hist * w[None]).sum(1), dtype)[:, None, :]


# ---------------------------------------------------------------------------
# Mamba2 (zamba2's backbone mixer)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    def __init__(self, in_proj, conv_w, A_log, D, dt_bias, norm, out_proj):
        super().__init__()
        self.in_proj = in_proj
        self.conv_w = _param(conv_w)
        self.A_log = _param(A_log)
        self.D = _param(D)
        self.dt_bias = _param(dt_bias)
        self.norm = norm
        self.out_proj = out_proj


def init_mamba2(d: int, *, expand=2, state=64, head_dim=64, conv=4,
                sparse=None, generator: torch.Generator, device,
                dtype=torch.float32) -> Mamba2:
    di = expand * d
    heads = di // head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(device=device, dtype=F32)
    return Mamba2(
        # order of the outputs: [z (di), x (di), B (state), C (state),
        # dt (heads)]
        init_linear(d, 2 * di + 2 * state + heads, sparse=sparse,
                    name="in_proj", **kw),
        _normal((conv, di + 2 * state), 0.1, **kw),
        torch.zeros((heads,), **f32), torch.ones((heads,), **f32),
        torch.zeros((heads,), **f32),
        init_rmsnorm(di, device=device, dtype=dtype),
        init_linear(di, d, sparse=sparse, name="out_proj", **kw))


def _mamba2_heads(p: Mamba2, head_dim: int):
    """(heads, inner width) this rank computes: all of them, or its block
    under a plan that splits the mixer by heads."""
    heads = p.A_log.shape[0]
    return heads, heads * head_dim


def _mamba2_split(p: Mamba2, u, *, di, state, policy):
    zxbcdt = apply_linear(p.in_proj, u, policy=policy)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * state,
                                      zxbcdt.shape[-1] - 2 * di - 2 * state],
                             dim=-1)
    return z, xbc, _softplus(dt.to(F32) + p.dt_bias)


def _mamba2_out(p: Mamba2, y, z, dtype, policy):
    y = apply_rmsnorm(p.norm, y.to(dtype)) * _silu32(z, dtype)
    return apply_linear(p.out_proj, y, policy=policy)


def apply_mamba2_seq(p: Mamba2, u, *, expand=2, state=64, head_dim=64,
                     chunk=128, policy=None):
    """Whole-sequence Mamba2 (SSD chunked).  u (B, T, D) -> (B, T, D).

    Within a chunk the recurrence is a decay-masked product
    ``(C Bᵀ ⊙ L)`` with ``L[t, s] = exp(cum[t] - cum[s])`` for s <= t;
    across chunks the state (B, H, P, N) is carried.  T is padded to whole
    chunks of ``chunk`` (zeros: a padded step adds nothing).  ``expand``
    is the config's; the sizes come from ``p`` (:func:`_mamba2_heads`)."""
    del expand
    b, t, _ = u.shape
    heads, di = _mamba2_heads(p, head_dim)
    z, xbc, dt = _mamba2_split(p, u, di=di, state=state, policy=policy)
    xbc = _causal_conv(xbc, p.conv_w)
    x, bmat, cmat = torch.split(xbc, [di, state, state], dim=-1)
    x = x.reshape(b, t, heads, head_dim)
    a = -torch.exp(p.A_log)                               # (H,)
    log_a = (dt * a).to(F32)                              # (B, T, H)

    nc = -(-t // chunk)
    pad = nc * chunk - t

    def chunks(v):
        v = torch.nn.functional.pad(v, (0, 0) * (v.ndim - 2) + (0, pad))
        return v.reshape(b, nc, chunk, *v.shape[2:])

    xp, bp, cp, dtp, lap = (chunks(v) for v in (x, bmat, cmat, dt, log_a))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=u.device))
    neg_inf = torch.full((), float("-inf"), dtype=F32, device=u.device)
    h = torch.zeros((b, heads, head_dim, state), dtype=F32, device=u.device)
    ys = []
    for c in range(nc):
        xc, bc, cc = xp[:, c], bp[:, c], cp[:, c]
        dtc, lac = dtp[:, c], lap[:, c]
        xc32 = xc.to(F32)
        cum = torch.cumsum(lac, dim=1)                    # (B, c, H)
        total = cum[:, -1]                                # (B, H)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]   # (B, c, c, H)
        # masked before the exp: above the diagonal ldiff grows with the
        # chunk and its exp overflows, and a where() after the exp would
        # give that inf a zero gradient, 0 x inf = nan (the reference's
        # order; the forward is the same either way)
        decay = torch.exp(torch.where(tri[None, :, :, None], ldiff, neg_inf))
        scores = _ein("btn,bsn->bts", cc, bc)[..., None] * decay
        y_intra = _ein("btsh,bsh,bshp->bthp", scores, dtc, xc32)
        y_state = _ein("btn,bhpn,bth->bthp", cc, h, torch.exp(cum))
        w_s = torch.exp(total[:, None] - cum)             # (B, c, H)
        h = h * torch.exp(total)[:, :, None, None] + _ein(
            "bsh,bshp,bsn->bhpn", dtc * w_s, xc32, bc)
        ys.append(y_intra + y_state)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, heads, head_dim)[:, :t]
    y = y + x.to(F32) * p.D[None, None, :, None]
    return _mamba2_out(p, y.reshape(b, t, di), z, u.dtype, policy)


def init_mamba2_state(batch, d, *, expand=2, state=64, head_dim=64, conv=4,
                      dtype=torch.float32, device=None, lead=()):
    """{"h" (*lead, B, H, P, N) float32, "conv" (*lead, B, K - 1, C)
    ``dtype``}, zeros."""
    di = expand * d
    heads = di // head_dim
    return {
        "h": torch.zeros((*lead, batch, heads, head_dim, state), dtype=F32,
                         device=device),
        "conv": torch.zeros((*lead, batch, conv - 1, di + 2 * state),
                            dtype=dtype, device=device),
    }


def apply_mamba2_step(p: Mamba2, u, st, *, expand=2, state=64, head_dim=64,
                      policy=None):
    """One token.  u (B, 1, D); ``st`` {"h", "conv"} is written in place.
    Returns (out (B, 1, D), st)."""
    del expand
    b = u.shape[0]
    heads, di = _mamba2_heads(p, head_dim)
    z, xbc, dt = _mamba2_split(p, u, di=di, state=state, policy=policy)
    hist = _cat(st["conv"], xbc)                          # (B, K, C)
    conv_out = _conv_step(hist, p.conv_w, u.dtype)
    x, bmat, cmat = torch.split(conv_out, [di, state, state], dim=-1)
    x = x.reshape(b, heads, head_dim)
    dt1 = dt[:, 0]                                        # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p.A_log))
    h = st["h"] * decay[:, :, None, None] + _ein(
        "bh,bhp,bn->bhpn", dt1, x.to(F32), bmat[:, 0])
    y = _ein("bn,bhpn->bhp", cmat[:, 0], h)
    y = y + x.to(F32) * p.D[None, :, None]
    out = _mamba2_out(p, y.reshape(b, 1, di), z, u.dtype, policy)
    st["h"].copy_(h)
    st["conv"].copy_(hist[:, 1:])
    return out, st


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory block)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, up, conv_w, wq, wk, wv, w_if, norm, down):
        super().__init__()
        self.up = up
        self.conv_w = _param(conv_w)
        self.wq, self.wk, self.wv, self.w_if = wq, wk, wv, w_if
        self.norm = norm
        self.down = down


def init_mlstm(d: int, *, heads=4, pf=MLSTM_PF, conv=4, sparse=None,
               generator: torch.Generator, device,
               dtype=torch.float32) -> MLSTM:
    di = pf * d
    kw = dict(generator=generator, device=device, dtype=dtype)
    return MLSTM(
        init_linear(d, 2 * di, sparse=sparse, name="up", **kw),
        _normal((conv, di), 0.1, **kw),
        init_linear(di, di, sparse=sparse, name="wq", **kw),
        init_linear(di, di, sparse=sparse, name="wk", **kw),
        init_linear(di, di, sparse=sparse, name="wv", **kw),
        init_linear(di, 2 * heads, sparse=None, name="w_if", **kw),
        init_rmsnorm(di, device=device, dtype=dtype),
        init_linear(di, d, sparse=sparse, name="down", **kw))


def _mlstm_up(p: MLSTM, x, *, heads, policy):
    """(xm whole, z, the heads this rank computes): ``up``'s output is
    ``[xm, z]``, ``xm`` over every channel (gathered whole under a plan that
    splits the mixer by heads) and ``z`` the rank's heads' channels."""
    up = apply_linear(p.up, x, policy=policy)
    di = p.conv_w.shape[1]
    xm, z = up[..., :di], up[..., di:]
    return xm, z, heads * z.shape[-1] // di


def _own_heads(t, heads: int, local: int):
    """The rank's block of the last (heads) axis of ``t`` when it computes
    ``local`` of ``heads`` heads."""
    return t if local == heads else get_context().local_block(t, -1)


def _mlstm_qkvif(p: MLSTM, xm, *, heads, local, policy):
    """q, k, v (B, T, local, dh) and the gates' pre-activations (B, T,
    local) of the ``local`` heads this rank computes."""
    b, t, di = xm.shape
    dh = di // heads
    conv_x = _causal_conv(xm, p.conv_w)
    q = apply_linear(p.wq, conv_x, policy=policy)
    k = apply_linear(p.wk, conv_x, policy=policy)
    v = apply_linear(p.wv, xm, policy=policy)
    gif = apply_linear(p.w_if, xm, policy=policy)
    i_pre, f_pre = (_own_heads(g, heads, local)
                    for g in torch.chunk(gif.to(F32), 2, dim=-1))
    q = q.reshape(b, t, local, dh)
    k = k.reshape(b, t, local, dh) * dh ** -0.5
    v = v.reshape(b, t, local, dh)
    return q, k, v, i_pre, _log_sigmoid(f_pre)


def apply_mlstm_seq(p: MLSTM, x, *, heads=4, pf=MLSTM_PF, chunk=128,
                    policy=None):
    """Whole-sequence mLSTM, the stabilised chunked parallel form: within a
    chunk a decay-masked product with a running max stabiliser, across
    chunks the (C, n, m) matrix-memory carry."""
    del pf
    b, t, d = x.shape
    xm, z, local = _mlstm_up(p, x, heads=heads, policy=policy)
    dh = xm.shape[-1] // heads
    q, k, v, i_pre, log_f = _mlstm_qkvif(p, xm, heads=heads, local=local,
                                         policy=policy)
    heads = local                    # the heads this rank computes
    c = min(chunk, t)
    nc = -(-t // c)
    pad = nc * c - t
    dev = x.device

    def chunks(a, value=0.0):
        a = torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, pad),
                                    value=value)
        return a.reshape(b, nc, c, *a.shape[2:])

    qp, kp, vp = chunks(q), chunks(k), chunks(v)
    # padded steps must not contribute: i -> -1e30, log_f -> 0
    ip, fp = chunks(i_pre, NEG_BIG), chunks(log_f)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    neg_inf = torch.full((), float("-inf"), dtype=F32, device=dev)
    C_p = torch.zeros((b, heads, dh, dh), dtype=F32, device=dev)
    n_p = torch.zeros((b, heads, dh), dtype=F32, device=dev)
    m_p = torch.full((b, heads), NEG_BIG, dtype=F32, device=dev)
    ys = []
    for j in range(nc):
        qc, kc, vc = (a[:, j].to(F32) for a in (qp, kp, vp))
        ic, fc = ip[:, j], fp[:, j]
        cum = torch.cumsum(fc, dim=1)                     # (B, c, H)
        total = cum[:, -1]                                # (B, H)
        # intra-chunk stabilised decay D[t,s] = cum[t]-cum[s]+i_s (s<=t)
        dmat = cum[:, :, None, :] - cum[:, None, :, :] + ic[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, neg_inf)
        m_intra = dmat.max(dim=2).values                  # (B, c, H)
        m_state = cum + m_p[:, None, :]                   # carried stabiliser
        m_t = torch.maximum(m_intra, m_state)
        dstab = torch.exp(dmat - m_t[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * dstab
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vc)
        n_intra = torch.einsum("btsh,bshd->bthd", dstab, kc)
        w_state = torch.exp(m_state - m_t)                # (B, c, H)
        y_state = torch.einsum("bthd,bhde->bthe", qc, C_p) * w_state[..., None]
        n_t = n_intra + n_p[:, None] * w_state[..., None]
        den = torch.maximum(torch.einsum("bthd,bthd->bth", qc, n_t).abs(),
                            torch.exp(-m_t))
        ys.append((y_intra + y_state) / den[..., None])
        # chunk-end carry
        m_new = torch.maximum(
            m_p + total, (total[:, None] - cum + ic).max(dim=1).values)
        w_kv = torch.exp(total[:, None] - cum + ic - m_new[:, None])
        carry = torch.exp(m_p + total - m_new)
        C_p = C_p * carry[..., None, None] + torch.einsum(
            "bsh,bshd,bshe->bhde", w_kv, kc, vc)
        n_p = n_p * carry[..., None] + torch.einsum("bsh,bshd->bhd", w_kv,
                                                    kc)
        m_p = m_new
    y = torch.stack(ys, dim=1).reshape(b, nc * c, heads, dh)[:, :t]
    y = y.reshape(b, t, heads * dh).to(x.dtype)
    y = apply_rmsnorm(p.norm, y) * _silu32(z, x.dtype)
    return apply_linear(p.down, y, policy=policy)


def init_mlstm_state(batch, d, *, heads=4, pf=MLSTM_PF, conv=4,
                     dtype=torch.float32, device=None, lead=()):
    """{"C" (*lead, B, H, dh, dh), "n" (.., H, dh), "m" (.., H) at -1e30,
    float32; "conv" (*lead, B, K - 1, di) ``dtype``}."""
    di = pf * d
    dh = di // heads
    f32 = dict(dtype=F32, device=device)
    return {
        "C": torch.zeros((*lead, batch, heads, dh, dh), **f32),
        "n": torch.zeros((*lead, batch, heads, dh), **f32),
        "m": torch.full((*lead, batch, heads), NEG_BIG, **f32),
        "conv": torch.zeros((*lead, batch, conv - 1, di), dtype=dtype,
                            device=device),
    }


def apply_mlstm_step(p: MLSTM, x, st, *, heads=4, pf=MLSTM_PF, policy=None):
    """One token; ``st`` {"C", "n", "m", "conv"} is written in place."""
    del pf
    b = x.shape[0]
    xm, z, local = _mlstm_up(p, x, heads=heads, policy=policy)
    dh = xm.shape[-1] // heads
    hist = _cat(st["conv"], xm)
    conv_x = _conv_step(hist, p.conv_w, x.dtype)
    q = apply_linear(p.wq, conv_x, policy=policy)
    k = apply_linear(p.wk, conv_x, policy=policy)
    v = apply_linear(p.wv, xm, policy=policy)
    gif = apply_linear(p.w_if, xm, policy=policy)
    i_pre, f_pre = (_own_heads(g, heads, local)
                    for g in torch.chunk(gif[:, 0].to(F32), 2, dim=-1))
    log_f = _log_sigmoid(f_pre)                           # (B, H)
    q = q.reshape(b, local, dh).to(F32)
    k = k.reshape(b, local, dh).to(F32) * dh ** -0.5
    v = v.reshape(b, local, dh).to(F32)
    m_new = torch.maximum(log_f + st["m"], i_pre)
    f_eff = torch.exp(log_f + st["m"] - m_new)
    i_eff = torch.exp(i_pre - m_new)
    C = st["C"] * f_eff[..., None, None] + i_eff[..., None, None] * \
        torch.einsum("bhk,bhv->bhkv", k, v)
    n = st["n"] * f_eff[..., None] + i_eff[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, local * dh).to(x.dtype)
    y = apply_rmsnorm(p.norm, y) * _silu32(z, x.dtype)
    out = apply_linear(p.down, y, policy=policy)
    st["C"].copy_(C)
    st["n"].copy_(n)
    st["m"].copy_(m_new)
    st["conv"].copy_(hist[:, 1:])
    return out, st


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory block; sequential by construction)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    def __init__(self, w_in, r, norm, down):
        super().__init__()
        self.w_in = w_in
        # block-diagonal recurrent weights, one (4dh, dh) block per head
        self.r = _param(r)
        self.norm = norm
        self.down = down


def init_slstm(d: int, *, heads=4, sparse=None, generator: torch.Generator,
               device, dtype=torch.float32) -> SLSTM:
    dh = d // heads
    kw = dict(generator=generator, device=device, dtype=dtype)
    return SLSTM(init_linear(d, 4 * d, sparse=sparse, name="w_in", **kw),
                 _normal((heads, 4 * dh, dh), 0.1, **kw),
                 init_rmsnorm(d, device=device, dtype=dtype),
                 init_linear(d, d, sparse=sparse, name="down", **kw))


def init_slstm_state(batch, d, *, heads=4, device=None, lead=()):
    """{"c", "n", "h" zeros, "m" at -1e30}, each (*lead, B, H, dh)
    float32."""
    shape = (*lead, batch, heads, d // heads)
    f32 = dict(dtype=F32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32),
            "m": torch.full(shape, NEG_BIG, **f32)}


def _slstm_cell(p: SLSTM, wx_t, st, *, heads):
    """wx_t (B, 4D): one step's input projection.  Returns the new state
    (new tensors)."""
    b = wx_t.shape[0]
    dh = wx_t.shape[-1] // 4 // heads
    rec = torch.einsum("bhd,hgd->bhg", st["h"].to(p.r.dtype), p.r).to(F32)
    pre = wx_t.reshape(b, heads, 4 * dh).to(F32) + rec
    z_pre, i_pre, f_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + st["m"], i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(log_f + st["m"] - m_new)
    c = f_eff * st["c"] + i_eff * z
    n = torch.clamp_min(f_eff * st["n"] + i_eff, 1e-6)
    return {"c": c, "n": n, "h": o * c / n, "m": m_new}


def apply_slstm_seq(p: SLSTM, x, *, heads=4, policy=None):
    b, t, d = x.shape
    wx = apply_linear(p.w_in, x, policy=policy)
    st = init_slstm_state(b, d, heads=heads, device=x.device)
    hs = []
    for i in range(t):
        st = _slstm_cell(p, wx[:, i], st, heads=heads)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).reshape(b, t, d).to(x.dtype)
    y = apply_rmsnorm(p.norm, y)
    return apply_linear(p.down, y, policy=policy)


def apply_slstm_step(p: SLSTM, x, st, *, heads=4, policy=None):
    """One token; ``st`` {"c", "n", "h", "m"} is written in place."""
    b, _, d = x.shape
    wx = apply_linear(p.w_in, x, policy=policy)[:, 0]
    new = _slstm_cell(p, wx, st, heads=heads)
    y = new["h"].reshape(b, 1, d).to(x.dtype)
    y = apply_rmsnorm(p.norm, y)
    out = apply_linear(p.down, y, policy=policy)
    for key, t in new.items():
        st[key].copy_(t)
    return out, st
