"""Port vs JAX package: layer primitives and decode attention.

Same numpy inputs on both sides.  Tolerance: float32 rtol/atol 1e-5 — the two
frameworks order their sums differently and use different libm kernels for
sin/cos/exp/rsqrt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_linear import ExecPolicy as JPolicy
from repro.core.sparsity import SparsityConfig as JCfg
from repro.core.sparsity import Static
from repro.launch.pack_tree import pack_tree as jax_pack_tree
from repro.models import attention as jattn
from repro.models import layers as jl

from repro_torch.core.sparse_linear import ExecPolicy, SparseLinear
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch.pack_tree import pack_tree
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = jl.apply_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tl.apply_rmsnorm(tl.RMSNorm(_t(scale)), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16 in -> bf16 out, computed in float32
    got16 = tl.RMSNorm(_t(scale))(_t(x).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("head_dim", [32, 80])
def test_rope_matches_half_split(head_dim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 4, head_dim)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 2)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.apply_rope(_t(x), _t(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)   # angles up to 500 rad in float32
    np.testing.assert_allclose(
        tl.rope_freqs(head_dim, 10000.0).numpy(),
        np.asarray(jl.rope_freqs(head_dim, 10000.0)), rtol=1e-6)
    # 1-D positions broadcast over the batch
    got1 = tl.apply_rope(_t(x), _t(pos[0]), 10000.0)
    want1 = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 10000.0)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-4,
                               atol=1e-4)


def test_unembedding_masks_padded_columns():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((48, 16)).astype(np.float32)
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    want = jl.apply_unembedding({"table": jnp.asarray(table)},
                                jnp.asarray(x), 40)
    got = tl.apply_unembedding(tl.Embedding(_t(table)), _t(x), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[..., 40:] == -1e30).all()
    toks = np.array([[3], [47]])
    np.testing.assert_array_equal(
        tl.apply_embedding(tl.Embedding(_t(table)), _t(toks)).numpy(),
        np.asarray(jl.apply_embedding({"table": jnp.asarray(table)},
                                      jnp.asarray(toks))))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_unembedding_keeps_its_cast_table_and_logits_stay_bit_equal(dtype):
    """The table is cast to the activation dtype once per model and dtype,
    not on every decode step: the logits are bit-equal to the per-step cast
    (what the JAX package's ``table.astype(x.dtype)`` does), and a table
    changed in place is cast again."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((96, 32)).astype(np.float32)
    emb = tl.Embedding(_t(table))
    for step in range(3):
        x = _t(rng.standard_normal((4, 1, 32)).astype(np.float32)).to(dtype)
        want = x @ emb.table.to(dtype).T
        want[..., 90:] = -1e30
        got = tl.apply_unembedding(emb, x, 90)
        assert got.dtype == dtype and torch.equal(got, want)
        cast = emb.table_as(dtype)
        assert emb.table_as(dtype) is cast          # kept, not recast
        assert (cast is emb.table) == (dtype == torch.float32)
        if step == 1:
            with torch.no_grad():
                emb.table.mul_(2)                    # changed in place
            assert emb.table_as(dtype) is not cast or dtype == torch.float32
            assert torch.equal(emb.table_as(dtype), emb.table.to(dtype))


def _linear_pair(rng, out_f, in_f, cfg):
    w = rng.standard_normal((out_f, in_f)).astype(np.float32) * in_f ** -0.5
    jnode = {"w": jnp.asarray(w)}
    tnode = SparseLinear(_t(w), None)
    if cfg is not None:
        jnode["sparsity"] = Static(JCfg(*cfg))
        tnode = SparseLinear(_t(w), SparsityConfig(*cfg))
    return jnode, tnode


@pytest.mark.parametrize("mode", ["dense", "masked", "packed", "packed_int8"])
def test_mlp_matches(mode):
    rng = np.random.default_rng(3)
    cfg = (2, 16, 1)
    names = (("gate", 96, 64), ("up", 96, 64), ("down", 64, 96))
    pairs = {n: _linear_pair(rng, o, i, cfg) for n, o, i in names}
    jp = {n: p[0] for n, p in pairs.items()}
    tm = tl.MLP(*(pairs[n][1] for n in ("gate", "up", "down")))
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    if mode.startswith("packed"):
        q = "int8" if mode.endswith("int8") else None
        jp = jax_pack_tree(jp, quantize=q)
        tm = pack_tree(tm, quantize=q)
        jpol, tpol = JPolicy(mode="packed"), ExecPolicy(mode="packed")
    else:
        jpol, tpol = JPolicy(mode=mode), ExecPolicy(mode=mode)
    want = jl.apply_mlp(jp, jnp.asarray(x), policy=jpol)
    got = tl.apply_mlp(tm, _t(x), policy=tpol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_linear_sparsity_follows_reference_group_choice():
    from repro_torch.configs.base import choose_group
    # the full-width stablelm_3b projections: M aligned to in_features // 16
    assert tl.linear_sparsity(2560, SparsityConfig(8, 128)) == \
        SparsityConfig(5, 80)
    assert tl.linear_sparsity(6912, SparsityConfig(8, 128)) == \
        SparsityConfig(3, 48)
    assert tl.linear_sparsity(128, SparsityConfig(2, 16)) == \
        SparsityConfig(1, 8)
    assert tl.linear_sparsity(64, None) is None
    from repro.configs.base import choose_group as jchoose
    for k in (8, 160, 432, 2560, 6912, 100):
        j = jchoose(k, 1 / 16, 128)
        assert choose_group(k, 1 / 16, 128) == SparsityConfig(j.n, j.m, j.k)
    g = torch.Generator().manual_seed(0)
    node = tl.init_linear(128, 32, sparse=SparsityConfig(2, 16), generator=g,
                          device="cpu")
    assert node.sparsity == SparsityConfig(1, 8)
    from repro_torch.core.sparsity import satisfies_pattern
    assert satisfies_pattern(node.w.data, node.sparsity)


def test_decode_attention_and_cache_write_match():
    rng = np.random.default_rng(4)
    b, s, h, hkv, dh, d = 3, 8, 4, 2, 16, 64
    names = (("wq", h * dh, d), ("wk", hkv * dh, d), ("wv", hkv * dh, d),
             ("wo", d, h * dh))
    pairs = {n: _linear_pair(rng, o, i, (2, 16, 1)) for n, o, i in names}
    jp = {n: p[0] for n, p in pairs.items()}
    ta = tattn.Attention(*(pairs[n][1] for n in ("wq", "wk", "wv", "wo")))
    kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=dh, rope_theta=1e4)
    jcache = jattn.init_kv_cache(b, s, hkv, dh, dtype=jnp.float32)
    tcache = tattn.init_kv_cache(b, s, hkv, dh, device="cpu",
                                 dtype=torch.float32)
    # stale content at the rows about to be written: the write must replace
    stale = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    jcache = {"k": jnp.asarray(stale), "v": jnp.asarray(-stale)}
    tcache = {"k": _t(stale), "v": _t(-stale)}
    # slot 2 starts past the end of the cache: nothing may be written for it
    pos = np.array([0, 3, s + 1])
    for step in range(3):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        jout, jcache = jattn.apply_attention_decode(
            jp, jnp.asarray(x), jcache, jnp.asarray(pos + step),
            policy=JPolicy(mode="masked"), **kw)
        tout, tcache = tattn.apply_attention_decode(
            ta, _t(x), tcache, _t(pos + step),
            policy=ExecPolicy(mode="masked"), **kw)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL)
    np.testing.assert_array_equal(tcache["k"][2].numpy(), stale[2])


def test_decode_attention_window_mask():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    lens = np.array([2, 6])
    for window in (-1, 3):
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lens),
                                      window=window)
        got = tattn.decode_attention(_t(q), _t(k), _t(v), _t(lens),
                                     window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
