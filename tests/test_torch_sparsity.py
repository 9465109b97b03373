"""Port vs JAX package: pruning masks, packing (row-packed and two-level
block), unpacking, int8 quantization.

Everything here must be bit-equal: masks, packed values and indices (incl.
under-full groups and magnitude ties, where the choice among equals decides
where a padded slot lands), the block layout's active-group lists (incl.
all-zero row blocks and ``a_max > G`` padding), int8 values and float32
scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro.quant import quantize as jq

from repro_torch.core import sparsity as tsp
from repro_torch.quant import quantize as tq

PATTERNS = [(2, 16), (5, 80), (3, 48), (8, 16), (1, 4)]


def _cases(n, m, seed):
    """dense inputs: plain random, tied magnitudes, under-full groups."""
    rng = np.random.default_rng(seed)
    rows, groups = 12, 3
    plain = rng.standard_normal((rows, groups * m)).astype(np.float32)
    tied = np.round(plain * 2) / 2                 # many equal magnitudes
    under = jsp.random_sparse_dense(rng, rows, groups * m,
                                    jsp.SparsityConfig(n, m))
    under_tied = np.sign(under) * np.ceil(np.abs(under))
    empty = np.zeros((rows, groups * m), np.float32)
    return {"plain": plain, "tied": tied, "under": under,
            "under_tied": under_tied.astype(np.float32), "empty": empty}


@pytest.mark.parametrize("n,m", PATTERNS)
@pytest.mark.parametrize("kind", ["plain", "tied", "under", "under_tied",
                                  "empty"])
def test_prune_mask_and_pack_bit_equal(n, m, kind):
    a = _cases(n, m, seed=100 * n + m)[kind]
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    want_mask = np.asarray(jsp.prune_mask(jnp.asarray(a), jcfg))
    got_mask = tsp.prune_mask(torch.from_numpy(a), tcfg).numpy()
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(
        tsp.prune(torch.from_numpy(a), tcfg).numpy(),
        np.asarray(jsp.prune(jnp.asarray(a), jcfg)))
    # pack both the raw matrix (drops beyond-top entries) and the pruned one
    for dense in (a, a * want_mask):
        want = jsp.pack(jnp.asarray(dense), jcfg)
        got = tsp.pack(torch.from_numpy(dense), tcfg)
        assert got.indices.dtype == torch.int32
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))


@pytest.mark.parametrize("n,m", PATTERNS)
def test_unpack_and_roundtrip(n, m):
    rng = np.random.default_rng(n + m)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    a = jsp.random_sparse_dense(rng, 10, 2 * m, jcfg)
    p = tsp.pack(torch.from_numpy(a), tcfg)
    back = tsp.unpack(p.values, p.indices, tcfg, p.shape).numpy()
    np.testing.assert_array_equal(back, a)          # lossless on N:M input
    want = jsp.unpack(jnp.asarray(p.values.numpy()),
                      jnp.asarray(p.indices.numpy()), jcfg, (10, 2 * m))
    np.testing.assert_array_equal(back, np.asarray(want))
    assert tsp.satisfies_pattern(torch.from_numpy(a), tcfg)


def test_unpack_accumulates_duplicate_indices():
    cfg = tsp.SparsityConfig(2, 4)
    vals = torch.tensor([[[1.0, 2.0]]])
    idx = torch.tensor([[[3, 3]]], dtype=torch.int32)
    np.testing.assert_array_equal(
        tsp.unpack(vals, idx, cfg, (1, 4)).numpy(), [[0, 0, 0, 3.0]])


@pytest.mark.parametrize("granularity", ["per_row", "per_group"])
@pytest.mark.parametrize("n,m", [(2, 16), (5, 80), (3, 48)])
def test_quantize_packed_bit_equal(n, m, granularity):
    rng = np.random.default_rng(7 * n + m)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    w = jsp.random_sparse_dense(rng, 16, 3 * m, jcfg)
    w[3] = 0                                        # a fully padded row
    w *= rng.uniform(0.01, 10.0, (16, 1)).astype(np.float32)
    jpw = jsp.PackedWeight.from_dense(jnp.asarray(w), jcfg)
    tpw = tsp.PackedWeight.from_dense(torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(tpw.values.numpy(), np.asarray(jpw.values))
    jqw = jq.quantize_packed(jpw, granularity=granularity)
    tqw = tq.quantize_packed(tpw, granularity=granularity)
    assert tqw.qdtype == "int8" and tqw.values.dtype == torch.int8
    assert tqw.scales.dtype == torch.float32
    np.testing.assert_array_equal(tqw.scales.numpy(), np.asarray(jqw.scales))
    np.testing.assert_array_equal(tqw.values.numpy(), np.asarray(jqw.values))
    np.testing.assert_array_equal(tqw.indices.numpy(),
                                  np.asarray(jqw.indices))
    # dequantized dense weights agree too (float32 products of equal inputs)
    np.testing.assert_array_equal(tqw.to_dense().numpy(),
                                  np.asarray(jqw.to_dense()))
    back = tq.dequantize_packed(tqw)
    assert back.qdtype is None and back.scales is None
    np.testing.assert_array_equal(
        back.values.numpy(), np.asarray(jq.dequantize_packed(jqw).values))


def test_packed_weight_validation():
    cfg = tsp.SparsityConfig(2, 16)
    v = torch.zeros(4, 2, 2)
    i = torch.zeros(4, 2, 2, dtype=torch.int32)
    pw = tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32))
    assert (pw.out_features, pw.in_features, pw.groups) == (4, 32, 2)
    with pytest.raises(ValueError):
        tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 48))
    with pytest.raises(ValueError):
        tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32),
                         scales=torch.ones(4))
    with pytest.raises(ValueError):
        tsp.PackedWeight(v.to(torch.int8), i, cfg=cfg, dense_shape=(4, 32),
                         qdtype="int8")
    # the block layout is ported: it needs its address stream and a
    # consistent geometry, and takes per-(row-block, group, row) scales only
    with pytest.raises(ValueError, match="active_groups"):
        tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32), layout="block")
    bv, bi = torch.zeros(1, 2, 4, 2), torch.zeros(1, 2, 4, 2, dtype=torch.int32)
    ag = torch.zeros(1, 2, dtype=torch.int32)
    bpw = tsp.PackedWeight(bv, bi, cfg=cfg, dense_shape=(4, 32),
                           layout="block", active_groups=ag)
    assert bpw.block_geom == (4, 2) and not bpw.has_duplicates
    assert torch.equal(bpw.to_dense(), torch.zeros(4, 32))
    with pytest.raises(ValueError):
        tsp.PackedWeight(bv, bi, cfg=cfg, dense_shape=(8, 32),
                         layout="block", active_groups=ag)
    with pytest.raises(ValueError):
        tsp.PackedWeight(bv, bi, cfg=cfg, dense_shape=(4, 32),
                         layout="block", active_groups=ag[:, :1])
    with pytest.raises(ValueError):
        tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32),
                         active_groups=ag)
    with pytest.raises(ValueError):
        tsp.PackedWeight(bv.to(torch.int8), bi, cfg=cfg, dense_shape=(4, 32),
                         layout="block", active_groups=ag,
                         scales=torch.ones(1), qdtype="int8")
    with pytest.raises(ValueError, match="granularity"):
        tq.quantize_packed(bpw, granularity="per_group")
    with pytest.raises(ValueError):
        tq.quantize_packed(tq.quantize_packed(pw))


def test_duplicate_index_record():
    """``has_duplicates`` counts two *non-zero* slots of one group at one
    index; pack's padded slots (value 0 at index 0) do not count."""
    cfg = tsp.SparsityConfig(2, 4)
    idx = torch.tensor([[[0, 0]]], dtype=torch.int32)
    pw = tsp.PackedWeight(torch.tensor([[[1.0, 0.0]]]), idx, cfg=cfg,
                          dense_shape=(1, 4))
    assert not pw.has_duplicates
    dup = pw.replace(values=torch.tensor([[[1.0, 2.0]]]))
    assert dup.has_duplicates
    assert dup.replace(cfg=tsp.SparsityConfig(1, 4, 2)).has_duplicates
    assert not tsp.holds_duplicates(torch.ones(3, 2, 1),
                                    torch.zeros(3, 2, 1, dtype=torch.int32))


BLOCK_GEOMETRIES = [(4, None), (4, 5), (6, 4), (12, None), (None, None)]


@pytest.mark.parametrize("block_r,a_max", BLOCK_GEOMETRIES)
@pytest.mark.parametrize("n,m", PATTERNS)
@pytest.mark.parametrize("kind", ["plain", "tied", "under", "under_tied",
                                  "empty", "zero_block"])
def test_pack_block_bit_equal(n, m, kind, block_r, a_max):
    """pack_block gives JAX's values, indices and active-group lists bit for
    bit: magnitude ties, under-full groups, all-zero row blocks (and all-zero
    weights), inactive tiles, a_max > G padding, the default geometry."""
    cases = _cases(n, m, seed=10 * n + m)
    a = cases["under" if kind == "zero_block" else kind].copy()
    if kind == "zero_block":
        a[4:8] = 0                               # an all-zero row block
        a[:4, :m] = 0                            # an inactive (block, group)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    want = jsp.pack_block(jnp.asarray(a), jcfg, block_r=block_r, a_max=a_max)
    got = tsp.pack_block(torch.from_numpy(a), tcfg, block_r=block_r,
                         a_max=a_max)
    assert got.layout == "block" and got.block_geom == want.block_geom
    assert got.dense_shape == tuple(want.dense_shape)
    for name in ("values", "indices", "active_groups"):
        t = getattr(got, name)
        assert t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.indices.dtype == torch.int32
    assert got.active_groups.dtype == torch.int32
    assert not got.has_duplicates
    # unpack_block of the same packing, and to_dense, agree with JAX
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    np.testing.assert_array_equal(
        tsp.unpack_block(got.active_groups, got.values, got.indices, tcfg,
                         got.dense_shape).numpy(),
        np.asarray(jsp.unpack_block(want.active_groups, want.values,
                                    want.indices, jcfg, want.dense_shape)))
    if kind in ("under", "under_tied", "empty", "zero_block"):
        # lossless on a weight that satisfies the pattern
        np.testing.assert_array_equal(got.to_dense().numpy(), a)


def test_pack_block_a_max_validation():
    cfg = tsp.SparsityConfig(2, 16)
    w = torch.zeros(8, 32)
    w[0, 0], w[0, 16] = 1.0, 2.0                # two active groups
    with pytest.raises(ValueError, match="active groups"):
        tsp.pack_block(w, cfg, block_r=8, a_max=1)
    with pytest.raises(ValueError, match="active groups"):
        jsp.pack_block(jnp.asarray(w.numpy()), jsp.SparsityConfig(2, 16),
                       block_r=8, a_max=1)
    with pytest.raises(ValueError, match="divisible"):
        tsp.pack_block(w, cfg, block_r=3)
    pw = tsp.PackedWeight.from_dense(w, cfg, layout="block", a_max=4)
    assert pw.block_geom == (8, 4)
    assert pw.active_groups.tolist() == [[0, 1, 0, 0]]
    assert torch.equal(pw.to_dense(), w)


@pytest.mark.parametrize("n,m", [(2, 16), (5, 80), (3, 48)])
def test_quantize_block_bit_equal(n, m):
    rng = np.random.default_rng(11 * n + m)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    w = jsp.random_sparse_dense(rng, 16, 3 * m, jcfg)
    w[4:8] = 0                                   # an all-zero row block
    w *= rng.uniform(0.01, 10.0, (16, 1)).astype(np.float32)
    jpw = jsp.pack_block(jnp.asarray(w), jcfg, block_r=4, a_max=5)
    tpw = tsp.pack_block(torch.from_numpy(w), tcfg, block_r=4, a_max=5)
    jqw, tqw = jq.quantize_packed(jpw), tq.quantize_packed(tpw)
    assert tqw.qdtype == "int8" and tqw.values.dtype == torch.int8
    assert tuple(tqw.scales.shape) == (4, 5, 4)
    for name in ("values", "indices", "active_groups", "scales"):
        np.testing.assert_array_equal(getattr(tqw, name).numpy(),
                                      np.asarray(getattr(jqw, name)))
    np.testing.assert_array_equal(tqw.to_dense().numpy(),
                                  np.asarray(jqw.to_dense()))
    np.testing.assert_array_equal(tq.amax_scales(tpw).numpy(),
                                  np.asarray(jq.amax_scales(jpw)))
    back = tq.dequantize_packed(tqw)
    assert back.layout == "block" and back.qdtype is None
    np.testing.assert_array_equal(
        back.values.numpy(), np.asarray(jq.dequantize_packed(jqw).values))
