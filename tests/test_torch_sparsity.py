"""Port vs JAX package: pruning masks, packing, unpacking, int8 quantization.

Everything here must be bit-equal: masks, packed values and indices (incl.
under-full groups and magnitude ties, where the choice among equals decides
where a padded slot lands), int8 values and float32 scales.
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
    with pytest.raises(NotImplementedError):
        tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32), layout="block")
    with pytest.raises(ValueError):
        tq.quantize_packed(tq.quantize_packed(pw))
