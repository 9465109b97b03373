"""Port vs JAX package: the plain PyTorch versions of the two packed matmul
kernels against the Pallas kernels in interpret mode and the jnp oracles.

Tolerances: float32 rtol/atol 1e-5 (summation order only); bfloat16 rtol/atol
2e-2 against the interpret-mode kernel, which — like the port — rounds the
packed values to the activation dtype before a float32-accumulated product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro.kernels import ref as jref
from repro.kernels.demm_q8 import demm_xwT_q8_pallas
from repro.kernels.demm_spmm import demm_xwT_pallas

from repro_torch import obs, tune
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.demm_q8 import demm_xwT_q8, demm_xwT_q8_plain
from repro_torch.kernels.demm_xwT import demm_xwT, demm_xwT_plain

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# (n, m, O, G, Bx): M in {16, 48, 80}, ragged Bx and O
SHAPES = [(2, 16, 24, 4, 5), (3, 48, 20, 3, 1), (5, 80, 33, 2, 37),
          (8, 16, 16, 2, 4)]


def _packed(n, m, o, g, seed, duplicates=False):
    rng = np.random.default_rng(seed)
    cfg = jsp.SparsityConfig(n, m)
    w = jsp.random_sparse_dense(rng, o, g * m, cfg)
    p = jsp.pack(jnp.asarray(w), cfg)
    values, indices = np.asarray(p.values), np.asarray(p.indices)
    if duplicates:
        # every slot of a group points at one column; all values non-zero
        # quarter-integers, so that their sums are exact in bfloat16 too
        values = (rng.integers(1, 9, values.shape) / 4
                  * rng.choice([-1.0, 1.0], values.shape)).astype(np.float32)
        indices = np.broadcast_to(
            rng.integers(0, m, (o, g, 1)), indices.shape).astype(np.int32)
        values[0] = 0                               # an all-padded row
        indices[0] = 0
    return values, np.ascontiguousarray(indices)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("n,m,o,g,bx", SHAPES)
def test_xwT_plain_f32(n, m, o, g, bx, duplicates):
    values, indices = _packed(n, m, o, g, seed=n * m + o, duplicates=duplicates)
    x = np.random.default_rng(bx).standard_normal((bx, g * m)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    got = demm_xwT_plain(_t(x), _t(values), _t(indices), tcfg).numpy()
    kern = demm_xwT_pallas(jnp.asarray(x), jnp.asarray(values),
                           jnp.asarray(indices), jcfg, interpret=True)
    want = jref.xwT_ref(jnp.asarray(x), jnp.asarray(values),
                        jnp.asarray(indices), jcfg, (o, g * m))
    assert got.dtype == np.float32 and got.shape == (bx, o)
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    # the port's own oracle and the CPU route of the kernel wrapper agree
    np.testing.assert_allclose(
        tref.xwT_ref(_t(x), _t(values), _t(indices), tcfg,
                     (o, g * m)).numpy(), got, **F32)
    before = demm_xwT.launches
    np.testing.assert_array_equal(
        demm_xwT(_t(x), _t(values), _t(indices), tcfg).numpy(), got)
    assert demm_xwT.launches == before      # no kernel launch on the CPU


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("n,m,o,g,bx", SHAPES)
def test_xwT_plain_bf16_vs_interpret_kernel(n, m, o, g, bx, duplicates):
    values, indices = _packed(n, m, o, g, seed=n + m + o, duplicates=duplicates)
    x = np.random.default_rng(bx + 1).standard_normal((bx, g * m)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    got = demm_xwT_plain(_t(x, torch.bfloat16), _t(values), _t(indices),
                         tcfg).numpy()
    kern = demm_xwT_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(values),
                           jnp.asarray(indices), jcfg, interpret=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(kern), **BF16)
    # bf16 values give the same answer as f32 values rounded on the fly
    np.testing.assert_array_equal(
        demm_xwT_plain(_t(x, torch.bfloat16), _t(values, torch.bfloat16),
                       _t(indices), tcfg).numpy(), got)


def _quantized(values, per_group, seed):
    rng = np.random.default_rng(seed)
    o, g, _ = values.shape
    q = np.clip(np.round(values * 40), -127, 127).astype(np.int8)
    shape = (o, g) if per_group else (o,)
    scales = rng.uniform(0.005, 0.05, shape).astype(np.float32)
    return q, scales


@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("n,m,o,g,bx", SHAPES)
def test_xwT_q8_plain_f32(n, m, o, g, bx, duplicates, per_group):
    values, indices = _packed(n, m, o, g, seed=n * m, duplicates=duplicates)
    q, scales = _quantized(values, per_group, seed=o)
    x = np.random.default_rng(bx + 2).standard_normal((bx, g * m)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    got = demm_xwT_q8_plain(_t(x), _t(q), _t(indices), _t(scales),
                            tcfg).numpy()
    kern = demm_xwT_q8_pallas(jnp.asarray(x), jnp.asarray(q),
                              jnp.asarray(indices), jnp.asarray(scales),
                              jcfg, interpret=True)
    want = jref.xwT_q8_ref(jnp.asarray(x), jnp.asarray(q),
                           jnp.asarray(indices), jnp.asarray(scales), jcfg,
                           (o, g * m))
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    np.testing.assert_allclose(
        tref.xwT_q8_ref(_t(x), _t(q), _t(indices), _t(scales), tcfg,
                        (o, g * m)).numpy(), got, **F32)
    before = demm_xwT_q8.launches
    np.testing.assert_array_equal(
        demm_xwT_q8(_t(x), _t(q), _t(indices), _t(scales), tcfg).numpy(), got)
    assert demm_xwT_q8.launches == before


@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("n,m,o,g,bx", SHAPES)
def test_xwT_q8_plain_bf16_vs_interpret_kernel(n, m, o, g, bx, per_group):
    values, indices = _packed(n, m, o, g, seed=n * m + 3)
    q, scales = _quantized(values, per_group, seed=o + 1)
    x = np.random.default_rng(bx + 3).standard_normal((bx, g * m)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    got = demm_xwT_q8_plain(_t(x, torch.bfloat16), _t(q), _t(indices),
                            _t(scales), tcfg).numpy()
    kern = demm_xwT_q8_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                              jnp.asarray(indices), jnp.asarray(scales),
                              jcfg, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **BF16)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("quantized", [False, True])
def test_ops_dispatch_on_cpu(backend, quantized):
    n, m, o, g, bx = 2, 16, 24, 4, 5
    values, indices = _packed(n, m, o, g, seed=11)
    tcfg = tsp.SparsityConfig(n, m)
    x = _t(np.random.default_rng(0).standard_normal((bx, g * m)).astype(np.float32))
    pw = tsp.PackedWeight(_t(values), _t(indices), cfg=tcfg,
                          dense_shape=(o, g * m))
    want = x @ pw.to_dense().T
    if quantized:
        from repro_torch.quant import quantize_packed
        pw = quantize_packed(pw)
        want = x @ pw.to_dense().T
    reg = obs.MetricsRegistry()
    prev = obs.default_registry()
    obs.set_default_registry(reg)
    try:
        got = ops.demm_matmul_packed(x, pw, backend=backend)
        ops.demm_matmul_packed(x, pw, backend=backend)
    finally:
        obs.set_default_registry(prev)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    op = "xwT_q8" if quantized else "xwT"
    counters = {(c["name"], c["labels"].get("op"), c["labels"].get("backend")):
                c["value"] for c in reg.snapshot(meta=False)["counters"]}
    assert counters[("kernel_dispatch_total", op, backend)] == 2
    events = [e for e in reg.trace.events if e["name"] == "kernel_dispatch"]
    assert len(events) == 1                 # first dispatch only


def test_registry_and_wrapper_errors():
    assert tune.backend_names("xwT") == ("cuda", "reference")
    assert tune.backend_names("xwT_q8") == ("cuda", "reference")
    for bad in ("pallas", "pallas_interpret", "auto"):
        with pytest.raises(ValueError, match="unknown backend"):
            tune.get_variant("xwT", bad)
    cfg = tsp.SparsityConfig(2, 16)
    x = torch.zeros(3, 32)
    v = torch.zeros(4, 2, 2)
    i = torch.zeros(4, 2, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        demm_xwT(torch.zeros(3, 48), v, i, cfg)            # K != G*M
    with pytest.raises(TypeError):
        demm_xwT(x.to(torch.float16), v, i, cfg)           # activation dtype
    with pytest.raises(TypeError):
        demm_xwT(x, v, i.to(torch.int64), cfg)             # index dtype
    with pytest.raises(ValueError):
        demm_xwT(x.T.contiguous().T, v, i, cfg)            # not contiguous
    with pytest.raises(TypeError):
        demm_xwT_q8(x, v, i, torch.ones(4), cfg)           # values not int8
    with pytest.raises(ValueError):
        demm_xwT_q8(x, v.to(torch.int8), i, torch.ones(4, 3), cfg)
    pw = tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32))
    pw.layout = "block"
    with pytest.raises(NotImplementedError):
        ops.demm_matmul_packed(x, pw)
