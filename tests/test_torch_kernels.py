"""Port vs JAX package: the plain PyTorch versions of the five packed matmul
kernels (K1 xwT, K3 xwT_q8, K2 block_spmm, K4 block_spmm_q8, K5 spmm)
against the Pallas kernels in interpret mode and the jnp oracles.

Tolerances: float32 rtol/atol 1e-5 (summation order only).  bfloat16
activations: rtol/atol 1e-5 as well wherever the port's plain version is
held against the interpret-mode kernel on inputs that reach its rounding —
both round the packed values (and the sums of duplicate indices, and the
int8 scale products) to bfloat16 at the same places and accumulate exact
products in float32, so only the summation order differs; rtol/atol 2e-2
where a test keeps the looser check it had, and against the interpret
kernel's output for a single activation row (Bx = 1 or Cd = 1): XLA on the
CPU evaluates that kernel's dot in bfloat16 there (8e-3 away from the exact
product of the very same bf16 scatter matrix), which is the reference's own
rounding.  The scatter rows themselves are held bit-equal to the Pallas
body's ``_scatter_matrix``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro.kernels import ref as jref
from repro.kernels.demm_block_spmm import demm_block_spmm_pallas
from repro.kernels.demm_q8 import demm_block_spmm_q8_pallas, demm_xwT_q8_pallas
from repro.kernels.demm_spmm import (_scatter_matrix, demm_spmm_pallas,
                                     demm_xwT_pallas)
from repro.quant import quantize as jq

from repro_torch import obs, tune
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.demm_block_spmm import (demm_block_spmm,
                                                 demm_block_spmm_plain,
                                                 pack_block_sparse)
from repro_torch.kernels.demm_q8 import (demm_block_spmm_q8,
                                         demm_block_spmm_q8_plain,
                                         demm_xwT_q8, demm_xwT_q8_plain)
from repro_torch.kernels.demm_spmm import demm_spmm, demm_spmm_plain
from repro_torch.kernels.demm_xwT import (demm_xwT, demm_xwT_plain,
                                          scatter_groups)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_SAME_ROUNDING = dict(rtol=1e-5, atol=1e-5)


def _bf16_tol(rows):
    """Tolerance against a bf16 interpret-mode kernel with ``rows``
    activation rows (B columns); see the module docstring."""
    return BF16_SAME_ROUNDING if rows > 1 else BF16
# (n, m, O, G, Bx): M in {16, 48, 80}, ragged Bx and O
SHAPES = [(2, 16, 24, 4, 5), (3, 48, 20, 3, 1), (5, 80, 33, 2, 37),
          (8, 16, 16, 2, 4)]


def _packed(n, m, o, g, seed, duplicates=False, exact=True):
    rng = np.random.default_rng(seed)
    cfg = jsp.SparsityConfig(n, m)
    w = jsp.random_sparse_dense(rng, o, g * m, cfg)
    p = jsp.pack(jnp.asarray(w), cfg)
    values, indices = np.asarray(p.values), np.asarray(p.indices)
    if duplicates:
        # every slot of a group points at one column.  exact: non-zero
        # quarter-integers, whose sums are exact in bfloat16 too; otherwise
        # standard normal, whose sums round
        if exact:
            values = (rng.integers(1, 9, values.shape) / 4
                      * rng.choice([-1.0, 1.0], values.shape))
        else:
            values = rng.standard_normal(values.shape)
        values = values.astype(np.float32)
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
    # a block-tagged weight whose values are not (RB, A_max, block_r, Ne)
    # raises the JAX package's ValueError; an unknown layout tag too
    pw = tsp.PackedWeight(v, i, cfg=cfg, dense_shape=(4, 32))
    pw.layout = "block"
    with pytest.raises(ValueError, match="unstacked"):
        ops.demm_matmul_packed(x, pw)
    pw.layout = "nope"
    with pytest.raises(ValueError, match="unknown PackedWeight layout"):
        ops.demm_matmul_packed(x, pw)
    for op in ("xwT_block", "xwT_block_q8", "spmm"):
        assert tune.backend_names(op) == ("cuda", "reference")
    ag = torch.zeros(1, 2, dtype=torch.int32)
    bv, bi = torch.zeros(1, 2, 4, 2), torch.zeros(1, 2, 4, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        demm_block_spmm(ag, bv, bi, x.T, cfg, r=8)         # RB*block_r != r
    with pytest.raises(ValueError):
        demm_block_spmm(ag[:, :1], bv, bi, x.T, cfg, r=4)  # ag shape
    with pytest.raises(TypeError):
        demm_block_spmm(ag.long(), bv, bi, x.T, cfg, r=4)  # ag dtype
    with pytest.raises(TypeError):
        demm_block_spmm_q8(ag, bv, bi, torch.ones(1, 2, 4), x.T, cfg, r=4)
    with pytest.raises(ValueError):
        demm_block_spmm_q8(ag, bv.to(torch.int8), bi, torch.ones(1, 2), x.T,
                           cfg, r=4)                       # scales shape
    with pytest.raises(ValueError):
        demm_spmm(v, i, torch.zeros(48, 3), cfg)           # K != G*M


@pytest.mark.parametrize("n,m,o,g,bx", SHAPES)
def test_xwT_duplicates_bf16_match_interpret_kernel(n, m, o, g, bx):
    """Duplicate indices whose sums round in bfloat16: K1's and K3's plain
    versions sum them in the activation dtype, slot by slot, as the TPU
    kernel's scatter matrix does (1e-5 relative; float32 sums after the
    product would differ by bfloat16 rounding of the summed weight)."""
    values, indices = _packed(n, m, o, g, seed=5 * n + m, duplicates=True,
                              exact=False)
    x = np.random.default_rng(bx + 7).standard_normal((bx, g * m)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    xb = _t(x, torch.bfloat16)
    got = demm_xwT_plain(xb, _t(values), _t(indices), tcfg).numpy()
    kern = demm_xwT_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(values),
                           jnp.asarray(indices), jcfg, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **_bf16_tol(bx))
    # the scatter rows are bit-equal to the Pallas body's, group by group
    s_port = scatter_groups(_t(values), _t(indices), m, torch.bfloat16)
    for gg in range(g):
        s_jax = _scatter_matrix(jnp.asarray(values[:, gg:gg + 1]),
                                jnp.asarray(indices[:, gg:gg + 1]), m, n,
                                jnp.bfloat16)
        np.testing.assert_array_equal(s_port[:, gg].numpy(),
                                      np.asarray(s_jax, np.float32))
    q = np.clip(np.round(values * 60), -127, 127).astype(np.int8)
    for shape in ((o,), (o, g)):
        scales = np.random.default_rng(o).uniform(0.005, 0.05, shape).astype(np.float32)
        got = demm_xwT_q8_plain(xb, _t(q), _t(indices), _t(scales),
                                tcfg).numpy()
        kern = demm_xwT_q8_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                                  jnp.asarray(indices), jnp.asarray(scales),
                                  jcfg, interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), **_bf16_tol(bx))


# (n, m, R, G, block_r, a_max, Cd): a_max None = the densest row block's
# active count; an a_max above G pads with slots aliasing group 0
BLOCK_SHAPES = [(2, 16, 64, 4, 16, None, 8), (5, 80, 32, 3, 8, 5, 3),
                (3, 48, 24, 5, 8, None, 1), (8, 16, 32, 2, 32, None, 16)]


def _block_packed(n, m, r, g, block_r, a_max, seed, duplicates=False):
    """A JAX-packed block weight with an inactive (row block, group) tile and
    an all-zero row block; numpy (dense, active_groups, values, indices)."""
    rng = np.random.default_rng(seed)
    cfg = jsp.SparsityConfig(n, m)
    w = jsp.random_sparse_dense(rng, r, g * m, cfg)
    tiles = w.reshape(r // block_r, block_r, g, m)
    tiles[0, :, g - 1] = 0
    if r // block_r > 1:
        tiles[-1] = 0
    pw = jsp.pack_block(jnp.asarray(w), cfg, block_r=block_r, a_max=a_max)
    ag, values, indices = (np.asarray(pw.active_groups),
                           np.array(pw.values), np.array(pw.indices))
    if duplicates:
        indices = np.ascontiguousarray(np.broadcast_to(indices[..., :1],
                                                       indices.shape))
        values = np.where(values != 0, values,
                          rng.standard_normal(values.shape)).astype(np.float32)
        values[:, :, 0] = 0                         # padded rows
    return w, ag, values, indices


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("n,m,r,g,block_r,a_max,cd", BLOCK_SHAPES)
def test_block_spmm_plain_vs_interpret_kernel(n, m, r, g, block_r, a_max, cd,
                                              duplicates, dtype):
    w, ag, values, indices = _block_packed(n, m, r, g, block_r, a_max,
                                           seed=r + m, duplicates=duplicates)
    b = np.random.default_rng(cd).standard_normal((g * m, cd)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = demm_block_spmm_plain(_t(ag), _t(values), _t(indices), _t(b, tdt),
                                tcfg, r=r).numpy()
    kern = demm_block_spmm_pallas(jnp.asarray(ag), jnp.asarray(values),
                                  jnp.asarray(indices), jnp.asarray(b, jdt),
                                  jcfg, r=r, interpret=True)
    assert got.dtype == np.float32 and got.shape == (r, cd)
    tol = F32 if dtype == "float32" else _bf16_tol(cd)
    np.testing.assert_allclose(got, np.asarray(kern), **tol)
    if not duplicates:
        assert not np.any(got[r - block_r:]) or r == block_r  # zero row block
    if dtype == "float32":
        want = jref.block_spmm_ref(jnp.asarray(ag), jnp.asarray(values),
                                   jnp.asarray(indices), jnp.asarray(b),
                                   jcfg, r)
        np.testing.assert_allclose(got, np.asarray(want), **F32)
        np.testing.assert_allclose(
            tref.block_spmm_ref(_t(ag), _t(values), _t(indices), _t(b), tcfg,
                                r).numpy(), got, **F32)
        if not duplicates:
            np.testing.assert_allclose(got, w @ b, rtol=1e-4, atol=1e-4)
    # the CPU route of the kernel wrapper, B as a transposed view too
    before = demm_block_spmm.launches
    bt = _t(np.ascontiguousarray(b.T), tdt).T
    np.testing.assert_array_equal(
        demm_block_spmm(_t(ag), _t(values), _t(indices), bt, tcfg,
                        r=r).numpy(), got)
    assert demm_block_spmm.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,r,g,block_r,a_max,cd", BLOCK_SHAPES)
def test_block_spmm_q8_plain_vs_interpret_kernel(n, m, r, g, block_r, a_max,
                                                 cd, dtype):
    w, _, _, _ = _block_packed(n, m, r, g, block_r, a_max, seed=r * m)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    jqw = jq.quantize_packed(jsp.pack_block(jnp.asarray(w), jcfg,
                                            block_r=block_r, a_max=a_max))
    ag, q, indices, scales = (np.asarray(jqw.active_groups),
                              np.asarray(jqw.values), np.asarray(jqw.indices),
                              np.asarray(jqw.scales))
    b = np.random.default_rng(cd + 1).standard_normal((g * m, cd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = demm_block_spmm_q8_plain(_t(ag), _t(q), _t(indices), _t(scales),
                                   _t(b, tdt), tcfg, r=r).numpy()
    kern = demm_block_spmm_q8_pallas(jnp.asarray(ag), jnp.asarray(q),
                                     jnp.asarray(indices),
                                     jnp.asarray(scales), jnp.asarray(b, jdt),
                                     jcfg, r=r, interpret=True)
    tol = F32 if dtype == "float32" else _bf16_tol(cd)
    np.testing.assert_allclose(got, np.asarray(kern), **tol)
    if dtype == "float32":
        want = jref.block_spmm_q8_ref(jnp.asarray(ag), jnp.asarray(q),
                                      jnp.asarray(indices),
                                      jnp.asarray(scales), jnp.asarray(b),
                                      jcfg, r)
        np.testing.assert_allclose(got, np.asarray(want), **F32)
        np.testing.assert_allclose(
            tref.block_spmm_q8_ref(_t(ag), _t(q), _t(indices), _t(scales),
                                   _t(b), tcfg, r).numpy(), got, **F32)
    before = demm_block_spmm_q8.launches
    np.testing.assert_array_equal(
        demm_block_spmm_q8(_t(ag), _t(q), _t(indices), _t(scales),
                           _t(b, tdt), tcfg, r=r).numpy(), got)
    assert demm_block_spmm_q8.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("n,m,o,g,bx", SHAPES)
def test_spmm_plain_vs_interpret_kernel(n, m, o, g, bx, duplicates, dtype):
    values, indices = _packed(n, m, o, g, seed=n * o, duplicates=duplicates,
                              exact=False)
    b = np.random.default_rng(bx + 9).standard_normal((g * m, bx)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = demm_spmm_plain(_t(values), _t(indices), _t(b, tdt), tcfg).numpy()
    kern = demm_spmm_pallas(jnp.asarray(values), jnp.asarray(indices),
                            jnp.asarray(b, jdt), jcfg, block_r=16,
                            block_c=16, interpret=True)
    assert got.dtype == np.float32 and got.shape == (o, bx)
    tol = F32 if dtype == "float32" else _bf16_tol(bx)
    np.testing.assert_allclose(got, np.asarray(kern), **tol)
    if dtype == "float32":
        want = jref.spmm_ref(jnp.asarray(values), jnp.asarray(indices),
                             jnp.asarray(b), jcfg, (o, g * m))
        np.testing.assert_allclose(got, np.asarray(want), **F32)
        np.testing.assert_allclose(
            tref.spmm_ref(_t(values), _t(indices), _t(b), tcfg,
                          (o, g * m)).numpy(), got, **F32)
    before = demm_spmm.launches
    np.testing.assert_array_equal(
        demm_spmm(_t(values), _t(indices), _t(b, tdt), tcfg).numpy(), got)
    assert demm_spmm.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("duplicates", [False, True])
def test_spmm_plain_vs_interpret_kernel_wide_b(duplicates, dtype):
    """K5 at the width its tiled body serves (Cd = 200, M = 48, ragged R):
    the plain version the card's kernel is held to agrees with
    ``demm_spmm_pallas`` in interpret mode."""
    n, m, o, g, cd = 3, 48, 100, 3, 200
    values, indices = _packed(n, m, o, g, seed=cd + o, duplicates=duplicates,
                              exact=False)
    b = np.random.default_rng(cd).standard_normal((g * m, cd)).astype(np.float32)
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = demm_spmm_plain(_t(values), _t(indices), _t(b, tdt), tcfg).numpy()
    kern = demm_spmm_pallas(jnp.asarray(values), jnp.asarray(indices),
                            jnp.asarray(b, jdt), jcfg, block_r=32,
                            block_c=128, interpret=True)
    assert got.shape == (o, cd)
    tol = F32 if dtype == "float32" else BF16_SAME_ROUNDING
    np.testing.assert_allclose(got, np.asarray(kern), **tol)
    before = demm_spmm.launches
    np.testing.assert_array_equal(
        demm_spmm(_t(values), _t(indices), _t(b, tdt), tcfg).numpy(), got)
    assert demm_spmm.launches == before


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# (label, B, M, Ne, G, body K5 must take); values float32 (R, G, Ne)
_SPMM_BODY_CASES = [
    ("bf16 Cd=64", lambda: _bf16(640, 64), 80, 5, 8, "tiled"),
    ("bf16 Cd=200", lambda: _bf16(384, 200), 48, 3, 8, "tiled"),
    ("bf16 Cd=256", lambda: _bf16(640, 256), 80, 5, 8, "tiled"),
    ("bf16 Cd=1024", lambda: _bf16(160, 1024), 16, 2, 10, "tiled"),
    ("bf16 Cd=4 (narrow)", lambda: _bf16(640, 4), 80, 5, 8, "gather"),
    ("bf16 Cd=63 (below the switch)", lambda: _bf16(640, 63), 80, 5, 8,
     "gather"),
    ("float32 B (TF32 would change it)",
     lambda: torch.zeros(640, 256), 80, 5, 8, "gather"),
    ("transposed B", lambda: _bf16(256, 640).T, 80, 5, 8, "gather"),
    ("rows not 16-byte aligned (Cd=100)", lambda: _bf16(640, 100), 80, 5, 8,
     "gather"),
    ("base not 16-byte aligned", lambda: _bf16(640, 264)[:, 1:257], 80, 5, 8,
     "gather"),
    ("a 16-byte aligned column window", lambda: _bf16(640, 264)[:, 8:264],
     80, 5, 8, "tiled"),
    ("rows of pairs not 16-byte aligned (G x Ne = 30)",
     lambda: _bf16(480, 256), 80, 5, 6, "gather"),
    ("M > 128", lambda: _bf16(1152, 256), 144, 5, 8, "gather"),
    ("Ne > 8", lambda: _bf16(640, 256), 80, 12, 8, "gather"),
]


@pytest.mark.parametrize("label,make,m,ne,g,want", _SPMM_BODY_CASES,
                         ids=[c[0] for c in _SPMM_BODY_CASES])
def test_spmm_body_choice(label, make, m, ne, g, want):
    from repro_torch.kernels.demm_spmm import spmm_body
    values = torch.zeros((4, g, ne))
    indices = torch.zeros((4, g, ne), dtype=torch.int32)
    assert spmm_body(values, indices, make(), m) == want, label


def test_spmm_body_override_is_checked_on_the_cpu_too():
    from repro_torch.kernels.demm_spmm import demm_spmm_on
    n, m, o, g = 5, 80, 8, 4
    values, indices = _packed(n, m, o, g, seed=1)
    tcfg = tsp.SparsityConfig(n, m)
    b = _t(np.ones((g * m, 256), np.float32))
    with pytest.raises(ValueError, match="tiled body takes"):
        demm_spmm_on("tiled", _t(values), _t(indices), b, tcfg)
    with pytest.raises(ValueError, match="body must be"):
        demm_spmm_on("dense", _t(values), _t(indices), b, tcfg)
    want = demm_spmm_plain(_t(values), _t(indices), b, tcfg)
    np.testing.assert_array_equal(
        demm_spmm_on("gather", _t(values), _t(indices), b, tcfg).numpy(),
        want.numpy())


def test_block_q8_body_override_is_checked_on_the_cpu_too():
    from repro_torch.kernels.demm_q8 import (demm_block_spmm_q8_on,
                                             demm_block_spmm_q8_plain)
    from repro_torch.quant import quantize_packed
    n, m, r, g = 2, 16, 32, 4
    w = jsp.random_sparse_dense(np.random.default_rng(6), r, g * m,
                                jsp.SparsityConfig(n, m))
    tcfg = tsp.SparsityConfig(n, m)
    qw = quantize_packed(tsp.pack_block(_t(w), tcfg, block_r=8))
    args = (qw.active_groups, qw.values, qw.indices, qw.scales)
    b = _t(np.random.default_rng(7).standard_normal((g * m, 3)).astype(
        np.float32))                     # B (K, Cd) contiguous: not serving
    with pytest.raises(ValueError, match="cluster body does not take"):
        demm_block_spmm_q8_on("cluster", *args, b, tcfg, r=r)
    with pytest.raises(ValueError, match="body must be"):
        demm_block_spmm_q8_on("dense", *args, b, tcfg, r=r)
    np.testing.assert_array_equal(
        demm_block_spmm_q8_on("gather", *args, b, tcfg, r=r).numpy(),
        demm_block_spmm_q8_plain(*args, b, tcfg, r=r).numpy())


def _header_constant(name, header):
    import re
    from repro_torch.kernels._build import CSRC
    text = (CSRC / header).read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, f"{name} not in {header}"
    return int(found.group(1))


def test_body_choice_limits_match_the_launchers():
    """The Python choosers state each body's limits once; the CUDA launchers
    refuse what lies beyond them.  The two must name the same numbers."""
    import re
    from repro_torch.kernels import demm_block_spmm as kb, demm_spmm as ks
    from repro_torch.kernels import demm_xwT as kx
    from repro_torch.kernels._build import CSRC
    assert ks.TILED_MAX_M == _header_constant("kTcMaxM", "demm_spmm_tc.cuh")
    assert ks.TILED_MAX_NE == _header_constant("kTcMaxNe", "demm_spmm_tc.cuh")
    takes = (CSRC / "demm_block_cluster.cuh").read_text()
    takes = takes[takes.index("inline bool cluster_takes"):]
    takes = takes[:takes.index("\n}\n")]
    assert re.search(rf"g\.cd <= {kb.CLUSTER_MAX_CD}\b", takes)
    # the span rule is written over the value width (1, 2 or 4 bytes), as
    # cluster_takes states it with values.element_size()
    assert "g.block_r) * g.ne * W::kValueBytes) % 16 == 0" in takes
    assert "g.block_r % 4 == 0" in takes
    bulk = "demm_xwt_bulk.cuh"
    assert kx.BULK_MAX_BX == _header_constant("kBulkMaxBt", bulk)
    assert kx.BULK_HEAD_BYTES == _header_constant("kBulkHeadBytes", bulk)
    takes = (CSRC / bulk).read_text()
    takes = takes[takes.index("inline bool bulk_takes"):]
    takes = takes[:takes.index("\n}\n")]
    assert "g.bx <= kBulkMaxBt" in takes
    assert "(pairs * W::kValueBytes) % 16 == 0" in takes
    assert "(pairs * sizeof(int32_t)) % 16 == 0" in takes
    # the stage plan needs the x tile and two rows of pairs, as xwt_body
    plan = (CSRC / bulk).read_text()
    plan = plan[plan.index("inline bool bulk_plan"):]
    assert "fixed + 2 * row_bytes > static_cast<size_t>(smem_limit)" in plan
    # K3: a row's staged scales (per group: G float32, per row: none) are
    # part of its row bytes, a 16-byte multiple, read from an aligned array
    assert "(static_cast<size_t>(g.g) * W::kStagedScaleBytes) % 16 == 0" \
        in takes
    assert "aligned(weights.staged_scale_bytes())" in takes
    rows = (CSRC / bulk).read_text()
    rows = rows[rows.index("inline size_t bulk_row_bytes"):]
    assert "static_cast<size_t>(g) * W::kStagedScaleBytes;" in rows
    common = (CSRC / "demm_xwt_common.cuh").read_text()
    int8 = common[common.index("struct Int8BulkWeights"):]
    assert ("kStagedScaleBytes = PER_GROUP ? sizeof(float) : 0;"
            in int8[:int8.index("\n};\n")])
    q8 = (CSRC / "demm_xwt_q8.cu").read_text()
    assert "Int8BulkWeights<XT, false>" in q8       # scale_cols == 1
    assert "Int8BulkWeights<XT, true>" in q8        # scale_cols == G


def test_launch_refusal_is_not_a_cuda_error():
    """A launcher's own refusal (negative code) is a ValueError that names
    it; a CUDA error (positive code) stays a RuntimeError, so a caller that
    skips refused tunables never swallows a fault of the card."""
    from repro_torch.kernels.demm_xwT import LaunchRefused, raise_on_launch_error
    raise_on_launch_error(0, "k")
    with pytest.raises(LaunchRefused, match="inconsistent shapes"):
        raise_on_launch_error(-2, "k")
    with pytest.raises(RuntimeError, match="error 700") as info:
        raise_on_launch_error(700, "k")
    assert not isinstance(info.value, LaunchRefused)


# (label, Bx (Cd), B = xᵀ?, block_r, Ne, M, body K4 must take)
_Q8_BODY_CASES = [
    ("serving Bx=1", 1, True, 128, 5, 80, "cluster"),
    ("serving Bx=4", 4, True, 128, 5, 80, "cluster"),
    ("serving Bx=8", 8, True, 128, 3, 48, "cluster"),
    ("Bx=9 (too wide)", 9, True, 128, 5, 80, "gather"),
    ("Bx=37", 37, True, 128, 5, 80, "gather"),
    ("B (K, Cd) contiguous", 4, False, 128, 5, 80, "gather"),
    ("block_r*Ne not a multiple of 16", 4, True, 8, 5, 80, "gather"),
    ("block_r*Ne a multiple of 16", 4, True, 8, 2, 16, "cluster"),
    ("M*2 bytes not a multiple of 16", 4, True, 128, 2, 12, "gather"),
]


@pytest.mark.parametrize("label,bx,serving,block_r,ne,m,want", _Q8_BODY_CASES,
                         ids=[c[0] for c in _Q8_BODY_CASES])
def test_block_q8_body_choice(label, bx, serving, block_r, ne, m, want):
    from repro_torch.kernels.demm_q8 import block_q8_body
    k = 4 * m
    values = torch.zeros((2, 4, block_r, ne), dtype=torch.int8)
    indices = torch.zeros((2, 4, block_r, ne), dtype=torch.int32)
    scales = torch.ones((2, 4, block_r))
    b = _bf16(bx, k).T if serving else _bf16(k, bx)
    assert block_q8_body(values, indices, scales, b, m) == want, label


# (label, Bx (Cd), B: "serving" xᵀ / "paper" (K, Cd) / "float32" xᵀ,
#  block_r, Ne, M, values dtype, body K2 must take)
_BLOCK_BODY_CASES = [
    ("serving Bx=1", 1, "serving", 128, 5, 80, torch.float32, "cluster"),
    ("serving Bx=4", 4, "serving", 128, 5, 80, torch.float32, "cluster"),
    ("serving Bx=8", 8, "serving", 128, 3, 48, torch.float32, "cluster"),
    ("serving Bx=4 bf16 values", 4, "serving", 128, 5, 80, torch.bfloat16,
     "cluster"),
    ("serving Bx=4 float32 x", 4, "float32", 128, 5, 80, torch.float32,
     "cluster"),
    ("Bx=9 (too wide)", 9, "serving", 128, 5, 80, torch.float32, "gather"),
    ("Bx=37", 37, "serving", 128, 5, 80, torch.float32, "gather"),
    ("B (K, Cd) contiguous", 4, "paper", 128, 5, 80, torch.float32,
     "gather"),
    # block_r x Ne = 4 values: 16 bytes in float32, 8 in bfloat16
    ("4-byte values, 16-byte span", 4, "serving", 4, 1, 16, torch.float32,
     "cluster"),
    ("2-byte values, 8-byte span", 4, "serving", 4, 1, 16, torch.bfloat16,
     "gather"),
    ("block_r not a multiple of 4", 4, "serving", 2, 8, 16, torch.float32,
     "gather"),
    ("M*2 bytes not a multiple of 16", 4, "serving", 128, 2, 12,
     torch.float32, "gather"),
]


@pytest.mark.parametrize("label,bx,kind,block_r,ne,m,vdtype,want",
                         _BLOCK_BODY_CASES,
                         ids=[c[0] for c in _BLOCK_BODY_CASES])
def test_block_body_choice(label, bx, kind, block_r, ne, m, vdtype, want):
    from repro_torch.kernels.demm_block_spmm import block_body
    k = 4 * m
    ag = torch.zeros((2, 4), dtype=torch.int32)
    values = torch.zeros((2, 4, block_r, ne), dtype=vdtype)
    indices = torch.zeros((2, 4, block_r, ne), dtype=torch.int32)
    b = {"serving": lambda: _bf16(bx, k).T, "paper": lambda: _bf16(k, bx),
         "float32": lambda: torch.zeros(bx, k).T}[kind]()
    assert block_body(ag, values, indices, b, m) == want, label


@pytest.mark.parametrize("cd", [1, 4, 8, 256])
def test_row_packed_spmm_never_takes_the_cluster_body(cd):
    """K5 runs K2's launcher with the identity address stream
    (``active_groups`` null, values (R, G, Ne)): always the gather body,
    even at serving widths where the block layout takes the cluster body."""
    from repro_torch.kernels.demm_block_spmm import block_body
    values = torch.zeros((128, 8, 4))
    indices = torch.zeros((128, 8, 4), dtype=torch.int32)
    b = _bf16(cd, 8 * 16).T
    assert block_body(None, values, indices, b, 16) == "gather"


def test_block_body_override_is_checked_on_the_cpu_too():
    from repro_torch.kernels.demm_block_spmm import demm_block_spmm_on
    n, m, r, g = 2, 16, 32, 4
    w = jsp.random_sparse_dense(np.random.default_rng(8), r, g * m,
                                jsp.SparsityConfig(n, m))
    tcfg = tsp.SparsityConfig(n, m)
    pw = tsp.pack_block(_t(w), tcfg, block_r=8)
    args = (pw.active_groups, pw.values, pw.indices)
    x = _t(np.random.default_rng(9).standard_normal((3, g * m)).astype(
        np.float32))
    before = demm_block_spmm.launches
    with pytest.raises(ValueError, match="cluster body does not take"):
        demm_block_spmm_on("cluster", *args, x.T.contiguous(), tcfg, r=r)
    with pytest.raises(ValueError, match="body must be"):
        demm_block_spmm_on("dense", *args, x.T, tcfg, r=r)
    want = demm_block_spmm_plain(*args, x.T, tcfg, r=r).numpy()
    for body in ("cluster", "gather", None):
        np.testing.assert_array_equal(
            demm_block_spmm_on(body, *args, x.T, tcfg, r=r).numpy(), want)
    np.testing.assert_array_equal(
        demm_block_spmm(*args, x.T, tcfg, r=r, cluster_size=2).numpy(), want)
    assert demm_block_spmm.launches == before     # CPU: the plain version


def _xwt_args(bx, k, m, ne, *, xdtype=torch.bfloat16, vdtype=torch.float32,
              offset=0):
    g = k // m
    buf = torch.zeros(bx * k + offset, dtype=xdtype)
    x = buf[offset:].view(bx, k)
    values = torch.zeros((4, g, ne), dtype=vdtype)
    indices = torch.zeros((4, g, ne), dtype=torch.int32)
    return x, values, indices


# (label, Bx, K, M, Ne, keyword arguments of _xwt_args, duplicates, body K1
#  must take)
_XWT_BODY_CASES = [
    ("serving Bx=1", 1, 2560, 80, 5, {}, False, "bulk"),
    ("serving Bx=4", 4, 2560, 80, 5, {}, False, "bulk"),
    ("serving Bx=8 K=6912", 8, 6912, 48, 3, {}, False, "bulk"),
    ("float32 x, bf16 values", 4, 2560, 80, 5,
     dict(xdtype=torch.float32, vdtype=torch.bfloat16), False, "bulk"),
    ("duplicates (the widest tile)", 1, 2560, 80, 5, {}, True, "bulk"),
    ("Bx=9 (too wide)", 9, 2560, 80, 5, {}, False, "gather"),
    ("Bx=37", 37, 2560, 80, 5, {}, False, "gather"),
    ("x tile beyond shared memory (K=16384, Bx=8)", 8, 16384, 128, 8, {},
     False, "gather"),
    ("float32 x, K=8192: one row fits, the duplicates tile does not", 1,
     8192, 128, 8, dict(xdtype=torch.float32), False, "bulk"),
    ("the same with duplicates", 1, 8192, 128, 8,
     dict(xdtype=torch.float32), True, "gather"),
    ("x rows not 16-byte multiples (K=36)", 4, 36, 12, 4, {}, False,
     "gather"),
    ("x not 16-byte aligned", 4, 2560, 80, 5, dict(offset=1), False,
     "gather"),
    ("a row of pairs not 16-byte multiples (G x Ne = 30)", 4, 480, 80, 5,
     {}, False, "gather"),
    ("bf16 values: G x Ne = 20 is 40 bytes", 4, 320, 80, 5,
     dict(vdtype=torch.bfloat16), False, "gather"),
    ("float32 values: G x Ne = 20 is 80 bytes", 4, 320, 80, 5, {}, False,
     "bulk"),
]


@pytest.mark.parametrize("label,bx,k,m,ne,kw,duplicates,want",
                         _XWT_BODY_CASES,
                         ids=[c[0] for c in _XWT_BODY_CASES])
def test_xwt_body_choice(label, bx, k, m, ne, kw, duplicates, want):
    from repro_torch.kernels.demm_xwT import xwt_body
    x, values, indices = _xwt_args(bx, k, m, ne, **kw)
    assert xwt_body(x, values, indices, m, duplicates=duplicates) == want, \
        label


def test_xwt_body_override_is_checked_on_the_cpu_too():
    from repro_torch.kernels.demm_xwT import demm_xwT_on
    n, m, o, g, bx = 5, 80, 8, 4, 3
    values, indices = _packed(n, m, o, g, seed=10)
    tcfg = tsp.SparsityConfig(n, m)
    x = _t(np.random.default_rng(11).standard_normal((bx, g * m)).astype(
        np.float32))
    x_wide = _t(np.random.default_rng(12).standard_normal((9, g * m)).astype(
        np.float32))
    before = demm_xwT.launches
    with pytest.raises(ValueError, match="bulk body does not take"):
        demm_xwT_on("bulk", x_wide, _t(values), _t(indices), tcfg)
    with pytest.raises(ValueError, match="body must be"):
        demm_xwT_on("dense", x, _t(values), _t(indices), tcfg)
    want = demm_xwT_plain(x, _t(values), _t(indices), tcfg).numpy()
    for body in ("bulk", "gather", None):
        np.testing.assert_array_equal(
            demm_xwT_on(body, x, _t(values), _t(indices), tcfg).numpy(), want)
    np.testing.assert_array_equal(
        demm_xwT_on("bulk", x, _t(values), _t(indices), tcfg, chunks=3,
                    rows_per_block=5).numpy(), want)
    assert demm_xwT.launches == before            # CPU: the plain version


def _xwt_q8_args(bx, k, m, ne, per_group, *, xdtype=torch.bfloat16,
                 scale_offset=0):
    x, values, indices = _xwt_args(bx, k, m, ne, xdtype=xdtype,
                                   vdtype=torch.int8)
    o, g = values.shape[:2]
    shape = (o, g) if per_group else (o,)
    n = int(np.prod(shape))
    scales = torch.ones(n + scale_offset)[scale_offset:].view(shape)
    return x, values, indices, scales


# (label, Bx, K, M, Ne, per-group scales?, keyword arguments of
#  _xwt_q8_args, duplicates, body K3 must take)
_XWT_Q8_BODY_CASES = [
    ("serving Bx=1 per row", 1, 2560, 80, 5, False, {}, False, "bulk"),
    ("serving Bx=4 per row", 4, 2560, 80, 5, False, {}, False, "bulk"),
    ("serving Bx=4 per group", 4, 2560, 80, 5, True, {}, False, "bulk"),
    ("serving Bx=8 K=6912 per row", 8, 6912, 48, 3, False, {}, False,
     "bulk"),
    ("serving Bx=8 K=6912 per group", 8, 6912, 48, 3, True, {}, False,
     "bulk"),
    ("float32 x per group", 4, 2560, 80, 5, True,
     dict(xdtype=torch.float32), False, "bulk"),
    ("duplicates (the widest tile) per group", 1, 6912, 48, 3, True, {},
     True, "bulk"),
    ("Bx=9 (too wide)", 9, 2560, 80, 5, False, {}, False, "gather"),
    ("Bx=37 per group", 37, 2560, 80, 5, True, {}, False, "gather"),
    # G x Ne = 20: 80 bytes of float32 values (K1 takes the bulk body), 20
    # of int8
    ("int8 values: G x Ne = 20 is 20 bytes", 4, 320, 80, 5, False, {},
     False, "gather"),
    ("int8 values: G x Ne = 32 is 32 bytes", 4, 320, 80, 8, False, {},
     False, "bulk"),
    # G = 2: 8 bytes of per-group scales a row; per-row scales are not
    # staged
    ("per-group scale rows not 16-byte multiples (G=2)", 4, 32, 16, 8,
     True, {}, False, "gather"),
    ("the same per row", 4, 32, 16, 8, False, {}, False, "bulk"),
    ("per-group scales not 16-byte aligned", 4, 2560, 80, 5, True,
     dict(scale_offset=1), False, "gather"),
    ("per-row scales not 16-byte aligned (read, not copied)", 4, 2560, 80,
     5, False, dict(scale_offset=1), False, "bulk"),
    ("x tile beyond shared memory (K=16384, Bx=8)", 8, 16384, 128, 8, True,
     {}, False, "gather"),
    # float32 x, K=55296: the x tile and two rows of pairs fit, with the
    # rows' 432 per-group scales they do not
    ("fit limit per row", 1, 55296, 128, 2, False,
     dict(xdtype=torch.float32), False, "bulk"),
    ("fit limit per group", 1, 55296, 128, 2, True,
     dict(xdtype=torch.float32), False, "gather"),
]


@pytest.mark.parametrize("label,bx,k,m,ne,per_group,kw,duplicates,want",
                         _XWT_Q8_BODY_CASES,
                         ids=[c[0] for c in _XWT_Q8_BODY_CASES])
def test_xwt_q8_body_choice(label, bx, k, m, ne, per_group, kw, duplicates,
                            want):
    from repro_torch.kernels.demm_xwT import xwt_body
    x, values, indices, scales = _xwt_q8_args(bx, k, m, ne, per_group, **kw)
    assert xwt_body(x, values, indices, m, duplicates=duplicates,
                    scales=scales) == want, label


@pytest.mark.parametrize("per_group", [False, True])
def test_xwt_q8_body_override_is_checked_on_the_cpu_too(per_group):
    from repro_torch.kernels.demm_q8 import demm_xwT_q8_on
    n, m, o, g, bx = 5, 80, 8, 16, 3        # int8 rows of 80 bytes
    values, indices = _packed(n, m, o, g, seed=13)
    tcfg = tsp.SparsityConfig(n, m)
    rng = np.random.default_rng(14)
    q = _t(rng.integers(-127, 128, values.shape).astype(np.int8))
    scales = _t(rng.uniform(0.001, 0.02, (o, g) if per_group else (o,))
                .astype(np.float32))
    x = _t(rng.standard_normal((bx, g * m)).astype(np.float32))
    x_wide = _t(rng.standard_normal((9, g * m)).astype(np.float32))
    before = (demm_xwT_q8.launches, dict(demm_xwT_q8.body_launches))
    with pytest.raises(ValueError, match="bulk body does not take"):
        demm_xwT_q8_on("bulk", x_wide, q, _t(indices), scales, tcfg)
    with pytest.raises(ValueError, match="body must be"):
        demm_xwT_q8_on("dense", x, q, _t(indices), scales, tcfg)
    with pytest.raises(ValueError, match="scales must have one of"):
        demm_xwT_q8_on(None, x, q, _t(indices), scales[:-1], tcfg)
    for lanes in (4, 32):
        with pytest.raises(ValueError, match="lanes must be 8 or 16"):
            demm_xwT_q8_on("bulk", x, q, _t(indices), scales, tcfg,
                           lanes=lanes)
    want = demm_xwT_q8_plain(x, q, _t(indices), scales, tcfg).numpy()
    for body in ("bulk", "gather", None):
        np.testing.assert_array_equal(
            demm_xwT_q8_on(body, x, q, _t(indices), scales, tcfg).numpy(),
            want)
    np.testing.assert_array_equal(
        demm_xwT_q8_on("bulk", x, q, _t(indices), scales, tcfg, chunks=3,
                       rows_per_block=5, lanes=8).numpy(), want)
    # CPU: the plain version, counted nowhere
    assert (demm_xwT_q8.launches, demm_xwT_q8.body_launches) == before


def test_pack_block_sparse_adapter_matches_jax():
    from repro.kernels.demm_block_spmm import pack_block_sparse as jpbs
    rng = np.random.default_rng(4)
    a = jsp.random_sparse_dense(rng, 256, 64, jsp.SparsityConfig(2, 16))
    a[:128, :16] = 0
    got = pack_block_sparse(a, tsp.SparsityConfig(2, 16))
    want = jpbs(a, jsp.SparsityConfig(2, 16))
    assert got[3] == want[3]
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g_, np.asarray(w_))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("op", ["xwT_block", "xwT_block_q8", "spmm"])
def test_block_and_spmm_dispatch_on_cpu(backend, op):
    n, m, r, g = 2, 16, 32, 4
    w = jsp.random_sparse_dense(np.random.default_rng(2), r, g * m,
                                jsp.SparsityConfig(n, m))
    tcfg = tsp.SparsityConfig(n, m)
    x = _t(np.random.default_rng(3).standard_normal((5, g * m)).astype(np.float32))
    reg = obs.MetricsRegistry()
    prev = obs.default_registry()
    obs.set_default_registry(reg)
    try:
        if op == "spmm":
            p = tsp.pack(_t(w), tcfg)
            got = ops.demm_spmm(p.values, p.indices, x.T, tcfg, (r, g * m),
                                backend=backend)
            ops.demm_spmm(p.values, p.indices, x.T, tcfg, (r, g * m),
                          backend=backend)
            want = _t(w) @ x.T
        else:
            pw = tsp.pack_block(_t(w), tcfg, block_r=8)
            if op == "xwT_block_q8":
                from repro_torch.quant import quantize_packed
                pw = quantize_packed(pw)
            got = ops.demm_matmul_packed(x, pw, backend=backend)
            ops.demm_matmul_packed(x, pw, backend=backend)
            want = x @ pw.to_dense().T
    finally:
        obs.set_default_registry(prev)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    counters = {(c["name"], c["labels"].get("op"), c["labels"].get("backend")):
                c["value"] for c in reg.snapshot(meta=False)["counters"]}
    assert counters[("kernel_dispatch_total", op, backend)] == 2
