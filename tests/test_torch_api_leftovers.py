"""The packed-API leftovers of the port against the JAX package's functions
on the same numpy inputs: ``models.layers.pack_linear``,
``core.sparse_linear.apply_packed``, ``quant.quantize_packed(observer=)``,
``quant.quantize_tree``, ``quant._slot_columns``,
``quant.activation_calibration``, ``core.sparsity.pack_block_stacked`` and
``unpack_packed``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.core import sparse_linear as jsl
from repro.core import sparsity as jsp
from repro.models import layers as jlayers
from repro import quant as jquant
from repro.quant import quantize as jq

from repro_torch.core import sparse_linear as tsl
from repro_torch.core import sparsity as tsp
from repro_torch.models import layers as tlayers
from repro_torch import quant as tquant
from repro_torch.quant import quantize as tq

SCALE_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _weight(o, k, n, m, seed=0):
    """A dense N:M weight whose rows and groups differ in scale (so clipping
    choices and per-group scales differ between units)."""
    rng = np.random.default_rng(seed)
    w = jsp.random_sparse_dense(rng, o, k, jsp.SparsityConfig(n, m))
    w *= np.exp(rng.standard_normal((o, k // m, 1)) * 0.7).repeat(
        m, axis=-1).reshape(o, k)
    # a few outliers, so a clip below amax can win
    w[rng.integers(0, o, 6), rng.integers(0, k, 6)] *= 6.0
    return w.astype(np.float32)


def _acts(k, b=16, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)) * np.exp(rng.standard_normal(k))
    return x.astype(np.float32)


def _pair(w, n, m, layout="xwT"):
    """(jax PackedWeight, torch PackedWeight) of one dense numpy weight."""
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    return (jsp.PackedWeight.from_dense(jnp.asarray(w), jcfg, layout),
            tsp.PackedWeight.from_dense(_t(w), tcfg, layout))


def _same_packed(tp, jp):
    np.testing.assert_array_equal(_np(tp.values), _np(jp.values))
    np.testing.assert_array_equal(_np(tp.indices), _np(jp.indices))
    assert tp.dense_shape == tuple(jp.dense_shape)
    assert tp.layout == jp.layout and tp.qdtype == jp.qdtype
    if jp.active_groups is not None:
        np.testing.assert_array_equal(_np(tp.active_groups),
                                      _np(jp.active_groups))
        assert tuple(tp.block_geom) == tuple(jp.block_geom)
    if jp.scales is not None:
        np.testing.assert_allclose(_np(tp.scales), _np(jp.scales),
                                   **SCALE_TOL)


# ---------------------------------------------------------------------------
# models.layers.pack_linear, core.sparse_linear.apply_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,k", [(2, 16, 1), (2, 32, 2)])
def test_pack_linear_matches_jax(n, m, k):
    w = _weight(32, 128, n * k, m)
    jcfg, tcfg = jsp.SparsityConfig(n, m, k), tsp.SparsityConfig(n, m, k)
    jp = jlayers.pack_linear({"w": jnp.asarray(w),
                              "sparsity": jsp.Static(jcfg)})
    tp = tlayers.pack_linear(tsl.SparseLinear(_t(w), tcfg))
    assert isinstance(tp, tsp.PackedWeight) and tp.cfg == tcfg
    _same_packed(tp, jp)
    # packed and dense nodes pass through as they are
    assert tlayers.pack_linear(tp) is tp
    dense = tsl.SparseLinear(_t(w), None)
    assert tlayers.pack_linear(dense) is dense


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_apply_packed_matches_jax(layout, backend):
    """``apply_packed`` with and without a reconfigured ``cfg`` (4:32 stored,
    served as 2 passes of 2:32) against the JAX package's; on the CPU the
    ``cuda`` backend's wrappers take their plain versions."""
    w = _weight(64, 128, 4, 32, seed=3)
    x = _acts(128, b=5)
    jp, tp = _pair(w, 4, 32, layout)
    for jc, tc in ((None, None), (jsp.SparsityConfig(2, 32, 2),
                                  tsp.SparsityConfig(2, 32, 2))):
        want = jsl.apply_packed(jp, jnp.asarray(x), cfg=jc)
        got = tsl.apply_packed(tp, _t(x), cfg=tc, backend=backend)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="n_effective"):
        tsl.apply_packed(tp, _t(x), cfg=tsp.SparsityConfig(2, 32))
    with pytest.raises(TypeError, match="PackedWeight"):
        tsl.apply_packed(tsl.SparseLinear(_t(w), None), _t(x))


# ---------------------------------------------------------------------------
# quant: observer, _slot_columns, activation_calibration, quantize_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_slot_columns_equal(layout):
    w = _weight(64, 256, 3, 32, seed=4)
    jp, tp = _pair(w, 3, 32, layout)
    got = tq._slot_columns(tp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(jq._slot_columns(jp)))


CALIBRATION_CASES = [("xwT", "per_row"), ("xwT", "per_group"),
                     ("block", "per_row")]


@pytest.mark.parametrize("layout,gran", CALIBRATION_CASES)
def test_activation_calibration_matches_jax(layout, gran):
    """The observer's scales at 1e-6 and the clip ratio it picked per unit
    equal the JAX package's; the int8 values of ``quantize_packed(...,
    observer=)`` equal exactly.  A unit whose choice differs (a near-tie
    between float32 sum orders) is reported by name."""
    w = _weight(64, 256, 16, 32, seed=5)
    x = _acts(256)
    jp, tp = _pair(w, 16, 32, layout)
    jobs = jquant.activation_calibration(jnp.asarray(x), granularity=gran)
    tobs = tquant.activation_calibration(_t(x), granularity=gran)
    want, got = _np(jobs(jp)), _np(tobs(tp))
    base = _np(tquant.amax_scales(tp, gran))
    ratio_t, ratio_j = got / base, want / base
    grid = np.asarray(tquant.CLIP_GRID, np.float32)
    pick_t = np.abs(ratio_t[..., None] - grid).argmin(-1)
    pick_j = np.abs(ratio_j[..., None] - grid).argmin(-1)
    differ = np.argwhere(pick_t != pick_j)
    assert not len(differ), f"clip choices differ at units {differ.tolist()}"
    # the search is not vacuous: some unit clips below amax
    assert (pick_t > 0).any()
    np.testing.assert_allclose(got, want, **SCALE_TOL)

    jqw = jquant.quantize_packed(jp, observer=jobs,
                                 granularity=gran if layout == "xwT"
                                 else "per_row")
    tqw = tquant.quantize_packed(tp, observer=tobs,
                                 granularity=gran if layout == "xwT"
                                 else "per_row")
    assert tqw.qdtype == "int8" and tqw.values.dtype == torch.int8
    _same_packed(tqw, jqw)


def test_quantize_packed_observer_shape_wins():
    """The repair: ``quantize_packed`` takes ``observer=``, and the
    observer's output shape wins over ``granularity`` (per-group scales
    from an observer under the default per-row granularity), as in the JAX
    package."""
    w = _weight(32, 128, 2, 16, seed=6)
    jp, tp = _pair(w, 2, 16)
    got = tquant.quantize_packed(
        tp, observer=lambda pw: tquant.amax_scales(pw, "per_group") * 0.9)
    want = jquant.quantize_packed(
        jp, observer=lambda pw: jquant.amax_scales(pw, "per_group") * 0.9)
    assert tuple(got.scales.shape) == (32, 8) == tuple(want.scales.shape)
    assert got.scales.dtype == torch.float32
    _same_packed(got, want)
    # no observer: the data-free amax scales, as before
    _same_packed(tquant.quantize_packed(tp), jquant.quantize_packed(jp))


class _Tree(nn.Module):
    def __init__(self, nodes):
        super().__init__()
        for name, node in nodes.items():
            setattr(self, name, node)


@pytest.mark.parametrize("gran", ["per_row", "per_group"])
def test_quantize_tree_matches_jax(gran):
    """Every float PackedWeight of a module tree quantized (block nodes per
    row whatever ``granularity``), quantized and dense nodes left alone, in
    place — node for node the JAX package's ``quantize_tree`` on the same
    tree as a dict."""
    ws = {name: _weight(32, 128, 2, 16, seed=i)
          for i, name in enumerate(("a", "b", "c", "d"))}
    ja, ta = _pair(ws["a"], 2, 16)
    jb, tb = _pair(ws["b"], 2, 16, "block")
    jc, tc = _pair(ws["c"], 2, 16)
    jc, tc = jquant.quantize_packed(jc), tquant.quantize_packed(tc)
    jtree = {"a": ja, "inner": {"b": jb, "c": jc},
             "d": {"w": jnp.asarray(ws["d"])}}
    dense = tsl.SparseLinear(_t(ws["d"]), None)
    ttree = _Tree({"a": ta, "inner": _Tree({"b": tb, "c": tc}), "d": dense})
    x = _acts(128)
    jobs = jquant.activation_calibration(jnp.asarray(x), granularity=gran)
    tobs = tquant.activation_calibration(_t(x), granularity=gran)
    # the block node's scale unit is per group already; the observer of a
    # per-group granularity would not fit it, so it runs without one there
    for observe in (False, True):
        kw_j = {"observer": jobs} if observe and gran == "per_row" else {}
        kw_t = {"observer": tobs} if observe and gran == "per_row" else {}
        jout = jquant.quantize_tree(jtree, granularity=gran, **kw_j)
        tree = _Tree({"a": ta, "inner": _Tree({"b": tb, "c": tc}),
                      "d": dense})
        tout = tquant.quantize_tree(tree, granularity=gran, **kw_t)
        assert tout is tree
        _same_packed(tout.a, jout["a"])
        _same_packed(tout.inner.b, jout["inner"]["b"])
        assert tout.inner.c is tc             # already quantized: untouched
        assert tout.d is dense                # dense: passes through
        assert tuple(tout.a.scales.shape) == ((32,) if gran == "per_row"
                                              else (32, 8))
        assert tuple(tout.inner.b.scales.shape) == tuple(
            tb.values.shape[:-1])


def test_quantize_tree_over_a_packed_model():
    """On a whole packed model (reduced stablelm_3b): every packed node is
    quantized, equal to ``pack_tree(..., quantize="int8")``'s."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model

    cfg = dataclasses.replace(get_arch("stablelm_3b").reduced(),
                              num_layers=1)
    model = tquant.quantize_tree(pack_tree(build_model(cfg, device="cpu",
                                                       seed=0)))
    ref = pack_tree(build_model(cfg, device="cpu", seed=0), quantize="int8")
    got = {n: m for n, m in model.named_modules()
           if isinstance(m, tsp.PackedWeight)}
    want = {n: m for n, m in ref.named_modules()
            if isinstance(m, tsp.PackedWeight)}
    assert got.keys() == want.keys() and len(got) >= 7
    for name, node in got.items():
        assert node.qdtype == "int8", name
        assert torch.equal(node.values, want[name].values), name
        assert torch.equal(node.scales, want[name].scales), name


# ---------------------------------------------------------------------------
# core.sparsity: pack_block_stacked, unpack_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(2,), (2, 3)])
def test_pack_block_stacked_slices_equal_jax(lead):
    """The port returns the per-slice block PackedWeights of a stacked
    weight, one shared a_max; each equals the JAX package's stacked
    children sliced."""
    o, k, n, m = 32, 256, 2, 32
    rng = np.random.default_rng(8)
    w = np.stack([_weight(o, k, n, m, seed=s)
                  for s in range(int(np.prod(lead)))]).reshape(*lead, o, k)
    # one slice far sparser: the shared a_max is the densest slice's
    w.reshape(-1, o, k)[0][:, 64:] = 0.0
    jcfg, tcfg = jsp.SparsityConfig(n, m), tsp.SparsityConfig(n, m)
    jp = jsp.pack_block_stacked(jnp.asarray(w), jcfg, block_r=8)
    tps = tsp.pack_block_stacked(_t(w), tcfg, block_r=8)
    assert isinstance(tps, list) and len(tps) == int(np.prod(lead))
    jv = _np(jp.values).reshape(-1, *jp.values.shape[len(lead):])
    ji = _np(jp.indices).reshape(-1, *jp.indices.shape[len(lead):])
    ja = _np(jp.active_groups).reshape(-1,
                                       *jp.active_groups.shape[len(lead):])
    for s, tp in enumerate(tps):
        assert tuple(tp.block_geom) == tuple(jp.block_geom)
        assert tp.dense_shape == (o, k)
        np.testing.assert_array_equal(_np(tp.values), jv[s])
        np.testing.assert_array_equal(_np(tp.indices), ji[s])
        np.testing.assert_array_equal(_np(tp.active_groups), ja[s])
        np.testing.assert_array_equal(
            _np(tp.to_dense()), w.reshape(-1, o, k)[s])
    a_max = jp.block_geom[1]
    with pytest.raises(ValueError, match="densest row block of the stack"):
        tsp.pack_block_stacked(_t(w), tcfg, block_r=8, a_max=a_max - 1)
    # a 2-D weight: a list of one, the PackedWeight that pack_block gives
    [one] = tsp.pack_block_stacked(_t(w.reshape(-1, o, k)[1]), tcfg)
    _same_packed(one, jsp.pack_block_stacked(
        jnp.asarray(w.reshape(-1, o, k)[1]), jcfg))


def test_unpack_packed_equals_jax():
    w = _weight(16, 64, 2, 16, seed=9)
    jcfg, tcfg = jsp.SparsityConfig(2, 16), tsp.SparsityConfig(2, 16)
    got = tsp.unpack_packed(tsp.pack(_t(w), tcfg))
    want = jsp.unpack_packed(jsp.pack(jnp.asarray(w), jcfg))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), w)


def test_exports_follow_the_jax_package():
    import repro.core as jcore
    import repro_torch.core as tcore

    for name in ("DeMMConfig", "demm_spmm", "demm_spmm_k_passes",
                 "unpack_packed"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name
    for name in ("CLIP_GRID", "activation_calibration", "quantize_tree"):
        assert name in jquant.__all__ and name in tquant.__all__, name
    assert tquant.CLIP_GRID == jquant.CLIP_GRID
