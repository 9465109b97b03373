"""Self-speculative decoding of the port (``repro_torch.spec``) against the
JAX package's (``repro.spec``), on the CPU.

* tier views of ``core.sparsity``: ``tier_sort_packed`` bit-equal to the JAX
  sort on both layouts, float and int8 (ties, padded slots, int8 -128);
  ``narrow_tier`` and ``to_dense`` of a view equal to JAX's, the view
  sharing the full tier's storage; ``reconfigure_k``;
* the kernel wrappers on a tier's prefix view (read in place, any other
  non-contiguous layout refused) and ``ops.demm_matmul_packed`` on a tier
  view against the JAX ``ops`` with ``tier_ne`` — the Pallas kernels in
  interpret mode — at the tolerances of ``tests/test_torch_kernels.py``;
* ``spec.tiers`` / ``spec.decode``: the same ``TierReport`` counts as the JAX
  derivation (its layers stacked: one JAX node is L of the port's), tensors
  shared with the full tier, the same refusals of ``guard_cache_kinds``,
  ``make_multistep`` equal to W single steps;
* both engines with ``spec=``: token streams equal to the JAX spec engines'
  and to the port's non-spec streams, greedy and sampled, the γ clamp near
  ``max_len``, preemption under spec, the ``spec_*`` counters and the SLO
  report's ``spec_reject`` waste equal to the JAX engine's;
* ``launch.serve --spec-draft`` (refused without ``--packed``).

Reduced stablelm_3b at 8:16, float32 compute, weights carried across with
``convert.from_jax_params``; the card-only twins (the kernels on their
bodies, draft and verify graphs against eager) are in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro.core.sparse_linear import ExecPolicy as JExecPolicy
from repro.kernels import ops as jops
from repro.launch.pack_tree import pack_tree as jax_pack_tree
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.slo import slo_report as jax_slo_report
from repro.paged import PagedServeConfig as JPagedServeConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import make_engine as jax_make_engine
from repro.spec import SpecConfig as JSpecConfig
from repro.spec import derive_draft_tier as jax_derive_draft_tier
from repro.spec import tier_sort_tree as jax_tier_sort_tree
from repro.spec.decode import guard_cache_kinds as jax_guard_cache_kinds

from _torch_port import (jax_model_and_params, jax_tree_to_numpy,
                         reduced_pair)
from repro_torch import obs as tobs
from repro_torch.convert import from_jax_params
from repro_torch.core import sparsity as tsp
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.demm_block_spmm import (demm_block_spmm,
                                                 demm_block_spmm_plain)
from repro_torch.kernels.demm_q8 import (demm_block_spmm_q8,
                                         demm_block_spmm_q8_plain,
                                         demm_xwT_q8, demm_xwT_q8_plain)
from repro_torch.kernels.demm_xwT import (demm_xwT, demm_xwT_plain,
                                          prefix_pitch)
from repro_torch.obs.slo import slo_report
from repro_torch.paged import PagedServeConfig
from repro_torch.serve import Request, ServeConfig, make_engine
from repro_torch.spec import (SpecConfig, TierReport, derive_draft_tier,
                              make_multistep, parse_tier, tier_sort_tree)
from repro_torch.spec.decode import guard_cache_kinds

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DRAFT = "4:16"
POLICY = ExecPolicy(mode="packed", backend="reference")
JPOLICY = JExecPolicy(mode="packed", backend="reference")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# tier views: sort, narrow, densify — both layouts, float and int8
# ---------------------------------------------------------------------------

def _crafted(layout, qdtype, seed=0, n=8, m=16, scale=1.0):
    """A packed weight as numpy arrays, built to exercise the tier sort:
    magnitudes from a few levels (ties), under-full groups (padded slots at
    value 0, index 0) and, for int8, -128 beside 127 and -127, with scales
    in ``scale * [0.5, 2)``."""
    rng = np.random.default_rng(seed)
    if layout == "block":
        rb, a_max, block_r, g = 2, 3, 4, 5
        core = (rb, a_max, block_r)
        ag = np.stack([np.sort(rng.choice(g, a_max, replace=False))
                       for _ in range(rb)]).astype(np.int32)
        dense_shape, geom = (rb * block_r, g * m), (block_r, a_max)
    else:
        o, g = 6, 3
        core = (o, g)
        ag, dense_shape, geom = None, (o, g * m), None
    idx = np.stack([np.sort(rng.choice(m, n, replace=False))
                    for _ in range(int(np.prod(core)))]).reshape(*core, n)
    if qdtype is None:
        vals = (rng.integers(1, 4, (*core, n))
                * rng.choice([-1.0, 1.0], (*core, n))).astype(np.float32)
    else:
        vals = rng.choice(np.array([-128, 127, -127, 5, -5, 1], np.int8),
                          (*core, n))
    live = rng.integers(0, n + 1, core)          # non-zeros per group
    pad = np.arange(n) >= live[..., None]
    vals[pad] = 0
    idx[pad] = 0
    scales = None
    if qdtype is not None:
        shape = core if layout == "block" else core[:1]
        scales = (scale * rng.uniform(0.5, 2.0, shape)).astype(np.float32)
    return dict(values=vals, indices=idx.astype(np.int32), active_groups=ag,
                scales=scales, qdtype=qdtype, layout=layout, cfg=(n, m),
                dense_shape=dense_shape, block_geom=geom)


def _pair(spec, tier_ne=None):
    """The same packed weight as a JAX and a port PackedWeight."""
    kw = dict(dense_shape=spec["dense_shape"], layout=spec["layout"],
              block_geom=spec["block_geom"], qdtype=spec["qdtype"])
    opt = lambda a, f: None if a is None else f(a)        # noqa: E731
    jpw = jsp.PackedWeight(
        jnp.asarray(spec["values"]), jnp.asarray(spec["indices"]),
        cfg=jsp.SparsityConfig(*spec["cfg"]),
        active_groups=opt(spec["active_groups"], jnp.asarray),
        scales=opt(spec["scales"], jnp.asarray), tier_ne=tier_ne, **kw)
    tpw = tsp.PackedWeight(
        _t(spec["values"]), _t(spec["indices"]),
        cfg=tsp.SparsityConfig(*spec["cfg"]),
        active_groups=opt(spec["active_groups"], _t),
        scales=opt(spec["scales"], _t), tier_ne=tier_ne, **kw)
    return jpw, tpw


MODES = [("xwT", None), ("xwT", "int8"), ("block", None), ("block", "int8")]
MODE_IDS = ["xwT", "xwT-int8", "block", "block-int8"]


@pytest.mark.parametrize("layout,qdtype", MODES, ids=MODE_IDS)
def test_tier_sort_packed_matches_jax(layout, qdtype):
    spec = _crafted(layout, qdtype, seed=1)
    assert (spec["values"] == 0).any()            # padded slots present
    if qdtype:
        assert (spec["values"] == -128).any()
    jpw, tpw = _pair(spec)
    js, ts = jsp.tier_sort_packed(jpw), tsp.tier_sort_packed(tpw)
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    # magnitude-descending, padded slots last, -128 first
    mag = np.abs(ts.values.numpy().astype(np.float32))
    assert (np.diff(mag, axis=-1) <= 0).all()
    # a permutation per group: the full tier's weight is unchanged, and a
    # second sort changes nothing
    np.testing.assert_array_equal(ts.to_dense().numpy(),
                                  tpw.to_dense().numpy())
    again = tsp.tier_sort_packed(ts)
    assert torch.equal(again.values, ts.values)
    assert torch.equal(again.indices, ts.indices)
    assert ts.has_duplicates == tpw.has_duplicates


@pytest.mark.parametrize("layout,qdtype", MODES, ids=MODE_IDS)
def test_narrow_tier_and_to_dense_match_jax(layout, qdtype):
    spec = _crafted(layout, qdtype, seed=2)
    jpw, tpw = _pair(spec)
    jpw, tpw = jsp.tier_sort_packed(jpw), tsp.tier_sort_packed(tpw)
    for t in (1, 3, 5):
        jv, tv = jpw.replace(tier_ne=t), tpw.replace(tier_ne=t)
        assert tv.tier_ne == t and f"tier_ne={t}" in repr(tv)
        assert tv.values is tpw.values and tv.indices is tpw.indices
        jn, tn = jsp.narrow_tier(jv), tsp.narrow_tier(tv)
        assert tn.tier_ne is None and tn.cfg == tsp.SparsityConfig(t, 16, 1)
        assert jn.cfg.n_effective == tn.cfg.n_effective == t
        # views of the full tier's storage, not copies
        for view, full in ((tn.values, tpw.values),
                           (tn.indices, tpw.indices)):
            assert view.data_ptr() == full.data_ptr()
            assert (view.untyped_storage().data_ptr()
                    == full.untyped_storage().data_ptr())
            assert not view.is_contiguous() and prefix_pitch(view) == 8
        np.testing.assert_array_equal(tn.values.numpy(),
                                      np.asarray(jn.values))
        np.testing.assert_array_equal(tn.indices.numpy(),
                                      np.asarray(jn.indices))
        np.testing.assert_array_equal(tv.to_dense().numpy(),
                                      np.asarray(jv.to_dense()))
    # the full tier is the canonical no-view
    assert tpw.replace(tier_ne=8).tier_ne is None
    assert tsp.narrow_tier(tpw) is tpw
    for bad in (0, 9):
        with pytest.raises(ValueError, match="tier_ne"):
            tpw.replace(tier_ne=bad)


def test_reconfigure_k_matches_jax():
    rng = np.random.default_rng(3)
    jcfg, tcfg = jsp.SparsityConfig(8, 16), tsp.SparsityConfig(8, 16)
    w = jsp.random_sparse_dense(rng, 6, 48, jcfg)
    jp = jsp.pack(jnp.asarray(w), jcfg)
    tp = tsp.pack(_t(w), tcfg)
    for k in (1, 2, 4):
        jr, tr = jsp.reconfigure_k(jp, k), tsp.reconfigure_k(tp, k)
        assert tr.cfg == tsp.SparsityConfig(8 // k, 16, k)
        np.testing.assert_array_equal(tr.values.numpy(),
                                      np.asarray(jr.values))
        np.testing.assert_array_equal(tr.indices.numpy(),
                                      np.asarray(jr.indices))
    with pytest.raises(ValueError, match="passes"):
        tsp.reconfigure_k(tp, 3)


# ---------------------------------------------------------------------------
# the kernel wrappers read a prefix in place; dispatch of a tier view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,qdtype", MODES, ids=MODE_IDS)
def test_wrappers_read_a_prefix_view_and_refuse_other_layouts(layout,
                                                              qdtype):
    """On the CPU each wrapper runs its plain version; a prefix view gives
    the contiguous copy's result, and a view that is not a prefix of a
    contiguous tensor (a suffix, a stride) raises before anything runs."""
    spec = _crafted(layout, qdtype, seed=4)
    _, tpw = _pair(spec)
    o, k = tpw.dense_shape
    x = _t(np.random.default_rng(5).standard_normal((3, k)).astype(
        np.float32))
    cfg = tsp.SparsityConfig(5, 16)

    def call(v, i):
        if layout == "xwT":
            if qdtype:
                return demm_xwT_q8(x, v, i, tpw.scales, cfg,
                                   duplicates=False)
            return demm_xwT(x, v, i, cfg, duplicates=False)
        args = (tpw.active_groups, v, i)
        if qdtype:
            return demm_block_spmm_q8(*args, tpw.scales, x.T, cfg, r=o).T
        return demm_block_spmm(*args, x.T, cfg, r=o).T

    view = (tpw.values[..., :5], tpw.indices[..., :5])
    got = call(*view)
    want = call(view[0].contiguous(), view[1].contiguous())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    plain = (demm_xwT_q8_plain(x, *view, tpw.scales, cfg) if layout == "xwT"
             and qdtype else demm_xwT_plain(x, *view, cfg)
             if layout == "xwT" else
             demm_block_spmm_q8_plain(tpw.active_groups, *view, tpw.scales,
                                      x.T, cfg, r=o).T if qdtype else
             demm_block_spmm_plain(tpw.active_groups, *view, x.T, cfg,
                                   r=o).T)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # rows not at the pitch: every other row of a tensor twice as tall
    strided = torch.stack([tpw.indices, tpw.indices], dim=1)[:, 0][..., :5]
    for bad in ((tpw.values[..., 3:], tpw.indices[..., 3:]),   # a suffix
                (tpw.values[..., 1:6], view[1]),               # an offset
                (view[0], strided)):
        with pytest.raises(ValueError, match="prefix view"):
            call(*bad)


@pytest.mark.parametrize("bx", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,qdtype", MODES, ids=MODE_IDS)
def test_ops_on_a_tier_view_match_jax(layout, qdtype, dtype, bx):
    """``ops.demm_matmul_packed`` on a ``tier_ne`` view against the JAX
    package on the same view: its ``ops`` through the Pallas kernels in
    interpret mode for xwT; for the block layout (the JAX registry's block
    variants have no interpret mode) its Pallas kernel in interpret mode on
    ``narrow_tier``'s slices, and its ``ops`` through the plain reference in
    float32.  The port runs backend ``cuda`` (the wrapper's plain version on
    the CPU, on the prefix views) and ``reference``.  Tolerances of
    ``tests/test_torch_kernels.py``: float32 1e-5, bfloat16 2e-2; int8
    scales at the size amax / 127 gives normal weights."""
    from repro.kernels.demm_block_spmm import demm_block_spmm_pallas
    from repro.kernels.demm_q8 import demm_block_spmm_q8_pallas
    spec = _crafted(layout, qdtype, seed=6, scale=1 / 64)
    jpw, tpw = _pair(spec)
    jpw, tpw = jsp.tier_sort_packed(jpw), tsp.tier_sort_packed(tpw)
    k = tpw.in_features
    x = np.random.default_rng(bx).standard_normal((bx, k)).astype(np.float32)
    tol = F32 if dtype == "float32" else BF16
    for t in (2, 5):
        jv, tv = jpw.replace(tier_ne=t), tpw.replace(tier_ne=t)
        jx = jnp.asarray(x, dtype)
        if layout == "xwT":
            want = jops.demm_matmul_packed(jx, jv, backend="pallas_interpret")
        else:
            jn = jsp.narrow_tier(jv)
            args = (jn.active_groups, jn.values, jn.indices)
            if qdtype:
                args += (jn.scales,)
            kern = (demm_block_spmm_q8_pallas if qdtype
                    else demm_block_spmm_pallas)
            want = kern(*args, jx.T, jn.cfg, r=jn.out_features,
                        interpret=True).T
            if dtype == "float32":
                np.testing.assert_allclose(
                    np.asarray(jops.demm_matmul_packed(jx, jv,
                                                       backend="reference")),
                    np.asarray(want), **F32)
        want = np.asarray(want, np.float32)
        tx = _t(x, getattr(torch, dtype))
        for backend in ("cuda", "reference"):
            got = ops.demm_matmul_packed(tx, tv, backend=backend)
            np.testing.assert_allclose(got.float().numpy(), want, **tol)
        # the draft tier differs from the full tier
        full = ops.demm_matmul_packed(tx, tpw, backend="cuda")
        assert not np.allclose(full.float().numpy(), want, **F32)


def test_from_jax_params_carries_tier_ne():
    spec = _crafted("xwT", None, seed=7)
    jtree = {"values": spec["values"], "indices": spec["indices"],
             "cfg": spec["cfg"], "dense_shape": spec["dense_shape"],
             "layout": "xwT", "tier_ne": 3}
    from repro_torch.convert import _linear
    pw = _linear(jtree, "cpu")
    assert pw.tier_ne == 3
    assert _linear({**jtree, "tier_ne": None}, "cpu").tier_ne is None


# ---------------------------------------------------------------------------
# spec.tiers and spec.decode against repro.spec
# ---------------------------------------------------------------------------

def test_parse_tier_matches_jax():
    from repro.spec import parse_tier as jax_parse_tier
    assert parse_tier("8:128") == jax_parse_tier("8:128") == (8, 128)
    for bad in ("8", "0:16", "16:8", "a:b"):
        with pytest.raises(ValueError) as t_err:
            parse_tier(bad)
        with pytest.raises(ValueError) as j_err:
            jax_parse_tier(bad)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError):
        SpecConfig("6:16", gamma=0)


@pytest.fixture(scope="module")
def spec_setup():
    """Reduced stablelm_3b at 8:16, packed and tier-sorted by the JAX
    package; the port's model converted from the same tree."""
    jcfg, tcfg = reduced_pair(sparsity=jsp.SparsityConfig(8, 16, 1))
    tcfg = dataclasses.replace(tcfg, sparsity=tsp.SparsityConfig(8, 16, 1))
    jmodel, params = jax_model_and_params(jcfg)
    packed = jax_tier_sort_tree(jax_pack_tree(params))
    return jcfg, tcfg, jmodel, packed


def _model(setup):
    _, tcfg, _, packed = setup
    return from_jax_params(jax_tree_to_numpy(packed), tcfg, device="cpu")


def _port_report_of(jax_report, layers):
    """The JAX tree stacks its layers: each of its layer nodes is ``layers``
    of the port's; embed, unembed and the final norm are 3 nodes on both
    sides, and every PackedWeight is a layer node."""
    return TierReport(narrowed=layers * jax_report.narrowed,
                      full=layers * jax_report.full,
                      other=3 + layers * (jax_report.other - 3))


@pytest.mark.parametrize("draft", ["4:16", "6:16"])
def test_derive_draft_tier_matches_jax_and_shares_tensors(spec_setup, draft):
    _, tcfg, _, packed = spec_setup
    model = _model(spec_setup)
    _, jrep = jax_derive_draft_tier(packed, draft)
    dmodel, rep = derive_draft_tier(model, draft)
    assert rep == _port_report_of(jrep, tcfg.num_layers)
    assert rep.narrowed >= tcfg.num_layers
    narrowed = 0
    for (name, d), (_, f) in zip(dmodel.named_modules(),
                                 model.named_modules()):
        if isinstance(d, tsp.PackedWeight):
            assert d.values is f.values and d.indices is f.indices
            assert d.values.data_ptr() == f.values.data_ptr()
            if d.tier_ne is not None:
                narrowed += 1
                assert d is not f and f.tier_ne is None
                assert d.tier_ne == parse_tier(draft)[0] and d.cfg == f.cfg
            else:
                assert d is f
        elif not any(isinstance(c, tsp.PackedWeight)
                     for c in d.modules()):
            assert d is f, name        # untouched subtrees are shared
    assert narrowed == rep.narrowed
    assert dmodel.embed is model.embed and dmodel is not model


def test_derive_draft_tier_mixed_tree_and_nothing_to_narrow(spec_setup):
    """A tree whose packed nodes do not all share the draft's M: the JAX
    and the port's counts agree; a draft that narrows nothing raises."""
    _, tcfg, _, packed = spec_setup
    model = _model(spec_setup)
    # the reduced config gives some linears another M than 16 (the group
    # follows the contraction dim), so the tree is mixed
    for draft in ("4:16", "7:16"):
        _, jrep = jax_derive_draft_tier(packed, draft)
        _, rep = derive_draft_tier(model, draft)
        assert rep == _port_report_of(jrep, tcfg.num_layers)
        assert rep.full > 0 and rep.narrowed > 0
    for draft in ("8:16", "4:32"):
        with pytest.raises(ValueError, match="narrows no"):
            derive_draft_tier(model, draft)
        with pytest.raises(ValueError, match="narrows no"):
            jax_derive_draft_tier(packed, draft)


@pytest.mark.parametrize("kinds,refused", [
    (("full",), False), (("paged",), False), (("full", "paged"), False),
    (("ring",), True), (("ssm",), True), (("full", "mlstm"), True),
    ((), True)])
def test_guard_cache_kinds_refuses_what_jax_refuses(kinds, refused):
    from repro.core.sparsity import Static
    tstate = {"pos": 0, "caches": [{"kind": k, "k": None} for k in kinds]}
    jstate = {"pos": 0, "caches": [{"kind": Static(k), "k": None}
                                   for k in kinds]}
    for guard, state in ((guard_cache_kinds, tstate),
                         (jax_guard_cache_kinds, jstate)):
        if refused:
            with pytest.raises(NotImplementedError, match="roll back"):
                guard(state)
        else:
            assert guard(state) == set(kinds)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_make_multistep_equals_single_steps(spec_setup, paged):
    _, tcfg, _, _ = spec_setup
    model = _model(spec_setup)
    from repro_torch.paged import PagedLayout
    layout = PagedLayout(4, 17, 8) if paged else None

    def state():
        st = model.init_decode_state(2, 32, dtype=torch.float32,
                                     device="cpu", paged=layout)
        st["pos"][:] = torch.tensor([3, 5])
        if paged:
            st["caches"]["block_table"][:] = torch.arange(
                1, 17).reshape(2, 8)
            st["caches"]["active"][:] = True
        return st

    tokens = torch.tensor([[1, 2, 3], [4, 5, 6]])
    a = state()
    logits, out = make_multistep(model, POLICY)(a, tokens)
    assert logits.shape == (2, 3, tcfg.padded_vocab)
    b = state()
    for j in range(3):
        step, b = model.decode_step(b, tokens[:, j:j + 1], policy=POLICY)
        np.testing.assert_array_equal(logits[:, j].numpy(),
                                      step[:, 0].numpy())
    assert torch.equal(out["pos"], b["pos"])
    assert torch.equal(out["pos"], torch.tensor([6, 8]))
    for key in ("k", "v"):
        assert torch.equal(a["caches"][key], b["caches"][key])


# ---------------------------------------------------------------------------
# the engines: token identity with the JAX spec engines and non-spec runs
# ---------------------------------------------------------------------------

def _config(paged, jax, **kw):
    kw.setdefault("max_len", 64)
    if paged:
        kw.setdefault("page_size", 4)
        return (JPagedServeConfig if jax else PagedServeConfig)(
            num_slots=2, **kw)
    kw.pop("num_pages", None)
    return (JServeConfig if jax else ServeConfig)(num_slots=2, **kw)


def _submit(engine, vocab, req_cls, n=4, max_new=8, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        prompt = rng.integers(0, vocab, 5 + i % 3, dtype=np.int32)
        engine.submit(req_cls(uid=i, prompt=prompt, max_new_tokens=max_new,
                              priority=i % 2))
    engine.run_until_drained()
    return {r.uid: list(r.output) for r in engine.completed}


def _run_jax(setup, paged, spec=None, n=4, max_new=8, prompt_seed=0,
             **kw):
    jcfg, _, jmodel, packed = setup
    eng = jax_make_engine(jmodel, packed, _config(paged, True, **kw),
                          policy=JPOLICY, metrics=JMetricsRegistry(),
                          spec=None if spec is None else JSpecConfig(*spec))
    return eng, _submit(eng, jcfg.vocab_size, JRequest, n, max_new,
                        prompt_seed)


def _run_port(setup, paged, spec=None, n=4, max_new=8, prompt_seed=0,
              model=None, **kw):
    _, tcfg, _, _ = setup
    eng = make_engine(model or _model(setup), _config(paged, False, **kw),
                      policy=POLICY, device="cpu",
                      metrics=tobs.MetricsRegistry(),
                      spec=None if spec is None else SpecConfig(*spec))
    return eng, _submit(eng, tcfg.vocab_size, Request, n, max_new,
                        prompt_seed)


SAMPLED = dict(temperature=0.8, top_k=8, seed=3)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_streams_equal_jax_and_non_spec(spec_setup, paged, sampled):
    kw = SAMPLED if sampled else {}
    spec = (DRAFT, 3)
    _, jref = _run_jax(spec_setup, paged, spec, **kw)
    model = _model(spec_setup)
    _, base = _run_port(spec_setup, paged, None, model=model, **kw)
    eng, got = _run_port(spec_setup, paged, spec, model=model, **kw)
    assert got == jref == base
    assert len(got) == 4 and all(len(v) == 8 for v in got.values())
    sm = eng._spec_metrics
    assert sm._verify_dispatches > 0
    assert sm._committed_total / sm._verify_dispatches > 1.0


def test_spec_streams_equal_across_engines(spec_setup):
    """Dense non-spec, dense spec, paged spec: one token stream (γ = 4)."""
    model = _model(spec_setup)
    _, ref = _run_port(spec_setup, False, None, model=model)
    _, dense = _run_port(spec_setup, False, (DRAFT, 4), model=model)
    _, paged = _run_port(spec_setup, True, (DRAFT, 4), model=model)
    assert ref == dense == paged


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_gamma_clamp_near_max_len(spec_setup, paged):
    """Windows shrink (and fall back to plain steps) as lanes approach
    max_len; the stream survives the clamp, as the JAX engine's does."""
    model = _model(spec_setup)
    _, ref = _run_port(spec_setup, paged, None, model=model, max_len=20,
                       max_new=16)
    eng, got = _run_port(spec_setup, paged, (DRAFT, 4), model=model,
                         max_len=20, max_new=16)
    _, jgot = _run_jax(spec_setup, paged, (DRAFT, 4), max_len=20,
                       max_new=16)
    assert ref == got == jgot
    assert any(len(v) < 16 for v in got.values())      # max_len ended some


def _counter(registry, name, **labels):
    for c in registry.snapshot(meta=False)["counters"]:
        if c["name"] == name and all(c["labels"].get(k) == v
                                     for k, v in labels.items()):
            return c["value"]
    return 0


@pytest.mark.parametrize("spec", [None, (DRAFT, 3)], ids=["plain", "spec"])
def test_sampled_stream_survives_preemption(spec_setup, spec):
    """A temperature > 0 request preempted mid-generation under page
    pressure resumes with the same tokens, with and without spec."""
    kw = dict(max_len=48, temperature=0.8, top_k=8, seed=5, n=5,
              max_new=10, prompt_seed=5)
    model = _model(spec_setup)
    roomy, ref = _run_port(spec_setup, True, spec, num_pages=64, model=model,
                           **kw)
    assert _counter(roomy.metrics, "serve_preempt_total") == 0
    tight, got = _run_port(spec_setup, True, spec, num_pages=8, model=model,
                           **kw)
    assert _counter(tight.metrics, "serve_preempt_total") > 0
    assert ref == got
    _, jgot = _run_jax(spec_setup, True, spec, num_pages=8, **kw)
    assert got == jgot


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_counters_and_waste_equal_jax(spec_setup, paged):
    spec = (DRAFT, 3)
    jeng, _ = _run_jax(spec_setup, paged, spec, **SAMPLED)
    teng, _ = _run_port(spec_setup, paged, spec, **SAMPLED)
    names = ("spec_draft_tokens_total", "spec_accepted_tokens_total",
             "spec_rejected_tokens_total", "serve_tokens_total")
    for name in names:
        assert (_counter(teng.metrics, name)
                == _counter(jeng.metrics, name)), name
    assert _counter(teng.metrics, "spec_draft_tokens_total") > 0
    for program in ("draft", "verify", "decode", "prefill"):
        assert (_counter(teng.metrics, "serve_step_dispatch_total",
                         program=program)
                == _counter(jeng.metrics, "serve_step_dispatch_total",
                            program=program)), program
    tsm, jsm = teng._spec_metrics, jeng._spec_metrics
    assert (tsm._committed_total, tsm._verify_dispatches) == \
        (jsm._committed_total, jsm._verify_dispatches)
    wasted = _counter(teng.metrics, "serve_wasted_tokens_total",
                      cause="spec_reject")
    assert wasted == sum(r.rejected_draft_tokens for r in teng.completed)
    assert wasted == _counter(jeng.metrics, "serve_wasted_tokens_total",
                              cause="spec_reject")
    trep = slo_report(teng.completed, metrics=teng.metrics)
    jrep = jax_slo_report(jeng.completed, metrics=jeng.metrics)
    assert trep["goodput"]["wasted_tokens"]["spec_reject"] == wasted > 0
    assert trep["goodput"]["wasted_tokens"] == jrep["goodput"][
        "wasted_tokens"]
    assert trep["goodput"]["ratio"] == pytest.approx(
        jrep["goodput"]["ratio"])


def test_engines_refuse_a_spec_that_cannot_roll_back_or_narrow(spec_setup):
    model = _model(spec_setup)
    with pytest.raises(ValueError, match="narrows no"):
        make_engine(model, ServeConfig(num_slots=1, max_len=16),
                    policy=POLICY, device="cpu",
                    metrics=tobs.MetricsRegistry(),
                    spec=SpecConfig("8:16", 2))
    # sorting twice is sorting once: the engine's own sort of an already
    # sorted model is a no-op
    before = [(p.values.clone(), p.indices.clone())
              for p in model.modules() if isinstance(p, tsp.PackedWeight)]
    tier_sort_tree(model)
    after = [(p.values, p.indices) for p in model.modules()
             if isinstance(p, tsp.PackedWeight)]
    for (v0, i0), (v1, i1) in zip(before, after):
        assert torch.equal(v0, v1) and torch.equal(i0, i1)


# ---------------------------------------------------------------------------
# launch.serve --spec-draft
# ---------------------------------------------------------------------------

def _serve(args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *args], capture_output=True, text=True, timeout=600)


def test_launch_serve_spec_draft_requires_packed(spec_setup):
    proc = _serve(["--sparsity", "8:16", "--spec-draft", "6:16"])
    assert proc.returncode == 2
    assert "--spec-draft requires --packed" in proc.stderr
    from repro_torch.launch.serve import run_serve
    with pytest.raises(ValueError, match="requires --packed"):
        run_serve(_model(spec_setup), 10, packed=False, device="cpu",
                  spec_draft="6:16")


def test_launch_serve_spec_draft_serves_and_logs_speculation():
    proc = _serve(["--packed", "--backend", "reference", "--sparsity",
                   "8:16", "--spec-draft", "6:16", "--spec-gamma", "3",
                   "--requests", "3", "--max-new", "6", "--max-len", "48"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout + proc.stderr
    assert "+spec6:16" in out and "speculation" in out
    assert "tokens_per_dispatch" in out
