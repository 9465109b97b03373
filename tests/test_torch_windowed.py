"""Port vs JAX package: the windowed decoders (``swa``: h2o_danube_1_8b;
``local_global``: gemma3_1b) and whole-sequence prefill.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port, on the CPU; weights reach the port through
``repro_torch.convert.from_jax_params``.  Models are reduced, float32
compute, with a short window so that the rings wrap: h2o with ``window`` 8;
gemma3 with ``local_global_ratio`` 1, 3 layers and ``local_window`` 8, which
gives one local, one global and one tail layer.

Tolerances: attention alone rtol/atol 1e-5 (float32, one softmax in another
summation order); logits and caches through the layers 1e-4 (as
``test_torch_decoder``); ring positions, token streams and refusals exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.base import get_arch as jax_get_arch
from repro.launch.serve import run_serve as jax_run_serve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.paged import PagedServeConfig as JPagedServeConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import make_engine as jax_make_engine
from repro.spec import SpecConfig as JSpecConfig

from _torch_port import jax_model_and_params, to_torch_model
from repro_torch import obs as tobs
from repro_torch.configs.base import get_arch
from repro_torch.launch.pack_tree import pack_tree
from repro_torch.launch.serve import run_serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.paged import PagedServeConfig
from repro_torch.serve import ServeConfig, make_engine
from repro_torch.spec import SpecConfig

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {
    "h2o_danube_1_8b": dict(window=8),
    "gemma3_1b": dict(local_global_ratio=1, num_layers=3, local_window=8),
}


def _pair(arch):
    over = {"compute_dtype": "float32", **ARCHS[arch]}
    return (dataclasses.replace(jax_get_arch(arch).reduced(), **over),
            dataclasses.replace(get_arch(arch).reduced(), **over))


@pytest.fixture(scope="module", params=list(ARCHS))
def windowed(request):
    jcfg, tcfg = _pair(request.param)
    jmodel, params = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, params


def _flat(tree, path=()):
    """{path: numpy array} of a decode state's tensors / arrays (the kind
    tags dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k != "kind":
                out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: tree.numpy()}
    return {path: np.asarray(tree)}


def _assert_states_equal(tstate, jstate):
    t, j = _flat(tstate), _flat(jstate)
    assert t.keys() == j.keys()
    for path in j:
        assert t[path].shape == j[path].shape, path
        if np.issubdtype(j[path].dtype, np.integer):
            np.testing.assert_array_equal(t[path], j[path], err_msg=str(path))
        else:
            np.testing.assert_allclose(t[path], j[path], err_msg=str(path),
                                       **TOL)


# ---------------------------------------------------------------------------
# flash_attention: the chunked online softmax
# ---------------------------------------------------------------------------

# (T, S, causal, window, static_window, q_chunk, kv_chunk, q_offset)
FLASH = {
    "causal": (37, 37, True, -1, None, 16, 8, 0),
    "causal_one_chunk": (37, 37, True, -1, None, 512, 1024, 0),
    "window": (37, 37, True, 5, None, 16, 8, 0),
    "banded_8_4": (37, 37, True, -1, 6, 8, 4, 0),
    "banded_16_8": (40, 40, True, -1, 6, 16, 8, 0),
    "banded_5_3": (29, 29, True, -1, 7, 5, 3, 0),
    "banded_wide": (33, 33, True, -1, 64, 8, 4, 0),
    "cross": (11, 23, False, -1, None, 4, 8, 0),
    "ragged": (13, 21, True, -1, None, 4, 8, 8),
    "offset": (7, 40, True, -1, None, 4, 16, 13),
    "offset_banded": (9, 50, True, -1, 6, 4, 8, 30),
}


@pytest.mark.parametrize("offset_tensor", [False, True])
@pytest.mark.parametrize("case", list(FLASH))
def test_flash_attention_matches(case, offset_tensor):
    t, s, causal, window, static, qc, kvc, off = FLASH[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((2, t, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, static_window=static,
              q_chunk=qc, kv_chunk=kvc)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_offset=off, **kw)
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.tensor([off]) if offset_tensor else off, **kw)
    assert tuple(got.shape) == (2, t, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_apply_attention_matches(windowed):
    """Whole-sequence self-attention with a static window and
    cross-attention through ``kv_x``, on a converted attention block."""
    jcfg, tcfg, _, params = windowed
    tmodel = to_torch_model(params, tcfg)
    jblk = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    kw = dict(num_heads=jcfg.num_heads, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.resolved_head_dim, rope_theta=jcfg.rope_theta,
              q_chunk=8, kv_chunk=4)
    for extra, tx in ((dict(window=5, static_window=5), None),
                      (dict(causal=False, window=-1), enc)):
        want = jattn.apply_attention(
            jblk, jnp.asarray(x),
            kv_x=None if tx is None else jnp.asarray(tx), **kw, **extra)
        with torch.inference_mode():
            got = tattn.apply_attention(
                tmodel.layers[0].attn, torch.from_numpy(x),
                kv_x=None if tx is None else torch.from_numpy(tx), **kw,
                **extra)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# ring buffers
# ---------------------------------------------------------------------------

def test_ring_decode_attention_and_slot_positions():
    """21 steps against a ring of W = 8, three sequences at different
    positions: the output, the ring and ``slot_pos`` equal the reference's
    on every step (the slots wrap twice)."""
    jcfg, tcfg = _pair("h2o_danube_1_8b")
    _, params = jax_model_and_params(jcfg)
    tmodel = to_torch_model(params, tcfg)
    jblk = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    b, w = 3, 8
    hkv, dh = jcfg.num_kv_heads, jcfg.resolved_head_dim
    jcache = jtf.init_ring_cache(b, w, hkv, dh, dtype=jnp.float32)
    tcache = ttf.init_ring_cache(b, w, hkv, dh, device="cpu",
                                 dtype=torch.float32)
    rng = np.random.default_rng(7)
    start = np.array([0, 3, 5])
    for step in range(21):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        pos = start + step
        jout, jcache = jtf.ring_decode_attention(
            jblk, jnp.asarray(x), jcache, jnp.asarray(pos, jnp.int32),
            cfg=jcfg, window=w, policy=None)
        with torch.inference_mode():
            tout, tcache = ttf.ring_decode_attention(
                tmodel.layers[0].attn, torch.from_numpy(x), tcache,
                torch.from_numpy(pos), cfg=tcfg, window=w, policy=None)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        _assert_states_equal(tcache, jcache)
    np.testing.assert_array_equal(
        tcache["slot_pos"].numpy(),
        np.array([[16, 17, 18, 19, 20, 13, 14, 15],
                  [16, 17, 18, 19, 20, 21, 22, 23],
                  [24, 25, 18, 19, 20, 21, 22, 23]]))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_layer_windows_match(arch):
    for base in (False, True):
        jcfg, tcfg = _pair(arch)
        if base:
            jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
        want = [int(w) for w in np.asarray(jtf.layer_windows(jcfg))]
        got = [2 ** 30 if w == ttf.FULL_WINDOW else w
               for w in ttf.layer_windows(tcfg)]
        assert got == want


# ---------------------------------------------------------------------------
# the model: decode through the wrap, whole-sequence prefill
# ---------------------------------------------------------------------------

def test_decode_step_matches_through_the_wrap(windowed):
    """21 decode steps (the rings of 8 wrap twice; gemma3's global layer
    attends to all 21 positions): logits on every step, and the whole
    decode state leaf by leaf on every step."""
    jcfg, tcfg, jmodel, params = windowed
    tmodel = to_torch_model(params, tcfg)
    b, max_len = 3, 24
    jstate = jmodel.init_decode_state(b, max_len, dtype=jnp.float32)
    tstate = tmodel.init_decode_state(b, max_len, dtype=torch.float32)
    _assert_states_equal(tstate, jstate)
    step = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(0)
    for _ in range(21):
        toks = rng.integers(0, jcfg.vocab_size, (b, 1))
        jlogits, jstate = step(params, jstate, jnp.asarray(toks, jnp.int32))
        with torch.inference_mode():
            tlogits, tstate = tmodel.decode_step(tstate,
                                                 torch.from_numpy(toks))
        assert tuple(tlogits.shape) == (b, 1, tcfg.padded_vocab)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        _assert_states_equal(tstate, jstate)
    assert tstate["caches"]["kind"] == jstate["caches"]["kind"].value


@pytest.mark.parametrize("mode", ["masked", "packed"])
def test_prefill_matches(windowed, mode):
    """``prefill``'s last logits equal the reference's, a prompt of 37
    tokens (longer than the window: the band mask matters), and its fresh
    decode state is the reference's."""
    from repro.core.sparse_linear import ExecPolicy as JPolicy
    from repro.launch.pack_tree import pack_tree as jax_pack_tree
    from repro_torch.core.sparse_linear import ExecPolicy

    jcfg, tcfg, jmodel, params = windowed
    tmodel = to_torch_model(params, tcfg)
    jparams = params
    if mode == "packed":
        jparams, tmodel = jax_pack_tree(params), pack_tree(tmodel)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 37))
    jlogits, jstate = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=48,
        policy=JPolicy(mode=mode))
    with torch.inference_mode():
        tlogits, tstate = tmodel.prefill({"tokens": torch.from_numpy(toks)},
                                         max_len=48,
                                         policy=ExecPolicy(mode=mode))
    assert tuple(tlogits.shape) == (2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_states_equal(tstate, jstate)


def test_prefill_equals_decoding_the_prompt(windowed):
    """The whole-sequence path and the ring decode path agree in the port:
    prefill's last logits are the last decode step's over the same tokens."""
    _, tcfg, _, params = windowed
    tmodel = to_torch_model(params, tcfg)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 19))
    with torch.inference_mode():
        want, _ = tmodel.prefill({"tokens": torch.from_numpy(toks)})
        state = tmodel.init_decode_state(2, 20, dtype=torch.float32)
        for t in range(toks.shape[1]):
            got, state = tmodel.decode_step(
                state, torch.from_numpy(toks[:, t:t + 1]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_from_jax_params_carries_the_windowed_trees(windowed):
    """The windowed configs' parameter tree is the dense decoder's (only
    ``cfg`` differs): every leaf arrives in the port unchanged."""
    jcfg, tcfg, _, params = windowed
    _, stable = jax_model_and_params(
        dataclasses.replace(jax_get_arch("stablelm_3b").reduced(),
                            compute_dtype="float32"))
    assert (jax.tree_util.tree_structure(params["layers"]) ==
            jax.tree_util.tree_structure(stable["layers"]))
    tmodel = to_torch_model(params, tcfg)
    assert tmodel.cfg == tcfg and len(tmodel.layers) == jcfg.num_layers
    np.testing.assert_array_equal(tmodel.embed.table.numpy(),
                                  np.asarray(params["embed"]["table"]))
    np.testing.assert_array_equal(tmodel.unembed.table.numpy(),
                                  np.asarray(params["unembed"]["table"]))
    tree = params["layers"]
    for i, blk in enumerate(tmodel.layers):
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("gate", "up", "down"))):
            for name in names:
                np.testing.assert_array_equal(
                    getattr(getattr(blk, grp), name).w.numpy(),
                    np.asarray(tree[grp][name]["w"][i]))
        for ln in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                getattr(blk, ln).scale.numpy(),
                np.asarray(tree[ln]["scale"][i]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

RUN = dict(requests=5, slots=2, max_new=6, max_len=32, seed=3)
MODES = {
    "packed": dict(),
    "packed_int8": dict(quantize="int8"),
    "packed_block": dict(layout="block"),
    "packed_block_int8": dict(layout="block", quantize="int8"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_token_streams_identical(windowed, mode):
    """The reference's ``run_serve`` and the port's, backend ``reference``:
    5 prompts of 4-11 tokens on 2 slots, 6 new tokens each (positions up to
    17: the rings of 8 wrap, and a claimed slot's ring is reset)."""
    jcfg, tcfg, jmodel, params = windowed
    jprev, tprev = jobs.default_registry(), tobs.default_registry()
    jobs.set_default_registry(jobs.MetricsRegistry())
    tobs.set_default_registry(tobs.MetricsRegistry())
    try:
        jeng = jax_run_serve(jmodel, params, jcfg.vocab_size,
                             backend="reference", packed=True, **RUN,
                             **MODES[mode])
        teng = run_serve(to_torch_model(params, tcfg), tcfg.vocab_size,
                         backend="reference", device="cpu", packed=True,
                         **RUN, **MODES[mode])
    finally:
        jobs.set_default_registry(jprev)
        tobs.set_default_registry(tprev)
    want = {r.uid: list(r.output) for r in jeng.completed}
    got = {r.uid: list(r.output) for r in teng.completed}
    assert len(got) == RUN["requests"]
    assert all(len(out) == RUN["max_new"] for out in got.values())
    assert got == want


def test_slot_reset_and_written_tensors_follow_the_state_tree(windowed):
    """A claimed slot's region of every state tensor is reset (``slot_pos``
    to -1) and the capture's restore list is every tensor of the state."""
    _, tcfg, _, params = windowed
    eng = make_engine(to_torch_model(params, tcfg),
                      ServeConfig(num_slots=2, max_len=16), device="cpu",
                      metrics=tobs.MetricsRegistry())
    flat = _flat(eng.state)
    assert len(eng._written()) == len(flat)
    assert any(path[-1] == "slot_pos" for path in flat)
    for t in eng._written():
        t.fill_(5)
    with torch.inference_mode():
        eng._reset_slot(1)
    fresh = _flat(eng.model.init_decode_state(2, 16, dtype=torch.float32))
    for path, arr in _flat(eng.state).items():
        # the slot axis: (..., B) pos, (..., B, W) slot_pos, (..., B, S or
        # W, Hkv, Dh) caches
        ax = {"pos": 0, "slot_pos": arr.ndim - 2}.get(path[-1], arr.ndim - 4)
        np.testing.assert_array_equal(np.take(arr, 1, axis=ax),
                                      np.take(fresh[path], 1, axis=ax))
        assert (np.take(arr, 0, axis=ax) == 5).all()


def test_paged_and_spec_refuse_windowed_configs(windowed):
    """Paging and speculation refuse a windowed config, in the port as in
    the reference: ring buffers are not paged, and a ring cannot roll back
    a rejected draft write."""
    jcfg, tcfg, jmodel, params = windowed
    tmodel = to_torch_model(params, tcfg)
    with pytest.raises(NotImplementedError):
        jax_make_engine(jmodel, params, JPagedServeConfig(num_slots=1,
                                                          max_len=16))
    with pytest.raises(NotImplementedError):
        make_engine(tmodel, PagedServeConfig(num_slots=1, max_len=16),
                    device="cpu")
    from repro.paged import PagedLayout as JPagedLayout
    from repro_torch.paged import PagedLayout
    with pytest.raises(NotImplementedError):
        jmodel.init_decode_state(1, 16, paged=JPagedLayout.for_serve(
            16, page_size=8, num_slots=1))
    with pytest.raises(NotImplementedError):
        tmodel.init_decode_state(1, 16, paged=PagedLayout.for_serve(
            16, page_size=8, num_slots=1))
    from repro.launch.pack_tree import pack_tree as jax_pack_tree
    with pytest.raises(NotImplementedError):
        jax_make_engine(jmodel, jax_pack_tree(params),
                        JServeConfig(num_slots=1, max_len=16),
                        spec=JSpecConfig("1:16", 2))
    with pytest.raises(NotImplementedError):
        make_engine(pack_tree(tmodel), ServeConfig(num_slots=1, max_len=16),
                    device="cpu", spec=SpecConfig("1:16", 2))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cli_serves_the_windowed_archs_on_the_cpu(arch, tmp_path):
    """``launch.serve --arch ARCH --packed`` (reduced, on the CPU when asked
    for): every request completes."""
    import json
    from repro_torch.launch.serve import main
    out = tmp_path / "m.json"
    prev = tobs.default_registry()
    tobs.set_default_registry(tobs.MetricsRegistry())
    try:
        main(["--arch", arch, "--device", "cpu", "--backend", "reference",
              "--packed", "--layout", "block", "--requests", "3",
              "--max-new", "4", "--metrics-out", str(out)])
    finally:
        tobs.set_default_registry(prev)
    counters = {c["name"]: c["value"]
                for c in json.loads(out.read_text())["counters"]}
    assert counters["serve_requests_completed_total"] == 3
    assert counters["serve_tokens_total"] == 12


# ---------------------------------------------------------------------------
# layer norm (defined by the reference, called by no model of it)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    init = jlayers.init_layernorm(48)
    norm = tlayers.init_layernorm(48, device="cpu")
    for name in ("scale", "bias"):
        np.testing.assert_array_equal(getattr(norm, name).numpy(),
                                      np.asarray(init[name]))
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    norm.scale.data.copy_(torch.from_numpy(scale))
    norm.bias.data.copy_(torch.from_numpy(bias))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jlayers.apply_layernorm(jp, jx).astype(jnp.float32))
    got = tlayers.apply_layernorm(norm, tx)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               **(TOL if dtype == "float32"
                                  else dict(rtol=1e-2, atol=1e-2)))
