"""The port's dry-run census (``repro_torch.launch.census``) against the JAX
package's loop-exact HLO analysis (``repro.launch.hlo_analysis``).

* ``tests/test_hlo_analysis.py``'s cases as census cases: a loop of five
  (f32[8,16] @ f32[16,16], then an all-reduce on a census context), the
  seven-step ``tanh(c @ w)`` loop, ``unknown_trip_loops`` always 0.
* The matmul-family FLOPs of reduced ``stablelm_3b``'s one-rank prefill,
  dense decode step and train step (and reduced ``olmoe_1b_7b``'s prefill)
  against the reference's ``dot_flops_by_name`` total of the same step,
  lowered and compiled by ``jax.jit`` on one CPU device with no mesh:
  within 2 % (prefill, decode) and 5 % (the train step).
* A packed matmul alone: 2 x Bx x O x G x Ne FLOPs, its stream's bytes,
  one op, none of its plain version's.
* The sequence-sharded decode combine in one process: a float32 cache cut
  into dp = 2 and 4 position blocks (windowed too, and a ring's slots),
  the partials merged, equal to whole-cache ``decode_attention`` at 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.sparse_linear import ExecPolicy as JExecPolicy
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro.models.families import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train.train_loop import make_train_step as jmake_train_step

from _torch_port import family_pair
from repro_torch.core.sparse_linear import ExecPolicy
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import ops
from repro_torch.launch import census
from repro_torch.launch import specs as tspecs
from repro_torch.models import attention as tattn
from repro_torch.sharding.context import CensusMesh, make_context

# the matmul-FLOP tolerances against the reference's compiled program
FWD_REL, TRAIN_REL = 0.02, 0.05


# ---------------------------------------------------------------------------
# tests/test_hlo_analysis.py's cases
# ---------------------------------------------------------------------------

def _loop_of_five():
    mesh = CensusMesh((1, 4), ("data", "model"))
    ctx = make_context(mesh)
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")

    def body(x, w):
        for _ in range(5):
            x = ctx.all_reduce(x @ w)
        return x

    return census.run(body, x, w, mesh=mesh)


def test_loop_weighting_counts_every_trip():
    _, a, _ = _loop_of_five()
    # dot flops = 2*8*16*16 = 4096, executed 5 times
    assert a.flops == 5 * 4096
    assert a.matmul_flops == 5 * 4096
    assert a.unknown_trip_loops == 0


def test_all_reduce_ring_weighting():
    _, a, _ = _loop_of_five()
    # AR payload 8*16*4 bytes, 2x ring weighting, 5 iterations
    assert a.collectives["all-reduce"]["count"] == 5
    assert a.collectives["all-reduce"]["bytes"] == 5 * 2 * 8 * 16 * 4
    assert a.to_dict()["collectives"]["total_bytes"] == 5 * 2 * 8 * 16 * 4
    assert set(a.to_dict()) == {"flops", "bytes_accessed", "collectives",
                                "unknown_trip_loops"}


def test_tanh_loop_counts_exactly():
    def f(w, x):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x.sum()

    _, a, _ = census.run(f, torch.empty(64, 64, device="meta"),
                         torch.empty(32, 64, device="meta"))
    assert a.matmul_flops == 7 * 2 * 32 * 64 * 64
    # the elementwise estimate: tanh's results and the sum's
    assert a.flops == 7 * 2 * 32 * 64 * 64 + 7 * 32 * 64 + 1
    assert a.unknown_trip_loops == 0
    # the argument bytes, then one (32, 64) product and its tanh at a time
    assert a.argument_bytes == (64 * 64 + 32 * 64) * 4
    assert a.peak_live_bytes >= 2 * 32 * 64 * 4


def test_views_count_nothing_and_fills_their_result():
    def f(x):
        y = x.view(4, 16).t()[1:3]
        return torch.zeros(8, 8, device="meta") + y.sum()

    _, a, _ = census.run(f, torch.empty(64, device="meta"))
    by_op = a.bytes_by_opcode
    assert "view" not in by_op and "t" not in by_op and "slice" not in by_op
    assert by_op["zeros"] == 8 * 8 * 4
    assert by_op["sum"] == 2 * 4 * 4 + 4      # the (2, 4) slice read, 0-d out


# ---------------------------------------------------------------------------
# a packed matmul alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_packed_matmul_counts_the_demm_products_once(quantize):
    from repro_torch.launch.pack_tree import pack_tree_shapes
    from repro_torch.core.sparse_linear import SparseLinear

    cfg = SparsityConfig(2, 16, 1)
    o, k, bx = 48, 64, 5
    root = torch.nn.Module()
    root.lin = SparseLinear(torch.empty(o, k, device="meta"), sparsity=cfg)
    pack_tree_shapes(root, quantize=quantize)
    pw = root.lin
    x = torch.empty(bx, k, device="meta", dtype=torch.bfloat16)
    y, a, _ = census.run(ops.demm_matmul_packed, x, pw)
    g, ne = k // 16, cfg.n_effective
    assert y.shape == (bx, o) and y.dtype == torch.float32
    assert a.flops == 2 * bx * o * g * ne
    assert a.dot_flops_by_name == {
        f"demm/{'xwT_q8' if quantize else 'xwT'}": 2 * bx * o * g * ne}
    stream = o * g * ne * ((1 if quantize else 4) + 4) + (o * 4 if quantize
                                                          else 0)
    assert a.bytes_accessed == stream + bx * k * 2 + bx * o * 4
    assert a.ops == 1 and list(a.bytes_by_opcode) == [
        f"demm/{'xwT_q8' if quantize else 'xwT'}"]
    assert a.packed_launches == {"xwT_q8" if quantize else "xwT": 1}
    assert ops.MATMUL_OBSERVER is None


# ---------------------------------------------------------------------------
# the sequence-sharded decode combine, in one process
# ---------------------------------------------------------------------------

def _stacked_reduce(t, op):
    """The reduction over the blocks of partials stacked on dim 0."""
    r = t.amax(0, keepdim=True) if op is not None else t.sum(0, keepdim=True)
    return r.expand_as(t).clone()


def _combine(parts):
    m, l, o = (torch.stack(t) for t in zip(*parts))
    return tattn.combine_partials(m, l, o, _stacked_reduce)[0]


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("window", [-1, 24])
def test_seq_sharded_combine_equals_whole_cache(dp, window):
    rng = np.random.default_rng(dp * 100 + window)
    b, s, hq, hkv, dh = 3, 64, 4, 2, 16
    q, k, v = (torch.tensor(rng.standard_normal(sh), dtype=torch.float32)
               for sh in ((b, 1, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    cache_len = torch.tensor([5, 40, 64])
    want = tattn.decode_attention(q, k, v, cache_len, window=window)
    n = s // dp
    got = _combine([tattn.decode_attention_partial(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], cache_len,
        window=window, first=r * n) for r in range(dp)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_seq_sharded_combine_over_a_windowed_ring(dp):
    """A ring of W slots holding positions 70..101 out of order (slot_pos),
    cut into dp blocks of slots: the same output as the dense cache of
    those positions under the window."""
    rng = np.random.default_rng(dp)
    b, w, hq, hkv, dh, p_now = 2, 32, 4, 4, 8, 101
    q = torch.tensor(rng.standard_normal((b, 1, hq, dh)), dtype=torch.float32)
    dense_k = torch.tensor(rng.standard_normal((b, p_now + 1, hkv, dh)),
                           dtype=torch.float32)
    dense_v = torch.tensor(rng.standard_normal((b, p_now + 1, hkv, dh)),
                           dtype=torch.float32)
    slot_pos = torch.arange(p_now - w + 1, p_now + 1)
    slot_of = slot_pos % w                      # where each position sits
    ring_k = torch.empty(b, w, hkv, dh)
    ring_v = torch.empty(b, w, hkv, dh)
    ring_k[:, slot_of] = dense_k[:, slot_pos]
    ring_v[:, slot_of] = dense_v[:, slot_pos]
    held = torch.empty(w, dtype=torch.int64)
    held[slot_of] = slot_pos
    held = held[None].expand(b, w)
    cache_len = torch.full((b,), p_now + 1)
    want = tattn.decode_attention(q, dense_k, dense_v, cache_len, window=w)
    n = w // dp
    got = _combine([tattn.decode_attention_partial(
        q, ring_k[:, r * n:(r + 1) * n], ring_v[:, r * n:(r + 1) * n],
        cache_len, window=w, positions=held[:, r * n:(r + 1) * n])
        for r in range(dp)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# matmul FLOPs against the reference's compiled program
# ---------------------------------------------------------------------------

def _reference_dot_flops(fn, *args) -> float:
    compiled = jax.jit(fn).lower(*args).compile()
    return sum(hlo_analysis.analyze(compiled.as_text())
               .dot_flops_by_name.values())


def _rel(a, b):
    return abs(a - b) / b


@pytest.fixture(scope="module")
def stablelm():
    jcfg, tcfg = family_pair("stablelm_3b")
    return jcfg, tcfg, jbuild_model(jcfg)


PREFILL = JShapeConfig("p", 64, 2, "prefill")


@pytest.mark.parametrize("arch", ["stablelm_3b", "olmoe_1b_7b"])
def test_prefill_matmul_flops_match_the_reference(arch):
    jcfg, tcfg = family_pair(arch)
    jmodel = jbuild_model(jcfg)
    pshapes = jspecs.param_shapes(jmodel)
    batch = jspecs.prefill_batch_specs(jcfg, PREFILL)
    want = _reference_dot_flops(
        lambda p, b: jmodel.prefill(p, b, policy=JExecPolicy(
            mode="masked"))[0], pshapes, batch)
    model = tspecs.meta_model(tcfg)
    tbatch = tspecs.prefill_batch_specs(tcfg, PREFILL)

    def step(batch):
        with torch.no_grad():
            return model.prefill(batch, max_len=1,
                                 policy=ExecPolicy(mode="masked"))[0]

    _, a, _ = census.run(step, tbatch)
    assert _rel(a.matmul_flops, want) <= FWD_REL, (a.matmul_flops, want,
                                                   a.dot_flops_by_name)


def test_decode_matmul_flops_match_the_reference(stablelm):
    jcfg, tcfg, jmodel = stablelm
    shape = JShapeConfig("d", 48, 3, "decode")
    pshapes = jspecs.param_shapes(jmodel)
    state = jax.eval_shape(lambda: jmodel.init_decode_state(3, 48))
    tok = jspecs.decode_token_specs(shape)
    want = _reference_dot_flops(
        lambda p, s, t: jmodel.decode_step(p, s, t, policy=JExecPolicy(
            mode="dense")), pshapes, state, tok)
    model = tspecs.meta_model(tcfg)
    tstate = model.init_decode_state(3, 48, device="meta")

    def step(state, tokens):
        with torch.no_grad():
            return model.decode_step(state, tokens,
                                     policy=ExecPolicy(mode="dense"))

    _, a, _ = census.run(step, tstate, tspecs.decode_token_specs(shape))
    assert _rel(a.matmul_flops, want) <= FWD_REL, (a.matmul_flops, want,
                                                   a.dot_flops_by_name)


def test_train_step_matmul_flops_match_the_reference(stablelm):
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step, train_params

    jcfg, tcfg, jmodel = stablelm
    shape = JShapeConfig("t", 32, 4, "train")
    pshapes = jspecs.param_shapes(jmodel)
    opt_cfg = jadamw.AdamWConfig()
    ostate = jax.eval_shape(lambda p: jadamw.init(opt_cfg, p), pshapes)
    batch = jspecs.train_batch_specs(jcfg, shape)
    jstep = jmake_train_step(jmodel, opt_cfg, num_microbatches=2,
                             policy=JExecPolicy(mode="masked"))
    want = _reference_dot_flops(
        jstep, pshapes, ostate, batch,
        jax.ShapeDtypeStruct((), jnp.int32))
    model = tspecs.meta_model(tcfg)
    step = make_train_step(model, adamw.AdamWConfig(), num_microbatches=2,
                           policy=ExecPolicy(mode="masked"))
    params = train_params(model)
    opt = adamw.init(adamw.AdamWConfig(), params)._replace(
        step=torch.zeros((), dtype=torch.int32))
    _, a, _ = census.run(step, params, opt,
                         tspecs.train_batch_specs(tcfg, shape), 0)
    assert _rel(a.matmul_flops, want) <= TRAIN_REL, (a.matmul_flops, want,
                                                     a.dot_flops_by_name)
