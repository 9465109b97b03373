"""The port's CUDA kernels on the card (marker ``cuda``).

A CUDA kernel has no interpret mode, so these run only where there is a GPU
and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere the ``card`` fixture skips them with a reason.  Tolerances: float32
rtol/atol 1e-4 (summation order), bfloat16 rtol/atol 2e-2.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.sparsity import SparsityConfig, pack_block, unpack
from repro_torch.kernels.demm_block_spmm import (block_body, demm_block_spmm,
                                                 demm_block_spmm_on,
                                                 demm_block_spmm_plain)
from repro_torch.kernels.demm_q8 import (block_q8_body, demm_block_spmm_q8,
                                         demm_block_spmm_q8_plain,
                                         demm_xwT_q8, demm_xwT_q8_on,
                                         demm_xwT_q8_plain)
from repro_torch.kernels.demm_spmm import (demm_spmm, demm_spmm_on,
                                           demm_spmm_plain, spmm_body)
from repro_torch.kernels.demm_xwT import (demm_xwT, demm_xwT_on,
                                          demm_xwT_plain, xwt_body)
from repro_torch.quant import quantize_packed
from repro_torch.launch.serve import run_serve
from repro_torch.models.families import build_model

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(card, n, m, o, g, bx, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    scores = torch.rand((o, g, m), generator=gen, device=card)
    idx = scores.topk(n, dim=-1).indices.sort(dim=-1).values.to(torch.int32)
    vals = torch.randn((o, g, n), generator=gen, device=card)
    x = torch.randn((bx, g * m), generator=gen, device=card).to(dtype)
    return x, vals.contiguous(), idx.contiguous(), gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,o,g,bx", [(2, 16, 256, 8, 4), (5, 80, 100, 4, 1),
                                        (3, 48, 77, 9, 37), (8, 128, 64, 130, 9)])
def test_kernels_match_plain_versions(card, n, m, o, g, bx, dtype):
    cfg = SparsityConfig(n, m)
    x, vals, idx, gen = _inputs(card, n, m, o, g, bx, dtype, seed=n * m)
    before = demm_xwT.launches
    got = demm_xwT(x, vals, idx, cfg)
    torch.cuda.synchronize()
    assert demm_xwT.launches == before + 1
    torch.testing.assert_close(got, demm_xwT_plain(x, vals, idx, cfg),
                               **TOL[dtype])
    q = torch.randint(-127, 128, vals.shape, generator=gen, device=card,
                      dtype=torch.int32).to(torch.int8)
    for shape in ((o,), (o, g)):
        scales = torch.rand(shape, generator=gen, device=card) * 0.02 + 1e-3
        before = demm_xwT_q8.launches
        got = demm_xwT_q8(x, q, idx, scales, cfg)
        torch.cuda.synchronize()
        assert demm_xwT_q8.launches == before + 1
        torch.testing.assert_close(
            got, demm_xwT_q8_plain(x, q, idx, scales, cfg), **TOL[dtype])


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    cfg = SparsityConfig(2, 16)
    x, vals, idx, _ = _inputs(card, 2, 16, 32, 4, 3, torch.float32, seed=0)
    with pytest.raises(TypeError):
        demm_xwT(x.to(torch.float16), vals, idx, cfg)
    with pytest.raises(ValueError):
        demm_xwT(x, vals.cpu(), idx, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_duplicate_indices_sum_in_the_activation_dtype(card, dtype):
    """Every slot of a group on one column, values not exact in bfloat16:
    the summing instantiation equals the plain version's rounding."""
    n, m, o, g, bx = 5, 80, 96, 8, 4
    cfg = SparsityConfig(n, m)
    x, vals, idx, gen = _inputs(card, n, m, o, g, bx, dtype, seed=3)
    idx = idx[..., :1].expand(o, g, n).contiguous()
    torch.testing.assert_close(demm_xwT(x, vals, idx, cfg),
                               demm_xwT_plain(x, vals, idx, cfg), **TOL[dtype])
    q = torch.randint(-127, 128, vals.shape, generator=gen, device=card,
                      dtype=torch.int32).to(torch.int8)
    scales = torch.rand((o,), generator=gen, device=card) * 0.02 + 1e-3
    torch.testing.assert_close(demm_xwT_q8(x, q, idx, scales, cfg),
                               demm_xwT_q8_plain(x, q, idx, scales, cfg),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,o,g,bx,a_max", [(2, 16, 256, 8, 4, None),
                                              (5, 80, 384, 4, 1, None),
                                              (3, 48, 128, 9, 37, 12)])
def test_block_and_spmm_kernels_match_plain_versions(card, n, m, o, g, bx,
                                                     a_max, dtype):
    cfg = SparsityConfig(n, m)
    x, vals, idx, gen = _inputs(card, n, m, o, g, bx, dtype, seed=n + m)
    dense = unpack(vals, idx, cfg, (o, g * m))
    dense[o // 2:] = 0                               # all-zero row blocks
    pw = pack_block(dense, cfg, a_max=a_max)
    qw = quantize_packed(pw)
    for b in (x.T, x.T.contiguous()):                # serving and (K, Cd)
        before = demm_block_spmm.launches
        got = demm_block_spmm(pw.active_groups, pw.values, pw.indices, b, cfg,
                              r=o, duplicates=pw.has_duplicates)
        torch.cuda.synchronize()
        assert demm_block_spmm.launches == before + 1
        torch.testing.assert_close(
            got, demm_block_spmm_plain(pw.active_groups, pw.values,
                                       pw.indices, b, cfg, r=o), **TOL[dtype])
        before = demm_block_spmm_q8.launches
        got = demm_block_spmm_q8(qw.active_groups, qw.values, qw.indices,
                                 qw.scales, b, cfg, r=o)
        torch.cuda.synchronize()
        assert demm_block_spmm_q8.launches == before + 1
        torch.testing.assert_close(
            got, demm_block_spmm_q8_plain(qw.active_groups, qw.values,
                                          qw.indices, qw.scales, b, cfg, r=o),
            **TOL[dtype])
        before = demm_spmm.launches
        got = demm_spmm(vals, idx, b, cfg)
        torch.cuda.synchronize()
        assert demm_spmm.launches == before + 1
        torch.testing.assert_close(got, demm_spmm_plain(vals, idx, b, cfg),
                                   **TOL[dtype])


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("n,m", [(2, 16), (3, 48), (5, 80)])
@pytest.mark.parametrize("cd", [64, 200, 256, 1024])
def test_spmm_tiled_body_matches_plain_version(card, cd, n, m, duplicates):
    """K5's tensor-core body: a bf16 B of 64 or more columns, R = 100
    (ragged against both tiles), every slot of a group on one column with
    ``duplicates`` (summed in bf16 as they are placed)."""
    o, g = 100, 8
    cfg = SparsityConfig(n, m)
    _, vals, idx, gen = _inputs(card, n, m, o, g, 1, torch.float32,
                                seed=cd + m)
    if duplicates:
        idx = idx[..., :1].expand(o, g, n).contiguous()
    b = torch.randn((g * m, cd), generator=gen, device=card).to(torch.bfloat16)
    assert spmm_body(vals, idx, b, m) == "tiled"
    before = demm_spmm.launches
    got = demm_spmm(vals, idx, b, cfg, duplicates=duplicates)
    torch.cuda.synchronize()
    assert demm_spmm.launches == before + 1
    torch.testing.assert_close(got, demm_spmm_plain(vals, idx, b, cfg),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("tile,groups_per_stage,stages",
                         [((128, 1), 1, 4), ((128, 1), 3, 2), ((128, 2), 2, 2),
                          ((256, 1), 1, 3), ((256, 2), 1, 3)])
def test_spmm_tiled_body_tunables(card, tile, groups_per_stage, stages):
    """Every tile of the tiled body, with 8 groups so that 3 groups per stage
    leave a last stage of fewer groups (its rows past K read as 0)."""
    n, m, o, g, cd = 5, 80, 300, 8, 320
    cfg = SparsityConfig(n, m)
    _, vals, idx, gen = _inputs(card, n, m, o, g, 1, torch.float32, seed=7)
    b = torch.randn((g * m, cd), generator=gen, device=card).to(torch.bfloat16)
    got = demm_spmm(vals, idx, b, cfg, duplicates=False, tile=tile,
                    stages=stages)
    torch.testing.assert_close(got, demm_spmm_plain(vals, idx, b, cfg),
                               **TOL[torch.bfloat16])
    got = demm_spmm_on("tiled", vals, idx, b, cfg, duplicates=False,
                       tile=tile, groups_per_stage=groups_per_stage,
                       stages=stages)
    torch.testing.assert_close(got, demm_spmm_plain(vals, idx, b, cfg),
                               **TOL[torch.bfloat16])


def test_spmm_float32_and_transposed_b_take_the_gather_body(card):
    n, m, o, g, cd = 5, 80, 100, 8, 256
    cfg = SparsityConfig(n, m)
    _, vals, idx, gen = _inputs(card, n, m, o, g, 1, torch.float32, seed=5)
    b32 = torch.randn((g * m, cd), generator=gen, device=card)
    bt = torch.randn((cd, g * m), generator=gen, device=card).to(
        torch.bfloat16).T
    for b in (b32, bt):
        assert spmm_body(vals, idx, b, m) == "gather"
        torch.testing.assert_close(demm_spmm(vals, idx, b, cfg),
                                   demm_spmm_plain(vals, idx, b, cfg),
                                   **TOL[b.dtype])


@pytest.mark.parametrize("case", ["inactive", "a_max > G", "duplicates"])
@pytest.mark.parametrize("bx", [1, 4, 8])
def test_block_q8_cluster_body_matches_plain_version(card, bx, case):
    """K4's cluster body at serving batch: inactive (row block, group) tiles
    (a_max < G) with an all-zero row block, padded list slots (a_max > G),
    duplicate indices (the summing instantiation)."""
    n, m, o, g = 5, 80, 512, 8
    cfg = SparsityConfig(n, m)
    x, vals, idx, gen = _inputs(card, n, m, o, g, bx, torch.bfloat16,
                                seed=bx + len(case))
    dense = unpack(vals, idx, cfg, (o, g * m))
    if case == "inactive":
        dense.reshape(4, 128, g, m)[:, :, 1] = 0     # group 1 inactive everywhere
        dense[128:256] = 0                            # an all-zero row block
        pw = pack_block(dense, cfg)
        assert pw.block_geom[1] < g
    else:
        pw = pack_block(dense, cfg, a_max=g + 3 if case == "a_max > G" else None)
    if case == "duplicates":
        dv = torch.randn(pw.values.shape, generator=gen, device=card)
        pw = pw.replace(values=dv, indices=pw.indices[..., :1].expand(
            pw.indices.shape).contiguous())
        assert pw.has_duplicates
    qw = quantize_packed(pw)
    b = x.T
    assert block_q8_body(qw.values, qw.indices, qw.scales, b, m) == "cluster"
    want = demm_block_spmm_q8_plain(qw.active_groups, qw.values, qw.indices,
                                    qw.scales, b, cfg, r=o)
    for cluster_size in (None, 1, 2, 4, 8):
        got = demm_block_spmm_q8(qw.active_groups, qw.values, qw.indices,
                                 qw.scales, b, cfg, r=o,
                                 duplicates=qw.has_duplicates,
                                 cluster_size=cluster_size)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


# (n, m, O, G): the three projection shapes of full-width stablelm_3b and
# the reduced configuration's 2:16
BODY_SHAPES = [(5, 80, 2560, 32), (5, 80, 6912, 32), (3, 48, 2560, 144),
               (2, 16, 256, 8)]


@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [1, 4, 8])
@pytest.mark.parametrize("n,m,o,g", BODY_SHAPES)
def test_xwt_bulk_body_matches_plain_version(card, n, m, o, g, bx, dtype,
                                             vdtype):
    """K1's bulk row-tile body at serving batch, as the main path launches
    it (no summing search), float32 and bfloat16 values; a float32 x of 8
    rows at K = 6912 leaves room for a ring of one-row chunks only."""
    cfg = SparsityConfig(n, m)
    x, vals, idx, _ = _inputs(card, n, m, o, g, bx, dtype, seed=o + bx)
    vals = vals.to(vdtype)
    assert xwt_body(x, vals, idx, m, duplicates=False) == "bulk"
    before = dict(demm_xwT.body_launches)
    got = demm_xwT(x, vals, idx, cfg, duplicates=False)
    torch.cuda.synchronize()
    assert demm_xwT.body_launches["bulk"] == before["bulk"] + 1
    torch.testing.assert_close(got, demm_xwT_plain(x, vals, idx, cfg),
                               **TOL[dtype])


@pytest.mark.parametrize("kw", [
    dict(chunks=1), dict(chunks=2), dict(chunks=16), dict(rows_per_block=1),
    dict(rows_per_block=7), dict(rows_per_block=160),
    dict(rows_per_block=40, chunks=3)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("n,m,o,g", BODY_SHAPES[:3])
def test_xwt_bulk_body_tunables(card, n, m, o, g, kw):
    """Every tunable of the bulk body: chunk counts (several barriers),
    one-row and ragged tiles, a tile larger than shared memory (a ring of
    chunks)."""
    cfg = SparsityConfig(n, m)
    x, vals, idx, _ = _inputs(card, n, m, o, g, 4, torch.bfloat16, seed=g)
    got = demm_xwT_on("bulk", x, vals, idx, cfg, duplicates=False, **kw)
    torch.testing.assert_close(got, demm_xwT_plain(x, vals, idx, cfg),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [1, 4, 8])
def test_xwt_bulk_body_sums_duplicates(card, bx, dtype):
    """Every slot of a group on one column, standard-normal values (their
    bfloat16 sums round) and an all-padded row: the bulk body's summing
    instantiation equals the plain version's rounding."""
    n, m, o, g = 5, 80, 300, 8
    cfg = SparsityConfig(n, m)
    x, vals, idx, _ = _inputs(card, n, m, o, g, bx, dtype, seed=bx)
    idx = idx[..., :1].expand(o, g, n).contiguous()
    vals[0] = 0
    idx[0] = 0
    assert xwt_body(x, vals, idx, m) == "bulk"
    want = demm_xwT_plain(x, vals, idx, cfg)
    for kw in ({}, dict(chunks=4), dict(rows_per_block=7)):
        torch.testing.assert_close(demm_xwT_on("bulk", x, vals, idx, cfg, **kw),
                                   want, **TOL[dtype])


def _q8_inputs(card, n, m, o, g, bx, dtype, per_group, duplicates, seed):
    """int8 values and float32 scales (O,) or (O, G); with ``duplicates``
    every slot of a group on one column (their int8 sums round to bfloat16
    above 256) and row 0 all padded."""
    x, _, idx, gen = _inputs(card, n, m, o, g, bx, dtype, seed)
    q = torch.randint(-127, 128, (o, g, n), generator=gen, device=card,
                      dtype=torch.int32).to(torch.int8)
    if duplicates:
        idx = idx[..., :1].expand(o, g, n).contiguous()
        q[0] = 0
        idx[0] = 0
    shape = (o, g) if per_group else (o,)
    scales = torch.rand(shape, generator=gen, device=card) * 0.02 + 0.001
    return x, q, idx, scales


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [1, 4, 8])
@pytest.mark.parametrize("n,m,o,g", BODY_SHAPES)
def test_xwt_q8_bulk_body_matches_plain_version(card, n, m, o, g, bx, dtype,
                                                per_group, duplicates):
    """K3 on the bulk row-tile body at serving batch, per-row scales (a
    register per row pass) and per-group scales (staged in shared memory),
    as the main path launches it and with the summing instantiation."""
    cfg = SparsityConfig(n, m)
    x, q, idx, scales = _q8_inputs(card, n, m, o, g, bx, dtype, per_group,
                                   duplicates, seed=o + bx)
    assert xwt_body(x, q, idx, m, duplicates=duplicates,
                    scales=scales) == "bulk"
    before = dict(demm_xwT_q8.body_launches)
    got = demm_xwT_q8(x, q, idx, scales, cfg, duplicates=duplicates)
    torch.cuda.synchronize()
    assert demm_xwT_q8.body_launches["bulk"] == before["bulk"] + 1
    torch.testing.assert_close(got, demm_xwT_q8_plain(x, q, idx, scales, cfg),
                               **TOL[dtype])


@pytest.mark.parametrize("kw", [
    dict(chunks=1), dict(chunks=2), dict(chunks=16), dict(rows_per_block=1),
    dict(rows_per_block=7), dict(rows_per_block=160),
    dict(rows_per_block=40, chunks=3), dict(rows_per_block=3000),
    dict(lanes=8), dict(lanes=16), dict(rows_per_block=7, lanes=8),
    dict(rows_per_block=160, chunks=2, lanes=16)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("n,m,o,g", BODY_SHAPES[:3])
def test_xwt_q8_bulk_body_tunables(card, n, m, o, g, per_group, kw):
    """K3's bulk-body tunables with both scale units: chunk counts (several
    barriers, each with its scales), one-row and ragged tiles, a tile
    larger than shared memory (a ring of chunks), every slot-lane count."""
    cfg = SparsityConfig(n, m)
    x, q, idx, scales = _q8_inputs(card, n, m, o, g, 4, torch.bfloat16,
                                   per_group, False, seed=g)
    got = demm_xwT_q8_on("bulk", x, q, idx, scales, cfg, duplicates=False,
                         **kw)
    torch.testing.assert_close(got, demm_xwT_q8_plain(x, q, idx, scales, cfg),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bx", [9, 37])
def test_xwt_q8_wide_batch_takes_the_gather_body(card, bx, per_group):
    """Beyond serving batch K3 keeps the gather body, and says so."""
    n, m, o, g = 5, 80, 2560, 32
    cfg = SparsityConfig(n, m)
    x, q, idx, scales = _q8_inputs(card, n, m, o, g, bx, torch.bfloat16,
                                   per_group, False, seed=bx)
    assert xwt_body(x, q, idx, m, duplicates=False, scales=scales) == "gather"
    before = dict(demm_xwT_q8.body_launches)
    got = demm_xwT_q8(x, q, idx, scales, cfg, duplicates=False)
    torch.cuda.synchronize()
    assert demm_xwT_q8.body_launches == {**before,
                                         "gather": before["gather"] + 1}
    torch.testing.assert_close(got, demm_xwT_q8_plain(x, q, idx, scales, cfg),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["dense", "inactive", "a_max > G",
                                  "duplicates"])
@pytest.mark.parametrize("bx", [1, 4, 8])
@pytest.mark.parametrize("n,m,o,g", BODY_SHAPES)
def test_block_cluster_body_matches_plain_version(card, n, m, o, g, bx, case,
                                                  vdtype):
    """K2 on K4's cluster body at serving batch, float32 and bfloat16 values:
    every group active; inactive (row block, group) tiles with an all-zero
    row block; padded list slots (a_max > G); duplicate indices with
    standard-normal values (the summing instantiation); every cluster size
    at Bx = 4."""
    cfg = SparsityConfig(n, m)
    x, vals, idx, gen = _inputs(card, n, m, o, g, bx, torch.bfloat16,
                                seed=o + g + bx)
    dense = unpack(vals, idx, cfg, (o, g * m))
    if case == "inactive":
        dense.reshape(o // 128, 128, g, m)[:, :, 1] = 0   # group 1 nowhere
        dense[128:256] = 0                                # an all-zero block
        pw = pack_block(dense, cfg)
        assert pw.block_geom[1] < g
    else:
        pw = pack_block(dense, cfg, a_max=g + 3 if case == "a_max > G"
                        else None)
    if case == "duplicates":
        dv = torch.randn(pw.values.shape, generator=gen, device=card)
        dv[0, :, 0] = 0
        pw = pw.replace(values=dv, indices=pw.indices[..., :1].expand(
            pw.indices.shape).contiguous())
        assert pw.has_duplicates
    pw = pw.replace(values=pw.values.to(vdtype).contiguous())
    args = (pw.active_groups, pw.values, pw.indices)
    b = x.T
    assert block_body(*args, b, m) == "cluster"
    want = demm_block_spmm_plain(*args, b, cfg, r=o)
    for cluster_size in (None, 1, 2, 4, 8) if bx == 4 else (None,):
        before = dict(demm_block_spmm.body_launches)
        got = demm_block_spmm(*args, b, cfg, r=o,
                              duplicates=pw.has_duplicates,
                              cluster_size=cluster_size)
        torch.cuda.synchronize()
        assert (demm_block_spmm.body_launches["cluster"]
                == before["cluster"] + 1)
        torch.testing.assert_close(got, want, **TOL[torch.bfloat16])
    got = demm_block_spmm_on("gather", *args, b, cfg, r=o,
                             duplicates=pw.has_duplicates)
    torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


def test_narrow_spmm_stays_on_the_gather_body(card):
    """K5 at Cd = 4 runs K2's launcher with the identity address stream:
    the gather body, never K2's cluster body, whose counts stay put."""
    n, m, o, g = 5, 80, 2560, 32
    cfg = SparsityConfig(n, m)
    x, vals, idx, _ = _inputs(card, n, m, o, g, 4, torch.bfloat16, seed=11)
    before = dict(demm_block_spmm.body_launches)
    assert spmm_body(vals, idx, x.T, m) == "gather"
    assert block_body(None, vals, idx, x.T, m) == "gather"
    torch.testing.assert_close(demm_spmm(vals, idx, x.T, cfg),
                               demm_spmm_plain(vals, idx, x.T, cfg),
                               **TOL[torch.bfloat16])
    assert demm_block_spmm.body_launches == before


@pytest.mark.parametrize("layout", ["xwT", "block"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_reduced_serving_cuda_equals_reference(card, quantize, layout):
    cfg = dataclasses.replace(get_arch("stablelm_3b").reduced(),
                              compute_dtype="float32")
    outs = {}
    for backend in ("cuda", "reference"):
        model = build_model(cfg, device=card, seed=0)
        eng = run_serve(model, cfg.vocab_size, packed=True, layout=layout,
                        quantize=quantize, backend=backend, requests=3,
                        slots=2, max_new=5, max_len=32, seed=0, device=card)
        outs[backend] = {r.uid: r.output for r in eng.completed}
        assert np.isfinite(eng.last_logits[:, :cfg.vocab_size]).all()
    assert outs["cuda"] == outs["reference"]


# ---------------------------------------------------------------------------
# the captured decode step (a CUDA engine replays one CUDA graph per tick)
# ---------------------------------------------------------------------------

def _graph_model(card, *, layout, quantize, dtype):
    from repro_torch.launch.pack_tree import pack_tree

    cfg = dataclasses.replace(get_arch("stablelm_3b").reduced(),
                              compute_dtype=dtype)
    model = pack_tree(build_model(cfg, device=card, seed=0), layout=layout,
                      quantize=quantize)
    return model, cfg


def _collect(model, cfg, *, backend, eager=False, slots=2, max_len=32,
             temperature=0.0, top_k=0, prompts=None, max_new=5):
    """Serve ``prompts`` (default: three random ones) and keep every tick's
    logits; returns (engine, [logits per tick], {uid: tokens})."""
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    eng = ServeEngine(model, ServeConfig(num_slots=slots, max_len=max_len,
                                         temperature=temperature,
                                         top_k=top_k, seed=0),
                      policy=ExecPolicy(mode="packed", backend=backend),
                      device="cuda", metrics=obs.MetricsRegistry(),
                      _eager=eager)
    if prompts is None:
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, rng.integers(3, 7),
                                dtype=np.int32) for _ in range(3)]
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    logits = []
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        logits.append(eng.last_logits.copy())
    return eng, logits, {r.uid: list(r.output) for r in eng.completed}


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.8, top_k=8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_graph_step_equals_eager_step_and_reference(card, layout, quantize,
                                                    dtype, sampling):
    """The captured step gives the eager step's logits bit for bit on every
    tick and its tokens; in float32 compute also backend ``reference``'s
    tokens (bfloat16 rounds differently in the plain versions)."""
    model, cfg = _graph_model(card, layout=layout, quantize=quantize,
                              dtype=dtype)
    eng, lg, tg = _collect(model, cfg, backend="cuda", **sampling)
    _, le, te = _collect(model, cfg, backend="cuda", eager=True, **sampling)
    _, le2, _ = _collect(model, cfg, backend="cuda", eager=True, **sampling)
    assert eng._graph is not None and eng._use_graph
    assert all(np.array_equal(a, b) for a, b in zip(le, le2)), \
        "the eager step is not deterministic"
    assert len(lg) == len(le)
    for t, (a, b) in enumerate(zip(lg, le)):
        assert np.array_equal(a, b), (t, np.abs(a - b).max())
    assert tg == te and len(tg) == 3
    if dtype == "float32":
        _, lr, tr = _collect(model, cfg, backend="reference", **sampling)
        assert tg == tr
        for a, b in zip(lg, lr):
            np.testing.assert_allclose(a[:, :cfg.vocab_size],
                                       b[:, :cfg.vocab_size], rtol=1e-3,
                                       atol=1e-3)


def test_graph_slot_reuse_decodes_as_a_fresh_engine(card):
    model, cfg = _graph_model(card, layout="xwT", quantize=None,
                              dtype="bfloat16")
    rng = np.random.default_rng(5)
    p1, p2 = (rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
              for n in (7, 4))
    eng, _, out = _collect(model, cfg, backend="cuda", slots=1,
                           prompts=[p1, p2], max_new=6)
    _, _, fresh = _collect(model, cfg, backend="cuda", slots=1,
                           prompts=[p2], max_new=6)
    assert out[1] == fresh[0]
    assert eng.completed[1].output == fresh[0]


def test_graph_pos_advances_by_one_per_replay(card):
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.kernels.demm_xwT import demm_xwT
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    model, cfg = _graph_model(card, layout="xwT", quantize=None,
                              dtype="bfloat16")
    eng = ServeEngine(model, ServeConfig(num_slots=3, max_len=32),
                      policy=ExecPolicy(mode="packed", backend="cuda"),
                      device="cuda", metrics=obs.MetricsRegistry())
    pos = eng.state["pos"]
    eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32) + 5,
                       max_new_tokens=20))
    eng.step()                                   # capture + first replay
    graph = eng._graph
    assert pos.tolist() == [1, 1, 1]            # idle slots advance too
    launches = demm_xwT.launches
    for t in range(2, 8):
        eng.step()
        assert eng._graph is graph and eng.state["pos"] is pos
        assert pos.tolist() == [t, t, t]
    assert demm_xwT.launches == launches        # replays never call a wrapper
    eng.submit(Request(uid=1, prompt=np.arange(3, dtype=np.int32),
                       max_new_tokens=2))
    eng.step()                                   # claims slot 1 (reset to 0)
    assert pos.tolist() == [8, 1, 8]


def test_capture_restores_the_initial_state_and_failures_raise(card):
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    model, cfg = _graph_model(card, layout="block", quantize=None,
                              dtype="bfloat16")

    def engine():
        return ServeEngine(model, ServeConfig(num_slots=2, max_len=16),
                           policy=ExecPolicy(mode="packed", backend="cuda"),
                           device="cuda", metrics=obs.MetricsRegistry())

    eng = engine()
    with torch.inference_mode():
        eng._capture(warmup=2)
    fresh = model.init_decode_state(2, 16, dtype=torch.float32, device=card)
    for name in ("k", "v"):
        assert torch.equal(eng.state["caches"][name], fresh["caches"][name])
    assert torch.equal(eng.state["pos"], fresh["pos"])
    # a step that cannot be captured raises; nothing runs it eagerly instead
    eng = engine()
    decode = model.decode_step

    def unsafe(state, tokens, **kw):
        torch.cuda.synchronize()                 # not allowed in a capture
        return decode(state, tokens, **kw)

    model.decode_step = unsafe
    try:
        eng.submit(Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                           max_new_tokens=2))
        with pytest.raises(RuntimeError):
            eng.step()
        assert eng._graph is None and eng.completed == []
    finally:
        del model.decode_step


# ---------------------------------------------------------------------------
# the paged engine: the decode step and the prefill chunk, each captured once
# ---------------------------------------------------------------------------

def _paged_collect(model, cfg, *, backend, eager=False, slots=2, max_len=64,
                   num_pages=None, prompts=None, max_new=5, **sampling):
    """Serve ``prompts`` (default: three random ones of 5 to 40 tokens) on
    the paged engine, chunks of 16; returns (engine, [(program, uid,
    position, logits row)] for every row the sampler reads, in call order,
    {uid: tokens}).  Program ``"prefill"`` is a request's last chunk.  The
    rows of masked lanes are not kept: they may read the null page, whose
    content is not deterministic."""
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import Request

    eng = PagedServeEngine(
        model, PagedServeConfig(num_slots=slots, max_len=max_len,
                                page_size=8, num_pages=num_pages,
                                prefill_chunk=16, seed=0, **sampling),
        policy=ExecPolicy(mode="packed", backend=backend), device="cuda",
        metrics=obs.MetricsRegistry(), _eager=eager)
    seen, program = [], ["decode"]
    finish, sample = eng._finish_prefill, eng.sampler.sample

    def in_prefill(*args):
        program[0] = "prefill"
        try:
            return finish(*args)
        finally:
            program[0] = "decode"

    def record(logits, uid, pos):
        seen.append((program[0], uid, pos, np.array(logits, copy=True)))
        return sample(logits, uid, pos)

    eng._finish_prefill = in_prefill
    eng.sampler = types.SimpleNamespace(sample=record)  # (a frozen dataclass)
    if prompts is None:
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, rng.integers(5, 41),
                                dtype=np.int32) for _ in range(3)]
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    eng.run_until_drained()
    del eng._finish_prefill                  # no reference cycle left
    return eng, seen, {r.uid: list(r.output) for r in eng.completed}


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.8, top_k=8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_paged_graphs_equal_eager_and_reference(card, layout, quantize,
                                                dtype, sampling):
    """Each program is captured once; the captured programs give the eager
    programs' logits bit for bit (the prefill chunk's and the decode
    step's) and their tokens; in float32 compute also backend
    ``reference``'s tokens and the dense engine's."""
    model, cfg = _graph_model(card, layout=layout, quantize=quantize,
                              dtype=dtype)
    eng, lg, tg = _paged_collect(model, cfg, backend="cuda", **sampling)
    _, le, te = _paged_collect(model, cfg, backend="cuda", eager=True,
                               **sampling)
    assert eng.captures == eng.prefill.captures == 1
    assert eng.prefill.dispatches > 3            # several chunks replayed
    assert [e[:3] for e in lg] == [e[:3] for e in le]
    assert {e[0] for e in lg} == {"prefill", "decode"}
    for (kind, uid, pos, a), (*_, b) in zip(lg, le):
        assert np.array_equal(a, b), (kind, uid, pos, np.abs(a - b).max())
    assert tg == te and len(tg) == 3
    if dtype == "float32":
        _, _, tr = _paged_collect(model, cfg, backend="reference",
                                  **sampling)
        assert tg == tr
        prompts = [eng.completed[i].prompt for i in
                   np.argsort([r.uid for r in eng.completed])]
        _, _, dense = _collect(model, cfg, backend="cuda", max_len=64,
                               prompts=prompts, **sampling)
        assert dense == tg


def test_paged_preemption_on_the_card_keeps_the_tokens(card):
    model, cfg = _graph_model(card, layout="xwT", quantize=None,
                              dtype="float32")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (30, 21, 38, 12)]
    _, _, want = _paged_collect(model, cfg, backend="cuda", slots=4,
                                prompts=prompts, max_new=8)
    eng, _, got = _paged_collect(model, cfg, backend="cuda", slots=4,
                                 num_pages=14, prompts=prompts, max_new=8)
    assert eng.metrics.counter("serve_preempt_total").value >= 1
    assert got == want
    assert eng.captures == eng.prefill.captures == 1


@pytest.mark.parametrize("layout", ["xwT", "block"])
def test_paged_wrappers_count_warmup_and_capture_on_their_bodies(card,
                                                                 layout):
    """The wrappers count the warm-up and the capture of each program only,
    whatever the prompts: 7 x layers x 2 for the chunk (x of 16 rows: the
    gather body) and 7 x layers x 2 for the step (the serving body)."""
    from repro_torch.kernels.demm_block_spmm import demm_block_spmm
    from repro_torch.kernels.demm_xwT import demm_xwT

    model, cfg = _graph_model(card, layout=layout, quantize=None,
                              dtype="bfloat16")
    kern = demm_xwT if layout == "xwT" else demm_block_spmm
    serving = "bulk" if layout == "xwT" else "cluster"
    per = 7 * cfg.num_layers * 2
    for lengths in ((4, 9), (40, 33, 17)):
        before = kern.launches
        by_body = dict(kern.body_launches)
        rng = np.random.default_rng(len(lengths))
        prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
                   for n in lengths]
        eng, _, _ = _paged_collect(model, cfg, backend="cuda",
                                   prompts=prompts)
        assert kern.launches - before == 2 * per
        assert kern.body_launches["gather"] - by_body["gather"] == per
        assert kern.body_launches[serving] - by_body[serving] == per
        assert eng.prefill.dispatches == sum(-(-n // 16) for n in lengths)


def test_paged_captures_restore_the_state_and_failures_raise(card):
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import Request

    model, cfg = _graph_model(card, layout="xwT", quantize=None,
                              dtype="bfloat16")

    def engine():
        return PagedServeEngine(
            model, PagedServeConfig(num_slots=2, max_len=32, page_size=8,
                                    prefill_chunk=16),
            policy=ExecPolicy(mode="packed", backend="cuda"), device="cuda",
            metrics=obs.MetricsRegistry())

    eng = engine()
    eng.submit(Request(uid=0, prompt=np.arange(20, dtype=np.int32),
                       max_new_tokens=3))
    with torch.inference_mode():
        eng._admit()
        eng._sync_control()
        # the first chunk: warm-up + capture, the state restored, then one
        # replay: the positions advance by one chunk, not two
        eng.prefill.step(eng.state, eng._work[0], 0, 0)
        torch.cuda.synchronize()
        assert eng.prefill.captures == 1
        assert eng.state["pos"].tolist() == [16, 0]
    # a program that cannot be captured raises; nothing runs it eagerly
    eng = engine()
    chunk = model.prefill_chunk

    def unsafe(*a, **kw):
        torch.cuda.synchronize()                 # not allowed in a capture
        return chunk(*a, **kw)

    model.prefill_chunk = unsafe
    try:
        eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=2))
        with pytest.raises(RuntimeError):
            eng.step()
        assert eng.prefill._graph is None and eng.completed == []
    finally:
        del model.prefill_chunk


def test_capture_holds_the_garbage_collector_off(card):
    """An engine that dies in a reference cycle is freed by a collection; a
    collection during a capture that frees it (its pinned staging buffers,
    its graphs) makes CUDA calls a capture forbids and loses the capture.
    ``capture_graph`` collects first and holds the collector off while it
    captures: here the dead engine becomes garbage inside the capture, among
    enough allocations to start collections."""
    import gc
    from repro_torch.serve.serve_loop import capture_graph

    model, cfg = _graph_model(card, layout="xwT", quantize=None,
                              dtype="bfloat16")
    dead, _, _ = _paged_collect(model, cfg, backend="cuda")
    dead.itself = dead                       # freed only by a collection
    holder = [dead]
    del dead
    x = torch.zeros(4, device=card)

    def fn():
        holder.clear()
        junk = [[] for _ in range(50000)]    # noqa: F841 (allocations)
        return x + 1

    threshold = gc.get_threshold()
    gc.set_threshold(100, 1, 1)
    try:
        graph, out = capture_graph(fn, [x], card, warmup=0)
    finally:
        gc.set_threshold(*threshold)
    graph.replay()
    torch.cuda.synchronize()
    assert out.tolist() == [1.0] * 4 and gc.isenabled()


# ---------------------------------------------------------------------------
# the autotuner and backend="auto" on the card (repro_torch.tune)
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_cache(tmp_path):
    from repro_torch import tune
    cache = tune.TuneCache(str(tmp_path / "tune_cache_torch.json"))
    tune.set_default_cache(cache)
    yield cache
    tune.set_default_cache(None)


@pytest.mark.parametrize("op", ["xwT", "xwT_q8", "xwT_block",
                                "xwT_block_q8"])
@pytest.mark.parametrize("bx", [4, 32])
def test_auto_never_resolves_to_the_plain_version_on_the_card(card,
                                                              tune_cache,
                                                              op, bx):
    """A CUDA tensor under ``auto`` runs the kernel (heuristic and tuned
    alike), equal to backend ``cuda``; a ``reference`` entry for its problem
    raises before anything runs."""
    from repro_torch import obs, tune
    from repro_torch.core.sparsity import PackedWeight, pack, prune
    from repro_torch.kernels import ops

    cfg = SparsityConfig(5, 80)
    w = prune(torch.randn(256, 640, device=card), cfg)
    pk = pack(w, cfg)
    pw = (pack_block(w, cfg) if "block" in op else
          PackedWeight(pk.values, pk.indices, cfg=cfg, dense_shape=(256, 640)))
    if op.endswith("_q8"):
        pw = quantize_packed(pw)
    x = torch.randn(bx, 640, device=card).to(torch.bfloat16)
    reg, prev = obs.MetricsRegistry(), obs.default_registry()
    obs.set_default_registry(reg)
    try:
        heuristic = ops.demm_matmul_packed(x, pw, backend="auto")
        tune.autotune_packed_tree(torch.nn.ModuleList([pw]), bx,
                                  torch.bfloat16, persist=False,
                                  max_measure=3, iters=2)
        tuned = ops.demm_matmul_packed(x, pw, backend="auto")
    finally:
        obs.set_default_registry(prev)
    want = ops.demm_matmul_packed(x, pw, backend="cuda")
    torch.testing.assert_close(heuristic, want, rtol=0, atol=0)
    torch.testing.assert_close(tuned, want, **TOL[torch.bfloat16])
    backends = {c["labels"]["backend"] for c in reg.snapshot(
        meta=False)["counters"] if c["name"] == "kernel_dispatch_total"}
    assert backends == {"cuda"}
    p = (tune.Problem.for_xwT_block(x.shape, pw, x.dtype, card)
         if "block" in op else
         tune.Problem.for_xwT(x.shape, (256, 640), cfg, x.dtype, card,
                              quantized=op.endswith("_q8")))
    tune_cache.put(p, tune.TunedConfig("reference", {}, 1.0, "tuned"))
    with pytest.raises(RuntimeError, match="does not dispatch on 'cuda'"):
        ops.demm_matmul_packed(x, pw, backend="auto")


@pytest.mark.parametrize("op", ["xwT", "xwT_q8", "spmm"])
@pytest.mark.parametrize("rows", [4, 32, 256])
def test_tuned_is_no_slower_than_the_default(card, tune_cache, op, rows):
    from repro_torch import tune
    from repro_torch.core.sparsity import PackedWeight, pack, prune

    cfg = SparsityConfig(5, 80)
    pk = pack(prune(torch.randn(2560, 2560, device=card), cfg), cfg)
    x = torch.randn(rows, 2560, device=card).to(torch.bfloat16)
    if op == "spmm":
        res = tune.autotune_spmm(pk.values, pk.indices, x.T.contiguous(),
                                 cfg, (2560, 2560), duplicates=False,
                                 persist=False, max_measure=4, iters=3)
    elif op == "xwT_q8":
        q = quantize_packed(PackedWeight(pk.values, pk.indices, cfg=cfg,
                                         dense_shape=(2560, 2560)))
        res = tune.autotune_xwT_q8(x, q.values, q.indices, q.scales, cfg,
                                   (2560, 2560), duplicates=False,
                                   persist=False, max_measure=4, iters=3)
    else:
        res = tune.autotune_xwT(x, pk.values, pk.indices, cfg, (2560, 2560),
                                duplicates=False, persist=False,
                                max_measure=4, iters=3)
    assert res.best.backend == "cuda"
    assert res.best.measured_us <= res.default.measured_s * 1e6
    kept = [c for c in res.candidates if not c.status.startswith("pruned")]
    assert kept and all(c.status in ("measured", "refused") for c in kept)
    # device time of a launch, not the ~30-50 us of issuing one
    assert res.best.measured_us < 200


@pytest.mark.parametrize("op,rows", [
    ("xwT", 4), ("xwT", 32), ("xwT_q8", 4), ("xwT_q8", 32), ("xwT_block", 4),
    ("xwT_block", 32), ("xwT_block_q8", 4), ("xwT_block_q8", 32), ("spmm", 4),
    ("spmm", 256)])
@pytest.mark.parametrize("o,k,n,m", [(2560, 2560, 5, 80), (2560, 6912, 3, 48)])
def test_smem_bytes_is_what_every_launcher_asks_for(card, op, rows, o, k, n,
                                                    m):
    """Every candidate of the grid at two full-width stablelm_3b shapes,
    launched once through the registered ``cuda`` variant: its launcher asks
    for the dynamic shared memory ``tune.smem_bytes`` counts, and a
    candidate counted over the budget is refused before it launches."""
    from repro_torch import tune
    from repro_torch.core.sparsity import PackedWeight, pack, prune
    from repro_torch.kernels._build import last_launch_smem
    from repro_torch.kernels.demm_xwT import LaunchRefused

    cfg = SparsityConfig(n, m)
    w = prune(torch.randn(o, k, device=card), cfg)
    x = torch.randn(rows, k, device=card).to(torch.bfloat16)
    quant = op.endswith("_q8")
    if op == "spmm":
        pk = pack(w, cfg)
        p = tune.Problem.for_spmm((o, k), (k, rows), cfg, x.dtype, card,
                                  value_bytes=pk.values.element_size())
        args = (pk.values, pk.indices, x.T.contiguous())
    elif op.startswith("xwT_block"):
        pw = pack_block(w, cfg)
        pw = quantize_packed(pw) if quant else pw
        p = tune.Problem.for_xwT_block(x.shape, pw, x.dtype, card)
        args = (x, pw.values, pw.indices, pw.active_groups)
        args += (pw.scales,) if quant else ()
    else:
        pk = pack(w, cfg)
        pw = PackedWeight(pk.values, pk.indices, cfg=cfg, dense_shape=(o, k))
        pw = quantize_packed(pw) if quant else pw
        p = tune.Problem.for_xwT(x.shape, (o, k), cfg, x.dtype, card,
                                 quantized=quant,
                                 value_bytes=pw.values.element_size())
        args = (x, pw.values, pw.indices) + ((pw.scales,) if quant else ())
    v = tune.get_variant(op, "cuda")
    launched = refused = 0
    for c in tune.enumerate_candidates(p, include_measure_only=False):
        if tune.geometry_refusal(p, c.backend, c.params) is not None:
            continue
        counted = tune.smem_bytes(p, "cuda", c.params)
        if counted > tune.DEFAULT_SMEM_BUDGET:
            with pytest.raises(LaunchRefused):
                v.call(*args, cfg, (o, k), duplicates=False, **c.params)
            refused += 1
            continue
        v.call(*args, cfg, (o, k), duplicates=False, **c.params)
        assert last_launch_smem() == counted, (c.params, counted)
        launched += 1
    torch.cuda.synchronize()
    assert launched > 0


def test_a_refused_candidate_is_refused_and_launching_goes_on(card,
                                                              tune_cache,
                                                              monkeypatch):
    """A rows_per_block the block gather body's launcher refuses (300 does
    not divide its 256 threads), let past the pruner: the candidate is
    ``refused`` (nothing was launched) and the process launches on."""
    from repro_torch import tune
    from repro_torch.core.sparsity import prune
    from repro_torch.tune import autotune as tat
    from repro_torch.tune import registry as treg

    monkeypatch.setattr(tat, "geometry_refusal", lambda *a, **kw: None)
    monkeypatch.setattr(treg, "BLOCK_GATHER_ROWS", (8, 300))
    cfg = SparsityConfig(5, 80)
    pw = pack_block(prune(torch.randn(256, 640, device=card), cfg), cfg)
    x = torch.randn(32, 640, device=card).to(torch.bfloat16)
    res = tune.autotune_xwT_block(x, pw, persist=False, iters=2)
    status = {c.params.get("rows_per_block"): c.status
              for c in res.candidates}
    assert status[300] == "refused" and status[8] == "measured"
    assert res.best.params.get("rows_per_block") != 300
    got = demm_block_spmm(pw.active_groups, pw.values, pw.indices, x.T, cfg,
                          r=256, duplicates=False)
    torch.testing.assert_close(
        got, demm_block_spmm_plain(pw.active_groups, pw.values, pw.indices,
                                   x.T, cfg, r=256), **TOL[torch.bfloat16])


def test_no_measurement_happens_during_a_capture(card, tune_cache,
                                                 monkeypatch):
    """An engine built with ``autotune=True`` measures in its constructor
    only, never while a capture is open; its captured step under ``auto``
    gives backend ``cuda``'s tokens and ``reference``'s (float32)."""
    from repro_torch.tune import autotune as tat

    real, seen = tat.measure, []

    def watched(calls, **kw):
        seen.append(torch.cuda.is_current_stream_capturing())
        return real(calls, **kw)

    monkeypatch.setattr(tat, "measure", watched)
    model, cfg = _graph_model(card, layout="xwT", quantize="int8",
                              dtype="float32")
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(model, ServeConfig(num_slots=2, max_len=32),
                      policy=ExecPolicy(mode="packed", backend="auto"),
                      device="cuda", metrics=obs.MetricsRegistry(),
                      autotune=True)
    built = len(seen)
    assert built > 0 and not any(seen)
    del eng
    eng, _, auto = _collect(model, cfg, backend="auto")
    assert eng._graph is not None and len(seen) == built
    _, _, cuda = _collect(model, cfg, backend="cuda")
    _, _, ref = _collect(model, cfg, backend="reference")
    assert auto == cuda == ref
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            tat._check_not_capturing()
