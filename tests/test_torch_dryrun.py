"""The port's dry run (``repro_torch.launch.dryrun``) and what it needs,
against the JAX package's.

* ``SHAPES`` and ``applicable_shapes`` for all ten archs; ``_model_flops``
  for every arch x shape.
* ``pack_tree_shapes``: every leaf's shape and dtype equal to the
  reference's (``jax.eval_shape`` of its ``pack_tree``) for each reduced
  arch, in ``xwT``, ``xwT`` + int8 and ``block`` at a given ``a_max``.
* ``cache_spec`` and ``batch_spec(seq_shard=True)`` on an abstract mesh
  (``jax.sharding.AbstractMesh``, no devices) of (16, 16) and (2, 16, 16)
  against the port's census mesh of the same shape.
* ``decode_state_specs``: equal to the reference's (``launch/dryrun.py``)
  on those meshes for every arch at ``decode_32k`` and, where it applies,
  ``long_500k`` (full widths; shapes only).
* The CLI: one packed decode cell in a process of its own prints one record
  with the reference's keys and H100 roofs, with no ``jax`` loaded; a
  ``--multi-pod`` cell gives an ``error`` record naming the ``pod``
  refusal; ``benchmarks/torch_roofline.py`` and ``benchmarks/torch_run.py``
  read a written JSONL.

Spec entries are compared with a one-name tuple read as the name, as
``PartitionSpec`` means it.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro.launch.pack_tree import pack_tree_shapes as jpack_tree_shapes
from repro.models.families import build_model as jbuild_model
from repro.sharding import partitioning as jpart

from _torch_port import STACKED_KEYS, family_pair
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch.pack_tree import pack_tree_shapes
from repro_torch.launch.specs import meta_model
from repro_torch.sharding import partitioning as tpart
from repro_torch.sharding.context import CensusMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RECORD_KEYS = {"arch", "shape", "arch_override", "num_microbatches", "mesh",
               "kind", "packed", "census_s", "memory_analysis",
               "cost_analysis", "collectives", "roofline", "roof",
               "model_flops", "useful_flops_ratio"}


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` (512 host
    devices) when imported: jax is initialised first, so that the flag
    changes nothing here, and the variable is restored for subprocesses."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jd


def _norm(spec):
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


# ---------------------------------------------------------------------------
# shapes and model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_shapes_and_applicable_shapes_match_jax(arch):
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert {k: tuple(vars(v).values()) for k, v in tbase.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jbase.SHAPES.items()}
    assert tbase.applicable_shapes(tbase.get_arch(arch)) == \
        jbase.applicable_shapes(jbase.get_arch(arch))


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_model_flops_match_jax(arch, jdryrun):
    for name in tbase.SHAPES:
        assert dryrun._model_flops(tbase.get_arch(arch),
                                   tbase.SHAPES[name]) == \
            jdryrun._model_flops(jbase.get_arch(arch), jbase.SHAPES[name])
    assert dryrun._n_chips(False) == jdryrun._n_chips(False)
    assert dryrun._n_chips(True) == jdryrun._n_chips(True)


# ---------------------------------------------------------------------------
# pack_tree_shapes
# ---------------------------------------------------------------------------

def _expand(keys, shape, start=0):
    """{port name: shape} of a reference leaf at path ``keys``: each
    stacked axis split into ``<key>.<i>``."""
    for j in range(start, len(keys) - 1):
        if keys[j] in STACKED_KEYS:
            out = {}
            for i in range(shape[0]):
                out.update(_expand(keys[:j + 1] + [str(i)] + keys[j + 1:],
                                   shape[1:], j + 2))
            return out
    return {".".join(keys): tuple(shape)}


def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        for name, shape in _expand([str(k) for k in keys],
                                   leaf.shape).items():
            out[name] = (shape, str(leaf.dtype))
    return out


def _torch_leaves(model) -> dict:
    return {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for n, t in list(model.named_parameters())
            + list(model.named_buffers())
            if not n.rsplit(".", 1)[-1].startswith("_")}


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_pack_tree_shapes_match_jax(arch):
    jcfg, tcfg = family_pair(arch)
    jmodel = jbuild_model(jcfg)
    pshapes = jspecs.param_shapes(jmodel)
    for kw in ({"layout": "xwT"}, {"layout": "xwT", "quantize": "int8"},
               {"layout": "block", "a_max": 3}):
        want = _jax_leaves(jpack_tree_shapes(jmodel, pshapes, **kw))
        got = _torch_leaves(pack_tree_shapes(meta_model(tcfg), **kw))
        assert got == want, (kw, set(got) ^ set(want))


def test_pack_tree_shapes_refuses_an_open_block_a_max_and_a_real_model():
    _, tcfg = family_pair("stablelm_3b")
    with pytest.raises(ValueError, match="a_max"):
        pack_tree_shapes(meta_model(tcfg), "block")
    from repro_torch.models.families import build_model
    with pytest.raises(ValueError, match="meta device"):
        pack_tree_shapes(build_model(tcfg, device="cpu", seed=0))


# ---------------------------------------------------------------------------
# cache_spec, batch_spec, decode_state_specs on abstract meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_batch_specs_match_jax(mesh):
    shape, names = MESHES[mesh]
    jm, tm = AbstractMesh(shape, names), CensusMesh(shape, names)
    for heads in (False, True):
        for seq in (False, True):
            assert _norm(tpart.cache_spec(tm, 5, shard_heads=heads,
                                          seq_shard=seq)) == \
                _norm(jpart.cache_spec(jm, 5, shard_heads=heads,
                                       seq_shard=seq)), (heads, seq)
    for seq in (False, True):
        assert _norm(tpart.batch_spec(tm, 3, seq_axis=1, seq_shard=seq)) == \
            _norm(jpart.batch_spec(jm, 3, seq_axis=1, seq_shard=seq))
    assert tpart.batch_axes(tm) == jpart.batch_axes(jm)


def _cells():
    for arch in tbase.ARCH_IDS:
        for shape in tbase.applicable_shapes(tbase.get_arch(arch)):
            if tbase.SHAPES[shape].kind == "decode":
                yield arch, shape


@pytest.mark.parametrize("arch,shape", list(_cells()))
def test_decode_state_specs_match_jax(arch, shape, jdryrun):
    jcfg, tcfg = jbase.get_arch(arch), tbase.get_arch(arch)
    jmodel, tmodel = jbuild_model(jcfg), meta_model(tcfg)
    seq = shape == "long_500k"
    for mesh in MESHES.values():
        want, _ = jdryrun.decode_state_specs(
            jmodel, jbase.SHAPES[shape], AbstractMesh(*mesh), seq_shard=seq)
        got, whole = dryrun.decode_state_specs(
            tmodel, tbase.SHAPES[shape], CensusMesh(*mesh), seq_shard=seq)

        def walk(g, w, leaf, path):
            if isinstance(leaf, dict):
                for k in leaf:
                    walk(g[k], w[k], leaf[k], f"{path}/{k}")
            elif isinstance(leaf, torch.Tensor):
                assert _norm(g) == _norm(w), (path, mesh)

        walk(got, want, whole, "")


# ---------------------------------------------------------------------------
# the CLI and the roofline table
# ---------------------------------------------------------------------------

_CLI = r"""
import json, sys
from repro_torch.launch import dryrun
for argv in ({argvs}):
    assert dryrun.main(argv) == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("MODULES", json.dumps(bad))
"""


@pytest.fixture(scope="module")
def cli_records():
    argvs = [["--arch", "stablelm_3b", "--shape", "decode_32k", "--packed"],
             ["--arch", "stablelm_3b", "--shape", "decode_32k",
              "--multi-pod"]]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CLI.format(argvs=repr(argvs)[1:-1] + ",")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    recs = [json.loads(l) for l in lines if l.startswith("{")]
    mods = json.loads(next(l for l in lines if l.startswith("MODULES"))
                      .split(" ", 1)[1])
    return recs, mods


def test_cli_prints_one_record_with_the_reference_keys(cli_records):
    recs, mods = cli_records
    assert mods == []
    assert len(recs) == 2
    r = recs[0]
    assert RECORD_KEYS <= set(r)
    assert (r["arch"], r["shape"], r["mesh"], r["kind"], r["packed"]) == (
        "stablelm_3b", "decode_32k", "pod16x16", "decode", True)
    assert set(r["memory_analysis"]) >= {"argument_bytes", "output_bytes",
                                         "temp_bytes", "peak_bytes"}
    assert r["cost_analysis"]["unknown_trip_loops"] == 0
    # 7 packed projections a layer, 32 layers
    assert r["cost_analysis"]["packed_launches"] == {"xwT": 224}
    assert set(r["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total_bytes"}
    assert r["collectives"]["all-reduce"]["count"] > 0
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                  "dominant"}
    assert r["roofline"]["compute_s"] == r["cost_analysis"]["flops"] / 989e12
    assert "H100" in r["roof"]
    assert r["model_flops"] > 0 and 0 < r["useful_flops_ratio"]
    assert r["memory_analysis"]["peak_bytes"] < 80e9


def test_cli_records_the_pod_refusal(cli_records):
    recs, _ = cli_records
    r = recs[1]
    assert set(r) == {"arch", "shape", "mesh", "error"}
    assert r["mesh"] == "pod2x16x16"
    assert r["error"].startswith("NotImplementedError: ")
    assert "'pod'" in r["error"]


def test_roofline_reads_the_census_jsonl(cli_records, tmp_path, capsys):
    from benchmarks import torch_roofline, torch_run

    recs, _ = cli_records
    path = tmp_path / "torch_dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    rows = torch_roofline.run(verbose=True, path=str(path))
    out = capsys.readouterr().out
    assert [name for name, _, _ in rows] == [
        "roofline_stablelm_3b_decode_32k_packed"]
    assert rows[0][2] == "dominant=" + recs[0]["roofline"]["dominant"]
    assert "1 cells with errors" in out and "pod" in out
    assert torch_run.main(["--device", "cpu", "--roofline",
                           str(path)]) == 0
    out = capsys.readouterr().out
    assert "roofline_stablelm_3b_decode_32k_packed," in out
    assert "roofline_skipped" not in out
