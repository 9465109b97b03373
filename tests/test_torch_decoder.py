"""Port vs JAX package: ``DecoderLM.decode_step`` over several steps, the
same weights on both sides through ``repro_torch.convert.from_jax_params``.

Reduced stablelm_3b (2 layers, d_model 128, 2:16), float32 compute.
Tolerance: rtol/atol 1e-4 on logits and caches (summation order through two
layers of matmuls, softmax and norms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_linear import ExecPolicy as JPolicy
from repro.launch.pack_tree import pack_tree as jax_pack_tree

from _torch_port import jax_model_and_params, reduced_pair, to_torch_model
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.sparse_linear import ExecPolicy, SparseLinear
from repro_torch.core.sparsity import PackedWeight
from repro_torch.launch.pack_tree import pack_tree

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    "dense": dict(mode="dense"),
    "masked": dict(mode="masked"),
    "packed": dict(mode="packed", pack=True),
    "packed_int8": dict(mode="packed", pack=True, quantize="int8"),
    "packed_int8_per_group": dict(mode="packed", pack=True, quantize="int8",
                                  granularity="per_group"),
    "packed_block": dict(mode="packed", pack=True, layout="block"),
    "packed_block_int8": dict(mode="packed", pack=True, layout="block",
                              quantize="int8"),
}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = reduced_pair()
    jmodel, params = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, params


def _run_both(setup, case, convert_packed):
    jcfg, tcfg, jmodel, params = setup
    spec = CASES[case]
    kw = {k: spec[k] for k in ("layout", "quantize", "granularity")
          if k in spec}
    if spec.get("pack"):
        jparams = jax_pack_tree(params, **kw)
        if convert_packed:      # convert the JAX package's own packed tree
            tmodel = to_torch_model(jparams, tcfg)
        else:                   # convert the masked tree, pack in the port
            tmodel = pack_tree(to_torch_model(params, tcfg), **kw)
    else:
        jparams, tmodel = params, to_torch_model(params, tcfg)
    b, max_len, steps = 3, 12, 5
    jstate = jmodel.init_decode_state(b, max_len, dtype=jnp.float32)
    tstate = tmodel.init_decode_state(b, max_len, dtype=torch.float32)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        toks = rng.integers(0, jcfg.vocab_size, (b, 1))
        jlogits, jstate = jmodel.decode_step(
            jparams, jstate, jnp.asarray(toks, jnp.int32),
            policy=JPolicy(mode=spec["mode"]))
        with torch.inference_mode():
            tlogits, tstate = tmodel.decode_step(
                tstate, torch.from_numpy(toks),
                policy=ExecPolicy(mode=spec["mode"]))
        assert tuple(tlogits.shape) == (b, 1, tcfg.padded_vocab)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        np.testing.assert_array_equal(tstate["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tstate["caches"][key].numpy(),
                np.asarray(jstate["caches"][key]), **TOL)
    return tmodel


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches(setup, case):
    tmodel = _run_both(setup, case, convert_packed=False)
    kinds = {type(m) for m in tmodel.modules()
             if isinstance(m, (SparseLinear, PackedWeight))}
    assert kinds == ({PackedWeight} if CASES[case].get("pack")
                     else {SparseLinear})


@pytest.mark.parametrize("case", ["packed", "packed_int8",
                                  "packed_int8_per_group", "packed_block",
                                  "packed_block_int8"])
def test_decode_step_matches_from_converted_packed_tree(setup, case):
    """Logits of a model converted from the JAX package's own packed tree
    (for the block layout: a scan stack sharing one a_max, sliced per
    layer) match the JAX model's."""
    tmodel = _run_both(setup, case, convert_packed=True)
    if CASES[case].get("layout") == "block":
        geoms = {m.block_geom for m in tmodel.modules()
                 if isinstance(m, PackedWeight)}
        assert all(g is not None for g in geoms)


def test_port_packing_equals_reference_packing(setup):
    """pack_tree of the port on converted masked weights gives the very
    arrays the JAX package's pack_tree gives (un-stacked per layer)."""
    jcfg, tcfg, _, params = setup
    names = (("attn", ("wq", "wk", "wv", "wo")),
             ("mlp", ("gate", "up", "down")))
    for kw in ({}, {"quantize": "int8"},
               {"quantize": "int8", "granularity": "per_group"},
               {"layout": "block"}, {"layout": "block", "quantize": "int8"}):
        jparams = jax_pack_tree(params, **kw)
        port_kw = dict(kw)
        if kw.get("layout") == "block":
            # the JAX scan stack shares one a_max over the layers; the port
            # packs each layer on its own unless told the stack's a_max
            port_kw["a_max"] = jparams["layers"]["attn"]["wq"].block_geom[1]
        tmodel = pack_tree(to_torch_model(params, tcfg), **port_kw)
        for i, blk in enumerate(tmodel.layers):
            for grp, ns in names:
                for name in ns:
                    tpw = getattr(getattr(blk, grp), name)
                    jpw = jparams["layers"][grp][name]
                    if kw.get("layout") == "block" and \
                            tpw.block_geom != jpw.block_geom:
                        # another projection of the stack, another a_max
                        tpw = pack_tree(to_torch_model(params, tcfg),
                                        layout="block",
                                        a_max=jpw.block_geom[1],
                                        quantize=kw.get("quantize"))
                        tpw = getattr(getattr(tpw.layers[i], grp), name)
                    assert (tpw.cfg.n, tpw.cfg.m, tpw.cfg.k) == \
                        (jpw.cfg.n, jpw.cfg.m, jpw.cfg.k)
                    assert tpw.dense_shape == tuple(jpw.dense_shape)
                    assert tpw.layout == jpw.layout
                    assert tpw.block_geom == jpw.block_geom
                    children = ["values", "indices"]
                    if tpw.layout == "block":
                        children.append("active_groups")
                    if "quantize" in kw:
                        children.append("scales")
                    for child in children:
                        np.testing.assert_array_equal(
                            getattr(tpw, child).numpy(),
                            np.asarray(getattr(jpw, child)[i]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_resolves_and_builds(arch):
    """Every id resolves to its config (the JAX package's, field for field)
    and builds a reduced model of its family on the CPU, whose decode step
    runs; an unknown id still raises ``KeyError``."""
    import dataclasses
    from repro.configs.base import get_arch as jax_get_arch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.families import build_model
    cfg = get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_arch(arch))
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jax_get_arch(arch).reduced())
    model = build_model(cfg.reduced(), device="cpu", seed=1)
    assert type(model).__name__ == {"audio": "EncDecLM", "hybrid": "HybridLM",
                                    "ssm": "XLSTMLM"}.get(cfg.family,
                                                          "DecoderLM")
    state = model.init_decode_state(2, 8, dtype=torch.float32)
    with torch.inference_mode():
        logits, _ = model.decode_step(state, torch.zeros((2, 1),
                                                         dtype=torch.long))
    assert tuple(logits.shape) == (2, 1, cfg.reduced().padded_vocab)
    with pytest.raises(KeyError):
        get_arch("no_such_arch")


def test_pack_tree_layouts_and_the_ports_own_init():
    from repro_torch.configs.base import get_arch
    from repro_torch.models.families import build_model
    cfg = get_arch("stablelm_3b").reduced()
    model = build_model(cfg, device="cpu", seed=1)
    with pytest.raises(ValueError, match="unknown layout"):
        pack_tree(model, layout="tiles")
    # the block layout is ported (shard-stacked and draft-tier views are
    # not: PackedWeight has no shard_axis / tier_ne)
    blocked = pack_tree(build_model(cfg, device="cpu", seed=1),
                        layout="block")
    assert blocked.layers[0].mlp.down.layout == "block"
    assert not hasattr(blocked.layers[0].mlp.down, "shard_axis")
    # the port's own init: seeded, pre-pruned, packs losslessly
    again = build_model(cfg, device="cpu", seed=1)
    w0 = model.layers[0].mlp.down.w.data.clone()
    assert torch.equal(w0, again.layers[0].mlp.down.w.data)
    packed = pack_tree(model)
    assert torch.equal(packed.layers[0].mlp.down.to_dense(), w0)
