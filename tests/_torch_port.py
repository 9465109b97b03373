"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: tree conversion and small-model construction."""

import dataclasses

import jax
import numpy as np

from repro.configs.base import get_arch as jax_get_arch
from repro.core.sparsity import PackedWeight as JaxPackedWeight
from repro.core.sparsity import Static
from repro.models.families import build_model as jax_build_model

from repro_torch.configs.base import get_arch as torch_get_arch
from repro_torch.convert import from_jax_params

from _torch_dist_worker import family_batch  # noqa: F401  (jax-free)


def jax_tree_to_numpy(tree):
    """The JAX package's parameter tree with numpy leaves, ``Static`` and
    ``PackedWeight`` nodes unwrapped into what ``repro_torch.convert``
    takes."""
    if isinstance(tree, JaxPackedWeight):
        c = tree.cfg
        return {"values": np.asarray(tree.values),
                "indices": np.asarray(tree.indices),
                "scales": (None if tree.scales is None
                           else np.asarray(tree.scales)),
                "active_groups": (None if tree.active_groups is None
                                  else np.asarray(tree.active_groups)),
                "cfg": (c.n, c.m, c.k), "dense_shape": tree.dense_shape,
                "layout": tree.layout, "block_geom": tree.block_geom,
                "qdtype": tree.qdtype}
    if isinstance(tree, Static):
        c = tree.value
        return (c.n, c.m, c.k)
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def reduced_pair(**overrides):
    """(jax_cfg, torch_cfg) of reduced stablelm_3b in float32 compute."""
    overrides = {"compute_dtype": "float32", **overrides}
    jcfg = dataclasses.replace(jax_get_arch("stablelm_3b").reduced(),
                               **overrides)
    tcfg = dataclasses.replace(torch_get_arch("stablelm_3b").reduced(),
                               **overrides)
    return jcfg, tcfg


def jax_model_and_params(jcfg, seed=0):
    model = jax_build_model(jcfg)
    return model, model.init(jax.random.PRNGKey(seed))


def to_torch_model(params, tcfg):
    return from_jax_params(jax_tree_to_numpy(params), tcfg, device="cpu")


def port_named(tree):
    """The JAX package's decoder tree (params, grads, masks or AdamW
    moments) as ``{port parameter name: numpy array}``: the stacked layer
    axis split into ``layers.<i>``, ``Static`` nodes and None leaves left
    out — the names ``repro_torch.train.train_loop.train_params`` gives."""
    out = {}

    def walk(node, prefix, layer):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k, layer)
        elif isinstance(node, Static) or node is None:
            return
        else:
            a = np.asarray(node)
            out[prefix] = a if layer is None else a[layer]

    for k, v in tree.items():
        if k == "layers":
            n = jax.tree.leaves(v)[0].shape[0]
            for i in range(n):
                walk(v, f"layers.{i}", i)
        else:
            walk(v, k, None)
    return out


# the keys under which a family's tree stacks its layers on a leading axis
# (the xLSTM's ``mlstm`` a second time, inside ``periods``)
STACKED_KEYS = ("layers", "enc_layers", "dec_layers", "periods", "mlstm")


def family_named(tree):
    """Any family's parameter tree (params or grads) as ``{port parameter
    name: numpy array}``: each stacked axis (:data:`STACKED_KEYS`) split
    into ``<key>.<i>``, ``Static`` nodes and None leaves left out — the
    names ``train_params`` gives the port's module tree."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                name = f"{prefix}.{k}" if prefix else k
                if k in STACKED_KEYS and isinstance(v, dict):
                    n = jax.tree.leaves(v)[0].shape[0]
                    for i in range(n):
                        walk(jax.tree.map(lambda a: a[i], v), f"{name}.{i}")
                else:
                    walk(v, name)
        elif not (isinstance(node, Static) or node is None):
            out[prefix] = np.asarray(node)

    walk(tree, "")
    return out


def family_pair(arch, **overrides):
    """(jax_cfg, torch_cfg) of reduced ``arch`` in float32 compute."""
    overrides = {"compute_dtype": "float32", **overrides}
    return (dataclasses.replace(jax_get_arch(arch).reduced(), **overrides),
            dataclasses.replace(torch_get_arch(arch).reduced(), **overrides))


def torch_batch(batch):
    """The numpy batch as tensors: int64 tokens, float32 frontend inputs."""
    import torch
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def state_arrays(state, prefix=""):
    """{path: numpy array} of a decode state of either package (the cache
    ``kind`` tags and a paged layout are not arrays)."""
    out = {}
    if isinstance(state, dict):
        for k, v in state.items():
            out.update(state_arrays(v, f"{prefix}/{k}"))
    elif hasattr(state, "shape") and not isinstance(state, Static):
        a = state.numpy() if hasattr(state, "numpy") else np.asarray(state)
        out[prefix] = a
    return out


# decode modes: (ExecPolicy mode, pack_tree kwargs or None for no packing)
PACK_MODES = {
    "dense": ("dense", None),
    "masked": ("masked", None),
    "packed": ("packed", {}),
    "packed_int8": ("packed", {"quantize": "int8"}),
    "packed_block": ("packed", {"layout": "block"}),
    "packed_block_int8": ("packed", {"layout": "block", "quantize": "int8"}),
}


def decode_both(jmodel, params, tcfg, mode, *, steps=3, b=2, max_len=12,
                seed=0, enc_len=3):
    """The JAX package's tree packed (or not) for ``mode``
    (:data:`PACK_MODES`), converted to the port, and ``steps`` decode steps
    of random tokens through both models from fresh float32 states (an
    encoder-decoder's ``enc_out`` set to the same random rows on both
    sides).  Returns ([(port logits, JAX logits)] per step, port state, JAX
    state, port model)."""
    import jax.numpy as jnp
    import torch
    from repro.core.sparse_linear import ExecPolicy as JPolicy
    from repro.launch.pack_tree import pack_tree as jax_pack_tree
    from repro_torch.core.sparse_linear import ExecPolicy

    pmode, pack = PACK_MODES[mode]
    jparams = params if pack is None else jax_pack_tree(params, **pack)
    tmodel = to_torch_model(jparams, tcfg)
    jstate = jmodel.init_decode_state(b, max_len, dtype=jnp.float32)
    tstate = tmodel.init_decode_state(b, max_len, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    if "enc_out" in tstate:
        e = rng.standard_normal((b, enc_len, tcfg.d_model)).astype(np.float32)
        jstate["enc_out"] = jnp.asarray(e)
        tstate["enc_out"] = torch.from_numpy(e)
    jstep = jax.jit(lambda p, s, t: jmodel.decode_step(
        p, s, t, policy=JPolicy(mode=pmode)))
    out = []
    for _ in range(steps):
        toks = rng.integers(0, tcfg.vocab_size, (b, 1))
        jlogits, jstate = jstep(jparams, jstate, jnp.asarray(toks, jnp.int32))
        with torch.inference_mode():
            tlogits, tstate = tmodel.decode_step(
                tstate, torch.from_numpy(toks), policy=ExecPolicy(mode=pmode))
        out.append((tlogits.numpy(), np.asarray(jlogits)))
    return out, tstate, jstate, tmodel


def loss_and_grads_both(jmodel, params, tmodel, batch, mode="masked"):
    """``train_loss`` and its gradient at every parameter through both
    packages: ((port loss, metrics, {name: grad}), (JAX loss, metrics,
    {name: grad})), the JAX grads named as the port's parameters."""
    import jax.numpy as jnp
    import torch
    from repro.core.sparse_linear import ExecPolicy as JPolicy
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.train.train_loop import train_params

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jb, policy=JPolicy(mode=mode)),
        has_aux=True))(params)
    leaves = {n: p.clone().requires_grad_(True)
              for n, p in train_params(tmodel).items()}
    loss, met = torch.func.functional_call(
        tmodel, leaves, (torch_batch(batch),),
        {"policy": ExecPolicy(mode=mode)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return ((float(loss), {k: float(v) for k, v in met.items()},
             {n: g.numpy() for n, g in zip(leaves, grads)}),
            (float(jloss), {k: float(v) for k, v in jmet.items()},
             family_named(jgrads)))


def assert_grads_close(got: dict, want: dict, rtol=1e-5):
    """Every gradient within rtol, atol rtol x the leaf's largest |grad|
    (sums over positions in another order; an element near 0 keeps no
    relative precision)."""
    assert set(got) == set(want), set(got) ^ set(want)
    for n, g in got.items():
        r = want[n]
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=rtol * float(np.abs(r).max()),
                                   err_msg=n)


_FAMILY_CACHE = {}


def family_setup(arch):
    """(jax_cfg, torch_cfg, JAX model, JAX params) of reduced ``arch`` in
    float32 compute, initialised once per process (a JAX init of a reduced
    family takes seconds on the CPU)."""
    if arch not in _FAMILY_CACHE:
        jcfg, tcfg = family_pair(arch)
        _FAMILY_CACHE[arch] = (jcfg, tcfg, *jax_model_and_params(jcfg))
    return _FAMILY_CACHE[arch]
