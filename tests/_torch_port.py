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
