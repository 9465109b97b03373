"""Atomic checkpoints of a tree of tensors, in the JAX package's layout.

Layout::

    <dir>/step_<N>/
        manifest.json        # step, leaves (path, file, shape, dtype), nodes
        <leaf-path>.npy      # one file per leaf, path "/" -> "__"
    <dir>/step_<N>.tmp/      # staging; os.rename() commits atomically

Leaf paths come from ``core.treeutil.key_path_str`` (a dotted parameter
name splits into parts: ``params/layers/0/attn/wq/w``).  ``save_async``
copies every leaf to the host at once and writes on a background thread
(training goes on, and may update the tensors in place).  ``restore`` loads
each leaf onto the device of the template's leaf.

Typed nodes: :class:`~repro_torch.core.sparsity.PackedWeight` nodes (values
/ indices — plus active_groups for the block layout and scales for quantized
weights — leaves, with ``{cfg, dense_shape, layout, block_geom, qdtype}``
recorded) and :class:`~repro_torch.core.treeutil.Static` metadata are kept
in the manifest's ``nodes`` table, and restore patches them back over the
template — so a packed tree round-trips with its full
:class:`SparsityConfig` (k-reconfiguration included) and quantization tag
even if the restoring process built its template with other static
metadata.  A renumbered (shard-stacked) or shard-local node records its
``shards`` and ``shard_axis`` too.  ``save(..., plan=)`` writes the
:class:`~repro_torch.sharding.plan.ShardingPlan` a tree was produced under
into the manifest (``sharding_plan``, the JAX package's JSON), and
:func:`load_plan` reads it back, so a restore knows the geometry its packed
weights were renumbered for.

bfloat16 leaves (numpy has no such type) are stored as their int16 bit
patterns with ``"dtype": "bfloat16"`` in the manifest.

From a world of ranks (``save(..., layout=)``, a training step's
``sharding.plan.TrainLayout``) every rank sends its blocks (tp blocks,
ZeRO-1 moment blocks) to rank 0's host, which writes whole leaves, so the
manifest is a one-process tree's and a one-process :func:`restore` reads
it; the other ranks wait until it is committed.  :func:`restore` with
``keep`` reads whole leaves and keeps a block of each
(``fault_tolerance.elastic_restore``: another plan's blocks).
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.sparsity import PackedWeight, SparsityConfig
from repro_torch.core.treeutil import (Static, sequence_keys, key_path_str,
                                       leaves_with_path, map_leaves)

_EXEC = ThreadPoolExecutor(max_workers=2)


def _to_host(leaf, copy: bool = True):
    """(numpy array, manifest dtype) of a leaf.  ``copy``: a copy, whatever
    the leaf's device, so that later in-place updates do not reach it (a
    write that does not wait for them, :func:`save_async`, needs one)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        dtype = "bfloat16" if t.dtype == torch.bfloat16 else None
        if dtype:
            t = t.view(torch.int16)
        # a CUDA tensor's .cpu() is a copy already; a CPU tensor's is itself
        arr = t.cpu().numpy() if t.is_cuda or not copy else t.numpy().copy()
        return arr, dtype or str(arr.dtype)
    arr = np.array(leaf) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device):
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device) if device is not None else t


# ---------------------------------------------------------------------------
# Typed-node manifest entries (PackedWeight attributes, Static values)
# ---------------------------------------------------------------------------

def _encode_value(v):
    """JSON-encode a Static value, tagging non-JSON-native types."""
    if isinstance(v, SparsityConfig):
        return {"__type__": "SparsityConfig", "n": v.n, "m": v.m, "k": v.k}
    if isinstance(v, tuple):
        return {"__type__": "tuple", "items": [_encode_value(x) for x in v]}
    return v


def _decode_value(v):
    if isinstance(v, dict) and "__type__" in v:
        if v["__type__"] == "SparsityConfig":
            return SparsityConfig(v["n"], v["m"], v["k"])
        if v["__type__"] == "tuple":
            return tuple(_decode_value(x) for x in v["items"])
    return v


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _node_entries(tree, prefix=""):
    """Manifest entries for typed (non-array) nodes, keyed by tree path."""
    out = []
    if isinstance(tree, PackedWeight):
        if tree.tier_ne is not None:
            raise ValueError("a draft-tier view is not checkpointed; save "
                             "the full tier")
        entry = {"path": prefix, "kind": "packed_weight",
                 "cfg": {"n": tree.cfg.n, "m": tree.cfg.m, "k": tree.cfg.k},
                 "dense_shape": list(tree.dense_shape),
                 "layout": tree.layout}
        if tree.block_geom is not None:
            entry["block_geom"] = list(tree.block_geom)
        if tree.qdtype is not None:
            entry["qdtype"] = tree.qdtype
        if tree.shards > 1:
            # renumbered shard-stacked / shard-local provenance
            entry["shards"] = tree.shards
            if tree.shard_axis is not None:
                entry["shard_axis"] = tree.shard_axis
        out.append(entry)
    elif isinstance(tree, Static):
        out.append({"path": prefix, "kind": "static",
                    "value": _encode_value(tree.value)})
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_node_entries(v, _join(prefix, key_path_str((k,)))))
    elif isinstance(tree, (list, tuple)):
        for k, v in zip(sequence_keys(tree), tree):
            out.extend(_node_entries(v, _join(prefix, k)))
    return out


def _patch_nodes(tree, by_path, prefix=""):
    """Overlay the manifest's node entries onto a restored tree (the
    manifest wins, so the saved SparsityConfig — k included — survives a
    stale template)."""
    if isinstance(tree, PackedWeight):
        e = by_path.get(prefix)
        if e is None or e["kind"] != "packed_weight":
            return tree
        geom = e.get("block_geom")
        qdtype = e.get("qdtype")
        return PackedWeight(tree.values, tree.indices,
                            cfg=SparsityConfig(**e["cfg"]),
                            dense_shape=tuple(e["dense_shape"]),
                            layout=e["layout"],
                            active_groups=tree.active_groups,
                            block_geom=tuple(geom) if geom else None,
                            scales=tree.scales if qdtype else None,
                            qdtype=qdtype,
                            shard_axis=e.get("shard_axis"),
                            shards=int(e.get("shards", 1)))
    if isinstance(tree, Static):
        e = by_path.get(prefix)
        if e is not None and e["kind"] == "static":
            return Static(_decode_value(e["value"]))
        return tree
    if isinstance(tree, dict):
        return {k: _patch_nodes(v, by_path, _join(prefix, key_path_str((k,))))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        patched = [_patch_nodes(v, by_path, _join(prefix, k))
                   for k, v in zip(sequence_keys(tree), tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*patched)
        return type(tree)(patched)
    return tree


def _write(host_leaves, nodes, directory: str, step: int, plan=None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "nodes": nodes}
    if plan is not None:
        manifest["sharding_plan"] = plan.to_json()
    for path, arr, dtype in host_leaves:
        if arr is None:
            manifest["leaves"].append({"path": path, "kind": "none"})
            continue
        fname = path.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": path, "kind": "array", "file": fname,
            "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_leaves(tree, copy: bool = False):
    """(path, host array, dtype) of every leaf, one at a time (``copy``:
    see :func:`_to_host`)."""
    for path, leaf in leaves_with_path(tree):
        path = key_path_str(path)
        if leaf is None:
            yield path, None, None
        else:
            yield (path, *_to_host(leaf, copy))


def save(tree, directory: str, step: int, *, plan=None,
         layout=None) -> str:
    """Synchronous atomic save, one leaf on the host at a time.  Returns the
    committed directory.  ``plan`` (a ``ShardingPlan``) is written into the
    manifest (:func:`load_plan`).  ``layout`` (a ``TrainLayout``; call on
    every rank): ``tree`` is a training state ``{"params", "opt", ...}``
    of this rank's blocks, saved whole by rank 0 (see the module
    docstring)."""
    if layout is None:
        return _write(_host_leaves(tree), _node_entries(tree), directory,
                      step, plan)
    import torch.distributed as dist

    whole = layout.whole_tree(tree, dst=0)     # None on the other ranks
    final = os.path.join(directory, f"step_{step:08d}")
    if dist.get_rank() == 0:
        final = _write(_host_leaves(whole), _node_entries(whole), directory,
                       step, plan)
    del whole
    dist.barrier()
    return final


def save_async(tree, directory: str, step: int, *, plan=None) -> Future:
    """Copy every leaf to the host now, write on a background thread."""
    return _EXEC.submit(_write, list(_host_leaves(tree, copy=True)),
                        _node_entries(tree), directory, step, plan)


def load_plan(directory: str, step: Optional[int] = None):
    """The :class:`~repro_torch.sharding.plan.ShardingPlan` a checkpoint was
    saved with, or None (no plan recorded, or no checkpoint).  ``step``
    defaults to the latest committed step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    final = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    blob = manifest.get("sharding_plan")
    if blob is None:
        return None
    from repro_torch.sharding.plan import ShardingPlan
    return ShardingPlan.from_json(blob)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(template, directory: str, step: int, *, keep=None):
    """Restore into ``template``'s structure.  Each leaf loads onto the
    device of the template's leaf (the CPU for a numpy or None template
    leaf); the manifest's shapes are authoritative.  Typed nodes
    (PackedWeight attributes, Static values) are patched from the manifest.
    A template leaf the checkpoint lacks raises ``KeyError`` (a None one
    restores as None).  ``keep(path, whole) -> block``, given the leaf's
    path string and the whole leaf as a memory-mapped numpy array, picks
    what of each leaf is read and kept."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path, leaf):
        key = key_path_str(path)
        if leaf is None and key not in by_path:
            return None
        entry = by_path[key]
        if entry["kind"] == "none":
            return None
        path_ = os.path.join(final, entry["file"])
        if keep is None:
            arr = np.load(path_)
        else:
            # a copy of the block: only its pages are read
            arr = np.array(keep(key, np.load(path_, mmap_mode="r")))
        dev = leaf.device if isinstance(leaf, torch.Tensor) else None
        return _from_host(arr, entry["dtype"], dev)

    restored = map_leaves(load, template)
    nodes = {e["path"]: e for e in manifest.get("nodes", [])}
    return _patch_nodes(restored, nodes) if nodes else restored
