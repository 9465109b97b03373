"""Small shared tree utilities: leaf naming and walking.

The port's trees are dicts (and lists, tuples, named tuples) whose leaves are
tensors, numpy arrays or None, with two typed nodes: a
:class:`~repro_torch.core.sparsity.PackedWeight` (children ``values``,
``indices``, ``active_groups``, ``scales``) and :class:`Static` metadata.  A
training parameter tree is a dict of named tensors keyed by the module
tree's dotted names (``"layers.0.attn.wq.w"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Static:
    """Non-array metadata carried in a tree (a checkpoint records its value
    in the manifest's ``nodes`` table, not as a leaf)."""

    value: Any


PACKED_CHILDREN = ("values", "indices", "active_groups", "scales")


def key_path_str(path) -> str:
    """'/'-joined string form of a key path.

    A part is a dict key or a sequence index; anything with ``.key``,
    ``.idx`` or ``.name`` is read the way the JAX package reads its key
    types, anything else falls back to ``str``.  A string key with dots (a
    module tree's dotted parameter name, ``"layers.0.attn.wq.w"``) splits
    at them, so that a flat dict of named parameters and the nested tree it
    names give the same path.  The single source of truth for path naming
    of checkpoint leaves and mask trees.
    """
    parts = []
    for p in path:
        if hasattr(p, "key"):
            p = p.key
        elif hasattr(p, "idx"):
            p = p.idx
        elif hasattr(p, "name"):
            p = p.name
        parts.extend(str(p).split("."))
    return "/".join(parts)


def leaves_with_path(tree, path=()):
    """``[(path tuple, leaf), ...]`` in a fixed order: dicts in insertion
    order, sequences in index order (a named tuple's parts by field name), a
    PackedWeight's children by name.
    ``Static`` nodes hold no leaf; None is a leaf."""
    from repro_torch.core.sparsity import PackedWeight

    if isinstance(tree, PackedWeight):
        return [(path + (c,), getattr(tree, c)) for c in PACKED_CHILDREN]
    if isinstance(tree, Static):
        return []
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(leaves_with_path(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for k, v in zip(sequence_keys(tree), tree):
            out.extend(leaves_with_path(v, path + (k,)))
        return out
    return [(path, tree)]


def sequence_keys(seq):
    """A sequence's keys: a named tuple's field names (as the JAX package
    names a NamedTuple's children), else the indices."""
    fields = getattr(seq, "_fields", None)
    return fields if isinstance(seq, tuple) and fields else range(len(seq))


def map_leaves(fn, tree, path=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (the structure
    and typed nodes kept; a PackedWeight is rebuilt with the new children,
    its static attributes unchanged)."""
    from repro_torch.core.sparsity import PackedWeight

    if isinstance(tree, PackedWeight):
        new = {c: fn(path + (c,), getattr(tree, c)) for c in PACKED_CHILDREN}
        return tree.replace(**new)
    if isinstance(tree, Static):
        return tree
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_leaves(fn, v, path + (k,))
               for k, v in zip(sequence_keys(tree), tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*out)           # a named tuple (optimizer state)
        return type(tree)(out)
    return fn(path, tree)
