"""Flat-npz (de)serialization of nested parameter trees.

A copy of `monodepth_tpu.utils.serialization` that walks nested dicts
(and lists or tuples) instead of `jax.tree_util`: one .npz per tree with
'/'-joined key paths, keys in the order jax flattens (dict keys sorted,
empty dicts and None left out). The JAX package's per-module exports
(`Checkpointer.export_modules`, `tools/convert_torch_weights.py`) and this
package's read and write the same files.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _leaves(tree, prefix: tuple):
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, prefix + (i,))
    else:
        yield prefix, tree


def _array(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_to_flat(tree) -> Dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): _array(leaf)
            for path, leaf in _leaves(tree, ())}


def flat_to_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_npz(path: str, tree) -> None:
    """Atomic publish (write-temp + rename): a reader (or a racing writer)
    never sees a half-written archive. The temp file is opened explicitly
    because np.savez appends '.npz' to bare paths that lack it."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **tree_to_flat(tree))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_npz(path: str) -> Dict[str, Any]:
    with np.load(path) as data:
        return flat_to_tree({k: data[k] for k in data.files})
