"""Parameter trees saved as flat ``.npz`` files (port of
``tpufusion/io/params_io.py``): nested dicts of arrays, each leaf stored
under its ``/``-joined path, so a file written by either package loads in
the other. Leaves are numpy arrays (a tensor is copied to the host).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return flat
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix: np.asarray(tree)}


def save_pytree(tree, path: str) -> str:
    """Save a tree as a flat npz; returns the path actually written:
    ``np.savez`` appends '.npz' to a path without it, so the path gets the
    suffix first."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **_flatten(tree))
    return path


def load_pytree(path: str) -> dict:
    """The nested dict of numpy arrays that ``save_pytree`` wrote."""
    tree: dict = {}
    with np.load(path) as data:
        for key, v in data.items():
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree
