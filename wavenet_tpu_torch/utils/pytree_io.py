"""Shared '/'-joined flat codec for nested param dicts (numpy only), and the
weight carry-over between numpy arrays and port tensors.

flatten_tree / unflatten_tree are the key scheme of the JAX package's
WaveNet.export_npz, so one .npz file serves both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> {'a/b/c': np.ndarray} (insertion order)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = np.asarray(v)
    return flat


def unflatten_tree(flat: dict) -> dict:
    """Inverse of flatten_tree; leaf values pass through unchanged."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """Nested dict of numpy arrays (e.g. JAX params via np.asarray) ->
    the same nested dict of tensors on `device`, shapes and dtypes kept."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(device))
            for k, v in tree.items()}


def params_to_numpy(tree: dict) -> dict:
    """Inverse of params_from_numpy: tensors -> numpy arrays on the host."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy())
            for k, v in tree.items()}
