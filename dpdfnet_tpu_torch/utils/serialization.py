"""Parameter trees from ``.npz`` files and from the JAX package.

The ``.npz`` key format is the JAX package's ``utils/serialization.py``:
'/'-joined key paths, list indices as ``NNNN#`` segments, explicit
``NNNN#none`` markers for ``None`` list entries; ``None`` dict values are
simply absent.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .tree import tree_map


def _load_npz_tree(path) -> Dict:
    """Rebuild the nested dict/list tree of numpy arrays from an ``.npz``."""
    data = np.load(path)
    root: Dict = {}
    for key in data.files:
        parts = key.split("/")
        node: Union[Dict, list] = root
        for i, part in enumerate(parts):
            is_leaf = i == len(parts) - 1
            if is_leaf and part.endswith("#none"):
                k = int(part[: -len("#none")])
                while len(node) <= k:
                    node.append(None)
                break
            is_index = part.endswith("#")
            k = int(part[:-1]) if is_index else part
            if is_leaf:
                if is_index:
                    while len(node) <= k:
                        node.append(None)
                node[k] = np.asarray(data[key])
                continue
            # '#none' markers are index-like: a list whose first saved entry
            # is None must still create its parent as a list
            nxt_is_index = parts[i + 1].endswith(("#", "#none"))
            if is_index:
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = [] if nxt_is_index else {}
            elif k not in node:
                node[k] = [] if nxt_is_index else {}
            node = node[k]
    return root


def params_from_jax(tree, device: DeviceLike = None) -> Dict:
    """The JAX parameter tree (leaves as numpy arrays, or anything
    ``np.asarray`` takes) as the port's tree of float32 tensors on
    ``device``.  Layouts are shared (HWIO convs, ``[I, 3H]`` GRU weights
    with (r, z, n) gate packing), so both packages compute the same
    function."""
    dev = resolve_device(device)
    return tree_map(
        lambda _, x: torch.as_tensor(np.array(x, dtype=np.float32), device=dev), tree)


def load_params(path, device: DeviceLike = None) -> Dict:
    """Load an ``.npz`` written by ``dpdfnet_tpu.utils.serialization.save_params``."""
    return params_from_jax(_load_npz_tree(path), device)
