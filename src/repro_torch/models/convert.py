"""The weight carry: the reference's parameters (numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them) into the port's tree,
and a cast of a tree to another config's types.

A bf16 leaf comes out of JAX as an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses; its bits go over as uint16 and are viewed as
``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from ..core.lowering import resolve_device
from .model import DTYPES, param_specs, tree_map


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)             # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter tree (dicts and lists of numpy arrays) as
    the port's, leaf for leaf, on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf(a, device), tree)


def cast_params(params, cfg: ModelConfig):
    """``params`` with each leaf cast to the type ``cfg``'s specs give it
    (for example an f32 model's weights as the bf16 model's), in place:
    each leaf is replaced in its dict or list as it is cast, so the old
    leaf is freed before the next is cast unless the caller holds it.
    Returns ``params``."""
    def cast(tree, specs):
        for key in (tree.keys() if isinstance(tree, dict)
                    else range(len(tree))):
            if isinstance(tree[key], (dict, list)):
                cast(tree[key], specs[key])
            else:
                tree[key] = tree[key].to(DTYPES[specs[key].dtype])

    cast(params, param_specs(cfg))
    return params
