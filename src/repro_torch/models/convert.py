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
    (for example an f32 model's weights as the bf16 model's)."""
    return tree_map(lambda t, p: t.to(DTYPES[p.dtype]), params,
                    param_specs(cfg))
