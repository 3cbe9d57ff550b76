"""Checkpointing with atomic commit, async save and retention: the
counterpart of ``repro.checkpoint.ckpt``, in its on-disk format.

Layout: <dir>/step_<N>/
    manifest.json            step, leaf count, the tree's structure, and
                             each leaf's shape and dtype
    proc<k>.npz              process k's leaves, ``leaf<i>`` in
                             ``tree_leaves`` order (jax.tree's: dict keys
                             sorted, lists, tuples and NamedTuples in
                             order); bf16 stored as its uint16 bits
    COMMIT                   written last: a checkpoint without it is
                             ignored (crash-safe atomic commit)

The step is written into ``step_<N>.tmp`` and renamed; the 3 most recent
committed steps are kept.  The leaf order and the format are the
reference's, so a checkpoint written by either package restores in the
other.  The process index is ``torch.distributed``'s rank when it is
initialised, else 0.  Each process holds whole leaves (no shards), so a
restore reads every ``.npz`` of the step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from ..models.model import tree_leaves, tree_map, tree_unflatten


def process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _structure(tree) -> str:
    """The tree's structure with ``*`` for each leaf (informational: a
    restore takes the structure of its target tree)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(t) for t in tree)
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}({inner})"
    return "*"


def _host(leaf):
    """(host array, dtype name) of one leaf: a tensor on any device, a
    numpy array (bf16 as ml_dtypes gives it) or a scalar; bf16 comes out
    as its uint16 bits, since npz cannot hold bf16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


# the pinned buffers of the last snapshot, in its order; the next snapshot
# copies into them where a leaf has the same shape and dtype (async_save
# joins the write that reads them before it snapshots again)
_pinned: List[torch.Tensor] = []


def _snapshot(tree):
    """A copy of every leaf on the host: card tensors into pinned memory
    (the last snapshot's buffers, reused) by non-blocking copies and one
    synchronize for the lot, host tensors and arrays copied."""
    pinned = []

    def copy(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            i = len(pinned)
            host = _pinned[i] if i < len(_pinned) else None
            if host is None or host.shape != leaf.shape or \
                    host.dtype != leaf.dtype:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
            host.copy_(leaf.detach(), non_blocking=True)
            pinned.append(host)
            return host
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().clone()
        return np.array(leaf)

    snap = tree_map(copy, tree)
    if pinned:
        torch.cuda.synchronize()
        _pinned[:] = pinned
    return snap


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous save of every leaf of ``tree`` (tensors, numpy arrays
    or scalars).  Returns the step's directory."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = [_host(leaf) for leaf in tree_leaves(tree)]
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": _structure(tree), "leaves": []}
    arrays = {}
    for i, (arr, dtype_name) in enumerate(leaves):
        arrays[f"leaf{i}"] = arr
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": dtype_name})
    np.savez(os.path.join(tmp, f"proc{process_index()}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    # retention: keep the 3 most recent committed steps
    steps = sorted(_committed_steps(ckpt_dir))
    for s in steps[:-3]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    return path


_save_thread: Optional[threading.Thread] = None


def async_save(ckpt_dir: str, step: int, tree: Any) -> None:
    """Non-blocking save: the leaves are copied to pinned host memory on
    the caller's thread (so the caller may overwrite its tensors as soon as
    this returns; the first save allocates the buffers, later ones reuse
    them), and the files are written on a background thread.  Joins any
    save still in flight first."""
    global _save_thread
    wait_for_save()
    snap = _snapshot(tree)
    _save_thread = threading.Thread(
        target=save_checkpoint, args=(ckpt_dir, step, snap), daemon=True)
    _save_thread.start()


def wait_for_save() -> None:
    """Join the save ``async_save`` left in flight, if any."""
    global _save_thread
    if _save_thread is not None:
        _save_thread.join()
        _save_thread = None


def _committed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, target_tree: Any,
                       device=None) -> Any:
    """Restore into the structure of ``target_tree``: each leaf a tensor of
    the saved shape and dtype, on ``device`` (the target leaf's device when
    not given)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"uncommitted checkpoint {path}")
    data = {}
    for name in os.listdir(path):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                for k in z.files:
                    data[k] = z[k]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    targets = list(tree_leaves(target_tree))
    if manifest["n_leaves"] != len(targets):
        raise ValueError(f"{path} holds {manifest['n_leaves']} leaves, the "
                         f"target tree {len(targets)}")
    out = []
    for i, ref in enumerate(targets):
        arr = data[f"leaf{i}"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: saved shape {arr.shape}, target "
                             f"{tuple(ref.shape)}")
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
        if manifest["leaves"][i]["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return tree_unflatten(target_tree, out)
