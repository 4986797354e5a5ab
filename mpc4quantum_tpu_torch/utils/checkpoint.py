"""Checkpoint / resume of tensor trees and model-history snapshots
(counterpart of mpc4quantum_tpu/utils/checkpoint.py).

A tree is any nesting of dicts, tuples (NamedTuples included), lists and
dataclasses (the models of models/dmdc.py, a Carry) over tensors and numpy
arrays; numbers, strings, None and a dataclass's static fields are settings,
not saved, and come back from the `like` tree a restore is given. The file
is a plain numpy .npz, one array a leaf in the tree's order, complex leaves
as they are; it is written to a temporary file first and moved into place,
so a crash while saving leaves the previous checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


def tree_map(fn, tree: Any) -> Any:
    """The tree with fn applied to each tensor and numpy array, in a fixed
    order; everything else is kept."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if not f.metadata.get("static")})
    return tree


def tree_leaves(tree: Any) -> list:
    """The tensors and numpy arrays of a tree, in tree_map's order."""
    leaves = []
    tree_map(lambda leaf: leaves.append(leaf), tree)
    return leaves


def tree_unflatten(like: Any, leaves) -> Any:
    """`like` with its leaves replaced, in order, by the arrays of the
    iterator `leaves`: each takes its like-leaf's dtype, shape and device."""
    def take(leaf):
        a = np.asarray(next(leaves))
        if a.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf has shape {a.shape}, expected {tuple(leaf.shape)}")
        if torch.is_tensor(leaf):
            return torch.from_numpy(a).to(leaf.device, leaf.dtype)
        return a.astype(leaf.dtype)
    return tree_map(take, like)


def save_checkpoint(path: str, tree: Any) -> None:
    """Write the tree's leaves to `path` (an .npz file, the name as given),
    copied to the host."""
    arrays = {f"l{i}": (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                        else np.asarray(leaf))
              for i, leaf in enumerate(tree_leaves(tree))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like: Any) -> Any:
    """A tree saved by `save_checkpoint`, restored into the structure,
    settings, dtypes and devices of `like`."""
    with np.load(path) as data:
        arrays = [data[f"l{i}"] for i in range(len(data.files))]
    n_like = len(tree_leaves(like))
    if len(arrays) != n_like:
        raise ValueError(f"{path} holds {len(arrays)} leaves, the structure to restore "
                         f"into has {n_like}")
    return tree_unflatten(like, iter(arrays))


class ModelHistory:
    """Host snapshots of a streaming model: `record(model)` after each
    update keeps a CPU copy of every `every`-th one."""

    def __init__(self, every: int = 10):
        self.every = int(every)
        self._count = 0
        self.snapshots: list = []

    def record(self, model_state) -> None:
        self._count += 1
        if self._count % self.every == 0:
            self.snapshots.append(tree_map(
                lambda t: t.detach().cpu().clone() if torch.is_tensor(t) else t.copy(),
                model_state))

    def __len__(self) -> int:
        return len(self.snapshots)
