"""Checkpoint: dict <-> directory <-> bytes interconvertible.

Mirrors the reference's AIR `Checkpoint` (`python/ray/air/checkpoint.py:63`)
without the cloud-URI legs (storage_path handles persistence). Pytrees of
arrays are stored as native numpy `.npz` plus a pickled structure, so an
8B model checkpoint round-trips without Python-object overhead.

The pytrees are flattened here, as jax flattens them: dicts by sorted key,
lists, tuples and None (a node with no leaves). numpy leaves go to
`arrays.npz`; torch tensors, of any dtype (bf16 included), go to
`tensors.pt` with `torch.save`, always as CPU tensors, and come back from
`to_dict` as CPU tensors.

A checkpoint that is pickled (it crosses a process boundary, e.g. from a
trial to the Tuner's driver) carries its CUDA tensor leaves as CPU tensors
of the same dtype, shape and bits, so a process that receives one never
makes a CUDA context for it. Inside the process that built it, `to_dict`
returns what was given.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_ARRAYS, _TENSORS, _META = "arrays.npz", "tensors.pt", "checkpoint.pkl"


def _is_tensor(x: Any) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


# ---- pytrees: (kind, aux, children) nodes; a leaf is ("leaf", None, ()) ----
_LEAF = ("leaf", None, ())


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """`tree`'s leaves in jax's order and a picklable structure for
    `tree_unflatten`: dicts by sorted key, lists, tuples (namedtuples
    included) and None (no leaves); anything else is a leaf."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return ("none", None, ())
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("namedtuple", type(x), tuple(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, None, tuple(walk(v) for v in x))
        leaves.append(x)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        kind, aux, children = node
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(aux, built))
        if kind == "namedtuple":
            return aux(*built)
        return tuple(built) if kind == "tuple" else built

    return build(treedef)


def _host(x: Any) -> Any:
    return x.detach().cpu() if _is_tensor(x) and x.device.type != "cpu" else x


def _to_host(obj: Any) -> Any:
    """`obj` with every tensor off the CPU copied to the CPU (same dtype,
    shape and bits); dicts, lists, tuples and dataclass instances keep
    their types and order."""
    if _is_tensor(obj):
        return _host(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, _to_host(getattr(obj, f.name)))
        return out
    if isinstance(obj, dict):
        out = copy.copy(obj)
        out.update((k, _to_host(v)) for k, v in obj.items())
        return out
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """`metrics` as they may leave a trial or a train worker: one-element
    tensors as Python numbers, other tensors as CPU tensors (nested dicts
    too), so the process that receives them never makes a CUDA context."""
    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if _is_tensor(v):
            return v.item() if v.numel() == 1 else v.detach().cpu()
        return v

    return host(dict(metrics))


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None):
        self._data = data
        self._directory = directory

    # ---- constructors ----
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=path)

    # ---- pickling: CUDA leaves cross as CPU tensors ----
    def __getstate__(self):
        return {"_data": _to_host(self._data), "_directory": self._directory}

    def __setstate__(self, state):
        self.__dict__.update(state)

    # ---- accessors ----
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return self._data
        assert self._directory is not None
        with open(os.path.join(self._directory, _META), "rb") as f:
            data = pickle.load(f)
        if "__treedef__" not in data:
            return data
        leaves: Dict[int, Any] = {}
        npz_path = os.path.join(self._directory, _ARRAYS)
        if os.path.exists(npz_path):
            arrays = np.load(npz_path)
            leaves.update({int(k): arrays[k] for k in arrays.files})
        pt_path = os.path.join(self._directory, _TENSORS)
        if os.path.exists(pt_path):
            import torch

            tensors = torch.load(pt_path, map_location="cpu",
                                 weights_only=True)
            leaves.update({int(k): t for k, t in tensors.items()})
        return tree_unflatten(data["__treedef__"],
                              [leaves[i] for i in sorted(leaves)])

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="rtt-ckpt-")
        os.makedirs(path, exist_ok=True)
        if self._directory is not None and self._directory != path:
            shutil.copytree(self._directory, path, dirs_exist_ok=True)
            return path
        data = self._data or {}
        # split array leaves out for efficient storage
        leaves, treedef = tree_flatten(data)
        if leaves and all(_is_tensor(x)
                          or isinstance(x, (np.ndarray, np.generic))
                          or hasattr(x, "__array__") for x in leaves):
            arrays = {str(i): np.asarray(x) for i, x in enumerate(leaves)
                      if not _is_tensor(x)}
            tensors = {str(i): _host(x) for i, x in enumerate(leaves)
                       if _is_tensor(x)}
            if arrays:
                np.savez(os.path.join(path, _ARRAYS), **arrays)
            if tensors:
                import torch

                torch.save(tensors, os.path.join(path, _TENSORS))
            with open(os.path.join(path, _META), "wb") as f:
                pickle.dump({"__treedef__": treedef}, f)
        else:
            with open(os.path.join(path, _META), "wb") as f:
                pickle.dump(data, f)
        return path

    def __repr__(self):
        src = "dict" if self._data is not None else self._directory
        return f"Checkpoint({src})"
