"""Numpy bridge between a parameter tree of the JAX package and the port.

Both packages use the same tree: nested dicts with the same leaf names, the
same layer-stacked `[L, ...]` shapes and `[in, out]` weight layout, and
`{"int8", "scale"}` leaves for w8a16 weights. The bridge moves leaves
bit for bit. A bfloat16 array from JAX arrives in numpy with the
`ml_dtypes` bfloat16 dtype, which `torch.from_numpy` rejects, so it travels
as its 16-bit pattern and is reinterpreted on the other side.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.models.transformer import ModelConfig
from ray_tpu_torch.ops.kernels._util import require_cuda


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.int16))  # owned, writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _bfloat16_numpy_dtype() -> np.dtype:
    try:
        return np.dtype("bfloat16")  # registered once ml_dtypes is imported
    except TypeError:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(
            _bfloat16_numpy_dtype())
    return t.numpy().copy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """A parameter tree of numpy (or JAX) arrays -> the same tree of torch
    tensors on `device`, leaf for leaf and bit for bit."""
    dev = require_cuda(device)
    emb = tree["embed"]
    emb_shape = tuple(np.shape(emb["int8"] if isinstance(emb, dict) else emb))
    if emb_shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed shape {emb_shape} does not match the config "
                         f"({cfg.vocab_size}, {cfg.d_model})")
    return _map(tree, lambda a: _to_tensor(a, dev))


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `params_from_jax`: torch tensors -> numpy arrays
    (bfloat16 tensors become ml_dtypes bfloat16 arrays with the same bits)."""
    return _map(params, _to_numpy)
