"""Int8 row-wise quantization (twin of ray_tpu/ops/pallas/quant.py).

Per-row absmax scales, round-half-even, used by w8a16 serving: the engine
quantizes every projection, the embedding and the LM head once at load
(`quantize_int8`), and every forward pass dequantizes each weight on read
(`dequantize_int8`). On a CUDA tensor each wrapper launches its hand-written
kernel (csrc/quant.cu) or raises; the plain PyTorch version beside it runs
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.kernels._util import check, load_library, stream_handle

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "rt_quantize_int8": ([_P, _INT, _P, _P, _I64, _I64, _P], _INT),
    "rt_dequantize_int8": ([_P, _P, _P, _INT, _INT, _I64, _I64, _P], _INT),
}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
# float32(1/127): the JAX reference's `/ 127.0` compiles to this multiply.
_INV_127 = 1.0 / 127.0


def _lib() -> ctypes.CDLL:
    return load_library("quant", _SIGNATURES)


def quantize_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the quant kernel (same arithmetic)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) * torch.tensor(
        _INV_127, dtype=torch.float32, device=x.device)
    values = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return values, scale


def dequantize_int8_plain(values: torch.Tensor, scales: torch.Tensor,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the dequant kernel."""
    return (values.float() * scales).to(dtype)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; the kernel needs a "
                         f"CUDA tensor (the plain version serves the CPU)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., d] float32/bfloat16 -> (int8 values [..., d], float32 scales
    [..., 1])."""
    if x.dtype not in _FLOAT_TYPES:
        raise TypeError(f"quantize_int8: dtype {x.dtype} not in {_FLOAT_TYPES}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"quantize_int8: needs a non-empty last axis, got "
                         f"shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    _check_device(x, "quantize_int8")
    d = x.shape[-1]
    rows = x.numel() // d
    values = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                         device=x.device)
    if rows:
        lib = _lib()
        check(lib, lib.rt_quantize_int8(
            x.data_ptr(), int(x.dtype == torch.bfloat16), values.data_ptr(),
            scales.data_ptr(), rows, d, stream_handle(x)), "quantize_int8")
        quantize_int8.launches += 1
    return values, scales


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(int8 [..., d], float32 [..., 1]) -> `dtype` [..., d]."""
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_int8: needs int8 values and float32 "
                        f"scales, got {values.dtype}, {scales.dtype}")
    if dtype not in _FLOAT_TYPES:
        raise TypeError(f"dequantize_int8: dtype {dtype} not in {_FLOAT_TYPES}")
    if values.dim() == 0 or scales.shape != (*values.shape[:-1], 1):
        raise ValueError(f"dequantize_int8: scales {tuple(scales.shape)} do "
                         f"not match values {tuple(values.shape)}")
    if values.device.type == "cpu" and scales.device.type == "cpu":
        return dequantize_int8_plain(values, scales, dtype)
    _check_device(values, "dequantize_int8")
    _check_device(scales, "dequantize_int8")
    if scales.device != values.device:
        raise ValueError("dequantize_int8: values and scales on different "
                         "devices")
    d = values.shape[-1]
    rows = values.numel() // d if d else 0
    out = torch.empty(values.shape, dtype=dtype, device=values.device)
    if rows:
        vectorized = (d % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (values, out)))
        lib = _lib()
        check(lib, lib.rt_dequantize_int8(
            values.data_ptr(), scales.data_ptr(), out.data_ptr(),
            int(dtype == torch.bfloat16), int(vectorized), rows, d,
            stream_handle(values)), "dequantize_int8")
        dequantize_int8.launches += 1
    return out


# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else (the CPU path launches nothing).
quantize_int8.launches = 0
dequantize_int8.launches = 0
KERNELS = (quantize_int8, dequantize_int8)
