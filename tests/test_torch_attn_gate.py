"""The fused attention block's routing and the kernels' dtype contract, on
the CPU.

* `fused_attn.use_flash` is the reference's `_use_kernel` gate
  (ray_tpu/ops/pallas/fused_attn.py:42-43) on a CUDA tensor: the flash
  kernels at head_dim >= 128 and seq >= 128, the einsum route below; on the
  CPU the port keeps the flash pair's plain versions at every shape.
* The float32 `attn_block` at (head_dim 32, s 64) and (128, 128) against
  the JAX package's on the CPU, through each of the port's two routes (the
  einsum route forced by patching the gate): outputs within 1e-5,
  gradients within 1e-4 (another summation order).
* The flash and fused-FFN wrappers' operand checks take bfloat16 and
  float32 operands of one dtype and refuse float16 and mixed dtypes,
  without a card (the checks are plain functions of the tensors' dtypes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.layers import rotary_embedding
from ray_tpu.ops.pallas import fused_attn as jattn
from ray_tpu_torch.ops.kernels import flash_attention as fa
from ray_tpu_torch.ops.kernels import fused_attn as tattn
from ray_tpu_torch.ops.kernels import fused_ffn as ff

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,hd", [(64, 32), (128, 128), (127, 128),
                                  (128, 64), (2048, 128), (256, 256),
                                  (128, 96), (4096, 64)])
def test_use_flash_is_the_references_gate(monkeypatch, s, hd):
    """On a CUDA tensor the port routes as the reference does on the TPU
    (its `on_tpu()` taken as true); on the CPU it keeps the flash pair."""
    monkeypatch.setattr(jattn, "on_tpu", lambda: True)
    assert tattn.use_flash(s, hd, cuda=True) == jattn._use_kernel(s, hd)
    assert tattn.use_flash(s, hd, cuda=False)


def _inputs(B, S, hd, H, KV, seed=0):
    rng = np.random.default_rng(seed)
    D = H * hd
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
          for s in ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D))]
    cos, sin = rotary_embedding(jnp.arange(S), hd)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    return [x, nw, *ws, np.array(cos)[None], np.array(sin)[None]], dy


# (B, S, head_dim, heads, kv heads): GQA n_rep 2 at head_dim 32, n_rep 2 at
# head_dim 128 (the shape at which the card takes the flash kernels)
SHAPES = {"hd32_s64": (1, 64, 32, 4, 2), "hd128_s128": (1, 128, 128, 2, 1)}


@functools.lru_cache(maxsize=None)
def _jax_block(shape):
    B, S, hd, H, KV = SHAPES[shape]
    args, dy = _inputs(B, S, hd, H, KV)
    fn = functools.partial(jattn.attn_block, n_heads=H, n_kv_heads=KV)

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(jnp.asarray(dy))

    y, grads = run(*(jnp.asarray(a) for a in args))
    return np.array(y), [np.array(g) for g in grads]


@pytest.mark.parametrize("route", ["flash", "einsum"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_f32_attn_block_matches_jax_block(monkeypatch, shape, route):
    B, S, hd, H, KV = SHAPES[shape]
    if route == "einsum":  # the route a CUDA tensor takes below the gate
        monkeypatch.setattr(tattn, "use_flash", lambda s, hd, cuda: False)
    args, dy = _inputs(B, S, hd, H, KV)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = [k.launches for k in fa.KERNELS]
    y = tattn.attn_block(*leaves, n_heads=H, n_kv_heads=KV)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert [k.launches for k in fa.KERNELS] == before  # the CPU: no kernel
    want_y, want_grads = _jax_block(shape)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **OUT_TOL)
    names = ("x", "norm_w", "wq", "wk", "wv", "wo", "cos", "sin")
    for g, w, name in zip(grads, want_grads, names):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}",
                                   **GRAD_TOL)


def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operand_checks_take_bf16_and_f32(dtype):
    q = _zeros((2, 64, 128), dtype)
    fa._check_operands(q, q, q, 128, 2, 1, "flash_fwd")
    x, g = _zeros((8, 16), dtype), _zeros((8, 4), dtype)
    ff._require_dtype("dw_gateup", (x, _zeros(16, dtype), g, g))
    ff._require_dtype("dw_down", (g, g, x))


def test_operand_checks_refuse_float16_and_mixed_dtypes():
    q16 = _zeros((2, 64, 128), torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa._check_operands(q16, q16, q16, 128, 2, 1, "flash_fwd")
    q32 = _zeros((2, 64, 128), torch.float32)
    qb = _zeros((2, 64, 128), torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        fa._check_operands(q32, qb, qb, 128, 2, 1, "flash_fwd")
    # head_dim 320 runs the wide family (fault C.2 closed); 0 is refused
    fa._check_operands(q32, q32, q32, 320, 2, 1, "flash_fwd")
    q0 = _zeros((2, 64, 0), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_operands(q0, q0, q0, 0, 2, 1, "flash_fwd")
    x16 = _zeros((8, 16), torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ff._require_dtype("dw_gateup", (x16, x16, x16))
    with pytest.raises(TypeError, match="one dtype"):
        ff._require_dtype("dw_down", (_zeros((8, 4), torch.float32),
                                      _zeros((8, 4), torch.bfloat16)))
