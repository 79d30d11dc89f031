"""ops/kernels/fused_attn and fused_ffn: the port's autograd.Functions
against the JAX package's custom_vjp blocks on the CPU, and the plain K3
against the reference's K3 Pallas kernel (interpret mode).

Same inputs from a seeded numpy generator on both sides, float32. The
outputs agree within 1e-5 and the gradients within 1e-4 (absolute and
relative): the two frameworks sum the matmuls in different orders, and the
port's attention core is the flash pair's plain version where the JAX block
takes its einsum reference on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ray_tpu.ops.layers import rotary_embedding
from ray_tpu.ops.pallas import fused_attn as jattn
from ray_tpu.ops.pallas import fused_ffn as jffn
from ray_tpu_torch.ops.kernels import fused_attn as tattn
from ray_tpu_torch.ops.kernels import fused_ffn as tffn

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

B, S, D, H, KV, DFF = 2, 32, 128, 4, 2, 256   # GQA n_rep 2, head_dim 32


def _rng(seed):
    return np.random.default_rng(seed)


def _attn_inputs():
    rng = _rng(0)
    hd = D // H
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
          for s in ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D))]
    cos, sin = rotary_embedding(jnp.arange(S), hd)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    return [x, nw, *ws, np.array(cos)[None], np.array(sin)[None]], dy


def _ffn_inputs(T=B * S, d=D, dff=DFF, seed=1):
    rng = _rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    wg = (rng.standard_normal((d, dff)) * d ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((d, dff)) * d ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((dff, d)) * dff ** -0.5).astype(np.float32)
    dy = rng.standard_normal((T, d)).astype(np.float32)
    return [x, nw, wg, wu, wd], dy


@functools.lru_cache(maxsize=None)
def _jax_block(which):
    """(output, grads) of the JAX block at the shared inputs (jitted)."""
    if which == "attn":
        args, dy = _attn_inputs()
        fn = functools.partial(jattn.attn_block, n_heads=H, n_kv_heads=KV)
    else:
        args, dy = _ffn_inputs()
        args[0] = args[0].reshape(B, S, D)
        dy = dy.reshape(B, S, D)
        fn = jffn.ffn_block

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(jnp.asarray(dy))

    y, grads = run(*(jnp.asarray(a) for a in args))
    return np.array(y), [np.array(g) for g in grads]


def _torch_block(fn, args, dy, **kw):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = fn(*leaves, **kw)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    return y.detach().numpy(), [g.numpy() for g in grads]


def test_attn_block_matches_jax_block():
    args, dy = _attn_inputs()
    y, grads = _torch_block(tattn.attn_block, args, dy, n_heads=H,
                            n_kv_heads=KV)
    want_y, want_grads = _jax_block("attn")
    np.testing.assert_allclose(y, want_y, **OUT_TOL)
    names = ("x", "norm_w", "wq", "wk", "wv", "wo", "cos", "sin")
    assert len(grads) == len(want_grads) == 8
    for g, w, name in zip(grads, want_grads, names):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)
    assert not grads[6].any() and not grads[7].any()  # cos/sin: zeros


def test_ffn_block_matches_jax_block():
    """The JAX block's backward runs its K3 Pallas kernel in interpret
    mode (USE_K3 = True) and XLA for the rest, as the port does."""
    args, dy = _ffn_inputs()
    args[0] = args[0].reshape(B, S, D)
    y, grads = _torch_block(tffn.ffn_block, args, dy.reshape(B, S, D))
    want_y, want_grads = _jax_block("ffn")
    np.testing.assert_allclose(y, want_y, **OUT_TOL)
    assert len(grads) == len(want_grads) == 5
    for g, w, name in zip(grads, want_grads,
                          ("x", "norm_w", "w_gate", "w_up", "w_down")):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def _reference_k3(x, rstd, nw, dgate, dup, bm, bn, bk):
    """The reference's K3 pallas_call as fused_ffn.py:264-285 launches it."""
    from jax.experimental.pallas import tpu as pltpu

    T, d = x.shape
    dff = dgate.shape[1]
    vmem = pltpu.VMEM
    return pl.pallas_call(
        jffn._dw_gateup_kernel,
        grid=(d // bm, dff // bn, T // bk),
        in_specs=[
            pl.BlockSpec((bk, bm), lambda i, j, k: (k, i), memory_space=vmem),
            pl.BlockSpec((bk, 1), lambda i, j, k: (k, 0), memory_space=vmem),
            pl.BlockSpec((1, bm), lambda i, j, k: (0, i), memory_space=vmem),
            pl.BlockSpec((bk, bn), lambda i, j, k: (k, j), memory_space=vmem),
            pl.BlockSpec((bk, bn), lambda i, j, k: (k, j), memory_space=vmem),
        ],
        out_specs=[
            pl.BlockSpec((bm, bn), lambda i, j, k: (i, j), memory_space=vmem),
            pl.BlockSpec((bm, bn), lambda i, j, k: (i, j), memory_space=vmem),
        ],
        out_shape=[jax.ShapeDtypeStruct((d, dff), dgate.dtype)] * 2,
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.float32)] * 2,
        interpret=True,
    )(x, rstd, nw.reshape(1, -1), dgate, dup)


def _k3_inputs(T, d, dff, seed):
    rng = _rng(seed)
    x, dgate, dup = (rng.standard_normal(s).astype(np.float32)
                     for s in ((T, d), (T, dff), (T, dff)))
    rstd = (0.5 + rng.random((T, 1))).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, rstd, nw, dgate, dup


def test_plain_k3_matches_reference_k3():
    """Tiles (bm, bn, bk) = (64, 128, 32) give the reference a 2x2x2 grid,
    so its accumulators carry across token blocks."""
    args = _k3_inputs(64, 128, 256, seed=2)
    want = _reference_k3(*(jnp.asarray(a) for a in args), 64, 128, 32)
    got = tffn.dw_gateup(*(torch.from_numpy(a) for a in args))
    for g, w, name in zip(got, want, ("dW_gate", "dW_up")):
        np.testing.assert_allclose(g.numpy(), np.array(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("T,d,dff", [(37, 72, 50), (100, 130, 200)])
def test_plain_k3_on_shapes_that_do_not_tile(T, d, dff):
    """No tiling guard on the port's side: float64 numpy is the truth."""
    x, rstd, nw, dgate, dup = _k3_inputs(T, d, dff, seed=3)
    h = (x * rstd * nw).astype(np.float64)
    got = tffn.dw_gateup(*(torch.from_numpy(a)
                           for a in (x, rstd, nw, dgate, dup)))
    for g, grad_out in zip(got, (dgate, dup)):
        assert g.shape == (d, dff)
        np.testing.assert_allclose(g.numpy(), h.T @ grad_out, **GRAD_TOL)


def test_ffn_block_bfloat16_stays_bfloat16():
    args, dy = _ffn_inputs(T=16, d=64, dff=96)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in args]
    y = tffn.ffn_block(*leaves)
    grads = torch.autograd.grad(y, leaves,
                                torch.from_numpy(dy).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert all(torch.isfinite(g.float()).all() for g in grads)
