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


# ------------------------------------------------ K1 and K2 (fused_ffn.py)


def _reference_k1(gate, up, dy, bm, bk):
    """The reference's K1 pallas_call as fused_ffn.py:207-221 launches it,
    with (bm, bk) tiles: dW_down row blocks of bm, token blocks of bk."""
    from jax.experimental.pallas import tpu as pltpu

    T, dff = gate.shape
    d = dy.shape[1]
    vmem = pltpu.VMEM
    return pl.pallas_call(
        jffn._dw_down_kernel,
        grid=(dff // bm, T // bk),
        in_specs=[
            pl.BlockSpec((bk, bm), lambda i, k: (k, i), memory_space=vmem),
            pl.BlockSpec((bk, bm), lambda i, k: (k, i), memory_space=vmem),
            pl.BlockSpec((bk, d), lambda i, k: (k, 0), memory_space=vmem),
        ],
        out_specs=pl.BlockSpec((bm, d), lambda i, k: (i, 0),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((dff, d), dy.dtype),
        scratch_shapes=[pltpu.VMEM((bm, d), jnp.float32)],
        interpret=True,
    )(gate, up, dy)


def _reference_k2(dy, wd, gate, up, bm, bn, bk):
    """The reference's K2 pallas_call as fused_ffn.py:233-252 launches it."""
    from jax.experimental.pallas import tpu as pltpu

    T, d = dy.shape
    dff = wd.shape[0]
    vmem = pltpu.VMEM
    tile = pl.BlockSpec((bm, bn), lambda i, j, k: (i, j), memory_space=vmem)
    return pl.pallas_call(
        jffn._dgateup_kernel,
        grid=(T // bm, dff // bn, d // bk),
        in_specs=[
            pl.BlockSpec((bm, bk), lambda i, j, k: (i, k), memory_space=vmem),
            pl.BlockSpec((bn, bk), lambda i, j, k: (j, k), memory_space=vmem),
            tile, tile,
        ],
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((T, dff), gate.dtype)] * 2,
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.float32)],
        interpret=True,
    )(dy, wd, gate, up)


def _k12_inputs(T, d, dff, seed):
    rng = _rng(seed)
    gate, up = (rng.standard_normal((T, dff)).astype(np.float32)
                for _ in range(2))
    dy = rng.standard_normal((T, d)).astype(np.float32)
    wd = (rng.standard_normal((dff, d)) * dff ** -0.5).astype(np.float32)
    return gate, up, dy, wd


def test_plain_k1_matches_reference_k1():
    """Tiles (bm, bk) = (64, 32) give the reference a 2 x 2 grid, so its
    accumulator carries across token blocks."""
    gate, up, dy, _ = _k12_inputs(64, 48, 128, seed=4)
    want = _reference_k1(*(jnp.asarray(a) for a in (gate, up, dy)), 64, 32)
    got = tffn.dw_down(*(torch.from_numpy(a) for a in (gate, up, dy)))
    assert got.shape == (128, 48)
    np.testing.assert_allclose(got.numpy(), np.array(want), **GRAD_TOL)


def test_plain_k2_matches_reference_k2():
    """Tiles (bm, bn, bk) = (32, 64, 32) give a 2 x 2 x 2 grid: d_s carries
    across d blocks before the epilogue runs."""
    gate, up, dy, wd = _k12_inputs(64, 64, 128, seed=5)
    want = _reference_k2(*(jnp.asarray(a) for a in (dy, wd, gate, up)),
                         32, 64, 32)
    got = tffn.dgateup(*(torch.from_numpy(a) for a in (dy, wd, gate, up)))
    for g, w, name in zip(got, want, ("dgate", "dup")):
        np.testing.assert_allclose(g.numpy(), np.array(w), err_msg=name,
                                   **GRAD_TOL)


def _silu64(x):
    return x / (1.0 + np.exp(-x))


@pytest.mark.parametrize("T,d,dff", [(37, 72, 50), (100, 130, 200)])
def test_plain_k1_k2_on_shapes_that_do_not_tile(T, d, dff):
    """No tiling guard on the port's side: float64 numpy is the truth."""
    gate, up, dy, wd = _k12_inputs(T, d, dff, seed=6)
    g64, u64 = gate.astype(np.float64), up.astype(np.float64)
    dwd = tffn.dw_down(*(torch.from_numpy(a) for a in (gate, up, dy)))
    np.testing.assert_allclose(dwd.numpy(), (_silu64(g64) * u64).T @ dy,
                               **GRAD_TOL)
    dgate, dup = tffn.dgateup(*(torch.from_numpy(a)
                                for a in (dy, wd, gate, up)))
    ds = dy.astype(np.float64) @ wd.T.astype(np.float64)
    s = 1.0 / (1.0 + np.exp(-g64))
    np.testing.assert_allclose(dgate.numpy(), ds * u64 * s * (1 + g64 * (1 - s)),
                               **GRAD_TOL)
    np.testing.assert_allclose(dup.numpy(), ds * _silu64(g64), **GRAD_TOL)


FLAG_VARIANTS = [(True, False, True), (False, True, True), (True, True, False)]


def _set_flags(module, flags):
    old = (module.USE_K1, module.USE_K2, module.USE_K3)
    module.USE_K1, module.USE_K2, module.USE_K3 = flags
    return old


@functools.lru_cache(maxsize=None)
def _jax_ffn_with_flags(flags):
    """The JAX block's output and grads with its USE_K1/K2/K3 flags set as
    given (the flags are read while the backward is traced)."""
    args, dy = _ffn_inputs()
    args[0] = args[0].reshape(B, S, D)
    old = _set_flags(jffn, flags)
    try:
        y, vjp = jax.vjp(jffn.ffn_block, *(jnp.asarray(a) for a in args))
        grads = vjp(jnp.asarray(dy.reshape(B, S, D)))
    finally:
        _set_flags(jffn, old)
    return np.array(y), [np.array(g) for g in grads]


@pytest.mark.parametrize("flags", FLAG_VARIANTS)
def test_ffn_block_flag_variants_match_jax_block(flags):
    """The twin of test_fused_ffn_flag_variants_match_reference
    (tests/test_pallas_kernels.py:493-528): the same three flag tuples, the
    port's block against the reference's block under the same flags, the
    reference's tolerance (2e-4)."""
    args, dy = _ffn_inputs()
    args[0] = args[0].reshape(B, S, D)
    old = _set_flags(tffn, flags)
    try:
        y, grads = _torch_block(tffn.ffn_block, args, dy.reshape(B, S, D))
    finally:
        _set_flags(tffn, old)
    want_y, want_grads = _jax_ffn_with_flags(flags)
    np.testing.assert_allclose(y, want_y, rtol=2e-4, atol=2e-4)
    for g, w, name in zip(grads, want_grads,
                          ("x", "norm_w", "w_gate", "w_up", "w_down")):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{flags} d{name}")
