"""ops/kernels/rmsnorm: the port's plain RMSNorm against the reference's
Pallas kernels (`ray_tpu/ops/pallas/rmsnorm.py`), run in interpret mode on
the CPU as tests/test_pallas_kernels.py runs them, and the port's autograd
Function against `jax.grad` of `rms_norm_pallas`.

Inputs come from a seeded numpy generator and go to both sides. float32
within 1e-5 (the port reduces each row in one sum, the reference in 256-row
blocks, so the last bits may differ); bfloat16 within one bf16 ulp (both
round the same float32 value once); gradients of sum(sin(norm)) within
1e-4, the reference's own tolerance (tests/test_pallas_kernels.py:20-33).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import rmsnorm as jrms
from ray_tpu_torch.ops.kernels import rmsnorm as trms

TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-3  # a non-default eps for the gradient test
# (leading shape + d): one that tiles the reference's 256-row blocks, and
# 300 rows (a ragged tail) of an odd d
SHAPES = [(4, 64, 256), (300, 130)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, g


_ref_fwd = jax.jit(jrms._run_fwd, static_argnums=2)


@functools.partial(jax.jit, static_argnums=3)
def _ref_vjp(x2d, w, g2d, eps):
    _, res = jrms._vjp_fwd(x2d, w, eps)
    return jrms._vjp_bwd(eps, res, g2d)


@jax.jit
def _ref_grad(x, w):
    return jax.grad(lambda x, w: jnp.sum(jnp.sin(jrms.rms_norm_pallas(
        x, w, EPS))), argnums=(0, 1))(x, w)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The Pallas forward and dx/dw on SHAPES[case] in float32."""
    x, w, g = _inputs(SHAPES[case], case)
    d = x.shape[-1]
    out, rstd = _ref_fwd(x.reshape(-1, d), w, 1e-5)
    dx, dw = _ref_vjp(x.reshape(-1, d), w, g.reshape(-1, d), 1e-5)
    return tuple(np.array(t) for t in (out, rstd, dx, dw))


def _launches():
    return [k.launches for k in trms.KERNELS]


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_plain_forward_matches_pallas_kernel(case):
    x, w, _ = _inputs(SHAPES[case], case)
    d = x.shape[-1]
    before = _launches()
    out, rstd = trms.rms_norm_fwd(torch.from_numpy(x.reshape(-1, d)),
                                  torch.from_numpy(w))
    assert _launches() == before  # the CPU launches nothing
    want_out, want_rstd, _, _ = _reference(case)
    assert out.dtype == torch.float32 and rstd.shape == (x.size // d,)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(rstd.numpy(), want_rstd[:, 0], **TOL)


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_plain_dx_and_dw_match_the_reference_vjp(case):
    x, w, g = _inputs(SHAPES[case], case)
    d = x.shape[-1]
    tx = torch.from_numpy(x.reshape(-1, d))
    tw = torch.from_numpy(w)
    tg = torch.from_numpy(g.reshape(-1, d))
    _, rstd = trms.rms_norm_fwd(tx, tw)
    _, _, want_dx, want_dw = _reference(case)
    np.testing.assert_allclose(trms.rms_norm_bwd_dx(tx, tw, rstd, tg).numpy(),
                               want_dx, **TOL)
    # the same through the autograd Function: dx from the kernel's plain
    # version, dw from the float32 reduction
    xr, wr = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    before = _launches()
    dx, dw = torch.autograd.grad(trms.RMSNorm.apply(xr, wr, 1e-5), (xr, wr),
                                 tg)
    assert _launches() == before
    np.testing.assert_allclose(dx.numpy(), want_dx, **TOL)
    np.testing.assert_allclose(dw.numpy(), want_dw, **TOL)


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 130)])
def test_autograd_matches_jax_grad_of_the_pallas_entry(shape):
    """d/dx and d/dw of sum(sin(rms_norm(x, w, eps))), eps 1e-3, against
    jax.grad through the reference's custom VJP."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want_dx, want_dw = _ref_grad(x, w)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = trms.rms_norm_fused(tx, tw, EPS)
    assert out.shape == shape
    dx, dw = torch.autograd.grad(torch.sin(out).sum(), (tx, tw))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-4,
                               atol=1e-4)


def _bf16_ulps(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_bfloat16_forward_within_one_ulp(shape):
    x, w, _ = _inputs(shape, 5)
    want = jrms.rms_norm_pallas(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(w, jnp.bfloat16))
    got = trms.rms_norm_fused(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert _bf16_ulps(got, want) <= 1.0


def test_bad_shapes_and_dtypes_raise():
    x = torch.zeros((4, 16))
    w = torch.ones(16)
    with pytest.raises(ValueError, match="w \\[d\\]"):
        trms.rms_norm_fwd(x, torch.ones(15))
    with pytest.raises(ValueError, match="w \\[d\\]"):
        trms.rms_norm_fwd(torch.zeros(16), w)
    with pytest.raises(ValueError, match="last axis"):
        trms.rms_norm_fused(torch.tensor(1.0), w)
    with pytest.raises(TypeError, match="x and w"):
        trms.rms_norm_fwd(x.half(), w)
    with pytest.raises(TypeError, match="x and w"):
        trms.rms_norm_fwd(x, w.long())
    rstd = torch.ones(4)
    with pytest.raises(ValueError, match="do not match"):
        trms.rms_norm_bwd_dx(x, w, rstd, torch.zeros((4, 15)))
    with pytest.raises(TypeError, match="float32"):
        trms.rms_norm_bwd_dx(x, w, rstd.double(), x)
    with pytest.raises(TypeError, match="float32"):
        trms.rms_norm_bwd_dx(x, w, rstd, x.bfloat16())
