"""Query rows that see no key (causal attention with sq > sk: rows
r < sq - sk attend nothing). On the flash route they give out = 0, with
lse = -1e30 and a zero gradient, in the port's plain versions as in its
kernels. The reference's Pallas forward gives 0 there too wherever its
block skip covers those rows, which it does at sq 256, sk 128 with 128-row
blocks: query block 0 holds exactly the 128 rows that see no key, and its
only key block lies above the band. The einsum route
(`causal_attention_reference`, in both packages) gives the mean of V on
such rows instead; that difference is deliberate.

Inputs from numpy seeds, float32; tolerance 2e-4 absolute and relative, the
reference's own for its kernels against its einsum.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import \
    causal_attention_reference as jax_reference
from ray_tpu.ops.pallas import flash_attention as jfa
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops.kernels import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-4)
# (b, heads, kv heads, sq, sk, head_dim): the reference's blocks are 128 x
# 128, so its block skip covers rows 0-127, the ones that see no key
B, H, KV, SQ, SK, D = 1, 4, 2, 256, 128, 32
BLOCK = 128
NO_KEY = SQ - SK
LAYOUTS = ["bh", "packed"]


def _inputs(layout):
    """q, k, v, do in the layout's shapes: [b·h, s, d] (K/V repeated per
    query head) or [b, s, heads·d]."""
    rng = np.random.default_rng(17)
    q, do = (rng.standard_normal((B, SQ, H * D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, SK, KV * D)).astype(np.float32)
            for _ in range(2))
    if layout == "packed":
        return q, k, v, do

    def flat(x, n):
        s = x.shape[1]
        heads = x.reshape(B, s, n, D).transpose(0, 2, 1, 3)
        return np.ascontiguousarray(
            np.repeat(heads, H // n, axis=1).reshape(B * H, s, D))

    return flat(q, H), flat(k, KV), flat(v, KV), flat(do, H)


@functools.lru_cache(maxsize=None)
def _reference(layout):
    """The Pallas forward and backward (interpret mode): out, lse at
    sublane 0 as [b·h, sq] or [b, h, sq], dq, dk, dv."""
    q, k, v, do = _inputs(layout)
    scale = D ** -0.5
    if layout == "packed":
        out, lse = jfa._flash_fwd_packed(q, k, v, H, KV, scale, True, BLOCK,
                                         BLOCK)
        grads = jfa._flash_bwd_packed(q, k, v, out, lse, do, H, KV, scale,
                                      True, BLOCK, BLOCK)
        lse0 = np.array(lse).reshape(B, H, 8, SQ)[:, :, 0, :]
    else:
        out, lse = jfa._flash_fwd(q, k, v, scale, True, BLOCK, BLOCK)
        grads = jfa._flash_bwd(q, k, v, out, lse, do, scale, True, BLOCK,
                               BLOCK)
        lse0 = np.array(lse)[:, 0, :]
    return tuple(np.array(t) for t in (out, lse0, *grads))


def _no_key_rows(x):
    """The rows that see no key: [b·h, r, d] or [b, r, h·d], r < sq - sk."""
    return x[:, :NO_KEY]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_forward_matches_pallas_on_rows_with_no_key(layout):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(layout))
    scale = D ** -0.5
    if layout == "packed":
        out, lse = tfa.flash_fwd_packed_plain(q, k, v, H, KV, scale, True)
    else:
        out, lse = tfa.flash_fwd_plain(q, k, v, scale, True)
    want_out, want_lse = _reference(layout)[:2]
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    assert bool((_no_key_rows(out) == 0).all())
    assert np.all(_no_key_rows(want_out) == 0)
    rows = lse[..., :NO_KEY]
    assert bool((rows == -1e30).all()), rows
    # the rows that do see keys carry a real softmax
    assert bool(out[:, NO_KEY:].abs().amax() > 0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_backward_matches_pallas_on_rows_with_no_key(layout):
    """The plain dq/dk/dv, fed the Pallas out and lse, against the Pallas
    backward: p = 0 on masked entries on both sides, so the rows that see
    no key add nothing to dk/dv and get dq = 0."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(layout))
    out, lse, *want = _reference(layout)
    out, lse = torch.from_numpy(out), torch.from_numpy(
        np.ascontiguousarray(lse))
    scale = D ** -0.5
    if layout == "packed":
        got = tfa.flash_bwd_packed(q, k, v, out, lse, do, H, KV, scale, True)
    else:
        got = tfa.flash_bwd(q, k, v, out, lse, do, scale, True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    assert bool((_no_key_rows(got[0]) == 0).all())


def test_flash_autograd_gives_zero_and_zero_gradient_on_rows_with_no_key():
    """FlashAttention over [b·h, s, d]: out 0 on those rows, and a cotangent
    there moves no gradient (the function is constant on them)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs("bh"))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.FlashAttention.apply(*leaves, D ** -0.5, True)
    assert bool((out[:, :NO_KEY] == 0).all())
    g = torch.zeros_like(do)
    g[:, :NO_KEY] = do[:, :NO_KEY]
    grads = torch.autograd.grad((out * g).sum(), leaves)
    for grad, name in zip(grads, "qkv"):
        assert bool((grad == 0).all()), f"d{name}"


def test_einsum_route_gives_the_mean_of_v_on_rows_with_no_key():
    """causal_attention_reference (the port's and the JAX package's) spreads
    p evenly over every key where all are masked: the mean of V, where the
    flash route gives 0. Both packages agree with each other."""
    q, k, v, _ = _inputs("bh")
    q4, k4, v4 = (a.reshape(B, H, -1, D) for a in (q, k, v))
    got = tattn.causal_attention_reference(
        *(torch.from_numpy(a) for a in (q4, k4, v4)))
    want = np.asarray(jax_reference(jnp.asarray(q4), jnp.asarray(k4),
                                    jnp.asarray(v4)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    mean_v = np.broadcast_to(v4.mean(axis=2, keepdims=True),
                             (B, H, NO_KEY, D))
    np.testing.assert_allclose(got[:, :, :NO_KEY].numpy(), mean_v, **TOL)
    flash, _ = tfa.flash_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   D ** -0.5, True)
    np.testing.assert_allclose(
        flash.reshape(B, H, SQ, D)[:, :, NO_KEY:].numpy(),
        got[:, :, NO_KEY:].numpy(), **TOL)
