"""The packed flash-attention entry (B5): the port's plain packed versions
against the reference's `_flash_fwd_packed`/`_flash_bwd_packed`, run in
interpret mode on the CPU as tests/test_pallas_kernels.py runs them; the
autograd entry `flash_attention_packed` against `jax.grad` of the
reference's; and `ops.attention_packed` against the JAX package's and
against the port's own `attention` modulo layout.

All in float32. Tolerance 2e-4 absolute and relative for the kernels, the
reference's own for its packed kernels against its einsum; 1e-5 where both
sides run the same einsum.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash_attention as jfa
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops.kernels import flash_attention as tfa

# the package re-exports the function `attention` under the module's name
jattn = importlib.import_module("ray_tpu.ops.attention")
TOL = dict(rtol=2e-4, atol=2e-4)
SAME = dict(rtol=1e-5, atol=1e-5)

# (b, heads, kv heads, sq, sk, d, causal, block_q, block_k): GQA n_rep 2;
# a ragged tail (80 with block 32); n_rep 1; n_rep 4; a decode window sq 4
# against sk 200; not causal
CASES = [
    (2, 4, 2, 96, 96, 32, True, 32, 32),
    (1, 4, 2, 80, 80, 32, True, 32, 32),
    (2, 2, 2, 64, 64, 32, True, 32, 32),
    (1, 8, 2, 64, 64, 32, True, 32, 32),
    (1, 4, 2, 4, 200, 32, True, 4, 64),
    (2, 4, 2, 96, 96, 32, False, 32, 32),
]


def _inputs(b, h, kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h * d), (b, sk, kv * d), (b, sk, kv * d),
                      (b, sq, h * d))]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The packed Pallas forward and backward on CASES[case] (interpret
    mode); lse at sublane 0 of its [b, 8·h, sq] broadcast."""
    b, h, kv, sq, sk, d, causal, bq, bk = CASES[case]
    q, k, v, do = _inputs(b, h, kv, sq, sk, d, case)
    scale = d ** -0.5
    out, lse = jfa._flash_fwd_packed(q, k, v, h, kv, scale, causal, bq, bk)
    dq, dk, dv = jfa._flash_bwd_packed(q, k, v, out, lse, do, h, kv, scale,
                                       causal, bq, bk)
    lse0 = np.array(lse).reshape(b, h, 8, sq)[:, :, 0, :]
    return tuple(np.array(t) for t in (out, lse0, dq, dk, dv))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_packed_forward_matches_pallas_kernel(case):
    b, h, kv, sq, sk, d, causal, _, _ = CASES[case]
    q, k, v, _ = _torch(*_inputs(b, h, kv, sq, sk, d, case))
    out, lse = tfa.flash_fwd_packed(q, k, v, h, kv, d ** -0.5, causal)
    want_out, want_lse = _reference(case)[:2]
    assert out.shape == (b, sq, h * d) and lse.shape == (b, h, sq)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_packed_backward_matches_pallas_kernels(case):
    """dk/dv sum each kv head's n_rep query heads, as the reference's dkv
    grid walks e = r·n_qb + i_q; Δ is the per-head row sum."""
    b, h, kv, sq, sk, d, causal, _, _ = CASES[case]
    q, k, v, do = _torch(*_inputs(b, h, kv, sq, sk, d, case))
    out, lse, *want = _reference(case)
    got = tfa.flash_bwd_packed(q, k, v, *_torch(out, lse), do, h, kv,
                               d ** -0.5, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_packed_delta_is_the_per_head_row_sum():
    rng = np.random.default_rng(5)
    o, do = (rng.standard_normal((2, 7, 3 * 16)).astype(np.float32)
             for _ in range(2))
    got = tfa.flash_delta_packed(*_torch(o, do), 3)
    want = (o * do).reshape(2, 7, 3, 16).sum(-1).transpose(0, 2, 1)
    assert got.shape == (2, 3, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 80])
def test_flash_attention_packed_grads_match_jax_grad(causal, s):
    b, h, kv, d = 2, 4, 2, 32
    q, k, v, g = _inputs(b, h, kv, s, s, d, 7)
    scale = d ** -0.5
    leaves = [t.requires_grad_(True) for t in _torch(q, k, v)]
    out = tfa.flash_attention_packed(*leaves, h, kv, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)

    def loss(q, k, v):
        o = jfa.flash_attention_packed(q, k, v, h, kv, scale, causal, 32,
                                       32, 32, 32)
        return jnp.sum(o * g), o

    (_, want_out), want = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for a, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("sq,sk,causal", [(16, 16, True), (5, 23, True),
                                          (12, 12, False)])
def test_attention_packed_matches_jax_attention_packed(sq, sk, causal):
    """ops.attention_packed with GQA (8 query heads over 2 KV heads) on the
    CPU, where both packages take the reference einsum through reshapes."""
    b, h, kv, d = 2, 8, 2, 32
    q, k, v, _ = _inputs(b, h, kv, sq, sk, d, 3)
    got = tattn.attention_packed(*_torch(q, k, v), n_heads=h, n_kv_heads=kv,
                                 causal=causal)
    want = jattn.attention_packed(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), n_heads=h, n_kv_heads=kv,
                                  causal=causal)
    assert got.shape == (b, sq, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)


def test_attention_packed_is_attention_modulo_layout():
    b, h, kv, s, d = 2, 4, 2, 64, 16
    q, k, v = _torch(*_inputs(b, h, kv, s, s, d, 4)[:3])
    out = tattn.attention_packed(q, k, v, n_heads=h, n_kv_heads=kv)

    def heads(t, n):
        return t.reshape(b, s, n, d).transpose(1, 2)

    ref = tattn.attention(heads(q, h), heads(k, kv), heads(v, kv))
    np.testing.assert_allclose(
        out.numpy(), ref.transpose(1, 2).reshape(b, s, h * d).numpy(),
        **SAME)


@pytest.mark.parametrize("q_width,n_heads,n_kv,k_width,match", [
    (30, 4, 2, 16, "packed width"),
    (32, 4, 3, 16, "packed width"),
    (32, 4, 2, 12, "k width"),
])
def test_flash_attention_packed_raises_the_references_errors(
        q_width, n_heads, n_kv, k_width, match):
    q = torch.zeros(1, 8, q_width)
    k = torch.zeros(1, 8, k_width)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_packed(q, k, k, n_heads, n_kv)


def test_packed_wrappers_refuse_bad_shapes():
    q, k = torch.zeros(1, 8, 4 * 32), torch.zeros(1, 8, 2 * 32)
    with pytest.raises(ValueError, match="heads"):
        tfa.flash_fwd_packed(q, k, k, 4, 3, 1.0)
    with pytest.raises(ValueError, match="dO"):
        tfa.flash_bwd_dq_packed(q, k, k, q, torch.zeros(1, 4, 7),
                                torch.zeros(1, 4, 8), 4, 2, 1.0)


def test_packed_cpu_path_launches_nothing():
    before = [kern.launches for kern in (*tfa.PACKED_KERNELS, *tfa.KERNELS)]
    q, k = torch.zeros(1, 8, 4 * 32), torch.zeros(1, 8, 2 * 32)
    out, lse = tfa.flash_fwd_packed(q, k, k, 4, 2, 1.0)
    tfa.flash_bwd_packed(q, k, k, out, lse, q, 4, 2, 1.0)
    assert [kern.launches for kern in (*tfa.PACKED_KERNELS,
                                       *tfa.KERNELS)] == before
