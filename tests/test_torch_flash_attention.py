"""ops/kernels/flash_attention and ops/attention: the port's plain flash
versions against the reference's Pallas kernels, run in interpret mode on
the CPU as tests/test_pallas_kernels.py runs them, and the autograd.Function
against torch autograd through the reference einsum.

All in float32. Tolerance 2e-4 absolute and relative, the reference's own
for its kernels against its einsum: the port computes densely and the
kernels blockwise, so sums run in another order.
"""

import functools
import importlib

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

# (bh, sq, sk, d, causal, block_q, block_k): square, causal and not; a
# decode window sq != sk (4 vs 200); ragged key tails (50 with block 32,
# 150 with block 64 and sq 40)
CASES = [
    (2, 128, 128, 64, True, 64, 64),
    (2, 128, 128, 64, False, 64, 64),
    (2, 4, 200, 32, True, 4, 64),
    (1, 50, 50, 32, False, 32, 32),
    (1, 40, 150, 32, True, 32, 64),
]


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The Pallas forward and backward on CASES[case] (interpret mode)."""
    bh, sq, sk, d, causal, bq, bk = CASES[case]
    q, k, v, do = _inputs(bh, sq, sk, d, case)
    scale = d ** -0.5
    out, lse = jfa._flash_fwd(q, k, v, scale, causal, bq, bk)
    dq, dk, dv = jfa._flash_bwd(q, k, v, out, lse, do, scale, causal, bq, bk)
    return tuple(np.array(t) for t in (out, lse, dq, dk, dv))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_forward_matches_pallas_kernel(case):
    bh, sq, sk, d, causal, _, _ = CASES[case]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(bh, sq, sk, d, case))
    out, lse = tfa.flash_fwd(q, k, v, d ** -0.5, causal)
    want_out, want_lse = _reference(case)[:2]
    assert lse.shape == (bh, sq)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    # the reference broadcasts lse over 8 sublanes; sublane 0 is the row
    np.testing.assert_allclose(lse.numpy(), want_lse[:, 0, :], **TOL)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_backward_matches_pallas_kernels(case):
    bh, sq, sk, d, causal, _, _ = CASES[case]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(bh, sq, sk, d, case))
    out, lse, *want = _reference(case)
    got = tfa.flash_bwd(q, k, v, torch.from_numpy(out),
                        torch.from_numpy(lse[:, 0, :].copy()), do,
                        d ** -0.5, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(64, 64), (40, 150)])
def test_flash_autograd_matches_reference_autograd(causal, sq, sk):
    b, h, d = 2, 3, 32
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                            (b, h, sq, d)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.FlashAttention.apply(
        *(t.reshape(b * h, -1, d) for t in leaves), d ** -0.5,
        causal).reshape(b, h, sq, d)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.causal_attention_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad((ref * g).sum(), ref_leaves)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    for a, r, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(a.numpy(), r.numpy(), err_msg=f"d{name}",
                                   **TOL)


@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 23)])
def test_attention_matches_jax_attention(sq, sk):
    """ops.attention with GQA (8 query heads over 2 KV heads) on the CPU,
    where both packages take the reference einsum; float32 within 1e-5."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 8, sq, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 32)).astype(np.float32)
    got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_refuse_bad_shapes():
    q = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), 1.0)
    with pytest.raises(ValueError, match="dO"):
        tfa.flash_bwd_dq(q, q, q, torch.zeros(2, 7, 32), torch.zeros(2, 8),
                         torch.zeros(2, 8), 1.0)


def test_cpu_path_launches_nothing():
    before = [kern.launches for kern in tfa.KERNELS]
    q = torch.zeros(1, 8, 32)
    out, lse = tfa.flash_fwd(q, q, q, 1.0)
    tfa.flash_bwd(q, q, q, out, lse, q, 1.0)
    assert [kern.launches for kern in tfa.KERNELS] == before
