"""Head dims up to 256 on the flash route, on the CPU.

* The flash plain versions at head_dim 96, 192 and 256 against the
  reference's Pallas kernels in interpret mode, which take any head_dim
  (ray_tpu/ops/pallas/flash_attention.py:104-137): float32 within 2e-4, the
  tolerance of tests/test_torch_flash_attention.py.
* The zero padding the CUDA wrappers apply before a launch (`pad_heads` to
  the next instantiated head_dim, `unpad_heads` after): padding, the plain
  version at the padded width, then slicing back gives the unpadded plain
  version's outputs bit for bit, in the [b·h, s, d] and the packed layout
  with GQA, because the padded columns add exact zeros to every score, to
  dO·Vᵀ and to Δ, and the caller's scale is kept.
* `_check_operands` takes head_dim 1 to 256 and refuses 320 and float16.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash_attention as jfa
from ray_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)

# (bh, sq, sk, d, causal, block_q, block_k): square and causal; a ragged
# key tail (100 with block 64) against 64 queries, not causal
CASES = [(hd, *case) for hd in (96, 192, 256)
         for case in ((2, 128, 128, True, 64, 64), (1, 64, 100, False, 32, 64))]


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The Pallas forward and backward on CASES[case] (interpret mode)."""
    d, bh, sq, sk, causal, bq, bk = CASES[case]
    q, k, v, do = _inputs(bh, sq, sk, d, case)
    scale = d ** -0.5
    out, lse = jfa._flash_fwd(q, k, v, scale, causal, bq, bk)
    dq, dk, dv = jfa._flash_bwd(q, k, v, out, lse, do, scale, causal, bq, bk)
    return tuple(np.array(t) for t in (out, lse, dq, dk, dv))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_forward_matches_pallas_at_wide_head_dims(case):
    d, bh, sq, sk, causal, _, _ = CASES[case]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(bh, sq, sk, d, case))
    out, lse = fa.flash_fwd(q, k, v, d ** -0.5, causal)
    want_out, want_lse = _reference(case)[:2]
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse[:, 0, :], **TOL)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_backward_matches_pallas_at_wide_head_dims(case):
    d, bh, sq, sk, causal, _, _ = CASES[case]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(bh, sq, sk, d, case))
    out, lse, *want = _reference(case)
    got = fa.flash_bwd(q, k, v, torch.from_numpy(out),
                       torch.from_numpy(lse[:, 0, :].copy()), do, d ** -0.5,
                       causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("d,kd", [(1, 32), (32, 32), (33, 64), (96, 128),
                                  (128, 128), (129, 256), (192, 256),
                                  (256, 256)])
def test_kernel_head_dim_is_the_next_instantiated_one(d, kd):
    assert fa.kernel_head_dim(d) == kd


def test_pad_heads_zero_fills_each_head():
    x = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(2, 3, 6)
    padded = fa.pad_heads(x, 2, 3, 5)  # two heads of 3 -> two heads of 5
    assert padded.shape == (2, 3, 10) and padded.is_contiguous()
    heads = padded.reshape(2, 3, 2, 5)
    assert torch.equal(heads[..., :3], x.reshape(2, 3, 2, 3))
    assert not heads[..., 3:].any()
    assert torch.equal(fa.unpad_heads(padded, 2, 3, 5), x)
    assert fa.pad_heads(x, 2, 3, 3) is x


def _rand(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,causal,sq,sk", [(1, True, 40, 40),
                                             (40, False, 33, 70),
                                             (96, True, 64, 64),
                                             (200, True, 20, 90)])
def test_padded_plain_versions_equal_unpadded(dtype, d, causal, sq, sk):
    """[b·h, s, d]: pad, the plain versions at the kernel's head_dim, slice
    back; equal to the plain versions at d, bit for bit."""
    bh = 3
    q, k, v, do = (_rand(s, dtype, i) for i, s in enumerate(
        ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))))
    kd, scale = fa.kernel_head_dim(d), d ** -0.5

    def pad(x):
        return fa.pad_heads(x, 1, d, kd)

    def unpad(x):
        return fa.unpad_heads(x, 1, d, kd)

    out, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    p_out, p_lse = fa.flash_fwd_plain(pad(q), pad(k), pad(v), scale, causal)
    delta = fa.flash_delta(out, do)
    assert torch.equal(fa.flash_delta(p_out, pad(do)), delta)
    bwd = (q, k, v, do, lse, delta, scale, causal)
    p_bwd = (pad(q), pad(k), pad(v), pad(do), lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv_plain(*bwd)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(*p_bwd)
    dq = fa.flash_bwd_dq_plain(*bwd)
    p_dq = fa.flash_bwd_dq_plain(*p_bwd)
    assert torch.equal(unpad(p_out), out) and torch.equal(p_lse, lse)
    for got, want, name in ((p_dk, dk, "dk"), (p_dv, dv, "dv"),
                            (p_dq, dq, "dq")):
        assert torch.equal(unpad(got), want), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [72, 160])
def test_padded_packed_plain_versions_equal_unpadded(dtype, d):
    """The packed layout with GQA (8 query heads over 2 kv heads): each
    head padded apart, the packed plain versions at the kernel's head_dim,
    sliced back; equal bit for bit."""
    b, h, kv, s = 2, 8, 2, 48
    q, do = (_rand((b, s, h * d), dtype, i) for i in (0, 3))
    k, v = (_rand((b, s, kv * d), dtype, i) for i in (1, 2))
    kd, scale = fa.kernel_head_dim(d), d ** -0.5
    qp, dop = (fa.pad_heads(t, h, d, kd) for t in (q, do))
    kp, vp = (fa.pad_heads(t, kv, d, kd) for t in (k, v))
    out, lse = fa.flash_fwd_packed_plain(q, k, v, h, kv, scale)
    p_out, p_lse = fa.flash_fwd_packed_plain(qp, kp, vp, h, kv, scale)
    assert torch.equal(fa.unpad_heads(p_out, h, d, kd), out)
    assert torch.equal(p_lse, lse)
    delta = fa.flash_delta_packed(out, do, h)
    assert torch.equal(fa.flash_delta_packed(p_out, dop, h), delta)
    dk, dv = fa.flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta, h, kv,
                                           scale)
    p_dk, p_dv = fa.flash_bwd_dkv_packed_plain(qp, kp, vp, dop, lse, delta,
                                               h, kv, scale)
    dq = fa.flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, h, kv, scale)
    p_dq = fa.flash_bwd_dq_packed_plain(qp, kp, vp, dop, lse, delta, h, kv,
                                        scale)
    assert torch.equal(fa.unpad_heads(p_dk, kv, d, kd), dk)
    assert torch.equal(fa.unpad_heads(p_dv, kv, d, kd), dv)
    assert torch.equal(fa.unpad_heads(p_dq, h, d, kd), dq)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 32, 40, 96, 128, 192, 255, 256])
def test_operand_checks_take_head_dims_up_to_256(dtype, d):
    q = torch.zeros((2, 8, d), dtype=dtype)
    fa._check_operands(q, q, q, d, 2, 1, "flash_fwd")


def test_operand_checks_refuse_320_and_float16():
    q = torch.zeros((2, 8, 320), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        fa._check_operands(q, q, q, 320, 2, 1, "flash_fwd")
    q16 = torch.zeros((2, 8, 256), dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa._check_operands(q16, q16, q16, 256, 2, 1, "flash_fwd")
