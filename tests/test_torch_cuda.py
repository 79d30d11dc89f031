"""The port on a CUDA device: the hand-written kernels against their plain
PyTorch versions, the engine's serving path through the quant kernels,
training steps through the flash, fused-FFN and AdamW kernels, and the
packed flash-attention, RMSNorm and cross-entropy entries through theirs.

Every test here needs a GPU and skips with a reason where there is none.
The file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ray_tpu_torch import ffnbench
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.models import ModelConfig, init_params
from ray_tpu_torch.models import inference, serving
from ray_tpu_torch.ops.attention import (attention, attention_packed,
                                         causal_attention_reference)
from ray_tpu_torch.ops.kernels import adamw as aw
from ray_tpu_torch.ops.kernels import flash_attention as fa
from ray_tpu_torch.ops.kernels import fused_ffn as ff
from ray_tpu_torch.ops.kernels import quant
from ray_tpu_torch.ops.kernels import rmsnorm as rms
from ray_tpu_torch.ops.kernels import xent
from ray_tpu_torch.ops.layers import rms_norm
from ray_tpu_torch.train import (default_optimizer, fused_adamw_optimizer,
                                 make_train_step)
from ray_tpu_torch.train.step import TrainState, global_norm

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    yield torch.device("cuda")
    # a test that checks for hidden synchronizations must not leave the
    # check on for the tests after it
    torch.cuda.set_sync_debug_mode(0)


def _input(shape, dtype, device, seed=0):
    x = (3 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0  # an all-zero row: the 1e-8 floor
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(300, 130), (3, 5, 64), (257, 1000),
                                   (7, 128256)])
def test_kernels_match_plain_versions(cuda, shape, dtype):
    x = _input(shape, dtype, cuda)
    before = [k.launches for k in quant.KERNELS]
    v, s = quant.quantize_int8(x)
    pv, ps = quant.quantize_int8_plain(x)
    out = quant.dequantize_int8(v, s, dtype)
    pout = quant.dequantize_int8_plain(v, s, dtype)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(s, ps)
    assert torch.equal(out, pout)
    assert [k.launches for k in quant.KERNELS] == [b + 1 for b in before]


def test_dequant_unaligned_rows_take_the_scalar_path(cuda):
    """A contiguous view whose start is not 16-byte aligned (d % 8 == 0)."""
    big = _input((9, 1000), torch.float32, cuda)
    v, s = quant.quantize_int8(big)
    vv, ss = v[1:], s[1:]
    assert vv.data_ptr() % 16 != 0
    out = quant.dequantize_int8(vv, ss, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out, quant.dequantize_int8_plain(vv, ss,
                                                        torch.bfloat16))


def test_wrappers_refuse_non_contiguous(cuda):
    x = _input((64, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_int8(x.T)


def test_w8a16_engine_goes_through_the_kernels(cuda):
    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0, device=cuda)
    qparams = serving.quantize_model_params(params, cfg)
    prompt = [5, 17, 400, 3]
    ref = inference.generate(qparams, torch.tensor([prompt], device=cuda,
                                                   dtype=torch.int32),
                             cfg, max_new_tokens=8, max_len=64)
    for k in quant.KERNELS:
        k.launches = 0
    eng = serving.ContinuousBatchingEngine(params, cfg, num_slots=2,
                                           max_len=64, quantize_weights=True,
                                           device=cuda)
    out = eng.generate(prompt, max_new_tokens=8)
    assert out == ref[0].tolist()
    assert quant.quantize_int8.launches == 9
    per_pass = 7 * cfg.n_layers + 2
    assert quant.dequantize_int8.launches == per_pass * (
        eng.prefill_calls + eng.decode_steps)


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_dispatch_never_waits_for_the_device(cuda, monkeypatch,
                                                    quantize):
    """Admission (host prompts to the device, batched prefill, the slot
    scatter) and the decode dispatch only queue device work: under
    torch.cuda.set_sync_debug_mode("error") a hidden stream synchronization,
    such as a copy from pageable host memory, raises. `_to_host`, the one
    intended wait, runs with the check off."""
    _dispatch_never_waits(cuda, monkeypatch, ModelConfig.tiny(), quantize)


@pytest.mark.parametrize("quantize", [False, True])
def test_moe_engine_dispatch_never_waits_for_the_device(cuda, monkeypatch,
                                                        quantize):
    """The same on a MoE model: the capacity comes from shapes and the
    routing stays on the device, so nothing in it waits either."""
    _dispatch_never_waits(cuda, monkeypatch, ModelConfig.tiny_moe(),
                          quantize)


def _dispatch_never_waits(cuda, monkeypatch, cfg, quantize):
    params = init_params(cfg, seed=0, device=cuda)
    eng = serving.ContinuousBatchingEngine(params, cfg, num_slots=4,
                                           max_len=64,
                                           quantize_weights=quantize,
                                           device=cuda)
    eng.generate([1, 2, 3], max_new_tokens=3)  # warm-up: lazy inits, caches
    to_host = serving.ContinuousBatchingEngine._to_host

    def unchecked(pending):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return to_host(pending)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(eng, "_to_host", unchecked, raising=False)
    prompts = [[5, 17, 400, 3], list(range(9, 29)), [7, 8]]  # two buckets
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    steps = eng.prefill_calls, eng.decode_steps
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.prefill_calls == steps[0] + 2
    assert eng.decode_steps == steps[1] + 3
    eng.run_until_done()
    for rid, p in zip(rids, prompts):
        assert len(eng.result(rid)) == len(p) + 5


# bf16 kernels against plain versions that compute in float32 from the same
# bf16 inputs: bf16 output rounding is ~4e-3 relative and the sums run in
# another order, so max abs error / max abs plain value < 1e-2.
REL_TOL = 1e-2


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _bf16(shape, device, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                     dtype=torch.bfloat16)


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (3, 64, 64, 32, True), (2, 50, 50, 64, False), (2, 40, 150, 32, True),
    (2, 4, 200, 128, True), (3, 130, 130, 128, True), (2, 100, 77, 64, False),
])
def test_flash_kernels_match_plain_versions(cuda, bh, sq, sk, d, causal):
    q, k, v, do = (_bf16(s, cuda, i) for i, s in enumerate(
        ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))))
    scale = d ** -0.5
    before = [kern.launches for kern in fa.KERNELS]
    out, lse = fa.flash_fwd(q, k, v, scale, causal)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = fa.flash_delta(p_out, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, p_lse, delta, scale, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, p_lse, delta, scale, causal)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, scale,
                                        causal)
    p_dq = fa.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (bh, sq)
    for got, want, name in ((out, p_out, "out"), (lse, p_lse, "lse"),
                            (dq, p_dq, "dq"), (dk, p_dk, "dk"),
                            (dv, p_dv, "dv")):
        assert _rel_err(got, want) < REL_TOL, name
    assert [kern.launches for kern in fa.KERNELS] == [b + 1 for b in before]


@pytest.mark.parametrize("T,d,dff", [(64, 128, 256), (1000, 200, 328),
                                     (37, 130, 50), (100, 72, 200)])
def test_k3_kernel_matches_plain_version(cuda, T, d, dff):
    x, dgate, dup = (_bf16(s, cuda, i) for i, s in enumerate(
        ((T, d), (T, dff), (T, dff))))
    rstd = torch.rand((T, 1), device=cuda) + 0.5
    nw = _bf16((d,), cuda, 5, 0.1) + 1
    before = ff.dw_gateup.launches
    dwg, dwu = ff.dw_gateup(x, rstd, nw, dgate, dup)
    p_dwg, p_dwu = ff.dw_gateup_plain(x, rstd, nw, dgate, dup)
    torch.cuda.synchronize()
    assert dwg.shape == dwu.shape == (d, dff)
    assert _rel_err(dwg, p_dwg) < REL_TOL
    assert _rel_err(dwu, p_dwu) < REL_TOL
    assert ff.dw_gateup.launches == before + 1


def test_new_kernels_refuse_float32_and_odd_head_dims(cuda):
    """The kernels take bfloat16 and float32 (both of one dtype); float16,
    mixed dtypes and head dims above 256 raise."""
    q = torch.zeros((2, 64, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_fwd(q, q, q, 1.0)
    q32 = torch.zeros((2, 64, 64), device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_fwd(q32, q32.bfloat16(), q32.bfloat16(), 1.0)
    q16 = torch.zeros((2, 64, 320), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q16, q16, q16, 1.0)
    x = torch.zeros((8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ff.dw_gateup(x, torch.ones((8, 1), device=cuda),
                     torch.ones(16, device=cuda, dtype=torch.float16),
                     torch.zeros((8, 4), device=cuda, dtype=torch.float16),
                     torch.zeros((8, 4), device=cuda, dtype=torch.float16))
    with pytest.raises(TypeError, match="one dtype"):
        ff.dw_down(torch.zeros((8, 4), device=cuda),
                   torch.zeros((8, 4), device=cuda),
                   torch.zeros((8, 16), device=cuda, dtype=torch.bfloat16))


def test_attention_dispatches_to_flash_on_the_card(cuda):
    """head_dim >= 128 and seq >= 128 (the reference's gate): the flash
    pair, forward and backward, against autograd through the einsum."""
    q = _bf16((1, 4, 128, 128), cuda, 0).requires_grad_(True)
    k = _bf16((1, 2, 128, 128), cuda, 1).requires_grad_(True)
    v = _bf16((1, 2, 128, 128), cuda, 2).requires_grad_(True)
    g = _bf16((1, 4, 128, 128), cuda, 3)
    before = [kern.launches for kern in fa.KERNELS]
    out = attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert [kern.launches for kern in fa.KERNELS] == [b + 1 for b in before]
    ref = causal_attention_reference(
        q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1))
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    assert _rel_err(out, ref) < 2e-2
    for a, b in zip(grads, ref_grads):
        assert _rel_err(a, b) < 2e-2


# `tiny` widened to head_dim 128 (d_model 256, 2 heads, 1 kv head) and
# trained at s 128: the shapes at which the fused attention block takes the
# flash kernels (the reference's gate); at tiny's own head_dim 32 it takes
# the einsum route.
TINY_HD128 = dict(d_model=256, n_heads=2, n_kv_heads=1)


def test_tiny_bf16_training_steps_go_through_the_kernels(cuda):
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16,
                              fused_ffn=True, fused_attn=True, **TINY_HD128)
    step_fn, init_fn = make_train_step(
        cfg, default_optimizer(1e-3, warmup_steps=1), device=cuda)
    state = init_fn(0)
    batch = make_batch(cfg, 2, 128, 1, cuda)
    kernels = (*fa.KERNELS, ff.dw_gateup)
    losses = []
    for _ in range(3):
        for kern in kernels:
            kern.launches = 0
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
        assert [kern.launches for kern in kernels] == [cfg.n_layers] * 4
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.opt_state.mu["embed"].dtype == torch.float32
    assert state.opt_state.nu["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("T,d,dff", [(37, 130, 50), (1000, 200, 328)])
def test_k1_k2_kernels_match_plain_versions(cuda, T, d, dff):
    gate, up = _bf16((T, dff), cuda, 0), _bf16((T, dff), cuda, 1)
    dy = _bf16((T, d), cuda, 2, 0.1)
    wd = _bf16((dff, d), cuda, 3, dff ** -0.5)
    before = [k.launches for k in ff.KERNELS]
    dwd = ff.dw_down(gate, up, dy)
    dgate, dup = ff.dgateup(dy, wd, gate, up)
    p_dwd = ff.dw_down_plain(gate, up, dy)
    p_dgate, p_dup = ff.dgateup_plain(dy, wd, gate, up)
    torch.cuda.synchronize()
    assert dwd.shape == (dff, d) and dgate.shape == dup.shape == (T, dff)
    for got, want in ((dwd, p_dwd), (dgate, p_dgate), (dup, p_dup)):
        assert _rel_err(got, want) < REL_TOL
    assert [k.launches for k in ff.KERNELS] == [before[0], before[1] + 1,
                                                before[2] + 1]


def _adamw_leaf(n, device, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    p, g = (torch.from_numpy((s * rng.standard_normal(n)).astype(np.float32))
            .to(device=device, dtype=dtype) for s in (0.02, 1e-2))
    mu = torch.from_numpy((1e-3 * rng.standard_normal(n)).astype(
        np.float32)).to(device)
    nu = torch.from_numpy((1e-5 * rng.random(n)).astype(np.float32)).to(
        device)
    return p, g, mu, nu


@pytest.mark.parametrize("n,dtype", [(1000003, torch.bfloat16),
                                     (13, torch.bfloat16),
                                     (4099, torch.float32)])
def test_adamw_kernel_equals_plain_version_bitwise(cuda, n, dtype):
    """In place, at sizes that are not a multiple of 8 (the scalar tail),
    and from an unaligned start (the scalar path for the whole leaf)."""
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    c1, c2 = aw.bias_correction(0.9, 4), aw.bias_correction(0.95, 4)
    clip = torch.tensor(0.37, device=cuda)
    for start in (0, 1):
        p, g, mu, nu = (t[start:] for t in _adamw_leaf(n, cuda, start, dtype))
        want = [t.clone() for t in (p, mu, nu)]
        before = aw.adamw_update.launches
        aw.adamw_update(p, g, mu, nu, 3e-4, clip, c1, c2, **hyper)
        aw.adamw_update_plain(want[0], g, want[1], want[2], 3e-4, clip, c1,
                              c2, **hyper)
        torch.cuda.synchronize()
        assert aw.adamw_update.launches == before + 1
        for got, ref in zip((p, mu, nu), want):
            assert torch.equal(got.view(torch.int16) if got.dtype ==
                               torch.bfloat16 else got,
                               ref.view(torch.int16) if ref.dtype ==
                               torch.bfloat16 else ref)


def test_fused_adamw_apply_never_waits_for_the_device(cuda):
    """The clip factor stays on the device and the count on the host:
    under torch.cuda.set_sync_debug_mode("error") a hidden synchronization
    raises."""
    opt = fused_adamw_optimizer(1e-3, warmup_steps=1)
    params = {"w": _adamw_leaf(4096 * 3 + 5, cuda, 0)[0],
              "b": _adamw_leaf(64, cuda, 1)[0]}
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    state = opt.init(params)
    gn = global_norm(grads)
    before = aw.adamw_update.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state = opt.apply(grads, state, params, gn)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.count == 2 and aw.adamw_update.launches == before + 4
    assert torch.isfinite(params["w"].float()).all()


def test_tiny_all_kernel_training_steps_go_through_the_kernels(cuda):
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16,
                              fused_ffn=True, fused_attn=True, **TINY_HD128)
    step_fn, init_fn = make_train_step(
        cfg, fused_adamw_optimizer(1e-3, warmup_steps=1), device=cuda)
    state = init_fn(0)
    batch = make_batch(cfg, 2, 128, 1, cuda)
    kernels = (*fa.KERNELS, *ff.KERNELS, aw.adamw_update)
    old = ff.USE_K1, ff.USE_K2
    ff.USE_K1 = ff.USE_K2 = True
    losses = []
    try:
        for _ in range(3):
            for kern in kernels:
                kern.launches = 0
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            assert np.isfinite(float(metrics["grad_norm"]))
            assert [kern.launches for kern in kernels] == \
                [cfg.n_layers] * 6 + [12]
    finally:
        ff.USE_K1, ff.USE_K2 = old
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.opt_state.nu["embed"].dtype == torch.float32


# RMSNorm and cross-entropy: float32 outputs within 1e-5 of the plain
# output's largest magnitude (another summation order), bfloat16 outputs
# within REL_TOL (one rounding of nearly equal float32 values), and the row
# statistics rstd, loss and lse within 2e-5 of each value.
F32_TOL = 1e-5
STAT_TOL = 2e-5


def _stat_ok(got, want):
    return bool(((got - want).abs() <= STAT_TOL * want.abs()).all())


def _randn(shape, device, dtype, seed, scale=1.0, shift=0.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                     dtype=dtype)


@pytest.mark.parametrize("wdtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(300, 130), (8, 4096), (5, 1000),
                                   (3, 7)])
def test_rmsnorm_kernels_match_plain_versions(cuda, shape, dtype, wdtype):
    """d = 130 and 7 take the scalar path, 4096 and 1000 the 16-byte one;
    x and w in every pairing of float32 and bfloat16."""
    x = _randn(shape, cuda, dtype, 0, 2.0)
    w = _randn(shape[-1:], cuda, wdtype, 1, 0.1, 1.0)
    g = _randn(shape, cuda, dtype, 2)
    before = [k.launches for k in rms.KERNELS]
    out, rstd = rms.rms_norm_fwd(x, w, 1e-5)
    p_out, p_rstd = rms.rms_norm_fwd_plain(x, w, 1e-5)
    dx = rms.rms_norm_bwd_dx(x, w, p_rstd, g)
    p_dx = rms.rms_norm_bwd_dx_plain(x, w, p_rstd, g)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else REL_TOL
    assert out.dtype == dx.dtype == dtype and rstd.shape == shape[:1]
    assert _rel_err(out, p_out) < tol and _rel_err(dx, p_dx) < tol
    assert _stat_ok(rstd, p_rstd)
    assert [k.launches for k in rms.KERNELS] == [b + 1 for b in before]


def test_rmsnorm_unaligned_rows_take_the_scalar_path(cuda):
    """A contiguous view whose start is 4 bytes past a 16-byte boundary."""
    flat = _randn((6 * 1000 + 1,), cuda, torch.float32, 0)
    x = flat[1:].view(6, 1000)
    assert x.data_ptr() % 16 != 0
    w = _randn((1000,), cuda, torch.float32, 1, 0.1, 1.0)
    out, rstd = rms.rms_norm_fwd(x, w)
    p_out, p_rstd = rms.rms_norm_fwd_plain(x, w, 1e-5)
    dx = rms.rms_norm_bwd_dx(x, w, p_rstd, x)
    torch.cuda.synchronize()
    assert _rel_err(out, p_out) < F32_TOL and _stat_ok(rstd, p_rstd)
    assert _rel_err(dx, rms.rms_norm_bwd_dx_plain(x, w, p_rstd, x)) < F32_TOL


def _labels(n, v, device, seed):
    """Labels in [0, V), every fourth -1 and the last one V (past the
    vocabulary: treated as negative)."""
    lab = np.random.default_rng(seed).integers(0, v, n).astype(np.int32)
    lab[::4] = -1
    lab[-1] = v
    return torch.from_numpy(lab).to(device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,v", [(37, 3000), (300, 2100), (5, 128256),
                                 (4, 13), (2, 1)])
def test_xent_kernels_match_plain_versions(cuda, n, v, dtype):
    logits = _randn((n, v), cuda, dtype, 0, 2.0)
    labels = _labels(n, v, cuda, 1)
    g = _randn((n,), cuda, torch.float32, 2)
    before = [k.launches for k in xent.KERNELS]
    loss, lse = xent.xent_fwd(logits, labels)
    p_loss, p_lse = xent.xent_fwd_plain(logits, labels)
    dx = xent.xent_bwd(logits, labels, p_lse, g)
    p_dx = xent.xent_bwd_plain(logits, labels, p_lse, g)
    torch.cuda.synchronize()
    assert loss.dtype == lse.dtype == torch.float32 and dx.dtype == dtype
    assert _stat_ok(loss, p_loss) and _stat_ok(lse, p_lse)
    tol = F32_TOL if dtype == torch.float32 else REL_TOL
    assert _rel_err(dx, p_dx) < tol
    assert [k.launches for k in xent.KERNELS] == [b + 1 for b in before]


def test_rmsnorm_and_xent_autograd_on_the_card(cuda):
    """rms_norm_fused against autograd through ops.layers.rms_norm, and
    softmax_cross_entropy against autograd through logsumexp, with int64
    labels and ignored rows."""
    x = _randn((2, 50, 136), cuda, torch.bfloat16, 0).requires_grad_(True)
    w = _randn((136,), cuda, torch.bfloat16, 1, 0.1, 1.0).requires_grad_(True)
    g = _randn((2, 50, 136), cuda, torch.bfloat16, 2)
    before = [k.launches for k in (*rms.KERNELS, *xent.KERNELS)]
    out = rms.rms_norm_fused(x, w)
    grads = torch.autograd.grad(out, (x, w), g)
    ref = rms_norm(x, w)
    ref_grads = torch.autograd.grad(ref, (x, w), g)
    assert _rel_err(out, ref) < REL_TOL
    for a, b in zip(grads, ref_grads):
        assert a.dtype == torch.bfloat16 and _rel_err(a, b) < REL_TOL

    logits = _randn((37, 3000), cuda, torch.float32, 3).requires_grad_(True)
    labels = _labels(37, 3000, cuda, 4).long()
    wts = _randn((37,), cuda, torch.float32, 5)
    loss = xent.softmax_cross_entropy(logits, labels)
    (dl,) = torch.autograd.grad((loss * wts).sum(), logits)
    valid = (labels >= 0) & (labels < 3000)
    tgt = logits.gather(1, labels.clamp(0, 2999)[:, None])[:, 0]
    ref = torch.logsumexp(logits, -1) - torch.where(valid, tgt, 0.0)
    (ref_dl,) = torch.autograd.grad((ref * wts).sum(), logits)
    assert _rel_err(loss, ref) < F32_TOL and _rel_err(dl, ref_dl) < F32_TOL
    assert [k.launches for k in (*rms.KERNELS, *xent.KERNELS)] == \
        [b + 1 for b in before]


def test_norm_and_xent_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((8, 16), device=cuda)
    w = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rms.rms_norm_fwd(x.t(), torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        rms.rms_norm_fwd(x, w.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        rms.rms_norm_bwd_dx(x, w, torch.ones(8), x)
    logits = torch.zeros((16, 8), device=cuda)
    labels = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        xent.xent_fwd(logits.t().contiguous().t(), labels)
    with pytest.raises(ValueError, match="one CUDA device"):
        xent.xent_fwd(logits, labels.cpu())
    with pytest.raises(TypeError, match="int32"):
        xent.xent_fwd(logits, labels.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        xent.xent_bwd(logits, labels, torch.zeros(16), torch.zeros(16))


def test_xent_bf16_past_two_to_the_31_elements(cuda):
    """16800 x 128256 bf16 logits, 2.15e9 elements: the last rows lie past
    2^31 elements, so a 32-bit offset would read the wrong rows there."""
    n, v = 16800, 128256
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    logits = torch.randn((n, v), generator=gen, device=cuda,
                         dtype=torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=gen, device=cuda,
                           dtype=torch.int32)
    labels[-3] = -1
    g = torch.rand((n,), generator=gen, device=cuda)
    loss, lse = xent.xent_fwd(logits, labels)
    dx = xent.xent_bwd(logits, labels, lse, g)
    for rows in (slice(0, 64), slice(n - 64, n)):
        p_loss, p_lse = xent.xent_fwd_plain(logits[rows], labels[rows])
        p_dx = xent.xent_bwd_plain(logits[rows], labels[rows], lse[rows],
                                   g[rows])
        torch.cuda.synchronize()
        assert _stat_ok(loss[rows], p_loss) and _stat_ok(lse[rows], p_lse)
        assert _rel_err(dx[rows], p_dx) < REL_TOL


def _heads(x, n):
    """[b, s, n·d] -> [b, n, s, d]."""
    b, s, width = x.shape
    return x.view(b, s, n, width // n).transpose(1, 2)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (2, 4, 2, 128, 128, 64, True), (1, 8, 2, 200, 200, 128, True),
    (1, 2, 2, 64, 300, 64, True), (1, 4, 1, 130, 130, 32, False),
])
def test_packed_flash_kernels_match_plain_versions(cuda, b, h, kv, sq, sk,
                                                   d, causal):
    q, k, v, do = (_bf16(s, cuda, i) for i, s in enumerate(
        ((b, sq, h * d), (b, sk, kv * d), (b, sk, kv * d), (b, sq, h * d))))
    scale = d ** -0.5
    before = [kern.launches for kern in fa.PACKED_KERNELS]
    out, lse = fa.flash_fwd_packed(q, k, v, h, kv, scale, causal)
    p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, h, kv, scale, causal)
    delta = fa.flash_delta_packed(p_out, do, h)
    dk, dv = fa.flash_bwd_dkv_packed(q, k, v, do, p_lse, delta, h, kv, scale,
                                     causal)
    dq = fa.flash_bwd_dq_packed(q, k, v, do, p_lse, delta, h, kv, scale,
                                causal)
    p_dk, p_dv = fa.flash_bwd_dkv_packed_plain(q, k, v, do, p_lse, delta, h,
                                               kv, scale, causal)
    p_dq = fa.flash_bwd_dq_packed_plain(q, k, v, do, p_lse, delta, h, kv,
                                        scale, causal)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert dk.shape == dv.shape == (b, sk, kv * d)
    for got, want, name in ((out, p_out, "out"), (lse, p_lse, "lse"),
                            (dq, p_dq, "dq"), (dk, p_dk, "dk"),
                            (dv, p_dv, "dv")):
        assert _rel_err(got, want) < REL_TOL, name
    assert [kern.launches for kern in fa.PACKED_KERNELS] == [
        n + 1 for n in before]


def test_packed_kernels_equal_the_unpacked_kernels_per_head(cuda):
    """The same kernel bodies over strided heads: the forward and dq equal
    the [b·h, s, d] route bit for bit, dk/dv agree to bf16 rounding (the
    packed kernel sums the n_rep heads in float32, the other route rounds
    each head's share first)."""
    b, h, kv, s, d = 2, 4, 2, 192, 128
    q, k, v, do = (_bf16(shape, cuda, i) for i, shape in enumerate(
        ((b, s, h * d), (b, s, kv * d), (b, s, kv * d), (b, s, h * d))))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_packed(q, k, v, h, kv, scale)
    delta = fa.flash_delta_packed(out, do, h)
    dk, dv = fa.flash_bwd_dkv_packed(q, k, v, do, lse, delta, h, kv, scale)
    dq = fa.flash_bwd_dq_packed(q, k, v, do, lse, delta, h, kv, scale)

    def flat(x, n):  # [b, s, n·d] -> [b·h, s, d], heads repeated to h
        x = _heads(x, n)
        return x.repeat_interleave(h // n, 1).reshape(b * h, s, d)

    q3, k3, v3, do3 = flat(q, h), flat(k, kv), flat(v, kv), flat(do, h)
    out3, lse3 = fa.flash_fwd(q3, k3, v3, scale)
    rows = (lse.view(b * h, s), delta.view(b * h, s))
    dk3, dv3 = fa.flash_bwd_dkv(q3, k3, v3, do3, *rows, scale)
    dq3 = fa.flash_bwd_dq(q3, k3, v3, do3, *rows, scale)
    torch.cuda.synchronize()
    assert torch.equal(flat(out, h), out3)
    assert torch.equal(lse.view(b * h, s), lse3)
    assert torch.equal(flat(dq, h), dq3)
    for got, want in ((dk, dk3), (dv, dv3)):
        summed = want.float().view(b, kv, h // kv, s, d).sum(2)
        assert _rel_err(_heads(got, kv), summed) < REL_TOL


def test_attention_packed_matches_attention_on_the_card(cuda):
    """The packed entry and the B1/B2 route on the same heads, forward and
    backward, and one launch of each packed kernel."""
    b, h, kv, s, d = 1, 4, 2, 256, 128
    q = _bf16((b, s, h * d), cuda, 0).requires_grad_(True)
    k = _bf16((b, s, kv * d), cuda, 1).requires_grad_(True)
    v = _bf16((b, s, kv * d), cuda, 2).requires_grad_(True)
    g = _bf16((b, s, h * d), cuda, 3)
    before = [kern.launches for kern in fa.PACKED_KERNELS]
    out = attention_packed(q, k, v, n_heads=h, n_kv_heads=kv)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert [kern.launches for kern in fa.PACKED_KERNELS] == [
        n + 1 for n in before]
    ref = attention(_heads(q, h), _heads(k, kv), _heads(v, kv))
    ref = ref.transpose(1, 2).reshape(b, s, h * d)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    assert _rel_err(out, ref) < REL_TOL
    for a, r in zip(grads, ref_grads):
        assert _rel_err(a, r) < REL_TOL


def test_packed_entry_refuses_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 128, 4 * 128), device=cuda, dtype=torch.float16)
    k = torch.zeros((1, 128, 2 * 128), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd_packed(q, k, k, 4, 2, 1.0)
    q16 = torch.zeros((1, 128, 2 * 320), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_packed(q16, q16, q16, n_heads=2, n_kv_heads=2)
    wide = torch.zeros((1, 128, 3 * 4 * 64), device=cuda,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_packed(wide[..., :256], wide[..., :256],
                            wide[..., :256], 4, 4, 1.0)
    with pytest.raises(ValueError, match="n_kv_heads"):
        fa.flash_attention_packed(q16, q16[..., :100], q16[..., :100], 2, 2)


# ------------------------------------------------ float32 and the redesign
#
# float32 kernels against their plain versions on the same float32 inputs:
# both compute in full float32 (CUDA-core FMAs in the kernels; the plain
# versions' matmuls with TF32 off, set below), summed in another order, so
# max abs error / max abs plain value < 1e-4.
F32_KERNEL_TOL = 1e-4


@pytest.fixture
def no_tf32(cuda):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = old


def _f32(shape, device, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,tile", [
    (2, 4, 1, 128, 128, 128, True, 16), (1, 2, 2, 64, 300, 64, True, 16),
    (1, 4, 1, 130, 130, 32, False, 16), (1, 8, 2, 200, 200, 128, True, 16),
    (1, 4, 2, 192, 192, 256, True, 16), (1, 4, 2, 192, 192, 200, True, 16),
    (2, 8, 2, 512, 512, 128, True, 64), (1, 16, 4, 520, 520, 64, True, 64),
    (4, 4, 4, 500, 530, 32, False, 64), (1, 32, 8, 300, 280, 256, True, 64),
])
def test_f32_flash_kernels_match_plain_versions(no_tf32, packed, b, h, kv,
                                                sq, sk, d, causal, tile):
    """The three float32 flash kernels, both layouts, GQA by index (packed)
    or repeated K/V ([b·h, s, d]), at head_dim 256 and a head_dim zero-padded
    to it too, and the forward at each query tile its plan can pick
    (`f32_fwd_tile`: b·h, or b x heads, query heads): ragged rows, sq != sk
    and not causal at both."""
    cuda = no_tf32
    assert fa.f32_fwd_tile(b * h, sq) == tile
    q, do = (_f32((b, sq, h * d), cuda, i) for i in (0, 3))
    k, v = (_f32((b, sk, kv * d), cuda, i) for i in (1, 2))
    scale = d ** -0.5
    if packed:
        kernels = fa.PACKED_KERNELS
        args = (h, kv, scale, causal)
        fwd, fwd_plain = fa.flash_fwd_packed, fa.flash_fwd_packed_plain
        dkv, dkv_plain = fa.flash_bwd_dkv_packed, fa.flash_bwd_dkv_packed_plain
        dq, dq_plain = fa.flash_bwd_dq_packed, fa.flash_bwd_dq_packed_plain
        delta_of = lambda o: fa.flash_delta_packed(o, do, h)  # noqa: E731
    else:
        def flat(x, n):
            return _heads(x, n).repeat_interleave(h // n, 1).reshape(
                b * h, x.shape[1], d).contiguous()
        q, k, v, do = flat(q, h), flat(k, kv), flat(v, kv), flat(do, h)
        kernels = fa.KERNELS
        args = (scale, causal)
        fwd, fwd_plain = fa.flash_fwd, fa.flash_fwd_plain
        dkv, dkv_plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain
        dq, dq_plain = fa.flash_bwd_dq, fa.flash_bwd_dq_plain
        delta_of = lambda o: fa.flash_delta(o, do)  # noqa: E731
    before = [(kern.launches, kern.f32_launches) for kern in kernels]
    out, lse = fwd(q, k, v, *args)
    p_out, p_lse = fwd_plain(q, k, v, *args)
    delta = delta_of(p_out)
    bwd = (q, k, v, do, p_lse, delta, *args)
    got = (out, lse, *dkv(*bwd), dq(*bwd))
    want = (p_out, p_lse, *dkv_plain(*bwd), dq_plain(*bwd))
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("out", "lse", "dk", "dv", "dq")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g, w) < F32_KERNEL_TOL, name
    assert [(kern.launches, kern.f32_launches) for kern in kernels] == [
        (n + 1, m + 1) for n, m in before]


# (b, heads, kv heads, sq, sk, head_dim, causal) of the float32 dq and
# dk/dv on their plans (`f32_fwd_tile`, `f32_dkv_tile`): GQA n_rep 4 (by
# index packed, K/V repeated per query head flat), head dims 32 to 256,
# ragged sq != sk, causal and not; between them every tile of each plan in
# each layout (`test_f32_bwd_cases_cover_every_tile`).
F32_BWD_CASES = [
    (2, 8, 2, 520, 500, 32, True), (4, 16, 4, 300, 600, 32, False),
    (2, 16, 4, 200, 1100, 64, False), (1, 8, 2, 70, 90, 64, True),
    (1, 8, 2, 130, 150, 128, True), (4, 8, 2, 700, 2100, 128, True),
    (2, 8, 2, 1030, 1000, 128, True), (1, 4, 1, 200, 190, 256, True),
    (4, 8, 2, 1000, 1100, 256, True),
]


def _f32_bwd_tiles(b, h, kv, sq, sk, packed):
    """(dq's query tile, dk/dv's key tile) the wrappers plan: packed over b
    x heads and b x kv heads, flat over b·h both (K/V repeated)."""
    return (fa.f32_fwd_tile(b * h, sq),
            fa.f32_dkv_tile(b * (kv if packed else h), sk))


def test_f32_bwd_cases_cover_every_tile(cuda):
    for packed in (False, True):
        tiles = {_f32_bwd_tiles(*c[:5], packed) for c in F32_BWD_CASES}
        for kernel in range(2):
            assert {t[kernel] for t in tiles} == set(fa.F32_FWD_TILES)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", F32_BWD_CASES)
def test_f32_dq_dkv_on_their_plans_match_plain_versions(no_tf32, packed, b,
                                                        h, kv, sq, sk, d,
                                                        causal):
    """The float32 dq and dk/dv at the tiles their plans give each case
    within 1e-4 of their plain versions, and a second call of each gives
    the same bits (every sum in a fixed order, no atomics)."""
    cuda = no_tf32
    q, do = (_f32((b, sq, h * d), cuda, i) for i in (0, 3))
    k, v = (_f32((b, sk, kv * d), cuda, i) for i in (1, 2))
    scale = d ** -0.5
    if packed:
        args = (h, kv, scale, causal)
        fwd_plain = fa.flash_fwd_packed_plain
        dkv, dkv_plain = fa.flash_bwd_dkv_packed, fa.flash_bwd_dkv_packed_plain
        dq, dq_plain = fa.flash_bwd_dq_packed, fa.flash_bwd_dq_packed_plain
        delta_of = lambda o: fa.flash_delta_packed(o, do, h)  # noqa: E731
    else:
        def flat(x, n):
            return _heads(x, n).repeat_interleave(h // n, 1).reshape(
                b * h, x.shape[1], d).contiguous()
        q, k, v, do = flat(q, h), flat(k, kv), flat(v, kv), flat(do, h)
        args = (scale, causal)
        fwd_plain = fa.flash_fwd_plain
        dkv, dkv_plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain
        dq, dq_plain = fa.flash_bwd_dq, fa.flash_bwd_dq_plain
        delta_of = lambda o: fa.flash_delta(o, do)  # noqa: E731
    p_out, p_lse = fwd_plain(q, k, v, *args)
    bwd = (q, k, v, do, p_lse, delta_of(p_out), *args)
    got_dk, got_dv = dkv(*bwd)
    got_dq = dq(*bwd)
    again_dk, again_dv = dkv(*bwd)
    again_dq = dq(*bwd)
    want_dk, want_dv = dkv_plain(*bwd)
    want_dq = dq_plain(*bwd)
    torch.cuda.synchronize()
    for g, w, name in ((got_dq, want_dq, "dq"), (got_dk, want_dk, "dk"),
                       (got_dv, want_dv, "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g, w) < F32_KERNEL_TOL, name
    for g, a in ((got_dq, again_dq), (got_dk, again_dk), (got_dv, again_dv)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("T,d,dff", [(512, 256, 512), (37, 130, 50),
                                     (1000, 200, 328)])
def test_f32_ffn_kernels_match_plain_versions(no_tf32, T, d, dff):
    cuda = no_tf32
    x = _f32((T, d), cuda, 0)
    rstd = torch.rand((T, 1), device=cuda) + 0.5
    nw = _f32((d,), cuda, 5, 0.1) + 1
    dgate, dup = _f32((T, dff), cuda, 1), _f32((T, dff), cuda, 2)
    gate, up = _f32((T, dff), cuda, 3), _f32((T, dff), cuda, 4)
    dy = _f32((T, d), cuda, 6, 0.1)
    wd = _f32((dff, d), cuda, 7, dff ** -0.5)
    before = [(kern.launches, kern.f32_launches) for kern in ff.KERNELS]
    got = (*ff.dw_gateup(x, rstd, nw, dgate, dup), ff.dw_down(gate, up, dy),
           *ff.dgateup(dy, wd, gate, up))
    want = (*ff.dw_gateup_plain(x, rstd, nw, dgate, dup),
            ff.dw_down_plain(gate, up, dy), *ff.dgateup_plain(dy, wd, gate,
                                                              up))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_err(g, w) < F32_KERNEL_TOL
    assert [(kern.launches, kern.f32_launches) for kern in ff.KERNELS] == [
        (n + 1, m + 1) for n, m in before]


@pytest.mark.parametrize("T,d,dff", [(256, 256, 256), (4096, 4096, 14336),
                                     (512, 256, 512), (37, 130, 50),
                                     (1000, 200, 328), (0, 64, 64)])
def test_f32_k1_k2_on_their_plans_match_plain_versions(no_tf32, T, d, dff):
    """The float32 K1, K2 and K3 on the tile and split their plan gives
    each shape (fused_ffn.f32_plan): the tiny step's (64 x 64 tiles, 8
    slices for K1 and K2, 4 for K3's two outputs), the 8B shape (128 x 128,
    unsplit), split and ragged shapes, rows that are not 16-byte aligned (d
    130, d_ff 50) and T = 0 (zeros). Within 1e-4 of the plain versions, and
    a second call gives the same bits."""
    cuda = no_tf32
    gate, up = _f32((T, dff), cuda, 3), _f32((T, dff), cuda, 4)
    dy = _f32((T, d), cuda, 6, 0.1)
    wd = _f32((dff, d), cuda, 7, dff ** -0.5)
    x = _f32((T, d), cuda, 0)
    rstd = torch.rand((T, 1), device=cuda) + 0.5
    nw = _f32((d,), cuda, 5, 0.1) + 1
    dgate, dup = _f32((T, dff), cuda, 1, 0.01), _f32((T, dff), cuda, 2, 0.01)
    kernels = (ff.dw_down, ff.dgateup, ff.dw_gateup)
    before = [(kern.launches, kern.f32_launches) for kern in kernels]

    def run():
        return (ff.dw_down(gate, up, dy), *ff.dgateup(dy, wd, gate, up),
                *ff.dw_gateup(x, rstd, nw, dgate, dup))

    got, again = run(), run()
    want = (ff.dw_down_plain(gate, up, dy),
            *ff.dgateup_plain(dy, wd, gate, up),
            *ff.dw_gateup_plain(x, rstd, nw, dgate, dup))
    torch.cuda.synchronize()
    for g, a, w, name in zip(got, again, want, ("dw_down", "dgate", "dup",
                                                "dw_gate", "dw_up")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(g, a), name
        if w.numel():
            assert _rel_err(g, w) < F32_KERNEL_TOL, name
    if T == 0:
        assert not got[0].any() and not got[3].any() and not got[4].any()
    calls = (2, 2 if T else 0, 2)  # K2 launches nothing for T = 0
    assert [(kern.launches, kern.f32_launches) for kern in kernels] == [
        (n + c, m + c) for (n, m), c in zip(before, calls)]


@pytest.mark.parametrize("plan", ffnbench.PLAN_SWEEP)
def test_f32_ffn_kernels_under_every_plan_of_the_sweep(no_tf32, plan):
    """K1, K2 and K3 at the float32 tiny step's shape (T = d = d_ff =
    256) under each plan of ffnbench's sweep, called through their C
    entries: within 1e-4 of the plain versions, and a second call gives the
    same bits."""
    cuda = no_tf32
    dims = ffnbench.TINY
    T, d, dff = dims
    t = {"x": _f32((T, d), cuda, 0), "nw": _f32((d,), cuda, 5, 0.1) + 1,
         "rstd": torch.rand((T, 1), device=cuda) + 0.5,
         "dgate": _f32((T, dff), cuda, 1, 0.01),
         "dup": _f32((T, dff), cuda, 2, 0.01),
         "gate": _f32((T, dff), cuda, 3), "up": _f32((T, dff), cuda, 4),
         "dy": _f32((T, d), cuda, 6, 0.1),
         "wd": _f32((dff, d), cuda, 7, dff ** -0.5)}
    ffnbench.add_outputs(t, dims, torch.float32)
    lib, _ = ff._entry("rt_dw_gateup", torch.float32)
    fns = ffnbench.entries(lib, t, dims, torch.float32, ffnbench.PLANNED,
                           plan)
    want = {"dw_gateup": ff.dw_gateup_plain(t["x"], t["rstd"], t["nw"],
                                            t["dgate"], t["dup"]),
            "dw_down": (ff.dw_down_plain(t["gate"], t["up"], t["dy"]),),
            "dgateup": ff.dgateup_plain(t["dy"], t["wd"], t["gate"],
                                        t["up"])}
    for name, fn in fns.items():
        fn()
        first = [t[o].clone() for o in ffnbench.OUTPUTS[name]]
        fn()
        torch.cuda.synchronize()
        for o, a, w in zip(ffnbench.OUTPUTS[name], first, want[name]):
            assert torch.equal(t[o], a), (name, o)
            assert _rel_err(t[o], w) < F32_KERNEL_TOL, (name, o)


@pytest.mark.parametrize("d", [4096, 256])
def test_f32_k3_h_operand_equals_the_plain_normed_x(no_tf32, d):
    """The float32 K3 with dgate the identity (T = d_ff = 256):
    dW_gate[i, t] is the kernel's h of token t, d row i (one nonzero term a
    sum, the other slices adding exact zeros): equal to the plain version's
    (x·rstd)·norm_w value for value, unsplit (d 4096: 128-tiles) and split
    (d 256: 64-tiles, 4 slices)."""
    cuda = no_tf32
    T = 256
    x = _f32((T, d), cuda, 0)
    rstd = torch.from_numpy(np.random.default_rng(4).random(
        (T, 1)).astype(np.float32) + 0.5).to(cuda)
    nw = _f32((d,), cuda, 5, 0.1) + 1
    eye = torch.eye(T, device=cuda)
    assert ff.f32_plan(d, T, T, 2) == (ff.F32Plan(128, 1) if d == 4096
                                       else ff.F32Plan(64, 4))
    dwg, dwu = ff.dw_gateup(x, rstd, nw, eye, eye)
    h = ff.normed(x, rstd, nw)
    torch.cuda.synchronize()
    assert torch.equal(dwg.T, h) and torch.equal(dwu.T, h)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", [
    (2, 8, 2, 256, 256, 128, True), (1, 4, 1, 64, 300, 64, True),
    (1, 4, 4, 130, 130, 32, False), (1, 4, 1, 200, 200, 128, True),
    (2, 4, 1, 200, 200, 64, True), (1, 8, 2, 192, 192, 32, True),
    (1, 4, 2, 192, 192, 256, True), (1, 4, 2, 192, 192, 96, True),
    (1, 4, 2, 192, 192, 192, True),
])
def test_redesigned_fwd_and_dq_match_plain_versions(cuda, b, h, kv, sq, sk,
                                                    d, causal):
    """The register-resident forward and dq kernels (bf16) at d 32/64/128/
    256 and at d 96 and 192 (zero-padded to 128 and 256), in both layouts,
    GQA n_rep 4 by index, sq != sk, not causal, and a ragged s: outputs
    within 1e-2 and lse within 2e-5 of the plain max (lse
    relative to its largest magnitude: a causal row 0 holds one score,
    which may lie near 0)."""
    q, do = (_bf16((b, sq, h * d), cuda, i) for i in (0, 3))
    k, v = (_bf16((b, sk, kv * d), cuda, i) for i in (1, 2))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_packed(q, k, v, h, kv, scale, causal)
    p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, h, kv, scale, causal)
    delta = fa.flash_delta_packed(p_out, do, h)
    bwd = (q, k, v, do, p_lse, delta, h, kv, scale, causal)
    dq = fa.flash_bwd_dq_packed(*bwd)
    p_dq = fa.flash_bwd_dq_packed_plain(*bwd)

    def flat(x, n):  # [b, s, n·d] -> [b·h, s, d], heads repeated to h
        return _heads(x, n).repeat_interleave(h // n, 1).reshape(
            b * h, x.shape[1], d).contiguous()

    q3, k3, v3, do3 = flat(q, h), flat(k, kv), flat(v, kv), flat(do, h)
    out3, lse3 = fa.flash_fwd(q3, k3, v3, scale, causal)
    rows = (p_lse.view(b * h, sq), delta.view(b * h, sq))
    dq3 = fa.flash_bwd_dq(q3, k3, v3, do3, *rows, scale, causal)
    torch.cuda.synchronize()
    assert _rel_err(out, p_out) < REL_TOL
    assert _rel_err(dq, p_dq) < REL_TOL
    assert _rel_err(lse, p_lse) < 2e-5
    assert _rel_err(out3, flat(p_out, h)) < REL_TOL
    assert _rel_err(dq3, flat(p_dq, h)) < REL_TOL
    assert _rel_err(lse3, p_lse.view(b * h, sq)) < 2e-5


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _train_on_both(cuda, cfg, seq, steps=3):
    """`steps` steps of default_optimizer with K1/K2 on, from the same
    float32 params and batch, on the card and on the CPU. Returns (the
    card's launches per step of the flash and fused-FFN kernels, both loss
    curves)."""
    opt = default_optimizer(1e-3, warmup_steps=1)
    params = init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, 2, seq, 1, "cpu")
    kernels = (*fa.KERNELS, *ff.KERNELS)
    old = ff.USE_K1, ff.USE_K2
    ff.USE_K1 = ff.USE_K2 = True
    curves, launches = {}, []
    try:
        for dev in (cuda, torch.device("cpu")):
            step_fn, _ = make_train_step(cfg, opt, device=dev)
            p = _to(params, dev)
            state = TrainState(params=p, opt_state=opt.init(p), step=0)
            losses = []
            for _ in range(steps):
                for kern in kernels:
                    kern.launches = kern.f32_launches = 0
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                if dev.type == "cuda":
                    launches.append({kern.__name__: (kern.launches,
                                                     kern.f32_launches)
                                     for kern in kernels})
            curves[dev.type] = losses
    finally:
        ff.USE_K1, ff.USE_K2 = old
    return launches, curves


@pytest.mark.parametrize("variant", ["tiny", "hd128"])
def test_tiny_f32_training_goes_through_the_f32_kernels(no_tf32, variant):
    """ModelConfig.tiny() in float32 with fused_ffn and fused_attn: K3, K1
    and K2 launch their float32 kernels n_layers times a step; the flash
    pair launches 0 times at head_dim 32 (the einsum route, as the
    reference's gate) and n_layers times at head_dim 128, s 128. The
    losses match the same model on the CPU within 1e-4 relative."""
    cfg = dataclasses.replace(ModelConfig.tiny(), fused_ffn=True,
                              fused_attn=True)
    seq = 64
    if variant == "hd128":
        cfg = dataclasses.replace(cfg, **TINY_HD128)
        seq = 128
    assert cfg.dtype == torch.float32
    launches, curves = _train_on_both(no_tf32, cfg, seq)
    n_flash = cfg.n_layers if variant == "hd128" else 0
    L = cfg.n_layers
    for got in launches:
        assert got == {"flash_fwd": (n_flash, n_flash),
                       "flash_bwd_dkv": (n_flash, n_flash),
                       "flash_bwd_dq": (n_flash, n_flash),
                       "dw_gateup": (L, L), "dw_down": (L, L),
                       "dgateup": (L, L)}
    assert all(np.isfinite(curves["cuda"]))
    np.testing.assert_allclose(curves["cuda"], curves["cpu"], rtol=1e-4)


# ------------------------------------------ head dims to 256, the redesigns


@pytest.mark.parametrize("d", [32, 64, 128, 256, 96, 192])
@pytest.mark.parametrize("b,h,kv,sq,sk,causal,packed", [
    (1, 4, 1, 200, 200, True, True), (2, 2, 2, 64, 300, True, False),
    (1, 2, 2, 130, 77, False, False), (2, 1, 1, 256, 256, True, False),
])
def test_dkv_kernel_matches_plain_version(cuda, d, b, h, kv, sq, sk, causal,
                                          packed):
    """The wgmma dk/dv kernel at every instantiated head_dim and at two
    zero-padded ones: packed with GQA n_rep 4 and a ragged s, sq != sk
    end-aligned, not causal with sq > sk, and the square causal case;
    within 1e-2 of the plain max."""
    q, do = (_bf16((b, sq, h * d), cuda, i) for i in (0, 3))
    k, v = (_bf16((b, sk, kv * d), cuda, i) for i in (1, 2))
    scale = d ** -0.5
    if packed:
        args = (h, kv, scale, causal)
        o, lse = fa.flash_fwd_packed_plain(q, k, v, *args)
        delta = fa.flash_delta_packed(o, do, h)
        dkv, dkv_plain = fa.flash_bwd_dkv_packed, fa.flash_bwd_dkv_packed_plain
    else:
        q, k, v, do = (_heads(t, n).reshape(b * n, t.shape[1], d).contiguous()
                       for t, n in ((q, h), (k, kv), (v, kv), (do, h)))
        args = (scale, causal)
        o, lse = fa.flash_fwd_plain(q, k, v, *args)
        delta = fa.flash_delta(o, do)
        dkv, dkv_plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain
    before = dkv.launches
    dk, dv = dkv(q, k, v, do, lse, delta, *args)
    p_dk, p_dv = dkv_plain(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    assert dk.shape == p_dk.shape and dv.shape == p_dv.shape
    assert _rel_err(dk, p_dk) < REL_TOL
    assert _rel_err(dv, p_dv) < REL_TOL
    assert dkv.launches == before + 1


@pytest.mark.parametrize("T,d,dff", [(4096, 4096, 14336), (1000, 4000, 3000),
                                     (300, 264, 1001), (77, 131, 72)])
def test_k1_kernel_matches_plain_version(cuda, T, d, dff):
    """The wgmma K1 at the 8B shape (TMA ring), at a shape that tiles on no
    axis, at a d_ff that is not a multiple of 8 and an odd d (the cp.async
    ring with element-wise chunks)."""
    gate, up = _bf16((T, dff), cuda, 0), _bf16((T, dff), cuda, 1)
    dy = _bf16((T, d), cuda, 2, 0.01)
    before = ff.dw_down.launches
    got = ff.dw_down(gate, up, dy)
    want = ff.dw_down_plain(gate, up, dy)
    torch.cuda.synchronize()
    assert got.shape == (dff, d)
    assert _rel_err(got, want) < REL_TOL
    assert ff.dw_down.launches == before + 1


def test_attention_entries_launch_the_kernels_at_head_dim_256(cuda):
    """ops.attention, ops.attention_packed and the fused attn_block at
    head_dim 256, s 128 take the flash route and launch its kernels (they
    raised before), against the einsum reference, and none of the wide
    family; head_dim 320 takes the wide family (it raised before the
    wide kernels), once per kernel."""
    b, h, kv, s, d = 1, 2, 1, 128, 256
    q = _bf16((b, s, h * d), cuda, 0).requires_grad_(True)
    k = _bf16((b, s, kv * d), cuda, 1).requires_grad_(True)
    v = _bf16((b, s, kv * d), cuda, 2).requires_grad_(True)
    g = _bf16((b, s, h * d), cuda, 3)
    ref = causal_attention_reference(
        _heads(q, h), *(_heads(t, kv).repeat_interleave(h // kv, 1)
                        for t in (k, v))).transpose(1, 2).reshape(b, s, h * d)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    before = [kern.launches for kern in (*fa.KERNELS, *fa.PACKED_KERNELS)]
    out_b = attention(_heads(q, h), _heads(k, kv), _heads(v, kv))
    out_b = out_b.transpose(1, 2).reshape(b, s, h * d)
    grads_b = torch.autograd.grad(out_b, (q, k, v), g)
    out_p = attention_packed(q, k, v, n_heads=h, n_kv_heads=kv)
    grads_p = torch.autograd.grad(out_p, (q, k, v), g)
    assert [kern.launches for kern in (*fa.KERNELS, *fa.PACKED_KERNELS)] == [
        n + 1 for n in before]
    for got, want in ((out_b, ref), (out_p, ref), *zip(grads_b, ref_grads),
                      *zip(grads_p, ref_grads)):
        assert _rel_err(got, want) < REL_TOL

    from ray_tpu_torch.ops.kernels.fused_attn import attn_block
    from ray_tpu_torch.ops.layers import rotary_embedding

    D = h * d
    x = _bf16((b, s, D), cuda, 4).requires_grad_(True)
    nw = _bf16((D,), cuda, 5, 0.1) + 1
    ws = [_bf16(shape, cuda, 6 + i, shape[0] ** -0.5) for i, shape in
          enumerate(((D, h * d), (D, kv * d), (D, kv * d), (h * d, D)))]
    cos, sin = rotary_embedding(torch.arange(s, device=cuda), d)
    before = [kern.launches for kern in fa.KERNELS]
    y = attn_block(x, nw, *ws, cos[None], sin[None], h, kv)
    dx, = torch.autograd.grad(y, (x,), _bf16((b, s, D), cuda, 11))
    torch.cuda.synchronize()
    assert [kern.launches for kern in fa.KERNELS] == [n + 1 for n in before]
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())
    assert all(kern.wide_launches == 0 for kern in fa.KERNELS)
    wide = _bf16((1, 1, 128, 320), cuda, 12).requires_grad_(True)
    out = attention(wide, wide, wide)
    torch.autograd.grad(out, (wide,), torch.ones_like(out))
    torch.cuda.synchronize()
    assert [kern.wide_launches for kern in fa.KERNELS] == [1, 1, 1]



@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [320, 512])
def test_wide_head_dims_match_plain_versions(no_tf32, d, dtype, causal,
                                             packed):
    """Fault C.2: the wide family (csrc/flash_wide.cu) at head_dim 320
    (zero-padded to 384) and 512, forward, dk/dv and dq, on [b·h, s, d]
    and on the packed layout with GQA (4 over 2 heads, s 150: a ragged
    tile), against the plain versions: bf16 within 1e-2 of the plain max,
    float32 within 1e-4, lse within 2e-5 of its max; one wide launch
    each."""
    b, h, kv, s = 1, 4, 2, 150
    lim = 1e-4 if dtype == torch.float32 else REL_TOL
    q, do = (_randn((b, s, h * d), no_tf32, dtype, i) for i in (0, 3))
    k, v = (_randn((b, s, kv * d), no_tf32, dtype, i) for i in (1, 2))
    scale = d ** -0.5
    if packed:
        fwd, dkv, dq_fn = (fa.flash_fwd_packed, fa.flash_bwd_dkv_packed,
                           fa.flash_bwd_dq_packed)
        plain = (fa.flash_fwd_packed_plain, fa.flash_bwd_dkv_packed_plain,
                 fa.flash_bwd_dq_packed_plain)
        heads = (h, kv, scale, causal)
    else:
        def flat(t, n):
            return _heads(t, n).repeat_interleave(h // n, 1).reshape(
                b * h, s, d).contiguous()

        q, do, k, v = flat(q, h), flat(do, h), flat(k, kv), flat(v, kv)
        fwd, dkv, dq_fn = fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq
        plain = (fa.flash_fwd_plain, fa.flash_bwd_dkv_plain,
                 fa.flash_bwd_dq_plain)
        heads = (scale, causal)
    kernels = (fwd, dkv, dq_fn)
    before = [(kern.launches, kern.wide_launches) for kern in kernels]
    out, lse = fwd(q, k, v, *heads)
    p_out, p_lse = plain[0](q, k, v, *heads)
    delta = (fa.flash_delta_packed(p_out, do, h) if packed
             else fa.flash_delta(p_out, do))
    bwd = (q, k, v, do, p_lse, delta, *heads)
    dk, dv = dkv(*bwd)
    dq = dq_fn(*bwd)
    torch.cuda.synchronize()
    assert [(kern.launches, kern.wide_launches) for kern in kernels] == [
        (n + 1, w + 1) for n, w in before]
    p_dk, p_dv = plain[1](*bwd)
    p_dq = plain[2](*bwd)
    assert _rel_err(out, p_out) < lim
    assert _rel_err(lse, p_lse) < STAT_TOL
    for got, want in ((dk, p_dk), (dv, p_dv), (dq, p_dq)):
        assert got.shape == want.shape and _rel_err(got, want) < lim


def _wide_backward(q, k, v, do, d, heads, causal):
    """(the bf16 wide backward's dk, dv, dq; its plain versions'; a
    function that calls the kernels again) on the plain forward's lse and
    Δ. heads (h, kv): the packed [b, s, h·d] entries, GQA by index; None:
    the [b·h, s, d] ones."""
    scale = d ** -0.5
    if heads is None:
        args = (scale, causal)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
        delta = fa.flash_delta(p_out, do)
        dkv, dq_fn = fa.flash_bwd_dkv, fa.flash_bwd_dq
        plain = (fa.flash_bwd_dkv_plain, fa.flash_bwd_dq_plain)
    else:
        args = (*heads, scale, causal)
        p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, *args)
        delta = fa.flash_delta_packed(p_out, do, heads[0])
        dkv, dq_fn = fa.flash_bwd_dkv_packed, fa.flash_bwd_dq_packed
        plain = (fa.flash_bwd_dkv_packed_plain, fa.flash_bwd_dq_packed_plain)
    bwd = (q, k, v, do, p_lse, delta, *args)

    def kernels():
        before = [dkv.wide_launches, dq_fn.wide_launches]
        got = (*dkv(*bwd), dq_fn(*bwd))
        torch.cuda.synchronize()
        assert [dkv.wide_launches, dq_fn.wide_launches] == [
            n + 1 for n in before]
        return got

    return kernels(), (*plain[0](*bwd), plain[1](*bwd)), kernels


@pytest.mark.parametrize("sq,sk", [(200, 64), (64, 200)])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_backward_where_sq_and_sk_differ(cuda, d, sq, sk):
    """The wgmma dk/dv and dq of the wide family, causal (end-aligned) with
    sq > sk, where rows 0..sq-sk-1 see no key and their dq is exactly 0,
    and with sq < sk; against the plain versions within 1e-2 of the plain
    max, on [b·h, s, d]."""
    bh = 2
    q, do = (_bf16((bh, sq, d), cuda, i) for i in (0, 3))
    k, v = (_bf16((bh, sk, d), cuda, i) for i in (1, 2))
    got, want, _ = _wide_backward(q, k, v, do, d, None, True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_err(g, w) < REL_TOL
    if sq > sk:
        assert bool((got[2][:, :sq - sk] == 0).all())
        assert bool((got[2][:, sq - sk:] != 0).any())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_backward_ragged_gqa_and_deterministic(cuda, d, packed,
                                                         causal):
    """The wgmma dk/dv and dq of the wide family at s 200 (two 128-row
    query tiles and four 64-key tiles, each ragged at its tail) with GQA 4
    query heads over 1 kv head, packed (by index) and on [b·h, s, d] (K/V
    repeated): within 1e-2 of the plain max, and a second call gives the
    same bits."""
    b, h, kv, s = 1, 4, 1, 200
    q, do = (_bf16((b, s, h * d), cuda, i) for i in (0, 3))
    k, v = (_bf16((b, s, kv * d), cuda, i) for i in (1, 2))
    if not packed:
        def flat(t, n):
            return _heads(t, n).repeat_interleave(h // n, 1).reshape(
                b * h, s, d).contiguous()

        q, do, k, v = flat(q, h), flat(do, h), flat(k, kv), flat(v, kv)
    got, want, again = _wide_backward(q, k, v, do, d,
                                      (h, kv) if packed else None, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_err(g, w) < REL_TOL
    for g, g2 in zip(got, again()):
        assert torch.equal(g, g2)


def _wide_fwd(q, k, v, d, heads, causal):
    """(the bf16 wide forward's out and lse; its plain version's; a
    function that calls the kernel again). heads (h, kv): the packed
    entry, GQA by index; None: the [b·h, s, d] one."""
    args = (*(heads or ()), d ** -0.5, causal)
    fwd, plain = ((fa.flash_fwd, fa.flash_fwd_plain) if heads is None
                  else (fa.flash_fwd_packed, fa.flash_fwd_packed_plain))

    def kernel():
        before = fwd.wide_launches
        got = fwd(q, k, v, *args)
        torch.cuda.synchronize()
        assert fwd.wide_launches == before + 1
        return got

    return kernel(), plain(q, k, v, *args), kernel


@pytest.mark.parametrize("sq,sk", [(200, 64), (64, 200)])
@pytest.mark.parametrize("d", [320, 512, 640])
def test_wide_bf16_forward_where_sq_and_sk_differ(cuda, d, sq, sk):
    """The wgmma forward of the wide family, causal (end-aligned) with sq >
    sk, where rows 0..sq-sk-1 see no key: out exactly 0 and lse -1e30
    there; and with sq < sk. Out within 1e-2 of the plain max, lse within
    2e-5 on the rows that see keys, on [b·h, s, d]; 640 takes the second
    staging plan (Q streamed, `wide_fwd_plan`)."""
    bh = 2
    q = _bf16((bh, sq, d), cuda, 0)
    k, v = (_bf16((bh, sk, d), cuda, i) for i in (1, 2))
    (out, lse), (p_out, p_lse), _ = _wide_fwd(q, k, v, d, None, True)
    assert out.shape == p_out.shape and _rel_err(out, p_out) < REL_TOL
    seen = max(sq - sk, 0)
    assert _rel_err(lse[:, seen:], p_lse[:, seen:]) < STAT_TOL
    if seen:
        assert bool((out[:, :seen] == 0).all())
        assert bool((lse[:, :seen] == -1e30).all())
        assert bool((out[:, seen:] != 0).any())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_forward_ragged_gqa_and_deterministic(cuda, d, packed,
                                                        causal):
    """The wgmma forward of the wide family at s 200 (two 128-row query
    tiles and four 64-key tiles, each ragged at its tail) with GQA 4 query
    heads over 1 kv head, packed (by index) and on [b·h, s, d] (K/V
    repeated): out within 1e-2 of the plain max, lse within 2e-5, and a
    second call gives the same bits."""
    b, h, kv, s = 1, 4, 1, 200
    q = _bf16((b, s, h * d), cuda, 0)
    k, v = (_bf16((b, s, kv * d), cuda, i) for i in (1, 2))
    if not packed:
        def flat(t, n):
            return _heads(t, n).repeat_interleave(h // n, 1).reshape(
                b * h, s, d).contiguous()

        q, k, v = flat(q, h), flat(k, kv), flat(v, kv)
    got, want, again = _wide_fwd(q, k, v, d, (h, kv) if packed else None,
                                 causal)
    assert got[0].shape == want[0].shape
    assert _rel_err(got[0], want[0]) < REL_TOL
    assert _rel_err(got[1], want[1]) < STAT_TOL
    for g, g2 in zip(got, again()):
        assert torch.equal(g, g2)


def _wide_f32_dq(q, k, v, do, d, heads, causal):
    """(the float32 wide dq; its plain version's; a function that calls the
    kernel again) on the plain forward's lse and Δ; heads as
    `_wide_backward`."""
    scale = d ** -0.5
    if heads is None:
        args = (scale, causal)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
        delta = fa.flash_delta(p_out, do)
        dq_fn, plain = fa.flash_bwd_dq, fa.flash_bwd_dq_plain
    else:
        args = (*heads, scale, causal)
        p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, *args)
        delta = fa.flash_delta_packed(p_out, do, heads[0])
        dq_fn, plain = fa.flash_bwd_dq_packed, fa.flash_bwd_dq_packed_plain
    bwd = (q, k, v, do, p_lse, delta, *args)

    def kernel():
        before = (dq_fn.wide_launches, dq_fn.f32_launches)
        got = dq_fn(*bwd)
        torch.cuda.synchronize()
        assert (dq_fn.wide_launches, dq_fn.f32_launches) == tuple(
            n + 1 for n in before)
        return got

    return kernel(), plain(*bwd), kernel


@pytest.mark.parametrize("sq,sk", [(200, 64), (64, 200)])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_f32_dq_where_sq_and_sk_differ(no_tf32, d, sq, sk):
    """The register-tiled float32 dq of the wide family, causal
    (end-aligned) with sq > sk, where rows 0..sq-sk-1 see no key and their
    dq is exactly 0, and with sq < sk; within 1e-4 of the plain max, on
    [b·h, s, d]."""
    bh = 2
    q, do = (_randn((bh, sq, d), no_tf32, torch.float32, i) for i in (0, 3))
    k, v = (_randn((bh, sk, d), no_tf32, torch.float32, i) for i in (1, 2))
    got, want, _ = _wide_f32_dq(q, k, v, do, d, None, True)
    assert got.shape == want.shape and _rel_err(got, want) < 1e-4
    if sq > sk:
        assert bool((got[:, :sq - sk] == 0).all())
        assert bool((got[:, sq - sk:] != 0).any())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_f32_dq_ragged_gqa_and_deterministic(no_tf32, d, packed,
                                                  causal):
    """The register-tiled float32 dq of the wide family at s 200 (ragged
    16-row query tiles and 32-key tiles) with GQA 4 query heads over 1 kv
    head, packed (by index) and on [b·h, s, d] (K/V repeated): within 1e-4
    of the plain max, and a second call gives the same bits."""
    b, h, kv, s = 1, 4, 1, 200
    q, do = (_randn((b, s, h * d), no_tf32, torch.float32, i)
             for i in (0, 3))
    k, v = (_randn((b, s, kv * d), no_tf32, torch.float32, i)
            for i in (1, 2))
    if not packed:
        def flat(t, n):
            return _heads(t, n).repeat_interleave(h // n, 1).reshape(
                b * h, s, d).contiguous()

        q, do, k, v = flat(q, h), flat(do, h), flat(k, kv), flat(v, kv)
    got, want, again = _wide_f32_dq(q, k, v, do, d,
                                    (h, kv) if packed else None, causal)
    assert got.shape == want.shape and _rel_err(got, want) < 1e-4
    assert torch.equal(got, again())


@pytest.mark.parametrize("d", [128, 256, 384, 640, 768])
def test_wide_entries_take_every_multiple_of_128(no_tf32, d):
    """The bf16 forward's and the float32 dq's, forward's and dk/dv's C
    entries of the wide family at head widths the wrappers never send them
    (128, 256: a head of 2 or 4 chunks, shorter than the forward's ring)
    and at 384, 640 and 768 (the bf16 forward's two staging plans; the
    float32 forward's and dk/dv's whole head and 128-column slices), causal,
    b·h 2 x s 150 against the plain versions: bf16 within 1e-2 of the
    plain max, lse 2e-5, float32 1e-4."""
    bh, s = 2, 150
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    layout = (bh, 1, 1, s, s, d)
    q, k, v = (_bf16((bh, s, d), no_tf32, i) for i in range(3))
    out, lse = torch.empty_like(q), torch.empty((bh, s), device=no_tf32)
    lib, fn = fa._wide_entry("rt_flash_fwd", torch.bfloat16)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), *layout, scale, 1, stream)
    assert code == 0, lib.rt_error_string(code)
    torch.cuda.synchronize()
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, True)
    assert _rel_err(out, p_out) < REL_TOL
    assert _rel_err(lse, p_lse) < STAT_TOL
    q, k, v, do = (_randn((bh, s, d), no_tf32, torch.float32, i)
                   for i in range(4))
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, True)
    delta = fa.flash_delta(p_out, do)
    dq = torch.empty_like(q)
    lib, fn = fa._wide_entry("rt_flash_bwd_dq", torch.float32)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              p_lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *layout,
              scale, 1, fa.wide_f32_dq_tile(bh, s, d), stream)
    assert code == 0, lib.rt_error_string(code)
    torch.cuda.synchronize()
    want = fa.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, scale, True)
    assert _rel_err(dq, want) < 1e-4
    # the float32 forward and dk/dv at their plans
    got = _wide_f32_entries(q, k, v, do, layout, scale, True,
                            fa.wide_f32_fwd_plan(bh, s, d),
                            fa.wide_f32_dkv_plan(bh, s, d))
    want = (p_out, p_lse,
            *fa.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, scale, True))
    _assert_f32(got, want)


def _wide_f32_entries(q, k, v, do, layout, scale, causal, fwd_plan,
                      dkv_plan):
    """(out, lse, dk, dv) of the float32 forward's and dk/dv's C entries of
    the wide family at the plans given, on the plain forward's lse and
    Δ."""
    b, heads, n_rep, sq = layout[:4]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, sq), device=q.device)
    lib, fn = fa._wide_entry("rt_flash_fwd", torch.float32)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), *layout, scale, int(causal), *fwd_plan,
              stream)
    assert code == 0, lib.rt_error_string(code)
    if heads == 1:
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
        delta = fa.flash_delta(p_out, do)
    else:
        p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, heads,
                                                 heads // n_rep, scale,
                                                 causal)
        delta = fa.flash_delta_packed(p_out, do, heads)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, fn = fa._wide_entry("rt_flash_bwd_dkv", torch.float32)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              p_lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), *layout, scale, int(causal), *dkv_plan, stream)
    assert code == 0, lib.rt_error_string(code)
    torch.cuda.synchronize()
    return out, lse.view(p_lse.shape), dk, dv


def _assert_f32(got, want):
    """(out, lse, dk, dv) of the float32 kernels against the plain
    versions': within 1e-4 of the plain max, lse within 2e-5 of its max."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert _rel_err(g, w) < (STAT_TOL if i == 1 else 1e-4), i


@pytest.mark.parametrize("tile", fa.F32_FWD_TILES)
@pytest.mark.parametrize("d", [384, 512, 640])
def test_wide_f32_dq_at_each_tile(no_tf32, d, tile):
    """The float32 wide dq's C entry at each query tile its plan can take
    (64 rows: 256 threads, 2 rows a thread; 16: 128 threads, one row),
    causal, b·h 3 x s 150 (ragged tiles), within 1e-4 of the plain max."""
    bh, s = 3, 150
    q, k, v, do = (_randn((bh, s, d), no_tf32, torch.float32, i)
                   for i in range(4))
    scale = d ** -0.5
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, True)
    delta = fa.flash_delta(p_out, do)
    want = fa.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, scale, True)
    dq = torch.empty_like(q)
    lib, fn = fa._wide_entry("rt_flash_bwd_dq", torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              p_lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, 1, 1,
              s, s, d, scale, 1, tile, stream)
    assert code == 0, lib.rt_error_string(code)
    torch.cuda.synchronize()
    assert _rel_err(dq, want) < 1e-4


# (d, the forward's (tile, width), dk/dv's): every pair the two plans can
# return (the whole head at 32 rows up to 512 columns and at 16 up to 1024
# with Q resident, 16-row 128-column slices with Q resident or streamed;
# dk/dv's whole head up to 512 with K and V resident, 128-column slices with
# them resident or streamed), each kernel's widest whole head among them,
# and the 32-row 128-column slices the forward's entry also takes where Q
# stays resident
WIDE_F32_PLANS = [(384, (32, 384), (16, 384)), (512, (32, 512), (16, 512)),
                  (512, (16, 512), (16, 128)), (1024, (16, 1024), (16, 128)),
                  (384, (32, 128), (16, 128)), (640, (16, 640), (16, 128)),
                  (1152, (16, 128), (16, 128)), (384, (16, 128), (16, 384))]


@pytest.mark.parametrize("d,fwd_plan,dkv_plan", WIDE_F32_PLANS)
def test_wide_f32_fwd_and_dkv_at_each_plan(no_tf32, d, fwd_plan, dkv_plan):
    """The float32 forward's and dk/dv's C entries of the wide family at
    each (tile, width) pair their plans can take, causal, b·h 3 x s 150
    (ragged tiles), within 1e-4 of the plain max (lse 2e-5)."""
    bh, s = 3, 150
    q, k, v, do = (_randn((bh, s, d), no_tf32, torch.float32, i)
                   for i in range(4))
    scale = d ** -0.5
    got = _wide_f32_entries(q, k, v, do, (bh, 1, 1, s, s, d), scale, True,
                            fwd_plan, dkv_plan)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, True)
    delta = fa.flash_delta(p_out, do)
    _assert_f32(got, (p_out, p_lse, *fa.flash_bwd_dkv_plain(
        q, k, v, do, p_lse, delta, scale, True)))


@pytest.mark.parametrize("d,fwd_plan,dkv_plan", [
    (384, (64, 384), (32, 384)), (640, (32, 640), (16, 640)),
    (384, (32, 256), (16, 256)), (1152, (16, 1152), (16, 1152)),
    (640, (32, 128), (16, 640))])
def test_wide_f32_entries_refuse_pairs_without_an_instantiation(
        no_tf32, d, fwd_plan, dkv_plan):
    """A tile the kernels have no instantiation for, a width neither the
    head nor 128, the whole head where its tile's rows do not fit the
    registers, or the forward's 32 rows where Q would stream: the C
    entries return cudaErrorInvalidValue and launch nothing."""
    bh, s = 1, 64
    q, k, v, do = (_randn((bh, s, d), no_tf32, torch.float32, i)
                   for i in range(4))
    stream = torch.cuda.current_stream().cuda_stream
    layout = (bh, 1, 1, s, s, d)
    out, lse = torch.empty_like(q), torch.empty((bh, s), device=no_tf32)
    lib, fn = fa._wide_entry("rt_flash_fwd", torch.float32)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), *layout, 1.0, 1, *fwd_plan, stream) == 1
    lib, fn = fa._wide_entry("rt_flash_bwd_dkv", torch.float32)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), lse.data_ptr(), out.data_ptr(),
              out.data_ptr(), *layout, 1.0, 1, *dkv_plan, stream) == 1


def _wide_f32_fwd_dkv(q, k, v, do, d, heads, causal):
    """(the float32 wide forward's out and lse and dk/dv's dk and dv (on
    the plain forward's lse and Δ); the plain versions'; a function that
    calls both kernels again), each launch counted in `.wide_launches` and
    `.f32_launches`; heads as `_wide_backward`."""
    scale = d ** -0.5
    if heads is None:
        args = (scale, causal)
        fwd, fwd_plain = fa.flash_fwd, fa.flash_fwd_plain
        p_out, p_lse = fwd_plain(q, k, v, *args)
        delta = fa.flash_delta(p_out, do)
        dkv, dkv_plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain
    else:
        args = (*heads, scale, causal)
        fwd, fwd_plain = fa.flash_fwd_packed, fa.flash_fwd_packed_plain
        p_out, p_lse = fwd_plain(q, k, v, *args)
        delta = fa.flash_delta_packed(p_out, do, heads[0])
        dkv = fa.flash_bwd_dkv_packed
        dkv_plain = fa.flash_bwd_dkv_packed_plain
    bwd = (q, k, v, do, p_lse, delta, *args)

    def kernel():
        before = [(f.wide_launches, f.f32_launches) for f in (fwd, dkv)]
        got = (*fwd(q, k, v, *args), *dkv(*bwd))
        torch.cuda.synchronize()
        assert [(f.wide_launches, f.f32_launches) for f in (fwd, dkv)] == [
            (w + 1, n + 1) for w, n in before]
        return got

    return kernel(), (p_out, p_lse, *dkv_plain(*bwd)), kernel


@pytest.mark.parametrize("sq,sk", [(200, 64), (64, 200)])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_f32_forward_where_sq_and_sk_differ(no_tf32, d, sq, sk):
    """The register-tiled float32 forward of the wide family, causal
    (end-aligned) with sq > sk, where rows 0..sq-sk-1 see no key and give
    out exactly 0 and lse -1e30, and with sq < sk; within 1e-4 of the plain
    max, lse within 2e-5, on [b·h, s, d]."""
    bh = 2
    q, do = (_randn((bh, sq, d), no_tf32, torch.float32, i) for i in (0, 3))
    k, v = (_randn((bh, sk, d), no_tf32, torch.float32, i) for i in (1, 2))
    got, want, _ = _wide_f32_fwd_dkv(q, k, v, do, d, None, True)
    _assert_f32(got[:2], want[:2])
    if sq > sk:
        assert bool((got[0][:, :sq - sk] == 0).all())
        assert bool((got[1][:, :sq - sk] == -1e30).all())
        assert bool((got[0][:, sq - sk:] != 0).any())


@pytest.mark.parametrize("sq,sk", [(200, 64), (64, 200)])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_f32_dkv_where_sq_and_sk_differ(no_tf32, d, sq, sk):
    """The register-tiled float32 dk/dv of the wide family, causal
    (end-aligned) with sq > sk, where rows 0..sq-sk-1 see no key and add
    nothing (their dO and Q scaled by -3 change no bit of dk and dv), and
    with sq < sk; within 1e-4 of the plain max, on [b·h, s, d]."""
    bh = 2
    q, do = (_randn((bh, sq, d), no_tf32, torch.float32, i) for i in (0, 3))
    k, v = (_randn((bh, sk, d), no_tf32, torch.float32, i) for i in (1, 2))
    got, want, _ = _wide_f32_fwd_dkv(q, k, v, do, d, None, True)
    _assert_f32(got[2:], want[2:])
    if sq > sk:
        p_lse, delta = want[1], fa.flash_delta(want[0], do)
        q2, do2 = q.clone(), do.clone()
        q2[:, :sq - sk] *= -3
        do2[:, :sq - sk] *= -3
        again = fa.flash_bwd_dkv(q2, k, v, do2, p_lse, delta, d ** -0.5,
                                 True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got[2:]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_f32_forward_ragged_gqa_and_deterministic(no_tf32, d, packed,
                                                       causal):
    """The register-tiled float32 forward of the wide family at s 200
    (ragged query and key tiles) with GQA 4 query heads over 1 kv head,
    packed (by index) and on [b·h, s, d] (K/V repeated): within 1e-4 of
    the plain max (lse 2e-5), and a second call gives the same bits."""
    got, want, again = _wide_f32_gqa(no_tf32, d, packed, causal)
    _assert_f32(got[:2], want[:2])
    assert all(torch.equal(g, g2) for g, g2 in zip(got[:2], again()[:2]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("d", [320, 512])
def test_wide_f32_dkv_ragged_gqa_and_deterministic(no_tf32, d, packed,
                                                   causal):
    """The register-tiled float32 dk/dv of the wide family at s 200 with
    GQA 4/1, packed (the 4 query heads of the kv head summed in registers)
    and on [b·h, s, d]: within 1e-4 of the plain max, and a second call
    gives the same bits."""
    got, want, again = _wide_f32_gqa(no_tf32, d, packed, causal)
    _assert_f32(got[2:], want[2:])
    assert all(torch.equal(g, g2) for g, g2 in zip(got[2:], again()[2:]))


def _wide_f32_gqa(cuda, d, packed, causal):
    b, h, kv, s = 1, 4, 1, 200
    q, do = (_randn((b, s, h * d), cuda, torch.float32, i) for i in (0, 3))
    k, v = (_randn((b, s, kv * d), cuda, torch.float32, i) for i in (1, 2))
    if not packed:
        def flat(t, n):
            return _heads(t, n).repeat_interleave(h // n, 1).reshape(
                b * h, s, d).contiguous()

        q, do, k, v = flat(q, h), flat(do, h), flat(k, kv), flat(v, kv)
    return _wide_f32_fwd_dkv(q, k, v, do, d, (h, kv) if packed else None,
                             causal)


# --------------------------- rows that see no key; the wgmma K3 and K2


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 96])
@pytest.mark.parametrize("h", [2, 32])
def test_rows_that_see_no_key_give_zero_on_the_card(no_tf32, h, d, dtype,
                                                    packed):
    """Causal with sq 300 > sk 64: rows 0-235 attend no key. The forward
    kernel (bf16 and float32, both layouts; head_dim 96 zero-padded to 128;
    2 heads or 32, which the float32 forward's plan gives query tiles of 16
    and 64) gives out 0 there, as its plain version does, and agrees with
    it everywhere: within 1e-2 (bf16) or 1e-4 (float32), lse within 2e-5;
    the dk/dv and dq kernels within 1e-2 (bf16) or 1e-4 (float32), the
    float32 dq exactly 0 on those rows."""
    cuda = no_tf32
    b, kv, sq, sk = 1, h, 300, 64
    assert fa.f32_fwd_tile(b * h, sq) == (16 if h == 2 else 64)
    make = _f32 if dtype == torch.float32 else _bf16
    q, do = make((b, sq, h * d), cuda, 0), make((b, sq, h * d), cuda, 3)
    k, v = make((b, sk, kv * d), cuda, 1), make((b, sk, kv * d), cuda, 2)
    scale = d ** -0.5
    if packed:
        args = (h, kv, scale, True)
        fwd, fwd_plain = fa.flash_fwd_packed, fa.flash_fwd_packed_plain
        dkv, dkv_plain = fa.flash_bwd_dkv_packed, fa.flash_bwd_dkv_packed_plain
        dq, dq_plain = fa.flash_bwd_dq_packed, fa.flash_bwd_dq_packed_plain
        delta_of = lambda o: fa.flash_delta_packed(o, do, h)  # noqa: E731
    else:
        q, k, v, do = (_heads(t, n).reshape(b * n, t.shape[1], d).contiguous()
                       for t, n in ((q, h), (k, kv), (v, kv), (do, h)))
        args = (scale, True)
        fwd, fwd_plain = fa.flash_fwd, fa.flash_fwd_plain
        dkv, dkv_plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain
        dq, dq_plain = fa.flash_bwd_dq, fa.flash_bwd_dq_plain
        delta_of = lambda o: fa.flash_delta(o, do)  # noqa: E731
    out, lse = fwd(q, k, v, *args)
    p_out, p_lse = fwd_plain(q, k, v, *args)
    bwd = (q, k, v, do, p_lse, delta_of(p_out), *args)
    got = [out, *dkv(*bwd), dq(*bwd)]
    want = [p_out, *dkv_plain(*bwd), dq_plain(*bwd)]
    torch.cuda.synchronize()
    tol = F32_KERNEL_TOL if dtype == torch.float32 else REL_TOL
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_err(g, w) < tol
    assert _rel_err(lse, p_lse) < STAT_TOL
    assert bool((out[:, :sq - sk] == 0).all())
    assert bool((p_out[:, :sq - sk] == 0).all())
    assert bool((out[:, sq - sk:] != 0).any())
    if dtype == torch.float32:
        assert bool((got[-1][:, :sq - sk] == 0).all())


FFN_SHAPES = [(4096, 4096, 14336), (1000, 4000, 3000), (300, 264, 1001),
              (77, 131, 72)]


@pytest.mark.parametrize("T,d,dff", FFN_SHAPES)
def test_wgmma_k3_kernel_matches_plain_version(cuda, T, d, dff):
    """The wgmma K3 at the 8B shape (TMA ring), at a shape that tiles on no
    axis, at a d_ff that is not a multiple of 8 and an odd d (the cp.async
    ring with element-wise chunks)."""
    x = _bf16((T, d), cuda, 0)
    dgate, dup = _bf16((T, dff), cuda, 1, 0.01), _bf16((T, dff), cuda, 2,
                                                       0.01)
    rstd = torch.from_numpy(np.random.default_rng(4).random(
        (T, 1)).astype(np.float32) + 0.5).to(cuda)
    nw = _bf16((d,), cuda, 5, 0.1) + 1
    before = ff.dw_gateup.launches
    dwg, dwu = ff.dw_gateup(x, rstd, nw, dgate, dup)
    p_dwg, p_dwu = ff.dw_gateup_plain(x, rstd, nw, dgate, dup)
    torch.cuda.synchronize()
    assert dwg.shape == dwu.shape == (d, dff)
    assert _rel_err(dwg, p_dwg) < REL_TOL
    assert _rel_err(dwu, p_dwu) < REL_TOL
    assert ff.dw_gateup.launches == before + 1


def test_k3_h_operand_equals_the_plain_normed_x(cuda):
    """With dgate the identity (T = d_ff = 256), dW_gate[i, t] is the
    kernel's bf16 h of token t, d row i (one nonzero term a sum): equal to
    the plain version's (x·rstd)·norm_w rounded to bf16, value for value."""
    T, d = 256, 4096
    x = _bf16((T, d), cuda, 0)
    rstd = torch.from_numpy(np.random.default_rng(4).random(
        (T, 1)).astype(np.float32) + 0.5).to(cuda)
    nw = _bf16((d,), cuda, 5, 0.1) + 1
    eye = torch.eye(T, device=cuda, dtype=torch.bfloat16)
    dwg, dwu = ff.dw_gateup(x, rstd, nw, eye, eye)
    h = ff.normed(x, rstd, nw)
    torch.cuda.synchronize()
    assert torch.equal(dwg.T, h) and torch.equal(dwu.T, h)


@pytest.mark.parametrize("T,d,dff", FFN_SHAPES)
def test_wgmma_k2_kernel_matches_plain_version(cuda, T, d, dff):
    """The wgmma K2 (shared-memory A and B, gate/up prefetched into the
    ring for the epilogue) at the same four shapes."""
    gate, up = _bf16((T, dff), cuda, 0), _bf16((T, dff), cuda, 1)
    dy = _bf16((T, d), cuda, 2, 0.01)
    wd = _bf16((dff, d), cuda, 3, dff ** -0.5)
    before = ff.dgateup.launches
    dgate, dup = ff.dgateup(dy, wd, gate, up)
    p_dgate, p_dup = ff.dgateup_plain(dy, wd, gate, up)
    torch.cuda.synchronize()
    assert dgate.shape == dup.shape == (T, dff)
    assert _rel_err(dgate, p_dgate) < REL_TOL
    assert _rel_err(dup, p_dup) < REL_TOL
    assert ff.dgateup.launches == before + 1


# ------------------------------------------------ MoE and selective remat

REMAT_MODES = ("none", "full", "dots", "dots_sans_qkv", "dots_plus_attn")
# tiny_moe widened to head_dim 128, so its attention takes the flash kernels
TINY_MOE_HD128 = dataclasses.replace(ModelConfig.tiny_moe(), **TINY_HD128)
# the routing of a CPU run must not sit near a tie (as test_torch_moe.py)
ROUTER_MARGIN = 1e-4


def _router_margin(logits) -> float:
    p = torch.softmax(logits.double().cpu(), -1).sort(-1, descending=True)[0]
    return min((p[:, 0] - p[:, 1]).min().item(),
               (p[:, 1] - p[:, 2]).min().item())


def _moe_inputs(device, dtype, B=2, S=64, d=256, E=8, ff=512, seed=59):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, S, d)),
              0.3 * rng.standard_normal((d, E)),
              *(rng.standard_normal(s) * s[-2] ** -0.5
                for s in ((E, d, ff), (E, d, ff), (E, ff, d))))
    return [torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=dtype)
            for a in arrays]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_moe_ffn_on_the_card_matches_its_cpu_run(no_tf32, dtype, tol):
    """moe_ffn (plain PyTorch, no kernel of its own) on the card against
    the same inputs on the CPU, capacity factor 1.25 (tokens dropped):
    float32 within 1e-5 of the output's largest magnitude, bfloat16 within
    1e-2; the aux loss within 1e-5 relative."""
    from ray_tpu_torch.ops.moe import moe_ffn

    cpu = _moe_inputs("cpu", dtype)
    x, router = cpu[0], cpu[1]
    logits = x.float().reshape(-1, x.shape[-1]) @ router.float()
    assert _router_margin(logits) > ROUTER_MARGIN
    want, want_aux = moe_ffn(*cpu)
    got, aux = moe_ffn(*(t.to(no_tf32) for t in cpu))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel_err(got.cpu(), want) < tol
    np.testing.assert_allclose(aux.item(), want_aux.item(), rtol=1e-5)


def _moe_loss_and_grads(cfg, params, tokens, device):
    """(loss, moe_aux, grads on the CPU, flash launches, router logits) of
    one forward and backward of `loss_fn`."""
    from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
    from ray_tpu_torch.ops import moe

    routed = []
    real = moe._route

    def recording(logits, capacity):
        routed.append(logits.detach())
        return real(logits, capacity)

    moe._route = recording
    try:
        p = {k: ({kk: vv.to(device).requires_grad_(True)
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(device).requires_grad_(True))
             for k, v in params.items()}
        leaves = list(tree_leaves(p))
        for kern in fa.KERNELS:
            kern.launches = 0
        loss, aux = loss_fn(p, {"tokens": tokens.to(device)}, cfg)
        grads = torch.autograd.grad(loss, leaves)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = {kern.__name__: kern.launches for kern in fa.KERNELS}
    finally:
        moe._route = real
    return (loss.item(), aux["moe_aux"].item(), [g.cpu() for g in grads],
            launches, routed)


def _tiny_tokens(cfg, seq=128, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, seq + 1)).astype(np.int64))


def test_tiny_moe_hd128_on_the_card_matches_its_cpu_run(no_tf32):
    """tiny_moe at head_dim 128 (float32, TF32 off): the flash pair launched
    n_layers times, the loss and aux within 1e-5 relative and every
    gradient within 1e-4 of its largest magnitude of the CPU's (einsum
    attention there)."""
    cfg = TINY_MOE_HD128
    params = init_params(cfg, seed=0, device="cpu")
    tokens = _tiny_tokens(cfg, seed=10)
    want = _moe_loss_and_grads(cfg, params, tokens, "cpu")
    assert want[3] == {k.__name__: 0 for k in fa.KERNELS}
    assert all(_router_margin(lg) > ROUTER_MARGIN for lg in want[4])
    got = _moe_loss_and_grads(cfg, params, tokens, no_tf32)
    L = cfg.n_layers
    assert got[3] == {"flash_fwd": L, "flash_bwd_dkv": L, "flash_bwd_dq": L}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert got[1] > 1.0
    for g, w in zip(got[2], want[2]):
        assert _rel_err(g, w) < 1e-4


@pytest.mark.parametrize("name", ["tiny_moe", "fused_ffn"])
def test_remat_modes_agree_on_the_card(no_tf32, name):
    """Every remat mode on the card gives the loss and gradients of `none`
    within 1e-6 relative (the same kernels recompute the same values), and
    launches the flash forward n_layers times a step without remat and
    2·n_layers with it (the recompute reruns it: no policy names its
    logsumexp), the flash backward n_layers times. `fused_ffn`: tiny at
    head_dim 128 with fused_ffn=True, fused_attn=False, the reference's
    config that wraps only the attention half."""
    if name == "tiny_moe":
        base = TINY_MOE_HD128
    else:
        base = dataclasses.replace(ModelConfig.tiny(), fused_ffn=True,
                                   **TINY_HD128)
    params = init_params(base, seed=0, device="cpu")
    tokens = _tiny_tokens(base, seed=10)
    L = base.n_layers
    results = {}
    for mode in REMAT_MODES:
        cfg = dataclasses.replace(base, remat=mode)
        results[mode] = _moe_loss_and_grads(cfg, params, tokens, no_tf32)
        fwd = L if mode == "none" else 2 * L
        assert results[mode][3] == {"flash_fwd": fwd, "flash_bwd_dkv": L,
                                    "flash_bwd_dq": L}, mode
    loss0, aux0, grads0 = results["none"][:3]
    for mode in REMAT_MODES[1:]:
        loss, aux, grads = results[mode][:3]
        np.testing.assert_allclose(loss, loss0, rtol=1e-6, err_msg=mode)
        np.testing.assert_allclose(aux, aux0, rtol=1e-6, err_msg=mode)
        for g, g0 in zip(grads, grads0):
            assert _rel_err(g, g0) <= 1e-6, mode


# ---- convert, servebench and checkpoints on the card (chip_smoke phases
# 11-13 at tiny sizes)


def test_convert_round_trip_serves_the_same_tokens(cuda):
    """state_dict_from_params then params_from_hf_state_dict on the card
    gives the params back bit for bit, and an engine on them the same
    tokens."""
    from ray_tpu_torch.models.convert import (params_from_hf_state_dict,
                                              state_dict_from_params)
    from ray_tpu_torch.models.transformer import tree_leaves

    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=cuda)
    sd = state_dict_from_params(params, cfg)
    assert all(t.device.type == "cuda" and t.dtype == torch.bfloat16
               for t in sd.values())
    back = params_from_hf_state_dict(sd, cfg, device=cuda)
    for a, b in zip(tree_leaves(params), tree_leaves(back), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    outs = []
    for p in (params, back):
        eng = serving.ContinuousBatchingEngine(p, cfg, num_slots=2,
                                               max_len=64, device=cuda)
        rids = [eng.submit([1, 2, 3, 4], max_new_tokens=8),
                eng.submit([5, 6, 7], max_new_tokens=8),
                eng.submit([9, 8], max_new_tokens=5)]
        eng.run_until_done()
        outs.append([eng.result(r) for r in rids])
    assert outs[0] == outs[1]


def test_servebench_quick_profile_on_the_card(cuda, tmp_path):
    """The runner's quick profile: rc 0, the card named, parity < 0.08, the
    quant kernel at 9 launches a w8a16 load (two loads), the dequant kernel
    at 7·L + 2 a pass."""
    import json

    from ray_tpu_torch.models import servebench

    before = [k.launches for k in quant.KERNELS]
    out = tmp_path / "sb.json"
    assert servebench.main(["--no-latency", "--json", str(out)]) == 0
    launches = [k.launches - b for k, b in zip(quant.KERNELS, before)]
    art = json.loads(out.read_text())
    assert (art["backend"], art["n_chips"]) == ("cuda", 1)
    assert art["device_name"] == torch.cuda.get_device_name(cuda)
    assert art["w8a16"]["logits_max_abs_diff_rel"] < 0.08
    per_pass = 7 * art["model"]["n_layers"] + 2
    assert launches[0] == 18
    assert launches[1] > 0 and launches[1] % per_pass == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sb.json"]


@pytest.mark.parametrize("opt", ["default", "fused"])
def test_checkpoint_resume_is_bit_identical_on_the_card(cuda, tmp_path,
                                                        opt):
    """tiny in bf16 at head_dim 128 through the flash and K3 kernels: 4
    steps straight against 2, a checkpoint, a restore into an abstract_like
    state and 2 more; losses, params and moments bit for bit."""
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.train import (abstract_like, latest_checkpoint,
                                     load_checkpoint, save_checkpoint)

    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16,
                              fused_ffn=True, fused_attn=True, **TINY_HD128)
    make = {"default": default_optimizer, "fused": fused_adamw_optimizer}
    step_fn, init_fn = make_train_step(
        cfg, make[opt](1e-3, warmup_steps=1), device=cuda)
    batch = make_batch(cfg, 2, 128, 1, cuda)

    def run(state, n):
        losses = []
        for _ in range(n):
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
        return state, losses

    def tensors(state):
        return [state.params, state.opt_state.mu, state.opt_state.nu]

    straight, want = run(init_fn(0), 4)
    state, first = run(init_fn(0), 2)
    save_checkpoint(state, str(tmp_path), step=2)
    target = abstract_like(state)
    assert all(t.device.type == "cuda" for t in tree_leaves(target.params))
    del state
    resumed, meta = load_checkpoint(latest_checkpoint(str(tmp_path)),
                                    target)
    assert meta["step"] == 2 and resumed.opt_state.count == 2
    fa.flash_fwd.launches = 0
    resumed, more = run(resumed, 2)
    assert fa.flash_fwd.launches == 2 * cfg.n_layers
    assert first + more == want
    for got, ref in zip(tensors(resumed), tensors(straight)):
        for a, b in zip(tree_leaves(got), tree_leaves(ref), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("opt", ["default", "fused"])
def test_phase_eff_times_the_real_step_on_the_card(cuda, opt):
    """measure_phase_eff on tiny in bf16 at head_dim 128: each phase of the
    real step timed on the card, finite and positive, under the optimizer
    it was given."""
    from ray_tpu_torch.models.planning import measure_phase_eff

    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16,
                              fused_ffn=True, fused_attn=True, **TINY_HD128)
    make = {"default": default_optimizer, "fused": fused_adamw_optimizer}
    m = measure_phase_eff(cfg, make[opt](warmup_steps=1),
                          make_batch(cfg, 2, 128, 1, cuda), steps=2,
                          device=cuda)
    assert m["optimizer"] == opt and m["steps"] == 2
    assert set(m["ms"]) == {"forward", "backward", "optimizer"}
    for phase, ms in m["ms"].items():
        assert math.isfinite(ms) and ms > 0, phase
        assert 0 < m["eff"][phase] < 1, phase


# ---------------------------------------------------------------- sharded


@pytest.fixture
def nccl_world_one(cuda):
    """A one-rank NCCL process group and its mesh."""
    from ray_tpu_torch.parallel import (MeshConfig, initialize_group,
                                        make_mesh, shutdown_group)

    initialize_group(0, 1, device="cuda")
    try:
        yield make_mesh(MeshConfig())
    finally:
        shutdown_group()


@pytest.mark.parametrize("opt", ["default", "fused"])
def test_world_one_nccl_sharded_step_is_the_unsharded_step(nccl_world_one,
                                                           opt):
    """tiny in bf16 at head_dim 128 (the flash kernels, K3 and, under fused
    AdamW, the AdamW kernel): 3 steps through NCCL's gathers and
    reductions equal the unsharded steps bit for bit, with the same
    launches."""
    import torch.distributed as dist

    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.train import to_local

    assert dist.get_backend() == "nccl"
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16,
                              fused_ffn=True, fused_attn=True, **TINY_HD128)
    make = {"default": default_optimizer, "fused": fused_adamw_optimizer}
    kernels = (*fa.KERNELS, ff.dw_gateup, aw.adamw_update)
    batch = make_batch(cfg, 2, 128, 1, "cuda")
    runs = []
    for mesh in (None, nccl_world_one):
        step_fn, init_fn = make_train_step(
            cfg, make[opt](1e-3, warmup_steps=1), "cuda", mesh=mesh)
        state, rows = init_fn(0), []
        for _ in range(3):
            for kern in kernels:
                kern.launches = 0
            state, m = step_fn(state, batch)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         [kern.launches for kern in kernels]))
        runs.append((rows, [t.clone() for t in tree_leaves(
            to_local(state.params))]))
    (want, p0), (got, p1) = runs
    assert got == want
    n_adamw = len(p0) if opt == "fused" else 0
    assert got[0][2] == [cfg.n_layers] * 4 + [n_adamw]
    assert all(torch.equal(a, b) for a, b in zip(p0, p1, strict=True))


# The local blocks of every Llama-3-8B leaf at fsdp 4 (the norms whole).
FSDP4_SHARDS = [(128256, 1024), (1024, 128256), (32, 1024, 4096),
                (32, 1024, 1024), (32, 4096, 1024), (32, 1024, 14336),
                (32, 14336, 1024), (32, 4096), (4096,)]


@pytest.mark.parametrize("shape", FSDP4_SHARDS)
def test_adamw_kernel_bitwise_at_the_fsdp4_shard_shapes(cuda, shape):
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    c1, c2 = aw.bias_correction(0.9, 3), aw.bias_correction(0.95, 3)
    clip = torch.tensor(0.61, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)

    def draw(scale, dtype=torch.float32, uniform=False):
        x = (torch.rand if uniform else torch.randn)(shape, generator=gen,
                                                     device=cuda)
        return (scale * x).to(dtype)

    p, g = draw(0.02, torch.bfloat16), draw(1e-2, torch.bfloat16)
    mu, nu = draw(1e-3), draw(1e-5, uniform=True)
    want = [t.clone() for t in (p, mu, nu)]
    aw.adamw_update(p, g, mu, nu, 3e-4, clip, c1, c2, **hyper)
    aw.adamw_update_plain(want[0], g, want[1], want[2], 3e-4, clip, c1, c2,
                          **hyper)
    torch.cuda.synchronize()
    assert torch.equal(p.view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(mu, want[1]) and torch.equal(nu, want[2])


def test_four_card_parity(cuda, tmp_path):
    """The 4-card runner's parity phase (ray_tpu_torch.multichip): fsdp 4
    and dp 4 against one card at 8B width, 8 layers."""
    from ray_tpu_torch import multichip

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, this host has "
                    f"{torch.cuda.device_count()}")
    out = multichip.main(["--chips", "4", "--phases", "parity", "--json",
                          str(tmp_path / "multichip.json")])
    assert {"fsdp", "dp", "one_card"} <= set(out["parity"])


# ---------------------------------------------------------------- tp and sp


@pytest.mark.parametrize("T,tp", [(8192, 2), (8192, 4)])
def test_ffn_kernels_at_the_tp_local_widths(cuda, T, tp):
    """K1, K2 and K3 at llama3_8b's d_ff split over tp (7168, 3584 columns)
    on a card's tokens of the fsdp 2 x tp 2 run (2 rows of 4096)."""
    d, dff = 4096, 14336 // tp
    x, dgate, dup = (_bf16(s, cuda, i) for i, s in enumerate(
        ((T, d), (T, dff), (T, dff))))
    gate, up = _bf16((T, dff), cuda, 3), _bf16((T, dff), cuda, 4)
    dy = _bf16((T, d), cuda, 5, 0.01)
    wd = _bf16((dff, d), cuda, 6, dff ** -0.5)
    rstd = torch.rand((T, 1), device=cuda) + 0.5
    nw = _bf16((d,), cuda, 7, 0.1) + 1
    before = [k.launches for k in ff.KERNELS]
    got = {"dw_gateup": ff.dw_gateup(x, rstd, nw, dgate, dup),
           "dw_down": (ff.dw_down(gate, up, dy),),
           "dgateup": ff.dgateup(dy, wd, gate, up)}
    want = {"dw_gateup": ff.dw_gateup_plain(x, rstd, nw, dgate, dup),
            "dw_down": (ff.dw_down_plain(gate, up, dy),),
            "dgateup": ff.dgateup_plain(dy, wd, gate, up)}
    torch.cuda.synchronize()
    for name in got:
        for g, w in zip(got[name], want[name], strict=True):
            assert g.shape == w.shape
            assert _rel_err(g, w) < REL_TOL, name
    assert [k.launches for k in ff.KERNELS] == [b + 1 for b in before]


@pytest.mark.parametrize("bh,s", [(2 * 16, 4096), (4 * 8, 2048),
                                  (1 * 8, 8192)],
                         ids=["fsdp2xtp2", "tp4", "ulysses_sp4"])
def test_flash_kernels_at_the_tp_and_sp_local_heads(cuda, bh, s):
    """The flash pair on the heads a card computes: 16 of 32 heads at tp 2
    (2 rows of 4096), 8 at tp 4 (4 x 2048), 8 over the whole 8192 under
    Ulysses at sp 4 (or tp 2 x sp 2), head_dim 128, causal."""
    d = 128
    q, k, v, do = (_bf16((bh, s, d), cuda, i) for i in range(4))
    scale = d ** -0.5
    before = [kern.launches for kern in fa.KERNELS]
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, True)
    delta = fa.flash_delta(p_out, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, p_lse, delta, scale, True)
    dq = fa.flash_bwd_dq(q, k, v, do, p_lse, delta, scale, True)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, scale,
                                        True)
    p_dq = fa.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, scale, True)
    torch.cuda.synchronize()
    for got, want, name in ((out, p_out, "out"), (lse, p_lse, "lse"),
                            (dq, p_dq, "dq"), (dk, p_dk, "dk"),
                            (dv, p_dv, "dv")):
        assert _rel_err(got, want) < REL_TOL, name
    assert [kern.launches for kern in fa.KERNELS] == [b + 1 for b in before]


def test_fused_blocks_with_a_one_rank_tp_group_on_the_card(cuda):
    """attn_block and ffn_block with a one-rank NCCL tp group: output and
    every gradient bit-identical to the blocks without a group."""
    import torch.distributed as dist

    from ray_tpu_torch.ops.kernels.fused_attn import attn_block
    from ray_tpu_torch.ops.kernels.fused_ffn import ffn_block
    from ray_tpu_torch.ops.layers import rotary_embedding
    from ray_tpu_torch.parallel import initialize_group, shutdown_group

    b, s, d, nq, nkv, dff = 2, 256, 1024, 8, 2, 2048
    hd = d // nq
    x, dy = _bf16((b, s, d), cuda, 0), _bf16((b, s, d), cuda, 1, 0.01)
    attn_w = [_bf16((d,), cuda, 2, 0.1) + 1,
              _bf16((d, nq * hd), cuda, 3, d ** -0.5),
              _bf16((d, nkv * hd), cuda, 4, d ** -0.5),
              _bf16((d, nkv * hd), cuda, 5, d ** -0.5),
              _bf16((nq * hd, d), cuda, 6, d ** -0.5)]
    ffn_w = [_bf16((d,), cuda, 7, 0.1) + 1,
             _bf16((d, dff), cuda, 8, d ** -0.5),
             _bf16((d, dff), cuda, 9, d ** -0.5),
             _bf16((dff, d), cuda, 10, dff ** -0.5)]
    cos, sin = rotary_embedding(torch.arange(s, device=cuda), hd)
    initialize_group(0, 1, device="cuda")
    try:
        for fn, ws, extra in ((attn_block, attn_w,
                               (cos[None], sin[None], nq, nkv, 1e-5)),
                              (ffn_block, ffn_w, (1e-5,))):
            runs = []
            for group in (None, dist.group.WORLD):
                leaves = [t.clone().requires_grad_(True) for t in (x, *ws)]
                y = fn(*leaves, *extra, tp_group=group)
                runs.append((y, torch.autograd.grad(y, leaves, dy)))
            (y0, g0), (y1, g1) = runs
            assert torch.equal(y0, y1)
            assert all(torch.equal(a, c) for a, c in zip(g0, g1))
    finally:
        shutdown_group()


def test_checkpoint_carries_cuda_leaves_as_cpu_tensors(cuda, tmp_path):
    """A checkpoint of CUDA tensors: as given in its own process; pickled
    (to the Tuner's driver), CPU tensors of the same dtype, shape and bits;
    through a directory, CPU tensors."""
    import pickle

    from ray_tpu_torch.air import Checkpoint

    want = {"w": _bf16((64, 32), cuda, 0), "b": torch.randn(7, device=cuda),
            "n": [torch.arange(3, device=cuda), None]}
    ck = Checkpoint.from_dict(want)
    assert ck.to_dict()["w"].is_cuda
    for got in (pickle.loads(pickle.dumps(ck)).to_dict(),
                Checkpoint.from_directory(
                    ck.to_directory(str(tmp_path))).to_dict()):
        for g, w in ((got["w"], want["w"]), (got["b"], want["b"]),
                     (got["n"][0], want["n"][0])):
            assert g.device.type == "cpu" and g.dtype == w.dtype
            assert torch.equal(g, w.cpu())
        assert got["n"][1] is None


def test_iter_torch_batches_lands_on_the_current_card(cuda):
    import ray_tpu_torch
    from ray_tpu_torch import data

    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 1})
    try:
        ds = data.from_numpy({"x": np.arange(6.0)})
        (batch,) = list(ds.iter_torch_batches(batch_size=8))
        assert batch["x"].device == torch.device(
            "cuda", torch.cuda.current_device())
        (cpu,) = list(ds.iter_torch_batches(batch_size=8, device="cpu"))
        assert cpu["x"].device.type == "cpu"
    finally:
        ray_tpu_torch.shutdown()


def test_torch_predictor_on_the_card_is_its_cpu_run(no_tf32):
    """TorchPredictor on the card (its default) against its CPU run on the
    same float32 `tiny` params and tokens: within 1e-5, returned as numpy
    on the host."""
    from ray_tpu_torch.models.transformer import forward, tree_leaves
    from ray_tpu_torch.train import TorchPredictor

    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=3, device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 33))

    def apply(p, batch):
        logits = forward(p, batch["tokens"][:, :-1], cfg)
        return {"last": logits[:, -1],
                "nll": torch.nn.functional.cross_entropy(
                    logits.transpose(1, 2), batch["tokens"][:, 1:],
                    reduction="none").mean(1)}

    on_card = TorchPredictor(params, apply)
    assert all(t.is_cuda for t in tree_leaves(on_card._params))
    got = on_card.predict({"tokens": tokens})
    want = TorchPredictor(params, apply, device="cpu").predict(
        {"tokens": tokens})
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_use_gpu_worker_holds_its_grant_as_its_device(cuda):
    """One `ScalingConfig(use_gpu=True)` worker: its `get_gpu_ids()` names
    `torch.cuda.current_device()`, and `train.torch.get_device()` is that
    card."""
    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig, session
    from ray_tpu_torch.train import DataParallelTrainer

    def loop():
        import torch

        import ray_tpu_torch
        from ray_tpu_torch.train.torch import get_device

        session.report({"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                        "current": torch.cuda.current_device(),
                        "device": str(get_device())})

    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 1})
    try:
        result = DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1,
                                               use_gpu=True)).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    m = result.metrics
    assert m["gpu_ids"] == [m["current"]] and m["device"] == \
        f"cuda:{m['current']}"


def test_ppo_learner_on_the_card_matches_its_cpu_run(cuda):
    """A `PPOLearner` on the card and one on the CPU, the same seed and the
    same batch (tests/test_learner_group.py's `_ppo_batch` at 64 rows),
    four updates: params and Adam state on cuda:0, the losses within 1e-5
    relative, the params within 1e-6 (TF32 off: float32 products)."""
    from ray_tpu_torch.rllib.ppo import PPOLearner

    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(64, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 64),
             "logp": rng.normal(size=64).astype(np.float32) * 0.1 - 0.7,
             "advantages": rng.normal(size=64).astype(np.float32),
             "returns": rng.normal(size=64).astype(np.float32)}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = PPOLearner(4, 2, lr=1e-3, seed=7)
        cpu = PPOLearner(4, 2, lr=1e-3, seed=7, device="cpu")
        assert {str(v.device) for v in card.params.values()} == {"cuda:0"}
        assert card.opt_state.mu["w0"].device.type == "cuda"
        for _ in range(4):
            a, b = card.update(batch), cpu.update(batch)
            assert math.isclose(float(a["total_loss"]),
                                float(b["total_loss"]), rel_tol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    wc, wp = card.get_weights(), cpu.get_weights()
    for k in wp:
        np.testing.assert_allclose(wc[k], wp[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_sac_learner_on_the_card_updates_with_its_own_noise(cuda):
    """A `SACLearner` at the reference's widths (256-256) on the card:
    params, Adam state, the target critics and the generator on cuda:0;
    four updates of a Pendulum-shaped batch of 256 drawing their standard
    normals on the card, finite; given the same normals in the batch, a
    CPU learner's losses within 1e-5 relative (TF32 off)."""
    from ray_tpu_torch.rllib.sac import SACLearner

    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(256, 3)).astype(np.float32),
             "actions": rng.uniform(-2, 2, (256, 1)).astype(np.float32),
             "rewards": rng.normal(size=256).astype(np.float32),
             "next_obs": rng.normal(size=(256, 3)).astype(np.float32),
             "dones": np.zeros(256, np.float32)}
    kw = dict(lr=3e-4, gamma=0.99, tau=0.005, target_entropy=-1.0, seed=0)
    card = SACLearner(3, 1, 2.0, **kw)
    where = {str(v.device) for tree in (card.params, card.extra)
             for v in _leaves(tree)} | {
        str(v.device) for v in _leaves(card.opt_state.mu)}
    assert where == {"cuda:0"} and card._rng.device.type == "cuda"
    for _ in range(4):
        stats = card.update_batch(batch)
        assert all(math.isfinite(v) for v in stats.values()), stats
    assert all(bool(torch.isfinite(v).all()) for v in _leaves(card.params))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = SACLearner(3, 1, 2.0, **kw)
        b = SACLearner(3, 1, 2.0, **kw, device="cpu")
        for u in range(3):
            noisy = {**batch,
                     "next_eps": rng.normal(size=(256, 1)).astype(np.float32),
                     "eps": rng.normal(size=(256, 1)).astype(np.float32)}
            sa, sb = a.update_batch(noisy), b.update_batch(noisy)
            assert math.isclose(sa["critic_loss"], sb["critic_loss"],
                                rel_tol=1e-5), (u, sa, sb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _leaves(tree):
    """The tensors of nested dicts."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
