"""The port on a CUDA device: the hand-written kernels against their plain
PyTorch versions, and the engine's serving path through them.

Every test here needs a GPU and skips with a reason where there is none.
The file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import ModelConfig, init_params
from ray_tpu_torch.models import inference, serving
from ray_tpu_torch.ops.kernels import quant

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


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
    cfg = ModelConfig.tiny()
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
