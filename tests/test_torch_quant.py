"""Int8 quant/dequant: the port against ray_tpu/ops/pallas/quant.py.

The JAX functions run their Pallas kernels in interpret mode on the CPU; the
port's wrappers run their plain PyTorch versions for CPU tensors. Both must
agree EXACTLY: scale = max(absmax, 1e-8) * float32(1/127) and
rint(x / scale) with an IEEE division reproduce the reference bit for bit.
The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models.serving import quantize_model_params as jax_quantize
from ray_tpu.ops.pallas.quant import dequantize_int8 as jax_dequantize
from ray_tpu.ops.pallas.quant import quantize_int8 as jax_quantize_int8
from ray_tpu_torch.bridge import params_from_jax
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.serving import quantize_model_params
from ray_tpu_torch.ops.kernels import quant

SHAPES = [(300, 130), (3, 5, 64), (257, 1000)]
DTYPES = ["float32", "bfloat16"]


def _input(shape, dtype, seed=0):
    x = (3 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0  # an all-zero row: the 1e-8 floor
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference_exactly(shape, dtype):
    jx, tx = _input(shape, dtype)
    jv, js = jax_quantize_int8(jx)
    tv, ts = quant.quantize_int8(tx)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (*shape[:-1], 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_dequantize_matches_reference_exactly(shape, out_dtype):
    jx, _ = _input(shape, "float32", seed=1)
    jv, js = jax_quantize_int8(jx)
    want = jax_dequantize(jv, js, getattr(jnp, out_dtype))
    got = quant.dequantize_int8(torch.from_numpy(np.array(jv)),
                                torch.from_numpy(np.array(js)),
                                getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_quantize_model_params_matches_reference_tree():
    """bfloat16, the serving dtype; float32 is covered leaf by leaf above."""
    jcfg = JaxConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=256, dtype=jnp.bfloat16)
    cfg = ModelConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=256, dtype=torch.bfloat16)
    tree = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(5),
                                                      jcfg)
    want = jax.tree_util.tree_map(np.asarray, jax_quantize(tree, jcfg))
    got = quantize_model_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg,
                        device="cpu"), cfg)
    assert got.keys() == want.keys()
    assert got["layers"].keys() == want["layers"].keys()
    for name in ("embed", "lm_head"):
        for part in ("int8", "scale"):
            np.testing.assert_array_equal(got[name][part].numpy(),
                                          want[name][part], err_msg=name)
    for name, leaf in want["layers"].items():
        if isinstance(leaf, dict):
            for part in ("int8", "scale"):
                np.testing.assert_array_equal(
                    got["layers"][name][part].numpy(), leaf[part],
                    err_msg=name)
        else:
            assert isinstance(got["layers"][name], torch.Tensor), name


def test_cpu_tensors_launch_nothing():
    before = [k.launches for k in quant.KERNELS]
    v, s = quant.quantize_int8(torch.ones(4, 8))
    quant.dequantize_int8(v, s, torch.float32)
    assert [k.launches for k in quant.KERNELS] == before


@pytest.mark.parametrize("call, err", [
    (lambda: quant.quantize_int8(torch.ones(4, 8, dtype=torch.float16)),
     TypeError),
    (lambda: quant.quantize_int8(torch.ones(4, 0)), ValueError),
    (lambda: quant.dequantize_int8(torch.ones(4, 8), torch.ones(4, 1)),
     TypeError),
    (lambda: quant.dequantize_int8(torch.ones(4, 8, dtype=torch.int8),
                                   torch.ones(3, 1)), ValueError),
    (lambda: quant.dequantize_int8(torch.ones(4, 8, dtype=torch.int8),
                                   torch.ones(4, 1), torch.int32), TypeError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()
