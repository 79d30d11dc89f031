"""models/inference: the port against ray_tpu/models/inference.py at the tiny
float32 config, with the JAX parameters moved over by the bridge.

Logits agree within 1e-4 and caches within 1e-5 (float32 sums taken in
another order); greedy tokens are equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models import inference as jinf
from ray_tpu.models.serving import quantize_model_params as jax_quantize
from ray_tpu.models.transformer import lm_head_weights as jax_lm_head
from ray_tpu_torch.bridge import params_from_jax
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models.serving import quantize_model_params
from ray_tpu_torch.models.transformer import lm_head_weights

JCFG, CFG = JaxConfig.tiny(), ModelConfig.tiny()
MAX_LEN = 32
RNG = np.random.default_rng(11)
# jitted once per module: op-by-op JAX would retrace the layer scan per call
jax_prefill = jax.jit(jinf.prefill, static_argnums=(2, 3))
jax_decode_step = jax.jit(jinf.decode_step, static_argnums=3)


@functools.lru_cache(maxsize=None)
def _params(quantized=False):
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JCFG)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CFG,
                         device="cpu")
    if quantized:
        return jax_quantize(jp, JCFG), quantize_model_params(tp, CFG)
    return jp, tp


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_matches_reference(quantized, padded):
    jp, tp = _params(quantized)
    tokens = RNG.integers(0, CFG.vocab_size, (3, 11)).astype(np.int32)
    index = np.array([10, 4, 7], np.int32) if padded else None
    jl, jc = jax_prefill(jp, jnp.asarray(tokens), JCFG, MAX_LEN,
                         None if index is None else jnp.asarray(index))
    tl, tc = tinf.prefill(tp, torch.from_numpy(tokens), CFG, MAX_LEN,
                          None if index is None else torch.from_numpy(index))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (3, 512)
    _close(tl, jl, 1e-4)
    _close(tc["k"], jc["k"], 1e-5)
    _close(tc["v"], jc["v"], 1e-5)
    assert int(tc["length"]) == int(jc["length"])


@pytest.mark.parametrize("start", [0, MAX_LEN + 2])
def test_decode_steps_match_reference(start):
    """Two decode steps from a prefilled cache; start past max_len checks
    that the write position clamps to the last row as the reference's."""
    jp, tp = _params()
    tokens = RNG.integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    _, jc = jax_prefill(jp, jnp.asarray(tokens), JCFG, MAX_LEN)
    _, tc = tinf.prefill(tp, torch.from_numpy(tokens), CFG, MAX_LEN)
    if start:
        jc = {**jc, "length": jnp.asarray(start, jnp.int32)}
        tc = {**tc, "length": torch.tensor(start, dtype=torch.int32)}
    for _ in range(2):
        tok = RNG.integers(0, CFG.vocab_size, (2,)).astype(np.int32)
        jl, jc = jax_decode_step(jp, jc, jnp.asarray(tok), JCFG)
        tl, tc = tinf.decode_step(tp, tc, torch.from_numpy(tok), CFG)
        _close(tl, jl, 1e-4)
        _close(tc["k"], jc["k"], 1e-5)
        _close(tc["v"], jc["v"], 1e-5)
        assert int(tc["length"]) == int(jc["length"])


@pytest.mark.parametrize("prompt, n", [([[5, 17, 400, 3]], 8),
                                       ([[1, 2, 3], [7, 8, 9]], 6),
                                       ([[4, 4]], 0)])
def test_generate_greedy_matches_reference(prompt, n):
    jp, tp = _params()
    want = np.asarray(jinf.generate(jp, jnp.asarray(prompt, jnp.int32), JCFG,
                                    max_new_tokens=n, max_len=MAX_LEN))
    got = tinf.generate(tp, torch.tensor(prompt, dtype=torch.int32), CFG,
                        max_new_tokens=n, max_len=MAX_LEN)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampling_follows_its_generator():
    _, tp = _params()
    prompt = torch.tensor([[5, 17, 400, 3]], dtype=torch.int32)

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return tinf.generate(tp, prompt, CFG, max_new_tokens=6,
                             max_len=MAX_LEN, temperature=0.8, generator=gen)

    a, b = sample(1), sample(1)
    assert torch.equal(a, b)
    assert tuple(a.shape) == (1, 10)
    assert ((a >= 0) & (a < CFG.vocab_size)).all()


def test_tied_lm_head_matches_reference():
    jcfg = dataclasses.replace(JCFG, tie_embeddings=True)
    cfg = dataclasses.replace(CFG, tie_embeddings=True)
    jp = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(2), jcfg))
    tp = params_from_jax(jp, cfg, device="cpu")
    assert "lm_head" not in tp
    _close(lm_head_weights(tp, cfg), jax_lm_head(jp, jcfg), 0)
    # quantized: the reference reads the port's own int8 leaves (the quant
    # itself is held to the reference in test_torch_quant.py)
    tq = quantize_model_params(tp, cfg)
    jq = {**jp, "embed": {k: v.numpy() for k, v in tq["embed"].items()}}
    _close(lm_head_weights(tq, cfg), jax_lm_head(jq, jcfg), 0)
