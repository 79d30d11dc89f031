"""models/convert: the port's HF Llama conversion against the JAX package's
(leaf for leaf, exact in float32) and against transformers' own logits
(2e-4, as tests/test_convert.py), on a tiny in-memory LlamaForCausalLM."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from ray_tpu.models.convert import load_hf_llama as jax_load_hf_llama
from ray_tpu_torch.bridge import params_to_numpy
from ray_tpu_torch.models.convert import (config_from_hf, load_hf_llama,
                                          params_from_hf_state_dict,
                                          state_dict_from_params)
from ray_tpu_torch.models.transformer import forward


def _tiny_hf_llama(tie=False):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tie, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("tie", [False, True])
def test_load_matches_the_jax_package_leaf_for_leaf(tie):
    model = _tiny_hf_llama(tie)
    params, cfg = load_hf_llama(model, dtype=torch.float32, device="cpu")
    jparams, jcfg = jax_load_hf_llama(model, dtype=jnp.float32)
    assert cfg.tie_embeddings == tie and ("lm_head" in params) == (not tie)
    for field in dataclasses.fields(jcfg):
        if field.name != "dtype":
            assert getattr(cfg, field.name) == getattr(jcfg, field.name), \
                field.name
    got = dict(_leaves(params_to_numpy(params)))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for name, a in want.items():
        assert got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.mark.parametrize("tie", [False, True])
def test_logits_match_transformers(tie):
    model = _tiny_hf_llama(tie)
    params, cfg = load_hf_llama(model, dtype=torch.float32, device="cpu")
    assert cfg.n_kv_heads == 2
    tokens = torch.tensor([[1, 5, 9, 2, 77, 33, 4, 8]])
    with torch.no_grad():
        hf_logits = model(tokens).logits
        ours = forward(params, tokens, cfg)
    np.testing.assert_allclose(ours.numpy(), hf_logits.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_dict_round_trip_is_bitwise(dtype):
    """HF -> port -> HF gives back the model's own state dict (cast once to
    `dtype`), in the params' dtype (ROADMAP C.5: the reference returns
    float32), as tensors that share no storage with the params; and
    port -> HF -> port gives back the params bit for bit."""
    model = _tiny_hf_llama()
    params, cfg = load_hf_llama(model, dtype=dtype, device="cpu")
    sd = state_dict_from_params(params, cfg)
    hf = model.state_dict()
    assert sd.keys() == hf.keys()
    for k, v in sd.items():
        assert v.dtype == dtype and v.is_contiguous(), k
        assert torch.equal(v, hf[k].to(dtype)), k
    owners = {t.untyped_storage().data_ptr() for _, t in _leaves(params)}
    assert not owners & {v.untyped_storage().data_ptr()
                         for v in sd.values()}
    back = params_from_hf_state_dict(sd, cfg, device="cpu")
    for (name, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_round_trip_into_transformers_keeps_the_logits():
    model = _tiny_hf_llama()
    params, cfg = load_hf_llama(model, dtype=torch.float32, device="cpu")
    fresh = _tiny_hf_llama()
    with torch.no_grad():
        for t in fresh.parameters():
            t.add_(1.0)
    fresh.load_state_dict(state_dict_from_params(params, cfg))
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    with torch.no_grad():
        assert torch.equal(fresh(tokens).logits, model(tokens).logits)


def test_bare_llama_model_keys_and_missing_lm_head():
    """A LlamaModel state dict (no `model.` prefix, no head) converts under
    tie_embeddings and is refused without it."""
    model = _tiny_hf_llama()
    params, cfg = load_hf_llama(model, dtype=torch.float32, device="cpu")
    bare = {k[len("model."):]: v for k, v in model.state_dict().items()
            if k.startswith("model.")}
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    got = params_from_hf_state_dict(bare, tied, device="cpu")
    assert "lm_head" not in got
    assert torch.equal(got["layers"]["wq"], params["layers"]["wq"])
    with pytest.raises(ValueError, match="no lm_head.weight"):
        params_from_hf_state_dict(bare, cfg, device="cpu")


def test_config_copies_the_reference_quirks():
    """rope_scaling and head_dim are not read (as the reference); remat and
    loss_chunk keep the ModelConfig defaults."""
    hf = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                   "low_freq_factor": 1.0,
                                   "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 64})
    cfg = config_from_hf(hf)
    assert cfg.head_dim == 16 and cfg.dtype == torch.bfloat16
    assert cfg.remat == "full" and cfg.loss_chunk == 0

