"""Bridge: a JAX parameter tree moves into the port and back bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.ops.pallas.adamw import FusedAdamWState
from ray_tpu.train.step import TrainState as JaxTrainState
from ray_tpu_torch.bridge import (params_from_jax, params_to_numpy,
                                  train_state_from_jax, train_state_to_numpy)
from ray_tpu_torch.models import ModelConfig, count_params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _quantized_layout(tree):
    """The w8a16 tree layout ({"int8", "scale"} leaves for the projections,
    the embedding and the LM head) with seeded values."""
    rng = np.random.default_rng(0)

    def q(a):
        return {"int8": rng.integers(-127, 128, a.shape).astype(np.int8),
                "scale": rng.random((*a.shape[:-1], 1)).astype(np.float32)}

    out = dict(tree)
    out["layers"] = {k: (q(v) if k.startswith("w") else v)
                     for k, v in tree["layers"].items()}
    out["embed"], out["lm_head"] = q(tree["embed"]), q(tree["lm_head"])
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_round_trip_is_bitwise(dtype, quantized):
    _round_trip("tiny", dtype, quantized)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_moe_round_trip_is_bitwise(dtype, quantized):
    """The MoE tree: router [L, d, E] (never quantized), experts
    [L, E, d, ff] / [L, E, ff, d] (int8 row by row when quantized)."""
    params = _round_trip("tiny_moe", dtype, quantized)
    layers = params["layers"]
    assert tuple(layers["router"].shape) == (2, 128, 4)
    assert layers["router"].dtype == getattr(torch, dtype)
    w_down = layers["w_down"]["scale"] if quantized else layers["w_down"]
    assert tuple(w_down.shape)[:3] == (2, 4, 256)


def _round_trip(preset, dtype, quantized):
    jcfg = dataclasses.replace(getattr(JaxConfig, preset)(),
                               dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(getattr(ModelConfig, preset)(),
                              dtype=getattr(torch, dtype))
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(3), jcfg))
    if quantized:
        tree = _quantized_layout(tree)

    params = params_from_jax(tree, cfg, device="cpu")
    src = dict(_leaves(tree))
    got = dict(_leaves(params))
    assert src.keys() == got.keys()
    for name, t in got.items():
        assert isinstance(t, torch.Tensor), name
        assert tuple(t.shape) == src[name].shape, name
    if quantized:
        assert params["layers"]["wq"]["int8"].dtype == torch.int8
        assert params["layers"]["wq"]["scale"].dtype == torch.float32
        assert params["layers"]["attn_norm"].dtype == getattr(torch, dtype)
    else:
        assert params["layers"]["wq"].dtype == getattr(torch, dtype)
    assert count_params(params) == sum(a.size for a in src.values())

    back = dict(_leaves(params_to_numpy(params)))
    for name, a in src.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(_bits(back[name]), _bits(a),
                                      err_msg=name)
    return params


def test_shape_mismatch_is_refused():
    tree = {"embed": np.zeros((16, 8), np.float32)}
    with pytest.raises(ValueError, match="embed shape"):
        params_from_jax(tree, ModelConfig.tiny(), device="cpu")


def test_fused_adamw_state_carries_across_bitwise():
    """A JAX TrainState whose optimizer state is the reference's
    FusedAdamWState (bf16 params, float32 mu and nu, count 5): every leaf
    arrives bit for bit, nu stays float32, and it goes back unchanged."""
    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(7)

    def moments(scale):
        return jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(p.shape)).astype(
                np.float32), params)

    opt = FusedAdamWState(count=np.int32(5), mu=moments(1e-3),
                          nu=jax.tree_util.tree_map(np.abs, moments(1e-5)))
    state = train_state_from_jax(
        JaxTrainState(params=params, opt_state=opt, step=np.int32(5)), cfg,
        device="cpu")
    assert state.opt_state.count == 5 and state.step == 5
    assert state.params["layers"]["wq"].dtype == torch.bfloat16
    assert state.opt_state.nu["layers"]["wq"].dtype == torch.float32
    back = train_state_to_numpy(state)
    for key, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
        src = dict(_leaves(tree))
        got = dict(_leaves(back[key]))
        assert src.keys() == got.keys()
        for name, a in src.items():
            assert got[name].dtype == a.dtype, (key, name)
            np.testing.assert_array_equal(_bits(got[name]), _bits(a),
                                          err_msg=f"{key} {name}")
