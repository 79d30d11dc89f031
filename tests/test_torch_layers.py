"""ops/layers: the port against ray_tpu/ops/layers.py on the same inputs.

float32 within 1e-6 absolute; bfloat16 within one bfloat16 ulp of the
reference value (the two frameworks may round an intermediate differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layers as jl
from ray_tpu_torch.ops import layers as tl

RNG = np.random.default_rng(7)
X = RNG.standard_normal((3, 9, 64)).astype(np.float32)
W = (1.0 + 0.1 * RNG.standard_normal(64)).astype(np.float32)
Q = RNG.standard_normal((2, 37, 4, 32)).astype(np.float32)
G = (2 * RNG.standard_normal((5, 48))).astype(np.float32)
U = RNG.standard_normal((5, 48)).astype(np.float32)
POS = np.arange(37)


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert (np.abs(got - want) <= ulp).all(), \
            float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    _close(tl.rms_norm(_t(X, dtype), _t(W, dtype)),
           jl.rms_norm(_j(X, dtype), _j(W, dtype)), dtype)


def test_rotary_embedding_tables():
    jc, js = jl.rotary_embedding(jnp.asarray(POS), 32)
    tc, ts = tl.rotary_embedding(torch.from_numpy(POS), 32)
    _close(tc, jc, "float32")
    _close(ts, js, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary(dtype):
    jc, js = jl.rotary_embedding(jnp.asarray(POS), 32)
    cos, sin = np.array(jc)[None], np.array(js)[None]
    got = tl.apply_rotary(_t(Q, dtype), torch.from_numpy(cos),
                          torch.from_numpy(sin))
    want = jl.apply_rotary(_j(Q, dtype), jnp.asarray(cos), jnp.asarray(sin))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    _close(tl.swiglu(_t(G, dtype), _t(U, dtype)),
           jl.swiglu(_j(G, dtype), _j(U, dtype)), dtype)
