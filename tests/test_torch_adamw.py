"""ops/kernels/adamw: the plain AdamW update against the reference's
`_adamw_kernel` (Pallas, interpret mode) and the port's FusedAdamW against
the reference's FusedAdamW.apply, on the CPU.

Inputs come from a seeded numpy generator and go to both sides. The kernel
comparison feeds both the same float32 scalars: the new bfloat16 parameter
agrees within one bf16 ulp (both round the same float32 value, which XLA
may form with a contracted multiply-add) and the float32 moments within
1e-6 relative to the larger of the two terms each sums (b·m and (1-b)·g
may nearly cancel in the first moment, where a fused multiply-add moves
the last bit of a tiny result). The optimizer comparison uses the
reference's own test tolerance against optax (rtol 2e-5, atol 2e-6): the
global norm is summed in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tpu.ops.pallas import adamw as jadamw
from ray_tpu_torch.ops.kernels import adamw as tadamw
from ray_tpu_torch.train.step import global_norm

HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
LANES = 128


def _reference_kernel(p, g, mu, nu, scalars, rows_per_block):
    """The reference's `_adamw_kernel` as `_leaf_update` launches it
    (adamw.py:58-83), with (rows_per_block, 128) blocks."""
    rows = p.size // LANES
    spec = pl.BlockSpec((rows_per_block, LANES), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    shape2d = (rows, LANES)
    po, muo, nuo = pl.pallas_call(
        functools.partial(jadamw._adamw_kernel, **HYPER),
        grid=(rows // rows_per_block,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), spec, spec, spec,
                  spec],
        out_specs=[spec, spec, spec],
        out_shape=[jax.ShapeDtypeStruct(shape2d, p.dtype),
                   jax.ShapeDtypeStruct(shape2d, jnp.float32),
                   jax.ShapeDtypeStruct(shape2d, jnp.float32)],
        interpret=True,
    )(scalars, *(a.reshape(shape2d) for a in (p, g, mu, nu)))
    return po, muo, nuo


def _bf16_bits(x):
    return np.asarray(x).view(np.uint16).astype(np.int32)


@pytest.mark.parametrize("step", [1, 7])
def test_plain_update_matches_reference_kernel(step):
    """bf16 p and g, float32 moments; 16 x 128 elements in two grid
    blocks. step 1 starts from zero moments, step 7 from warm ones."""
    rng = np.random.default_rng(step)
    n = 16 * LANES
    p = (0.02 * rng.standard_normal(n)).astype(np.float32)
    g = (1e-2 * rng.standard_normal(n)).astype(np.float32)
    if step == 1:
        mu = np.zeros(n, np.float32)
        nu = np.zeros(n, np.float32)
    else:
        mu = (1e-3 * rng.standard_normal(n)).astype(np.float32)
        nu = (1e-5 * rng.random(n)).astype(np.float32)
    lr, clip = np.float32(3e-4), np.float32(0.37)
    c1 = tadamw.bias_correction(HYPER["b1"], step)
    c2 = tadamw.bias_correction(HYPER["b2"], step)
    scalars = jnp.asarray([[lr, clip, c1, c2]], jnp.float32)
    want = _reference_kernel(jnp.asarray(p, jnp.bfloat16),
                             jnp.asarray(g, jnp.bfloat16), jnp.asarray(mu),
                             jnp.asarray(nu), scalars, rows_per_block=8)

    tp = torch.from_numpy(p).bfloat16()
    tmu, tnu = torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy())
    before = tadamw.adamw_update.launches
    tadamw.adamw_update(tp, torch.from_numpy(g).bfloat16(), tmu, tnu,
                        float(lr), torch.tensor(clip), c1, c2, **HYPER)
    assert tadamw.adamw_update.launches == before  # the CPU launches nothing
    assert tp.dtype == torch.bfloat16
    got_bits = tp.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    ulps = np.abs(got_bits - _bf16_bits(want[0]).reshape(-1))
    assert ulps.max() <= 1, ulps.max()
    gc = g.astype(np.float32) * clip
    for got, want_m, terms in (
            (tmu, want[1], (HYPER["b1"] * mu, (1 - HYPER["b1"]) * gc)),
            (tnu, want[2], (HYPER["b2"] * nu, (1 - HYPER["b2"]) * gc * gc))):
        err = np.abs(got.numpy() - np.asarray(want_m).reshape(-1))
        scale = np.maximum(np.abs(terms[0]), np.abs(terms[1]))
        assert (err <= 1e-6 * scale).all(), (err / scale).max()


def test_fused_adamw_matches_reference_over_three_steps():
    """The twin of tests/test_pallas_kernels.py:429-462 against the
    reference's FusedAdamW itself: step 0's gradients (norm ~80) are
    clipped, the next two (norm ~3) are clipped less."""
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 128), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i == 0 else 0.1))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]
    ref = jadamw.FusedAdamW(3e-3, b1=0.9, b2=0.95, weight_decay=0.1,
                            clip_norm=1.0)
    ours = tadamw.FusedAdamW(3e-3, b1=0.9, b2=0.95, weight_decay=0.1,
                             clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = ref.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ours.init(tp)
    for i, g in enumerate(grads):
        jp, jstate = ref.apply({k: jnp.asarray(v) for k, v in g.items()},
                               jstate, jp)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tstate = ours.apply(tg, tstate, tp, global_norm(tg))
        assert tstate.count == int(jstate.count) == i + 1
        for k in shapes:
            for got, want, name in ((tp[k], jp[k], "params"),
                                    (tstate.mu[k], jstate.mu[k], "mu"),
                                    (tstate.nu[k], jstate.nu[k], "nu")):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=2e-5, atol=2e-6,
                                           err_msg=f"step {i} {name} {k}")


def test_fused_adamw_keeps_float32_moments_on_bfloat16_params():
    ours = tadamw.FusedAdamW(1e-3)
    params = {"a": {"w": torch.zeros((3, 4), dtype=torch.bfloat16)},
              "b": torch.zeros(5, dtype=torch.bfloat16)}
    state = ours.init(params)
    assert state.count == 0
    for leaf in (state.mu["a"]["w"], state.nu["a"]["w"], state.mu["b"]):
        assert leaf.dtype == torch.float32 and not leaf.any()
    assert state.mu["b"] is not state.nu["b"]
    grads = {"a": {"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16)},
             "b": torch.full((5,), -0.5, dtype=torch.bfloat16)}
    state = ours.apply(grads, state, params, global_norm(grads))
    assert state.count == 1 and params["b"].dtype == torch.bfloat16
    assert (params["a"]["w"] < 0).all() and (params["b"] > 0).all()


def test_adamw_update_refuses_mismatched_leaves():
    p = torch.zeros(8, dtype=torch.bfloat16)
    f32 = torch.zeros(8)
    clip = torch.tensor(1.0)
    with pytest.raises(ValueError, match="do not match"):
        tadamw.adamw_update(p, p[:4], f32, f32, 1e-3, clip, 0.1, 0.05,
                            **HYPER)
    with pytest.raises(TypeError, match="float32 mu"):
        tadamw.adamw_update(p, p, p, f32, 1e-3, clip, 0.1, 0.05, **HYPER)
