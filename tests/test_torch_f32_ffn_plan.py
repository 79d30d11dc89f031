"""The plan of the float32 fused-FFN K1, K2 and K3 kernels
(ray_tpu_torch/ops/kernels/fused_ffn.py `f32_plan`, `f32_slices`,
`f32_launch_plan`): which output tile a shape takes, how many slices its
reduction is cut into, and the workspace the wrappers allocate for them
(K3's plan counts its two outputs, and its workspace holds both).

The kernels run only on a card; what runs here is the plan they are given
and its arithmetic: per-slice float32 partial products summed in slice
order, then K2's swiglu VJP on the sum, K3's h = (x·rstd)·norm_w formed
before its products, held against the reference's K1, K2 and K3 Pallas
kernels in interpret mode on the same numpy inputs (float32, within 1e-4:
the two sum in different orders).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ray_tpu.ops.pallas import fused_ffn as jffn
from ray_tpu_torch.ops.kernels import fused_ffn as ff

TOL = dict(rtol=1e-4, atol=1e-4)


def _cdiv(a, b):
    return -(-a // b)


# (M, N, K): K1 is (d_ff, d, T), K2 (T, d_ff, d). The float32 tiny step's
# shape, the 8B shape both ways, chip_smoke's and the GPU tests' ragged and
# split shapes, T = 0, then a grid of sizes around the tiles and the stage.
NAMED = [(256, 256, 256), (14336, 4096, 4096), (4096, 14336, 4096),
         (512, 256, 512), (512, 512, 256), (50, 130, 37), (37, 50, 130),
         (328, 200, 1000), (1000, 328, 200), (64, 64, 0)]
GRID = list(itertools.product((1, 37, 64, 130, 1000, 4096),
                              (1, 64, 200, 14336),
                              (0, 1, 15, 16, 17, 200, 4096)))


@pytest.mark.parametrize("M,N,K", NAMED)
def test_named_shapes_take_the_expected_plan(M, N, K):
    plan = ff.f32_plan(M, N, K)
    assert plan.tile in ff.F32_TILES and plan.splits >= 1
    if (M, N, K) == (256, 256, 256):  # the tiny step: 16 tiles x 8 slices
        assert plan == ff.F32Plan(64, 8)
    if K == 4096 and max(M, N) == 14336:  # the 8B shape: 112 x 32 tiles
        assert plan == ff.F32Plan(128, 1)


@pytest.mark.parametrize("M,N,K", NAMED)
def test_slices_cover_the_reduction_exactly_once(M, N, K):
    """Contiguous slices in order from 0 to K, each starting on a stage
    boundary and at least one stage long (or ending at K)."""
    plan = ff.f32_plan(M, N, K)
    slices = ff.f32_slices(K, plan.splits)
    assert len(slices) == plan.splits
    assert slices[0][0] == 0 and slices[-1][1] == K
    for (a0, a1), (b0, _) in zip(slices, slices[1:]):
        assert a1 == b0
    for k0, k1 in slices:
        assert k0 % ff.F32_STAGE == 0
        assert k1 - k0 >= min(ff.F32_STAGE, K - k0)
        if K:
            assert k1 > k0
    covered = np.zeros(K, dtype=np.int64)
    for k0, k1 in slices:
        covered[k0:k1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("M,N,K", NAMED)
def test_grid_reaches_a_wave_wherever_it_can(M, N, K):
    """Tiles times slices reach WAVE_BLOCKS blocks wherever the smallest tile
    and slices of one stage can; where they cannot, every stage is a
    slice."""
    plan = ff.f32_plan(M, N, K)
    blocks = _cdiv(M, plan.tile) * _cdiv(N, plan.tile) * plan.splits
    smallest = ff.F32_TILES[-1]
    stages = max(1, _cdiv(K, ff.F32_STAGE))
    most = _cdiv(M, smallest) * _cdiv(N, smallest) * stages
    if most >= ff.WAVE_BLOCKS:
        assert blocks >= ff.WAVE_BLOCKS
    else:
        assert plan == ff.F32Plan(smallest, stages)


@pytest.mark.parametrize("M,N,K", NAMED)
def test_no_split_where_the_tiles_alone_fill_a_wave(M, N, K):
    plan = ff.f32_plan(M, N, K)
    for tile in ff.F32_TILES:
        if _cdiv(M, tile) * _cdiv(N, tile) >= ff.WAVE_BLOCKS:
            assert plan == ff.F32Plan(tile, 1)
            return
    assert plan.tile == ff.F32_TILES[-1]


@pytest.mark.parametrize("M,N,K", NAMED)
def test_workspace_matches_the_plan(M, N, K):
    plan, ws = ff.f32_launch_plan(M, N, K, "cpu")
    assert plan == ff.f32_plan(M, N, K)
    if plan.splits == 1:
        assert ws is None
    else:
        assert ws.dtype == torch.float32
        assert tuple(ws.shape) == (plan.splits, M, N)


# (d, d_ff, T) of K3, whose plan sees its two outputs: the float32 tiny
# step's, the 8B shape, chip_smoke's and the GPU tests' shapes, T = 0.
NAMED_K3 = [(256, 256, 256), (4096, 14336, 4096), (256, 512, 512),
            (130, 50, 37), (200, 328, 1000), (64, 64, 0), (4096, 256, 256)]


@pytest.mark.parametrize("M,N,K", NAMED_K3)
def test_k3_plan_counts_both_outputs(M, N, K):
    """Its tiles count twice: the grid (tiles, S, 2) reaches a wave
    wherever the smallest tile and one-stage slices can, and the workspace
    is [S, 2, d, d_ff]."""
    plan, ws = ff.f32_launch_plan(M, N, K, "cpu", outputs=2)
    assert plan == ff.f32_plan(M, N, K, 2)
    if (M, N, K) == (256, 256, 256):  # the tiny step: 16 tiles x 2 x 4
        assert plan == ff.F32Plan(64, 4)
    if (M, N, K) == (4096, 14336, 4096):  # the 8B shape: 32 x 112 x 2
        assert plan == ff.F32Plan(128, 1)
    blocks = _cdiv(M, plan.tile) * _cdiv(N, plan.tile) * 2 * plan.splits
    smallest = ff.F32_TILES[-1]
    stages = max(1, _cdiv(K, ff.F32_STAGE))
    most = _cdiv(M, smallest) * _cdiv(N, smallest) * 2 * stages
    if most >= ff.WAVE_BLOCKS:
        assert blocks >= ff.WAVE_BLOCKS
    else:
        assert plan == ff.F32Plan(smallest, stages)
    if plan.splits == 1:
        assert ws is None
    else:
        assert tuple(ws.shape) == (plan.splits, 2, M, N)
        assert ws.dtype == torch.float32
    test_slices_cover_the_reduction_exactly_once(M, N, K)


def test_plan_rules_hold_over_a_grid_of_shapes():
    """The four rules above at every (M, N, K) of GRID."""
    for shape in GRID:
        test_slices_cover_the_reduction_exactly_once(*shape)
        test_grid_reaches_a_wave_wherever_it_can(*shape)
        test_no_split_where_the_tiles_alone_fill_a_wave(*shape)
        test_workspace_matches_the_plan(*shape)


# ------------------------------------------ the split arithmetic against
# the reference's K1 and K2


def _split_product(a, b, K):
    """sum_k a[:, k] b[k, :] as the kernels compute it under the plan of
    this product: a float32 partial per slice, summed in slice order."""
    plan = ff.f32_plan(a.shape[0], b.shape[1], K)
    out = None
    for k0, k1 in ff.f32_slices(K, plan.splits):
        part = a[:, k0:k1] @ b[k0:k1, :]
        out = part if out is None else out + part
    return out, plan


def _reference_k1(gate, up, dy, bm, bk):
    from jax.experimental.pallas import tpu as pltpu

    T, dff = gate.shape
    d = dy.shape[1]
    vmem = pltpu.VMEM
    return pl.pallas_call(
        jffn._dw_down_kernel,
        grid=(dff // bm, T // bk),
        in_specs=[
            pl.BlockSpec((bk, bm), lambda i, k: (k, i), memory_space=vmem),
            pl.BlockSpec((bk, bm), lambda i, k: (k, i), memory_space=vmem),
            pl.BlockSpec((bk, d), lambda i, k: (k, 0), memory_space=vmem),
        ],
        out_specs=pl.BlockSpec((bm, d), lambda i, k: (i, 0),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((dff, d), dy.dtype),
        scratch_shapes=[pltpu.VMEM((bm, d), jnp.float32)],
        interpret=True,
    )(gate, up, dy)


def _reference_k2(dy, wd, gate, up, bm, bn, bk):
    from jax.experimental.pallas import tpu as pltpu

    T, d = dy.shape
    dff = wd.shape[0]
    vmem = pltpu.VMEM
    tile = pl.BlockSpec((bm, bn), lambda i, j, k: (i, j), memory_space=vmem)
    return pl.pallas_call(
        jffn._dgateup_kernel,
        grid=(T // bm, dff // bn, d // bk),
        in_specs=[
            pl.BlockSpec((bm, bk), lambda i, j, k: (i, k), memory_space=vmem),
            pl.BlockSpec((bn, bk), lambda i, j, k: (j, k), memory_space=vmem),
            tile, tile,
        ],
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((T, dff), gate.dtype)] * 2,
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.float32)],
        interpret=True,
    )(dy, wd, gate, up)


def _inputs(T, d, dff, seed):
    rng = np.random.default_rng(seed)
    gate, up = (rng.standard_normal((T, dff)).astype(np.float32)
                for _ in range(2))
    dy = rng.standard_normal((T, d)).astype(np.float32)
    wd = (rng.standard_normal((dff, d)) * dff ** -0.5).astype(np.float32)
    return gate, up, dy, wd


def test_split_k1_matches_reference_k1():
    """T 256 x d 64 x d_ff 128: 2 x 1 tiles of 64, so the plan cuts the 256
    tokens into 16 slices of one stage each."""
    gate, up, dy, _ = _inputs(256, 64, 128, seed=11)
    s = ff.swiglu_act(torch.from_numpy(gate), torch.from_numpy(up))
    got, plan = _split_product(s.T, torch.from_numpy(dy), 256)
    assert plan == ff.F32Plan(64, 16)
    want = _reference_k1(*(jnp.asarray(a) for a in (gate, up, dy)), 64, 64)
    np.testing.assert_allclose(got.numpy(), np.array(want), **TOL)


def test_split_k2_matches_reference_k2():
    """T 64 x d 256 x d_ff 128: 1 x 2 tiles of 64, d cut into 16 slices;
    the swiglu VJP runs once, on the summed d_s."""
    gate, up, dy, wd = _inputs(64, 256, 128, seed=12)
    ds, plan = _split_product(torch.from_numpy(dy), torch.from_numpy(wd).T,
                              256)
    assert plan == ff.F32Plan(64, 16)
    g, u = torch.from_numpy(gate), torch.from_numpy(up)
    got = (ds * u * ff._dsilu(g), ds * ff._silu(g))
    want = _reference_k2(*(jnp.asarray(a) for a in (dy, wd, gate, up)),
                         32, 64, 64)
    for a, b, name in zip(got, want, ("dgate", "dup")):
        np.testing.assert_allclose(a.numpy(), np.array(b), err_msg=name,
                                   **TOL)


def _reference_k3(x, rstd, nw, dgate, dup, bm, bn, bk):
    from jax.experimental.pallas import tpu as pltpu

    T, d = x.shape
    dff = dgate.shape[1]
    vmem = pltpu.VMEM
    out = pl.BlockSpec((bm, bn), lambda i, j, k: (i, j), memory_space=vmem)
    return pl.pallas_call(
        jffn._dw_gateup_kernel,
        grid=(d // bm, dff // bn, T // bk),
        in_specs=[
            pl.BlockSpec((bk, bm), lambda i, j, k: (k, i), memory_space=vmem),
            pl.BlockSpec((bk, 1), lambda i, j, k: (k, 0), memory_space=vmem),
            pl.BlockSpec((1, bm), lambda i, j, k: (0, i), memory_space=vmem),
            pl.BlockSpec((bk, bn), lambda i, j, k: (k, j), memory_space=vmem),
            pl.BlockSpec((bk, bn), lambda i, j, k: (k, j), memory_space=vmem),
        ],
        out_specs=[out, out],
        out_shape=[jax.ShapeDtypeStruct((d, dff), dgate.dtype)] * 2,
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.float32),
                        pltpu.VMEM((bm, bn), jnp.float32)],
        interpret=True,
    )(x, rstd, nw.reshape(1, -1), dgate, dup)


def test_split_k3_matches_reference_k3():
    """T 256 x d 64 x d_ff 128: 1 x 2 tiles of 64, two outputs, so the plan
    cuts the 256 tokens into 16 slices; h = (x·rstd)·norm_w as the kernel
    forms it where x lands, each output's slices summed in slice order."""
    T, d, dff = 256, 64, 128
    rng = np.random.default_rng(13)
    x = rng.standard_normal((T, d)).astype(np.float32)
    rstd = (rng.random((T, 1)) + 0.5).astype(np.float32)
    nw = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    dgate, dup = (rng.standard_normal((T, dff)).astype(np.float32)
                  for _ in range(2))
    h = ff.normed(*(torch.from_numpy(a) for a in (x, rstd, nw)))
    plan = ff.f32_plan(d, dff, T, 2)
    assert plan == ff.F32Plan(64, 16)
    got = []
    for g in (dgate, dup):
        out = None
        for k0, k1 in ff.f32_slices(T, plan.splits):
            part = h[k0:k1].T @ torch.from_numpy(g)[k0:k1]
            out = part if out is None else out + part
        got.append(out)
    want = _reference_k3(*(jnp.asarray(a) for a in (x, rstd, nw, dgate,
                                                    dup)), 64, 64, 64)
    for a, b, name in zip(got, want, ("dw_gate", "dw_up")):
        np.testing.assert_allclose(a.numpy(), np.array(b), err_msg=name,
                                   **TOL)
