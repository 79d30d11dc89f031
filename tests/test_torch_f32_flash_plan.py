"""The plan of the float32 flash forward
(ray_tpu_torch/ops/kernels/flash_attention.py `f32_fwd_tile`, `key_tiles`,
`tile_needs_mask`): which query tile a shape takes, the key tiles a block
walks and which of them it masks.

The kernel runs only on a card; what runs here is its plan and its
arithmetic: the band arithmetic per tile height against a dense mask, and a
blockwise emulation of the kernel's online softmax in numpy (query tiles of
the planned height, 64-key tiles zero-filled past sk, exp2 of log2e-scaled
scores, p kept 0 while a row's max is -1e30) held against the reference's
Pallas forward in interpret mode on the same numpy inputs, and against the
port's plain version where rows see no key (float32, within 2e-4, the
reference's own tolerance for its kernels against its einsum).
"""

import itertools

import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash_attention as jfa
from ray_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)
WAVE = 128
SMALLEST = fa.F32_FWD_TILES[-1]


def _cdiv(a, b):
    return -(-a // b)


# (query heads, sq, the tile the plan takes): the 8B attention shape
# [b·h, s, d] and packed (b 2 x 32 heads), the float32 tiny step's (b 2 x 2
# heads, s 128), chip_smoke's ragged float32 shape (8 x 1000), phase 7e's
# float32 shape (4 heads, s 256), the rows-that-see-no-key cases (2 and 32
# heads, sq 300), the GPU tests' shapes at each tile, one row.
NAMED = [(64, 2048, 64), (4, 128, 16), (8, 1000, 64), (4, 256, 16),
         (2, 300, 16), (32, 300, 64), (16, 512, 64), (16, 520, 64),
         (16, 500, 64), (8, 200, 16), (1, 1, 16)]
GRID = list(itertools.product((1, 2, 4, 8, 16, 64, 200),
                              (1, 15, 16, 17, 64, 65, 128, 1000, 2048)))


@pytest.mark.parametrize("heads,sq,tile", NAMED)
def test_named_shapes_take_the_expected_tile(heads, sq, tile):
    assert fa.f32_fwd_tile(heads, sq) == tile


@pytest.mark.parametrize("heads,sq", [s[:2] for s in NAMED] + GRID)
def test_every_query_row_is_covered_once(heads, sq):
    """The grid's cdiv(sq, tile) blocks a head cover rows 0..sq-1 once,
    each block starting inside the rows."""
    tile = fa.f32_fwd_tile(heads, sq)
    assert tile in fa.F32_FWD_TILES
    covered = np.zeros(sq, dtype=np.int64)
    for block in range(_cdiv(sq, tile)):
        q0 = block * tile
        assert q0 < sq
        covered[q0:q0 + tile] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("heads,sq", [s[:2] for s in NAMED] + GRID)
def test_grid_reaches_a_wave_wherever_it_can(heads, sq):
    """The largest tile whose blocks alone make a wave; where none does,
    the smallest, whose blocks are then the most the plan can give."""
    tile = fa.f32_fwd_tile(heads, sq)
    blocks = heads * _cdiv(sq, tile)
    if heads * _cdiv(sq, SMALLEST) >= WAVE:
        assert blocks >= WAVE
    else:
        assert tile == SMALLEST
    for larger in fa.F32_FWD_TILES:
        if larger == tile:
            break
        assert heads * _cdiv(sq, larger) < WAVE


BAND = [(1, 1), (5, 70), (64, 64), (100, 37), (130, 130), (200, 64),
        (300, 64), (257, 300), (64, 1000)]


@pytest.mark.parametrize("tile", fa.F32_FWD_TILES)
@pytest.mark.parametrize("sq,sk", BAND)
@pytest.mark.parametrize("causal", [True, False])
def test_band_and_mask_match_a_dense_mask(tile, sq, sk, causal):
    """For each query block of `tile` rows (rows past sq included, as the
    kernel holds them): the key tiles it walks hold every entry its rows
    attend and each holds one; a key tile is left unmasked exactly where
    every row of the block attends every key of it."""
    kt = fa.KEY_TILE
    rows = np.arange(_cdiv(sq, tile) * tile)[:, None]
    cols = np.arange(_cdiv(sk, kt) * kt)[None, :]
    valid = (cols < sk) & (rows >= 0)
    if causal:
        valid = valid & (cols <= rows + sk - sq)
    for q0 in range(0, sq, tile):
        block = valid[q0:q0 + tile]
        n = fa.key_tiles(q0, tile, sq, sk, causal)
        assert not block[:sq - q0, n * kt:].any()
        for kb in range(n):
            tile_valid = block[:, kb * kt:(kb + 1) * kt]
            assert tile_valid.any()
            assert fa.tile_needs_mask(q0, kb * kt, sq, sk, causal) == \
                (not tile_valid.all())


def _emulate(q, k, v, scale, causal):
    """The float32 forward kernel's arithmetic, block by block, in numpy:
    (out, lse)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kt = fa.KEY_TILE
    tile = fa.f32_fwd_tile(bh, sq)
    pad = _cdiv(sk, kt) * kt - sk
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0)))
    scale2 = np.float32(scale * 1.4426950408889634)
    neg = np.float32(-1e30)
    out = np.zeros_like(q)
    lse = np.zeros((bh, sq), np.float32)
    for q0 in range(0, sq, tile):
        rows = np.arange(q0, min(q0 + tile, sq))
        qb = q[:, rows]
        m = np.full((bh, len(rows)), neg, np.float32)
        l = np.zeros((bh, len(rows)), np.float32)
        o = np.zeros((bh, len(rows), d), np.float32)
        for kb in range(fa.key_tiles(q0, tile, sq, sk, causal)):
            cols = np.arange(kb * kt, (kb + 1) * kt)
            s = qb @ kp[:, cols].transpose(0, 2, 1)
            if fa.tile_needs_mask(q0, kb * kt, sq, sk, causal):
                ok = cols[None, :] < sk
                if causal:
                    ok = ok & (cols[None, :] <= rows[:, None] + sk - sq)
                s = np.where(ok, s, neg)
            mx = np.maximum(m, s.max(-1))
            alpha = np.exp2((m - mx) * scale2)
            p = np.where((mx == neg)[..., None], np.float32(0),
                         np.exp2(s * scale2 - (mx * scale2)[..., None]))
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p @ vp[:, cols]
            m = mx
        l = np.maximum(l, np.float32(1e-30))
        out[:, rows] = o / l[..., None]
        lse[:, rows] = np.where(m == neg, neg, m * np.float32(scale)) \
            + np.log(l)
    return out, lse


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d))]


# (bh, sq, sk, d, causal, the reference's block_q, block_k, the tile)
EMULATED = [
    (2, 128, 128, 64, True, 64, 64, 16),
    (2, 40, 150, 32, True, 8, 64, 16),
    (128, 64, 64, 32, True, 64, 64, 64),
    (96, 100, 130, 32, False, 32, 64, 64),
]


@pytest.mark.parametrize("case", EMULATED)
def test_emulated_kernel_matches_reference_forward(case):
    bh, sq, sk, d, causal, bq, bk, tile = case
    assert fa.f32_fwd_tile(bh, sq) == tile
    q, k, v = _inputs(bh, sq, sk, d, seed=sum(case))
    scale = d ** -0.5
    got, got_lse = _emulate(q, k, v, scale, causal)
    want, want_lse = jfa._flash_fwd(q, k, v, scale, causal, bq, bk)
    np.testing.assert_allclose(got, np.array(want), **TOL)
    np.testing.assert_allclose(got_lse, np.array(want_lse)[:, 0, :], **TOL)


@pytest.mark.parametrize("bh", [2, 32])
def test_emulated_kernel_gives_zero_where_rows_see_no_key(bh):
    """Causal sq 300 against sk 64: rows 0-235 attend no key, and the
    emulated kernel gives out 0 and lse -1e30 there, as the port's plain
    version does, at both query tiles (2 heads: 16, 32 heads: 64)."""
    sq, sk, d = 300, 64, 32
    q, k, v = _inputs(bh, sq, sk, d, seed=bh)
    got, got_lse = _emulate(q, k, v, d ** -0.5, True)
    want, want_lse = fa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                        d ** -0.5, True)
    assert (got[:, :sq - sk] == 0).all()
    assert (got_lse[:, :sq - sk] == np.float32(-1e30)).all()
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    np.testing.assert_allclose(got_lse, want_lse.numpy(), **TOL)
