"""The plan of the float32 flash dq and dk/dv
(ray_tpu_torch/ops/kernels/flash_attention.py `f32_fwd_tile`,
`f32_dkv_tile`, `key_tiles`, `query_tiles`, `bwd_tile_needs_mask`): which
tile a shape takes, the tiles of the other side a block walks and which
pairs of tiles it masks.

The kernels run only on a card; what runs here is their plan and their
arithmetic: the band arithmetic per tile height against a dense mask, and
a blockwise emulation of each kernel in numpy (its own side in tiles of the
planned height, the other side streamed in tiles of F32_BWD_STREAM rows
zero-filled past its end, exp2 of log2e-scaled scores, p selected to 0 on
the entries of a masked pair that no row may attend, dk/dv summed over
the n_rep query heads of its kv head in order) held against the
reference's Pallas backward in interpret mode on the same numpy inputs,
and against the port's plain versions where rows see no key (float32,
within 2e-4, the reference's own tolerance for its kernels against its
einsum).
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
STREAM = fa.F32_BWD_STREAM
LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)


def _cdiv(a, b):
    return -(-a // b)


def _tiles(b, h, kv, sq, sk):
    """(dq's query tile, dk/dv's key tile) as the wrappers plan them."""
    return fa.f32_fwd_tile(b * h, sq), fa.f32_dkv_tile(b * kv, sk)


# (b, heads, kv heads, sq, sk, dq tile, dk/dv tile): the 8B attention
# shape [b·h, s, d] and packed (b 2 x 32 heads, 8 kv heads), the float32
# tiny step's (b·h 4, s 128), chip_smoke's ragged float32 shape (8 x 1000
# against 1100), phase 7e's float32 shape (4 heads, 2 kv heads, s 256) in
# both layouts, the rows-that-see-no-key cases (2 and 32 heads, sq 300
# against sk 64), one row.
NAMED = [(64, 1, 1, 2048, 2048, 64, 64), (2, 32, 8, 2048, 2048, 64, 64),
         (4, 1, 1, 128, 128, 16, 16), (8, 1, 1, 1000, 1100, 64, 64),
         (1, 4, 2, 256, 256, 16, 16), (4, 1, 1, 256, 256, 16, 16),
         (1, 2, 2, 300, 64, 16, 16), (1, 32, 32, 300, 64, 64, 16),
         (1, 1, 1, 1, 1, 16, 16)]
SHAPES = [s[:5] for s in NAMED] + [
    (b, h, kv, s, s + extra)
    for (b, h, kv), s, extra in itertools.product(
        ((1, 1, 1), (2, 2, 1), (1, 8, 2), (4, 16, 4), (2, 64, 8)),
        (1, 15, 16, 17, 64, 65, 128, 1000), (0, 37))]


@pytest.mark.parametrize("b,h,kv,sq,sk,dq_tile,dkv_tile", NAMED)
def test_named_shapes_take_the_expected_tiles(b, h, kv, sq, sk, dq_tile,
                                              dkv_tile):
    assert _tiles(b, h, kv, sq, sk) == (dq_tile, dkv_tile)


@pytest.mark.parametrize("b,h,kv,sq,sk", SHAPES)
def test_every_query_row_and_key_is_covered_once(b, h, kv, sq, sk):
    """dq's cdiv(sq, tile) blocks a head cover rows 0..sq-1 once and dk/dv's
    cdiv(sk, tile) blocks a kv head keys 0..sk-1 once, each block starting
    inside its rows."""
    for tile, n in zip(_tiles(b, h, kv, sq, sk), (sq, sk)):
        assert tile in fa.F32_FWD_TILES
        covered = np.zeros(n, dtype=np.int64)
        for block in range(_cdiv(n, tile)):
            assert block * tile < n
            covered[block * tile:(block + 1) * tile] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("b,h,kv,sq,sk", SHAPES)
def test_grids_reach_a_wave_wherever_they_can(b, h, kv, sq, sk):
    """Each kernel takes the largest tile whose blocks alone make a wave;
    where none does, the smallest, whose blocks are then the most the plan
    can give."""
    for tile, heads, n in zip(_tiles(b, h, kv, sq, sk), (b * h, b * kv),
                              (sq, sk)):
        if heads * _cdiv(n, SMALLEST) >= WAVE:
            assert heads * _cdiv(n, tile) >= WAVE
        else:
            assert tile == SMALLEST
        for larger in fa.F32_FWD_TILES:
            if larger == tile:
                break
            assert heads * _cdiv(n, larger) < WAVE


BAND = [(1, 1), (5, 70), (64, 64), (100, 37), (130, 130), (200, 64),
        (300, 64), (257, 300), (64, 1000), (33, 31)]


def _dense(sq, sk, rows, keys, causal):
    """[rows, keys] bool over rows and keys padded past sq and sk: the
    entries a row attends."""
    r = np.arange(rows)[:, None]
    c = np.arange(keys)[None, :]
    valid = (r < sq) & (c < sk)
    if causal:
        valid = valid & (c <= r + sk - sq)
    return valid


@pytest.mark.parametrize("tile", fa.F32_FWD_TILES)
@pytest.mark.parametrize("sq,sk", BAND)
@pytest.mark.parametrize("causal", [True, False])
def test_dq_band_and_mask_match_a_dense_mask(tile, sq, sk, causal):
    """For each dq block of `tile` query rows: the key tiles of STREAM keys
    it walks hold every entry its rows attend and each holds one; a pair of
    tiles is left unmasked exactly where every row of it attends every key
    of it."""
    valid = _dense(sq, sk, _cdiv(sq, tile) * tile,
                   _cdiv(sk, STREAM) * STREAM, causal)
    for q0 in range(0, sq, tile):
        block = valid[q0:q0 + tile]
        n = fa.key_tiles(q0, tile, sq, sk, causal, STREAM)
        assert not block[:, n * STREAM:].any()
        for kb in range(n):
            pair = block[:, kb * STREAM:(kb + 1) * STREAM]
            assert pair.any()
            assert fa.bwd_tile_needs_mask(q0, tile, kb * STREAM, STREAM, sq,
                                          sk, causal) == (not pair.all())


@pytest.mark.parametrize("tile", fa.F32_FWD_TILES)
@pytest.mark.parametrize("sq,sk", BAND)
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_band_and_mask_match_a_dense_mask(tile, sq, sk, causal):
    """For each dk/dv block of `tile` keys: the query tiles of STREAM rows
    it walks (`query_tiles`, the kernel's qt0 ..) hold every entry that
    attends one of its keys and each holds one; a pair of tiles is left
    unmasked exactly where every row of it attends every key of it."""
    valid = _dense(sq, sk, _cdiv(sq, STREAM) * STREAM,
                   _cdiv(sk, tile) * tile, causal)
    for k0 in range(0, sk, tile):
        block = valid[:, k0:k0 + tile]
        walked = fa.query_tiles(k0, sq, sk, causal, STREAM)
        assert walked.stop == _cdiv(sq, STREAM)
        assert not block[:walked.start * STREAM].any()
        for qb in walked:
            pair = block[qb * STREAM:(qb + 1) * STREAM]
            assert pair.any()
            assert fa.bwd_tile_needs_mask(qb * STREAM, STREAM, k0, tile, sq,
                                          sk, causal) == (not pair.all())


# ------------------------------------------------------------ emulation


def _pad_rows(x, n):
    """x [..., rows, d] zero-filled to n rows."""
    pad = [(0, 0)] * x.ndim
    pad[-2] = (0, n - x.shape[-2])
    return np.pad(x, pad)


def _p_ds(s, dp, lse, delta, scale, mask, valid):
    """The kernels' p and ds on one pair of tiles ([..., rows, keys]; lse
    and delta [..., rows]): exp2 of log2e-scaled scores, p selected to 0
    where the pair is masked and the entry not attended, ds = p (dp -
    delta) scale."""
    x = s * (np.float32(scale) * LOG2E) - (lse * LOG2E)[..., None]
    if mask:
        with np.errstate(over="ignore"):
            p = np.where(valid, np.exp2(x), np.float32(0))
    else:
        # only rows that see keys reach a pair without a mask
        assert (lse > NEG).all()
        p = np.exp2(x)
    ds = p * (dp - delta[..., None]) * np.float32(scale)
    assert np.isfinite(p).all() and np.isfinite(ds).all()
    return p, ds


def _heads(x, n):
    """[b, s, n·d] -> [b, n, s, d]."""
    b, s, w = x.shape
    return x.reshape(b, s, n, w // n).transpose(0, 2, 1, 3)


def _emulate_dq(q, k, v, do, lse, delta, n_heads, n_kv, scale, causal):
    """The float32 dq kernel, block by block over packed [b, s, h·d]
    operands (lse, delta [b, h, sq]): query tiles of its planned height,
    key tiles of STREAM keys in order."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    n_rep = n_heads // n_kv
    tile = fa.f32_fwd_tile(b * n_heads, sq)
    rows_pad, keys_pad = _cdiv(sq, tile) * tile, _cdiv(sk, STREAM) * STREAM
    qh, doh = (_pad_rows(_heads(x, n_heads), rows_pad) for x in (q, do))
    kh, vh = (_pad_rows(_heads(x, n_kv), keys_pad) for x in (k, v))
    lse_p, delta_p = (np.pad(x, ((0, 0), (0, 0), (0, rows_pad - sq)))
                      for x in (lse, delta))
    valid = _dense(sq, sk, rows_pad, keys_pad, causal)
    dq = np.zeros_like(qh)
    for h in range(n_heads):
        g = h // n_rep
        for q0 in range(0, sq, tile):
            rows = slice(q0, q0 + tile)
            acc = np.zeros((b, tile, qh.shape[-1]), np.float32)
            for kb in range(fa.key_tiles(q0, tile, sq, sk, causal, STREAM)):
                keys = slice(kb * STREAM, (kb + 1) * STREAM)
                dp = doh[:, h, rows] @ vh[:, g, keys].transpose(0, 2, 1)
                s = qh[:, h, rows] @ kh[:, g, keys].transpose(0, 2, 1)
                mask = fa.bwd_tile_needs_mask(q0, tile, kb * STREAM, STREAM,
                                              sq, sk, causal)
                _, ds = _p_ds(s, dp, lse_p[:, h, rows], delta_p[:, h, rows],
                              scale, mask, valid[rows, keys])
                acc += ds @ kh[:, g, keys]
            dq[:, h, rows] = acc
    return dq[:, :, :sq].transpose(0, 2, 1, 3).reshape(q.shape)


def _emulate_dkv(q, k, v, do, lse, delta, n_heads, n_kv, scale, causal):
    """The float32 dk/dv kernel, block by block over packed operands: key
    tiles of its planned height, each walking the query tiles of STREAM
    rows (`query_tiles`) of its kv head's n_rep query heads, head by head
    in order, into one sum."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    n_rep = n_heads // n_kv
    tile = fa.f32_dkv_tile(b * n_kv, sk)
    rows_pad, keys_pad = _cdiv(sq, STREAM) * STREAM, _cdiv(sk, tile) * tile
    qh, doh = (_pad_rows(_heads(x, n_heads), rows_pad) for x in (q, do))
    kh, vh = (_pad_rows(_heads(x, n_kv), keys_pad) for x in (k, v))
    lse_p, delta_p = (np.pad(x, ((0, 0), (0, 0), (0, rows_pad - sq)))
                      for x in (lse, delta))
    valid = _dense(sq, sk, rows_pad, keys_pad, causal)
    dk, dv = np.zeros_like(kh), np.zeros_like(vh)
    for g in range(n_kv):
        for k0 in range(0, sk, tile):
            keys = slice(k0, k0 + tile)
            for h in range(g * n_rep, (g + 1) * n_rep):
                for qb in fa.query_tiles(k0, sq, sk, causal, STREAM):
                    q0 = qb * STREAM
                    rows = slice(q0, q0 + STREAM)
                    s = qh[:, h, rows] @ kh[:, g, keys].transpose(0, 2, 1)
                    dp = doh[:, h, rows] @ vh[:, g, keys].transpose(0, 2, 1)
                    mask = fa.bwd_tile_needs_mask(q0, STREAM, k0, tile, sq,
                                                  sk, causal)
                    p, ds = _p_ds(s, dp, lse_p[:, h, rows],
                                  delta_p[:, h, rows], scale, mask,
                                  valid[rows, keys])
                    dv[:, g, keys] += p.transpose(0, 2, 1) @ doh[:, h, rows]
                    dk[:, g, keys] += ds.transpose(0, 2, 1) @ qh[:, h, rows]

    def packed(x):
        return x[:, :, :sk].transpose(0, 2, 1, 3).reshape(k.shape)

    return packed(dk), packed(dv)


def _inputs(b, h, kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h * d), (b, sk, kv * d), (b, sk, kv * d),
                      (b, sq, h * d))]


def _delta(o, do, n_heads):
    """[b, h, sq]: per-head rowsum(dO ⊙ O) in float32."""
    return (_heads(do, n_heads) * _heads(o, n_heads)).sum(-1)


# (b, heads, kv heads, sq, sk, d, causal, the reference's block_q,
# block_k, dq tile, dk/dv tile, packed): each tile of each kernel, sq < sk,
# sq > sk, ragged, not causal; GQA n_rep 4 through the packed reference.
EMULATED = [
    (2, 1, 1, 128, 128, 64, True, 64, 64, 16, 16, False),
    (2, 1, 1, 40, 150, 32, True, 8, 64, 16, 16, False),
    (128, 1, 1, 64, 64, 32, True, 64, 64, 64, 64, False),
    (96, 1, 1, 100, 130, 32, False, 32, 64, 64, 64, False),
    (1, 8, 2, 70, 90, 32, True, 32, 32, 16, 16, True),
    (2, 16, 4, 300, 130, 32, True, 64, 64, 64, 16, True),
    (2, 32, 16, 256, 256, 32, True, 128, 128, 64, 64, True),
]


@pytest.mark.parametrize("case", EMULATED)
def test_emulated_kernels_match_reference_backward(case):
    b, h, kv, sq, sk, d, causal, bq, bk, dq_tile, dkv_tile, packed = case
    assert _tiles(b, h, kv, sq, sk) == (dq_tile, dkv_tile)
    q, k, v, do = _inputs(b, h, kv, sq, sk, d, seed=sum(case[:6]))
    scale = d ** -0.5
    if packed:
        o, lse = jfa._flash_fwd_packed(q, k, v, h, kv, scale, causal, bq, bk)
        dq, dk, dv = jfa._flash_bwd_packed(q, k, v, o, lse, do, h, kv,
                                           scale, causal, bq, bk)
        lse = np.array(lse).reshape(b, h, 8, sq)[:, :, 0]
    else:
        o, lse = jfa._flash_fwd(q, k, v, scale, causal, bq, bk)
        dq, dk, dv = jfa._flash_bwd(q, k, v, o, lse, do, scale, causal, bq,
                                    bk)
        lse = np.array(lse)[:, :1, :]  # [b·h, 1 head, sq]
    o = np.array(o)
    args = (q, k, v, do, lse, _delta(o, do, h), h, kv, scale, causal)
    np.testing.assert_allclose(_emulate_dq(*args), np.array(dq), **TOL)
    got_dk, got_dv = _emulate_dkv(*args)
    np.testing.assert_allclose(got_dk, np.array(dk), **TOL)
    np.testing.assert_allclose(got_dv, np.array(dv), **TOL)


@pytest.mark.parametrize("h", [2, 32])
def test_emulated_kernels_give_zero_where_rows_see_no_key(h):
    """Causal sq 300 against sk 64: rows 0-235 attend no key (lse -1e30).
    The emulated dq is 0 there, and dq, dk and dv match the port's plain
    versions, at both dq tiles (2 heads: 16, 32 heads: 64)."""
    b, sq, sk, d = 1, 300, 64, 32
    q, k, v, do = _inputs(b, h, h, sq, sk, d, seed=h)
    scale = d ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_fwd_packed_plain(tq, tk, tv, h, h, scale, True)
    delta = fa.flash_delta_packed(o, tdo, h)
    assert (lse[:, :, :sq - sk] == -1e30).all()
    args = (q, k, v, do, lse.numpy(), delta.numpy(), h, h, scale, True)
    got_dq = _emulate_dq(*args)
    got_dk, got_dv = _emulate_dkv(*args)
    plain = (tq, tk, tv, tdo, lse, delta, h, h, scale, True)
    want_dk, want_dv = fa.flash_bwd_dkv_packed_plain(*plain)
    want_dq = fa.flash_bwd_dq_packed_plain(*plain)
    assert (got_dq[:, :sq - sk] == 0).all()
    np.testing.assert_allclose(got_dq, want_dq.numpy(), **TOL)
    np.testing.assert_allclose(got_dk, want_dk.numpy(), **TOL)
    np.testing.assert_allclose(got_dv, want_dv.numpy(), **TOL)
