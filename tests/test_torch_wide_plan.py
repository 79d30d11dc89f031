"""The host plans of the wide flash family's redesigned kernels
(csrc/flash_wide.cu: the bf16 forward `flash_wide_fwd_wgmma_kernel`, the
float32 dq `flash_wide_dq_f32_kernel`), on the CPU.

* `wide_f32_dq_tile`: the float32 dq's query tile by wave, at head dims
  128-1024, at chip_smoke phase 7e's and the 8B attention shape's head
  counts, and at the boundary where it switches.
* `wide_fwd_plan`: the forward's staging plan by head_dim (Q resident up to
  512, streamed beyond), its slices covering the head, and its shared
  memory within a block's limit at every multiple of 128 up to 4096.
* A walk of the forward's ring step by step, as the kernel issues and
  waits for its cp.async groups: it departs from the backward's
  `chunk_of`/`ring_step` (chunks in order, eight stages loaded six ahead,
  the V slice in a buffer of its own), so every chunk step must find its
  chunk landed and not yet overwritten, no refill may take a stage a
  product in flight still reads, and a key tile's V slice must be in
  before its P·V.
* Blockwise float32 emulations of the two kernels' arithmetic in numpy
  (the forward's 256-column slices, 128-row query tiles, 64-key tiles and
  online softmax in exp2; the dq's 128-column slices, its tile plan, the
  chunks in `chunk_of` order and p selected to 0 where a row may not
  attend) against the reference's Pallas kernels in interpret mode on the
  same numpy inputs (within 2e-4, the tolerance of
  tests/test_torch_head_dims.py), and against the port's plain versions
  where rows see no key.
"""

import itertools

import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash_attention as jfa
from ray_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)
LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)
# the kernels' constants (csrc/flash_wide.cu): the forward's query tile and
# key tile, its score products in flight across a barrier (kFwdLag); the
# float32 dq's key tile; the chunk width
Q_ROWS, KEYS, LAG = 128, 64, 1
F32_KEYS = fa.F32_BWD_STREAM
CHUNK = 64
# the most shared memory an H100 block may take (227 KB)
MAX_BLOCK_SMEM = 232448


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("d", range(128, 1025, 128))
@pytest.mark.parametrize("heads,sq,tile_at", [
    # phase 7e's float32 shape (b 1, 4 heads; flat b·h 4), s 256: 16 rows
    # at every width up to 1024, where 4 x 4 x 8 slices make 128 blocks
    (4, 256, 1024),
    # the 8B attention shape, b·h 64 x s 2048: 64 rows at every width
    (64, 2048, 128),
    # the float32 tiny step's b·h 4 x s 128
    (4, 128, 2048)])
def test_wide_f32_dq_tile_by_wave(d, heads, sq, tile_at):
    """64 rows where the 64-row blocks, one a 128-column slice, make a wave
    of WAVE_BLOCKS, else 16; `tile_at` the first width taking 64."""
    want = 64 if d >= tile_at else 16
    assert fa.wide_f32_dq_tile(heads, sq, d) == want
    blocks = heads * _cdiv(sq, 64) * (d // fa.WIDE_SLICE)
    assert (blocks >= fa.WAVE_BLOCKS) == (want == 64)


@pytest.mark.parametrize("heads,sq,d,tile", [
    (1, 64 * 127, 128, 16), (1, 64 * 128, 128, 64),  # one slice
    (1, 64 * 127 + 1, 128, 64),  # the ragged last tile counts
    (2, 64 * 16, 512, 64), (2, 64 * 16 - 64, 512, 16),  # 128 and 120 blocks
    (127, 64, 128, 16), (128, 64, 128, 64)])
def test_wide_f32_dq_tile_switches_at_one_wave(heads, sq, d, tile):
    assert fa.wide_f32_dq_tile(heads, sq, d) == tile


@pytest.mark.parametrize("d", range(128, 4097, 128))
def test_wide_fwd_plan_by_head_dim(d):
    """Q resident up to WIDE_FWD_RESIDENT_MAX (512) with slices of 256
    columns, streamed beyond with slices of 128; the slices cover the head
    once; a block's shared memory within the card's limit."""
    resident, slices, smem = fa.wide_fwd_plan(d)
    assert resident == (d <= fa.WIDE_FWD_RESIDENT_MAX)
    width = fa.WIDE_FWD_SLICE if resident else fa.WIDE_SLICE
    assert (slices - 1) * width < d <= slices * width
    assert smem <= MAX_BLOCK_SMEM
    if resident:  # Q's 128 rows at d, beside the ring and the V slice
        assert smem - 128 * d * 2 == fa.wide_fwd_plan(128)[2] - 128 * 128 * 2


def test_wide_fwd_plan_switches_where_resident_q_stops_fitting():
    """512 is the widest head whose resident Q fits beside the ring and the
    256-column V slice; 640 would not, and takes the streamed plan."""
    assert fa.wide_fwd_plan(512)[0] and not fa.wide_fwd_plan(640)[0]
    _, _, at_512 = fa.wide_fwd_plan(512)
    assert at_512 + 128 * 128 * 2 > MAX_BLOCK_SMEM
    assert fa.wide_fwd_plan(640)[2] == fa.wide_fwd_plan(4096)[2]


# ------------------------------------------------------- the forward's ring


def _walk_forward_ring(n: int, n_kt: int) -> int:
    """Runs the bf16 wide forward's ring as one thread issues it (every
    thread issues the same groups and waits alike, then meets the others
    at the barrier) for a head of n chunks and n_kt key tiles, asserting
    its invariants; returns the number of chunk steps walked."""
    stages = fa.WIDE_FWD_STAGES
    ahead = stages - 1 - LAG
    total = n * n_kt
    groups = []  # the cp.async groups committed, in order: their loads
    holds = {}  # stage -> the step whose chunk was last issued into it

    def done(pending):  # the loads of every group but the newest `pending`
        return set().union(*groups[:max(len(groups) - pending, 0)])

    def issue(step, group):
        holds[step % stages] = step
        group.add(("K", step))

    first = {("Q",)}  # the resident Q, with the first chunk
    for i in range(ahead):
        group = first if i == 0 else set()
        if i < total:
            issue(i, group)
        groups.append(group)
    walked = 0
    for t in range(n_kt):
        for j in range(n):
            step = t * n + j
            landed = done(ahead - 1)  # cp_async_wait<kFwdAhead - 1>
            assert ("K", step) in landed and ("Q",) in landed
            # the barrier: every product of the steps before step - LAG is
            # done; at a tile's first chunk every one (wait_all before the
            # softmax), so also P.V(t - 1) and the V buffer's reads
            in_flight = set(range(step - LAG, step)) if j else set()
            group = set()
            if step + ahead < total:
                target = (step + ahead) % stages
                assert all(s % stages != target for s in in_flight)
                assert target != step % stages
                issue(step + ahead, group)
            if j == 0:
                group.add(("V", t))
            groups.append(group)
            assert holds[step % stages] == step  # not yet overwritten
            walked += 1
        # before P.V(t): V(t)'s group, n - 1 groups after it (the wait the
        # kernel adds for n < kFwdStages - kFwdLag), else the last chunk
        # step's wait already covered it
        if n < stages - LAG:
            landed = done(n - 1)
        assert ("V", t) in landed
    return walked


@pytest.mark.parametrize("n", [2, 4, 6, 7, 8, 10, 16])
@pytest.mark.parametrize("n_kt", [0, 1, 2, 5, 32])
def test_wide_fwd_ring_walk(n, n_kt):
    """Head widths of 128-1024 columns (2-16 chunks of 64), 0-32 key
    tiles: both sides of the V wait's switch (n = 7) and the head shorter
    than the ring (2, 4)."""
    assert _walk_forward_ring(n, n_kt) == n * n_kt


# ------------------------------------------------------- emulations


def _key_tiles(q0, rows, sq, sk, causal, keys):
    return fa.key_tiles(q0, rows, sq, sk, causal, keys)


def _valid(rows, cols, sq, sk, causal):
    r = rows[:, None]
    c = cols[None, :]
    ok = (r < sq) & (c < sk)
    return ok & (c <= r + (sk - sq)) if causal else ok


def _emulate_forward(q, k, v, scale, causal):
    """The forward's blocks over [bh, s, kd] float32 (kd a multiple of
    128): per (head, 128-row tile, slice) the key tiles of 64 keys, S as
    the sum of its 64-column chunks in order, the online softmax in exp2
    of log2e-scaled scores with p kept 0 while a row's max is -1e30, and
    out = o / max(l, 1e-30); lse from slice 0."""
    bh, sq, kd = q.shape
    sk = k.shape[1]
    resident, n_slices, _ = fa.wide_fwd_plan(kd)
    width = fa.WIDE_FWD_SLICE if resident else fa.WIDE_SLICE
    scale2 = np.float32(scale) * LOG2E
    out = np.zeros_like(q)
    lse = np.zeros((bh, sq), np.float32)
    for h, qt, sl in itertools.product(range(bh), range(_cdiv(sq, Q_ROWS)),
                                       range(n_slices)):
        q0, c0 = qt * Q_ROWS, sl * width
        c1 = min(c0 + width, kd)
        rows = np.arange(q0, q0 + Q_ROWS)
        qb = np.zeros((Q_ROWS, kd), np.float32)
        qb[:max(min(sq - q0, Q_ROWS), 0)] = q[h, q0:q0 + Q_ROWS]
        m = np.full(Q_ROWS, NEG)
        l = np.zeros(Q_ROWS, np.float32)
        o = np.zeros((Q_ROWS, c1 - c0), np.float32)
        for t in range(_key_tiles(q0, Q_ROWS, sq, sk, causal, KEYS)):
            k0 = t * KEYS
            kb = np.zeros((KEYS, kd), np.float32)
            vb = np.zeros((KEYS, kd), np.float32)
            n_in = min(sk - k0, KEYS)
            kb[:n_in], vb[:n_in] = k[h, k0:k0 + n_in], v[h, k0:k0 + n_in]
            s = np.zeros((Q_ROWS, KEYS), np.float32)
            for c in range(0, kd, CHUNK):
                s += qb[:, c:c + CHUNK] @ kb[:, c:c + CHUNK].T
            ok = _valid(rows, np.arange(k0, k0 + KEYS), sq, sk, causal)
            ok |= rows[:, None] >= sq  # rows past sq are not masked
            s = np.where(ok, s, NEG)
            mx = np.maximum(m, s.max(1))
            alpha = np.exp2((m - mx) * scale2)
            ms = np.where(mx == NEG, np.float32(0), mx * scale2)
            p = np.exp2(s * scale2 - ms[:, None]).astype(np.float32)
            m, l = mx, l * alpha + p.sum(1)
            o = o * alpha[:, None] + p @ vb[:, c0:c1]
        n_rows = max(min(sq - q0, Q_ROWS), 0)
        lc = np.maximum(l, np.float32(1e-30))
        out[h, q0:q0 + n_rows, c0:c1] = (o / lc[:, None])[:n_rows]
        if sl == 0:
            lse[h, q0:q0 + n_rows] = np.where(
                m == NEG, NEG, m * np.float32(scale) + np.log(lc))[:n_rows]
    return out, lse


def _chunk_of(j, slice_, n):
    c = 2 * slice_ + 2 + j
    return c if c < n else c - n


def _emulate_dq(q, k, v, do, lse, delta, scale, causal):
    """The float32 dq's blocks over [bh, s, kd] (kd a multiple of 128): per
    (head, query tile of the planned height, 128-column slice) the key
    tiles of 32 keys, S and dP summed chunk by chunk in `chunk_of` order, p
    selected to 0 where a row may not attend, dQ_slice += dS·K_slice."""
    bh, sq, kd = q.shape
    sk = k.shape[1]
    tile = fa.wide_f32_dq_tile(bh, sq, kd)
    n = kd // CHUNK
    scale2 = np.float32(scale) * LOG2E
    dq = np.zeros_like(q)
    for h, qt, sl in itertools.product(range(bh), range(_cdiv(sq, tile)),
                                       range(kd // fa.WIDE_SLICE)):
        q0 = qt * tile
        rows = np.arange(q0, q0 + tile)
        n_rows = min(sq - q0, tile)
        qb, ob = (np.zeros((tile, kd), np.float32) for _ in range(2))
        qb[:n_rows], ob[:n_rows] = q[h, q0:q0 + n_rows], do[h, q0:q0 + n_rows]
        lse2 = np.zeros(tile, np.float32)
        dlt = np.zeros(tile, np.float32)
        lse2[:n_rows] = lse[h, q0:q0 + n_rows] * LOG2E
        dlt[:n_rows] = delta[h, q0:q0 + n_rows]
        acc = np.zeros((tile, fa.WIDE_SLICE), np.float32)
        for t in range(_key_tiles(q0, tile, sq, sk, causal, F32_KEYS)):
            k0 = t * F32_KEYS
            kb, vb = (np.zeros((F32_KEYS, kd), np.float32) for _ in range(2))
            n_in = min(sk - k0, F32_KEYS)
            kb[:n_in], vb[:n_in] = k[h, k0:k0 + n_in], v[h, k0:k0 + n_in]
            s = np.zeros((tile, F32_KEYS), np.float32)
            dp = np.zeros((tile, F32_KEYS), np.float32)
            for j in range(n):
                c = _chunk_of(j, sl, n) * CHUNK
                s += qb[:, c:c + CHUNK] @ kb[:, c:c + CHUNK].T
                dp += ob[:, c:c + CHUNK] @ vb[:, c:c + CHUNK].T
            ok = _valid(rows, np.arange(k0, k0 + F32_KEYS), sq, sk, causal)
            with np.errstate(over="ignore"):
                p = np.where(ok, np.exp2(s * scale2 - lse2[:, None]), 0)
            ds = (p * (dp - dlt[:, None]) * np.float32(scale)).astype(
                np.float32)
            cs = sl * fa.WIDE_SLICE
            acc += ds @ kb[:, cs:cs + fa.WIDE_SLICE]
        dq[h, q0:q0 + n_rows, sl * fa.WIDE_SLICE:(sl + 1) * fa.WIDE_SLICE] = \
            acc[:n_rows]
    return dq


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))]


def _padded(x, kd):
    return np.pad(x, ((0, 0), (0, 0), (0, kd - x.shape[-1])))


# (bh, sq, sk, d, causal, block_q, block_k of the reference): head dims 320
# (padded to 384: a 256- and a 128-column slice) and 512 (two 256-column
# slices), causal over two query tiles with a ragged tail, not causal with a
# ragged key tail
CASES = [(2, 150, 150, 320, True, 64, 64), (1, 64, 100, 512, False, 32, 64),
         (1, 136, 136, 512, True, 64, 64)]


@pytest.mark.parametrize("bh,sq,sk,d,causal,bq,bk", CASES)
def test_emulated_kernels_match_pallas(bh, sq, sk, d, causal, bq, bk):
    q, k, v, do = _inputs(bh, sq, sk, d, 7)
    scale = d ** -0.5
    out, lse = jfa._flash_fwd(q, k, v, scale, causal, bq, bk)
    dq, _, _ = jfa._flash_bwd(q, k, v, out, lse, do, scale, causal, bq, bk)
    out, lse, dq = (np.array(t) for t in (out, lse, dq))
    lse = lse.reshape(bh, -1, sq)[:, 0] if lse.ndim == 3 else lse
    kd = fa.kernel_head_dim(d)
    e_out, e_lse = _emulate_forward(_padded(q, kd), _padded(k, kd),
                                    _padded(v, kd), scale, causal)
    np.testing.assert_allclose(e_out[..., :d], out, **TOL)
    np.testing.assert_allclose(e_out[..., d:], 0)
    np.testing.assert_allclose(e_lse, lse, **TOL)
    delta = (do * out).sum(-1)
    e_dq = _emulate_dq(*(_padded(x, kd) for x in (q, k, v, do)), lse, delta,
                       scale, causal)
    np.testing.assert_allclose(e_dq[..., :d], dq, **TOL)


@pytest.mark.parametrize("d", [384, 640])
def test_emulated_kernels_where_rows_see_no_key(d):
    """Causal with sq 200 > sk 64: rows 0-135 see no key. The emulations
    give out 0, lse -1e30 and dq exactly 0 there and agree with the port's
    plain versions everywhere; 640 takes the forward's streamed plan."""
    q, k, v, do = _inputs(2, 200, 64, d, 3)
    scale = d ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    p_out, p_lse = fa.flash_fwd_plain(*t[:3], scale, True)
    delta = fa.flash_delta(p_out, t[3])
    p_dq = fa.flash_bwd_dq_plain(*t, p_lse, delta, scale, True)
    e_out, e_lse = _emulate_forward(q, k, v, scale, True)
    e_dq = _emulate_dq(q, k, v, do, p_lse.numpy(), delta.numpy(), scale,
                       True)
    assert (e_out[:, :136] == 0).all() and (e_lse[:, :136] == NEG).all()
    assert (e_dq[:, :136] == 0).all()
    np.testing.assert_allclose(e_out, p_out.numpy(), **TOL)
    np.testing.assert_allclose(e_lse[:, 136:], p_lse.numpy()[:, 136:], **TOL)
    np.testing.assert_allclose(e_dq, p_dq.numpy(), **TOL)
