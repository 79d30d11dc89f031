"""The host plans of the wide flash family's redesigned kernels
(csrc/flash_wide.cu: the bf16 forward `flash_wide_fwd_wgmma_kernel`, the
float32 dq `flash_wide_dq_f32_kernel`, the float32 forward
`flash_wide_fwd_f32_kernel` and dk/dv `flash_wide_dkv_f32_kernel`), on the
CPU.

* `wide_f32_dq_tile`: the float32 dq's query tile by wave, at head dims
  128-1024, at chip_smoke phase 7e's and the 8B attention shape's head
  counts, and at the boundary where it switches.
* `wide_f32_fwd_plan`, `wide_f32_dkv_plan`: the float32 forward's and
  dk/dv's (tile, slice width) by wave and register budget, at head dims
  128-1024, at phase 7e's and the 8B shape's head counts, at the
  boundaries where the width or the tile switches, and each pair's shared
  memory (`wide_f32_smem`) within a block's limit.
* `wide_fwd_plan`: the forward's staging plan by head_dim (Q resident up to
  512, streamed beyond), its slices covering the head, and its shared
  memory within a block's limit at every multiple of 128 up to 4096.
* Walks of the rings step by step, as the kernels issue and wait for
  their cp.async groups: the bf16 forward's (chunks in order, eight
  stages loaded six ahead, the V slice in a buffer of its own), the float32
  forward's (a key tile's K steps, then its V steps, in one ring) and the
  float32 dk/dv's (a query tile's chunks, the slice's kept staged for the
  output products: at the whole head, every chunk). Every step must find
  its chunk landed and not yet overwritten, and no refill may take a stage
  that a read still to come needs.
* Blockwise float32 emulations of the kernels' arithmetic in numpy (the
  bf16 forward's 256-column slices, 128-row query tiles, 64-key tiles and
  online softmax in exp2; the dq's 128-column slices, its tile plan, the
  chunks in `chunk_of` order and p selected to 0 where a row may not
  attend; the float32 forward's slices, tiles, online softmax and P·V a
  128-column group at a time; dk/dv's key tile, its query tiles over the
  n_rep heads summed in order and p selected to 0, each at every plan it
  can take) against the reference's Pallas kernels in interpret mode on
  the same numpy inputs (within 2e-4, the tolerance of
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


# (heads, sq, d, the forward's plan): phase 7e's float32 shape (b 1, 4 query
# heads in both layouts, s 256), the 8B attention shape (b·h 64, s 2048)
# and the float32 tiny step's (b·h 4, s 128)
# (7e: 32- and 16-row tiles make 32 and 64 blocks, no wave, so 16-row
# 128-column slices; the tiny step: 16 and 32 blocks, the same)
FWD_PLANS = [
    *((4, 256, d, (16, 128)) for d in range(128, 1025, 128)),
    *((64, 2048, d, (32, d)) for d in range(128, 513, 128)),
    *((64, 2048, d, (16, d)) for d in range(640, 1025, 128)),
    *((4, 128, d, (16, 128)) for d in range(128, 1025, 128))]
# (kv heads, sk, d, dk/dv's plan): phase 7e flat (4) and packed (2 kv heads
# of n_rep 2), the 8B shape, the tiny step
DKV_PLANS = [
    *((kv, 256, d, (16, 128)) for kv in (4, 2) for d in range(128, 1025, 128)),
    *((64, 2048, d, (16, d if d <= 512 else 128))
      for d in range(128, 1025, 128)),
    *((4, 128, d, (16, 128)) for d in range(128, 1025, 128))]


@pytest.mark.parametrize("heads,sq,d,plan", FWD_PLANS)
def test_wide_f32_fwd_plan_by_wave_and_registers(heads, sq, d, plan):
    """The whole head at the first tile whose rows of it fit 64
    accumulators a thread (32 rows up to 512 columns, 16 up to 1024) and
    whose blocks make a wave; else 128-column slices of 16 rows."""
    assert fa.wide_f32_fwd_plan(heads, sq, d) == plan
    tile, width = plan
    assert tile * width <= fa.WIDE_F32_ACC and d % width == 0
    assert fa.wide_f32_smem("fwd", tile, d) <= MAX_BLOCK_SMEM


@pytest.mark.parametrize("kv_heads,sk,d,plan", DKV_PLANS)
def test_wide_f32_dkv_plan_by_wave_and_registers(kv_heads, sk, d, plan):
    """The whole head where 16 keys of dK and dV fit 64 accumulators a
    thread (up to 512 columns) and the blocks make a wave; else 128-column
    slices."""
    assert fa.wide_f32_dkv_plan(kv_heads, sk, d) == plan
    tile, width = plan
    assert 2 * tile * width <= fa.WIDE_F32_ACC and d % width == 0
    assert fa.wide_f32_smem("dkv", tile, d) <= MAX_BLOCK_SMEM


@pytest.mark.parametrize("heads,sq,d,plan", [
    (128, 32, 512, (32, 512)), (127, 32, 512, (16, 512)),  # 32 rows' wave
    (1, 32 * 127, 512, (16, 512)), (1, 32 * 128, 512, (32, 512)),
    (1, 32 * 127 + 1, 512, (32, 512)),  # the ragged last tile counts
    (64, 2048, 640, (16, 640)), (64, 2048, 1024, (16, 1024)),  # 16 rows
    (64, 2048, 1152, (16, 128)),  # the registers: 128-column slices
    (128, 16, 640, (16, 640)), (127, 16, 640, (16, 128)),  # 16 rows' wave
    (1, 16, 512, (16, 128))])  # no wave at all
def test_wide_f32_fwd_plan_switches(heads, sq, d, plan):
    assert fa.wide_f32_fwd_plan(heads, sq, d) == plan


@pytest.mark.parametrize("kv_heads,sk,d,plan", [
    (128, 16, 512, (16, 512)), (127, 16, 512, (16, 128)),
    (1, 16 * 128, 512, (16, 512)), (1, 16 * 127 + 1, 512, (16, 512)),
    (1, 16 * 127, 512, (16, 128)),
    (64, 2048, 512, (16, 512)), (64, 2048, 640, (16, 128))])
def test_wide_f32_dkv_plan_switches(kv_heads, sk, d, plan):
    assert fa.wide_f32_dkv_plan(kv_heads, sk, d) == plan


@pytest.mark.parametrize("d", range(128, 4097, 128))
def test_wide_f32_smem_at_every_plan(d):
    """Every pair the entries take at head_dim d (the whole head where its
    tile's rows fit the registers, 128-column slices anywhere) fits a
    block: Q (K and V) stay resident while they fit the accumulators'
    budget, and the rings shrink (forward) or carry K and V (dk/dv) when
    they stream."""
    for tile in fa.WIDE_F32_FWD_TILES:  # 32 rows only with Q resident
        if tile == 16 or tile * d <= fa.WIDE_F32_ACC:
            assert fa.wide_f32_smem("fwd", tile, d) <= MAX_BLOCK_SMEM
    assert fa.wide_f32_smem("dkv", fa.WIDE_F32_DKV_TILE, d) <= MAX_BLOCK_SMEM
    # the largest: Q of 32 rows x 512 (16 x 1024), K and V of 16 x 512
    if d in (512, 1024):
        assert fa.wide_f32_smem("fwd", 16384 // d, d) > 190000
    if d == 512:
        assert fa.wide_f32_smem("dkv", 16, d) > 200000


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


# ---------------------------------------- the float32 kernels' rings

# the float32 kernels' stages (csrc/flash_wide.cu kFwdF32Ring, kDkvRing) and
# the deepest wait they issue (cp_async_wait_upto)
F32_FWD_RING = {True: 9, False: 6}
DKV_RING = 9
MAX_WAIT = 8


class _Ring:
    """One thread's cp.async groups over a ring of `stages` stages (every
    thread issues the same groups and waits alike, then meets the others at
    the barrier): `issue` commits the loads of a step, `advance` is
    ring_advance (the wait, the barrier, the refill of the stages whose
    steps are before `released`), and `read` asserts that a step's chunk
    is landed and still in its stage."""

    def __init__(self, stages, total, resident):
        self.stages, self.total, self.resident = stages, total, resident
        self.groups = [{"resident"}] if resident else []
        self.holds = {}
        self.loaded = 0
        self.needed = set()  # steps a read still to come needs
        while self.loaded < total and self.loaded < stages:
            self.issue()

    def issue(self):
        target = self.loaded % self.stages
        held = self.holds.get(target)
        assert held is None or held not in self.needed, (
            f"step {self.loaded}'s refill takes the stage of step {held}, "
            f"which a read still needs")
        self.holds[target] = self.loaded
        self.groups.append({self.loaded})
        self.loaded += 1

    def advance(self, step, released):
        pending = min(max(self.loaded - 1 - step, 0), MAX_WAIT)
        self.landed = set().union(*self.groups[:len(self.groups) - pending])
        self.needed -= set(range(released))
        while self.loaded < self.total and self.loaded < released + \
                self.stages:
            self.issue()

    def read(self, step):
        assert step in self.landed
        assert not self.resident or "resident" in self.landed
        assert self.holds[step % self.stages] == step  # not overwritten


def _walk_f32_forward(nk, nv, n_kt, resident):
    """The float32 forward's ring for a head of nk 128-column K steps and a
    slice of nv V steps, over n_kt key tiles: a K step is read only during
    itself, so its barrier frees every step before it; the V steps are
    waited for at once (at the last one's step) and read together by the
    tile's P·V, so they stay until the next tile's first barrier."""
    per = nk + nv
    total = n_kt * per
    ring = _Ring(F32_FWD_RING[resident], total, resident)
    walked = 0
    for t in range(n_kt):
        start = t * per
        v_steps = set(range(start + nk, start + per))
        for step in range(start, start + nk):
            ring.needed = set(range(step, total))
            ring.advance(step, step)
            ring.read(step)
            walked += 1
        ring.needed = set(range(start + nk, total))
        ring.advance(start + per - 1, start + nk)
        for step in sorted(v_steps):  # P·V
            ring.read(step)
            walked += 1
    return walked


def _chunk_of(j, slice_, n, m=2):
    c = m * (slice_ + 1) + j
    return c if c < n else c - n


def _walk_f32_dkv(n, m, tiles, resident):
    """The float32 dk/dv's ring (`ring_step` with kLag 0) for a head of n
    64-column chunks and a slice of m, over `tiles` query tiles: the
    slice's chunks, walked last, are read again by the tile's output
    products after its last step; a later tile's refill may take them only
    after that."""
    ring = _Ring(DKV_RING, tiles * n, resident)
    for tt in range(tiles):
        start = tt * n
        slice_steps = set(range(start + n - m, start + n))
        for j in range(n):
            step = start + j
            # reads to come: this step on, and this tile's slice chunks
            ring.needed = set(range(step, tiles * n)) | slice_steps
            released = step if j == 0 else min(step, start + n - m)
            ring.advance(step, released)
            ring.read(step)
        for step in sorted(slice_steps):  # the output products
            assert ring.holds[step % DKV_RING] == step
    return ring.loaded


@pytest.mark.parametrize("d", [128, 384, 512, 640, 1024, 1152])
@pytest.mark.parametrize("n_kt", [0, 1, 2, 7])
def test_wide_f32_fwd_ring_walk(d, n_kt):
    """Every plan's ring: the whole head (nv = nk) with Q resident, and
    128-column slices with Q resident or (16 rows) streamed (6 stages)."""
    for tile in fa.WIDE_F32_FWD_TILES:
        resident = tile * d <= fa.WIDE_F32_ACC
        widths = {128, d} if resident else {128} if tile == 16 else set()
        for width in widths:
            nk, nv = d // 128, width // 128
            assert _walk_f32_forward(nk, nv, n_kt, resident) == \
                n_kt * (nk + nv)


@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 1152])
@pytest.mark.parametrize("tiles", [0, 1, 2, 9])
def test_wide_f32_dkv_ring_walk(d, tiles):
    """The whole head up to 512 (m = n chunks kept, the ring one stage
    deeper than a tile) and 128-column slices (m = 2) at any width, K and V
    resident up to 512."""
    n = d // 64
    for width in ({128, d} if d <= 512 else {128}):
        assert _walk_f32_dkv(n, width // 64, tiles, d <= 512) == tiles * n


def test_wide_f32_dkv_ring_needs_a_stage_beyond_the_tile():
    """With the whole head kept, a ring no deeper than the tile's chunks
    would have to refill a chunk the output products still read: the walk
    catches it (the kernel's ring is DKV_RING = 9 > 8 chunks at 512)."""
    global DKV_RING
    saved = DKV_RING
    try:
        DKV_RING = 7
        with pytest.raises(AssertionError):
            _walk_f32_dkv(8, 8, 2, True)
    finally:
        DKV_RING = saved


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


# -------------------------------------- the float32 forward's and dk/dv's


def _emulate_f32_forward(q, k, v, scale, causal, tile, width):
    """The float32 forward's blocks over grouped [b, h, sq, kd] q and [b,
    kv, sk, kd] k/v (kd a multiple of 128, query head h reading kv head h
    // n_rep): per (head, query tile of `tile` rows, slice of `width`
    columns) the key tiles of 32 keys, S summed a 128-column step at a time,
    entries no row may attend set to -1e30, the online softmax in exp2 of
    log2e-scaled scores with p kept 0 while a row's max is -1e30, and O
    rescaled by alpha, then O += P·V a 128-column group at a time; out = o
    / max(l, 1e-30), lse from slice 0."""
    b, h, sq, kd = q.shape
    n_rep = h // k.shape[1]
    sk = k.shape[2]
    scale2 = np.float32(scale) * LOG2E
    out = np.zeros_like(q)
    lse = np.zeros((b, h, sq), np.float32)
    for bi, hi, qt, sl in itertools.product(range(b), range(h),
                                            range(_cdiv(sq, tile)),
                                            range(kd // width)):
        q0, c0 = qt * tile, sl * width
        rows = np.arange(q0, q0 + tile)
        n_rows = min(sq - q0, tile)
        qb = np.zeros((tile, kd), np.float32)
        qb[:n_rows] = q[bi, hi, q0:q0 + n_rows]
        kh, vh = k[bi, hi // n_rep], v[bi, hi // n_rep]
        m = np.full(tile, NEG)
        l = np.zeros(tile, np.float32)
        o = np.zeros((tile, width), np.float32)
        for t in range(_key_tiles(q0, tile, sq, sk, causal, F32_KEYS)):
            k0 = t * F32_KEYS
            kb, vb = (np.zeros((F32_KEYS, kd), np.float32) for _ in range(2))
            n_in = min(sk - k0, F32_KEYS)
            kb[:n_in], vb[:n_in] = kh[k0:k0 + n_in], vh[k0:k0 + n_in]
            s = np.zeros((tile, F32_KEYS), np.float32)
            for c in range(0, kd, 128):
                s += qb[:, c:c + 128] @ kb[:, c:c + 128].T
            ok = _valid(rows, np.arange(k0, k0 + F32_KEYS), sq, sk, causal)
            s = np.where(ok, s, NEG)
            mx = np.maximum(m, s.max(1))
            alpha = np.exp2((m - mx) * scale2)
            p = np.where((mx == NEG)[:, None], np.float32(0),
                         np.exp2(s * scale2 - (mx * scale2)[:, None]))
            m, l = mx, l * alpha + p.sum(1)
            o *= alpha[:, None]
            for c in range(0, width, 128):
                o[:, c:c + 128] += p @ vb[:, c0 + c:c0 + c + 128]
        lc = np.maximum(l, np.float32(1e-30))
        out[bi, hi, q0:q0 + n_rows, c0:c0 + width] = (o / lc[:, None])[
            :n_rows]
        if sl == 0:
            lse[bi, hi, q0:q0 + n_rows] = np.where(
                m == NEG, NEG, m * np.float32(scale) + np.log(lc))[:n_rows]
    return out, lse


def _emulate_f32_dkv(q, k, v, do, lse, delta, scale, causal, width):
    """The float32 dk/dv's blocks over grouped operands (lse, delta [b, h,
    sq]): per (kv head, key tile of 16, slice of `width` columns), the
    n_rep query heads in order, each over its query tiles of 32 rows from
    the first whose band reaches the key tile (`query_tiles`): S^T and dP^T
    summed chunk by chunk in `chunk_of` order (the slice's chunks last), p
    selected to 0 where a row may not attend, ds = p (dp - delta) scale,
    dV_slice += P^T·dO_slice and dK_slice += dS^T·Q_slice into one sum."""
    b, h, sq, kd = q.shape
    n_kv, sk = k.shape[1], k.shape[2]
    n_rep = h // n_kv
    keys_n = fa.WIDE_F32_DKV_TILE
    n, m = kd // CHUNK, width // CHUNK
    scale2 = np.float32(scale) * LOG2E
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bi, g, kt, sl in itertools.product(range(b), range(n_kv),
                                           range(_cdiv(sk, keys_n)),
                                           range(kd // width)):
        k0, c0 = kt * keys_n, sl * width
        keys = np.arange(k0, k0 + keys_n)
        n_in = min(sk - k0, keys_n)
        kb, vb = (np.zeros((keys_n, kd), np.float32) for _ in range(2))
        kb[:n_in], vb[:n_in] = k[bi, g, k0:k0 + n_in], v[bi, g, k0:k0 + n_in]
        adk, adv = (np.zeros((keys_n, width), np.float32) for _ in range(2))
        for r in range(n_rep):
            hi = g * n_rep + r
            for qb in fa.query_tiles(k0, sq, sk, causal, F32_KEYS):
                q0 = qb * F32_KEYS
                rows = np.arange(q0, q0 + F32_KEYS)
                n_rows = min(sq - q0, F32_KEYS)
                qt, dot = (np.zeros((F32_KEYS, kd), np.float32)
                           for _ in range(2))
                qt[:n_rows] = q[bi, hi, q0:q0 + n_rows]
                dot[:n_rows] = do[bi, hi, q0:q0 + n_rows]
                lse2, dlt = (np.zeros(F32_KEYS, np.float32) for _ in range(2))
                lse2[:n_rows] = lse[bi, hi, q0:q0 + n_rows] * LOG2E
                dlt[:n_rows] = delta[bi, hi, q0:q0 + n_rows]
                st, dpt = (np.zeros((keys_n, F32_KEYS), np.float32)
                           for _ in range(2))
                for j in range(n):
                    c = _chunk_of(j, sl, n, m) * CHUNK
                    st += kb[:, c:c + CHUNK] @ qt[:, c:c + CHUNK].T
                    dpt += vb[:, c:c + CHUNK] @ dot[:, c:c + CHUNK].T
                ok = _valid(rows, keys, sq, sk, causal).T
                with np.errstate(over="ignore"):
                    p = np.where(ok, np.exp2(st * scale2 - lse2[None]), 0)
                ds = np.where(ok, p * (dpt - dlt[None]) * np.float32(scale),
                              0).astype(np.float32)
                adv += p.astype(np.float32) @ dot[:, c0:c0 + width]
                adk += ds @ qt[:, c0:c0 + width]
        dk[bi, g, k0:k0 + n_in, c0:c0 + width] = adk[:n_in]
        dv[bi, g, k0:k0 + n_in, c0:c0 + width] = adv[:n_in]
    return dk, dv


def _grouped(x, n, kd):
    """[b, s, n·d] -> [b, n, s, kd], each head zero-padded to kd."""
    b, s, w = x.shape
    x = x.reshape(b, s, n, w // n).transpose(0, 2, 1, 3)
    return np.pad(x, ((0, 0), (0, 0), (0, 0), (0, kd - w // n)))


def _ungrouped(x, d):
    """The inverse of `_grouped`: [b, n, s, kd] -> [b, s, n·d]."""
    b, n, s, _ = x.shape
    return x[..., :d].transpose(0, 2, 1, 3).reshape(b, s, n * d)


# (b, heads, kv heads, sq, sk, d, causal, the reference's block_q,
# block_k): 320 (padded to 384) causal over ragged tiles, 512 not causal
# with sq < sk, and GQA 4/2 at 384 through the packed reference
F32_CASES = [(2, 1, 1, 150, 150, 320, True, 64, 64),
             (1, 1, 1, 64, 100, 512, False, 32, 64),
             (1, 4, 2, 70, 70, 384, True, 32, 32)]


def _reference(case):
    """The reference's out, lse, dk and dv on the case's numpy inputs (the
    packed Pallas kernels where heads > 1), lse [b, h, sq]."""
    b, h, kv, sq, sk, d, causal, bq, bk = case
    rng = np.random.default_rng(sum(case[:6]))
    q, do = (rng.standard_normal((b, sq, h * d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kv * d)).astype(np.float32)
            for _ in range(2))
    scale = d ** -0.5
    if h == 1:
        out, lse = jfa._flash_fwd(q, k, v, scale, causal, bq, bk)
        _, dk, dv = jfa._flash_bwd(q, k, v, out, lse, do, scale, causal, bq,
                                   bk)
        lse = np.array(lse)
        lse = (lse.reshape(b, -1, sq)[:, :1] if lse.ndim == 3
               else lse[:, None])
    else:
        out, lse = jfa._flash_fwd_packed(q, k, v, h, kv, scale, causal, bq,
                                         bk)
        _, dk, dv = jfa._flash_bwd_packed(q, k, v, out, lse, do, h, kv,
                                          scale, causal, bq, bk)
        lse = np.array(lse).reshape(b, h, 8, sq)[:, :, 0]
    return (q, k, v, do), tuple(np.array(x) for x in (out, lse, dk, dv))


_REFERENCES = {}


def _cached_reference(case):
    if case not in _REFERENCES:
        _REFERENCES[case] = _reference(case)
    return _REFERENCES[case]


def _plans(kernel, kd):
    """Every plan the entry takes at head_dim kd: (tile, width)."""
    if kernel == "fwd":  # Q streams only at 16 rows and 128 columns
        return [(tile, width) for tile in fa.WIDE_F32_FWD_TILES
                for width in sorted({128, kd})
                if tile * kd <= fa.WIDE_F32_ACC
                or (tile, width) == (16, 128)]
    return [(16, width) for width in sorted({128, kd})
            if width == 128 or 2 * 16 * kd <= fa.WIDE_F32_ACC]


@pytest.mark.parametrize("case", F32_CASES)
@pytest.mark.parametrize("plan", [(32, "d"), (16, "d"), (32, 128),
                                  (16, 128)])
def test_emulated_f32_forward_matches_pallas(case, plan):
    """The float32 forward's emulation at each of its plans (the whole
    head at 32 and 16 rows, 128-column slices at both) against the
    reference's forward."""
    (q, k, v, _), (out, lse, _, _) = _cached_reference(case)
    b, h, kv, sq, sk, d, causal = case[:7]
    kd = fa.kernel_head_dim(d)
    tile, width = plan[0], kd if plan[1] == "d" else plan[1]
    assert (tile, width) in _plans("fwd", kd)
    e_out, e_lse = _emulate_f32_forward(
        _grouped(q, h, kd), _grouped(k, kv, kd), _grouped(v, kv, kd),
        d ** -0.5, causal, tile, width)
    np.testing.assert_allclose(_ungrouped(e_out, d), out, **TOL)
    np.testing.assert_allclose(e_out[..., d:], 0)
    np.testing.assert_allclose(e_lse, lse, **TOL)


@pytest.mark.parametrize("case", F32_CASES)
@pytest.mark.parametrize("width", ["d", 128])
def test_emulated_f32_dkv_matches_pallas(case, width):
    """The float32 dk/dv's emulation at each of its plans (the whole head,
    128-column slices) against the reference's dk and dv, GQA summed over
    the n_rep query heads in order."""
    (q, k, v, do), (out, lse, dk, dv) = _cached_reference(case)
    b, h, kv, sq, sk, d, causal = case[:7]
    kd = fa.kernel_head_dim(d)
    width = kd if width == "d" else width
    assert (16, width) in _plans("dkv", kd)
    delta = (_grouped(do, h, d) * _grouped(out, h, d)).sum(-1)
    e_dk, e_dv = _emulate_f32_dkv(
        _grouped(q, h, kd), _grouped(k, kv, kd), _grouped(v, kv, kd),
        _grouped(do, h, kd), lse, delta, d ** -0.5, causal, width)
    np.testing.assert_allclose(_ungrouped(e_dk, d), dk, **TOL)
    np.testing.assert_allclose(_ungrouped(e_dv, d), dv, **TOL)
    np.testing.assert_allclose(e_dk[..., d:], 0)


@pytest.mark.parametrize("d,width", [(384, 384), (384, 128), (640, 128)])
def test_emulated_f32_kernels_where_rows_see_no_key(d, width):
    """Causal with sq 200 > sk 64: rows 0-135 see no key. The float32
    forward's emulation gives out 0 and lse -1e30 there (at 32 and 16 rows)
    and dk/dv's takes nothing from them; both agree with the port's plain
    versions everywhere."""
    q, k, v, do = _inputs(2, 200, 64, d, 5)
    scale = d ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    p_out, p_lse = fa.flash_fwd_plain(*t[:3], scale, True)
    delta = fa.flash_delta(p_out, t[3])
    p_dk, p_dv = fa.flash_bwd_dkv_plain(*t, p_lse, delta, scale, True)

    def grouped(x):  # [b·h, s, d] as b·h batches of one head
        return x[:, None]

    for tile in fa.WIDE_F32_FWD_TILES:
        if width != 128 and tile * d > fa.WIDE_F32_ACC:
            continue
        e_out, e_lse = _emulate_f32_forward(grouped(q), grouped(k),
                                            grouped(v), scale, True, tile,
                                            width)
        assert (e_out[:, 0, :136] == 0).all()
        assert (e_lse[:, 0, :136] == NEG).all()
        np.testing.assert_allclose(e_out[:, 0], p_out.numpy(), **TOL)
        np.testing.assert_allclose(e_lse[:, 0, 136:],
                                   p_lse.numpy()[:, 136:], **TOL)
    if width != 128 and 2 * 16 * d > fa.WIDE_F32_ACC:
        return
    e_dk, e_dv = _emulate_f32_dkv(grouped(q), grouped(k), grouped(v),
                                  grouped(do), p_lse.numpy()[:, None],
                                  delta.numpy()[:, None], scale, True, width)
    np.testing.assert_allclose(e_dk[:, 0], p_dk.numpy(), **TOL)
    np.testing.assert_allclose(e_dv[:, 0], p_dv.numpy(), **TOL)
