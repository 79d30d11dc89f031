"""Flash attention, forward and backward (twin of
ray_tpu/ops/pallas/flash_attention.py:38-364).

Over `[b·h, s, head_dim]` tensors, causal or not, with the causal mask
aligned to the END of the key axis (row r sees keys <= r + sk - sq, the
KV-cache convention):

  * `flash_fwd` -> (out, lse): online-softmax attention; lse is the per-row
    logsumexp, stored `[b·h, sq]` float32 (the reference broadcasts it over
    8 sublanes, `[b·h, 8, sq]`, only for the TPU's tiling);
  * `flash_bwd` -> (dq, dk, dv): the FlashAttention-2 recompute backward.
    Δ = rowsum(dO ⊙ O) is plain torch here, as in the reference; then
    `flash_bwd_dkv` accumulates dk/dv per key tile and `flash_bwd_dq`
    accumulates dq per query tile, each recomputing p from lse;
  * `FlashAttention`: the autograd.Function over the pair (the twin of
    `flash_attention_pallas`).

On a CUDA tensor each of the three wrappers launches its hand-written kernel
(csrc/flash_attention.cu) or raises: the kernels take bfloat16 or float32
operands, all of one dtype (`KERNEL_DTYPES`; the reference computes in the
input dtype), and any head_dim. Up to 256 they are instantiated at 32, 64,
128 and 256 (`HEAD_DIMS`); above 256 the wide family (csrc/flash_wide.cu)
takes the head in output slices of `WIDE_SLICE` columns (`WIDE_FWD_SLICE`
in the bf16 forward, whose staging plan is `wide_fwd_plan`; the whole head
in the float32 forward and dk/dv where it fits, below), recomputing the
score over the whole width in each. The wrappers zero-pad any other
head_dim to the next instantiated one, or to a multiple of `WIDE_SLICE`,
before the launch and slice the outputs back (`kernel_head_dim`,
`pad_heads`, `unpad_heads`; exact, since the scale is the caller's). Each
wrapper counts its launches in `.launches` and, of those, the float32
kernel's in `.f32_launches` and the wide family's in `.wide_launches`.
The float32 kernels up to 256 also take a tile height planned from the
shape: the query tile of the forward and dq (`f32_fwd_tile`: 64 rows
where those tiles alone make a wave of the card, else 16) and the key
tile of dk/dv (`f32_dkv_tile`, the same rule over kv heads and keys); dq
and dk/dv stream the other side in tiles of `F32_BWD_STREAM` rows. The
wide float32 dq takes one too (`wide_f32_dq_tile`, slices counted), and
the wide float32 forward and dk/dv a tile and a slice width: the whole
padded head where the tile's rows of it fit the registers, so S is
computed once (`wide_f32_fwd_plan`, `wide_f32_dkv_plan`).
`key_tiles`, `tile_needs_mask`, `query_tiles` and `bwd_tile_needs_mask`
are the kernels' causal-band arithmetic, in Python for the tests. The
plain PyTorch versions beside them run for tensors on the CPU; they
compute densely in float32 with the kernels' masking and roundings (p and
ds rounded to the input dtype before the products they feed). Over
[b·h, s, d] GQA is the caller's: K/V come in repeated per query head.

The packed layout (twin of `_flash_fwd_packed`/`_flash_bwd_packed`,
ray_tpu/ops/pallas/flash_attention.py:376-502) runs the same three kernels
over `[b, s, heads·head_dim]` operands, the layout the q/k/v projections
produce: each head is a column slice found by strides, and GQA is the index
map `h // n_rep`, so K/V `[b, sk, n_kv·head_dim]` are never repeated and the
dk/dv kernel sums the n_rep query heads of a kv head in float32 before its
one write. lse and Δ are `[b, heads, sq]` (the reference's `[b, 8·heads,
sq]` broadcast is TPU tiling). Entries: `flash_fwd_packed`,
`flash_bwd_dkv_packed`, `flash_bwd_dq_packed` (each with its plain twin and
launch counter, in `PACKED_KERNELS`), `flash_bwd_packed`,
`FlashAttentionPacked` and `flash_attention_packed`, the twin of the
reference's entry of that name. The Pallas block sizes are TPU tiling and
are not carried over.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.kernels._util import (KERNEL_DTYPES, WAVE_BLOCKS,
                                             cdiv, check, count_launch,
                                             dtype_entry, stream_handle,
                                             with_f32)

_NEG_INF = -1e30
# The head dims the CUDA kernels of flash_attention.cu are instantiated at.
# Any other head_dim up to the last is zero-padded to the next of them
# before the launch and the outputs sliced back (`pad_heads`,
# `unpad_heads`); a wider one is zero-padded to a multiple of WIDE_SLICE and
# runs the wide family of flash_wide.cu, one block a slice of that many
# output columns.
HEAD_DIMS = (32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
WIDE_SLICE = 128

_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry takes the packed layout (batch, heads, n_rep, sq, sk, d);
# [b·h, s, d] operands are batch = b·h, heads = n_rep = 1.
_LAYOUT = [_INT] * 6
_SIGNATURES = {
    **with_f32({
        "rt_flash_fwd": ([_P] * 5 + _LAYOUT + [_F, _INT, _P], _INT),
        "rt_flash_bwd_dkv": ([_P] * 8 + _LAYOUT + [_F, _INT, _P], _INT),
        "rt_flash_bwd_dq": ([_P] * 7 + _LAYOUT + [_F, _INT, _P], _INT),
    }),
    # the float32 kernels also take their tile (`f32_fwd_tile`,
    # `f32_dkv_tile`)
    "rt_flash_fwd_f32": ([_P] * 5 + _LAYOUT + [_F, _INT, _INT, _P], _INT),
    "rt_flash_bwd_dkv_f32": ([_P] * 8 + _LAYOUT + [_F, _INT, _INT, _P],
                             _INT),
    "rt_flash_bwd_dq_f32": ([_P] * 7 + _LAYOUT + [_F, _INT, _INT, _P], _INT),
}
# The wide family: the bf16 entries' arguments, but the float32 ones also
# take their plan: the dq its query tile (`wide_f32_dq_tile`), the forward
# and dk/dv their tile and slice width (`wide_f32_fwd_plan`,
# `wide_f32_dkv_plan`).
_WIDE_SIGNATURES = {
    "rt_flash_wide_fwd": _SIGNATURES["rt_flash_fwd"],
    "rt_flash_wide_bwd_dkv": _SIGNATURES["rt_flash_bwd_dkv"],
    "rt_flash_wide_bwd_dq": _SIGNATURES["rt_flash_bwd_dq"],
    "rt_flash_wide_fwd_f32": ([_P] * 5 + _LAYOUT + [_F, _INT, _INT, _INT, _P],
                              _INT),
    "rt_flash_wide_bwd_dkv_f32": (
        [_P] * 8 + _LAYOUT + [_F, _INT, _INT, _INT, _P], _INT),
    "rt_flash_wide_bwd_dq_f32": _SIGNATURES["rt_flash_bwd_dq_f32"],
}

# The float32 plan: a forward or dq block owns F32_FWD_TILES[0] query rows
# of one head where those tiles alone make a wave of WAVE_BLOCKS blocks,
# else F32_FWD_TILES[1], and a dk/dv block the same number of keys of one
# kv head by the same rule (csrc/flash_attention.cu, "float32"). The
# forward walks keys in tiles of KEY_TILE; dq walks keys, and dk/dv query
# rows, in tiles of F32_BWD_STREAM.
F32_FWD_TILES = (64, 16)
KEY_TILE = 64
F32_BWD_STREAM = 32
# The bf16 wide forward (csrc/flash_wide.cu, "bf16 forward"): a ring of
# WIDE_FWD_STAGES chunk stages, and the block's Q resident up to head_dim
# WIDE_FWD_RESIDENT_MAX with output slices of WIDE_FWD_SLICE columns
# (`wide_fwd_plan`).
WIDE_FWD_SLICE = 256
WIDE_FWD_STAGES = 8
WIDE_FWD_RESIDENT_MAX = 512
# The wide float32 forward and dk/dv (csrc/flash_wide.cu, "float32
# forward", "float32 dk/dv"): a block's output accumulators hold at most
# WIDE_F32_ACC floats (64 a thread of 256), so a block owns the whole padded
# head, and computes S once, where its tile's rows of it fit (and the
# blocks make a wave), else slices of WIDE_SLICE columns. The forward's
# query tile is one of WIDE_F32_FWD_TILES, dk/dv's key tile
# WIDE_F32_DKV_TILE; both walk the other side in tiles of F32_BWD_STREAM.
WIDE_F32_ACC = 16384
WIDE_F32_FWD_TILES = (32, 16)
WIDE_F32_DKV_TILE = 16


def f32_fwd_tile(heads: int, sq: int) -> int:
    """The query-tile height of the float32 forward and dq over `heads`
    query heads (b·h, or b x heads in the packed layout) of sq rows."""
    for tile in F32_FWD_TILES:
        if heads * cdiv(sq, tile) >= WAVE_BLOCKS:
            return tile
    return F32_FWD_TILES[-1]


def wide_f32_dq_tile(heads: int, sq: int, d: int) -> int:
    """The query-tile height of the wide float32 dq (csrc/flash_wide.cu,
    "float32 dq") over `heads` query heads of sq rows at head_dim d (a
    multiple of WIDE_SLICE): F32_FWD_TILES[0] where those blocks, one a
    WIDE_SLICE-column slice of dq, alone make a wave of WAVE_BLOCKS, else
    F32_FWD_TILES[1]."""
    for tile in F32_FWD_TILES:
        if heads * cdiv(sq, tile) * (d // WIDE_SLICE) >= WAVE_BLOCKS:
            return tile
    return F32_FWD_TILES[-1]


def wide_fwd_plan(d: int) -> Tuple[bool, int, int]:
    """The bf16 wide forward's staging plan at head_dim d (a multiple of
    WIDE_SLICE), as csrc/flash_wide.cu's `fwd_entry` picks it: (whether the
    block's 128 query rows of Q stay resident in shared memory, the number
    of output slices, and the dynamic shared memory of a block in bytes).
    Resident Q (up to WIDE_FWD_RESIDENT_MAX): slices of WIDE_FWD_SLICE
    columns, the last one WIDE_SLICE where d is an odd multiple of it;
    streamed Q: slices of WIDE_SLICE. Shared memory: the ring of
    WIDE_FWD_STAGES K chunks (64 keys x 64 columns), with Q's chunk (128
    rows) beside each where Q streams, a key tile's V slice, resident Q,
    and 1 KB to align the tiles."""
    resident = d <= WIDE_FWD_RESIDENT_MAX
    q_chunk, k_chunk = 128 * 64 * 2, 64 * 64 * 2
    stage = k_chunk if resident else q_chunk + k_chunk
    width = WIDE_FWD_SLICE if resident else WIDE_SLICE
    smem = (WIDE_FWD_STAGES * stage + 64 * width * 2
            + (128 * d * 2 if resident else 0) + 1024)
    return resident, cdiv(d, width), smem


def wide_f32_fwd_plan(heads: int, sq: int, d: int) -> Tuple[int, int]:
    """The wide float32 forward's (query tile, slice width) over `heads`
    query heads of sq rows at head_dim d (a multiple of WIDE_SLICE), as
    csrc/flash_wide.cu's `fwd_f32_entry` takes it: the whole head at the
    first tile of WIDE_F32_FWD_TILES whose rows of it fit WIDE_F32_ACC and
    whose blocks make a wave of WAVE_BLOCKS; else WIDE_SLICE-column slices
    of 16 rows (at chip_smoke phase 7e's float32 shapes, 0.79-0.88x the
    time of 32-row slices and 0.64-0.85x that of the whole head: PERF.md
    §6)."""
    for tile in WIDE_F32_FWD_TILES:
        if (tile * d <= WIDE_F32_ACC
                and heads * cdiv(sq, tile) >= WAVE_BLOCKS):
            return tile, d
    return WIDE_F32_FWD_TILES[-1], WIDE_SLICE


def wide_f32_dkv_plan(kv_heads: int, sk: int, d: int) -> Tuple[int, int]:
    """The wide float32 dk/dv's (key tile, slice width) over `kv_heads` kv
    heads of sk keys at head_dim d, as `dkv_f32_entry` takes it: the whole
    head where dK's and dV's WIDE_F32_DKV_TILE rows of it fit WIDE_F32_ACC
    together and the blocks make a wave, else WIDE_SLICE-column slices."""
    tile = WIDE_F32_DKV_TILE
    if (2 * tile * d <= WIDE_F32_ACC
            and kv_heads * cdiv(sk, tile) >= WAVE_BLOCKS):
        return tile, d
    return tile, WIDE_SLICE


def wide_f32_smem(kernel: str, tile: int, d: int) -> int:
    """The dynamic shared memory of a block of the wide float32 "fwd"
    (query tile `tile`) or "dkv" at head_dim d, in bytes, as
    csrc/flash_wide.cu's `fwd_f32_smem` and `dkv_f32_smem` count it. The
    forward: a ring of 9 stages of a K (V) pair of 64-column chunks [2][32]
    [64] where Q stays resident (tile x d, where it fits WIDE_F32_ACC), else
    6 stages with Q's pair [2][tile][64] beside it; the p buffer [32][tile +
    4] and the rows' alpha and l. dk/dv: 9 stages of a Q and a dO chunk
    [32][64], with K's and V's [16][64] where they do not stay resident (16
    x d each, up to d 512); the p and ds buffers [32][16]."""
    if kernel == "fwd":
        resident = tile * d <= WIDE_F32_ACC
        if not resident and tile != 16:
            raise ValueError(f"the wide float32 forward streams Q only at "
                             f"16 rows, not {tile} at head_dim {d}")
        stage = 4 * 2 * 64 * (F32_BWD_STREAM + (0 if resident else tile))
        return ((9 if resident else 6) * stage
                + (4 * tile * d if resident else 0)
                + 4 * (F32_BWD_STREAM * (tile + 4) + 2 * tile))
    resident = 2 * tile * d <= WIDE_F32_ACC
    stage = 4 * 64 * (2 * F32_BWD_STREAM + (0 if resident else 2 * tile))
    return (9 * stage + (4 * 2 * tile * d if resident else 0)
            + 4 * 2 * F32_BWD_STREAM * tile)


def f32_dkv_tile(kv_heads: int, sk: int) -> int:
    """The key-tile height of the float32 dk/dv over `kv_heads` kv heads
    (b·h, or b x n_kv in the packed layout) of sk keys: the forward's rule
    (`f32_fwd_tile`) over its own blocks."""
    return f32_fwd_tile(kv_heads, sk)


def key_tiles(q0: int, rows: int, sq: int, sk: int, causal: bool,
              key_tile: int = KEY_TILE) -> int:
    """How many key tiles of `key_tile` keys a block of query rows [q0,
    q0 + rows) walks (the kernels' `key_blocks`): all of sk, or, causal, up
    to the band of its last row (keys <= row + sk - sq)."""
    n = cdiv(sk, key_tile)
    if causal:
        last = q0 + rows - 1 + sk - sq
        n = min(n, last // key_tile + 1 if last >= 0 else 0)
    return n


def query_tiles(k0: int, sq: int, sk: int, causal: bool,
                query_tile: int = F32_BWD_STREAM) -> range:
    """The query tiles of `query_tile` rows (by index) that a float32
    dk/dv block of keys from k0 walks for each query head: all of sq, or,
    causal, from the tile of the first row that attends key k0 (rows >=
    k0 - (sk - sq))."""
    first = max(k0 - (sk - sq), 0) // query_tile if causal else 0
    return range(first, cdiv(sq, query_tile))


def bwd_tile_needs_mask(q0: int, rows: int, k0: int, keys: int, sq: int,
                        sk: int, causal: bool) -> bool:
    """Whether query rows [q0, q0 + rows) and keys [k0, k0 + keys) hold
    an entry that is not attended (the float32 dq's and dk/dv's
    `pair_needs_mask`): a row past sq, a key past sk, or a key past the
    band of the first row. A pair that needs none holds only rows that see
    keys."""
    return (q0 + rows > sq or k0 + keys > sk
            or (causal and k0 + keys - 1 > q0 + sk - sq))


def tile_needs_mask(q0: int, k0: int, sq: int, sk: int,
                    causal: bool) -> bool:
    """Whether the key tile at k0 holds a key that some row of the query
    block at q0 may not attend (the kernels' `tile_needs_mask`): the ragged
    key tail, or keys past the band of the block's first row."""
    return k0 + KEY_TILE > sk or (causal and k0 + KEY_TILE - 1 > q0 + sk - sq)


def _entry(name: str, dtype: torch.dtype):
    return dtype_entry("flash_attention", _SIGNATURES, name, dtype)


def _wide_entry(name: str, dtype: torch.dtype):
    """The wide family's entry for `name` ("rt_flash_fwd" ->
    "rt_flash_wide_fwd")."""
    return dtype_entry("flash_wide", _WIDE_SIGNATURES,
                       name.replace("rt_flash_", "rt_flash_wide_"), dtype)


# ---------------------------------------------------------------- plain


def _valid(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    """[sq, sk] bool: the entries a row may attend (end-aligned causal)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    if causal:
        return cols <= rows + (sk - sq)
    return torch.ones((sq, sk), dtype=torch.bool, device=device)


def _scores(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(q.shape[-2], k.shape[-2], causal, q.device)
    return s, valid


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel. A row that may attend
    no key (causal with sq > sk: rows r < sq - sk) gives out 0, as the
    kernels do, and lse -1e30."""
    s, valid = _scores(q, k, scale, causal)
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    lse = (m + torch.log(l))[..., 0]
    p = torch.where(valid.any(dim=-1, keepdim=True), p, 0.0)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, lse


def _p_ds_plain(q, k, v, do, lse, delta, scale, causal):
    s, valid = _scores(q, k, scale, causal)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = torch.where(valid, p * (dp - delta[..., None]) * scale, 0.0)
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def _dkv_f32(q, k, v, do, lse, delta, scale, causal):
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk, dv


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel."""
    dk, dv = _dkv_f32(q, k, v, do, lse, delta, scale, causal)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float,
                       causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def _grouped(x: torch.Tensor, groups: int, n_rep: int) -> torch.Tensor:
    """[b, s, groups·n_rep·d] -> [b, groups, n_rep, s, d]: head
    g·n_rep + r at [:, g, r] (query heads by kv head; k/v take n_rep 1)."""
    b, s, width = x.shape
    d = width // (groups * n_rep)
    return x.reshape(b, s, groups, n_rep, d).permute(0, 2, 3, 1, 4)


def _packed(x: torch.Tensor) -> torch.Tensor:
    """[b, groups, n_rep, s, d] -> [b, s, groups·n_rep·d]."""
    b, _, _, s, _ = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, -1)


def _grouped_operands(q, k, v, n_heads, n_kv, *rows):
    """q, k, v and the [b, heads, sq] row tensors `rows`, grouped by kv
    head: K/V broadcast over the n_rep query heads (never repeated)."""
    n_rep = n_heads // n_kv
    b, sq = q.shape[:2]
    return (_grouped(q, n_kv, n_rep), _grouped(k, n_kv, 1),
            _grouped(v, n_kv, 1),
            *(r.reshape(b, n_kv, n_rep, sq) for r in rows))


def flash_fwd_packed_plain(q, k, v, n_heads: int, n_kv: int, scale: float,
                           causal: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed forward: (out [b, sq, h·d], lse
    [b, h, sq] float32)."""
    out, lse = flash_fwd_plain(*_grouped_operands(q, k, v, n_heads, n_kv),
                               scale, causal)
    return _packed(out), lse.reshape(q.shape[0], n_heads, q.shape[1])


def flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta, n_heads: int,
                               n_kv: int, scale: float, causal: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed dk/dv kernel: each kv head's
    n_rep query heads summed in float32 before the one rounding."""
    qg, kg, vg, lg, dg = _grouped_operands(q, k, v, n_heads, n_kv, lse,
                                           delta)
    dog = _grouped(do, n_kv, n_heads // n_kv)
    dk, dv = _dkv_f32(qg, kg, vg, dog, lg, dg, scale, causal)
    return (_packed(dk.sum(2, keepdim=True)).to(k.dtype),
            _packed(dv.sum(2, keepdim=True)).to(v.dtype))


def flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, n_heads: int,
                              n_kv: int, scale: float, causal: bool = True
                              ) -> torch.Tensor:
    """Plain PyTorch version of the packed dq kernel."""
    qg, kg, vg, lg, dg = _grouped_operands(q, k, v, n_heads, n_kv, lse,
                                           delta)
    dog = _grouped(do, n_kv, n_heads // n_kv)
    return _packed(flash_bwd_dq_plain(qg, kg, vg, dog, lg, dg, scale,
                                      causal))


# ---------------------------------------------------------------- padding


def kernel_head_dim(d: int) -> int:
    """The head_dim that a head of width d runs at, zero-padded: the next
    instantiated one up to MAX_HEAD_DIM, above it the next multiple of
    WIDE_SLICE (the wide family's slices)."""
    if d > MAX_HEAD_DIM:
        return -(-d // WIDE_SLICE) * WIDE_SLICE
    return next(kd for kd in HEAD_DIMS if d <= kd)


def pad_heads(x: torch.Tensor, heads: int, d: int, kd: int) -> torch.Tensor:
    """[..., heads·d] -> [..., heads·kd], contiguous: each head's d
    columns followed by kd - d zeros. With the caller's scale kept, the
    zeros add nothing to any score, to dO·Vᵀ or to Δ, and the padded
    columns of out, dq, dk and dv come out zero."""
    if kd == d:
        return x
    lead = x.shape[:-1]
    return torch.nn.functional.pad(x.reshape(*lead, heads, d),
                                   (0, kd - d)).reshape(*lead, heads * kd)


def unpad_heads(x: torch.Tensor, heads: int, d: int, kd: int
                ) -> torch.Tensor:
    """The inverse of `pad_heads`: each head's first d columns, contiguous."""
    if kd == d:
        return x
    lead = x.shape[:-1]
    return x.reshape(*lead, heads, kd)[..., :d].reshape(*lead, heads * d)


# ---------------------------------------------------------------- kernels


def _check(q, k, v, what: str) -> None:
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"{what}: needs q [bh, sq, d] and k/v [bh, sk, d], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in b·h or head_dim")


def _check_cuda(tensors, what: str) -> None:
    """The kernels' contract: CUDA, one device, contiguous, 16-byte
    aligned; operands of one dtype in KERNEL_DTYPES and head_dim at least
    1 (checked by callers)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device (the plain version serves the CPU), "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and "
                             f"16-byte aligned")


def _check_operands(q, k, v, d: int, batch: int, heads: int,
                    what: str) -> None:
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: the CUDA kernels take bfloat16 or float32 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d < 1:
        raise ValueError(f"{what}: the CUDA kernels take head_dim >= 1, "
                         f"got {d}")
    if batch > 65535 or heads > 65535:
        raise ValueError(f"{what}: a grid axis of {max(batch, heads)} "
                         f"exceeds 65535")


def _padded(layout, q, k, v, do=None):
    """(the layout at the kernel's head_dim, and q, k, v and dO
    zero-padded to it, and a function that slices a query-side and a
    key-side result back)."""
    b, heads, n_rep, sq, sk, d = layout
    kd = kernel_head_dim(d)
    n_kv = heads // n_rep
    q, do = (pad_heads(t, heads, d, kd) if t is not None else None
             for t in (q, do))
    k, v = (pad_heads(t, n_kv, d, kd) for t in (k, v))

    def back(x, query_side: bool):
        return unpad_heads(x, heads if query_side else n_kv, d, kd)

    return (b, heads, n_rep, sq, sk, kd), q, k, v, do, back


def _kernel_entry(name: str, layout, dtype: torch.dtype):
    """(library, entry point, wide): the wide family above MAX_HEAD_DIM
    (the padded layout's head_dim), else flash_attention.cu's kernels."""
    if layout[5] > MAX_HEAD_DIM:
        return (*_wide_entry(name, dtype), True)
    return (*_entry(name, dtype), False)


def _launch_fwd(q, k, v, lse, layout, scale, causal, what) -> torch.Tensor:
    layout, q, k, v, _, back = _padded(layout, q, k, v)
    out = torch.empty_like(q)
    lib, fn, wide = _kernel_entry("rt_flash_fwd", layout, q.dtype)
    b, heads, _, sq = layout[:4]
    tile = ()
    if q.dtype == torch.float32:
        tile = (wide_f32_fwd_plan(b * heads, sq, layout[5]) if wide
                else (f32_fwd_tile(b * heads, sq),))
    check(lib, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *layout, float(scale), int(causal), *tile,
        stream_handle(q)), what)
    return back(out, True)


def _launch_dkv(q, k, v, do, lse, delta, layout, scale, causal, what):
    layout, q, k, v, do, back = _padded(layout, q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib, fn, wide = _kernel_entry("rt_flash_bwd_dkv", layout, q.dtype)
    b, heads, n_rep, _, sk = layout[:5]
    tile = ()
    if q.dtype == torch.float32:
        tile = (wide_f32_dkv_plan(b * heads // n_rep, sk, layout[5]) if wide
                else (f32_dkv_tile(b * heads // n_rep, sk),))
    check(lib, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *layout, float(scale), int(causal), *tile, stream_handle(q)), what)
    return back(dk, False), back(dv, False)


def _launch_dq(q, k, v, do, lse, delta, layout, scale, causal, what):
    layout, q, k, v, do, back = _padded(layout, q, k, v, do)
    dq = torch.empty_like(q)
    lib, fn, wide = _kernel_entry("rt_flash_bwd_dq", layout, q.dtype)
    b, heads, _, sq = layout[:4]
    tile = ()
    if q.dtype == torch.float32:
        tile = ((wide_f32_dq_tile(b * heads, sq, layout[5]),) if wide
                else (f32_fwd_tile(b * heads, sq),))
    check(lib, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *layout,
        float(scale), int(causal), *tile, stream_handle(q)), what)
    return back(dq, True)


def _count(wrapper, dtype: torch.dtype, d: int) -> None:
    """One launch of `wrapper`'s kernel at head_dim d: the wide family's
    above MAX_HEAD_DIM."""
    count_launch(wrapper, dtype)
    if d > MAX_HEAD_DIM:
        wrapper.wide_launches += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [bh, sq, d], k/v [bh, sk, d] -> (out [bh, sq, d] in q's dtype, lse
    [bh, sq] float32)."""
    _check(q, k, v, "flash_fwd")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_fwd_plain(q, k, v, scale, causal)
    _check_cuda((q, k, v), "flash_fwd")
    bh, sq, d = q.shape
    _check_operands(q, k, v, d, bh, 1, "flash_fwd")
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if not (bh and sq):
        return torch.empty_like(q), lse
    out = _launch_fwd(q, k, v, lse, (bh, 1, 1, sq, k.shape[1], d), scale,
                      causal, "flash_fwd")
    _count(flash_fwd, q.dtype, d)
    return out, lse


def _check_bwd(q, k, v, do, lse, delta, what):
    _check(q, k, v, what)
    bh, sq, _ = q.shape
    if do.shape != q.shape or lse.shape != (bh, sq) or delta.shape != (bh, sq):
        raise ValueError(f"{what}: dO {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    return _check_bwd_operands(q, k, v, do, lse, delta, q.shape[-1], bh, 1,
                               what)


def _check_bwd_operands(q, k, v, do, lse, delta, d, batch, heads, what):
    """True if every tensor is on the CPU (the plain version runs); else
    raise unless the kernels take them."""
    tensors = (q, k, v, do, lse, delta)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    _check_cuda(tensors, what)
    _check_operands(q, k, v, d, batch, heads, what)
    if do.dtype != q.dtype or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise TypeError(f"{what}: needs dO in q's dtype ({q.dtype}) and "
                        f"float32 lse/delta, got {do.dtype}, {lse.dtype}, "
                        f"{delta.dtype}")
    return False


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each [bh, sk, d] in k's dtype."""
    if _check_bwd(q, k, v, do, lse, delta, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    bh, sq, d = q.shape
    if not (bh and k.shape[1]):
        return torch.empty_like(k), torch.empty_like(v)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta,
                         (bh, 1, 1, sq, k.shape[1], d), scale, causal,
                         "flash_bwd_dkv")
    _count(flash_bwd_dkv, q.dtype, d)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float,
                 causal: bool = True) -> torch.Tensor:
    """dq [bh, sq, d] in q's dtype."""
    if _check_bwd(q, k, v, do, lse, delta, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    bh, sq, d = q.shape
    if not (bh and sq):
        return torch.empty_like(q)
    dq = _launch_dq(q, k, v, do, lse, delta, (bh, 1, 1, sq, k.shape[1], d),
                    scale, causal, "flash_bwd_dq")
    _count(flash_bwd_dq, q.dtype, d)
    return dq


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in float32, [bh, sq] (plain torch, as the
    reference's preprocess step)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention at (q, k, v) given the forward's out `o`
    and `lse` and the output cotangent `do`."""
    delta = flash_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) over [bh, s, d] with the flash kernels in
    both directions (twin of `flash_attention_pallas`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool = True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------- packed


def _check_packed(q, k, v, n_heads: int, n_kv: int, what: str) -> int:
    """Shapes of the packed layout; returns head_dim."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0]:
        raise ValueError(f"{what}: needs q [b, sq, h·d] and k/v [b, sk, "
                         f"n_kv·d], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if n_heads < 1 or n_kv < 1 or n_heads % n_kv or q.shape[2] % n_heads \
            or k.shape[2] != n_kv * (q.shape[2] // n_heads):
        raise ValueError(f"{what}: q width {q.shape[2]} and k width "
                         f"{k.shape[2]} are not {n_heads} and {n_kv} heads "
                         f"of one head_dim, with n_kv dividing n_heads")
    return q.shape[2] // n_heads


def _packed_layout(q, k, n_heads, n_kv, d):
    b, sq, _ = q.shape
    return (b, n_heads, n_heads // n_kv, sq, k.shape[1], d)


def flash_fwd_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int, n_kv: int, scale: float,
                     causal: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, sq, h·d], k/v [b, sk, n_kv·d] -> (out [b, sq, h·d] in q's
    dtype, lse [b, h, sq] float32)."""
    d = _check_packed(q, k, v, n_heads, n_kv, "flash_fwd_packed")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_fwd_packed_plain(q, k, v, n_heads, n_kv, scale, causal)
    _check_cuda((q, k, v), "flash_fwd_packed")
    b, sq, _ = q.shape
    _check_operands(q, k, v, d, b, n_heads, "flash_fwd_packed")
    lse = torch.empty((b, n_heads, sq), dtype=torch.float32,
                      device=q.device)
    if not (b and sq):
        return torch.empty_like(q), lse
    out = _launch_fwd(q, k, v, lse, _packed_layout(q, k, n_heads, n_kv, d),
                      scale, causal, "flash_fwd_packed")
    _count(flash_fwd_packed, q.dtype, d)
    return out, lse


def _check_bwd_packed(q, k, v, do, lse, delta, n_heads, n_kv, what):
    d = _check_packed(q, k, v, n_heads, n_kv, what)
    b, sq, _ = q.shape
    if do.shape != q.shape or lse.shape != (b, n_heads, sq) \
            or delta.shape != (b, n_heads, sq):
        raise ValueError(f"{what}: dO {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)} with {n_heads} "
                         f"heads")
    return d, _check_bwd_operands(q, k, v, do, lse, delta, d, b, n_heads,
                                  what)


def flash_bwd_dkv_packed(q, k, v, do, lse, delta, n_heads: int, n_kv: int,
                         scale: float, causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each [b, sk, n_kv·d] in k's dtype: one kv head's gradient
    summed over its n_rep query heads."""
    d, plain = _check_bwd_packed(q, k, v, do, lse, delta, n_heads, n_kv,
                                 "flash_bwd_dkv_packed")
    if plain:
        return flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta, n_heads,
                                          n_kv, scale, causal)
    if not (q.shape[0] and k.shape[1]):
        return torch.empty_like(k), torch.empty_like(v)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta,
                         _packed_layout(q, k, n_heads, n_kv, d), scale,
                         causal, "flash_bwd_dkv_packed")
    _count(flash_bwd_dkv_packed, q.dtype, d)
    return dk, dv


def flash_bwd_dq_packed(q, k, v, do, lse, delta, n_heads: int, n_kv: int,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """dq [b, sq, h·d] in q's dtype."""
    d, plain = _check_bwd_packed(q, k, v, do, lse, delta, n_heads, n_kv,
                                 "flash_bwd_dq_packed")
    if plain:
        return flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, n_heads,
                                         n_kv, scale, causal)
    if not (q.shape[0] and q.shape[1]):
        return torch.empty_like(q)
    dq = _launch_dq(q, k, v, do, lse, delta,
                    _packed_layout(q, k, n_heads, n_kv, d), scale, causal,
                    "flash_bwd_dq_packed")
    _count(flash_bwd_dq_packed, q.dtype, d)
    return dq


def flash_delta_packed(o: torch.Tensor, do: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """Δ = per-head rowsum(dO ⊙ O) in float32, [b, h, sq] (plain torch, as
    the reference computes it in XLA, flash_attention.py:428-434)."""
    b, sq, width = o.shape
    prod = (do.float() * o.float()).reshape(b, sq, n_heads,
                                            width // n_heads)
    return prod.sum(-1).transpose(1, 2).contiguous()


def flash_bwd_packed(q, k, v, o, lse, do, n_heads: int, n_kv: int,
                     scale: float, causal: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of packed attention given the forward's out `o` and
    `lse` and the output cotangent `do`."""
    delta = flash_delta_packed(o, do, n_heads)
    dk, dv = flash_bwd_dkv_packed(q, k, v, do, lse, delta, n_heads, n_kv,
                                  scale, causal)
    dq = flash_bwd_dq_packed(q, k, v, do, lse, delta, n_heads, n_kv, scale,
                             causal)
    return dq, dk, dv


class FlashAttentionPacked(torch.autograd.Function):
    """out = attention(q, k, v) over packed [b, s, heads·d] with the packed
    kernels in both directions; saves (q, k, v, out, lse) as the
    reference's `_vjp_fwd_packed`."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads: int, n_kv: int, scale: float,
                causal: bool = True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd_packed(q, k, v, n_heads, n_kv, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_heads, ctx.n_kv = n_heads, n_kv
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_packed(q, k, v, out, lse, do.contiguous(),
                                      ctx.n_heads, ctx.n_kv, ctx.scale,
                                      ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, n_heads: int, n_kv_heads: int,
                           sm_scale: Optional[float] = None,
                           causal: bool = True) -> torch.Tensor:
    """Flash attention over packed [b, s, heads·head_dim] tensors (twin of
    ray_tpu/ops/pallas/flash_attention.py:505): q [b, s, n_heads·d], k/v
    [b, s, n_kv_heads·d] -> [b, s, n_heads·d]. GQA K/V stay unexpanded."""
    if q.shape[-1] % n_heads or n_heads % n_kv_heads:
        raise ValueError(
            f"packed width {q.shape[-1]} must divide by n_heads={n_heads}, "
            f"which must divide by n_kv_heads={n_kv_heads}")
    d = q.shape[-1] // n_heads
    if k.shape[-1] != n_kv_heads * d:
        raise ValueError(f"k width {k.shape[-1]} != n_kv_heads*head_dim "
                         f"{n_kv_heads * d}")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    return FlashAttentionPacked.apply(q, k, v, n_heads, n_kv_heads, scale,
                                      causal)


# Launch counts: each wrapper adds one to `.launches` where it launches its
# kernel, and nowhere else (the CPU path launches nothing); `.f32_launches`
# counts the float32 kernel's share, `.wide_launches` the wide family's
# (head_dim above MAX_HEAD_DIM).
# The packed wrappers run the same kernels but count apart: no model path
# calls them.
KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
PACKED_KERNELS = (flash_fwd_packed, flash_bwd_dkv_packed, flash_bwd_dq_packed)
for _wrapper in (*KERNELS, *PACKED_KERNELS):
    _wrapper.launches = 0
    _wrapper.f32_launches = 0
    _wrapper.wide_launches = 0
