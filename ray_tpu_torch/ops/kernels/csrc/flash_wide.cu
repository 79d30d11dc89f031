// Flash attention at head widths above 256: the forward and the two backward
// kernels, bf16 or float32 operands with float32 accumulation and softmax
// state. The narrower widths (up to 256) run the kernels of
// flash_attention.cu; this family takes what those cannot hold.
//
// The forward kernels (flash_wide_fwd_wgmma_kernel in bf16,
// flash_wide_fwd_f32_kernel in float32) replace the TPU kernel _fwd_kernel
// (ray_tpu/ops/pallas/flash_attention.py:38) at those widths, in both of its
// calls (_flash_fwd :104 over [b*h, s, d], _flash_fwd_packed :376 over the
// packed [b, s, h*d]); the dk/dv kernels (flash_wide_dkv_wgmma_kernel,
// flash_wide_dkv_f32_kernel) replace _bwd_dkv_kernel (:181) and the dq
// kernels (flash_wide_dq_wgmma_kernel, flash_wide_dq_f32_kernel)
// _bwd_dq_kernel (:224), both on the recompute of _recompute_p_ds (:142), in
// _flash_bwd (:276, :303) and _flash_bwd_packed (:442, :480). The Pallas
// blocks take any head_dim; these kernels take any multiple of kW (128)
// columns, and the wrapper zero-pads a head to it (flash_attention.py
// `pad_heads`; the caller's scale is kept, so the padded zeros add nothing
// to any score, to dO.V^T or to delta, and the padded output columns come
// out zero).
//
// What bounds them on an H100: the products. A wide head's output does not
// always fit a block's registers (64 keys x 512 columns of dK alone are 128
// KB of float32), so a block owns one output-width slice of it: a forward
// or dq block a tile of query rows of one head and one slice of O (dQ), a
// dk/dv block a tile of keys of one kv head and one slice of both dK and
// dV. Where the slice is narrower than the head, each block recomputes the
// score S = Q.K^T (and, in the backward, dP = dO.V^T) over the whole
// head_dim, chunk by chunk, each chunk's partial sum added to the block's
// float32 accumulators: the price of the cut. Counted against the bound's
// products (each once), n slices of 128 columns do (4n + 4) / 8 of dk/dv's
// work, (4n + 2) / 6 of dq's and (n + 1) / 2 of the forward's: 2.5x, 3x and
// 1.5x at d 512. The bf16 forward's slices are 256 columns up to head_dim
// 512; the float32 forward's and dk/dv's are the whole padded head wherever
// their tile's rows of it fit a block's registers (no recompute), else 128.
// The lse (forward) is written once, by slice 0.
// The rest is the narrower kernels' arithmetic (flash_attention.cu): the
// causal mask end-aligned (key col <= row + sk - sq), key tiles wholly past
// the band skipped, the online softmax in exp2 of log2e-scaled scores, p
// and ds rounded to the operand dtype only as operands of the accumulating
// products, a row that sees no key giving out 0 and lse -1e30 (p kept 0
// while its max is -1e30), the backward's p selected to 0 (never
// multiplied) where a row may not attend, GQA by index (query head h reads
// kv head h / n_rep; a dk/dv block walks the n_rep query heads of its kv
// head and sums them in float32 before its one write). No atomics: every
// output is written once, so two calls give the same bits.
//
// One layout serves both calls, as in flash_attention.cu: q, dO, out, dq
// [b, sq, heads*d], k, v, dk, dv [b, sk, (heads/n_rep)*d], lse and delta
// [b, heads, sq]; [b*h, s, d] is heads = n_rep = 1. Grid: x the tiles times
// the slices, y the head (the kv head for dk/dv), z the batch.
//
// Two designs, both fed by cp.async rings of 64-column chunks of the head
// (zero-filled past sq and sk): the bf16 kernels run on wgmma ("bf16
// backward", "bf16 forward" below); the float32 kernels are register-tiled
// on the CUDA cores in full float32, no TF32 ("float32 dq", "float32
// forward", "float32 dk/dv" below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kW = 128;  // an output slice of the cut
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool attends(int row, int col, int sq, int sk,
                                        int offset, int causal) {
  return row < sq && col < sk && (!causal || col <= row + offset);
}

// Key tiles of `keys` keys that query rows [q0, q0 + rows) walk: all of
// sk, or, causal, up to the band of the last row.
__device__ __forceinline__ int key_tiles(int q0, int sk, int offset,
                                         int causal, int rows, int keys) {
  int n = (sk + keys - 1) / keys;
  if (causal) {
    const int last = q0 + rows - 1 + offset;
    const int lim = last < 0 ? 0 : last / keys + 1;
    n = n < lim ? n : lim;
  }
  return n;
}

// ------------------------------------------------------------ bf16 backward
//
// flash_wide_dkv_wgmma_kernel and flash_wide_dq_wgmma_kernel: the cut (the
// slice axis, the score recomputed per slice) on Hopper's warpgroup MMA.
// One block of two warpgroups (256 threads) owns one kW-column output
// slice:
//  * dk/dv: 64 keys of one kv head; query tiles of kWq (128) rows stream
//    past them, warpgroup g taking rows 64g..64g+63 of each, for each of
//    the n_rep query heads in turn;
//  * dq: kWq query rows of one head, warpgroup g rows 64g..64g+63; key
//    tiles of kWk (64) stream past them.
// Per (query tile, key tile) pair each warpgroup computes, as m64n64k16
// wgmma with both operands K-major in shared memory, S^T = K.Q^T and dP^T =
// V.dO^T (dk/dv: rows keys) or S = Q.K^T and dP = dO.V^T (dq: rows
// queries), as one k-loop over the head's kC-column chunks (64 columns: one
// 128-byte swizzled row); then p and ds on the accumulators in float32 (the
// reference's _recompute_p_ds), rounded to bf16 into register A operands,
// and the output products dV += P^T.dO, dK += dS^T.Q (dk/dv) or dQ += dS.K
// (dq) as m64n64k16 wgmma with the slice's two chunks of dO and Q (K) read
// MN-major: the chunks the score loop staged, not loaded again.
//
// The chunk ring: every operand streams. A stage holds one chunk of the
// pair: Q and dO for 128 query rows, K and V for 64 keys (48 KB), and the
// lse and delta of the 128 rows (dk/dv). kStages (4) stages, filled by
// cp.async (zero-filled past sq and sk) while the products of the stages
// before them run. A tile's chunks are walked with the slice's two last
// (chunk_of), so those two are still staged for the output products; a
// stage is refilled once every thread is done with it (its score products,
// or, for the slice's chunks, the tile's output products), so the first
// chunks of the next tile load during the p/ds math and the output
// products. Nothing stays resident, so shared memory is 197 KB at any
// head_dim. dq keeps one step's score products in flight across the next
// step's barrier (wgmma_wait<1>, kLag 1); dk/dv waits for them each step,
// since with one in flight ptxas serializes its products (C7515) at 251
// registers a thread.
//
// What bounds them: the products (the bound's FLOPs are the true width,
// each product once), then the step itself. A chunk step moves 48 KB
// through L2 and shared memory for two m64n64k64 products a warpgroup
// (some 43 FLOP a byte), and each m64n64k16 reads 4 KB of shared memory in
// its 32 cycles, at the edge of the SM's 128 bytes a cycle; on an H100 at
// the 8B attention shape a step takes ~1 us against 0.28 at peak, and the
// same kernel without its refills, or without its score products, takes
// 0.64-0.74 or 0.73-0.87 of that (PERF.md §6): feed and products overlap
// only in part. One block an SM: dk/dv holds 192 accumulator floats a
// thread (the dK and dV halves of its slice, 64 + 64, and S^T, dP^T,
// 32 + 32). dk/dv's two warpgroups each sum over half of
// every query tile; at the end each adds warpgroup 0's partial sum and
// warpgroup 1's, in that order, for one of dK and dV (exchanged through
// shared memory) and writes it: deterministic. Blocks are issued slice
// fastest: dk/dv key tile by key tile across every (kv head, batch), lowest
// keys (the most query tiles under causal) first; dq the heaviest query
// tiles first.

constexpr int kC = 64;     // a chunk: 64 columns (128 bytes) of the head
constexpr int kWq = 128;   // query rows a stage holds: a warpgroup's 64 each
constexpr int kWk = 64;    // keys a stage holds
constexpr int kStages = 4;
constexpr int kQBytes = kWq * kC * 2;  // one Q (dO) chunk
constexpr int kKBytes = kWk * kC * 2;  // one K (V) chunk
// a stage: Q, dO, K, V chunks, then lse and delta of the 128 rows; every
// tile 1024-byte aligned
constexpr int kRowsAt = 2 * kQBytes + 2 * kKBytes;
constexpr int kStageBytes = kRowsAt + 2 * kWq * 4;
constexpr int kWgmmaSmem = kStages * kStageBytes + 1024;
static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
static_assert(kThreads == 2 * kWq, "a thread a row's lse or delta");

// Which chunk step j of a tile reads: the slice's m chunks (m slice ..
// m slice + m - 1; 2 for a kW-column slice) last.
__device__ __forceinline__ int chunk_of(int j, int slice, int n, int m = 2) {
  const int c = m * (slice + 1) + j;
  return c < n ? c : c - n;
}

// Waits until at most n of this thread's cp.async groups are pending (at
// most 8: for a larger n, until 8 are).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n <= 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// One chunk of a pair into stage `st`: Q and dO rows [q0, q0 + kWq) and K
// and V rows [k0, k0 + kWk), the pointers already at the head's chunk.
__device__ __forceinline__ void load_chunks(unsigned char* st, const bf16* q,
                                            const bf16* dout, int q0, int sq,
                                            int64_t ldq, const bf16* k,
                                            const bf16* v, int k0, int sk,
                                            int64_t ldk) {
  bf16* t = reinterpret_cast<bf16*>(st);
  load_tile_async<kC, kWq>(t, q, q0, sq, ldq);
  load_tile_async<kC, kWq>(t + kWq * kC, dout, q0, sq, ldq);
  load_tile_async<kC, kWk>(t + 2 * kWq * kC, k, k0, sk, ldk);
  load_tile_async<kC, kWk>(t + 2 * kWq * kC + kWk * kC, v, k0, sk, ldk);
}

// An m64n64 accumulator (float32) as the A fragments of the four k16 steps
// of a product over its 64 columns, rounded to bf16.
__device__ __forceinline__ void pack_a(const float (&p)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

// A ring of kRing stages, the same bookkeeping in every thread: `loaded`
// steps have been issued, one cp.async group each, step s into stage s %
// kRing. Before step `step` reads its stage: wait for it, make every
// thread's copies visible, and refill the stages whose steps before
// `released` left free.
template <int kRing, typename Load>
__device__ __forceinline__ void ring_advance(int step, int released,
                                             int total, int& loaded,
                                             Load load_step) {
  cp_async_wait_upto(loaded - 1 - step);
  fence_async_shared();
  __syncthreads();
  for (; loaded < total && loaded < released + kRing; ++loaded) {
    load_step(loaded);
    cp_async_commit();
  }
}

// The backward's ring (tile t, chunk j at step t * n + j, the slice's m
// chunks last). A step's score products stay in flight for kLag more steps
// (wgmma_wait<kLag>), and a tile's last ones, with its output products,
// until the tile's end. So at chunk j of a tile every step before step -
// kLag is done (j > 0), or every step before it (j = 0), but the tile's
// slice chunks, which the output products read after its last chunk, stay.
template <int kLag, int kRing = kStages, typename Load>
__device__ __forceinline__ void ring_step(int step, int j, int n, int total,
                                          int& loaded, Load load_step,
                                          int m = 2) {
  int released = j == 0 ? step : step - kLag;  // steps before it are free
  const int kept = step - j + n - m;  // the tile's first slice chunk
  if (j > 0 && released > kept) released = kept;
  ring_advance<kRing>(step, released, total, loaded, load_step);
}

__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
}

// Zeroes an accumulator's registers before its first product.
template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_dkv_wgmma_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int sq, int sk, int n_rep, int d, float scale,
                                int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = ring_base(smem_raw);
  const uint32_t ring_at = smem_u32(ring);

  const int n = d / kC;  // chunks of the head
  const int n_slices = d / kW;
  // launch order: slice fastest, then (kv head, batch), then key tile
  const int n_kv = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + n_kv * blockIdx.z);
  const int slice = lin % n_slices;
  const int rest = lin / n_slices;
  const int hb = rest % (n_kv * gridDim.z);
  const int g = hb % n_kv;  // kv head
  const int batch = hb / n_kv;
  const int k0 = rest / (n_kv * gridDim.z) * kWk;
  const int heads = n_kv * n_rep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // query rows 64 wg.. of each tile
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(n_kv) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(g) * d;
  const int offset = sk - sq;
  const int key = k0 + (warp & 3) * 16 + (lane >> 2);
  const int col_lane = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;

  // first query tile whose causal band reaches this block's first key
  int qb0 = 0;
  if (causal) {
    const int need = k0 - offset - (kWq - 1);
    qb0 = need <= 0 ? 0 : (need + kWq - 1) / kWq;
  }
  const int n_qb = (sq + kWq - 1) / kWq;
  const int per_head = n_qb > qb0 ? n_qb - qb0 : 0;
  const int n_tiles = n_rep * per_head;  // query tiles of every head
  const int total = n_tiles * n;

  auto load_step = [&](int step) {
    const int t = step / n;
    const int j = step - t * n;
    const int head = g * n_rep + t / per_head;
    const int q0 = (qb0 + t % per_head) * kWq;
    const int c = chunk_of(j, slice, n) * kC;
    const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                         static_cast<int64_t>(head) * d + c;
    unsigned char* st = ring + (step % kStages) * kStageBytes;
    load_chunks(st, q + qoff, dout + qoff, q0, sq, ldq, k + koff + c,
                v + koff + c, k0, sk, ldk);
    if (j == n - 1) {  // the tile's lse, then delta; zeros past sq
      const int i = threadIdx.x % kWq;
      const float* src = threadIdx.x < kWq ? lse : delta;
      const bool valid = q0 + i < sq;
      const int64_t row =
          (static_cast<int64_t>(batch) * heads + head) * sq + q0 + i;
      cp_async4(smem_u32(st + kRowsAt + threadIdx.x * 4),
                valid ? src + row : src, valid);
    }
  };

  float adk[2][32], adv[2][32];  // the slice's two 64-column halves
  zero(adk[0]);
  zero(adk[1]);
  zero(adv[0]);
  zero(adv[1]);
  int loaded = 0;
  for (; loaded < total && loaded < kStages; ++loaded) {
    load_step(loaded);
    cp_async_commit();
  }
  const uint32_t wg_rows = wg * 64 * 128;  // the warpgroup's rows of Q, dO

  for (int t = 0; t < n_tiles; ++t) {
    float s[32], dp[32];
    zero(s);
    zero(dp);
    for (int j = 0; j < n; ++j) {
      const int step = t * n + j;
      ring_step<0>(step, j, n, total, loaded, load_step);
      const uint32_t st = ring_at + (step % kStages) * kStageBytes;
      const uint32_t tQ = st + wg_rows;
      const uint32_t tO = st + kQBytes + wg_rows;
      const uint32_t tK = st + 2 * kQBytes;
      const uint32_t tV = tK + kKBytes;
      fence_operands(s);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {  // S^T += K.Q^T
        wgmma_ss_n64(s, kmajor_desc<kC, kWk>(tK, kk),
                     kmajor_desc<kC, kWq>(tQ, kk));
      }
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {  // dP^T += V.dO^T
        wgmma_ss_n64(dp, kmajor_desc<kC, kWk>(tV, kk),
                     kmajor_desc<kC, kWq>(tO, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(s);
      fence_operands(dp);
    }

    // rows are keys, columns this warpgroup's queries: p^T and ds^T in place
    const int q0 = (qb0 + t % per_head) * kWq;
    const int first = (t * n + n - 2) % kStages;  // the slice's chunks
    const int last = (t * n + n - 1) % kStages;
    const float* row_lse =
        reinterpret_cast<const float*>(ring + last * kStageBytes + kRowsAt);
    const float* row_delta = row_lse + kWq;
    const bool mask =
        q0 + kWq > sq || (causal && k0 + kWk - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * wg + 8 * j + col_lane;
      const float2 l2 = *reinterpret_cast<const float2*>(row_lse + c);
      const float2 d2 = *reinterpret_cast<const float2*>(row_delta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int qr = q0 + c + (e & 1);
        const int kr = key + (e >> 1) * 8;
        const bool valid =
            !mask || (qr < sq && (!causal || kr <= qr + offset));
        const float lv = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        const float p =
            valid ? exp2f(fmaf(s[i], scale2, -lv * kLog2e)) : 0.0f;
        dp[i] = valid ? p * (dp[i] - dl) * scale : 0.0f;  // ds
        s[i] = p;
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);
    const uint32_t s0 = ring_at + first * kStageBytes + wg_rows;
    const uint32_t s1 = ring_at + last * kStageBytes + wg_rows;
    fence_operands(adv[0]);
    fence_operands(adv[1]);
    fence_operands(adk[0]);
    fence_operands(adk[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dV += P^T.dO, dO MN-major
      wgmma_rs<64>(adv[0], pa[kk], mnmajor_desc<kC, kWq>(s0 + kQBytes, kk));
      wgmma_rs<64>(adv[1], pa[kk], mnmajor_desc<kC, kWq>(s1 + kQBytes, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dK += dS^T.Q, Q MN-major
      wgmma_rs<64>(adk[0], da[kk], mnmajor_desc<kC, kWq>(s0, kk));
      wgmma_rs<64>(adk[1], da[kk], mnmajor_desc<kC, kWq>(s1, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(adv[0]);
    fence_operands(adv[1]);
    fence_operands(adk[0]);
    fence_operands(adk[1]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every product is done with the ring

  // Each warpgroup summed half of every query tile. Warpgroup 0 hands its
  // dK to warpgroup 1 and takes warpgroup 1's dV, through the ring; each
  // adds warpgroup 0's value and warpgroup 1's, in that order, and writes.
  // [warpgroup][64 values][128 threads]
  float* red = reinterpret_cast<float*>(ring);
  const int tid = threadIdx.x & 127;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      red[(wg * 64 + h * 32 + i) * 128 + tid] =
          wg == 0 ? adk[h][i] : adv[h][i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float other = red[((1 - wg) * 64 + h * 32 + i) * 128 + tid];
      if (wg == 0) {
        adv[h][i] = adv[h][i] + other;
      } else {
        adk[h][i] = other + adk[h][i];
      }
    }
  }
  bf16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key + r * 8;
    if (kr >= sk) continue;
    bf16* dst =
        out + koff + static_cast<int64_t>(kr) * ldk + slice * kW + col_lane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = wg == 0 ? adv[h][4 * j + 2 * r] : adk[h][4 * j + 2 * r];
        const float x1 =
            wg == 0 ? adv[h][4 * j + 2 * r + 1] : adk[h][4 * j + 2 * r + 1];
        *reinterpret_cast<uint32_t*>(dst + h * 64 + j * 8) = pack_bf16(x0, x1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_dq_wgmma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dq, int sq, int sk,
                               int n_rep, int d, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = ring_base(smem_raw);
  const uint32_t ring_at = smem_u32(ring);

  const int n = d / kC;
  const int n_slices = d / kW;
  // launch order: slice fastest, then (head, batch), then the query tile,
  // heaviest (the causal band's longest rows) first
  const int heads = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + heads * blockIdx.z);
  const int slice = lin % n_slices;
  const int rest = lin / n_slices;
  const int hb = rest % (heads * gridDim.z);
  const int head = hb % heads;
  const int batch = hb / heads;
  const int q0 =
      (gridDim.x / n_slices - 1 - rest / (heads * gridDim.z)) * kWq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // rows 64 wg.. of the block
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * d;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                       static_cast<int64_t>(head) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(head / n_rep) * d;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int row = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col_lane = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;
  const int n_kt = key_tiles(q0, sk, offset, causal, kWq, kWk);
  const int total = n_kt * n;

  auto load_step = [&](int step) {
    const int t = step / n;
    const int c = chunk_of(step - t * n, slice, n) * kC;
    load_chunks(ring + (step % kStages) * kStageBytes, q + qoff + c,
                dout + qoff + c, q0, sq, ldq, k + koff + c, v + koff + c,
                t * kWk, sk, ldk);
  };

  int loaded = 0;
  for (; loaded < total && loaded < kStages; ++loaded) {
    load_step(loaded);
    cp_async_commit();
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    lse2[i] = r < sq ? lse[row_off + r] * kLog2e : 0.0f;
    dl[i] = r < sq ? delta[row_off + r] : 0.0f;
  }
  float acc[2][32];  // the slice's two 64-column halves
  zero(acc[0]);
  zero(acc[1]);
  const uint32_t wg_rows = wg * 64 * 128;  // the warpgroup's rows of Q, dO

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kWk;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    for (int j = 0; j < n; ++j) {
      const int step = t * n + j;
      ring_step<1>(step, j, n, total, loaded, load_step);
      const uint32_t st = ring_at + (step % kStages) * kStageBytes;
      const uint32_t tQ = st + wg_rows;
      const uint32_t tO = st + kQBytes + wg_rows;
      const uint32_t tK = st + 2 * kQBytes;
      const uint32_t tV = tK + kKBytes;
      fence_operands(s);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {  // S += Q.K^T
        wgmma_ss_n64(s, kmajor_desc<kC, kWq>(tQ, kk),
                     kmajor_desc<kC, kWk>(tK, kk));
      }
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {  // dP += dO.V^T
        wgmma_ss_n64(dp, kmajor_desc<kC, kWq>(tO, kk),
                     kmajor_desc<kC, kWk>(tV, kk));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one is done
      fence_operands(s);
      fence_operands(dp);
    }
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    const bool mask =
        k0 + kWk > sk || (causal && k0 + kWk - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int col = k0 + (i >> 2) * 8 + col_lane + (i & 1);
      const bool valid =
          !mask || (col < sk && (!causal || col <= row + h * 8 + offset));
      const float p = valid ? exp2f(s[i] * scale2 - lse2[h]) : 0.0f;
      s[i] = valid ? p * (dp[i] - dl[h]) * scale : 0.0f;  // ds
    }
    uint32_t da[4][4];
    pack_a(s, da);
    // the slice's two K chunks
    const uint32_t s0 = ring_at +
                        ((t * n + n - 2) % kStages) * kStageBytes +
                        2 * kQBytes;
    const uint32_t s1 = ring_at +
                        ((t * n + n - 1) % kStages) * kStageBytes +
                        2 * kQBytes;
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dQ += dS.K, K MN-major
      wgmma_rs<64>(acc[0], da[kk], mnmajor_desc<kC, kWk>(s0, kk));
      wgmma_rs<64>(acc[1], da[kk], mnmajor_desc<kC, kWk>(s1, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc[0]);
    fence_operands(acc[1]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row + r * 8;
    if (qr >= sq) continue;
    bf16* dst =
        dq + qoff + static_cast<int64_t>(qr) * ldq + slice * kW + col_lane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + h * 64 + j * 8) =
            pack_bf16(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ bf16 forward
//
// flash_wide_fwd_wgmma_kernel replaces the first (SIMT) forward in bf16
// (the TPU kernel _fwd_kernel above head_dim 256). What held that one at
// 0.003 of bound: CUDA cores, operands widened to float32 one element a
// thread, two barriers a 128-column chunk and nothing in flight during a
// product. This one runs on the warpgroup MMA with the bf16 backward's
// block: two warpgroups (256 threads) own 128 query rows of one head,
// warpgroup g rows 64g..64g+63, and key tiles of kWk (64) stream past them.
// What bounds it: the products, the score product's feed and the slices'
// recompute. Two staging plans by head_dim (`fwd_bf16_entry`;
// flash_attention.py `wide_fwd_plan`):
//  * plan 1, d <= kFwdResidentMaxD (512): the block's Q stays resident (128
//    rows x d, 128 KB at 512), so a chunk step streams only K's chunk (8
//    KB), and the output slice is kFwdSlice (256) columns, two m64n128
//    halves (128 accumulator floats a thread): S is recomputed d / 256
//    times, not d / 128, so the recompute caps the kernel at 2 / (n + 1) of
//    bound for n slices, 0.67 at 384 and 512 (0.5 and 0.4 with 128-column
//    slices). Where d is an odd multiple of 128 the last slice holds 128
//    columns: it runs both halves' P.V (the second on whatever its half of
//    the V buffer holds) and writes the first, so every block runs one
//    code path. 225 KB of dynamic shared memory at 512, 255 registers a
//    thread and no spill (ptxas, sm_90a);
//  * plan 2, wider heads: Q's chunk streams beside K's (24 KB a step) and
//    the slice is one half (kW): with two halves beside the Q loads ptxas
//    spilled 88 bytes at 255 registers. 209 KB at any width, 224
//    registers.
// The chunk steps:
//  * S = Q.K^T per key tile as m64n64k16 wgmma over the head's kC-column
//    chunks, both operands K-major in 128-byte-swizzled shared memory. A
//    ring of kFwdStages (8) stages is filled by cp.async kFwdAhead (6)
//    steps ahead, one group committed a step (empty past the last), and a
//    step's products stay in flight across the next step's barrier
//    (kFwdLag): the refill at step s takes the stage step s - 2 read. The
//    chunks are walked in order (no slice chunk is reused here, so no
//    chunk_of): a stage holds chunk j of key tile t at step t n + j.
//  * The online softmax on the S fragments: row max and sum over the quad
//    of lanes that holds a row (shuffles), O rescaled by alpha in
//    registers, exp2 of log2e-scaled scores, p kept 0 while a row's max is
//    -1e30. P rounded to bf16 into register A fragments (pack_a), then O +=
//    P.V_slice as m64n128k16 wgmma per half, the slice's V columns of the
//    key tile read MN-major from their own buffer. V(t) is loaded in the
//    group of step t n, after the barrier that follows P.V(t - 1), and
//    waited for before P.V(t) (for n >= kFwdStages - kFwdLag chunks the
//    last chunk step's wait already covers it).
//  * lse written once, by slice 0; out as o / l in bf16.

constexpr int kFwdSlice = 2 * kW;  // output columns a block (plan 1)
constexpr int kFwdStages = 8;
constexpr int kFwdLag = 1;
constexpr int kFwdAhead = kFwdStages - 1 - kFwdLag;  // steps loaded ahead
constexpr int kFwdResidentMaxD = 512;

template <bool kResident>
constexpr int kFwdStageBytes = kResident ? kKBytes : kQBytes + kKBytes;
// 128-column halves of a block's output slice: plan 2 keeps one, since two
// beside its Q loads spilled (255 registers)
template <bool kResident>
constexpr int kFwdHalves = kResident ? 2 : 1;
template <bool kResident>
constexpr int kFwdSliceOf = kFwdHalves<kResident> * kW;

// Dynamic shared memory of the forward at head_dim d: the ring, the V
// slice, resident Q (plan 1), and room to align the tiles to 1024 bytes.
template <bool kResident>
constexpr int fwd_wgmma_smem(int d) {
  return kFwdStages * kFwdStageBytes<kResident> +
         kWk * kFwdSliceOf<kResident> * 2 + (kResident ? kWq * d * 2 : 0) +
         1024;
}
static_assert(fwd_wgmma_smem<true>(kFwdResidentMaxD) <= 232448 &&
                  fwd_wgmma_smem<false>(0) <= 232448,
              "a block's shared memory");

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_fwd_wgmma_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                bf16* __restrict__ out,
                                float* __restrict__ lse, int sq, int sk,
                                int n_rep, int d, float scale, int causal) {
  constexpr int kStage = kFwdStageBytes<kResident>;
  constexpr int kKAt = kResident ? 0 : kQBytes;  // a stage's K chunk
  constexpr int kHalves = kFwdHalves<kResident>;
  constexpr int kSlice = kFwdSliceOf<kResident>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = ring_base(smem_raw);
  unsigned char* sv = ring + kFwdStages * kStage;  // the V slice
  unsigned char* sq_all = sv + kWk * kSlice * 2;   // resident Q, by chunk
  const uint32_t ring_at = smem_u32(ring);
  const uint32_t v_at = smem_u32(sv);
  const uint32_t q_at = smem_u32(sq_all);

  const int n = d / kC;  // chunks of the head
  const int n_slices = (d + kSlice - 1) / kSlice;
  // launch order: slice fastest, then (head, batch), then the query tile,
  // heaviest (the causal band's longest rows) first
  const int heads = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + heads * blockIdx.z);
  const int slice = lin % n_slices;
  const int rest = lin / n_slices;
  const int hb = rest % (heads * gridDim.z);
  const int head = hb % heads;
  const int batch = hb / heads;
  const int q0 =
      (gridDim.x / n_slices - 1 - rest / (heads * gridDim.z)) * kWq;
  const int c0 = slice * kSlice;  // the slice's first column
  const bool full = d - c0 >= kSlice;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // rows 64 wg.. of the block
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * d;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                       static_cast<int64_t>(head) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(head / n_rep) * d;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int row = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col_lane = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;
  const int n_kt = key_tiles(q0, sk, offset, causal, kWq, kWk);
  const int total = n_kt * n;

  auto load_step = [&](int step) {  // chunk step % n of key tile step / n
    const int t = step / n;
    const int c = (step - t * n) * kC;
    bf16* st = reinterpret_cast<bf16*>(ring + (step % kFwdStages) * kStage);
    if constexpr (!kResident) {
      load_tile_async<kC, kWq>(st, q + qoff + c, q0, sq, ldq);
    }
    load_tile_async<kC, kWk>(st + kKAt / 2, k + koff + c, t * kWk, sk, ldk);
  };
  auto load_v = [&](int t) {  // the slice's columns of key tile t
    bf16* tv = reinterpret_cast<bf16*>(sv);
    if (kHalves == 2 && full) {
      load_tile_async<kFwdSlice, kWk>(tv, v + koff + c0, t * kWk, sk, ldk);
    } else {
      load_tile_async<kW, kWk>(tv, v + koff + c0, t * kWk, sk, ldk);
    }
  };

  if constexpr (kResident) {  // the block's Q, every chunk, in group 0
    for (int c = 0; c < n; ++c) {
      load_tile_async<kC, kWq>(
          reinterpret_cast<bf16*>(sq_all + c * kQBytes), q + qoff + c * kC,
          q0, sq, ldq);
    }
  }
  for (int i = 0; i < kFwdAhead; ++i) {
    if (i < total) load_step(i);
    cp_async_commit();
  }

  float o[kHalves][64];  // the slice's 128-column halves
#pragma unroll
  for (int h = 0; h < kHalves; ++h) zero(o[h]);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
  const uint32_t wg_rows = wg * 64 * 128;  // the warpgroup's rows of Q

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kWk;
    float s[32];
    zero(s);
    for (int j = 0; j < n; ++j) {
      const int step = t * n + j;
      // groups 0..step are in: kFwdAhead + step committed before this
      cp_async_wait<kFwdAhead - 1>();
      fence_async_shared();
      __syncthreads();
      if (step + kFwdAhead < total) load_step(step + kFwdAhead);
      if (j == 0) load_v(t);  // P.V(t - 1) is done in every thread
      cp_async_commit();
      const uint32_t st = ring_at + (step % kFwdStages) * kStage;
      const uint32_t tQ = (kResident ? q_at + j * kQBytes : st) + wg_rows;
      const uint32_t tK = st + kKAt;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {  // S += Q.K^T
        wgmma_ss_n64(s, kmajor_desc<kC, kWq>(tQ, kk),
                     kmajor_desc<kC, kWk>(tK, kk));
      }
      wgmma_commit();
      wgmma_wait<kFwdLag>();  // the step before this one is done
      fence_operands(s);
    }
    wgmma_wait_all();
    fence_operands(s);
    if (n < kFwdStages - kFwdLag) {  // V(t)'s group, n - 1 after it
      cp_async_wait_upto(n - 1);
      fence_async_shared();
      __syncthreads();
    }

    // the online softmax: rows row and row + 8, columns k0 + 8 (i / 4) +
    // col_lane + i % 2
    const bool mask =
        k0 + kWk > sk || (causal && k0 + kWk - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      if (mask) {
        const int col = k0 + (i >> 2) * 8 + col_lane + (i & 1);
        if (!(col < sk && (!causal || col <= row + h * 8 + offset))) {
          s[i] = kNegInf;
        }
      }
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m[i] - mx[i]) * scale2);
      m[i] = mx[i];
      l[i] *= alpha[i];
      // a row that has seen no key yet keeps p = 0 (and so out 0)
      ms[i] = mx[i] == kNegInf ? 0.0f : mx[i] * scale2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(fmaf(s[i], scale2, -ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
    uint32_t pa[4][4];
    pack_a(s, pa);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[h][i] *= alpha[(i >> 1) & 1];
      fence_operands(o[h]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWk / 16; ++kk) {  // O += P.V, V MN-major
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        wgmma_rs<kW>(o[h], pa[kk],
                     mnmajor_desc<kW, kWk>(v_at + h * 2 * kWk * 128, kk));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_operands(o[h]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum = fmaxf(sum, 1e-30f);
    const int r = row + i * 8;
    if (r >= sq) continue;
    const float inv = 1.0f / sum;
    bf16* dst = out + qoff + static_cast<int64_t>(r) * ldq + c0 + col_lane;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      if (h == 1 && !full) break;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(dst + h * kW + j * 8) = pack_bf16(
            o[h][4 * j + 2 * i] * inv, o[h][4 * j + 2 * i + 1] * inv);
      }
    }
    if (slice == 0 && (lane & 3) == 0) {
      lse[row_off + r] = m[i] == kNegInf ? kNegInf : m[i] * scale + logf(sum);
    }
  }
}

// ------------------------------------------------------------ float32 dq
//
// flash_wide_dq_f32_kernel replaces the first (SIMT) dq in float32 (the TPU
// kernel _bwd_dq_kernel above head_dim 256). What held that one at 0.011
// of bound: 32 rows a block, five shared-memory loads for every four FMAs
// (scalar reads of padded tiles), two barriers for each 128-column chunk of
// each score product. Bound on an H100: float32 operations (67 TFLOP/s; no
// TF32). What bounds a register-tiled SIMT product below that is its
// shared-memory reads: a warp's float4 load is four wavefronts (one a
// quarter-warp, broadcast or not), so a thread's R x J score patch, R + J
// float4s for 4RJ FMAs a 4-column step, runs at RJ / (4 (R + J)) of the
// FMA peak: 0.5 at 4 x 4, 0.2 at the 1 x 4 of the narrow dq's 16-row
// tile (flash_attention.cu, "float32"). So:
//  * Design choice (a) of the two a wide head allows: 128-column output
//    slices, every operand streamed chunk by chunk through the bf16
//    backward's ring (chunk_of, ring_step; kStages 4 of kC = 64 columns): a
//    stage holds one chunk of Q and dO (BQ rows) and of K and V (32 keys),
//    the slice's two chunks walked last and kept for dQ += dS.K_slice. The
//    other, (b), a block holding dQ's whole width for fewer rows, needs all
//    of a key tile's K after the scores (64 KB at 512) beside Q and dO, so
//    a second plan beyond 512; (a) takes any width with one plan, at the
//    slices' recompute cap of 3 / (2n + 1) of bound (0.43 at 384, 0.33 at
//    512).
//  * A block (256 threads) owns BQ query rows of one head (64, or 16 where
//    the 64-row blocks, slices counted, would not make a wave: the host
//    plan, flash_attention.py `wide_f32_dq_tile`) and one kW-column slice
//    of dQ, and walks key tiles of kF32Stream (32) keys. Every thread
//    computes a 4 x 4 patch of S and dP (rows 4rg.., keys kg + 8j) over its
//    share of each chunk: the kSplit (2 at 64 rows, 8 at 16) lanes of a
//    patch take the chunk's float4s dg, dg + kSplit, .., so 16 rows still
//    run at the 4 x 4 patch's rate, and a butterfly of shuffles sums the
//    shares once a key tile (each lane adds its partner's in the same
//    order, so every lane holds the same bits). Both operands are read
//    d-contiguous as stored; K and V chunks are XOR-swizzled by (key & 7)
//    kSplit, so the quarter-warp's reads spread over the 8 bank groups.
//    (8 x 4 patches at 64 rows, 4 lanes a patch, took 1.06-1.08x as long
//    at the 8B attention shape: not kept, PERF.md.)
//  * p = exp2(s scale log2e - lse log2e) selected to 0 where a row may not
//    attend (never multiplied: a row that sees no key has lse -1e30), ds =
//    p (dp - delta) scale, each lane of a patch computing 16 / kSplit of it
//    into a [32 keys][BQ rows] buffer; then a barrier, and dQ_slice += dS.K
//    with each thread on one float4 of the slice's columns and BQ / 8 rows.
//  * One barrier a key tile beyond the ring's one a chunk step. 200.5 KB
//    of dynamic shared memory at 64 rows and 98 KB at 16; one block an SM
//    at either (224 and 162 registers a thread, no spill): two blocks of
//    16 rows, at the 128 registers that allows, spilled and took 1.1-1.2x
//    as long at phase 7e's shapes (PERF.md). No atomics; every sum in a
//    fixed order.

constexpr int kF32Stream = 32;  // keys a key tile
constexpr int kF32Threads = 256;
// lanes splitting each chunk of a 4 x 4 patch's dot products
template <int BQ>
constexpr int kSplit = kF32Threads / (BQ / 4 * (kF32Stream / 4));
// a stage: Q and dO chunks [BQ][kC], K and V chunks [32][kC], float32
template <int BQ>
constexpr int kF32StageBytes = 4 * kC * (2 * BQ + 2 * kF32Stream);
// the ring, dS [32][BQ], and the rows' lse (log2e-scaled) and delta
template <int BQ>
constexpr int kDqF32Smem =
    kStages * kF32StageBytes<BQ> + 4 * BQ * (kF32Stream + 2);
static_assert(kSplit<64> == 2 && kSplit<16> == 8, "patches of 4 x 4");
static_assert(kDqF32Smem<64> <= 232448, "a block's shared memory");

// Rows [row0, row0 + kRowsT) of a float32 matrix (rows ld apart), the kC
// columns at src, into tile[kRowsT][kC] by cp.async with kF32Threads
// threads, 16-byte chunk c of row r at chunk c ^ swizzle(r); rows >= n
// zero-filled.
template <int kRowsT, typename Swizzle>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* src,
                                              int row0, int n, int64_t ld,
                                              Swizzle swizzle) {
  constexpr int kChunks = kRowsT * kC / 4;
  static_assert(kChunks % kF32Threads == 0, "whole 16-byte moves");
#pragma unroll
  for (int it = 0; it < kChunks / kF32Threads; ++it) {
    const int e = threadIdx.x + it * kF32Threads;
    const int r = e / (kC / 4);
    const int c = e % (kC / 4);
    const bool valid = row0 + r < n;
    const float* from =
        valid ? src + (static_cast<int64_t>(row0) + r) * ld + 4 * c : src;
    cp_async16(smem_u32(tile + r * kC + 4 * (c ^ swizzle(r))), from, valid);
  }
}

// c[i][j] += A[own row i] . B[streamed row (32 / J) j] over this lane's
// share of one chunk (float4s dg + S cc): `a` at the patch's first own row
// (rows kC apart), `b` at its first streamed row (chunks ^ xb).
template <int S, int J = 4>
__device__ __forceinline__ void patch_dot(const float* a, const float* b,
                                          int dg, int xb,
                                          float (&c)[4][J]) {
  constexpr int kApart = kF32Stream / J;  // the patch's streamed rows
#pragma unroll
  for (int cc = 0; cc < kC / 4 / S; ++cc) {
    const int ch = dg + S * cc;
    float4 bv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(b + kApart * j * kC +
                                               4 * (ch ^ xb));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + i * kC + 4 * ch);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        c[i][j] = fmaf(av.x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av.y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av.z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av.w, bv[j].w, c[i][j]);
      }
    }
  }
}

template <int BQ>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_wide_dq_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int sq, int sk,
                             int n_rep, int d, float scale, int causal) {
  constexpr int S = kSplit<BQ>;
  constexpr int RO = BQ / 8;  // output rows a thread
  constexpr int kStage = kF32StageBytes<BQ>;
  constexpr int kKAt = 2 * BQ * kC;  // a stage's K chunk (floats)
  constexpr int kVAt = kKAt + kF32Stream * kC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  float* sDS = reinterpret_cast<float*>(ring + kStages * kStage);  // [32][BQ]
  float* sLse = sDS + kF32Stream * BQ;  // the rows' lse log2e, then delta

  const int n = d / kC;
  const int n_slices = d / kW;
  // launch order: slice fastest, then (head, batch), then the query tile,
  // heaviest first
  const int heads = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + heads * blockIdx.z);
  const int slice = lin % n_slices;
  const int rest = lin / n_slices;
  const int hb = rest % (heads * gridDim.z);
  const int head = hb % heads;
  const int batch = hb / heads;
  const int q0 = (gridDim.x / n_slices - 1 - rest / (heads * gridDim.z)) * BQ;
  const int dg = threadIdx.x % S;  // this lane's share of a chunk
  const int kg = threadIdx.x / S % 8;  // the patch's keys kg + 8j
  const int rg = threadIdx.x / S / 8;  // and its rows 4 rg + i
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * d;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                       static_cast<int64_t>(head) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(head / n_rep) * d;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const float scale2 = scale * kLog2e;
  const int n_kt = key_tiles(q0, sk, offset, causal, BQ, kF32Stream);
  const int total = n_kt * n;
  const auto unswizzled = [](int) { return 0; };
  const auto key_swizzle = [](int r) { return ((r & 7) * S) & 15; };

  auto load_step = [&](int step) {
    const int t = step / n;
    const int c = chunk_of(step - t * n, slice, n) * kC;
    float* st = reinterpret_cast<float*>(ring + (step % kStages) * kStage);
    load_rows_f32<BQ>(st, q + qoff + c, q0, sq, ldq, unswizzled);
    load_rows_f32<BQ>(st + BQ * kC, dout + qoff + c, q0, sq, ldq,
                      unswizzled);
    load_rows_f32<kF32Stream>(st + kKAt, k + koff + c, t * kF32Stream, sk,
                              ldk, key_swizzle);
    load_rows_f32<kF32Stream>(st + kVAt, v + koff + c, t * kF32Stream, sk,
                              ldk, key_swizzle);
  };

  int loaded = 0;
  for (; loaded < total && loaded < kStages; ++loaded) {
    load_step(loaded);
    cp_async_commit();
  }
  // the block's rows' log2e-scaled lse and delta (0 past sq), read after
  // the first chunk step's barrier
  if (threadIdx.x < 2 * BQ) {
    const int i = threadIdx.x % BQ;
    const bool ok = q0 + i < sq;
    sLse[threadIdx.x] = threadIdx.x < BQ
                            ? (ok ? lse[row_off + q0 + i] * kLog2e : 0.0f)
                            : (ok ? delta[row_off + q0 + i] : 0.0f);
  }
  // the output: rows q0 + RO ro + i, the slice's float4 column cg
  const int cg = threadIdx.x % 32;
  const int ro = threadIdx.x / 32;
  float acc[RO][4];
#pragma unroll
  for (int i = 0; i < RO; ++i) zero(acc[i]);
  const int xk = key_swizzle(kg);  // the patch's keys kg + 8j: one swizzle

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kF32Stream;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      zero(s[i]);
      zero(dp[i]);
    }
    for (int j = 0; j < n; ++j) {
      const int step = t * n + j;
      ring_step<0>(step, j, n, total, loaded, load_step);
      const float* st =
          reinterpret_cast<const float*>(ring + (step % kStages) * kStage);
      patch_dot<S>(st + 4 * rg * kC, st + kKAt + kg * kC, dg, xk, s);
      patch_dot<S>(st + BQ * kC + 4 * rg * kC, st + kVAt + kg * kC, dg, xk,
                   dp);
    }
    // the shares of the patch's S lanes, summed
#pragma unroll
    for (int m = 1; m < S; m <<= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] += __shfl_xor_sync(0xffffffffu, s[i][jj], m);
          dp[i][jj] += __shfl_xor_sync(0xffffffffu, dp[i][jj], m);
        }
      }
    }
    // a pair holding an entry no row may attend: a row past sq, a key past
    // sk, or a key past the causal band of the block's first row
    const bool mask = q0 + BQ > sq || k0 + kF32Stream > sk ||
                      (causal && k0 + kF32Stream - 1 > q0 + offset);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (e % S != dg) continue;  // this lane's entries of the patch
      const int i = e / 4;
      const int jj = e % 4;
      const int row = q0 + 4 * rg + i;
      const int key = kg + 8 * jj;
      const bool valid =
          !mask || attends(row, k0 + key, sq, sk, offset, causal);
      const float lse2 = sLse[4 * rg + i];
      const float dlt = sLse[BQ + 4 * rg + i];
      const float p = valid ? exp2f(fmaf(s[i][jj], scale2, -lse2)) : 0.0f;
      sDS[key * BQ + 4 * rg + i] = p * (dp[i][jj] - dlt) * scale;
    }
    __syncthreads();  // every lane's dS is in
    // dQ_slice += dS.K_slice: the slice's two K chunks, still staged
    const float* kt = reinterpret_cast<const float*>(
                          ring + ((t * n + n - 2 + cg / 16) % kStages) *
                                     kStage) +
                      kKAt;
#pragma unroll 8
    for (int r = 0; r < kF32Stream; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(
          kt + r * kC + 4 * ((cg % 16) ^ key_swizzle(r)));
      float x[RO];
#pragma unroll
      for (int i = 0; i < RO; i += 2) {
        const float2 w =
            *reinterpret_cast<const float2*>(sDS + r * BQ + RO * ro + i);
        x[i] = w.x;
        x[i + 1] = w.y;
      }
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        acc[i][0] = fmaf(x[i], y.x, acc[i][0]);
        acc[i][1] = fmaf(x[i], y.y, acc[i][1]);
        acc[i][2] = fmaf(x[i], y.z, acc[i][2]);
        acc[i][3] = fmaf(x[i], y.w, acc[i][3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const int r = q0 + RO * ro + i;
    if (r >= sq) continue;
    *reinterpret_cast<float4*>(dq + qoff + static_cast<int64_t>(r) * ldq +
                               slice * kW + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ------------------------------------------------------- float32 forward
//
// flash_wide_fwd_f32_kernel replaces the first (SIMT) forward in float32
// (the TPU kernel _fwd_kernel above head_dim 256). What held that one at
// 0.06 of bound: scalar shared-memory reads (five loads for four FMAs),
// element-by-element copies with nothing in flight during a product, two
// barriers for each 128-column chunk of each score product, and 128-column
// output slices that recomputed S in each (a cap of 2 / (n + 1) of bound).
// Bound on an H100: float32 operations (67 TFLOP/s; no TF32), below which
// the patches' shared-memory reads hold it ("float32 dq": an R x J patch
// reads R + J float4s for 4RJ FMAs a lane, RJ / (4 (R + J)) of the FMA
// peak). The design, from the float32 dq's parts:
//  * A block (256 threads) owns BQ query rows of one head (32, or 16 where
//    those blocks alone would not make a wave) and one output slice of
//    `width` columns: the whole padded head wherever the block's O fits
//    kF32Acc floats (64 a thread: 32 rows up to 512 columns, 16 up to
//    1024), so S is computed once; else kW (128). The host plan picks both
//    (flash_attention.py `wide_f32_fwd_plan`); the kernel holds up to
//    kF32Groups 128-column groups of O a thread and runs the slice's
//    `width / 128` of them. (16-row 128-column slices took 0.79-0.88x
//    the time of 32-row ones at chip_smoke phase 7e's float32 shapes, so
//    the cut is 16 rows.)
//  * Key tiles of kF32Stream (32) keys. Per key tile, one ring of
//    kFwdF32Ring stages (cp.async, zero-filled past sq and sk) streams the
//    tile's K in d / 128 steps of 128 columns, then the slice's V in
//    width / 128: a K step's barrier frees the stage the step before it
//    read; the V steps stay staged until the tile's P.V, which reads them
//    all after one wait for the last, and the next tile's first barrier
//    frees them (ring_advance; a host walk of it in
//    tests/test_torch_wide_plan.py). Q stays resident (BQ x d, 64 KB at
//    most) wherever the tile's rows of the whole head fit that budget;
//    else (the 16-row cut above 1024 columns) its chunks stream beside
//    K's.
//  * S = Q.K^T as split-lane patches of 4 rows x 8 keys (patch_dot: 8
//    lanes at 32 rows, 16 at 16, share each chunk, summed by a shuffle
//    butterfly in one order), 0.67 of the FMA peak by their reads where the
//    dq's 4 x 4 run at 0.5 (0.90-0.92x the time at the 8B attention shape,
//    PERF.md); K and V chunks XOR-swizzled by key where 8 lanes share.
//  * The online softmax in exp2 of log2e-scaled scores: the patches write S
//    (-1e30 where a row may not attend) into a [32 keys][BQ] buffer; each
//    row's 256 / BQ lanes take its max and sum by shuffles, keep its m and l,
//    write p back (0 while the row's max is -1e30) and its alpha. Then O is
//    rescaled by alpha and O += P.V_slice, each thread BQ / 8 rows x one
//    float4 column (cg) of each 128-column group, unrolled over the
//    slice's groups (`pv_groups`): at 32 rows a key's p (one broadcast
//    float4) feeds every group's V float4, so the product runs at width /
//    (width + 128) of the FMA peak (0.8 at 512) by its reads, not the 0.5
//    of a group a step (which took 1.10-1.13x the time at the 8B shape).
//  * lse written once, by slice 0; out = o / max(l, 1e-30), so a row that
//    sees no key gives out 0 and lse -1e30. No atomics.
// ptxas (sm_90a): 224 registers at 32 rows, 207 and 166 at 16 rows with Q
// resident and streamed, no spill; dynamic shared memory 201,472 and
// 217,856 bytes at 32 rows and head_dim 384 and 512, 215,680 at 16 rows
// and 1024, 150,144 where Q streams (flash_attention.py `wide_f32_smem`).

constexpr int kF32Acc = 16384;  // a block's output accumulators: 64 a thread
// the forward's stages: 16 KB each where Q stays resident (a key tile's V
// groups, up to 8, and one more), 24 KB (16 rows) where it streams
template <bool kResident>
constexpr int kFwdF32Ring = kResident ? 9 : 6;
template <int BQ>
constexpr int kF32Groups = kF32Acc / (BQ * kW);  // 4 (32 rows), 8 (16)
// a forward stage: a K (V) pair of chunks [2][32][kC], and Q's pair
// [2][BQ][kC] where Q streams
template <int BQ, bool kResident>
constexpr int kFwdF32Stage = 4 * 2 * kC * (kF32Stream + (kResident ? 0 : BQ));
template <int BQ>
constexpr int kFwdF32Ld = BQ + 4;  // a row of the p buffer, padded

// Dynamic shared memory of the forward at head_dim d: the ring, resident Q,
// the p buffer [32][BQ + 4], and the rows' alpha and l.
template <int BQ, bool kResident>
constexpr int fwd_f32_smem(int d) {
  return kFwdF32Ring<kResident> * kFwdF32Stage<BQ, kResident> +
         (kResident ? 4 * BQ * d : 0) +
         4 * (kF32Stream * kFwdF32Ld<BQ> + 2 * BQ);
}
static_assert(fwd_f32_smem<32, true>(kF32Acc / 32) <= 232448 &&
                  fwd_f32_smem<16, true>(kF32Acc / 16) <= 232448 &&
                  fwd_f32_smem<16, false>(0) <= 232448,
              "a block's shared memory");

// O += P.V over NV 128-column groups of a key tile, V's rows staged at
// ring + vat[c] (this lane's chunk of group c): for each of the 32 keys, the
// thread's RO rows of p (`p` at its first row, keys ld apart) and float4
// column cg of each group's V row. Unrolled over the groups, so every
// group's loads of a key issue together; `pv_groups` picks NV = nv.
template <int NV, int kGroups, int RO, typename Swizzle>
__device__ __forceinline__ void pv_product(float (&acc)[kGroups][RO][4],
                                           const float* p, int ld,
                                           const float* ring,
                                           const int (&vat)[kGroups], int cg,
                                           Swizzle swizzle) {
#pragma unroll 8
  for (int r = 0; r < kF32Stream; ++r) {
    float w[RO];
    if constexpr (RO == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + r * ld);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p + r * ld);
      w[0] = x.x;
      w[1] = x.y;
    }
    const int col = r * kC + 4 * (cg ^ swizzle(r));
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float4 y = *reinterpret_cast<const float4*>(ring + vat[c] + col);
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        acc[c][i][0] = fmaf(w[i], y.x, acc[c][i][0]);
        acc[c][i][1] = fmaf(w[i], y.y, acc[c][i][1]);
        acc[c][i][2] = fmaf(w[i], y.z, acc[c][i][2]);
        acc[c][i][3] = fmaf(w[i], y.w, acc[c][i][3]);
      }
    }
  }
}

template <int NV, int kGroups, int RO, typename Swizzle>
__device__ __forceinline__ void pv_groups(int nv,
                                          float (&acc)[kGroups][RO][4],
                                          const float* p, int ld,
                                          const float* ring,
                                          const int (&vat)[kGroups], int cg,
                                          Swizzle swizzle) {
  if constexpr (NV > 1) {
    if (nv < NV) {
      pv_groups<NV - 1>(nv, acc, p, ld, ring, vat, cg, swizzle);
      return;
    }
  }
  pv_product<NV>(acc, p, ld, ring, vat, cg, swizzle);
}

template <int BQ, bool kResident>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_wide_fwd_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ out,
                              float* __restrict__ lse, int sq, int sk,
                              int n_rep, int d, int width, float scale,
                              int causal) {
  constexpr int J = 8;                       // keys a score patch
  constexpr int KG = kF32Stream / J;         // key groups: keys kg + KG j
  constexpr int S = kF32Threads / (BQ / 4 * KG);  // lanes a patch: 8, 16
  constexpr int kGroups = kResident ? kF32Groups<BQ> : 1;
  constexpr int RO = BQ / 8;                 // output rows a thread
  constexpr int TPR = kF32Threads / BQ;      // softmax lanes a row
  constexpr int KPL = kF32Stream / TPR;      // keys a softmax lane
  constexpr int LD = kFwdF32Ld<BQ>;
  constexpr int kRing = kFwdF32Ring<kResident>;
  constexpr int kStage = kFwdF32Stage<BQ, kResident> / 4;  // floats
  constexpr int kQAt = 2 * kF32Stream * kC;  // a stage's Q pair (streamed)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* sQ = ring + kRing * kStage;  // resident Q, [chunk][BQ][kC]
  float* sP = sQ + (kResident ? BQ * d : 0);  // [32 keys][LD]: s, then p
  float* sAlpha = sP + kF32Stream * LD;       // the rows' alpha, then l
  float* sL = sAlpha + BQ;

  const int n = d / kC;      // chunks of the head
  const int nk = d / kW;     // K steps of a key tile
  const int nv = width / kW; // V steps: the slice's 128-column groups
  const int n_slices = d / width;
  // launch order: slice fastest, then (head, batch), then the query tile,
  // heaviest (the causal band's longest rows) first
  const int heads = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + heads * blockIdx.z);
  const int slice = lin % n_slices;
  const int rest = lin / n_slices;
  const int hb = rest % (heads * gridDim.z);
  const int head = hb % heads;
  const int batch = hb / heads;
  const int q0 = (gridDim.x / n_slices - 1 - rest / (heads * gridDim.z)) * BQ;
  const int c0 = slice * width;  // the slice's first column
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * d;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                       static_cast<int64_t>(head) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(head / n_rep) * d;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const float scale2 = scale * kLog2e;
  const int n_kt = key_tiles(q0, sk, offset, causal, BQ, kF32Stream);
  const int per = nk + nv;  // steps a key tile
  const int total = n_kt * per;
  const auto unswizzled = [](int) { return 0; };
  const auto key_swizzle = [](int r) { return ((r & 7) * S) & 15; };

  auto load_step = [&](int step) {  // K pair j, or V pair j - nk, of tile t
    const int t = step / per;
    const int j = step - t * per;
    float* st = ring + (step % kRing) * kStage;
    const int col = j < nk ? j * kW : c0 + (j - nk) * kW;
    const float* src = (j < nk ? k : v) + koff + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_rows_f32<kF32Stream>(st + h * kF32Stream * kC, src + h * kC,
                                t * kF32Stream, sk, ldk, key_swizzle);
    }
    if constexpr (!kResident) {
      if (j < nk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          load_rows_f32<BQ>(st + kQAt + h * BQ * kC, q + qoff + col + h * kC,
                            q0, sq, ldq, unswizzled);
        }
      }
    }
  };

  if constexpr (kResident) {  // the block's Q, every chunk, a group of its own
    for (int c = 0; c < n; ++c) {
      load_rows_f32<BQ>(sQ + c * BQ * kC, q + qoff + c * kC, q0, sq, ldq,
                        unswizzled);
    }
    cp_async_commit();
  }
  int loaded = 0;
  for (; loaded < total && loaded < kRing; ++loaded) {
    load_step(loaded);
    cp_async_commit();
  }

  // the score patch: rows 4 rg + i, keys kg + KG j, this lane's share dg
  // (the patch's keys share their swizzle: KG is even)
  const int dg = threadIdx.x % S;
  const int kg = threadIdx.x / S % KG;
  const int rg = threadIdx.x / S / KG;
  const int xk = key_swizzle(kg);
  // the softmax: row sr, keys su + TPR e
  const int sr = threadIdx.x / TPR;
  const int su = threadIdx.x % TPR;
  float m = kNegInf, l = 0.0f;
  // the output: rows RO ro + i, float4 column cg of each 128-column group
  const int cg = threadIdx.x % 32;
  const int ro = threadIdx.x / 32;
  float acc[kGroups][RO][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
#pragma unroll
    for (int i = 0; i < RO; ++i) zero(acc[c][i]);
  }

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kF32Stream;
    float s[4][J];
#pragma unroll
    for (int i = 0; i < 4; ++i) zero(s[i]);
    for (int j = 0; j < nk; ++j) {  // S += Q.K^T, 128 columns a step
      const int step = t * per + j;
      ring_advance<kRing>(step, step, total, loaded, load_step);
      const float* st = ring + (step % kRing) * kStage;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* qa = kResident ? sQ + (2 * j + h) * BQ * kC
                                    : st + kQAt + h * BQ * kC;
        patch_dot<S, J>(qa + 4 * rg * kC,
                        st + h * kF32Stream * kC + kg * kC, dg, xk, s);
      }
    }
    // the shares of the patch's S lanes, summed
#pragma unroll
    for (int mk = 1; mk < S; mk <<= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          s[i][jj] += __shfl_xor_sync(0xffffffffu, s[i][jj], mk);
        }
      }
    }
    // a tile holding a key no row of the block may attend: a row past sq, a
    // key past sk, or a key past the causal band of the block's first row
    const bool mask = q0 + BQ > sq || k0 + kF32Stream > sk ||
                      (causal && k0 + kF32Stream - 1 > q0 + offset);
#pragma unroll
    for (int e = 0; e < 4 * J; ++e) {
      if (e % S != dg) continue;  // this lane's entries of the patch
      const int i = e / J;
      const int jj = e % J;
      const int row = 4 * rg + i;
      const int key = kg + KG * jj;
      const bool ok =
          !mask || attends(q0 + row, k0 + key, sq, sk, offset, causal);
      sP[key * LD + row] = ok ? s[i][jj] : kNegInf;
    }
    __syncthreads();  // every patch's S is in
    {  // the online softmax of row sr over its TPR lanes
      float x[KPL];
      float mx = m;
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        x[e] = sP[(su + TPR * e) * LD + sr];
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int lanes = 1; lanes < TPR; lanes <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lanes));
      }
      const float alpha = exp2f((m - mx) * scale2);
      m = mx;
      // a row that has seen no key yet keeps p = 0 (and so out 0)
      const bool none = mx == kNegInf;
      const float ms = mx * scale2;
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        x[e] = none ? 0.0f : exp2f(fmaf(x[e], scale2, -ms));
        sum += x[e];
        sP[(su + TPR * e) * LD + sr] = x[e];
      }
#pragma unroll
      for (int lanes = 1; lanes < TPR; lanes <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
      }
      l = l * alpha + sum;
      if (su == 0) sAlpha[sr] = alpha;
    }
    // every V step of the tile landed (they stay staged until its P.V is
    // done); the barrier makes p and alpha visible
    ring_advance<kRing>(t * per + per - 1, t * per + nk, total, loaded,
                        load_step);
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const float a = sAlpha[RO * ro + i];
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[c][i][x] *= a;
      }
    }
    // O_slice += P.V_slice over the slice's nv groups, unrolled for nv
    int vat[kGroups];  // the groups' stages, at this lane's chunk
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      vat[c] = ((t * per + nk + c) % kRing) * kStage +
               (cg / 16) * kF32Stream * kC;
    }
    pv_groups<kGroups>(nv, acc, sP + RO * ro, LD, ring, vat, cg % 16,
                       key_swizzle);
  }
  cp_async_wait<0>();

  if (su == 0) {
    const float lc = fmaxf(l, 1e-30f);
    sL[sr] = lc;
    if (slice == 0 && q0 + sr < sq) {
      lse[row_off + q0 + sr] = m == kNegInf ? kNegInf : m * scale + logf(lc);
    }
  }
  __syncthreads();  // every row's l is in
#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const int r = q0 + RO * ro + i;
    if (r >= sq) continue;
    const float lc = sL[RO * ro + i];
    float* dst = out + qoff + static_cast<int64_t>(r) * ldq + c0 + 4 * cg;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      if (c >= nv) break;
      *reinterpret_cast<float4*>(dst + c * kW) =
          make_float4(acc[c][i][0] / lc, acc[c][i][1] / lc,
                      acc[c][i][2] / lc, acc[c][i][3] / lc);
    }
  }
}

// --------------------------------------------------------- float32 dk/dv
//
// flash_wide_dkv_f32_kernel replaces the first (SIMT) dk/dv in float32 (the
// TPU kernel _bwd_dkv_kernel above head_dim 256). What held that one at
// 0.06 of bound: the SIMT forward's scalar reads, copies and barriers, and
// S and dP recomputed in each 128-column slice (a cap of 8 / (4n + 4) of
// bound). Bound on an H100: float32 operations, below which the patches'
// shared-memory reads hold it ("float32 forward"). The design:
//  * A block (256 threads) owns kDkvKeys (16) keys of one kv head and one
//    output slice of `width` columns of both dK and dV: the whole padded
//    head up to 512 columns, where 2 x 16 x 512 accumulators make kF32Acc,
//    so S and dP are computed once, and the blocks make a wave; else kW
//    (128). The host plan picks it (flash_attention.py
//    `wide_f32_dkv_plan`). The block's K and V stay resident (16 x d each,
//    64 KB at 512) where it holds the whole head; above 512 they stream.
//  * For each of the n_rep query heads in turn, query tiles of kF32Stream
//    (32) rows from the first one whose band reaches the block's keys. Per
//    tile, the backward's ring (chunk_of, ring_step; kDkvRing stages)
//    streams Q and dO a 64-column chunk a step, the slice's chunks last;
//    those stay staged for the output products (at the whole head, every
//    chunk: the ring holds a tile's n chunk pairs, 16 KB each, and one more
//    stage, so the next tile's first chunk loads during the output
//    products). Staging them costs shared memory where streaming them
//    again would double the tile's reads from L2 (~4 FMAs a byte at the
//    whole head, near what L2 feeds 132 SMs).
//  * S^T = K.Q^T and dP^T = V.dO^T as split-lane 4 x 4 patches (4 keys x 4
//    rows, 8 lanes a patch, patch_dot; 0.5 of the FMA peak by their reads),
//    summed by a shuffle butterfly. p =
//    exp2(s scale log2e - lse log2e), selected to 0 where a row may not
//    attend (never multiplied), ds = p (dp - delta) scale, into [32 rows]
//    [16 keys] buffers; each lane's rows' lse and delta are read from global
//    memory at the tile's start, in flight during its chunk steps.
//  * dV_slice += P^T.dO_slice (threads 0-127) and dK_slice += dS^T.Q_slice
//    (threads 128-255), each thread 4 keys x one float4 column of each
//    128-column group (cg + 32 c) of its output: a row's p or ds (one
//    broadcast float4) feeds every group, width / (width + 128) of the FMA
//    peak by its reads; the n_rep heads' sums in registers in one order,
//    each output written once. No atomics.
// ptxas (sm_90a): 224 registers with K and V resident, 164 where they
// stream, no spill; dynamic shared memory 200,704 and 217,088 bytes at
// head_dim 384 and 512, 225,280 where K and V stream (flash_attention.py
// `wide_f32_smem`).

constexpr int kDkvKeys = 16;
constexpr int kDkvRing = 9;  // stages: a tile's 8 chunk pairs at 512, + 1
// a dk/dv stage: Q and dO chunks [32][kC], and K and V chunks [16][kC]
// where they stream
template <bool kResident>
constexpr int kDkvF32Stage =
    4 * kC * (2 * kF32Stream + (kResident ? 0 : 2 * kDkvKeys));
constexpr int kDkvF32MaxD = kF32Acc / (2 * kDkvKeys);  // 512: K, V resident

// Dynamic shared memory of dk/dv at head_dim d: the ring, resident K and V,
// the p and ds buffers.
template <bool kResident>
constexpr int dkv_f32_smem(int d) {
  return kDkvRing * kDkvF32Stage<kResident> +
         (kResident ? 4 * 2 * kDkvKeys * d : 0) +
         4 * 2 * kF32Stream * kDkvKeys;
}
static_assert(dkv_f32_smem<true>(kDkvF32MaxD) <= 232448 &&
                  dkv_f32_smem<false>(0) <= 232448,
              "a block's shared memory");
static_assert(kDkvRing > kDkvF32MaxD / kC, "a tile's chunks and one more");

template <bool kResident>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_wide_dkv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int sq, int sk, int n_rep, int d, int width,
                              float scale, int causal) {
  constexpr int BK = kDkvKeys;
  constexpr int S = kF32Threads / (BK / 4 * (kF32Stream / 4));  // 8
  constexpr int kPer = 16 / S;  // a lane's entries of its patch
  constexpr int kGroups = kResident ? kF32Acc / (2 * BK * kW) : 1;
  constexpr int kStage = kDkvF32Stage<kResident> / 4;  // floats
  constexpr int kDoAt = kF32Stream * kC;        // a stage's dO chunk
  constexpr int kKAt = 2 * kF32Stream * kC;     // K and V (streamed)
  constexpr int kVAt = kKAt + BK * kC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* sK = ring + kDkvRing * kStage;  // resident K, V [chunk][16][kC]
  float* sV = sK + (kResident ? BK * d : 0);
  float* sP = sV + (kResident ? BK * d : 0);  // P [32 rows][16 keys]
  float* sD = sP + kF32Stream * BK;           // dS, the same

  const int n = d / kC;
  const int m = width / kC;  // the slice's chunks
  const int n_slices = d / width;
  // launch order: slice fastest, then (kv head, batch), then the key tile,
  // lowest keys (the most query tiles under causal) first
  const int n_kv = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + n_kv * blockIdx.z);
  const int slice = lin % n_slices;
  const int rest = lin / n_slices;
  const int hb = rest % (n_kv * gridDim.z);
  const int g = hb % n_kv;  // kv head
  const int batch = hb / n_kv;
  const int k0 = rest / (n_kv * gridDim.z) * BK;
  const int heads = n_kv * n_rep;
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(n_kv) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(g) * d;
  const int offset = sk - sq;
  const float scale2 = scale * kLog2e;
  // query tiles from the first whose rows reach key k0 under causal
  const int first = causal ? max(k0 - offset, 0) / kF32Stream : 0;
  const int nq = (sq + kF32Stream - 1) / kF32Stream - first;
  const int tiles = n_rep * nq;  // (query head, query tile) pairs
  const int total = tiles * n;
  const auto unswizzled = [](int) { return 0; };

  auto qoff_of = [&](int tt) {  // head g n_rep + tt / nq's first column
    return static_cast<int64_t>(batch) * sq * ldq +
           static_cast<int64_t>(g * n_rep + tt / nq) * d;
  };
  auto load_step = [&](int step) {
    const int tt = step / n;
    const int q0 = (first + tt % nq) * kF32Stream;
    const int c = chunk_of(step - tt * n, slice, n, m) * kC;
    const int64_t qo = qoff_of(tt) + c;
    float* st = ring + (step % kDkvRing) * kStage;
    load_rows_f32<kF32Stream>(st, q + qo, q0, sq, ldq, unswizzled);
    load_rows_f32<kF32Stream>(st + kDoAt, dout + qo, q0, sq, ldq,
                              unswizzled);
    if constexpr (!kResident) {
      load_rows_f32<BK>(st + kKAt, k + koff + c, k0, sk, ldk, unswizzled);
      load_rows_f32<BK>(st + kVAt, v + koff + c, k0, sk, ldk, unswizzled);
    }
  };

  if constexpr (kResident) {  // the block's K and V, a group of their own
    for (int c = 0; c < n; ++c) {
      load_rows_f32<BK>(sK + c * BK * kC, k + koff + c * kC, k0, sk, ldk,
                        unswizzled);
      load_rows_f32<BK>(sV + c * BK * kC, v + koff + c * kC, k0, sk, ldk,
                        unswizzled);
    }
    cp_async_commit();
  }
  int loaded = 0;
  for (; loaded < total && loaded < kDkvRing; ++loaded) {
    load_step(loaded);
    cp_async_commit();
  }

  // the score patch: keys 4 kq + i, rows qg + 8 jj, this lane's share dg
  const int dg = threadIdx.x % S;
  const int qg = threadIdx.x / S % 8;
  const int kq = threadIdx.x / S / 8;
  // the output: dV (threads 0-127) or dK, keys 4 ko + i, float4 column cg
  // of each 128-column group
  const int cg = threadIdx.x % 32;
  const int ko = threadIdx.x / 32 % 4;
  const bool is_dk = threadIdx.x >= kF32Threads / 2;
  const float* wsrc = is_dk ? sD : sP;
  const int xat = is_dk ? 0 : kDoAt;  // Q for dK, dO for dV
  float acc[kGroups][4][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) zero(acc[c][i]);
  }

  for (int tt = 0; tt < tiles; ++tt) {
    const int q0 = (first + tt % nq) * kF32Stream;
    const int64_t row_off =
        (static_cast<int64_t>(batch) * heads + g * n_rep + tt / nq) * sq;
    // this lane's rows' log2e-scaled lse and delta (0 past sq)
    float lse2[kPer], dlt[kPer];
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int row = q0 + qg + 8 * ((dg + S * x) % 4);
      lse2[x] = row < sq ? lse[row_off + row] * kLog2e : 0.0f;
      dlt[x] = row < sq ? delta[row_off + row] : 0.0f;
    }
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      zero(s[i]);
      zero(dp[i]);
    }
    for (int j = 0; j < n; ++j) {
      const int step = tt * n + j;
      ring_step<0, kDkvRing>(step, j, n, total, loaded, load_step, m);
      const float* st = ring + (step % kDkvRing) * kStage;
      const int c = chunk_of(j, slice, n, m);
      const float* ka = kResident ? sK + c * BK * kC : st + kKAt;
      const float* va = kResident ? sV + c * BK * kC : st + kVAt;
      patch_dot<S>(ka + 4 * kq * kC, st + qg * kC, dg, 0, s);
      patch_dot<S>(va + 4 * kq * kC, st + kDoAt + qg * kC, dg, 0, dp);
    }
    // the shares of the patch's S lanes, summed
#pragma unroll
    for (int mk = 1; mk < S; mk <<= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] += __shfl_xor_sync(0xffffffffu, s[i][jj], mk);
          dp[i][jj] += __shfl_xor_sync(0xffffffffu, dp[i][jj], mk);
        }
      }
    }
    // a pair holding an entry no row may attend: a row past sq, a key past
    // sk, or a key past the causal band of the tile's first row
    const bool mask = q0 + kF32Stream > sq || k0 + BK > sk ||
                      (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (e % S != dg) continue;  // this lane's entries of the patch
      const int x = e / S;
      const int i = e / 4;
      const int jj = e % 4;
      const int row = qg + 8 * jj;
      const int key = 4 * kq + i;
      const bool ok =
          !mask || attends(q0 + row, k0 + key, sq, sk, offset, causal);
      const float p = ok ? exp2f(fmaf(s[i][jj], scale2, -lse2[x])) : 0.0f;
      sP[row * BK + key] = p;
      sD[row * BK + key] = ok ? p * (dp[i][jj] - dlt[x]) * scale : 0.0f;
    }
    __syncthreads();  // every lane's p and ds are in
    // dV_slice += P^T.dO_slice, dK_slice += dS^T.Q_slice: the slice's
    // chunks, still staged (steps n - m .. n - 1 of the tile)
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      if (2 * c >= m) break;
      const float* xt =
          ring + ((tt * n + n - m + 2 * c + cg / 16) % kDkvRing) * kStage +
          xat;
#pragma unroll 8
      for (int r = 0; r < kF32Stream; ++r) {
        const float4 y =
            *reinterpret_cast<const float4*>(xt + r * kC + 4 * (cg % 16));
        const float4 w =
            *reinterpret_cast<const float4*>(wsrc + r * BK + 4 * ko);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[c][i][0] = fmaf(wv[i], y.x, acc[c][i][0]);
          acc[c][i][1] = fmaf(wv[i], y.y, acc[c][i][1]);
          acc[c][i][2] = fmaf(wv[i], y.z, acc[c][i][2]);
          acc[c][i][3] = fmaf(wv[i], y.w, acc[c][i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = is_dk ? dk : dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ko + i;
    if (key >= sk) continue;
    float* row = dst + koff + static_cast<int64_t>(key) * ldk +
                 slice * width + 4 * cg;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      if (2 * c >= m) break;
      *reinterpret_cast<float4*>(row + c * kW) =
          make_float4(acc[c][i][0], acc[c][i][1], acc[c][i][2], acc[c][i][3]);
    }
  }
}

bool bad_layout(int batch, int heads, int n_rep, int d) {
  return d <= 0 || d % kW != 0 || n_rep <= 0 || heads % n_rep != 0 ||
         batch > 65535 || heads > 65535;
}

template <bool kResident>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int heads, int n_rep, int sq,
                     int sk, int d, float scale, int causal, void* stream) {
  const int smem = fwd_wgmma_smem<kResident>(d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_fwd_wgmma_kernel<kResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kWq - 1) / kWq *
                      ((d + kFwdSliceOf<kResident> - 1) /
                       kFwdSliceOf<kResident>),
                  heads, batch);
  flash_wide_fwd_wgmma_kernel<kResident><<<grid, kThreads, smem,
                                           static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), sq, sk, n_rep, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int fwd_bf16_entry(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int heads, int n_rep, int sq, int sk,
                   int d, float scale, int causal, void* stream) {
  if (bad_layout(batch, heads, n_rep, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Q resident up to 512 columns
  return d <= kFwdResidentMaxD
             ? launch_fwd_wgmma<true>(q, k, v, out, lse, batch, heads, n_rep,
                                      sq, sk, d, scale, causal, stream)
             : launch_fwd_wgmma<false>(q, k, v, out, lse, batch, heads,
                                       n_rep, sq, sk, d, scale, causal,
                                       stream);
}

template <int BQ, bool kResident>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int heads, int n_rep, int sq, int sk,
                   int d, int width, float scale, int causal, void* stream) {
  const int smem = fwd_f32_smem<BQ, kResident>(d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_fwd_f32_kernel<BQ, kResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ * (d / width), heads, batch);
  flash_wide_fwd_f32_kernel<BQ, kResident><<<grid, kF32Threads, smem,
                                             static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, n_rep, d, width, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The float32 forward at query tile `tile` (32 or 16) with output slices
// of `width` columns: the whole head, where the tile's rows of it fit
// kF32Acc accumulators, or kW (flash_attention.py `wide_f32_fwd_plan`). Q
// stays resident wherever the tile's rows of the whole head fit that
// budget; it streams only in 16-row, kW-column blocks. Any other pair is
// refused.
int fwd_f32_entry(const void* q, const void* k, const void* v, void* out,
                  void* lse, int batch, int heads, int n_rep, int sq, int sk,
                  int d, float scale, int causal, int tile, int width,
                  void* stream) {
  const bool resident = tile * d <= kF32Acc;
  if (bad_layout(batch, heads, n_rep, d) || (tile != 32 && tile != 16) ||
      (width != d && width != kW) ||
      (!resident && (tile != 16 || width != kW))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 32) {
    return launch_fwd_f32<32, true>(q, k, v, out, lse, batch, heads, n_rep,
                                    sq, sk, d, width, scale, causal, stream);
  }
  return resident ? launch_fwd_f32<16, true>(q, k, v, out, lse, batch, heads,
                                             n_rep, sq, sk, d, width, scale,
                                             causal, stream)
                  : launch_fwd_f32<16, false>(q, k, v, out, lse, batch,
                                              heads, n_rep, sq, sk, d, width,
                                              scale, causal, stream);
}

int dkv_bf16_entry(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int batch, int heads, int n_rep,
                   int sq, int sk, int d, float scale, int causal,
                   void* stream) {
  if (bad_layout(batch, heads, n_rep, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_dkv_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWgmmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kWk - 1) / kWk * (d / kW), heads / n_rep, batch);
  flash_wide_dkv_wgmma_kernel<<<grid, kThreads, kWgmmaSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, n_rep, d,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kResident>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int batch, int heads, int n_rep,
                   int sq, int sk, int d, int width, float scale, int causal,
                   void* stream) {
  const int smem = dkv_f32_smem<kResident>(d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_dkv_f32_kernel<kResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kDkvKeys - 1) / kDkvKeys * (d / width),
                  heads / n_rep, batch);
  flash_wide_dkv_f32_kernel<kResident><<<grid, kF32Threads, smem,
                                         static_cast<cudaStream_t>(
                                             stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, n_rep, d,
      width, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The float32 dk/dv at key tile `tile` (kDkvKeys) with output slices of
// `width` columns: the whole head up to kDkvF32MaxD, or kW
// (flash_attention.py `wide_f32_dkv_plan`); K and V resident up to
// kDkvF32MaxD. Any other pair is refused.
int dkv_f32_entry(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int batch, int heads, int n_rep,
                  int sq, int sk, int d, float scale, int causal, int tile,
                  int width, void* stream) {
  const bool resident = d <= kDkvF32MaxD;
  if (bad_layout(batch, heads, n_rep, d) || tile != kDkvKeys ||
      (width != d && width != kW) || (width != kW && !resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return resident
             ? launch_dkv_f32<true>(q, k, v, dout, lse, delta, dk, dv, batch,
                                    heads, n_rep, sq, sk, d, width, scale,
                                    causal, stream)
             : launch_dkv_f32<false>(q, k, v, dout, lse, delta, dk, dv,
                                     batch, heads, n_rep, sq, sk, d, width,
                                     scale, causal, stream);
}

template <int BQ>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int batch, int heads, int n_rep, int sq, int sk,
                  int d, float scale, int causal, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_dq_f32_kernel<BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDqF32Smem<BQ>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ * (d / kW), heads, batch);
  flash_wide_dq_f32_kernel<BQ><<<grid, kF32Threads, kDqF32Smem<BQ>,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, n_rep, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dq on wgmma; the float32 one at query tile `tile` (64 or 16).
template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int batch,
             int heads, int n_rep, int sq, int sk, int d, float scale,
             int causal, int tile, void* stream) {
  if (bad_layout(batch, heads, n_rep, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (std::is_same_v<T, bf16>) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wide_dq_wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWgmmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kWq - 1) / kWq * (d / kW), heads, batch);
    flash_wide_dq_wgmma_kernel<<<grid, kThreads, kWgmmaSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), sq, sk, n_rep, d, scale, causal);
    return static_cast<int>(cudaGetLastError());
  } else {
    if (tile == 64) {
      return launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, batch, heads,
                               n_rep, sq, sk, d, scale, causal, stream);
    }
    if (tile == 16) {
      return launch_dq_f32<16>(q, k, v, dout, lse, delta, dq, batch, heads,
                               n_rep, sq, sk, d, scale, causal, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [batch, sq, heads*d], k/v [batch, sk, (heads/n_rep)*d] row-major, bf16
// (rt_flash_wide_*) or float32 (rt_flash_wide_*_f32); out like q; lse
// [batch, heads, sq] float32. [b*h, s, d] operands are batch = b*h, heads =
// n_rep = 1. d is a positive multiple of 128. Returns a CUDA error code
// (0 = ok).
int rt_flash_wide_fwd(const void* q, const void* k, const void* v,
                      void* out, void* lse, int batch, int heads, int n_rep,
                      int sq, int sk, int d, float scale, int causal,
                      void* stream) {
  return fwd_bf16_entry(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                        scale, causal, stream);
}

// The float32 forward also takes its query tile and slice width
// (flash_attention.py `wide_f32_fwd_plan`).
int rt_flash_wide_fwd_f32(const void* q, const void* k, const void* v,
                          void* out, void* lse, int batch, int heads,
                          int n_rep, int sq, int sk, int d, float scale,
                          int causal, int tile, int width, void* stream) {
  return fwd_f32_entry(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                       scale, causal, tile, width, stream);
}

// dO like q, lse/delta [batch, heads, sq] float32; dk/dv like k.
int rt_flash_wide_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int batch,
                          int heads, int n_rep, int sq, int sk, int d,
                          float scale, int causal, void* stream) {
  return dkv_bf16_entry(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                        n_rep, sq, sk, d, scale, causal, stream);
}

// The float32 dk/dv also takes its key tile and slice width
// (flash_attention.py `wide_f32_dkv_plan`).
int rt_flash_wide_bwd_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              int batch, int heads, int n_rep, int sq,
                              int sk, int d, float scale, int causal,
                              int tile, int width, void* stream) {
  return dkv_f32_entry(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                       n_rep, sq, sk, d, scale, causal, tile, width, stream);
}

// dq like q.
int rt_flash_wide_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, int batch, int heads,
                         int n_rep, int sq, int sk, int d, float scale,
                         int causal, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                        sq, sk, d, scale, causal, 0, stream);
}

// The float32 dq also takes its query tile (flash_attention.py
// `wide_f32_dq_tile`: 64 or 16).
int rt_flash_wide_bwd_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int batch,
                             int heads, int n_rep, int sq, int sk, int d,
                             float scale, int causal, int tile,
                             void* stream) {
  return dq_entry<float>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                         sq, sk, d, scale, causal, tile, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
