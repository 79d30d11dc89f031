// Flash attention for the training step: the forward and the two backward
// kernels, bf16 or float32 operands with float32 accumulation and softmax
// state.
//
// flash_fwd_kernel replaces the TPU kernel _fwd_kernel
// (ray_tpu/ops/pallas/flash_attention.py:38) in both of its calls, over
// [b*h, s, d] (_flash_fwd :104) and over the packed [b, s, h*d] layout
// (_flash_fwd_packed :376); flash_bwd_dkv_kernel replaces _bwd_dkv_kernel
// (:181) and flash_bwd_dq_kernel replaces _bwd_dq_kernel (:224), both built
// on the recompute of _recompute_p_ds (:142), in _flash_bwd (:276, :303)
// and in _flash_bwd_packed (:442, :480). The *_f32 kernels are the same
// three functions for float32 operands (the reference keeps the input
// dtype, :63, :130).
//
// What bounds them on an H100: tensor-core operations. At the Llama-3-8B
// training shape (b*h = 64, s = 2048, head_dim 128, causal) each product
// costs 2*bh*s*s*hd/2 = 3.44e10 FLOP against ~100 MB of operands, a few
// hundred FLOP per byte, above the card's ~295 FLOP/byte balance point. The
// forward does 2 products (bound 0.069 ms at 989 TFLOP/s), dk/dv 4 and dq 3.
//
// Shared by every kernel here:
//  * One block owns one output tile (128 query rows in the bf16 forward and
//    dq, 128 keys in the bf16 dk/dv (64 at d 256), 64 or 16 query rows in
//    the float32 forward and dq, 64 or 16 keys in the float32 dk/dv) and
//    loops over the reduction axis inside the block (the TPU's sequential
//    grid axis does not exist here). No atomics: forward and dq blocks own
//    query tiles, dk/dv blocks own key tiles, so results are
//    deterministic.
//  * Scores, probabilities and the softmax state stay float32; p and ds are
//    rounded to bf16 only as operands of the accumulating products, as the
//    TPU kernels cast them.
//  * Causal masks are end-aligned (key col <= row + sk - sq) and key blocks
//    entirely above the band are skipped; the ragged key tail is masked with
//    -1e30, and rows past sq or sk are zero-filled when a tile is loaded, so
//    no product ever reads garbage (0 * NaN would poison a sum). l >= 1e-30
//    guards rows that saw no key.
//  * A query row that may attend no key (causal with sq > sk: rows
//    r < sq - sk) gives out = 0 and lse = -1e30: while a row's max is
//    still -1e30 its p is kept 0, in every forward kernel. Its gradient is
//    then 0, which is what the backward kernels compute there (p = 0 on
//    masked entries). The einsum route (causal_attention_reference) gives
//    the mean of V on such rows instead; the flash route is one function.
//  * One layout serves both calls: q, dO, out and dq are [b, sq, heads*D]
//    and k, v, dk, dv [b, sk, (heads/n_rep)*D], lse and delta
//    [b, heads, sq]. The grid's y axis is the head and z the batch; a
//    block finds its head's rows by strides (row stride heads*D on the
//    query side, (heads/n_rep)*D on the key side), so [b*h, s, d] is the
//    case heads = 1, n_rep = 1 and no transpose is ever made. Offsets are
//    64-bit.
//  * GQA by index: query head h reads kv head h / n_rep, and K/V are never
//    repeated. A dk/dv block owns one key tile of one kv head and walks the
//    query tiles of all n_rep query heads that share it, accumulating in
//    float32 and writing once (no atomics; the causal skip of the first
//    query tiles applies per head). The [b*h, s, d] callers pass K/V
//    repeated per query head and sum dk/dv over the groups afterwards, as
//    the reference's unpacked path does.
//
// The bf16 kernels are built on Hopper's warpgroup MMA (wgmma; the shared
// building blocks are in hopper.cuh): the forward and dq share one
// query-stationary mainloop (see "query-stationary mainloop" below), dk/dv
// its key-stationary twin ("key-stationary mainloop"). Two warpgroups a
// block; scores, probabilities and output accumulators never leave
// registers; P and dS are register A operands; the streamed tiles come
// through a two-stage cp.async ring. The float32 kernels use CUDA-core
// FMAs (no TF32, which keeps ~3 digits): one SIMT design (rows over groups
// of lanes, float4 operand reads from swizzled tiles, two cp.async slots
// for the streamed side and a host plan of the block's tile; see
// "float32" below).
//
// Head dims 32, 64, 128 and 256 are instantiated; the wrappers zero-pad any
// other head_dim up to 256 to the next of them (the caller's scale stays,
// so the padded zeros change no score) and refuse a wider one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Index of the first key block (of kt keys) past the causal band of query
// rows [q0, q0 + rows): key block kb is needed iff kb*kt <= q0 + rows - 1 +
// offset.
__device__ __forceinline__ int key_blocks(int q0, int sk, int offset,
                                          int causal, int rows = kBQ,
                                          int kt = kBK) {
  int n = (sk + kt - 1) / kt;
  if (causal) {
    const int last = q0 + rows - 1 + offset;
    const int lim = last < 0 ? 0 : last / kt + 1;
    n = n < lim ? n : lim;
  }
  return n;
}

// Whether key tile [k0, k0 + kBK) holds an entry that some row of the
// query tile starting at q0 may not attend: the ragged key tail, or keys
// past the causal band of the tile's first row.
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, int sk,
                                                int offset, int causal) {
  return k0 + kBK > sk || (causal && k0 + kBK - 1 > q0 + offset);
}

__device__ __forceinline__ bool attends(int row, int col, int sk, int offset,
                                        int causal) {
  return col < sk && (!causal || col <= row + offset);
}

// ------------------------------------------------ query-stationary mainloop
//
// flash_fwd_kernel and flash_bwd_dq_kernel: one block of two warpgroups
// (8 warps) owns a 128-row query tile of one head and streams the 64-row
// K/V tiles of its kv head past it. Warpgroup g owns rows 64g..64g+63,
// and each of its warps 16 of them: every score, probability and output
// value of those rows stays in registers.
//
// What bounds them: tensor-core operations (2 products in the forward, 3
// in dq, each 2*pairs*hd FLOP), above the card's ~295 FLOP/byte balance
// point, so the design keeps the tensor cores fed:
//  * products are Hopper's warpgroup MMA (wgmma): S = Q.K^T (and dP =
//    dO.V^T) as m64n64k16 with both operands read from shared memory by
//    descriptor, P.V (and dS.K) as m64nDk16 with P (dS) as the register A
//    operand and V (K) read MN-major from shared memory;
//  * the online softmax (forward) and the p/ds recompute (dq) run on the
//    S and dP accumulators, with row max and sum reduced over the 4 lanes
//    of a row by shuffles, and P and dS are rounded to bf16 in place into
//    the A fragments of the next product: the accumulator layout of two
//    neighbouring n8 column tiles is the A layout of a k16 step;
//  * O (forward) and dQ (dq) accumulate in registers; the forward rescales
//    O there by exp(m_prev - m_new) between its P.V products;
//  * K/V tiles arrive through a two-stage cp.async ring: tile j+1 loads
//    while tile j's products run; a fence.proxy.async makes the copies
//    visible to the products' reads;
//  * tiles use the 128-byte-swizzled layout the descriptors read (d >= 64;
//    core matrices at d 32), written by the copies themselves, so a
//    product's shared-memory reads spread over the banks;
//  * the grid's x axis is walked backwards, so the causal band's heaviest
//    query tiles are issued first and the tail of the launch is short.
// Softmax exps are exp2 of log2e-scaled scores; lse is written back in
// natural log. The block holds 2 x (K, V) and Q (and dO) tiles: 97 KB in
// the forward and 129 KB in dq at d 128, one block an SM. At d 256 the
// forward's 193 KB still fit, but dq's two stages would take 257 KB: its
// K/V ring has one stage there (193 KB), each tile loaded after the
// previous one's products, a simple kernel before a fast one. The O and dQ
// accumulators are 128 floats a thread at d 256.

constexpr int kWgRows = 128;  // query rows a block: two warpgroups of 64
constexpr int kWgThreads = 256;

// The online softmax of one key tile on a warp's S accumulators (rows
// row, row + 8; m unscaled, l this lane's share): masks, updates m and l,
// turns s into p = exp(s*scale - m*scale) and returns alpha = exp(m_prev -
// m_new) for the two rows.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], bool mask,
                                               int row, int k0, int col_lane,
                                               int sk, int offset,
                                               int causal, float scale2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (mask && !attends(row + (e >> 1) * 8, k0 + j * 8 + col_lane +
                           (e & 1), sk, offset, causal)) {
        s[4 * j + e] = kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float ms[2];
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
}

// P (float32, the accumulator layout) as the A fragments of the four k16
// steps of P.V, rounded to bf16.
__device__ __forceinline__ void pack_p(const float (&p)[32],
                                       uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q, 2 x (K, V), and room to align the tiles to 1024 bytes
  return sizeof(bf16) * (kWgRows + 4 * kBK) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int sq, int sk, int n_rep,
                           float scale, int causal) {
  constexpr int kTile = kBK * D;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* sK = sQ + kWgRows * D;  // two stages
  bf16* sV = sK + 2 * kTile;    // two stages

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;  // heaviest first
  const int warp = threadIdx.x >> 5;  // rows 16 warp.. of the block
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;           // rows 64 wg.. of the block
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal, kWgRows);
  const int row = q0 + warp * 16 + (lane >> 2);
  const int col_lane = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;

  load_tile_async<D, kWgRows>(sQ, q + qoff, q0, sq, ldq);
  if (n_kb > 0) {
    load_tile_async<D, kBK>(sK, k + koff, 0, sk, ldk);
    load_tile_async<D, kBK>(sV, v + koff, 0, sk, ldk);
  }
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  // this warpgroup's 64 rows of the Q tile
  const uint32_t tQ = smem_u32(sQ) + wg * 64 * (kSwizzled<D> ? 128 : D * 2);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    const bf16* tK = sK + (kb & 1) * kTile;
    const bf16* tV = sV + (kb & 1) * kTile;
    if (kb + 1 < n_kb) {  // the next tile loads while this one computes
      load_tile_async<D, kBK>(sK + ((kb + 1) & 1) * kTile, k + koff,
                              k0 + kBK, sk, ldk);
      load_tile_async<D, kBK>(sV + ((kb + 1) & 1) * kTile, v + koff,
                              k0 + kBK, sk, ldk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kb (and Q)
    fence_async_shared();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(s, kmajor_desc<D, kWgRows>(tQ, kk),
                   kmajor_desc<D, kBK>(smem_u32(tK), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    float alpha[2];
    online_softmax(s, m, l, alpha,
                   tile_needs_mask(q0, k0, sk, offset, causal), row, k0,
                   col_lane, sk, offset, causal, scale2);
    uint32_t pa[kBK / 16][4];
    pack_p(s, pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_rs<D>(o, pa[kk], mnmajor_desc<D, kBK>(smem_u32(tV), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
    __syncthreads();  // every warp is done with this stage before its refill
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
    bf16* dst = out + qoff + static_cast<int64_t>(r) * ldq + col_lane;
    const float inv = 1.0f / sum;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    if ((lane & 3) == 0) {
      lse[row_off + r] =
          (m[i] == kNegInf ? kNegInf : m[i] * scale) + logf(sum);
    }
  }
}

// Stages of dq's K/V ring: two, but one at d 256, where two do not fit.
template <int D>
constexpr int kDqStages = D > 128 ? 1 : 2;

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, the stages of (K, V), and room to align the tiles to 1024 bytes
  return sizeof(bf16) * (2 * kWgRows + 2 * kDqStages<D> * kBK) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int sq, int sk,
                              int n_rep, float scale, int causal) {
  constexpr int kTile = kBK * D;  // elements of one K or V tile
  constexpr int kStages = kDqStages<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* sO = sQ + kWgRows * D;        // dO
  bf16* sK = sO + kWgRows * D;        // kStages stages
  bf16* sV = sK + kStages * kTile;    // kStages stages

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal, kWgRows);
  const int row = q0 + warp * 16 + (lane >> 2);
  const int col_lane = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;
  const uint32_t wg_rows = wg * 64 * (kSwizzled<D> ? 128 : D * 2);
  const uint32_t tQ = smem_u32(sQ) + wg_rows;
  const uint32_t tO = smem_u32(sO) + wg_rows;

  load_tile_async<D, kWgRows>(sQ, q + qoff, q0, sq, ldq);
  load_tile_async<D, kWgRows>(sO, dout + qoff, q0, sq, ldq);
  if (kStages == 2 && n_kb > 0) {
    load_tile_async<D, kBK>(sK, k + koff, 0, sk, ldk);
    load_tile_async<D, kBK>(sV, v + koff, 0, sk, ldk);
  }
  cp_async_commit();

  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    lse2[i] = r < sq ? lse[row_off + r] * kLog2e : 0.0f;
    dl[i] = r < sq ? delta[row_off + r] : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    const int stage = kStages == 2 ? (kb & 1) : 0;
    const bf16* tK = sK + stage * kTile;
    const bf16* tV = sV + stage * kTile;
    if (kStages == 1) {  // this tile, into the stage the last one freed
      load_tile_async<D, kBK>(sK, k + koff, k0, sk, ldk);
      load_tile_async<D, kBK>(sV, v + koff, k0, sk, ldk);
    } else if (kb + 1 < n_kb) {  // the next tile loads while this one computes
      load_tile_async<D, kBK>(sK + ((kb + 1) & 1) * kTile, k + koff,
                              k0 + kBK, sk, ldk);
      load_tile_async<D, kBK>(sV + ((kb + 1) & 1) * kTile, v + koff,
                              k0 + kBK, sk, ldk);
    }
    cp_async_commit();
    // every group but the newest (two stages) or all of them (one): tile
    // kb, and Q and dO
    cp_async_wait<kStages - 1>();
    fence_async_shared();
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.0f;
      dp[i] = 0.0f;
    }
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S = Q.K^T
      wgmma_ss_n64(s, kmajor_desc<D, kWgRows>(tQ, kk),
                   kmajor_desc<D, kBK>(smem_u32(tK), kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO.V^T
      wgmma_ss_n64(dp, kmajor_desc<D, kWgRows>(tO, kk),
                   kmajor_desc<D, kBK>(smem_u32(tV), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    const bool mask = tile_needs_mask(q0, k0, sk, offset, causal);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const bool valid =
          !mask || attends(row + h * 8, k0 + (i >> 2) * 8 + col_lane + (i & 1),
                           sk, offset, causal);
      const float p = valid ? exp2f(s[i] * scale2 - lse2[h]) : 0.0f;
      s[i] = valid ? p * (dp[i] - dl[h]) * scale : 0.0f;  // ds
    }
    uint32_t pa[kBK / 16][4];
    pack_p(s, pa);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // dQ += dS.K, K read MN-major
      wgmma_rs<D>(acc, pa[kk], mnmajor_desc<D, kBK>(smem_u32(tK), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    if (r >= sq) continue;
    bf16* dst = dq + qoff + static_cast<int64_t>(r) * ldq + col_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------- key-stationary mainloop
//
// flash_bwd_dkv_kernel (bf16): the twin of the query-stationary mainloop
// with the roles of queries and keys swapped. One block of two warpgroups
// owns 128 keys of one kv head (warpgroup g keys 64g..64g+63); K and V
// stay in shared memory, and the 64-row Q and dO tiles, with their lse and
// delta, stream past them through a two-stage cp.async ring, for each of
// the n_rep query heads of the kv head in turn. dK and dV accumulate in
// registers (float32) and are written once: no atomics, deterministic.
//
// Per query tile, for the warpgroup's 64 keys (products as m64nNk16 wgmma):
//  * S^T = K.Q^T and dP^T = V.dO^T (N 64): A is the warpgroup's K (V)
//    rows, B the Q (dO) tile, both K-major, the forward's descriptors with
//    the roles swapped;
//  * P^T = exp2(S^T*scale*log2e - lse*log2e) and dS^T = P^T*(dP^T -
//    delta)*scale on the accumulators in float32, each lane reading the lse
//    and delta of its 16 query columns from shared memory; P stays float32
//    until dS is formed, as the reference's _recompute_p_ds (:142);
//  * dV += P^T.dO and dK += dS^T.Q (N = d): the A operand is P^T (dS^T)
//    rounded to bf16 in registers, the B operand the dO (Q) tile read
//    MN-major: the one shared tile serves both of its reads, as K does in
//    dq.
// Masks go only on tiles that cross the causal diagonal (end-aligned,
// offset sk - sq) or hold query rows past sq; the first query tile of a
// head is the first whose band reaches the block's first key. Blocks are
// issued key tile by key tile across every (kv head, batch), so those with
// the lowest keys (the most query tiles under causal) start first on every
// head: the packed layout's 256 blocks of 4 heads each at the 8B shape
// took 0.48 ms issued head by head and 0.33 ms so (H100 SXM).
//
// Budgets at d 128: registers dK 64 + dV 64 + S^T 32 + dP^T 32 floats a
// thread, then 32 for the packed P^T and dS^T operands; shared memory K, V
// 64 KB + two stages of Q and dO 64 KB + lse/delta 1 KB, one block an SM.
// At d 256, dK and dV for 64 keys do not fit in registers: both
// warpgroups take the same 64 keys, recompute the same S^T and dP^T, and
// each accumulates one 128-column half of dK and dV (1.5x the products);
// shared memory 193 KB.

template <int D>
constexpr int kDkvKeys = D > 128 ? 64 : 128;  // keys a block

template <int D>
constexpr int kDkvCols = D > 128 ? D / 2 : D;  // dK/dV columns a warpgroup

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, two stages of Q and dO, two of lse and delta, and room to align
  // the tiles to 1024 bytes
  return sizeof(bf16) * (2 * kDkvKeys<D> + 4 * kBQ) * D +
         sizeof(float) * 4 * kBQ + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                         int sk, int n_rep, float scale, int causal) {
  constexpr int kKeys = kDkvKeys<D>;
  constexpr int kCols = kDkvCols<D>;
  constexpr int kTile = kBQ * D;  // elements of one Q or dO tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* sV = sK + kKeys * D;
  bf16* sQ = sV + kKeys * D;   // two stages
  bf16* sO = sQ + 2 * kTile;   // dO, two stages
  // two stages of [lse | delta], kBQ floats each
  float* sRow = reinterpret_cast<float*>(sO + 2 * kTile);

  // launch order: key tile-major over every (kv head, batch)
  const int n_kv = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + n_kv * blockIdx.z);
  const int hb = lin % (n_kv * gridDim.z);
  const int g = hb % n_kv;  // kv head
  const int batch = hb / n_kv;
  const int k0 = lin / (n_kv * gridDim.z) * kKeys;
  const int heads = n_kv * n_rep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(n_kv) * D;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk + g * D;
  const int offset = sk - sq;
  // the warpgroup's keys (its accumulator rows) and dK/dV columns
  const int wg_key = kKeys == 128 ? 64 * wg : 0;
  const int col0 = kCols == D ? 0 : kCols * wg;
  const int key = k0 + wg_key + (warp & 3) * 16 + (lane >> 2);
  const int col_lane = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;

  // first query tile whose causal band reaches this block's first key
  int qb0 = 0;
  if (causal) {
    const int need = k0 - offset - (kBQ - 1);
    qb0 = need <= 0 ? 0 : (need + kBQ - 1) / kBQ;
  }
  const int n_qb = (sq + kBQ - 1) / kBQ;
  const int per_head = n_qb > qb0 ? n_qb - qb0 : 0;
  const int n_tiles = n_rep * per_head;  // query tiles of every head

  // Query tile `it` (head g*n_rep + it / per_head) into ring stage `stage`.
  auto load_query_tile = [&](int it, int stage) {
    const int head = g * n_rep + it / per_head;
    const int q0 = (qb0 + it % per_head) * kBQ;
    const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
    load_tile_async<D, kBQ>(sQ + stage * kTile, q + qoff, q0, sq, ldq);
    load_tile_async<D, kBQ>(sO + stage * kTile, dout + qoff, q0, sq, ldq);
    if (threadIdx.x < 2 * kBQ) {  // lse, then delta; zeros past sq
      const int i = threadIdx.x % kBQ;
      const float* src = threadIdx.x < kBQ ? lse : delta;
      const bool valid = q0 + i < sq;
      const int64_t row =
          (static_cast<int64_t>(batch) * heads + head) * sq + q0 + i;
      cp_async4(smem_u32(sRow + stage * 2 * kBQ + threadIdx.x),
                valid ? src + row : src, valid);
    }
  };

  load_tile_async<D, kKeys>(sK, k + koff, k0, sk, ldk);
  load_tile_async<D, kKeys>(sV, v + koff, k0, sk, ldk);
  if (n_tiles > 0) load_query_tile(0, 0);
  cp_async_commit();

  float acc_dk[kCols / 2], acc_dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    acc_dk[i] = 0.0f;
    acc_dv[i] = 0.0f;
  }
  const uint32_t tK = smem_u32(sK) + row_offset<D>(wg_key);
  const uint32_t tV = smem_u32(sV) + row_offset<D>(wg_key);
  // the warpgroup's column blocks of the Q and dO tiles (d 256 only)
  const uint32_t col_off = col0 / 64 * kBQ * 128;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int q0 = (qb0 + it % per_head) * kBQ;
    cp_async_wait<0>();  // tile it (and K, V)
    fence_async_shared();
    __syncthreads();  // ... for every thread; and stage ^ 1 is free
    if (it + 1 < n_tiles) load_query_tile(it + 1, stage ^ 1);
    cp_async_commit();

    const uint32_t tQ = smem_u32(sQ + stage * kTile);
    const uint32_t tO = smem_u32(sO + stage * kTile);
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.0f;
      dp[i] = 0.0f;
    }
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S^T = K.Q^T
      wgmma_ss_n64(s, kmajor_desc<D, kKeys>(tK, kk),
                   kmajor_desc<D, kBQ>(tQ, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // dP^T = V.dO^T
      wgmma_ss_n64(dp, kmajor_desc<D, kKeys>(tV, kk),
                   kmajor_desc<D, kBQ>(tO, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    // rows are keys, columns queries: p^T and ds^T in place
    const float* row_lse = sRow + stage * 2 * kBQ;
    const float* row_delta = row_lse + kBQ;
    const bool mask =
        q0 + kBQ > sq || (causal && k0 + kKeys - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const int c = 8 * j + col_lane;
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
        const float p = valid ? exp2f(fmaf(s[i], scale2, -lv * kLog2e)) : 0.0f;
        dp[i] = valid ? p * (dp[i] - dl) * scale : 0.0f;  // ds
        s[i] = p;
      }
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    pack_p(s, pa);
    pack_p(dp, da);
    fence_operands(acc_dv);
    fence_operands(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {  // dV += P^T.dO, dO MN-major
      wgmma_rs<kCols>(acc_dv, pa[kk], mnmajor_desc<D, kBQ>(tO + col_off, kk));
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {  // dK += dS^T.Q, Q MN-major
      wgmma_rs<kCols>(acc_dk, da[kk], mnmajor_desc<D, kBQ>(tQ + col_off, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc_dv);
    fence_operands(acc_dk);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key + i * 8;
    if (r >= sk) continue;
    const int64_t at = koff + static_cast<int64_t>(r) * ldk + col0 + col_lane;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + j * 8) =
          pack_bf16(acc_dk[4 * j + 2 * i], acc_dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + j * 8) =
          pack_bf16(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
    }
  }
}

// ----------------------------------------------------------------- float32
//
// flash_fwd_f32_kernel: one block owns BQ query rows of one head (64, or
// 16 where the 64-row tiles alone would not make a wave of 128 blocks: the
// host plan, flash_attention.py `f32_fwd_tile`) and walks the 64-key
// tiles of its kv head. Bound on an H100: float32 operations (67 TFLOP/s
// on the CUDA cores; no TF32, which keeps ~3 digits). What the design does
// about it:
//  * Rows go to row groups of 16 lanes, R rows a thread (8 at 64 rows, 4
//    there at d 256, 1 at 16 rows: 128, 256 and 256 threads). Thread (ty,
//    tx) = (tid / 16, tid % 16) owns rows R ty .. R ty + R - 1: their
//    scores at keys tx + 16j (j < 4), their softmax state (m, l) and their
//    output at columns 4tx + 64c (D / 16 of them; 2tx, 2tx + 1 at d 32).
//    The row max and sum are four __shfl_xor_sync steps over the 16 lanes,
//    and m, l and the rescale of O by alpha stay in registers.
//  * S = Q.K^T reads Q and K as stored ([rows][d], d-contiguous, as in
//    memory): each step takes 4 d of the thread's R rows and 4 keys as R +
//    4 float4s for 16R FMAs (at R 8, 12 loads for 128 FMAs; the first SIMT
//    design made 8 scalar loads for 16). Nothing is transposed, so K needs
//    no second buffer and no transposing pass. A half-warp reads one Q
//    address (a broadcast) and 16 key rows: K's 16-byte chunks are
//    XOR-swizzled by key & 7 and Q's by (row / R) & 7, so those reads
//    spread over all 8 bank groups with no padding.
//  * P.V reduces over keys, and V [keys][d] is already k-major for it: per
//    key, R p (float4s) and D / 64 float4s of V for R D / 16 FMAs. P goes
//    through shared memory, since a row's 64 p are spread over its 16
//    lanes; each warp's 2R rows have their own [64][2R] buffer, which only
//    that warp reads.
//  * Two slots, K and V, filled in turn by 16-byte cp.async, one barrier a
//    slot: V(j) loads while S(j) and the softmax run, K(j + 1) while P.V(j)
//    runs (the first K and V come together). At d 128 and 64 rows a block
//    holds 112 KB (Q, the two slots, P) and 254 registers a thread: two
//    blocks an SM. 4 rows a thread (256 threads) spilled at the 128
//    registers two such blocks allow and was 12% slower (PERF.md).
//  * Exps are exp2 of log2e-scaled scores (m is kept unscaled); while a
//    row's max is still -1e30 its p is set to 0 by an explicit test, and
//    lse is written in natural log, -1e30 for a row that saw no key.
//
// dq and dk/dv (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel) take
// the forward's design with each kernel's own side stationary. A block
// owns BT rows of its side (dq: query rows of one head; dk/dv: keys of one
// kv head; 64, or 16 where the 64-row tiles alone would not make a wave of
// 128 blocks: the host plan, flash_attention.py `f32_fwd_tile` and
// `f32_dkv_tile`) and streams the other side past them in tiles of kBS
// (32) rows through two cp.async slots. Bound on an H100: float32
// operations (dq 3 products, dk/dv 4). What the design does about it:
//  * The block's own rows go to row groups of a quarter-warp (L = 8 lanes),
//    R a thread (4 at 64 own rows, 2 there at d 256, 1 at 16: 128, 256 and
//    128 threads). Thread (ty, tx) owns rows R ty .. R ty + R - 1, the
//    streamed rows tx + 8j (j < 4) of each tile, and output columns 4tx +
//    32c.
//  * The two score products (dq: S = Q.K^T and dP = dO.V^T; dk/dv: S^T =
//    K.Q^T and dP^T = V.dO^T) read d-contiguous float4s of both operands
//    as stored: the own rows' 16-byte chunks XOR-swizzled by (row / R) & 7
//    (one address a row group), the streamed rows' by row & 7 (8 rows over
//    8 lanes), so no operand is ever transposed and no tile is padded.
//    Counting four shared-memory wavefronts for a warp's float4 load (one
//    a quarter-warp), broadcast or not, a step of 4 d costs 4 (R + 4)
//    wavefronts for 16 R FMAs a thread: the square 4 x 4 patch of
//    quarter-warp groups against the 8 x 2 of half-warp ones took dk/dv
//    from 5.23 to 4.80 ms at the 8B shape (PERF.md).
//  * p = exp2(s scale log2e - lse log2e) and ds = p (dp - delta) scale are
//    elementwise (no row reduction). On a pair of tiles that holds an entry
//    no row may attend (`pair_needs_mask`: a row past sq, a key past sk,
//    the causal band) p is selected to 0 there, never multiplied to 0: a
//    row that sees no key has lse -1e30, and its exp overflows. A pair
//    without such an entry holds only rows that see keys.
//  * The accumulating products (dq += dS.K; dv += P^T.dO, dk += dS^T.Q)
//    reduce over the streamed rows: dS (and P) go through a per-warp buffer
//    [kBS][the warp's 4R own rows], no barrier of its own, and each
//    streamed row is read by the thread's column chunks at their swizzled
//    place (chunk tx + 8c at (tx + 8c) ^ (row & 7), conflict-free).
//  * dq: Q and dO are loaded once; K(j) loads while dP(j) runs and V(j + 1)
//    while S(j), dS and dS.K(j) run: two barriers a key tile. dk/dv: K and
//    V are loaded once; Q (with lse) and dO (with delta) walk the query
//    tiles of the n_rep query heads of its kv head, in order; dO(j) loads
//    while S^T(j) runs and Q(j + 1) while dv += P^T.dO(j) runs: three
//    barriers a query tile (Q is read by the first product and the last
//    but one). At d 128 and 64 own rows a dq block holds 104 KB and a dk/dv
//    block 112.25 KB: two blocks of four warps an SM (252 and 255
//    registers a thread).
//  * No atomics: each block writes its rows once, every sum in a fixed
//    order, so two calls give the same bits.

// The float32 forward's rows a thread at query tile BQ (flash_attention.py
// F32_FWD_TILES). At 16 rows, one row a thread keeps each thread's serial
// work (the time of a launch that fills few SMs) small; at d 256, 8 rows'
// outputs would not fit in registers.
template <int D, int BQ>
constexpr int kFwdRows = BQ >= 64 ? (D > 128 ? 4 : 8) : 1;
template <int D, int BQ>
constexpr int kFwdF32Threads = 16 * BQ / kFwdRows<D, BQ>;
// the Q.K^T and P.V loops' unroll (the fastest of 2, 4 and 8 at d 128)
constexpr int kFwdUnrollD = 2;
constexpr int kFwdUnrollKeys = 8;

template <int D, int BQ>
constexpr size_t fwd_f32_smem_bytes() {
  // Q, the K and V slots, and each warp's P [64][2 * rows]
  return sizeof(float) * (BQ * D + 2 * kBK * D + BQ * kBK);
}

// Rows [row0, row0 + kRows) of an [n, D] float32 matrix (rows ld apart)
// into a [kRows][D] tile by cp.async, 16-byte chunk c of row r at chunk
// c ^ swizzle(r); rows >= n zero-filled.
template <int D, int kRows, int kThreads, typename Swizzle>
__device__ __forceinline__ void load_rows_async_f32(float* tile,
                                                    const float* src,
                                                    int row0, int n,
                                                    int64_t ld,
                                                    Swizzle swizzle) {
  constexpr int kChunks = kRows * D / 4;
#pragma unroll
  for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (kChunks % kThreads != 0 && e >= kChunks) break;
    const int r = e / (D / 4);
    const int c = e % (D / 4);
    const bool valid = row0 + r < n;
    const int64_t at = valid ? (static_cast<int64_t>(row0) + r) * ld + 4 * c
                             : 0;
    cp_async16(smem_u32(tile + r * D + 4 * (c ^ swizzle(r))), src + at,
               valid);
  }
}

// R (8, 4 or 1) consecutive floats of shared memory, 4R-byte aligned: as
// float4s where R is a multiple of 4.
template <int R>
__device__ __forceinline__ void load_floats(const float* p, float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = p[i];
  }
}

template <int R>
__device__ __forceinline__ void store_floats(float* p, const float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = x[i];
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kFwdF32Threads<D, BQ>, D > 128 ? 1 : 2)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int sq, int sk, int n_rep,
                         float scale, int causal) {
  constexpr int R = kFwdRows<D, BQ>;  // rows a thread
  constexpr int kThreads = kFwdF32Threads<D, BQ>;
  constexpr int kCols = D / 16;  // output columns a thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * D;
  float* sV = sK + kBK * D;
  // this warp's P: [64 keys][its 2R rows]
  float* sP = sV + kBK * D + (threadIdx.x >> 5) * kBK * 2 * R;

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int ty = threadIdx.x >> 4;  // rows R ty .. R ty + R - 1
  const int tx = threadIdx.x & 15;  // keys tx + 16j
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal, BQ);
  const float scale2 = scale * kLog2e;
  const auto q_swizzle = [](int r) { return (r / R) & 7; };
  const auto k_swizzle = [](int r) { return r & 7; };
  const auto no_swizzle = [](int) { return 0; };

  // Q, and the first K and V tiles
  load_rows_async_f32<D, BQ, kThreads>(sQ, q + qoff, q0, sq, ldq,
                                       q_swizzle);
  if (n_kb > 0) {
    load_rows_async_f32<D, kBK, kThreads>(sK, k + koff, 0, sk, ldk,
                                          k_swizzle);
    load_rows_async_f32<D, kBK, kThreads>(sV, v + koff, 0, sk, ldk,
                                          no_swizzle);
  }
  cp_async_commit();

  float o[R][kCols];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }
  const float* q_rows = sQ + R * ty * D;  // row R ty + i at i * D
  const float* k_rows = sK + tx * D;      // key tx + 16j at 16j * D
  const int xq = q_swizzle(R * ty);
  const int xk = k_swizzle(tx);
  const int pr = R * (ty & 1);  // this thread's rows in its warp's P

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    cp_async_wait<0>();
    // K(kb) is in; every thread is past P.V(kb - 1), so V's slot is free
    __syncthreads();
    if (kb > 0) {  // V(0) came with K(0)
      load_rows_async_f32<D, kBK, kThreads>(sV, v + koff, k0, sk, ldk,
                                            no_swizzle);
    }
    cp_async_commit();

    float s[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll kFwdUnrollD
    for (int c = 0; c < D / 4; ++c) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(k_rows + 16 * j * D +
                                                 4 * (c ^ xk));
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_rows + i * D + 4 * (c ^ xq));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // the online softmax, row by row over the half-warp's 16 lanes
    const bool mask = tile_needs_mask(q0, k0, sk, offset, causal);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + R * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mask && !attends(row, k0 + tx + 16 * j, sk, offset, causal)) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int lanes = 1; lanes < 16; lanes <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lanes));
      }
      const float alpha = exp2f((m[i] - mx) * scale2);
      m[i] = mx;
      // a row that has seen no key yet keeps p = 0 (and so out 0)
      const bool none = mx == kNegInf;
      const float ms = mx * scale2;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = none ? 0.0f : exp2f(fmaf(s[i][j], scale2, -ms));
        sum += s[i][j];
      }
#pragma unroll
      for (int lanes = 1; lanes < 16; lanes <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = s[i][j];
      store_floats<R>(sP + (tx + 16 * j) * 2 * R + pr, p);
    }

    cp_async_wait<0>();
    // V(kb) and every warp's P are in; every thread is past S(kb), so K's
    // slot is free
    __syncthreads();
    if (kb + 1 < n_kb) {
      load_rows_async_f32<D, kBK, kThreads>(sK, k + koff, k0 + kBK, sk,
                                            ldk, k_swizzle);
    }
    cp_async_commit();
#pragma unroll kFwdUnrollKeys
    for (int key = 0; key < kBK; ++key) {
      float p[R];
      load_floats<R>(sP + key * 2 * R + pr, p);
      const float* v_row = sV + key * D;
      float vv[kCols];
      if constexpr (kCols >= 4) {
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(
              v_row + 4 * (tx + 16 * c));
          vv[4 * c] = x.x;
          vv[4 * c + 1] = x.y;
          vv[4 * c + 2] = x.z;
          vv[4 * c + 3] = x.w;
        }
      } else {
        const float2 x = *reinterpret_cast<const float2*>(v_row + 2 * tx);
        vv[0] = x.x;
        vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + R * ty + i;
    if (r >= sq) continue;
    const float sum = fmaxf(l[i], 1e-30f);
    const float inv = 1.0f / sum;
    float* dst = out + qoff + static_cast<int64_t>(r) * ldq;
    if constexpr (kCols >= 4) {
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        *reinterpret_cast<float4*>(dst + 4 * (tx + 16 * c)) =
            make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv,
                        o[i][4 * c + 2] * inv, o[i][4 * c + 3] * inv);
      }
    } else {
      *reinterpret_cast<float2*>(dst + 2 * tx) =
          make_float2(o[i][0] * inv, o[i][1] * inv);
    }
    if (tx == 0) {
      lse[row_off + r] =
          (m[i] == kNegInf ? kNegInf : m[i] * scale) + logf(sum);
    }
  }
}

// The float32 dq and dk/dv stream the other side in tiles of kBS rows
// (flash_attention.py F32_BWD_STREAM).
constexpr int kBS = 32;

// Own rows go to row groups of a quarter-warp, kBwdLanes lanes: a 4 x 4
// score patch a thread at 64 own rows. At block tile BT
// (flash_attention.py F32_FWD_TILES): own rows a thread, threads.
constexpr int kBwdLanes = 8;
constexpr int kBwdCols = kBS / kBwdLanes;  // streamed rows a thread a tile
template <int D, int BT>
constexpr int kBwdRows = BT >= 64 ? (D > 128 ? 2 : 4) : 1;
template <int D, int BT>
constexpr int kBwdThreads = kBwdLanes * BT / kBwdRows<D, BT>;
// the score products' d loop unroll: dq's the fastest of 1, 2 and 4 at d
// 128; dk/dv's the most that spills nothing there (4 spilled)
constexpr int kDqUnrollD = 4;
constexpr int kDkvUnrollD = 2;

// Whether query rows [q0, q0 + rows) and keys [k0, k0 + keys) hold an entry
// that is not attended: a row past sq, a key past sk, or a key past the
// causal band of the first row (flash_attention.py `bwd_tile_needs_mask`).
__device__ __forceinline__ bool pair_needs_mask(int q0, int rows, int k0,
                                                int keys, int sq, int sk,
                                                int offset, int causal) {
  return q0 + rows > sq || k0 + keys > sk ||
         (causal && k0 + keys - 1 > q0 + offset);
}

// c[i][j] = A[own row i] . B[streamed row L j] over D (L = kBwdLanes):
// `a` at the thread's first own row (rows D apart, chunks ^ xa), `b` at
// its first streamed row (chunks ^ xb); the d loop unrolled U times.
template <int D, int R, int U>
__device__ __forceinline__ void own_dot_streamed(const float* a, int xa,
                                                 const float* b, int xb,
                                                 float (&c)[R][kBwdCols]) {
  constexpr int L = kBwdLanes;
  constexpr int J = kBwdCols;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) c[i][j] = 0.0f;
  }
#pragma unroll U
  for (int ch = 0; ch < D / 4; ++ch) {
    float4 bv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(b + L * j * D +
                                               4 * (ch ^ xb));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(a + i * D + 4 * (ch ^ xa));
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

// acc[i][c] += sum over the kBS streamed rows r of w[r][own row i] x
// T[r][the thread's column c]: `w` this warp's [kBS][(32 / L) R] buffer
// at the thread's own rows, `t` a [kBS][D] tile of chunks swizzled by
// r & 7. The thread's columns are chunks tx + Lc.
template <int D, int R>
__device__ __forceinline__ void weights_times_streamed(
    const float* w, const float* t, float (&acc)[R][D / kBwdLanes]) {
  constexpr int L = kBwdLanes;
  constexpr int kCols = D / L;
  const int tx = threadIdx.x % L;
#pragma unroll kFwdUnrollKeys
  for (int r = 0; r < kBS; ++r) {
    float x[R];
    load_floats<R>(w + r * (32 / L) * R, x);
    const float* row = t + r * D;
    const int xr = r & 7;
    float tv[kCols];
#pragma unroll
    for (int c = 0; c < kCols / 4; ++c) {
      const float4 y =
          *reinterpret_cast<const float4*>(row + 4 * ((tx + L * c) ^ xr));
      tv[4 * c] = y.x;
      tv[4 * c + 1] = y.y;
      tv[4 * c + 2] = y.z;
      tv[4 * c + 3] = y.w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(x[i], tv[c], acc[i][c]);
    }
  }
}

// The thread's own rows row0 + R ty + i (those below n) of acc into an
// output whose rows are ld apart, at the thread's columns.
template <int D, int R>
__device__ __forceinline__ void store_own_rows(
    float* dst, const float (&acc)[R][D / kBwdLanes], int row0, int n,
    int64_t ld) {
  constexpr int L = kBwdLanes;
  const int ty = threadIdx.x / L;
  const int tx = threadIdx.x % L;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + R * ty + i;
    if (r >= n) continue;
    float* p = dst + static_cast<int64_t>(r) * ld;
#pragma unroll
    for (int c = 0; c < D / L / 4; ++c) {
      *reinterpret_cast<float4*>(p + 4 * (tx + L * c)) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                      acc[i][4 * c + 3]);
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }
}

template <int D, int BQ>
constexpr size_t dq_f32_smem_bytes() {
  // Q and dO, the K and V slots, and each warp's dS [kBS][its own rows]
  return sizeof(float) * (2 * BQ * D + 2 * kBS * D + BQ * kBS);
}

template <int D, int BQ>
__global__ void __launch_bounds__(kBwdThreads<D, BQ>, D > 128 ? 1 : 2)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int sq, int sk, int n_rep,
                            float scale, int causal) {
  constexpr int R = kBwdRows<D, BQ>;  // query rows a thread
  constexpr int L = kBwdLanes;
  constexpr int J = kBwdCols;
  constexpr int kWarpRows = 32 / L * R;
  constexpr int kThreads = kBwdThreads<D, BQ>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + BQ * D;
  float* sK = sO + BQ * D;
  float* sV = sK + kBS * D;
  // this warp's dS: [kBS keys][its kWarpRows rows]
  float* sDS = sV + kBS * D + (threadIdx.x >> 5) * kBS * kWarpRows;

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int ty = threadIdx.x / L;  // rows R ty .. R ty + R - 1
  const int tx = threadIdx.x % L;  // keys tx + L j
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal, BQ, kBS);
  const float scale2 = scale * kLog2e;
  const auto own_swizzle = [](int r) { return (r / R) & 7; };
  const auto streamed_swizzle = [](int r) { return r & 7; };

  // Q, dO and the first V tile (K(0) follows at the first barrier)
  load_rows_async_f32<D, BQ, kThreads>(sQ, q + qoff, q0, sq, ldq,
                                       own_swizzle);
  load_rows_async_f32<D, BQ, kThreads>(sO, dout + qoff, q0, sq, ldq,
                                       own_swizzle);
  if (n_kb > 0) {
    load_rows_async_f32<D, kBS, kThreads>(sV, v + koff, 0, sk, ldk,
                                          streamed_swizzle);
  }
  cp_async_commit();

  // each row's log2e-scaled lse and its delta (0 past sq)
  float lse2[R], dlt[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + R * ty + i;
    lse2[i] = r < sq ? lse[row_off + r] * kLog2e : 0.0f;
    dlt[i] = r < sq ? delta[row_off + r] : 0.0f;
  }
  float acc[R][D / L];
  zero(acc);
  const float* q_rows = sQ + R * ty * D;
  const float* o_rows = sO + R * ty * D;
  const int xo = own_swizzle(R * ty);
  const int xs = streamed_swizzle(tx);
  const int pr = R * (ty % (32 / L));  // this thread's rows in its warp's dS

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBS;
    cp_async_wait<0>();
    // V(kb) is in; every thread is past dS.K(kb - 1), so K's slot is free
    __syncthreads();
    load_rows_async_f32<D, kBS, kThreads>(sK, k + koff, k0, sk, ldk,
                                          streamed_swizzle);
    cp_async_commit();
    float dp[R][J];
    own_dot_streamed<D, R, kDqUnrollD>(o_rows, xo, sV + tx * D, xs, dp);

    cp_async_wait<0>();
    // K(kb) is in; every thread is past dP(kb), so V's slot is free
    __syncthreads();
    if (kb + 1 < n_kb) {
      load_rows_async_f32<D, kBS, kThreads>(sV, v + koff, k0 + kBS, sk, ldk,
                                            streamed_swizzle);
    }
    cp_async_commit();
    float s[R][J];
    own_dot_streamed<D, R, kDqUnrollD>(q_rows, xo, sK + tx * D, xs, s);
    const bool mask = pair_needs_mask(q0, BQ, k0, kBS, sq, sk, offset, causal);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + R * ty + i;
        const bool valid =
            !mask || (row < sq && attends(row, k0 + tx + L * j, sk, offset,
                                          causal));
        const float p =
            valid ? exp2f(fmaf(s[i][j], scale2, -lse2[i])) : 0.0f;
        ds[i] = p * (dp[i][j] - dlt[i]) * scale;
      }
      store_floats<R>(sDS + (tx + L * j) * kWarpRows + pr, ds);
    }
    __syncwarp();
    weights_times_streamed<D, R>(sDS + pr, sK, acc);  // dq += dS.K
  }
  cp_async_wait<0>();
  store_own_rows<D, R>(dq + qoff, acc, q0, sq, ldq);
}

template <int D, int BK>
constexpr size_t dkv_f32_smem_bytes() {
  // K and V, the Q and dO slots, each warp's P^T and dS^T [kBS][its own
  // keys], and the lse and delta slots
  return sizeof(float) * (2 * BK * D + 2 * kBS * D + 2 * BK * kBS + 2 * kBS);
}

template <int D, int BK>
__global__ void __launch_bounds__(kBwdThreads<D, BK>, D > 128 ? 1 : 2)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int sq, int sk, int n_rep, float scale,
                             int causal) {
  constexpr int R = kBwdRows<D, BK>;  // keys a thread
  constexpr int L = kBwdLanes;
  constexpr int J = kBwdCols;
  constexpr int kWarpRows = 32 / L * R;
  constexpr int kThreads = kBwdThreads<D, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BK * D;
  float* sQ = sV + BK * D;
  float* sO = sQ + kBS * D;
  // this warp's P^T and dS^T: [kBS query rows][its kWarpRows keys] each
  float* sPt = sO + kBS * D + (threadIdx.x >> 5) * kBS * kWarpRows;
  float* sDSt = sPt + BK * kBS;
  float* sLse = sO + kBS * D + 2 * BK * kBS;
  float* sDelta = sLse + kBS;

  const int g = blockIdx.y;  // kv head
  const int n_kv = gridDim.y;
  const int heads = n_kv * n_rep;
  const int batch = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / L;  // keys k0 + R ty .. R ty + R - 1
  const int tx = threadIdx.x % L;  // query rows tx + L j of a tile
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(n_kv) * D;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk + g * D;
  const int offset = sk - sq;
  const float scale2 = scale * kLog2e;
  const auto own_swizzle = [](int r) { return (r / R) & 7; };
  const auto streamed_swizzle = [](int r) { return r & 7; };
  // Each query head's tiles from the first that holds a row attending key
  // k0 (rows >= k0 - offset); tile t is head g n_rep + t / per_head's
  // tile qt0 + t % per_head.
  const int first_row = causal ? max(k0 - offset, 0) : 0;
  const int qt0 = first_row / kBS;
  const int per_head = max((sq + kBS - 1) / kBS - qt0, 0);
  const int n_t = n_rep * per_head;
  const auto tile_q0 = [&](int t) { return (qt0 + t % per_head) * kBS; };
  // Q with lse, or dO with delta, of tile t; rows past sq zero-filled
  const auto load_tile = [&](float* rows, float* vec, const float* src,
                             const float* vsrc, int t) {
    const int head = g * n_rep + t / per_head;
    const int q0 = tile_q0(t);
    load_rows_async_f32<D, kBS, kThreads>(
        rows, src + static_cast<int64_t>(batch) * sq * ldq + head * D, q0,
        sq, ldq, streamed_swizzle);
    const int i = threadIdx.x;
    if (i < kBS) {
      const bool valid = q0 + i < sq;
      const int64_t at =
          (static_cast<int64_t>(batch) * heads + head) * sq + q0 + i;
      cp_async4(smem_u32(vec + i), vsrc + (valid ? at : 0), valid);
    }
  };

  // K and V once, and the first Q tile
  load_rows_async_f32<D, BK, kThreads>(sK, k + koff, k0, sk, ldk,
                                       own_swizzle);
  load_rows_async_f32<D, BK, kThreads>(sV, v + koff, k0, sk, ldk,
                                       own_swizzle);
  if (n_t > 0) load_tile(sQ, sLse, q, lse, 0);
  cp_async_commit();

  float acc_dk[R][D / L], acc_dv[R][D / L];
  zero(acc_dk);
  zero(acc_dv);
  const float* k_rows = sK + R * ty * D;
  const float* v_rows = sV + R * ty * D;
  const int xo = own_swizzle(R * ty);
  const int xs = streamed_swizzle(tx);
  const int pr = R * (ty % (32 / L));  // this thread's keys in its buffers

  for (int t = 0; t < n_t; ++t) {
    const int q0 = tile_q0(t);
    cp_async_wait<0>();
    // Q(t) and lse(t) are in; every thread is past dv(t - 1), so dO's slot
    // is free
    __syncthreads();
    load_tile(sO, sDelta, dout, delta, t);
    cp_async_commit();
    float p[R][J];  // S^T, then P^T
    own_dot_streamed<D, R, kDkvUnrollD>(k_rows, xo, sQ + tx * D, xs,
                                           p);
    const bool mask = pair_needs_mask(q0, kBS, k0, BK, sq, sk, offset, causal);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int row = q0 + tx + L * j;
      const float l2 = sLse[tx + L * j] * kLog2e;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool valid =
            !mask || (row < sq && attends(row, k0 + R * ty + i, sk, offset,
                                          causal));
        p[i][j] = valid ? exp2f(fmaf(p[i][j], scale2, -l2)) : 0.0f;
      }
    }

    cp_async_wait<0>();
    // dO(t) and delta(t) are in
    __syncthreads();
    float dp[R][J];
    own_dot_streamed<D, R, kDkvUnrollD>(v_rows, xo, sO + tx * D, xs,
                                           dp);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float dl = sDelta[tx + L * j];
      float pc[R], dc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pc[i] = p[i][j];
        dc[i] = p[i][j] * (dp[i][j] - dl) * scale;
      }
      store_floats<R>(sPt + (tx + L * j) * kWarpRows + pr, pc);
      store_floats<R>(sDSt + (tx + L * j) * kWarpRows + pr, dc);
    }
    __syncwarp();
    weights_times_streamed<D, R>(sDSt + pr, sQ, acc_dk);  // dk += dS^T.Q
    // every thread is past dk(t), so Q's slot is free
    __syncthreads();
    if (t + 1 < n_t) load_tile(sQ, sLse, q, lse, t + 1);
    cp_async_commit();
    weights_times_streamed<D, R>(sPt + pr, sO, acc_dv);  // dv += P^T.dO
  }
  cp_async_wait<0>();
  store_own_rows<D, R>(dk + koff, acc_dk, k0, sk, ldk);
  store_own_rows<D, R>(dv + koff, acc_dv, k0, sk, ldk);
}

// ------------------------------------------------------------------ launch

// What every launch shares: the grid's head and batch axes within their
// 65535 limit, n_rep dividing the heads, and the dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int batch, int heads,
                    int n_rep) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 ||
      n_rep < 1 || heads % n_rep) {
    return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launches `kernel` over (tiles of `tile` of `rows`, grid_heads, batch)
// after prepare(); returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int rows,
                   int tile, int grid_heads, int batch, int heads, int n_rep,
                   cudaStream_t s, Args... args) {
  cudaError_t err = prepare(kernel, smem, batch, heads, n_rep);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + tile - 1) / tile, grid_heads, batch);
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// launch() for a float32 kernel: two 64-row blocks of the forward, dq or
// dk/dv at d 128 need all of the SM's shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_f32(Kernel kernel, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch(kernel, args...);
}

// The float32 forward at query tile BQ.
template <int D, int BQ>
cudaError_t launch_fwd_f32(const float* q, const float* k, const float* v,
                           float* out, float* lse, int batch, int heads,
                           int n_rep, int sq, int sk, float scale, int causal,
                           cudaStream_t s) {
  return launch_f32(flash_fwd_f32_kernel<D, BQ>, fwd_f32_smem_bytes<D, BQ>(),
                    kFwdF32Threads<D, BQ>, sq, BQ, heads, batch, heads, n_rep,
                    s, q, k, v, out, lse, sq, sk, n_rep, scale, causal);
}

// The float32 dk/dv at key tile BK and dq at query tile BQ.
template <int D, int BK>
cudaError_t launch_dkv_f32(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, float* dk, float* dv,
                           int batch, int heads, int n_rep, int sq, int sk,
                           float scale, int causal, cudaStream_t s) {
  return launch_f32(flash_bwd_dkv_f32_kernel<D, BK>,
                    dkv_f32_smem_bytes<D, BK>(), kBwdThreads<D, BK>, sk, BK,
                    heads / n_rep, batch, heads, n_rep, s, q, k, v, dout, lse,
                    delta, dk, dv, sq, sk, n_rep, scale, causal);
}

template <int D, int BQ>
cudaError_t launch_dq_f32(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* delta, float* dq, int batch, int heads,
                          int n_rep, int sq, int sk, float scale, int causal,
                          cudaStream_t s) {
  return launch_f32(flash_bwd_dq_f32_kernel<D, BQ>, dq_f32_smem_bytes<D, BQ>(),
                    kBwdThreads<D, BQ>, sq, BQ, heads, batch, heads, n_rep, s,
                    q, k, v, dout, lse, delta, dq, sq, sk, n_rep, scale,
                    causal);
}

// `tile`: the float32 forward's query tile (64 or 16, flash_attention.py
// `f32_fwd_tile`); the bf16 forward ignores it.
template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int batch, int heads, int n_rep, int sq,
                       int sk, float scale, int causal, int tile,
                       cudaStream_t s) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  float* ll = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 2) {
    return launch(flash_fwd_kernel<D>, fwd_smem_bytes<D>(), kWgThreads, sq,
                  kWgRows, heads, batch, heads, n_rep, s, qq, kk, vv, oo, ll,
                  sq, sk, n_rep, scale, causal);
  } else {
    switch (tile) {
      case 64: return launch_fwd_f32<D, 64>(qq, kk, vv, oo, ll, batch, heads, n_rep, sq, sk, scale, causal, s);
      case 16: return launch_fwd_f32<D, 16>(qq, kk, vv, oo, ll, batch, heads, n_rep, sq, sk, scale, causal, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

// `tile`: the float32 dk/dv's key tile (64 or 16, flash_attention.py
// `f32_dkv_tile`); the bf16 dk/dv ignores it.
template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int heads, int n_rep,
                       int sq, int sk, float scale, int causal, int tile,
                       cudaStream_t s) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  const float* ll = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  T* dkk = static_cast<T*>(dk);
  T* dvv = static_cast<T*>(dv);
  if constexpr (sizeof(T) == 2) {
    return launch(flash_bwd_dkv_kernel<D>, dkv_smem_bytes<D>(), kWgThreads,
                  sk, kDkvKeys<D>, heads / n_rep, batch, heads, n_rep, s, qq,
                  kk, vv, dd, ll, de, dkk, dvv, sq, sk, n_rep, scale, causal);
  } else {
    switch (tile) {
      case 64: return launch_dkv_f32<D, 64>(qq, kk, vv, dd, ll, de, dkk, dvv, batch, heads, n_rep, sq, sk, scale, causal, s);
      case 16: return launch_dkv_f32<D, 16>(qq, kk, vv, dd, ll, de, dkk, dvv, batch, heads, n_rep, sq, sk, scale, causal, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

// `tile`: the float32 dq's query tile (64 or 16, flash_attention.py
// `f32_fwd_tile`); the bf16 dq ignores it.
template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int heads, int n_rep, int sq,
                      int sk, float scale, int causal, int tile,
                      cudaStream_t s) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  const float* ll = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  T* dqq = static_cast<T*>(dq);
  if constexpr (sizeof(T) == 2) {
    return launch(flash_bwd_dq_kernel<D>, dq_smem_bytes<D>(), kWgThreads,
                  sq, kWgRows, heads, batch, heads, n_rep, s, qq, kk, vv, dd,
                  ll, de, dqq, sq, sk, n_rep, scale, causal);
  } else {
    switch (tile) {
      case 64: return launch_dq_f32<D, 64>(qq, kk, vv, dd, ll, de, dqq, batch, heads, n_rep, sq, sk, scale, causal, s);
      case 16: return launch_dq_f32<D, 16>(qq, kk, vv, dd, ll, de, dqq, batch, heads, n_rep, sq, sk, scale, causal, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, int batch, int heads, int n_rep, int sq, int sk,
              int d, float scale, int causal, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_fwd<32, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 64: return launch_fwd<64, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 128: return launch_fwd<128, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 256: return launch_fwd<256, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              int batch, int heads, int n_rep, int sq, int sk, int d,
              float scale, int causal, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 64: return launch_dkv<64, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 128: return launch_dkv<128, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 256: return launch_dkv<256, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int batch,
             int heads, int n_rep, int sq, int sk, int d, float scale,
             int causal, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq<32, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 64: return launch_dq<64, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 128: return launch_dq<128, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    case 256: return launch_dq<256, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [batch, sq, heads*d], k/v [batch, sk, (heads/n_rep)*d] row-major, bf16
// (rt_flash_*) or float32 (rt_flash_*_f32); out like q; lse [batch, heads,
// sq] float32. [b*h, s, d] operands are batch = b*h, heads = n_rep = 1. d
// is 32, 64, 128 or 256. Returns a CUDA error code (0 = ok).
int rt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int batch, int heads, int n_rep, int sq, int sk,
                 int d, float scale, int causal, void* stream) {
  return fwd_entry<bf16>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                         scale, causal, 0, stream);
}

// The float32 forward also takes its query tile, 64 or 16
// (flash_attention.py `f32_fwd_tile`).
int rt_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int heads, int n_rep, int sq,
                     int sk, int d, float scale, int causal, int tile,
                     void* stream) {
  return fwd_entry<float>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                          scale, causal, tile, stream);
}

// dO like q, lse/delta [batch, heads, sq] float32; dk/dv like k.
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int batch, int heads, int n_rep,
                     int sq, int sk, int d, float scale, int causal,
                     void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                         n_rep, sq, sk, d, scale, causal, 0, stream);
}

// The float32 dk/dv also takes its key tile, 64 or 16 (flash_attention.py
// `f32_dkv_tile`).
int rt_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int batch, int heads, int n_rep,
                         int sq, int sk, int d, float scale, int causal,
                         int tile, void* stream) {
  return dkv_entry<float>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                          n_rep, sq, sk, d, scale, causal, tile, stream);
}

// dq like q.
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int batch, int heads, int n_rep, int sq, int sk,
                    int d, float scale, int causal, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                        sq, sk, d, scale, causal, 0, stream);
}

// The float32 dq also takes its query tile, 64 or 16 (flash_attention.py
// `f32_fwd_tile`).
int rt_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int batch, int heads, int n_rep, int sq,
                        int sk, int d, float scale, int causal, int tile,
                        void* stream) {
  return dq_entry<float>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                         sq, sk, d, scale, causal, tile, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
