// Flash attention for the training step: the forward and the two backward
// kernels, bf16 operands with float32 accumulation and softmax state.
//
// flash_fwd_kernel replaces the TPU kernel _fwd_kernel
// (ray_tpu/ops/pallas/flash_attention.py:38) in both of its calls, over
// [b*h, s, d] (_flash_fwd :104) and over the packed [b, s, h*d] layout
// (_flash_fwd_packed :376); flash_bwd_dkv_kernel replaces _bwd_dkv_kernel
// (:181) and flash_bwd_dq_kernel replaces _bwd_dq_kernel (:224), both built
// on the recompute of _recompute_p_ds (:142), in _flash_bwd (:276, :303)
// and in _flash_bwd_packed (:442, :480).
//
// What bounds them on an H100: tensor-core operations. At the Llama-3-8B
// training shape (b*h = 64, s = 2048, head_dim 128, causal) each product
// costs 2*bh*s*s*hd/2 = 3.44e10 FLOP against ~100 MB of operands, a few
// hundred FLOP per byte, above the card's ~295 FLOP/byte balance point. The
// forward does 2 products (bound 0.069 ms at 989 TFLOP/s), dk/dv 4 and dq 3.
//
// Design (simple and right first; wgmma/TMA are later work):
//  * One block of 4 warps owns one 64-row output tile and loops over the
//    reduction axis inside the block (the TPU's sequential grid axis does
//    not exist here). No atomics: forward and dq blocks own query tiles,
//    dk/dv blocks own key tiles, so results are deterministic.
//  * Tiles are staged through shared memory; the products run on
//    nvcuda::wmma 16x16x16 bf16 fragments with float32 accumulators. Each
//    warp owns 16 rows of every 64-row tile.
//  * Scores, probabilities and the softmax state stay float32; p and ds are
//    rounded to bf16 only as operands of the accumulating products, as the
//    TPU kernels cast them.
//  * Causal masks are end-aligned (key col <= row + sk - sq) and key blocks
//    entirely above the band are skipped; the ragged key tail is masked with
//    -1e30, and rows past sq or sk are zero-filled when a tile is loaded, so
//    no product ever reads garbage (0 * NaN would poison a sum).
//  * The forward keeps its output accumulator in shared memory and rescales
//    it by exp(m_prev - m_new) before each P.V product; l >= 1e-30 guards
//    rows that saw no key.
//  * One layout serves both calls: q, dO, out and dq are [b, sq, heads*D]
//    and k, v, dk, dv [b, sk, (heads/n_rep)*D], lse and delta
//    [b, heads, sq]. The grid's y axis is the head and z the batch; a
//    block finds its head's rows by strides (row stride heads*D on the
//    query side, (heads/n_rep)*D on the key side), so [b*h, s, d] is the
//    case heads = 1, n_rep = 1 and no transpose is ever made. Each head's
//    slice of a row is D*2 bytes (64-256), so the 16-byte loads stay
//    whole. Offsets are 64-bit.
//  * GQA by index: query head h reads kv head h / n_rep, and K/V are never
//    repeated. A dk/dv block owns one key tile of one kv head and walks the
//    query tiles of all n_rep query heads that share it, accumulating in
//    its float32 fragments and writing once (no atomics; the causal skip
//    of the first query tiles applies per head). The [b*h, s, d] callers
//    pass K/V repeated per query head and sum dk/dv over the groups
//    afterwards, as the reference's unpacked path does.
//
// Head dims 32, 64 and 128 are instantiated; the caller checks the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

constexpr int kLdS = kBK + 4;  // float32 score tiles
constexpr int kLdP = kBK + 8;  // bf16 probability tiles

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copies rows [row0, row0 + rows) of an [n, D] bf16 matrix whose rows lie
// ld elements apart into a [rows][D + 8] shared tile with 16-byte moves;
// rows >= n become zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n, int rows,
                                          int64_t ld) {
  constexpr int kVec = D / 8;
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(
          src + (static_cast<int64_t>(row0) + r) * ld + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Loads n_rows float32 values starting at row0 (zeros past n).
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    dst[i] = (row0 + i < n) ? src[row0 + i] : 0.0f;
  }
}

// C[16][kBK] = A[16][D] * B[kBK][D]^T for one warp: A is the warp's 16 rows
// of a [.][D + 8] tile, B a [kBK][D + 8] tile, C float32 with stride kLdS.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const bf16* a_rows,
                                                  const bf16* b_tile,
                                                  float* c_rows) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBt b;
      wmma::load_matrix_sync(a, a_rows + kk * 16, kLd);
      wmma::load_matrix_sync(b, b_tile + j * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c_rows + j * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// Index of the first key block past the causal band of query rows
// [q0, q0 + kBQ): key block kb is needed iff kb*kBK <= q0 + kBQ - 1 + offset.
__device__ __forceinline__ int key_blocks(int q0, int sk, int offset,
                                          int causal) {
  int n = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + kBQ - 1 + offset;
    const int lim = last < 0 ? 0 : last / kBK + 1;
    n = n < lim ? n : lim;
  }
  return n;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * (kBQ + 2 * kBK) * (D + 8)     // Q, K, V
         + sizeof(float) * kBQ * kLdS                 // scores
         + sizeof(bf16) * kBQ * kLdP                  // probabilities
         + sizeof(float) * kBQ * (D + 4)              // output accumulator
         + sizeof(float) * 3 * kBQ;                   // m, l, alpha
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int n_rep,
                     float scale, int causal) {
  constexpr int kLdT = D + 8;
  constexpr int kLdO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * kLdT;
  bf16* sV = sK + kBK * kLdT;
  float* sS = reinterpret_cast<float*>(sV + kBK * kLdT);
  bf16* sP = reinterpret_cast<bf16*>(sS + kBQ * kLdS);
  float* sO = reinterpret_cast<float*>(sP + kBQ * kLdP);
  float* sM = sO + kBQ * kLdO;
  float* sL = sM + kBQ;
  float* sAlpha = sL + kBQ;

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;

  load_rows<D>(sQ, q + qoff, q0, sq, kBQ, ldq);
  for (int i = threadIdx.x; i < kBQ * kLdO; i += kThreads) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }

  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal);
  // softmax layout: two lanes per row, 32 columns each
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int row = q0 + r;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sK, k + koff, k0, sk, kBK, ldk);
    load_rows<D>(sV, v + koff, k0, sk, kBK, ldk);
    __syncthreads();
    rows_times_tile_t<D>(sQ + warp * 16 * kLdT, sK, sS + warp * 16 * kLdS);
    __syncwarp();

    const float* srow = sS + r * kLdS + half * 32;
    float s[32];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      const bool valid = col < sk && (!causal || col <= row + offset);
      s[c] = valid ? srow[c] * scale : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = sM[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
    bf16* prow = sP + r * kLdP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(s[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_prev - m_new);
    __syncwarp();  // both lanes of the row have read sM
    if (half == 0) {
      sM[r] = m_new;
      sL[r] = sL[r] * alpha + sum;
      sAlpha[r] = alpha;
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = warp * 16 + i / D;
      sO[rr * kLdO + i % D] *= sAlpha[rr];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragC acc;
      float* o_frag = sO + warp * 16 * kLdO + j * 16;
      wmma::load_matrix_sync(acc, o_frag, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sP + warp * 16 * kLdP + kk * 16, kLdP);
        wmma::load_matrix_sync(b, sV + kk * 16 * kLdT + j * 16, kLdT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_frag, acc, kLdO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int rr = i / D;
    if (q0 + rr < sq) {
      const float l = fmaxf(sL[rr], 1e-30f);
      out[qoff + (static_cast<int64_t>(q0) + rr) * ldq + i % D] =
          __float2bfloat16_rn(sO[rr * kLdO + i % D] / l);
    }
  }
  for (int rr = threadIdx.x; rr < kBQ; rr += kThreads) {
    if (q0 + rr < sq) {
      lse[row_off + q0 + rr] =
          sM[rr] + logf(fmaxf(sL[rr], 1e-30f));
    }
  }
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (2 * kBQ + 2 * kBK) * (D + 8)  // Q, dO, K, V
         + sizeof(float) * 2 * kBQ * kLdS              // scores, dP
         + sizeof(bf16) * 2 * kBQ * kLdP               // P, dS
         + sizeof(float) * 2 * kBQ;                    // lse, delta
}

// Shared layout of the two backward kernels.
template <int D>
struct BwdTiles {
  bf16* q;
  bf16* dout;
  bf16* k;
  bf16* v;
  float* s;
  float* dp;
  bf16* p;
  bf16* ds;
  float* lse;
  float* delta;
  __device__ explicit BwdTiles(unsigned char* smem) {
    constexpr int kLdT = D + 8;
    q = reinterpret_cast<bf16*>(smem);
    dout = q + kBQ * kLdT;
    k = dout + kBQ * kLdT;
    v = k + kBK * kLdT;
    s = reinterpret_cast<float*>(v + kBK * kLdT);
    dp = s + kBQ * kLdS;
    p = reinterpret_cast<bf16*>(dp + kBQ * kLdS);
    ds = p + kBQ * kLdP;
    lse = reinterpret_cast<float*>(ds + kBQ * kLdP);
    delta = lse + kBQ;
  }
};

// For the warp's 16 query rows of the (q0, k0) tile pair: s = q.k^T and
// dp = dO.v^T, then p = exp(s*scale - lse) and ds = p*(dp - delta)*scale on
// the valid entries (0 elsewhere), written as bf16 to t.p (if want_p) and
// t.ds.
template <int D>
__device__ __forceinline__ void recompute_p_ds(const BwdTiles<D>& t, int q0,
                                               int k0, int sq, int sk,
                                               float scale, int causal,
                                               bool want_p) {
  constexpr int kLdT = D + 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  rows_times_tile_t<D>(t.q + warp * 16 * kLdT, t.k, t.s + warp * 16 * kLdS);
  rows_times_tile_t<D>(t.dout + warp * 16 * kLdT, t.v,
                       t.dp + warp * 16 * kLdS);
  __syncwarp();
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int row = q0 + r;
  const int offset = sk - sq;
  const float lse = t.lse[r];
  const float delta = t.delta[r];
  const float* srow = t.s + r * kLdS + half * 32;
  const float* dprow = t.dp + r * kLdS + half * 32;
  bf16* prow = t.p + r * kLdP + half * 32;
  bf16* dsrow = t.ds + r * kLdP + half * 32;
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const int col = k0 + half * 32 + c;
    const bool valid = row < sq && col < sk &&
                       (!causal || col <= row + offset);
    const float p = valid ? expf(srow[c] * scale - lse) : 0.0f;
    const float ds = valid ? p * (dprow[c] - delta) * scale : 0.0f;
    if (want_p) prow[c] = __float2bfloat16_rn(p);
    dsrow[c] = __float2bfloat16_rn(ds);
  }
}

// Writes a float32 [rows][D + 4] staging tile as bf16 rows [row0, n) of a
// matrix whose rows lie ld elements apart.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float* stage,
                                           int row0, int n, int rows,
                                           int64_t ld) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    if (row0 + r < n) {
      dst[(static_cast<int64_t>(row0) + r) * ld + i % D] =
          __float2bfloat16_rn(stage[r * (D + 4) + i % D]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                         int sk, int n_rep, float scale, int causal) {
  constexpr int kLdT = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  BwdTiles<D> t(smem);
  const int g = blockIdx.y;  // kv head
  const int n_kv = gridDim.y;
  const int heads = n_kv * n_rep;
  const int batch = blockIdx.z;
  const int k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x >> 5;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(n_kv) * D;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk + g * D;

  load_rows<D>(t.k, k + koff, k0, sk, kBK, ldk);
  load_rows<D>(t.v, v + koff, k0, sk, kBK, ldk);

  FragC acc_dk[D / 16];
  FragC acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.0f);
    wmma::fill_fragment(acc_dv[j], 0.0f);
  }

  // first query tile whose causal band reaches this key tile
  const int offset = sk - sq;
  int qb0 = 0;
  if (causal) {
    const int need = k0 - offset - (kBQ - 1);
    qb0 = need <= 0 ? 0 : (need + kBQ - 1) / kBQ;
  }
  const int n_qb = (sq + kBQ - 1) / kBQ;
  // every query head of this kv head, each over its query tiles
  for (int r = 0; r < n_rep; ++r) {
    const int head = g * n_rep + r;
    const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
    const int64_t row_off =
        (static_cast<int64_t>(batch) * heads + head) * sq;
    for (int qb = qb0; qb < n_qb; ++qb) {
      const int q0 = qb * kBQ;
      __syncthreads();
      load_rows<D>(t.q, q + qoff, q0, sq, kBQ, ldq);
      load_rows<D>(t.dout, dout + qoff, q0, sq, kBQ, ldq);
      load_vec(t.lse, lse + row_off, q0, sq);
      load_vec(t.delta, delta + row_off, q0, sq);
      __syncthreads();
      recompute_p_ds<D>(t, q0, k0, sq, sk, scale, causal, true);
      __syncthreads();  // every warp reads every query row of p and ds
      // dv += p^T.dO and dk += ds^T.q over this query tile, for the warp's
      // 16 key rows: A(key, query) = p[query][key] is p read column-major.
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        FragAt a_p;
        FragAt a_ds;
        wmma::load_matrix_sync(a_p, t.p + kk * 16 * kLdP + warp * 16, kLdP);
        wmma::load_matrix_sync(a_ds, t.ds + kk * 16 * kLdP + warp * 16,
                               kLdP);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          FragB b_do;
          FragB b_q;
          wmma::load_matrix_sync(b_do, t.dout + kk * 16 * kLdT + j * 16,
                                 kLdT);
          wmma::load_matrix_sync(b_q, t.q + kk * 16 * kLdT + j * 16, kLdT);
          wmma::mma_sync(acc_dv[j], a_p, b_do, acc_dv[j]);
          wmma::mma_sync(acc_dk[j], a_ds, b_q, acc_dk[j]);
        }
      }
    }
  }
  __syncthreads();
  // stage through the (now free) Q/dO/K/V region: [kBK][D + 4] float32 each
  float* stage_k = reinterpret_cast<float*>(smem);
  float* stage_v = stage_k + kBK * (D + 4);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage_k + warp * 16 * (D + 4) + j * 16,
                            acc_dk[j], D + 4, wmma::mem_row_major);
    wmma::store_matrix_sync(stage_v + warp * 16 * (D + 4) + j * 16,
                            acc_dv[j], D + 4, wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<D>(dk + koff, stage_k, k0, sk, kBK, ldk);
  store_rows<D>(dv + koff, stage_v, k0, sk, kBK, ldk);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int sq, int sk, int n_rep,
                        float scale, int causal) {
  constexpr int kLdT = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  BwdTiles<D> t(smem);
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;

  load_rows<D>(t.q, q + qoff, q0, sq, kBQ, ldq);
  load_rows<D>(t.dout, dout + qoff, q0, sq, kBQ, ldq);
  load_vec(t.lse, lse + row_off, q0, sq);
  load_vec(t.delta, delta + row_off, q0, sq);

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int n_kb = key_blocks(q0, sk, sk - sq, causal);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();
    load_rows<D>(t.k, k + koff, k0, sk, kBK, ldk);
    load_rows<D>(t.v, v + koff, k0, sk, kBK, ldk);
    __syncthreads();
    recompute_p_ds<D>(t, q0, k0, sq, sk, scale, causal, false);
    __syncwarp();  // ds rows of this warp are complete
    // dq += ds.k for the warp's 16 query rows
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, t.ds + warp * 16 * kLdP + kk * 16, kLdP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, t.k + kk * 16 * kLdT + j * 16, kLdT);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage + warp * 16 * (D + 4) + j * 16, acc[j],
                            D + 4, wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<D>(dq + qoff, stage, q0, sq, kBQ, ldq);
}

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

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int batch, int heads, int n_rep, int sq,
                       int sk, float scale, int causal, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem, batch, heads, n_rep);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), sq, sk, n_rep, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int heads, int n_rep,
                       int sq, int sk, float scale, int causal,
                       cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err =
      prepare(flash_bwd_dkv_kernel<D>, smem, batch, heads, n_rep);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kBK - 1) / kBK, heads / n_rep, batch);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, n_rep, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int heads, int n_rep, int sq,
                      int sk, float scale, int causal, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, smem, batch, heads,
                            n_rep);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sq, sk, n_rep, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [batch, sq, heads*d], k/v [batch, sk, (heads/n_rep)*d] bf16 row-major;
// out like q; lse [batch, heads, sq] float32. [b*h, s, d] operands are
// batch = b*h, heads = n_rep = 1. d is 32, 64 or 128. Returns a CUDA error
// code (0 = ok).
int rt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int batch, int heads, int n_rep, int sq, int sk,
                 int d, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 64: return launch_fwd<64>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 128: return launch_fwd<128>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dO like q, lse/delta [batch, heads, sq] float32; dk/dv like k.
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int batch, int heads, int n_rep,
                     int sq, int sk, int d, float scale, int causal,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dq like q.
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int batch, int heads, int n_rep, int sq, int sk,
                    int d, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
