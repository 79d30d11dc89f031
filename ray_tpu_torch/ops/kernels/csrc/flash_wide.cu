// Flash attention at head widths above 256: the forward and the two backward
// kernels, bf16 or float32 operands with float32 accumulation and softmax
// state. The narrower widths (up to 256) run the kernels of
// flash_attention.cu; this family takes what those cannot hold.
//
// flash_wide_fwd_kernel replaces the TPU kernel _fwd_kernel
// (ray_tpu/ops/pallas/flash_attention.py:38) at those widths, in both of its
// calls (_flash_fwd :104 over [b*h, s, d], _flash_fwd_packed :376 over the
// packed [b, s, h*d]); flash_wide_dkv_kernel replaces _bwd_dkv_kernel
// (:181) and flash_wide_dq_kernel _bwd_dq_kernel (:224), in _flash_bwd
// (:276, :303) and _flash_bwd_packed (:442, :480). The Pallas blocks take
// any head_dim; these kernels take any multiple of kW (128) columns, and
// the wrapper zero-pads a head to it (flash_attention.py `pad_heads`; the
// caller's scale is kept, so the padded zeros add nothing to any score, to
// dO.V^T or to delta, and the padded output columns come out zero).
//
// What bounds them on an H100: the products. A wide head's output does not
// fit a block's registers, so the design cuts it:
//  * a grid axis over output-width slices of kW columns: a forward or dq
//    block owns kRows query rows of one head and one kW-column slice of O
//    (dQ); a dk/dv block owns kRows keys of one kv head and one slice of
//    both dK and dV;
//  * each block recomputes the score S = Q.K^T (and, in the backward,
//    dP = dO.V^T) over the whole head_dim, chunk by chunk of kW columns,
//    each chunk's partial sum added to the block's float32 accumulators,
//    so no block holds a whole head's width: the score products run once
//    per slice (d / kW times), the price of the cut;
//  * the lse (forward) is written once, by slice 0; the other slices
//    compute the same row statistics and do not store them.
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
// A simple design first (CUDA cores, no wgmma, no TMA): 256 threads; the
// operands of each product pass through shared memory as float32 tiles of
// 32 rows x kW columns padded to kW + 1 (bank-conflict-free reads); a
// score tile is 32 x 32, thread (i, g) = (tid / 8, tid % 8) owning row i
// and columns g + 8j (j < 4), and an output tile 32 x kW, the same thread
// owning row i and columns g + 8c (c < 16). 37,248 bytes (forward, dq) and
// 41,472 (dk/dv) of static shared memory a block; 80, 64 and 128
// registers a thread, no spill (ptxas, sm_90a).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kW = 128;        // the output slice, and a score chunk
constexpr int kRows = 32;      // rows a block owns (queries or keys)
constexpr int kThreads = 256;
constexpr int kLd = kW + 1;    // a padded shared-memory row
constexpr int kLdS = kRows + 1;
constexpr int kOut = kW / 8;   // output columns a thread
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (p and ds as operands of a product)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ bool attends(int row, int col, int sq, int sk,
                                        int offset, int causal) {
  return row < sq && col < sk && (!causal || col <= row + offset);
}

// Key tiles of kRows keys that query rows [q0, q0 + kRows) walk: all of
// sk, or, causal, up to the band of the last row.
__device__ __forceinline__ int key_tiles(int q0, int sk, int offset,
                                         int causal) {
  int n = (sk + kRows - 1) / kRows;
  if (causal) {
    const int last = q0 + kRows - 1 + offset;
    const int lim = last < 0 ? 0 : last / kRows + 1;
    n = n < lim ? n : lim;
  }
  return n;
}

// Columns [c0, c0 + kW) of rows [row0, row0 + kRows) of a row-major matrix
// of n rows (ld elements apart) into tile[kRows][kLd] as float32; rows >= n
// zero-filled, so no product reads garbage.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          int row0, int n, int64_t ld,
                                          int c0) {
  for (int e = threadIdx.x; e < kRows * kW; e += kThreads) {
    const int r = e / kW;
    const int c = e % kW;
    float x = 0.0f;
    if (row0 + r < n) {
      x = to_float(src[static_cast<int64_t>(row0 + r) * ld + c0 + c]);
    }
    tile[r * kLd + c] = x;
  }
}

// acc[j] += a[i] . b[g + 8j] over one chunk (rows of the two tiles).
__device__ __forceinline__ void chunk_dots(const float* a, const float* b,
                                           int i, int g, float (&acc)[4]) {
  const float* ar = a + i * kLd;
#pragma unroll 8
  for (int c = 0; c < kW; ++c) {
    const float x = ar[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j] = fmaf(x, b[(g + 8 * j) * kLd + c], acc[j]);
    }
  }
}

// acc += the score of rows [a0, a0 + kRows) of `a` against rows [b0, b0 +
// kRows) of `b` over the whole head_dim d, a chunk at a time through the
// two shared tiles.
template <typename T>
__device__ __forceinline__ void scores(float* sa, float* sb, const T* a,
                                       int a0, int na, int64_t lda,
                                       const T* b, int b0, int nb,
                                       int64_t ldb, int d, int i, int g,
                                       float (&acc)[4]) {
  for (int c0 = 0; c0 < d; c0 += kW) {
    __syncthreads();  // every thread is done with the tiles' last reads
    load_tile(sa, a, a0, na, lda, c0);
    load_tile(sb, b, b0, nb, ldb, c0);
    __syncthreads();
    chunk_dots(sa, sb, i, g, acc);
  }
}

// out[c] += sum over the tile's rows j of w[i][j] * x[j][g + 8c].
__device__ __forceinline__ void accumulate(const float* w, const float* x,
                                           int i, int g,
                                           float (&out)[kOut]) {
#pragma unroll 4
  for (int j = 0; j < kRows; ++j) {
    const float wj = w[i * kLdS + j];
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      out[c] = fmaf(wj, x[j * kLd + g + 8 * c], out[c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          float* __restrict__ lse, int sq, int sk, int n_rep,
                          int d, float scale, int causal) {
  __shared__ float sA[kRows * kLd];   // a Q chunk
  __shared__ float sB[kRows * kLd];   // a K chunk, then the V slice
  __shared__ float sP[kRows * kLdS];  // p rounded to T

  const int n_slices = d / kW;
  const int slice = blockIdx.x % n_slices;
  // heaviest query tiles first (the causal band's longest rows)
  const int q0 = (gridDim.x / n_slices - 1 - blockIdx.x / n_slices) * kRows;
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * d;
  const T* qb = q + static_cast<int64_t>(batch) * sq * ldq +
                static_cast<int64_t>(head) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(head / n_rep) * d;
  const T* kb = k + koff;
  const T* vb = v + koff;
  const int offset = sk - sq;
  const int i = threadIdx.x >> 3;  // this thread's row of the block
  const int g = threadIdx.x & 7;   // its lane among the row's 8
  const int row = q0 + i;
  const float scale2 = scale * kLog2e;

  float m = kNegInf, l = 0.0f;
  float o[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) o[c] = 0.0f;

  const int n_kt = key_tiles(q0, sk, offset, causal);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kRows;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    scores(sA, sB, qb, q0, sq, ldq, kb, k0, sk, ldk, d, i, g, s);

    // the online softmax over the row's 8 lanes
    float mx = m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!attends(row, k0 + g + 8 * j, sq, sk, offset, causal)) {
        s[j] = kNegInf;
      }
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int lanes = 1; lanes < 8; lanes <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lanes));
    }
    const float alpha = exp2f((m - mx) * scale2);
    m = mx;
    // a row that has seen no key yet keeps p = 0 (and so out 0)
    const bool none = mx == kNegInf;
    const float ms = mx * scale2;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = none ? 0.0f : exp2f(fmaf(s[j], scale2, -ms));
      sum += s[j];
    }
#pragma unroll
    for (int lanes = 1; lanes < 8; lanes <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
    }
    l = l * alpha + sum;
#pragma unroll
    for (int c = 0; c < kOut; ++c) o[c] *= alpha;

    __syncthreads();  // the K chunk's and the last P.V's reads are done
#pragma unroll
    for (int j = 0; j < 4; ++j) sP[i * kLdS + g + 8 * j] = round_to<T>(s[j]);
    load_tile(sB, vb, k0, sk, ldk, slice * kW);
    __syncthreads();
    accumulate(sP, sB, i, g, o);
  }

  if (row < sq) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = out + static_cast<int64_t>(batch) * sq * ldq +
              static_cast<int64_t>(row) * ldq +
              static_cast<int64_t>(head) * d + slice * kW;
#pragma unroll
    for (int c = 0; c < kOut; ++c) orow[g + 8 * c] = from_float<T>(o[c] / lc);
    if (slice == 0 && g == 0) {
      lse[(static_cast<int64_t>(batch) * heads + head) * sq + row] =
          m == kNegInf ? kNegInf : m * scale + logf(lc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int sq, int sk, int n_rep, int d, float scale,
                         int causal) {
  __shared__ float sA[kRows * kLd];   // a Q (dO) chunk
  __shared__ float sB[kRows * kLd];   // a K (V) chunk, then the K slice
  __shared__ float sS[kRows * kLdS];  // ds rounded to T

  const int n_slices = d / kW;
  const int slice = blockIdx.x % n_slices;
  const int q0 = (gridDim.x / n_slices - 1 - blockIdx.x / n_slices) * kRows;
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * d;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                       static_cast<int64_t>(head) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(head / n_rep) * d;
  const int offset = sk - sq;
  const int i = threadIdx.x >> 3;
  const int g = threadIdx.x & 7;
  const int row = q0 + i;
  const float scale2 = scale * kLog2e;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const float lse2 = row < sq ? lse[row_off + row] * kLog2e : 0.0f;
  const float dlt = row < sq ? delta[row_off + row] : 0.0f;

  float acc[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) acc[c] = 0.0f;

  const int n_kt = key_tiles(q0, sk, offset, causal);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kRows;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    scores(sA, sB, q + qoff, q0, sq, ldq, k + koff, k0, sk, ldk, d, i, g, s);
    scores(sA, sB, dout + qoff, q0, sq, ldq, v + koff, k0, sk, ldk, d, i, g,
           dp);
    float ds[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = attends(row, k0 + g + 8 * j, sq, sk, offset, causal);
      const float p = ok ? exp2f(fmaf(s[j], scale2, -lse2)) : 0.0f;
      ds[j] = ok ? p * (dp[j] - dlt) * scale : 0.0f;
    }
    __syncthreads();  // the V chunk's and the last dS.K's reads are done
#pragma unroll
    for (int j = 0; j < 4; ++j) sS[i * kLdS + g + 8 * j] = round_to<T>(ds[j]);
    load_tile(sB, k + koff, k0, sk, ldk, slice * kW);
    __syncthreads();
    accumulate(sS, sB, i, g, acc);
  }

  if (row < sq) {
    T* drow = dq + qoff + static_cast<int64_t>(row) * ldq + slice * kW;
#pragma unroll
    for (int c = 0; c < kOut; ++c) drow[g + 8 * c] = from_float<T>(acc[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int sq,
                          int sk, int n_rep, int d, float scale, int causal) {
  __shared__ float sA[kRows * kLd];   // a K (V) chunk, then the dO slice
  __shared__ float sB[kRows * kLd];   // a Q (dO) chunk, then the Q slice
  __shared__ float sP[kRows * kLdS];  // P^T [key][row] rounded to T
  __shared__ float sD[kRows * kLdS];  // dS^T [key][row] rounded to T

  const int n_slices = d / kW;
  const int slice = blockIdx.x % n_slices;
  // lowest keys first: under causal they walk the most query tiles
  const int k0 = blockIdx.x / n_slices * kRows;
  const int kvh = blockIdx.y;
  const int n_kv = gridDim.y;
  const int heads = n_kv * n_rep;
  const int batch = blockIdx.z;
  const int64_t ldq = static_cast<int64_t>(heads) * d;
  const int64_t ldk = static_cast<int64_t>(n_kv) * d;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk +
                       static_cast<int64_t>(kvh) * d;
  const int offset = sk - sq;
  const int i = threadIdx.x >> 3;  // this thread's key of the block
  const int g = threadIdx.x & 7;   // its lane among the key's 8
  const int key = k0 + i;
  const float scale2 = scale * kLog2e;
  // the first query row that attends key k0 under causal, by tile
  const int first = causal ? max(k0 - offset, 0) / kRows : 0;
  const int n_qt = (sq + kRows - 1) / kRows;

  float adk[kOut], adv[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) adk[c] = adv[c] = 0.0f;

  for (int r = 0; r < n_rep; ++r) {
    const int head = kvh * n_rep + r;
    const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq +
                         static_cast<int64_t>(head) * d;
    const int64_t row_off =
        (static_cast<int64_t>(batch) * heads + head) * sq;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * kRows;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      scores(sA, sB, k + koff, k0, sk, ldk, q + qoff, q0, sq, ldq, d, i, g,
             s);
      scores(sA, sB, v + koff, k0, sk, ldk, dout + qoff, q0, sq, ldq, d, i,
             g, dp);
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + g + 8 * j;
        const bool ok = attends(row, key, sq, sk, offset, causal);
        const float lse2 = ok ? lse[row_off + row] * kLog2e : 0.0f;
        const float dlt = ok ? delta[row_off + row] : 0.0f;
        p[j] = ok ? exp2f(fmaf(s[j], scale2, -lse2)) : 0.0f;
        ds[j] = ok ? p[j] * (dp[j] - dlt) * scale : 0.0f;
      }
      __syncthreads();  // the chunks' and the last products' reads are done
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[i * kLdS + g + 8 * j] = round_to<T>(p[j]);
        sD[i * kLdS + g + 8 * j] = round_to<T>(ds[j]);
      }
      load_tile(sA, dout + qoff, q0, sq, ldq, slice * kW);
      load_tile(sB, q + qoff, q0, sq, ldq, slice * kW);
      __syncthreads();
      accumulate(sP, sA, i, g, adv);  // dV += P^T.dO
      accumulate(sD, sB, i, g, adk);  // dK += dS^T.Q
    }
  }

  if (key < sk) {
    const int64_t at = koff + static_cast<int64_t>(key) * ldk + slice * kW;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dk[at + g + 8 * c] = from_float<T>(adk[c]);
      dv[at + g + 8 * c] = from_float<T>(adv[c]);
    }
  }
}

bool bad_layout(int batch, int heads, int n_rep, int d) {
  return d <= 0 || d % kW != 0 || n_rep <= 0 || heads % n_rep != 0 ||
         batch > 65535 || heads > 65535;
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, int batch, int heads, int n_rep, int sq, int sk,
              int d, float scale, int causal, void* stream) {
  if (bad_layout(batch, heads, n_rep, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + kRows - 1) / kRows * (d / kW), heads, batch);
  flash_wide_fwd_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, n_rep, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              int batch, int heads, int n_rep, int sq, int sk, int d,
              float scale, int causal, void* stream) {
  if (bad_layout(batch, heads, n_rep, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sk + kRows - 1) / kRows * (d / kW), heads / n_rep,
                  batch);
  flash_wide_dkv_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, n_rep, d, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int batch,
             int heads, int n_rep, int sq, int sk, int d, float scale,
             int causal, void* stream) {
  if (bad_layout(batch, heads, n_rep, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + kRows - 1) / kRows * (d / kW), heads, batch);
  flash_wide_dq_kernel<T><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sq, sk, n_rep, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
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
  return fwd_entry<bf16>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                         scale, causal, stream);
}

int rt_flash_wide_fwd_f32(const void* q, const void* k, const void* v,
                          void* out, void* lse, int batch, int heads,
                          int n_rep, int sq, int sk, int d, float scale,
                          int causal, void* stream) {
  return fwd_entry<float>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                          scale, causal, stream);
}

// dO like q, lse/delta [batch, heads, sq] float32; dk/dv like k.
int rt_flash_wide_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int batch,
                          int heads, int n_rep, int sq, int sk, int d,
                          float scale, int causal, void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                         n_rep, sq, sk, d, scale, causal, stream);
}

int rt_flash_wide_bwd_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              int batch, int heads, int n_rep, int sq,
                              int sk, int d, float scale, int causal,
                              void* stream) {
  return dkv_entry<float>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                          n_rep, sq, sk, d, scale, causal, stream);
}

// dq like q.
int rt_flash_wide_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, int batch, int heads,
                         int n_rep, int sq, int sk, int d, float scale,
                         int causal, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                        sq, sk, d, scale, causal, stream);
}

int rt_flash_wide_bwd_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int batch,
                             int heads, int n_rep, int sq, int sk, int d,
                             float scale, int causal, void* stream) {
  return dq_entry<float>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                         sq, sk, d, scale, causal, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
