// Softmax cross-entropy over [N, V] logits: the forward (loss and the
// row's logsumexp) and the backward (softmax - onehot) * g, with no softmax
// tensor stored.
//
// xent_fwd replaces the TPU kernel _fwd_kernel
// (ray_tpu/ops/pallas/xent.py:28); xent_bwd replaces _bwd_kernel
// (ray_tpu/ops/pallas/xent.py:59).
//
// What bounds them on an H100: device-memory bytes. The forward reads the
// logits once (4 bytes an element in float32) for ~4 float operations and
// one exp; the backward reads them again and writes dx. At the Llama-3-8B
// shape [4096, 128256] in float32 that is 2.10 GB (0.627 ms at 3.35 TB/s)
// and 4.20 GB (1.255 ms).
//
// Design (simple and right first):
//  * One 256-thread block per row, grid-stride over rows. On the TPU the
//    vocabulary axis is a sequential grid axis carrying (max, sumexp,
//    correct logit) in scratch memory from block to block; here a loop
//    inside the block takes its place. Each thread keeps an online (m, l)
//    over a strided set of columns (16 bytes a turn: 4 float32 or 8 bf16,
//    one rescale a turn), then the block merges the pairs with warp
//    shuffles and one shared-memory step. Only real columns are read, so
//    the vocabulary tail (128256 = 62 * 2048 + 1280) needs no mask; a
//    thread that saw no column keeps the reference's (-1e30, 0), which
//    merges away exactly.
//  * The reference's constants: m starts at -1e30 (not -inf), lse = m +
//    log(max(l, 1e-30)), loss = lse - c with c = logits[row, label] in
//    float32 when 0 <= label < V and 0 otherwise (the one non-zero term of
//    the reference's masked sum; a label >= V is treated as a negative one).
//  * The backward is one block per row too: p = exp(x - lse[row]) for each
//    real column, minus 1 at the label, times g[row] in float32, rounded
//    once to the logits' type.
//  * 16-byte loads and stores when the wrapper says V is a multiple of the
//    vector width and the pointers are 16-byte aligned; a scalar loop takes
//    the rest. IEEE expf and logf (no --use_fast_math).
//  * 64-bit offsets: [4096, 128256] float32 logits are 2.1 GB, and a bf16
//    batch of 16800 rows passes 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1 << 20;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// (m, l) <- the merge of (m, l) and (m2, l2): l scaled to the larger max.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd(const T* __restrict__ logits, const int* __restrict__ labels,
             float* __restrict__ loss, float* __restrict__ lse_out,
             int64_t rows, int64_t v, int vectorized) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  constexpr int kN = Vec<T>::kN;
  const int64_t nvec = vectorized ? v / kN : 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = logits + row * v;
    float m = kNegInf, l = 0.0f;
#pragma unroll 4
    for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[k];
      float f[kN];
      float bm = m;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        f[i] = to_f32(a.v[i]);
        bm = fmaxf(bm, f[i]);
      }
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kN; ++i) s += expf(f[i] - bm);
      l = l * expf(m - bm) + s;
      m = bm;
    }
    for (int64_t j = nvec * kN + threadIdx.x; j < v; j += kThreads) {
      const float f = to_f32(xr[j]);
      const float mn = fmaxf(m, f);
      l = l * expf(m - mn) + expf(f - mn);
      m = mn;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      merge(m, l, m2, l2);
    }
    if ((threadIdx.x & 31) == 0) {
      sm_m[threadIdx.x >> 5] = m;
      sm_l[threadIdx.x >> 5] = l;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      m = sm_m[0];
      l = sm_l[0];
      for (int w = 1; w < kWarps; ++w) merge(m, l, sm_m[w], sm_l[w]);
      const float lse = m + logf(fmaxf(l, 1e-30f));
      const int label = labels[row];
      const float c =
          (label >= 0 && label < v) ? to_f32(xr[label]) : 0.0f;
      lse_out[row] = lse;
      loss[row] = lse - c;
    }
    __syncthreads();  // sm_m and sm_l are reused by the block's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd(const T* __restrict__ logits, const int* __restrict__ labels,
             const float* __restrict__ lse, const float* __restrict__ g,
             T* __restrict__ dx, int64_t rows, int64_t v, int vectorized) {
  constexpr int kN = Vec<T>::kN;
  const int64_t nvec = vectorized ? v / kN : 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = logits + row * v;
    T* dxr = dx + row * v;
    const float s = lse[row];
    const float gr = g[row];
    // a label outside [0, V) matches no column
    const int64_t label = labels[row];
#pragma unroll 4
    for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[k];
      Vec<T> o;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float p = expf(to_f32(a.v[i]) - s);
        const float onehot = (k * kN + i == label) ? 1.0f : 0.0f;
        o.v[i] = from_f32<T>((p - onehot) * gr);
      }
      reinterpret_cast<Vec<T>*>(dxr)[k] = o;
    }
    for (int64_t j = nvec * kN + threadIdx.x; j < v; j += kThreads) {
      const float p = expf(to_f32(xr[j]) - s);
      const float onehot = (j == label) ? 1.0f : 0.0f;
      dxr[j] = from_f32<T>((p - onehot) * gr);
    }
  }
}

int grid_for(int64_t rows) {
  return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
}

}  // namespace

extern "C" {

// logits: [rows, v] float32 (is_bf16 == 0) or bfloat16; labels: [rows]
// int32; loss, lse: [rows] float32. vectorized != 0 requires v %
// (16 / sizeof(logits)) == 0 and a 16-byte aligned logits pointer (the
// caller checks). Returns cudaGetLastError() after the launch.
int rt_xent_fwd(const void* logits, const void* labels, void* loss,
                void* lse, int is_bf16, int vectorized, int64_t rows,
                int64_t v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    xent_fwd<bf16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const bf16*>(logits), static_cast<const int*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), rows, v,
        vectorized);
  } else {
    xent_fwd<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), rows, v,
        vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits, dx: [rows, v] of one type (is_bf16); labels: [rows] int32; lse,
// g: [rows] float32; vectorized as for rt_xent_fwd (dx aligned too).
int rt_xent_bwd(const void* logits, const void* labels, const void* lse,
                const void* g, void* dx, int is_bf16, int vectorized,
                int64_t rows, int64_t v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    xent_bwd<bf16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const bf16*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<bf16*>(dx), rows, v, vectorized);
  } else {
    xent_bwd<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(dx), rows, v, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
