// Fused RMSNorm: the forward (out and rstd) and the backward's dx.
//
// rmsnorm_fwd replaces the TPU kernel _fwd_kernel
// (ray_tpu/ops/pallas/rmsnorm.py:25); rmsnorm_bwd_dx replaces _bwd_dx_kernel
// (ray_tpu/ops/pallas/rmsnorm.py:33). dw stays a plain reduction in the
// wrapper, as the reference leaves it to XLA (rmsnorm.py:104-106).
//
// What bounds them on an H100: device-memory bytes. The forward reads x and
// writes out (4 bytes an element in bf16) for ~4 float operations; the dx
// pass reads x and g and writes dx (6 bytes) for ~8. At [4096, 4096] bf16
// that is 67.1 MB (0.020 ms at 3.35 TB/s) and 100.7 MB (0.030 ms).
//
// Design (simple and right first):
//  * One 256-thread block per row, grid-stride over rows; no 256-row blocks
//    as on the TPU, so a ragged row count needs nothing.
//  * Pass 1 reduces the row in float32 (sum of x^2, or of w*g*x) with warp
//    shuffles and one shared-memory step; every thread then adds the warp
//    partials in the same order, so all threads hold the same sum. Pass 2
//    reads the row again (8 KB at d 4096 in bf16, still in L1/L2) and
//    writes the output. Rows are never staged in shared memory.
//  * 16-byte loads and stores (8 bf16 or 4 float32 a thread) when the
//    wrapper says the row length is a multiple of that width and every
//    pointer is 16-byte aligned; a scalar loop takes whatever is left (the
//    whole row otherwise, e.g. d = 130).
//  * The reference's arithmetic: var = sum(x^2) / d, rstd = 1 / sqrt(var +
//    eps) with IEEE sqrt and division (no --use_fast_math), out = (x * rstd)
//    * w in float32 rounded once; proj = sum(w*g*x) / d as a division (not a
//    multiply by 1/d), dx = rstd * (w*g - x * rstd * rstd * proj) with every
//    operation of the epilogue an explicitly rounded intrinsic, so nvcc
//    contracts no multiply-add that the reference does not have.
//  * 64-bit offsets throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1 << 20;

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

// 16 bytes of T: the unit of a vector load or store of x, g, out and dx.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// kN consecutive elements of w (of another type than x, perhaps) as
// float32; p is aligned to min(16, kN * sizeof(W)) bytes.
template <int kN, typename W>
__device__ __forceinline__ void load_f32(const W* p, float* f) {
  constexpr int kBytes = kN * static_cast<int>(sizeof(W));
  struct alignas(kBytes < 16 ? kBytes : 16) Pack {
    W v[kN];
  };
  const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
  for (int i = 0; i < kN; ++i) f[i] = to_f32(pk.v[i]);
}

// Sum of v over the block, returned to every thread. smem holds kWarps
// floats and is free again when the function returns.
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += smem[w];
  __syncthreads();
  return s;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ out, float* __restrict__ rstd_out,
                int64_t rows, int64_t d, float eps, int vectorized) {
  __shared__ float smem[kWarps];
  constexpr int kN = Vec<T>::kN;
  const int64_t nvec = vectorized ? d / kN : 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float ss = 0.0f;
    for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[k];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float f = to_f32(a.v[i]);
        ss += f * f;
      }
    }
    for (int64_t j = nvec * kN + threadIdx.x; j < d; j += kThreads) {
      const float f = to_f32(xr[j]);
      ss += f * f;
    }
    const float var = block_sum(ss, smem) / static_cast<float>(d);
    const float r = 1.0f / sqrtf(var + eps);
    if (threadIdx.x == 0) rstd_out[row] = r;
    for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[k];
      float wf[kN];
      load_f32<kN>(w + k * kN, wf);
      Vec<T> o;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        o.v[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(a.v[i]), r), wf[i]));
      }
      reinterpret_cast<Vec<T>*>(orow)[k] = o;
    }
    for (int64_t j = nvec * kN + threadIdx.x; j < d; j += kThreads) {
      orow[j] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[j]), r),
                                      to_f32(w[j])));
    }
  }
}

// dx of one element: rstd * (wg - x * rstd * rstd * proj), in that order.
__device__ __forceinline__ float dx_of(float xf, float wg, float r,
                                       float proj) {
  const float t = __fmul_rn(__fmul_rn(__fmul_rn(xf, r), r), proj);
  return __fmul_rn(r, __fsub_rn(wg, t));
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_dx(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   T* __restrict__ dx, int64_t rows, int64_t d,
                   int vectorized) {
  __shared__ float smem[kWarps];
  constexpr int kN = Vec<T>::kN;
  const int64_t nvec = vectorized ? d / kN : 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    T* dxr = dx + row * d;
    float dot = 0.0f;
    for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[k];
      const Vec<T> b = reinterpret_cast<const Vec<T>*>(gr)[k];
      float wf[kN];
      load_f32<kN>(w + k * kN, wf);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        dot += __fmul_rn(wf[i], to_f32(b.v[i])) * to_f32(a.v[i]);
      }
    }
    for (int64_t j = nvec * kN + threadIdx.x; j < d; j += kThreads) {
      dot += __fmul_rn(to_f32(w[j]), to_f32(gr[j])) * to_f32(xr[j]);
    }
    const float proj = block_sum(dot, smem) / static_cast<float>(d);
    const float r = rstd[row];
    for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[k];
      const Vec<T> b = reinterpret_cast<const Vec<T>*>(gr)[k];
      float wf[kN];
      load_f32<kN>(w + k * kN, wf);
      Vec<T> o;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float wg = __fmul_rn(wf[i], to_f32(b.v[i]));
        o.v[i] = from_f32<T>(dx_of(to_f32(a.v[i]), wg, r, proj));
      }
      reinterpret_cast<Vec<T>*>(dxr)[k] = o;
    }
    for (int64_t j = nvec * kN + threadIdx.x; j < d; j += kThreads) {
      const float wg = __fmul_rn(to_f32(w[j]), to_f32(gr[j]));
      dxr[j] = from_f32<T>(dx_of(to_f32(xr[j]), wg, r, proj));
    }
  }
}

int grid_for(int64_t rows) {
  return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
}

template <typename T, typename W>
void launch_fwd(const void* x, const void* w, void* out, void* rstd,
                int64_t rows, int64_t d, float eps, int vectorized,
                cudaStream_t s) {
  rmsnorm_fwd<T, W><<<grid_for(rows), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), static_cast<float*>(rstd), rows, d, eps,
      vectorized);
}

template <typename T, typename W>
void launch_bwd_dx(const void* x, const void* w, const void* rstd,
                   const void* g, void* dx, int64_t rows, int64_t d,
                   int vectorized, cudaStream_t s) {
  rmsnorm_bwd_dx<T, W><<<grid_for(rows), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<T*>(dx), rows, d, vectorized);
}

}  // namespace

extern "C" {

// x, out: [rows, d] float32 (x_is_bf16 == 0) or bfloat16; w: [d] float32
// (w_is_bf16 == 0) or bfloat16; rstd: [rows] float32. vectorized != 0
// requires d % (16 / sizeof(x)) == 0 and 16-byte aligned pointers (the
// caller checks). Returns cudaGetLastError() after the launch.
int rt_rmsnorm_fwd(const void* x, const void* w, void* out, void* rstd,
                   int x_is_bf16, int w_is_bf16, int vectorized,
                   int64_t rows, int64_t d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16 && w_is_bf16) {
    launch_fwd<bf16, bf16>(x, w, out, rstd, rows, d, eps, vectorized, s);
  } else if (x_is_bf16) {
    launch_fwd<bf16, float>(x, w, out, rstd, rows, d, eps, vectorized, s);
  } else if (w_is_bf16) {
    launch_fwd<float, bf16>(x, w, out, rstd, rows, d, eps, vectorized, s);
  } else {
    launch_fwd<float, float>(x, w, out, rstd, rows, d, eps, vectorized, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: [rows, d] of one type (x_is_bf16); w: [d]; rstd: [rows]
// float32; vectorized as for rt_rmsnorm_fwd.
int rt_rmsnorm_bwd_dx(const void* x, const void* w, const void* rstd,
                      const void* g, void* dx, int x_is_bf16, int w_is_bf16,
                      int vectorized, int64_t rows, int64_t d,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16 && w_is_bf16) {
    launch_bwd_dx<bf16, bf16>(x, w, rstd, g, dx, rows, d, vectorized, s);
  } else if (x_is_bf16) {
    launch_bwd_dx<bf16, float>(x, w, rstd, g, dx, rows, d, vectorized, s);
  } else if (w_is_bf16) {
    launch_bwd_dx<float, bf16>(x, w, rstd, g, dx, rows, d, vectorized, s);
  } else {
    launch_bwd_dx<float, float>(x, w, rstd, g, dx, rows, d, vectorized, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
