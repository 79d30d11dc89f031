// Int8 row-wise quantization kernels for w8a16 serving.
//
// quant_rows replaces the TPU kernel _quant_kernel
// (ray_tpu/ops/pallas/quant.py:19); dequant_rows replaces _dequant_kernel
// (ray_tpu/ops/pallas/quant.py:27).
//
// What bounds them on an H100: device-memory bytes. Each element costs a
// handful of float operations against 3 bytes moved (bf16 in, int8 out, or
// the reverse), two orders of magnitude below the card's operations-per-byte
// balance point. The designs therefore only try to keep the memory system
// busy with coalesced accesses and to move each byte once:
//
//  * quant_rows: one block per row (grid-stride over rows). Pass 1 reads the
//    row with strided, coalesced loads and reduces |x| to the row's absmax
//    with warp shuffles and one shared-memory step; pass 2 reads the row
//    again and writes int8 values. Rows are long (up to 128256 elements for
//    the [4096, 128256] LM head) and are never staged in shared memory; the
//    second read usually hits L2 for rows of a few thousand elements. The
//    numerics follow the JAX reference exactly: scale = max(absmax, 1e-8) *
//    float(1/127) (XLA turns the division by the constant into this
//    multiply), values = clip(rint(x / scale), -127, 127) with an IEEE
//    division, so the file is compiled without --use_fast_math.
//  * dequant_rows: one block per row; when the row length is a multiple of
//    8 and the pointers are 16-byte aligned each thread moves 8 int8 values
//    in one 8-byte load and 8 outputs in 16-byte stores, else one element at
//    a time. out = float(v) * scale, rounded to nearest-even for bf16.
//
// All offsets are 64-bit: stacked 8B leaves reach 1.9e9 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* out, int64_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* out, int64_t i,
                                       float v) {
  out[i] = __float2bfloat16_rn(v);
}

// Stores 8 consecutive outputs starting at out (16-byte aligned).
__device__ __forceinline__ void store8(float* out, const float* v) {
  float4* dst = reinterpret_cast<float4*>(out);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* out, const float* v) {
  union {
    __nv_bfloat162 h[4];
    uint4 u;
  } pack;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pack.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(out) = pack.u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_rows(const T* __restrict__ x, int8_t* __restrict__ values,
               float* __restrict__ scales, int64_t rows, int64_t d) {
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    float m = 0.0f;
    for (int64_t j = threadIdx.x; j < d; j += kThreads) {
      m = fmaxf(m, fabsf(to_float(xr[j])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    const float scale = fmaxf(m, 1e-8f) * (1.0f / 127.0f);
    if (threadIdx.x == 0) scales[row] = scale;
    int8_t* vr = values + row * d;
    for (int64_t j = threadIdx.x; j < d; j += kThreads) {
      float q = rintf(to_float(xr[j]) / scale);
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      vr[j] = static_cast<int8_t>(q);
    }
    __syncthreads();  // warp_max is reused by the block's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequant_rows(const int8_t* __restrict__ values,
                 const float* __restrict__ scales, T* __restrict__ out,
                 int64_t rows, int64_t d, int vectorized) {
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const float scale = scales[row];
    const int8_t* vr = values + row * d;
    T* orow = out + row * d;
    int64_t tail = 0;
    if (vectorized) {
      const int64_t nvec = d / 8;
      const uint2* src = reinterpret_cast<const uint2*>(vr);
      for (int64_t k = threadIdx.x; k < nvec; k += kThreads) {
        union {
          uint2 u;
          int8_t b[8];
        } raw;
        raw.u = src[k];
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(raw.b[i]) * scale;
        store8(orow + 8 * k, f);
      }
      tail = nvec * 8;
    }
    for (int64_t j = tail + threadIdx.x; j < d; j += kThreads) {
      store1(orow, j, static_cast<float>(vr[j]) * scale);
    }
  }
}

int grid_for(int64_t rows) {
  return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
}

}  // namespace

extern "C" {

// x: [rows, d] float32 (x_is_bf16 == 0) or bfloat16; values: [rows, d] int8;
// scales: [rows] float32. Returns cudaGetLastError() after the launch.
int rt_quantize_int8(const void* x, int x_is_bf16, void* values, void* scales,
                     int64_t rows, int64_t d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quant_rows<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(values),
        static_cast<float*>(scales), rows, d);
  } else {
    quant_rows<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(values),
        static_cast<float*>(scales), rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// values: [rows, d] int8; scales: [rows] float32; out: [rows, d] float32
// (out_is_bf16 == 0) or bfloat16. vectorized != 0 requires d % 8 == 0 and
// 16-byte aligned pointers (the caller checks).
int rt_dequantize_int8(const void* values, const void* scales, void* out,
                       int out_is_bf16, int vectorized, int64_t rows,
                       int64_t d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16) {
    dequant_rows<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const int8_t*>(values), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), rows, d, vectorized);
  } else {
    dequant_rows<float><<<grid_for(rows), kThreads, 0, s>>>(
        static_cast<const int8_t*>(values), static_cast<const float*>(scales),
        static_cast<float*>(out), rows, d, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
