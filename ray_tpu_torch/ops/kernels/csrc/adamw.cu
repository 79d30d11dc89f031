// One-pass AdamW update with the global-norm clip folded in as a scalar:
// read p, g, mu, nu; write p', mu', nu' in place.
//
// adamw_kernel replaces the TPU kernel _adamw_kernel
// (ray_tpu/ops/pallas/adamw.py:37, launched per leaf by _leaf_update :55).
//
// What bounds it on an H100: bytes. A bf16 parameter moves 22 B (p and g
// read as bf16, mu and nu read and written as float32, p written as bf16)
// for ~16 float operations: at 8 layers of Llama-3-8B (2.7956e9 parameters)
// that is 61.5 GB a step, 18.4 ms at 3.35 TB/s.
//
// Design (simple and right first):
//  * One launch per leaf; a grid-stride loop over the leaf with 64-bit
//    indices (the embedding's float32 moment alone is 2.1 GB).
//  * Each thread takes 8 elements per turn with 16-byte loads (8 bf16 of p
//    and g, 2 x 4 floats of mu and nu) when every pointer is 16-byte
//    aligned; a scalar loop takes the tail past the last multiple of 8 (or
//    the whole leaf when a pointer is not aligned).
//  * The outputs overwrite the inputs element by element, so p, mu and nu
//    are deliberately not __restrict__.
//  * The clip factor is read from device memory (it is computed on the
//    device from the global norm, so the host never waits for it); lr and
//    the bias corrections 1 - b^t arrive by value from the host's count.
//  * Every operation is written as an explicitly rounded intrinsic in the
//    reference's order (g*clip; b1*mu + (1-b1)*g; b2*nu + ((1-b2)*g)*g;
//    lr*((mu/c1)/(sqrt(nu/c2)+eps) + wd*p); p - update), so no FMA is
//    contracted and the result equals the plain PyTorch version bit for bit
//    without changing the build flags of the other kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident 256-thread blocks per SM

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

template <typename T>
struct __align__(16) Vec8 {
  T v[8];
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// One element's update; p arrives as float32 and leaves as float32.
__device__ __forceinline__ void update(float& p, float g, float& mu,
                                       float& nu, float clip,
                                       const Hyper& h) {
  g = __fmul_rn(g, clip);
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, h.c2)), h.eps);
  const float u = __fmul_rn(
      h.lr, __fadd_rn(__fdiv_rn(__fdiv_rn(mu, h.c1), denom),
                      __fmul_rn(h.wd, p)));
  p = __fsub_rn(p, u);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(P* p, const P* __restrict__ g, float* mu, float* nu,
                 const float* __restrict__ clip_ptr, int64_t n, Hyper h,
                 int vec) {
  const float clip = *clip_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t tail = 0;
  if (vec) {
    const int64_t n8 = n / 8;
    for (int64_t v = tid; v < n8; v += stride) {
      const int64_t i = v * 8;
      Vec8<P> pv = *reinterpret_cast<const Vec8<P>*>(p + i);
      const Vec8<P> gv = *reinterpret_cast<const Vec8<P>*>(g + i);
      Vec8<float> mv = *reinterpret_cast<const Vec8<float>*>(mu + i);
      Vec8<float> nv = *reinterpret_cast<const Vec8<float>*>(nu + i);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float pf = to_f32(pv.v[k]);
        update(pf, to_f32(gv.v[k]), mv.v[k], nv.v[k], clip, h);
        pv.v[k] = from_f32<P>(pf);
      }
      *reinterpret_cast<Vec8<P>*>(p + i) = pv;
      *reinterpret_cast<Vec8<float>*>(mu + i) = mv;
      *reinterpret_cast<Vec8<float>*>(nu + i) = nv;
    }
    tail = n8 * 8;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    float pf = to_f32(p[i]);
    float m = mu[i];
    float s = nu[i];
    update(pf, to_f32(g[i]), m, s, clip, h);
    p[i] = from_f32<P>(pf);
    mu[i] = m;
    nu[i] = s;
  }
}

template <typename P>
int launch(void* p, const void* g, void* mu, void* nu, const void* clip,
           int64_t n, const Hyper& h, int vec, cudaStream_t stream) {
  const int64_t work = vec ? (n + 7) / 8 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  adamw_kernel<P><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), static_cast<float*>(mu),
      static_cast<float*>(nu), static_cast<const float*>(clip), n, h, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// p, g [n] of one dtype (bf16 when p_is_f32 == 0, else float32), mu and nu
// [n] float32, all contiguous and updated in place (p, mu, nu); clip one
// float32 on the device. vec != 0 when every pointer is 16-byte aligned.
// omb1/omb2 are 1 - b1 and 1 - b2, each rounded once from the caller's
// double. Returns a CUDA error code (0 = ok).
int rt_adamw(void* p, const void* g, void* mu, void* nu, const void* clip,
             int64_t n, float lr, float c1, float c2, float b1, float omb1,
             float b2, float omb2, float eps, float wd, int p_is_f32,
             int vec, void* stream) {
  const Hyper h{lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p_is_f32 ? launch<float>(p, g, mu, nu, clip, n, h, vec, s)
                  : launch<bf16>(p, g, mu, nu, clip, n, h, vec, s);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
