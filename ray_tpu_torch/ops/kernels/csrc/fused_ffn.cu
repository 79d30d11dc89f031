// K3 of the fused FFN backward: the gate/up weight gradients
//   dW_gate = h^T . dgate,  dW_up = h^T . dup,  h = bf16(x * rstd * norm_w)
// with h recomputed per tile from x, rstd and norm_w and never stored.
//
// dw_gateup_kernel replaces the TPU kernel _dw_gateup_kernel
// (ray_tpu/ops/pallas/fused_ffn.py:121, called at :264 when USE_K3).
//
// What bounds it on an H100: tensor-core operations. At the Llama-3-8B
// training shape (T = 4096 tokens, d = 4096, d_ff = 14336) the two products
// cost 2 * 2*T*d*d_ff = 9.62e11 FLOP (0.97 ms at 989 TFLOP/s) against
// ~0.5 GB of operands and outputs (0.15 ms at 3.35 TB/s).
//
// Design (simple and right first; wgmma/TMA and a pipelined ring of tiles
// are later work):
//  * One block of 8 warps owns one 128 x 64 tile of both outputs ([d, d_ff]
//    rows x columns) and walks the token axis T inside the block, 32 tokens
//    per step; the TPU's sequential k grid axis becomes that loop.
//  * Each step stages a [32 x 128] tile of h, computed on the fly in float32
//    as (x * rstd) * norm_w and rounded to bf16 as the reference rounds it,
//    and the [32 x 64] tiles of dgate and dup. The h tile feeds both
//    products: two float32 accumulators share it, as on the TPU.
//  * The next step's x, rstd, dgate and dup are loaded into registers while
//    the current step's products run, so device-memory latency overlaps
//    the tensor-core work; two blocks share an SM.
//  * Products run on nvcuda::wmma 16x16x16 bf16 fragments; each warp owns a
//    32 x 32 patch of each accumulator (2 x 2 fragments each).
//  * Ragged edges are masked here, not by a tiling guard: tokens past T and
//    columns past d or d_ff load as zeros, and only in-range outputs are
//    written. 16-byte loads are used where a row's length is a multiple of
//    8, element loads elsewhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTM = 128;  // output rows (d axis) per block
constexpr int kTN = 64;   // output columns (d_ff axis) per block
constexpr int kTK = 32;   // tokens per step
constexpr int kThreads = 256;
constexpr int kLdH = kTM + 8;
constexpr int kLdG = kTN + 8;
constexpr int kLdStage = kTN + 4;

// Each thread stages kXVec 8-element pieces of the x tile and kGVec of each
// dgate/dup tile per step.
constexpr int kXVec = kTK * kTM / 8 / kThreads;
constexpr int kGVec = kTK * kTN / 8 / kThreads;
static_assert(kXVec * 8 * kThreads == kTK * kTM, "x tile split");
static_assert(kGVec * 8 * kThreads == kTK * kTN, "dgate tile split");

constexpr int kTileBytes = sizeof(bf16) * kTK * (kLdH + 2 * kLdG) +
                           sizeof(float) * kTM;
constexpr int kStageBytes = sizeof(float) * kTM * kLdStage;
constexpr int kSmemBytes = kTileBytes > kStageBytes ? kTileBytes : kStageBytes;

using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Eight bf16 values src[0..8) packed in 16 bytes, zeros past `left` valid
// elements; one 16-byte load when `vec` (aligned row) and all 8 are valid.
__device__ __forceinline__ uint4 fetch8(const bf16* src, int left, bool vec) {
  if (vec && left >= 8) return *reinterpret_cast<const uint4*>(src);
  __align__(16) bf16 e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    e[i] = i < left ? src[i] : __float2bfloat16_rn(0.0f);
  }
  return *reinterpret_cast<const uint4*>(e);
}

// Registers holding one step's tiles while the previous step computes.
struct Staged {
  uint4 x[kXVec];
  float r[kXVec];
  uint4 g[kGVec];
  uint4 u[kGVec];
};

__device__ __forceinline__ void fetch_step(Staged& st, const bf16* x,
                                           const float* rstd,
                                           const bf16* dgate,
                                           const bf16* dup, int t0, int m0,
                                           int n0, int T, int d, int dff,
                                           bool vec_x, bool vec_g) {
#pragma unroll
  for (int v = 0; v < kXVec; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int t = t0 + i / (kTM / 8);
    const int c = (i % (kTM / 8)) * 8;
    const int left = t < T ? d - (m0 + c) : 0;
    const int64_t off = static_cast<int64_t>(t) * d + m0 + c;
    st.x[v] = fetch8(x + (left > 0 ? off : 0), left, vec_x);
    st.r[v] = t < T ? rstd[t] : 0.0f;
  }
#pragma unroll
  for (int v = 0; v < kGVec; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int t = t0 + i / (kTN / 8);
    const int c = (i % (kTN / 8)) * 8;
    const int left = t < T ? dff - (n0 + c) : 0;
    const int64_t off = static_cast<int64_t>(t) * dff + n0 + c;
    st.g[v] = fetch8(dgate + (left > 0 ? off : 0), left, vec_g);
    st.u[v] = fetch8(dup + (left > 0 ? off : 0), left, vec_g);
  }
}

// Writes the staged step into shared memory: dgate/dup as they are, and
// h = bf16((x * rstd) * norm_w) computed here in float32.
__device__ __forceinline__ void store_step(const Staged& st, bf16* sH,
                                           bf16* sG, bf16* sU,
                                           const float* sW) {
#pragma unroll
  for (int v = 0; v < kXVec; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int r = i / (kTM / 8);
    const int c = (i % (kTM / 8)) * 8;
    const bf16* e = reinterpret_cast<const bf16*>(&st.x[v]);
    __align__(16) bf16 h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      h[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * st.r[v] *
                                 sW[c + k]);
    }
    *reinterpret_cast<uint4*>(sH + r * kLdH + c) =
        *reinterpret_cast<const uint4*>(h);
  }
#pragma unroll
  for (int v = 0; v < kGVec; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int r = i / (kTN / 8);
    const int c = (i % (kTN / 8)) * 8;
    *reinterpret_cast<uint4*>(sG + r * kLdG + c) = st.g[v];
    *reinterpret_cast<uint4*>(sU + r * kLdG + c) = st.u[v];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    dw_gateup_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ rstd,
                     const bf16* __restrict__ norm_w,
                     const bf16* __restrict__ dgate,
                     const bf16* __restrict__ dup, bf16* __restrict__ dw_gate,
                     bf16* __restrict__ dw_up, int T, int d, int dff) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* sH = reinterpret_cast<bf16*>(smem);
  bf16* sG = sH + kTK * kLdH;
  bf16* sU = sG + kTK * kLdG;
  float* sW = reinterpret_cast<float*>(sU + kTK * kLdG);

  const int m0 = blockIdx.y * kTM;  // rows of dW: the d axis
  const int n0 = blockIdx.x * kTN;  // columns of dW: the d_ff axis
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const bool vec_x = (d & 7) == 0;
  const bool vec_g = (dff & 7) == 0;

  for (int i = threadIdx.x; i < kTM; i += kThreads) {
    sW[i] = m0 + i < d ? __bfloat162float(norm_w[m0 + i]) : 0.0f;
  }

  FragC acc_g[2][2];
  FragC acc_u[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::fill_fragment(acc_g[a][b], 0.0f);
      wmma::fill_fragment(acc_u[a][b], 0.0f);
    }
  }

  Staged st;
  fetch_step(st, x, rstd, dgate, dup, 0, m0, n0, T, d, dff, vec_x, vec_g);
  for (int t0 = 0; t0 < T; t0 += kTK) {
    __syncthreads();  // the previous step's fragments are loaded (and sW)
    store_step(st, sH, sG, sU, sW);
    __syncthreads();
    // the next step's loads are in flight while this step computes
    if (t0 + kTK < T) {
      fetch_step(st, x, rstd, dgate, dup, t0 + kTK, m0, n0, T, d, dff,
                 vec_x, vec_g);
    }
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      FragAt h[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        // A(row i, token t) = h[t][i]: the h tile read column-major
        wmma::load_matrix_sync(h[a], sH + kk * 16 * kLdH + wm + a * 16, kLdH);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        FragB g;
        FragB u;
        wmma::load_matrix_sync(g, sG + kk * 16 * kLdG + wn + b * 16, kLdG);
        wmma::load_matrix_sync(u, sU + kk * 16 * kLdG + wn + b * 16, kLdG);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          wmma::mma_sync(acc_g[a][b], h[a], g, acc_g[a][b]);
          wmma::mma_sync(acc_u[a][b], h[a], u, acc_u[a][b]);
        }
      }
    }
  }

  // epilogue: stage each accumulator through shared memory, write in range
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wmma::store_matrix_sync(
            stage + (wm + a * 16) * kLdStage + wn + b * 16,
            pass == 0 ? acc_g[a][b] : acc_u[a][b], kLdStage,
            wmma::mem_row_major);
      }
    }
    __syncthreads();
    bf16* out = pass == 0 ? dw_gate : dw_up;
    for (int i = threadIdx.x; i < kTM * kTN; i += kThreads) {
      const int r = i / kTN;
      const int c = i % kTN;
      if (m0 + r < d && n0 + c < dff) {
        out[static_cast<int64_t>(m0 + r) * dff + n0 + c] =
            __float2bfloat16_rn(stage[r * kLdStage + c]);
      }
    }
  }
}

}  // namespace

extern "C" {

// x [T, d] bf16, rstd [T] float32, norm_w [d] bf16, dgate/dup [T, d_ff]
// bf16, all row-major and 16-byte aligned; dw_gate/dw_up [d, d_ff] bf16.
// Returns a CUDA error code (0 = ok).
int rt_dw_gateup(const void* x, const void* rstd, const void* norm_w,
                 const void* dgate, const void* dup, void* dw_gate,
                 void* dw_up, int T, int d, int dff, void* stream) {
  dim3 grid((dff + kTN - 1) / kTN, (d + kTM - 1) / kTM);
  dw_gateup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(rstd),
      static_cast<const bf16*>(norm_w), static_cast<const bf16*>(dgate),
      static_cast<const bf16*>(dup), static_cast<bf16*>(dw_gate),
      static_cast<bf16*>(dw_up), T, d, dff);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
