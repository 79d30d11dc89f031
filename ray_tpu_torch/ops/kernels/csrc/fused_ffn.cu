// The fused FFN backward's three kernels (ray_tpu/ops/pallas/fused_ffn.py),
// each one block per output tile with the reduction axis walked inside the
// block and float32 accumulators:
//
//   K1 dw_down_kernel    dW_down = swiglu(gate, up)^T . dy        [d_ff, d]
//      replaces _dw_down_kernel (fused_ffn.py:76, called at :208 when USE_K1)
//   K2 dgateup_kernel    d_s = dy . W_down^T (float32, never stored), then
//                        dgate = d_s*up*silu'(gate), dup = d_s*silu(gate)
//      replaces _dgateup_kernel (fused_ffn.py:97, called at :233 when USE_K2)
//   K3 dw_gateup_kernel  dW_gate = h^T . dgate, dW_up = h^T . dup,
//                        h = bf16(x * rstd * norm_w) recomputed per tile
//      replaces _dw_gateup_kernel (fused_ffn.py:121, called at :264 when
//      USE_K3)
//
// plus float32 twins of all three (*_f32_kernel, at the end of the file).
//
// What bounds them on an H100: tensor-core operations. At the Llama-3-8B
// training shape (T = 4096 tokens, d = 4096, d_ff = 14336) K1 and K2 are
// one product each, 2*T*d*d_ff = 4.81e11 FLOP (0.49 ms at 989 TFLOP/s),
// against 0.39 GB (K1) and 0.62 GB (K2) of operands and outputs (0.12 and
// 0.18 ms at 3.35 TB/s); K3 is two products, 9.62e11 FLOP (0.97 ms), against
// ~0.5 GB.
//
// K1 (bf16) is built on Hopper's warpgroup MMA with the swiglu as a
// register operand (see "K1" below). K2 and K3 keep the first design
// (a wgmma mainloop for them is later work):
//  * One block of 8 warps owns one output tile (128 x 64) and loops over
//    the reduction axis (tokens for K3, d for K2); the TPU's sequential k
//    grid axis becomes that loop. Each warp owns a 32 x 32 patch of each
//    accumulator (2 x 2 nvcuda::wmma 16x16x16 bf16 fragments).
//  * The elementwise chains run on tiles already in registers or shared
//    memory: K3's prologue computes h; K2's epilogue reads the float32
//    accumulator from shared memory with the gate/up tile and writes only
//    dgate and dup.
//  * The next step's tiles are loaded into registers while the current
//    step's products run, so device-memory latency overlaps the tensor-core
//    work; two blocks share an SM.
//  * Ragged edges are masked here, not by a tiling guard: rows and columns
//    past T, d or d_ff load as zeros, and only in-range outputs are written.
//    16-byte loads are used where a row's length is a multiple of 8,
//    element loads elsewhere.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int kTM = 128;  // output rows per block
constexpr int kTN = 64;   // output columns per block
constexpr int kTK = 32;   // tokens per step (K3)
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
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

// Stages a block's kTM x kTN float32 accumulator in shared memory
// (row-major, ld kLdStage); the caller syncs before and after.
__device__ __forceinline__ void stage_acc(float* stage, FragC (&acc)[2][2],
                                          int wm, int wn) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::store_matrix_sync(stage + (wm + a * 16) * kLdStage + wn + b * 16,
                              acc[a][b], kLdStage, wmma::mem_row_major);
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------------------------- K1
//
// dw_down_kernel (bf16) is built on Hopper's warpgroup MMA (hopper.cuh):
//  * a block owns a 128 (d_ff) x 256 (d) output tile, two warpgroups of
//    m64n256 (128 float32 accumulators a thread), so the swiglu of each
//    gate/up element is recomputed d/256 times (16 at d 4096) where the
//    TPU kernel's full-d rows compute it once;
//  * 64-token stages of gate and up [64 x 128] and dy [64 x 256], all in
//    the 128-byte-swizzled layout, arrive through a three-stage ring (64 KB
//    a stage). Where d_ff and d are multiples of 8 the Tensor Memory
//    Accelerator (TMA) fills it: 8 boxes of 64 x 64 a stage, issued by a
//    ninth, producer warp, with a "full" and an "empty" mbarrier a stage,
//    so the consumers never wait at a block barrier and walk the k16 steps
//    of all stages as one sequence. Elsewhere all threads fill it by
//    cp.async, a block barrier a stage. At the 8B shape (H100 SXM) the
//    cp.async ring moved ~4.7 TB/s from L2 and held the kernel at 1.5 ms
//    even with no swiglu at all; TMA took it to 1.28 ms and the producer
//    warp ~5% further. What holds it near 0.4 of its bound: the swiglu's
//    two special-function ops an element (~0.3 ms: a variant without it
//    took 0.97 ms) and 1 KB of tiles from L2 a token a block (gate, up
//    and dy: twice the A operand of a plain product).
//  * the swiglu is the register A operand, with no shared-memory round
//    trip: each warp ldmatrix.trans-loads its 16 d_ff rows x 16 tokens of
//    gate and of up (A(d_ff row, token) is the tile read transposed),
//    computes silu(g)*u in float32, rounds it to bf16 as the plain
//    version does and packs it into the 4 A registers of m64n256k16; B is
//    the dy tile read MN-major (tokens are the reduction rows, d is
//    contiguous);
//  * the swiglu of k16 step k+1 is computed while step k's product runs
//    (two A register sets), so the special-function work overlaps the
//    tensor cores.
// The sigmoid is __expf and __fdividef: silu(g)*u = g*u / (1 + exp(-g))
// with two special-function ops (ex2, rcp) an element, where expf and an
// IEEE division take more; its float32 value may differ from the plain
// version's in the last bits, and so its bf16 rounding by one ulp. Rows
// and columns past T, d or d_ff are zero-filled by the copies; where d_ff
// or d is not a multiple of 8 a 16-byte copy cannot reach a row, and those
// chunks are fetched element by element. Only in-range outputs are
// written, as bf16 pairs from the accumulators.

constexpr int kK1Rows = 128;  // d_ff rows a block (two warpgroups of 64)
constexpr int kK1Cols = 256;  // d columns a block
constexpr int kK1Tok = 64;    // tokens a stage
constexpr int kK1Stages = 3;
constexpr int kK1Gate = kK1Tok * kK1Rows;  // elements of a gate/up tile
constexpr int kK1Dy = kK1Tok * kK1Cols;    // elements of a dy tile
constexpr int kK1Stage = 2 * kK1Gate + kK1Dy;
constexpr size_t kK1SmemBytes = sizeof(bf16) * kK1Stages * kK1Stage + 1024;

// One 16-byte chunk (8 bf16) of a row into shared memory: by cp.async when
// the row is 16-byte aligned (`vec`) and all 8 are in range, zero-filled
// when none is, else element by element.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const bf16* src,
                                           int left, bool vec) {
  if (left <= 0 || (vec && left >= 8)) {
    cp_async16(dst, src, left > 0);
  } else {
    const uint4 val = fetch8(src, left, false);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(val.x), "r"(val.y), "r"(val.z), "r"(val.w)
                 : "memory");
  }
}

// Tokens [t0, t0 + 64) of gate/up (d_ff columns m0..m0+127) and of dy (d
// columns n0..n0+255) into one ring stage.
__device__ __forceinline__ void k1_load_stage(bf16* stage, const bf16* gate,
                                              const bf16* up, const bf16* dy,
                                              int t0, int m0, int n0, int T,
                                              int d, int dff, bool vec_f,
                                              bool vec_d) {
  const uint32_t sG = smem_u32(stage);
  const uint32_t sU = sG + 2 * kK1Gate;
  const uint32_t sD = sU + 2 * kK1Gate;
#pragma unroll
  for (int it = 0; it < kK1Gate / 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kK1Rows / 8);
    const int c = i % (kK1Rows / 8);
    const int t = t0 + r;
    const int left = t < T ? dff - (m0 + 8 * c) : 0;
    const int64_t off = left > 0 ? static_cast<int64_t>(t) * dff + m0 + 8 * c
                                 : 0;
    const int at = tile_offset<kK1Rows, kK1Tok>(r, c);
    copy_chunk(sG + at, gate + off, left, vec_f);
    copy_chunk(sU + at, up + off, left, vec_f);
  }
#pragma unroll
  for (int it = 0; it < kK1Dy / 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kK1Cols / 8);
    const int c = i % (kK1Cols / 8);
    const int t = t0 + r;
    const int left = t < T ? d - (n0 + 8 * c) : 0;
    const int64_t off = left > 0 ? static_cast<int64_t>(t) * d + n0 + 8 * c
                                 : 0;
    copy_chunk(sD + tile_offset<kK1Cols, kK1Tok>(r, c), dy + off, left,
               vec_d);
  }
}

// bf16(silu(g) * u) of two packed bf16 pairs, packed the same way.
__device__ __forceinline__ uint32_t swiglu2(uint32_t g2, uint32_t u2) {
  const float g0 = __uint_as_float(g2 << 16);
  const float g1 = __uint_as_float(g2 & 0xffff0000u);
  const float u0 = __uint_as_float(u2 << 16);
  const float u1 = __uint_as_float(u2 & 0xffff0000u);
  return pack_bf16(__fdividef(g0 * u0, 1.0f + __expf(-g0)),
                   __fdividef(g1 * u1, 1.0f + __expf(-g1)));
}

// The A fragment of k16 step kk for this warp's 16 d_ff rows: ldmatrix
// .trans of gate and up (lane l gives the address of token row
// 16kk + l%8 + 8(l/16) at chunk `chunk` + (l/8)%2, so matrix i is
// a[i]'s 8 x 8 block), then the swiglu in registers.
__device__ __forceinline__ void swiglu_fragment(uint32_t (&a)[4],
                                                uint32_t gate_tile,
                                                uint32_t up_tile, int kk,
                                                int lane, int chunk) {
  const int row = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
  const uint32_t at =
      tile_offset<kK1Rows, kK1Tok>(row, chunk + ((lane >> 3) & 1));
  uint32_t g[4], u[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(g[0]), "=r"(g[1]), "=r"(g[2]), "=r"(g[3])
      : "r"(gate_tile + at));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
      : "r"(up_tile + at));
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = swiglu2(g[i], u[i]);
}

// Tokens [t0, t0 + 64) into one ring stage by TMA: two 64-column boxes of
// gate and of up, four of dy, all completing on the stage's mbarrier.
__device__ __forceinline__ void k1_tma_stage(bf16* stage, uint32_t bar,
                                             const CUtensorMap* tm_gate,
                                             const CUtensorMap* tm_up,
                                             const CUtensorMap* tm_dy, int t0,
                                             int m0, int n0) {
  constexpr int kBox = kK1Tok * 64 * sizeof(bf16);  // one 64 x 64 box
  const uint32_t sG = smem_u32(stage);
  const uint32_t sU = sG + 2 * kK1Gate;
  const uint32_t sD = sU + 2 * kK1Gate;
  mbar_expect_bytes(bar, kK1Stage * sizeof(bf16));
#pragma unroll
  for (int i = 0; i < kK1Rows / 64; ++i) {
    tma_load_2d(sG + i * kBox, tm_gate, m0 + 64 * i, t0, bar);
    tma_load_2d(sU + i * kBox, tm_up, m0 + 64 * i, t0, bar);
  }
#pragma unroll
  for (int i = 0; i < kK1Cols / 64; ++i) {
    tma_load_2d(sD + i * kBox, tm_dy, n0 + 64 * i, t0, bar);
  }
}

// K1's block: two consumer warpgroups, and on the TMA ring a ninth warp
// that only issues the copies.
template <bool kTma>
constexpr int kK1Threads = kTma ? kThreads + 32 : kThreads;

template <bool kTma>
__global__ void __launch_bounds__(kK1Threads<kTma>, 1)
    dw_down_kernel(const __grid_constant__ CUtensorMap tm_gate,
                   const __grid_constant__ CUtensorMap tm_up,
                   const __grid_constant__ CUtensorMap tm_dy,
                   const bf16* __restrict__ gate, const bf16* __restrict__ up,
                   const bf16* __restrict__ dy, bf16* __restrict__ dw_down,
                   int T, int d, int dff) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  // TMA ring: a stage landed (full), every consumer warp is done with it
  // (empty)
  __shared__ __align__(8) uint64_t full[kK1Stages], empty[kK1Stages];

  const int n0 = blockIdx.x * kK1Cols;  // columns of dW_down: the d axis
  const int m0 = blockIdx.y * kK1Rows;  // rows of dW_down: the d_ff axis
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_steps = (T + kK1Tok - 1) / kK1Tok;
  // this warp's 16 d_ff rows of the gate/up tiles, in 16-byte chunks
  const int chunk = wg * 8 + (warp & 3) * 2;
  constexpr int kSteps = kK1Tok / 16;  // k16 steps a stage
  auto stage_at = [&](int buf) { return smem_u32(ring + buf * kK1Stage); };

  float acc[kK1Cols / 2];
#pragma unroll
  for (int i = 0; i < kK1Cols / 2; ++i) acc[i] = 0.0f;
  uint32_t a[2][4] = {};

  if constexpr (kTma) {
    // The producer warp keeps the ring full; the consumers walk the k16
    // steps of all stages as one sequence, so the swiglu of the next step
    // (in the next stage too) overlaps this step's product, and a stage is
    // released to the producer as soon as its last product is done.
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < kK1Stages; ++i) {
        mbar_init(smem_u32(&full[i]), 1);
        mbar_init(smem_u32(&empty[i]), kThreads / 32);
      }
      mbar_fence_init();
    }
    __syncthreads();
    if (warp == kThreads / 32) {
      if (lane == 0) {
        for (int st = 0; st < n_steps; ++st) {
          const int buf = st % kK1Stages;
          if (st >= kK1Stages) {
            mbar_wait(smem_u32(&empty[buf]), (st / kK1Stages - 1) & 1);
          }
          k1_tma_stage(ring + buf * kK1Stage, smem_u32(&full[buf]),
                       &tm_gate, &tm_up, &tm_dy, st * kK1Tok, m0, n0);
        }
      }
      return;
    }
    if (n_steps > 0) {
      mbar_wait(smem_u32(&full[0]), 0);
      swiglu_fragment(a[0], stage_at(0), stage_at(0) + 2 * kK1Gate, 0, lane,
                      chunk);
    }
    for (int st = 0; st < n_steps; ++st) {
      const uint32_t tD = stage_at(st % kK1Stages) + 4 * kK1Gate;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        fence_operands(acc);
        wgmma_fence();
        wgmma_rs_n256(acc, a[kk & 1], mnmajor_desc<kK1Cols, kK1Tok>(tD, kk));
        wgmma_commit();
        // step kk - 1's product is done: its A registers, kept live up to
        // here, are free for step kk + 1, and after the last step of a
        // stage this warp is done with that stage
        wgmma_wait<1>();
        fence_operands(a[(kk + 1) & 1]);
        if (kk == 0 && st > 0 && lane == 0) {
          mbar_arrive(smem_u32(&empty[(st - 1) % kK1Stages]));
        }
        if (kk + 1 < kSteps) {
          const uint32_t tG = stage_at(st % kK1Stages);
          swiglu_fragment(a[(kk + 1) & 1], tG, tG + 2 * kK1Gate, kk + 1,
                          lane, chunk);
        } else if (st + 1 < n_steps) {  // the next stage's first step
          const int buf = (st + 1) % kK1Stages;
          mbar_wait(smem_u32(&full[buf]), ((st + 1) / kK1Stages) & 1);
          swiglu_fragment(a[(kk + 1) & 1], stage_at(buf),
                          stage_at(buf) + 2 * kK1Gate, 0, lane, chunk);
        }
      }
    }
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(a[0]);
    fence_operands(a[1]);
  } else {
    // cp.async ring (rows that TMA cannot describe): every thread copies,
    // and a block barrier a stage frees the stage copied into next
    const bool vec_f = (dff & 7) == 0;
    const bool vec_d = (d & 7) == 0;
#pragma unroll
    for (int st = 0; st < kK1Stages - 1; ++st) {
      if (st < n_steps) {
        k1_load_stage(ring + st * kK1Stage, gate, up, dy, st * kK1Tok, m0,
                      n0, T, d, dff, vec_f, vec_d);
      }
      cp_async_commit();
    }
    for (int st = 0; st < n_steps; ++st) {
      cp_async_wait<kK1Stages - 2>();  // stage st has landed
      fence_async_shared();
      __syncthreads();  // ... for every thread; and stage st - 1 is free
      const int next = st + kK1Stages - 1;
      if (next < n_steps) {
        k1_load_stage(ring + (next % kK1Stages) * kK1Stage, gate, up, dy,
                      next * kK1Tok, m0, n0, T, d, dff, vec_f, vec_d);
      }
      cp_async_commit();
      const uint32_t tG = stage_at(st % kK1Stages);
      const uint32_t tU = tG + 2 * kK1Gate;
      const uint32_t tD = tU + 2 * kK1Gate;
      swiglu_fragment(a[0], tG, tU, 0, lane, chunk);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        fence_operands(acc);
        wgmma_fence();
        wgmma_rs_n256(acc, a[kk & 1], mnmajor_desc<kK1Cols, kK1Tok>(tD, kk));
        wgmma_commit();
        wgmma_wait<1>();  // step kk - 1 is done (see the TMA ring)
        fence_operands(a[(kk + 1) & 1]);
        if (kk + 1 < kSteps) {
          swiglu_fragment(a[(kk + 1) & 1], tG, tU, kk + 1, lane, chunk);
        }
      }
      wgmma_wait_all();
      fence_operands(acc);
      fence_operands(a[1]);
    }
    cp_async_wait<0>();
  }

  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    if (r >= dff) continue;
    bf16* dst = dw_down + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int j = 0; j < kK1Cols / 8; ++j) {
      const int c = col + 8 * j;
      const float lo = acc[4 * j + 2 * i];
      const float hi = acc[4 * j + 2 * i + 1];
      if (pairs && c + 1 < d) {
        *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(lo, hi);
      } else {
        if (c < d) dst[c] = __float2bfloat16_rn(lo);
        if (c + 1 < d) dst[c + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// ------------------------------------------------------------------- K2

constexpr int kTK2 = 64;  // d per step
constexpr int kLdK2 = kTK2 + 8;
constexpr int kAVec2 = kTM * kTK2 / 8 / kThreads;
constexpr int kBVec2 = kTN * kTK2 / 8 / kThreads;
static_assert(kAVec2 * 8 * kThreads == kTM * kTK2, "dy tile split");
static_assert(kBVec2 * 8 * kThreads == kTN * kTK2, "w_down tile split");
constexpr int kK2TileBytes = sizeof(bf16) * (kTM + kTN) * kLdK2;
static_assert(kK2TileBytes <= kSmemBytes, "K2 tiles fit");

// One step of K2: the [kTM x kTK2] dy tile (tokens m0.., d columns k0..)
// and the [kTN x kTK2] W_down tile (d_ff rows n0.., d columns k0..).
struct StagedK2 {
  uint4 a[kAVec2];
  uint4 b[kBVec2];
};

__device__ __forceinline__ void fetch_k2(StagedK2& st, const bf16* dy,
                                         const bf16* w_down, int k0, int m0,
                                         int n0, int T, int d, int dff,
                                         bool vec_d) {
#pragma unroll
  for (int v = 0; v < kAVec2; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int t = m0 + i / (kTK2 / 8);
    const int c = (i % (kTK2 / 8)) * 8;
    const int left = t < T ? d - (k0 + c) : 0;
    const int64_t off = static_cast<int64_t>(t) * d + k0 + c;
    st.a[v] = fetch8(dy + (left > 0 ? off : 0), left, vec_d);
  }
#pragma unroll
  for (int v = 0; v < kBVec2; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int j = n0 + i / (kTK2 / 8);
    const int c = (i % (kTK2 / 8)) * 8;
    const int left = j < dff ? d - (k0 + c) : 0;
    const int64_t off = static_cast<int64_t>(j) * d + k0 + c;
    st.b[v] = fetch8(w_down + (left > 0 ? off : 0), left, vec_d);
  }
}

__device__ __forceinline__ void store_k2(const StagedK2& st, bf16* sA,
                                         bf16* sB) {
#pragma unroll
  for (int v = 0; v < kAVec2; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int r = i / (kTK2 / 8);
    const int c = (i % (kTK2 / 8)) * 8;
    *reinterpret_cast<uint4*>(sA + r * kLdK2 + c) = st.a[v];
  }
#pragma unroll
  for (int v = 0; v < kBVec2; ++v) {
    const int i = threadIdx.x + v * kThreads;
    const int r = i / (kTK2 / 8);
    const int c = (i % (kTK2 / 8)) * 8;
    *reinterpret_cast<uint4*>(sB + r * kLdK2 + c) = st.b[v];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    dgateup_kernel(const bf16* __restrict__ dy,
                   const bf16* __restrict__ w_down,
                   const bf16* __restrict__ gate, const bf16* __restrict__ up,
                   bf16* __restrict__ dgate, bf16* __restrict__ dup, int T,
                   int d, int dff) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kTM * kLdK2;

  const int m0 = blockIdx.y * kTM;  // rows of dgate/dup: tokens
  const int n0 = blockIdx.x * kTN;  // columns: the d_ff axis
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const bool vec_d = (d & 7) == 0;

  FragC acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.0f);
  }

  StagedK2 st;
  fetch_k2(st, dy, w_down, 0, m0, n0, T, d, dff, vec_d);
  for (int k0 = 0; k0 < d; k0 += kTK2) {
    __syncthreads();  // the previous step's fragments are loaded
    store_k2(st, sA, sB);
    __syncthreads();
    if (k0 + kTK2 < d) {
      fetch_k2(st, dy, w_down, k0 + kTK2, m0, n0, T, d, dff, vec_d);
    }
#pragma unroll
    for (int kk = 0; kk < kTK2 / 16; ++kk) {
      FragA a[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        wmma::load_matrix_sync(a[x], sA + (wm + x * 16) * kLdK2 + kk * 16,
                               kLdK2);
      }
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        // B(k, j) = W_down[j][k]: the W_down tile read column-major
        FragBt w;
        wmma::load_matrix_sync(w, sB + (wn + y * 16) * kLdK2 + kk * 16,
                               kLdK2);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          wmma::mma_sync(acc[x][y], a[x], w, acc[x][y]);
        }
      }
    }
  }

  // epilogue: the swiglu VJP on the float32 d_s tile; d_s is never stored
  float* stage = reinterpret_cast<float*>(smem);
  __syncthreads();
  stage_acc(stage, acc, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < kTM * kTN; i += kThreads) {
    const int r = i / kTN;
    const int c = i % kTN;
    if (m0 + r < T && n0 + c < dff) {
      const int64_t off = static_cast<int64_t>(m0 + r) * dff + n0 + c;
      const float ds = stage[r * kLdStage + c];
      const float g = __bfloat162float(gate[off]);
      const float u = __bfloat162float(up[off]);
      const float s = sigmoid(g);
      dgate[off] = __float2bfloat16_rn(ds * u * (s * (1.0f + g * (1.0f - s))));
      dup[off] = __float2bfloat16_rn(ds * (g * s));
    }
  }
}

// ---------------------------------------------------------------- float32
//
// K1, K2 and K3 for float32 operands and outputs (the reference keeps the
// model's dtype, fused_ffn.py:264 on): one plain tiled SIMT product,
// C[m][n] = sum_k A(m, k) B(k, n) over a 64 x 64 output tile, 16 of k a
// step through shared memory, each of 256 threads owning a 4 x 4 patch
// (rows 4ty + i, columns tx + 16j), every product an FMA on the CUDA cores
// in float32 (TF32 would keep ~3 digits). The modes differ only in how A
// and B are fetched (with K1's swiglu and K3's h computed on the fly) and
// in K2's epilogue. Bound on an H100: float32 operations (67 TFLOP/s).

constexpr int kFT = 64;  // output tile
constexpr int kFK = 16;  // reduction step
constexpr int kLdF = kFT + 1;

// Fills the [kFK][kLdF] tile with fetch(x, kk) at [kk][x] for x < kFT.
// kContig: the source is contiguous along k (each thread walks k),
// otherwise along x.
template <bool kContig, typename Fetch>
__device__ __forceinline__ void fill_tile_f32(float* tile, Fetch fetch) {
  for (int e = threadIdx.x; e < kFK * kFT; e += kThreads) {
    const int x = kContig ? e / kFK : e % kFT;
    const int kk = kContig ? e % kFK : e / kFT;
    tile[kk * kLdF + x] = fetch(x, kk);
  }
}

template <bool kContigA, bool kContigB, typename FetchA, typename FetchB>
__device__ __forceinline__ void gemm_tile_f32(int K, FetchA fetch_a,
                                              FetchB fetch_b, float* sA,
                                              float* sB, float (&c)[4][4]) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();  // the previous step's readers are done
    fill_tile_f32<kContigA>(
        sA, [&](int m, int kk) { return fetch_a(m, k0 + kk); });
    fill_tile_f32<kContigB>(
        sB, [&](int n, int kk) { return fetch_b(k0 + kk, n); });
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sA[kk * kLdF + 4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sB[kk * kLdF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(x[i], y[j], c[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void store_tile_f32(float* out,
                                               const float (&c)[4][4],
                                               int m0, int n0, int M, int N) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 4 * ty + i;
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[static_cast<int64_t>(m) * N + n] = c[i][j];
    }
  }
}

// K3: dW_gate (blockIdx.z 0) or dW_up (1) = h^T . dgate|dup, h = x*rstd*w.
__global__ void __launch_bounds__(kThreads)
    dw_gateup_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ rstd,
                         const float* __restrict__ norm_w,
                         const float* __restrict__ dgate,
                         const float* __restrict__ dup,
                         float* __restrict__ dw_gate,
                         float* __restrict__ dw_up, int T, int d, int dff) {
  __shared__ float sA[kFK * kLdF];
  __shared__ float sB[kFK * kLdF];
  const int m0 = blockIdx.y * kFT;  // the d axis
  const int n0 = blockIdx.x * kFT;  // the d_ff axis
  const float* g = blockIdx.z ? dup : dgate;
  float c[4][4];
  gemm_tile_f32<false, false>(
      T,
      [&](int m, int t) {
        const int i = m0 + m;
        return t < T && i < d
                   ? x[static_cast<int64_t>(t) * d + i] * rstd[t] * norm_w[i]
                   : 0.0f;
      },
      [&](int t, int n) {
        const int j = n0 + n;
        return t < T && j < dff ? g[static_cast<int64_t>(t) * dff + j] : 0.0f;
      },
      sA, sB, c);
  store_tile_f32(blockIdx.z ? dw_up : dw_gate, c, m0, n0, d, dff);
}

// K1: dW_down = swiglu(gate, up)^T . dy, swiglu = silu(g) * u.
__global__ void __launch_bounds__(kThreads)
    dw_down_f32_kernel(const float* __restrict__ gate,
                       const float* __restrict__ up,
                       const float* __restrict__ dy,
                       float* __restrict__ dw_down, int T, int d, int dff) {
  __shared__ float sA[kFK * kLdF];
  __shared__ float sB[kFK * kLdF];
  const int m0 = blockIdx.y * kFT;  // the d_ff axis
  const int n0 = blockIdx.x * kFT;  // the d axis
  float c[4][4];
  gemm_tile_f32<false, false>(
      T,
      [&](int m, int t) {
        const int i = m0 + m;
        if (t >= T || i >= dff) return 0.0f;
        const int64_t off = static_cast<int64_t>(t) * dff + i;
        const float g = gate[off];
        return g * sigmoid(g) * up[off];
      },
      [&](int t, int n) {
        const int j = n0 + n;
        return t < T && j < d ? dy[static_cast<int64_t>(t) * d + j] : 0.0f;
      },
      sA, sB, c);
  store_tile_f32(dw_down, c, m0, n0, dff, d);
}

// K2: d_s = dy . W_down^T (never stored), then the swiglu VJP.
__global__ void __launch_bounds__(kThreads)
    dgateup_f32_kernel(const float* __restrict__ dy,
                       const float* __restrict__ w_down,
                       const float* __restrict__ gate,
                       const float* __restrict__ up,
                       float* __restrict__ dgate, float* __restrict__ dup,
                       int T, int d, int dff) {
  __shared__ float sA[kFK * kLdF];
  __shared__ float sB[kFK * kLdF];
  const int m0 = blockIdx.y * kFT;  // tokens
  const int n0 = blockIdx.x * kFT;  // the d_ff axis
  float c[4][4];
  gemm_tile_f32<true, true>(
      d,
      [&](int m, int k) {
        const int t = m0 + m;
        return t < T && k < d ? dy[static_cast<int64_t>(t) * d + k] : 0.0f;
      },
      [&](int k, int n) {
        const int j = n0 + n;
        return j < dff && k < d ? w_down[static_cast<int64_t>(j) * d + k]
                                : 0.0f;
      },
      sA, sB, c);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = m0 + 4 * ty + i;
      const int n = n0 + tx + 16 * j;
      if (t < T && n < dff) {
        const int64_t off = static_cast<int64_t>(t) * dff + n;
        const float g = gate[off];
        const float s = sigmoid(g);
        dgate[off] = c[i][j] * up[off] * (s * (1.0f + g * (1.0f - s)));
        dup[off] = c[i][j] * (g * s);
      }
    }
  }
}

// The CUDA driver API's cuTensorMapEncodeTiled, found through the runtime
// (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major [rows, cols] bf16 matrix in 64 x 64 boxes,
// 128-byte swizzle, zeros past its edges.
cudaError_t encode_bf16_map(CUtensorMap* map, const void* ptr, int rows,
                            int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, kK1Tok};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// gate/up [T, d_ff], dy [T, d] bf16, row-major and 16-byte aligned;
// dw_down [d_ff, d] bf16.
int rt_dw_down(const void* gate, const void* up, const void* dy,
               void* dw_down, int T, int d, int dff, void* stream) {
  if ((dff + kK1Rows - 1) / kK1Rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA needs row strides that are multiples of 16 bytes
  const bool tma = T > 0 && dff % 8 == 0 && d % 8 == 0;
  CUtensorMap maps[3] = {};
  if (tma) {
    cudaError_t err = encode_bf16_map(&maps[0], gate, T, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[1], up, T, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[2], dy, T, d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = tma ? dw_down_kernel<true> : dw_down_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kK1SmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((d + kK1Cols - 1) / kK1Cols, (dff + kK1Rows - 1) / kK1Rows);
  kernel<<<grid, tma ? kK1Threads<true> : kK1Threads<false>, kK1SmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(gate),
      static_cast<const bf16*>(up), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dw_down), T, d, dff);
  return static_cast<int>(cudaGetLastError());
}

// dy [T, d], w_down [d_ff, d], gate/up [T, d_ff] bf16, row-major and
// 16-byte aligned; dgate/dup [T, d_ff] bf16.
int rt_dgateup(const void* dy, const void* w_down, const void* gate,
               const void* up, void* dgate, void* dup, int T, int d, int dff,
               void* stream) {
  dim3 grid((dff + kTN - 1) / kTN, (T + kTM - 1) / kTM);
  dgateup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w_down),
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
      static_cast<bf16*>(dgate), static_cast<bf16*>(dup), T, d, dff);
  return static_cast<int>(cudaGetLastError());
}

// The same three entries for float32 operands and outputs (rstd float32).
int rt_dw_gateup_f32(const void* x, const void* rstd, const void* norm_w,
                     const void* dgate, const void* dup, void* dw_gate,
                     void* dw_up, int T, int d, int dff, void* stream) {
  dim3 grid((dff + kFT - 1) / kFT, (d + kFT - 1) / kFT, 2);
  dw_gateup_f32_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rstd),
      static_cast<const float*>(norm_w), static_cast<const float*>(dgate),
      static_cast<const float*>(dup), static_cast<float*>(dw_gate),
      static_cast<float*>(dw_up), T, d, dff);
  return static_cast<int>(cudaGetLastError());
}

int rt_dw_down_f32(const void* gate, const void* up, const void* dy,
                   void* dw_down, int T, int d, int dff, void* stream) {
  dim3 grid((d + kFT - 1) / kFT, (dff + kFT - 1) / kFT);
  dw_down_f32_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gate), static_cast<const float*>(up),
      static_cast<const float*>(dy), static_cast<float*>(dw_down), T, d, dff);
  return static_cast<int>(cudaGetLastError());
}

int rt_dgateup_f32(const void* dy, const void* w_down, const void* gate,
                   const void* up, void* dgate, void* dup, int T, int d,
                   int dff, void* stream) {
  dim3 grid((dff + kFT - 1) / kFT, (T + kFT - 1) / kFT);
  dgateup_f32_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w_down),
      static_cast<const float*>(gate), static_cast<const float*>(up),
      static_cast<float*>(dgate), static_cast<float*>(dup), T, d, dff);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
