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
// plus float32 twins of all three (*_f32_kernel, near the end of the
// file, on one SIMT mainloop of their own, fed by a cp.async ring, with
// tiles and a split of the reduction planned on the host).
//
// What bounds them on an H100: tensor-core operations. At the Llama-3-8B
// training shape (T = 4096 tokens, d = 4096, d_ff = 14336) K1 and K2 are
// one product each, 2*T*d*d_ff = 4.81e11 FLOP (0.49 ms at 989 TFLOP/s),
// against 0.39 GB (K1) and 0.62 GB (K2) of operands and outputs (0.12 and
// 0.18 ms at 3.35 TB/s); K3 is two products, 9.62e11 FLOP (0.97 ms), against
// ~0.5 GB.
//
// The bf16 kernels are built on Hopper's warpgroup MMA (hopper.cuh) around
// one mainloop (see "rings" below): two consumer warpgroups a block, each
// owning 64 rows of the output tile in float32 registers, fed by a ring of
// shared-memory stages in the 128-byte-swizzled layout that TMA writes and
// the wgmma descriptors read. What the three share besides:
//  * The TPU's sequential k grid axis becomes the loop over ring stages; one
//    block per output tile, no atomics and no split of the reduction, so
//    results are deterministic.
//  * The elementwise chains run where the data already is: K1's swiglu and
//    K3's h are the products' register A operands, formed from the staged
//    tiles (ldmatrix.trans) while the previous k16 step's products run;
//    K2's swiglu VJP is its epilogue, on the float32 accumulators.
//  * Each k16 step streams a block's whole tile width from L2 (about 1 KB a
//    token for K1, 768 B for K3 and K2), so that traffic, not the tensor
//    cores, is what holds them near 0.4 of their bound: tiles are as wide
//    as 128 float32 accumulators a thread allow, and K2 and K3 issue their
//    tiles in groups (grouped_tile) so that a wave's blocks share operand
//    rows and columns in L2 instead of streaming them from device memory
//    once a wave.
//  * Ragged edges: rows and columns past T, d or d_ff are zero-filled by
//    the copies (TMA fills past a matrix's edge; the cp.async ring fetches
//    partial chunks element by element), and only in-range outputs are
//    written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kBox = 64;        // a TMA box: 64 rows of 64 bf16 (8 KB)
constexpr int kBoxBytes = kBox * kBox * 2;
// output tiles issued per group along the first tile axis (grouped_tile)
constexpr int kGroup = 16;

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// Rows [row0, row0 + kRows) x columns [col0, col0 + kCols) of a row-major
// [n_rows, n_cols] bf16 matrix into a swizzled tile (tile_offset<kCols,
// kRows>, the layout TMA's 64 x 64 boxes give), by the kThreads consumer
// threads; everything past the matrix zero-filled.
template <int kCols, int kRows>
__device__ __forceinline__ void load_tile_chunks(uint32_t dst,
                                                 const bf16* src, int row0,
                                                 int col0, int n_rows,
                                                 int n_cols, bool vec) {
  constexpr int kChunks = kRows * kCols / 8;
  static_assert(kChunks % kThreads == 0, "whole 16-byte moves");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kCols / 8);
    const int c = i % (kCols / 8);
    const int row = row0 + r;
    const int left = row < n_rows ? n_cols - (col0 + 8 * c) : 0;
    const int64_t off =
        left > 0 ? static_cast<int64_t>(row) * n_cols + col0 + 8 * c : 0;
    copy_chunk(dst + tile_offset<kCols, kRows>(r, c), src + off, left, vec);
  }
}

// Four 8 x 8 bf16 matrices, transposed, from shared memory (lane l gives
// the address of matrix l / 8's row l % 8).
__device__ __forceinline__ void ldmatrix_trans_x4(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The output tile (m, n) of linear block b when the n_m x n_n tiles are
// issued in groups of kGroup m-tiles, m fastest inside a group: a wave of
// 132 blocks then spans ~kGroup m-tiles and ~132 / kGroup n-tiles, so its
// blocks share both operands' tiles in L2 (where n fastest would have each
// wave stream a whole operand from device memory).
__device__ __forceinline__ void grouped_tile(int b, int n_m, int n_n, int& m,
                                             int& n) {
  const int per = kGroup * n_n;
  const int group = b / per;
  const int first = group * kGroup;
  const int size = min(n_m - first, kGroup);
  const int r = b - group * per;
  m = first + r % size;
  n = r / size;
}

// A warpgroup's m64nN float32 accumulator as bf16 rows of a row-major
// [n_rows, n_cols] matrix: this thread's rows `row` and row + 8, columns
// col + 8j, col + 8j + 1 (col = the tile's first column + 2 (lane % 4)),
// in range only; bf16 pairs where the row length is even.
template <int N>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 2],
                                          bf16* out, int row, int col,
                                          int n_rows, int n_cols) {
  const bool pairs = (n_cols & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    if (r >= n_rows) continue;
    bf16* dst = out + static_cast<int64_t>(r) * n_cols;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = col + 8 * j;
      const float lo = acc[4 * j + 2 * i];
      const float hi = acc[4 * j + 2 * i + 1];
      if (pairs && c + 1 < n_cols) {
        *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(lo, hi);
      } else {
        if (c < n_cols) dst[c] = __float2bfloat16_rn(lo);
        if (c + 1 < n_cols) dst[c + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// ----------------------------------------------------------------- rings
//
// The mainloop K1, K2 and K3 share: a ring of kStages shared-memory stages,
// each holding the tiles of one reduction step (64 tokens for K1 and K3, 64
// of d for K2), consumed by two warpgroups in kSteps k16 products a stage.
//  * TMA ring, where every operand row is 16-byte aligned (a multiple of 8
//    elements): a ninth, producer warp issues each stage's boxes as soon as
//    the stage's "empty" mbarrier says all 8 consumer warps are done with
//    it, and the boxes complete on its "full" mbarrier. The consumers never
//    wait at a block barrier and walk the k16 steps of all stages as one
//    sequence.
//  * cp.async ring, for rows TMA cannot describe: all 256 threads copy, and
//    one block barrier a stage frees the stage copied into next.
// In both, the A operand of k16 step k+1 (`prep`: K1's swiglu, K3's h, a
// no-op for K2's shared-memory A) is formed while step k's products
// (`mma`) run: two A register sets, each kept live by an empty asm until
// its product is done, always indexed at compile time (a runtime index
// puts them in local memory).

template <bool kTma>
constexpr int kRingThreads = kTma ? kThreads + 32 : kThreads;

// The 1024-byte-aligned ring inside the dynamic shared memory (the
// 128-byte swizzle repeats every 1024 bytes; each stage starts on one).
__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
}

template <int kStages>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), kThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// A barrier of the two consumer warpgroups alone (the producer warp may
// have exited).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The producer (one lane): for each of n_steps steps waits until its stage
// is free, then issue(step, stage, full barrier) starts its copies.
template <int kStages, typename Issue>
__device__ __forceinline__ void ring_produce(uint64_t* full, uint64_t* empty,
                                             int n_steps, Issue issue) {
  for (int st = 0; st < n_steps; ++st) {
    const int buf = st % kStages;
    if (st >= kStages) {
      mbar_wait(smem_u32(&empty[buf]), (st / kStages - 1) & 1);
    }
    issue(st, buf, smem_u32(&full[buf]));
  }
}

// The consumers of the TMA ring over its first n_steps steps. A stage is
// released to the producer once its last product is done (the first step
// of the next stage); the last stage is not released.
template <int kStages, int kSteps, typename Prep, typename Mma>
__device__ __forceinline__ void ring_consume(uint64_t* full, uint64_t* empty,
                                             int n_steps, uint32_t (&a)[2][4],
                                             Prep prep, Mma mma) {
  static_assert(kSteps % 2 == 0, "A register sets alternate per k16 step");
  const bool leader = (threadIdx.x & 31) == 0;
  if (n_steps > 0) {
    mbar_wait(smem_u32(&full[0]), 0);
    prep(a[0], 0, 0);
  }
  for (int st = 0; st < n_steps; ++st) {
    const int buf = st % kStages;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      mma(a[kk & 1], buf, kk);
      wgmma_commit();
      // step kk - 1's products are done: its A registers, kept live up to
      // here, are free for step kk + 1, and after the last step of a stage
      // this warp is done with that stage
      wgmma_wait<1>();
      fence_operands(a[(kk + 1) & 1]);
      if (kk == 0 && st > 0 && leader) {
        mbar_arrive(smem_u32(&empty[(st - 1) % kStages]));
      }
      if (kk + 1 < kSteps) {
        prep(a[(kk + 1) & 1], buf, kk + 1);
      } else if (st + 1 < n_steps) {  // the next stage's first step
        const int next = (st + 1) % kStages;
        mbar_wait(smem_u32(&full[next]), ((st + 1) / kStages) & 1);
        prep(a[(kk + 1) & 1], next, 0);
      }
    }
  }
  wgmma_wait_all();
  fence_operands(a[0]);
  fence_operands(a[1]);
}

// The cp.async ring: load(step, stage) issues a stage's copies from every
// thread; the products as in ring_consume, one stage at a time.
template <int kStages, int kSteps, typename Load, typename Prep,
          typename Mma>
__device__ __forceinline__ void ring_cp_async(int n_steps,
                                              uint32_t (&a)[2][4], Load load,
                                              Prep prep, Mma mma) {
  static_assert(kSteps % 2 == 0, "A register sets alternate per k16 step");
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kStages - 2>();  // stage st has landed
    fence_async_shared();
    __syncthreads();  // ... for every thread; and stage st - 1 is free
    const int next = st + kStages - 1;
    if (next < n_steps) load(next, next % kStages);
    cp_async_commit();
    const int buf = st % kStages;
    prep(a[0], buf, 0);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      mma(a[kk & 1], buf, kk);
      wgmma_commit();
      wgmma_wait<1>();  // step kk - 1 is done (see ring_consume)
      fence_operands(a[(kk + 1) & 1]);
      if (kk + 1 < kSteps) prep(a[(kk + 1) & 1], buf, kk + 1);
    }
    wgmma_wait_all();
    fence_operands(a[0]);
    fence_operands(a[1]);
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------- K1
//
// dw_down_kernel: dW_down = swiglu(gate, up)^T . dy.
//  * a block owns a 128 (d_ff) x 256 (d) output tile, two warpgroups of
//    m64n256 (128 float32 accumulators a thread), so the swiglu of each
//    gate/up element is recomputed d/256 times (16 at d 4096) where the
//    TPU kernel's full-d rows compute it once;
//  * 64-token stages of gate and up [64 x 128] and dy [64 x 256] through a
//    three-stage ring (64 KB a stage; 8 TMA boxes). At the 8B shape (H100
//    SXM) the cp.async ring moved ~4.7 TB/s from L2 and held the kernel at
//    1.5 ms even with no swiglu at all; TMA took it to 1.28 ms and the
//    producer warp ~5% further. What holds it near 0.4 of its bound: the
//    swiglu's two special-function ops an element (~0.3 ms: a variant
//    without it took 0.97 ms) and 1 KB of tiles from L2 a token a block
//    (gate, up and dy: twice the A operand of a plain product).
//  * the swiglu is the register A operand, with no shared-memory round
//    trip: each warp ldmatrix.trans-loads its 16 d_ff rows x 16 tokens of
//    gate and of up (A(d_ff row, token) is the tile read transposed),
//    computes silu(g)*u in float32, rounds it to bf16 as the plain
//    version does and packs it into the 4 A registers of m64n256k16; B is
//    the dy tile read MN-major (tokens are the reduction rows, d is
//    contiguous).
// The sigmoid is __expf and __fdividef: silu(g)*u = g*u / (1 + exp(-g))
// with two special-function ops (ex2, rcp) an element, where expf and an
// IEEE division take more; its float32 value may differ from the plain
// version's in the last bits, and so its bf16 rounding by one ulp.

constexpr int kK1Rows = 128;  // d_ff rows a block (two warpgroups of 64)
constexpr int kK1Cols = 256;  // d columns a block
constexpr int kK1Tok = 64;    // tokens a stage
constexpr int kK1Stages = 3;
constexpr int kK1Gate = kK1Tok * kK1Rows * 2;  // bytes of a gate/up tile
constexpr int kK1Dy = kK1Tok * kK1Cols * 2;    // bytes of a dy tile
constexpr int kK1Stage = 2 * kK1Gate + kK1Dy;  // bytes a stage
constexpr size_t kK1SmemBytes = kK1Stages * kK1Stage + 1024;

// bf16(silu(g) * u) of two packed bf16 pairs, packed the same way.
__device__ __forceinline__ uint32_t swiglu2(uint32_t g2, uint32_t u2) {
  const float g0 = __uint_as_float(g2 << 16);
  const float g1 = __uint_as_float(g2 & 0xffff0000u);
  const float u0 = __uint_as_float(u2 << 16);
  const float u1 = __uint_as_float(u2 & 0xffff0000u);
  return pack_bf16(__fdividef(g0 * u0, 1.0f + __expf(-g0)),
                   __fdividef(g1 * u1, 1.0f + __expf(-g1)));
}

// The address this lane gives ldmatrix.trans for the A fragment of k16
// step kk of a [64 tokens x 128] tile whose 16 rows (of A) start at chunk
// `chunk`: token row 16kk + l%8 + 8(l/16) at chunk + (l/8)%2, so matrix i
// is a[i]'s 8 x 8 block (rows 0-7 | 8-15 of A x tokens 0-7 | 8-15).
__device__ __forceinline__ uint32_t a_trans_offset(int kk, int lane,
                                                   int chunk) {
  const int row = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
  return tile_offset<128, 64>(row, chunk + ((lane >> 3) & 1));
}

// K1's A fragment of k16 step kk: gate and up read transposed, then the
// swiglu in registers.
__device__ __forceinline__ void swiglu_fragment(uint32_t (&a)[4],
                                                uint32_t gate_tile,
                                                uint32_t up_tile, int kk,
                                                int lane, int chunk) {
  const uint32_t at = a_trans_offset(kk, lane, chunk);
  uint32_t g[4], u[4];
  ldmatrix_trans_x4(g, gate_tile + at);
  ldmatrix_trans_x4(u, up_tile + at);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = swiglu2(g[i], u[i]);
}

template <bool kTma>
__global__ void __launch_bounds__(kRingThreads<kTma>, 1)
    dw_down_kernel(const __grid_constant__ CUtensorMap tm_gate,
                   const __grid_constant__ CUtensorMap tm_up,
                   const __grid_constant__ CUtensorMap tm_dy,
                   const bf16* __restrict__ gate, const bf16* __restrict__ up,
                   const bf16* __restrict__ dy, bf16* __restrict__ dw_down,
                   int T, int d, int dff) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(ring_base(smem_raw));
  __shared__ __align__(8) uint64_t full[kK1Stages], empty[kK1Stages];

  const int n0 = blockIdx.x * kK1Cols;  // columns of dW_down: the d axis
  const int m0 = blockIdx.y * kK1Rows;  // rows of dW_down: the d_ff axis
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_steps = cdiv(T, kK1Tok);
  // this warp's 16 d_ff rows of the gate/up tiles, in 16-byte chunks
  const int chunk = wg * 8 + (warp & 3) * 2;
  auto stage_at = [&](int buf) { return ring + buf * kK1Stage; };

  float acc[kK1Cols / 2];
#pragma unroll
  for (int i = 0; i < kK1Cols / 2; ++i) acc[i] = 0.0f;
  uint32_t a[2][4] = {};
  auto prep = [&](uint32_t(&af)[4], int buf, int kk) {
    swiglu_fragment(af, stage_at(buf), stage_at(buf) + kK1Gate, kk, lane,
                    chunk);
  };
  auto mma = [&](const uint32_t(&af)[4], int buf, int kk) {
    fence_operands(acc);
    wgmma_fence();
    wgmma_rs_n256(acc, af,
                  mnmajor_desc<kK1Cols, kK1Tok>(stage_at(buf) + 2 * kK1Gate,
                                                kk));
  };

  if constexpr (kTma) {
    ring_init<kK1Stages>(full, empty);
    if (warp == kThreads / 32) {
      if (lane == 0) {
        ring_produce<kK1Stages>(
            full, empty, n_steps, [&](int st, int buf, uint32_t bar) {
              // two 64-column boxes of gate and of up, four of dy
              const uint32_t s = stage_at(buf);
              const int t0 = st * kK1Tok;
              mbar_expect_bytes(bar, kK1Stage);
#pragma unroll
              for (int i = 0; i < kK1Rows / kBox; ++i) {
                tma_load_2d(s + i * kBoxBytes, &tm_gate, m0 + kBox * i, t0,
                            bar);
                tma_load_2d(s + kK1Gate + i * kBoxBytes, &tm_up,
                            m0 + kBox * i, t0, bar);
              }
#pragma unroll
              for (int i = 0; i < kK1Cols / kBox; ++i) {
                tma_load_2d(s + 2 * kK1Gate + i * kBoxBytes, &tm_dy,
                            n0 + kBox * i, t0, bar);
              }
            });
      }
      return;
    }
    ring_consume<kK1Stages, kK1Tok / 16>(full, empty, n_steps, a, prep, mma);
  } else {
    const bool vec_f = (dff & 7) == 0;
    const bool vec_d = (d & 7) == 0;
    ring_cp_async<kK1Stages, kK1Tok / 16>(
        n_steps, a,
        [&](int st, int buf) {
          const uint32_t s = stage_at(buf);
          const int t0 = st * kK1Tok;
          load_tile_chunks<kK1Rows, kK1Tok>(s, gate, t0, m0, T, dff, vec_f);
          load_tile_chunks<kK1Rows, kK1Tok>(s + kK1Gate, up, t0, m0, T, dff,
                                            vec_f);
          load_tile_chunks<kK1Cols, kK1Tok>(s + 2 * kK1Gate, dy, t0, n0, T,
                                            d, vec_d);
        },
        prep, mma);
  }
  fence_operands(acc);

  store_acc<kK1Cols>(acc, dw_down,
                     m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2),
                     n0 + 2 * (lane & 3), dff, d);
}

// ------------------------------------------------------------------- K3
//
// dw_gateup_kernel: dW_gate = h^T . dgate and dW_up = h^T . dup, h =
// bf16((x * rstd) * norm_w).
//  * a block owns 128 d-rows x 128 d_ff-columns of both outputs; each
//    warpgroup takes 64 d-rows and keeps two m64n128 float32 accumulators
//    (gate and up: 128 floats a thread, as K1's one m64n256);
//  * 64-token stages of x [64 x 128 of d], dgate and dup [64 x 128 of
//    d_ff] (48 KB; 6 TMA boxes) and rstd of those tokens (256 bytes, one
//    1-D TMA box zero-filled past T, so padded tokens give h = 0), four
//    stages;
//  * h is the register A operand, formed like K1's swiglu: ldmatrix.trans
//    of the x tile gives A(d row, token), and (x * rstd[t]) * nw[i] in
//    float32, in that order, rounded to bf16, is bit for bit the plain
//    version's h (`normed`). nw of a thread's two d rows is loaded once
//    into registers, rstd read per k16 step from the stage. Each k16 step
//    issues two m64n128k16 products on the one A, B the dgate and the dup
//    tiles read MN-major (tokens are the reduction rows);
//  * tiles are issued in groups of 16 d-row tiles walking d_ff
//    (grouped_tile): with d_ff fastest a wave spans about all 112 d_ff
//    tiles of one d-row tile at the 8B shape and streams nearly all of
//    dgate and dup (235 MB) from device memory; grouped, ~33 MB a wave
//    (PERF.md gives the times with 1, 8 and 16 d-row tiles a group);
//  * on the TMA ring both output tiles leave by TMA stores from the freed
//    ring (see the epilogue).

constexpr int kK3Rows = 128;  // d rows a block (two warpgroups of 64)
constexpr int kK3Cols = 128;  // d_ff columns a block, of each output
constexpr int kK3Tok = 64;    // tokens a stage
constexpr int kK3Stages = 4;
constexpr int kK3Tile = kK3Tok * 128 * 2;  // bytes of an x, dgate or dup tile
constexpr int kK3Stage = 3 * kK3Tile;      // bytes a stage
constexpr int kK3Rstd = kK3Tok * 4;        // bytes of a stage's rstd
// the stages, then each stage's rstd (1024-aligned, so 256-byte slots)
constexpr size_t kK3SmemBytes = kK3Stages * (kK3Stage + kK3Rstd) + 1024;
static_assert(kK3Rows == 128 && kK3Cols == 128, "x/dgate tile offsets");

// bf16((x * r) * w) of a packed bf16 pair of x (two tokens), r their two
// rstd values, w the row's norm weight; packed the same way.
__device__ __forceinline__ uint32_t h2(uint32_t x2, float2 r, float w) {
  const float x0 = __uint_as_float(x2 << 16);
  const float x1 = __uint_as_float(x2 & 0xffff0000u);
  return pack_bf16(x0 * r.x * w, x1 * r.y * w);
}

// K3's A fragment of k16 step kk: the x tile read transposed, then h with
// this thread's tokens' rstd (16kk + 2t, +1, +8, +9; t = lane % 4) and its
// two rows' norm weights w0 (row g) and w1 (row g + 8).
__device__ __forceinline__ void h_fragment(uint32_t (&a)[4], uint32_t x_tile,
                                           uint32_t rstd, int kk, int lane,
                                           int chunk, float w0, float w1) {
  uint32_t x[4];
  ldmatrix_trans_x4(x, x_tile + a_trans_offset(kk, lane, chunk));
  const uint32_t at = rstd + 4 * (16 * kk + 2 * (lane & 3));
  float2 r0, r1;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(r0.x), "=f"(r0.y)
               : "r"(at));
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(r1.x), "=f"(r1.y)
               : "r"(at + 32));
  a[0] = h2(x[0], r0, w0);
  a[1] = h2(x[1], r0, w1);
  a[2] = h2(x[2], r1, w0);
  a[3] = h2(x[3], r1, w1);
}

template <bool kTma>
__global__ void __launch_bounds__(kRingThreads<kTma>, 1)
    dw_gateup_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_dgate,
                     const __grid_constant__ CUtensorMap tm_dup,
                     const __grid_constant__ CUtensorMap tm_rstd,
                     const __grid_constant__ CUtensorMap tm_dw_gate,
                     const __grid_constant__ CUtensorMap tm_dw_up,
                     const bf16* __restrict__ x,
                     const float* __restrict__ rstd,
                     const bf16* __restrict__ norm_w,
                     const bf16* __restrict__ dgate,
                     const bf16* __restrict__ dup, bf16* __restrict__ dw_gate,
                     bf16* __restrict__ dw_up, int T, int d, int dff) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(ring_base(smem_raw));
  __shared__ __align__(8) uint64_t full[kK3Stages], empty[kK3Stages];

  int mt, nt;
  grouped_tile(blockIdx.x, cdiv(d, kK3Rows), cdiv(dff, kK3Cols), mt, nt);
  const int m0 = mt * kK3Rows;  // rows of dW: the d axis
  const int n0 = nt * kK3Cols;  // columns of dW: the d_ff axis
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_steps = cdiv(T, kK3Tok);
  // this warp's 16 d rows of the x tile, in 16-byte chunks
  const int chunk = wg * 8 + (warp & 3) * 2;
  auto stage_at = [&](int buf) { return ring + buf * kK3Stage; };
  auto rstd_at = [&](int buf) {
    return ring + kK3Stages * kK3Stage + buf * kK3Rstd;
  };

  // norm_w of this thread's two d rows (rows of A: g and g + 8)
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const float w0 = row < d ? __bfloat162float(norm_w[row]) : 0.0f;
  const float w1 = row + 8 < d ? __bfloat162float(norm_w[row + 8]) : 0.0f;

  float acc_g[kK3Cols / 2], acc_u[kK3Cols / 2];
#pragma unroll
  for (int i = 0; i < kK3Cols / 2; ++i) {
    acc_g[i] = 0.0f;
    acc_u[i] = 0.0f;
  }
  // Both accumulators' zeros settle here: left to the compiler, acc_u's
  // were set between the first products, and ptxas then serialized every
  // product of the kernel (its C7515 note; 1.85 ms against 1.58 at the 8B
  // shape, H100 SXM).
  fence_operands(acc_g);
  fence_operands(acc_u);
  uint32_t a[2][4] = {};
  auto prep = [&](uint32_t(&af)[4], int buf, int kk) {
    h_fragment(af, stage_at(buf), rstd_at(buf), kk, lane, chunk, w0, w1);
  };
  auto mma = [&](const uint32_t(&af)[4], int buf, int kk) {
    fence_operands(acc_g);
    fence_operands(acc_u);
    wgmma_fence();
    wgmma_rs_n128(acc_g, af,
                  mnmajor_desc<kK3Cols, kK3Tok>(stage_at(buf) + kK3Tile, kk));
    wgmma_rs_n128(
        acc_u, af,
        mnmajor_desc<kK3Cols, kK3Tok>(stage_at(buf) + 2 * kK3Tile, kk));
  };

  if constexpr (kTma) {
    ring_init<kK3Stages>(full, empty);
    if (warp == kThreads / 32) {
      if (lane == 0) {
        ring_produce<kK3Stages>(
            full, empty, n_steps, [&](int st, int buf, uint32_t bar) {
              // two 64-column boxes each of x, dgate and dup, and rstd
              const uint32_t s = stage_at(buf);
              const int t0 = st * kK3Tok;
              mbar_expect_bytes(bar, kK3Stage + kK3Rstd);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                tma_load_2d(s + i * kBoxBytes, &tm_x, m0 + kBox * i, t0, bar);
                tma_load_2d(s + kK3Tile + i * kBoxBytes, &tm_dgate,
                            n0 + kBox * i, t0, bar);
                tma_load_2d(s + 2 * kK3Tile + i * kBoxBytes, &tm_dup,
                            n0 + kBox * i, t0, bar);
              }
              tma_load_1d(rstd_at(buf), &tm_rstd, t0, bar);
            });
      }
      return;
    }
    ring_consume<kK3Stages, kK3Tok / 16>(full, empty, n_steps, a, prep, mma);
  } else {
    const bool vec_x = (d & 7) == 0;
    const bool vec_f = (dff & 7) == 0;
    ring_cp_async<kK3Stages, kK3Tok / 16>(
        n_steps, a,
        [&](int st, int buf) {
          const uint32_t s = stage_at(buf);
          const int t0 = st * kK3Tok;
          load_tile_chunks<128, kK3Tok>(s, x, t0, m0, T, d, vec_x);
          load_tile_chunks<128, kK3Tok>(s + kK3Tile, dgate, t0, n0, T, dff,
                                        vec_f);
          load_tile_chunks<128, kK3Tok>(s + 2 * kK3Tile, dup, t0, n0, T,
                                        dff, vec_f);
          if (threadIdx.x < kK3Tok) {  // rstd, 0 past T
            const int t = t0 + threadIdx.x;
            cp_async4(rstd_at(buf) + 4 * threadIdx.x, rstd + (t < T ? t : 0),
                      t < T);
          }
        },
        prep, mma);
  }
  fence_operands(acc_g);
  fence_operands(acc_u);

  if constexpr (kTma) {
    // Both tiles as bf16 into the ring (free once both warpgroups' products
    // are done), in the 128-byte-swizzled 64 x 64 boxes a TMA load would
    // give (4-byte stores, no bank conflicts), then one thread stores the
    // eight boxes by TMA, clipped at the matrices' edges: 1.58 ms a launch
    // at the 8B shape against 1.68-1.71 with each thread storing its
    // 4-byte pairs straight from registers (H100 SXM).
    consumer_sync();
    // boxes 0-3 dW_gate, 4-7 dW_up, each (row block, column block) 2 x 2
    auto stage_tile = [&](const float(&acc)[kK3Cols / 2], int first_box) {
      const int r_loc = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r_loc + 8 * i;
#pragma unroll
        for (int j = 0; j < kK3Cols / 8; ++j) {
          const int box = first_box + (r / kBox) * 2 + j / 8;
          const uint32_t at = ring + box * kBoxBytes + (r % kBox) * 128 +
                              (((j % 8) ^ (r & 7)) << 4) + 4 * (lane & 3);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                       "r"(pack_bf16(acc[4 * j + 2 * i],
                                     acc[4 * j + 2 * i + 1]))
                       : "memory");
        }
      }
    };
    stage_tile(acc_g, 0);
    stage_tile(acc_u, 4);
    fence_async_shared();
    consumer_sync();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int box = 0; box < 8; ++box) {
        tma_store_2d(box < 4 ? &tm_dw_gate : &tm_dw_up,
                     n0 + kBox * (box % 2), m0 + kBox * (box % 4 / 2),
                     ring + box * kBoxBytes);
      }
      tma_store_drain();
    }
  } else {
    const int col = n0 + 2 * (lane & 3);
    store_acc<kK3Cols>(acc_g, dw_gate, row, col, d, dff);
    store_acc<kK3Cols>(acc_u, dw_up, row, col, d, dff);
  }
}

// ------------------------------------------------------------------- K2
//
// dgateup_kernel: d_s = dy . W_down^T in float32, never stored, then
// dgate = d_s*up*silu'(gate) and dup = d_s*silu(gate).
//  * a block owns 128 tokens x 256 d_ff columns, two warpgroups of m64n256
//    (128 float32 accumulators a thread), rather than 128 x 128 at two
//    blocks an SM: 87 FLOP a byte of tiles streamed from L2 against 64,
//    and L2 is what such a product waits on here (K1);
//  * both operands are K-major (d is contiguous in dy [T, d] and in W_down
//    [d_ff, d]), so the mainloop is a plain shared-memory product: 64-of-d
//    stages of dy [128 x 64] and W_down [256 x 64] (48 KB, 6 TMA boxes),
//    four stages, wgmma with both descriptors in shared memory;
//  * the epilogue reads gate and up and writes dgate and dup (4 x 117 MB
//    at the 8B shape): on the TMA ring the producer loads the block's gate
//    and up tiles [128 x 256] (16 boxes, 128 KB) into the first three
//    stages that free up after the mainloop's last, so they arrive while
//    the last products run and the epilogue reads them from shared memory
//    (swizzled, no bank conflicts). The cp.async ring reads them from
//    device memory in the epilogue. d_s is staged through shared memory,
//    so the epilogue is a loop, a warp a row (see there);
//  * the sigmoid is expf and an IEEE division, once per output element,
//    as in the plain version;
//  * tiles are issued in groups of 16 token tiles walking d_ff
//    (grouped_tile): with d_ff fastest every wave streams all of W_down
//    (117 MB) from device memory.

constexpr int kK2Rows = 128;  // tokens a block (two warpgroups of 64)
constexpr int kK2Cols = 256;  // d_ff columns a block
constexpr int kK2Depth = 64;  // d a stage
constexpr int kK2Stages = 4;
constexpr int kK2A = kK2Rows * kK2Depth * 2;  // bytes of a dy tile
constexpr int kK2B = kK2Cols * kK2Depth * 2;  // bytes of a W_down tile
constexpr int kK2Stage = kK2A + kK2B;         // bytes a stage
constexpr int kK2BoxesPerStage = kK2Stage / kBoxBytes;
// gate and up tiles of the epilogue, in 64 x 64 boxes, and the ring stages
// they take after the mainloop's
constexpr int kK2GateBoxes = (kK2Rows / kBox) * (kK2Cols / kBox);
constexpr int kK2EpiSteps =
    (2 * kK2GateBoxes + kK2BoxesPerStage - 1) / kK2BoxesPerStage;
constexpr size_t kK2SmemBytes = kK2Stages * kK2Stage + 1024;
// each epilogue step waits for a stage whose last mainloop use the
// consumers release; they release all but the last stage
static_assert(kK2EpiSteps <= kK2Stages - 1, "epilogue stages free up");

__device__ __forceinline__ void swiglu_vjp2(float2 ds, uint32_t g2,
                                            uint32_t u2, float (&dg)[2],
                                            float (&du)[2]) {
  const float g[2] = {__uint_as_float(g2 << 16),
                      __uint_as_float(g2 & 0xffff0000u)};
  const float u[2] = {__uint_as_float(u2 << 16),
                      __uint_as_float(u2 & 0xffff0000u)};
  const float d[2] = {ds.x, ds.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float s = sigmoid(g[i]);
    dg[i] = d[i] * u[i] * (s * (1.0f + g[i] * (1.0f - s)));
    du[i] = d[i] * (g[i] * s);
  }
}

// Two bf16 of a row (element c, c + 1; the second 0 past the row) packed
// as a pair.
__device__ __forceinline__ uint32_t load_pair(const bf16* row, int c,
                                              int n_cols, bool pairs) {
  if (pairs && c + 1 < n_cols) {
    return *reinterpret_cast<const uint32_t*>(row + c);
  }
  const uint32_t lo = __bfloat16_as_ushort(row[c]);
  const uint32_t hi = c + 1 < n_cols ? __bfloat16_as_ushort(row[c + 1]) : 0;
  return lo | (hi << 16);
}

template <bool kTma>
__global__ void __launch_bounds__(kRingThreads<kTma>, 1)
    dgateup_kernel(const __grid_constant__ CUtensorMap tm_dy,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_gate,
                   const __grid_constant__ CUtensorMap tm_up,
                   const bf16* __restrict__ dy,
                   const bf16* __restrict__ w_down,
                   const bf16* __restrict__ gate, const bf16* __restrict__ up,
                   bf16* __restrict__ dgate, bf16* __restrict__ dup, int T,
                   int d, int dff) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring_ptr = ring_base(smem_raw);
  const uint32_t ring = smem_u32(ring_ptr);
  __shared__ __align__(8) uint64_t full[kK2Stages], empty[kK2Stages];

  int mt, nt;
  grouped_tile(blockIdx.x, cdiv(T, kK2Rows), cdiv(dff, kK2Cols), mt, nt);
  const int m0 = mt * kK2Rows;  // rows of dgate/dup: tokens
  const int n0 = nt * kK2Cols;  // columns: the d_ff axis
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_steps = cdiv(d, kK2Depth);
  auto stage_at = [&](int buf) { return ring + buf * kK2Stage; };

  float acc[kK2Cols / 2];
#pragma unroll
  for (int i = 0; i < kK2Cols / 2; ++i) acc[i] = 0.0f;
  uint32_t a[2][4] = {};  // no register A operand: both in shared memory
  auto prep = [](uint32_t(&)[4], int, int) {};
  // the product of k16 step kk of a stage: A this warpgroup's 64 token rows
  // of the dy tile, B the W_down tile, both K-major
  auto mma = [&](const uint32_t(&)[4], int buf, int kk) {
    fence_operands(acc);
    wgmma_fence();
    wgmma_ss_n256(
        acc,
        kmajor_desc<kK2Depth, kK2Rows>(stage_at(buf) + wg * 64 * 128, kk),
        kmajor_desc<kK2Depth, kK2Cols>(stage_at(buf) + kK2A, kk));
  };

  if constexpr (kTma) {
    ring_init<kK2Stages>(full, empty);
    if (warp == kThreads / 32) {
      if (lane == 0) {
        ring_produce<kK2Stages>(
            full, empty, n_steps + kK2EpiSteps,
            [&](int st, int buf, uint32_t bar) {
              const uint32_t s = stage_at(buf);
              if (st < n_steps) {  // two boxes of dy, four of W_down
                const int k0 = st * kK2Depth;
                mbar_expect_bytes(bar, kK2Stage);
#pragma unroll
                for (int i = 0; i < kK2Rows / kBox; ++i) {
                  tma_load_2d(s + i * kBoxBytes, &tm_dy, k0, m0 + kBox * i,
                              bar);
                }
#pragma unroll
                for (int i = 0; i < kK2Cols / kBox; ++i) {
                  tma_load_2d(s + kK2A + i * kBoxBytes, &tm_w, k0,
                              n0 + kBox * i, bar);
                }
              } else {  // the epilogue's gate and up boxes
                const int b0 = (st - n_steps) * kK2BoxesPerStage;
                const int nb = min(2 * kK2GateBoxes - b0, kK2BoxesPerStage);
                mbar_expect_bytes(bar, nb * kBoxBytes);
                for (int i = 0; i < nb; ++i) {
                  const int b = (b0 + i) % kK2GateBoxes;  // token-block major
                  tma_load_2d(s + i * kBoxBytes,
                              b0 + i < kK2GateBoxes ? &tm_gate : &tm_up,
                              n0 + kBox * (b % (kK2Cols / kBox)),
                              m0 + kBox * (b / (kK2Cols / kBox)), bar);
                }
              }
            });
      }
      return;
    }
    ring_consume<kK2Stages, kK2Depth / 16>(full, empty, n_steps, a, prep,
                                           mma);
  } else {
    const bool vec_d = (d & 7) == 0;
    ring_cp_async<kK2Stages, kK2Depth / 16>(
        n_steps, a,
        [&](int st, int buf) {
          const uint32_t s = stage_at(buf);
          const int k0 = st * kK2Depth;
          load_tile_chunks<kK2Depth, kK2Rows>(s, dy, m0, k0, T, d, vec_d);
          load_tile_chunks<kK2Depth, kK2Cols>(s + kK2A, w_down, n0, k0, dff,
                                              d, vec_d);
        },
        prep, mma);
  }
  fence_operands(acc);

  // Epilogue: d_s goes through shared memory 64 columns at a time (into a
  // ring stage free by now: the mainloop's last on the TMA ring, whose
  // other three hold the gate/up boxes), and the swiglu VJP runs in a loop
  // over rows, a warp a row: each lane's two columns, 128 contiguous bytes
  // of dgate and of dup a warp. Unrolled over a thread's 128 accumulators
  // instead, with its IEEE divisions, the epilogue took 0.67 ms of the
  // kernel's 1.49 at the 8B shape (H100 SXM).
  constexpr int kCb = 64;       // d_ff columns staged at a time
  constexpr int kLd = kCb + 8;  // floats a staged row: no bank conflicts
  static_assert(kK2Rows * kLd * 4 <= kK2Stage, "a staged block fits");
  float* ds = reinterpret_cast<float*>(
      ring_ptr + (kTma ? (n_steps + kK2Stages - 1) % kK2Stages : 0) *
                     kK2Stage);
  if constexpr (kTma) {
#pragma unroll
    for (int e = 0; e < kK2EpiSteps; ++e) {
      const int st = n_steps + e;
      mbar_wait(smem_u32(&full[st % kK2Stages]), (st / kK2Stages) & 1);
    }
  }
  const int rl = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const bool pairs = (dff & 1) == 0;
#pragma unroll
  for (int cb = 0; cb < kK2Cols / kCb; ++cb) {
    // both warpgroups' products are done (cb 0), or every warp has read
    // the previous block
    consumer_sync();
#pragma unroll
    for (int jj = 0; jj < kCb / 8; ++jj) {
      const int j = cb * (kCb / 8) + jj;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<float2*>(ds + (rl + 8 * i) * kLd + 8 * jj +
                                   2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    consumer_sync();
    const int c_loc = cb * kCb + 2 * lane;
    const int c = n0 + c_loc;
#pragma unroll 2
    for (int r_loc = warp; r_loc < kK2Rows; r_loc += kThreads / 32) {
      const int r = m0 + r_loc;
      if (r >= T || c >= dff) continue;
      const int64_t off = static_cast<int64_t>(r) * dff + c;
      uint32_t g2, u2;
      if constexpr (kTma) {
        // box b of gate (b + kK2GateBoxes of up) in epilogue step b / 6,
        // slot b % 6; 128-byte swizzle inside the box
        const int b = (r_loc / kBox) * (kK2Cols / kBox) + cb;
        const int bu = b + kK2GateBoxes;
        const int in_box = (r_loc % kBox) * 128 +
                           (((lane >> 2) ^ (r_loc & 7)) << 4) +
                           (lane & 3) * 4;
        const uint32_t at_g =
            stage_at((n_steps + b / kK2BoxesPerStage) % kK2Stages) +
            (b % kK2BoxesPerStage) * kBoxBytes + in_box;
        const uint32_t at_u =
            stage_at((n_steps + bu / kK2BoxesPerStage) % kK2Stages) +
            (bu % kK2BoxesPerStage) * kBoxBytes + in_box;
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(g2) : "r"(at_g));
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(u2) : "r"(at_u));
      } else {
        g2 = load_pair(gate + off - c, c, dff, pairs);
        u2 = load_pair(up + off - c, c, dff, pairs);
      }
      float dg[2], du[2];
      swiglu_vjp2(*reinterpret_cast<const float2*>(ds + r_loc * kLd +
                                                   2 * lane),
                  g2, u2, dg, du);
      if (pairs && c + 1 < dff) {
        *reinterpret_cast<uint32_t*>(dgate + off) = pack_bf16(dg[0], dg[1]);
        *reinterpret_cast<uint32_t*>(dup + off) = pack_bf16(du[0], du[1]);
      } else {
        dgate[off] = __float2bfloat16_rn(dg[0]);
        dup[off] = __float2bfloat16_rn(du[0]);
        if (c + 1 < dff) {
          dgate[off + 1] = __float2bfloat16_rn(dg[1]);
          dup[off + 1] = __float2bfloat16_rn(du[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------- float32 K1, K2, K3
//
// K1, K2 and K3 for float32 operands and outputs (the reference keeps the
// model's dtype, fused_ffn.py:264 on). Every product is an FMA on the CUDA
// cores in float32: TF32 would keep ~3 digits, and the kernels are held
// within 1e-4 of their plain versions. Bound on an H100: float32 operations
// (67 TFLOP/s).
//
// One SIMT mainloop, C[m][n] = sum_k A(m, k) B(k, n), serves all three:
//  * a block of 256 threads owns a kB x kB output tile (kB 128 or 64),
//    each thread a (kB/16) x (kB/16) patch: rows 4ty + r + 64i, columns
//    4tx + c + 64j (ty, tx = thread / 16, thread % 16). Both operands sit
//    in shared memory k-major ([k][m] and [k][n], rows padded by 4 floats),
//    so each k reads a thread's A and B as float4s: at kB 128, 4 vector
//    loads for 64 FMAs (the first SIMT design read 8 scalars for 16). A
//    k row's float4 reads are one address for A (a broadcast) and 16
//    consecutive ones for B: no bank conflicts.
//  * a ring of kF32Stages stages of 16 of k, filled by 16-byte cp.async
//    (element by element and zero-filled at ragged edges and in rows that
//    are not 16-byte aligned, as copy_chunk does for bf16), one block
//    barrier a stage: stages st + 1 and st + 2 load while st multiplies.
//  * `land(step, stage)` runs on each thread's own chunks of a stage once
//    they have arrived (cp.async.wait_group makes a thread's own copies
//    visible to it), before the barrier that releases the stage: K1's
//    swiglu and K3's h = (x*rstd)*norm_w, once per element per block, and
//    K2's transpose of its d-contiguous operands into the k-major tiles.
//  * the tile and a split of the reduction are planned on the host
//    (fused_ffn.py `f32_plan`): 128 x 128 tiles where those alone fill a
//    wave of 132 SMs, else 64 x 64, and where those do not either, the
//    reduction cut into S slices of whole stages (slice s: stages
//    [s n / S, (s + 1) n / S) of n, `f32_slices`), grid (tiles, S). With
//    S > 1 each block writes its float32 partial tile to a workspace
//    [S, M, N] (allocated by the wrapper), and a second kernel sums the S
//    partials in slice order and applies the epilogue (K2's swiglu VJP) to
//    the sum. K3's two products are blocks of one grid (tiles, S, 2) over
//    a workspace [S, 2, d, d_ff], summed by one launch into the two halves
//    of one [2, d, d_ff] output. No atomics: every call gives the same
//    bits. A second kernel
//    rather than the last block of a tile found by a counter: no counters
//    to keep at zero across calls and streams, no fences, and it costs one
//    launch on shapes that are launch-bound anyway. One wrapper call
//    launches one kernel (S = 1) or two.
//  * tiles are issued in groups (grouped_tile), so that a wave's blocks
//    share operand rows in L2 (112 x 32 tiles of 128 at the 8B shape).
// At the 8B shape K1 and K2 reach ~0.58 of the float32 bound, two blocks an
// SM (127-128 registers a thread). What holds them there is not shared memory
// (halving the float4 reads gained 1-2%), occupancy (two blocks an SM, as
// planned), the copies (K2's transposes cost 6.5%) or a missing register
// prefetch of the next k (0.2%); 16 x 8 patches at 128 threads, one block
// an SM without the register cap, four stages and 32-deep stages were all
// slower (PERF.md).

constexpr int kF32K = 16;  // of the reduction a stage
constexpr int kF32Stages = 3;

template <int kB>
struct F32Tile {
  static constexpr int kP = kB / 16;             // a thread's patch: kP x kP
  static constexpr int kLd = kB + 4;             // floats a k row
  static constexpr int kFloats = kF32K * kLd;    // a k-major tile
  static constexpr int kRawLd = kF32K + 4;       // floats an m row (K2)
  static constexpr int kRaw = kB * kRawLd;       // an m-major tile (K2)
  static constexpr int kChunks = kB * kF32K / 4 / kThreads;  // a thread's
  static_assert(kB == 64 || kB == 128, "4 x 4 or 8 x 8 patches");
};

// K1: three k-major tiles a stage (gate, up, dy); K2: two m-major tiles a
// stage (dy, W_down) and two pairs of k-major tiles they are transposed
// into (one pair per stage in flight: see f32_mainloop).
template <int kB>
constexpr size_t kK1F32Smem = kF32Stages * 3 * F32Tile<kB>::kFloats * 4;
template <int kB>
constexpr size_t kK2F32Smem =
    (kF32Stages * 2 * F32Tile<kB>::kRaw + 2 * 2 * F32Tile<kB>::kFloats) * 4;
// K3: two k-major tiles a stage (x, then h; dgate or dup).
template <int kB>
constexpr size_t kK3F32Smem = kF32Stages * 2 * F32Tile<kB>::kFloats * 4;

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four floats src[0..4) into shared memory at dst: by cp.async when the row
// is 16-byte aligned (`vec`) and all 4 are in range, zero-filled when none
// is, else element by element.
__device__ __forceinline__ void copy4_f32(uint32_t dst, const float* src,
                                          int left, bool vec) {
  if (left <= 0 || (vec && left >= 4)) {
    cp_async16(dst, src, left > 0);
  } else {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = i < left ? src[i] : 0.0f;
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "f"(e[0]), "f"(e[1]), "f"(e[2]), "f"(e[3])
                 : "memory");
  }
}

// Chunk it of this thread in a [16 x kB] k-major tile: k row `k`, columns
// c .. c + 3 (a warp copies 512 contiguous bytes).
template <int kB>
__device__ __forceinline__ void kmajor_chunk(int it, int& k, int& c) {
  const int e = threadIdx.x + it * kThreads;
  k = e / (kB / 4);
  c = 4 * (e % (kB / 4));
}

// Rows [k0, k0 + 16) x columns [c0, c0 + kB) of a row-major
// [n_rows, n_cols] matrix into a k-major tile, zeros past the matrix (a
// stage that lies inside an aligned matrix skips the checks: 1% at the 8B
// shape).
template <int kB>
__device__ __forceinline__ void copy_kmajor(float* tile, const float* src,
                                            int k0, int c0, int n_rows,
                                            int n_cols, bool vec) {
  const bool whole = vec && k0 + kF32K <= n_rows && c0 + kB <= n_cols;
#pragma unroll
  for (int it = 0; it < F32Tile<kB>::kChunks; ++it) {
    int k, c;
    kmajor_chunk<kB>(it, k, c);
    const int row = k0 + k;
    const uint32_t dst = smem_u32(tile + k * F32Tile<kB>::kLd + c);
    if (whole) {
      cp_async16(dst, src + static_cast<int64_t>(row) * n_cols + c0 + c,
                 true);
      continue;
    }
    const int left = row < n_rows ? n_cols - (c0 + c) : 0;
    const int64_t off =
        left > 0 ? static_cast<int64_t>(row) * n_cols + c0 + c : 0;
    copy4_f32(dst, src + off, left, vec);
  }
}

// Chunk it of this thread in a [kB x 16] m-major tile: row m, k .. k + 3. A
// warp takes 16 rows x 32 bytes (whole sectors); its transposed stores
// (k rows 4 apart: 16 banks apart at kLd = kB + 4) then hit all 32 banks,
// and its float4 reads of the rows (kRawLd 20) all 8 bank groups.
template <int kB>
__device__ __forceinline__ void mmajor_chunk(int it, int& m, int& k) {
  const int e = threadIdx.x + it * kThreads;
  const int g = e / 32;
  m = 16 * (g % (kB / 16)) + e % 16;
  k = 4 * (2 * (g / (kB / 16)) + (e / 16) % 2);
}

// Rows [r0, r0 + kB) x k [k0, k0 + 16) of a row-major [n_rows, n_k]
// matrix into an m-major tile, zeros past the matrix (checks skipped as
// in copy_kmajor).
template <int kB>
__device__ __forceinline__ void copy_mmajor(float* raw, const float* src,
                                            int r0, int k0, int n_rows,
                                            int n_k, bool vec) {
  const bool whole = vec && r0 + kB <= n_rows && k0 + kF32K <= n_k;
#pragma unroll
  for (int it = 0; it < F32Tile<kB>::kChunks; ++it) {
    int m, k;
    mmajor_chunk<kB>(it, m, k);
    const int row = r0 + m;
    const uint32_t dst = smem_u32(raw + m * F32Tile<kB>::kRawLd + k);
    if (whole) {
      cp_async16(dst, src + static_cast<int64_t>(row) * n_k + k0 + k, true);
      continue;
    }
    const int left = row < n_rows ? n_k - (k0 + k) : 0;
    const int64_t off =
        left > 0 ? static_cast<int64_t>(row) * n_k + k0 + k : 0;
    copy4_f32(dst, src + off, left, vec);
  }
}

// This thread's chunks of an m-major tile into the k-major tile.
template <int kB>
__device__ __forceinline__ void transpose_own(const float* raw,
                                              float* tile) {
  using Tl = F32Tile<kB>;
#pragma unroll
  for (int it = 0; it < Tl::kChunks; ++it) {
    int m, k;
    mmajor_chunk<kB>(it, m, k);
    const float4 v =
        *reinterpret_cast<const float4*>(raw + m * Tl::kRawLd + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) tile[(k + i) * Tl::kLd + m] = lane4(v, i);
  }
}

// Stages [first, first + count) of the cdiv(K, 16) stages of the reduction:
// slice blockIdx.y of gridDim.y (fused_ffn.py `f32_slices`).
__device__ __forceinline__ void f32_slice(int K, int& first, int& count) {
  const int64_t n = cdiv(K, kF32K);
  first = static_cast<int>(blockIdx.y * n / gridDim.y);
  count = static_cast<int>((blockIdx.y + 1) * n / gridDim.y) - first;
}

// The mainloop over stages [st0, st0 + n_steps): load(step, stage) issues a
// stage's copies, land(step, stage) finishes this thread's own chunks of it
// once they are in, tiles(step, stage, a, b) names the k-major A and B tiles
// the products read. acc comes back as this thread's patch.
template <int kB, typename Load, typename Land, typename Tiles>
__device__ __forceinline__ void f32_mainloop(int st0, int n_steps,
                                             float (&acc)[kB / 16][kB / 16],
                                             Load load, Land land,
                                             Tiles tiles) {
  using Tl = F32Tile<kB>;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < Tl::kP; ++i) {
#pragma unroll
    for (int j = 0; j < Tl::kP; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll
  for (int st = 0; st < kF32Stages - 1; ++st) {
    if (st < n_steps) load(st0 + st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    const int buf = st % kF32Stages;
    cp_async_wait<kF32Stages - 2>();  // this thread's copies of stage st
    land(st, buf);
    // every thread's stage st is in and landed; stage st - 1 is free
    __syncthreads();
    const int next = st + kF32Stages - 1;
    if (next < n_steps) load(st0 + next, next % kF32Stages);
    cp_async_commit();
    const float* a;
    const float* b;
    tiles(st, buf, a, b);
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float4 x[Tl::kP / 4], y[Tl::kP / 4];
#pragma unroll
      for (int q = 0; q < Tl::kP / 4; ++q) {
        x[q] = *reinterpret_cast<const float4*>(a + kk * Tl::kLd + 4 * ty +
                                                64 * q);
        y[q] = *reinterpret_cast<const float4*>(b + kk * Tl::kLd + 4 * tx +
                                                64 * q);
      }
#pragma unroll
      for (int i = 0; i < Tl::kP; ++i) {
#pragma unroll
        for (int j = 0; j < Tl::kP; ++j) {
          acc[i][j] = fmaf(lane4(x[i / 4], i % 4), lane4(y[j / 4], j % 4),
                           acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// f(m, n, v) for each 4-column group of this thread's patch in range: row
// m < M, columns n .. n + 3 (those at or past N to be dropped).
template <int kB, typename F>
__device__ __forceinline__ void for_patch(const float (&acc)[kB / 16][kB / 16],
                                          int m0, int n0, int M, int N, F f) {
  constexpr int kP = kB / 16;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int m = m0 + 4 * ty + i % 4 + 64 * (i / 4);
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < kP / 4; ++q) {
      const int n = n0 + 4 * tx + 64 * q;
      if (n >= N) continue;
      f(m, n,
        make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                    acc[i][4 * q + 3]));
    }
  }
}

// Elements i .. i + 3 of a float32 array of n: one 16-byte access where the
// array's rows are aligned (`vec`) and all 4 are in range; zeros past n.
__device__ __forceinline__ float4 load4(const float* p, int64_t i, int64_t n,
                                        bool vec) {
  if (vec && i + 4 <= n) return *reinterpret_cast<const float4*>(p + i);
  return make_float4(p[i], i + 1 < n ? p[i + 1] : 0.0f,
                     i + 2 < n ? p[i + 2] : 0.0f,
                     i + 3 < n ? p[i + 3] : 0.0f);
}

__device__ __forceinline__ void store4(float* p, int64_t i, int64_t n,
                                       float4 v, bool vec) {
  if (vec && i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = v;
    return;
  }
  p[i] = v.x;
  if (i + 1 < n) p[i + 1] = v.y;
  if (i + 2 < n) p[i + 2] = v.z;
  if (i + 3 < n) p[i + 3] = v.w;
}

// K1's A operand: silu(g) * u, in the plain swiglu_act's order, the
// sigmoid by __expf and __fdividef (two special-function ops). With expf
// and an IEEE division, whose slow path ptxas keeps as a call, it cost 2.4
// of the kernel's 15.0 ms at the 8B shape, and its call spilled registers
// (PERF.md); in float32 the two differ in the last bits.
__device__ __forceinline__ float swiglu_f32(float g, float u) {
  return (g * __fdividef(1.0f, 1.0f + __expf(-g))) * u;
}

// K2's epilogue on four elements: dgate = d_s*up*silu'(gate), dup =
// d_s*silu(gate), in the plain version's order (_dsilu, fused_ffn.py).
__device__ __forceinline__ void swiglu_vjp4(float4 ds, float4 g, float4 u,
                                            float4& dg, float4& du) {
  float a[4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = lane4(g, i);
    const float s = sigmoid(x);
    a[i] = lane4(ds, i) * lane4(u, i) * (s * (1.0f + x * (1.0f - s)));
    b[i] = lane4(ds, i) * (x * s);
  }
  dg = make_float4(a[0], a[1], a[2], a[3]);
  du = make_float4(b[0], b[1], b[2], b[3]);
}

// K1: dW_down [d_ff, d] = swiglu(gate, up)^T . dy: M = d_ff, N = d, the
// reduction over the T tokens. gate/up [T, d_ff] and dy [T, d] are
// token-major, so every tile is a plain k-major copy; the swiglu overwrites
// the gate tile as it lands (once per element per block: d / kB times in
// all, 32 at the 8B shape).
template <int kB>
__global__ void __launch_bounds__(kThreads, 2)
    dw_down_f32_kernel(const float* __restrict__ gate,
                       const float* __restrict__ up,
                       const float* __restrict__ dy,
                       float* __restrict__ dw_down, float* __restrict__ ws,
                       int T, int d, int dff) {
  using Tl = F32Tile<kB>;
  extern __shared__ __align__(16) float smem_f32[];
  int mt, nt;
  grouped_tile(blockIdx.x, cdiv(dff, kB), cdiv(d, kB), mt, nt);
  const int m0 = mt * kB;  // rows of dW_down: the d_ff axis
  const int n0 = nt * kB;  // columns: the d axis
  int st0, n_steps;
  f32_slice(T, st0, n_steps);
  const bool vec_f = (dff & 3) == 0;
  const bool vec_d = (d & 3) == 0;
  // a stage: the gate (then swiglu), up and dy tiles
  auto stage = [&](int buf) { return smem_f32 + buf * 3 * Tl::kFloats; };
  float acc[Tl::kP][Tl::kP];
  f32_mainloop<kB>(
      st0, n_steps, acc,
      [&](int st, int buf) {
        float* s = stage(buf);
        const int k0 = st * kF32K;
        copy_kmajor<kB>(s, gate, k0, m0, T, dff, vec_f);
        copy_kmajor<kB>(s + Tl::kFloats, up, k0, m0, T, dff, vec_f);
        copy_kmajor<kB>(s + 2 * Tl::kFloats, dy, k0, n0, T, d, vec_d);
      },
      [&](int, int buf) {
        float* s = stage(buf);
#pragma unroll
        for (int it = 0; it < Tl::kChunks; ++it) {
          int k, c;
          kmajor_chunk<kB>(it, k, c);
          float4* g = reinterpret_cast<float4*>(s + k * Tl::kLd + c);
          const float4 u = *reinterpret_cast<const float4*>(
              s + Tl::kFloats + k * Tl::kLd + c);
          const float4 v = *g;
          *g = make_float4(swiglu_f32(v.x, u.x), swiglu_f32(v.y, u.y),
                           swiglu_f32(v.z, u.z), swiglu_f32(v.w, u.w));
        }
      },
      [&](int, int buf, const float*& a, const float*& b) {
        a = stage(buf);
        b = stage(buf) + 2 * Tl::kFloats;
      });
  float* out = gridDim.y > 1
                   ? ws + static_cast<int64_t>(blockIdx.y) * dff * d
                   : dw_down;
  for_patch<kB>(acc, m0, n0, dff, d, [&](int m, int n, float4 v) {
    store4(out + static_cast<int64_t>(m) * d, n, d, v, vec_d);
  });
}

// K2: d_s [T, d_ff] = dy . W_down^T, then the swiglu VJP: M = T, N = d_ff,
// the reduction over d. dy [T, d] and W_down [d_ff, d] are both
// d-contiguous, so each stage lands as two m-major tiles that every thread
// transposes (its own chunks) into a k-major pair. d_s stays in registers
// (S = 1) or in the workspace's partials (S > 1); the VJP runs on the whole
// sum only.
template <int kB>
__global__ void __launch_bounds__(kThreads, 2)
    dgateup_f32_kernel(const float* __restrict__ dy,
                       const float* __restrict__ w_down,
                       const float* __restrict__ gate,
                       const float* __restrict__ up,
                       float* __restrict__ dgate, float* __restrict__ dup,
                       float* __restrict__ ws, int T, int d, int dff) {
  using Tl = F32Tile<kB>;
  extern __shared__ __align__(16) float smem_f32[];
  int mt, nt;
  grouped_tile(blockIdx.x, cdiv(T, kB), cdiv(dff, kB), mt, nt);
  const int m0 = mt * kB;  // rows of dgate/dup: tokens
  const int n0 = nt * kB;  // columns: the d_ff axis
  int st0, n_steps;
  f32_slice(d, st0, n_steps);
  const bool vec_d = (d & 3) == 0;
  const bool vec_f = (dff & 3) == 0;
  // the stages' m-major dy and W_down tiles, then the two k-major pairs:
  // stage st's pair is written (land) while other threads may still read
  // stage st - 1's, and every thread is past st - 2's products by then
  auto raw = [&](int buf) { return smem_f32 + buf * 2 * Tl::kRaw; };
  auto kmaj = [&](int st) {
    return smem_f32 + kF32Stages * 2 * Tl::kRaw + (st & 1) * 2 * Tl::kFloats;
  };
  float acc[Tl::kP][Tl::kP];
  f32_mainloop<kB>(
      st0, n_steps, acc,
      [&](int st, int buf) {
        const int k0 = st * kF32K;
        copy_mmajor<kB>(raw(buf), dy, m0, k0, T, d, vec_d);
        copy_mmajor<kB>(raw(buf) + Tl::kRaw, w_down, n0, k0, dff, d, vec_d);
      },
      [&](int st, int buf) {
        transpose_own<kB>(raw(buf), kmaj(st));
        transpose_own<kB>(raw(buf) + Tl::kRaw, kmaj(st) + Tl::kFloats);
      },
      [&](int st, int, const float*& a, const float*& b) {
        a = kmaj(st);
        b = kmaj(st) + Tl::kFloats;
      });
  if (gridDim.y > 1) {
    float* part = ws + static_cast<int64_t>(blockIdx.y) * T * dff;
    for_patch<kB>(acc, m0, n0, T, dff, [&](int m, int n, float4 v) {
      store4(part + static_cast<int64_t>(m) * dff, n, dff, v, vec_f);
    });
    return;
  }
  for_patch<kB>(acc, m0, n0, T, dff, [&](int m, int n, float4 v) {
    const int64_t row = static_cast<int64_t>(m) * dff;
    float4 dg, du;
    swiglu_vjp4(v, load4(gate + row, n, dff, vec_f),
                load4(up + row, n, dff, vec_f), dg, du);
    store4(dgate + row, n, dff, dg, vec_f);
    store4(dup + row, n, dff, du, vec_f);
  });
}

// K3: dW_gate (blockIdx.z 0) or dW_up (1) [d, d_ff] = h^T . dgate|dup, h =
// (x*rstd)*norm_w: M = d, N = d_ff, the reduction over the T tokens. x [T,
// d] and dgate/dup [T, d_ff] are token-major, so both tiles are plain
// k-major copies (K1's layout). h is formed where x lands, in the plain
// version's order (fused_ffn.py `normed`), once per element per block:
// norm_w at the block's kB columns is loaded once into shared memory, and
// each chunk's token's rstd is read from L1, where the stage's load put
// its 16 values (a prefetch: no register holds them across the stages).
// Each block makes one of the two products and recomputes h: both in one
// block would need two 8 x 8 accumulators a thread, over the 128-register
// budget of two blocks an SM, which this kernel fills as K1 does.
template <int kB>
__global__ void __launch_bounds__(kThreads, 2)
    dw_gateup_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ rstd,
                         const float* __restrict__ norm_w,
                         const float* __restrict__ dgate,
                         const float* __restrict__ dup,
                         float* __restrict__ dw_gate,
                         float* __restrict__ dw_up, float* __restrict__ ws,
                         int T, int d, int dff) {
  using Tl = F32Tile<kB>;
  extern __shared__ __align__(16) float smem_f32[];
  int mt, nt;
  grouped_tile(blockIdx.x, cdiv(d, kB), cdiv(dff, kB), mt, nt);
  const int m0 = mt * kB;  // rows of dW: the d axis
  const int n0 = nt * kB;  // columns: the d_ff axis
  int st0, n_steps;
  f32_slice(T, st0, n_steps);
  const bool vec_d = (d & 3) == 0;
  const bool vec_f = (dff & 3) == 0;
  __shared__ __align__(16) float s_norm_w[kB];
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    s_norm_w[i] = m0 + i < d ? norm_w[m0 + i] : 0.0f;
  }
  __syncthreads();
  // a stage: the x (then h) tile, the dgate|dup tile, the chunks' rstd
  auto stage = [&](int buf) { return smem_f32 + buf * 2 * Tl::kFloats; };
  float acc[Tl::kP][Tl::kP];
  f32_mainloop<kB>(
      st0, n_steps, acc,
      [&](int st, int buf) {
        float* s = stage(buf);
        const int k0 = st * kF32K;
        copy_kmajor<kB>(s, x, k0, m0, T, d, vec_d);
        // a parameter in each branch: a selected pointer would hold two
        // registers through the mainloop, and spilled
        if (blockIdx.z) {
          copy_kmajor<kB>(s + Tl::kFloats, dup, k0, n0, T, dff, vec_f);
        } else {
          copy_kmajor<kB>(s + Tl::kFloats, dgate, k0, n0, T, dff, vec_f);
        }
        if (threadIdx.x == 0) {  // 64 aligned bytes: one L1 line
          asm volatile("prefetch.global.L1 [%0];\n" ::"l"(rstd + k0));
        }
      },
      [&](int st, int buf) {
        float* s = stage(buf);
        const int k0 = (st0 + st) * kF32K;
#pragma unroll
        for (int it = 0; it < Tl::kChunks; ++it) {
          int k, cc;
          kmajor_chunk<kB>(it, k, cc);
          float4* h = reinterpret_cast<float4*>(s + k * Tl::kLd + cc);
          const float r = k0 + k < T ? __ldg(rstd + k0 + k) : 0.0f;
          const float4 w = *reinterpret_cast<const float4*>(s_norm_w + cc);
          const float4 v = *h;
          *h = make_float4(v.x * r * w.x, v.y * r * w.y, v.z * r * w.z,
                           v.w * r * w.w);
        }
      },
      [&](int, int buf, const float*& a, const float*& b) {
        a = stage(buf);
        b = stage(buf) + Tl::kFloats;
      });
  float* out = gridDim.y > 1
                   ? ws + (static_cast<int64_t>(blockIdx.y) * 2 + blockIdx.z)
                              * d * dff
                   : (blockIdx.z ? dw_up : dw_gate);
  for_patch<kB>(acc, m0, n0, d, dff, [&](int m, int n, float4 v) {
    store4(out + static_cast<int64_t>(m) * dff, n, dff, v, vec_f);
  });
}

// The S partials of elements i .. i + 3 of a workspace [S, n], summed in
// slice order.
__device__ __forceinline__ float4 sum_slices(const float* ws, int S,
                                             int64_t n, int64_t i,
                                             bool vec) {
  float4 v = load4(ws, i, n, vec);
  for (int s = 1; s < S; ++s) {
    const float4 p = load4(ws + s * n, i, n, vec);
    v = make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
  }
  return v;
}

// K1 and K3 with S > 1: the output = the sum of the partials (4 elements a
// thread).
__global__ void __launch_bounds__(kThreads)
    split_sum_f32_kernel(const float* __restrict__ ws, int S, int64_t n,
                         float* __restrict__ out) {
  const int64_t i =
      4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (i >= n) return;
  const bool vec = (n & 3) == 0;
  store4(out, i, n, sum_slices(ws, S, n, i, vec), vec);
}

// K2 with S > 1: the swiglu VJP on the sum of the partials of d_s.
__global__ void __launch_bounds__(kThreads)
    split_vjp_f32_kernel(const float* __restrict__ ws, int S, int64_t n,
                         const float* __restrict__ gate,
                         const float* __restrict__ up,
                         float* __restrict__ dgate,
                         float* __restrict__ dup) {
  const int64_t i =
      4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (i >= n) return;
  const bool vec = (n & 3) == 0;
  float4 dg, du;
  swiglu_vjp4(sum_slices(ws, S, n, i, vec), load4(gate, i, n, vec),
              load4(up, i, n, vec), dg, du);
  store4(dgate, i, n, dg, vec);
  store4(dup, i, n, du, vec);
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
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a float32 vector of n elements in boxes of 64 (256
// bytes, no swizzle), zeros past its end.
cudaError_t encode_f32_vector_map(CUtensorMap* map, const void* ptr, int n) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};  // unread
  const cuuint32_t box[1] = {kBox};
  const cuuint32_t steps[1] = {1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lets `kernel` take `bytes` of dynamic shared memory, then launches it on
// `grid` blocks of `threads`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
           void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The number of output tiles of an n_m x n_n grid issued along one axis,
// or -1 past the grid's limit.
int linear_tiles(int rows, int tile_rows, int cols, int tile_cols) {
  const int64_t n = static_cast<int64_t>((rows + tile_rows - 1) / tile_rows) *
                    ((cols + tile_cols - 1) / tile_cols);
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// The plan fused_ffn.py `f32_plan` chose for an M x N product over K: a
// tile of 128 or 64, 1 <= splits <= max(1, cdiv(K, 16)) (and at most
// 65535), a workspace [splits, M, N] where splits > 1. Returns the number
// of output tiles, or -1 for a plan the kernels do not take.
int f32_tiles(int M, int N, int K, int tile, int splits, const void* ws) {
  const int stages = (K + kF32K - 1) / kF32K;
  if ((tile != 128 && tile != 64) || splits < 1 || splits > 65535 ||
      splits > (stages > 1 ? stages : 1) || (splits > 1 && ws == nullptr)) {
    return -1;
  }
  return linear_tiles(M, tile, N, tile);
}

// Blocks of kThreads for the split kernels' 4 elements a thread.
unsigned split_blocks(int64_t n) {
  return static_cast<unsigned>((n + 4 * kThreads - 1) / (4 * kThreads));
}

}  // namespace

extern "C" {

// x [T, d] bf16, rstd [T] float32, norm_w [d] bf16, dgate/dup [T, d_ff]
// bf16, all row-major and 16-byte aligned; dw_gate/dw_up [d, d_ff] bf16.
// Returns a CUDA error code (0 = ok).
int rt_dw_gateup(const void* x, const void* rstd, const void* norm_w,
                 const void* dgate, const void* dup, void* dw_gate,
                 void* dw_up, int T, int d, int dff, void* stream) {
  const int tiles = linear_tiles(d, kK3Rows, dff, kK3Cols);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  // TMA needs row strides that are multiples of 16 bytes
  const bool tma = T > 0 && d % 8 == 0 && dff % 8 == 0;
  CUtensorMap maps[6] = {};
  if (tma) {
    cudaError_t err = encode_bf16_map(&maps[0], x, T, d);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[1], dgate, T, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[2], dup, T, dff);
    if (err == cudaSuccess) err = encode_f32_vector_map(&maps[3], rstd, T);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[4], dw_gate, d, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[5], dw_up, d, dff);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch(tma ? dw_gateup_kernel<true> : dw_gateup_kernel<false>,
                dim3(tiles), tma ? kRingThreads<true> : kRingThreads<false>,
                kK3SmemBytes, stream, maps[0], maps[1], maps[2], maps[3],
                maps[4], maps[5],
                static_cast<const bf16*>(x), static_cast<const float*>(rstd),
                static_cast<const bf16*>(norm_w),
                static_cast<const bf16*>(dgate),
                static_cast<const bf16*>(dup), static_cast<bf16*>(dw_gate),
                static_cast<bf16*>(dw_up), T, d, dff);
}

// gate/up [T, d_ff], dy [T, d] bf16, row-major and 16-byte aligned;
// dw_down [d_ff, d] bf16.
int rt_dw_down(const void* gate, const void* up, const void* dy,
               void* dw_down, int T, int d, int dff, void* stream) {
  if ((dff + kK1Rows - 1) / kK1Rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tma = T > 0 && dff % 8 == 0 && d % 8 == 0;
  CUtensorMap maps[3] = {};
  if (tma) {
    cudaError_t err = encode_bf16_map(&maps[0], gate, T, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[1], up, T, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[2], dy, T, d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch(tma ? dw_down_kernel<true> : dw_down_kernel<false>,
                dim3((d + kK1Cols - 1) / kK1Cols,
                     (dff + kK1Rows - 1) / kK1Rows),
                tma ? kRingThreads<true> : kRingThreads<false>, kK1SmemBytes,
                stream, maps[0], maps[1], maps[2],
                static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
                static_cast<const bf16*>(dy), static_cast<bf16*>(dw_down), T,
                d, dff);
}

// dy [T, d], w_down [d_ff, d], gate/up [T, d_ff] bf16, row-major and
// 16-byte aligned; dgate/dup [T, d_ff] bf16.
int rt_dgateup(const void* dy, const void* w_down, const void* gate,
               const void* up, void* dgate, void* dup, int T, int d, int dff,
               void* stream) {
  const int tiles = linear_tiles(T, kK2Rows, dff, kK2Cols);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = T > 0 && d > 0 && d % 8 == 0 && dff % 8 == 0;
  CUtensorMap maps[4] = {};
  if (tma) {
    cudaError_t err = encode_bf16_map(&maps[0], dy, T, d);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[1], w_down, dff, d);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[2], gate, T, dff);
    if (err == cudaSuccess) err = encode_bf16_map(&maps[3], up, T, dff);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch(tma ? dgateup_kernel<true> : dgateup_kernel<false>,
                dim3(tiles), tma ? kRingThreads<true> : kRingThreads<false>,
                kK2SmemBytes, stream, maps[0], maps[1], maps[2], maps[3],
                static_cast<const bf16*>(dy),
                static_cast<const bf16*>(w_down),
                static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
                static_cast<bf16*>(dgate), static_cast<bf16*>(dup), T, d,
                dff);
}

// The same three entries for float32 operands and outputs (rstd float32),
// each also taking the plan of fused_ffn.py `f32_plan` (tile, splits) and,
// where splits > 1, its float32 workspace: [splits, M, N] (M x N = d_ff x
// d for K1, T x d_ff for K2), [splits, 2, d, d_ff] for K3, whose dw_up
// must then follow dw_gate in memory (one [2, d, d_ff] output).
int rt_dw_gateup_f32(const void* x, const void* rstd, const void* norm_w,
                     const void* dgate, const void* dup, void* dw_gate,
                     void* dw_up, void* ws, int T, int d, int dff, int tile,
                     int splits, void* stream) {
  const int tiles = f32_tiles(d, dff, T, tile, splits, ws);
  auto* dg = static_cast<float*>(dw_gate);
  auto* du = static_cast<float*>(dw_up);
  const int64_t n = 2 * static_cast<int64_t>(d) * dff;
  if (tiles < 0 || (splits > 1 && du != dg + n / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(tiles, splits, 2);
  const auto* xx = static_cast<const float*>(x);
  const auto* r = static_cast<const float*>(rstd);
  const auto* nw = static_cast<const float*>(norm_w);
  const auto* g = static_cast<const float*>(dgate);
  const auto* u = static_cast<const float*>(dup);
  auto* w = static_cast<float*>(ws);
  const int err =
      tile == 128
          ? launch(dw_gateup_f32_kernel<128>, grid, kThreads,
                   kK3F32Smem<128>, stream, xx, r, nw, g, u, dg, du, w, T, d,
                   dff)
          : launch(dw_gateup_f32_kernel<64>, grid, kThreads, kK3F32Smem<64>,
                   stream, xx, r, nw, g, u, dg, du, w, T, d, dff);
  if (err != 0 || splits == 1) return err;
  split_sum_f32_kernel<<<split_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w, splits, n,
                                                              dg);
  return static_cast<int>(cudaGetLastError());
}

int rt_dw_down_f32(const void* gate, const void* up, const void* dy,
                   void* dw_down, void* ws, int T, int d, int dff, int tile,
                   int splits, void* stream) {
  const int tiles = f32_tiles(dff, d, T, tile, splits, ws);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, splits);
  const auto* g = static_cast<const float*>(gate);
  const auto* u = static_cast<const float*>(up);
  const auto* y = static_cast<const float*>(dy);
  auto* out = static_cast<float*>(dw_down);
  auto* w = static_cast<float*>(ws);
  const int err =
      tile == 128
          ? launch(dw_down_f32_kernel<128>, grid, kThreads, kK1F32Smem<128>,
                   stream, g, u, y, out, w, T, d, dff)
          : launch(dw_down_f32_kernel<64>, grid, kThreads, kK1F32Smem<64>,
                   stream, g, u, y, out, w, T, d, dff);
  if (err != 0 || splits == 1) return err;
  const int64_t n = static_cast<int64_t>(dff) * d;
  split_sum_f32_kernel<<<split_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w, splits, n,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

int rt_dgateup_f32(const void* dy, const void* w_down, const void* gate,
                   const void* up, void* dgate, void* dup, void* ws, int T,
                   int d, int dff, int tile, int splits, void* stream) {
  const int tiles = f32_tiles(T, dff, d, tile, splits, ws);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, splits);
  const auto* y = static_cast<const float*>(dy);
  const auto* wd = static_cast<const float*>(w_down);
  const auto* g = static_cast<const float*>(gate);
  const auto* u = static_cast<const float*>(up);
  auto* dg = static_cast<float*>(dgate);
  auto* du = static_cast<float*>(dup);
  auto* w = static_cast<float*>(ws);
  const int err =
      tile == 128
          ? launch(dgateup_f32_kernel<128>, grid, kThreads, kK2F32Smem<128>,
                   stream, y, wd, g, u, dg, du, w, T, d, dff)
          : launch(dgateup_f32_kernel<64>, grid, kThreads, kK2F32Smem<64>,
                   stream, y, wd, g, u, dg, du, w, T, d, dff);
  if (err != 0 || splits == 1) return err;
  const int64_t n = static_cast<int64_t>(T) * dff;
  split_vjp_f32_kernel<<<split_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w, splits, n, g,
                                                              u, dg, du);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
