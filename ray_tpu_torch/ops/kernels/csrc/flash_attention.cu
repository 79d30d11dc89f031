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
//    dq, 64 rows elsewhere) and loops over the reduction axis inside the
//    block (the TPU's sequential grid axis does not exist
//    here). No atomics: forward and dq blocks own query tiles, dk/dv blocks
//    own key tiles, so results are deterministic.
//  * Scores, probabilities and the softmax state stay float32; p and ds are
//    rounded to bf16 only as operands of the accumulating products, as the
//    TPU kernels cast them.
//  * Causal masks are end-aligned (key col <= row + sk - sq) and key blocks
//    entirely above the band are skipped; the ragged key tail is masked with
//    -1e30, and rows past sq or sk are zero-filled when a tile is loaded, so
//    no product ever reads garbage (0 * NaN would poison a sum). l >= 1e-30
//    guards rows that saw no key.
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
// The bf16 forward and dq kernels share one query-stationary mainloop
// (see "query-stationary mainloop" below): two warpgroups, wgmma products
// with P and dS as register operands, the scores, probabilities and output
// accumulator never leaving registers, and K/V streamed through a
// two-stage cp.async ring. The bf16 dk/dv kernel keeps the first design
// (nvcuda::wmma over shared-memory tiles); the float32 kernels are plain
// tiled SIMT code with CUDA-core FMAs (no TF32, which keeps ~3 digits).
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
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kLdS = kBK + 4;  // float32 score tiles (dk/dv)
constexpr int kLdP = kBK + 8;  // bf16 probability tiles (dk/dv)

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
// [q0, q0 + rows): key block kb is needed iff kb*kBK <= q0 + rows - 1 +
// offset.
__device__ __forceinline__ int key_blocks(int q0, int sk, int offset,
                                          int causal, int rows = kBQ) {
  int n = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + rows - 1 + offset;
    const int lim = last < 0 ? 0 : last / kBK + 1;
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

// ------------------------------------------------------- async copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats as bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// the forward and 129 KB in dq at d 128, one block an SM.

constexpr int kWgRows = 128;  // query rows a block: two warpgroups of 64
constexpr int kWgThreads = 256;

// The products. A warp's part of an accumulator D (m64nN) is its 16 rows:
// for lane 4g + t, d[4j], d[4j + 1] hold row g, columns 8j + 2t, 8j + 2t
// + 1, and d[4j + 2], d[4j + 3] the same columns of row g + 8. A register
// A operand (m64k16) is the warp's 16 rows the same way: a[0] | a[1] rows
// g | g + 8 at columns 2t, 2t + 1, a[2] | a[3] at columns 2t + 8, 2t + 9.
// Every product accumulates (its predicate is 1): callers zero D first.

// D[64 x 64] += A . B, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A . B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A . B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A . B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Tile layouts the descriptors read. D >= 64: 128-byte swizzle, the tile
// cut into column blocks of 64 elements (kRows x 128 bytes each), row r's
// 16-byte chunk c at chunk c ^ (r % 8) of its 128-byte row (tiles
// 1024-byte aligned). D = 32: no swizzle, 8 x 8 core matrices (8 rows of
// 16 bytes, 128 contiguous bytes), row-group major.
template <int D>
constexpr bool kSwizzled = D >= 64;

// Byte offset of 16-byte chunk `chunk` of row `row` in a kRows-row tile.
template <int D, int kRows>
__device__ __forceinline__ int tile_offset(int row, int chunk) {
  if constexpr (kSwizzled<D>) {
    return (chunk >> 3) * kRows * 128 + row * 128 +
           (((chunk & 7) ^ (row & 7)) << 4);
  } else {
    return ((row >> 3) * (D / 8) + chunk) * 128 + (row & 7) * 16;
  }
}

// kRows rows of an [n, D] bf16 matrix (rows ld apart) into a tile by
// cp.async, rows >= n zero-filled. Swizzled: a row's chunks go to one
// 128-byte row, so the writes of 8 threads cover 8 banks groups; core
// matrices: each pair of threads reads 32 contiguous bytes and each 16
// threads write 256 contiguous bytes.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int n, int64_t ld) {
  constexpr int kChunks = kRows * D / 8;
  static_assert(kChunks % kWgThreads == 0, "whole 16-byte moves");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < kChunks / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads;
    int r, chunk;
    if constexpr (kSwizzled<D>) {
      r = i / (D / 8);
      chunk = i % (D / 8);
    } else {
      r = ((i >> 4) / (D / 16)) * 8 + ((i >> 1) & 7);
      chunk = ((i >> 4) % (D / 16)) * 2 + (i & 1);
    }
    const bool valid = row0 + r < n;
    const bf16* from =
        valid ? src + (static_cast<int64_t>(row0) + r) * ld + chunk * 8 : src;
    cp_async16(base + tile_offset<D, kRows>(r, chunk), from, valid);
  }
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), and the layout (1: 128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swz << 62);
}

// Descriptor of the k16 step kk of a K-major kRows-row tile (rows are M or
// N, the reduction runs along D): Q and K.
template <int D, int kRows>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  if constexpr (kSwizzled<D>) {
    return smem_desc(tile + (kk >> 2) * kRows * 128 + (kk & 3) * 32, 16,
                     1024, 1);
  } else {
    return smem_desc(tile + kk * 256, 128, (D / 8) * 128, 0);
  }
}

// Descriptor of the k16 step kk (rows 16 kk..) of an MN-major kRows-row
// tile (the reduction runs along the rows, N along D): V.
template <int D, int kRows>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  if constexpr (kSwizzled<D>) {
    return smem_desc(tile + kk * 2048, kRows * 128, 1024, 1);
  } else {
    return smem_desc(tile + kk * 2 * (D / 8) * 128, (D / 8) * 128, 128, 0);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, desc);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, desc);
  } else {
    wgmma_rs_n128(o, a, desc);
  }
}

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
    // this thread's copies, visible to the products' (async) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
      wgmma_pv<D>(o, pa[kk], mnmajor_desc<D, kBK>(smem_u32(tV), kk));
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

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, 2 x (K, V), and room to align the tiles to 1024 bytes
  return sizeof(bf16) * (2 * kWgRows + 4 * kBK) * D + 1024;
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
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* sO = sQ + kWgRows * D;  // dO
  bf16* sK = sO + kWgRows * D;  // two stages
  bf16* sV = sK + 2 * kTile;    // two stages

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
  if (n_kb > 0) {
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
    const bf16* tK = sK + (kb & 1) * kTile;
    const bf16* tV = sV + (kb & 1) * kTile;
    if (kb + 1 < n_kb) {  // the next tile loads while this one computes
      load_tile_async<D, kBK>(sK + ((kb + 1) & 1) * kTile, k + koff,
                              k0 + kBK, sk, ldk);
      load_tile_async<D, kBK>(sV + ((kb + 1) & 1) * kTile, v + koff,
                              k0 + kBK, sk, ldk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kb (Q, dO)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
      wgmma_pv<D>(acc, pa[kk], mnmajor_desc<D, kBK>(smem_u32(tK), kk));
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

// ------------------------------------------------------------ dk/dv (bf16)

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (2 * kBQ + 2 * kBK) * (D + 8)  // Q, dO, K, V
         + sizeof(float) * 2 * kBQ * kLdS              // scores, dP
         + sizeof(bf16) * 2 * kBQ * kLdP               // P, dS
         + sizeof(float) * 2 * kBQ;                    // lse, delta
}

// Shared layout of the dk/dv kernel.
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
// the valid entries (0 elsewhere), written as bf16 to t.p and t.ds.
template <int D>
__device__ __forceinline__ void recompute_p_ds(const BwdTiles<D>& t, int q0,
                                               int k0, int sq, int sk,
                                               float scale, int causal) {
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
    prow[c] = __float2bfloat16_rn(p);
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
      recompute_p_ds<D>(t, q0, k0, sq, sk, scale, causal);
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

// ----------------------------------------------------------------- float32
//
// The three kernels for float32 operands and outputs: plain tiled SIMT
// code, one block of 256 threads per 64-row output tile (as the bf16
// kernels), tiles in shared memory with rows padded to D + 1 floats, and
// every product an FMA on the CUDA cores in float32 (TF32 would keep ~3
// digits). Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 and
// columns tx + 16j of each 64-wide tile. Bound on an H100: float32
// operations (67 TFLOP/s outside the tensor cores).

constexpr int kF32Threads = 256;
constexpr int kLdF = kBK + 1;  // float32 [64][64] tiles

// Rows [row0, row0 + 64) of an [n, D] float32 matrix (rows ld apart) into
// a [64][D + 1] tile; rows >= n become zeros.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int n, int64_t ld) {
  for (int i = threadIdx.x; i < kBQ * D; i += kF32Threads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < n ? src[(static_cast<int64_t>(row0) + r) * ld + c] : 0.0f;
  }
}

__device__ __forceinline__ void load_vec_f32(float* dst, const float* src,
                                             int row0, int n) {
  for (int i = threadIdx.x; i < kBQ; i += kF32Threads) {
    dst[i] = row0 + i < n ? src[row0 + i] : 0.0f;
  }
}

// c[i][j] = A[4ty + i] . B[tx + 16j] over D, A and B [64][D + 1] tiles.
template <int D>
__device__ __forceinline__ void rows_dot_rows_f32(const float* a,
                                                  const float* b,
                                                  float (&c)[4][4]) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(4 * ty + i) * (D + 1) + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(x[i], y[j], c[i][j]);
    }
  }
}

// acc[i][j] += W[4ty + i][:] . T[:][tx + 16j], W a [64][kLdF] tile and T
// a [64][D + 1] tile.
template <int D>
__device__ __forceinline__ void weights_times_rows_f32(
    const float* w, const float* t, float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w[(4 * ty + i) * kLdF + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float y = t[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst,
                                               const float (&acc)[4][D / 16],
                                               int row0, int n, int64_t ld,
                                               const float* row_scale) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (row0 + r >= n) continue;
    const float f = row_scale ? row_scale[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dst[(static_cast<int64_t>(row0) + r) * ld + tx + 16 * j] =
          acc[i][j] * f;
    }
  }
}

template <int D>
constexpr size_t fwd_f32_smem_bytes() {
  return sizeof(float) * (3 * kBQ * (D + 1)  // Q, K, V
                          + kBQ * kLdF        // scores, then p
                          + 3 * kBQ);         // m, l, alpha (1/l at the end)
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int sq, int sk, int n_rep,
                         float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kBQ * (D + 1);
  float* sV = sK + kBK * (D + 1);
  float* sS = sV + kBK * (D + 1);
  float* sM = sS + kBQ * kLdF;
  float* sL = sM + kBQ;
  float* sAlpha = sL + kBQ;

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal);

  load_rows_f32<D>(sQ, q + qoff, q0, sq, ldq);
  for (int i = threadIdx.x; i < kBQ; i += kF32Threads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }
  float o[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[i][j] = 0.0f;
  }
  // softmax layout: four lanes per row, 16 columns each
  const int sr = threadIdx.x >> 2;
  const int quarter = threadIdx.x & 3;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32<D>(sK, k + koff, k0, sk, ldk);
    load_rows_f32<D>(sV, v + koff, k0, sk, ldk);
    __syncthreads();
    float c[4][4];
    rows_dot_rows_f32<D>(sQ, sK, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i;
        const int col = k0 + tx + 16 * j;
        sS[r * kLdF + tx + 16 * j] =
            attends(q0 + r, col, sk, offset, causal) ? c[i][j] * scale
                                                     : kNegInf;
      }
    }
    __syncthreads();
    float* srow = sS + sr * kLdF + quarter * 16;
    float mx = kNegInf;
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) mx = fmaxf(mx, srow[cc]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_prev = sM[sr];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) {
      const float p = expf(srow[cc] - m_new);
      srow[cc] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m_prev - m_new);
    __syncwarp();  // the row's four lanes have read sM
    if (quarter == 0) {
      sM[sr] = m_new;
      sL[sr] = sL[sr] * alpha + sum;
      sAlpha[sr] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[4 * ty + i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) o[i][j] *= a;
    }
    weights_times_rows_f32<D>(sS, sV, o);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ; i += kF32Threads) {
    const float l = fmaxf(sL[i], 1e-30f);
    if (q0 + i < sq) lse[row_off + q0 + i] = sM[i] + logf(l);
    sAlpha[i] = 1.0f / l;
  }
  __syncthreads();
  store_rows_f32<D>(out + qoff, o, q0, sq, ldq, sAlpha);
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * (4 * kBQ * (D + 1)  // Q, dO, K, V
                          + kBQ * kLdF        // ds
                          + 2 * kBQ);         // lse, delta
}

// p = exp(s*scale - lse), ds = p*(dp - delta)*scale on the entries a row
// attends (0 elsewhere), for the thread's 4 x 4 patch (rows 4ty + i of
// the query tile, columns tx + 16j of the key tile, or transposed).
__device__ __forceinline__ float ds_f32(float s, float dp, float lse,
                                        float delta, float scale, bool valid,
                                        float* p_out) {
  const float p = valid ? expf(s * scale - lse) : 0.0f;
  if (p_out) *p_out = p;
  return valid ? p * (dp - delta) * scale : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int sq, int sk, int n_rep,
                            float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + kBQ * (D + 1);
  float* sK = sO + kBQ * (D + 1);
  float* sV = sK + kBK * (D + 1);
  float* sDS = sV + kBK * (D + 1);
  float* sLse = sDS + kBQ * kLdF;
  float* sDelta = sLse + kBQ;

  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int batch = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(heads / n_rep) * D;
  const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
  const int64_t koff =
      static_cast<int64_t>(batch) * sk * ldk + (head / n_rep) * D;
  const int64_t row_off = (static_cast<int64_t>(batch) * heads + head) * sq;
  const int offset = sk - sq;
  const int n_kb = key_blocks(q0, sk, offset, causal);

  load_rows_f32<D>(sQ, q + qoff, q0, sq, ldq);
  load_rows_f32<D>(sO, dout + qoff, q0, sq, ldq);
  load_vec_f32(sLse, lse + row_off, q0, sq);
  load_vec_f32(sDelta, delta + row_off, q0, sq);
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();
    load_rows_f32<D>(sK, k + koff, k0, sk, ldk);
    load_rows_f32<D>(sV, v + koff, k0, sk, ldk);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot_rows_f32<D>(sQ, sK, s);
    rows_dot_rows_f32<D>(sO, sV, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = q0 + r < sq &&
                           attends(q0 + r, k0 + tx + 16 * j, sk, offset,
                                   causal);
        sDS[r * kLdF + tx + 16 * j] = ds_f32(s[i][j], dp[i][j], sLse[r],
                                             sDelta[r], scale, valid,
                                             nullptr);
      }
    }
    __syncthreads();
    weights_times_rows_f32<D>(sDS, sK, acc);  // dq += ds.k
  }
  store_rows_f32<D>(dq + qoff, acc, q0, sq, ldq, nullptr);
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) * (4 * kBQ * (D + 1)  // K, V, Q, dO
                          + 2 * kBK * kLdF    // p^T, ds^T
                          + 2 * kBQ);         // lse, delta
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int sq, int sk, int n_rep, float scale,
                             int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kBK * (D + 1);
  float* sQ = sV + kBK * (D + 1);
  float* sO = sQ + kBQ * (D + 1);
  float* sPt = sO + kBQ * (D + 1);  // [key][query]
  float* sDSt = sPt + kBK * kLdF;   // [key][query]
  float* sLse = sDSt + kBK * kLdF;
  float* sDelta = sLse + kBQ;

  const int g = blockIdx.y;  // kv head
  const int n_kv = gridDim.y;
  const int heads = n_kv * n_rep;
  const int batch = blockIdx.z;
  const int k0 = blockIdx.x * kBK;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int64_t ldq = static_cast<int64_t>(heads) * D;
  const int64_t ldk = static_cast<int64_t>(n_kv) * D;
  const int64_t koff = static_cast<int64_t>(batch) * sk * ldk + g * D;

  load_rows_f32<D>(sK, k + koff, k0, sk, ldk);
  load_rows_f32<D>(sV, v + koff, k0, sk, ldk);
  float acc_dk[4][D / 16];
  float acc_dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      acc_dk[i][j] = 0.0f;
      acc_dv[i][j] = 0.0f;
    }
  }

  const int offset = sk - sq;
  int qb0 = 0;
  if (causal) {
    const int need = k0 - offset - (kBQ - 1);
    qb0 = need <= 0 ? 0 : (need + kBQ - 1) / kBQ;
  }
  const int n_qb = (sq + kBQ - 1) / kBQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int head = g * n_rep + rep;
    const int64_t qoff = static_cast<int64_t>(batch) * sq * ldq + head * D;
    const int64_t row_off =
        (static_cast<int64_t>(batch) * heads + head) * sq;
    for (int qb = qb0; qb < n_qb; ++qb) {
      const int q0 = qb * kBQ;
      __syncthreads();
      load_rows_f32<D>(sQ, q + qoff, q0, sq, ldq);
      load_rows_f32<D>(sO, dout + qoff, q0, sq, ldq);
      load_vec_f32(sLse, lse + row_off, q0, sq);
      load_vec_f32(sDelta, delta + row_off, q0, sq);
      __syncthreads();
      float st[4][4], dpt[4][4];  // [key 4ty + i][query tx + 16j]
      rows_dot_rows_f32<D>(sK, sQ, st);
      rows_dot_rows_f32<D>(sV, sO, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool valid = q0 + qr < sq &&
                             attends(q0 + qr, k0 + key, sk, offset, causal);
          float p;
          sDSt[key * kLdF + qr] = ds_f32(st[i][j], dpt[i][j], sLse[qr],
                                         sDelta[qr], scale, valid, &p);
          sPt[key * kLdF + qr] = p;
        }
      }
      __syncthreads();
      weights_times_rows_f32<D>(sPt, sO, acc_dv);   // dv += p^T.dO
      weights_times_rows_f32<D>(sDSt, sQ, acc_dk);  // dk += ds^T.q
    }
  }
  store_rows_f32<D>(dk + koff, acc_dk, k0, sk, ldk, nullptr);
  store_rows_f32<D>(dv + koff, acc_dv, k0, sk, ldk, nullptr);
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

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int batch, int heads, int n_rep, int sq,
                       int sk, float scale, int causal, cudaStream_t s) {
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
    return launch(flash_fwd_f32_kernel<D>, fwd_f32_smem_bytes<D>(),
                  kF32Threads, sq, kBQ, heads, batch, heads, n_rep, s, qq, kk,
                  vv, oo, ll, sq, sk, n_rep, scale, causal);
  }
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int heads, int n_rep,
                       int sq, int sk, float scale, int causal,
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
    return launch(flash_bwd_dkv_kernel<D>, bwd_smem_bytes<D>(), kThreads, sk,
                  kBK, heads / n_rep, batch, heads, n_rep, s, qq, kk, vv, dd,
                  ll, de, dkk, dvv, sq, sk, n_rep, scale, causal);
  } else {
    return launch(flash_bwd_dkv_f32_kernel<D>, dkv_f32_smem_bytes<D>(),
                  kF32Threads, sk, kBK, heads / n_rep, batch, heads, n_rep, s,
                  qq, kk, vv, dd, ll, de, dkk, dvv, sq, sk, n_rep, scale,
                  causal);
  }
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int heads, int n_rep, int sq,
                      int sk, float scale, int causal, cudaStream_t s) {
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
    return launch(flash_bwd_dq_f32_kernel<D>, dq_f32_smem_bytes<D>(),
                  kF32Threads, sq, kBQ, heads, batch, heads, n_rep, s, qq, kk,
                  vv, dd, ll, de, dqq, sq, sk, n_rep, scale, causal);
  }
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, int batch, int heads, int n_rep, int sq, int sk,
              int d, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_fwd<32, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 64: return launch_fwd<64, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 128: return launch_fwd<128, T>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              int batch, int heads, int n_rep, int sq, int sk, int d,
              float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 64: return launch_dkv<64, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 128: return launch_dkv<128, T>(q, k, v, dout, lse, delta, dk, dv, batch, heads, n_rep, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int batch,
             int heads, int n_rep, int sq, int sk, int d, float scale,
             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq<32, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 64: return launch_dq<64, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, s);
    case 128: return launch_dq<128, T>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [batch, sq, heads*d], k/v [batch, sk, (heads/n_rep)*d] row-major, bf16
// (rt_flash_*) or float32 (rt_flash_*_f32); out like q; lse [batch, heads,
// sq] float32. [b*h, s, d] operands are batch = b*h, heads = n_rep = 1. d
// is 32, 64 or 128. Returns a CUDA error code (0 = ok).
int rt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int batch, int heads, int n_rep, int sq, int sk,
                 int d, float scale, int causal, void* stream) {
  return fwd_entry<bf16>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                         scale, causal, stream);
}

int rt_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int heads, int n_rep, int sq,
                     int sk, int d, float scale, int causal, void* stream) {
  return fwd_entry<float>(q, k, v, out, lse, batch, heads, n_rep, sq, sk, d,
                          scale, causal, stream);
}

// dO like q, lse/delta [batch, heads, sq] float32; dk/dv like k.
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int batch, int heads, int n_rep,
                     int sq, int sk, int d, float scale, int causal,
                     void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                         n_rep, sq, sk, d, scale, causal, stream);
}

int rt_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int batch, int heads, int n_rep,
                         int sq, int sk, int d, float scale, int causal,
                         void* stream) {
  return dkv_entry<float>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                          n_rep, sq, sk, d, scale, causal, stream);
}

// dq like q.
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int batch, int heads, int n_rep, int sq, int sk,
                    int d, float scale, int causal, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                        sq, sk, d, scale, causal, stream);
}

int rt_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int batch, int heads, int n_rep, int sq,
                        int sk, int d, float scale, int causal,
                        void* stream) {
  return dq_entry<float>(q, k, v, dout, lse, delta, dq, batch, heads, n_rep,
                         sq, sk, d, scale, causal, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
