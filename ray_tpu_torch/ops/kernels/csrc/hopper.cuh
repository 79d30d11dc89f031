// Hopper building blocks shared by the flash-attention and fused-FFN
// kernels: cp.async copies, 128-byte-swizzled shared-memory tiles, the
// shared-memory matrix descriptors of the warpgroup MMA (wgmma) and the
// products themselves (bf16 operands, float32 accumulators), for sm_90a.
//
// Register layouts of the products. A warp's part of an accumulator D
// (m64nN) is its 16 rows: for lane 4g + t, d[4j], d[4j + 1] hold row g,
// columns 8j + 2t, 8j + 2t + 1, and d[4j + 2], d[4j + 3] the same columns
// of row g + 8. A register A operand (m64k16) is the warp's 16 rows the
// same way: a[0] | a[1] rows g | g + 8 at columns 2t, 2t + 1, a[2] | a[3]
// at columns 2t + 8, 2t + 9. Every product accumulates (its predicate is
// 1): callers zero D first.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats as bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------- async copies

// 16-byte asynchronous copy global -> shared; zero-fills when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy (one float), zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed copies (and shared-memory stores) visible
// to the products' reads, which go through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------- tensor copies (TMA), barriers
//
// A 2-D box of a row-major matrix, copied by the Tensor Memory Accelerator
// into shared memory in the 128-byte-swizzled layout below (box rows of
// 64 bf16), zero-filled past the matrix's edges; an mbarrier counts the
// bytes as they land. The tensor map is built on the host (see
// fused_ffn.cu) and passed as a __grid_constant__ kernel parameter.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes initialized mbarriers visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more to land before the phase
// completes.
__device__ __forceinline__ void mbar_expect_bytes(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// One arrival (no bytes expected).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box at (column c0, row c1) of the matrix `map` describes, into
// shared memory at `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The box at element `c0` of the vector `map` describes (rank 1), into
// shared memory at `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const void* map,
                                            int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// The box at (column c0, row c1) of the matrix `map` describes, from
// shared memory at `src` (the layout a load of that box gives), clipped at
// the matrix's edges; a bulk group of this thread's.
__device__ __forceinline__ void tma_store_2d(const void* map, int c0, int c1,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

// Closes this thread's bulk group, and waits until its stores have read
// their shared memory (not until they reach device memory).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ------------------------------------------------------------ products

#define RT_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

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
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A . B, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40),
        RT_D8(48), RT_D8(56), RT_D8(64), RT_D8(72), RT_D8(80), RT_D8(88),
        RT_D8(96), RT_D8(104), RT_D8(112), RT_D8(120)
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
      : RT_D8(0), RT_D8(8)
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
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
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
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40),
        RT_D8(48), RT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A . B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40),
        RT_D8(48), RT_D8(56), RT_D8(64), RT_D8(72), RT_D8(80), RT_D8(88),
        RT_D8(96), RT_D8(104), RT_D8(112), RT_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef RT_D8

// D[64 x N] += A . B with A in registers and B MN-major: N = 32, 64, 128
// or 256.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    static_assert(N == 256, "wgmma widths 32, 64, 128, 256");
    wgmma_rs_n256(d, a, desc_b);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for a register A operand: a use here keeps its registers from
// being reused while a product issued earlier may still read them.
__device__ __forceinline__ void fence_operands(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------------------------ tiles
//
// Tile layouts the descriptors read. D >= 64 columns: 128-byte swizzle,
// the tile cut into column blocks of 64 elements (kRows x 128 bytes each),
// row r's 16-byte chunk c at chunk c ^ (r % 8) of its 128-byte row (tiles
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

// Byte offset of row `row` (a multiple of 8) in a kRows-row tile.
template <int D>
__host__ __device__ constexpr int row_offset(int row) {
  return row * (kSwizzled<D> ? 128 : D * 2);
}

// kRows rows of an [n, D] bf16 matrix (rows ld apart) into a tile by
// cp.async with kThreads threads, rows >= n zero-filled. Swizzled: a row's
// chunks go to one 128-byte row, so the writes of 8 threads cover 8 bank
// groups; core matrices: each pair of threads reads 32 contiguous bytes
// and each 16 threads write 256 contiguous bytes.
template <int D, int kRows, int kThreads = 256>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int n, int64_t ld) {
  constexpr int kChunks = kRows * D / 8;
  static_assert(kChunks % kThreads == 0, "whole 16-byte moves");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
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
// N, the reduction runs along the D columns).
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
// tile (the reduction runs along the rows, N along the D columns; a
// product narrower than D starts at a column block's offset).
template <int D, int kRows>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  if constexpr (kSwizzled<D>) {
    return smem_desc(tile + kk * 2048, kRows * 128, 1024, 1);
  } else {
    return smem_desc(tile + kk * 2 * (D / 8) * 128, (D / 8) * 128, 128, 0);
  }
}

}  // namespace
