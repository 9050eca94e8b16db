// Hopper (sm_90a) device helpers of the port's wgmma kernels (attention.cu):
// warpgroup matrix multiply (wgmma) on bf16 operands with fp32 sums, its
// shared-memory descriptors and fences, cp.async copies into the swizzled
// tiles wgmma reads, named barriers, and the fragment-layout maps.
//
// Tiles in shared memory. Every bf16 operand tile is row-major, one row of
// RB = 64 or 128 bytes (32 or 64 values), rows in groups of eight that
// wgmma reads as one swizzle atom (8 x RB bytes, aligned to it): the
// 16-byte chunk c of row r sits at chunk c ^ ((r * RB >> 7) & (RB/16 - 1)),
// which is the hardware's 128-byte (RB = 128) or 64-byte (RB = 64) swizzle.
// One layout serves both ways a product reads a tile:
//   K-major  (the contraction runs along the row, e.g. K in q.K^T): the
//            descriptor starts at the tile's first row, SBO = one atom
//            (8 rows), and a k-step of 16 values moves the start 32 bytes;
//   MN-major (the contraction runs down the rows, e.g. V in P.V; the
//            transpose bit set): the same SBO, and a k-step of 16 moves the
//            start 16 rows. A tile is one atom wide (RB / 2 values), so the
//            leading-byte offset between atoms is never used.
//
// Fragments (PTX ISA, wgmma .m64nNk16): thread t of a warpgroup (warp
// w = t / 32, lane l) holds accumulator d[4j + e] at row 16w + l/4 + 8(e/2),
// column 8j + 2(l%4) + e%2; an A operand from registers, for k-step kk of a
// row-major 64 x K matrix, is four bf16 pairs at (row, column) = (r, 16kk +
// 2(l%4)), (r + 8, same), (r, + 8), (r + 8, + 8) with r = 16w + l/4 -- the
// same threads and rows as the accumulator, so a product's fp32 result
// becomes the next product's A operand without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mvlt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of RB-byte rows.
template <int RB>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  static_assert(RB == 64 || RB == 128, "rows of 64 or 128 bytes");
  return r * RB + ((c ^ ((r * RB >> 7) & (RB / 16 - 1))) << 4);
}

// 64-bit wgmma shared-memory descriptor (PTX ISA "matrix descriptor"):
// start address, leading and stride byte offsets in 16-byte units, swizzle
// mode (1: 128-byte, 2: 64-byte) in bits 62-63; base offset 0 (atoms are
// aligned to their size).
template <int RB>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t kSbo = 8 * RB / 16, kLbo = 1, kMode = RB == 128 ? 1 : 2;
  return ((uint64_t)((addr & 0x3FFFF) >> 4)) | (kLbo << 16) | (kSbo << 32) | (kMode << 62);
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  // 16 bytes from global memory, or 16 zero bytes where !valid
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// x, opaque to the compiler: what is derived from it (shared-memory
// addresses, wgmma descriptors) is recomputed where it is used instead of
// being hoisted out of a loop and held in registers all along.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %1;\n" : "=r"(x) : "r"(x));
  return x;
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator (or
// register-operand) values across a wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// 2^x by the SFU's ex2.approx (relative error about 2^-22; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step kk of an accumulator (columns 16kk .. 16kk + 15) as an A operand.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Products, D[64 x N] (+)= A[64 x 16] B[16 x N] with N = 2 x the
// accumulator's length: wgmma_ss reads A and B through descriptors
// (TransA / TransB: 0 K-major, 1 MN-major), wgmma_rs takes A from
// registers. acc = 0 overwrites D.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TransA), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, "
      "1, %22;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TransB));
}

template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22,"
      " %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TransA), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22,"
      " %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, %38;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TransB));
}


}  // namespace hopper
}  // namespace mvlt
