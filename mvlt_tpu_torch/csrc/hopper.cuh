// Hopper (sm_90a) device helpers of the port's wgmma kernels (attention.cu,
// mlm_ce.cu, ln_mlp.cu, ln_mlp_bwd.cu, block_attention_train.cu, dwconv_mlp.cu,
// swin_attention.cu, swin_block.cu):
// warpgroup matrix multiply (wgmma) on bf16 operands with fp32 sums, its
// shared-memory descriptors and fences, cp.async copies into the swizzled
// tiles wgmma reads, named barriers, the fragment-layout maps, and the
// 128 x 128 output tile over a streamed contraction (mma_tile), with its
// staged epilogue (store_tile), that the GEMM-shaped kernels share.
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

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (a swizzle atom's alignment),
// by an offset, so that the compiler still sees a shared-memory pointer.
__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
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

// The same product at N = 128 (both operands through descriptors).
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TransA), "n"(TransB));
}

// The same product at N = 128 with A from registers.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TransB));
}

// The N = 64 product into columns 64 (Off / 32) .. + 63 of an N = 128
// accumulator (Off 0 or 32), for a B operand held as two 64-column panels.
template <int TransA, int TransB, int Off>
__device__ __forceinline__ void wgmma_ss_half(float (&d)[64], uint64_t da, uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;"
      "\n}\n"
      : "+f"(d[Off + 0]), "+f"(d[Off + 1]), "+f"(d[Off + 2]), "+f"(d[Off + 3]),
        "+f"(d[Off + 4]), "+f"(d[Off + 5]), "+f"(d[Off + 6]), "+f"(d[Off + 7]),
        "+f"(d[Off + 8]), "+f"(d[Off + 9]), "+f"(d[Off + 10]), "+f"(d[Off + 11]),
        "+f"(d[Off + 12]), "+f"(d[Off + 13]), "+f"(d[Off + 14]), "+f"(d[Off + 15]),
        "+f"(d[Off + 16]), "+f"(d[Off + 17]), "+f"(d[Off + 18]), "+f"(d[Off + 19]),
        "+f"(d[Off + 20]), "+f"(d[Off + 21]), "+f"(d[Off + 22]), "+f"(d[Off + 23]),
        "+f"(d[Off + 24]), "+f"(d[Off + 25]), "+f"(d[Off + 26]), "+f"(d[Off + 27]),
        "+f"(d[Off + 28]), "+f"(d[Off + 29]), "+f"(d[Off + 30]), "+f"(d[Off + 31])
      : "l"(da), "l"(db), "r"(acc), "n"(TransA), "n"(TransB));
}

// ---- 128 x 128 output tiles over a streamed contraction ------------------
//
// A block of two warpgroups (kGemmThreads) computes one 128 x 128 fp32 tile
// of a product, warpgroup w holding rows 64w .. 64w + 63 in registers, and
// streams the contraction in kGemmChunk-deep chunks through a kGemmRing-stage
// cp.async ring of swizzled tiles: two chunks in flight ahead of the
// product and one product in flight behind it (mlm_ce.cu, ln_mlp_bwd.cu).

constexpr int kGemmTile = 128;     // rows and columns of a block's output tile
constexpr int kGemmChunk = 64;     // contraction depth of one ring stage
constexpr int kGemmRing = 5;       // ring stages; kGemmRing - 2 chunks load ahead
constexpr int kGemmThreads = 256;  // two warpgroups, 64 rows of the tile each
constexpr int kGemmOperandBytes = kGemmTile * kGemmChunk * 2;  // one operand of one stage
constexpr int kGemmPanelBytes = kGemmOperandBytes / 2;         // 64 rows of 128 bytes
constexpr size_t kGemmSmem = 1024 + (size_t)kGemmRing * 2 * kGemmOperandBytes;
constexpr int kGemmStageLd = kGemmTile + 8;  // bf16 row of an output stage in shared memory

// Thread t's accumulator rows of the tile: tile_row() and tile_row() + 8, at
// columns 8j + tile_col() and + 1 (j < 16) -- d[4j + e] at row
// tile_row() + 8(e / 2), column 8j + tile_col() + e % 2.
__device__ __forceinline__ int tile_row() {
  return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int tile_col() { return 2 * (threadIdx.x & 3); }

// A row-major bf16 matrix in device memory, ld elements a row; elements
// past [rows][cols] read as zeros. cols and ld are multiples of 8.
struct Mat {
  const __nv_bfloat16* p;
  long long ld;
  int rows, cols;
};

// One ring stage of an operand, a Rows x 64 tile of m (Rows 128 or 64), by
// cp.async:
//   K-major  (MN false): rows r0 .. r0 + Rows - 1, columns k0 .. k0 + 63,
//            one 128-byte swizzled row each;
//   MN-major (MN true):  rows k0 .. k0 + 63, columns r0 .. r0 + Rows - 1, as
//            panels of 64 columns [64][128 B], kGemmPanelBytes apart.
template <bool MN, int Rows = kGemmTile>
__device__ __forceinline__ void load_operand(uint32_t dst, const Mat& m, int r0, int k0) {
  constexpr int kChunksPerRow = Rows / 8;  // 16-byte chunks across an MN-major tile
  for (int i = threadIdx.x; i < Rows * 8; i += kGemmThreads) {
    int row, col;
    uint32_t off;
    if (MN) {
      const int k = i / kChunksPerRow, c = i % kChunksPerRow;
      row = k0 + k;
      col = r0 + c * 8;
      off = (c >> 3) * kGemmPanelBytes + tile_off<128>(k, c & 7);
    } else {
      const int r = i >> 3, c = i & 7;
      row = r0 + r;
      col = k0 + c * 8;
      off = tile_off<128>(r, c);
    }
    const bool ok = row < m.rows && col < m.cols;
    cp_async16_zfill(dst + off, ok ? m.p + row * m.ld + col : m.p, ok);
  }
}

// d = the block's 128 x 128 tile of A^T B (A rows m0.., B rows n0..) over
// chunks [c0, c1) of the contraction; warpgroup w holds rows 64w .. 64w + 63.
// A is K-major (A_MN false: [M][K] in memory) or MN-major ([K][M]); so is B.
// Every thread of the block calls it; the ring is free again for the next
// call only after a __syncthreads().
//
// mma_tile_from takes the A operand from load_a(dst, k0) instead: it fills
// the stage at dst with the tile's 128 rows by contraction columns k0 ..
// k0 + 63 in load_operand's layout (K-major, or MN-major for A_MN), by
// cp.async or by plain shared-memory stores -- a gather, or A computed on
// the fly. It is called kGemmRing - 2 chunks ahead of the product, into a
// stage whose product both warpgroups have finished.
template <bool A_MN, bool B_MN, typename LoadA>
__device__ __forceinline__ void mma_tile_from(LoadA load_a, const Mat& b, int n0, int c0, int c1,
                                              uint32_t ring, float (&d)[64]) {
  const int wg = threadIdx.x >> 7, n = c1 - c0;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  auto load = [&](int i) {  // chunk c0 + i into its stage; one commit group each
    if (i < n) {
      const uint32_t st = ring + (i % kGemmRing) * 2 * kGemmOperandBytes;
      load_a(st, (c0 + i) * kGemmChunk);
      load_operand<B_MN>(st + kGemmOperandBytes, b, n0, (c0 + i) * kGemmChunk);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kGemmRing - 2; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kGemmRing - 3>();
    fence_proxy_async();
    __syncthreads();  // chunk i is in; both warpgroups' products of chunk i - 2 are done
    load(i + kGemmRing - 2);  // into chunk i - 2's stage
    const uint32_t st = ring + (i % kGemmRing) * 2 * kGemmOperandBytes;
    const uint32_t sa = st + wg * kGemmPanelBytes, sb = st + kGemmOperandBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmChunk / 16; ++kk) {
      const uint64_t da = make_desc<128>(sa + (A_MN ? kk * 16 * 128 : kk * 32));
      if (B_MN) {
        wgmma_ss_half<A_MN, 1, 0>(d, da, make_desc<128>(sb + kk * 16 * 128), 1);
        wgmma_ss_half<A_MN, 1, 32>(d, da, make_desc<128>(sb + kGemmPanelBytes + kk * 16 * 128),
                                   1);
      } else {
        wgmma_ss<A_MN, 0>(d, da, make_desc<128>(sb + kk * 32), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk i - 1's product is done
  }
  wgmma_wait<0>();
  fence_regs(d);
}

template <bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_tile(const Mat& a, const Mat& b, int m0, int n0, int c0,
                                         int c1, uint32_t ring, float (&d)[64]) {
  mma_tile_from<A_MN, B_MN>(
      [&](uint32_t dst, int k0) { load_operand<A_MN>(dst, a, m0, k0); }, b, n0, c0, c1, ring, d);
}

// The block's 128 x 128 fp32 tile d (every thread's, after mma_tile) handed
// to epi(r, c, v) eight columns at a time -- r and c tile-relative, v[8]
// the values at columns c .. c + 7 -- through a staging copy in shared
// memory at `stage` (the ring: kGemmTile * kStageLdF floats), so that the
// epilogue reads and writes device memory in 16-byte rows.
constexpr int kStageLdF = kGemmTile + 4;  // fp32 row of an output stage

// Dynamic shared memory of a block that runs mma_tile over `chunks` chunks
// and then store_tile: the ring stages the contraction touches (chunk i
// takes stage i % kGemmRing), and at least the epilogue's staging copy;
// kGemmSmem from five chunks on. A short contraction (K <= 128) then leaves
// room for two blocks an SM, so that one block's loads overlap another's
// products and epilogue.
__host__ __device__ constexpr size_t gemm_smem(int chunks) {
  constexpr size_t kStaging = (size_t)kGemmTile * kStageLdF * 4;
  const size_t ring = (size_t)(chunks < kGemmRing ? chunks : kGemmRing) * 2 * kGemmOperandBytes;
  return 1024 + (ring > kStaging ? ring : kStaging);
}
template <typename Epi>
__device__ __forceinline__ void store_tile(const float (&d)[64], float* stage, Epi epi) {
  __syncthreads();  // every warpgroup is done with the ring
  const int r = tile_row(), cq = tile_col();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stage + (r + 8 * h) * kStageLdF + 8 * j + cq) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kGemmTile * kGemmTile / 8; i += kGemmThreads) {
    const int rr = i >> 4, c = (i & 15) * 8;
    float v[8];
    const float4 lo = *reinterpret_cast<const float4*>(stage + rr * kStageLdF + c);
    const float4 hi = *reinterpret_cast<const float4*>(stage + rr * kStageLdF + c + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    epi(rr, c, v);
  }
}

// Eight fp32 values to 16 bytes of bf16.
__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// out[n][m] = sum_k A[k][m] B(k, n) over the chunks of k of one split, fp32,
// for m < m_out and n < n_out (A MN-major; B MN-major or K-major); split s
// writes out + s * split_stride. The long-K weight-gradient form: the
// contraction runs over rows, each split over its own range of them.
struct GemmArgs {
  Mat a, b;
  float* out;
  long long split_stride;
  int m_out, n_out, ldo, chunks, per_split;
};

template <bool B_MN>
__device__ __forceinline__ void gemm_tn_block(const GemmArgs& a, int m0, int n0, int split,
                                              uint32_t ring) {
  const int c0 = split * a.per_split, c1 = min(a.chunks, c0 + a.per_split);
  float d[64];
  mma_tile<true, B_MN>(a.a, a.b, m0, n0, c0, c1, ring, d);
  float* out = a.out + split * a.split_stride;
  const int m = m0 + tile_row(), cq = tile_col();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = m + 8 * (e >> 1), nn = n0 + 8 * j + cq + (e & 1);
      if (mm < a.m_out && nn < a.n_out) out[(size_t)nn * a.ldo + mm] = d[4 * j + e];
    }
  }
}

// Two weight gradients of a backward in one launch: blocks [0, tiles) x
// splits (blockIdx.y) take the first, the same again the second; the block's
// output tile runs down the rows of out fastest.
__device__ __forceinline__ void gemm_tn_pair(const GemmArgs& first, const GemmArgs& second,
                                             int splits, char* smem_raw) {
  const int z = blockIdx.y;
  const bool two = z >= splits;
  const GemmArgs& g = two ? second : first;
  const int mt = (g.m_out + kGemmTile - 1) / kGemmTile;
  gemm_tn_block<true>(g, (blockIdx.x % mt) * kGemmTile, (blockIdx.x / mt) * kGemmTile,
                      z - (two ? splits : 0), smem_u32(align1024(smem_raw)));
}

}  // namespace hopper
}  // namespace mvlt
