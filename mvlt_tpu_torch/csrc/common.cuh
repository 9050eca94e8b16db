// Device helpers shared by the port's Hopper kernels (sr_kv.cu,
// block_fused.cu, attention.cu, ln_mlp.cu).
//
// Counterparts of the in-kernel helpers of mvlt_tpu/ops/kernel_math.py:
//   one_pass_ln -> layer_norm_row, row_stats_global (two-pass statistics:
//                  mean, then the centred variance; E[x^2] - mean^2 loses
//                  digits on residual-grown rows)
//   softmax_av  -> written out inside block_fused.cu and attention.cu (fp32
//                  logits and softmax)
//   gelu / gelu_grad -> gelu_erf / gelu_erf_and_grad (exact erf, never the tanh
//                  form)
// gemm_bf16 is the matrix-product routine: bf16 tensor-core tiles
// (nvcuda::wmma, 16x16x16, fp32 accumulation), a tile of up to eight 16x16
// output blocks per warp at a time, each handed element by element to an
// epilogue. gemm_acc is its form for a plain sum into an fp32 matrix: the
// blocks load from and store to it whole, with no epilogue; it pays where A
// and B are both in shared memory, and loses where B is read from L2 (no
// two-row-block reuse, no prefetch).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace mvlt {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kSmemLimit = 232448;
// Per-warp fp32 staging tile for the GEMM epilogue.
constexpr size_t kStageBytes = kWarps * 256 * sizeof(float);

__host__ __device__ inline size_t align128(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// The exact GELU and its derivative Phi(u) + u * phi(u), sharing one erf.
__device__ __forceinline__ float2 gelu_erf_and_grad(float u) {
  const float phi2 = 1.0f + erff(u * 0.70710678118654752f);  // 2 Phi(u)
  return make_float2(0.5f * u * phi2,
                     0.5f * phi2 + u * 0.39894228040143268f * __expf(-0.5f * u * u));
}

// Two-pass LayerNorm statistics (mean, 1/sqrt(var + eps)) of one row of
// n <= 32 * 16 bf16 values in global memory, by one warp; every lane gets both.
__device__ __forceinline__ float2 row_stats_global(const bf16* src, int n, float eps) {
  const int lane = threadIdx.x & 31;
  float v[16];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n ? __bfloat162float(src[c]) : 0.0f;
    s += v[j];
  }
  const float mean = warp_sum(s) / n;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float z = lane + 32 * j < n ? v[j] - mean : 0.0f;
    q += z * z;
  }
  return make_float2(mean, rsqrtf(warp_sum(q) / n + eps));
}

// Rows [0, rows) of a [tile, n] bf16 tile with row stride ld elements, from
// global memory with row stride src_ld, into shared memory with row stride
// dst_ld; rows [rows, tile) become zero. n, src_ld and dst_ld are multiples
// of 8 and both bases 16-byte aligned (16-byte loads).
__device__ __forceinline__ void load_tile_rows(bf16* dst, int dst_ld, const bf16* src,
                                               long long src_ld, int rows, int tile, int n) {
  const int per_row = n / 8;
  for (int i = threadIdx.x; i < tile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < rows) raw = *reinterpret_cast<const uint4*>(src + r * src_ld + c);
    *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = raw;
  }
}

// LayerNorm of one row of n values, computed by one warp in fp32 with
// two-pass statistics; load(c) returns element c as float, the result goes to
// dst as bf16. Returns (mean, 1/std) to every lane.
template <typename Load>
__device__ __forceinline__ float2 layer_norm_row(Load load, int n, const float* gamma,
                                                 const float* beta, float eps, bf16* dst) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int c = lane; c < n; c += 32) s += load(c);
  const float mean = warp_sum(s) / n;
  float q = 0.0f;
  for (int c = lane; c < n; c += 32) {
    const float z = load(c) - mean;
    q += z * z;
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
  for (int c = lane; c < n; c += 32)
    dst[c] = __float2bfloat16((load(c) - mean) * rstd * gamma[c] + beta[c]);
  return make_float2(mean, rstd);
}

// LayerNorm of one row of n <= 32 * kMaxPerLane bf16 values in global memory,
// by one warp: the row is read once, all loads in flight together, and held
// in registers for the two-pass statistics.
constexpr int kMaxPerLane = 16;

__device__ __forceinline__ void layer_norm_row_global(const bf16* src, int n, const float* gamma,
                                                      const float* beta, float eps, bf16* dst) {
  const int lane = threadIdx.x & 31;
  float v[kMaxPerLane];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n ? __bfloat162float(src[c]) : 0.0f;
    s += v[j];
  }
  const float mean = warp_sum(s) / n;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const float z = lane + 32 * j < n ? v[j] - mean : 0.0f;
    q += z * z;
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < n) dst[c] = __float2bfloat16((v[j] - mean) * rstd * gamma[c] + beta[c]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// A warp's output tile is RB 16-row blocks by up to CB = 4 16-column blocks.
// Every B fragment -- a weight read from L2 -- feeds RB products and every A
// fragment CB, and the next k-step's fragments load while this one
// multiplies, so each warp keeps several loads in flight.
template <int RB, bool BColMajor>
struct Frags {
  static constexpr int CB = 4;
  using BLayout = typename std::conditional<BColMajor, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, nvcuda::wmma::row_major> a[RB];
  nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[CB];

  // pa: the tile's first row of A; pb: B at the tile's first column
  __device__ __forceinline__ void load(const bf16* pa, int lda, const bf16* pb, int ldb,
                                       int ncb, int k0) {
#pragma unroll
    for (int i = 0; i < RB; ++i)
      nvcuda::wmma::load_matrix_sync(a[i], pa + (size_t)16 * i * lda + k0, lda);
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (j < ncb) {
        nvcuda::wmma::load_matrix_sync(
            b[j], BColMajor ? pb + (size_t)16 * j * ldb + k0 : pb + (size_t)k0 * ldb + 16 * j,
            ldb);
      }
    }
  }

  __device__ __forceinline__ void mma(Acc (&acc)[RB][CB], int ncb) const {
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j)
        if (j < ncb) nvcuda::wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
};

template <int RB, bool BColMajor, typename Epi>
__device__ void gemm_tiles(const bf16* a, int lda, const bf16* b, int ldb, int rows,
                           int ncols, int kdim, int cb, float* st, Epi epi) {
  using namespace nvcuda;
  using F = Frags<RB, BColMajor>;
  constexpr int CB = F::CB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = ncols >> 4, per_row = (nb + cb - 1) / cb;
  const int ntiles = (rows >> 4) / RB * per_row;
  for (int t = warp; t < ntiles; t += kWarps) {
    const int r0 = (t / per_row) * RB * 16, cblk = (t % per_row) * cb, c0 = cblk * 16;
    const int ncb = min(cb, nb - cblk);
    const bf16* pa = a + (size_t)r0 * lda;
    const bf16* pb = BColMajor ? b + (size_t)c0 * ldb : b + c0;
    typename F::Acc acc[RB][CB];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    F f0, f1;
    f0.load(pa, lda, pb, ldb, ncb, 0);
    for (int k0 = 0; k0 < kdim; k0 += 32) {
      const bool has1 = k0 + 16 < kdim;
      if (has1) f1.load(pa, lda, pb, ldb, ncb, k0 + 16);
      f0.mma(acc, ncb);
      if (!has1) break;
      if (k0 + 32 < kdim) f0.load(pa, lda, pb, ldb, ncb, k0 + 32);
      f1.mma(acc, ncb);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        if (j < ncb) {
          wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32)
            epi(r0 + 16 * i + (e >> 4), c0 + 16 * j + (e & 15), st[e]);
          __syncwarp();
        }
      }
    }
  }
}

// out[rows, ncols] = a[rows, kdim] . B, handed to epi(row, col, value).
//   a: bf16 row-major with leading dimension lda (shared memory);
//   B: bf16; with BColMajor element (k, n) is b[n * ldb + k] -- a torch Linear
//      weight [out, in] read as it is -- otherwise b[k * ldb + n].
// rows, ncols and kdim are multiples of 16; every pointer a 16-row or
// 16-column block starts at is 32-byte aligned. All warps of the block must
// call it; each output element reaches epi exactly once, from one warp.
// With one block of 8 warps on an SM the products wait on the latency of
// their L2 loads, so a round of tiles over the warps costs about the same
// whatever the tile: the warp tile (RB <= MaxRB, CB) is the one with the
// fewest rounds, then the fewest products and B loads (cost per round: the
// latency as 8 products, plus its products, plus a tenth per B load).
// MaxRB = 1 keeps the register count low where several blocks share an SM.
template <bool BColMajor, int MaxRB, typename Epi>
__device__ void gemm_bf16(const bf16* a, int lda, const bf16* b, int ldb, int rows,
                          int ncols, int kdim, float* stage, Epi epi) {
  static_assert(MaxRB == 1 || MaxRB == 2, "warp tiles span one or two row blocks");
  const int nrb = rows >> 4, nb = ncols >> 4;
  int best_rb = 1, best_cb = 1;
  float best = 3.0e38f;
  for (int rb = MaxRB; rb >= 1; rb >>= 1) {
    if (nrb % rb) continue;
    for (int cb = 4; cb >= 1; cb >>= 1) {
      const int tiles = nrb / rb * ((nb + cb - 1) / cb);
      const int rounds = (tiles + kWarps - 1) / kWarps;
      const float cost = rounds * (8.0f + rb * cb + 0.1f * cb);
      if (cost < best) {
        best = cost;
        best_rb = rb;
        best_cb = cb;
      }
    }
  }
  float* st = stage + (threadIdx.x >> 5) * 256;
  if (MaxRB == 2 && best_rb == 2)
    gemm_tiles<MaxRB, BColMajor>(a, lda, b, ldb, rows, ncols, kdim, best_cb, st, epi);
  else
    gemm_tiles<1, BColMajor>(a, lda, b, ldb, rows, ncols, kdim, best_cb, st, epi);
}

// c[rows, ncols] = (first ? 0 : c) + a . B, c fp32 row-major (leading
// dimension ldc) in shared or device memory; a and B as for gemm_bf16. A
// warp takes strips of one 16-row block by up to 4 column blocks; their
// accumulators load from and store to c as whole fragments, so each element
// of c is read and written once per call and nothing passes through a
// per-element epilogue. c and every 16-row or 16-column block start in it
// are 32-byte aligned and ldc is a multiple of 4.
template <bool BColMajor>
__device__ void gemm_acc(const bf16* a, int lda, const bf16* b, int ldb, int rows, int ncols,
                         int kdim, float* c, int ldc, bool first) {
  using namespace nvcuda;
  using BLayout = typename std::conditional<BColMajor, wmma::col_major, wmma::row_major>::type;
  constexpr int CB = 4;
  const int nb = ncols >> 4, per_row = (nb + CB - 1) / CB;
  const int strips = (rows >> 4) * per_row;
  for (int t = threadIdx.x >> 5; t < strips; t += kWarps) {
    const int r0 = (t / per_row) * 16, c0 = (t % per_row) * CB * 16;
    const int ncb = min(CB, nb - c0 / 16);
    float* cp = c + (size_t)r0 * ldc + c0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (j < ncb) {
        if (first) {
          wmma::fill_fragment(acc[j], 0.0f);
        } else {
          wmma::load_matrix_sync(acc[j], cp + 16 * j, ldc, wmma::mem_row_major);
        }
      }
    }
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + (size_t)r0 * lda + k0, lda);
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        if (j < ncb) {
          const int col = c0 + 16 * j;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
          wmma::load_matrix_sync(
              fb, BColMajor ? b + (size_t)col * ldb + k0 : b + (size_t)k0 * ldb + col, ldb);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (j < ncb) wmma::store_matrix_sync(cp + 16 * j, acc[j], ldc, wmma::mem_row_major);
    }
  }
}

}  // namespace mvlt
