// Device and host helpers shared by the port's Hopper kernels (every
// csrc/*.cu).
//
// Counterparts of the in-kernel helpers of mvlt_tpu/ops/kernel_math.py:
//   one_pass_ln -> layer_norm_row, row_stats_global (two-pass statistics:
//                  mean, then the centred variance; E[x^2] - mean^2 loses
//                  digits on residual-grown rows)
//   softmax_av  -> written out inside attn_half.cuh and attention.cu (fp32
//                  logits and softmax)
//   gelu / gelu_grad -> gelu_erf / gelu_erf_and_grad (exact erf, never the tanh
//                  form)
// gemm_bf16 is the wmma kernels' matrix-product routine (kernels A and C:
// sr_kv.cu, attn_half.cuh): bf16 tensor-core tiles (nvcuda::wmma, 16x16x16,
// fp32 accumulation), a tile of up to eight 16x16 output blocks per warp at a
// time, each handed element by element to an epilogue (the wgmma kernels'
// products are hopper.cuh's).

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

// Route tags: a template argument of a kernel that several paths launch,
// naming the path, so that a profile (which sees kernel names) books its
// device time to that path -- #12's kernels inside kernels B, D and E and
// the fused attention forward, kernel F's inside E, #10's inside B and the
// fused attention forward. kRowScale: whether an LN-MLP epilogue takes the
// per-sample row scale; kAttn: the route's number at #10's chain entry
// (attention.cu:mvlt_attention_fwd_route).
struct LnMlpRoute {  // #12 (ln_mlp.cu) itself
  static constexpr bool kRowScale = true;
};
struct AttnRoute {};      // #10 (attention.cu) itself
struct SwinAttnRoute {};  // kernel F (swin_attention.cu) itself
struct DwConvRoute {      // kernel D's chain (dwconv_mlp.cu)
  static constexpr bool kRowScale = false;
};
struct SwinBlockRoute {  // kernel E's chain (swin_block.cu)
  static constexpr bool kRowScale = false;
};
struct FbaFwdRoute {  // the fused attention forward's chain (block_attention_train.cu)
  static constexpr bool kRowScale = true;
  static constexpr int kAttn = 1;
};
struct BlockFusedRoute {  // kernel B's chain (block_fused.cu)
  static constexpr bool kRowScale = false;
  static constexpr int kAttn = 2;
};

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

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// The row kernels of the wgmma kernels' chains (ln_mlp_bwd.cu,
// block_attention_train.cu): a lane holds P column pairs of a row (2 lane +
// 64 p, + 1; D <= 64 P), and a warp takes R = 8 / P rows at once, so that
// each lane keeps about 8 pairs of loads in flight.
__host__ __device__ constexpr int rows_at_once(int p) { return p >= 8 ? 1 : 8 / p; }

// Lets `kernel` take `bytes` of dynamic shared memory (at most kSmemLimit).
inline cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// LayerNorm of one row of n values, computed by one warp in fp32 with
// two-pass statistics; load(c) returns element c as float, the result goes to
// dst as bf16.
template <typename Load>
__device__ __forceinline__ void layer_norm_row(Load load, int n, const float* gamma,
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

}  // namespace mvlt
