// Device and host helpers shared by the port's Hopper kernels (every
// csrc/*.cu).
//
// Counterparts of the in-kernel helpers of mvlt_tpu/ops/kernel_math.py:
//   one_pass_ln -> the row kernels' two-pass statistics (ln_mlp.cu:ln_row,
//                  row_stats_global: the mean, then the centred variance;
//                  E[x^2] - mean^2 loses digits on residual-grown rows)
//   softmax_av  -> written out inside attention.cu and swin_attention.cu
//                  (fp32 logits and softmax)
//   gelu / gelu_grad -> gelu_erf / gelu_erf_and_grad (exact erf, never the tanh
//                  form)
// The matrix products are hopper.cuh's (wgmma).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mvlt {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kSmemLimit = 232448;

// Route tags: a template argument of a kernel that several paths launch,
// naming the path, so that a profile (which sees kernel names) books its
// device time to that path -- #12's kernels inside kernels A, B, C, D and E
// and the fused attention forward, kernel F's inside E, #10's inside B, C
// and the fused attention forward, and kernel A's own products. kRowScale:
// whether an LN-MLP epilogue takes the per-sample row scale; kAttn: the
// route's number at #10's chain entry (attention.cu:mvlt_attention_fwd_route).
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
struct BlockAttentionRoute {  // kernel C's chain (block_attention.cu)
  static constexpr bool kRowScale = false;
  static constexpr int kAttn = 3;
};
struct SrKvRoute {  // kernel A's chain (sr_kv.cu)
  static constexpr bool kRowScale = false;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
// n <= 32 * kMaxPerLane bf16 values in global memory, by one warp; every
// lane gets both.
constexpr int kMaxPerLane = 16;

__device__ __forceinline__ float2 row_stats_global(const bf16* src, int n, float eps) {
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
  return make_float2(mean, rsqrtf(warp_sum(q) / n + eps));
}

}  // namespace mvlt
