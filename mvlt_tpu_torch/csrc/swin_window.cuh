// Window attention with an additive logit bias on the wmma core, for kernel
// E (swin_block.cu, the whole Swin block; kernel F, swin_attention.cu, runs
// on wgmma):
//   out = softmax(q [K_win | K_txt]^T * scale + add) [V_win | V_txt]
// for one head of one window, everything in shared memory. The softmax is
// the exp2 form of mvlt_tpu/ops/kernel_math.py:softmax_av: logits in fp32
// and in log2 units (log2(e) folded into the scale and the bias), the
// unnormalised probabilities rounded to bf16 for P.V, and the fp32 row sums
// applied after P.V.

#pragma once

#include <math.h>

#include "common.cuh"

namespace mvlt {

// Shared-memory rows of bf16 operands are padded by kWinPad elements (16
// bytes) so that the 16 rows of a tensor-core fragment fall on different banks.
constexpr int kWinPad = 8;
constexpr float kLog2e = 1.4426950408889634f;
// A softmax row is held in registers, 16 values a lane: ws^2 + T <= 512.
constexpr int kMaxKeys = 32 * 16;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// The fp32 logit tile [rows_p, mp + 4]; the bf16 probabilities overwrite it
// in place, row r at the start of its logit row (row stride 2 (mp + 4)).
__host__ __device__ inline size_t win_logit_bytes(int rows_p, int mp) {
  return align128((size_t)rows_p * (mp + 4) * 4);
}

// Rows [0, rows) of a [rows, hd] bf16 matrix whose rows are src_ld elements
// apart in global memory, into rows of ld elements in shared memory;
// 16-byte asynchronous copies, waited for by the caller.
__device__ inline void load_rows_async(bf16* dst, int ld, const bf16* src, long long src_ld,
                                       int rows, int hd) {
  const int per_row = hd / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    cp_async16(dst + (size_t)r * ld + c, src + r * src_ld + c);
  }
}

__device__ inline void zero_rows(bf16* dst, int ld, int r0, int r1, int n) {
  for (int i = threadIdx.x; i < (r1 - r0) * n; i += kThreads)
    dst[(size_t)(r0 + i / n) * ld + i % n] = __float2bfloat16(0.0f);
}

// One head of one window: q [rows_p, hd] (ld ldk; rows past `rows` are
// padding, computed and never handed out) against m = rows_k + T keys held
// in kv [mp, hd] (ld ldk). load_k() and load_v() fill kv rows [0, m) with K,
// then V (asynchronous copies and/or a product by all threads); rows [m, mp)
// are zeroed here. add(r, c) is the additive logit term of query r and key c
// < m in natural units (-INFINITY masks). out(r, c, v) receives the
// normalised output of query r < rows, column c < hd. Scratch: logit
// (win_logit_bytes), inv [rows_p] fp32, stage (kStageBytes). All threads call
// it; it returns synchronised.
template <class LoadK, class LoadV, class Add, class Out>
__device__ __forceinline__ void window_attention(const bf16* q, bf16* kv, int ldk, int rows,
                                                 int m, int hd, float* logit, float* inv,
                                                 float* stage, float scale, LoadK load_k,
                                                 LoadV load_v, Add add, Out out) {
  const int rows_p = round16(rows), mp = round16(m), lds = mp + 4;
  const float sl2 = scale * kLog2e;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  zero_rows(kv, ldk, m, mp, hd);
  load_k();
  cp_async_wait_all();
  __syncthreads();
  gemm_bf16<true, 2>(q, ldk, kv, ldk, rows_p, mp, hd, stage, [&](int r, int c, float v) {
    logit[r * lds + c] = c >= m ? -INFINITY : r >= rows ? 0.0f : v * sl2 + add(r, c) * kLog2e;
  });
  __syncthreads();
  load_v();
  bf16* probs = reinterpret_cast<bf16*>(logit);
  for (int r = warp; r < rows_p; r += kWarps) {
    const float* lr = logit + (size_t)r * lds;
    float e[16];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = lane + 32 * j;
      e[j] = c < mp ? lr[c] : -INFINITY;
      mx = fmaxf(mx, e[j]);
    }
    mx = warp_max(mx);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      e[j] = exp2f(e[j] - mx);
      s += e[j];
    }
    s = warp_sum(s);
    __syncwarp();   // the whole row is in registers before it is overwritten
    bf16* pr = probs + (size_t)r * 2 * lds;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = lane + 32 * j;
      if (c < mp) pr[c] = __float2bfloat16(e[j]);
    }
    if (lane == 0) inv[r] = 1.0f / s;
  }
  cp_async_wait_all();
  __syncthreads();
  gemm_bf16<false, 2>(probs, 2 * lds, kv, ldk, rows_p, hd, mp, stage,
                      [&](int r, int c, float v) {
                        if (r < rows) out(r, c, v * inv[r]);
                      });
  __syncthreads();
}

}  // namespace mvlt
