// The attention half of a PVLT block on a tile of stream rows in shared
// memory, shared by kernel B (block_fused.cu, the whole v1 block), kernel C
// (block_attention.cu, the v2 block's attention half) and the training
// form's forward (block_attention_train.cu):
//   xres += proj(concat_h softmax((LN1(xres) Wq_h + bq_h) K_h^T * scale) V_h) + bp
// (the training form: xres += s * (proj(...) + bp), and optionally the LN1
// and softmax statistics of each row)
// with xres the fp32 residual tile [tr, d], K and V [B, H, M, hd] bf16 from
// kernel A, weights in torch Linear layout [out, in] bf16, biases and
// LayerNorm affines fp32. LayerNorm statistics, logits and softmax are fp32;
// the softmax is masked past the true K/V length M (padded to mp, a multiple
// of 16), and rows of the tile past the stream's end are computed on zeros.

#pragma once

#include <math.h>

#include "common.cuh"

namespace mvlt {

// Shared-memory rows of bf16 operands are padded by kPad elements (16 bytes)
// so that the 16 rows of a tensor-core fragment fall on different banks.
constexpr int kPad = 8;

struct AttnArgs {
  const bf16* k;
  const bf16* v;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wq;
  const float* bq;
  const bf16* wp;
  const float* bp;
  int heads, m;
  float scale, eps1;
};

// Bytes of the logits (fp32 [tr, mp]) and probabilities (bf16 [tr, mp + kPad])
// the attention half keeps while it runs, and where the probabilities start.
__host__ __device__ inline size_t attn_logit_bytes(int tr, int mp) {
  return align128((size_t)tr * mp * 4);
}
__host__ __device__ inline size_t attn_scratch_bytes(int tr, int mp) {
  return attn_logit_bytes(tr, mp) + align128((size_t)tr * (mp + kPad) * 2);
}

// Shared-memory layout of a kernel that runs the attention half alone on a
// tile of tr rows (kernel C and the training forward): the fp32 residual, the
// LN1 (later head outputs) and Q tiles, one head's K or V, the logits and
// probabilities, the GEMM staging.
struct AttnSmem {
  size_t xres, abuf, qall, kv, logit, stage, total;
};

__host__ __device__ inline AttnSmem attn_smem(int tr, int d, int mp, int hd) {
  AttnSmem s;
  size_t o = 0;
  s.xres = o;  o += align128((size_t)tr * d * 4);
  s.abuf = o;  o += align128((size_t)tr * (d + kPad) * 2);
  s.qall = o;  o += align128((size_t)tr * (d + kPad) * 2);
  s.kv = o;    o += align128((size_t)mp * (hd + kPad) * 2);
  s.logit = o; o += attn_scratch_bytes(tr, mp);
  s.stage = o; o += kStageBytes;
  s.total = o;
  return s;
}

__device__ inline void layer_norm_tile(const float* src, int rows, int d, const float* gamma,
                                       const float* beta, float eps, bf16* dst, int ld) {
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = src + (size_t)r * d;
    layer_norm_row([&](int c) { return row[c]; }, d, gamma, beta, eps, dst + (size_t)r * ld);
  }
}

// The fp32 residual tile [tr, d] from tr rows of a bf16 stream (rows past
// `rows` zero; d a multiple of 8, 16-byte loads), plus `bias` per column
// when it is not null.
__device__ inline void load_residual_tile(float* xres, const bf16* src, int tr, int d, int rows,
                                          const float* bias) {
#pragma unroll 4
  for (int i = threadIdx.x * 8; i < tr * d; i += kThreads * 8) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    const bool live = i / d < rows;
    if (live) raw = *reinterpret_cast<const uint4*>(src + i);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      xres[i + j] = __bfloat162float(e[j]) + (bias && live ? bias[(i + j) % d] : 0.0f);
  }
}

// One head's K or V [m, hd] (global, contiguous) into rows of ld = hd + kPad,
// rows m..mp zero; 16-byte asynchronous copies, waited for by the caller.
__device__ inline void load_head_async(bf16* dst, const bf16* src, int m, int mp, int hd) {
  const int ld = hd + kPad, per_row = hd / 8;
  for (int i = threadIdx.x; i < m * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    cp_async16(dst + r * ld + c, src + (size_t)r * hd + c);
  }
  for (int i = m * ld + threadIdx.x; i < mp * ld; i += kThreads) dst[i] = __float2bfloat16(0.0f);
}

// The attention half for sample b on the residual tile xres [tr, d] (fp32,
// loaded and synchronised by the caller); on return xres holds the tile's
// attention-half output, synchronised. Scratch: abuf and qall bf16
// [tr, d + kPad], kv bf16 [mp, hd + kPad], logit (attn_scratch_bytes),
// stage (kStageBytes). abuf ends up holding the concatenated head outputs.
// kTrain (the training forward): the projection sum is scaled by
// row_scale, and where stats is not null the first `rows` rows get their
// statistics at stats[r * (2 + 2H)]: LN1 mean and 1/std, then per head the
// row max of the scaled logits and 1/denominator (P = exp(l - max) * inv).
// The serving form (kTrain false) compiles to the code it always had.
template <bool kTrain = false>
__device__ __forceinline__ void attention_half(const AttnArgs& a, int b, int tr, int d, float* xres,
                                               bf16* abuf, bf16* qall, bf16* kv, float* logit,
                                               float* stage, float row_scale = 1.0f,
                                               float* stats = nullptr, int rows = 0) {
  const int hd = d / a.heads, m = a.m, mp = (m + 15) & ~15;
  const int ld = d + kPad, ldk = hd + kPad, ldp = mp + kPad;
  bf16* probs = reinterpret_cast<bf16*>(reinterpret_cast<char*>(logit) + attn_logit_bytes(tr, mp));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  [[maybe_unused]] const int sw = 2 + 2 * a.heads;

  if constexpr (kTrain) {
    for (int r = warp; r < tr; r += kWarps) {
      const float* row = xres + (size_t)r * d;
      const float2 st = layer_norm_row([&](int c) { return row[c]; }, d, a.ln1_w, a.ln1_b,
                                       a.eps1, abuf + (size_t)r * ld);
      if (stats && r < rows && lane == 0) {
        stats[(size_t)r * sw] = st.x;
        stats[(size_t)r * sw + 1] = st.y;
      }
    }
  } else {
    layer_norm_tile(xres, tr, d, a.ln1_w, a.ln1_b, a.eps1, abuf, ld);
  }
  __syncthreads();
  gemm_bf16<true, 2>(abuf, ld, a.wq, d, tr, d, d, stage, [&](int r, int c, float v) {
    qall[r * ld + c] = __float2bfloat16(v + a.bq[c]);
  });
  __syncthreads();

  for (int h = 0; h < a.heads; ++h) {
    const size_t kv_off = ((size_t)b * a.heads + h) * m * hd;
    load_head_async(kv, a.k + kv_off, m, mp, hd);
    cp_async_wait_all();
    __syncthreads();
    // logits = q_h . K_h^T * scale (fp32)
    gemm_bf16<true, 2>(qall + h * hd, ld, kv, ldk, tr, mp, hd, stage,
                       [&](int r, int c, float v) { logit[r * mp + c] = v * a.scale; });
    __syncthreads();
    // V_h streams in while the softmax runs
    load_head_async(kv, a.v + kv_off, m, mp, hd);
    // fp32 softmax over the first m columns; padded columns get probability 0
    for (int r = warp; r < tr; r += kWarps) {
      float* lr = logit + (size_t)r * mp;
      float mx = -INFINITY;
      for (int c = lane; c < m; c += 32) mx = fmaxf(mx, lr[c]);
      mx = warp_max(mx);
      float s = 0.0f;
      for (int c = lane; c < m; c += 32) {
        const float e = __expf(lr[c] - mx);
        lr[c] = e;
        s += e;
      }
      const float inv = 1.0f / warp_sum(s);
      for (int c = lane; c < mp; c += 32)
        probs[(size_t)r * ldp + c] = __float2bfloat16(c < m ? lr[c] * inv : 0.0f);
      if constexpr (kTrain) {
        if (stats && r < rows && lane == 0) {
          stats[(size_t)r * sw + 2 + 2 * h] = mx;
          stats[(size_t)r * sw + 3 + 2 * h] = inv;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // head output P . V_h into its columns of abuf (LN1 is no longer needed)
    gemm_bf16<false, 2>(probs, ldp, kv, ldk, tr, hd, mp, stage, [&](int r, int c, float v) {
      abuf[r * ld + h * hd + c] = __float2bfloat16(v);
    });
    __syncthreads();
  }

  if constexpr (kTrain) {
    gemm_bf16<true, 2>(abuf, ld, a.wp, d, tr, d, d, stage, [&](int r, int c, float v) {
      xres[r * d + c] += row_scale * (v + a.bp[c]);
    });
  } else {
    gemm_bf16<true, 2>(abuf, ld, a.wp, d, tr, d, d, stage,
                       [&](int r, int c, float v) { xres[r * d + c] += v + a.bp[c]; });
  }
  __syncthreads();
}

}  // namespace mvlt
