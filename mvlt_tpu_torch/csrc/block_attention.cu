// Attention half of a PVT-v2 serving block, one launch per block (kernel C).
//
// Replaces: mvlt_tpu/ops/block_attention.py:fused_block_attention_padded
// (Pallas body _kernel, on the lane-padded stream of stages 2-4) and
// mvlt_tpu/ops/block_packed.py:fused_attention_p2 (Pallas body
// _attn_kernel_p2, on the packed stage-1 stream). It computes their function
// without their TPU layouts (no 128-lane padding, no two-tokens-per-row
// packing, no per-head 128-lane stripes):
//   out = x + proj(concat_h softmax((LN1(x) Wq_h + bq_h) K_h^T * hd^-1/2) V_h) + bp
// with x [B, N, D] bf16, K and V [B, H, M, hd] bf16 from kernel A (sr_kv.cu).
//
// What bounds it on the H100: the Q, logits, P.V and out-proj products,
// 2.N.(2D^2 + 2.M.D) flops per sample, against one read and one write of the
// bf16 stream and one read of K/V; at stage 1 (D = 64, one head) the bytes
// weigh more, at stages 2-4 the products.
//
// Design: attn_half.cuh's tile code on the wmma core. One block of 8
// warps owns TR stream rows of one sample, keeps their fp32 residual, LN1'd
// copy, Q, one head's K and V, and the logits and probabilities in shared
// memory, and writes the tile once. TR is the largest of 64/32/16 whose
// layout fits the 227 KB of shared memory. The sum x + proj + bp is fp32 and
// rounded once.

#include <initializer_list>

#include "attn_half.cuh"

namespace mvlt {
namespace {

struct AttnKernelArgs {
  const bf16* x;
  AttnArgs at;
  bf16* out;
  int n, d, tr;
};

__global__ void __launch_bounds__(kThreads) block_attention_kernel(AttnKernelArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int tr = a.tr, d = a.d, hd = d / a.at.heads, mp = (a.at.m + 15) & ~15;
  const int b = blockIdx.y, n0 = blockIdx.x * tr;
  const int rows = min(tr, a.n - n0);
  const AttnSmem L = attn_smem(tr, d, mp, hd);
  float* xres = reinterpret_cast<float*>(smem + L.xres);

  // residual tile, fp32; rows past N are zero and never stored
  load_residual_tile(xres, a.x + ((size_t)b * a.n + n0) * d, tr, d, rows);
  __syncthreads();
  attention_half(a.at, b, tr, d, xres, reinterpret_cast<bf16*>(smem + L.abuf),
                 reinterpret_cast<bf16*>(smem + L.qall), reinterpret_cast<bf16*>(smem + L.kv),
                 reinterpret_cast<float*>(smem + L.logit),
                 reinterpret_cast<float*>(smem + L.stage));

  bf16* ob = a.out + ((size_t)b * a.n + n0) * d;
  for (int i = threadIdx.x * 8; i < rows * d; i += kThreads * 8) {
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(xres[i + j]);
    *reinterpret_cast<uint4*>(ob + i) = raw;
  }
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int mvlt_block_attention(const void* x, const void* k, const void* v,
                                    const void* ln1_w, const void* ln1_b, const void* wq,
                                    const void* bq, const void* wp, const void* bp, void* out,
                                    int batch, int n, int d, int heads, int m, float scale,
                                    float eps1, void* stream) {
  using namespace mvlt;
  const int hd = d / heads, mp = (m + 15) & ~15;
  int tr = 0;
  size_t bytes = 0;
  for (int cand : {64, 32, 16}) {
    bytes = attn_smem(cand, d, mp, hd).total;
    if (bytes <= kSmemLimit) {
      tr = cand;
      break;
    }
  }
  if (!tr) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      block_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const AttnArgs at{static_cast<const bf16*>(k),      static_cast<const bf16*>(v),
                    static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                    static_cast<const bf16*>(wq),     static_cast<const float*>(bq),
                    static_cast<const bf16*>(wp),     static_cast<const float*>(bp),
                    heads, m, scale, eps1};
  AttnKernelArgs a{static_cast<const bf16*>(x), at, static_cast<bf16*>(out), n, d, tr};
  dim3 grid((n + tr - 1) / tr, batch);
  block_attention_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
