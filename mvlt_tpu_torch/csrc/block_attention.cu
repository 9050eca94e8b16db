// Attention half of a PVT-v2 serving block (kernel C), a chain of wgmma
// launches over bf16 scratch in device memory.
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
// Design: kernel B's attention half with no row scale and no statistics, so
// the same chain (attn_chain.cuh:attention_half_chain) under
// BlockAttentionRoute: #12's norm kernel (LN1), #12's hidden kernel with
// GELU off (Q), #10's forward on [B, H, N, hd] views of Q and A, #12's out
// kernel (the out-projection and the residual, the sum fp32 and rounded
// once). Each product runs at its own tiling on wgmma; a profile books the
// four launches to kernel C, and the wrappers of #10 and #12 count none of
// them.

#include "attn_chain.cuh"

// C entry, bound with ctypes. Launches the chain on `stream` and returns the
// first failing cudaError_t (0 on success); it does not synchronise. Head
// dim 32 or 64, D a multiple of 16 and at most 512. The scratch
// (ops/block_attention.py:fwd_scratch): nrm, q and attn rows * D bf16, lse
// B * H * N floats.
extern "C" int mvlt_block_attention(const void* x, const void* k, const void* v,
                                    const void* ln1_w, const void* ln1_b, const void* wq,
                                    const void* bq, const void* wp, const void* bp, void* out,
                                    void* nrm, void* q, void* attn, void* lse, int batch, int n,
                                    int d, int heads, int m, float scale, float eps1,
                                    void* stream) {
  using namespace mvlt;
  const HalfArgs half{static_cast<const bf16*>(x),     static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),     static_cast<const float*>(ln1_w),
                      static_cast<const float*>(ln1_b), static_cast<const bf16*>(wq),
                      static_cast<const float*>(bq),   static_cast<const bf16*>(wp),
                      static_cast<const float*>(bp),   nullptr,
                      static_cast<bf16*>(out),         nullptr,
                      static_cast<bf16*>(nrm),         static_cast<bf16*>(q),
                      static_cast<bf16*>(attn),        static_cast<float*>(lse),
                      batch,                           n,
                      d,                               heads,
                      m,                               scale,
                      eps1};
  return (int)attention_half_chain<BlockAttentionRoute>(half, static_cast<cudaStream_t>(stream));
}
