// Whole transformer block of PVLT serving (kernel B), a chain of launches on
// wgmma (hopper.cuh) over bf16 scratch in device memory.
//
// Replaces: mvlt_tpu/ops/block_fused.py:fused_block (Pallas body _kernel) and
// its packed stage-1 form mvlt_tpu/ops/block_packed.py:fused_block_p2. It
// computes the same function without their TPU layout (no 128-lane padding,
// no two-tokens-per-row packing, no head-pair stripes):
//   out = h + fc2(gelu(fc1(LN2(h)))),  h = x + proj(attn(LN1(x) Wq + bq, K, V)) + bp
// with x [B, N, D] bf16, K and V [B, H, M, hd] bf16 from kernel A, weights in
// torch Linear layout [out, in] bf16, biases and LayerNorm affines fp32.
//
// What bounds it on the H100: the matrix products (Q, logits, P.V, out-proj,
// fc1, fc2), about 2.N.(2D^2 + 2.M.D + 2.D.hidden) flops per sample, against
// one read and one write of the bf16 stream: operations (0.37 ms summed over
// the four pvlt_tiny stages at B = 101).
//
// Design: the TPU kernel keeps a row tile's whole block in VMEM. On Hopper
// that fusion held every product on small wmma tiles of one block of 8 warps
// (its earlier body: 255 registers, spills, 10-27 TFLOP/s), so the block is
// a chain of wgmma launches, each at its own best tiling:
//   1-4. h = x + proj(attention(LN1(x) Wq + bq, K, V)) + bp: the
//        attention-half chain of attn_chain.cuh (#12's norm, Q on #12's
//        hidden kernel, #10's forward on [B, H, N, hd] views, the
//        out-projection on #12's out kernel), h bf16 [rows, D];
//   5.   out = h + MLP(LN2(h)): #12's forward through its C entry (one
//        launch at D <= 128, the hidden never in device memory; three above,
//        through LN2(h) and G in scratch), without a row scale.
// Every launch runs under BlockFusedRoute (common.cuh), so a profile books
// it to kernel B and the wrappers of #10 and #12 count none of them. The
// scratch is ops/block_fused.py:scratch's. h is rounded to bf16 between 4
// and 5, where the plain version keeps it in fp32 (kernel E's precedent,
// swin_block.cu).

#include "attn_chain.cuh"

// C entry, bound with ctypes. Launches the chain on `stream` and returns the
// first failing cudaError_t (0 on success); it does not synchronise. Head
// dim 32 or 64, D a multiple of 16 and at most 512, hidden a multiple of 16.
// The scratch: nrm, q, attn and h rows * D bf16 (nrm holds LN1(x), then
// #12's LN2(h)), g rows * hidden bf16 at D > 128 (else unused), lse B * H *
// N floats.
extern "C" int mvlt_block_fused(const void* x, const void* k, const void* v,
                                const void* ln1_w, const void* ln1_b, const void* wq,
                                const void* bq, const void* wp, const void* bp,
                                const void* ln2_w, const void* ln2_b, const void* w1,
                                const void* b1, const void* w2, const void* b2, void* out,
                                void* nrm, void* q, void* attn, void* h, void* g, void* lse,
                                int batch, int n, int d, int heads, int m, int hidden,
                                float scale, float eps1, float eps2, void* stream) {
  using namespace mvlt;
  if (hidden < 16 || hidden % 16) return (int)cudaErrorInvalidValue;
  const HalfArgs half{static_cast<const bf16*>(x),     static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),     static_cast<const float*>(ln1_w),
                      static_cast<const float*>(ln1_b), static_cast<const bf16*>(wq),
                      static_cast<const float*>(bq),   static_cast<const bf16*>(wp),
                      static_cast<const float*>(bp),   nullptr,
                      static_cast<bf16*>(h),           nullptr,
                      static_cast<bf16*>(nrm),         static_cast<bf16*>(q),
                      static_cast<bf16*>(attn),        static_cast<float*>(lse),
                      batch,                           n,
                      d,                               heads,
                      m,                               scale,
                      eps1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = attention_half_chain<BlockFusedRoute>(half, st);
  if (err != cudaSuccess) return (int)err;
  return mvlt_ln_mlp_fwd(h, ln2_w, ln2_b, w1, b1, w2, b2, nullptr, out, nrm, g,
                         (long long)batch * n, n, d, hidden, d <= 128, 2, eps2, nullptr, stream);
}
