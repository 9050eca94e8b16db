// The LN-MLP forward's (#12, ln_mlp.cu) host launchers and epilogue, shared
// with the chains that run its kernels: kernel A (sr_kv.cu: LN1), kernel D
// (dwconv_mlp.cu: LN2, fc1 without GELU, and fc2 with the residual, around
// its conv), kernel E (swin_block.cu: the block's MLP half, and its
// out-projection epilogue), and the attention-half chain of kernels B and C
// and the fused attention forward (attn_chain.cuh: LN1, Q as fc1 without
// GELU, the out-projection as fc2 over the attention output; B's MLP half
// through the C entry).
//
// Its kernels carry a route tag (common.cuh): LnMlpRoute when #12 runs
// itself, SrKvRoute, DwConvRoute, SwinBlockRoute, BlockFusedRoute and
// BlockAttentionRoute inside A's, D's, E's, B's and C's chains, whose
// epilogues take no row scale, and FbaFwdRoute inside the fused attention
// forward's, whose out-projection takes it.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mvlt {

struct LnMlpArgs {
  const bf16* x;
  const float* gamma;
  const float* beta;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* s;  // [B] row scale (routes with kRowScale only)
  bf16* out;
  bf16* nrm;  // [rows, D] LN(x) (three-launch form)
  bf16* g;    // [rows, H] the hidden (three-launch form)
  int rows, n, d, hidden;
  float eps;
  float* stats;  // the norm kernel's (mean, 1/std) of row r at stats[r * stats_ld], or null
  int stats_ld;
};

// y rows of an epilogue: 8 columns c .. c + 7 of row `row`, v the fc2 sums:
// y = x + s (v + b2), s the row's sample's scale or 1.
template <class Route>
__device__ __forceinline__ void store_out(const LnMlpArgs& a, int row, int c,
                                          const float (&v)[8]) {
  const size_t o = (size_t)row * a.d + c;
  const float sc = Route::kRowScale ? a.s[row / a.n] : 1.0f;
  const uint4 xr = *reinterpret_cast<const uint4*>(a.x + o);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xr);
  float y[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xf = __bfloat1622float2(xp[e]);
    y[2 * e] = xf.x + sc * (v[2 * e] + a.b2[c + 2 * e]);
    y[2 * e + 1] = xf.y + sc * (v[2 * e + 1] + a.b2[c + 2 * e + 1]);
  }
  *reinterpret_cast<uint4*>(a.out + o) = hopper::pack_bf16x8(y);
}

// The three-launch form's kernels, one launch each: nrm = LN(x) (and the
// rows' statistics where a.stats is not null);
// g = LN(x) W1^T + b1, through GELU where Gelu; out = x + s (g W2^T + b2).
template <class Route>
cudaError_t ln_mlp_fwd_norm(const LnMlpArgs& a, cudaStream_t st);
template <class Route, bool Gelu>
cudaError_t ln_mlp_fwd_hidden(const LnMlpArgs& a, cudaStream_t st);
template <class Route>
cudaError_t ln_mlp_fwd_out(const LnMlpArgs& a, cudaStream_t st);

}  // namespace mvlt

// ln_mlp.cu's C entry; route 0 is #12 itself (LnMlpRoute), 1 kernel E
// (SwinBlockRoute), 2 kernel B (BlockFusedRoute); routes 1 and 2 take no
// row scale (s may be null).
extern "C" int mvlt_ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* s, void* out, void* nrm, void* g, long long rows, int n,
                               int d, int hidden, int fused, int route, float eps, void* stream);
