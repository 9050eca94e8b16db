// The attention half of a PVLT block as a chain of wgmma launches over bf16
// scratch in device memory, shared by kernel B's chain (block_fused.cu, v1
// serving), kernel C (block_attention.cu, the v2 block's attention half,
// serving) and the fused attention forward (block_attention_train.cu,
// Pallas #6/#7):
//   out = x + s[b] * (proj(concat_h softmax((LN1(x) Wq_h + bq_h) K_h^T * scale) V_h) + bp)
// with s = 1 on a route without a row scale (BlockFusedRoute,
// BlockAttentionRoute), for x
// [B, N, D] bf16, K and V [B, H, M, hd] bf16 contiguous, Wq and Wp [D, D] in
// torch Linear layout bf16, biases, the LN1 affine and s [B] fp32:
//   1. LN1(x) -> nrm bf16 [rows, D] by #12's norm kernel, one warp a row
//      (two-pass fp32 statistics); where stats is not null each row's mean
//      and 1/std also go to its statistics columns 0 and 1;
//   2. Q = nrm Wq^T + bq -> q bf16 [rows, D] by #12's hidden kernel with
//      GELU off (hopper.cuh:mma_tile, K = D: two blocks an SM at D <= 128);
//   3. A = softmax(Q K_h^T scale) V_h -> attn bf16 [rows, D] by #10's
//      forward kernel through its route entry (attention.cu), Q and A read
//      and written as [B, H, N, hd] views of [B, N, D] (head h in columns
//      h.hd ..); the rows' lse to `lse` [B, H, N] (unused after); where stats
//      is not null each head's row max (natural units) and 1/denominator go
//      to columns 2 + 2h and 3 + 2h;
//   4. out = x + s (A Wp^T + bp) by #12's out kernel (its fc2 with G = A,
//      K = D), x read in bf16, the sum in fp32 and rounded once; each row
//      takes its own sample's scale (a 128-row tile may span two samples).
// Every launch runs under the caller's route tag (common.cuh), so a profile
// books the chain's device time to the path that ran it, and the wrappers
// of #10 and #12 count none of these launches. The rounding points are the
// plain version's (ops/block_attention.py:attention_residual): LN1, Q and A
// bf16, the residual sum fp32.

#pragma once

#include "ln_mlp.cuh"

// #10's forward on a chain's route (attention.cu).
extern "C" int mvlt_attention_fwd_route(const void* q, const void* k, const void* v, void* o,
                                        void* lse, void* stats, const long long* strides,
                                        int batch, int heads, int n, int m, int hd, int stats_ld,
                                        int route, float scale, void* stream);

namespace mvlt {

struct HalfArgs {
  const bf16* x;
  const bf16* k;
  const bf16* v;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wq;
  const float* bq;
  const bf16* wp;
  const float* bp;
  const float* s;  // [B], routes with kRowScale only
  bf16* out;
  float* stats;  // [B, N, 2 + 2H] or null
  bf16* nrm;     // scratch [rows, D] each
  bf16* q;
  bf16* attn;
  float* lse;  // scratch [B, H, N]
  int batch, n, d, heads, m;
  float scale, eps;
};

// Whether the chain takes these shapes: head dim 32 or 64 (#10's), D a
// multiple of 16 and at most 512 (#12's), at most 2^30 rows.
inline bool half_chain_takes(int batch, int n, int d, int heads, int m) {
  const long long rows = (long long)batch * n;
  return batch >= 1 && n >= 1 && m >= 1 && heads >= 1 && d % heads == 0 && d % 16 == 0 &&
         d <= 512 && (d / heads == 32 || d / heads == 64) && rows <= (1LL << 30);
}

// Launches the chain on `st`; returns the first failing cudaError_t.
template <class Route>
cudaError_t attention_half_chain(const HalfArgs& h, cudaStream_t st) {
  if (!half_chain_takes(h.batch, h.n, h.d, h.heads, h.m)) return cudaErrorInvalidValue;
  const int d = h.d, hd = d / h.heads, sw = 2 + 2 * h.heads;
  const long long rows = (long long)h.batch * h.n;
  // LN1 and Q as #12's norm and hidden (fc1 = Wq, no GELU); the
  // out-projection as its fc2 over A
  const LnMlpArgs ln{h.x,   h.ln1_w, h.ln1_b, h.wq, h.bq, h.wp,    h.bp,    h.s,   h.out,
                     h.nrm, h.q,     (int)rows, h.n, d,    d,    h.eps, h.stats, sw};
  cudaError_t err = ln_mlp_fwd_norm<Route>(ln, st);
  if (err == cudaSuccess) err = ln_mlp_fwd_hidden<Route, false>(ln, st);
  if (err != cudaSuccess) return err;
  // the attention core on [B, H, N, hd] views: (batch, head, row) strides of
  // Q, K, V, then A
  const long long view_q[3] = {(long long)h.n * d, hd, d};
  const long long view_a[3] = {(long long)h.n * d, hd, d};
  const long long view_kv[3] = {(long long)h.heads * h.m * hd, (long long)h.m * hd, hd};
  long long strides[12];
  for (int c = 0; c < 3; ++c) {
    strides[c] = view_q[c];
    strides[3 + c] = strides[6 + c] = view_kv[c];
    strides[9 + c] = view_a[c];
  }
  err = (cudaError_t)mvlt_attention_fwd_route(h.q, h.k, h.v, h.attn, h.lse, h.stats, strides,
                                              h.batch, h.heads, h.n, h.m, hd, sw, Route::kAttn,
                                              h.scale, st);
  if (err != cudaSuccess) return err;
  LnMlpArgs proj = ln;
  proj.g = h.attn;
  return ln_mlp_fwd_out<Route>(proj, st);
}

}  // namespace mvlt
