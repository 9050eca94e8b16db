// The attention half of a PVLT v1 training block, forward and backward
// (the fused_attn_train route):
//   out = x + s[b] * (proj(concat_h softmax((LN1(x) Wq_h + bq_h) K_h^T * hd^-1/2) V_h) + bp)
// for x [B, N, D] bf16, K and V [B, H, M, hd] bf16 (projected in PyTorch),
// Wq and Wp [D, D] in torch Linear layout (bf16 copies of the fp32 masters),
// biases and the LN1 affine fp32, and s [B] fp32, the per-sample DropPath
// scale (mask / keep).
//
// Replaces: mvlt_tpu/ops/block_attention.py:_fba_impl (forward, Pallas body
// _kernel), _fba_impl_stats (forward with a statistics side output, Pallas
// body _kernel_stats) and _fba_bwd (backward, Pallas bodies _bwd_kernel and
// _bwd_kernel_stats), without their TPU layouts (no 128-lane padding of D,
// hd or M, no per-head 128-lane stripes) and without their XLA fallback at
// stage 4. The statistics are [B, N, 2 + 2H] fp32 in natural units: per row
// the LN1 mean and 1/std, then per head the row max of the scaled logits
// and 1/denominator, so that P = exp(l - max) * inv.
//
// What bounds it on the H100: the forward does 4.N.(D^2 + M.D) flops per
// sample (Q, logits, P.V, out-projection) against one read and one write of
// the bf16 stream: bytes at every stage on paper (0.16 ms summed over the
// four stages at B = 150); the backward 10.N.D^2 + 12.N.M.D flops per
// sample (Q and dO, the attention core's logits, P.V, dP, dQ, dK, dV, then
// dWq, dWp and dLN1) against x and dy read and dx written: operations at
// every stage on paper (0.41 ms summed over the four stages at B = 150).
//
// Design, forward: the attention-half chain of attn_chain.cuh under
// FbaFwdRoute (#12's norm, Q on #12's hidden kernel, #10's forward on
// [B, H, N, hd] views, the out-projection on #12's out kernel with the
// row's own scale s[b]) over the scratch of ops/block_attention.py:
// fwd_scratch; in the statistics form (Pallas #7) the norm kernel writes
// each row's LN1 mean and 1/std and #10's forward, in its statistics mode,
// each head's row max and 1/denominator, nothing else changes (Pallas #6).
//
// Design, backward: the TPU kernel fuses everything per row tile because its
// grid runs in order and carries the weight gradients; on Hopper that fusion
// keeps the products on small tiles of a slow core, so the backward is a
// chain of wgmma launches over bf16 scratch in [B, N, D] (ops/
// block_attention.py:bwd_scratch), every cross-block sum in a fixed order
// (no atomics: two calls are bit-equal):
//   fba_bwd_prep_kernel   a warp takes 8 / P rows of P column pairs a lane:
//       LN1 (two-pass statistics, or the forward's saved mean and 1/std),
//       LN1(x) and s.dy in bf16 [rows, D], (mean, rstd) [rows]; in the
//       statistics form also each head's lse = max - log(1/den), natural;
//   fba_bwd_proj_kernel   Q = LN1(x) Wq^T + bq and dO = (s.dy) Wp, bf16
//       [rows, D], on hopper.cuh:mma_tile (K = D), one launch for both;
//   the attention core per (sample, head) on the wgmma kernels of
//       attention.cu, called through their C entries, Q, dO, A and dQ read
//       and written as [B, H, N, hd] views of [B, N, D] (head h in columns
//       h.hd ..): A = P V_h and lse by the #10 forward (recompute form), or
//       A = exp(S - lse) V_h with the statistics' lse and no softmax
//       reductions (its Fixed form: the statistics form saves the row max,
//       sum and rescale, not the products); then dQ, dK, dV by the #11
//       backward, its split-N dK/dV slots summed in order;
//   fba_bwd_wgrad_kernel  dWq = dQ^T LN1(x) and dWp = (s.dy)^T A, long-K
//       GEMMs over the rows (hopper.cuh:gemm_tn_block) split into row ranges
//       (ops/block_attention.py:bwd_plan) whose fp32 slots are summed after;
//   fba_bwd_proj_kernel   dLN1 = dQ Wq in fp32, into Q's and dO's space;
//   fba_bwd_rows_kernel   dx = dy + the LN1 backward of dLN1, and per block
//       of rows the fp32 column sums of s.dy (dbp), dLN1.nhat (dgamma), dLN1
//       (dbeta) and dQ (dbq) into a slot;
//   fba_bwd_sum_kernel    every slot set summed in order.
// Padded rows and columns load as zeros and add nothing; a sample with s = 0
// has dO = 0, so its dQ, dLN1 and every sum it joins are exactly 0 and its
// dx is dy.
//
// Tensor-parallel mode (the C entries' `part` / `dx_part` set): the chains
// run on a rank's H heads of head dim hd (passed in, H hd < D): Wq and bq
// its [H hd, D] rows, Wp its [D, H hd] columns, K and V its heads. Q, dO, A
// and dQ are [rows, H hd]; the forward writes the fp32 partial s (A Wp^T)
// without bp and x (attn_chain.cuh), the backward the fp32 partial dx, the
// LN1 backward of the rank's dLN1 without dy, with dgamma and dbeta of the
// rank's heads and dWq, dbq, dWp of its shard whole; dbp is s.dy's column
// sum, whole on every rank. The model group sums the partials
// (parallel/tensor.py:fused_attn_tp). The same kernels, with the width of
// the heads apart from D and one branch in the row kernel's store.

#include <math.h>

#include "attn_chain.cuh"

// The attention core's C entries (attention.cu).
extern "C" int mvlt_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  const long long* strides, int batch, int heads, int n, int m,
                                  int hd, float scale, void* stream);
extern "C" int mvlt_attention_fwd_from_lse(const void* q, const void* k, const void* v, void* o,
                                           const void* lse, const long long* strides, int batch,
                                           int heads, int n, int m, int hd, float scale,
                                           void* stream);
extern "C" int mvlt_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                  void* slots, void* dq_acc, const long long* strides, int batch,
                                  int heads, int n, int m, int hd, int splits, float scale,
                                  void* stream);

namespace mvlt {
namespace {

// ---- backward ---------------------------------------------------------------

using namespace hopper;

constexpr int kSumThreads = 256;

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const float* ln1_w;
  const float* ln1_b;
  const float* s;
  const float* stats;  // [rows, 2 + 2H] from the forward, or null (recompute)
  bf16* dx;
  bf16* nrm;    // [rows, D] LN1(x)
  bf16* dys;    // [rows, D] s.dy
  bf16* dq;     // [rows, D] dQ
  float* dn;    // [rows, D] dLN1 fp32
  float2* st;   // [rows] (mean, rstd)
  float* lse;   // [B, H, N]
  float* colp;  // [col blocks][4][D]: column sums of s.dy, dLN1.nhat, dLN1, dQ
  int rows, n, d, heads;
  float eps;
  int dh;                    // the heads' width H hd (D, or a rank's under TP)
  float* dx_part = nullptr;  // [rows, D] fp32: the tensor-parallel mode's dx
};



template <int P>
__global__ void __launch_bounds__(kThreads) fba_bwd_prep_kernel(BwdArgs a) {
  constexpr int R = rows_at_once(P);
  const int lane = threadIdx.x & 31, d = a.d, sw = 2 + 2 * a.heads;
  const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  float2 xv[R][P], dv[R][P];
  float mean[R], rstd[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    mean[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      xv[k][p] = dv[k][p] = make_float2(0.0f, 0.0f);
      if (r0 + k < a.rows && c < d) {
        xv[k][p] = load_bf16x2(a.x + (size_t)(r0 + k) * d + c);
        dv[k][p] = load_bf16x2(a.dy + (size_t)(r0 + k) * d + c);
      }
      mean[k] += xv[k][p].x + xv[k][p].y;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (a.stats) {  // the forward's statistics
      const bool in = r0 + k < a.rows;
      mean[k] = in ? a.stats[(size_t)(r0 + k) * sw] : 0.0f;
      rstd[k] = in ? a.stats[(size_t)(r0 + k) * sw + 1] : 0.0f;
      continue;
    }
    mean[k] = warp_sum(mean[k]) / d;  // two-pass: the mean, then the centred variance
    float var = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (2 * lane + 64 * p < d) {
        const float z0 = xv[k][p].x - mean[k], z1 = xv[k][p].y - mean[k];
        var += z0 * z0 + z1 * z1;
      }
    }
    rstd[k] = rsqrtf(warp_sum(var) / d + a.eps);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = r0 + k;
    if (r >= a.rows) continue;
    const float sc = a.s[r / a.n];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c < d) {
        const size_t o = (size_t)r * d + c;
        store_bf16x2(a.nrm + o, (xv[k][p].x - mean[k]) * rstd[k] * a.ln1_w[c] + a.ln1_b[c],
                     (xv[k][p].y - mean[k]) * rstd[k] * a.ln1_w[c + 1] + a.ln1_b[c + 1]);
        store_bf16x2(a.dys + o, dv[k][p].x * sc, dv[k][p].y * sc);
      }
    }
    if (lane == 0) a.st[r] = make_float2(mean[k], rstd[k]);
    if (a.stats && lane < a.heads) {  // lse = max + log(den) = max - log(1/den), natural
      const float* sr = a.stats + (size_t)r * sw + 2 + 2 * lane;
      a.lse[((size_t)(r / a.n) * a.heads + lane) * a.n + r % a.n] = sr[0] - logf(sr[1]);
    }
  }
}

// out = A B^T (+ bias), [rows, ncols], bf16 or fp32; B [ncols][K] (K-major)
// or [K][ncols] (b_mn).
struct ProjJob {
  Mat a, b;
  const float* bias;  // or null
  void* out;
  int ncols, b_mn, f32;
};

// Blocks [0, row tiles x column tiles) of job blockIdx.y, row tile major.
__global__ void __launch_bounds__(kGemmThreads, 1) fba_bwd_proj_kernel(
    const __grid_constant__ ProjJob j0, const __grid_constant__ ProjJob j1) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const ProjJob& j = blockIdx.y ? j1 : j0;
  const int ntiles = (j.ncols + kGemmTile - 1) / kGemmTile;
  const int m0 = (blockIdx.x / ntiles) * kGemmTile, n0 = (blockIdx.x % ntiles) * kGemmTile;
  const int chunks = (j.a.cols + kGemmChunk - 1) / kGemmChunk, rows = j.a.rows;
  float d[64];
  if (j.b_mn)
    mma_tile<false, true>(j.a, j.b, m0, n0, 0, chunks, smem_u32(smem), d);
  else
    mma_tile<false, false>(j.a, j.b, m0, n0, 0, chunks, smem_u32(smem), d);
  store_tile(d, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    const int row = m0 + r, col = n0 + c;
    if (row >= rows || col >= j.ncols) return;
    const size_t o = (size_t)row * j.ncols + col;
    if (j.f32) {
      float4* out = reinterpret_cast<float4*>(static_cast<float*>(j.out) + o);
      out[0] = make_float4(v[0], v[1], v[2], v[3]);
      out[1] = make_float4(v[4], v[5], v[6], v[7]);
      return;
    }
    if (j.bias) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += j.bias[col + e];
    }
    *reinterpret_cast<uint4*>(static_cast<bf16*>(j.out) + o) = pack_bf16x8(v);
  });
}

// Blocks [0, tiles) x splits for dWq, the same again for dWp (blockIdx.y).
__global__ void __launch_bounds__(kGemmThreads, 1) fba_bwd_wgrad_kernel(
    const __grid_constant__ GemmArgs dwq, const __grid_constant__ GemmArgs dwp, int splits) {
  extern __shared__ char smem_raw[];
  gemm_tn_pair(dwq, dwp, splits, smem_raw);
}

// dx = dy + (dLN1 gamma - m1 - nhat m2) rstd per row; block b takes the
// warp-row groups b, b + gridDim.x, ... (a fixed set for a fixed grid) and
// writes its column sums to slot b. Dynamic shared memory: kWarps * 4 * D
// floats.
template <int P>
__global__ void __launch_bounds__(kThreads) fba_bwd_rows_kernel(BwdArgs a) {
  constexpr int R = rows_at_once(P);
  extern __shared__ float part[];  // [warp][4][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = a.d;
  float sum[4][P][2];  // the lane's column sums: s.dy, dLN1.nhat, dLN1, dQ
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < P; ++p) sum[q][p][0] = sum[q][p][1] = 0.0f;
  for (int g = blockIdx.x * kWarps + warp; g * R < a.rows; g += gridDim.x * kWarps) {
    const int r0 = g * R;
    float2 dn[R][P], xh[R][P], dyv[R][P], dqv[R][P];
    float m1[R], m2[R];
    float2 st[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool in = r0 + k < a.rows;
      st[k] = in ? a.st[r0 + k] : make_float2(0.0f, 0.0f);
      m1[k] = m2[k] = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = 2 * lane + 64 * p;
        dn[k][p] = xh[k][p] = dyv[k][p] = dqv[k][p] = make_float2(0.0f, 0.0f);
        if (in && c < d) {
          const size_t o = (size_t)(r0 + k) * d + c;
          dn[k][p] = *reinterpret_cast<const float2*>(a.dn + o);
          const float2 xv = load_bf16x2(a.x + o);
          dyv[k][p] = load_bf16x2(a.dy + o);
          if (c < a.dh) dqv[k][p] = load_bf16x2(a.dq + (size_t)(r0 + k) * a.dh + c);
          xh[k][p] = make_float2((xv.x - st[k].x) * st[k].y, (xv.y - st[k].x) * st[k].y);
          const float g0 = dn[k][p].x * a.ln1_w[c], g1 = dn[k][p].y * a.ln1_w[c + 1];
          m1[k] += g0 + g1;
          m2[k] += g0 * xh[k][p].x + g1 * xh[k][p].y;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      m1[k] = warp_sum(m1[k]) / d;
      m2[k] = warp_sum(m2[k]) / d;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = r0 + k;
      if (r >= a.rows) continue;
      const float sc = a.s[r / a.n];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = 2 * lane + 64 * p;
        if (c >= d) continue;
        const float l0 = (dn[k][p].x * a.ln1_w[c] - m1[k] - xh[k][p].x * m2[k]) * st[k].y;
        const float l1 = (dn[k][p].y * a.ln1_w[c + 1] - m1[k] - xh[k][p].y * m2[k]) * st[k].y;
        if (a.dx_part)  // the rank's part, without dy
          *reinterpret_cast<float2*>(a.dx_part + (size_t)r * d + c) = make_float2(l0, l1);
        else
          store_bf16x2(a.dx + (size_t)r * d + c, dyv[k][p].x + l0, dyv[k][p].y + l1);
        sum[0][p][0] += dyv[k][p].x * sc, sum[0][p][1] += dyv[k][p].y * sc;
        sum[1][p][0] += dn[k][p].x * xh[k][p].x, sum[1][p][1] += dn[k][p].y * xh[k][p].y;
        sum[2][p][0] += dn[k][p].x, sum[2][p][1] += dn[k][p].y;
        sum[3][p][0] += dqv[k][p].x, sum[3][p][1] += dqv[k][p].y;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    if (c < d) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* w = part + ((size_t)warp * 4 + q) * d + c;
        w[0] = sum[q][p][0];
        w[1] = sum[q][p][1];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * d; i += kThreads) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += part[w * 4 * d + i];
    a.colp[(size_t)blockIdx.x * 4 * d + i] = t;
  }
}

// out[i] = the sum over s < count of slots[s * stride + i] in order, i < n.
struct SumJob {
  const float* slots;
  long long stride;
  int count, n;
  float* out;
};
struct SumJobs {
  SumJob job[6];
};

__global__ void __launch_bounds__(kSumThreads) fba_bwd_sum_kernel(SumJobs jobs) {
  const SumJob& j = jobs.job[blockIdx.y];
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= j.n) return;
  float t = 0.0f;
#pragma unroll 8
  for (int s = 0; s < j.count; ++s) t += j.slots[s * j.stride + i];
  j.out[i] = t;
}

template <int P>
cudaError_t launch_rows(bool finish, const BwdArgs& a, int col_blocks, cudaStream_t st) {
  if (!finish) {
    const int per_block = kWarps * rows_at_once(P);
    fba_bwd_prep_kernel<P><<<(a.rows + per_block - 1) / per_block, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)kWarps * 4 * a.d * sizeof(float);
  const cudaError_t err = allow_dynamic_smem((const void*)fba_bwd_rows_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  fba_bwd_rows_kernel<P><<<col_blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t row_pass(bool finish, const BwdArgs& a, int col_blocks, cudaStream_t st) {
  if (a.d <= 64) return launch_rows<1>(finish, a, col_blocks, st);
  if (a.d <= 128) return launch_rows<2>(finish, a, col_blocks, st);
  if (a.d <= 256) return launch_rows<4>(finish, a, col_blocks, st);
  return launch_rows<8>(finish, a, col_blocks, st);
}

cudaError_t launch_proj(const ProjJob& j0, const ProjJob* j1, cudaStream_t st) {
  const int tiles =
      ((j0.a.rows + kGemmTile - 1) / kGemmTile) * ((j0.ncols + kGemmTile - 1) / kGemmTile);
  fba_bwd_proj_kernel<<<dim3(tiles, j1 ? 2 : 1), kGemmThreads, kGemmSmem, st>>>(j0,
                                                                               j1 ? *j1 : j0);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. They launch on `stream` and return the
// cudaError_t of the launches (0 on success); no synchronisation.

// Forward: out [B, N, D]; stats [B, N, 2 + 2H] fp32 where not null. K and V
// [B, H, m, hd] contiguous, hd 32 or 64. The scratch, as
// ops/block_attention.py:fwd_scratch sizes it: nrm rows * D, q and attn
// rows * H hd bf16, lse B * H * N floats. `part` not null: the
// tensor-parallel mode (the module note), part [B, N, D] fp32 in place of
// out (out and bp unused); otherwise H hd = D.
extern "C" int mvlt_fba_fwd(const void* x, const void* k, const void* v, const void* ln1_w,
                            const void* ln1_b, const void* wq, const void* bq, const void* wp,
                            const void* bp, const void* s, void* out, void* stats, void* nrm,
                            void* q, void* attn, void* lse, void* part, int batch, int n, int d,
                            int heads, int m, int hd, float scale, float eps1, void* stream) {
  using namespace mvlt;
  const HalfArgs h{static_cast<const bf16*>(x),     static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v),     static_cast<const float*>(ln1_w),
                   static_cast<const float*>(ln1_b), static_cast<const bf16*>(wq),
                   static_cast<const float*>(bq),   static_cast<const bf16*>(wp),
                   static_cast<const float*>(bp),   static_cast<const float*>(s),
                   static_cast<bf16*>(out),         static_cast<float*>(stats),
                   static_cast<bf16*>(nrm),         static_cast<bf16*>(q),
                   static_cast<bf16*>(attn),        static_cast<float*>(lse),
                   batch,                           n,
                   d,                               heads,
                   m,                               scale,
                   eps1,                            hd,
                   static_cast<float*>(part)};
  return (int)attention_half_chain<FbaFwdRoute>(h, static_cast<cudaStream_t>(stream));
}

// Backward. K and V [B, H, m, hd] contiguous, hd 32 or 64; stats as the
// forward wrote them, or null for the recompute form. The scratch, as
// ops/block_attention.py:bwd_scratch sizes it: nrm and dys rows * D, attn
// and dq rows * H hd bf16, qdo 2 * rows * D bf16 (Q, then dO, each rows *
// H hd; later dLN1 in fp32), st rows float2, lse B * H * N floats, colp
// col_blocks * 4 * D floats, wslots 2 * splits * H hd * D floats when
// splits > 1; aslots and dq_acc the attention backward's
// (ops/pallas_attention.py:attention_bwd). dk, dv [B, H, m, hd] bf16; the
// parameter gradients fp32, dWq [H hd, D] and dWp [D, H hd] in torch
// layout. splits (the row ranges of the weight gradients) is trimmed so
// that none is empty. `dx_part` not null: the tensor-parallel mode (the
// module note), dx_part [B, N, D] fp32 in place of dx; otherwise H hd = D.
extern "C" int mvlt_fba_bwd(const void* x, const void* dy, const void* k, const void* v,
                            const void* ln1_w, const void* ln1_b, const void* wq,
                            const void* bq, const void* wp, const void* s, const void* stats,
                            void* dx, void* nrm, void* dys, void* qdo, void* attn, void* dq,
                            void* st, void* lse, void* colp, void* wslots, void* aslots,
                            void* dq_acc, void* dk, void* dv, void* dwq, void* dbq, void* dwp,
                            void* dbp, void* dgamma, void* dbeta, void* dx_part, int batch,
                            int n, int d, int heads, int m, int hd, int splits, int attn_splits,
                            int col_blocks, float scale, float eps1, void* stream) {
  using namespace mvlt;
  const long long rows_ll = (long long)batch * n;
  const int dh = heads * hd;
  if (batch < 1 || n < 1 || m < 1 || heads < 1 || heads > 32 || d % 16 || d > 512 ||
      (hd != 32 && hd != 64) || dh > d || (!dx_part && dh != d) || rows_ll > (1LL << 30) ||
      splits < 1 || col_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = (int)rows_ll;
  cudaError_t err = allow_dynamic_smem((const void*)fba_bwd_proj_kernel, kGemmSmem);
  if (err == cudaSuccess) err = allow_dynamic_smem((const void*)fba_bwd_wgrad_kernel, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  bf16* q = static_cast<bf16*>(qdo);
  bf16* dout = q + (size_t)rows * dh;
  const BwdArgs a{static_cast<const bf16*>(x),     static_cast<const bf16*>(dy),
                  static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                  static_cast<const float*>(s),     static_cast<const float*>(stats),
                  static_cast<bf16*>(dx),           static_cast<bf16*>(nrm),
                  static_cast<bf16*>(dys),          static_cast<bf16*>(dq),
                  static_cast<float*>(qdo),         static_cast<float2*>(st),
                  static_cast<float*>(lse),         static_cast<float*>(colp),
                  rows,                             n,
                  d,                                heads,
                  eps1,                             dh,
                  static_cast<float*>(dx_part)};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);

  // LN1(x), s.dy, (mean, rstd) (and lse from the statistics)
  err = row_pass(false, a, col_blocks, cs);
  if (err != cudaSuccess) return (int)err;
  // Q = LN1(x) Wq^T + bq, dO = (s.dy) Wp
  // Wq [dh][D] (K-major for Q, MN-major for dLN1), Wp [D][dh] (MN-major)
  const Mat wq_m{static_cast<const bf16*>(wq), d, dh, d};
  const Mat wp_m{static_cast<const bf16*>(wp), dh, d, dh};
  const ProjJob jq{Mat{a.nrm, d, rows, d}, wq_m, static_cast<const float*>(bq), q, dh, 0, 0};
  const ProjJob jdo{Mat{a.dys, d, rows, d}, wp_m, nullptr, dout, dh, 1, 0};
  err = launch_proj(jq, &jdo, cs);
  if (err != cudaSuccess) return (int)err;

  // the attention core on [B, H, N, hd] views: (batch, head, row) strides
  const long long sq[3] = {(long long)n * dh, hd, dh}, skv[3] = {(long long)heads * m * hd,
                                                              (long long)m * hd, hd};
  long long strides[18];
  for (int i = 0; i < 6; ++i)
    for (int c = 0; c < 3; ++c) strides[3 * i + c] = (i == 1 || i == 2) ? skv[c] : sq[c];
  // q, k, v, o (= A) for the forward; q, k, v, o, dO, dQ for the backward
  err = (cudaError_t)(stats ? mvlt_attention_fwd_from_lse(q, k, v, attn, lse, strides, batch,
                                                         heads, n, m, hd, scale, stream)
                            : mvlt_attention_fwd(q, k, v, attn, lse, strides, batch, heads, n,
                                                 m, hd, scale, stream));
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)mvlt_attention_bwd(q, k, v, attn, lse, dout, dq, dk, dv, aslots, dq_acc,
                                        strides, batch, heads, n, m, hd, attn_splits, scale,
                                        stream);
  if (err != cudaSuccess) return (int)err;

  // dWq [dh][D] = dQ^T LN1(x), dWp [D][dh] = (s.dy)^T A, over row ranges
  const int rchunks = (rows + kGemmChunk - 1) / kGemmChunk, per = (rchunks + splits - 1) / splits;
  splits = (rchunks + per - 1) / per;
  const long long dd = (long long)d * dh;
  float* ws = static_cast<float*>(wslots);
  const bool slots = splits > 1;
  const GemmArgs gq{Mat{a.nrm, d, rows, d}, Mat{a.dq, dh, rows, dh},
                    slots ? ws : static_cast<float*>(dwq), dd, d, dh, d, rchunks, per};
  const GemmArgs gp{Mat{static_cast<const bf16*>(attn), dh, rows, dh}, Mat{a.dys, d, rows, d},
                    slots ? ws + splits * dd : static_cast<float*>(dwp), dd, dh, d, dh, rchunks,
                    per};
  const int tiles = ((d + kGemmTile - 1) / kGemmTile) * ((dh + kGemmTile - 1) / kGemmTile);
  fba_bwd_wgrad_kernel<<<dim3(tiles, 2 * splits), kGemmThreads, kGemmSmem, cs>>>(gq, gp,
                                                                                 splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dLN1 = dQ Wq, fp32, over Q and dO (both read by now)
  const ProjJob jn{Mat{a.dq, dh, rows, dh}, wq_m, nullptr, a.dn, d, 1, 1};
  err = launch_proj(jn, nullptr, cs);
  if (err != cudaSuccess) return (int)err;
  err = row_pass(true, a, col_blocks, cs);
  if (err != cudaSuccess) return (int)err;

  SumJobs jobs{};
  int njobs = 0, longest = 1;
  auto add = [&](const float* from, long long stride, int count, int count_n, void* out) {
    jobs.job[njobs++] = SumJob{from, stride, count, count_n, static_cast<float*>(out)};
    longest = count_n > longest ? count_n : longest;
  };
  const float* cp = a.colp;
  add(cp, 4LL * d, col_blocks, d, dbp);
  add(cp + d, 4LL * d, col_blocks, d, dgamma);
  add(cp + 2 * d, 4LL * d, col_blocks, d, dbeta);
  add(cp + 3 * d, 4LL * d, col_blocks, dh, dbq);
  if (slots) {
    const int ranges = splits;  // every range of rows, in order
    add(ws, dd, ranges, (int)dd, dwq);
    add(ws + splits * dd, dd, ranges, (int)dd, dwp);
  }
  fba_bwd_sum_kernel<<<dim3((longest + kSumThreads - 1) / kSumThreads, njobs), kSumThreads, 0,
                       cs>>>(jobs);
  return (int)cudaGetLastError();
}
