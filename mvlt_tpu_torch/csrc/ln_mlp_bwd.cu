// Backward of LN -> fc1 -> GELU -> fc2 -> scaled residual of PVLT training
// (the forward is ln_mlp.cu):
//   y = x + s[b] * (GELU(LN(x) W1^T + b1) W2^T + b2)
// for x and its gradient dy [rows = B*N, D] bf16, W1 [H, D] and W2 [D, H] in
// torch Linear layout (bf16 copies of the fp32 masters), b1 and the LN affine
// fp32, and s [B] fp32, the per-sample DropPath scale. With the hidden
// recomputed, per row: n = LN(x); h1 = n W1^T + b1; G = GELU(h1) in bf16;
// dys = s dy; dh1 = (dys W2) GELU'(h1); dn = dh1 W1; dx = dy +
// LN-backward(dn gamma); over all rows dW2 = dys^T G, dW1 = dh1^T n, db1 =
// sum dh1, db2 = sum dys, dgamma = sum dn nhat, dbeta = sum dn. Every
// product's operands are bf16 and every sum fp32 (db1 and db2 before any
// rounding), as ops/fused_mlp.py:ln_mlp_bwd_reference computes; a row with s
// = 0 passes dy through to dx.
//
// Replaces: mvlt_tpu/ops/fused_mlp.py:_fused_ln_mlp_bwd (Pallas body
// _mlp_bwd_kernel), without its TPU layouts (no 128-lane padding, no
// two-tokens-per-row packing).
//
// What bounds it on the H100: 10.rows.D.H flops (the hidden recomputed, dG,
// dW2, dW1, dn): 208-302 GFLOP at the pvlt_tiny stages at B = 150, 0.21-0.31
// ms at the bf16 peak. The hidden is 4-8x wider than the stream, so where it
// goes through device memory its bf16 copies (G and dh1: 1.3 GB at stage 1)
// cost more than the products at D <= 128.
//
// Design. The TPU kernel walks row tiles in order and carries the weight
// gradients across its sequential grid; here the backward is six plain
// launches, each with every fp32 sum in registers over its whole
// contraction, and every cross-block sum in a fixed order (two calls are
// bit-equal, no atomics):
//   ln_mlp_bwd_prep_kernel    a warp takes 8 / P rows of P column pairs a
//       lane at once (D <= 64 P): LN statistics (two-pass), n and dys in
//       bf16 [rows, D], (mean, rstd) [rows];
//   ln_mlp_bwd_hidden_kernel  a 128-row by 64-hidden tile a block, two
//       warpgroups, two blocks an SM: h1 = n W1^T (n, W1 K-major) and dG =
//       dys W2 (W2 read MN-major) on wgmma, K = D, both products over one
//       double-buffered cp.async ring whose stages hold a chunk of all four
//       operands; then in registers G = GELU(h1 + b1) and dh1 = dG
//       GELU'(h1 + b1) (one erf for both); G and dh1 out in bf16 [rows, H]
//       through a shared-memory stage, dh1's fp32 column sums to a [row
//       tiles, H] slot of db1 partials;
//   ln_mlp_bwd_wgrad_kernel   dW1 = n^T dh1 and dW2 = G^T dys, long-K GEMMs
//       over the rows (hopper.cuh:gemm_tn_block, both operands MN-major),
//       split into ranges of rows (ops/fused_mlp.py:bwd_plan, blocks filling
//       whole waves) whose fp32 slots the sum launch adds in order; dW2
//       written in torch's [D, H];
//   ln_mlp_bwd_dnorm_kernel   dn = dh1 W1 (K = H, W1 MN-major) in fp32
//       [rows, D], in the space of G once the weight gradients have read it;
//   ln_mlp_bwd_rows_kernel    rows as the prep kernel takes them: dx = dy +
//       (dn gamma - m1 - nhat m2) rstd, and per block of 128 rows the fp32
//       column sums of s dy (db2), dn nhat (dgamma) and dn (dbeta) into a
//       slot;
//   ln_mlp_bwd_sum_kernel     every slot set summed in order: a lane a
//       column, the slots dealt over the block's warps, the warps' sums
//       added in warp order.
// The scratch (ops/fused_mlp.py:bwd_scratch) is the wrapper's, through the
// caching allocator: 1.48 GB at stage 1, B = 150.
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, pvlt_tiny's stages
// at B = 150): 2.82 / 1.81 / 1.56 / 1.68 ms by CUDA events at stages 1-4,
// 2.69 / 1.47 / 1.32 / 1.31 ms of device time, against 12.2 / 9.7 / 10.7 /
// 16.6 for the wmma kernel it replaces (one block an SM walking row tiles,
// fp32 weight-gradient slots loaded and stored whole on every tile, 32-row
// tiles at D = 512). At stage 1 the hidden kernel takes 1.17 ms of the 2.7
// (G and dh1 written, 1.3 GB, and the erf GELU), the weight gradients 0.66
// (half their MMA work on D = 64 padded to the 128 tile); at stage 4 the
// products run at 210-270 TFLOP/s. Measured and dropped: a 128 x 128
// hidden tile (two 64-float accumulators, one block an SM) was 1.31-1.50 ms
// at stage 1; a branch in mma_tile that skipped the padded half made every
// product 10-30% slower.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mvlt {
namespace {

using namespace hopper;

constexpr int kColRows = 128;  // rows a block of ln_mlp_bwd_rows_kernel sums over
constexpr int kMaxPairs = 8;   // column pairs a lane holds in a row kernel: D <= 512
constexpr int kSumWarps = 32;  // warps of a block of ln_mlp_bwd_sum_kernel
constexpr int kMaxJobs = 6;
// The hidden kernel: 128 rows by kHidTile hidden columns a block, two
// blocks an SM; its ring's two stages each hold a chunk of all four
// operands (n and dys 128 rows, W1 and W2 64).
constexpr int kHidTile = 64;
constexpr uint32_t kHidStage = 2 * kGemmOperandBytes + 2 * kGemmPanelBytes;  // 48 KB
constexpr size_t kHidSmem = 1024 + 2 * (size_t)kHidStage;
constexpr int kHidLd = kHidTile + 8;  // bf16 row of the hidden kernel's output stage

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const float* gamma;
  const float* beta;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* s;
  bf16* dx;
  bf16* nhat;      // [rows, D] LN(x), bf16
  bf16* dys;       // [rows, D] s.dy, bf16
  float2* stats;   // [rows] (mean, rstd)
  bf16* g;         // [rows, H] GELU(h1), bf16
  bf16* dh;        // [rows, H] dh1, bf16
  float* dn;       // [rows, D] dn, fp32
  float* db1p;     // [row tiles, H] column sums of dh1
  float* colp;     // [row blocks, 3, D] column sums of s.dy, dn.nhat, dn
  int rows, n, d, hidden;
  float eps;
};



template <int P>
__global__ void __launch_bounds__(kThreads) ln_mlp_bwd_prep_kernel(BwdArgs a) {
  constexpr int R = rows_at_once(P);
  const int lane = threadIdx.x & 31, d = a.d;
  const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  float2 xv[R][P], dv[R][P];
  float sum[R], var[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    sum[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      xv[k][p] = dv[k][p] = make_float2(0.0f, 0.0f);
      if (r0 + k < a.rows && c < d) {
        xv[k][p] = load_bf16x2(a.x + (size_t)(r0 + k) * d + c);
        dv[k][p] = load_bf16x2(a.dy + (size_t)(r0 + k) * d + c);
      }
      sum[k] += xv[k][p].x + xv[k][p].y;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {  // two-pass statistics: the mean, then the centred variance
    sum[k] = warp_sum(sum[k]) / d;
    var[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (2 * lane + 64 * p < d) {
        const float z0 = xv[k][p].x - sum[k], z1 = xv[k][p].y - sum[k];
        var[k] += z0 * z0 + z1 * z1;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = r0 + k;
    const float rstd = rsqrtf(warp_sum(var[k]) / d + a.eps);
    if (r >= a.rows) continue;
    const float sc = a.s[r / a.n];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c < d) {
        const size_t o = (size_t)r * d + c;
        store_bf16x2(a.nhat + o, (xv[k][p].x - sum[k]) * rstd * a.gamma[c] + a.beta[c],
                     (xv[k][p].y - sum[k]) * rstd * a.gamma[c + 1] + a.beta[c + 1]);
        store_bf16x2(a.dys + o, dv[k][p].x * sc, dv[k][p].y * sc);
      }
    }
    if (lane == 0) a.stats[r] = make_float2(sum[k], rstd);
  }
}

// d1 = the 128 x 64 tile of n W1^T and d2 = that of dys W2 (n, W1 and dys
// K-major, W2 MN-major), both products over one double-buffered ring: the
// next chunk loads while this one multiplies.
__device__ __forceinline__ void hidden_products(const Mat& n, const Mat& w1, const Mat& dys,
                                                const Mat& w2, int m0, int n0, int chunks,
                                                uint32_t ring, float (&d1)[32], float (&d2)[32]) {
  constexpr uint32_t kRows = kGemmOperandBytes, kPanel = kGemmPanelBytes;
  const uint32_t rows = (threadIdx.x >> 7) * kPanel;  // the warpgroup's 64 rows of n and dys
#pragma unroll
  for (int i = 0; i < 32; ++i) d1[i] = d2[i] = 0.0f;
  auto load = [&](int i) {  // chunk i into stage i % 2: n | W1 | dys | W2
    if (i < chunks) {
      const uint32_t st = ring + (i & 1) * kHidStage;
      load_operand<false>(st, n, m0, i * kGemmChunk);
      load_operand<false, 64>(st + kRows, w1, n0, i * kGemmChunk);
      load_operand<false>(st + kRows + kPanel, dys, m0, i * kGemmChunk);
      load_operand<true, 64>(st + 2 * kRows + kPanel, w2, n0, i * kGemmChunk);
    }
    cp_async_commit();
  };
  load(0);
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // chunk i is in; both warpgroups' products of chunk i - 1 are done
    load(i + 1);      // into chunk i - 1's stage
    const uint32_t st = ring + (i & 1) * kHidStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmChunk / 16; ++kk) {
      wgmma_ss<0, 0>(d1, make_desc<128>(st + rows + kk * 32),
                     make_desc<128>(st + kRows + kk * 32), 1);
      wgmma_ss<0, 1>(d2, make_desc<128>(st + kRows + kPanel + rows + kk * 32),
                     make_desc<128>(st + 2 * kRows + kPanel + kk * 16 * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(d1);
  fence_regs(d2);
}

__global__ void __launch_bounds__(kGemmThreads, 2) ln_mlp_bwd_hidden_kernel(BwdArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, H = a.hidden;
  const int htiles = (H + kHidTile - 1) / kHidTile;
  const int m0 = (blockIdx.x / htiles) * kGemmTile, n0 = (blockIdx.x % htiles) * kHidTile;
  const int chunks = (a.d + kGemmChunk - 1) / kGemmChunk;
  float h1[32], dg[32];
  hidden_products(Mat{a.nhat, a.d, a.rows, a.d}, Mat{a.w1, a.d, H, a.d},
                  Mat{a.dys, a.d, a.rows, a.d}, Mat{a.w2, H, a.d, H}, m0, n0, chunks,
                  smem_u32(smem), h1, dg);

  // in registers: h1 -> G, dG -> dh1. Rows past the end have n = dys = 0, so
  // their dh1 is exactly 0; columns past H have zero weights and no b1.
  const int rl = tile_row(), cq = tile_col();
#pragma unroll
  for (int j = 0; j < kHidTile / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + 8 * j + cq + c;
      const float bias = col < H ? a.b1[col] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + c;
        const float2 gg = gelu_erf_and_grad(h1[i] + bias);
        h1[i] = gg.x;
        dg[i] = dg[i] * gg.y;
      }
    }
  }

  __syncthreads();  // both warpgroups are done with the ring: it becomes the stage
  bf16* sg = reinterpret_cast<bf16*>(smem);
  bf16* sd = sg + kGemmTile * kHidLd;
  float* red = reinterpret_cast<float*>(sd + kGemmTile * kHidLd);  // [8 warps][kHidTile]
#pragma unroll
  for (int j = 0; j < kHidTile / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (rl + 8 * h) * kHidLd + 8 * j + cq;
      *reinterpret_cast<uint32_t*>(sg + at) = pack_bf16(h1[4 * j + 2 * h], h1[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(sd + at) = pack_bf16(dg[4 * j + 2 * h], dg[4 * j + 2 * h + 1]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // the column's fp32 sum over the warp's 16 rows
      float s = dg[4 * j + c] + dg[4 * j + 2 + c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[(tid >> 5) * kHidTile + 8 * j + cq + c] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < kGemmTile * kHidTile / 8; i += kGemmThreads) {
    const int r = i / (kHidTile / 8), c = (i % (kHidTile / 8)) * 8;
    if (m0 + r < a.rows && n0 + c < H) {
      const size_t o = (size_t)(m0 + r) * H + n0 + c;
      *reinterpret_cast<uint4*>(a.g + o) = *reinterpret_cast<const uint4*>(sg + r * kHidLd + c);
      *reinterpret_cast<uint4*>(a.dh + o) = *reinterpret_cast<const uint4*>(sd + r * kHidLd + c);
    }
  }
  if (tid < kHidTile && n0 + tid < H) {
    float s = 0.0f;
    for (int w = 0; w < kGemmThreads / 32; ++w) s += red[w * kHidTile + tid];
    a.db1p[(size_t)(m0 / kGemmTile) * H + n0 + tid] = s;
  }
}

// Blocks [0, tiles) x splits for dW1, the same again for dW2 (blockIdx.y).
__global__ void __launch_bounds__(kGemmThreads, 1) ln_mlp_bwd_wgrad_kernel(
    const __grid_constant__ GemmArgs dw1, const __grid_constant__ GemmArgs dw2, int splits) {
  extern __shared__ char smem_raw[];
  gemm_tn_pair(dw1, dw2, splits, smem_raw);
}

__global__ void __launch_bounds__(kGemmThreads, 1) ln_mlp_bwd_dnorm_kernel(BwdArgs a) {
  extern __shared__ char smem_raw[];
  const int d = a.d, dtiles = (d + kGemmTile - 1) / kGemmTile;
  const int m0 = (blockIdx.x / dtiles) * kGemmTile, n0 = (blockIdx.x % dtiles) * kGemmTile;
  float acc[64];
  mma_tile<false, true>(Mat{a.dh, a.hidden, a.rows, a.hidden}, Mat{a.w1, d, a.hidden, d}, m0,
                        n0, 0, (a.hidden + kGemmChunk - 1) / kGemmChunk,
                        smem_u32(align1024(smem_raw)), acc);
  const int rl = m0 + tile_row(), cq = tile_col();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, c = n0 + 8 * j + cq;
      if (r < a.rows && c < d)
        *reinterpret_cast<float2*>(a.dn + (size_t)r * d + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Dynamic shared memory: kWarps * 3 * D floats.
template <int P>
__global__ void __launch_bounds__(kThreads) ln_mlp_bwd_rows_kernel(BwdArgs a) {
  constexpr int R = rows_at_once(P);
  extern __shared__ float part[];  // [warp][3][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = a.d;
  float sb2[P][2], sg[P][2], sbe[P][2];  // the lane's column sums
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e) sb2[p][e] = sg[p][e] = sbe[p][e] = 0.0f;
  for (int rr = warp * R; rr < kColRows; rr += kWarps * R) {
    const int r0 = blockIdx.x * kColRows + rr;
    float2 dn[R][P], xh[R][P], dyv[R][P];
    float m1[R], m2[R];
    float2 st[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool in = r0 + k < a.rows;
      st[k] = in ? a.stats[r0 + k] : make_float2(0.0f, 0.0f);
      m1[k] = m2[k] = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = 2 * lane + 64 * p;
        dn[k][p] = xh[k][p] = dyv[k][p] = make_float2(0.0f, 0.0f);
        if (in && c < d) {
          const size_t o = (size_t)(r0 + k) * d + c;
          dn[k][p] = *reinterpret_cast<const float2*>(a.dn + o);
          const float2 xv = load_bf16x2(a.x + o);
          dyv[k][p] = load_bf16x2(a.dy + o);
          xh[k][p] = make_float2((xv.x - st[k].x) * st[k].y, (xv.y - st[k].x) * st[k].y);
          const float g0 = dn[k][p].x * a.gamma[c], g1 = dn[k][p].y * a.gamma[c + 1];
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
        if (c < d) {
          const float v0 = dyv[k][p].x + (dn[k][p].x * a.gamma[c] - m1[k] - xh[k][p].x * m2[k]) *
                                             st[k].y;
          const float v1 = dyv[k][p].y +
                           (dn[k][p].y * a.gamma[c + 1] - m1[k] - xh[k][p].y * m2[k]) * st[k].y;
          store_bf16x2(a.dx + (size_t)r * d + c, v0, v1);
          sb2[p][0] += dyv[k][p].x * sc, sb2[p][1] += dyv[k][p].y * sc;
          sg[p][0] += dn[k][p].x * xh[k][p].x, sg[p][1] += dn[k][p].y * xh[k][p].y;
          sbe[p][0] += dn[k][p].x, sbe[p][1] += dn[k][p].y;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    if (c < d) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* w = part + (size_t)warp * 3 * d + c + e;
        w[0] = sb2[p][e];
        w[d] = sg[p][e];
        w[2 * d] = sbe[p][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * d; i += kThreads) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += part[w * 3 * d + i];
    a.colp[(size_t)blockIdx.x * 3 * d + i] = t;
  }
}

// out[i] = the sum over s < count of slots[s * stride + i], i < n; `warps`
// warps share each 32 outputs (1, or kSumWarps for a long count).
struct SumJob {
  const float* slots;
  long long stride;
  int count, n, warps;
  float* out;
};
struct SumJobs {
  SumJob job[kMaxJobs];
};

__host__ __device__ inline int sum_job_outputs(const SumJob& j) {  // outputs a block takes
  return 32 * (kSumWarps / j.warps);
}

// Job blockIdx.y: a lane an output; the warps sharing an output add slots
// w, w + warps, ... in order, then their sums are added in warp order -- a
// fixed order for every output.
__global__ void __launch_bounds__(kSumWarps * 32) ln_mlp_bwd_sum_kernel(SumJobs jobs) {
  __shared__ float part[kSumWarps][32];
  const SumJob& jb = jobs.job[blockIdx.y];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpo = jb.warps;
  const long long i0 = (long long)blockIdx.x * sum_job_outputs(jb);
  if (i0 >= jb.n) return;  // the whole block: this job is shorter
  const long long i = i0 + (warp / wpo) * 32 + lane;
  float s = 0.0f;
  if (i < jb.n)
    for (int k = warp % wpo; k < jb.count; k += wpo) s += jb.slots[k * jb.stride + i];
  if (wpo == 1) {
    if (i < jb.n) jb.out[i] = s;
    return;
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < jb.n) {
    float t = 0.0f;
    for (int w = 0; w < kSumWarps; ++w) t += part[w][lane];
    jb.out[i] = t;
  }
}

// The prep (Rows false) or the finishing row kernel for a lane's P column
// pairs of a D-wide row.
template <int P>
cudaError_t launch_rows(bool rows_kernel, const BwdArgs& a, cudaStream_t st) {
  if (!rows_kernel) {
    const int per_block = kWarps * rows_at_once(P);
    ln_mlp_bwd_prep_kernel<P><<<(a.rows + per_block - 1) / per_block, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)kWarps * 3 * a.d * sizeof(float);
  const cudaError_t err = allow_dynamic_smem((const void*)ln_mlp_bwd_rows_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  ln_mlp_bwd_rows_kernel<P><<<(a.rows + kColRows - 1) / kColRows, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t row_pass(bool rows_kernel, const BwdArgs& a, cudaStream_t st) {
  if (a.d <= 64) return launch_rows<1>(rows_kernel, a, st);
  if (a.d <= 128) return launch_rows<2>(rows_kernel, a, st);
  if (a.d <= 256) return launch_rows<4>(rows_kernel, a, st);
  return launch_rows<8>(rows_kernel, a, st);
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. It launches on `stream` and returns the
// cudaError_t of the launches (0 on success); no synchronisation. D a
// multiple of 16 and at most 512, H a multiple of 16. The scratch, as
// ops/fused_mlp.py:bwd_scratch sizes it: nhat and dys rows * D bf16; stats
// rows float2; g and dh rows * H bf16; dn rows * D floats (it may be g's
// space); db1p ceil(rows / 128) * H floats; colp ceil(rows / 128) * 3 * D
// floats; wslots 2 * splits * H * D floats when splits > 1 (else unused).
// splits (the row ranges of the weight gradients) is trimmed so that none
// is empty.
extern "C" int mvlt_ln_mlp_bwd(const void* x, const void* dy, const void* gamma,
                               const void* beta, const void* w1, const void* b1,
                               const void* w2, const void* s, void* dx, void* nhat, void* dys,
                               void* stats, void* g, void* dh, void* dn, void* db1p, void* colp,
                               void* wslots, void* dw1, void* dw2, void* db1, void* db2,
                               void* dgamma, void* dbeta, long long rows, int n, int d,
                               int hidden, int splits, float eps, void* stream) {
  using namespace mvlt;
  if (rows < 1 || rows > (1LL << 30) || n < 1 || d < 16 || d > 2 * 32 * kMaxPairs || d % 16 ||
      hidden < 16 || hidden % 16 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int nr = (int)rows;
  cudaError_t err = allow_dynamic_smem((const void*)ln_mlp_bwd_hidden_kernel, kHidSmem);
  if (err == cudaSuccess) err = allow_dynamic_smem((const void*)ln_mlp_bwd_wgrad_kernel, kGemmSmem);
  if (err == cudaSuccess) err = allow_dynamic_smem((const void*)ln_mlp_bwd_dnorm_kernel, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const BwdArgs a{static_cast<const bf16*>(x),     static_cast<const bf16*>(dy),
                  static_cast<const float*>(gamma), static_cast<const float*>(beta),
                  static_cast<const bf16*>(w1),    static_cast<const float*>(b1),
                  static_cast<const bf16*>(w2),    static_cast<const float*>(s),
                  static_cast<bf16*>(dx),          static_cast<bf16*>(nhat),
                  static_cast<bf16*>(dys),         static_cast<float2*>(stats),
                  static_cast<bf16*>(g),           static_cast<bf16*>(dh),
                  static_cast<float*>(dn),         static_cast<float*>(db1p),
                  static_cast<float*>(colp),       nr, n, d, hidden, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (nr + kGemmTile - 1) / kGemmTile;
  const int htiles = (hidden + kGemmTile - 1) / kGemmTile;
  const int dtiles = (d + kGemmTile - 1) / kGemmTile;
  const int hid_tiles = (hidden + kHidTile - 1) / kHidTile;

  err = row_pass(false, a, st);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_bwd_hidden_kernel<<<row_tiles * hid_tiles, kGemmThreads, kHidSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dW1 [H][D] = n^T dh1 (m = D, n = H); dW2 [D][H] = G^T dys (m = H, n = D)
  const int rchunks = (nr + kGemmChunk - 1) / kGemmChunk, per = (rchunks + splits - 1) / splits;
  splits = (rchunks + per - 1) / per;
  const long long hd = (long long)hidden * d;
  float* ws = static_cast<float*>(wslots);
  const bool slots = splits > 1;
  const GemmArgs gw1{Mat{a.nhat, d, nr, d}, Mat{a.dh, hidden, nr, hidden},
                     slots ? ws : static_cast<float*>(dw1), hd, d, hidden, d, rchunks, per};
  const GemmArgs gw2{Mat{a.g, hidden, nr, hidden}, Mat{a.dys, d, nr, d},
                     slots ? ws + splits * hd : static_cast<float*>(dw2), hd, hidden, d, hidden,
                     rchunks, per};
  ln_mlp_bwd_wgrad_kernel<<<dim3(htiles * dtiles, 2 * splits), kGemmThreads, kGemmSmem, st>>>(
      gw1, gw2, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_mlp_bwd_dnorm_kernel<<<row_tiles * dtiles, kGemmThreads, kGemmSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = row_pass(true, a, st);
  if (err != cudaSuccess) return (int)err;
  const int col_blocks = (nr + kColRows - 1) / kColRows;

  SumJobs jobs{};
  int njobs = 0, blocks = 1;
  auto add = [&](const float* slots, long long stride, int count, int n, void* out) {
    const SumJob j{slots, stride, count, n, count >= 64 ? kSumWarps : 1, static_cast<float*>(out)};
    jobs.job[njobs++] = j;
    const int b = (n + sum_job_outputs(j) - 1) / sum_job_outputs(j);
    blocks = b > blocks ? b : blocks;
  };
  add(a.db1p, hidden, row_tiles, hidden, db1);
  add(a.colp, 3LL * d, col_blocks, d, db2);
  add(a.colp + d, 3LL * d, col_blocks, d, dgamma);
  add(a.colp + 2 * d, 3LL * d, col_blocks, d, dbeta);
  if (slots) {
    const int ranges = splits;  // every range of rows, in order
    add(ws, hd, ranges, (int)hd, dw1);
    add(ws + splits * hd, hd, ranges, (int)hd, dw2);
  }
  ln_mlp_bwd_sum_kernel<<<dim3(blocks, njobs), kSumWarps * 32, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}
