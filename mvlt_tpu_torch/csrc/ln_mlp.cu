// LN -> fc1 -> GELU -> fc2 -> scaled residual of PVLT training, forward
// (the backward is ln_mlp_bwd.cu):
//   y = x + s[b] * (GELU(LN(x) W1^T + b1) W2^T + b2)
// for x [rows = B*N, D] bf16, W1 [H, D] and W2 [D, H] in torch Linear layout
// (bf16 copies of the fp32 masters), b1, b2 and the LN affine fp32, and s
// [B] fp32, the per-sample DropPath scale (mask / keep). LN(x) (two-pass
// fp32 statistics) and GELU (exact erf) are rounded to bf16 before the
// product that reads them, every sum is fp32, and y is rounded once, as
// ops/fused_mlp.py:ln_mlp_reference computes it.
//
// Replaces: mvlt_tpu/ops/fused_mlp.py:_fused_ln_mlp_impl (Pallas body
// _kernel), without its TPU layouts (no 128-lane padding, no
// two-tokens-per-row packing).
//
// What bounds it on the H100: the products, 4.rows.D.H flops (83 GFLOP at
// stage 1, B = 150: 84 us at the bf16 peak) against one read and one write
// of the stream (162 MB, 48 us); beside them the erf of every hidden value
// (324 M at stage 1), about a quarter of a millisecond of issue slots.
//
// Design, on wgmma (hopper.cuh), by the width of the stream:
//   D <= 128, one launch, the hidden never in device memory
//     (ln_mlp_fwd_fused_kernel): a block of two warpgroups owns 128 rows of
//     the flattened stream (the row scale is looked up per row, so a tile
//     may span two samples). LN(x) by one warp a row, written once into a
//     swizzled shared-memory operand; then per 64 hidden columns: fc1 =
//     LN(x) W1^T on wgmma from shared memory (W1's and W2's panels of the
//     chunk streamed through a 4-stage cp.async ring, two chunks ahead),
//     + b1 and GELU in registers, packed to bf16 A fragments (acc_to_a), and
//     fc2 += G W2^T through wgmma with A from registers into an fp32 [64, D]
//     sum per warpgroup that stays in registers over all of H (D padded to
//     64 or 128). The epilogue stages the sum in shared memory and adds b2,
//     the row's own scale and the residual in 16-byte rows.
//   D > 128, three launches (the [64, D] sum no longer fits in registers
//     beside the fc1 chunk): ln_mlp_fwd_norm_kernel writes LN(x) bf16
//     [rows, D]; ln_mlp_fwd_hidden_kernel G = GELU(LN(x) W1^T + b1) bf16
//     [rows, H] on hopper.cuh:mma_tile (128 x 128 tiles, K = D);
//     ln_mlp_fwd_out_kernel y = x + s (G W2^T + b2) on mma_tile (K = H).
//     The scratch (ops/fused_mlp.py:fwd_scratch) is the wrapper's: at stage
//     4, B = 150, 29 MB of LN(x) and 118 MB of G, written once and read once
//     (about 90 us of traffic against 0.12 ms of products at the peak).
//
// Tensor-parallel mode (the C entry's `part` set): W1 and b1 are a rank's
// [H / tp] rows and W2 its [D, H / tp] columns; the epilogue writes the
// fp32 partial s (G W2^T) (ln_mlp.cuh:store_out), which the model group
// sums before b2 and the residual are added and y is rounded once
// (parallel/tensor.py:fused_ln_mlp_tp). The same kernels, one branch in
// the epilogue.
//
// The three-launch kernels are also run by kernel D's chain (LN2, fc1 with
// GELU off, fc2 without a row scale) and kernel E's (the MLP half), under
// their route tags (ln_mlp.cuh).

#include <math.h>

#include "ln_mlp.cuh"

namespace mvlt {
namespace {

using namespace hopper;

constexpr int kFusedMaxD = 128;  // widest stream of the one-launch kernel
constexpr int kHidChunk = 64;    // hidden columns a step of the one-launch kernel
constexpr int kWRing = 4;        // its weight ring: stages, two chunks loading ahead

// LN(x) of one row by one warp: the lane's P column pairs (2 lane + 64 p,
// + 1), two-pass fp32 statistics, zeros past D. Returns (mean, 1/std).
template <int P>
__device__ __forceinline__ float2 ln_row(const bf16* xr, const LnMlpArgs& a, float2 (&v)[P]) {
  const int lane = threadIdx.x & 31, d = a.d;
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    v[p] = c < d ? load_bf16x2(xr + c) : make_float2(0.0f, 0.0f);
    sum += v[p].x + v[p].y;
  }
  const float mean = warp_sum(sum) / d;
  float var = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (2 * lane + 64 * p < d) {
      const float z0 = v[p].x - mean, z1 = v[p].y - mean;
      var += z0 * z0 + z1 * z1;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / d + a.eps);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    v[p] = c < d ? make_float2((v[p].x - mean) * rstd * a.gamma[c] + a.beta[c],
                               (v[p].y - mean) * rstd * a.gamma[c + 1] + a.beta[c + 1])
                 : make_float2(0.0f, 0.0f);
  }
  return make_float2(mean, rstd);
}

template <int DP>
__host__ __device__ constexpr size_t fused_smem() {
  // LN(x) [128][DP] | kWRing stages of (W1 chunk [64][DP] | W2 chunk [DP][64])
  return 1024 + (size_t)kGemmTile * DP * 2 + (size_t)kWRing * 2 * (DP / 64) * kGemmPanelBytes;
}

template <int DP, class Route>
__global__ void __launch_bounds__(kGemmThreads, DP == 64 ? 2 : 1) ln_mlp_fwd_fused_kernel(
    LnMlpArgs a) {
  constexpr int DC = DP / 64;  // 64-column chunks of D (and 64-row panels of W2)
  constexpr uint32_t kNrm = kGemmTile * DP * 2, kStage = 2 * DC * kGemmPanelBytes;
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const uint32_t s_nrm = smem_u32(smem), s_ring = s_nrm + kNrm;
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kGemmTile, chunks = (a.hidden + kHidChunk - 1) / kHidChunk;
  const Mat w1{a.w1, a.d, a.hidden, a.d}, w2{a.w2, a.hidden, a.d, a.hidden};
  auto load = [&](int j) {  // chunk j: W1 rows j*64.. (all of D) | W2 columns j*64.. (all of D)
    if (j < chunks) {
      const uint32_t st = s_ring + (j % kWRing) * kStage;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        load_operand<false, 64>(st + c * kGemmPanelBytes, w1, j * kHidChunk, c * 64);
      load_operand<false, DP>(st + DC * kGemmPanelBytes, w2, 0, j * kHidChunk);
    }
    cp_async_commit();
  };
  load(0);
  load(1);

  // LN(x) into the swizzled operand, chunk c of columns 64c .. 64c + 63 a
  // [128][128 B] tile; rows past the end zero
  for (int r = warp; r < kGemmTile; r += kGemmThreads / 32) {
    float2 v[DC];
    if (m0 + r < a.rows) {
      ln_row<DC>(a.x + (size_t)(m0 + r) * a.d, a, v);
    } else {
#pragma unroll
      for (int p = 0; p < DC; ++p) v[p] = make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int p = 0; p < DC; ++p)
      *reinterpret_cast<uint32_t*>(smem + p * kGemmOperandBytes + tile_off<128>(r, lane >> 2) +
                                   (lane & 3) * 4) = pack_bf16(v[p].x, v[p].y);
  }

  float acc[DP / 2];  // fc2: the warpgroup's 64 rows by DP columns, over all of H
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  const uint32_t a_rows = s_nrm + wg * kGemmPanelBytes;  // the warpgroup's 64 rows of LN(x)
  const int cq = tile_col();
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kWRing - 3>();
    fence_proxy_async();
    __syncthreads();  // chunk j is in (and LN(x)); chunk j - 2's fc2 is done in both warpgroups
    load(j + 2);      // into chunk j - 2's stage
    const uint32_t st = s_ring + (j % kWRing) * kStage;
    float h[32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(h, make_desc<128>(a_rows + c * kGemmOperandBytes + kk * 32),
                       make_desc<128>(st + c * kGemmPanelBytes + kk * 32), c | kk);
    wgmma_commit();
    wgmma_wait<0>();  // fc1 of this chunk, and the last chunk's fc2
    fence_regs(h);
    // + b1, GELU, bf16 A fragments; columns past H have zero weights and
    // no bias, so their GELU(0) = 0 adds nothing
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kHidChunk + 8 * jj + cq + (e & 1);
        h[4 * jj + e] = gelu_erf(h[4 * jj + e] + (col < a.hidden ? a.b1[col] : 0.0f));
      }
    }
    uint32_t ga[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(h, kk, ga[kk]);
      fence_regs(ga[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<0>(acc, ga[kk], make_desc<128>(st + DC * kGemmPanelBytes + kk * 32), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the sums through shared memory (the ring), then b2, the row's scale and
  // the residual in 16-byte rows
  constexpr int LD = DP + 4;
  float* stage = reinterpret_cast<float*>(smem + kNrm);
  __syncthreads();
  const int r = tile_row();
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(stage + (r + 8 * hh) * LD + 8 * jj + cq) =
          make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  }
  __syncthreads();
  for (int i = tid; i < kGemmTile * DP / 8; i += kGemmThreads) {
    const int rr = i / (DP / 8), c = (i % (DP / 8)) * 8;
    if (m0 + rr >= a.rows || c >= a.d) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = stage[rr * LD + c + e];
    store_out<Route>(a, m0 + rr, c, v);
  }
}

// LN(x) bf16 [rows, D], one warp a row (the three-launch form); each row's
// (mean, 1/std) too where a.stats is not null.
template <int P, class Route>
__global__ void __launch_bounds__(kThreads) ln_mlp_fwd_norm_kernel(LnMlpArgs a) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= a.rows) return;
  float2 v[P];
  const float2 st = ln_row<P>(a.x + (size_t)r * a.d, a, v);
  if (a.stats && lane == 0) *reinterpret_cast<float2*>(a.stats + (size_t)r * a.stats_ld) = st;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    if (c < a.d)
      *reinterpret_cast<uint32_t*>(a.nrm + (size_t)r * a.d + c) = pack_bf16(v[p].x, v[p].y);
  }
}

// G = GELU(LN(x) W1^T + b1) (without the GELU where !Gelu), a 128 x 128
// tile a block, row tile major.
template <bool Gelu, class Route>
__global__ void __launch_bounds__(kGemmThreads, 1) ln_mlp_fwd_hidden_kernel(LnMlpArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int htiles = (a.hidden + kGemmTile - 1) / kGemmTile;
  const int m0 = (blockIdx.x / htiles) * kGemmTile, n0 = (blockIdx.x % htiles) * kGemmTile;
  float d[64];
  mma_tile<false, false>(Mat{a.nrm, a.d, a.rows, a.d}, Mat{a.w1, a.d, a.hidden, a.d}, m0, n0,
                         0, (a.d + kGemmChunk - 1) / kGemmChunk, smem_u32(smem), d);
  store_tile(d, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    if (m0 + r >= a.rows || n0 + c >= a.hidden) return;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] += a.b1[n0 + c + e];
      if (Gelu) v[e] = gelu_erf(v[e]);
    }
    *reinterpret_cast<uint4*>(a.g + (size_t)(m0 + r) * a.hidden + n0 + c) = pack_bf16x8(v);
  });
}

// y = x + s (G W2^T + b2), a 128 x 128 tile a block, row tile major (G the
// attention output and W2 the out-projection in the attention-half chain).
template <class Route>
__global__ void __launch_bounds__(kGemmThreads, 1) ln_mlp_fwd_out_kernel(LnMlpArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int dtiles = (a.d + kGemmTile - 1) / kGemmTile;
  const int m0 = (blockIdx.x / dtiles) * kGemmTile, n0 = (blockIdx.x % dtiles) * kGemmTile;
  float d[64];
  mma_tile<false, false>(Mat{a.g, a.hidden, a.rows, a.hidden},
                         Mat{a.w2, a.hidden, a.d, a.hidden}, m0, n0, 0,
                         (a.hidden + kGemmChunk - 1) / kGemmChunk, smem_u32(smem), d);
  store_tile(d, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    if (m0 + r < a.rows && n0 + c < a.d) store_out<Route>(a, m0 + r, n0 + c, v);
  });
}

template <int DP, class Route>
cudaError_t launch_fused(const LnMlpArgs& a, cudaStream_t st) {
  const cudaError_t err =
      allow_dynamic_smem((const void*)ln_mlp_fwd_fused_kernel<DP, Route>, fused_smem<DP>());
  if (err != cudaSuccess) return err;
  ln_mlp_fwd_fused_kernel<DP, Route>
      <<<(a.rows + kGemmTile - 1) / kGemmTile, kGemmThreads, fused_smem<DP>(), st>>>(a);
  return cudaGetLastError();
}

template <int P, class Route>
cudaError_t launch_norm(const LnMlpArgs& a, cudaStream_t st) {
  ln_mlp_fwd_norm_kernel<P, Route><<<(a.rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

int row_tiles(const LnMlpArgs& a) { return (a.rows + kGemmTile - 1) / kGemmTile; }

}  // namespace

template <class Route>
cudaError_t ln_mlp_fwd_norm(const LnMlpArgs& a, cudaStream_t st) {
  return a.d <= 64    ? launch_norm<1, Route>(a, st)
         : a.d <= 128 ? launch_norm<2, Route>(a, st)
         : a.d <= 256 ? launch_norm<4, Route>(a, st)
                      : launch_norm<8, Route>(a, st);
}

template <class Route, bool Gelu>
cudaError_t ln_mlp_fwd_hidden(const LnMlpArgs& a, cudaStream_t st) {
  const cudaError_t err =
      allow_dynamic_smem((const void*)ln_mlp_fwd_hidden_kernel<Gelu, Route>, kGemmSmem);
  if (err != cudaSuccess) return err;
  ln_mlp_fwd_hidden_kernel<Gelu, Route>
      <<<row_tiles(a) * ((a.hidden + kGemmTile - 1) / kGemmTile), kGemmThreads,
         gemm_smem((a.d + kGemmChunk - 1) / kGemmChunk), st>>>(a);
  return cudaGetLastError();
}

template <class Route>
cudaError_t ln_mlp_fwd_out(const LnMlpArgs& a, cudaStream_t st) {
  const cudaError_t err = allow_dynamic_smem((const void*)ln_mlp_fwd_out_kernel<Route>, kGemmSmem);
  if (err != cudaSuccess) return err;
  ln_mlp_fwd_out_kernel<Route>
      <<<row_tiles(a) * ((a.d + kGemmTile - 1) / kGemmTile), kGemmThreads,
         gemm_smem((a.hidden + kGemmChunk - 1) / kGemmChunk), st>>>(a);
  return cudaGetLastError();
}

// kernel D's chain (dwconv_mlp.cu) runs these three, kernel E's
// (swin_block.cu) and kernel A's (sr_kv.cu) the norm for their LN1, and the
// attention-half chain (attn_chain.cuh) all three for kernels B and C and
// the fused attention forward
template cudaError_t ln_mlp_fwd_norm<DwConvRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_norm<SwinBlockRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_hidden<DwConvRoute, false>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_out<DwConvRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_norm<FbaFwdRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_hidden<FbaFwdRoute, false>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_out<FbaFwdRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_norm<BlockFusedRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_hidden<BlockFusedRoute, false>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_out<BlockFusedRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_norm<BlockAttentionRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_hidden<BlockAttentionRoute, false>(const LnMlpArgs&,
                                                                   cudaStream_t);
template cudaError_t ln_mlp_fwd_out<BlockAttentionRoute>(const LnMlpArgs&, cudaStream_t);
template cudaError_t ln_mlp_fwd_norm<SrKvRoute>(const LnMlpArgs&, cudaStream_t);

namespace {

// The whole forward on one route: one launch (fused, D <= 128) or three.
template <class Route>
cudaError_t ln_mlp_fwd(const LnMlpArgs& a, bool fused, cudaStream_t st) {
  if (fused) return a.d <= 64 ? launch_fused<64, Route>(a, st) : launch_fused<128, Route>(a, st);
  cudaError_t err = ln_mlp_fwd_norm<Route>(a, st);
  if (err == cudaSuccess) err = ln_mlp_fwd_hidden<Route, true>(a, st);
  if (err == cudaSuccess) err = ln_mlp_fwd_out<Route>(a, st);
  return err;
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. It launches on `stream` and returns the
// cudaError_t of the launches (0 on success); no synchronisation. D a
// multiple of 16 and at most 512, H a multiple of 16. `fused` (D <= 128
// only) picks the one-launch kernel; otherwise nrm (rows * D) and g (rows *
// H) bf16 are the three-launch form's scratch. `route` 0 runs #12 itself,
// 1 kernel E's MLP half (SwinBlockRoute), 2 kernel B's (BlockFusedRoute);
// 1 and 2 take no row scale (s unused). With `part` (fp32 [rows, D]) not
// null, route 0 only, the tensor-parallel mode: the partial in `part` in
// place of y (out and b2 unused; ln_mlp.cuh).
extern "C" int mvlt_ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* s, void* out, void* nrm, void* g, long long rows, int n,
                               int d, int hidden, int fused, int route, float eps, void* part,
                               void* stream) {
  using namespace mvlt;
  if (rows < 1 || rows > (1LL << 30) || n < 1 || d < 16 || d > 512 || d % 16 || hidden < 16 ||
      hidden % 16 || (fused && d > kFusedMaxD) || route < 0 || route > 2 || (part && route))
    return (int)cudaErrorInvalidValue;
  LnMlpArgs a{static_cast<const bf16*>(x),     static_cast<const float*>(gamma),
              static_cast<const float*>(beta), static_cast<const bf16*>(w1),
              static_cast<const float*>(b1),   static_cast<const bf16*>(w2),
              static_cast<const float*>(b2),   static_cast<const float*>(s),
              static_cast<bf16*>(out),         static_cast<bf16*>(nrm),
              static_cast<bf16*>(g),           (int)rows,
              n,                               d,
              hidden,                          eps};
  a.part = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(route == 0   ? ln_mlp_fwd<LnMlpRoute>(a, fused, st)
               : route == 1 ? ln_mlp_fwd<SwinBlockRoute>(a, fused, st)
                            : ln_mlp_fwd<BlockFusedRoute>(a, fused, st));
}

