// Whole Swin block on the visual stream (kernel E), a chain of launches on
// wgmma (hopper.cuh) over bf16 scratch in device memory.
//
// Replaces: mvlt_tpu/ops/swin_band.py:fused_swin_band_block (Pallas body
// _kernel). It computes the same function without the TPU's band layout (a
// band of ws grid rows with dense [band, band + T] logits and -inf outside
// the windows, the caller's vertical roll, lane padding, head stripes):
//   h   = x + proj(concat_h attn_h) + bp
//   out = h + fc2(gelu(fc1(LN2(h)) + b1)) + b2
//   attn_h = softmax(q_h [K_h | Kt_h]^T * scale + table_h) [V_h | Vt_h]
// with q, K, V from LN1 of the window's rows, in Swin's (shifted) windows;
// the additive table [nW, H, ws^2, ws^2 + T] fp32 holds the relative-position
// bias by in-window position plus the shifted-window region mask (built by
// the caller, as the JAX package builds it in XLA: models/swin.py:add_table);
// text K/V [B, T, C] come projected from PyTorch. x [B, h*w, C] bf16 in
// row-major (y, x) order, weights in torch Linear layout [out, in] bf16 (q
// and kv stacked as wqkv [3C, C]), biases and LayerNorm affines fp32. It
// also writes the pooled LN1 rows [B, (h/p)(w/p), C] the text queries
// consume.
//
// What bounds it on the H100: the products (q, K, V, logits, P.V, proj, fc1,
// fc2), about 2.N.(4.C^2 + 2.(ws^2 + T).C + 2.C.hidden) flops a sample,
// against one read and one write of the bf16 stream: operations.
//
// Design: the window partition and the shift's roll live in an int32 index
// of h*w entries, token -> window slot (window * ws^2 + position;
// ops/swin_band.py:window_index, from models/swin.py:window_partition), read
// by two GEMM epilogues, so no roll or partition copy exists:
//   1. LN1(x) -> bf16 [rows, C]: #12's ln_mlp_fwd_norm_kernel; the pooled
//      LN1 rows by swin_pool_kernel (fp32 sums of the unrounded LN1, one
//      warp a pooled cell, in a fixed order);
//   2. q | k | v = LN1 wqkv^T + bqkv on mma_tile (swin_qkv_kernel), each row
//      stored straight into its window slot of q, k, v [B, nW, H, ws^2, hd];
//   3. the window attention on kernel F's kernel (swin_attention.cu), called
//      through its C entry, the text K/V read as a [B, H, T, hd] view of
//      [B, T, C] (strides, no copy);
//   4. h = x + A wp^T + bp on mma_tile (swin_proj_kernel), A's rows gathered
//      from the window layout through the same index, h bf16 [rows, C] in
//      row-major order;
//   5. out = h + MLP(LN2(h)): #12's forward through its C entry (one launch
//      at C <= 128, three above), without a row scale.
// #12's and F's kernels run under SwinBlockRoute (common.cuh). h is rounded
// to bf16 between 4 and 5, where the plain version keeps it in fp32.

#include <initializer_list>

#include "ln_mlp.cuh"

extern "C" int mvlt_swin_attention(const void* q, const void* kw, const void* vw,
                                   const void* kt, const void* vt, const void* table, void* out,
                                   const long long* txt_strides, int batch, int nw, int heads,
                                   int ws2, int t, int hd, int per_block, int wgs, int route,
                                   float scale, void* stream);

namespace mvlt {
namespace {

using namespace hopper;

struct SwinBlockArgs {
  const bf16* x;
  const bf16* ln1;  // [rows, C] LN1(x)
  const float* ln1_w;
  const float* ln1_b;
  bf16* pooled;
  const int* index;  // [h*w] token -> window slot
  const bf16* wqkv;  // [3C, C]
  const float* bqkv;
  bf16* q;  // [B, nW, H, ws^2, hd] each
  bf16* k;
  bf16* v;
  const bf16* attn;  // the attention output, [B, nW, H, ws^2, hd]
  int h, w, d, heads, hd, nw, ws2, pool, rows;
  float eps1;
};

// q | k | v = LN1(x) wqkv^T + bqkv, a 128 x 128 tile a block, row tile
// major; each 8 columns go to their window slot.
__global__ void __launch_bounds__(kGemmThreads, 1) swin_qkv_kernel(SwinBlockArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int n3 = 3 * a.d, ntiles = (n3 + kGemmTile - 1) / kGemmTile;
  const int m0 = (blockIdx.x / ntiles) * kGemmTile, n0 = (blockIdx.x % ntiles) * kGemmTile;
  float d[64];
  mma_tile<false, false>(Mat{a.ln1, a.d, a.rows, a.d}, Mat{a.wqkv, a.d, n3, a.d}, m0, n0, 0,
                         (a.d + kGemmChunk - 1) / kGemmChunk, smem_u32(smem), d);
  const int hw = a.h * a.w;
  store_tile(d, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    const int row = m0 + r, col = n0 + c;
    if (row >= a.rows || col >= n3) return;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += a.bqkv[col + e];
    const int which = col / a.d, ch = col - which * a.d, head = ch / a.hd, dd = ch % a.hd;
    const int slot = a.index[row % hw];
    const size_t win = ((size_t)(row / hw) * a.nw + slot / a.ws2) * a.heads * a.ws2 * a.hd;
    bf16* dst = which == 0 ? a.q : which == 1 ? a.k : a.v;
    *reinterpret_cast<uint4*>(dst + win + (size_t)head * a.ws2 * a.hd +
                              (size_t)(slot % a.ws2) * a.hd + dd) = pack_bf16x8(v);
  });
}

// h = x + A wp^T + bp, a 128 x 128 tile a block, row tile major; A's rows
// gathered from the window layout.
__global__ void __launch_bounds__(kGemmThreads, 1) swin_proj_kernel(SwinBlockArgs a,
                                                                    LnMlpArgs o) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int dtiles = (a.d + kGemmTile - 1) / kGemmTile, hw = a.h * a.w;
  const int m0 = (blockIdx.x / dtiles) * kGemmTile, n0 = (blockIdx.x % dtiles) * kGemmTile;
  auto load_a = [&](uint32_t dst, int k0) {
    for (int i = threadIdx.x; i < kGemmTile * 8; i += kGemmThreads) {
      const int r = i >> 3, c = i & 7, row = m0 + r, col = k0 + 8 * c;
      const bool ok = row < a.rows && col < a.d;
      const int slot = ok ? a.index[row % hw] : 0;
      const size_t src = (((size_t)(row / hw) * a.nw + slot / a.ws2) * a.heads + col / a.hd) *
                             a.ws2 * a.hd +
                         (size_t)(slot % a.ws2) * a.hd + col % a.hd;
      cp_async16_zfill(dst + tile_off<128>(r, c), ok ? a.attn + src : a.attn, ok);
    }
  };
  float d[64];
  mma_tile_from<false, false>(load_a, Mat{o.w2, a.d, a.d, a.d}, n0, 0,
                              (a.d + kGemmChunk - 1) / kGemmChunk, smem_u32(smem), d);
  store_tile(d, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    if (m0 + r < a.rows && n0 + c < a.d) store_out<SwinBlockRoute>(o, m0 + r, n0 + c, v);
  });
}

// Pooled LN1 rows: one warp per cell of the (h/p) x (w/p) pooled grid sums
// LN1 of the cell's p x p visual rows in fp32, in row-major order, and
// writes the mean. C <= 32 * kMaxPerLane.
__global__ void __launch_bounds__(kThreads) swin_pool_kernel(SwinBlockArgs a) {
  const int lane = threadIdx.x & 31;
  const int pw = a.w / a.pool, cells = (a.h / a.pool) * pw;
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (cell >= cells) return;
  const int d = a.d, py = cell / pw, px = cell % pw;
  float acc[kMaxPerLane] = {};
  for (int dy = 0; dy < a.pool; ++dy) {
    for (int dx = 0; dx < a.pool; ++dx) {
      const bf16* src =
          a.x + (((size_t)b * a.h + py * a.pool + dy) * a.w + px * a.pool + dx) * d;
      const float2 st = row_stats_global(src, d, a.eps1);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < d)
          acc[j] += (__bfloat162float(src[c]) - st.x) * st.y * a.ln1_w[c] + a.ln1_b[c];
      }
    }
  }
  const float inv = 1.0f / (a.pool * a.pool);
  bf16* dst = a.pooled + ((size_t)b * cells + cell) * d;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < d) dst[c] = __float2bfloat16(acc[j] * inv);
  }
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. Launches the chain on `stream` and returns the
// first failing cudaError_t (0 on success); it does not synchronise. The
// window ws divides h and w, ws^2 <= 64 and ws^2 + T <= 512, head dim 32 or
// 64 (kernel F's), the pool divides h and w, C <= 512 and hidden multiples of
// 16. `table` and `index` as the header says; per_block and wgs kernel F's
// plan (ops/swin_attention.py:plan). `scratch` holds LN1(x) [rows, C] (then
// #12's LN2(h)), h [rows, C], then q, k, v and the attention output [rows,
// C] each, whose space #12's hidden [rows, hidden] takes over at C > 128:
// rows * (2 C + max(4 C, hidden)) bf16 (ops/swin_band.py:scratch_elems).
extern "C" int mvlt_swin_block(const void* x, const void* kt, const void* vt, const void* table,
                               const void* index, const void* ln1_w, const void* ln1_b,
                               const void* wqkv, const void* bqkv, const void* wp, const void* bp,
                               const void* ln2_w, const void* ln2_b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* out,
                               void* pooled, void* scratch, int batch, int h, int w, int d,
                               int heads, int t, int hidden, int ws, int pool, int per_block,
                               int wgs, float scale, float eps1, float eps2, void* stream) {
  using namespace mvlt;
  const int hw = h * w, ws2 = ws * ws, hd = heads > 0 ? d / heads : 0;
  const long long rows = (long long)batch * hw;
  if (batch < 1 || ws < 1 || h % ws || w % ws || pool < 1 || h % pool || w % pool ||
      d > 32 * kMaxPerLane || d % 16 || hidden % 16 || heads < 1 || d % heads ||
      (hd != 32 && hd != 64) || rows > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  bf16* ln1 = static_cast<bf16*>(scratch);
  bf16* hres = ln1 + rows * d;
  bf16* qkv = hres + rows * d;
  SwinBlockArgs a{static_cast<const bf16*>(x),
                  ln1,
                  static_cast<const float*>(ln1_w),
                  static_cast<const float*>(ln1_b),
                  static_cast<bf16*>(pooled),
                  static_cast<const int*>(index),
                  static_cast<const bf16*>(wqkv),
                  static_cast<const float*>(bqkv),
                  qkv,
                  qkv + rows * d,
                  qkv + 2 * rows * d,
                  qkv + 3 * rows * d,
                  h,
                  w,
                  d,
                  heads,
                  hd,
                  (h / ws) * (w / ws),
                  ws2,
                  pool,
                  (int)rows,
                  eps1};
  // LN1 and the out-projection's epilogue (x + v + bp into h) on #12's args
  const LnMlpArgs ln{static_cast<const bf16*>(x), static_cast<const float*>(ln1_w),
                     static_cast<const float*>(ln1_b), nullptr, nullptr,
                     static_cast<const bf16*>(wp), static_cast<const float*>(bp), nullptr, hres,
                     ln1, nullptr, (int)rows, hw, d, 16, eps1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ln_mlp_fwd_norm<SwinBlockRoute>(ln, st);
  if (err != cudaSuccess) return (int)err;
  const int cells = (h / pool) * (w / pool);
  swin_pool_kernel<<<dim3((cells + kWarps - 1) / kWarps, batch), kThreads, 0, st>>>(a);
  for (const void* k : {(const void*)swin_qkv_kernel, (const void*)swin_proj_kernel})
    if (err == cudaSuccess) err = allow_dynamic_smem(k, hopper::kGemmSmem);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (int)((rows + hopper::kGemmTile - 1) / hopper::kGemmTile);
  const int tiles = (d + hopper::kGemmTile - 1) / hopper::kGemmTile;
  const size_t smem = hopper::gemm_smem((d + hopper::kGemmChunk - 1) / hopper::kGemmChunk);
  swin_qkv_kernel<<<row_tiles * ((3 * d + hopper::kGemmTile - 1) / hopper::kGemmTile),
                    hopper::kGemmThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long txt_strides[3] = {(long long)t * d, hd, d};
  err = (cudaError_t)mvlt_swin_attention(a.q, a.k, a.v, kt, vt, table, qkv + 3 * rows * d,
                                         txt_strides, batch, a.nw, heads, ws2, t, hd, per_block,
                                         wgs, 1, scale, stream);
  if (err != cudaSuccess) return (int)err;
  swin_proj_kernel<<<row_tiles * tiles, hopper::kGemmThreads, smem, st>>>(a, ln);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return mvlt_ln_mlp_fwd(hres, ln2_w, ln2_b, w1, b1, w2, b2, nullptr, out, ln1, qkv, rows, hw, d,
                         hidden, d <= 128, 1, eps2, stream);
}
