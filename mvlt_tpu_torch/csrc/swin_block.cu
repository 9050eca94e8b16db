// Whole Swin block on the visual stream, one launch of two kernels per
// block (kernel E).
//
// Replaces: mvlt_tpu/ops/swin_band.py:fused_swin_band_block (Pallas body
// _kernel). It computes the same function without the TPU's band layout (a
// band of ws grid rows with dense [band, band + T] logits and -inf outside
// the windows, the caller's vertical roll, lane padding, head stripes):
//   h   = x + proj(concat_h attn_h) + bp
//   out = h + fc2(gelu(fc1(LN2(h)) + b1)) + b2
//   attn_h = softmax(q_h [K_h | Kt_h]^T * scale + bias_h + mask) [V_h | Vt_h]
// with q, K, V from LN1 of the window's rows, the relative-position bias
// indexed by in-window position, and Swin's shifted-window region mask, both
// in rolled coordinates as mvlt_tpu/ops/swin_band.py:_band_layout sets them
// out; text K/V [B, T, C] come projected from PyTorch. x [B, h*w, C] bf16 in
// row-major (y, x) order, weights in torch Linear layout [out, in] bf16 (the
// kv weight [2C, C]: K rows, then V rows), biases, LayerNorm affines and the
// bias table [(2 ws - 1)^2, H] fp32. A second kernel writes the pooled LN1
// rows [B, (h/p)(w/p), C] the text queries consume: LN1 recomputed for every
// visual row and averaged over p x p cells, in a fixed order (no atomics).
//
// What bounds it on the H100: the products (q, K, V, logits, P.V, proj, fc1,
// fc2), about 2.N.(4.C^2 + 2.(ws^2 + T).C + 2.C.hidden) flops per sample,
// against one read and one write of the bf16 stream; weights, the bias table
// and each sample's text K/V stay in the 50 MB L2.
//
// Design: one block of 8 warps per (sample, window). It gathers the window's
// ws^2 rows by index -- for a shifted block, grid row (y + s) % h and column
// (x + s) % w -- and writes them back to the same places, so no roll copy
// and no dense mask exist. Shared memory holds, while attending, LN1 of the
// rows, one head's q and K (then V) and the fp32 logits (swin_window.cuh),
// with the head outputs gathered in obuf; then the fp32 residual tile and a
// chunk of the MLP hidden take the attention's place: 223 KB at C = 512,
// T = 128, so one block per SM. GELU is exact erf. Products run on the wmma
// core (common.cuh:gemm_bf16). wgmma and TMA are for later work.

#include <initializer_list>

#include "swin_window.cuh"

namespace mvlt {
namespace {

struct SwinBlockArgs {
  const bf16* x;
  const bf16* kt;
  const bf16* vt;
  const float* rel;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wq;
  const float* bq;
  const bf16* wkv;
  const float* bkv;
  const bf16* wp;
  const float* bp;
  const float* ln2_w;
  const float* ln2_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  bf16* out;
  bf16* pooled;
  int h, w, d, heads, t, hidden, ws, shift, pool, chunk;
  float scale, eps1, eps2;
};

struct SwinBlockSmem {
  size_t ln1, qh, kv, logit, inv, xres, hid, obuf, stage, total;
};

// Shared-memory layout, computed the same way on the host and the device.
// The attention buffers (ln1 .. inv) and the MLP buffers (xres, hid)
// overlay each other; obuf (the head outputs, then LN2) and the GEMM staging
// follow.
__host__ __device__ inline SwinBlockSmem swin_block_smem(int rows_p, int d, int hd, int mp,
                                                         int chunk) {
  SwinBlockSmem s;
  size_t o = 0;
  s.ln1 = o;   o += align128((size_t)rows_p * (d + kWinPad) * 2);
  s.qh = o;    o += align128((size_t)rows_p * (hd + kWinPad) * 2);
  s.kv = o;    o += align128((size_t)mp * (hd + kWinPad) * 2);
  s.logit = o; o += win_logit_bytes(rows_p, mp);
  s.inv = o;   o += align128((size_t)rows_p * 4);
  const size_t attn = o;
  s.xres = 0;
  s.hid = align128((size_t)rows_p * d * 4);
  const size_t mlp = s.hid + align128((size_t)rows_p * (chunk + kWinPad) * 2);
  o = attn > mlp ? attn : mlp;
  s.obuf = o;  o += align128((size_t)rows_p * (d + kWinPad) * 2);
  s.stage = o; o += kStageBytes;
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads) swin_block_kernel(SwinBlockArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int ws = a.ws, rows = ws * ws, rows_p = round16(rows), d = a.d, hd = d / a.heads;
  const int m = rows + a.t, mp = round16(m), ld = d + kWinPad, ldk = hd + kWinPad;
  const int ldh = a.chunk + kWinPad;
  const int b = blockIdx.y, wy = blockIdx.x / (a.w / ws), wx = blockIdx.x % (a.w / ws);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const SwinBlockSmem L = swin_block_smem(rows_p, d, hd, mp, a.chunk);
  bf16* ln1 = reinterpret_cast<bf16*>(smem + L.ln1);
  bf16* qh = reinterpret_cast<bf16*>(smem + L.qh);
  bf16* kv = reinterpret_cast<bf16*>(smem + L.kv);
  float* xres = reinterpret_cast<float*>(smem + L.xres);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* obuf = reinterpret_cast<bf16*>(smem + L.obuf);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  const size_t n = (size_t)a.h * a.w;
  const bf16* xb = a.x + b * n * d;

  // window row r (row-major in the window) -> its token in the un-rolled grid
  auto token = [&](int r) {
    const int y = (wy * ws + r / ws + a.shift) % a.h;
    const int x = (wx * ws + r % ws + a.shift) % a.w;
    return (size_t)y * a.w + x;
  };
  // Swin's region id along one axis of length len, at rolled position pos
  auto region = [&](int pos, int len) {
    return a.shift == 0 ? 0 : pos < len - ws ? 0 : pos < len - a.shift ? 1 : 2;
  };

  for (int r = warp; r < rows_p; r += kWarps) {
    if (r < rows) {
      layer_norm_row_global(xb + token(r) * d, d, a.ln1_w, a.ln1_b, a.eps1, ln1 + r * ld);
    } else {
      for (int c = lane; c < d; c += 32) ln1[r * ld + c] = __float2bfloat16(0.0f);
    }
  }
  __syncthreads();

  const bf16* ktb = a.kt + (size_t)b * a.t * d;
  const bf16* vtb = a.vt + (size_t)b * a.t * d;
  // one head's window K or V: LN1 . W[rows of the head] + bias, into kv
  auto project = [&](const bf16* wm, const float* bias) {
    gemm_bf16<true, 2>(ln1, ld, wm, d, rows_p, hd, d, stage, [&](int r, int c, float v) {
      if (r < rows) kv[r * ldk + c] = __float2bfloat16(v + bias[c]);
    });
  };
  for (int h = 0; h < a.heads; ++h) {
    gemm_bf16<true, 2>(ln1, ld, a.wq + (size_t)h * hd * d, d, rows_p, hd, d, stage,
                       [&](int r, int c, float v) {
                         qh[r * ldk + c] = __float2bfloat16(v + a.bq[h * hd + c]);
                       });
    window_attention(
        qh, kv, ldk, rows, m, hd, reinterpret_cast<float*>(smem + L.logit),
        reinterpret_cast<float*>(smem + L.inv), stage, a.scale,
        [&] {
          project(a.wkv + (size_t)h * hd * d, a.bkv + h * hd);
          load_rows_async(kv + (size_t)rows * ldk, ldk, ktb + h * hd, d, a.t, hd);
        },
        [&] {
          project(a.wkv + (size_t)(d + h * hd) * d, a.bkv + d + h * hd);
          load_rows_async(kv + (size_t)rows * ldk, ldk, vtb + h * hd, d, a.t, hd);
        },
        [&](int r, int c) -> float {
          if (c >= rows) return 0.0f;   // text columns
          const int iq = r / ws, jq = r % ws, ik = c / ws, jk = c % ws;
          if (region(wy * ws + iq, a.h) != region(wy * ws + ik, a.h) ||
              region(wx * ws + jq, a.w) != region(wx * ws + jk, a.w))
            return -INFINITY;
          return a.rel[((iq - ik + ws - 1) * (2 * ws - 1) + (jq - jk + ws - 1)) * a.heads + h];
        },
        [&](int r, int c, float v) { obuf[r * ld + h * hd + c] = __float2bfloat16(v); });
  }

  // ---- out-projection onto the fp32 residual (over the attention buffers) ----
  for (int i = threadIdx.x * 8; i < rows_p * d; i += kThreads * 8) {
    const int r = i / d, c = i - r * d;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < rows) raw = *reinterpret_cast<const uint4*>(xb + token(r) * d + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) xres[i + j] = __bfloat162float(e[j]);
  }
  __syncthreads();
  gemm_bf16<true, 2>(obuf, ld, a.wp, d, rows_p, d, d, stage,
                     [&](int r, int c, float v) { xres[r * d + c] += v + a.bp[c]; });
  __syncthreads();

  // ---- MLP half, the hidden in chunks ----
  for (int r = warp; r < rows_p; r += kWarps) {
    const float* row = xres + (size_t)r * d;
    layer_norm_row([&](int c) { return row[c]; }, d, a.ln2_w, a.ln2_b, a.eps2, obuf + r * ld);
  }
  __syncthreads();
  for (int c0 = 0; c0 < a.hidden; c0 += a.chunk) {
    const int cw = min(a.chunk, a.hidden - c0);
    gemm_bf16<true, 2>(obuf, ld, a.w1 + (size_t)c0 * d, d, rows_p, cw, d, stage,
                       [&](int r, int c, float v) {
                         hid[r * ldh + c] = __float2bfloat16(gelu_erf(v + a.b1[c0 + c]));
                       });
    __syncthreads();
    gemm_bf16<true, 2>(hid, ldh, a.w2 + c0, a.hidden, rows_p, d, cw, stage,
                       [&](int r, int c, float v) { xres[r * d + c] += v; });
    __syncthreads();
  }

  bf16* ob = a.out + b * n * d;
  for (int i = threadIdx.x * 8; i < rows * d; i += kThreads * 8) {
    const int r = i / d, c = i - r * d;
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(xres[i + j] + a.b2[c + j]);
    *reinterpret_cast<uint4*>(ob + token(r) * d + c) = raw;
  }
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

// C entry, bound with ctypes. Launches both kernels on `stream` and returns
// the first failing cudaError_t (0 on success); it does not synchronise.
extern "C" int mvlt_swin_block(const void* x, const void* kt, const void* vt, const void* rel,
                               const void* ln1_w, const void* ln1_b, const void* wq,
                               const void* bq, const void* wkv, const void* bkv,
                               const void* wp, const void* bp, const void* ln2_w,
                               const void* ln2_b, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out, void* pooled,
                               int batch, int h, int w, int d, int heads, int t, int hidden,
                               int ws, int shift, int pool, float scale, float eps1, float eps2,
                               void* stream) {
  using namespace mvlt;
  const int rows_p = round16(ws * ws), mp = round16(ws * ws + t), hd = d / heads;
  if (ws * ws + t > kMaxKeys || d > 32 * kMaxPerLane || h % ws || w % ws || h % pool ||
      w % pool)
    return (int)cudaErrorInvalidConfiguration;
  int chunk = 0;
  size_t bytes = 0;
  for (int cand : {256, 128, 64}) {
    const int c = hidden < cand ? hidden : cand;
    bytes = swin_block_smem(rows_p, d, hd, mp, c).total;
    if (bytes <= kSmemLimit) {
      chunk = c;
      break;
    }
  }
  if (!chunk) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const SwinBlockArgs a{
      static_cast<const bf16*>(x),     static_cast<const bf16*>(kt),
      static_cast<const bf16*>(vt),    static_cast<const float*>(rel),
      static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      static_cast<const bf16*>(wq),    static_cast<const float*>(bq),
      static_cast<const bf16*>(wkv),   static_cast<const float*>(bkv),
      static_cast<const bf16*>(wp),    static_cast<const float*>(bp),
      static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b),
      static_cast<const bf16*>(w1),    static_cast<const float*>(b1),
      static_cast<const bf16*>(w2),    static_cast<const float*>(b2),
      static_cast<bf16*>(out),         static_cast<bf16*>(pooled),
      h, w, d, heads, t, hidden, ws, shift, pool, chunk, scale, eps1, eps2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  swin_block_kernel<<<dim3((h / ws) * (w / ws), batch), kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cells = (h / pool) * (w / pool);
  swin_pool_kernel<<<dim3((cells + kWarps - 1) / kWarps, batch), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
