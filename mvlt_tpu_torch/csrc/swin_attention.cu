// Windowed joint attention of the Swin window path, one launch per block
// (kernel F), on Hopper's warpgroup matrix multiply (wgmma).
//
// Replaces: mvlt_tpu/ops/swin_attention.py:_fused_swin_attention (Pallas
// bodies _kernel and _kernel_paired). It computes, per sample, window and
// head,
//   out = softmax(q [k_win | k_txt]^T * scale + table) [v_win | v_txt]
// with q/k/v_win [B, nW, H, ws^2, hd] and k/v_txt [B, H, T, hd] bf16 (any
// batch, head and row strides: kernel E passes [B, T, C] as such a view) and
// the additive table [nW, H, ws^2, ws^2 + T] fp32 (relative-position bias
// plus the region/pad mask on the window columns, zeros on the text
// columns). The text K/V is read from its one copy by the windows of a
// block, never duplicated. Kernel E (swin_block.cu) runs this kernel through
// the C entry under its own route tag (common.cuh).
//
// What bounds it on the H100: the q.K^T and P.V products, 4.ws^2.(ws^2 +
// T).hd flops per (window, head), against reading q/k/v/out once, the text
// K/V once per sample and the table; at hd = 64 it sits near the card's
// balance point, so both count. At pvlt_swin_tiny's window-path shapes
// (ws^2 <= 64, T = 128) the work per window is small (3 MFLOP), so what
// bounds it in practice is the chain S -> softmax -> P.V per window.
//
// Design (the training attention forward of attention.cu, with an additive
// fp32 bias and keys from two sources). One block owns one (sample, head)
// and a run of `per_block` windows; it stages the sample's text K and V once in
// shared memory (zeros past T, 64-row chunks), swizzled as wgmma reads them,
// and its one or two warpgroups take alternate windows, running apart
// (barriers per warpgroup). A warpgroup's window is one m64 tile: q, the
// window's K and V (rows past ws^2 zero; 49 at ws = 7 pads to 64) go in by
// cp.async, V in a copy group of its own that lands while q.K^T runs. Keys
// come in 64-column chunks: the window's own, then the text's. Per chunk:
// S = q K^T on wgmma (both K-major), the logits in registers in log2 units
// (q.k scale + table, the table read in fragment layout from global memory,
// where every sample of the launch shares it; columns past the chunk's keys
// -inf), the online softmax (row max and sum over the 4 threads of a row by
// shuffles, ex2.approx, the running sum and output rescaled when a later
// chunk raises the max), P rounded to bf16 in registers and O += P V on
// wgmma (A from registers, V MN-major). O / l goes out as bf16 pairs, rows
// < ws^2 only. The TPU's window pairs (two windows stacked into one MXU
// tile) have no counterpart. hd is 32 or 64; ws^2 <= 64.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mvlt {
namespace {

using namespace hopper;

constexpr int kWin = 64;  // query rows of a window tile, key rows of a chunk

struct SwinAttnArgs {
  const bf16* q;
  const bf16* kw;
  const bf16* vw;
  const bf16* kt;
  const bf16* vt;
  const float* table;
  bf16* out;
  long long txt_b, txt_h, txt_r;  // element strides of the text K/V: sample, head, row
  int batch, nw, heads, ws2, t, per_block;
  float scale_log2;
};

__host__ __device__ constexpr int round_win(int n) { return (n + kWin - 1) / kWin * kWin; }

// text K | text V [round_win(T)][rb] each | per warpgroup: q, window K,
// window V [64][rb] each; 1024 bytes for the swizzle atoms' alignment
__host__ __device__ constexpr size_t swin_attn_smem(int t, int rb, int wgs) {
  return 1024 + 2 * (size_t)round_win(t) * rb + (size_t)wgs * 3 * kWin * rb;
}

template <int HD, class Route>
__global__ void __launch_bounds__(256, 2) swin_attn_hopper_kernel(SwinAttnArgs a) {
  constexpr int RB = HD * 2, CH = RB / 16, NA = HD / 2;
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int wgs = blockDim.x >> 7, bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int win0 = blockIdx.x * a.per_block, win1 = min(a.nw, win0 + a.per_block);
  const int tp = round_win(a.t), m = a.ws2 + a.t;
  const uint32_t s_kt = smem_u32(smem), s_vt = s_kt + tp * RB;
  const uint32_t s_q = s_vt + tp * RB + wg * 3 * kWin * RB;
  const uint32_t s_kw = s_q + kWin * RB, s_vw = s_kw + kWin * RB;
  const size_t txt = (size_t)b * a.txt_b + (size_t)h * a.txt_h;
  const bf16* ktb = a.kt + txt;
  const bf16* vtb = a.vt + txt;

  auto win_off = [&](int win) { return (((size_t)b * a.nw + win) * a.heads + h) * a.ws2 * HD; };
  auto load_tile = [&](uint32_t dst, const bf16* src) {  // a window's [ws^2][hd], zeros past
    for (int i = t; i < kWin * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      const bool ok = r < a.ws2;
      cp_async16_zfill(dst + tile_off<RB>(r, c), ok ? src + r * HD + c * 8 : src, ok);
    }
  };
  auto load_window = [&](int win) {  // q and K, then V in a group of its own
    if (win < win1) {
      load_tile(s_q, a.q + win_off(win));
      load_tile(s_kw, a.kw + win_off(win));
    }
    cp_async_commit();
    if (win < win1) load_tile(s_vw, a.vw + win_off(win));
    cp_async_commit();
  };

  // the sample's text K/V for the whole block, and each warpgroup's first window
  for (int i = tid; i < tp * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < a.t;
    cp_async16_zfill(s_kt + tile_off<RB>(r, c), ok ? ktb + r * a.txt_r + c * 8 : ktb, ok);
    cp_async16_zfill(s_vt + tile_off<RB>(r, c), ok ? vtb + r * a.txt_r + c * 8 : vtb, ok);
  }
  cp_async_commit();
  load_window(win0 + wg);
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();

  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);  // rows r0, r0 + 8
  const int chunks = 1 + tp / kWin;
  for (int win = win0 + wg; win < win1; win += wgs) {
    if (win != win0 + wg) {
      named_barrier(1 + wg, 128);  // every warp is done with the last window's tiles
      load_window(win);
      cp_async_wait<1>();
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    }
    const float* tab = a.table + ((size_t)win * a.heads + h) * a.ws2 * m;
    float o[NA], m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NA; ++i) o[i] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const uint32_t sk = c == 0 ? s_kw : s_kt + (c - 1) * kWin * RB;
      const uint32_t sv = c == 0 ? s_vw : s_vt + (c - 1) * kWin * RB;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0, 0>(s, make_desc<RB>(s_q + kk * 32), make_desc<RB>(sk + kk * 32), kk);
      wgmma_commit();
      wgmma_wait<0>();  // this chunk's S, and the last chunk's P.V
      fence_regs(s);
      fence_regs(o);
      // logits in log2 units; the chunk's column 0 is table column col0
      const int col0 = c == 0 ? 0 : a.ws2 + (c - 1) * kWin;
      const int keys = c == 0 ? a.ws2 : min(kWin, a.t - (c - 1) * kWin);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = r0 + 8 * ((i >> 1) & 1), cc = 8 * (i >> 2) + cq + (i & 1);
        const float add =
            rr < a.ws2 && cc < keys ? tab[(size_t)rr * m + col0 + cc] * kLog2e : 0.0f;
        s[i] = cc < keys ? fmaf(s[i], a.scale_log2, add) : -INFINITY;
      }
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      }
      const float mn0 = fmaxf(m0, x0), mn1 = fmaxf(m1, x1);
      // a row with no finite logit yet keeps its zero sums
      const float b0 = mn0 == -INFINITY ? 0.0f : mn0, b1 = mn1 == -INFINITY ? 0.0f : mn1;
      const float a0 = exp2f(m0 - b0), a1 = exp2f(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = fast_exp2(s[4 * j] - b0);
        s[4 * j + 1] = fast_exp2(s[4 * j + 1] - b0);
        s[4 * j + 2] = fast_exp2(s[4 * j + 2] - b1);
        s[4 * j + 3] = fast_exp2(s[4 * j + 3] - b1);
        p0 += s[4 * j] + s[4 * j + 1];
        p1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + p0;
      l1 = l1 * a1 + p1;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(s, kk, p[kk]);
        fence_regs(p[kk]);
      }
      if (c == 0) {  // the window's V is in
        cp_async_wait<0>();
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(o, p[kk], make_desc<RB>(sv + 16 * kk * RB), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
    bf16* ob = a.out + win_off(win);
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      if (r0 < a.ws2)
        *reinterpret_cast<uint32_t*>(ob + r0 * HD + 8 * j + cq) =
            pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (r0 + 8 < a.ws2)
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * HD + 8 * j + cq) =
            pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

template <int HD, class Route>
int launch(const SwinAttnArgs& a, int wgs, cudaStream_t stream) {
  const size_t bytes = swin_attn_smem(a.t, HD * 2, wgs);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  static int smem_dev = -1;  // this instantiation's shared-memory allowance, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != smem_dev) {
    err = cudaFuncSetAttribute(swin_attn_hopper_kernel<HD, Route>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (err == cudaSuccess) smem_dev = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nw + a.per_block - 1) / a.per_block, a.batch * a.heads);
  swin_attn_hopper_kernel<HD, Route><<<grid, 128 * wgs, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes: hd 32 or 64, 1 <= ws2 <= 64, T >= 0, one block
// per (sample, head) and run of `per_block` windows, `wgs` (1 or 2)
// warpgroups a block; txt_strides the text K/V's (sample, head, row) element
// strides (rows of 16-byte aligned hd values). `route` 0 is kernel F itself,
// 1 kernel E's chain. Launches on `stream` and returns the cudaError_t of
// the launch (0 on success); it does not synchronise.
extern "C" int mvlt_swin_attention(const void* q, const void* kw, const void* vw,
                                   const void* kt, const void* vt, const void* table, void* out,
                                   const long long* txt_strides, int batch, int nw, int heads,
                                   int ws2, int t, int hd, int per_block, int wgs, int route,
                                   float scale, void* stream) {
  using namespace mvlt;
  if (ws2 < 1 || ws2 > kWin || t < 0 || per_block < 1 || (wgs != 1 && wgs != 2) ||
      (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  const SwinAttnArgs a{static_cast<const bf16*>(q),
                       static_cast<const bf16*>(kw),
                       static_cast<const bf16*>(vw),
                       static_cast<const bf16*>(kt),
                       static_cast<const bf16*>(vt),
                       static_cast<const float*>(table),
                       static_cast<bf16*>(out),
                       txt_strides[0],
                       txt_strides[1],
                       txt_strides[2],
                       batch,
                       nw,
                       heads,
                       ws2,
                       t,
                       per_block,
                       scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return route ? launch<64, SwinBlockRoute>(a, wgs, st) : launch<64, SwinAttnRoute>(a, wgs, st);
  if (hd == 32)
    return route ? launch<32, SwinBlockRoute>(a, wgs, st) : launch<32, SwinAttnRoute>(a, wgs, st);
  return (int)cudaErrorInvalidValue;
}
