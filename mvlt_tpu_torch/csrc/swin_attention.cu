// Windowed joint attention of the Swin window path, one launch per block
// (kernel F).
//
// Replaces: mvlt_tpu/ops/swin_attention.py:_fused_swin_attention (Pallas
// bodies _kernel and _kernel_paired). It computes, per sample, window and
// head,
//   out = softmax(q [k_win | k_txt]^T * scale + table) [v_win | v_txt]
// with q/k/v_win [B, nW, H, ws^2, hd] and k/v_txt [B, H, T, hd] bf16 and the
// additive table [nW, H, ws^2, ws^2 + T] fp32 (relative-position bias plus
// the region/pad mask on the window columns, zeros on the text columns).
// The text K/V is read from its one copy by every window, never duplicated.
//
// What bounds it on the H100: the q.K^T and P.V products, 4.ws^2.(ws^2 +
// T).hd flops per (window, head), against reading q/k/v/out once, the text
// K/V once per sample and the table; at hd = 64 it sits near the card's
// balance point, so both count.
//
// Design: one block of 8 warps per (sample, window, head) keeps q, one of
// K or V, and the logits in shared memory (swin_window.cuh); about 95 KB at
// ws = 8 and T = 128, so two blocks share an SM. Query rows past ws^2 (49 at
// ws = 7) are padded to the 16-row tile, computed on zeros and never stored;
// key columns past ws^2 + T are masked. The TPU's window pairs (two windows
// stacked into one MXU tile) have no counterpart. wgmma and TMA are for
// later work.

#include "swin_window.cuh"

namespace mvlt {
namespace {

struct SwinAttnArgs {
  const bf16* q;
  const bf16* kw;
  const bf16* vw;
  const bf16* kt;
  const bf16* vt;
  const float* table;
  bf16* out;
  int nw, heads, ws2, t, hd;
  float scale;
};

struct SwinAttnSmem {
  size_t q, kv, logit, inv, stage, total;
};

__host__ __device__ inline SwinAttnSmem swin_attn_smem(int ws2, int t, int hd) {
  const int rows_p = round16(ws2), mp = round16(ws2 + t), ld = hd + kWinPad;
  SwinAttnSmem s;
  size_t o = 0;
  s.q = o;     o += align128((size_t)rows_p * ld * 2);
  s.kv = o;    o += align128((size_t)mp * ld * 2);
  s.logit = o; o += win_logit_bytes(rows_p, mp);
  s.inv = o;   o += align128((size_t)rows_p * 4);
  s.stage = o; o += kStageBytes;
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads) swin_attention_kernel(SwinAttnArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int head = blockIdx.x % a.heads, win = blockIdx.x / a.heads, b = blockIdx.y;
  const int ws2 = a.ws2, hd = a.hd, ld = hd + kWinPad, m = ws2 + a.t;
  const SwinAttnSmem L = swin_attn_smem(ws2, a.t, hd);
  bf16* q = reinterpret_cast<bf16*>(smem + L.q);
  bf16* kv = reinterpret_cast<bf16*>(smem + L.kv);
  const size_t win_off = (((size_t)b * a.nw + win) * a.heads + head) * ws2 * hd;
  const size_t txt_off = ((size_t)b * a.heads + head) * a.t * hd;
  const float* tab = a.table + ((size_t)win * a.heads + head) * ws2 * m;

  load_rows_async(q, ld, a.q + win_off, hd, ws2, hd);
  zero_rows(q, ld, ws2, round16(ws2), hd);
  window_attention(
      q, kv, ld, ws2, m, hd, reinterpret_cast<float*>(smem + L.logit),
      reinterpret_cast<float*>(smem + L.inv), reinterpret_cast<float*>(smem + L.stage), a.scale,
      [&] {
        load_rows_async(kv, ld, a.kw + win_off, hd, ws2, hd);
        load_rows_async(kv + (size_t)ws2 * ld, ld, a.kt + txt_off, hd, a.t, hd);
      },
      [&] {
        load_rows_async(kv, ld, a.vw + win_off, hd, ws2, hd);
        load_rows_async(kv + (size_t)ws2 * ld, ld, a.vt + txt_off, hd, a.t, hd);
      },
      [&](int r, int c) { return tab[(size_t)r * m + c]; },
      [&](int r, int c, float v) {
        a.out[win_off + (size_t)r * hd + c] = __float2bfloat16(v);
      });
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int mvlt_swin_attention(const void* q, const void* kw, const void* vw,
                                   const void* kt, const void* vt, const void* table, void* out,
                                   int batch, int nw, int heads, int ws2, int t, int hd,
                                   float scale, void* stream) {
  using namespace mvlt;
  if (ws2 + t > kMaxKeys || hd % 16 || hd > 128) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = swin_attn_smem(ws2, t, hd).total;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      swin_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const SwinAttnArgs a{static_cast<const bf16*>(q),      static_cast<const bf16*>(kw),
                       static_cast<const bf16*>(vw),     static_cast<const bf16*>(kt),
                       static_cast<const bf16*>(vt),     static_cast<const float*>(table),
                       static_cast<bf16*>(out),          nw, heads, ws2, t, hd, scale};
  swin_attention_kernel<<<dim3(nw * heads, batch), kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
