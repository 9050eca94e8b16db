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
// stage 4: every shape that fits the shared-memory plans below runs here.
// The statistics are [B, N, 2 + 2H] fp32 in natural units: per row the LN1
// mean and 1/std, then per head the row max of the scaled logits and
// 1/denominator, so that P = exp(l - max) * inv.
//
// What bounds it on the H100: the forward does kernel C's products,
// 2.N.(2D^2 + 2.M.D) flops per sample, against one read and one write of
// the bf16 stream; the backward about 2.5x the forward's products against
// x and dy read and dx written, plus its own scratch (Q and dO [B, N, D]
// bf16, three floats per row and head) written once and read once. At
// stage 1 (D = 64, one head) the bytes weigh more, at stages 2-4 the
// products.
//
// Design, forward: kernel C (attn_half.cuh) in its training form: one block
// of 8 warps per tile of TR rows of one sample; the projection sum is scaled
// by s[b] before it joins the fp32 residual; the statistics are written per
// row where asked (Pallas #7), nothing else changes (Pallas #6).
// Backward, three launches, deterministic, no atomics:
//   1. rows: a fixed set of G blocks (G <= the workspace's slots, one per
//      SM) each walk every G-th row tile of the [B, N] grid. Per tile: LN1
//      (statistics by reductions, or read from the forward's side output),
//      dys = s.dy; per head Q_h = LN1 Wq_h^T + bq_h, dO_h = dys Wp[:, h],
//      logits, P (softmax by reductions, or exp(l - max) * inv from the
//      statistics), A_h = P V_h, dP = dO_h V_h^T, D = rowsum(dP P),
//      dS = P (dP - D) scale, dQ_h = dS K_h; the block adds dWq, dWp^T, dbq,
//      dbp, dgamma and dbeta of the tile into its own fp32 slot (written on
//      its first tile; dWq and dWp^T per head through common.cuh:gemm_acc);
//      dLN1 = dQ Wq, dx = dy + the LN1 backward. Q_h and dO_h go to device
//      memory in bf16, and (max, 1/denominator, D) per row and head in fp32.
//      Padded rows of a tile are zero in dy, so they add nothing anywhere;
//      a sample with s = 0 passes dy through to dx and adds nothing else.
//   2. dK/dV: one block per (sample, head) and role walks its sample's row
//      tiles and keeps the fp32 sum in shared memory: role 0 rebuilds P from
//      Q_h and the saved row statistics (no softmax reductions) and sums
//      dV = P^T dO_h; role 1 also forms dP = dO_h V_h^T and
//      dS = P (dP - D) scale, and sums dK = dS^T Q_h. One fp32 [M, hd] sum
//      per block fits shared memory at every pvlt_tiny stage (48 KB at
//      M = 192, hd = 64), where the TPU kernel's dK/dV blocks did not fit at
//      stage 4 and fell back to XLA.
//   3. the in-order sum of the G slots into dWq, dWp (from its transposed
//      slot layout), dbq, dbp, dgamma and dbeta.
// Products run on common.cuh's wmma core (bf16 operands, fp32 sums); the
// backward's warp tiles span one row block (MaxRB = 1), as the other
// backward kernels' do. K and V are read as fragments straight from device
// memory (L2) in the backward, with their rows padded to 16 by the wrapper.

#include <initializer_list>

#include "attn_half.cuh"

namespace mvlt {
namespace {

struct FwdArgs {
  const bf16* x;
  AttnArgs at;
  const float* s;
  bf16* out;
  float* stats;  // [B, N, 2 + 2H] or null
  int n, d, tr;
};

__global__ void __launch_bounds__(kThreads) fba_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int tr = a.tr, d = a.d, hd = d / a.at.heads, mp = (a.at.m + 15) & ~15;
  const int b = blockIdx.y, n0 = blockIdx.x * tr;
  const int rows = min(tr, a.n - n0);
  const AttnSmem L = attn_smem(tr, d, mp, hd);
  float* xres = reinterpret_cast<float*>(smem + L.xres);

  // residual tile, fp32; rows past N are zero and never stored
  load_residual_tile(xres, a.x + ((size_t)b * a.n + n0) * d, tr, d, rows, nullptr);
  __syncthreads();
  float* stats = a.stats ? a.stats + ((size_t)b * a.n + n0) * (2 + 2 * a.at.heads) : nullptr;
  attention_half<true>(a.at, b, tr, d, xres, reinterpret_cast<bf16*>(smem + L.abuf),
                       reinterpret_cast<bf16*>(smem + L.qall), reinterpret_cast<bf16*>(smem + L.kv),
                       reinterpret_cast<float*>(smem + L.logit),
                       reinterpret_cast<float*>(smem + L.stage), a.s[b], stats, rows);

  bf16* ob = a.out + ((size_t)b * a.n + n0) * d;
  for (int i = threadIdx.x * 8; i < rows * d; i += kThreads * 8) {
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(xres[i + j]);
    *reinterpret_cast<uint4*>(ob + i) = raw;
  }
}

// ---- backward ---------------------------------------------------------------

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const bf16* k;  // [B, H, mp, hd], rows m..mp zero
  const bf16* v;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wq;
  const float* bq;
  const bf16* wp;
  const float* s;
  const float* stats;  // [B, N, 2 + 2H] from the forward, or null (recompute)
  bf16* dx;
  float* ws;  // [slots, slot_size] fp32
  bf16* qs;   // Q [B, N, D] bf16 (scratch, launch 1 -> 2)
  bf16* dos;  // dO [B, N, D] bf16 (scratch)
  float* rs;  // [B, H, N, 3]: row max, 1/denominator, rowsum(dP P) (scratch)
  bf16* dk;   // [B, H, m, hd]
  bf16* dv;
  int batch, n, d, heads, m, tr, slot_size;
  float scale, eps;
};

// slot layout (floats): dWq [D, D] | dWp^T [D, D] | dbq [D] | dbp [D] | dgamma [D] | dbeta [D]
// (a multiple of 8 floats, so every slot starts 32-byte aligned)
__host__ __device__ inline int slot_floats(int d) { return (2 * d * d + 4 * d + 7) & ~7; }

// Launch 1's shared memory: the tile's LN1, s.dy and dQ (all heads) in bf16,
// the LN1 statistics, then a region holding either one head's scratch or,
// after the heads, dLN1 fp32 [tr, d]; then the GEMM staging.
struct RowsSmem {
  size_t normed, dys, dqall, rowst, qh, doh, at, dqt, dqf, pf, pb, dp, dn, stage, total;
};

__host__ __device__ inline RowsSmem rows_smem(int tr, int d, int hd, int mp) {
  RowsSmem s;
  size_t o = 0;
  s.normed = o; o += align128((size_t)tr * (d + kPad) * 2);
  s.dys = o;    o += align128((size_t)tr * (d + kPad) * 2);
  s.dqall = o;  o += align128((size_t)tr * (d + kPad) * 2);
  s.rowst = o;  o += align128((size_t)tr * 4 * 4);           // mean, rstd, max, 1/den
  const size_t u = o;
  s.qh = o;     o += align128((size_t)tr * (hd + kPad) * 2);  // Q_h bf16
  s.doh = o;    o += align128((size_t)tr * (hd + kPad) * 2);  // dO_h bf16
  s.at = o;     o += align128((size_t)hd * (tr + kPad) * 2);  // A_h^T bf16
  s.dqt = o;    o += align128((size_t)hd * (tr + kPad) * 2);  // dQ_h^T bf16
  s.dqf = o;    o += align128((size_t)tr * hd * 4);           // dQ_h fp32
  s.pf = o;     o += align128((size_t)tr * mp * 4);           // logits, then P, fp32
  s.pb = o;     o += align128((size_t)tr * (mp + kPad) * 2);  // P, then dS, bf16
  s.dp = o;     o += align128((size_t)tr * mp * 4);           // dP fp32
  s.dn = u;
  const size_t dn_end = u + align128((size_t)tr * d * 4);
  if (dn_end > o) o = dn_end;
  s.stage = o;  o += kStageBytes;
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads) fba_bwd_rows_kernel(BwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int tr = a.tr, d = a.d, H = a.heads, hd = d / H, m = a.m, mp = (m + 15) & ~15;
  const int ld = d + kPad, ldh = hd + kPad, ldt = tr + kPad, ldp = mp + kPad;
  const int sw = 2 + 2 * H;
  const RowsSmem L = rows_smem(tr, d, hd, mp);
  bf16* normed = reinterpret_cast<bf16*>(smem + L.normed);
  bf16* dys = reinterpret_cast<bf16*>(smem + L.dys);
  bf16* dqall = reinterpret_cast<bf16*>(smem + L.dqall);
  float* rowst = reinterpret_cast<float*>(smem + L.rowst);
  bf16* qh = reinterpret_cast<bf16*>(smem + L.qh);
  bf16* doh = reinterpret_cast<bf16*>(smem + L.doh);
  bf16* at = reinterpret_cast<bf16*>(smem + L.at);
  bf16* dqt = reinterpret_cast<bf16*>(smem + L.dqt);
  float* dqf = reinterpret_cast<float*>(smem + L.dqf);
  float* pf = reinterpret_cast<float*>(smem + L.pf);
  bf16* pb = reinterpret_cast<bf16*>(smem + L.pb);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  float* dn = reinterpret_cast<float*>(smem + L.dn);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* slot = a.ws + (size_t)blockIdx.x * a.slot_size;
  float* s_dwq = slot;
  float* s_dwpt = slot + (size_t)d * d;
  float* s_dbq = s_dwpt + (size_t)d * d;
  float* s_dbp = s_dbq + d;
  float* s_dg = s_dbp + d;
  float* s_dbe = s_dg + d;
  const int tiles_per_sample = (a.n + tr - 1) / tr;
  const long long ntiles = (long long)a.batch * tiles_per_sample;

  bool first = true;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, first = false) {
    const int b = (int)(t / tiles_per_sample), n0 = (int)(t % tiles_per_sample) * tr;
    const int rows = min(tr, a.n - n0);
    const size_t row0 = (size_t)b * a.n + n0;
    const bf16* xb = a.x + row0 * d;
    const bf16* dyb = a.dy + row0 * d;
    const float sc = a.s[b];
    // LN1 (recomputed, or from the forward's statistics) and s.dy; padded rows zero
    for (int r = warp; r < tr; r += kWarps) {
      if (r < rows) {
        const bf16* xr = xb + (size_t)r * d;
        float mean, rstd;
        if (a.stats) {
          mean = a.stats[(row0 + r) * sw];
          rstd = a.stats[(row0 + r) * sw + 1];
        } else {
          float sum = 0.0f;
          for (int c = lane; c < d; c += 32) sum += __bfloat162float(xr[c]);
          mean = warp_sum(sum) / d;
          float q = 0.0f;
          for (int c = lane; c < d; c += 32) {
            const float z = __bfloat162float(xr[c]) - mean;
            q += z * z;
          }
          rstd = rsqrtf(warp_sum(q) / d + a.eps);
        }
        for (int c = lane; c < d; c += 32) {
          normed[r * ld + c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd *
                                                a.ln1_w[c] + a.ln1_b[c]);
          dys[r * ld + c] = __float2bfloat16(__bfloat162float(dyb[(size_t)r * d + c]) * sc);
        }
        if (lane == 0) {
          rowst[4 * r] = mean;
          rowst[4 * r + 1] = rstd;
        }
      } else {
        for (int c = lane; c < d; c += 32) {
          normed[r * ld + c] = __float2bfloat16(0.0f);
          dys[r * ld + c] = __float2bfloat16(0.0f);
        }
      }
    }
    __syncthreads();

    for (int h = 0; h < H; ++h) {
      const bf16* kh = a.k + ((size_t)b * H + h) * mp * hd;
      const bf16* vh = a.v + ((size_t)b * H + h) * mp * hd;
      // Q_h = LN1 Wq_h^T + bq_h and dO_h = (s.dy) Wp[:, h], kept and written out
      gemm_bf16<true, 1>(normed, ld, a.wq + (size_t)h * hd * d, d, tr, hd, d, stage,
                         [&](int r, int c, float v) {
                           const bf16 e = __float2bfloat16(v + a.bq[h * hd + c]);
                           qh[r * ldh + c] = e;
                           if (r < rows) a.qs[(row0 + r) * d + h * hd + c] = e;
                         });
      gemm_bf16<false, 1>(dys, ld, a.wp + h * hd, d, tr, hd, d, stage,
                          [&](int r, int c, float v) {
                            const bf16 e = __float2bfloat16(v);
                            doh[r * ldh + c] = e;
                            if (r < rows) a.dos[(row0 + r) * d + h * hd + c] = e;
                          });
      __syncthreads();
      gemm_bf16<true, 1>(qh, ldh, kh, hd, tr, mp, hd, stage,
                         [&](int r, int c, float v) { pf[r * mp + c] = v * a.scale; });
      __syncthreads();
      // P fp32 in place and bf16; padded columns 0. Padded rows: P = 0 from
      // the statistics (inv 0), a softmax of bq's logits when recomputed --
      // either way their dO is 0, so they add nothing.
      for (int r = warp; r < tr; r += kWarps) {
        float* lr = pf + (size_t)r * mp;
        float mx, inv;
        if (a.stats) {
          const bool live = r < rows;
          mx = live ? a.stats[(row0 + r) * sw + 2 + 2 * h] : 0.0f;
          inv = live ? a.stats[(row0 + r) * sw + 3 + 2 * h] : 0.0f;
          for (int c = lane; c < m; c += 32) lr[c] = __expf(fminf(lr[c] - mx, 0.0f)) * inv;
        } else {
          mx = -INFINITY;
          for (int c = lane; c < m; c += 32) mx = fmaxf(mx, lr[c]);
          mx = warp_max(mx);
          float sum = 0.0f;
          for (int c = lane; c < m; c += 32) {
            const float e = __expf(lr[c] - mx);
            lr[c] = e;
            sum += e;
          }
          inv = 1.0f / warp_sum(sum);
          for (int c = lane; c < m; c += 32) lr[c] *= inv;
        }
        for (int c = lane; c < mp; c += 32) {
          if (c >= m) lr[c] = 0.0f;
          pb[(size_t)r * ldp + c] = __float2bfloat16(lr[c]);
        }
        if (lane == 0) {
          rowst[4 * r + 2] = mx;
          rowst[4 * r + 3] = inv;
        }
      }
      __syncthreads();
      // A_h = P V_h (bf16, as the forward rounds it), kept transposed for dWp;
      // dP = dO_h V_h^T
      gemm_bf16<false, 1>(pb, ldp, vh, hd, tr, hd, mp, stage, [&](int r, int c, float v) {
        at[c * ldt + r] = __float2bfloat16(v);
      });
      gemm_bf16<true, 1>(doh, ldh, vh, hd, tr, mp, hd, stage,
                         [&](int r, int c, float v) { dp[r * mp + c] = v; });
      __syncthreads();
      // D = rowsum(dP P); dS = P (dP - D) scale over the bf16 P
      for (int r = warp; r < tr; r += kWarps) {
        const float* prow = pf + (size_t)r * mp;
        const float* dprow = dp + (size_t)r * mp;
        float dsum = 0.0f;
        for (int c = lane; c < m; c += 32) dsum += prow[c] * dprow[c];
        dsum = warp_sum(dsum);
        for (int c = lane; c < mp; c += 32)
          pb[(size_t)r * ldp + c] = __float2bfloat16(prow[c] * (dprow[c] - dsum) * a.scale);
        if (r < rows && lane == 0) {
          float* out = a.rs + (((size_t)b * H + h) * a.n + n0 + r) * 3;
          out[0] = rowst[4 * r + 2];
          out[1] = rowst[4 * r + 3];
          out[2] = dsum;
        }
      }
      __syncthreads();
      // dQ_h = dS K_h: fp32 for dbq, bf16 into dQ (all heads) and dQ_h^T
      gemm_bf16<false, 1>(pb, ldp, kh, hd, tr, hd, mp, stage, [&](int r, int c, float v) {
        dqf[r * hd + c] = v;
        const bf16 e = __float2bfloat16(v);
        dqall[r * ld + h * hd + c] = e;
        dqt[c * ldt + r] = e;
      });
      __syncthreads();
      // this head's rows of dWq and dWp^T, and dbq, into the slot
      gemm_acc<false>(dqt, ldt, normed, ld, hd, d, tr, s_dwq + (size_t)h * hd * d, d, first);
      gemm_acc<false>(at, ldt, dys, ld, hd, d, tr, s_dwpt + (size_t)h * hd * d, d, first);
      for (int c = threadIdx.x; c < hd; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < rows; ++r) sum += dqf[r * hd + c];
        s_dbq[h * hd + c] = first ? sum : s_dbq[h * hd + c] + sum;
      }
      __syncthreads();
    }

    // dLN1 = dQ Wq (fp32), over the head scratch
    gemm_bf16<false, 1>(dqall, ld, a.wq, d, tr, d, d, stage,
                        [&](int r, int c, float v) { dn[r * d + c] = v; });
    __syncthreads();
    // column sums: dbp = sum s.dy, dgamma = sum dLN1 * nhat, dbeta = sum dLN1
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sbp = 0.0f, sg = 0.0f, sbe = 0.0f;
      for (int r = 0; r < rows; ++r) {
        sbp += __bfloat162float(dyb[(size_t)r * d + c]) * sc;
        const float nh = (__bfloat162float(xb[(size_t)r * d + c]) - rowst[4 * r]) * rowst[4 * r + 1];
        sg += dn[r * d + c] * nh;
        sbe += dn[r * d + c];
      }
      s_dbp[c] = first ? sbp : s_dbp[c] + sbp;
      s_dg[c] = first ? sg : s_dg[c] + sg;
      s_dbe[c] = first ? sbe : s_dbe[c] + sbe;
    }
    // dx = dy + (dnhat - mean(dnhat) - nhat * mean(dnhat * nhat)) * rstd
    bf16* dxb = a.dx + row0 * d;
    for (int r = warp; r < rows; r += kWarps) {
      const float mean = rowst[4 * r], rstd = rowst[4 * r + 1];
      float m1 = 0.0f, m2 = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float dnh = dn[r * d + c] * a.ln1_w[c];
        const float nh = (__bfloat162float(xb[(size_t)r * d + c]) - mean) * rstd;
        m1 += dnh;
        m2 += dnh * nh;
      }
      m1 = warp_sum(m1) / d;
      m2 = warp_sum(m2) / d;
      for (int c = lane; c < d; c += 32) {
        const float dnh = dn[r * d + c] * a.ln1_w[c];
        const float nh = (__bfloat162float(xb[(size_t)r * d + c]) - mean) * rstd;
        dxb[(size_t)r * d + c] = __float2bfloat16(__bfloat162float(dyb[(size_t)r * d + c]) +
                                                  (dnh - m1 - nh * m2) * rstd);
      }
    }
    __syncthreads();
  }
}

// Launch 2's shared memory: the fp32 sum [mp, hd], the Q_h and dO_h tiles,
// the tile's row statistics, P and dP fp32, and P^T or dS^T bf16.
struct KvSmem {
  size_t acc, qt, dot, rst, p, dp, tt, total;
};

__host__ __device__ inline KvSmem kv_smem(int tq, int mp, int hd) {
  KvSmem s;
  size_t o = 0;
  s.acc = o; o += align128((size_t)mp * hd * 4);
  s.qt = o;  o += align128((size_t)tq * (hd + kPad) * 2);
  s.dot = o; o += align128((size_t)tq * (hd + kPad) * 2);
  s.rst = o; o += align128((size_t)tq * 3 * 4);
  s.p = o;   o += align128((size_t)tq * mp * 4);
  s.dp = o;  o += align128((size_t)tq * mp * 4);
  s.tt = o;  o += align128((size_t)mp * (tq + kPad) * 2);
  s.total = o + kStageBytes;
  return s;
}

__global__ void __launch_bounds__(kThreads) fba_bwd_kv_kernel(BwdArgs a, int tq) {
  extern __shared__ __align__(128) char smem[];
  const int d = a.d, H = a.heads, hd = d / H, m = a.m, mp = (m + 15) & ~15;
  const int ldq = hd + kPad, ldt = tq + kPad;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const bool dv_block = blockIdx.y == 0;
  const KvSmem L = kv_smem(tq, mp, hd);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  bf16* qt = reinterpret_cast<bf16*>(smem + L.qt);
  bf16* dot = reinterpret_cast<bf16*>(smem + L.dot);
  float* rst = reinterpret_cast<float*>(smem + L.rst);
  float* p = reinterpret_cast<float*>(smem + L.p);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  bf16* tt = reinterpret_cast<bf16*>(smem + L.tt);  // P^T (dV block) or dS^T (dK block)
  float* stage = reinterpret_cast<float*>(smem + L.total - kStageBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kh = a.k + ((size_t)b * H + h) * mp * hd;
  const bf16* vh = a.v + ((size_t)b * H + h) * mp * hd;
  const float* rs = a.rs + ((size_t)b * H + h) * a.n * 3;

  for (int n0 = 0; n0 < a.n; n0 += tq) {
    const int rows = min(tq, a.n - n0);
    // rows past N are zero in Q_h and dO_h, with zero statistics: they add nothing
    const size_t off = ((size_t)b * a.n + n0) * d + h * hd;
    load_tile_rows(qt, ldq, a.qs + off, d, rows, tq, hd);
    load_tile_rows(dot, ldq, a.dos + off, d, rows, tq, hd);
    for (int i = threadIdx.x; i < tq * 3; i += kThreads)
      rst[i] = i < rows * 3 ? rs[(size_t)n0 * 3 + i] : 0.0f;
    __syncthreads();
    gemm_bf16<true, 1>(qt, ldq, kh, hd, tq, mp, hd, stage,
                       [&](int r, int c, float v) { p[r * mp + c] = v * a.scale; });
    __syncthreads();
    // P from the saved statistics: no max or sum reductions
    for (int i = threadIdx.x; i < tq * mp; i += kThreads) {
      const int r = i / mp, c = i - r * mp;
      p[i] = c < m ? __expf(fminf(p[i] - rst[3 * r], 0.0f)) * rst[3 * r + 1] : 0.0f;
    }
    __syncthreads();
    if (dv_block) {
      // dV += P^T dO (P rounded to bf16, as the forward's P.V uses it)
      for (int i = threadIdx.x; i < tq * mp; i += kThreads) {
        const int r = i / mp, c = i - r * mp;
        tt[c * ldt + r] = __float2bfloat16(p[i]);
      }
      __syncthreads();
      gemm_acc<false>(tt, ldt, dot, ldq, mp, hd, tq, acc, hd, n0 == 0);
      __syncthreads();
      continue;
    }
    // dP = dO V^T; dS = P (dP - D) scale, transposed; dK += dS^T Q
    gemm_bf16<true, 1>(dot, ldq, vh, hd, tq, mp, hd, stage,
                       [&](int r, int c, float v) { dp[r * mp + c] = v; });
    __syncthreads();
    for (int r = warp; r < tq; r += kWarps) {
      const float dsum = rst[3 * r + 2];
      for (int c = lane; c < mp; c += 32)
        tt[c * ldt + r] = __float2bfloat16(p[r * mp + c] * (dp[r * mp + c] - dsum) * a.scale);
    }
    __syncthreads();
    gemm_acc<false>(tt, ldt, qt, ldq, mp, hd, tq, acc, hd, n0 == 0);
    __syncthreads();
  }

  bf16* out = (dv_block ? a.dv : a.dk) + ((size_t)b * H + h) * m * hd;
  for (int i = threadIdx.x; i < m * hd; i += kThreads) out[i] = __float2bfloat16(acc[i]);
}

// Sum the first `slots` slots in order; dWp is written back from its
// transposed slot layout to torch's [D_out, D_in].
__global__ void fba_reduce_kernel(const float* ws, int slots, int slot_size, int d, float* dwq,
                                  float* dwp, float* dbq, float* dbp, float* dgamma,
                                  float* dbeta) {
  const int dd = d * d, total = 2 * dd + 4 * d;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int g = 0; g < slots; ++g) sum += ws[(size_t)g * slot_size + i];
    if (i < dd) {
      dwq[i] = sum;
    } else if (i < 2 * dd) {
      const int j = (i - dd) / d, c = (i - dd) - j * d;
      dwp[(size_t)c * d + j] = sum;
    } else {
      const int k = i - 2 * dd;
      float* dst[4] = {dbq, dbp, dgamma, dbeta};
      dst[k / d][k % d] = sum;
    }
  }
}

template <typename Smem>
int pick_tile(Smem smem, size_t* bytes) {
  for (int cand : {64, 32, 16}) {
    *bytes = smem(cand);
    if (*bytes <= kSmemLimit) return cand;
  }
  return 0;
}

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. They launch on `stream` and return the
// cudaError_t of the launches (0 on success); no synchronisation.

// Forward: out [B, N, D]; stats [B, N, 2 + 2H] fp32 where not null. K and V
// [B, H, m, hd] contiguous.
extern "C" int mvlt_fba_fwd(const void* x, const void* k, const void* v, const void* ln1_w,
                            const void* ln1_b, const void* wq, const void* bq, const void* wp,
                            const void* bp, const void* s, void* out, void* stats, int batch,
                            int n, int d, int heads, int m, float scale, float eps1,
                            void* stream) {
  using namespace mvlt;
  const int hd = d / heads, mp = (m + 15) & ~15;
  size_t bytes = 0;
  const int tr = pick_tile([&](int t) { return attn_smem(t, d, mp, hd).total; }, &bytes);
  if (!tr) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(fba_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const AttnArgs at{static_cast<const bf16*>(k),      static_cast<const bf16*>(v),
                    static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                    static_cast<const bf16*>(wq),     static_cast<const float*>(bq),
                    static_cast<const bf16*>(wp),     static_cast<const float*>(bp),
                    heads, m, scale, eps1};
  FwdArgs a{static_cast<const bf16*>(x), at, static_cast<const float*>(s),
            static_cast<bf16*>(out), static_cast<float*>(stats), n, d, tr};
  dim3 grid((n + tr - 1) / tr, batch);
  fba_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Floats of one workspace slot of the backward.
extern "C" int mvlt_fba_slot_floats(int d) { return mvlt::slot_floats(d); }

// Backward. K and V [B, H, mp, hd] with mp = m rounded up to 16 and rows
// m..mp zero; stats as the forward wrote them, or null for the recompute
// form; ws holds `slots` slots of mvlt_fba_slot_floats(d) floats (the kernel
// uses min(slots, row tiles) of them); qs, dos [B, N, D] bf16 and rs
// [B, H, N, 3] fp32 are scratch; dk, dv [B, H, m, hd] bf16; the parameter
// gradients fp32, dWq and dWp [D, D] in torch layout.
extern "C" int mvlt_fba_bwd(const void* x, const void* dy, const void* k, const void* v,
                            const void* ln1_w, const void* ln1_b, const void* wq,
                            const void* bq, const void* wp, const void* s, const void* stats,
                            void* dx, void* ws, int slots, void* qs, void* dos, void* rs,
                            void* dk, void* dv, void* dwq, void* dbq, void* dwp, void* dbp,
                            void* dgamma, void* dbeta, int batch, int n, int d, int heads,
                            int m, float scale, float eps1, void* stream) {
  using namespace mvlt;
  const int hd = d / heads, mp = (m + 15) & ~15;
  size_t rows_bytes = 0, kv_bytes = 0;
  const int tr = pick_tile([&](int t) { return rows_smem(t, d, hd, mp).total; }, &rows_bytes);
  const int tq = pick_tile([&](int t) { return kv_smem(t, mp, hd).total; }, &kv_bytes);
  if (!tr || !tq || slots < 1) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      fba_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fba_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (long long)batch * ((n + tr - 1) / tr);
  const int used = (int)(ntiles < slots ? ntiles : slots);
  BwdArgs a{static_cast<const bf16*>(x),     static_cast<const bf16*>(dy),
            static_cast<const bf16*>(k),     static_cast<const bf16*>(v),
            static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
            static_cast<const bf16*>(wq),    static_cast<const float*>(bq),
            static_cast<const bf16*>(wp),    static_cast<const float*>(s),
            static_cast<const float*>(stats), static_cast<bf16*>(dx),
            static_cast<float*>(ws),         static_cast<bf16*>(qs),
            static_cast<bf16*>(dos),         static_cast<float*>(rs),
            static_cast<bf16*>(dk),          static_cast<bf16*>(dv),
            batch, n, d, heads, m, tr, slot_floats(d), scale, eps1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fba_bwd_rows_kernel<<<used, kThreads, rows_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fba_bwd_kv_kernel<<<dim3(batch * heads, 2), kThreads, kv_bytes, st>>>(a, tq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = 2 * d * d + 4 * d;
  fba_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), used, slot_floats(d), d, static_cast<float*>(dwq),
      static_cast<float*>(dwp), static_cast<float*>(dbq), static_cast<float*>(dbp),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}
