// Attention core of PVLT training, forward and backward, on Hopper's
// warpgroup matrix multiply (wgmma):
//   o = softmax(q k^T * scale) v,  lse = logsumexp(q k^T * scale)
// and the gradients dq, dk, dv, for q [B, H, N, hd] against a whole small
// K/V [B, H, M, hd] (M = 192 at every pvlt_tiny stage at 256 input, 177 at
// 224; hd = 64 at every stage, 32 also taken).
//
// Replaces: mvlt_tpu/ops/pallas_attention.py:_fused_attention_impl (:184,
// forward, Pallas body _attn_kernel) and _fused_attention_bwd (:118, Pallas
// body _attn_bwd_kernel). Same function without their TPU layout (no
// 128-lane head padding, no M padding to 128, exact M under a mask); the
// forward also writes lse, and the backward takes o and lse instead of
// recomputing the softmax statistics.
//
// What bounds it on the H100: at B = 150 the forward's products are
// 4.N.M.hd flops per head (31 GFLOP at stage 1, 31 us at 989 TFLOP/s)
// against q, o and K/V once (170 MB, 51 us at 3.35 TB/s): memory, on paper.
// In practice the softmax's per-logit work (max, fma, ex2, sum, bf16
// packing: 12,288 logits a 64-row tile, about 5 instructions each) and the
// chain S -> softmax -> P.V of each tile bound it: the tensor cores idle
// while a warpgroup exponentiates. The backward does 2.5x the products
// against q, dO, dq and K/V, dK/dV once: on the line between the two, and
// bound the same way by its elementwise work and the chain of five
// products per tile. No logits, probabilities or dS reach device memory.
//
// Forward (attn_fwd_hopper_kernel, 2 warpgroups, 2 blocks an SM). One block
// owns one (sample, head) and a run of 64-row q tiles, the two warpgroups
// taking alternate tiles and, with K/V resident, running apart (barriers
// per warpgroup), so one's softmax overlaps the other's products. It
// stages the head's K and V once in shared memory (48 KB at M = 192),
// swizzled as wgmma reads them; where 2.M.hd does not fit, it stages them
// in windows per tile pair. Q tiles stream through a 2-stage ring per
// warpgroup by cp.async (16 bytes a thread, zero-filled past N), the next
// tile's copy in flight while this one multiplies. Per 64-column chunk of
// K/V: S = Q K^T on wgmma (both operands K-major from shared memory), the
// softmax in registers (row max and sum over the 4 threads of a row by
// shuffles, the scale and log2(e) folded into one fma before ex2.approx,
// columns >= M masked to -inf on the last chunk, the running sum and
// output rescaled when a later chunk raises the row max), P rounded to
// bf16 in registers and O += P V on wgmma with A from registers and V
// MN-major. The next chunk's S is issued ahead of this chunk's P.V, so P.V
// runs while the next softmax takes its max and exponentials. O / l
// leaves through the tile's ring slot as 16-byte row stores, lse as fp32.
// q and o are the strided [B, N, H, hd] views the step passes. In its
// statistics mode (Stats, the fused attention forward's #7) it also writes
// each row's final max and 1/l, in natural units, into the row's head
// columns of the [B, N, 2 + 2H] statistics. The chains of kernels B and C
// and the fused attention forward (attn_chain.cuh) launch it under their
// route tags (common.cuh) through mvlt_attention_fwd_route.
//
// Backward (attn_bwd_hopper_kernel, 3 warpgroups, 1 block an SM). One block
// owns one (sample, head), a range of q tiles, and the whole K/V of the head
// in shared memory, in groups of 3 slices of 64 rows (one group at
// M <= 192; larger M walks the tiles once per group). Warpgroup w keeps its
// slice's dK_w and dV_w in fp32 registers over every tile; per tile, in
// two halves of 32 q columns (so that S^T and dP^T, 16 values a thread
// each, fit beside dK_w and dV_w without spilling):
//   S^T_w = K_w Q^T and dP^T_w = V_w dO^T (both from shared memory),
//   P^T_w = exp2(S^T_w scale log2e - lse[q] log2e), rows >= M zero (the
//     product accumulates onto -lse / scale, as dP^T_w onto -Dq),
//   dV_w += P^T_w dO (A = P from registers),
//   dS^T_w = P^T_w (dP^T_w - Dq) scale, Dq = rowsum(dO o O) from the tile,
//   dK_w += dS^T_w Q (A = dS from registers),
// then dQ_w = dS_w K_w (dS^T_w through shared memory, MN-major),
// and the three dQ_w sum in a fixed order into the tile's dq rows (each q
// row belongs to one block: no atomics). Q, dO and O tiles stream through
// a 2-stage cp.async ring. To fill 132 SMs when B.H is small the host
// splits N into `splits` ranges (ops/pallas_attention.py: plan_splits);
// each range writes fp32 dK/dV into its own slot and
// attn_bwd_slot_sum_kernel adds the slots in order: deterministic. With
// one split the block writes bf16 directly. No producer warp: the
// consumers issue their own cp.async copies, and the wgmma descriptors are
// rebuilt per tile from an opaque base rather than held in registers.
//
// ptxas (sm_90a, nvcc 12.9; chip_smoke.py's build phase prints them):
// forward 126 registers at hd = 64, 121 at 32; backward 163 and 154 (of
// 168 at 384 threads); the slot sum 32; no spills anywhere.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mvlt {
namespace {

using namespace hopper;

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;            // q rows of a tile, K/V rows of a slice (wgmma M)
constexpr int kSlices = 3;           // K/V slices of a backward group (its warpgroups)
constexpr int kGroupRows = kSlices * kTile;
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128 * kSlices;

struct View {
  long long sb, sh, sn;  // element strides of batch, head and row
};

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  View vq, vk, vv, vo;
  int heads, n, m, tiles, per_block, win;  // win: K/V rows staged at once
  float scale_log2;
  float* stats;  // Stats: [B, N, stats_ld] fp32, head h's (max, 1/l) at column 2 + 2h
  int stats_ld;
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* slots;   // [splits][2][B.H.M.hd] fp32 dK, dV partials (splits > 1)
  float* dq_acc;  // [B.H.N.hd] fp32 dq of earlier K/V groups (M > 192)
  View vq, vk, vv, vo, vdo, vdq;
  int heads, n, m, tiles, splits;
  float scale, scale_log2;
};

__host__ __device__ constexpr size_t fwd_smem(int win, int rb) {
  return 1024 + 2 * (size_t)win * rb + 4 * (size_t)kTile * rb;
}

__host__ __device__ constexpr size_t bwd_smem(int hd) {
  return 1024 + 2 * (size_t)kGroupRows * hd * 2 + 6 * (size_t)kTile * hd * 2 +
         (size_t)kSlices * kTile * 128 + (size_t)kSlices * kTile * (hd + 4) * 4 +
         4 * (size_t)kTile * 4;
}

// Fixed: lse is the input, the rows' natural logsumexp (fused attention
// backward, statistics form): P = exp(S scale - lse) directly, with no row
// max, rescale or sum, and o = P V is not divided. Stats (never with Fixed):
// the row's max of the scaled logits and 1/l also go to a.stats. Route: the
// path that launched it (common.cuh), for profiles.
template <int HD, bool Fixed, bool Stats, class Route>
__global__ void __launch_bounds__(kFwdThreads, 2) attn_fwd_hopper_kernel(FwdArgs a) {
  static_assert(!(Fixed && Stats), "the statistics come from the softmax reductions");
  constexpr int RB = HD * 2, CH = RB / 16, NA = HD / 2;
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int tile0 = blockIdx.x * a.per_block, tile1 = min(a.tiles, tile0 + a.per_block);
  const int mpad = (a.m + kTile - 1) & ~(kTile - 1), nwin = (mpad + a.win - 1) / a.win;
  // K window [win][RB] | V window [win][RB] | Q ring [2 warpgroups][2 stages][64][RB]
  const uint32_t s_k = smem_u32(smem), s_v = s_k + a.win * RB;
  char* ring = smem + 2 * a.win * RB + wg * 2 * kTile * RB;
  const uint32_t s_ring = smem_u32(ring);
  const bf16* qb = a.q + b * a.vq.sb + h * a.vq.sh;
  const bf16* kb = a.k + b * a.vk.sb + h * a.vk.sh;
  const bf16* vb = a.v + b * a.vv.sb + h * a.vv.sh;
  bf16* ob = a.o + b * a.vo.sb + h * a.vo.sh;

  auto load_q = [&](int tile, int stage) {
    for (int i = t; i < kTile * CH; i += 128) {
      const int r = i / CH, c = i % CH, row = tile * kTile + r;
      const bool ok = tile < tile1 && row < a.n;
      cp_async16_zfill(s_ring + stage * kTile * RB + tile_off<RB>(r, c),
                       ok ? qb + row * a.vq.sn + c * 8 : qb, ok);
    }
  };
  auto load_kv = [&](int first) {  // rows first .. first + win, zeros past M
    for (int i = tid; i < a.win * CH; i += kFwdThreads) {
      const int r = i / CH, c = i % CH, row = first + r;
      const bool ok = row < a.m;
      cp_async16_zfill(s_k + tile_off<RB>(r, c), ok ? kb + row * a.vk.sn + c * 8 : kb, ok);
      cp_async16_zfill(s_v + tile_off<RB>(r, c), ok ? vb + row * a.vv.sn + c * 8 : vb, ok);
    }
  };

  const int iters = (tile1 - tile0 + 1) / 2;
  if (nwin == 1) load_kv(0);
  load_q(tile0 + wg, 0);
  cp_async_commit();
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);  // rows r0, r0 + 8
  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1, tile = tile0 + 2 * it + wg;
    cp_async_wait<0>();
    fence_proxy_async();
    // this tile's Q is in (and, the first time, K/V); the warpgroup is past
    // its last tile. With K/V resident the two warpgroups run apart.
    if (it == 0 || nwin > 1)
      __syncthreads();
    else
      named_barrier(1 + wg, 128);
    if (it + 1 < iters) {
      load_q(tile + 2, stage ^ 1);
      cp_async_commit();
    }
    const bool active = tile < tile1;
    const uint32_t sq = s_ring + stage * kTile * RB;
    float o[NA], m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NA; ++i) o[i] = 0.0f;
    if (Fixed) {  // lse in log2 units; +inf past N gives P = 0
      const int row = tile * kTile + r0;
      const float* lrow = a.lse + (size_t)bh * a.n;
      m0 = active && row < a.n ? lrow[row] * kLog2e : INFINITY;
      m1 = active && row + 8 < a.n ? lrow[row + 8] * kLog2e : INFINITY;
    }
    for (int w = 0; w < nwin; ++w) {
      if (nwin > 1) {
        __syncthreads();
        load_kv(w * a.win);
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        __syncthreads();
      }
      if (!active) continue;
      const int rows = min(a.win, mpad - w * a.win);
      // S of the next chunk is issued ahead of P.V of this one, so P.V runs
      // while the next chunk's softmax takes its max and exponentials
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0, 0>(s, make_desc<RB>(sq + kk * 32), make_desc<RB>(s_k + kk * 32), kk);
      wgmma_commit();
      for (int c0 = 0; c0 < rows; c0 += kTile) {
        if (c0 == 0)
          wgmma_wait<0>();
        else
          wgmma_wait<1>();  // this chunk's S; the last chunk's P.V may still run
        fence_regs(s);
        const int col0 = w * a.win + c0;  // the K/V row of this chunk's column 0
        if (col0 + kTile > a.m) {  // the last chunk: columns past M out
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (col0 + 8 * (i >> 2) + cq + (i & 1) >= a.m) s[i] = -INFINITY;
        }
        float a0 = 1.0f, a1 = 1.0f;
        if (!Fixed) {
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
          // the scale (> 0) goes into the exponent's fma: max of the raw logits
          const float mn0 = fmaxf(m0, x0 * a.scale_log2), mn1 = fmaxf(m1, x1 * a.scale_log2);
          a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
          m0 = mn0;
          m1 = mn1;
        }
        const float mn0 = m0, mn1 = m1;
        float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[4 * j] = fast_exp2(fmaf(s[4 * j], a.scale_log2, -mn0));
          s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], a.scale_log2, -mn0));
          s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], a.scale_log2, -mn1));
          s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], a.scale_log2, -mn1));
          p0 += s[4 * j] + s[4 * j + 1];
          p1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * a0 + p0;
        l1 = l1 * a1 + p1;
        wgmma_wait<0>();  // the last chunk's P.V is done: o may be rescaled
        fence_regs(o);
        if (!Fixed) {
#pragma unroll
          for (int j = 0; j < NA / 4; ++j) {
            o[4 * j] *= a0;
            o[4 * j + 1] *= a0;
            o[4 * j + 2] *= a1;
            o[4 * j + 3] *= a1;
          }
        }
        uint32_t p[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(s, kk, p[kk]);
          fence_regs(p[kk]);
        }
        fence_regs(o);
        wgmma_fence();
        if (c0 + kTile < rows) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<0, 0>(s, make_desc<RB>(sq + kk * 32),
                           make_desc<RB>(s_k + (c0 + kTile) * RB + kk * 32), kk);
          wgmma_commit();
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(o, p[kk], make_desc<RB>(s_v + (c0 + 16 * kk) * RB), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(o);
    }
    char* st = ring + stage * kTile * RB;  // the tile's ring slot holds O on the way out
    if (active) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float i0 = Fixed ? 1.0f : 1.0f / l0, i1 = Fixed ? 1.0f : 1.0f / l1;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        *reinterpret_cast<uint32_t*>(st + tile_off<RB>(r0, j) + cq * 2) =
            pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        *reinterpret_cast<uint32_t*>(st + tile_off<RB>(r0 + 8, j) + cq * 2) =
            pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
      if (!Fixed && (lane & 3) == 0) {
        float* lrow = a.lse + (size_t)bh * a.n + tile * kTile;
        if (tile * kTile + r0 < a.n) lrow[r0] = (m0 + log2f(l0)) * kLn2;
        if (tile * kTile + r0 + 8 < a.n) lrow[r0 + 8] = (m1 + log2f(l1)) * kLn2;
        if (Stats) {  // the max in natural units (m is in log2 units), 1/l
          float* srow = a.stats + ((size_t)b * a.n + tile * kTile + r0) * a.stats_ld + 2 + 2 * h;
          if (tile * kTile + r0 < a.n)
            *reinterpret_cast<float2*>(srow) = make_float2(m0 * kLn2, i0);
          if (tile * kTile + r0 + 8 < a.n)
            *reinterpret_cast<float2*>(srow + 8 * a.stats_ld) = make_float2(m1 * kLn2, i1);
        }
      }
    }
    named_barrier(1 + wg, 128);
    if (active) {
      for (int i = t; i < kTile * CH; i += 128) {
        const int r = i / CH, c = i % CH, row = tile * kTile + r;
        if (row < a.n)
          *reinterpret_cast<uint4*>(ob + row * a.vo.sn + c * 8) =
              *reinterpret_cast<const uint4*>(st + tile_off<RB>(r, c));
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1) attn_bwd_hopper_kernel(BwdArgs a) {
  constexpr int RB = HD * 2, CH = RB / 16, NA = HD / 2, LDR = HD + 4;
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int tile0 = split * a.tiles / a.splits, tile1 = (split + 1) * a.tiles / a.splits;
  const int groups = (a.m + kGroupRows - 1) / kGroupRows;
  // K [192][RB] | V [192][RB] | Q, dO and O rings [2][64][RB] each
  // | dS^T [3][64 rows of M][64 q, 128 B] | dQ partials fp32 [3][64][LDR]
  // | Dq [2][64] | lse [2][64]
  const uint32_t s_k = smem_u32(smem), s_v = s_k + kGroupRows * RB;
  const uint32_t s_q = s_v + kGroupRows * RB, s_do = s_q + 2 * kTile * RB;
  const uint32_t s_o = s_do + 2 * kTile * RB, s_ds = s_o + 2 * kTile * RB;
  char* do_gen = smem + (s_do - s_k);
  char* o_gen = smem + (s_o - s_k);
  char* ds_gen = smem + (s_ds - s_k) + wg * kTile * 128;
  float* red = reinterpret_cast<float*>(smem + (s_ds - s_k) + kSlices * kTile * 128);
  float* dq_s = red + kSlices * kTile * LDR;
  float* lse_s = dq_s + 2 * kTile;
  const bf16* qb = a.q + b * a.vq.sb + h * a.vq.sh;
  const bf16* dob = a.dout + b * a.vdo.sb + h * a.vdo.sh;
  const bf16* ob = a.o + b * a.vo.sb + h * a.vo.sh;
  const bf16* kb = a.k + b * a.vk.sb + h * a.vk.sh;
  const bf16* vb = a.v + b * a.vv.sb + h * a.vv.sh;
  bf16* dqb = a.dq + b * a.vdq.sb + h * a.vdq.sh;
  const size_t count = (size_t)gridDim.y * a.m * HD;  // elements of dK (and of dV)

  auto load_tile = [&](int tile, int stage) {  // Q, dO and O rows, zeros past N
    for (int i = tid; i < kTile * CH; i += kBwdThreads) {
      const int r = i / CH, c = i % CH, row = tile * kTile + r;
      const bool ok = row < a.n;
      const uint32_t off = stage * kTile * RB + tile_off<RB>(r, c);
      cp_async16_zfill(s_q + off, ok ? qb + row * a.vq.sn + c * 8 : qb, ok);
      cp_async16_zfill(s_do + off, ok ? dob + row * a.vdo.sn + c * 8 : dob, ok);
      cp_async16_zfill(s_o + off, ok ? ob + row * a.vo.sn + c * 8 : ob, ok);
    }
  };
  auto load_kv = [&](int first) {  // rows first .. first + 192, zeros past M
    for (int i = tid; i < kGroupRows * CH; i += kBwdThreads) {
      const int r = i / CH, c = i % CH, row = first + r;
      const bool ok = row < a.m;
      cp_async16_zfill(s_k + tile_off<RB>(r, c), ok ? kb + row * a.vk.sn + c * 8 : kb, ok);
      cp_async16_zfill(s_v + tile_off<RB>(r, c), ok ? vb + row * a.vv.sn + c * 8 : vb, ok);
    }
  };

  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);  // rows r0, r0 + 8
  const float inv_scale_log2 = 1.0f / a.scale_log2;
  for (int g = 0; g < groups; ++g) {
    const int first = g * kGroupRows;
    const int slices = min(kSlices, (a.m - first + kTile - 1) / kTile);
    const bool active = wg < slices;
    const int mrow = first + wg * kTile + r0;  // this thread's K/V rows mrow, mrow + 8
    float dk[NA], dv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.0f;
    load_kv(first);
    load_tile(tile0, 0);
    cp_async_commit();
    for (int tile = tile0; tile < tile1; ++tile) {
      const int stage = (tile - tile0) & 1;
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // the tile is in; every thread is past the last tile
      if (tile + 1 < tile1) {
        load_tile(tile + 1, stage ^ 1);
        cp_async_commit();
      }
      if (tid < 4 * kTile) {  // Dq = rowsum(dO o O) and lse in log2 units, per q row
        const int r = tid >> 2, part = tid & 3, row = tile * kTile + r;
        float acc = 0.0f;  // rows past N are zeros
#pragma unroll
        for (int c = part * CH / 4; c < (part + 1) * CH / 4; ++c) {
          const uint32_t off = stage * kTile * RB + tile_off<RB>(r, c);
          const uint4 ov = *reinterpret_cast<const uint4*>(o_gen + off);
          const uint4 dv4 = *reinterpret_cast<const uint4*>(do_gen + off);
          const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&dv4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fx = __bfloat1622float2(x[e]), fy = __bfloat1622float2(y[e]);
            acc += fx.x * fy.x + fx.y * fy.y;
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (part == 0) {
          dq_s[stage * kTile + r] = acc;
          lse_s[stage * kTile + r] =
              row < a.n ? a.lse[(size_t)bh * a.n + row] * kLog2e : INFINITY;
        }
      }
      __syncthreads();
      if (active) {
        // this warpgroup's K/V slice and the tile's Q and dO, from an opaque
        // base: the descriptors are rebuilt per tile, not held in registers
        const uint32_t base = opaque(s_k);
        const uint32_t kw = base + wg * kTile * RB, vw = kw + (s_v - s_k);
        const uint32_t sq = base + (s_q - s_k) + stage * kTile * RB;
        const uint32_t sdo = sq + (s_do - s_q);
        const float* lse2 = lse_s + stage * kTile;
        const float* dqv = dq_s + stage * kTile;
        // The q tile in two halves of 32 columns, so that S^T, dP^T (16
        // values a thread each) sit beside dK_w and dV_w without spilling.
        // The accumulators start at -lse[q] / scale and -Dq[q]: the products
        // land on S^T_w - lse / scale and dP^T_w - Dq.
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const int q0 = 32 * half;
          float s[16], dp[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = q0 + 8 * (i >> 2) + cq + (i & 1);
            s[i] = -lse2[col] * inv_scale_log2;
            dp[i] = -dqv[col];
          }
          fence_regs(s);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<0, 0>(s, make_desc<RB>(kw + kk * 32),
                           make_desc<RB>(sq + q0 * RB + kk * 32), 1);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<0, 0>(dp, make_desc<RB>(vw + kk * 32),
                           make_desc<RB>(sdo + q0 * RB + kk * 32), 1);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
          // P^T: rows of M (zero past M), columns q (lse = inf past N gives 0)
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const bool ok = mrow + 8 * ((i >> 1) & 1) < a.m;
            const float x = fast_exp2(s[i] * a.scale_log2);
            s[i] = ok ? x : 0.0f;
          }
          uint32_t pa[2][4];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            acc_to_a(s, kk, pa[kk]);
            fence_regs(pa[kk]);
          }
          fence_regs(dv);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_rs<1>(dv, pa[kk], make_desc<RB>(sdo + (q0 + 16 * kk) * RB), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dp);
          fence_regs(dv);
          // dS^T = P^T (dP^T - Dq) scale
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i] = s[i] * dp[i] * a.scale;
          uint32_t da[2][4];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            acc_to_a(s, kk, da[kk]);
            fence_regs(da[kk]);
          }
          fence_regs(dk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_rs<1>(dk, da[kk], make_desc<RB>(sq + (q0 + 16 * kk) * RB), 1);
          wgmma_commit();
          // dS^T_w to shared memory (rows of M, 64 q columns) for dQ_w = dS_w K_w
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int chunk = 4 * half + j;
            *reinterpret_cast<uint32_t*>(ds_gen + tile_off<128>(r0, chunk) + cq * 2) =
                da[j >> 1][2 * (j & 1)];
            *reinterpret_cast<uint32_t*>(ds_gen + tile_off<128>(r0 + 8, chunk) + cq * 2) =
                da[j >> 1][2 * (j & 1) + 1];
          }
          wgmma_wait<0>();
          fence_regs(dk);
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        float dqp[NA];
        const uint32_t sds = base + (s_ds - s_k) + wg * kTile * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(dqp, make_desc<128>(sds + 16 * kk * 128),
                         make_desc<RB>(kw + 16 * kk * RB), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqp);
        fence_regs(dk);
        fence_regs(dv);
        float* part = red + wg * kTile * LDR;
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          *reinterpret_cast<float2*>(part + r0 * LDR + 8 * j + cq) =
              make_float2(dqp[4 * j], dqp[4 * j + 1]);
          *reinterpret_cast<float2*>(part + (r0 + 8) * LDR + 8 * j + cq) =
              make_float2(dqp[4 * j + 2], dqp[4 * j + 3]);
        }
      }
      __syncthreads();
      // dq rows of the tile: the slices' partials in order, after the earlier groups'
      for (int i = tid; i < kTile * HD / 8; i += kBwdThreads) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, row = tile * kTile + r;
        if (row >= a.n) continue;
        float acc[8];
        float* prev = a.dq_acc + ((size_t)bh * a.n + row) * HD + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = g > 0 ? prev[e] : 0.0f;
        for (int w = 0; w < slices; ++w) {
          const float* src = red + (w * kTile + r) * LDR + c;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += src[e];
        }
        if (g + 1 < groups) {
#pragma unroll
          for (int e = 0; e < 8; ++e) prev[e] = acc[e];
        } else {
          uint4 out;
          uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int e = 0; e < 4; ++e) ow[e] = pack_bf16(acc[2 * e], acc[2 * e + 1]);
          *reinterpret_cast<uint4*>(dqb + row * a.vdq.sn + c) = out;
        }
      }
    }
    // this group's dK and dV rows: bf16, or fp32 into this split's slot
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mrow + 8 * half;
        if (row >= a.m) continue;
        const size_t base = ((size_t)bh * a.m + row) * HD;
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          const int col = 8 * j + cq, i = 4 * j + 2 * half;
          if (a.splits == 1) {
            *reinterpret_cast<uint32_t*>(a.dk + base + col) = pack_bf16(dk[i], dk[i + 1]);
            *reinterpret_cast<uint32_t*>(a.dv + base + col) = pack_bf16(dv[i], dv[i + 1]);
          } else {
            float* slot = a.slots + (size_t)split * 2 * count + base + col;
            *reinterpret_cast<float2*>(slot) = make_float2(dk[i], dk[i + 1]);
            *reinterpret_cast<float2*>(slot + count) = make_float2(dv[i], dv[i + 1]);
          }
        }
      }
    }
  }
}

// dK, dV = the splits' fp32 slots summed in split order, to bf16; 4 values a
// thread over dK then dV.
__global__ void attn_bwd_slot_sum_kernel(const float* slots, bf16* dk, bf16* dv, int splits,
                                         long long count) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= 2 * count) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(slots + s * 2 * count + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* out = i < count ? dk + i : dv + (i - count);
  uint2 packed = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  *reinterpret_cast<uint2*>(out) = packed;
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }


// The device's SM count, and letting `kernel` take all of an SM's shared
// memory there; each asked of the runtime once per device.
int sm_count(int dev) {
  static int cached_dev = -1, sms = 0;
  if (dev != cached_dev) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached_dev = dev;
  }
  return sms;
}

// `cached_dev` is the caller's own (one per kernel instantiation).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int dev, int& cached_dev) {
  if (dev == cached_dev) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  if (err == cudaSuccess) cached_dev = dev;
  return err;
}

template <int HD, bool Fixed, bool Stats, class Route>
int launch_fwd(FwdArgs a, int batch, cudaStream_t stream) {
  constexpr int RB = HD * 2;
  const int mpad = (a.m + kTile - 1) & ~(kTile - 1);
  a.win = mpad;
  if (fwd_smem(a.win, RB) > kSmemLimit)
    a.win = (int)((kSmemLimit - fwd_smem(0, RB)) / (2 * RB)) & ~(kTile - 1);
  const size_t bytes = fwd_smem(a.win, RB);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static int smem_dev = -1;
  if (err == cudaSuccess)
    err = allow_smem(attn_fwd_hopper_kernel<HD, Fixed, Stats, Route>, dev, smem_dev);
  if (err != cudaSuccess) return (int)err;
  // an even run of q tiles per block, about 8 blocks an SM over the grid
  const long long bhs = (long long)batch * a.heads, sms = max(1, sm_count(dev));
  int per = (int)((a.tiles * bhs + 8 * sms - 1) / (8 * sms));
  per = min(max(2, (per + 1) & ~1), (a.tiles + 1) & ~1);
  a.per_block = per;
  dim3 grid((a.tiles + per - 1) / per, (unsigned)bhs);
  attn_fwd_hopper_kernel<HD, Fixed, Stats, Route><<<grid, kFwdThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const BwdArgs& a, int batch, cudaStream_t stream) {
  const size_t bytes = bwd_smem(HD);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static int smem_dev = -1;
  if (err == cudaSuccess) err = allow_smem(attn_bwd_hopper_kernel<HD>, dev, smem_dev);
  if (err != cudaSuccess) return (int)err;
  const long long bhs = (long long)batch * a.heads;
  attn_bwd_hopper_kernel<HD><<<dim3(a.splits, (unsigned)bhs), kBwdThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const long long count = bhs * a.m * HD, threads = 256, quads = 2 * count / 4;
  attn_bwd_slot_sum_kernel<<<(unsigned)((quads + threads - 1) / threads), (unsigned)threads, 0,
                             stream>>>(a.slots, a.dk, a.dv, a.splits, count);
  return (int)cudaGetLastError();
}

// route 0: #10 itself (fixed picks the Fixed form); FbaFwdRoute::kAttn
// (with or without statistics), BlockFusedRoute::kAttn and
// BlockAttentionRoute::kAttn: the chains'.
template <int HD>
int fwd_on_route(const FwdArgs& a, int batch, bool fixed, int route, cudaStream_t st) {
  if (route == FbaFwdRoute::kAttn)
    return a.stats ? launch_fwd<HD, false, true, FbaFwdRoute>(a, batch, st)
                   : launch_fwd<HD, false, false, FbaFwdRoute>(a, batch, st);
  if (route == BlockFusedRoute::kAttn)
    return launch_fwd<HD, false, false, BlockFusedRoute>(a, batch, st);
  if (route == BlockAttentionRoute::kAttn)
    return launch_fwd<HD, false, false, BlockAttentionRoute>(a, batch, st);
  return fixed ? launch_fwd<HD, true, false, AttnRoute>(a, batch, st)
               : launch_fwd<HD, false, false, AttnRoute>(a, batch, st);
}

int attention_fwd(const void* q, const void* k, const void* v, void* o, const void* lse,
                  const long long* strides, int batch, int heads, int n, int m, int hd,
                  float scale, bool fixed, int route, float* stats, int stats_ld,
                  cudaStream_t st) {
  if ((route != 0 && route != FbaFwdRoute::kAttn && route != BlockFusedRoute::kAttn &&
       route != BlockAttentionRoute::kAttn) ||
      (stats && route != FbaFwdRoute::kAttn) || (stats && (stats_ld < 2 || stats_ld % 2)))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o),
            static_cast<float*>(const_cast<void*>(lse)), view(strides), view(strides + 3),
            view(strides + 6), view(strides + 9), heads, n, m, (n + kTile - 1) / kTile, 0, 0,
            scale * kLog2e, stats, stats_ld};
  if (hd == 64) return fwd_on_route<64>(a, batch, fixed, route, st);
  if (hd == 32) return fwd_on_route<32>(a, batch, fixed, route, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. Each [B, H, rows, hd] tensor comes with three
// element strides (batch, head, row); the last dimension is contiguous, rows
// start on 16 bytes. lse is fp32 [B, H, N]; dk and dv are contiguous. hd is
// 32 or 64. They launch on `stream` and return the cudaError_t of the launch
// (0 on success); no synchronisation.
extern "C" int mvlt_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  const long long* strides, int batch, int heads, int n, int m,
                                  int hd, float scale, void* stream) {
  return mvlt::attention_fwd(q, k, v, o, lse, strides, batch, heads, n, m, hd, scale, false, 0,
                             nullptr, 0, static_cast<cudaStream_t>(stream));
}

// The same on a chain's route (attn_chain.cuh): `route` FbaFwdRoute::kAttn
// (1), BlockFusedRoute::kAttn (2) or BlockAttentionRoute::kAttn (3). Where
// `stats` is not null (route 1 only), each row's max of the scaled logits
// (natural units) and 1/l go to stats[(b * n + row) * stats_ld + 2 + 2h] and
// + 1 ([B, N, stats_ld] fp32, stats_ld even).
extern "C" int mvlt_attention_fwd_route(const void* q, const void* k, const void* v, void* o,
                                        void* lse, void* stats, const long long* strides,
                                        int batch, int heads, int n, int m, int hd, int stats_ld,
                                        int route, float scale, void* stream) {
  return mvlt::attention_fwd(q, k, v, o, lse, strides, batch, heads, n, m, hd, scale, false,
                             route, static_cast<float*>(stats), stats_ld,
                             static_cast<cudaStream_t>(stream));
}

// The same with the rows' lse [B, H, N] given (natural log, as the forward
// writes it): o = exp(q k^T scale - lse) v, no softmax reductions (the fused
// attention backward's statistics form, csrc/block_attention_train.cu).
extern "C" int mvlt_attention_fwd_from_lse(const void* q, const void* k, const void* v, void* o,
                                           const void* lse, const long long* strides, int batch,
                                           int heads, int n, int m, int hd, float scale,
                                           void* stream) {
  return mvlt::attention_fwd(q, k, v, o, lse, strides, batch, heads, n, m, hd, scale, true, 0,
                             nullptr, 0, static_cast<cudaStream_t>(stream));
}

// `splits` (1 .. the q tiles) ranges of q tiles per (sample, head); with more
// than one, `slots` holds 2 * splits * B * H * M * hd floats. `dq_acc` holds
// B * H * N * hd floats where M > 192, else may be null.
extern "C" int mvlt_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                  void* slots, void* dq_acc, const long long* strides, int batch,
                                  int heads, int n, int m, int hd, int splits, float scale,
                                  void* stream) {
  using namespace mvlt;
  const int tiles = (n + kTile - 1) / kTile;
  if (splits < 1 || splits > tiles) return (int)cudaErrorInvalidValue;
  BwdArgs a{static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
            static_cast<const bf16*>(v),   static_cast<const bf16*>(o),
            static_cast<const bf16*>(dout), static_cast<const float*>(lse),
            static_cast<bf16*>(dq),        static_cast<bf16*>(dk),
            static_cast<bf16*>(dv),        static_cast<float*>(slots),
            static_cast<float*>(dq_acc),   view(strides),
            view(strides + 3),             view(strides + 6),
            view(strides + 9),             view(strides + 12),
            view(strides + 15),            heads,
            n,                             m,
            tiles,                         splits,
            scale,                         scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_bwd<64>(a, batch, st);
  if (hd == 32) return launch_bwd<32>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}
