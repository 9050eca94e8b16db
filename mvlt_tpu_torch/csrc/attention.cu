// Attention core of PVLT training, forward and backward:
//   o = softmax(q k^T * scale) v
// for q [B, H, N, hd] against a whole small K/V [B, H, M, hd] (M = 192 at
// every pvlt_tiny stage after spatial reduction).
//
// Replaces: mvlt_tpu/ops/pallas_attention.py:_fused_attention_impl (forward,
// Pallas body _attn_kernel) and _fused_attention_bwd (Pallas body
// _attn_bwd_kernel). Same function without their TPU layout: no 128-lane
// head padding, no M padding to 128, exact M with a masked softmax.
//
// What bounds it on the H100: the forward reads q and K/V once and writes o
// once; its products are 4.N.M.hd flops per head, about 31 GFLOP at stage 1,
// B = 150, against 170 MB of bytes -- memory-bound (51 us at 3.35 TB/s). The
// backward reads q, K, V and dO, writes dq, dK and dV, and does about 2.5x the
// forward's products: also close to the line. Neither materialises the
// [N, M] probabilities in device memory.
//
// Design. Tensors are addressed through (batch, head, row) element strides
// with a contiguous last dimension, so q/K/V taken as views of the
// projections' outputs need no copy. K and V are read by the tensor-core
// fragments straight from global memory (they stay in L2: 48 KB per head);
// the wrapper pads them to a multiple of 16 rows only where M is not one.
// Forward: one block of 8 warps per (batch*head, q tile of TQ rows): Q tile
// -> fp32 logits -> fp32 softmax masked past M -> bf16 P -> P.V, written
// straight to o. Backward: a TPU grid carries dK/dV from one q tile to the
// next in scratch (a sequential grid axis); here a block loops over all q
// tiles of one (batch, head) and keeps the fp32 sum in shared memory, so no
// atomics and the result is deterministic. The grid's second axis splits the
// work in two blocks per (batch, head), which run concurrently: block 0
// recomputes P and sums dV = P^T dO; block 1 recomputes P, forms
// dP = dO V^T, dS = P * (dP - rowsum(dP * P)) * scale, writes dQ = dS K and
// sums dK = dS^T Q. That is one extra q.K^T product per tile, against a
// single block holding both fp32 sums, which does not fit shared memory at
// M = 600. Products run through common.cuh:gemm_bf16 (wmma bf16, fp32
// accumulation); the backward's warp tiles span one row block (MaxRB = 1):
// with two it spilled 1.5 KB at 255 registers and measured 8-12% slower on
// the H100. Its dK/dV sums go through common.cuh:gemm_acc (whole
// accumulator fragments, both operands in shared memory), 7-10% faster
// there than the per-element epilogue. wgmma/TMA are for later work.

#include <math.h>

#include <initializer_list>

#include "common.cuh"

namespace mvlt {
namespace {

// shared-memory rows of bf16 operands padded by 16 bytes (bank spread)
constexpr int kPad = 8;

struct View {
  long long sb, sh, sn;  // element strides of batch, head and row
};

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  View vq, vk, vv, vo;
  int heads, n, m, hd, tq;
  float scale;
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  View vq, vk, vv, vdo, vdq, vdk, vdv;
  int heads, n, m, hd, tq;
  float scale;
};

__host__ __device__ inline size_t fwd_smem(int tq, int mp, int hd, size_t* off) {
  size_t o = 0;
  off[0] = o; o += align128((size_t)tq * (hd + kPad) * 2);   // Q tile
  off[1] = o; o += align128((size_t)tq * mp * 4);            // fp32 logits
  off[2] = o; o += align128((size_t)tq * (mp + kPad) * 2);   // bf16 P
  off[3] = o; o += kStageBytes;
  return o;
}

// Backward layout, the larger of the two blocks' needs:
// acc fp32 [mp, hd] | Q tile | dO tile | S fp32 [tq, mp] | dP fp32 [tq, mp]
// | dS bf16 [tq, mp + pad] | P^T or dS^T bf16 [mp, tq + pad] | stage
__host__ __device__ inline size_t bwd_smem(int tq, int mp, int hd, size_t* off) {
  size_t o = 0;
  off[0] = o; o += align128((size_t)mp * hd * 4);
  off[1] = o; o += align128((size_t)tq * (hd + kPad) * 2);
  off[2] = o; o += align128((size_t)tq * (hd + kPad) * 2);
  off[3] = o; o += align128((size_t)tq * mp * 4);
  off[4] = o; o += align128((size_t)tq * mp * 4);
  off[5] = o; o += align128((size_t)tq * (mp + kPad) * 2);
  off[6] = o; o += align128((size_t)mp * (tq + kPad) * 2);
  off[7] = o; o += kStageBytes;
  return o;
}

// fp32 softmax over the first m of mp columns of each of tq rows, in place;
// columns m..mp become 0. One warp per row.
__device__ void softmax_rows(float* s, int tq, int m, int mp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < tq; r += kWarps) {
    float* row = s + (size_t)r * mp;
    float mx = -INFINITY;
    for (int c = lane; c < m; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < m; c += 32) {
      const float e = __expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int c = lane; c < mp; c += 32) row[c] = c < m ? row[c] * inv : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int hd = a.hd, m = a.m, mp = (m + 15) & ~15, tq = a.tq;
  const int ldq = hd + kPad, ldp = mp + kPad;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int n0 = blockIdx.x * tq, rows = min(tq, a.n - n0);
  size_t off[4];
  fwd_smem(tq, mp, hd, off);
  bf16* qs = reinterpret_cast<bf16*>(smem + off[0]);
  float* logit = reinterpret_cast<float*>(smem + off[1]);
  bf16* probs = reinterpret_cast<bf16*>(smem + off[2]);
  float* stage = reinterpret_cast<float*>(smem + off[3]);
  const bf16* kb = a.k + b * a.vk.sb + h * a.vk.sh;
  const bf16* vb = a.v + b * a.vv.sb + h * a.vv.sh;
  const int ldk = (int)a.vk.sn, ldv = (int)a.vv.sn;

  load_tile_rows(qs, ldq, a.q + b * a.vq.sb + h * a.vq.sh + n0 * a.vq.sn, a.vq.sn, rows, tq, hd);
  __syncthreads();
  gemm_bf16<true, 2>(qs, ldq, kb, ldk, tq, mp, hd, stage,
                     [&](int r, int c, float v) { logit[r * mp + c] = v * a.scale; });
  __syncthreads();
  softmax_rows(logit, tq, m, mp);
  __syncthreads();
  for (int i = threadIdx.x; i < tq * mp; i += kThreads) {
    const int r = i / mp, c = i - r * mp;
    probs[r * ldp + c] = __float2bfloat16(logit[i]);
  }
  __syncthreads();
  bf16* ob = a.o + b * a.vo.sb + h * a.vo.sh + n0 * a.vo.sn;
  const long long ldo = a.vo.sn;
  gemm_bf16<false, 2>(probs, ldp, vb, ldv, tq, hd, mp, stage, [&](int r, int c, float v) {
    if (r < rows) ob[r * ldo + c] = __float2bfloat16(v);
  });
}

__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int hd = a.hd, m = a.m, mp = (m + 15) & ~15, tq = a.tq;
  const int ldq = hd + kPad, ldp = mp + kPad, ldt = tq + kPad;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const bool dv_block = blockIdx.y == 0;
  size_t off[8];
  bwd_smem(tq, mp, hd, off);
  float* acc = reinterpret_cast<float*>(smem + off[0]);
  bf16* qs = reinterpret_cast<bf16*>(smem + off[1]);
  bf16* dos = reinterpret_cast<bf16*>(smem + off[2]);
  float* p = reinterpret_cast<float*>(smem + off[3]);
  float* dp = reinterpret_cast<float*>(smem + off[4]);
  bf16* ds = reinterpret_cast<bf16*>(smem + off[5]);
  bf16* tr = reinterpret_cast<bf16*>(smem + off[6]);  // P^T (dV block) or dS^T (dK block)
  float* stage = reinterpret_cast<float*>(smem + off[7]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const bf16* kb = a.k + b * a.vk.sb + h * a.vk.sh;
  const bf16* vb = a.v + b * a.vv.sb + h * a.vv.sh;
  const int ldk = (int)a.vk.sn, ldv = (int)a.vv.sn;
  const bf16* qb = a.q + b * a.vq.sb + h * a.vq.sh;
  const bf16* dob = a.dout + b * a.vdo.sb + h * a.vdo.sh;
  bf16* dqb = a.dq + b * a.vdq.sb + h * a.vdq.sh;
  const long long ldqo = a.vdq.sn;


  for (int n0 = 0; n0 < a.n; n0 += tq) {
    const int rows = min(tq, a.n - n0);
    // rows past N are zero in Q and dO: they add nothing to dK or dV
    load_tile_rows(qs, ldq, qb + n0 * a.vq.sn, a.vq.sn, rows, tq, hd);
    load_tile_rows(dos, ldq, dob + n0 * a.vdo.sn, a.vdo.sn, rows, tq, hd);
    __syncthreads();
    gemm_bf16<true, 1>(qs, ldq, kb, ldk, tq, mp, hd, stage,
                       [&](int r, int c, float v) { p[r * mp + c] = v * a.scale; });
    __syncthreads();
    softmax_rows(p, tq, m, mp);
    __syncthreads();
    if (dv_block) {
      // dV += P^T dO (P rounded to bf16, as the forward's P.V uses it)
      for (int i = threadIdx.x; i < tq * mp; i += kThreads) {
        const int r = i / mp, c = i - r * mp;
        tr[c * ldt + r] = __float2bfloat16(p[i]);
      }
      __syncthreads();
      gemm_acc<false>(tr, ldt, dos, ldq, mp, hd, tq, acc, hd, n0 == 0);
      __syncthreads();
      continue;
    }
    // dP = dO V^T (fp32)
    gemm_bf16<true, 1>(dos, ldq, vb, ldv, tq, mp, hd, stage,
                       [&](int r, int c, float v) { dp[r * mp + c] = v; });
    __syncthreads();
    // dS = P * (dP - rowsum(dP * P)) * scale, into dS and dS^T
    for (int r = warp; r < tq; r += kWarps) {
      const float* pr = p + (size_t)r * mp;
      const float* dpr = dp + (size_t)r * mp;
      float t = 0.0f;
      for (int c = lane; c < m; c += 32) t += pr[c] * dpr[c];
      t = warp_sum(t);
      for (int c = lane; c < mp; c += 32) {
        const bf16 e = __float2bfloat16(pr[c] * (dpr[c] - t) * a.scale);
        ds[r * ldp + c] = e;
        tr[c * ldt + r] = e;
      }
    }
    __syncthreads();
    // dQ = dS K, straight to global; dK += dS^T Q
    gemm_bf16<false, 1>(ds, ldp, kb, ldk, tq, hd, mp, stage, [&](int r, int c, float v) {
      if (r < rows) dqb[(n0 + r) * ldqo + c] = __float2bfloat16(v);
    });
    gemm_acc<false>(tr, ldt, qs, ldq, mp, hd, tq, acc, hd, n0 == 0);
    __syncthreads();
  }

  const View& vo = dv_block ? a.vdv : a.vdk;
  bf16* out = (dv_block ? a.dv : a.dk) + b * vo.sb + h * vo.sh;
  for (int i = threadIdx.x; i < m * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    out[r * vo.sn + c] = __float2bfloat16(acc[i]);
  }
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. Each tensor comes with three element
// strides (batch, head, row); the last dimension is contiguous. K and V
// hold a multiple of 16 rows (m real ones). They launch on `stream` and
// return the cudaError_t of the launch (0 on success); no synchronisation.
extern "C" int mvlt_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int batch, int heads, int n,
                                  int m, int hd, float scale, void* stream) {
  using namespace mvlt;
  const int mp = (m + 15) & ~15;
  size_t off[4], bytes = 0;
  int tq = 0;
  for (int cand : {64, 32, 16}) {
    bytes = fwd_smem(cand, mp, hd, off);
    if (bytes <= kSmemLimit) {
      tq = cand;
      break;
    }
  }
  if (!tq) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o),
            view(strides), view(strides + 3), view(strides + 6), view(strides + 9),
            heads, n, m, hd, tq, scale};
  dim3 grid((n + tq - 1) / tq, batch * heads);
  attn_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mvlt_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  const long long* strides, int batch, int heads, int n,
                                  int m, int hd, float scale, void* stream) {
  using namespace mvlt;
  const int mp = (m + 15) & ~15;
  size_t off[8], bytes = 0;
  int tq = 0;
  for (int cand : {64, 32, 16}) {
    bytes = bwd_smem(cand, mp, hd, off);
    if (bytes <= kSmemLimit) {
      tq = cand;
      break;
    }
  }
  if (!tq) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a{static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
            static_cast<const bf16*>(v),   static_cast<const bf16*>(dout),
            static_cast<bf16*>(dq),        static_cast<bf16*>(dk),
            static_cast<bf16*>(dv),        view(strides),
            view(strides + 3),             view(strides + 6),
            view(strides + 9),             view(strides + 12),
            view(strides + 15),            view(strides + 18),
            heads, n, m, hd, tq, scale};
  dim3 grid(batch * heads, 2);
  attn_bwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
