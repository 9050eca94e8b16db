// MLM cross entropy of PVLT pre-training against the tied vocabulary:
//   forward   logit = x E^T + b;  lse[r] = log sum_v exp(logit[r, v]);
//             nll[r] = lse[r] - logit[r, label[r]]  (0 where label = -1)
//   backward  dl = g[r] (softmax - onehot), recomputed from the saved lse
//             (0 where label = -1);  dx = dl E, dE = dl^T x, db = sum_r dl
// for x [R, H] bf16, E [V, H] bf16 (the tied fp32 word embeddings, rounded
// by the wrapper), b [V] fp32 and labels [R] int32. dl is rounded to bf16
// before the two products, db sums it in fp32, as the TPU kernel does. The
// forward never writes the [R, V] logits to device memory; the backward
// writes dl once, in bf16.
//
// Replaces: mvlt_tpu/ops/mlm_ce.py:_fwd_impl (Pallas body _fwd_kernel) and
// _bwd_impl (bodies _bwd_rows_kernel and _bwd_table_kernel), without their
// lane-replicated per-row operands.
//
// What bounds it on the H100: the products. At the pre-training shape (R =
// 3,072 gathered rows, H = 768, V = 30,522) the forward is 2.R.V.H = 144
// GFLOP (0.146 ms at the bf16 peak) against 52 MB of operands (0.015 ms);
// the backward's least work is one recompute, dx and dE: 432 GFLOP (0.437
// ms).
//
// Forward (wmma, common.cuh). Tiles of 64 rows by 64 vocabulary columns
// with the whole H of both operands in shared memory (gemm_bf16); one block
// of 8 warps per SM. The TPU carries (max, sum-exp, picked) across a
// sequential vocab grid axis. A grid over row tiles alone is 48 blocks for
// 132 SMs at R = 3,072, so the vocabulary is split over S blocks as well (S
// chosen so that the blocks fill whole waves of the SMs, 11 there): each
// block runs the online logsumexp over its vocab tiles and writes a partial
// (max, sum, picked) per row, and a second launch merges a row's S partials
// in split order. The vocabulary is ragged (30,522 = 476 x 64 + 58): the
// last tile's missing rows of E load as zeros and their logits are -inf
// (never the max, never picked). Rows past R load as zeros with label -1.
//
// Backward (wgmma, hopper.cuh): one recompute of the logits, then the two
// products as GEMMs of their own, all on 128 x 128 output tiles of two
// warpgroups (64 rows each, fp32 sums in registers) that stream the
// contraction in 64-deep chunks through a 5-stage cp.async ring of
// swizzled tiles, two chunks in flight ahead of the product and one product
// in flight behind it.
//   mlm_ce_dlogits_kernel  S = x E^T (x and E K-major), then in registers
//       dl = g (exp(S + b - lse) - onehot), 0 on ignored rows and padded
//       columns; dl goes out once in bf16 to a [R_pad, V_pad] scratch
//       (rows and columns rounded up to 128: 188 MB at the pre-training
//       shape) through a shared-memory stage, and the tile's fp32 column
//       sums to a [R_pad / 128, V_pad] slot of db partials;
//   mlm_ce_gemm_kernel<false>  dx^T = E^T dl^T: A = E read MN-major (H
//       across the tile's rows), B = dl K-major, the 30,592-deep vocabulary
//       split into S ranges (ops/mlm_ce.py: bwd_plan, 5 at the
//       pre-training shape) whose fp32 dx slots a sum launch adds in order;
//   mlm_ce_gemm_kernel<true>   dE^T = x^T dl: A = x MN-major, B = dl
//       MN-major (two 64-column panels, two m64n64 products a step), the
//       3,072-deep rows in one range;
//   mlm_ce_slot_sum_kernel     db and dx from their slots, in order.
// Every sum runs in a fixed order: two calls on the same inputs are
// bit-equal, and no float atomics are used. The least traffic is 432 GFLOP
// against ~0.4 GB of dl written and read twice.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mvlt {
namespace {

constexpr int kTile = 64;  // rows, and vocabulary columns, per tile
constexpr int kPad = 8;
constexpr int kMaxSplits = 16;

struct Args {
  const bf16* x;
  const bf16* table;
  const float* bias;
  const int* labels;
  float* ws;  // [S][rows][3] partials
  int rows, vocab, h, per_split;  // per_split: vocab tiles per split
};

__host__ __device__ inline int tiles(int n) { return (n + kTile - 1) / kTile; }

__host__ __device__ inline size_t operand_bytes(int h) {
  return align128((size_t)kTile * (h + kPad) * 2);
}

// x tile | E tile | logits fp32 | running max, sum, picked, label | stage
__host__ __device__ inline size_t fwd_smem(int h, size_t* off) {
  size_t o = 0;
  off[0] = o; o += operand_bytes(h);
  off[1] = o; o += operand_bytes(h);
  off[2] = o; o += align128((size_t)kTile * kTile * 4);
  off[3] = o; o += align128((size_t)kTile * 4 * 4);
  off[4] = o; o += kStageBytes;
  return o;
}

__global__ void __launch_bounds__(kThreads) mlm_ce_fwd_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  size_t off[5];
  fwd_smem(a.h, off);
  const int ld = a.h + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* ts = reinterpret_cast<bf16*>(smem + off[1]);
  float* logits = reinterpret_cast<float*>(smem + off[2]);
  float* run_m = reinterpret_cast<float*>(smem + off[3]);
  float* run_s = run_m + kTile;
  float* run_p = run_s + kTile;
  int* lab = reinterpret_cast<int*>(run_p + kTile);
  float* stage = reinterpret_cast<float*>(smem + off[4]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kTile, nrows = min(kTile, a.rows - r0);
  const int j0 = blockIdx.y * a.per_split, j1 = min(tiles(a.vocab), j0 + a.per_split);

  load_tile_rows(xs, ld, a.x + (size_t)r0 * a.h, a.h, nrows, kTile, a.h);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    run_m[r] = -INFINITY;
    run_s[r] = 0.0f;
    run_p[r] = 0.0f;
    lab[r] = r < nrows ? a.labels[r0 + r] : -1;
  }
  for (int j = j0; j < j1; ++j) {
    const int v0 = j * kTile, nv = min(kTile, a.vocab - v0);
    load_tile_rows(ts, ld, a.table + (size_t)v0 * a.h, a.h, nv, kTile, a.h);
    __syncthreads();
    gemm_bf16<true, 2>(xs, ld, ts, ld, kTile, kTile, a.h, stage, [&](int r, int c, float v) {
      logits[r * kTile + c] = c < nv ? v + a.bias[v0 + c] : -INFINITY;
    });
    __syncthreads();
    // online logsumexp, one warp per row, two columns per lane
    for (int r = warp; r < kTile; r += kWarps) {
      const float l0 = logits[r * kTile + lane], l1 = logits[r * kTile + lane + 32];
      const float m_old = run_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(l0, l1)));
      const float s = warp_sum(__expf(l0 - m_new) + __expf(l1 - m_new));
      if (lane == 0) {
        run_s[r] = run_s[r] * __expf(m_old - m_new) + s;
        run_m[r] = m_new;
        const int c = lab[r] - v0;
        if (c >= 0 && c < nv) run_p[r] += logits[r * kTile + c];
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    float* p = a.ws + ((size_t)blockIdx.y * a.rows + r0 + r) * 3;
    p[0] = run_m[r];
    p[1] = run_s[r];
    p[2] = run_p[r];
  }
}

// One thread per row: merge the splits' (max, sum, picked) in split order.
__global__ void mlm_ce_merge_kernel(const float* ws, const int* labels, int rows, int splits,
                                    float* nll, float* lse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ws[((size_t)s * rows + r) * 3]);
  float sum = 0.0f, picked = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* p = ws + ((size_t)s * rows + r) * 3;
    sum += p[1] * expf(p[0] - m);
    picked += p[2];
  }
  const float l = m + logf(sum);
  lse[r] = l;
  nll[r] = labels[r] >= 0 ? l - picked : 0.0f;
}


// ---- backward (wgmma) ----------------------------------------------------

using namespace hopper;

constexpr int kBwdTile = 128;     // rows and columns of a block's output tile
constexpr int kChunk = 64;        // contraction depth of one ring stage
constexpr int kRing = 5;          // ring stages; kRing - 2 chunks load ahead
constexpr int kBwdThreads = 256;  // two warpgroups, 64 rows of the tile each
constexpr int kOperandBytes = kBwdTile * kChunk * 2;  // one operand of one stage
constexpr int kPanelBytes = kOperandBytes / 2;        // 64 rows of 128 bytes
constexpr size_t kBwdSmem = 1024 + (size_t)kRing * 2 * kOperandBytes;
constexpr int kLds = kBwdTile + 8;  // bf16 row of the dl stage

// A row-major bf16 matrix in device memory, ld elements a row; elements
// past [rows][cols] read as zeros.
struct Mat {
  const bf16* p;
  long long ld;
  int rows, cols;
};

struct DlArgs {
  Mat x, e;
  const float* bias;
  const int* labels;
  const float* lse;
  const float* g;
  bf16* dl;    // [rows_pad][vocab_pad]
  float* dbp;  // [rows_pad / 128][vocab_pad] column sums of each row tile
  int rows, vocab, vocab_pad, chunks;
};

// out[n][m] = sum_k A[k][m] B(k, n) over the split's chunks of k, fp32, for
// m < m_out and n < n_out; split s writes out + s * split_stride.
struct GemmArgs {
  Mat a, b;
  float* out;
  long long split_stride;
  int m_out, n_out, ldo, chunks, per_split;
};

// One ring stage of an operand, a 128 x 64 tile of m, by cp.async:
//   K-major  (MN false): rows r0 .. r0 + 127, columns k0 .. k0 + 63, one
//            128-byte swizzled row each;
//   MN-major (MN true):  rows k0 .. k0 + 63, columns r0 .. r0 + 127, as two
//            panels of 64 columns [64][128 B], kPanelBytes apart.
template <bool MN>
__device__ __forceinline__ void load_operand(uint32_t dst, const Mat& m, int r0, int k0) {
  for (int i = threadIdx.x; i < kBwdTile * 8; i += kBwdThreads) {
    int row, col;
    uint32_t off;
    if (MN) {
      const int k = i >> 4, c = i & 15;
      row = k0 + k;
      col = r0 + c * 8;
      off = (c >> 3) * kPanelBytes + tile_off<128>(k, c & 7);
    } else {
      const int r = i >> 3, c = i & 7;
      row = r0 + r;
      col = k0 + c * 8;
      off = tile_off<128>(r, c);
    }
    const bool ok = row < m.rows && col < m.cols;
    cp_async16_zfill(dst + off, ok ? m.p + row * m.ld + col : m.p, ok);
  }
}

// d = the block's 128 x 128 tile of A^T B (A rows m0.., B rows n0..) over
// chunks [c0, c1) of the contraction; warpgroup w holds rows 64w .. 64w + 63.
// A is K-major (A_MN false: [M][K] in memory) or MN-major ([K][M]); so is B.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_tile(const Mat& a, const Mat& b, int m0, int n0, int c0,
                                         int c1, uint32_t ring, float (&d)[64]) {
  const int wg = threadIdx.x >> 7, n = c1 - c0;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  auto load = [&](int i) {  // chunk c0 + i into its stage; one commit group each
    if (i < n) {
      const uint32_t st = ring + (i % kRing) * 2 * kOperandBytes;
      load_operand<A_MN>(st, a, m0, (c0 + i) * kChunk);
      load_operand<B_MN>(st + kOperandBytes, b, n0, (c0 + i) * kChunk);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kRing - 2; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kRing - 3>();
    fence_proxy_async();
    __syncthreads();  // chunk i is in; both warpgroups' products of chunk i - 2 are done
    load(i + kRing - 2);  // into chunk i - 2's stage
    const uint32_t st = ring + (i % kRing) * 2 * kOperandBytes;
    const uint32_t sa = st + wg * kPanelBytes, sb = st + kOperandBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint64_t da = make_desc<128>(sa + (A_MN ? kk * 16 * 128 : kk * 32));
      if (B_MN) {
        wgmma_ss_half<A_MN, 1, 0>(d, da, make_desc<128>(sb + kk * 16 * 128), 1);
        wgmma_ss_half<A_MN, 1, 32>(d, da, make_desc<128>(sb + kPanelBytes + kk * 16 * 128), 1);
      } else {
        wgmma_ss<A_MN, 0>(d, da, make_desc<128>(sb + kk * 32), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk i - 1's product is done
  }
  wgmma_wait<0>();
  fence_regs(d);
}

__global__ void __launch_bounds__(kBwdThreads, 1) mlm_ce_dlogits_kernel(DlArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.x * kBwdTile, n0 = blockIdx.y * kBwdTile;
  float d[64];
  mma_tile<false, false>(a.x, a.e, m0, n0, 0, a.chunks, smem_u32(smem), d);

  // dl in registers: thread rows rl and rl + 8 of the tile, columns 8j + cq, + 1
  const int rl = 64 * wg + 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  int lab[2];
  float nlse[2], g[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + rl + 8 * h;
    const bool in = r < a.rows;
    lab[h] = in ? a.labels[r] : -1;
    nlse[h] = in ? -a.lse[r] * kLog2e : 0.0f;
    g[h] = in ? a.g[r] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, v = n0 + 8 * j + cq + (e & 1);
      float dl = 0.0f;
      if (lab[h] >= 0 && v < a.vocab) {
        const float p = fast_exp2(fmaf(d[4 * j + e] + a.bias[v], kLog2e, nlse[h]));
        dl = g[h] * (v == lab[h] ? p - 1.0f : p);
      }
      d[4 * j + e] = dl;
    }
  }

  __syncthreads();  // both warpgroups are done with the ring: it becomes the stage
  bf16* st = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + kBwdTile * kLds * 2);  // [8 warps][128]
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(st + (rl + 8 * h) * kLds + 8 * j + cq) =
          pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // the column's sum over the warp's 16 rows
      float s = d[4 * j + c] + d[4 * j + 2 + c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[(tid >> 5) * kBwdTile + 8 * j + cq + c] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < kBwdTile * kBwdTile / 8; i += kBwdThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    *reinterpret_cast<uint4*>(a.dl + (size_t)(m0 + r) * a.vocab_pad + n0 + c) =
        *reinterpret_cast<const uint4*>(st + r * kLds + c);
  }
  if (tid < kBwdTile) {
    float s = 0.0f;
    for (int w = 0; w < kBwdThreads / 32; ++w) s += red[w * kBwdTile + tid];
    a.dbp[(size_t)blockIdx.x * a.vocab_pad + n0 + tid] = s;
  }
}

template <bool B_MN>
__global__ void __launch_bounds__(kBwdThreads, 1) mlm_ce_gemm_kernel(GemmArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.x * kBwdTile, n0 = blockIdx.y * kBwdTile, split = blockIdx.z;
  const int c0 = split * a.per_split, c1 = min(a.chunks, c0 + a.per_split);
  float d[64];
  mma_tile<true, B_MN>(a.a, a.b, m0, n0, c0, c1, smem_u32(smem), d);
  float* out = a.out + split * a.split_stride;
  const int m = m0 + 64 * wg + 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = m + 8 * (e >> 1), nn = n0 + 8 * j + cq + (e & 1);
      if (mm < a.m_out && nn < a.n_out) out[(size_t)nn * a.ldo + mm] = d[4 * j + e];
    }
  }
}

// out[i] = the sum over s of slots[s * stride + i], in slot order, i < n.
__global__ void mlm_ce_slot_sum_kernel(const float* slots, long long stride, int count,
                                       long long n, float* out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < count; ++s) sum += slots[s * stride + i];
    out[i] = sum;
  }
}

cudaError_t slot_sum(const float* slots, long long stride, int count, long long n, float* out,
                     cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  mlm_ce_slot_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(slots, stride,
                                                                              count, n, out);
  return cudaGetLastError();
}

cudaError_t prepare(const void* kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. They launch on `stream` and return the
// cudaError_t of the launches (0 on success); no synchronisation. The
// forward takes h a multiple of 16 and at most 768 (its two operand tiles
// fill shared memory).

// The vocabulary splits of the forward for `rows`
// rows on `sms` SMs: the count up to 16 whose (row tile, split) blocks fill
// the largest share of their last wave, the smallest such; trimmed so that
// no split is empty.
extern "C" int mvlt_mlm_ce_splits(int rows, int vocab, int sms) {
  using namespace mvlt;
  const int rt = tiles(rows), nvt = tiles(vocab);
  int best = 1;
  float best_fill = 0.0f;
  for (int s = 1; s <= kMaxSplits && s <= nvt; ++s) {
    const int blocks = rt * s, waves = (blocks + sms - 1) / sms;
    const float fill = (float)blocks / ((float)waves * sms);
    if (fill > best_fill + 1e-6f) {
      best_fill = fill;
      best = s;
    }
  }
  const int per = (nvt + best - 1) / best;
  return (nvt + per - 1) / per;
}

// ws: splits * rows * 3 floats.
extern "C" int mvlt_mlm_ce_fwd(const void* x, const void* table, const void* bias,
                               const void* labels, void* ws, void* nll, void* lse, int rows,
                               int vocab, int h, int splits, void* stream) {
  using namespace mvlt;
  if (rows < 1 || vocab < 1 || h % 16 || splits < 1) return (int)cudaErrorInvalidValue;
  size_t off[5];
  const size_t bytes = fwd_smem(h, off);
  cudaError_t err = prepare((const void*)mlm_ce_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int per = (tiles(vocab) + splits - 1) / splits;
  splits = (tiles(vocab) + per - 1) / per;  // no empty split
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(table),
         static_cast<const float*>(bias), static_cast<const int*>(labels),
         static_cast<float*>(ws), rows, vocab, h, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mlm_ce_fwd_kernel<<<dim3(tiles(rows), splits), kThreads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlm_ce_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const int*>(labels), rows, splits,
      static_cast<float*>(nll), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

// dl: rows_pad * vocab_pad bf16 and dbp: rows_pad / 128 * vocab_pad floats
// (rows and vocab rounded up to 128); slots: splits * rows * h floats when
// splits > 1 (else unused). dx [rows, h], dtable [vocab, h] and dbias
// [vocab], all fp32. h is a multiple of 64; splits (the vocabulary ranges of
// dx) at least 1, trimmed so that none is empty.
extern "C" int mvlt_mlm_ce_bwd(const void* x, const void* table, const void* bias,
                               const void* labels, const void* lse, const void* g, void* dl,
                               void* dbp, void* slots, void* dx, void* dtable, void* dbias,
                               int rows, int vocab, int h, int splits, void* stream) {
  using namespace mvlt;
  if (rows < 1 || vocab < 1 || h < 64 || h % 64 || splits < 1) return (int)cudaErrorInvalidValue;
  const int rows_pad = (rows + kBwdTile - 1) / kBwdTile * kBwdTile;
  const int vocab_pad = (vocab + kBwdTile - 1) / kBwdTile * kBwdTile;
  cudaError_t err = prepare((const void*)mlm_ce_dlogits_kernel, kBwdSmem);
  if (err == cudaSuccess) err = prepare((const void*)mlm_ce_gemm_kernel<false>, kBwdSmem);
  if (err == cudaSuccess) err = prepare((const void*)mlm_ce_gemm_kernel<true>, kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* eb = static_cast<const bf16*>(table);
  bf16* dlb = static_cast<bf16*>(dl);
  const Mat xm{xb, h, rows, h}, em{eb, h, vocab, h}, dlm{dlb, vocab_pad, rows_pad, vocab_pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = rows_pad / kBwdTile, vocab_tiles = vocab_pad / kBwdTile;
  const int m_tiles = (h + kBwdTile - 1) / kBwdTile;

  const DlArgs da{xm, em, static_cast<const float*>(bias), static_cast<const int*>(labels),
                  static_cast<const float*>(lse), static_cast<const float*>(g), dlb,
                  static_cast<float*>(dbp), rows, vocab, vocab_pad, h / kChunk};
  mlm_ce_dlogits_kernel<<<dim3(row_tiles, vocab_tiles), kBwdThreads, kBwdSmem, st>>>(da);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = slot_sum(static_cast<const float*>(dbp), vocab_pad, row_tiles, vocab,
                   static_cast<float*>(dbias), st);
  if (err != cudaSuccess) return (int)err;

  // dx^T = E^T dl^T over the vocabulary, in `splits` ranges
  const int vchunks = vocab_pad / kChunk, per = (vchunks + splits - 1) / splits;
  splits = (vchunks + per - 1) / per;
  float* dx_out = splits > 1 ? static_cast<float*>(slots) : static_cast<float*>(dx);
  const GemmArgs ga{em, dlm, dx_out, (long long)rows * h, h, rows, h, vchunks, per};
  mlm_ce_gemm_kernel<false><<<dim3(m_tiles, row_tiles, splits), kBwdThreads, kBwdSmem, st>>>(ga);
  err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1)
    err = slot_sum(static_cast<const float*>(slots), (long long)rows * h, splits,
                   (long long)rows * h, static_cast<float*>(dx), st);
  if (err != cudaSuccess) return (int)err;

  // dE^T = x^T dl over the rows, in one range
  const int rchunks = rows_pad / kChunk;
  const GemmArgs ge{xm, dlm, static_cast<float*>(dtable), 0, h, vocab, h, rchunks, rchunks};
  mlm_ce_gemm_kernel<true><<<dim3(m_tiles, vocab_tiles, 1), kBwdThreads, kBwdSmem, st>>>(ge);
  return (int)cudaGetLastError();
}
