// MLM cross entropy of PVLT pre-training against the tied vocabulary, with
// the [rows, vocab] logits never in device memory:
//   forward   logit = x E^T + b;  lse[r] = log sum_v exp(logit[r, v]);
//             nll[r] = lse[r] - logit[r, label[r]]  (0 where label = -1)
//   backward  dl = g[r] (softmax - onehot), recomputed from the saved lse
//             (0 where label = -1);  dx = dl E, dE = dl^T x, db = sum_r dl
// for x [R, H] bf16, E [V, H] bf16 (the tied fp32 word embeddings, rounded
// by the wrapper), b [V] fp32 and labels [R] int32. dl is rounded to bf16
// before the two products, db sums it in fp32, as the TPU kernel does.
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
// Design. Tiles of 64 rows by 64 vocabulary columns with the whole H of both
// operands in shared memory, so every product reads A and B there
// (common.cuh:gemm_bf16 for the logits, gemm_acc for the sums); one block of
// 8 warps per SM.
// Forward: the TPU carries (max, sum-exp, picked) across a sequential vocab
// grid axis. A grid over row tiles alone is 48 blocks for 132 SMs at R =
// 3,072, so the vocabulary is split over S blocks as well (S chosen so that
// the blocks fill whole waves of the SMs, 11 there): each block runs the
// online logsumexp over its vocab tiles and writes a partial (max, sum,
// picked) per row, and a second launch merges a row's S partials in split
// order.
// Backward, dx: the same (row tile, split) grid; a block recomputes each
// logits tile, forms dl and adds dl.E_j into its split's fp32 slot of dx
// partials (gemm_acc: whole accumulator fragments loaded from and stored to
// device memory); a second launch sums the S slots in order: deterministic,
// no atomics. The slots take S.R.H.4 bytes (104 MB at the pre-training
// shape).
// Backward, dE and db: one block per vocab tile keeps its E tile in shared
// memory and loops over every row tile: recompute, dl, then dE_j += dl^T.x
// (gemm_acc into the block's own rows of dE, written on the first row tile)
// and db_j += the column sums of the fp32 dl, in row order.
// One recompute or two: two, as on the TPU. With one, every vocab tile would
// leave a dx partial of all R rows (477 x 9.4 MB at the pre-training shape),
// or the partials would need atomics; the second recompute costs 144 GFLOP
// (576 instead of 432).
// The vocabulary is ragged (30,522 = 476 x 64 + 58): the last tile's missing
// rows of E load as zeros, their logits are -inf (never the max, never
// picked) and their dl is 0. Rows past R load as zeros with label -1.

#include <math.h>

#include "common.cuh"

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
  const float* lse;  // backward
  const float* g;    // backward
  float* ws;         // forward: [S][rows][3] partials; dx: [S][rows_pad][h] slots
  float* dtable;     // [vocab_pad][h]
  float* dbias;      // [vocab]
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

// x tile | E tile | dl bf16 | label, lse, g | stage
__host__ __device__ inline size_t dx_smem(int h, size_t* off) {
  size_t o = 0;
  off[0] = o; o += operand_bytes(h);
  off[1] = o; o += operand_bytes(h);
  off[2] = o; o += align128((size_t)kTile * (kTile + kPad) * 2);
  off[3] = o; o += align128((size_t)kTile * 3 * 4);
  off[4] = o; o += kStageBytes;
  return o;
}

// E tile | x tile | dl fp32 | dl^T bf16 sharing the stage | label, lse, g
__host__ __device__ inline size_t dtable_smem(int h, size_t* off) {
  const size_t dlt = (size_t)kTile * (kTile + kPad) * 2;
  size_t o = 0;
  off[0] = o; o += operand_bytes(h);
  off[1] = o; o += operand_bytes(h);
  off[2] = o; o += align128((size_t)kTile * kTile * 4);
  off[3] = o; o += align128(dlt > kStageBytes ? dlt : kStageBytes);
  off[4] = o; o += align128((size_t)kTile * 3 * 4);
  return o;
}

// Rows [r0, r0 + kTile) of the per-row operands into shared memory; rows past
// R get label -1 (no loss, no gradient).
__device__ __forceinline__ void load_row_operands(const Args& a, int r0, int* lab, float* lse,
                                                  float* g) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = r0 + r < a.rows;
    lab[r] = in ? a.labels[r0 + r] : -1;
    lse[r] = in ? a.lse[r0 + r] : 0.0f;
    g[r] = in ? a.g[r0 + r] : 0.0f;
  }
}

// dl of one logit (bias not yet added) at tile column c of a tile with nv
// valid columns starting at v0.
__device__ __forceinline__ float dlogit(const Args& a, float v, int c, int nv, int v0, int lab,
                                        float lse, float g) {
  if (lab < 0 || c >= nv) return 0.0f;
  const float p = __expf(v + a.bias[v0 + c] - lse);
  return g * (c == lab - v0 ? p - 1.0f : p);
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

__global__ void __launch_bounds__(kThreads) mlm_ce_dx_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  size_t off[5];
  dx_smem(a.h, off);
  const int ld = a.h + kPad, ldd = kTile + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* ts = reinterpret_cast<bf16*>(smem + off[1]);
  bf16* dl = reinterpret_cast<bf16*>(smem + off[2]);
  int* lab = reinterpret_cast<int*>(smem + off[3]);
  float* lse = reinterpret_cast<float*>(lab + kTile);
  float* g = lse + kTile;
  float* stage = reinterpret_cast<float*>(smem + off[4]);
  const int r0 = blockIdx.x * kTile, nrows = min(kTile, a.rows - r0);
  const int j0 = blockIdx.y * a.per_split, j1 = min(tiles(a.vocab), j0 + a.per_split);
  float* slot = a.ws + ((size_t)blockIdx.y * gridDim.x * kTile + r0) * a.h;

  load_tile_rows(xs, ld, a.x + (size_t)r0 * a.h, a.h, nrows, kTile, a.h);
  load_row_operands(a, r0, lab, lse, g);
  for (int j = j0; j < j1; ++j) {
    const int v0 = j * kTile, nv = min(kTile, a.vocab - v0);
    load_tile_rows(ts, ld, a.table + (size_t)v0 * a.h, a.h, nv, kTile, a.h);
    __syncthreads();
    gemm_bf16<true, 2>(xs, ld, ts, ld, kTile, kTile, a.h, stage, [&](int r, int c, float v) {
      dl[r * ldd + c] = __float2bfloat16(dlogit(a, v, c, nv, v0, lab[r], lse[r], g[r]));
    });
    __syncthreads();
    // slot += dl . E_j, E_j read as B[k = vocab][n = h]
    gemm_acc<false>(dl, ldd, ts, ld, kTile, a.h, kTile, slot, a.h, j == j0);
    __syncthreads();
  }
}

// dx[r] = the sum of the S slots' rows r, in split order.
__global__ void mlm_ce_dx_reduce_kernel(const float* ws, int splits, long long slot_floats,
                                        long long n, float* dx) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) sum += ws[s * slot_floats + i];
    dx[i] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) mlm_ce_dtable_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  size_t off[5];
  dtable_smem(a.h, off);
  const int ld = a.h + kPad, ldt = kTile + kPad;
  bf16* ts = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* xs = reinterpret_cast<bf16*>(smem + off[1]);
  float* dl = reinterpret_cast<float*>(smem + off[2]);
  bf16* dlt = reinterpret_cast<bf16*>(smem + off[3]);
  float* stage = reinterpret_cast<float*>(smem + off[3]);  // free again once dl^T is written
  int* lab = reinterpret_cast<int*>(smem + off[4]);
  float* lse = reinterpret_cast<float*>(lab + kTile);
  float* g = lse + kTile;
  const int v0 = blockIdx.x * kTile, nv = min(kTile, a.vocab - v0);
  float* dt = a.dtable + (size_t)v0 * a.h;
  float db = 0.0f;  // thread c < kTile: column c's sum

  load_tile_rows(ts, ld, a.table + (size_t)v0 * a.h, a.h, nv, kTile, a.h);
  for (int i = 0, nrt = tiles(a.rows); i < nrt; ++i) {
    const int r0 = i * kTile;
    load_tile_rows(xs, ld, a.x + (size_t)r0 * a.h, a.h, min(kTile, a.rows - r0), kTile, a.h);
    load_row_operands(a, r0, lab, lse, g);
    __syncthreads();
    gemm_bf16<true, 2>(xs, ld, ts, ld, kTile, kTile, a.h, stage,
                       [&](int r, int c, float v) { dl[r * kTile + c] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e - r * kTile;
      const float d = dlogit(a, dl[e], c, nv, v0, lab[r], lse[r], g[r]);
      dl[e] = d;
      dlt[c * ldt + r] = __float2bfloat16(d);
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      for (int r = 0; r < kTile; ++r) db += dl[r * kTile + threadIdx.x];
    }
    // dE_j += dl^T . x, x read as B[k = row][n = h]
    gemm_acc<false>(dlt, ldt, xs, ld, kTile, a.h, kTile, dt, a.h, i == 0);
    __syncthreads();
  }
  if (threadIdx.x < nv) a.dbias[v0 + threadIdx.x] = db;
}

cudaError_t prepare(const void* kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. They launch on `stream` and return the
// cudaError_t of the launches (0 on success); no synchronisation. h is a
// multiple of 16 and at most 768 (the two operand tiles fill shared memory).

extern "C" int mvlt_mlm_ce_tile() { return mvlt::kTile; }

// The vocabulary splits of the forward and of the dx backward for `rows`
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
         static_cast<const float*>(bias), static_cast<const int*>(labels), nullptr, nullptr,
         static_cast<float*>(ws), nullptr, nullptr, rows, vocab, h, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mlm_ce_fwd_kernel<<<dim3(tiles(rows), splits), kThreads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlm_ce_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const int*>(labels), rows, splits,
      static_cast<float*>(nll), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

// ws: splits * tiles(rows) * 64 * h floats; dx [rows, h], dtable
// [tiles(vocab) * 64, h] and dbias [vocab], all fp32.
extern "C" int mvlt_mlm_ce_bwd(const void* x, const void* table, const void* bias,
                               const void* labels, const void* lse, const void* g, void* ws,
                               void* dx, void* dtable, void* dbias, int rows, int vocab, int h,
                               int splits, void* stream) {
  using namespace mvlt;
  if (rows < 1 || vocab < 1 || h % 16 || splits < 1) return (int)cudaErrorInvalidValue;
  size_t off[5];
  const size_t dx_bytes = dx_smem(h, off), dt_bytes = dtable_smem(h, off);
  cudaError_t err = prepare((const void*)mlm_ce_dx_kernel, dx_bytes);
  if (err == cudaSuccess) err = prepare((const void*)mlm_ce_dtable_kernel, dt_bytes);
  if (err != cudaSuccess) return (int)err;
  const int per = (tiles(vocab) + splits - 1) / splits;
  splits = (tiles(vocab) + per - 1) / per;  // no empty split: every slot is written
  Args a{static_cast<const bf16*>(x),    static_cast<const bf16*>(table),
         static_cast<const float*>(bias), static_cast<const int*>(labels),
         static_cast<const float*>(lse),  static_cast<const float*>(g),
         static_cast<float*>(ws),         static_cast<float*>(dtable),
         static_cast<float*>(dbias),      rows, vocab, h, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mlm_ce_dx_kernel<<<dim3(tiles(rows), splits), kThreads, dx_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)rows * h;
  mlm_ce_dx_reduce_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
      static_cast<const float*>(ws), splits, (long long)tiles(rows) * kTile * h, n,
      static_cast<float*>(dx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlm_ce_dtable_kernel<<<tiles(vocab), kThreads, dt_bytes, st>>>(a);
  return (int)cudaGetLastError();
}
