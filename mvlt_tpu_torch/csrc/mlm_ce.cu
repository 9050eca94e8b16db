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
// Forward (wgmma, hopper.cuh): mlm_ce_fwd_kernel computes the logits of a
// 128-row by 128-column tile on the backward's mma_tile (x and E K-major, H
// streamed in 64-deep chunks), adds the bias in registers and sets padded
// vocabulary columns (v >= V, zero rows of E) to -inf, then reduces each row
// of the tile to a partial (max, sum of exp, the labelled logit) over its 2 x
// 16 values a thread and the 4 lanes of a quad (__shfl_xor). The TPU carries
// (max, sum-exp, picked) across a sequential vocab grid axis; here every
// (row tile, vocab tile) block writes its partials ([V_pad / 128][R][3], 8.8
// MB at the pre-training shape: 239 x 3,072 x 12 B) and mlm_ce_merge_kernel
// merges a row's partials in vocabulary order: deterministic, no atomics.
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, R = 3,072): 0.67-0.70 ms
// by CUDA events, 0.52 of device time (the merge 0.036), against 1.77 for
// the cuBLAS logits + F.cross_entropy (device 1.56) and 2.58-2.62 for the
// wmma forward it replaces (64 x 64 tiles with both whole-H operands in
// shared memory, loaded synchronously, a warp-per-row online logsumexp
// through an fp32 shared tile).
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
//
// Tensor-parallel mode (a vocabulary-parallel decode, the table and bias a
// rank's rows [vocab_start, vocab_start + V)): labels stay global, a row's
// label picks a column only inside the rank's range, and a label outside
// it picks nothing while the row still counts. The forward then writes the
// rank's (lse, picked) (`picked` not null) for the model group to combine;
// the backward takes the group's lse and returns dx as this rank's partial
// (parallel/tensor.py:vocab_parallel_nll).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mvlt {
namespace {

using namespace hopper;

struct FwdArgs {
  Mat x, e;
  const float* bias;
  const int* labels;
  float* ws;  // [vocab tiles][rows][3] partials (max, sum of exp, picked)
  int rows, vocab, chunks, vocab_start;
};

__global__ void __launch_bounds__(kGemmThreads, 1) mlm_ce_fwd_kernel(FwdArgs a) {
  extern __shared__ char smem_raw[];
  const int m0 = blockIdx.x * kGemmTile, n0 = blockIdx.y * kGemmTile;
  float d[64];
  mma_tile<false, false>(a.x, a.e, m0, n0, 0, a.chunks, smem_u32(align1024(smem_raw)), d);

  // thread rows rl and rl + 8 of the tile, columns 8j + cq, + 1
  const int rl = tile_row(), cq = tile_col();
  float mx[2] = {-INFINITY, -INFINITY}, picked[2] = {0.0f, 0.0f};
  int lab[2];  // the label's column in this rank's range; -1 for none (or ignored)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + rl + 8 * h;
    const int l = r < a.rows ? a.labels[r] : -1;
    const int c = l - a.vocab_start;
    lab[h] = l >= 0 && c >= 0 && c < a.vocab ? c : -1;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, v = n0 + 8 * j + cq + (e & 1);
      const float l = v < a.vocab ? d[4 * j + e] + a.bias[v] : -INFINITY;
      d[4 * j + e] = l;
      mx[h] = fmaxf(mx[h], l);
      if (v == lab[h]) picked[h] = l;
    }
  }
  float sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float nm = -mx[h] * kLog2e;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      s += fast_exp2(fmaf(d[4 * j + 2 * h], kLog2e, nm)) +
           fast_exp2(fmaf(d[4 * j + 2 * h + 1], kLog2e, nm));
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    sum[h] = s;
    picked[h] += __shfl_xor_sync(0xffffffffu, picked[h], 1);  // one lane holds it, or none
    picked[h] += __shfl_xor_sync(0xffffffffu, picked[h], 2);
  }
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + rl + 8 * h;
      if (r < a.rows) {
        float* p = a.ws + ((size_t)blockIdx.y * a.rows + r) * 3;
        p[0] = mx[h];
        p[1] = sum[h];
        p[2] = picked[h];
      }
    }
  }
}

// One thread per row: merge the vocabulary tiles' (max, sum, picked) in
// order; nll, or in the tensor-parallel mode the rank's picked logit.
__global__ void mlm_ce_merge_kernel(const float* ws, const int* labels, int rows, int parts,
                                    float* nll, float* lse, bool partial) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < parts; ++s) m = fmaxf(m, ws[((size_t)s * rows + r) * 3]);
  float sum = 0.0f, picked = 0.0f;
  for (int s = 0; s < parts; ++s) {
    const float* p = ws + ((size_t)s * rows + r) * 3;
    sum += p[1] * expf(p[0] - m);
    picked += p[2];
  }
  const float l = m + logf(sum);
  lse[r] = l;
  nll[r] = partial ? picked : labels[r] >= 0 ? l - picked : 0.0f;
}

// ---- backward (wgmma) ----------------------------------------------------

struct DlArgs {
  Mat x, e;
  const float* bias;
  const int* labels;
  const float* lse;
  const float* g;
  bf16* dl;    // [rows_pad][vocab_pad]
  float* dbp;  // [rows_pad / 128][vocab_pad] column sums of each row tile
  int rows, vocab, vocab_pad, chunks, vocab_start;
};

__global__ void __launch_bounds__(kGemmThreads, 1) mlm_ce_dlogits_kernel(DlArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * kGemmTile, n0 = blockIdx.y * kGemmTile;
  float d[64];
  mma_tile<false, false>(a.x, a.e, m0, n0, 0, a.chunks, smem_u32(smem), d);

  // dl in registers: thread rows rl and rl + 8 of the tile, columns 8j + cq, + 1
  const int rl = tile_row(), cq = tile_col();
  int lab[2];
  float nlse[2], g[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + rl + 8 * h;
    const bool in = r < a.rows;
    lab[h] = in ? a.labels[r] : -1;  // global; its column here is lab - vocab_start
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
        dl = g[h] * (v + a.vocab_start == lab[h] ? p - 1.0f : p);
      }
      d[4 * j + e] = dl;
    }
  }

  __syncthreads();  // both warpgroups are done with the ring: it becomes the stage
  bf16* st = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + kGemmTile * kGemmStageLd * 2);  // [8 warps][128]
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(st + (rl + 8 * h) * kGemmStageLd + 8 * j + cq) =
          pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // the column's sum over the warp's 16 rows
      float s = d[4 * j + c] + d[4 * j + 2 + c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[(tid >> 5) * kGemmTile + 8 * j + cq + c] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < kGemmTile * kGemmTile / 8; i += kGemmThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    *reinterpret_cast<uint4*>(a.dl + (size_t)(m0 + r) * a.vocab_pad + n0 + c) =
        *reinterpret_cast<const uint4*>(st + r * kGemmStageLd + c);
  }
  if (tid < kGemmTile) {
    float s = 0.0f;
    for (int w = 0; w < kGemmThreads / 32; ++w) s += red[w * kGemmTile + tid];
    a.dbp[(size_t)blockIdx.x * a.vocab_pad + n0 + tid] = s;
  }
}

template <bool B_MN>
__global__ void __launch_bounds__(kGemmThreads, 1) mlm_ce_gemm_kernel(GemmArgs a) {
  extern __shared__ char smem_raw[];
  gemm_tn_block<B_MN>(a, blockIdx.x * kGemmTile, blockIdx.y * kGemmTile, blockIdx.z,
                      smem_u32(align1024(smem_raw)));
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
// cudaError_t of the launches (0 on success); no synchronisation. h is a
// multiple of 64 (both directions stream it in 64-deep chunks).

// ws: (vocab rounded up to 128) / 128 * rows * 3 floats, the partials.
// vocab_start: the global index of the table's first row (0 in one
// process); with `partial` the nll output holds the rank's picked logit
// (the tensor-parallel mode).
extern "C" int mvlt_mlm_ce_fwd(const void* x, const void* table, const void* bias,
                               const void* labels, void* ws, void* nll, void* lse, int rows,
                               int vocab, int h, int vocab_start, int partial, void* stream) {
  using namespace mvlt;
  if (rows < 1 || vocab < 1 || h < 64 || h % 64 || vocab_start < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare((const void*)mlm_ce_fwd_kernel, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (rows + kGemmTile - 1) / kGemmTile;
  const int vocab_tiles = (vocab + kGemmTile - 1) / kGemmTile;
  const FwdArgs a{Mat{static_cast<const bf16*>(x), h, rows, h},
                  Mat{static_cast<const bf16*>(table), h, vocab, h},
                  static_cast<const float*>(bias), static_cast<const int*>(labels),
                  static_cast<float*>(ws), rows, vocab, h / kGemmChunk, vocab_start};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mlm_ce_fwd_kernel<<<dim3(row_tiles, vocab_tiles), kGemmThreads, kGemmSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlm_ce_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const int*>(labels), rows, vocab_tiles,
      static_cast<float*>(nll), static_cast<float*>(lse), partial != 0);
  return (int)cudaGetLastError();
}

// dl: rows_pad * vocab_pad bf16 and dbp: rows_pad / 128 * vocab_pad floats
// (rows and vocab rounded up to 128); slots: splits * rows * h floats when
// splits > 1 (else unused). dx [rows, h], dtable [vocab, h] and dbias
// [vocab], all fp32. h is a multiple of 64; splits (the vocabulary ranges of
// dx) at least 1, trimmed so that none is empty. vocab_start as the
// forward's; lse is then the model group's, and dx this rank's partial.
extern "C" int mvlt_mlm_ce_bwd(const void* x, const void* table, const void* bias,
                               const void* labels, const void* lse, const void* g, void* dl,
                               void* dbp, void* slots, void* dx, void* dtable, void* dbias,
                               int rows, int vocab, int h, int splits, int vocab_start,
                               void* stream) {
  using namespace mvlt;
  if (rows < 1 || vocab < 1 || h < 64 || h % 64 || splits < 1 || vocab_start < 0)
    return (int)cudaErrorInvalidValue;
  const int rows_pad = (rows + kGemmTile - 1) / kGemmTile * kGemmTile;
  const int vocab_pad = (vocab + kGemmTile - 1) / kGemmTile * kGemmTile;
  cudaError_t err = prepare((const void*)mlm_ce_dlogits_kernel, kGemmSmem);
  if (err == cudaSuccess) err = prepare((const void*)mlm_ce_gemm_kernel<false>, kGemmSmem);
  if (err == cudaSuccess) err = prepare((const void*)mlm_ce_gemm_kernel<true>, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* eb = static_cast<const bf16*>(table);
  bf16* dlb = static_cast<bf16*>(dl);
  const Mat xm{xb, h, rows, h}, em{eb, h, vocab, h}, dlm{dlb, vocab_pad, rows_pad, vocab_pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = rows_pad / kGemmTile, vocab_tiles = vocab_pad / kGemmTile;
  const int m_tiles = (h + kGemmTile - 1) / kGemmTile;

  const DlArgs da{xm, em, static_cast<const float*>(bias), static_cast<const int*>(labels),
                  static_cast<const float*>(lse), static_cast<const float*>(g), dlb,
                  static_cast<float*>(dbp), rows, vocab, vocab_pad, h / kGemmChunk,
                  vocab_start};
  mlm_ce_dlogits_kernel<<<dim3(row_tiles, vocab_tiles), kGemmThreads, kGemmSmem, st>>>(da);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = slot_sum(static_cast<const float*>(dbp), vocab_pad, row_tiles, vocab,
                   static_cast<float*>(dbias), st);
  if (err != cudaSuccess) return (int)err;

  // dx^T = E^T dl^T over the vocabulary, in `splits` ranges
  const int vchunks = vocab_pad / kGemmChunk, per = (vchunks + splits - 1) / splits;
  splits = (vchunks + per - 1) / per;
  float* dx_out = splits > 1 ? static_cast<float*>(slots) : static_cast<float*>(dx);
  const GemmArgs ga{em, dlm, dx_out, (long long)rows * h, h, rows, h, vchunks, per};
  mlm_ce_gemm_kernel<false><<<dim3(m_tiles, row_tiles, splits), kGemmThreads, kGemmSmem, st>>>(ga);
  err = cudaGetLastError();
  if (err == cudaSuccess && splits > 1)
    err = slot_sum(static_cast<const float*>(slots), (long long)rows * h, splits,
                   (long long)rows * h, static_cast<float*>(dx), st);
  if (err != cudaSuccess) return (int)err;

  // dE^T = x^T dl over the rows, in one range
  const int rchunks = rows_pad / kGemmChunk;
  const GemmArgs ge{xm, dlm, static_cast<float*>(dtable), 0, h, vocab, h, rchunks, rchunks};
  mlm_ce_gemm_kernel<true><<<dim3(m_tiles, vocab_tiles, 1), kGemmThreads, kGemmSmem, st>>>(ge);
  return (int)cudaGetLastError();
}
