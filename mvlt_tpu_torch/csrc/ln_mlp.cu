// LN -> fc1 -> GELU -> fc2 -> scaled residual of PVLT training, forward
// (the backward is ln_mlp_bwd.cu):
//   y = x + s[b] * (GELU(LN(x) W1^T + b1) W2^T + b2)
// for x [B, N, D] bf16, W1 [H, D] and W2 [D, H] in torch Linear layout (bf16
// copies of the fp32 masters), b1, b2 and the LN affine fp32, and s [B] fp32,
// the per-sample DropPath scale (mask / keep).
//
// Replaces: mvlt_tpu/ops/fused_mlp.py:_fused_ln_mlp_impl (Pallas body
// _kernel), without its TPU layouts (no 128-lane padding, no
// two-tokens-per-row packing).
//
// What bounds it on the H100: the products, 4.rows.D.H flops (83 GFLOP at
// stage 1, B = 150: 84 us at the bf16 peak) against one read and one write
// of the stream (162 MB, 48 us). The hidden [rows, H] never reaches device
// memory.
//
// Design: one block of 8 warps per tile of TR rows of the flattened
// [B*N, D] stream (the row scale is looked up per row, so a tile may span two
// samples): LN per row by one warp (two-pass statistics), then the hidden in
// 64-wide chunks: fc1 + b1 + GELU into shared memory, fc2 accumulated in fp32
// in shared memory; the residual is read again at the end. The products run
// on common.cuh:gemm_bf16 (wmma), whose B operand -- the weights -- comes
// from L2 with two-row-block tiles and prefetch (gemm_acc's whole-fragment
// sums were 19-34% slower here).

#include <math.h>

#include <initializer_list>

#include "common.cuh"

namespace mvlt {
namespace {

constexpr int kPad = 8;
constexpr int kChunk = 64;  // hidden columns per step

struct FwdArgs {
  const bf16* x;
  const float* gamma;
  const float* beta;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* s;
  bf16* out;
  long long rows;
  int n, d, hidden, tr;
  float eps;
};

__host__ __device__ inline size_t fwd_smem(int tr, int d, size_t* off) {
  size_t o = 0;
  off[0] = o; o += align128((size_t)tr * (d + kPad) * 2);       // LN(x) bf16
  off[1] = o; o += align128((size_t)tr * (kChunk + kPad) * 2);  // GELU chunk bf16
  off[2] = o; o += align128((size_t)tr * d * 4);                // fc2 sum fp32
  off[3] = o; o += kStageBytes;
  return o;
}

__global__ void __launch_bounds__(kThreads) ln_mlp_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int tr = a.tr, d = a.d, ld = d + kPad, ldh = kChunk + kPad;
  const long long r0 = (long long)blockIdx.x * tr;
  const int rows = (int)min((long long)tr, a.rows - r0);
  size_t off[4];
  fwd_smem(tr, d, off);
  bf16* normed = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* hid = reinterpret_cast<bf16*>(smem + off[1]);
  float* y = reinterpret_cast<float*>(smem + off[2]);
  float* stage = reinterpret_cast<float*>(smem + off[3]);
  const int warp = threadIdx.x >> 5;
  const bf16* xb = a.x + r0 * d;

  for (int r = warp; r < tr; r += kWarps) {
    if (r < rows) {
      layer_norm_row_global(xb + (size_t)r * d, d, a.gamma, a.beta, a.eps, normed + r * ld);
    } else {
      for (int c = threadIdx.x & 31; c < d; c += 32) normed[r * ld + c] = __float2bfloat16(0.0f);
    }
  }
  for (int i = threadIdx.x; i < tr * d; i += kThreads) y[i] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < a.hidden; c0 += kChunk) {
    const int cw = min(kChunk, a.hidden - c0);
    gemm_bf16<true, 2>(normed, ld, a.w1 + (size_t)c0 * d, d, tr, cw, d, stage,
                       [&](int r, int c, float v) {
                         hid[r * ldh + c] = __float2bfloat16(gelu_erf(v + a.b1[c0 + c]));
                       });
    __syncthreads();
    gemm_bf16<true, 2>(hid, ldh, a.w2 + c0, a.hidden, tr, d, cw, stage,
                       [&](int r, int c, float v) { y[r * d + c] += v; });
    __syncthreads();
  }

  bf16* ob = a.out + r0 * d;
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const float sc = a.s[(r0 + r) / a.n];
    ob[i] = __float2bfloat16(__bfloat162float(xb[i]) + sc * (y[i] + a.b2[c]));
  }
}

int pick_tile(size_t (*smem)(int, int, size_t*), int d, size_t* bytes) {
  size_t off[4];
  for (int cand : {128, 64, 32, 16}) {
    *bytes = smem(cand, d, off);
    if (*bytes <= kSmemLimit) return cand;
  }
  return 0;
}

}  // namespace
}  // namespace mvlt

// C entries, bound with ctypes. They launch on `stream` and return the
// cudaError_t of the launches (0 on success); no synchronisation.
extern "C" int mvlt_ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* s, void* out, long long rows, int n, int d,
                               int hidden, float eps, void* stream) {
  using namespace mvlt;
  size_t bytes = 0;
  const int tr = pick_tile(fwd_smem, d, &bytes);
  if (!tr) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a{static_cast<const bf16*>(x),    static_cast<const float*>(gamma),
            static_cast<const float*>(beta), static_cast<const bf16*>(w1),
            static_cast<const float*>(b1),  static_cast<const bf16*>(w2),
            static_cast<const float*>(b2),  static_cast<const float*>(s),
            static_cast<bf16*>(out),        rows, n, d, hidden, tr, eps};
  const long long blocks = (rows + tr - 1) / tr;
  ln_mlp_fwd_kernel<<<(unsigned)blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
