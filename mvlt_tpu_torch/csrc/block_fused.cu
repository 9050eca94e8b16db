// Whole transformer block of PVLT serving, one launch per block (kernel B).
//
// Replaces: mvlt_tpu/ops/block_fused.py:fused_block (Pallas body _kernel) and
// its packed stage-1 form mvlt_tpu/ops/block_packed.py:fused_block_p2. It
// computes the same function without their TPU layout (no 128-lane padding,
// no two-tokens-per-row packing, no head-pair stripes):
//   out = h + fc2(gelu(fc1(LN2(h)))),  h = x + proj(attn(LN1(x) Wq + bq, K, V))
// with x [B, N, D] bf16, K and V [B, H, M, hd] bf16 from kernel A, weights in
// torch Linear layout [out, in] bf16, biases and LayerNorm affines fp32.
//
// What bounds it on the H100: the matrix products (Q, logits, P.V, out-proj,
// fc1, fc2), about 2.N.(2D^2 + 2.M.D + 2.D.hidden) flops per sample, against
// one read and one write of the bf16 stream; the weights (5 MB at stage 4)
// and each sample's K/V stay in the 50 MB L2. With the tile in shared memory
// and 255 registers a thread, one block of 8 warps fills an SM, so the
// products wait on the latency of their L2 loads rather than on bandwidth.
//
// Design: one block of 8 warps owns a tile of TR stream rows of one sample and
// keeps everything of that tile in shared memory -- the fp32 residual, its
// LayerNorm'd copy, Q for all heads, one head's K and V, the fp32 logits and
// bf16 probabilities, and a 256-wide chunk of the MLP hidden -- so the stream
// is read once and written once and the hidden never reaches device memory.
// TR is the largest of 64/32/16 whose layout fits the 227 KB of shared memory.
// Products run on the tensor cores through wmma bf16 tiles with fp32
// accumulation (common.cuh:gemm_bf16): a warp multiplies each weight fragment
// it loads from L2 into up to two row blocks and four column blocks, and takes
// the warp tile that needs the fewest rounds of loads. LayerNorm statistics,
// logits and softmax are fp32; GELU is exact erf. The softmax is masked past
// the true K/V length M, and rows past N are computed on zeros and never
// stored. The attention half is attn_half.cuh's, which kernel C shares.
// Measured and dropped: weight tiles staged through shared memory with
// cp.async (double-buffered), and a three-deep ring of weight fragments in
// registers; neither was faster. wgmma and TMA are for later work.

#include <initializer_list>

#include "attn_half.cuh"

namespace mvlt {
namespace {

struct BlockArgs {
  const bf16* x;
  AttnArgs at;
  const float* ln2_w;
  const float* ln2_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int n, d, hidden, tr, chunk;
  float eps2;
};

struct BlockSmem {
  size_t xres, abuf, qall, kv, u2, stage, total;
};

// Shared-memory layout, computed the same way on the host and the device.
// kv holds one head's K, then its V; u2 holds the logits and probabilities
// during attention and the hidden chunk during the MLP.
__host__ __device__ inline BlockSmem block_smem(int tr, int d, int mp, int hd, int chunk) {
  BlockSmem s;
  size_t o = 0;
  s.xres = o;  o += align128((size_t)tr * d * 4);
  s.abuf = o;  o += align128((size_t)tr * (d + kPad) * 2);
  s.qall = o;  o += align128((size_t)tr * (d + kPad) * 2);
  s.kv = o;    o += align128((size_t)mp * (hd + kPad) * 2);
  s.u2 = o;
  const size_t attn = attn_scratch_bytes(tr, mp);
  const size_t mlp = align128((size_t)tr * (chunk + kPad) * 2);
  o += attn > mlp ? attn : mlp;
  s.stage = o; o += kStageBytes;
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads) block_fused_kernel(BlockArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int tr = a.tr, d = a.d, hd = d / a.at.heads, mp = (a.at.m + 15) & ~15;
  const int ld = d + kPad, ldh = a.chunk + kPad;
  const int b = blockIdx.y, n0 = blockIdx.x * tr;
  const int rows = min(tr, a.n - n0);
  const BlockSmem L = block_smem(tr, d, mp, hd, a.chunk);
  float* xres = reinterpret_cast<float*>(smem + L.xres);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.abuf);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.u2);
  float* stage = reinterpret_cast<float*>(smem + L.stage);

  // residual tile, fp32; rows past N are zero and never stored
  load_residual_tile(xres, a.x + ((size_t)b * a.n + n0) * d, tr, d, rows, nullptr);
  __syncthreads();
  attention_half(a.at, b, tr, d, xres, abuf, reinterpret_cast<bf16*>(smem + L.qall),
                 reinterpret_cast<bf16*>(smem + L.kv), reinterpret_cast<float*>(smem + L.u2),
                 stage);

  // ---- MLP half, the hidden in chunks ----
  layer_norm_tile(xres, tr, d, a.ln2_w, a.ln2_b, a.eps2, abuf, ld);
  __syncthreads();
  for (int c0 = 0; c0 < a.hidden; c0 += a.chunk) {
    const int cw = min(a.chunk, a.hidden - c0);
    gemm_bf16<true, 2>(abuf, ld, a.w1 + (size_t)c0 * d, d, tr, cw, d, stage,
                    [&](int r, int c, float v) {
                      hid[r * ldh + c] = __float2bfloat16(gelu_erf(v + a.b1[c0 + c]));
                    });
    __syncthreads();
    gemm_bf16<true, 2>(hid, ldh, a.w2 + c0, a.hidden, tr, d, cw, stage,
                    [&](int r, int c, float v) { xres[r * d + c] += v; });
    __syncthreads();
  }

  bf16* ob = a.out + ((size_t)b * a.n + n0) * d;
  for (int i = threadIdx.x * 8; i < rows * d; i += kThreads * 8) {
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(xres[i + j] + a.b2[(i + j) % d]);
    *reinterpret_cast<uint4*>(ob + i) = raw;
  }
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int mvlt_block_fused(const void* x, const void* k, const void* v,
                                const void* ln1_w, const void* ln1_b, const void* wq,
                                const void* bq, const void* wp, const void* bp,
                                const void* ln2_w, const void* ln2_b, const void* w1,
                                const void* b1, const void* w2, const void* b2, void* out,
                                int batch, int n, int d, int heads, int m, int hidden,
                                float scale, float eps1, float eps2, void* stream) {
  using namespace mvlt;
  const int hd = d / heads, mp = (m + 15) & ~15;
  const int chunk = hidden < 256 ? hidden : 256;
  int tr = 0;
  size_t bytes = 0;
  for (int cand : {64, 32, 16}) {
    bytes = block_smem(cand, d, mp, hd, chunk).total;
    if (bytes <= kSmemLimit) {
      tr = cand;
      break;
    }
  }
  if (!tr) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      block_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const AttnArgs at{static_cast<const bf16*>(k),      static_cast<const bf16*>(v),
                    static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
                    static_cast<const bf16*>(wq),     static_cast<const float*>(bq),
                    static_cast<const bf16*>(wp),     static_cast<const float*>(bp),
                    heads, m, scale, eps1};
  BlockArgs a{static_cast<const bf16*>(x),      at,
              static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b),
              static_cast<const bf16*>(w1),     static_cast<const float*>(b1),
              static_cast<const bf16*>(w2),     static_cast<const float*>(b2),
              static_cast<bf16*>(out),          n, d, hidden, tr, chunk, eps2};
  dim3 grid((n + tr - 1) / tr, batch);
  block_fused_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
