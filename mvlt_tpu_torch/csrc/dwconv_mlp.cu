// MLP half of a PVT-v2 serving block (kernel D), a chain of launches on
// wgmma (hopper.cuh) over bf16 scratch in device memory.
//
// Replaces: mvlt_tpu/ops/dwconv_mlp.py:fused_dwconv_mlp (Pallas body _kernel,
// on the lane-padded stream of stages 2-4) and fused_dwconv_mlp_p2 (body
// _kernel_p2, on the packed stage-1 stream, whose halo crosses the lane
// halves). It computes their function without their TPU layouts:
//   out = x + fc2(GELU(z)) + b2,  z = dwconv3x3(fc1(LN2(x))) + b_dw on the h*w
//   visual rows (zero padding at the grid's borders), z = fc1(LN2(x)) on the
//   T text rows after them
// with x [B, N, D] bf16 (N = h*w + T, visual rows in row-major (y, x) order),
// fc1/fc2 weights in torch Linear layout bf16, the depthwise weight
// [hidden, 1, 3, 3] bf16, biases and LayerNorm affines fp32. The fc1 output
// is rounded to bf16 before the conv, as the Pallas kernel does; the conv
// sums in fp32, GELU is exact erf.
//
// What bounds it on the H100: fc1 and fc2, 4.N.D.hidden flops a sample, and
// the conv's 18.h.w.hidden, against one read and one write of the stream:
// operations (0.060-0.083 ms a stage at B = 101). At D <= 128 the bf16
// hidden that a chain writes and reads again outweighs the products (H1 and
// G are 437 MB each at stage 1, B = 101).
//
// Design. On the TPU a whole sample's image sits in VMEM and a sequential
// grid axis walks the hidden chunks; here the conv's halo (the grid rows
// above and below a tile) needs the fc1 output of rows another block
// computes, so fc1 and the conv are separate launches:
//   1. LN2(x) -> bf16 [rows, D]: #12's ln_mlp_fwd_norm_kernel;
//   2. H1 = LN2(x) W1^T + b1 -> bf16 [rows, hidden]: #12's
//      ln_mlp_fwd_hidden_kernel with GELU off (mma_tile, 128 x 128 tiles);
//   3. the conv, its bias and GELU (GELU alone on the text rows) ->
//      G bf16 [rows, hidden]: dwconv_stencil_kernel, a thread for 8
//      channels of 4 neighbouring tokens of a grid row (16-byte loads, so
//      each tap is a coalesced read along the channels, mostly from L1/L2;
//      the taps and each loaded H1 value serve 4 outputs);
//   4. y = x + G W2^T + b2: #12's ln_mlp_fwd_out_kernel without a row scale.
// #12's kernels run through ln_mlp.cuh under DwConvRoute. A fused form
// that merged 3 into 4 (each 128-row fc2 tile forming conv + GELU of its
// rows from H1 straight into its A operand, G never written) lost the A/B
// of scripts/probe_dwconv_swin.py at every v2 stage and was dropped; its
// times are in PERF.md section 6.
//
// The trap is the conv's halo: a token's neighbours are taken by grid
// (y, x), each side checked against the grid's borders, never by the flat
// row index, so a token's left or right neighbour never wraps into the
// previous or next grid row.

#include "ln_mlp.cuh"

namespace mvlt {
namespace {

using namespace hopper;

struct DwArgs {
  const bf16* h1;    // [rows, hidden] fc1 output, b1 added
  const bf16* wdw;   // [hidden, 9] depthwise taps
  const float* bdw;  // [hidden]
  bf16* g;           // [rows, hidden] the GELU output
  int h, w, n, hidden;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// Value k of the bf16 values packed in r, as fp32 (k a constant after unrolling).
__device__ __forceinline__ float bf16_at(const uint4 (&r)[9], int k) {
  const uint4& q = r[k >> 3];
  const int j = (k >> 1) & 3;
  const uint32_t word = j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
}

constexpr int kRun = 4;  // tokens of one grid row (or text rows) a stencil thread takes

// Step 3: G = GELU(conv(H1) + b_dw) (text rows GELU(H1)). Block row
// blockIdx.y is a sample; a thread takes 8 channels of kRun neighbouring
// tokens of one grid row, so that its taps (converted once) and each H1
// value it loads (3 rows of kRun + 2 tokens) serve kRun outputs;
// neighbouring threads take neighbouring channels.
__global__ void __launch_bounds__(kThreads) dwconv_stencil_kernel(DwArgs a) {
  const int groups = a.hidden / 8, runs = (a.w + kRun - 1) / kRun, vis = a.h * runs;
  const int units = vis + (a.n - a.h * a.w + kRun - 1) / kRun;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= units * groups) return;
  const int u = i / groups, c0 = (i - u * groups) * 8;
  const bf16* h1 = a.h1 + (size_t)blockIdx.y * a.n * a.hidden + c0;
  bf16* g = a.g + (size_t)blockIdx.y * a.n * a.hidden + c0;
  float z[kRun][8];
  if (u >= vis) {  // text rows: GELU(H1) alone
    const int r0 = a.h * a.w + (u - vis) * kRun;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (r0 + k >= a.n) break;
      unpack8(*reinterpret_cast<const uint4*>(h1 + (size_t)(r0 + k) * a.hidden), z[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) z[k][e] = gelu_erf(z[k][e]);
      *reinterpret_cast<uint4*>(g + (size_t)(r0 + k) * a.hidden) = pack_bf16x8(z[k]);
    }
    return;
  }
  const int y = u / runs, x0 = (u - y * runs) * kRun;
  uint4 wr[9];  // the 8 channels' taps, [8][9] bf16 contiguous
  const uint4* wsrc = reinterpret_cast<const uint4*>(a.wdw + (size_t)c0 * 9);
#pragma unroll
  for (int j = 0; j < 9; ++j) wr[j] = wsrc[j];
#pragma unroll
  for (int k = 0; k < kRun; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) z[k][e] = a.bdw[c0 + e];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= a.h) continue;
    uint4 v[kRun + 2];  // grid columns x0 - 1 .. x0 + kRun of row yy; zeros past the borders
#pragma unroll
    for (int j = 0; j < kRun + 2; ++j) {
      const int xx = x0 - 1 + j;
      const bool in = xx >= 0 && xx < a.w;
      v[j] = in ? *reinterpret_cast<const uint4*>(h1 + (size_t)(yy * a.w + xx) * a.hidden)
                : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kRun + 2; ++j) {
      float f[8];
      unpack8(v[j], f);
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int k = j - 1 - dx;  // the output token whose tap (dy, dx) column j is
        if (k < 0 || k >= kRun) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          z[k][e] = fmaf(f[e], bf16_at(wr, e * 9 + (dy + 1) * 3 + dx + 1), z[k][e]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (x0 + k >= a.w) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) z[k][e] = gelu_erf(z[k][e]);
    *reinterpret_cast<uint4*>(g + (size_t)(y * a.w + x0 + k) * a.hidden) = pack_bf16x8(z[k]);
  }
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. Launches the chain on `stream` and returns the
// first failing cudaError_t (0 on success); it does not synchronise. D a
// multiple of 16 and at most 512, hidden a multiple of 16. `scratch` holds
// H1 bf16 [rows, hidden], then LN2(x) bf16 [rows, D] whose space G [rows,
// hidden] takes over in the chain: rows * (hidden + max(D, hidden)) bf16
// (ops/dwconv_mlp.py:scratch_elems).
extern "C" int mvlt_dwconv_mlp(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* b1, const void* wdw, const void* bdw, const void* w2,
                               const void* b2, void* out, void* scratch, int batch, int h, int w,
                               int t, int d, int hidden, float eps, void* stream) {
  using namespace mvlt;
  const long long rows = (long long)batch * (h * w + t);
  if (batch < 1 || h < 1 || w < 1 || t < 0 || rows > (1LL << 30) || d < 16 || d > 512 ||
      d % 16 || hidden < 16 || hidden % 16)
    return (int)cudaErrorInvalidValue;
  bf16* h1 = static_cast<bf16*>(scratch);
  bf16* rest = h1 + rows * hidden;  // LN2(x), then G
  LnMlpArgs la{static_cast<const bf16*>(x),
               static_cast<const float*>(ln_w),
               static_cast<const float*>(ln_b),
               static_cast<const bf16*>(w1),
               static_cast<const float*>(b1),
               static_cast<const bf16*>(w2),
               static_cast<const float*>(b2),
               nullptr,
               static_cast<bf16*>(out),
               rest,
               h1,
               (int)rows,
               h * w + t,
               d,
               hidden,
               eps};
  const DwArgs da{h1, static_cast<const bf16*>(wdw), static_cast<const float*>(bdw), rest,
                  h, w, h * w + t, hidden};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ln_mlp_fwd_norm<DwConvRoute>(la, st);
  if (err == cudaSuccess) err = ln_mlp_fwd_hidden<DwConvRoute, false>(la, st);
  if (err != cudaSuccess) return (int)err;
  la.g = rest;  // fc2 reads G
  const int units = (h * ((w + kRun - 1) / kRun) + (t + kRun - 1) / kRun) * (hidden / 8);
  dwconv_stencil_kernel<<<dim3((units + kThreads - 1) / kThreads, batch), kThreads, 0, st>>>(da);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = ln_mlp_fwd_out<DwConvRoute>(la, st);
  return (int)err;
}
