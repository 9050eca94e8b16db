// MLP half of a PVT-v2 serving block, one launch per block (kernel D).
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
// [hidden, 1, 3, 3] bf16, biases and LayerNorm affines fp32. The fc1 output is
// rounded to bf16 before the conv, as the Pallas kernel does; the conv sums
// in fp32, GELU is exact erf.
//
// What bounds it on the H100: fc1 and fc2, 4.N.D.hidden flops per sample,
// plus 18.h.w.hidden for the conv, against one read and one write of the
// stream: operations.
//
// The hard part is the conv's halo. On the TPU a whole sample's image sits in
// VMEM and a sequential grid axis walks the hidden chunks; here the fc1
// output of one sample (4,096 x 512 fp32 at stage 1) is far larger than a
// block's 227 KB of shared memory. Design: one block of 8 warps per (sample,
// band of grid rows), plus blocks of text rows. A visual block LayerNorms its
// band and one halo grid row above and below (rows outside the grid are not
// loaded: the conv's zero padding), then walks the hidden width in chunks:
// fc1 of band + halo into shared memory (the halo rows recomputed, never
// exchanged between blocks), the nine taps per output as (row, column)
// neighbours checked against the grid's borders -- so a token's left or right
// neighbour never wraps into the previous or next grid row -- plus the conv
// bias and GELU, then fc2 of the chunk added into the block's fp32 residual
// tile. Text blocks skip the conv and its bias. Each row is written once. The
// band is the one that minimises the rows of fc1 and fc2 per sample within an
// output tile of 128 rows; the chunk the widest that then fits.

#include <initializer_list>

#include "attn_half.cuh"

namespace mvlt {
namespace {

struct DwArgs {
  const bf16* x;
  const float* ln_w;
  const float* ln_b;
  const bf16* w1;
  const float* b1;
  const bf16* wdw;
  const float* bdw;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int h, w, t, n, d, hidden;
  int band;    // grid rows of a visual block
  int mp;      // output rows a block holds (a multiple of 16; also a text block's rows)
  int nbands;  // visual blocks per sample
  int chunk;   // hidden columns per pass
  float eps;
};

struct DwSmem {
  size_t xres, normed, hid, act, taps, stage, total;
};

// xres: the fp32 residual [mp, d]; normed: LN2 of band + halo, bf16
// [hp, d + kPad]; hid: the fc1 chunk of band + halo; act: GELU of the
// chunk's conv output [mp, chunk + kPad]; taps: the chunk's nine taps, fp32.
__host__ __device__ inline DwSmem dw_smem(int mp, int hp, int d, int chunk) {
  DwSmem s;
  size_t o = 0;
  s.xres = o;   o += align128((size_t)mp * d * 4);
  s.normed = o; o += align128((size_t)hp * (d + kPad) * 2);
  s.hid = o;    o += align128((size_t)hp * (chunk + kPad) * 2);
  s.act = o;    o += align128((size_t)mp * (chunk + kPad) * 2);
  s.taps = o;   o += align128((size_t)9 * chunk * 4);
  s.stage = o;  o += kStageBytes;
  s.total = o;
  return s;
}

// fc1 rows of a visual block of `band` grid rows: band + halo, clipped to the
// grid, rounded up to whole 16-row blocks
__host__ __device__ inline int dw_halo_rows(int band, int h, int w) {
  return ((band + 2 < h ? band + 2 : h) * w + 15) & ~15;
}

__global__ void __launch_bounds__(kThreads) dwconv_mlp_kernel(DwArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int d = a.d, w = a.w, b = blockIdx.y;
  const int ld = d + kPad, ldh = a.chunk + kPad;
  const DwSmem L = dw_smem(a.mp, dw_halo_rows(a.band, a.h, w), d, a.chunk);
  float* xres = reinterpret_cast<float*>(smem + L.xres);
  bf16* normed = reinterpret_cast<bf16*>(smem + L.normed);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* taps = reinterpret_cast<float*>(smem + L.taps);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // rows [row0, row0 + rows) are this block's output; rows [lrow0, lrow0 +
  // lrows) go through LN2 and fc1 (a visual band plus its halo grid rows)
  const bool visual = blockIdx.x < a.nbands;
  int y0 = 0, g_lo = 0, row0, rows, lrow0, lrows;
  if (visual) {
    y0 = blockIdx.x * a.band;
    g_lo = max(0, y0 - 1);
    row0 = y0 * w;
    rows = min(a.band, a.h - y0) * w;
    lrow0 = g_lo * w;
    lrows = (min(a.h, y0 + a.band + 1) - g_lo) * w;
  } else {
    row0 = a.h * w + (blockIdx.x - a.nbands) * a.mp;
    rows = min(a.mp, a.n - row0);
    lrow0 = row0;
    lrows = rows;
  }
  const int frows = (lrows + 15) & ~15, orows = (rows + 15) & ~15;
  const bf16* xs = a.x + (size_t)b * a.n * d;

  // residual + fc2 bias, fp32; rows past the block's are zero and never stored
  load_residual_tile(xres, xs + (size_t)row0 * d, orows, d, rows, a.b2);
  for (int r = warp; r < frows; r += kWarps) {
    bf16* dst = normed + (size_t)r * ld;
    if (r < lrows) {
      layer_norm_row_global(xs + (size_t)(lrow0 + r) * d, d, a.ln_w, a.ln_b, a.eps, dst);
    } else {
      for (int c = lane; c < d; c += 32) dst[c] = __float2bfloat16(0.0f);
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < a.hidden; c0 += a.chunk) {
    const int cw = min(a.chunk, a.hidden - c0);
    const bf16* w1c = a.w1 + (size_t)c0 * d;
    if (visual) {
      for (int i = threadIdx.x; i < 9 * cw; i += kThreads) {
        const int k = i / cw, c = i - k * cw;
        taps[k * cw + c] = __bfloat162float(a.wdw[(size_t)(c0 + c) * 9 + k]);
      }
      gemm_bf16<true, 2>(normed, ld, w1c, d, frows, cw, d, stage, [&](int r, int c, float v) {
        hid[r * ldh + c] = __float2bfloat16(v + a.b1[c0 + c]);
      });
      __syncthreads();
      // the 3x3 depthwise conv of the band's rows, neighbours by grid
      // (row, column); a neighbour outside the grid is the zero padding
      for (int i = threadIdx.x; i < orows * cw; i += kThreads) {
        const int r = i / cw, c = i - r * cw;
        float z = 0.0f;
        if (r < rows) {
          const int y = y0 + r / w, xc = r % w;
          z = a.bdw[c0 + c];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int yy = y + dy - 1;
            if (yy < 0 || yy >= a.h) continue;
            const bf16* src = hid + (size_t)(yy - g_lo) * w * ldh + c;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int xx = xc + dx - 1;
              if (xx < 0 || xx >= w) continue;
              z += taps[(dy * 3 + dx) * cw + c] * __bfloat162float(src[xx * ldh]);
            }
          }
          z = gelu_erf(z);
        }
        act[r * ldh + c] = __float2bfloat16(z);
      }
    } else {
      gemm_bf16<true, 2>(normed, ld, w1c, d, orows, cw, d, stage, [&](int r, int c, float v) {
        act[r * ldh + c] = __float2bfloat16(gelu_erf(v + a.b1[c0 + c]));
      });
    }
    __syncthreads();
    gemm_bf16<true, 2>(act, ldh, a.w2 + c0, a.hidden, orows, d, cw, stage,
                       [&](int r, int c, float v) { xres[r * d + c] += v; });
    __syncthreads();
  }

  bf16* ob = a.out + ((size_t)b * a.n + row0) * d;
  for (int i = threadIdx.x * 8; i < rows * d; i += kThreads * 8) {
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(xres[i + j]);
    *reinterpret_cast<uint4*>(ob + i) = raw;
  }
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int mvlt_dwconv_mlp(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* b1, const void* wdw, const void* bdw, const void* w2,
                               const void* b2, void* out, int batch, int h, int w, int t, int d,
                               int hidden, float eps, void* stream) {
  using namespace mvlt;
  // the band with the fewest fc1 + fc2 rows per sample (halo recompute
  // against the last band's padding), output tiles of at most 128 rows, with
  // the widest hidden chunk (at least 64 columns, or the whole hidden) that
  // fits; ties go to the wider chunk
  int band = 0, chunk = 0;
  long long best = -1;
  size_t bytes = 0;
  const int max_band = w >= 128 ? 1 : (128 / w < h ? 128 / w : h);
  for (int rb = 1; rb <= max_band; ++rb) {
    const int mp = (rb * w + 15) & ~15, hp = dw_halo_rows(rb, h, w);
    for (int cand : {256, 128, 64}) {
      const int ch = cand < hidden ? cand : hidden;
      const size_t need = dw_smem(mp, hp, d, ch).total;
      if (need > kSmemLimit) continue;
      const long long rows = (long long)((h + rb - 1) / rb) * (hp + mp);
      if (best < 0 || rows < best || (rows == best && ch > chunk)) {
        best = rows;
        band = rb;
        chunk = ch;
        bytes = need;
      }
      break;
    }
  }
  if (!band) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      dwconv_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int mp = (band * w + 15) & ~15, nbands = (h + band - 1) / band;
  DwArgs a{static_cast<const bf16*>(x),   static_cast<const float*>(ln_w),
           static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
           static_cast<const float*>(b1), static_cast<const bf16*>(wdw),
           static_cast<const float*>(bdw), static_cast<const bf16*>(w2),
           static_cast<const float*>(b2), static_cast<bf16*>(out),
           h, w, t, h * w + t, d, hidden, band, mp, nbands, chunk, eps};
  dim3 grid(nbands + (t + mp - 1) / mp, batch);
  dwconv_mlp_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
