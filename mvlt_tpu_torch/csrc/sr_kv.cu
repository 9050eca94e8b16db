// K/V front end of a PVLT block (kernel A), a chain of wgmma launches over
// scratch in device memory.
//
// Replaces: mvlt_tpu/ops/sr_kv.py:fused_ln_sr_kv (Pallas body _kv_kernel) and
// its packed stage-1 form mvlt_tpu/ops/block_packed.py:fused_ln_sr_kv_p2.
// Same function, plain layout: K and V come out as [B, H, M, hd] bf16 with
// exactly M rows (no 128-row padding, no head stripes, text rows in order).
//   kv_in = [SR-LN(SRconv(LN1(x_vis))) ; LN1(x_text)]   (sr > 1)
//   kv_in = LN1(x)                                       (sr == 1, M = N)
//   K, V  = split(kv_in . Wkv^T + bkv) per head
// x [B, h*w + T, D] bf16; Wsr is the torch conv weight OIHW [D, D, sr, sr]
// laid out by the wrapper as [D_out, (r, s, c_in)] so that one contraction row
// is the space-to-depth row of a reduced pixel; Wkv is the torch Linear
// weight [2D, D].
//
// What bounds it on the H100: bytes. At stage 1 (B = 101) the stream is read
// once (54.6 MB, 16 us at 3.35 TB/s) against 2.B.h.w.D^2 = 3.4 GFLOP of SR
// conv (3.4 us at the bf16 peak); the K/V products are small (M = 192 rows a
// sample at every pvlt_tiny stage).
//
// Design: four launches at sr > 1, two at sr == 1, all under SrKvRoute
// (common.cuh), so that a profile books them to kernel A:
//   1. LN1(x) -> nrm bf16 [B*N, D] by #12's norm kernel (one warp a row,
//      two-pass fp32 statistics).
//   2. (sr > 1) the SR conv as one product [B*p, sr*sr*D] x Wsr^T on
//      hopper.cuh:mma_tile_from (sr_conv_gemm_kernel), whose load_a gathers
//      the space-to-depth operand straight from nrm by cp.async, one 16-byte
//      chunk (8 channels of one pixel) at a time: contraction column k of
//      reduced pixel (b, py, px) is nrm[b, (py sr + r) w + px sr + s, c] with
//      (r, s, c) = unravel(k, (sr, sr, D)). A chunk never straddles two
//      pixels (D is a multiple of 16), whatever D is against the 64-column
//      ring stage (D = 96 puts a stage across two pixels). The operand never
//      exists in device memory. With B*p = 6,464 rows at every sr > 1 stage
//      at B = 101, the 128 x 128 output tiles alone would fill 51 of 132
//      SMs, so the contraction is split into `splits` ranges
//      (ops/sr_kv.py:conv_splits, from the shapes and the SM count), each
//      writing its own fp32 slot [splits, B*p, D]: no atomics.
//   3. (sr > 1) one warp a K/V-input row (sr_ln_rows_kernel): a reduced row
//      sums the slots in order (so repeats are bit-equal), adds the bias
//      rounded to bf16, and rounds the sum to bf16, where the plain version's
//      bf16 conv (bf16 weight and bias, fp32 sum) rounds its output; then
//      SR-LN with two-pass fp32 statistics into kvin bf16 [B, M, D]. A text
//      row is copied from nrm as it is (LN1 only, not SR-LN).
//   4. K, V = kvin Wkv^T + bkv (nrm at sr == 1) on mma_tile with K = D
//      (kv_proj_gemm_kernel; two blocks an SM at D <= 128), the epilogue
//      adding bkv in fp32 and storing each 8-column group, rounded once, into
//      its head of K or V [B, H, M, hd].

#include "ln_mlp.cuh"

namespace mvlt {
namespace {

using namespace hopper;

struct SrKvArgs {
  const bf16* nrm;    // LN1(x) [B*N, D]
  const bf16* wsr;    // [D, sr*sr*D]
  const float* bsr;
  const float* srn_w;
  const float* srn_b;
  const bf16* wkv;    // [2D, D]
  const float* bkv;
  float* slots;       // [splits, B*p, D]
  bf16* kvin;         // [B*M, D]
  bf16* k;            // [B, H, M, hd]
  bf16* v;
  int batch, n, w, d, heads, sr, p, m, splits, per_split;
  float eps_sr;
};

// Rows of the gathered operand that one thread fills in each ring stage
// (load_operand's K-major order: chunk i = tid + kGemmThreads j is row
// i / 8, column chunk i % 8).
constexpr int kRowsPerThread = kGemmTile * 8 / kGemmThreads;

// One split's share of the SR conv: the block's 128 x 128 tile of
// gather(nrm) Wsr^T over contraction chunks [c0, c1), into its slot.
template <class Route>
__global__ void __launch_bounds__(kGemmThreads, 1) sr_conv_gemm_kernel(SrKvArgs a) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int dtiles = (a.d + kGemmTile - 1) / kGemmTile, rows = a.batch * a.p;
  const int m0 = (blockIdx.x / dtiles) * kGemmTile, n0 = (blockIdx.x % dtiles) * kGemmTile;
  const int kdim = a.sr * a.sr * a.d, chunks = (kdim + kGemmChunk - 1) / kGemmChunk;
  const int c0 = blockIdx.y * a.per_split, c1 = min(chunks, c0 + a.per_split);
  // the thread's 16-byte column chunk and, per row it fills, the offset of
  // the reduced pixel's first stream row (-1 past the last reduced pixel)
  const int cc = threadIdx.x & 7, pw = a.w / a.sr;
  long long base[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = m0 + (threadIdx.x >> 3) + j * (kGemmThreads / 8);
    const int b = row / a.p, pix = row - b * a.p, py = pix / pw, px = pix - py * pw;
    base[j] = row < rows
                  ? ((long long)b * a.n + (long long)py * a.sr * a.w + px * a.sr) * a.d
                  : -1;
  }
  auto load_a = [&](uint32_t dst, int k0) {
    const int k = k0 + cc * 8, rs = k / a.d, ch = k - rs * a.d;
    const int r = rs / a.sr, s = rs - r * a.sr;
    const long long off = ((long long)r * a.w + s) * a.d + ch;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const bool ok = k < kdim && base[j] >= 0;
      cp_async16_zfill(dst + tile_off<128>((threadIdx.x >> 3) + j * (kGemmThreads / 8), cc),
                       ok ? a.nrm + base[j] + off : a.nrm, ok);
    }
  };
  float acc[64];
  mma_tile_from<false, false>(load_a, Mat{a.wsr, kdim, a.d, kdim}, n0, c0, c1, smem_u32(smem),
                              acc);
  float* slot = a.slots + (size_t)blockIdx.y * rows * a.d;
  store_tile(acc, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    if (m0 + r >= rows || n0 + c >= a.d) return;
    float4* o = reinterpret_cast<float4*>(slot + (size_t)(m0 + r) * a.d + n0 + c);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  });
}

// P column pairs of a row a lane (2 lane + 64 p, + 1) to bf16.
template <int P>
__device__ __forceinline__ void store_row(bf16* dst, const float2 (&v)[P], int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (2 * lane + 64 * p < d) store_bf16x2(dst + 2 * lane + 64 * p, v[p].x, v[p].y);
}

// Row j of sample b of the K/V input, one warp a row: SR-LN of the reduced
// pixel's conv (j < p) or the text row of nrm (j >= p).
template <int P, class Route>
__global__ void __launch_bounds__(kThreads) sr_ln_rows_kernel(SrKvArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= a.batch * a.m) return;
  const int b = row / a.m, j = row - b * a.m, d = a.d;
  const bool text = j >= a.p;
  const size_t stride = (size_t)a.batch * a.p * d;
  const float* conv = a.slots + ((size_t)b * a.p + j) * d;
  const bf16* src = a.nrm + ((size_t)b * a.n + a.n - a.m + j) * d;
  float2 v[P];
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    v[p] = make_float2(0.0f, 0.0f);
    if (c >= d) continue;
    if (text) {
      v[p] = load_bf16x2(src + c);
    } else {
      float2 acc = make_float2(0.0f, 0.0f);
      for (int s = 0; s < a.splits; ++s) {
        const float2 part = *reinterpret_cast<const float2*>(conv + s * stride + c);
        acc.x += part.x, acc.y += part.y;
      }
      const float2 bias = __bfloat1622float2(__floats2bfloat162_rn(a.bsr[c], a.bsr[c + 1]));
      v[p] = __bfloat1622float2(__floats2bfloat162_rn(acc.x + bias.x, acc.y + bias.y));
    }
    sum += v[p].x + v[p].y;
  }
  bf16* dst = a.kvin + (size_t)row * d;
  if (text) return store_row<P>(dst, v, d);
  const float mean = warp_sum(sum) / d;
  float var = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (2 * lane + 64 * p < d) {
      const float z0 = v[p].x - mean, z1 = v[p].y - mean;
      var += z0 * z0 + z1 * z1;
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / d + a.eps_sr);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = 2 * lane + 64 * p;
    if (c < d)
      v[p] = make_float2((v[p].x - mean) * rstd * a.srn_w[c] + a.srn_b[c],
                         (v[p].y - mean) * rstd * a.srn_w[c + 1] + a.srn_b[c + 1]);
  }
  store_row<P>(dst, v, d);
}

// K, V = src Wkv^T + bkv for src [B*M, D], a 128 x 128 tile a block, row
// tile major; columns c < D go to K, the rest to V, head (c mod D) / hd.
template <class Route>
__global__ void __launch_bounds__(kGemmThreads, 1) kv_proj_gemm_kernel(SrKvArgs a,
                                                                       const bf16* src) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int rows = a.batch * a.m, cols = 2 * a.d, ctiles = (cols + kGemmTile - 1) / kGemmTile;
  const int m0 = (blockIdx.x / ctiles) * kGemmTile, n0 = (blockIdx.x % ctiles) * kGemmTile;
  float acc[64];
  mma_tile<false, false>(Mat{src, a.d, rows, a.d}, Mat{a.wkv, a.d, cols, a.d}, m0, n0, 0,
                         (a.d + kGemmChunk - 1) / kGemmChunk, smem_u32(smem), acc);
  const int hd = a.d / a.heads;
  store_tile(acc, reinterpret_cast<float*>(smem), [&](int r, int c, float (&v)[8]) {
    const int row = m0 + r, col = n0 + c;
    if (row >= rows || col >= cols) return;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += a.bkv[col + e];
    const bool is_v = col >= a.d;
    const int cv = is_v ? col - a.d : col, head = cv / hd, b = row / a.m;
    bf16* dst = (is_v ? a.v : a.k) +
                (((size_t)b * a.heads + head) * a.m + row - b * a.m) * hd + cv - head * hd;
    *reinterpret_cast<uint4*>(dst) = pack_bf16x8(v);
  });
}

template <int P>
cudaError_t launch_rows(const SrKvArgs& a, cudaStream_t st) {
  const long long rows = (long long)a.batch * a.m;
  sr_ln_rows_kernel<P, SrKvRoute>
      <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

int tiles(long long rows, int cols) {
  return (int)((rows + kGemmTile - 1) / kGemmTile) * ((cols + kGemmTile - 1) / kGemmTile);
}

}  // namespace
}  // namespace mvlt

// C entry, bound with ctypes. wsr, bsr, srn_w, srn_b, slots and kvin are
// ignored when sr == 1. The scratch (ops/sr_kv.py:scratch): nrm B * N * D
// bf16, slots splits * B * p * D floats, kvin B * M * D bf16. `splits`
// ranges of the SR conv's contraction, none of them empty. D a multiple of
// 16 and at most 512, head dim a multiple of 8. Launches on `stream` and
// returns the first failing cudaError_t (0 on success); it does not
// synchronise.
extern "C" int mvlt_sr_kv(const void* x, const void* ln1_w, const void* ln1_b,
                          const void* wsr, const void* bsr, const void* srn_w,
                          const void* srn_b, const void* wkv, const void* bkv, void* k,
                          void* v, void* nrm, void* slots, void* kvin, int batch, int h, int w,
                          int t, int d, int heads, int sr, int splits, float eps1, float eps_sr,
                          void* stream) {
  using namespace mvlt;
  using namespace mvlt::hopper;
  const int n = h * w + t;
  const int p = sr > 1 ? (h / sr) * (w / sr) : 0;
  const int m = sr > 1 ? p + t : n;
  const int chunks = (sr * sr * d + kGemmChunk - 1) / kGemmChunk;
  const int per_split = splits >= 1 ? (chunks + splits - 1) / splits : 0;
  const long long rows = (long long)batch * n;
  if (batch < 1 || h < 1 || w < 1 || t < 0 || d < 16 || d > 512 || d % 16 || heads < 1 ||
      d % heads || (d / heads) % 8 || sr < 1 || rows > (1LL << 30) ||
      (sr > 1 && (h % sr || w % sr || splits < 1 || (splits - 1) * per_split >= chunks)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  LnMlpArgs ln{};
  ln.x = static_cast<const bf16*>(x);
  ln.gamma = static_cast<const float*>(ln1_w);
  ln.beta = static_cast<const float*>(ln1_b);
  ln.nrm = static_cast<bf16*>(nrm);
  ln.rows = (int)rows;
  ln.n = n;
  ln.d = ln.hidden = d;
  ln.eps = eps1;
  cudaError_t err = ln_mlp_fwd_norm<SrKvRoute>(ln, st);
  if (err != cudaSuccess) return (int)err;
  const SrKvArgs a{static_cast<const bf16*>(nrm),    static_cast<const bf16*>(wsr),
                   static_cast<const float*>(bsr),   static_cast<const float*>(srn_w),
                   static_cast<const float*>(srn_b), static_cast<const bf16*>(wkv),
                   static_cast<const float*>(bkv),   static_cast<float*>(slots),
                   static_cast<bf16*>(kvin),         static_cast<bf16*>(k),
                   static_cast<bf16*>(v),            batch,
                   n,                                w,
                   d,                                heads,
                   sr,                               p,
                   m,                                splits,
                   per_split,                        eps_sr};
  if (sr > 1) {
    err = allow_dynamic_smem((const void*)sr_conv_gemm_kernel<SrKvRoute>, kGemmSmem);
    if (err != cudaSuccess) return (int)err;
    sr_conv_gemm_kernel<SrKvRoute>
        <<<dim3(tiles((long long)batch * p, d), splits), kGemmThreads, gemm_smem(per_split),
           st>>>(a);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = d <= 64    ? launch_rows<1>(a, st)
            : d <= 128 ? launch_rows<2>(a, st)
            : d <= 256 ? launch_rows<4>(a, st)
                       : launch_rows<8>(a, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = allow_dynamic_smem((const void*)kv_proj_gemm_kernel<SrKvRoute>, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  kv_proj_gemm_kernel<SrKvRoute>
      <<<tiles((long long)batch * m, 2 * d), kGemmThreads,
         gemm_smem((d + kGemmChunk - 1) / kGemmChunk), st>>>(a, sr > 1 ? a.kvin : a.nrm);
  return (int)cudaGetLastError();
}
