// LN -> fc1 -> GELU -> fc2 -> scaled residual of PVLT training, forward and
// backward:
//   y = x + s[b] * (GELU(LN(x) W1^T + b1) W2^T + b2)
// for x [B, N, D] bf16, W1 [H, D] and W2 [D, H] in torch Linear layout (bf16
// copies of the fp32 masters), b1, b2 and the LN affine fp32, and s [B] fp32,
// the per-sample DropPath scale (mask / keep).
//
// Replaces: mvlt_tpu/ops/fused_mlp.py:_fused_ln_mlp_impl (forward, Pallas
// body _kernel) and _fused_ln_mlp_bwd (Pallas body _mlp_bwd_kernel), without
// their TPU layouts (no 128-lane padding, no two-tokens-per-row packing).
//
// What bounds it on the H100: the products, 4.rows.D.H flops forward (83
// GFLOP at stage 1, B = 150: 84 us at the bf16 peak) against one read and one
// write of the stream (162 MB, 48 us); the backward does about 3x the
// forward's products. The hidden [rows, H] never reaches device memory in
// either direction.
//
// Design, forward: one block of 8 warps per tile of TR rows of the flattened
// [B*N, D] stream (the row scale is looked up per row, so a tile may span two
// samples): LN per row by one warp (two-pass statistics), then the hidden in
// 64-wide chunks: fc1 + b1 + GELU into shared memory, fc2 accumulated in fp32
// in shared memory; the residual is read again at the end.
// Backward: the weight gradients are sums over all rows (up to 633,600 at
// stage 1); one fp32 dW1 is 4 MB at stage 4, so a block's partial sum cannot
// stay on chip, and on Hopper blocks run in no order. So a fixed set of G
// blocks (G <= the slots of the workspace the wrapper allocates) each walk
// every G-th row tile and add their partial dW1, dW2^T, db1, db2, dLN-gamma
// and dLN-beta into their own fp32 slot (written on their first tile, added
// on the others; dW1 and dW2^T through common.cuh:gemm_acc, as whole
// accumulator fragments loaded from and stored to the slot -- through the
// per-element epilogue instead, the backward was 1.4-2.3x slower on the
// H100); a second launch sums the slots
// in a fixed order. Deterministic, no atomics. Per tile: recompute LN, then
// per hidden chunk: h1 = LN.W1c^T + b1 (fp32 kept), G^T = GELU(h1)^T;
// dG = (s.dy) W2c; dh1 = dG * GELU'(h1); dW2c^T += G^T (s.dy);
// dW1c += dh1^T LN; dLN += dh1 W1c; then dx = dy + LN-backward(dLN * gamma).
// Rows with s = 0 still pass dy through to dx. The backward's warp tiles
// span one row block (MaxRB = 1): with two it spilled 1.9 KB at 255
// registers and measured 9-26% slower on the H100. The fc2 and dLN sums keep
// gemm_bf16: their B operand comes from L2, where its two-row-block tiles
// and prefetch beat gemm_acc's whole-fragment sums (the forward was 19-34%
// slower with gemm_acc). Measured and dropped: a
// dx kernel beside a weight kernel that keeps each hidden chunk's sums in
// shared memory over thousands of rows (no per-tile slot traffic, one more
// product per row) was 7-35% slower: the time is in the latency-bound
// products, not in the slots.

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

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const float* gamma;
  const float* beta;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* s;
  bf16* dx;
  float* ws;  // [slots, slot_size] fp32
  long long rows;
  int n, d, hidden, tr, slot_size;
  float eps;
};

// slot layout (floats): dW1 [H, D] | dW2^T [H, D] | db1 [H] | db2 [D] | dgamma [D] | dbeta [D]
// (a multiple of 8 floats, so every slot starts 32-byte aligned)
__host__ __device__ inline int slot_floats(int d, int hidden) {
  return (2 * hidden * d + hidden + 3 * d + 7) & ~7;
}

__host__ __device__ inline size_t fwd_smem(int tr, int d, size_t* off) {
  size_t o = 0;
  off[0] = o; o += align128((size_t)tr * (d + kPad) * 2);       // LN(x) bf16
  off[1] = o; o += align128((size_t)tr * (kChunk + kPad) * 2);  // GELU chunk bf16
  off[2] = o; o += align128((size_t)tr * d * 4);                // fc2 sum fp32
  off[3] = o; o += kStageBytes;
  return o;
}

__host__ __device__ inline size_t bwd_smem(int tr, int d, size_t* off) {
  size_t o = 0;
  off[0] = o; o += align128((size_t)tr * (d + kPad) * 2);       // LN(x) bf16
  off[1] = o; o += align128((size_t)tr * (d + kPad) * 2);       // s.dy bf16
  off[2] = o; o += align128((size_t)tr * kChunk * 4);           // h1, then dh1, fp32
  off[3] = o; o += align128((size_t)kChunk * (tr + kPad) * 2);  // GELU(h1)^T bf16
  off[4] = o; o += align128((size_t)tr * (kChunk + kPad) * 2);  // dh1 bf16
  off[5] = o; o += align128((size_t)kChunk * (tr + kPad) * 2);  // dh1^T bf16
  off[6] = o; o += align128((size_t)tr * d * 4);                // dLN fp32
  off[7] = o; o += align128((size_t)tr * 2 * 4);                // mean, rstd
  off[8] = o; o += kStageBytes;
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

__global__ void __launch_bounds__(kThreads) ln_mlp_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int tr = a.tr, d = a.d, H = a.hidden;
  const int ld = d + kPad, ldh = kChunk + kPad, ldt = tr + kPad;
  size_t off[9];
  bwd_smem(tr, d, off);
  bf16* normed = reinterpret_cast<bf16*>(smem + off[0]);
  bf16* dys = reinterpret_cast<bf16*>(smem + off[1]);
  float* h1 = reinterpret_cast<float*>(smem + off[2]);
  bf16* gt = reinterpret_cast<bf16*>(smem + off[3]);
  bf16* dh = reinterpret_cast<bf16*>(smem + off[4]);
  bf16* dht = reinterpret_cast<bf16*>(smem + off[5]);
  float* dln = reinterpret_cast<float*>(smem + off[6]);
  float* stats = reinterpret_cast<float*>(smem + off[7]);
  float* stage = reinterpret_cast<float*>(smem + off[8]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* slot = a.ws + (size_t)blockIdx.x * a.slot_size;
  float* s_dw1 = slot;
  float* s_dw2t = slot + (size_t)H * d;
  float* s_db1 = s_dw2t + (size_t)H * d;
  float* s_db2 = s_db1 + H;
  float* s_dg = s_db2 + d;
  float* s_dbe = s_dg + d;
  const long long ntiles = (a.rows + tr - 1) / tr;

  bool first = true;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, first = false) {
    const long long r0 = t * tr;
    const int rows = (int)min((long long)tr, a.rows - r0);
    const bf16* xb = a.x + r0 * d;
    const bf16* dyb = a.dy + r0 * d;
    // recompute LN(x); s.dy; zero dLN. Rows past the end are zero.
    for (int r = warp; r < tr; r += kWarps) {
      if (r < rows) {
        const float2 st = row_stats_global(xb + (size_t)r * d, d, a.eps);
        const float sc = a.s[(r0 + r) / a.n];
        for (int c = lane; c < d; c += 32) {
          const float xv = __bfloat162float(xb[(size_t)r * d + c]);
          normed[r * ld + c] = __float2bfloat16((xv - st.x) * st.y * a.gamma[c] + a.beta[c]);
          dys[r * ld + c] = __float2bfloat16(__bfloat162float(dyb[(size_t)r * d + c]) * sc);
        }
        if (lane == 0) {
          stats[2 * r] = st.x;
          stats[2 * r + 1] = st.y;
        }
      } else {
        for (int c = lane; c < d; c += 32) {
          normed[r * ld + c] = __float2bfloat16(0.0f);
          dys[r * ld + c] = __float2bfloat16(0.0f);
        }
      }
    }
    for (int i = threadIdx.x; i < tr * d; i += kThreads) dln[i] = 0.0f;
    __syncthreads();

    for (int c0 = 0; c0 < H; c0 += kChunk) {
      const int cw = min(kChunk, H - c0);
      // h1 = LN W1c^T + b1 (fp32 kept); GELU(h1)^T for the dW2 product
      gemm_bf16<true, 1>(normed, ld, a.w1 + (size_t)c0 * d, d, tr, cw, d, stage,
                         [&](int r, int c, float v) {
                           const float u = v + a.b1[c0 + c];
                           h1[r * kChunk + c] = u;
                           gt[c * ldt + r] = __float2bfloat16(gelu_erf(u));
                         });
      __syncthreads();
      // dG = (s.dy) W2c, W2 [D, H] read as B[k = d][n = j]; dh1 = dG * GELU'(h1)
      gemm_bf16<false, 1>(dys, ld, a.w2 + c0, H, tr, cw, d, stage, [&](int r, int c, float v) {
        const float g = v * gelu_erf_grad(h1[r * kChunk + c]);
        h1[r * kChunk + c] = g;
        const bf16 e = __float2bfloat16(g);
        dh[r * ldh + c] = e;
        dht[c * ldt + r] = e;
      });
      __syncthreads();
      // weight gradients of this chunk into the slot; dLN += dh1 W1c
      gemm_acc<false>(gt, ldt, dys, ld, cw, d, tr, s_dw2t + (size_t)c0 * d, d, first);
      gemm_acc<false>(dht, ldt, normed, ld, cw, d, tr, s_dw1 + (size_t)c0 * d, d, first);
      gemm_bf16<false, 1>(dh, ldh, a.w1 + (size_t)c0 * d, d, tr, d, cw, stage,
                          [&](int r, int c, float v) { dln[r * d + c] += v; });
      for (int c = threadIdx.x; c < cw; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < rows; ++r) sum += h1[r * kChunk + c];
        s_db1[c0 + c] = first ? sum : s_db1[c0 + c] + sum;
      }
      __syncthreads();
    }

    // column sums: db2 = sum s.dy, dgamma = sum dLN * nhat, dbeta = sum dLN
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sb2 = 0.0f, sg = 0.0f, sbe = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float sc = a.s[(r0 + r) / a.n];
        sb2 += __bfloat162float(dyb[(size_t)r * d + c]) * sc;
        const float nh = (__bfloat162float(xb[(size_t)r * d + c]) - stats[2 * r]) * stats[2 * r + 1];
        sg += dln[r * d + c] * nh;
        sbe += dln[r * d + c];
      }
      s_db2[c] = first ? sb2 : s_db2[c] + sb2;
      s_dg[c] = first ? sg : s_dg[c] + sg;
      s_dbe[c] = first ? sbe : s_dbe[c] + sbe;
    }
    // dx = dy + (dnhat - mean(dnhat) - nhat * mean(dnhat * nhat)) * rstd
    bf16* dxb = a.dx + r0 * d;
    for (int r = warp; r < rows; r += kWarps) {
      const float mean = stats[2 * r], rstd = stats[2 * r + 1];
      float m1 = 0.0f, m2 = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float dn = dln[r * d + c] * a.gamma[c];
        const float nh = (__bfloat162float(xb[(size_t)r * d + c]) - mean) * rstd;
        m1 += dn;
        m2 += dn * nh;
      }
      m1 = warp_sum(m1) / d;
      m2 = warp_sum(m2) / d;
      for (int c = lane; c < d; c += 32) {
        const float dn = dln[r * d + c] * a.gamma[c];
        const float nh = (__bfloat162float(xb[(size_t)r * d + c]) - mean) * rstd;
        dxb[(size_t)r * d + c] = __float2bfloat16(
            __bfloat162float(dyb[(size_t)r * d + c]) + (dn - m1 - nh * m2) * rstd);
      }
    }
    __syncthreads();
  }
}

// Sum the first `slots` slots in order; dW2 is written back from its
// transposed slot layout to torch's [D, H].
__global__ void ln_mlp_reduce_kernel(const float* ws, int slots, int slot_size, int d,
                                     int hidden, float* dw1, float* dw2, float* db1,
                                     float* db2, float* dgamma, float* dbeta) {
  const int hd = hidden * d;
  const int total = 2 * hd + hidden + 3 * d;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int g = 0; g < slots; ++g) sum += ws[(size_t)g * slot_size + i];
    if (i < hd) {
      dw1[i] = sum;
    } else if (i < 2 * hd) {
      const int j = (i - hd) / d, c = (i - hd) - j * d;
      dw2[(size_t)c * hidden + j] = sum;
    } else if (i < 2 * hd + hidden) {
      db1[i - 2 * hd] = sum;
    } else {
      const int k = i - 2 * hd - hidden;
      (k < d ? db2 : k < 2 * d ? dgamma : dbeta)[k % d] = sum;
    }
  }
}

int pick_tile(size_t (*smem)(int, int, size_t*), int d, size_t* bytes) {
  size_t off[9];
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

// Floats of one workspace slot.
extern "C" int mvlt_ln_mlp_slot_floats(int d, int hidden) {
  return mvlt::slot_floats(d, hidden);
}

// ws holds `slots` slots of mvlt_ln_mlp_slot_floats(d, hidden) floats; the
// kernel uses min(slots, row tiles) of them.
extern "C" int mvlt_ln_mlp_bwd(const void* x, const void* dy, const void* gamma,
                               const void* beta, const void* w1, const void* b1,
                               const void* w2, const void* s, void* dx, void* ws, int slots,
                               void* dw1, void* dw2, void* db1, void* db2, void* dgamma,
                               void* dbeta, long long rows, int n, int d, int hidden,
                               float eps, void* stream) {
  using namespace mvlt;
  size_t bytes = 0;
  const int tr = pick_tile(bwd_smem, d, &bytes);
  if (!tr || slots < 1) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (rows + tr - 1) / tr;
  const int used = (int)(ntiles < slots ? ntiles : slots);
  const int slot_size = slot_floats(d, hidden);
  BwdArgs a{static_cast<const bf16*>(x),    static_cast<const bf16*>(dy),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const bf16*>(w1),   static_cast<const float*>(b1),
            static_cast<const bf16*>(w2),   static_cast<const float*>(s),
            static_cast<bf16*>(dx),         static_cast<float*>(ws),
            rows, n, d, hidden, tr, slot_size, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ln_mlp_bwd_kernel<<<used, kThreads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = 2 * hidden * d + hidden + 3 * d;
  ln_mlp_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), used, slot_size, d, hidden, static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(db1), static_cast<float*>(db2),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}
