// One warpgroup's products through csrc/hopper.cuh, for holding its operand
// layouts against torch.matmul (scripts/probe_attention.py):
//   S = Q K^T      both operands K-major from shared memory   [64 x 64]
//   O = bf16(S) V  A from registers (S's fragments), V MN-major [64 x hd]
//   X = E^T K      A = E^T and B = K both MN-major              [64 x hd]
// for bf16 row-major Q, K, V [64, hd] and E [64, 64]; fp32 row-major out.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mvlt;
using namespace mvlt::hopper;

template <int HD>
__global__ void probe_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* e,
                             float* s_out, float* o_out, float* x_out) {
  constexpr int RB = HD * 2, CH = RB / 16, NA = HD / 2;
  __shared__ __align__(1024) char smem[3 * 64 * RB + 64 * 128];
  const uint32_t sq = smem_u32(smem), sk = sq + 64 * RB, sv = sk + 64 * RB, se = sv + 64 * RB;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int i = t; i < 64 * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    cp_async16_zfill(sq + tile_off<RB>(r, c), q + r * HD + c * 8, true);
    cp_async16_zfill(sk + tile_off<RB>(r, c), k + r * HD + c * 8, true);
    cp_async16_zfill(sv + tile_off<RB>(r, c), v + r * HD + c * 8, true);
  }
  for (int i = t; i < 64 * 8; i += 128)
    cp_async16_zfill(se + tile_off<128>(i / 8, i % 8), e + (i / 8) * 64 + (i % 8) * 8, true);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float s[32], o[NA], x[NA];
  wgmma_fence();
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<0, 0>(s, make_desc<RB>(sq + kk * 32), make_desc<RB>(sk + kk * 32), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[4][4];
  for (int kk = 0; kk < 4; ++kk) {
    acc_to_a(s, kk, p[kk]);
    fence_regs(p[kk]);
  }
  wgmma_fence();
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(o, p[kk], make_desc<RB>(sv + 16 * kk * RB), kk);
  wgmma_commit();
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<1, 1>(x, make_desc<128>(se + 16 * kk * 128), make_desc<RB>(sk + 16 * kk * RB), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(x);
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  for (int i = 0; i < 32; ++i)
    s_out[(r0 + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + cq + (i & 1)] = s[i];
  for (int i = 0; i < NA; ++i) {
    const int idx = (r0 + 8 * ((i >> 1) & 1)) * HD + 8 * (i >> 2) + cq + (i & 1);
    o_out[idx] = o[i];
    x_out[idx] = x[i];
  }
}

}  // namespace

extern "C" int probe_wgmma(const void* q, const void* k, const void* v, const void* e,
                           void* s, void* o, void* x, int hd) {
  using mvlt::bf16;
  auto args = [&](auto kernel) {
    kernel<<<1, 128>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(e),
                       static_cast<float*>(s), static_cast<float*>(o), static_cast<float*>(x));
  };
  if (hd == 64) args(probe_kernel<64>);
  else if (hd == 32) args(probe_kernel<32>);
  else return -1;
  return (int)cudaGetLastError();
}
