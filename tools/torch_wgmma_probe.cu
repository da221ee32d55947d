// Checks the layouts the backward kernels rely on: one warpgroup loads a
// 64 x 128 Q and K tile by TMA, computes S = Q K^T (SS, K-major) and
// O = round(S) K (RS, K read MN-major).
#include "../petastorm_tpu_torch/csrc/hopper.cuh"
using namespace hopper;
struct PP { CUtensorMap tq, tk; float* s_out; float* o_out; };

__global__ void probe(const __grid_constant__ PP p) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + 16384, bar = base + 32768;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) { mbar_init(bar, 1); mbar_init_fence(); }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 32768);
    for (int c = 0; c < 2; ++c) {
      tma_load_4d(sq + c * 8192, &p.tq, bar, c * 64, 0, 0, 0);
      tma_load_4d(sk + c * 8192, &p.tk, bar, c * 64, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[32];
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wgmma_ss_m64n64k16<__nv_bfloat16>(s, desc_sw128(sq + (j / 4) * 8192 + (j % 4) * 32, 16, 1024),
                                      desc_sw128(sk + (j / 4) * 8192 + (j % 4) * 32, 16, 1024), j > 0);
  wgmma_commit(); wgmma_wait<0>(); fence_regs(s);
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);
  for (int i = 0; i < 32; ++i)
    p.s_out[(row + 8 * ((i / 2) % 2)) * 64 + 8 * (i / 4) + col + i % 2] = s[i];
  uint32_t a[4][4];
  for (int i = 0; i < 32; i += 2) a[i / 8][i % 8 / 2] = pack2<__nv_bfloat16>(s[i], s[i + 1]);
  float o[64];
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_m64n128k16_tb<__nv_bfloat16>(o, a[j], desc_sw128(sk + j * 2048, 8192, 1024), 1);
  wgmma_commit(); wgmma_wait<0>(); fence_regs(o);
  for (int j = 0; j < 4; ++j) fence_regs(a[j]);
  for (int i = 0; i < 64; ++i)
    p.o_out[(row + 8 * ((i / 2) % 2)) * 128 + 8 * (i / 4) + col + i % 2] = o[i];
}

extern "C" int run_probe(const void* q, const void* k, float* s_out, float* o_out) {
  PP p;
  if (!encode_bshd(&p.tq, q, false, 1, 64, 1, 128, 64 * 128, 128, 128, 64) ||
      !encode_bshd(&p.tk, k, false, 1, 64, 1, 128, 64 * 128, 128, 128, 64))
    return -1;
  p.s_out = s_out; p.o_out = o_out;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, 40000);
  probe<<<1, 128, 40000>>>(p);
  return (int)cudaGetLastError();
}
