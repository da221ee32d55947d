// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v,
// with the logsumexp of each query row on request ("lse" mode), or the
// online softmax's partials in place of o ("stats" mode).
//
// Replaces petastorm_tpu/ops/flash_attn.py::_flash_kernel (:89, the Pallas
// kernel launched by _flash_launch in its "out", "lse" and "stats" modes).
//
// "stats" is ring attention's merge contract: the unnormalised float32
// accumulator o = sum_j exp(s_j - m) v_j, the row max m of the scaled
// scores (natural-log units) and the normaliser l = sum_j exp(s_j - m),
// written instead of o / l; m and l are (b, h, sq) float32 arrays. Launchers
// flash_attn_fwd_stats (tensor cores) and flash_attn_fwd_stats_fma. The
// tensor-core route keeps its max in units of log2 and writes m2 ln 2.
//
// Layout. q is (b, sq, h, d) and k, v are (b, sk, kv_h, d), read through
// their batch, sequence and head strides (the head dim is unit-stride); o is
// written in the same (b, sq, h, d) layout and lse as a contiguous
// (b, h, sq, 1) float32 array. The TPU kernel needed (b, h, s, d) operands
// and its caller transposed around the call; here those would be four extra
// copies per call, so the kernels read the model's layout directly.
//
// Numerics, as _flash_kernel: s = (q . k accumulated in f32) * scale, with
// scale = 1/sqrt(d) rounded once to f32 by the caller; max, exp and the
// normaliser in f32; p is rounded to v's dtype before p . v, which is
// accumulated in f32; o = acc / l rounded to q's dtype; lse = m + log(l).
// The mask is the top-left one (q_pos >= k_pos), so sq != sk works and no
// row is ever fully masked (every row sees key 0). Grouped-query heads read
// kv head h / (H / KV_H); K/V are never repeated. Causal tiles above the
// diagonal are never visited, and q tiles are issued last-first, so the
// longest causal rows start first.
//
// Two routes, chosen by the wrapper (ops/flash_attn.py::fwd_route) from the
// dtype and head dim before the launch:
//
// Tensor cores (flash_fwd_tc_kernel, launcher flash_attn_fwd; bf16 and f16
// with d % 8 == 0 and d <= 128). One block per (128-row q tile, head,
// batch): two consumer warpgroups of 64 rows each and one producer warp.
// The producer loads Q once by TMA and streams 64-key K/V tiles by TMA
// (128-byte swizzle, zeros past every edge) into a four-stage mbarrier
// ring, refilling a stage once all eight consumer warps have released it.
// Each warpgroup computes S = Q K^T by wgmma (both operands K-major), takes
// the online softmax in registers in base 2 (log2(e) folded into the scale,
// ex2.approx; each row lives on the 4 threads of a quad), rounds P to the
// inputs' dtype straight into wgmma A fragments and adds P V by wgmma with
// V read MN-major through the transpose bit. Tile n's S product is issued
// with tile n-1's P V product, and the softmax of tile n runs while P V is
// still on the tensor cores (wait_group 1, then 0 before the rescale).
// TMA fills padded keys with zeros, whose score would be 0, so keys >= sk
// and causal keys k_pos > q_pos get -inf before the row max; only a tile
// on the diagonal or on the sk edge masks, and a warpgroup whose rows all
// lie past sq or above a tile skips it.
//
// CUDA cores (flash_fwd_kernel, launcher flash_attn_fwd_fma; f32, and 16-bit
// inputs with d > 128 or d % 8 != 0). One block of 256 threads per (64-row
// q tile, head, batch) walks the K/V tiles itself and keeps the online
// softmax state in registers; every product is an IEEE f32 fused
// multiply-add from shared memory, so f32 inputs keep full f32 precision
// (no TF32); ragged sq, sk and d are zero-filled in shared memory and
// padded keys get a score of -inf.
//
// Bound. At the main path's shape (b 2, s 8192, 32 heads over 8 kv heads,
// d 128, causal, bf16) the call does 4*b*h*d*sum(visible keys) = 1.1e12
// operations on 0.34 GB of inputs and outputs: operation-bound, about
// 1.11 ms at the tensor cores' 989 TFLOP/s. The tensor-core route does
// every one of those operations on the tensor cores, reads each K/V tile
// once per 128 query rows (the rest of the traffic hits L2 across the
// heads of a group), and hides the softmax's exp (a 64 x 64 tile per
// warpgroup per step) behind the P V product. The FMA route's peak is the
// 67 TFLOP/s of f32 FMAs, so it cannot come within 15x of that bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 threads, each owning a 4 x 4 score tile
constexpr int LDT = BQ + 4;   // row stride of the transposed tiles: 16-byte rows, no power of two
static_assert(BQ == BK, "Q and K tiles share load_transposed and the LDT stride");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is unit-stride
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // T, or float32 in "stats" mode
  float* lse;  // (b, h, sq) float32: "lse" mode, else null
  float* m;    // (b, h, sq) float32 each: "stats" mode, else null
  float* l;
  int64_t sq, sk;
  int h, kv_h, d;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
};

// Shared memory: Q^T [DP][LDT], then one buffer that holds K^T [DP][LDT] and,
// once the scores are taken, V [BK][DP], then P [BQ][LDT].
constexpr size_t smem_bytes(int dp) { return sizeof(float) * (2 * dp * LDT + BQ * LDT); }

// Rows [row0, row0 + 64) of one head, transposed into dst[c * LDT + r],
// zero past `rows` and past d.
template <typename T, int DP>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int64_t row0,
                                                int64_t rows, int64_t row_stride, int d) {
  for (int e = threadIdx.x; e < BQ * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const int64_t row = row0 + r;
    dst[c * LDT + r] = (row < rows && c < d) ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kv = qt + DP * LDT;
  float* ps = kv + DP * LDT;
  constexpr int G = DP / 64;  // 4-wide column groups of the output each thread owns

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (p.h / p.kv_h);
  const T* qb = static_cast<const T*>(p.q) + batch * p.qs.b + head * p.qs.h;
  const T* kb = static_cast<const T*>(p.k) + batch * p.ks.b + kv_head * p.ks.h;
  const T* vb = static_cast<const T*>(p.v) + batch * p.vs.b + kv_head * p.vs.h;

  load_transposed<T, DP>(qt, qb, q0, p.sq, p.qs.s, p.d);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int64_t q_last = min64(q0 + BQ, p.sq) - 1;
  const int64_t k_end = p.causal ? min64(p.sk, q_last + 1) : p.sk;
  for (int64_t k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q is stored; the previous tile's V and P are read
    load_transposed<T, DP>(kv, kb, k0, p.sk, p.ks.s, p.d);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[c * LDT + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[c * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Online softmax over this tile. The 16 threads of a row group (one
    // half-warp) share rows ty*4 .. ty*4+3 and reduce across lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q0 + ty * 4 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k_pos = k0 + tx * 4 + j;
        const bool seen = k_pos < p.sk && !(p.causal && k_pos > q_pos);
        s[i][j] = seen ? s[i][j] * p.scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // Finite from the first tile on: every row sees key 0.
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        tile_sum += e;
        s[i][j] = to_float(from_float<T>(e));  // p in v's dtype for p . v
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      l[i] = l[i] * alpha + tile_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * LDT + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();  // K is read, P is stored

    for (int e = threadIdx.x; e < BK * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const int64_t row = k0 + r;
      kv[r * DP + c] = (row < p.sk && c < p.d) ? to_float(vb[row * p.vs.s + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * LDT + kk]);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(&kv[(kk + u) * DP + g * 64 + tx * 4]);
          const float vv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][g * 4 + c] = fmaf(pr[i][u], vv[c], acc[i][g * 4 + c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t q_pos = q0 + ty * 4 + i;
    if (q_pos >= p.sq) continue;
    if (p.m != nullptr) {  // "stats": the unnormalised accumulator, m and l
      float* orow = static_cast<float*>(p.o) + batch * p.os.b + q_pos * p.os.s + head * p.os.h;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = g * 64 + tx * 4 + c;
          if (col < p.d) orow[col] = acc[i][g * 4 + c];
        }
      if (tx == 0) {
        const int64_t at = ((int64_t)batch * p.h + head) * p.sq + q_pos;
        p.m[at] = m[i];
        p.l[at] = l[i];
      }
      continue;
    }
    T* orow = static_cast<T*>(p.o) + batch * p.os.b + q_pos * p.os.s + head * p.os.h;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g * 64 + tx * 4 + c;
        if (col < p.d) orow[col] = from_float<T>(acc[i][g * 4 + c] / l[i]);
      }
    if (p.lse != nullptr && tx == 0)
      p.lse[((int64_t)batch * p.h + head) * p.sq + q_pos] = m[i] + logf(l[i]);
  }
}

template <typename T, int DP>
cudaError_t launch_dp(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  // Above 48 KB a launch is refused unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int64_t batch, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.sq + BQ - 1) / BQ), (unsigned)p.h, (unsigned)batch);
  if (p.d <= 64) return launch_dp<T, 64>(p, grid, stream);
  if (p.d <= 128) return launch_dp<T, 128>(p, grid, stream);
  return launch_dp<T, 256>(p, grid, stream);
}

int fwd_fma(const void* q, const void* k, const void* v, void* o, float* lse, float* m,
            float* l, int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h, int64_t d,
            const int64_t* strides, int64_t dtype, int64_t causal, float scale, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv_h < 1 || h % kv_h != 0 || d < 1 ||
      d > 256 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.m = m;
  p.l = l;
  p.sq = sq;
  p.sk = sk;
  p.h = (int)h;
  p.kv_h = (int)kv_h;
  p.d = (int)d;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.os = {strides[9], strides[10], strides[11]};
  p.scale = scale;
  p.causal = causal != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(p, b, s);
    case 1: return (int)launch<__half>(p, b, s);
    case 2: return (int)launch<float>(p, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The FMA route's launcher. q, k, v, o: device pointers in the layouts
// above; lse: device pointer to (b, h, sq) float32, or null. strides: 12
// int64 in elements, (batch, seq, head) for q, k, v, o in turn. dtype: 0 =
// bf16, 1 = f16, 2 = f32 (q, k, v and o alike). Returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attn_fwd_fma(const void* q, const void* k, const void* v, void* o, void* lse,
                              int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h,
                              int64_t d, const int64_t* strides, int64_t dtype, int64_t causal,
                              float scale, void* stream) {
  return fwd_fma(q, k, v, o, static_cast<float*>(lse), nullptr, nullptr, b, sq, sk, h, kv_h, d,
                 strides, dtype, causal, scale, stream);
}

// The FMA route in "stats" mode (the ring-attention merge's contract): o is
// the unnormalised float32 accumulator in the (b, sq, h, d) layout, and m
// (the row max of the scaled scores, in natural-log units) and l (the
// normaliser, sum of exp(s - m)) are (b, h, sq) float32 arrays. Arguments
// otherwise as for flash_attn_fwd_fma; o's strides are in float32 elements.
extern "C" int flash_attn_fwd_stats_fma(const void* q, const void* k, const void* v, void* o,
                                        void* m, void* l, int64_t b, int64_t sq, int64_t sk,
                                        int64_t h, int64_t kv_h, int64_t d,
                                        const int64_t* strides, int64_t dtype, int64_t causal,
                                        float scale, void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  return fwd_fma(q, k, v, o, nullptr, static_cast<float*>(m), static_cast<float*>(l), b, sq, sk,
                 h, kv_h, d, strides, dtype, causal, scale, stream);
}

// ===================================================== tensor-core route ==

namespace {
namespace tc {

using namespace hopper;

constexpr int BQ = 128;                       // q rows a block: two warpgroups of 64
constexpr int BK = 64;                        // keys a K/V tile
static_assert(BK == 64, "scores and accumulate (hopper.cuh) take 64-key tiles");
constexpr int STAGES = 4;                     // K/V ring depth
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
constexpr int CONSUMER_WARPS = CONSUMERS / 32;

struct TcParams {
  CUtensorMap tq, tk, tv;  // encode_bshd maps: Q boxes of 128 rows, K/V of 64
  void* o;                 // T, or float32 in "stats" mode
  float* lse;              // (b, h, sq) float32, or null: "out" mode
  float* m;                // (b, h, sq) float32 each: "stats" mode
  float* l;
  Strides os;              // output strides, in elements
  int b, sq, sk, h, kv_h, d;
  float scale;
  int causal;
};

template <int DP> constexpr int fwd_tc_smem() {
  return ATOM + BQ * DP * 2 + STAGES * 2 * BK * DP * 2 + 8 * (1 + 2 * STAGES);
}

// The online softmax of one BK-key tile's scores s, for the two rows
// (lane_row and lane_row + 8 of the warpgroup's 64, first row q_first) this
// thread holds a quarter of, in place: with `mask`, keys >= sk and, if
// causal, keys past the row count as -inf; s becomes p = exp(s - m) in f32.
// Updates the running max m2 (in units of log2) and this thread's share l
// of each normaliser, and leaves each row's rescale factor in alpha.
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m2)[2], float (&l)[2],
                                               float (&alpha)[2], bool mask, int k0, int q_first,
                                               int sk, bool causal, float scale_log2,
                                               int lane_row, int lane_col) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int q_pos = q_first + lane_row + 8 * ((i / 2) % 2);
      const int k_pos = k0 + 8 * (i / 4) + lane_col + i % 2;
      if (k_pos >= sk || (causal && k_pos > q_pos)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // A row lives on the 4 threads of a quad.
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r] * scale_log2);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row that has seen no key yet
    alpha[r] = ex2(m2[r] - m_use[r]);
    m2[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -m_use[(i / 2) % 2]));
    l[(i / 2) % 2] += s[i];
  }
}

// p rounded to T and packed as the A fragments of the P V product.
template <typename T>
__device__ __forceinline__ void to_fragments(const float (&p)[BK / 2],
                                             uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) a[i / 8][i % 8 / 2] = pack2<T>(p[i], p[i + 1]);
}

// STATS: the "stats" epilogue (o unnormalised in float32, m and l) in
// place of o / l and the lse.
template <typename T, int DP, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ TcParams p) {
  constexpr uint32_t QP = BQ * 128, KP = BK * 128;  // bytes of one 64-column panel
  constexpr uint32_t QBYTES = DP / 64 * QP, KBYTES = DP / 64 * KP;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t s_q = base, s_kv = base + QBYTES;  // stage s: K at s_kv + 2*s*KBYTES, then V
  const uint32_t bar_q = s_kv + STAGES * 2 * KBYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hb = p.h * p.b;
  const int tile = (p.sq + BQ - 1) / BQ - 1 - (int)(blockIdx.x / hb);  // heaviest first
  const int head = blockIdx.x % hb % p.h, batch = blockIdx.x % hb / p.h;
  const int kv_head = head / (p.h / p.kv_h);
  const int q0 = tile * BQ;
  const int k_end = p.causal ? min(p.sk, min(q0 + BQ, p.sq)) : p.sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, QBYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_load_4d(s_q + c * QP, &p.tq, bar_q, c * 64, q0, head, batch);
      for (int n = 0; n < n_tiles; ++n) {
        const int stage = n % STAGES;
        // The stage's previous tile, n - STAGES, released by every consumer warp.
        if (n >= STAGES) mbar_wait(bar_empty + 8 * stage, (n / STAGES - 1) & 1);
        const uint32_t bar = bar_full + 8 * stage, dst = s_kv + stage * 2 * KBYTES;
        mbar_expect_tx(bar, 2 * KBYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_load_4d(dst + c * KP, &p.tk, bar, c * 64, n * BK, kv_head, batch);
          tma_load_4d(dst + KBYTES + c * KP, &p.tv, bar, c * 64, n * BK, kv_head, batch);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, wg_warp = tid % 128 / 32;
  // This thread's rows of its warpgroup's 64: lane_row and lane_row + 8.
  const int lane_row = 16 * wg_warp + lane / 4, lane_col = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg;
  // Warpgroup-uniform: the tiles these rows see are a prefix of the block's.
  const int n_live = wg_first >= p.sq ? 0
                     : p.causal      ? min(n_tiles, min(wg_first + 63, p.sq - 1) / BK + 1)
                                     : n_tiles;
  const float scale_log2 = p.scale * LOG2E;
  auto full = [&](int n) { mbar_wait(bar_full + 8 * (n % STAGES), (n / STAGES) & 1); };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (n % STAGES));
  };
  auto k_tile = [&](int n) { return s_kv + (n % STAGES) * 2 * KBYTES; };

  float acc[DP / 2];
  float m2[2] = {-INFINITY, -INFINITY};  // running row max, in units of log2
  float l[2] = {0.f, 0.f};               // this thread's share of each row's normaliser
  zero(acc);
  // Only a tile on the diagonal or on the sk edge masks.
  auto masks = [&](int n) {
    return (p.causal && n * BK + BK - 1 > wg_first) || n * BK + BK > p.sk;
  };

  mbar_wait(bar_q, 0);
  if (n_live > 0) {
    const uint32_t s_wq = s_q + wg * 64 * 128;
    uint32_t a[BK / 16][4];  // P of the tile whose P V product is next
    float s[BK / 2], alpha[2];
    full(0);
    zero(s);
    wgmma_fence();
    scores<T, DP>(s, s_wq, QP, k_tile(0), KP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax(s, m2, l, alpha, masks(0), 0, wg_first, p.sk, p.causal, scale_log2, lane_row,
                   lane_col);
    to_fragments<T>(s, a);
    for (int n = 1; n < n_live; ++n) {
      full(n);
      zero(s);
      fence_regs(s);
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) fence_regs(a[j]);
      wgmma_fence();
      scores<T, DP>(s, s_wq, QP, k_tile(n), KP);
      wgmma_commit();
      accumulate<T, DP>(acc, a, k_tile(n - 1) + KBYTES, KP);
      wgmma_commit();
      // The softmax of tile n runs while P V of tile n-1 is on the tensor
      // cores. The A fragments of the next P V are made only after that
      // product is done: registers that a wgmma in flight reads are
      // written by nothing else, or ptxas serialises the products.
      wgmma_wait<1>();
      fence_regs(s);
      online_softmax(s, m2, l, alpha, masks(n), n * BK, wg_first, p.sk, p.causal, scale_log2,
                     lane_row, lane_col);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) fence_regs(a[j]);
      release(n - 1);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      to_fragments<T>(s, a);
    }
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(a[j]);
    wgmma_fence();
    accumulate<T, DP>(acc, a, k_tile(n_live - 1) + KBYTES, KP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(a[j]);
    release(n_live - 1);
  }
  // Tiles none of these rows sees: released as they land.
  for (int n = n_live; n < n_tiles; ++n) {
    full(n);
    release(n);
  }
  if (n_live == 0) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (STATS) {
    // exp2(s scale log2(e) - m2) = exp(s scale - m2 ln 2): l needs no change,
    // and m in natural-log units is m2 ln 2.
    store_rows_f32<DP>(acc, static_cast<float*>(p.o),
                       (int64_t)batch * p.os.b + (int64_t)head * p.os.h, p.os.s, wg_first, p.sq,
                       p.d, lane_row, lane_col);
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wg_first + lane_row + 8 * r;
        if (row < p.sq) {
          const int64_t at = ((int64_t)batch * p.h + head) * p.sq + row;
          p.m[at] = m2[r] * 0.6931471805599453f;
          p.l[at] = l[r];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = acc[i] / l[(i / 2) % 2];
  store_rows<T, DP>(acc, p.o, (int64_t)batch * p.os.b + (int64_t)head * p.os.h, p.os.s, wg_first,
                    p.sq, p.d, lane_row, lane_col);
  if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg_first + lane_row + 8 * r;
      if (row < p.sq)  // (m2 + log2 l) ln 2
        p.lse[((int64_t)batch * p.h + head) * p.sq + row] =
            (m2[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

template <int DP, bool STATS>
cudaError_t launch_tc(bool f16, int64_t blocks, const TcParams& p, cudaStream_t stream) {
  auto kernel = f16 ? flash_fwd_tc_kernel<__half, DP, STATS>
                    : flash_fwd_tc_kernel<__nv_bfloat16, DP, STATS>;
  // Above 48 KB a launch is refused unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_tc_smem<DP>());
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, fwd_tc_smem<DP>(), stream>>>(p);
  return cudaGetLastError();
}

int fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, float* m, float* l,
           int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h, int64_t d,
           const int64_t* strides, int64_t dtype, int64_t causal, float scale, void* stream) {
  const int64_t limit = 0x7fffffff;
  if ((dtype != 0 && dtype != 1) || b < 1 || h < 1 || kv_h < 1 || h % kv_h != 0 || d < 8 ||
      d > 128 || d % 8 != 0 || sq < 1 || sk < 1 || sq > limit - tc::BQ || sk > limit - tc::BK ||
      (sq + tc::BQ - 1) / tc::BQ * h * b > limit)
    return (int)cudaErrorInvalidValue;
  tc::TcParams p = {};
  const bool f16 = dtype == 1;
  const int64_t* s = strides;
  if (!hopper::encode_bshd(&p.tq, q, f16, b, sq, h, d, s[0], s[1], s[2], tc::BQ) ||
      !hopper::encode_bshd(&p.tk, k, f16, b, sk, kv_h, d, s[3], s[4], s[5], tc::BK) ||
      !hopper::encode_bshd(&p.tv, v, f16, b, sk, kv_h, d, s[6], s[7], s[8], tc::BK))
    return (int)cudaErrorInvalidValue;
  p.o = o;
  p.lse = lse;
  p.m = m;
  p.l = l;
  p.os = {s[9], s[10], s[11]};
  p.b = (int)b;
  p.sq = (int)sq;
  p.sk = (int)sk;
  p.h = (int)h;
  p.kv_h = (int)kv_h;
  p.d = (int)d;
  p.scale = scale;
  p.causal = causal != 0;
  const int64_t blocks = (sq + tc::BQ - 1) / tc::BQ * h * b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m != nullptr)
    return (int)(d <= 64 ? launch_tc<64, true>(f16, blocks, p, st)
                         : launch_tc<128, true>(f16, blocks, p, st));
  return (int)(d <= 64 ? launch_tc<64, false>(f16, blocks, p, st)
                       : launch_tc<128, false>(f16, blocks, p, st));
}

}  // namespace tc
}  // namespace

// The tensor-core route's launcher: 16-bit inputs only (dtype 0 = bf16,
// 1 = f16), d % 8 == 0 and d <= 128. q, k, v device pointers in the
// layouts above, each 16-byte aligned, with (batch, seq, head) strides in
// elements that are multiples of 8 (TMA takes strides in multiples of 16
// bytes; the wrapper makes an input contiguous otherwise). Arguments as for
// flash_attn_fwd_fma. Returns the launch's cudaError_t (0 on success);
// cudaErrorInvalidValue on a shape, stride or dtype it does not take or a
// tensor map the driver refuses.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h,
                              int64_t d, const int64_t* strides, int64_t dtype, int64_t causal,
                              float scale, void* stream) {
  return tc::fwd_tc(q, k, v, o, static_cast<float*>(lse), nullptr, nullptr, b, sq, sk, h, kv_h,
                    d, strides, dtype, causal, scale, stream);
}

// The tensor-core route in "stats" mode: o, m and l as for
// flash_attn_fwd_stats_fma (o float32, its strides in float32 elements and
// even, for 8-byte stores), inputs as for flash_attn_fwd.
extern "C" int flash_attn_fwd_stats(const void* q, const void* k, const void* v, void* o,
                                    void* m, void* l, int64_t b, int64_t sq, int64_t sk,
                                    int64_t h, int64_t kv_h, int64_t d, const int64_t* strides,
                                    int64_t dtype, int64_t causal, float scale, void* stream) {
  if (m == nullptr || l == nullptr || reinterpret_cast<uintptr_t>(o) % 8 != 0 ||
      (strides[9] | strides[10] | strides[11]) % 2 != 0)
    return (int)cudaErrorInvalidValue;
  return tc::fwd_tc(q, k, v, o, nullptr, static_cast<float*>(m), static_cast<float*>(l), b, sq,
                    sk, h, kv_h, d, strides, dtype, causal, scale, stream);
}
