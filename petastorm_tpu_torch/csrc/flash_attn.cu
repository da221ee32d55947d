// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v,
// with the logsumexp of each query row on request.
//
// Replaces petastorm_tpu/ops/flash_attn.py::_flash_kernel (the Pallas
// kernel launched by _flash_launch in its "out" and "lse" modes).
//
// Layout. q is (b, sq, h, d) and k, v are (b, sk, kv_h, d), read through
// their batch, sequence and head strides (the head dim is unit-stride); o is
// written in the same (b, sq, h, d) layout and lse as a contiguous
// (b, h, sq, 1) float32 array. The TPU kernel needed (b, h, s, d) operands
// and its caller transposed around the call; here those would be four extra
// copies per call, so the kernel reads the model's layout directly.
//
// Work split. One block of 256 threads per (64-row q tile, head, batch).
// The block walks the K/V tiles itself and keeps the online softmax state
// (running max m, normaliser l, f32 accumulator) in registers: on the TPU the
// kv grid axis ran in order and carried that state in VMEM scratch, but
// blocks on this card run in parallel and in no order. Causal tiles above
// the diagonal are never visited: the loop ends at the last key the tile's
// last row can see (the mask is the top-left one, q_pos >= k_pos, so it also
// holds for sq != sk and no row is ever fully masked). Grouped-query heads
// read their kv head h / (H / KV_H); K/V are never repeated. Ragged sq, sk
// and d are masked (padded rows and columns are zero-filled in shared
// memory, padded keys get a score of -inf). q tiles are issued last-first,
// so the longest causal rows start first.
//
// Numerics, as _flash_kernel: s = (q . k accumulated in f32) * scale, with
// scale = 1/sqrt(d) rounded once to f32 by the caller; max, exp and the
// normaliser in f32; p is rounded to v's dtype before p . v, which is
// accumulated in f32; o = acc / l rounded to q's dtype; lse = m + log(l).
// Every product is an IEEE f32 fused multiply-add on the CUDA cores, so f32
// inputs keep full f32 precision (no TF32).
//
// Bound. At the main path's shape (b 2, s 8192, 32 heads over 8 kv heads,
// d 128, causal, bf16) the call does 4*b*h*d*sum(visible keys) = 1.1e12
// operations on 0.34 GB of inputs and outputs: operation-bound, about
// 1.11 ms at the tensor cores' 989 TFLOP/s. This first version computes
// both products with f32 FMAs from shared memory (4x4 register tiles,
// 16-byte shared loads), whose peak is 67 TFLOP/s, so it cannot come within
// 15x of that bound. Tensor-core products (mma/wgmma on bf16 tiles), TMA
// loads and a pipelined K/V ring are the later redesign.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  void* o;
  float* lse;  // null: "out" mode
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

}  // namespace

// q, k, v, o: device pointers in the layouts above; lse: device pointer to
// (b, h, sq) float32, or null. strides: 12 int64 in elements, (batch, seq,
// head) for q, k, v, o in turn. dtype: 0 = bf16, 1 = f16, 2 = f32 (q, k, v
// and o alike). Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h,
                              int64_t d, const int64_t* strides, int64_t dtype, int64_t causal,
                              float scale, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv_h < 1 || h % kv_h != 0 || d < 1 ||
      d > 256 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
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
