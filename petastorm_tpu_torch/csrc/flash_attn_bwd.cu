// Flash-attention backward for Hopper (sm_90a): given the forward's inputs
// q, k, v, its logsumexp lse, the output gradient dO and D = rowsum(dO . o),
// compute dq (kernel K3) and dk, dv (kernel K4).
//
// Replaces petastorm_tpu/ops/flash_attn.py::_flash_bwd_dq_kernel (K3,
// launched by _flash_backward at :376) and ::_flash_bwd_dkv_kernel (K4,
// launched at :399), with their shared tile math _bwd_p_ds.
//
// What both compute, per (query i, key j) that i sees:
//   s  = (q_i . k_j accumulated in f32) * scale      (scale rounded once to f32)
//   p  = exp(s - lse_i)                               (f32, not rounded)
//   dp = dO_i . v_j accumulated in f32
//   ds = p * (dp - D_i) * scale                       (f32)
//   dq_i += round(ds) k_j,  dk_j += round(ds) q_i,  dv_j += round(p) dO_i
// where round() is to the inputs' dtype, every sum is f32, and each output
// is rounded once to the inputs' dtype when it is written. Every product is
// an IEEE f32 fused multiply-add on the CUDA cores (no TF32).
//
// Work split. The TPU kernels carried their accumulators in VMEM scratch
// across an in-order grid axis. Blocks on this card run in parallel and in
// no order, so each block walks that axis itself and keeps its accumulators
// in registers:
//   K3: one block of 256 threads per (64-row q tile, head, batch) walks the
//       K/V tiles up to the last key its tile's last row sees (as the
//       forward does) and writes dq once. q tiles are issued last-first.
//   K4: one block per (K/V tile, kv head, batch) walks every (group head,
//       q tile) pair that reaches its keys: the grouped-query sum happens in
//       the block, and the causal q loop starts at the first q tile whose
//       last row reaches the K/V tile (_causal_live). dk and dv are written
//       once. K/V tiles hold 64 keys, 32 at d > 128, so the two f32
//       accumulators stay at 2 x 64 floats a thread and do not spill.
// No output is shared between blocks, so no atomics are used and both
// outputs are the same bits from run to run.
//
// Layout. q, dO, dq are (b, sq, h, d) and k, v, dk, dv are (b, sk, kv_h, d),
// read and written through their batch, sequence and head strides (the
// head dim is unit-stride); lse and D are contiguous (b, h, sq) float32.
// The mask is the top-left one (q_pos >= k_pos), so sq != sk works. Ragged
// sq, sk and d are zero-filled in shared memory; padded keys get s = -inf,
// so p = 0; padded q rows get p = 0 and their lse and D are never read.
//
// Bound. At the training path's shape (b 2, s 8192, 32 heads over 8 kv
// heads, d 128, causal, bf16) each product over the causal pairs is
// 2*b*h*d*s(s+1)/2 = 5.5e11 operations: K3 does three (1.65e12, 1.67 ms at
// the tensor cores' 989 TFLOP/s), K4 four (2.2e12, 2.22 ms), and each moves
// under 0.5 GB (0.15 ms at 3.35 TB/s): both are bound by operations. This
// first version runs every product on f32 FMAs from shared memory, whose
// peak is 67 TFLOP/s, so it cannot come within 15x of that bound; the
// tensor-core redesign (mma/wgmma on bf16 tiles, TMA, pipelined tiles) is
// later work, as it is for the forward.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LDT = BQ + 4;   // row stride of the transposed q-side tiles

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

// x rounded to T and back: the rounding the plain version applies to p and ds.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is unit-stride
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;
  const float* lse;  // (b, h, sq)
  const float* dd;   // D, (b, h, sq)
  void* dq;
  void* dk;
  void* dv;
  int64_t sq, sk;
  int h, kv_h, d;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale;
  int causal;
};

// Rows [row0, row0 + ROWS) of one head, transposed into dst[c * LD + r],
// zero past `rows` and past d.
template <typename T, int DP, int ROWS, int LD>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int64_t row0,
                                                int64_t rows, int64_t row_stride, int d) {
  for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const int64_t row = row0 + r;
    dst[c * LD + r] = (row < rows && c < d) ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

// Rows [row0, row0 + ROWS) of one head as they are, into dst[r * DP + c].
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t row0, int64_t rows,
                                          int64_t row_stride, int d) {
  for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const int64_t row = row0 + r;
    dst[r * DP + c] = (row < rows && c < d) ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

// ---------------------------------------------------------------- K3: dq --
// Shared memory: Q^T [DP][LDT], dO^T [DP][LDT], one K/V buffer [DP][LDT]
// (K^T, then V^T, then K as [64][DP]), dS [64][LDT]. Thread (ty, tx) owns
// q rows ty*4 .. ty*4+3 and, of each 64-key tile, keys tx*4 .. tx*4+3; of
// dq it owns columns g*64 + tx*4 .. +3 for each 64-wide group g.
constexpr size_t dq_smem_bytes(int dp) { return sizeof(float) * (3 * dp * LDT + BQ * LDT); }

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int BK = 64;
  constexpr int G = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = qt + DP * LDT;
  float* kv = dot + DP * LDT;
  float* dss = kv + DP * LDT;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (p.h / p.kv_h);
  const T* qb = static_cast<const T*>(p.q) + batch * p.qs.b + head * p.qs.h;
  const T* dob = static_cast<const T*>(p.d_o) + batch * p.dos.b + head * p.dos.h;
  const T* kb = static_cast<const T*>(p.k) + batch * p.ks.b + kv_head * p.ks.h;
  const T* vb = static_cast<const T*>(p.v) + batch * p.vs.b + kv_head * p.vs.h;
  const int64_t stat0 = ((int64_t)batch * p.h + head) * p.sq;

  load_transposed<T, DP, BQ, LDT>(qt, qb, q0, p.sq, p.qs.s, p.d);
  load_transposed<T, DP, BQ, LDT>(dot, dob, q0, p.sq, p.dos.s, p.d);

  float lse[4], dd[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t q_pos = q0 + ty * 4 + i;
    lse[i] = q_pos < p.sq ? p.lse[stat0 + q_pos] : 0.f;
    dd[i] = q_pos < p.sq ? p.dd[stat0 + q_pos] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int64_t q_last = min64(q0 + BQ, p.sq) - 1;
  const int64_t k_end = p.causal ? min64(p.sk, q_last + 1) : p.sk;
  for (int64_t k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q and dO are stored; the previous tile's K and dS are read
    load_transposed<T, DP, BK, LDT>(kv, kb, k0, p.sk, p.ks.s, p.d);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
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
    __syncthreads();  // K^T is read
    load_transposed<T, DP, BK, LDT>(kv, vb, k0, p.sk, p.vs.s, p.d);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&dot[c * LDT + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[c * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(av[i], bv[j], dp[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q0 + ty * 4 + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k_pos = k0 + tx * 4 + j;
        const bool seen = q_pos < p.sq && k_pos < p.sk && !(p.causal && k_pos > q_pos);
        const float pij = seen ? expf(__fmul_rn(s[i][j], p.scale) - lse[i]) : 0.f;
        ds[j] = round_to<T>(pij * (dp[i][j] - dd[i]) * p.scale);
      }
      *reinterpret_cast<float4*>(&dss[(ty * 4 + i) * LDT + tx * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // V^T is read, dS is stored
    load_rows<T, DP, BK>(kv, kb, k0, p.sk, p.ks.s, p.d);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float dsr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&dss[(ty * 4 + i) * LDT + kk]);
        dsr[i][0] = t.x; dsr[i][1] = t.y; dsr[i][2] = t.z; dsr[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(&kv[(kk + u) * DP + g * 64 + tx * 4]);
          const float kr[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][g * 4 + c] = fmaf(dsr[i][u], kr[c], acc[i][g * 4 + c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t q_pos = q0 + ty * 4 + i;
    if (q_pos >= p.sq) continue;
    T* row = static_cast<T*>(p.dq) + batch * p.dqs.b + q_pos * p.dqs.s + head * p.dqs.h;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g * 64 + tx * 4 + c;
        if (col < p.d) row[col] = from_float<T>(acc[i][g * 4 + c]);
      }
  }
}

// ----------------------------------------------------------- K4: dk, dv --
// R key rows per thread, BKV = 16 R keys per block. Shared memory: K^T and
// V^T [DP][BKV + 4] for the whole walk, one q-side buffer [DP][LDT] (Q^T,
// then dO^T, then dO as [64][DP], then Q as [64][DP]) and one [BKV][LDT]
// buffer (P^T, then dS^T). Thread (ty, tx) owns keys ty*R .. ty*R+R-1 and,
// of each q tile, rows tx*4 .. tx*4+3; of dk and dv it owns columns
// g*64 + tx*4 .. +3 for each 64-wide group g.
constexpr size_t dkv_smem_bytes(int dp, int r) {
  return sizeof(float) * (2 * dp * (16 * r + 4) + dp * LDT + 16 * r * LDT);
}

// R consecutive floats from shared memory (16- or 8-byte aligned).
template <int R> __device__ __forceinline__ void load_r(float (&out)[R], const float* src);
template <> __device__ __forceinline__ void load_r<4>(float (&out)[4], const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
template <> __device__ __forceinline__ void load_r<2>(float (&out)[2], const float* src) {
  const float2 t = *reinterpret_cast<const float2*>(src);
  out[0] = t.x; out[1] = t.y;
}

// acc[a][g*4 + c] += sum over the 64 q rows r of lhs[(ty*R + a) * LDT + r] * rhs[r * DP + g*64 + tx*4 + c]
template <int DP, int R>
__device__ __forceinline__ void accumulate_rows(float (&acc)[R][DP / 16], const float* lhs,
                                                const float* rhs, int tx, int ty) {
  constexpr int G = DP / 64;
#pragma unroll 2
  for (int rr = 0; rr < BQ; rr += 4) {
    float l[R][4];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float4 t = *reinterpret_cast<const float4*>(&lhs[(ty * R + a) * LDT + rr]);
      l[a][0] = t.x; l[a][1] = t.y; l[a][2] = t.z; l[a][3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(&rhs[(rr + u) * DP + g * 64 + tx * 4]);
        const float rv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][g * 4 + c] = fmaf(l[a][u], rv[c], acc[a][g * 4 + c]);
      }
  }
}

template <typename T, int DP, int R>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int BKV = 16 * R;
  constexpr int LDK = BKV + 4;
  constexpr int G = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = kt + DP * LDK;
  float* buf = vt + DP * LDK;
  float* pb = buf + DP * LDT;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t k0 = (int64_t)blockIdx.x * BKV;
  const int kv_head = blockIdx.y, batch = blockIdx.z;
  const int rep = p.h / p.kv_h;
  load_transposed<T, DP, BKV, LDK>(kt, static_cast<const T*>(p.k) + batch * p.ks.b +
                                           kv_head * p.ks.h, k0, p.sk, p.ks.s, p.d);
  load_transposed<T, DP, BKV, LDK>(vt, static_cast<const T*>(p.v) + batch * p.vs.b +
                                           kv_head * p.vs.h, k0, p.sk, p.vs.s, p.d);

  float dk[R][4 * G], dv[R][4 * G];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dk[a][c] = dv[a][c] = 0.f;

  const int64_t n_q = (p.sq + BQ - 1) / BQ;
  // The first q tile whose last row reaches key k0: q0 + 63 >= k0.
  const int64_t qi0 = p.causal ? k0 / BQ : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int head = kv_head * rep + hh;
    const T* qb = static_cast<const T*>(p.q) + batch * p.qs.b + head * p.qs.h;
    const T* dob = static_cast<const T*>(p.d_o) + batch * p.dos.b + head * p.dos.h;
    const int64_t stat0 = ((int64_t)batch * p.h + head) * p.sq;
    for (int64_t qi = qi0; qi < n_q; ++qi) {
      const int64_t q0 = qi * BQ;
      float lse[4], dd[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t q_pos = q0 + tx * 4 + b;
        lse[b] = q_pos < p.sq ? p.lse[stat0 + q_pos] : 0.f;
        dd[b] = q_pos < p.sq ? p.dd[stat0 + q_pos] : 0.f;
      }
      __syncthreads();  // K^T, V^T are stored; the previous pair's Q and dS^T are read
      load_transposed<T, DP, BQ, LDT>(buf, qb, q0, p.sq, p.qs.s, p.d);
      __syncthreads();

      float s[R][4] = {}, dp[R][4] = {};
#pragma unroll 8
      for (int c = 0; c < DP; ++c) {
        float kr[R];
        load_r<R>(kr, &kt[c * LDK + ty * R]);
        const float4 b = *reinterpret_cast<const float4*>(&buf[c * LDT + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[a][j] = fmaf(kr[a], bv[j], s[a][j]);
      }
      __syncthreads();  // Q^T is read
      load_transposed<T, DP, BQ, LDT>(buf, dob, q0, p.sq, p.dos.s, p.d);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DP; ++c) {
        float vr[R];
        load_r<R>(vr, &vt[c * LDK + ty * R]);
        const float4 b = *reinterpret_cast<const float4*>(&buf[c * LDT + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[a][j] = fmaf(vr[a], bv[j], dp[a][j]);
      }

      // p and ds of this thread's (key, q row) pairs; P^T in dO's dtype goes
      // to shared memory now, ds waits in registers until P^T is consumed.
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int64_t k_pos = k0 + ty * R + a;
        float pr[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int64_t q_pos = q0 + tx * 4 + b;
          const bool seen = q_pos < p.sq && k_pos < p.sk && !(p.causal && k_pos > q_pos);
          const float pij = seen ? expf(__fmul_rn(s[a][b], p.scale) - lse[b]) : 0.f;
          s[a][b] = round_to<T>(pij * (dp[a][b] - dd[b]) * p.scale);  // ds
          pr[b] = round_to<T>(pij);
        }
        *reinterpret_cast<float4*>(&pb[(ty * R + a) * LDT + tx * 4]) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
      }
      __syncthreads();  // dO^T is read, P^T is stored
      load_rows<T, DP, BQ>(buf, dob, q0, p.sq, p.dos.s, p.d);
      __syncthreads();
      accumulate_rows<DP, R>(dv, pb, buf, tx, ty);
      __syncthreads();  // P^T and dO are read
#pragma unroll
      for (int a = 0; a < R; ++a)
        *reinterpret_cast<float4*>(&pb[(ty * R + a) * LDT + tx * 4]) =
            make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
      load_rows<T, DP, BQ>(buf, qb, q0, p.sq, p.qs.s, p.d);
      __syncthreads();
      accumulate_rows<DP, R>(dk, pb, buf, tx, ty);
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int64_t k_pos = k0 + ty * R + a;
    if (k_pos >= p.sk) continue;
    T* dkrow = static_cast<T*>(p.dk) + batch * p.dks.b + k_pos * p.dks.s + kv_head * p.dks.h;
    T* dvrow = static_cast<T*>(p.dv) + batch * p.dvs.b + k_pos * p.dvs.s + kv_head * p.dvs.h;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g * 64 + tx * 4 + c;
        if (col < p.d) {
          dkrow[col] = from_float<T>(dk[a][g * 4 + c]);
          dvrow[col] = from_float<T>(dv[a][g * 4 + c]);
        }
      }
  }
}

// Above 48 KB a launch is refused unless the kernel opts in first.
template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Params& p, int64_t batch, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.sq + BQ - 1) / BQ), (unsigned)p.h, (unsigned)batch);
  if (p.d <= 64) return launch_kernel(flash_bwd_dq_kernel<T, 64>, grid, dq_smem_bytes(64), p, stream);
  if (p.d <= 128)
    return launch_kernel(flash_bwd_dq_kernel<T, 128>, grid, dq_smem_bytes(128), p, stream);
  return launch_kernel(flash_bwd_dq_kernel<T, 256>, grid, dq_smem_bytes(256), p, stream);
}

template <typename T>
cudaError_t launch_dkv(const Params& p, int64_t batch, cudaStream_t stream) {
  const int r = p.d <= 128 ? 4 : 2;
  const dim3 grid((unsigned)((p.sk + 16 * r - 1) / (16 * r)), (unsigned)p.kv_h, (unsigned)batch);
  if (p.d <= 64)
    return launch_kernel(flash_bwd_dkv_kernel<T, 64, 4>, grid, dkv_smem_bytes(64, 4), p, stream);
  if (p.d <= 128)
    return launch_kernel(flash_bwd_dkv_kernel<T, 128, 4>, grid, dkv_smem_bytes(128, 4), p, stream);
  return launch_kernel(flash_bwd_dkv_kernel<T, 256, 2>, grid, dkv_smem_bytes(256, 2), p, stream);
}

bool fill(Params& p, const void* q, const void* k, const void* v, const void* d_o,
          const void* lse, const void* dd, int64_t b, int64_t sq, int64_t sk, int64_t h,
          int64_t kv_h, int64_t d, const int64_t* strides, int64_t causal, float scale) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv_h < 1 || h % kv_h != 0 || d < 1 ||
      d > 256 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 0x7fffffff ||
      (sk + 31) / 32 > 0x7fffffff)
    return false;
  p.q = q;
  p.k = k;
  p.v = v;
  p.d_o = d_o;
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.sq = sq;
  p.sk = sk;
  p.h = (int)h;
  p.kv_h = (int)kv_h;
  p.d = (int)d;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.dos = {strides[9], strides[10], strides[11]};
  p.scale = scale;
  p.causal = causal != 0;
  return true;
}

}  // namespace

// Both launchers: q, k, v, d_o device pointers in the layouts above; lse and
// dd device pointers to (b, h, sq) float32. strides: int64 in elements,
// (batch, seq, head) for q, k, v, d_o and then each output in turn. dtype:
// 0 = bf16, 1 = f16, 2 = f32 (inputs and outputs alike). Each returns the
// launch's cudaError_t (0 on success).

// K3: dq, (b, sq, h, d). strides: 15 (q, k, v, d_o, dq).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* lse, const void* dd, void* dq, int64_t b,
                                 int64_t sq, int64_t sk, int64_t h, int64_t kv_h, int64_t d,
                                 const int64_t* strides, int64_t dtype, int64_t causal,
                                 float scale, void* stream) {
  Params p = {};
  if (!fill(p, q, k, v, d_o, lse, dd, b, sq, sk, h, kv_h, d, strides, causal, scale))
    return (int)cudaErrorInvalidValue;
  p.dq = dq;
  p.dqs = {strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dq<__nv_bfloat16>(p, b, s);
    case 1: return (int)launch_dq<__half>(p, b, s);
    case 2: return (int)launch_dq<float>(p, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4: dk and dv, (b, sk, kv_h, d) each. strides: 18 (q, k, v, d_o, dk, dv).
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* lse, const void* dd, void* dk, void* dv,
                                  int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h,
                                  int64_t d, const int64_t* strides, int64_t dtype,
                                  int64_t causal, float scale, void* stream) {
  Params p = {};
  if (!fill(p, q, k, v, d_o, lse, dd, b, sq, sk, h, kv_h, d, strides, causal, scale))
    return (int)cudaErrorInvalidValue;
  p.dk = dk;
  p.dv = dv;
  p.dks = {strides[12], strides[13], strides[14]};
  p.dvs = {strides[15], strides[16], strides[17]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dkv<__nv_bfloat16>(p, b, s);
    case 1: return (int)launch_dkv<__half>(p, b, s);
    case 2: return (int)launch_dkv<float>(p, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
