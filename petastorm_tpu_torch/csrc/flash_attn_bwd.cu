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
// is rounded once to the inputs' dtype when it is written.
//
// Two routes, chosen by the wrapper (ops/flash_attn.py::bwd_route) from the
// dtype and head dim before the launch:
//
// Tensor cores (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel; bf16 and
// f16 with d % 8 == 0 and d <= 128). Every product is a wgmma with f32
// accumulators in registers; tiles arrive by TMA (128-byte swizzle, zero
// fill past the edges) into a two-stage ring, one thread issuing the loads
// of tile n+1 while both warpgroups compute on tile n. Each of the two
// warpgroups of a block owns 64 rows of M.
//   K3: one block per (128-row q tile, head, batch); Q and dO stay for the
//       walk, K/V tiles of 64 keys stream up to the causal diagonal.
//       S = Q K^T and dP = dO V^T (both operands K-major), dS formed in
//       registers, then dq += dS K with dS as the register A operand and K
//       read MN-major through the transpose bit (no transposed copy).
//   K4: one block per (128-key tile, kv head, batch); K and V stay, Q/dO
//       tiles of 64 rows (with their lse and D) stream for every (group
//       head, q tile) pair from the first one whose last row reaches the
//       block's keys. The scores are computed transposed, S^T = K Q^T and
//       dP^T = V dO^T, so that P^T and dS^T are already A fragments for
//       dv += P^T dO and dk += dS^T Q (dO and Q MN-major). The grouped-query
//       sum happens in the block.
//   Only the tile that straddles the diagonal or an edge masks; padded keys
//   get p = 0 as if s = -inf, and so do padded q rows. exp is exp2 with
//   log2(e) folded into the scale and lse.
//
// CUDA cores (flash_bwd_dq_kernel, flash_bwd_dkv_kernel; f32, and 16-bit
// inputs with d > 128 or d % 8 != 0): every product an IEEE f32 FMA from
// shared memory (no TF32, so f32 keeps its bars), tiles loaded synchronously.
//   K3: one block of 256 threads per (64-row q tile, head, batch) walks the
//       K/V tiles up to the last key its tile's last row sees (as the
//       forward does) and writes dq once. q tiles are issued last-first.
//   K4: one block per (K/V tile, kv head, batch) walks every (group head,
//       q tile) pair that reaches its keys: the grouped-query sum happens in
//       the block, and the causal q loop starts at the first q tile whose
//       last row reaches the K/V tile (_causal_live). dk and dv are written
//       once. K/V tiles hold 64 keys, 32 at d > 128, so the two f32
//       accumulators stay at 2 x 64 floats a thread and do not spill.
//
// On both routes no output is shared between blocks, so no atomics are used
// and both outputs are the same bits from run to run.
//
// Layout. q, dO, dq are (b, sq, h, d) and k, v, dk, dv are (b, sk, kv_h, d),
// read and written through their batch, sequence and head strides (the
// head dim is unit-stride). The FMA route reads lse and D as contiguous
// (b, h, sq) float32; the tensor-core route reads both from one
// (2, b, h, stats_stride) float32 tensor, stats_stride a multiple of 4.
// The mask is the top-left one (q_pos >= k_pos), so sq != sk works. On the
// FMA route ragged sq, sk and d are zero-filled in shared memory; padded
// keys get s = -inf, so p = 0; padded q rows get p = 0 and their lse and D
// are never read.
//
// Bound. At the training path's shape (b 2, s 8192, 32 heads over 8 kv
// heads, d 128, causal, bf16) each product over the causal pairs is
// 2*b*h*d*s(s+1)/2 = 5.5e11 operations: K3 does three (1.65e12, 1.67 ms at
// the tensor cores' 989 TFLOP/s), K4 four (2.2e12, 2.22 ms), and each moves
// under 0.5 GB (0.15 ms at 3.35 TB/s): both are bound by operations. The
// FMA route's peak is the 67 TFLOP/s of f32 FMAs, so it cannot come within
// 15x of that bound; the tensor-core route is the one the token path takes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// The FMA route's launchers: q, k, v, d_o device pointers in the layouts above; lse and
// dd device pointers to (b, h, sq) float32. strides: int64 in elements,
// (batch, seq, head) for q, k, v, d_o and then each output in turn. dtype:
// 0 = bf16, 1 = f16, 2 = f32 (inputs and outputs alike). Each returns the
// launch's cudaError_t (0 on success).

// K3: dq, (b, sq, h, d). strides: 15 (q, k, v, d_o, dq).
extern "C" int flash_attn_bwd_dq_fma(const void* q, const void* k, const void* v,
                                     const void* d_o, const void* lse, const void* dd, void* dq,
                                     int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv_h,
                                     int64_t d, const int64_t* strides, int64_t dtype,
                                     int64_t causal, float scale, void* stream) {
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
extern "C" int flash_attn_bwd_dkv_fma(const void* q, const void* k, const void* v,
                                      const void* d_o, const void* lse, const void* dd, void* dk,
                                      void* dv, int64_t b, int64_t sq, int64_t sk, int64_t h,
                                      int64_t kv_h, int64_t d, const int64_t* strides,
                                      int64_t dtype, int64_t causal, float scale, void* stream) {
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

// ===================================================== tensor-core route ==

namespace {
namespace tc {

using namespace hopper;

constexpr int THREADS = 256;                  // two warpgroups, 64 rows of M each
constexpr int DQ_BQ = 128, DQ_BK = 64;        // K3: q rows a block, keys a tile
constexpr int DKV_BK = 128, DKV_BQ = 64;      // K4: keys a block, q rows a tile

struct TcParams {
  CUtensorMap tq, tk, tv, tdo;  // encode_bshd maps; K3 boxes Q/dO 128 rows, K/V 64; K4 the reverse
  CUtensorMap tstats;           // K4: encode_rows_f32 over stats, 64-float boxes
  const float* stats;           // (2, b, h, stats_stride): lse, then D
  void* out0;                   // dq; or dk
  void* out1;                   // dv
  Strides os0, os1;             // output strides, in elements
  int64_t stats_stride;
  int b, sq, sk, h, kv_h, d;
  float scale;
  int causal;
};

template <int DP> constexpr int dq_tc_smem() {
  return ATOM + 2 * DQ_BQ * DP * 2 + 2 * 2 * DQ_BK * DP * 2 + 64;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ TcParams p) {
  constexpr uint32_t QP = DQ_BQ * 128, KP = DQ_BK * 128;  // bytes of one panel
  constexpr uint32_t QBYTES = DP / 64 * QP, KBYTES = DP / 64 * KP;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t s_q = base, s_do = base + QBYTES, s_kv = base + 2 * QBYTES;
  const uint32_t bar_q = s_kv + 4 * KBYTES, bar_kv = bar_q + 8;  // bar_kv + 8 * stage

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int hb = p.h * p.b;
  const int tile = (p.sq + DQ_BQ - 1) / DQ_BQ - 1 - (int)(blockIdx.x / hb);  // heaviest first
  const int head = blockIdx.x % hb % p.h, batch = blockIdx.x % hb / p.h;
  const int kv_head = head / (p.h / p.kv_h);
  const int q0 = tile * DQ_BQ;
  const int k_end = p.causal ? min(p.sk, min(q0 + DQ_BQ, p.sq)) : p.sk;
  const int n_tiles = (k_end + DQ_BK - 1) / DQ_BK;

  auto load_kv = [&](int n, int stage) {
    const uint32_t bar = bar_kv + 8 * stage, dst = s_kv + stage * 2 * KBYTES;
    mbar_expect_tx(bar, 2 * KBYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      tma_load_4d(dst + c * KP, &p.tk, bar, c * 64, n * DQ_BK, kv_head, batch);
      tma_load_4d(dst + KBYTES + c * KP, &p.tv, bar, c * 64, n * DQ_BK, kv_head, batch);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * QBYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      tma_load_4d(s_q + c * QP, &p.tq, bar_q, c * 64, q0, head, batch);
      tma_load_4d(s_do + c * QP, &p.tdo, bar_q, c * 64, q0, head, batch);
    }
    load_kv(0, 0);
  }

  // This thread's rows of its warpgroup's 64: lane_row and lane_row + 8.
  const int lane_row = 16 * warp + lane / 4, lane_col = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg;
  float lse2[2], dd[2];  // lse * log2(e) and D of the two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wg_first + lane_row + 8 * i;
    const int64_t at = ((int64_t)batch * p.h + head) * p.stats_stride + row;
    const bool in = row < p.sq;
    lse2[i] = in ? p.stats[at] * LOG2E : 0.f;
    dd[i] = in ? p.stats[(int64_t)p.b * p.h * p.stats_stride + at] : 0.f;
  }
  const float scale_log2 = p.scale * LOG2E;
  float acc[DP / 2];
  zero(acc);
  mbar_wait(bar_q, 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n & 1;
    if (tid == 0 && n + 1 < n_tiles) load_kv(n + 1, stage ^ 1);
    mbar_wait(bar_kv + 8 * stage, (n >> 1) & 1);
    const int k0 = n * DQ_BK;
    // Warpgroup-uniform: skip a tile none of these rows sees.
    if (wg_first < p.sq && (!p.causal || k0 <= wg_first + 63)) {
      const uint32_t s_k = s_kv + stage * 2 * KBYTES, s_v = s_k + KBYTES;
      float s[32], dp[32];
      zero(s);
      zero(dp);
      wgmma_fence();
      scores<T, DP>(s, s_q + wg * 64 * 128, QP, s_k, KP);
      scores<T, DP>(dp, s_do + wg * 64 * 128, QP, s_v, KP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const bool edge = (p.causal && k0 + DQ_BK - 1 > wg_first) || k0 + DQ_BK > p.sk ||
                        wg_first + 64 > p.sq;
      uint32_t a[4][4];  // round(dS), the A fragments of dq += dS K
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i / 2) % 2;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pe = ex2(fmaf(s[i + e], scale_log2, -lse2[r]));
          if (edge) {
            const int q_pos = wg_first + lane_row + 8 * r;
            const int k_pos = k0 + 8 * (i / 4) + lane_col + e;
            if (!(q_pos < p.sq && k_pos < p.sk && !(p.causal && k_pos > q_pos))) pe = 0.f;
          }
          ds[e] = pe * (dp[i + e] - dd[r]) * p.scale;
        }
        a[i / 8][i % 8 / 2] = pack2<T>(ds[0], ds[1]);
      }
      wgmma_fence();
      accumulate<T, DP>(acc, a, s_k, KP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(a[j]);
    }
    __syncthreads();  // both warpgroups are done with this stage before it is refilled
  }

  if (wg_first < p.sq)
    store_rows<T, DP>(acc, p.out0, (int64_t)batch * p.os0.b + (int64_t)head * p.os0.h, p.os0.s,
                      wg_first, p.sq, p.d, lane_row, lane_col);
}

template <int DP> constexpr int dkv_tc_smem() {
  return ATOM + 2 * DKV_BK * DP * 2 + 2 * 2 * DKV_BQ * DP * 2 + 2 * 2 * DKV_BQ * 4 + 64;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ TcParams p) {
  constexpr uint32_t KP = DKV_BK * 128, QP = DKV_BQ * 128;  // bytes of one panel
  constexpr uint32_t KBYTES = DP / 64 * KP, QBYTES = DP / 64 * QP;
  constexpr uint32_t SBYTES = 2 * DKV_BQ * 4;  // lse and D of one q tile
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t raw = smem_addr(tc_smem);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  const uint32_t s_k = base, s_v = base + KBYTES, s_qdo = base + 2 * KBYTES;  // + stage*2*QBYTES
  const uint32_t s_stats = s_qdo + 4 * QBYTES;                                 // + stage*SBYTES
  const uint32_t bar_kv = s_stats + 2 * SBYTES, bar_q = bar_kv + 8;            // bar_q + 8*stage
  const float* stats_smem = reinterpret_cast<const float*>(tc_smem + (s_stats - raw));

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int hb = p.kv_h * p.b;
  const int k0 = (int)(blockIdx.x / hb) * DKV_BK;  // the most q tiles see the first keys
  const int kv_head = blockIdx.x % hb % p.kv_h, batch = blockIdx.x % hb / p.kv_h;
  const int rep = p.h / p.kv_h;
  const int n_q = (p.sq + DKV_BQ - 1) / DKV_BQ;
  // The first q tile whose last row reaches key k0: q0 + 63 >= k0.
  const int qi0 = p.causal ? min(k0 / DKV_BQ, n_q) : 0;
  const int live_q = n_q - qi0;
  const int n_steps = rep * live_q;

  auto load_q = [&](int it, int stage) {
    const int head = kv_head * rep + it / live_q, row0 = (qi0 + it % live_q) * DKV_BQ;
    const uint32_t bar = bar_q + 8 * stage, dst = s_qdo + stage * 2 * QBYTES;
    const uint32_t st = s_stats + stage * SBYTES;
    mbar_expect_tx(bar, 2 * QBYTES + SBYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      tma_load_4d(dst + c * QP, &p.tq, bar, c * 64, row0, head, batch);
      tma_load_4d(dst + QBYTES + c * QP, &p.tdo, bar, c * 64, row0, head, batch);
    }
    tma_load_4d(st, &p.tstats, bar, row0, head, batch, 0);
    tma_load_4d(st + SBYTES / 2, &p.tstats, bar, row0, head, batch, 1);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * KBYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      tma_load_4d(s_k + c * KP, &p.tk, bar_kv, c * 64, k0, kv_head, batch);
      tma_load_4d(s_v + c * KP, &p.tv, bar_kv, c * 64, k0, kv_head, batch);
    }
    if (n_steps > 0) load_q(0, 0);
  }

  // This thread's keys of its warpgroup's 64: lane_row and lane_row + 8.
  const int lane_row = 16 * warp + lane / 4, lane_col = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wg;  // the warpgroup's first key
  const float scale_log2 = p.scale * LOG2E;
  float dk[DP / 2], dv[DP / 2];
  zero(dk);
  zero(dv);
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_steps; ++it) {
    const int stage = it & 1;
    if (tid == 0 && it + 1 < n_steps) load_q(it + 1, stage ^ 1);
    mbar_wait(bar_q + 8 * stage, (it >> 1) & 1);
    const int q0 = (qi0 + it % live_q) * DKV_BQ;
    // Warpgroup-uniform: skip a tile whose rows see none of these keys.
    if (kw0 < p.sk && (!p.causal || q0 + DKV_BQ - 1 >= kw0)) {
      const uint32_t s_q = s_qdo + stage * 2 * QBYTES, s_do = s_q + QBYTES;
      float s[32], dp[32];  // S^T and dP^T: keys by q rows
      zero(s);
      zero(dp);
      wgmma_fence();
      scores<T, DP>(s, s_k + wg * 64 * 128, KP, s_q, QP);
      scores<T, DP>(dp, s_v + wg * 64 * 128, KP, s_do, QP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const float* lse = stats_smem + stage * (SBYTES / 4);
      const float* dd = lse + DKV_BQ;
      const bool edge = (p.causal && q0 < kw0 + 63) || q0 + DKV_BQ > p.sq || kw0 + 64 > p.sk;
      uint32_t ap[4][4], as[4][4];  // round(P^T) and round(dS^T) as A fragments
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i / 2) % 2;
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (i / 4) + lane_col + e;  // q row in the tile
          float pe = ex2(fmaf(s[i + e], scale_log2, -lse[c] * LOG2E));
          if (edge) {
            const int k_pos = kw0 + lane_row + 8 * r, q_pos = q0 + c;
            if (!(q_pos < p.sq && k_pos < p.sk && !(p.causal && k_pos > q_pos))) pe = 0.f;
          }
          pr[e] = pe;
          ds[e] = pe * (dp[i + e] - dd[c]) * p.scale;
        }
        ap[i / 8][i % 8 / 2] = pack2<T>(pr[0], pr[1]);
        as[i / 8][i % 8 / 2] = pack2<T>(ds[0], ds[1]);
      }
      wgmma_fence();
      accumulate<T, DP>(dv, ap, s_do, QP);
      accumulate<T, DP>(dk, as, s_q, QP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_regs(ap[j]);
        fence_regs(as[j]);
      }
    }
    __syncthreads();  // both warpgroups are done with this stage before it is refilled
  }

  if (kw0 < p.sk) {
    store_rows<T, DP>(dk, p.out0, (int64_t)batch * p.os0.b + (int64_t)kv_head * p.os0.h, p.os0.s,
                      kw0, p.sk, p.d, lane_row, lane_col);
    store_rows<T, DP>(dv, p.out1, (int64_t)batch * p.os1.b + (int64_t)kv_head * p.os1.h, p.os1.s,
                      kw0, p.sk, p.d, lane_row, lane_col);
  }
}

template <typename K>
cudaError_t launch(K kernel, int64_t blocks, int smem, const TcParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_tc(bool f16, int64_t blocks, const TcParams& p, cudaStream_t stream) {
  return f16 ? launch(flash_bwd_dq_tc_kernel<__half, DP>, blocks, dq_tc_smem<DP>(), p, stream)
             : launch(flash_bwd_dq_tc_kernel<__nv_bfloat16, DP>, blocks, dq_tc_smem<DP>(), p,
                      stream);
}

template <int DP>
cudaError_t launch_dkv_tc(bool f16, int64_t blocks, const TcParams& p, cudaStream_t stream) {
  return f16 ? launch(flash_bwd_dkv_tc_kernel<__half, DP>, blocks, dkv_tc_smem<DP>(), p, stream)
             : launch(flash_bwd_dkv_tc_kernel<__nv_bfloat16, DP>, blocks, dkv_tc_smem<DP>(), p,
                      stream);
}

// Checks what both kernels take and fills everything but the maps and
// outputs. false on what they do not take.
bool fill(TcParams& p, const void* stats, int64_t b, int64_t sq, int64_t sk, int64_t h,
          int64_t kv_h, int64_t d, int64_t stats_stride, int64_t dtype, int64_t causal,
          float scale) {
  const int64_t limit = 0x7fffffff;
  if ((dtype != 0 && dtype != 1) || b < 1 || h < 1 || kv_h < 1 || h % kv_h != 0 || d < 8 ||
      d > 128 || d % 8 != 0 || sq < 1 || sk < 1 || sq > limit - DQ_BQ || sk > limit - DKV_BK ||
      stats_stride < sq || stats_stride % 4 != 0 ||
      (sq + DQ_BQ - 1) / DQ_BQ * h * b > limit || (sk + DKV_BK - 1) / DKV_BK * kv_h * b > limit)
    return false;
  p.stats = static_cast<const float*>(stats);
  p.stats_stride = stats_stride;
  p.b = (int)b;
  p.sq = (int)sq;
  p.sk = (int)sk;
  p.h = (int)h;
  p.kv_h = (int)kv_h;
  p.d = (int)d;
  p.scale = scale;
  p.causal = causal != 0;
  return true;
}

}  // namespace tc
}  // namespace

// The tensor-core route's launchers: 16-bit inputs only (dtype 0 = bf16,
// 1 = f16), d % 8 == 0 and d <= 128. q, k, v, d_o device pointers in the
// layouts above, each 16-byte aligned, with (batch, seq, head) strides in
// elements that are multiples of 8 (TMA takes strides in multiples of 16
// bytes; the wrapper makes an input contiguous otherwise). stats: (2, b, h,
// stats_stride) float32, lse then D. strides as for the FMA route. Each
// returns the launch's cudaError_t (0 on success); cudaErrorInvalidValue
// on a shape, stride or dtype it does not take or a tensor map the driver
// refuses.

// K3: dq, (b, sq, h, d). strides: 15 (q, k, v, d_o, dq).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* stats, void* dq, int64_t b, int64_t sq, int64_t sk,
                                 int64_t h, int64_t kv_h, int64_t d, const int64_t* strides,
                                 int64_t stats_stride, int64_t dtype, int64_t causal,
                                 float scale, void* stream) {
  using namespace tc;
  TcParams p = {};
  const bool f16 = dtype == 1;
  const int64_t* s = strides;
  if (!fill(p, stats, b, sq, sk, h, kv_h, d, stats_stride, dtype, causal, scale) ||
      !encode_bshd(&p.tq, q, f16, b, sq, h, d, s[0], s[1], s[2], DQ_BQ) ||
      !encode_bshd(&p.tk, k, f16, b, sk, kv_h, d, s[3], s[4], s[5], DQ_BK) ||
      !encode_bshd(&p.tv, v, f16, b, sk, kv_h, d, s[6], s[7], s[8], DQ_BK) ||
      !encode_bshd(&p.tdo, d_o, f16, b, sq, h, d, s[9], s[10], s[11], DQ_BQ))
    return (int)cudaErrorInvalidValue;
  p.out0 = dq;
  p.os0 = {s[12], s[13], s[14]};
  const int64_t blocks = (sq + DQ_BQ - 1) / DQ_BQ * h * b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d <= 64 ? launch_dq_tc<64>(f16, blocks, p, st)
                       : launch_dq_tc<128>(f16, blocks, p, st));
}

// K4: dk and dv, (b, sk, kv_h, d) each. strides: 18 (q, k, v, d_o, dk, dv).
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* stats, void* dk, void* dv, int64_t b, int64_t sq,
                                  int64_t sk, int64_t h, int64_t kv_h, int64_t d,
                                  const int64_t* strides, int64_t stats_stride, int64_t dtype,
                                  int64_t causal, float scale, void* stream) {
  using namespace tc;
  TcParams p = {};
  const bool f16 = dtype == 1;
  const int64_t* s = strides;
  if (!fill(p, stats, b, sq, sk, h, kv_h, d, stats_stride, dtype, causal, scale) ||
      !encode_bshd(&p.tq, q, f16, b, sq, h, d, s[0], s[1], s[2], DKV_BQ) ||
      !encode_bshd(&p.tk, k, f16, b, sk, kv_h, d, s[3], s[4], s[5], DKV_BK) ||
      !encode_bshd(&p.tv, v, f16, b, sk, kv_h, d, s[6], s[7], s[8], DKV_BK) ||
      !encode_bshd(&p.tdo, d_o, f16, b, sq, h, d, s[9], s[10], s[11], DKV_BQ) ||
      !encode_rows_f32(&p.tstats, stats, 2, b, h, sq, stats_stride, DKV_BQ))
    return (int)cudaErrorInvalidValue;
  p.out0 = dk;
  p.out1 = dv;
  p.os0 = {s[12], s[13], s[14]};
  p.os1 = {s[15], s[16], s[17]};
  const int64_t blocks = (sk + DKV_BK - 1) / DKV_BK * kv_h * b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d <= 64 ? launch_dkv_tc<64>(f16, blocks, p, st)
                       : launch_dkv_tc<128>(f16, blocks, p, st));
}
