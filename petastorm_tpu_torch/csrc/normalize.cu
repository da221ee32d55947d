// Image normalisation for Hopper (sm_90a): out = x * scale[c] + bias[c].
//
// Replaces petastorm_tpu/ops/image_ops.py::_normalize_kernel, the Pallas
// kernel behind normalize_images. x is a uint8 image batch (..., C) in
// channels-last order, so the channel of flat element i is i % C; scale and
// bias are the per-channel float32 factors 1/(255*std) and -mean/std that
// the Python wrapper computes, passed by value (C <= 4). The output is
// bf16, f16 or f32, rounded to nearest even from the f32 result.
//
// The multiply and the add are rounded one at a time (__fmul_rn, __fadd_rn),
// as the plain PyTorch version rounds them, so the two agree bit for bit. A
// fused multiply-add rounds once and differs where x*scale and bias cancel
// (x/255 close to the mean): there the product's f32 rounding is many
// 16-bit ulps of the tiny result, and its sign can flip.
//
// Bound: device memory. Each element reads 1 byte and writes 2 (bf16), with
// two flops in between, far below the card's ratio of operations to bytes.
// At 256x224x224x3 that is 115.6 MB per call, about 35 us at 3.35 TB/s.
// The design follows from that alone: each thread of a grid-stride loop
// takes 16 input bytes as one 16-byte load and writes its 16 outputs as
// 16-byte stores (two for bf16/f16, four for f32), so a warp moves 512
// contiguous input bytes an instruction. The channel of a vector's first
// element is taken once per vector (16 v mod C, which is 0 unless C = 3),
// in 32-bit arithmetic when the vector count allows; the 16 elements then
// walk the channels in order, with the C scales and biases rotated by that
// first channel in registers (selects, no divergent branch). A tail that is
// not a whole vector, and a whole input or output that is not 16-byte
// aligned (a contiguous view at an odd offset), take a scalar loop in the
// same kernel. The TPU kernel's (rows, 128) lane tiling and its periodic
// scale/bias tiles exist only for the TPU's vector layout and are not
// carried over.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Affine {
  float scale[4];
  float bias[4];
};

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float normalize(uint32_t x, float scale, float bias) {
  return __fadd_rn(__fmul_rn((float)x, scale), bias);
}

// Two f32 values rounded to OutT and packed (lo first) into 32 bits.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The 16 results of one vector, stored as 16-byte words at out.
template <typename OutT>
__device__ __forceinline__ void store16(OutT* out, const float (&y)[16]) {
  if constexpr (sizeof(OutT) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<float4*>(out)[j] =
          make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      reinterpret_cast<uint4*>(out)[j] = make_uint4(
          pack2(out, y[8 * j], y[8 * j + 1]), pack2(out, y[8 * j + 2], y[8 * j + 3]),
          pack2(out, y[8 * j + 4], y[8 * j + 5]), pack2(out, y[8 * j + 6], y[8 * j + 7]));
  }
}

// a[c] by selects, so that a stays in registers.
template <int C> __device__ __forceinline__ float pick(const float (&a)[C], int c) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < C; ++k) r = c == k ? a[k] : r;
  return r;
}

// I: the vector index type, uint32_t when every vector index fits.
template <int C, typename OutT, typename I>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x, OutT* __restrict__ out,
                                    int64_t n, int64_t n_vec, Affine affine) {
  float sc[C], bi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sc[c] = affine.scale[c];
    bi[c] = affine.bias[c];
  }
  const I stride = (I)gridDim.x * blockDim.x;
  for (I v = (I)blockIdx.x * blockDim.x + threadIdx.x; v < (I)n_vec; v += stride) {
    const uint4 in = reinterpret_cast<const uint4*>(x)[v];
    const uint32_t words[4] = {in.x, in.y, in.z, in.w};
    // Element j of the vector is in channel (c0 + j) % C, c0 = 16 v % C.
    float rs[C], rb[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      rs[k] = sc[k];
      rb[k] = bi[k];
    }
    if constexpr (16 % C != 0) {
      const int c0 = (int)((16 % C) * (v % C) % C);
#pragma unroll
      for (int t = 1; t < C; ++t)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          rs[k] = c0 == t ? sc[(t + k) % C] : rs[k];
          rb[k] = c0 == t ? bi[(t + k) % C] : rb[k];
        }
    }
    float y[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      y[j] = normalize((words[j / 4] >> (8 * (j % 4))) & 0xffu, rs[j % C], rb[j % C]);
    store16(out + (int64_t)v * 16, y);
  }
  // The tail past the last whole vector (all of it when unaligned).
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = n_vec * 16 + tid; i < n; i += (int64_t)stride) {
    const int c = (int)(i % C);
    store(out + i, normalize(x[i], pick(sc, c), pick(bi, c)));
  }
}

template <int C, typename OutT>
cudaError_t launch_c(const uint8_t* x, OutT* out, int64_t n, const Affine& affine,
                     cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t n_vec = aligned ? n / 16 : 0;
  const int threads = 256;
  const int64_t work = n_vec > 0 ? n_vec : n;
  int64_t blocks = (work + threads - 1) / threads;
  // Enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (n_vec + (int64_t)blocks * threads < ((int64_t)1 << 32))
    normalize_u8_kernel<C, OutT, uint32_t><<<(unsigned)blocks, threads, 0, stream>>>(
        x, out, n, n_vec, affine);
  else
    normalize_u8_kernel<C, OutT, uint64_t><<<(unsigned)blocks, threads, 0, stream>>>(
        x, out, n, n_vec, affine);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(const uint8_t* x, OutT* out, int64_t n, int channels, const Affine& affine,
                   cudaStream_t stream) {
  switch (channels) {
    case 1: return launch_c<1>(x, out, n, affine, stream);
    case 2: return launch_c<2>(x, out, n, affine, stream);
    case 3: return launch_c<3>(x, out, n, affine, stream);
    case 4: return launch_c<4>(x, out, n, affine, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out_dtype: 0 = bf16, 1 = f16, 2 = f32. scale and bias point to `channels`
// host floats. Returns the launch's cudaError_t (0 on success).
extern "C" int normalize_u8(const void* x, void* out, int64_t n, int64_t channels,
                            int64_t out_dtype, const float* scale, const float* bias,
                            void* stream) {
  if (channels < 1 || channels > 4) return (int)cudaErrorInvalidValue;
  Affine affine = {};
  for (int c = 0; c < channels; ++c) {
    affine.scale[c] = scale[c];
    affine.bias[c] = bias[c];
  }
  const uint8_t* xs = static_cast<const uint8_t*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return (int)launch(xs, static_cast<__nv_bfloat16*>(out), n, (int)channels, affine, s);
    case 1: return (int)launch(xs, static_cast<__half*>(out), n, (int)channels, affine, s);
    case 2: return (int)launch(xs, static_cast<float*>(out), n, (int)channels, affine, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
