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
// The design follows from that alone: a grid-stride loop over int64 flat
// indices, the channel as a compile-time modulo (one instantiation per C),
// no shared memory. The TPU kernel's (rows, 128) lane tiling and its
// periodic scale/bias tiles exist only for the TPU's vector layout and are
// not carried over. This simple version loads one byte per thread per
// iteration; 16-byte vector loads (uchar4 and wider) are later work.

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

template <int C, typename OutT>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x, OutT* __restrict__ out,
                                    int64_t n, Affine affine) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = (int)(i % C);
    store(out + i, __fadd_rn(__fmul_rn((float)x[i], affine.scale[c]), affine.bias[c]));
  }
}

template <typename OutT>
cudaError_t launch(const uint8_t* x, OutT* out, int64_t n, int channels, const Affine& affine,
                   cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // Enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  switch (channels) {
    case 1: normalize_u8_kernel<1, OutT><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n, affine); break;
    case 2: normalize_u8_kernel<2, OutT><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n, affine); break;
    case 3: normalize_u8_kernel<3, OutT><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n, affine); break;
    case 4: normalize_u8_kernel<4, OutT><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n, affine); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
