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
//
// A second route, normalize_u8_strided, takes every other input: any
// strides (a crop, a transpose, an NCHW tensor seen as NHWC) and any channel
// count. The wrapper collapses the input's mergeable dimensions first, so
// the kernel gets at most 8 (sizes, strides) pairs, templated on their
// number. Each element of the contiguous output reads the input byte its
// index gives through those sizes and strides, and its channel's scale and
// bias (channel = index % C, as the output is contiguous with C
// last) from a small float32 device buffer rather than a by-value array, so
// C is not bounded. The same two roundings as above keep it bit-equal to the
// plain version. Dividing an index through the sizes costs a few integer
// divisions, so it is done once a lane and a row, not once an element: a
// warp takes 512 consecutive output elements, lane l those at l, l + 32,
// ..., l + 480, so that each of the warp's 16 loads and stores covers 32
// consecutive elements (consecutive bytes where the innermost stride is 1,
// as in a crop). A lane divides for its first element, then walks the
// innermost dimension 32 elements at a time by adding 32 strides (dividing
// again only where it wraps into the next row), steps the channel by
// 32 mod C, and issues its 16 loads before it converts and stores any. At
// (256, 208, 208, 3) it takes 43 % of the memory bound on an H100.

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

// ---------------------------------------------------------------- strided

constexpr int kMaxDims = 8;

// The input's collapsed layout: sizes and strides (in elements, which are
// bytes for uint8), outermost first.
struct Layout {
  int64_t size[kMaxDims];
  int64_t stride[kMaxDims];
};

// Elements a lane takes at once: a warp takes 32 * kRun consecutive output
// elements, lane l those at l, l + 32, ..., so that each of the warp's kRun
// loads and stores covers 32 consecutive elements.
constexpr int kRun = 16;

// The input offset of output element i.
template <int NDIM, typename I>
__device__ __forceinline__ I input_offset(I i, const Layout& layout) {
  I off = 0;
#pragma unroll
  for (int d = NDIM - 1; d > 0; --d) {
    const I s = (I)layout.size[d];
    off += (i % s) * (I)layout.stride[d];
    i /= s;
  }
  return off + i * (I)layout.stride[0];
}

// I: the index type, uint32_t when every output index and input offset fits.
template <int NDIM, typename OutT, typename I>
__global__ void normalize_u8_strided_kernel(const uint8_t* __restrict__ x,
                                            OutT* __restrict__ out, int64_t n,
                                            int64_t channels, Layout layout,
                                            const float* __restrict__ affine) {
  const I count = (I)n, c_count = (I)channels;
  const I inner_size = (I)layout.size[NDIM - 1];
  const I inner_step = 32 * (I)layout.stride[NDIM - 1];
  const I c_step = 32 % c_count;
  const I chunks = (count + 32 * kRun - 1) / (32 * kRun);
  const I warps = (I)gridDim.x * (blockDim.x / 32);
  const I lane = threadIdx.x % 32;
  for (I chunk = ((I)blockIdx.x * blockDim.x + threadIdx.x) / 32; chunk < chunks;
       chunk += warps) {
    const I first = chunk * 32 * kRun + lane;
    // Walk the innermost dimension 32 elements at a time; divide again
    // only where it wraps into the next row.
    I off = input_offset<NDIM>(first, layout), inner = first % inner_size;
    uint32_t v[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const I i = first + 32 * k;
      v[k] = i < count ? x[off] : 0u;
      inner += 32;
      off += inner_step;
      if (inner >= inner_size) {
        inner = (i + 32) % inner_size;
        off = input_offset<NDIM>(i + 32, layout);
      }
    }
    I c = first % c_count;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const I i = first + 32 * k;
      if (i < count)
        store(out + i, normalize(v[k], __ldg(affine + c), __ldg(affine + c_count + c)));
      c += c_step;
      c = c >= c_count ? c - c_count : c;
    }
  }
}

template <int NDIM, typename OutT>
cudaError_t launch_strided_d(const uint8_t* x, OutT* out, int64_t n, int64_t channels,
                             const Layout& layout, const float* affine, cudaStream_t stream) {
  const int threads = 256;
  const int64_t chunks = (n + 32 * kRun - 1) / (32 * kRun);
  int64_t blocks = (chunks + threads / 32 - 1) / (threads / 32);
  if (blocks > 132 * 32) blocks = 132 * 32;
  // The largest input offset any element reaches. (A walk may compute
  // offsets past the end, which it never reads.)
  int64_t max_off = 0;
  for (int d = 0; d < NDIM; ++d) max_off += (layout.size[d] - 1) * layout.stride[d];
  if (n + (int64_t)blocks * threads * kRun + 64 * kRun < ((int64_t)1 << 32) &&
      max_off < ((int64_t)1 << 32))
    normalize_u8_strided_kernel<NDIM, OutT, uint32_t><<<(unsigned)blocks, threads, 0, stream>>>(
        x, out, n, channels, layout, affine);
  else
    normalize_u8_strided_kernel<NDIM, OutT, uint64_t><<<(unsigned)blocks, threads, 0, stream>>>(
        x, out, n, channels, layout, affine);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_strided(const uint8_t* x, OutT* out, int64_t n, int64_t channels, int ndim,
                           const Layout& layout, const float* affine, cudaStream_t stream) {
  switch (ndim) {
    case 1: return launch_strided_d<1>(x, out, n, channels, layout, affine, stream);
    case 2: return launch_strided_d<2>(x, out, n, channels, layout, affine, stream);
    case 3: return launch_strided_d<3>(x, out, n, channels, layout, affine, stream);
    case 4: return launch_strided_d<4>(x, out, n, channels, layout, affine, stream);
    case 5: return launch_strided_d<5>(x, out, n, channels, layout, affine, stream);
    case 6: return launch_strided_d<6>(x, out, n, channels, layout, affine, stream);
    case 7: return launch_strided_d<7>(x, out, n, channels, layout, affine, stream);
    case 8: return launch_strided_d<8>(x, out, n, channels, layout, affine, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The general route: out (contiguous, n elements, the input's shape) from x
// read through `ndim` <= 8 collapsed (sizes, strides), outermost first, with
// non-negative strides in elements. affine points to 2 * channels device
// floats: the scales, then the biases. Returns the launch's cudaError_t.
extern "C" int normalize_u8_strided(const void* x, void* out, int64_t n, int64_t channels,
                                    int64_t out_dtype, int64_t ndim, const int64_t* sizes,
                                    const int64_t* strides, const float* affine,
                                    void* stream) {
  if (channels < 1 || ndim < 1 || ndim > kMaxDims || n < 1) return (int)cudaErrorInvalidValue;
  Layout layout = {};
  for (int d = 0; d < ndim; ++d) {
    if (sizes[d] < 1 || strides[d] < 0) return (int)cudaErrorInvalidValue;
    layout.size[d] = sizes[d];
    layout.stride[d] = strides[d];
  }
  const uint8_t* xs = static_cast<const uint8_t*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nd = (int)ndim;
  switch (out_dtype) {
    case 0: return (int)launch_strided(xs, static_cast<__nv_bfloat16*>(out), n, channels, nd,
                                       layout, affine, s);
    case 1: return (int)launch_strided(xs, static_cast<__half*>(out), n, channels, nd, layout,
                                       affine, s);
    case 2: return (int)launch_strided(xs, static_cast<float*>(out), n, channels, nd, layout,
                                       affine, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
