"""On-device image ops: the input-pipeline tail after a batch is staged.

``normalize_images`` fuses uint8 -> float, scale to [0, 1], normalize by
mean/std and the cast to ``out_dtype`` into one pass, so the staged uint8
batch (4x smaller than float32 over PCIe) is expanded only on the card.
A CUDA tensor goes through the hand-written kernels of
``csrc/normalize.cu`` (it raises if a kernel cannot build or launch): a
contiguous batch of at most 4 channels through the 16-byte vector kernel
(launch count ``normalize_u8``), any other layout or channel count through
the general route, which reads the input through its strides (launch count
``normalize_u8_strided``). A CPU tensor goes through the plain PyTorch
version :func:`normalize_images_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from petastorm_tpu_torch import kernels

KERNEL_NAME = "normalize_u8"
STRIDED_KERNEL_NAME = "normalize_u8_strided"
_OUT_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
#: The vector kernel's channel limit (its factors are passed by value).
_MAX_CHANNELS = 4
#: The general route's limit on dimensions after :func:`collapse_layout`.
_MAX_DIMS = 8


def normalize_factors(channels: int, mean, std):
    """Per-channel ``(scale, bias)`` with ``(x/255 - mean)/std == x*scale +
    bias``, computed in float32 exactly as the JAX package computes them (a
    float64 computation would shift bf16 roundings)."""
    if len(mean) < channels or len(std) < channels:
        raise ValueError(f"images have {channels} channels but mean/std supply "
                         f"{len(mean)}/{len(std)} values")
    mean_t = torch.tensor(mean, dtype=torch.float32)[:channels]
    std_t = torch.tensor(std, dtype=torch.float32)[:channels]
    return 1.0 / (255.0 * std_t), -mean_t / std_t


def normalize_images_plain(images: torch.Tensor, mean=(0.485, 0.456, 0.406),
                           std=(0.229, 0.224, 0.225),
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    scale, bias = normalize_factors(images.shape[-1], mean, std)
    scale, bias = scale.to(images.device), bias.to(images.device)
    return (images.to(torch.float32) * scale + bias).to(out_dtype)


def normalize_images(images: torch.Tensor, mean=(0.485, 0.456, 0.406),
                     std=(0.229, 0.224, 0.225),
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(..., C)`` uint8 images of any layout and channel count ->
    ``(x/255 - mean)/std`` in ``out_dtype`` (bf16, f16 or f32), a contiguous
    tensor of the same shape."""
    if images.dtype != torch.uint8:
        raise TypeError(f"normalize_images takes uint8 images, got {images.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16, float16 or float32, got {out_dtype}")
    if images.dim() == 0:
        raise ValueError("normalize_images needs a channel dimension")
    if images.device.type == "cpu":
        return normalize_images_plain(images, mean, std, out_dtype).contiguous()
    if images.device.type != "cuda":
        raise ValueError(f"normalize_images runs on CPU or CUDA tensors, got {images.device}")
    channels = images.shape[-1]
    scale, bias = normalize_factors(channels, mean, std)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    if images.numel() == 0:
        return out
    if images.is_contiguous() and channels <= _MAX_CHANNELS:
        name = KERNEL_NAME
        fn = _launcher()
        args = (images.data_ptr(), out.data_ptr(), images.numel(), channels,
                _OUT_DTYPES[out_dtype], (ctypes.c_float * channels)(*scale.tolist()),
                (ctypes.c_float * channels)(*bias.tolist()))
    else:
        name = STRIDED_KERNEL_NAME
        sizes, strides = collapse_layout(images.shape, images.stride())
        if len(sizes) > _MAX_DIMS:
            raise ValueError(f"the strided kernel takes at most {_MAX_DIMS} dimensions after "
                             f"merging, this layout has {len(sizes)}")
        fn = _strided_launcher()
        # From pinned memory, so the copy is queued without waiting for the
        # stream to drain (a pageable copy would); `affine` keeps the device
        # buffer alive until the kernel, queued after it, has read it.
        affine = torch.cat([scale, bias]).pin_memory().to(images.device, non_blocking=True)
        args = (images.data_ptr(), out.data_ptr(), images.numel(), channels,
                _OUT_DTYPES[out_dtype], len(sizes), (ctypes.c_int64 * len(sizes))(*sizes),
                (ctypes.c_int64 * len(sizes))(*strides), affine.data_ptr())
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    kernels.count_launch(name)
    return out


def collapse_layout(sizes, strides):
    """``(sizes, strides)`` of a layout with its size-1 dimensions dropped
    and each dimension merged into the one outside it where the outer
    stride is the inner size times the inner stride: the same elements in
    the same order, in the fewest dimensions. A layout of one element
    becomes ``([1], [1])``."""
    dims = [[int(n), int(s)] for n, s in zip(sizes, strides) if n != 1]
    if not dims:
        return [1], [1]
    merged = [dims[0]]
    for n, s in dims[1:]:
        if merged[-1][1] == n * s:
            merged[-1] = [merged[-1][0] * n, s]
        else:
            merged.append([n, s])
    return [n for n, _ in merged], [s for _, s in merged]


def _launcher():
    from petastorm_tpu_torch.kernels.build import load
    fn = load("normalize").normalize_u8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _strided_launcher():
    from petastorm_tpu_torch.kernels.build import load
    fn = load("normalize").normalize_u8_strided
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
