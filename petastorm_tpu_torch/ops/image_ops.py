"""On-device image ops: the input-pipeline tail after a batch is staged.

``normalize_images`` fuses uint8 -> float, scale to [0, 1], normalize by
mean/std and the cast to ``out_dtype`` into one pass, so the staged uint8
batch (4x smaller than float32 over PCIe) is expanded only on the card.
A CUDA tensor goes through the hand-written kernel ``csrc/normalize.cu``
(it raises if the kernel cannot build or launch); a CPU tensor goes through
the plain PyTorch version :func:`normalize_images_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from petastorm_tpu_torch import kernels

KERNEL_NAME = "normalize_u8"
_OUT_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_MAX_CHANNELS = 4


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
    """``(..., C)`` uint8 images -> ``(x/255 - mean)/std`` in ``out_dtype``
    (bf16, f16 or f32), the same shape."""
    if images.dtype != torch.uint8:
        raise TypeError(f"normalize_images takes uint8 images, got {images.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16, float16 or float32, got {out_dtype}")
    if images.dim() == 0:
        raise ValueError("normalize_images needs a channel dimension")
    if images.device.type == "cpu":
        return normalize_images_plain(images, mean, std, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"normalize_images runs on CPU or CUDA tensors, got {images.device}")
    if not images.is_contiguous():
        raise ValueError("normalize_images needs a contiguous (channels-last) tensor")
    channels = images.shape[-1]
    if not 1 <= channels <= _MAX_CHANNELS:
        raise ValueError(f"the CUDA kernel takes 1..{_MAX_CHANNELS} channels, got {channels}")
    scale, bias = normalize_factors(channels, mean, std)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    if images.numel() == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = fn(images.data_ptr(), out.data_ptr(), images.numel(), channels,
                 _OUT_DTYPES[out_dtype],
                 (ctypes.c_float * channels)(*scale.tolist()),
                 (ctypes.c_float * channels)(*bias.tolist()), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed with cudaError_t {err}")
    kernels.count_launch(KERNEL_NAME)
    return out


def _launcher():
    from petastorm_tpu_torch.kernels.build import load
    fn = load("normalize").normalize_u8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
