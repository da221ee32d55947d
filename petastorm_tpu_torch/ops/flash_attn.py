"""Flash attention: softmax attention without the O(seq^2) score matrix.

q ``(b, sq, heads, d)``, k/v ``(b, sk, kv_heads, d)`` -> o ``(b, sq, heads,
d)`` in q's dtype, grouped-query native (``heads % kv_heads == 0``; K/V are
never repeated). With ``causal`` a query at position i sees keys 0..i (the
top-left mask of :func:`~petastorm_tpu_torch.parallel.attention.dense_attention`,
so sq != sk is allowed). :func:`flash_attention_lse` also returns the
logsumexp of each query row, ``(b, heads, sq, 1)`` float32.

A CUDA tensor goes through the hand-written kernel ``csrc/flash_attn.cu``
(it raises if the kernel cannot build or launch, and never falls back); a
CPU tensor goes through the plain PyTorch version
:func:`flash_attention_plain`, which computes the same function: float32
scores ``(q . k) * scale`` with ``scale = 1/sqrt(d)`` rounded once to
float32, float32 softmax, p rounded to v's dtype before ``p . v``, float32
accumulation.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from petastorm_tpu_torch import kernels

KERNEL_NAME = "flash_attn_fwd"
#: Largest head dim the kernel takes.
MAX_HEAD_DIM = 256
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
#: Bytes of float32 scores the plain version holds at once (it loops over q rows).
_PLAIN_SCORE_BYTES = 1 << 30
#: CUDA grid limit on the head and batch axes.
_MAX_GRID_YZ = 65535


def softmax_scale(head_dim: int) -> float:
    """``1/sqrt(d)`` rounded once to float32, as the JAX kernel rounds it."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on what the kernel does not take (the plain
    version is held to the same contract)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (b, s, heads, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (b={b}, sk, kv_heads, d={d}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("attention needs at least one key (sk == 0)")
    if h % k.shape[2]:
        raise ValueError(f"heads ({h}) must be a multiple of kv_heads ({k.shape[2]})")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside the kernel's 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of bfloat16, float16 or float32; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {q.device}")
    if d > 1 and any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be unit-stride")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False):
    """Plain PyTorch version of the kernel, on any device: ``(o, lse)``.

    It holds at most about 1 GiB of float32 scores at once, looping over
    blocks of q rows; with ``causal`` each block reads only the keys its
    last row can see. Its float32 products are IEEE float32 as long as
    ``torch.backends.cuda.matmul.allow_tf32`` is off (PyTorch's default)."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    rep = h // kv_h
    scale = softmax_scale(d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (b, kv_h, 1, sk, d)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    rows = max(1, _PLAIN_SCORE_BYTES // (4 * b * h * sk))
    for q0 in range(0, sq, rows):
        q1 = min(sq, q0 + rows)
        n = q1 - q0
        keys = min(sk, q1) if causal else sk
        qc = q[:, q0:q1].float().reshape(b, n, kv_h, rep, d).permute(0, 2, 3, 1, 4)
        s = torch.matmul(qc, kf[..., :keys, :].transpose(-1, -2)) * scale   # (b, g, r, n, keys)
        if causal:
            seen = (torch.arange(q0, q1, device=q.device)[:, None]
                    >= torch.arange(keys, device=q.device)[None, :])
            s = s.masked_fill(~seen, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(v.dtype).float(), vf[..., :keys, :])      # (b, g, r, n, d)
        o[:, q0:q1] = (acc / l).to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, n, h, d)
        lse[:, :, q0:q1] = (m + torch.log(l)).reshape(b, h, n, 1)
    return o, lse


def _flash(q, k, v, causal: bool, with_lse: bool):
    _check(q, k, v)
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal)
        return o, (lse if with_lse else None)
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_YZ} batches and heads, "
                         f"got {b} and {h}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device) if with_lse else None
    if sq == 0:
        return o, lse
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                    *o.stride()[:3])
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, sk, h, kv_h, d, strides,
                 _DTYPES[q.dtype], int(causal), softmax_scale(d), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed with cudaError_t {err}")
    kernels.count_launch(KERNEL_NAME)
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Drop-in for :func:`~petastorm_tpu_torch.parallel.attention.dense_attention`:
    q ``(b, sq, heads, d)``, k/v ``(b, sk, kv_heads, d)`` -> ``(b, sq, heads, d)``."""
    return _flash(q, k, v, causal, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """``(o, lse)``: the output and the logsumexp of each query row,
    ``(b, heads, sq, 1)`` float32 (the residual a backward pass needs)."""
    return _flash(q, k, v, causal, with_lse=True)


def make_flash_attention(causal: bool = True):
    """An ``attn_fn`` for :func:`petastorm_tpu_torch.models.llama.apply`
    (``supports_gqa``: K/V arrive at native kv-head width)."""
    def attn(q, k, v):
        return flash_attention(q, k, v, causal=causal)
    attn.supports_gqa = True
    return attn


def _launcher():
    from petastorm_tpu_torch.kernels.build import load
    fn = load("flash_attn").flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
