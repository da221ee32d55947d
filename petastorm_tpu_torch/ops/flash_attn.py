"""Flash attention: softmax attention without the O(seq^2) score matrix,
forward and backward.

q ``(b, sq, heads, d)``, k/v ``(b, sk, kv_heads, d)`` -> o ``(b, sq, heads,
d)`` in q's dtype, grouped-query native (``heads % kv_heads == 0``; K/V are
never repeated). With ``causal`` a query at position i sees keys 0..i (the
top-left mask of :func:`~petastorm_tpu_torch.parallel.attention.dense_attention`,
so sq != sk is allowed). :func:`flash_attention_lse` also returns the
logsumexp of each query row, ``(b, heads, sq, 1)`` float32.

A CUDA tensor goes through the hand-written kernels (it raises if a kernel
cannot build or launch, and never falls back): the forward
``csrc/flash_attn.cu`` (K2) and the backward ``csrc/flash_attn_bwd.cu``
(K3: dq, K4: dk and dv), whose route :func:`bwd_route` picks from the
dtype and head dim before the launch: tensor cores (wgmma, TMA) for 16-bit
inputs with ``d % 8 == 0`` and ``d <= 128``, f32 FMAs otherwise. A CPU
tensor goes through the plain PyTorch
versions :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`,
which compute the same functions: float32 scores ``(q . k) * scale`` with
``scale = 1/sqrt(d)`` rounded once to float32, float32 softmax, p rounded
to v's dtype before ``p . v``, float32 accumulation; the backward's
numerics are described at :func:`flash_attention_bwd_plain`.

:func:`flash_attention` is differentiable: when grad is enabled and an
input requires it, it runs :class:`FlashAttentionFunction`, whose forward
is the "lse" launch and whose backward launches K3 and K4, as the JAX
package's ``custom_vjp`` does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from petastorm_tpu_torch import kernels

KERNEL_NAME = "flash_attn_fwd"
#: Launch-count names of the backward kernels K3 (dq) and K4 (dk, dv): the
#: tensor-core route, then the FMA route. Each is also the name of its C
#: launcher in ``csrc/flash_attn_bwd.cu``.
BWD_DQ_KERNEL_NAME = "flash_attn_bwd_dq"
BWD_DKV_KERNEL_NAME = "flash_attn_bwd_dkv"
BWD_DQ_FMA_KERNEL_NAME = "flash_attn_bwd_dq_fma"
BWD_DKV_FMA_KERNEL_NAME = "flash_attn_bwd_dkv_fma"
#: The backward's two routes (see :func:`bwd_route`).
TENSOR_CORES, FMA = "tensor cores", "fma"
_BWD_KERNELS = {(TENSOR_CORES, "dq"): BWD_DQ_KERNEL_NAME,
                (TENSOR_CORES, "dkv"): BWD_DKV_KERNEL_NAME,
                (FMA, "dq"): BWD_DQ_FMA_KERNEL_NAME, (FMA, "dkv"): BWD_DKV_FMA_KERNEL_NAME}
#: Largest head dim the tensor-core backward takes.
TC_MAX_HEAD_DIM = 128
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


def _check_grid(b: int, h: int) -> None:
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_YZ} batches and heads, "
                         f"got {b} and {h}")


def _flash(q, k, v, causal: bool, with_lse: bool):
    _check(q, k, v)
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal)
        return o, (lse if with_lse else None)
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    _check_grid(b, h)
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
    q ``(b, sq, heads, d)``, k/v ``(b, sk, kv_heads, d)`` -> ``(b, sq, heads, d)``.
    Differentiable: with grad enabled and an input that requires it, the
    forward is the "lse" launch and the backward runs K3 and K4."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, flash_attention_lse,
                                            flash_attention_bwd)
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


def _check_bwd(q, o, lse, do) -> None:
    """Raise ``ValueError`` unless o and do are q-shaped in q's dtype and
    lse is ``(b, heads, sq, 1)`` float32, all on q's device."""
    b, sq, h, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({tuple(q.shape)} {q.dtype} on {q.device}); "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (b, h, sq, 1) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be ({b}, {h}, {sq}, 1) float32 on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def _rowsum_do_o(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO . o)`` in float32 from the rounded o, ``(b, sq, heads)``."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = False):
    """Plain PyTorch version of the backward kernels, on any device:
    ``(dq, dk, dv)`` in the inputs' dtypes and the model layout.

    Given the forward's output ``o`` and logsumexp ``lse`` (as
    :func:`flash_attention_lse` returns them) and the output gradient
    ``do``, with ``D = rowsum(dO . o)`` in float32, for each pair (query i,
    key j) that i sees: ``p = exp(s - lse_i)`` from the float32 scores (not
    rounded), ``dp = dO_i . v_j`` from input-dtype operands into float32,
    ``ds = p (dp - D_i) scale`` in float32; then ``dq = round(ds) k``,
    ``dk = round(ds)^T q`` summed over each kv head's group of query heads,
    ``dv = round(p)^T dO``, where round() is to the inputs' dtype and every
    sum is float32. Like :func:`flash_attention_plain` it loops over blocks
    of q rows, holding about 1 GiB of float32 scores per block, and with
    ``causal`` each block reads only the keys its last row can see."""
    _check(q, k, v)
    _check_bwd(q, o, lse, do)
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    rep = h // kv_h
    scale = softmax_scale(d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (b, kv_h, 1, sk, d)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    dd = _rowsum_do_o(do, o)                                 # (b, sq, h)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.zeros((b, kv_h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, _PLAIN_SCORE_BYTES // (4 * b * h * sk))
    for q0 in range(0, sq, rows):
        q1 = min(sq, q0 + rows)
        n = q1 - q0
        keys = min(sk, q1) if causal else sk

        def grouped(t):   # (b, n, h, d) rows of this block -> (b, kv_h, rep, n, d) float32
            return t[:, q0:q1].float().reshape(b, n, kv_h, rep, d).permute(0, 2, 3, 1, 4)
        qc, doc = grouped(q), grouped(do)
        p = torch.matmul(qc, kf[..., :keys, :].transpose(-1, -2)).mul_(scale)
        if causal:
            seen = (torch.arange(q0, q1, device=q.device)[:, None]
                    >= torch.arange(keys, device=q.device)[None, :])
            p.masked_fill_(~seen, float("-inf"))
        p.sub_(lse[:, :, q0:q1].reshape(b, kv_h, rep, n, 1)).exp_()
        ds = torch.matmul(doc, vf[..., :keys, :].transpose(-1, -2))
        ds.sub_(dd[:, q0:q1].permute(0, 2, 1).reshape(b, kv_h, rep, n, 1)).mul_(p).mul_(scale)
        dq[:, q0:q1] = torch.matmul(ds.to(k.dtype).float(), kf[..., :keys, :]).to(
            q.dtype).permute(0, 3, 1, 2, 4).reshape(b, n, h, d)
        dk[:, :, :keys] += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qc).sum(2)
        del ds
        dv[:, :, :keys] += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doc).sum(2)
        del p
    return dq, dk.to(k.dtype).permute(0, 2, 1, 3), dv.to(v.dtype).permute(0, 2, 1, 3)


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels' route for inputs of ``dtype`` and ``head_dim``:
    :data:`TENSOR_CORES` (wgmma products, TMA tiles) for bfloat16 and
    float16 with ``head_dim % 8 == 0`` and ``head_dim <= 128``; :data:`FMA`
    (IEEE float32 FMAs) otherwise: float32, whose bars tensor cores (TF32)
    would break, and 16-bit inputs with a head dim the tensor-core kernels do
    not take. Decided before any launch, never after a failed one."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim % 8 == 0 \
            and head_dim <= TC_MAX_HEAD_DIM:
        return TENSOR_CORES
    return FMA


def _tma_strides(t: torch.Tensor):
    """The (batch, seq, head) strides of a ``(b, s, h, d)`` tensor as a TMA
    map takes them: a dim of size 1 is never stepped, so it takes the stride
    a contiguous tensor would have (PyTorch may give it any)."""
    _, s, h, d = t.shape
    return [st if n > 1 else nat for st, n, nat in zip(t.stride()[:3], t.shape[:3],
                                                        (s * h * d, h * d, d))]


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` in place: a 16-byte-aligned base, a
    unit-stride head dim and (batch, seq, head) strides that are positive
    multiples of 16 bytes."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0 and (t.shape[3] == 1 or t.stride(3) == 1)
            and all(st > 0 and st * size % 16 == 0 for st in _tma_strides(t)))


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where TMA can read it, else a contiguous copy in a fresh
    (aligned) allocation."""
    return t if _tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def _bwd_inputs(route: str, q, k, v, o, lse, do):
    """``(q, k, v, do, stats)`` as the kernels of ``route`` read them.

    ``stats`` holds lse and ``D = rowsum(dO . o)`` as one ``(2, b, heads,
    n)`` float32 tensor: n = sq on the FMA route, sq rounded up to a multiple
    of 4 on the tensor-core route (TMA takes row strides in multiples of 16
    bytes; the padding is never read). On the tensor-core route an input
    whose strides or base TMA cannot take is first made contiguous
    (:func:`_tma_operand`); on the FMA route dO gets a unit-stride head dim."""
    if route == TENSOR_CORES:
        q, k, v, do = (_tma_operand(t) for t in (q, k, v, do))
    elif q.shape[3] > 1 and do.stride(3) != 1:
        do = do.contiguous()
    b, sq, h, _ = q.shape
    n = -(-sq // 4) * 4 if route == TENSOR_CORES else sq
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=q.device)
    stats[0, :, :, :sq] = lse[..., 0]
    stats[1, :, :, :sq] = _rowsum_do_o(do, o).transpose(1, 2)
    return q, k, v, do, stats


def _bwd_call(route, which, q, k, v, do, stats, outs, causal):
    """Launch K3 (``which="dq"``, ``outs = (dq,)``) or K4 (``"dkv"``,
    ``outs = (dk, dv)``) of ``route`` and count it under its name."""
    name = _BWD_KERNELS[route, which]
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    _check_grid(b, h)
    if route == TENSOR_CORES:
        strides = [s for t in (q, k, v, do) for s in _tma_strides(t)]
        stats_args = (stats.data_ptr(),)
        extra = (stats.shape[3],)
    else:
        strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
        stats_args = (stats[0].data_ptr(), stats[1].data_ptr())
        extra = ()
    for t in outs:
        strides += t.stride()[:3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_launcher(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats_args,
            *(t.data_ptr() for t in outs), b, sq, sk, h, kv_h, d,
            (ctypes.c_int64 * len(strides))(*strides), *extra, _DTYPES[q.dtype],
            int(causal), softmax_scale(d), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    kernels.count_launch(name)


def _flash_bwd_dq(route, q, k, v, do, stats, causal: bool) -> torch.Tensor:
    """K3 of ``route`` on CUDA tensors (inputs as :func:`_bwd_inputs` gives
    them): dq."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.shape[1]:
        _bwd_call(route, "dq", q, k, v, do, stats, (dq,), causal)
    return dq


def _flash_bwd_dkv(route, q, k, v, do, stats, causal: bool):
    """K4 of ``route`` on CUDA tensors (inputs as :func:`_bwd_inputs` gives
    them): (dk, dv)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if not q.shape[1]:   # no query sees a key
        return dk.zero_(), dv.zero_()
    _bwd_call(route, "dkv", q, k, v, do, stats, (dk, dv), causal)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = False):
    """``(dq, dk, dv)`` of flash attention from the forward's ``o`` and
    ``lse`` and the output gradient ``do``: K3 and K4 on CUDA tensors, by
    the route :func:`bwd_route` gives (on the tensor-core route an input
    whose strides or base TMA cannot take is made contiguous first), the
    plain version :func:`flash_attention_bwd_plain` on CPU tensors."""
    _check(q, k, v)
    _check_bwd(q, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    route = bwd_route(q.dtype, q.shape[3])
    q, k, v, do, stats = _bwd_inputs(route, q, k, v, o, lse, do)
    return (_flash_bwd_dq(route, q, k, v, do, stats, causal),
            *_flash_bwd_dkv(route, q, k, v, do, stats, causal))


class FlashAttentionFunction(torch.autograd.Function):
    """The autograd seam of flash attention, as the JAX package's
    ``_flash_vjp``: ``apply(q, k, v, causal, forward, backward) -> o``.

    ``forward(q, k, v, causal) -> (o, lse)`` runs once and ``(q, k, v, o,
    lse)`` are saved; ``backward(q, k, v, o, lse, do, causal) -> (dq, dk,
    dv)`` gives the gradients. :func:`flash_attention` passes
    :func:`flash_attention_lse` and :func:`flash_attention_bwd` (the
    kernels on the card, the plain versions on the CPU); passing
    :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`
    gives the plain function on any device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, forward, backward):
        o, lse = forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.backward_fn = causal, backward
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.backward_fn(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None, None


def _launcher():
    from petastorm_tpu_torch.kernels.build import load
    fn = load("flash_attn").flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_launcher(name: str):
    """One of the four C launchers of :data:`_BWD_KERNELS`: q, k, v, dO, the
    stats (one pointer on the tensor-core route, lse and D on the FMA
    route) and the outputs, then the sizes, the strides, on the tensor-core
    route the stats' row stride, dtype, causal, scale and the stream."""
    from petastorm_tpu_torch.kernels.build import load
    fn = getattr(load("flash_attn_bwd"), name)
    if fn.argtypes is None:
        tc = name in (BWD_DQ_KERNEL_NAME, BWD_DKV_KERNEL_NAME)
        stats = 1 if tc else 2
        outs = 1 if name in (BWD_DQ_KERNEL_NAME, BWD_DQ_FMA_KERNEL_NAME) else 2
        fn.argtypes = ([ctypes.c_void_p] * (4 + stats + outs) + [ctypes.c_int64] * 6
                       + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * (3 if tc else 2)
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
