"""Ulysses-style sequence parallelism: exact attention over sequence-sharded
q/k/v by trading the sequence sharding for a head sharding (DeepSpeed-Ulysses,
Jacobs et al., arXiv:2309.14509). The port of
``petastorm_tpu/parallel/ulysses_attention.py``.

Two all-to-all exchanges over the sequence process group bracket a plain
local attention:

1. **seq -> head**: each rank sends its sequence block of ``heads/P`` heads
   to each peer; afterwards it holds the whole sequence for its
   ``heads/P`` heads, and ordinary attention runs locally;
2. **head -> seq**: the inverse exchange restores the ``(b, seq/P, heads,
   d)`` layout.

Each exchange is a ``torch.autograd.Function`` whose backward is the inverse
exchange. Against :mod:`ring_attention` (P - 1 rotations, one block's scores
at a time, the causal skip): two exchanges, a whole sequence of scores per
local head unless ``local_attn="flash"`` (K2 "lse", then K3 and K4 in the
backward), and ``heads`` and ``kv_heads`` must divide by P.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from petastorm_tpu_torch.ops.flash_attn import flash_attention
from petastorm_tpu_torch.parallel import comm
from petastorm_tpu_torch.parallel.attention import dense_attention


def _seq_to_head(x, group):
    """``(b, l, h, d) -> (b, l * P, h / P, d)``: heads split across the
    ranks, their sequence blocks concatenated in rank order."""
    size = dist.get_world_size(group)
    hp = x.shape[2] // size
    return torch.cat(comm.all_to_all([x[:, :, i * hp:(i + 1) * hp] for i in range(size)],
                                     group), dim=1)


def _head_to_seq(x, group):
    """``(b, l * P, h / P, d) -> (b, l, h, d)``: the inverse exchange."""
    size = dist.get_world_size(group)
    lb = x.shape[1] // size
    return torch.cat(comm.all_to_all([x[:, i * lb:(i + 1) * lb] for i in range(size)],
                                     group), dim=2)


class SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g, ctx.group), None


class HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g, ctx.group), None


def ulysses_attention(q, k, v, group, causal: bool = False, local_attn: str = "dense"):
    """Exact (optionally causal) attention across the sequence-sharded ranks
    of ``group`` via two all-to-alls; q ``(b, block, heads, d)``, k/v
    ``(b, block, kv_heads, d)``, with ``heads`` and ``kv_heads`` divisible by
    the group's size. ``local_attn="flash"`` runs the local step through
    :func:`~petastorm_tpu_torch.ops.flash_attn.flash_attention` (on a CUDA
    tensor: the kernels K2, K3 and K4, or an error)."""
    if local_attn not in ("dense", "flash"):
        raise ValueError(f"unknown local_attn {local_attn!r}")
    p = dist.get_world_size(group)
    h, kv_h = q.shape[2], k.shape[2]
    if h % p or kv_h % p:
        raise ValueError(
            f"Ulysses sequence parallelism needs heads ({h}) and kv_heads ({kv_h}) divisible "
            f"by the sequence group's size ({p}); use ring attention")
    local = flash_attention if local_attn == "flash" else dense_attention
    out = local(SeqToHead.apply(q, group), SeqToHead.apply(k, group), SeqToHead.apply(v, group),
                causal=causal)
    return HeadToSeq.apply(out, group).to(q.dtype)


def make_ulysses_attention(mesh, seq_axis: str = "seq", causal: bool = True,
                           local_attn: str = "dense"):
    """An ``attn_fn`` running :func:`ulysses_attention` over ``mesh``'s
    ``seq_axis`` group; interchangeable with
    :func:`~petastorm_tpu_torch.parallel.ring_attention.make_ring_attention`
    (``supports_gqa``: K/V are exchanged at kv-head width)."""
    group = mesh.group(seq_axis)

    def attn(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal, local_attn=local_attn)

    attn.supports_gqa = True
    return attn
