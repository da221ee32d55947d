"""Ring attention: exact attention over sequence-sharded q/k/v.

Each rank of a sequence process group holds a contiguous block of the
sequence. K/V blocks rotate around the ring (:func:`comm.rotate
<petastorm_tpu_torch.parallel.comm.rotate>`) while every rank streams them
into an online-softmax accumulator, so a rank never holds more than one
block's scores (Liu et al., Ring Attention with Blockwise Transformers,
arXiv:2310.01889). The port of ``petastorm_tpu/parallel/ring_attention.py``:
its ``shard_map`` body becomes the code each rank runs, and its mesh axis
name a process group.

Inside a rank q, k and v are ``(b, block, heads, d)`` and
``(b, block, kv_heads, d)``; K/V rotate at kv-head width (grouped-query
attention is native).

The backward is one ``torch.autograd.Function`` over the whole ring, not
autograd through each step's transfers: with the causal block skip a rank
leaves some received blocks unused, so autograd would prune their transfers'
backward on some ranks and not on others, and the ranks' point-to-point
calls would stop pairing up. The forward saves the local q, k, v, the output
and the global logsumexp of each row; the backward runs the ring again, the
other way, computing each block's share of dq, dk and dv with the global
logsumexp (on the card with ``local_attn="flash"``: the flash backward
kernels K3 and K4; with ``"dense"``: their plain version, ``local_block_q``
q rows at a time), and sends dk and dv (float32) along with their block, so
that after P hops they reach the block's owner.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.ops.flash_attn import (_flash_stats, flash_attention_bwd,
                                                flash_attention_bwd_plain, softmax_scale)
from petastorm_tpu_torch.parallel import comm


def _block_attention(q, k, v, bias):
    """One (q block, kv block) pair -> ``(o, m, l)``: the unnormalised
    float32 output ``(b, lq, h, d)``, the row max of the scores and the sum
    of ``exp(scores - max)``, ``(b, h, lq)`` each. ``bias`` broadcasts to
    ``(b, h, lq, lk)``.

    Scores in float32 from float32 operands, times
    :func:`~petastorm_tpu_torch.ops.flash_attn.softmax_scale`, p rounded to
    v's dtype before ``p v``, summed in float32: the flash kernel's numerics.
    (The JAX package's block takes the scores' product and ``p v`` in the
    input dtype; for float32 inputs the two agree.)"""
    b, lq, h, d = q.shape
    lk, kv_h = k.shape[1], k.shape[2]
    rep = h // kv_h
    qg = q.float().reshape(b, lq, kv_h, rep, d).permute(0, 2, 3, 1, 4)   # (b, g, r, lq, d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]                        # (b, g, 1, lk, d)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scores = torch.matmul(qg, kf.transpose(-1, -2)) * softmax_scale(d)
    scores = scores.reshape(b, h, lq, lk) + bias
    m = scores.amax(dim=-1)                                               # (b, h, lq)
    # A fully masked row has m = -inf; use 0 there so exp(-inf - 0) = 0.
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe[..., None])
    l = p.sum(dim=-1)
    pg = p.to(v.dtype).float().reshape(b, kv_h, rep, lq, lk)
    o = torch.matmul(pg, vf).permute(0, 3, 1, 2, 4).reshape(b, lq, h, d)
    return o, m, l


def _causal_bias(q_pos, k_pos):
    """``(1, 1, lq, lk)`` float32: 0 where ``q_pos >= k_pos``, else -inf."""
    seen = q_pos[:, None] >= k_pos[None, :]
    return torch.zeros(seen.shape, device=seen.device).masked_fill(~seen, float("-inf"))[None, None]


def _bias(q_pos, k_pos, causal: bool):
    if causal:
        return _causal_bias(q_pos, k_pos)
    return torch.zeros((1, 1, q_pos.numel(), k_pos.numel()), device=q_pos.device)


def _block_attention_chunked(q, k, v, k_pos, q_pos, causal: bool, block_q: int):
    """:func:`_block_attention` taken ``block_q`` q rows at a time, each chunk
    under checkpointing while grad is enabled, so that the scores of one
    chunk, ``O(block_q * lk)``, are all that exist at once in the forward or
    in autograd's backward (the ring's own backward chunks its plain
    gradients likewise); q rows are independent, so the chunks' ``(o, m, l)``
    concatenate exactly. The causal bias is built from positions inside each
    chunk. A last chunk may be shorter."""
    lq = q.shape[1]
    if lq <= block_q:
        return _block_attention(q, k, v, _bias(q_pos, k_pos, causal))

    def chunk(q_blk, qpos_blk):
        return _block_attention(q_blk, k, v, _bias(qpos_blk, k_pos, causal))

    parts = []
    for i in range(0, lq, block_q):
        args = (q[:, i:i + block_q], q_pos[i:i + block_q])
        parts.append(checkpoint(chunk, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else chunk(*args))
    o, m, l = zip(*parts)
    return torch.cat(o, dim=1), torch.cat(m, dim=2), torch.cat(l, dim=2)


def _merge(acc, blk):
    """Online-softmax merge of the running ``(o, m, l)`` and a block's,
    guarded where either max is -inf (a block that saw no key)."""
    o_acc, m_acc, l_acc = acc
    o_blk, m_blk, l_blk = blk
    m_new = torch.maximum(m_acc, m_blk)
    neg_inf = torch.full_like(m_new, float("-inf"))
    alpha = torch.exp(torch.where(torch.isneginf(m_acc), neg_inf, m_acc - m_new))
    beta = torch.exp(torch.where(torch.isneginf(m_blk), neg_inf, m_blk - m_new))
    o = alpha.transpose(1, 2)[..., None] * o_acc + beta.transpose(1, 2)[..., None] * o_blk
    return o, m_new, alpha * l_acc + beta * l_blk


def _check(q, k, local_block_q, local_attn):
    if local_attn not in ("dense", "flash"):
        raise ValueError(f"unknown local_attn {local_attn!r}")
    lq, h = q.shape[1], q.shape[2]
    if h % k.shape[2]:
        raise ValueError(f"heads ({h}) must be a multiple of kv_heads ({k.shape[2]})")
    if k.shape[1] != lq:
        raise ValueError(f"the ring takes equal sequence blocks: q has {lq} rows, k {k.shape[1]}")
    if local_block_q is not None and lq % local_block_q and lq > local_block_q:
        # Skipping the chunking would quietly lose the memory bound asked for.
        raise ValueError(f"local q length ({lq}) must be divisible by "
                         f"local_block_q ({local_block_q})")


class RingAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, group, causal, local_block_q, local_attn) -> out``:
    the whole ring, forward and backward (see the module's docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, local_block_q, local_attn):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        b, lq, h, d = q.shape
        q_pos = rank * lq + torch.arange(lq, device=q.device)

        def local(k_blk, v_blk, j):
            if local_attn == "flash":
                # The diagonal block takes the causal kernel with local offsets
                # (the same as global ones there); past blocks the plain one.
                return _flash_stats(q, k_blk, v_blk, causal and j == rank)
            k_pos = j * lq + torch.arange(lq, device=q.device)
            if local_block_q is None:
                return _block_attention(q, k_blk, v_blk, _bias(q_pos, k_pos, causal))
            return _block_attention_chunked(q, k_blk, v_blk, k_pos, q_pos, causal,
                                            local_block_q)

        acc = (torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device),
               torch.full((b, h, lq), float("-inf"), device=q.device),
               torch.zeros((b, h, lq), device=q.device))
        k_blk, v_blk = k, v
        for step in range(size):
            j = (rank - step) % size   # the block held now came from rank j
            # Block-level causal skip: a block wholly in the future of every
            # local row adds nothing (rank i computes i + 1 of the P blocks).
            if not (causal and j > rank):
                acc = _merge(acc, local(k_blk, v_blk, j))
            if step < size - 1:
                k_blk, v_blk = comm.rotate([k_blk, v_blk], group)
        o, m, l = acc
        l = l.clamp_min(1e-20)   # rows with no visible key
        out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, (m + torch.log(l))[..., None])
        ctx.group, ctx.causal, ctx.local_attn = group, causal, local_attn
        ctx.local_block_q = local_block_q
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if ctx.local_attn == "flash":
            block_bwd = flash_attention_bwd
        else:   # local_block_q q rows of scores at a time, as in the forward
            block_bwd = functools.partial(flash_attention_bwd_plain, block_q=ctx.local_block_q)
        do = do.to(out.dtype)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_blk, v_blk = k, v
        for step in range(size):
            j = (rank + step) % size   # the other way round: block j came from rank j
            if not (causal and j > rank):
                # With the global lse, p = exp(s - lse) is this block's share of
                # the whole row's softmax, so these are its exact gradients.
                g_q, g_k, g_v = block_bwd(q, k_blk, v_blk, out, lse, do, causal and j == rank)
                dq += g_q
                dk += g_k
                dv += g_v
            if step < size - 1:
                k_blk, v_blk, dk, dv = comm.rotate([k_blk, v_blk, dk, dv], group, shift=-1)
            else:   # the last hop brings each block's dk and dv home
                dk, dv = comm.rotate([dk, dv], group, shift=-1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q, k, v, group, causal: bool = False,
                   local_block_q: Optional[int] = None, local_attn: str = "dense"):
    """Exact (optionally causal) attention across the sequence-sharded ranks
    of ``group``: returns the attention of the local q block, in q's shape
    and dtype. Every rank of the group calls it with blocks of one shape.

    ``local_attn="dense"`` computes each ring step in PyTorch
    (:func:`_block_attention`); ``local_block_q`` chunks it over q rows,
    bounding a step's scores to ``local_block_q`` rows in the forward and
    in the backward.
    ``local_attn="flash"`` runs each step through the flash kernel's "stats"
    mode (K2; the diagonal block causal, past blocks plain, future blocks
    skipped before the launch) and the backward through K3 and K4; on a CUDA
    tensor that launches the kernels or raises. ``local_block_q`` is then
    only checked: the kernel tiles the block itself."""
    _check(q, k, local_block_q, local_attn)
    return RingAttentionFunction.apply(q, k, v, group, causal, local_block_q, local_attn)


def make_ring_attention(mesh, seq_axis: str = "seq", causal: bool = True,
                        local_block_q: Optional[int] = None, local_attn: str = "dense"):
    """An ``attn_fn`` for :func:`petastorm_tpu_torch.models.llama.apply` that
    runs :func:`ring_attention` over ``mesh``'s ``seq_axis`` group
    (``supports_gqa``: K/V rotate at kv-head width). Each rank passes its own
    sequence block; the JAX package's ``data_axis`` and ``head_axis`` have no
    counterpart yet (one data rank, no tensor parallelism)."""
    group = mesh.group(seq_axis)

    def attn(q, k, v):
        return ring_attention(q, k, v, group, causal=causal, local_block_q=local_block_q,
                              local_attn=local_attn)

    attn.supports_gqa = True
    return attn
