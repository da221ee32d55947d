"""Moving tensors between the ranks of a ``torch.distributed`` process group:
the transport of ring and Ulysses attention, of the gradient sums of
sequence and data parallelism, of the cross-rank batch norm's statistics,
of the sharded device cache's rows, of tensor parallelism's partial sums,
of FSDP's gathers and gradient scatters, and of the pipeline's hops.

The JAX package's collectives (``lax.ppermute``, ``lax.all_to_all``,
``lax.all_gather``, ``psum``) ride the TPU's interconnect inside one
program. Here each rank is a process. The group must be a gloo group: gloo
moves host memory, so a CUDA tensor is copied to a pinned host buffer,
sent, and copied back to the card on arrival. Nothing is computed on the
host: these functions move bytes and, for :func:`all_reduce_`, add them
(or take their maximum).
Another backend (NCCL, which refuses two ranks on one card) raises
``NotImplementedError``: the multi-GPU transport is ROADMAP Queue A item 10.

Every call adds its count, the bytes it sends and its host-clock seconds
(the staging copies included) to :data:`transfer_stats`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: op name -> {"calls": n, "bytes": sent, "seconds": host clock}.
transfer_stats: Dict[str, Dict[str, float]] = {}


def reset_transfer_stats() -> None:
    transfer_stats.clear()


def _record(op: str, nbytes: int, t0: float) -> None:
    entry = transfer_stats.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0})
    entry["calls"] += 1
    entry["bytes"] += nbytes
    entry["seconds"] += time.perf_counter() - t0


def check_backend(group) -> None:
    """Raise ``NotImplementedError`` unless ``group`` is a gloo group."""
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise NotImplementedError(
            f"the rank transport takes gloo groups (one card, ranks as processes); "
            f"got {backend!r}: NCCL and several cards are ROADMAP Queue A item 10 (multi-GPU)")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo can send it: a contiguous host tensor (pinned for a CUDA
    tensor: the copy waits for the stream, so the bytes are final)."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _host_buffer(like: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(like.shape if shape is None else tuple(shape), dtype=like.dtype,
                       pin_memory=like.device.type == "cuda")


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return host if like.device.type == "cpu" else host.to(like.device, non_blocking=True)


def rotate(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """Send each of ``tensors`` to the rank ``shift`` places on in ``group``
    and return what the rank ``shift`` places back sent: ``lax.ppermute``
    with the permutation ``i -> (i + shift) % P``. Every rank calls it with
    tensors of the same shapes and dtypes. ``shift=-1`` runs the ring the
    other way. A group of one rank returns the tensors themselves."""
    size = dist.get_world_size(group)
    if size == 1:
        return list(tensors)
    check_backend(group)
    t0 = time.perf_counter()
    rank = dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + shift) % size)
    src = dist.get_global_rank(group, (rank - shift) % size)
    sends = [_to_host(t) for t in tensors]
    recvs = [_host_buffer(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group=group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group=group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [_to_device(h, t) for h, t in zip(recvs, tensors)]
    _record("rotate", sum(t.numel() * t.element_size() for t in tensors), t0)
    return out


def all_to_all(chunks: Sequence[torch.Tensor], group,
               recv_shapes: Optional[Sequence[Sequence[int]]] = None,
               record_as: str = "all_to_all") -> List[torch.Tensor]:
    """``chunks[i]`` goes to rank i of ``group``; returns the P chunks the
    ranks sent here, in rank order, each of the shape and dtype of the chunk
    of the same index sent from here (``lax.all_to_all``'s exchange, with
    the split and the concatenation left to the caller), or of
    ``recv_shapes[i]`` when the ranks exchange chunks of other sizes (the
    sharded device cache's row gathers). The exchange is P - 1
    point-to-point pairs a rank (not every gloo build has an all-to-all);
    this rank's own chunk stays where it is. ``record_as`` names the call in
    :data:`transfer_stats`."""
    size = dist.get_world_size(group)
    if len(chunks) != size:
        raise ValueError(f"all_to_all needs one chunk per rank ({size}), got {len(chunks)}")
    if size == 1:
        return list(chunks)
    check_backend(group)
    t0 = time.perf_counter()
    rank = dist.get_rank(group)
    peers = [i for i in range(size) if i != rank]
    recvs = {i: _host_buffer(chunks[i], None if recv_shapes is None else recv_shapes[i])
             for i in peers}
    ops = [dist.P2POp(dist.isend, _to_host(chunks[i]), dist.get_global_rank(group, i),
                      group=group) for i in peers]
    ops += [dist.P2POp(dist.irecv, recvs[i], dist.get_global_rank(group, i), group=group)
            for i in peers]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [chunks[i] if i == rank else _to_device(recvs[i], chunks[i]) for i in range(size)]
    _record(record_as, sum(chunks[i].numel() * chunks[i].element_size() for i in peers), t0)
    return out


def all_gather(t: torch.Tensor, group, record_as: str = "all_gather") -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order (``lax.all_gather`` without the
    stacking): each rank calls it with a tensor of the same shape and dtype.
    The received tensors are on ``t``'s device; this rank's own is ``t``.
    ``record_as`` names the call in :data:`transfer_stats`."""
    size = dist.get_world_size(group)
    if size == 1:
        return [t]
    check_backend(group)
    t0 = time.perf_counter()
    rank = dist.get_rank(group)
    host = _to_host(t)
    recvs = [_host_buffer(t) for _ in range(size)]
    dist.all_gather(recvs, host, group=group)
    out = [t if i == rank else _to_device(recvs[i], t) for i in range(size)]
    _record(record_as, t.numel() * t.element_size(), t0)
    return out


def all_reduce_(tensors: Sequence[torch.Tensor], group, record_as: str = "all_reduce",
                op=dist.ReduceOp.SUM) -> None:
    """Sum each of ``tensors`` over ``group``, in place (``psum``; ``op=
    ReduceOp.MAX``: ``pmax``). ``record_as`` names the call in
    :data:`transfer_stats`."""
    if dist.get_world_size(group) == 1:
        return
    check_backend(group)
    t0 = time.perf_counter()
    for t in tensors:
        host = _to_host(t)
        dist.all_reduce(host, op=op, group=group)
        if host is not t:
            t.copy_(host, non_blocking=t.device.type == "cuda")
    _record(record_as, sum(t.numel() * t.element_size() for t in tensors), t0)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0,
                   record_as: str = "reduce_scatter") -> torch.Tensor:
    """This rank's block of the sum of every rank's ``t`` over ``group``:
    ``t`` split along ``dim`` into P equal blocks, block i summed over the
    ranks and kept by rank i (``lax.psum_scatter``). ``torch.distributed``
    has no gloo reduce-scatter, so each rank sends block i to rank i
    (:func:`all_to_all`'s pairs, (P - 1) / P of ``t`` a rank, half of what
    an all-reduce moves) and adds the P blocks it holds in rank order.
    ``record_as`` names the exchange in :data:`transfer_stats`."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} ({t.shape[dim]}) does not split into {size} blocks")
    blocks = all_to_all([c.contiguous() for c in t.chunk(size, dim)], group,
                        record_as=record_as)
    out = blocks[0].clone()
    for block in blocks[1:]:
        out += block
    return out


def shift(t: torch.Tensor, group, reverse: bool = False, send: bool = True,
          recv: bool = True, record_as: str = "shift") -> torch.Tensor:
    """One hop along the open chain of ``group``'s ranks: ``lax.ppermute``
    with ``[(i, i + 1) for i in range(P - 1)]`` (``reverse``: ``(i + 1,
    i)``). Sends ``t`` to the next rank and returns what the previous rank
    sent, on ``t``'s device; the chain's first rank (the last, with
    ``reverse``) receives zeros. ``send=False`` or ``recv=False`` leaves out
    this rank's half of the hop at a step where it has nothing to send or
    needs nothing (``t`` is then only the shape and dtype of what it would
    receive); its peer must leave out the matching half. The sends and
    receives are posted together (``batch_isend_irecv``), so no order of
    blocking calls can deadlock neighbours."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    step = -1 if reverse else 1
    dst, src = rank + step, rank - step
    send, recv = send and 0 <= dst < size, recv and 0 <= src < size
    if not (send or recv):
        return torch.zeros_like(t)
    check_backend(group)
    t0 = time.perf_counter()
    ops, buf = [], None
    if send:
        ops.append(dist.P2POp(dist.isend, _to_host(t), dist.get_global_rank(group, dst),
                              group=group))
    if recv:
        buf = _host_buffer(t)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src), group=group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _record(record_as, t.numel() * t.element_size() if send else 0, t0)
    return _to_device(buf, t) if recv else torch.zeros_like(t)


# --------------------------------------------------- tensor parallelism's pair
# Megatron's two conjugate operations (Shoeybi et al., arXiv:1909.08053): the
# activations of a model group are replicated, each rank holds a slice of a
# column-parallel and a row-parallel weight, and its product is one partial
# sum of the block's output. GSPMD inserts the same collectives from the
# shardings; here autograd sees them as functions.


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (each
    rank's slice contributes a part of the replicated input's gradient)."""

    @staticmethod
    def forward(ctx, x, group, record_as):
        ctx.group, ctx.record_as = group, record_as
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_([g], ctx.group, record_as=ctx.record_as)
        return g, None, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward (the replicated output's
    gradient is whole on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce_([out], group, record_as="tp_reduce")
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group, record_as: str = "tp_grad") -> torch.Tensor:
    """``x`` entering a model group's sliced weights: the same values, and a
    backward that sums the gradient over ``group`` (recorded as
    ``record_as``). ``group=None`` or a group of one rank: ``x`` itself."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group, record_as)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x`` (recorded as
    ``"tp_reduce"``), with an identity backward. ``group=None`` or a group of
    one rank: ``x`` itself."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


# ------------------------------------------------------------- FSDP's gather
# ZeRO-3 (Rajbhandari et al., arXiv:1910.02054): each rank of the data group
# holds one block of a weight; the weight is gathered whole where it is used
# and its gradient is reduce-scattered back into blocks, the collectives
# GSPMD inserts for ``param_shardings_fsdp``.


class _GatherForUse(torch.autograd.Function):
    """The ranks' blocks cast to ``dtype`` and concatenated along ``dim``;
    the backward casts the whole gradient to the block's dtype and
    reduce-scatters it (:func:`reduce_scatter`, recorded as
    ``"fsdp_grad"``)."""

    @staticmethod
    def forward(ctx, t, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, t.dtype
        return torch.cat(all_gather(t.to(dtype).contiguous(), group, record_as="fsdp_gather"),
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.to(ctx.dtype), ctx.group, ctx.dim, record_as="fsdp_grad"), \
            None, None, None


def gather_for_use(t: torch.Tensor, group, dim: int, dtype=None) -> torch.Tensor:
    """The whole weight of which each rank of ``group`` holds one block along
    ``dim`` (in rank order), cast to ``dtype`` before the gather (bf16
    compute: half the bytes of a float32 gather, the same values as a
    float32 gather cast afterwards), recorded as ``"fsdp_gather"``. The
    backward sums the gradient over the group in the block's dtype (float32
    for float32 master weights) and hands each rank its block. ``group=None``
    or a group of one rank: ``t`` cast to ``dtype``."""
    dtype = dtype or t.dtype
    if group is None or dist.get_world_size(group) == 1:
        return t.to(dtype)
    return _GatherForUse.apply(t, group, dim, dtype)


# ------------------------------------------------------- the pipeline's output


class _ReplicateFromLast(torch.autograd.Function):
    """The last rank's ``t`` on every rank (a broadcast); the backward hands
    the last rank its cotangent once and the others zeros."""

    @staticmethod
    def forward(ctx, t, group):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.last = rank == size - 1
        check_backend(group)
        t0 = time.perf_counter()
        host = _to_host(t) if ctx.last else _host_buffer(t)
        dist.broadcast(host, dist.get_global_rank(group, size - 1), group=group)
        _record("pipe_out", t.numel() * t.element_size() if ctx.last else 0, t0)
        return t.view_as(t) if ctx.last else _to_device(host, t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def replicate_from_last(t: torch.Tensor, group) -> torch.Tensor:
    """The pipeline's result, which only the last stage of ``group``
    computed, replicated on every stage: the JAX pipeline's ``psum`` of the
    masked emits (recorded as ``"pipe_out"``). Each stage then computes the
    same loss from it, so each holds the same cotangent; the backward gives
    it to the last stage once and not its sum over the stages, which would
    make every stage's parameter gradient P times too large. A group of one
    rank: ``t`` itself."""
    if dist.get_world_size(group) == 1:
        return t
    return _ReplicateFromLast.apply(t, group)
