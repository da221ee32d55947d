"""Moving tensors between the ranks of a ``torch.distributed`` process group:
the transport of ring and Ulysses attention and of the gradient sum.

The JAX package's collectives (``lax.ppermute``, ``lax.all_to_all``,
``psum``) ride the TPU's interconnect inside one program. Here each rank is
a process. The group must be a gloo group: gloo moves host memory, so a
CUDA tensor is copied to a pinned host buffer, sent, and copied back to the
card on arrival. Nothing is computed on the host: these functions move
bytes and, for :func:`all_reduce_`, add them. Another backend (NCCL, which
refuses two ranks on one card) raises ``NotImplementedError``: the
multi-GPU transport is ROADMAP Queue A item 6.

Every call adds its count, the bytes it sends and its host-clock seconds
(the staging copies included) to :data:`transfer_stats`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

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
            f"the sequence-parallel transport takes gloo groups (one card, ranks as processes); "
            f"got {backend!r}: NCCL and several cards are ROADMAP Queue A item 6 (multi-GPU)")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo can send it: a contiguous host tensor (pinned for a CUDA
    tensor: the copy waits for the stream, so the bytes are final)."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=like.device.type == "cuda")


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


def all_to_all(chunks: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """``chunks[i]`` goes to rank i of ``group``; returns the P chunks the
    ranks sent here, in rank order, each of the shape and dtype of the chunk
    of the same index sent from here (``lax.all_to_all``'s exchange, with
    the split and the concatenation left to the caller). The exchange is
    P - 1 point-to-point pairs a rank (not every gloo build has an
    all-to-all); this rank's own chunk stays where it is."""
    size = dist.get_world_size(group)
    if len(chunks) != size:
        raise ValueError(f"all_to_all needs one chunk per rank ({size}), got {len(chunks)}")
    if size == 1:
        return list(chunks)
    check_backend(group)
    t0 = time.perf_counter()
    rank = dist.get_rank(group)
    peers = [i for i in range(size) if i != rank]
    recvs = {i: _host_buffer(chunks[i]) for i in peers}
    ops = [dist.P2POp(dist.isend, _to_host(chunks[i]), dist.get_global_rank(group, i),
                      group=group) for i in peers]
    ops += [dist.P2POp(dist.irecv, recvs[i], dist.get_global_rank(group, i), group=group)
            for i in peers]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [chunks[i] if i == rank else _to_device(recvs[i], chunks[i]) for i in range(size)]
    _record("all_to_all", sum(chunks[i].numel() * chunks[i].element_size() for i in peers), t0)
    return out


def all_reduce_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each of ``tensors`` over ``group``, in place (``psum``)."""
    if dist.get_world_size(group) == 1:
        return
    check_backend(group)
    t0 = time.perf_counter()
    for t in tensors:
        host = _to_host(t)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        if host is not t:
            t.copy_(host, non_blocking=t.device.type == "cuda")
    _record("all_reduce", sum(t.numel() * t.element_size() for t in tensors), t0)
