"""Switch (GShard) sparse mixture of experts: top-k routing with a capacity
per expert. The port of ``petastorm_tpu/parallel/moe.py``.

The JAX package encodes routing as dense ``(tokens, experts, capacity)``
dispatch and combine masks and lets GSPMD turn their einsums into
all-to-alls. :func:`switch_route` computes the same masks (the reference the
tests hold the JAX package to). :func:`switch_moe_block` computes the same
values from the same routing by index: each expert gathers the tokens it
kept, runs its SwiGLU on them and adds its output, times the router weight,
back into their rows; no mask of ``n * E * C`` elements is built.

On ranks the routing stays global, as GSPMD's is over the global batch. A
token's slot is its place in the flattened global order (batch row, then
position) among the tokens that chose the same expert, after the slots
taken in earlier rounds; the capacity comes from the global token count,
and the auxiliary loss' means are over every token. Each rank counts, per
round, row and expert, the tokens of its own block that chose each expert,
and one all-gather of those counts over the data and sequence groups gives
every rank the offsets of its block. The experts of a model group (expert
parallelism on the tensor-parallel axis) each run on the rank that holds
them, over that rank's tokens: the rank's tokens are the group's, since
activations are replicated over it, and the partial outputs are summed over
the group (:func:`~petastorm_tpu_torch.parallel.comm.reduce_from_group`).

Load balancing: :func:`switch_aux_loss` is the Switch Transformer's
``E * sum_e f_e * p_e`` (the fraction of tokens whose first choice is e,
times the mean router probability of e).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from petastorm_tpu_torch.parallel import comm

#: The list :func:`record_routing` collects into, or ``None``.
_record: Optional[List[dict]] = None


@contextlib.contextmanager
def record_routing():
    """Collect the routing of the :func:`switch_moe_block` calls made inside
    the ``with`` block -> the list they fill, one entry a call (a block
    recomputed under checkpointing adds another): ``capacity``, ``tokens``
    (global), ``top_k``, ``kept``, the global slots filled per expert, and
    ``aux``, this rank's share of the auxiliary loss (device tensors, so that
    recording waits for nothing). Outside such a block nothing is kept."""
    global _record
    saved, _record = _record, []
    try:
        yield _record
    finally:
        _record = saved


def switch_aux_loss(router_probs: torch.Tensor, top_k: int = 1) -> torch.Tensor:
    """``E * sum_e f_e * p_e`` (Switch Transformer eq. 4) over ``(n, E)``
    probabilities; ``top_k`` is accepted and ignored, as in the JAX package."""
    num_experts = router_probs.shape[-1]
    choice = router_probs.argmax(dim=-1)
    f = F.one_hot(choice, num_experts).to(router_probs.dtype).mean(dim=0)
    p = router_probs.mean(dim=0)
    del top_k
    return num_experts * (f * p).sum()


def _rank_size(group) -> Tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _choices(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """``(top_k, n)`` expert choices: each round the argmax of the
    probabilities the earlier rounds left."""
    remaining, choices = probs, []
    for _ in range(top_k):
        choice = remaining.argmax(dim=-1)
        choices.append(choice)
        remaining = remaining * (1.0 - F.one_hot(choice, probs.shape[-1]).to(probs.dtype))
    return torch.stack(choices)


def _slots(choices: torch.Tensor, rows: int, num_experts: int, capacity: int,
           data_group=None, seq_group=None):
    """Slot positions of a rank's ``(top_k, rows * cols)`` choices, in the
    global order -> ``(pos, kept, first)``: ``pos`` ``(top_k, n)``, the global
    slots filled per expert and the global count of first choices per
    expert, ``(E,)`` each.

    The rank holds ``rows`` batch rows (its block of ``data_group``'s) and a
    block of positions of each (its block of ``seq_group``'s). The counts of
    each (round, row, expert) are gathered over the sequence group, then the
    data group; the exclusive cumulative sum over the global blocks, taken in
    the global order, is each block's offset."""
    top_k, n = choices.shape
    onehot = F.one_hot(choices, num_experts).reshape(top_k, rows, n // rows, num_experts)
    counts = onehot.sum(dim=2)                                       # (k, rows, E)
    seq_rank, seq_size = _rank_size(seq_group)
    data_rank, data_size = _rank_size(data_group)
    blocks = torch.stack(comm.all_gather(counts, seq_group, record_as="moe_counts")
                         if seq_size > 1 else [counts])              # (S, k, rows, E)
    blocks = torch.stack(comm.all_gather(blocks, data_group, record_as="moe_counts")
                         if data_size > 1 else [blocks])             # (D, S, k, rows, E)
    blocks = blocks.permute(2, 0, 3, 1, 4).reshape(top_k, -1, num_experts)   # global order
    offsets = blocks.cumsum(dim=1) - blocks
    totals = blocks.sum(dim=1)                                       # (k, E)
    mine = (data_rank * rows + torch.arange(rows, device=choices.device)) * seq_size + seq_rank
    used = torch.zeros(num_experts, dtype=totals.dtype, device=choices.device)
    positions = []
    for r in range(top_k):
        within = (onehot[r].cumsum(dim=1) - onehot[r]).reshape(n, num_experts)
        before = (offsets[r, mine][:, None, :] + used).expand(rows, n // rows, num_experts)
        taken = within + before.reshape(n, num_experts)
        positions.append(taken.gather(1, choices[r][:, None])[:, 0])
        used = torch.clamp(used + totals[r], max=capacity)
    return torch.stack(positions), used, totals[0]


def switch_route(router_logits: torch.Tensor, top_k: int, capacity: int):
    """Top-k routing with a capacity per expert, as dense masks.

    :param router_logits: ``(n, E)`` float32
    :returns: ``(dispatch, combine, aux)``: dispatch ``(n, E, C)`` in {0, 1}
        (token t occupies slot c of expert e), combine ``(n, E, C)`` with the
        router probability in the occupied slots, and the load-balancing loss
    """
    n, num_experts = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    aux = switch_aux_loss(probs, top_k)
    choices = _choices(probs, top_k)
    pos, _, _ = _slots(choices, 1, num_experts, capacity)
    dispatch = torch.zeros((n, num_experts, capacity), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    tokens = torch.arange(n, device=probs.device)
    for r in range(top_k):
        keep = pos[r] < capacity
        at = (tokens[keep], choices[r][keep], pos[r][keep])
        dispatch = dispatch.index_put(at, torch.ones_like(at[0], dtype=probs.dtype),
                                      accumulate=True)
        gate = probs.gather(1, choices[r][:, None])[:, 0]
        combine = combine.index_put(at, gate[keep], accumulate=True)
    return dispatch, combine, aux


def combine_weights(probs: torch.Tensor, expert_group) -> torch.Tensor:
    """The router probabilities as the weights that combine a model group's
    experts: the same values, and a backward that sums their gradient over
    ``expert_group``. Each rank combines only its own experts' outputs, so
    its gradient of the probabilities (and so of the router weight) covers
    only those; the sum makes it whole on every rank."""
    return comm.copy_to_group(probs, expert_group)


def _swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor):
    return (F.silu(x @ w1.to(x.dtype)) * (x @ w3.to(x.dtype))) @ w2.to(x.dtype)


def switch_moe_block(h: torch.Tensor, router_w: torch.Tensor, ew1: torch.Tensor,
                     ew3: torch.Tensor, ew2: torch.Tensor, *, top_k: int = 1,
                     capacity_factor: float = 1.25, data_group=None, seq_group=None,
                     expert_group=None):
    """Sparse SwiGLU mixture of experts over ``(b, s, d)`` activations ->
    ``(out, aux)``. Tokens over capacity add zero here, so the caller's
    residual passes them through.

    :param data_group: the group whose ranks hold other rows of the batch
    :param seq_group: the group whose ranks hold other blocks of positions
        (the routing and the capacity are over all of their tokens; ``aux`` is
        this rank's share of the global loss: the shares sum to it)
    :param expert_group: the model group over which the experts are split:
        ``ew1``/``ew3``/``ew2`` hold this rank's ``E / P`` of the
        ``router_w.shape[-1]`` experts, in rank order, and ``out`` is summed
        over the group
    """
    b, s, d = h.shape
    num_experts = router_w.shape[-1]
    n_local = b * s
    n = n_local * _rank_size(data_group)[1] * _rank_size(seq_group)[1]
    capacity = max(1, int(capacity_factor * top_k * n / num_experts))
    x = h.reshape(n_local, d)
    probs = torch.softmax(x.float() @ router_w, dim=-1)             # (n_local, E)
    with torch.no_grad():
        choices = _choices(probs, top_k)
        pos, kept, first = _slots(choices, b, num_experts, capacity, data_group, seq_group)
    # E * sum_e f_e p_e, split over the ranks: f is global, the mean of p a
    # sum over every rank's tokens divided by the global count.
    aux = num_experts * ((first.to(probs.dtype) / n) * probs.sum(dim=0)).sum() / n
    if _record is not None:
        _record.append({"capacity": capacity, "tokens": n, "top_k": top_k, "kept": kept,
                        "aux": aux.detach()})
    gates = combine_weights(probs, expert_group)
    xc = comm.copy_to_group(x, expert_group)
    rank, _ = _rank_size(expert_group)
    local = ew1.shape[0]
    out = torch.zeros_like(x)
    for e in range(local):
        expert = rank * local + e
        hit = (choices == expert) & (pos < capacity)                 # (k, n_local)
        idx = hit.nonzero()[:, 1]
        gate = gates[idx, expert].to(h.dtype)
        out = out.index_add(0, idx, _swiglu(xc[idx], ew1[e], ew3[e], ew2[e]) * gate[:, None])
    return comm.reduce_from_group(out, expert_group).reshape(b, s, d), aux
