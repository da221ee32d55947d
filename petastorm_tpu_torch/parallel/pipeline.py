"""Pipeline parallelism: a GPipe microbatched stage pipeline over the ranks
of a process group. The port of ``petastorm_tpu/parallel/pipeline.py``.

Each rank of the ``pipe`` group holds one stage (its slice of parameters
stacked on a leading stage axis). The batch is split into ``M``
microbatches that flow down the chain of ranks, one hop a step
(:func:`~petastorm_tpu_torch.parallel.comm.shift`, ``lax.ppermute`` with
``[(i, i + 1)]``), for ``M + S - 1`` steps: the GPipe bubble (Huang et al.,
arXiv:1811.06965). The last stage's outputs are then replicated on every
stage (:func:`~petastorm_tpu_torch.parallel.comm.replicate_from_last`).

JAX gets the reverse schedule by differentiating its ``scan`` of
``ppermute`` in one program. Autograd stops at the process, so the pipeline
owns its backward (:class:`PipelineFunction`): the forward keeps each
microbatch's stage input, and the backward runs the schedule in reverse,
receiving each microbatch's output gradient from the next stage, running
the stage again under autograd on the kept input (GPipe's
rematerialization) and sending the input gradient to the previous stage. A
stage skips the bubble steps at which it holds no microbatch: JAX computes
them on masked inputs whose contribution is zero.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from petastorm_tpu_torch.parallel import comm


def _active(t: int, stage: int, m: int) -> bool:
    """Whether ``stage`` holds a microbatch at step ``t`` of ``m``: stage i
    takes microbatch ``t - i``."""
    return 0 <= t - stage < m


class PipelineFunction(torch.autograd.Function):
    """``apply(stage_fn, spec, group, n_microbatches, x, *leaves) -> y``:
    the forward schedule on this rank's stage (``leaves``, flattened by
    ``spec``, each with a leading stage axis of 1); ``y`` is the composed
    stages' output on the last stage and zeros elsewhere. The backward
    returns this stage's parameter gradients and ``x``'s gradient, which is
    non-zero on stage 0 only."""

    @staticmethod
    def forward(ctx, stage_fn, spec, group, n_microbatches, x, *leaves):
        size, stage, m = dist.get_world_size(group), dist.get_rank(group), n_microbatches
        params = tree_unflatten([t[0] if t.dim() >= 1 else t for t in leaves], spec)
        mbs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        inputs, outs, recv = [None] * m, [None] * m, None
        for t in range(m + size - 1):
            out = mbs[0]   # the shape and dtype of a hop that sends nothing
            if _active(t, stage, m):
                inputs[t - stage] = mbs[t] if stage == 0 else recv
                out = stage_fn(params, inputs[t - stage])
                outs[t - stage] = out
            recv = comm.shift(out, group, send=_active(t, stage, m),
                              recv=_active(t, stage - 1, m), record_as="pipe_hop")
        ctx.stage_fn, ctx.spec, ctx.group, ctx.m, ctx.inputs = stage_fn, spec, group, m, inputs
        ctx.save_for_backward(*leaves)
        if stage != size - 1:
            return torch.zeros_like(x)
        return torch.cat(outs).reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        group, m, inputs = ctx.group, ctx.m, ctx.inputs
        size, stage = dist.get_world_size(group), dist.get_rank(group)
        leaves = ctx.saved_tensors
        wanted = ctx.needs_input_grad[5:]
        grads = [torch.zeros_like(t) if w else None for t, w in zip(leaves, wanted)]
        gmbs = gy.reshape((m, gy.shape[0] // m) + tuple(gy.shape[1:]))
        dx, recv = [None] * m, None
        for t in reversed(range(m + size - 1)):
            g_in = gmbs[0]   # the shape and dtype of a hop that sends nothing
            if _active(t, stage, m):
                mb = t - stage
                g_out = gmbs[mb] if stage == size - 1 else recv
                inp = inputs[mb].detach().requires_grad_(stage > 0 or ctx.needs_input_grad[4])
                local = [(t_[0] if t_.dim() >= 1 else t_).detach().requires_grad_(w)
                         for t_, w in zip(leaves, wanted)]
                with torch.enable_grad():
                    out = ctx.stage_fn(tree_unflatten(local, ctx.spec), inp)
                    targets = [inp] + [p for p, w in zip(local, wanted) if w]
                    got = list(torch.autograd.grad(out, [u for u in targets if u.requires_grad],
                                                   g_out, allow_unused=True))
                if inp.requires_grad:
                    g_in = got.pop(0)
                    g_in = torch.zeros_like(inp) if g_in is None else g_in
                    if stage == 0:
                        dx[mb] = g_in
                for acc, w in zip(grads, wanted):
                    if w:
                        g = got.pop(0)
                        if g is not None:
                            (acc[0] if acc.dim() >= 1 else acc).add_(g)
                inputs[mb] = None
            recv = comm.shift(g_in, group, reverse=True, send=_active(t, stage, m),
                              recv=_active(t, stage + 1, m), record_as="pipe_hop")
        if not ctx.needs_input_grad[4]:
            gx = None
        elif stage == 0:
            gx = torch.cat(dx).reshape(gy.shape)
        else:
            gx = torch.zeros_like(gy)
        return (None, None, None, None, gx, *grads)


def _check_one_stage(leaves, size: int, axis_name: str) -> None:
    leading = {t.shape[0] for t in leaves if t.dim() >= 1}
    if leading and leading != {1}:
        raise ValueError(
            f"Each rank must hold exactly one stage: local stage axis is {sorted(leading)}, so "
            f"the stacked stage count does not equal the '{axis_name}' mesh axis size ({size}). "
            f"Stack S == mesh-axis stages.")


def pipeline_apply(stage_fn: Callable, params, x: torch.Tensor, n_microbatches: int, group,
                   axis_name: str = "pipe") -> torch.Tensor:
    """Apply the S stages of ``group``'s ranks to ``x``, GPipe-pipelined.

    :param stage_fn: ``f(stage_params, microbatch) -> microbatch``, one
        stage (shapes and dtype preserved)
    :param params: this rank's stage: a tree whose tensor leaves have a
        leading stage axis of size 1 (0-dim leaves pass as they are)
    :param x: the rank's batch (rows divisible by ``n_microbatches``), the
        same on every stage
    :returns: ``stage_fn`` composed S times over ``x``, on every stage
    """
    size = dist.get_world_size(group)
    leaves, spec = tree_flatten(params)
    _check_one_stage(leaves, size, axis_name)
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_microbatches} microbatches")
    y = PipelineFunction.apply(stage_fn, spec, group, n_microbatches, x, *leaves)
    return comm.replicate_from_last(y, group)


def make_pipeline(mesh, stage_fn: Callable, n_microbatches: int, pipe_axis: str = "pipe",
                  data_axis: str = None):
    """-> ``f(stage_params, x) -> y``: :func:`pipeline_apply` over ``mesh``'s
    ``pipe_axis`` group. ``stage_params`` is this rank's stage (leading axis
    1: :func:`stack_stage_params` with the mesh), ``x`` this rank's rows of
    the batch (split over ``data_axis``: each data rank runs its own
    pipeline on its rows), the layout the JAX package's ``shard_map`` specs
    ``P(pipe_axis)`` and ``P(data_axis)`` describe. ``x`` is replicated over
    the stages, so its gradient (stage 0's alone) is summed over the
    ``pipe_axis`` group, as ``shard_map``'s transpose sums the cotangent of
    an input replicated over an axis (recorded as ``"pipe_dx"``): whatever
    made ``x`` (the embedding) gets its whole gradient on every stage."""
    mesh.check_axes(pipe_axis, data_axis)
    group = mesh.group(pipe_axis)

    def pipe(stage_params, x):
        x = comm.copy_to_group(x, group, record_as="pipe_dx")
        return pipeline_apply(stage_fn, stage_params, x, n_microbatches, group, pipe_axis)

    return pipe


def stack_stage_params(per_stage_params: list, mesh=None, pipe_axis: str = "pipe"):
    """[tree per stage] -> the tree with a leading ``(S, ...)`` stage axis.
    With ``mesh``: this rank's stage only, index ``rank(pipe_axis)``, as a
    leading axis of 1 (a copy, so the list can be freed); the list must
    hold one stage per rank of the axis."""
    if mesh is None:
        return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)
    size = int(mesh.shape[pipe_axis])
    if len(per_stage_params) != size:
        raise ValueError(
            f"Each rank must hold exactly one stage: {len(per_stage_params)} stages for the "
            f"'{pipe_axis}' mesh axis size ({size}). Stack S == mesh-axis stages.")
    rank = dist.get_rank(mesh.group(pipe_axis))
    return tree_map(lambda t: t[None].clone(), per_stage_params[rank])
