"""Rank functions for the FSDP and pipeline tests of petastorm_tpu_torch.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package (as ``torch_tp_ranks``). Each function runs several cases in
one spawn and returns plain tensors for the test process to hold against the
JAX package.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel import comm, pipeline
from petastorm_tpu_torch.parallel.mesh import make_mesh


def _unsummed_scatter(t, group, dim=0, record_as="reduce_scatter"):
    """The control's reduce-scatter: this rank's block of its own gradient,
    not summed over the group."""
    return t.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


class _SummedCotangent(torch.autograd.Function):
    """The control's replicate op: the forward's, and a backward that sums
    the cotangent over the stages that each computed the same loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _REPLICATE(t, group).detach()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


_REPLICATE = comm.replicate_from_last


@contextlib.contextmanager
def _control(name):
    """The wrong versions the bars must reject: ``"gather unsummed"`` (the
    FSDP gather's backward keeps the rank's block of its own gradient) and
    ``"cotangent summed"`` (the pipeline's output op sums its cotangent over
    the stages: every stage's gradient S times too large)."""
    scatter, replicate = comm.reduce_scatter, comm.replicate_from_last
    if name == "gather unsummed":
        comm.reduce_scatter = _unsummed_scatter
    elif name == "cotangent summed":
        comm.replicate_from_last = _SummedCotangent.apply
    try:
        yield
    finally:
        comm.reduce_scatter, comm.replicate_from_last = scatter, replicate


def _coords(mesh):
    return {axis: dist.get_rank(mesh.group(axis)) for axis in mesh.shape}


def _grads_and_after(params, shardings, step, batch):
    """One step of ``step`` -> (loss, the gradients the step summed, the
    parameters after it), as this rank's trees."""
    grads = []
    opt = step[0](params)
    opt.register_step_pre_hook(lambda *_: grads.append(
        llama._map_leaves(lambda _, t: t.grad.clone(), shardings, params)))
    _, _, loss = step[1](params, opt, batch)
    return loss.item(), grads[0], llama._map_leaves(lambda _, t: t.detach().clone(), shardings,
                                                    params)


def fsdp_cases(rank, world, sizes, jax_params, cfg_kwargs, tokens, cases):
    """FSDP on the ``(data, seq, model)`` mesh ``sizes``: for each case
    ``(name, variant, control)`` one AdamW step (float32 compute) of
    ``params_from_jax(jax_params)``'s blocks (``param_shardings_fsdp``, with
    the model axis where it has more than one rank) on the rank's rows of
    ``tokens`` (``shift="roll"``), or, for ``variant == "bf16"``, the loss
    alone in bfloat16 compute. ``variant``: ``"plain"``, ``"xent_remat"``
    (``xent_chunk=16`` and ``remat_layers``) or ``"bf16"``. -> ``{"coords":
    {axis: index}, "transfers": the first case's {op: calls, bytes}, name:
    (loss, grads, params after)}``, the gradients and parameters as this
    rank's trees of blocks."""
    torch.set_num_threads(1)
    mesh = make_mesh(sizes, ("data", "seq", "model"))
    tp = sizes[2] > 1
    cfg = llama.LlamaConfig(**cfg_kwargs)
    shardings = llama.param_shardings_fsdp(mesh, cfg, model_axis="model" if tp else None)
    coords = _coords(mesh)
    rows = tokens.shape[0] // sizes[0]
    mine = {"tokens": torch.from_numpy(np.ascontiguousarray(
        tokens[coords["data"] * rows:(coords["data"] + 1) * rows]))}
    groups = dict(fsdp_group=mesh.group("data"), model_group=mesh.group("model") if tp else None)
    out = {"coords": coords}
    for name, variant, control in cases:
        params = llama.shard_params(llama.params_from_jax(jax_params, device="cpu"), shardings,
                                    mesh)
        comm.reset_transfer_stats()
        with _control(control):
            if variant == "bf16":
                with torch.no_grad():
                    loss = llama.loss_fn(params, mine, cfg, shift="roll", **groups)
                dist.all_reduce(loss, group=mesh.group("data"))
                out[name] = (loss.item(), None, None)
                continue
            kw = dict(xent_chunk=16, remat_layers=True) if variant == "xent_remat" else {}
            step = llama.make_train_step(cfg, shift="roll", compute_dtype=torch.float32, **kw,
                                         **groups)
            out[name] = _grads_and_after(params, shardings, step, mine)
        out.setdefault("transfers", {op: (v["calls"], v["bytes"])
                                     for op, v in comm.transfer_stats.items()})
    return out


def _stage_fn(p, x):
    return torch.relu(x @ p["w"] + p["b"])


def pipeline_cases(rank, world, meshes, stages, x, llama_case):
    """The toy pipeline of the JAX test on each ``(pipe, data)`` mesh of
    ``meshes`` (4 microbatches): this rank's output rows, and the gradient
    of ``sum(y ** 2)`` over the global batch (summed over the data ranks) of
    its stage's parameters and of its rows of ``x``; the same with the
    cotangent-summing control. Then the refusals, and ``llama_case`` if
    given (:func:`llama_pipeline`). -> ``{mesh: {"coords", "y", "grads",
    "dx", "control grads"}, "errors": [...], "llama": ...}``."""
    torch.set_num_threads(1)
    out = {}
    for sizes in meshes:
        mesh = make_mesh(sizes, ("pipe", "data"))
        coords = _coords(mesh)
        rows = x.shape[0] // sizes[1]
        mine = torch.from_numpy(x[coords["data"] * rows:(coords["data"] + 1) * rows])
        per_stage = [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages]
        pipe = pipeline.make_pipeline(mesh, _stage_fn, n_microbatches=4, data_axis="data")
        result = {"coords": coords}
        for control in (None, "cotangent summed"):
            stage = pipeline.stack_stage_params(per_stage, mesh)
            for t in stage.values():
                t.requires_grad_(True)
            xin = mine.clone().requires_grad_(True)
            with _control(control):
                y = pipe(stage, xin)
                (y ** 2).sum().backward()
            grads = {k: t.grad[0] for k, t in stage.items()}
            for g in grads.values():
                dist.all_reduce(g, group=mesh.group("data"))
            if control is None:
                result.update(y=y.detach(), grads=grads, dx=xin.grad)
            else:
                result["control grads"] = grads
        out[sizes] = result
    mesh = make_mesh(meshes[0], ("pipe", "data"))
    per_stage = [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages]
    errors = []
    for attempt in (
            lambda: pipeline.make_pipeline(mesh, _stage_fn, 3)(
                pipeline.stack_stage_params(per_stage, mesh), torch.from_numpy(x)),
            lambda: pipeline.make_pipeline(mesh, _stage_fn, 4)(
                pipeline.stack_stage_params(per_stage), torch.from_numpy(x)),
            lambda: pipeline.stack_stage_params(per_stage + per_stage[:1], mesh)):
        try:
            attempt()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    if llama_case is not None:
        out["llama"] = llama_pipeline(*llama_case)
    return out


def llama_pipeline(sizes, jax_params, cfg_kwargs, tokens):
    """The Llama of ``cfg_kwargs`` (one block a stage) pipelined over the
    ``(pipe, data)`` mesh ``sizes`` with 4 microbatches (``shift="split"``):
    one float32 AdamW step of ``params_from_jax(jax_params)`` on the rank's
    rows of ``tokens`` and the same with the cotangent-summing control, each
    -> (loss, the gradients summed over the data ranks); and the bfloat16
    loss. -> ``{"coords", "f32", "control", "bf16"}``."""
    mesh = make_mesh(sizes, ("pipe", "data"))
    cfg = llama.LlamaConfig(**cfg_kwargs)
    coords = _coords(mesh)
    rows = tokens.shape[0] // sizes[1]
    mine = {"tokens": torch.from_numpy(tokens[coords["data"] * rows:(coords["data"] + 1) * rows])}
    pipe = pipeline.make_pipeline(mesh, lambda layer, x: llama.apply_block(layer, x, cfg)[0],
                                  n_microbatches=4, data_axis="data")

    def layers_fn(stage, x):
        return pipe(stage, x), torch.zeros(())

    out = {"coords": coords}
    for name, dtype, control in (("f32", torch.float32, None),
                                 ("control", torch.float32, "cotangent summed"),
                                 ("bf16", torch.bfloat16, None)):
        params = llama.params_from_jax(jax_params, device="cpu")
        params["layers"] = pipeline.stack_stage_params(params["layers"], mesh)
        init_opt, step = llama.make_train_step(cfg, layers_fn=layers_fn, compute_dtype=dtype,
                                               data_group=mesh.group("data"))
        opt = init_opt(params)
        grads = []
        opt.register_step_pre_hook(lambda *_: grads.append(
            {k: (v.grad.clone() if torch.is_tensor(v) else {n: t.grad[0].clone()
                                                            for n, t in v.items()})
             for k, v in params.items()}))
        with _control(control):
            loss = step(params, opt, mine)[2].item()
        out[name] = (loss, grads[0] if dtype == torch.float32 else None)
    return out


def comm_round_trip(rank, world, device):
    """FSDP's gather (forward and backward), the chain hop both ways and the
    replicate-from-last op on ``device`` ranks, on inputs drawn on the host
    from each rank's seed -> the results and gradients as host tensors."""
    gen = torch.Generator().manual_seed(rank)
    block = torch.randn(3, 5, generator=gen).to(device).requires_grad_(True)
    group = dist.group.WORLD
    whole = comm.gather_for_use(block, group, dim=0, dtype=torch.bfloat16)
    (whole.float() * torch.arange(whole.numel(), device=device).reshape(whole.shape)).sum() \
        .backward()
    x = torch.randn(4, 6, generator=gen).to(device)
    y = torch.randn(4, 6, generator=gen).to(device).requires_grad_(True)
    out = comm.replicate_from_last(y * 2, group)
    (out * (rank + 1)).sum().backward()
    return {"gathered": whole.detach().float().cpu(), "block grad": block.grad.cpu(),
            "hop": comm.shift(x, group).cpu(), "hop back": comm.shift(x, group, reverse=True).cpu(),
            "replicated": out.detach().cpu(), "replicated grad": y.grad.cpu()}
