"""Rank functions for the tensor- and expert-parallel tests of
petastorm_tpu_torch.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package (as ``torch_seq_ranks``). Each function runs several cases in
one spawn and returns plain tensors for the test process to hold against the
JAX package.
"""
import contextlib

import numpy as np
import torch

from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel import moe
from petastorm_tpu_torch.parallel.mesh import make_mesh
from petastorm_tpu_torch.parallel.ring_attention import make_ring_attention
from petastorm_tpu_torch.parallel.ulysses_attention import make_ulysses_attention

MAKERS = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}


@contextlib.contextmanager
def _control(name):
    """The wrong versions the bars must reject: ``"per-rank routing"`` routes
    each rank's block alone (slots and capacity from its own tokens), and
    ``"router unsummed"`` leaves the router's gradient partial over the
    model group."""
    block, combine = moe.switch_moe_block, moe.combine_weights
    if name == "per-rank routing":
        moe.switch_moe_block = lambda *a, **kw: block(*a, **dict(kw, data_group=None,
                                                                 seq_group=None))
    elif name == "router unsummed":
        moe.combine_weights = lambda probs, group: probs
    try:
        yield
    finally:
        moe.switch_moe_block, moe.combine_weights = block, combine


def _coords(mesh):
    return {axis: torch.distributed.get_rank(mesh.group(axis)) for axis in mesh.shape}


def tp_cases(rank, world, meshes, jax_params, cfg_kwargs, tokens, cases):
    """For each mesh of ``meshes`` (``(data, seq, model)`` sizes whose
    product is ``world``), each case ``(name, mesh index, dispatch,
    strategy, variant, control)`` on this rank: one AdamW step (float32
    compute) of ``params_from_jax(jax_params)``'s slice over the rank's
    rows and block of ``tokens`` (``shift="roll"``), or, for ``variant ==
    "bf16"``, the loss alone in bfloat16 compute.

    ``strategy``: ``"dense"`` (the default attention over the rank's heads),
    ``"ring"`` or ``"ulysses"`` over the sequence axis, with
    ``head_axis="model"``. ``variant``: ``"plain"``, ``"xent_remat"``
    (``xent_chunk=16`` and ``remat_layers``) or ``"bf16"``. -> ``{"coords":
    [per mesh {axis: index}], name: (loss, grads, params after)}``, the
    gradients (summed over the data and sequence groups) and the parameters
    as this rank's trees of slices, or ``(loss, None, None)``."""
    torch.set_num_threads(1)
    made = [make_mesh(sizes, ("data", "seq", "model")) for sizes in meshes]
    out = {"coords": [_coords(m) for m in made]}
    for name, mi, dispatch, strategy, variant, control in cases:
        mesh = made[mi]
        cfg = llama.LlamaConfig(**dict(cfg_kwargs, moe_dispatch=dispatch))
        shardings = llama.param_shardings(mesh, cfg)
        params = llama.shard_params(llama.params_from_jax(jax_params, device="cpu"), shardings,
                                    mesh)
        attn = None if strategy == "dense" else MAKERS[strategy](
            mesh, causal=True, head_axis="model", local_attn="dense")
        seq, data = mesh.group("seq"), mesh.group("data")
        coords, sizes = _coords(mesh), mesh.shape
        rows = tokens.shape[0] // sizes["data"]
        mine = torch.from_numpy(np.ascontiguousarray(
            tokens[coords["data"] * rows:(coords["data"] + 1) * rows]))
        groups = dict(seq_group=seq, data_group=data, model_group=mesh.group("model"))
        kw = dict(xent_chunk=16, remat_layers=True) if variant == "xent_remat" else {}
        with _control(control):
            if variant == "bf16":
                with torch.no_grad():
                    loss = llama.loss_fn(params, {"tokens": mine}, cfg, attn_fn=attn,
                                         shift="roll", **groups)
                for group in (seq, data):
                    torch.distributed.all_reduce(loss, group=group)
                out[name] = (loss.item(), None, None)
                continue
            init_opt, step = llama.make_train_step(cfg, attn_fn=attn, shift="roll",
                                                   compute_dtype=torch.float32, **kw, **groups)
            opt = init_opt(params)
            grads = []
            opt.register_step_pre_hook(lambda *_: grads.append(
                llama._map_leaves(lambda _, t: t.grad.clone(), shardings, params)))
            _, _, loss = step(params, opt, {"tokens": mine})
        out[name] = (loss.item(), grads[0],
                     llama._map_leaves(lambda _, t: t.detach().clone(), shardings, params))
    return out


def card_tp_step(rank, world, cfg_kwargs, tokens):
    """One float32 AdamW step of ``LlamaConfig(**cfg_kwargs)`` (weights drawn
    on the host from seed 0) on ``cuda:0`` with ``model_group=`` over all
    the ranks and flash attention over the rank's heads -> (the loss, the
    rank's gradients and its parameters after the step on the host, the
    launch counts)."""
    from petastorm_tpu_torch import kernels
    from petastorm_tpu_torch.ops.flash_attn import make_flash_attention
    cfg = llama.LlamaConfig(**cfg_kwargs)
    mesh = make_mesh((1, 1, world), ("data", "seq", "model"))
    shardings = llama.param_shardings(mesh, cfg)
    host = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = llama._map_leaves(lambda _, t: t.cuda(),
                               shardings, llama.shard_params(host, shardings, mesh))
    init_opt, step = llama.make_train_step(cfg, attn_fn=make_flash_attention(causal=True),
                                           shift="roll", compute_dtype=torch.float32,
                                           model_group=mesh.group("model"))
    opt = init_opt(params)
    grads = []
    opt.register_step_pre_hook(lambda *_: grads.append(
        llama._map_leaves(lambda _, t: t.grad.cpu(), shardings, params)))
    kernels.reset_launch_counts()
    _, _, loss = step(params, opt, {"tokens": torch.from_numpy(tokens).cuda()})
    return (loss.item(), grads[0],
            llama._map_leaves(lambda _, t: t.detach().cpu(), shardings, params),
            dict(kernels.launch_counts))
