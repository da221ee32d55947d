"""Rank functions for the sequence-parallel tests of petastorm_tpu_torch.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package: a spawned child starts fresh and would otherwise import JAX for
nothing. Each function runs several cases in one spawn and returns plain
tensors for the test process to hold against the JAX package.
"""
import numpy as np
import torch

from petastorm_tpu_torch.benchmark.seq_parallel_bench import STRATEGIES
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel.mesh import make_mesh


def attention_cases(rank, world, arrays, cotangent, cases):
    """Each case ``(name, strategy, causal, local_attn, local_block_q,
    dtype, grad, heads)`` on this rank's block of ``arrays`` (q, k, v as
    float32 numpy, the whole sequence; with ``heads = (h, kv_h)`` only the
    first h and kv_h heads) -> ``{name: (out, dq, dk, dv)}`` (grads None
    unless ``grad``; the backward takes ``cotangent``'s block) or
    ``{name: "ValueError: ..."}``."""
    torch.set_num_threads(1)
    mesh = make_mesh((1, world), ("data", "seq"))
    block = arrays[0].shape[1] // world
    rows = slice(rank * block, (rank + 1) * block)
    results = {}
    for name, strategy, causal, local_attn, local_block_q, dtype, grad, heads in cases:
        kw = {"local_block_q": local_block_q} if local_block_q else {}
        attn = STRATEGIES[strategy](mesh, causal=causal, local_attn=local_attn, **kw)
        h = heads or (arrays[0].shape[2], arrays[1].shape[2])
        q, k, v = (torch.from_numpy(np.ascontiguousarray(a[:, rows, :n])).to(getattr(torch, dtype))
                   .requires_grad_(grad) for a, n in zip(arrays, (h[0], h[1], h[1])))
        try:
            out = attn(q, k, v)
        except ValueError as e:
            results[name] = f"ValueError: {e}"
            continue
        grads = (None, None, None)
        if grad:
            out.backward(torch.from_numpy(np.ascontiguousarray(cotangent[:, rows])).to(out.dtype))
            grads = (q.grad, k.grad, v.grad)
        results[name] = (out.detach(), *grads)
    return results


def train_step_cases(rank, world, jax_params, cfg_kwargs, tokens, strategies):
    """One float32 AdamW step of the Llama (``params_from_jax(jax_params)``)
    on this rank's block of ``tokens`` per strategy (local_attn "dense"
    and "flash") -> ``{name: (loss, grads, params after the step)}``,
    gradients and parameters as ``param_leaves`` lists."""
    torch.set_num_threads(1)
    cfg = llama.LlamaConfig(**cfg_kwargs)
    mesh = make_mesh((1, world), ("data", "seq"))
    results = {}
    for strategy, local_attn in strategies:
        params = llama.params_from_jax(jax_params, device="cpu")
        attn = STRATEGIES[strategy](mesh, causal=True, local_attn=local_attn)
        init_opt, step = llama.make_train_step(cfg, attn_fn=attn, shift="roll",
                                               compute_dtype=torch.float32,
                                               seq_group=mesh.group("seq"))
        opt = init_opt(params)
        grads = []
        opt.register_step_pre_hook(
            lambda *_: grads.extend(t.grad.clone() for t in llama.param_leaves(params)))
        _, _, loss = step(params, opt, {"tokens": torch.from_numpy(tokens)})
        results[f"{strategy}-{local_attn}"] = (
            loss.item(), grads, [t.detach().clone() for t in llama.param_leaves(params)])
    return results


def card_attention(rank, world, seq, strategy):
    """Ring or Ulysses (``local_attn="flash"``, causal, bf16) forward and
    backward on ``cuda:0`` over this rank's block of seeded inputs ->
    ``(out, dq, dk, dv, launch counts, out's device type)`` on the host."""
    from petastorm_tpu_torch import kernels
    q, k, v, do = card_inputs(seq)
    mesh = make_mesh((1, world), ("data", "seq"))
    block = seq // world
    rows = slice(rank * block, (rank + 1) * block)
    q, k, v = (t[:, rows].clone().requires_grad_() for t in (q, k, v))
    kernels.reset_launch_counts()
    out = STRATEGIES[strategy](mesh, causal=True, local_attn="flash")(q, k, v)
    out.backward(do[:, rows])
    torch.cuda.synchronize()
    return (out.detach().cpu(), q.grad.cpu(), k.grad.cpu(), v.grad.cpu(),
            dict(kernels.launch_counts), out.device.type)


def card_inputs(seq):
    """Seeded bf16 q, k, v and an output gradient on the card: 8 heads over
    2 kv heads, d 128."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    return tuple(torch.randn(1, seq, h, 128, generator=gen, device="cuda").bfloat16()
                 for h in (8, 2, 2, 8))
