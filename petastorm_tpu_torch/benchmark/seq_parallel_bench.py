"""Sequence-parallel Llama training: token windows from a store into a train
step whose window is split over P ranks, with ring or Ulysses attention.

The JAX package drives this path in ``__graft_entry__.dryrun_multichip``
(strategies "ring", "ring-flash" and "ulysses" over a ``seq`` mesh axis).
Here :func:`run_seq_parallel_train` spawns P ranks
(:func:`~petastorm_tpu_torch.parallel.launch.run_ranks`: gloo, all on
``cuda:0`` on one card). Every rank reads the same windows in the same
order (``make_reader`` with the NGram window, the inline pool, row groups
shuffled by seed 0) through a ``DataLoader``, batch 1, draws the same
weights from a ``torch.Generator`` seeded 0, and trains with
ring attention, then with Ulysses, both with ``local_attn="flash"``, by
:func:`~petastorm_tpu_torch.models.llama.make_train_step` over its block of
each window (``seq_group``): the gradients are summed over the group before
AdamW, so the ranks stay equal.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Sequence

import numpy as np
import torch

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.loader.loader import resolve_device
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.parallel import comm
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.parallel.mesh import make_mesh
from petastorm_tpu_torch.parallel.ring_attention import make_ring_attention
from petastorm_tpu_torch.parallel.ulysses_attention import make_ulysses_attention
from petastorm_tpu_torch.reader import make_reader

STRATEGIES = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}
SEED = 0


def leaf(params: dict, name: str) -> torch.Tensor:
    """The parameter ``name``: a top-level key, or ``layers.<i>.<key>``."""
    if name.startswith("layers."):
        _, i, key = name.split(".")
        return params["layers"][int(i)][key]
    return params[name]


def token_windows(url: str, window: int):
    """A reader of ``url``'s dense NGram windows of ``window`` tokens, in an
    order every rank sees alike: one inline worker, row groups shuffled by
    :data:`SEED`, endless."""
    ngram = NGram({o: ["ts", "token"] for o in range(window)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    return make_reader(url, schema_fields=ngram, reader_pool_type="dummy",
                       shuffle_row_groups=True, seed=SEED, num_epochs=None)


def _rank_train(rank: int, world_size: int, url: str, steps: int, window: int,
                model_kwargs: dict, watch: Sequence[str], device: str) -> Dict[str, dict]:
    dev = resolve_device(device)
    cfg = llama.LlamaConfig(**model_kwargs)
    mesh = make_mesh((1, world_size), ("data", "seq"))
    results = {}
    for strategy, make_attention in STRATEGIES.items():
        attn = make_attention(mesh, causal=True, local_attn="flash")
        params = llama.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
        init_opt, step = llama.make_train_step(cfg, attn_fn=attn, shift="roll",
                                               seq_group=mesh.group("seq"))
        opt = init_opt(params)
        grads = {}

        def first_grads(*_):   # the first step's gradients, summed over the group
            if not grads:
                grads.update({n: leaf(params, n).grad.detach().cpu() for n in watch})
        hook = opt.register_step_pre_hook(first_grads)
        losses, step_ms = [], []
        with DataLoader(token_windows(url, window), batch_size=1, device=dev) as loader:
            it = iter(loader)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            comm.reset_transfer_stats()
            for _ in range(steps):
                batch = {"tokens": next(it)["token"]}
                t0 = time.perf_counter()
                params, opt, loss = step(params, opt, batch)
                losses.append(loss.item())   # waits for the step
                step_ms.append((time.perf_counter() - t0) * 1e3)
            it.close()
        hook.remove()
        ms = float(np.median(step_ms))
        results[strategy] = {
            "losses": losses, "step_ms": step_ms,
            "tokens_per_sec": window / ms * 1e3,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if dev.type == "cuda" else None),
            "launches": dict(kernels.launch_counts),
            "transfers": {op: dict(v) for op, v in comm.transfer_stats.items()},
            "grads": grads if rank == 0 else {}}
        del params, opt, init_opt, step, grads
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def run_seq_parallel_train(url: str, world_size: int = 2, steps: int = 3, window: int = 8192,
                           model_kwargs: dict | None = None, watch: Sequence[str] = (),
                           device: str = "cuda") -> Dict[str, list]:
    """Train ``steps`` AdamW steps of ``LlamaConfig(**model_kwargs)`` on
    ``url``'s windows (``write_token_store``) with ring attention, then
    ``steps`` with Ulysses, each from the same weights, the window split over
    ``world_size`` spawned ranks.
    Returns ``{"ring": [per-rank result], "ulysses": [...]}``; a rank's result holds the
    window's loss at each step (summed over the group), each step's host
    time (from the staged batch to the loss on the host), ``tokens_per_sec``
    (window tokens over the median step), its peak device memory, its
    kernel launch counts and :data:`~petastorm_tpu_torch.parallel.comm.transfer_stats`
    over the steps, and on rank 0 the first step's summed gradients of the
    ``watch`` leaves (``"embed"``, ``"layers.0.wq"``, ...), on the host."""
    per_rank = run_ranks(_rank_train, world_size,
                         args=(url, steps, window, dict(model_kwargs or {}), tuple(watch), device),
                         device=device)
    return {s: [r[s] for r in per_rank] for s in STRATEGIES}
