"""Sequence-parallel Llama training on the port: a small Llama (vocab 64,
dim 32, 2 layers, 8 heads over 2 kv heads) whose window is split over P = 2
spawned ranks (gloo, on the CPU), with ring and Ulysses attention, against
the single-process port and the JAX package's loss, on the JAX weights
(``params_from_jax``), in float32.

Bars: the loss at rtol 1e-4 against both; each gradient leaf (summed over
the ranks) within 1e-4 of its largest single-process value; the parameters
after one AdamW step within 1e-4 (a step moves each by about lr = 3e-4).
The bench (``run_seq_parallel_train``) runs on the CPU in bfloat16 compute:
its loss within 5e-3 of the single-process step's (the JAX package's
flash-in-Llama bar) and its gradients within 4e-2 (``chip_smoke.py``'s
``GRAD_REL_BAR``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_seq_ranks
from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.benchmark.seq_parallel_bench import (leaf, run_seq_parallel_train,
                                                              token_windows)
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ops.flash_attn import make_flash_attention
from petastorm_tpu_torch.parallel.launch import run_ranks

CFG = dict(vocab=64, dim=32, n_layers=2, n_heads=8, n_kv_heads=2, hidden=64)
P = 2
STRATEGIES = (("ring", "flash"), ("ring", "dense"), ("ulysses", "flash"))


def _single_step(params, cfg, tokens, compute_dtype):
    """One AdamW step in one process: (loss, grads, params after)."""
    init_opt, step = llama.make_train_step(cfg, attn_fn=make_flash_attention(causal=True),
                                           shift="roll", compute_dtype=compute_dtype)
    opt = init_opt(params)
    grads = []
    opt.register_step_pre_hook(
        lambda *_: grads.extend(t.grad.clone() for t in llama.param_leaves(params)))
    _, _, loss = step(params, opt, {"tokens": tokens})
    return loss.item(), grads, [t.detach().clone() for t in llama.param_leaves(params)]


def test_train_step_matches_single_process_and_jax():
    jax_cfg = jax_llama.LlamaConfig(**CFG)
    cfg = llama.LlamaConfig(**CFG)
    jax_params = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), jax_cfg))
    tokens = np.random.default_rng(3).integers(0, CFG["vocab"], (2, 32)).astype(np.int32)
    per_rank = run_ranks(torch_seq_ranks.train_step_cases, P,
                         args=(jax_params, CFG, tokens, STRATEGIES), device="cpu", timeout_s=300)
    want_loss, want_grads, want_params = _single_step(
        llama.params_from_jax(jax_params, device="cpu"), cfg, torch.from_numpy(tokens),
        torch.float32)
    jax_loss = float(jax_llama.loss_fn(jax.tree.map(jnp.asarray, jax_params),
                                       {"tokens": jnp.asarray(tokens)}, jax_cfg, shift="roll",
                                       compute_dtype=jnp.float32))
    np.testing.assert_allclose(want_loss, jax_loss, rtol=1e-4)
    for strategy, local_attn in STRATEGIES:
        name = f"{strategy}-{local_attn}"
        for rank in per_rank:
            loss, grads, params = rank[name]
            np.testing.assert_allclose(loss, want_loss, rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(loss, jax_loss, rtol=1e-4, err_msg=name)
            for got, want in zip(grads, want_grads):
                assert (got - want).abs().max() <= 1e-4 * want.abs().max(), name
            for got, want in zip(params, want_params):
                torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_rope_offset_gives_the_global_positions():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 12, 4, 8)).astype(np.float32))
    whole = llama._rope(x, 500000.0)
    torch.testing.assert_close(llama._rope(x[:, 4:8], 500000.0, offset=4), whole[:, 4:8],
                               rtol=0, atol=0)


def test_sequence_parallel_loss_takes_the_roll_shift_only():
    with pytest.raises(ValueError, match="roll"):
        llama.loss_fn({}, {"tokens": torch.zeros(1, 8, dtype=torch.int64)}, llama.TINY,
                      shift="split", seq_group=object())


def test_bench_on_cpu_ranks_matches_a_single_process_step(tmp_path):
    """The bench's main path (store -> NGram reader -> DataLoader on every
    rank -> sequence-parallel train steps), on two CPU ranks."""
    url = f"file://{tmp_path}/tokens"
    window = 32
    write_token_store(url, windows=3, window=window, vocab=CFG["vocab"], seed=0)
    watch = ("embed", "layers.0.wq", "layers.0.wk", "layers.0.wo")
    got = run_seq_parallel_train(url, world_size=P, steps=2, window=window, model_kwargs=CFG,
                                 watch=watch, device="cpu")
    cfg = llama.LlamaConfig(**CFG)
    with DataLoader(token_windows(url, window), batch_size=1, device="cpu") as loader:
        tokens = next(iter(loader))["token"]
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want_loss, want_grads, _ = _single_step(params, cfg, tokens, torch.bfloat16)
    want = {n: g for n, g in zip(_leaf_names(params), want_grads)}
    for strategy, ranks in got.items():
        assert len(ranks) == P
        losses = [r["losses"] for r in ranks]
        assert losses[0] == losses[1] and len(losses[0]) == 2 and np.isfinite(losses[0]).all()
        np.testing.assert_allclose(losses[0][0], want_loss, rtol=5e-3, err_msg=strategy)
        for r in ranks:
            assert r["launches"] == {}   # the CPU launches no kernel
            ops = {"ring": "rotate", "ulysses": "all_to_all"}[strategy]
            assert r["transfers"][ops]["calls"] > 0 and r["transfers"]["all_reduce"]["calls"] > 0
        assert set(ranks[0]["grads"]) == set(watch) and not ranks[1]["grads"]
        for n, g in ranks[0]["grads"].items():
            assert ((g - want[n]).norm() / want[n].norm()).item() < 4e-2, (strategy, n)


def _leaf_names(params):
    """``param_leaves``' names, in its order."""
    names = []
    for key in sorted(params):
        if key == "layers":
            names += [f"layers.{i}.{k}" for i, layer in enumerate(params["layers"])
                      for k in sorted(layer)]
        else:
            names.append(key)
    assert all(leaf(params, n) is t for n, t in zip(names, llama.param_leaves(params)))
    return names
