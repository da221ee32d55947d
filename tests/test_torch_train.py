"""Training on the port against the JAX package at ``TINY`` (dense MLP and
soft MoE), with the JAX parameters carried across by ``params_from_jax``:
``loss_fn`` and its gradients against ``jax.value_and_grad``, checkpointing
(``remat_layers``, ``xent_chunk``), and ``make_train_step`` (AdamW) against
the JAX ``make_train_step`` (optax).

Bars: gradients per leaf, max |difference| over max |JAX gradient|, 1e-4 in
float32 compute and 3e-2 in bfloat16 (the JAX package's chunked-xent bar,
``tests/test_models.py``); the loss 1e-5 (float32) and 5e-3 (bfloat16, the
JAX package's flash-in-Llama bar). Parameters after two AdamW steps: in
float32 within 2 x lr (each step moves a parameter by at most about lr).
In bfloat16 the gradients differ by up to 3e-2 of each leaf's largest, and
AdamW's first step moves every parameter by lr times the sign of its
gradient, so a parameter whose gradient lies within that difference of 0
can move the other way in one framework: within 4 x lr (two steps of at
most about 2 lr apart), and 90 % of each leaf within 0.1 x lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu.ops.flash_attn import make_flash_attention as jax_make_flash
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ops.flash_attn import make_flash_attention

_MOE = dict(n_experts=2, moe_every=2)
_DT = {"float32": (torch.float32, jnp.float32, 1e-4, 1e-5),
       "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2, 5e-3)}


@pytest.fixture(scope="module", params=["dense_mlp", "soft_moe"])
def model(request):
    extra = _MOE if request.param == "soft_moe" else {}
    jax_cfg = dataclasses.replace(jax_llama.TINY, **extra)
    cfg = dataclasses.replace(llama.TINY, **extra)
    jax_params = jax_llama.init_params(jax.random.PRNGKey(0), jax_cfg)
    return cfg, jax_cfg, jax.tree.map(np.asarray, jax_params)


def _port_params(tree):
    params = llama.params_from_jax(tree, device="cpu")
    for t in llama.param_leaves(params):
        t.requires_grad_(True)
    return params


def _leaf(params, path):
    node = params
    for key in path:
        node = node[key.key if hasattr(key, "key") else key.idx]
    return node


def _tokens(shift, seed=1):
    shape = (2, 64) if shift == "roll" else (2, 65)
    return np.random.default_rng(seed).integers(0, llama.TINY.vocab, shape).astype(np.int32)


def _attn(kind):
    if kind == "dense":
        return None, None
    return make_flash_attention(causal=True), jax_make_flash(causal=True)


def _assert_leaves_close(got_tree, want_tree, bar):
    """Per leaf: max |got - want| <= bar * max |want|."""
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        want = np.asarray(want, np.float32)
        got = _leaf(got_tree, path)
        got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == want.shape, path
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
        assert rel <= bar, f"{jax.tree_util.keystr(path)}: {rel:.3g} > {bar}"


@pytest.mark.parametrize("shift", ["roll", "split"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(model, dt, attn, shift):
    cfg, jax_cfg, tree = model
    torch_dt, jax_dt, grad_bar, loss_bar = _DT[dt]
    toks = _tokens(shift)
    port_attn, jax_attn = _attn(attn)
    params = _port_params(tree)
    loss = llama.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, attn_fn=port_attn,
                         compute_dtype=torch_dt, shift=shift)
    leaves = llama.param_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    for t, g in zip(leaves, grads):
        t.grad = g
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jax_llama.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, jax_cfg, attn_fn=jax_attn, compute_dtype=jax_dt,
        shift=shift)))(tree)
    assert float(loss.detach()) == pytest.approx(float(want_loss), abs=loss_bar)
    grad_tree = jax.tree.map(lambda t: t.grad, params,
                             is_leaf=lambda x: isinstance(x, torch.Tensor))
    _assert_leaves_close(grad_tree, want_grads, grad_bar)


def _loss_and_grads(params, cfg, toks, **kw):
    loss = llama.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, **kw)
    return loss.detach(), torch.autograd.grad(loss, llama.param_leaves(params))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_layers_matches_no_remat(model, attn):
    """Checkpoint recompute runs the same operations: the loss is equal and
    the gradients within 1e-6 (the JAX package's bar)."""
    cfg, _, tree = model
    params = _port_params(tree)
    toks = _tokens("roll")
    kw = dict(attn_fn=_attn(attn)[0], shift="roll")
    loss, grads = _loss_and_grads(params, cfg, toks, **kw)
    remat_loss, remat_grads = _loss_and_grads(params, cfg, toks, remat_layers=True, **kw)
    assert float(loss) == float(remat_loss)
    for a, b in zip(grads, remat_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shift,chunk", [("roll", 32), ("split", 64)])
def test_xent_chunk_matches_full_loss_and_gradients(model, shift, chunk):
    """As the JAX package's own test: loss within rel 1e-3 and gradients
    within 3e-2 of each leaf's max (bfloat16 cotangents reassociate)."""
    cfg, _, tree = model
    params = _port_params(tree)
    toks = _tokens(shift)
    kw = dict(attn_fn=make_flash_attention(causal=True), shift=shift)
    loss, grads = _loss_and_grads(params, cfg, toks, **kw)
    chunk_loss, chunk_grads = _loss_and_grads(params, cfg, toks, xent_chunk=chunk, **kw)
    assert float(chunk_loss) == pytest.approx(float(loss), rel=1e-3)
    for a, b in zip(grads, chunk_grads):
        assert (a - b).abs().max() <= 3e-2 * a.abs().max()
    with pytest.raises(ValueError, match="must divide"):
        llama.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, shift=shift,
                      xent_chunk=chunk + 1)


def test_xent_chunk_keeps_no_logits_for_the_backward():
    """With ``xent_chunk`` every chunk's lm_head logits are recomputed in
    the backward, so the storages autograd saves (each counted once) hold
    far fewer bytes than one copy of the (tokens, vocab) float32 logits;
    the full-logits loss saves more than that copy. A vocabulary much wider
    than the model makes the logits dominate what is saved."""
    cfg = dataclasses.replace(llama.TINY, vocab=8192, dim=16, n_layers=1, n_heads=2,
                              n_kv_heads=1, hidden=32)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for t in llama.param_leaves(params):
        t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    logits_bytes = toks.numel() * cfg.vocab * 4

    def saved_bytes(**kw):
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = llama.loss_fn(params, {"tokens": toks}, cfg, shift="roll", **kw)
        loss.backward()
        return sum(storages.values())
    assert saved_bytes() > logits_bytes
    assert saved_bytes(xent_chunk=32) < logits_bytes // 2


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_train_step_matches_jax_optax_step(model, dt):
    """Two AdamW steps with flash attention: each step's loss against the
    JAX step's, then every parameter against the JAX parameters."""
    cfg, jax_cfg, tree = model
    torch_dt, jax_dt, _, loss_bar = _DT[dt]
    lr = 3e-4
    batches = [_tokens("roll", seed=s) for s in (1, 2)]
    params = llama.params_from_jax(tree, device="cpu")
    init_opt, step = llama.make_train_step(cfg, learning_rate=lr,
                                           attn_fn=make_flash_attention(causal=True),
                                           compute_dtype=torch_dt, shift="roll")
    opt = init_opt(params)
    jax_init, jax_step = jax_llama.make_train_step(jax_cfg, learning_rate=lr,
                                                   attn_fn=jax_make_flash(causal=True),
                                                   compute_dtype=jax_dt, shift="roll")
    jax_step = jax.jit(jax_step)
    jax_params = jax.tree.map(jnp.asarray, tree)
    jax_opt = jax_init(jax_params)
    for toks in batches:
        out, opt, loss = step(params, opt, {"tokens": torch.from_numpy(toks)})
        assert out is params and loss.grad_fn is None
        jax_params, jax_opt, jax_loss = jax_step(jax_params, jax_opt, {"tokens": jnp.asarray(toks)})
        assert float(loss) == pytest.approx(float(jax_loss), abs=loss_bar)
    for path, want in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        diff = np.abs(_leaf(params, path).detach().numpy() - np.asarray(want))
        where = jax.tree_util.keystr(path)
        if dt == "float32":
            assert diff.max() <= 2 * lr, where
        else:
            assert diff.max() <= 4 * lr and (diff <= 0.1 * lr).mean() >= 0.9, where
    moved = [not np.array_equal(_leaf(params, p).detach().numpy(), w)
             for p, w in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert all(moved)
