"""petastorm_tpu_torch.models.llama against the JAX package's Llama at
``TINY``, with the JAX parameters carried across by ``params_from_jax``.

float32 compute: logits (and every block) within atol 1e-4. bfloat16
compute: the loss within abs 5e-3, the bar of the JAX package's
flash-in-Llama test. Attention is the dense default or flash (the port's
plain version on the CPU; the JAX kernel in interpret mode).
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
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", params=["dense_mlp", "soft_moe"])
def model(request):
    extra = _MOE if request.param == "soft_moe" else {}
    jax_cfg = dataclasses.replace(jax_llama.TINY, **extra)
    cfg = dataclasses.replace(llama.TINY, **extra)
    jax_params = jax_llama.init_params(jax.random.PRNGKey(0), jax_cfg)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    return cfg, params, jax_cfg, jax_params


def _tokens(shape=(2, 64), seed=1):
    return np.random.default_rng(seed).integers(0, llama.TINY.vocab, shape).astype(np.int32)


def _attn(kind):
    if kind == "dense":
        return None, None
    return make_flash_attention(causal=True), jax_make_flash(causal=True)


def test_params_from_jax_keeps_keys_and_layouts(model):
    cfg, params, _, jax_params = model
    flat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_has_the_jax_shapes(model):
    cfg, _, jax_cfg, jax_params = model
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    again = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = jax.tree.map(lambda a: tuple(a.shape), jax_params)
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(torch.Generator(), llama.TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.params_from_jax({"embed": np.zeros((2, 2), np.float32)})


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        got = llama._rmsnorm(torch.from_numpy(x).to(_TORCH_DT[dt]), torch.from_numpy(scale), 1e-5)
        want = jax_llama._rmsnorm(jnp.asarray(x, getattr(jnp, dt)), jnp.asarray(scale), 1e-5)
        atol = 1e-5 if dt == "float32" else 3e-2
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)
    got = llama._rope(torch.from_numpy(x), 500000.0)
    want = jax_llama._rope(jnp.asarray(x), 500000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_embedding_gather_and_onehot_match(model, dt):
    _, params, _, jax_params = model
    toks = _tokens()
    onehot = llama._embed_lookup(params["embed"], torch.from_numpy(toks), _TORCH_DT[dt])
    gather = params["embed"].to(_TORCH_DT[dt])[torch.from_numpy(toks).long()]
    want = jax_llama._embed_lookup(jax_params["embed"], jnp.asarray(toks), getattr(jnp, dt))
    assert torch.equal(onehot, gather)
    np.testing.assert_array_equal(onehot.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_apply_block_matches(model, attn):
    cfg, params, jax_cfg, jax_params = model
    x = np.random.default_rng(3).normal(size=(2, 64, cfg.dim)).astype(np.float32)
    port_attn, jax_attn = _attn(attn)
    for li in range(cfg.n_layers):   # layer 1 is the MoE one in soft_moe
        got, aux = llama.apply_block(params["layers"][li], torch.from_numpy(x), cfg,
                                     attn_fn=port_attn)
        want, _ = jax_llama.apply_block(jax_params["layers"][li], jnp.asarray(x), jax_cfg,
                                        attn_fn=jax_attn)
        assert float(aux) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("embed_lookup", ["gather", "onehot"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_apply_logits_match_in_float32(model, attn, embed_lookup):
    cfg, params, jax_cfg, jax_params = model
    toks = _tokens()
    port_attn, jax_attn = _attn(attn)
    got = llama.apply(params, torch.from_numpy(toks), cfg, attn_fn=port_attn,
                      compute_dtype=torch.float32, embed_lookup=embed_lookup)
    want = jax_llama.apply(jax_params, jnp.asarray(toks), jax_cfg, attn_fn=jax_attn,
                           compute_dtype=jnp.float32, embed_lookup=embed_lookup)
    assert got.dtype == torch.float32 and got.shape == (2, 64, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    hidden = llama.apply(params, torch.from_numpy(toks), cfg, attn_fn=port_attn,
                         compute_dtype=torch.float32, return_hidden=True)
    assert hidden.shape == (2, 64, cfg.dim)


@pytest.mark.parametrize("shift,xent_chunk", [("split", None), ("roll", None),
                                              ("split", 32), ("roll", 64)])
@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_matches(model, dt, attn, shift, xent_chunk):
    cfg, params, jax_cfg, jax_params = model
    toks = _tokens((2, 64) if shift == "roll" else (2, 65))
    port_attn, jax_attn = _attn(attn)
    got = llama.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, attn_fn=port_attn,
                        compute_dtype=_TORCH_DT[dt], shift=shift, xent_chunk=xent_chunk)
    want = jax_llama.loss_fn(jax_params, {"tokens": jnp.asarray(toks)}, jax_cfg,
                             attn_fn=jax_attn, compute_dtype=getattr(jnp, dt), shift=shift,
                             xent_chunk=xent_chunk)
    assert got.shape == () and torch.isfinite(got)
    assert float(got) == pytest.approx(float(want), abs=1e-4 if dt == "float32" else 5e-3)


def test_switch_dispatch_and_bad_arguments_raise(model):
    cfg, params, _, _ = model
    toks = torch.from_numpy(_tokens((1, 8)))
    with pytest.raises(ValueError, match="shift"):
        llama.loss_fn(params, {"tokens": toks}, cfg, shift="left")
    with pytest.raises(ValueError, match="embed_lookup"):
        llama.apply(params, toks, cfg, embed_lookup="table")
    with pytest.raises(ValueError, match="xent_chunk"):
        llama.loss_fn(params, {"tokens": toks}, cfg, shift="roll", xent_chunk=3)
    if cfg.n_experts:
        # The switch dispatch runs (it raised before it was ported) and
        # matches the JAX package: loss and summed aux, float32, top-2 at a
        # capacity that drops tokens.
        kw = dict(moe_dispatch="switch", moe_top_k=2, moe_capacity_factor=0.5)
        switch, jax_switch = (dataclasses.replace(c, **kw) for c in (cfg, model[2]))
        toks = _tokens((2, 33))
        got = llama.loss_fn(params, {"tokens": torch.from_numpy(toks)}, switch,
                            compute_dtype=torch.float32)
        want = jax_llama.loss_fn(model[3], {"tokens": jnp.asarray(toks)}, jax_switch,
                                 compute_dtype=jnp.float32)
        assert float(got) == pytest.approx(float(want), abs=1e-4)
        _, aux = llama.apply(params, torch.from_numpy(toks), switch, with_aux=True,
                             compute_dtype=torch.float32)
        _, jax_aux = jax_llama.apply(model[3], jnp.asarray(toks), jax_switch, with_aux=True,
                                     compute_dtype=jnp.float32)
        assert float(aux) == pytest.approx(float(jax_aux), abs=1e-6) and float(aux) > 0
