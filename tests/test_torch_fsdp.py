"""FSDP (ZeRO-3) on the port against the JAX package: the layout of
``param_shardings_fsdp``, and a TINY-width Llama with 4 experts (layer 1 a
soft mixture) whose weights (``params_from_jax``) are split over the data
axis of spawned CPU ranks (gloo) on a ``("data", "seq", "model")`` mesh of
(2, 1, 1) (FSDP alone) or (2, 1, 2) (FSDP with Megatron's model axis), each
rank also holding its rows of the batch.

Bars, float32 compute: the loss at rtol 1e-4 against JAX's ``loss_fn`` on
the global batch; every leaf's gradient (its blocks joined over the data,
then the model axis) within 1e-4 of its largest value from ``jax.grad``;
the parameters after one AdamW step within 1e-4 of optax's (a step moves
each by about lr = 3e-4; the ranks read 1e-7 and less). bfloat16 compute:
the loss within 5e-3. The control, a gather whose backward keeps the rank's
block of its own gradient instead of summing it over the data ranks, must
miss the gradient and update bars.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fsdp_ranks
from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel import comm
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.parallel.mesh import Mesh

CFG = dict(vocab=256, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden=128, n_experts=4,
           moe_every=2)
TOKENS = np.random.default_rng(5).integers(0, CFG["vocab"], (4, 32)).astype(np.int32)
CASES = [("plain", "plain", None), ("xent_remat", "xent_remat", None), ("bf16", "bf16", None),
         ("control", "plain", "gather unsummed")]


@pytest.fixture(scope="module")
def ref():
    """JAX's float32 loss and gradients, optax's parameters after one AdamW
    step, and the bfloat16 loss, on the global batch."""
    cfg = jax_llama.LlamaConfig(**CFG)
    params = jax_llama.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.asarray(TOKENS)}
    init_opt, train_step = jax_llama.make_train_step(cfg, shift="roll",
                                                     compute_dtype=jnp.float32)

    @jax.jit
    def references(params, batch):
        loss, grads = jax.value_and_grad(jax_llama.loss_fn)(params, batch, cfg, shift="roll",
                                                            compute_dtype=jnp.float32)
        after, _, _ = train_step(params, init_opt(params), batch)
        return loss, grads, after, jax_llama.loss_fn(params, batch, cfg, shift="roll")

    loss, grads, after, bf16 = references(params, batch)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"params": to_np(params), "loss": float(loss), "grads": to_np(grads),
            "after": to_np(after), "bf16": float(bf16)}


def _joined(ranks, sizes, name, part):
    """Every rank's tree of ``name``'s ``part`` (1: gradients, 2: parameters)
    joined over the data axis, then the model axis, as ``param_leaves``."""
    tp = sizes[2] > 1
    shardings = llama.param_shardings_fsdp(
        types.SimpleNamespace(shape={"data": sizes[0], "model": sizes[2]}),
        llama.LlamaConfig(**CFG), model_axis="model" if tp else None)
    by_model = []
    for m in range(sizes[2]):
        blocks = sorted((r["coords"]["data"], r[name][part]) for r in ranks
                        if r["coords"]["model"] == m and r["coords"]["seq"] == 0)
        by_model.append(llama.unshard_params([t for _, t in blocks], shardings, axis="data"))
    return llama.param_leaves(llama.unshard_params(by_model, shardings, axis="model")
                              if tp else by_model[0])


def _misses(ref, ranks, sizes, name):
    misses = []
    losses = [r[name][0] for r in ranks]
    if name == "bf16":
        if abs(losses[0] - ref["bf16"]) > 5e-3:
            misses.append(f"bf16 loss {losses[0]} vs {ref['bf16']}")
        return misses
    if not np.allclose(losses, losses[0], rtol=1e-6):
        misses.append(f"the ranks' losses differ: {losses}")
    if abs(losses[0] - ref["loss"]) > 1e-4 * abs(ref["loss"]):
        misses.append(f"loss {losses[0]} vs {ref['loss']}")
    names = _leaf_names()
    want = llama.param_leaves(llama.params_from_jax(ref["grads"], device="cpu"))
    for leaf, got, w in zip(names, _joined(ranks, sizes, name, 1), want):
        if got.shape != w.shape or (got - w).abs().max() > 1e-4 * w.abs().max():
            misses.append(f"gradient of {leaf}")
    want = llama.param_leaves(llama.params_from_jax(ref["after"], device="cpu"))
    for leaf, got, w in zip(names, _joined(ranks, sizes, name, 2), want):
        if (got - w).abs().max() > 1e-4:
            misses.append(f"{leaf} after the step: {(got - w).abs().max().item():.3g} off")
    return misses


def _leaf_names():
    cfg = llama.LlamaConfig(**CFG)
    specs = llama._param_pspec_tuples(cfg, None)["layers"]
    return ["embed"] + [f"layers.{i}.{k}" for i, layer in enumerate(specs)
                        for k in sorted(layer)] + ["lm_head", "norm_out"]


@pytest.mark.parametrize("sizes", [(2, 1, 1), (2, 1, 2)], ids=["2x1x1", "2x1x2"])
def test_loss_and_every_gradient_match_jax_under_fsdp(ref, sizes):
    ranks = run_ranks(torch_fsdp_ranks.fsdp_cases, int(np.prod(sizes)),
                      args=(sizes, ref["params"], CFG, TOKENS, CASES), device="cpu",
                      timeout_s=300)
    assert [tuple(r["coords"][a] for a in ("data", "seq", "model")) for r in ranks] == \
        [tuple(c) for c in np.ndindex(*sizes)]
    for name, _, control in CASES:
        misses = _misses(ref, ranks, sizes, name)
        if control is None:
            assert not misses, (sizes, name, misses)
        else:
            assert any(m.startswith("gradient of layers.0.wq") for m in misses), misses
            assert any("after the step" in m for m in misses), misses
    # The blocks were gathered and their gradients scattered over the data
    # group; the replicated leaves' gradients were summed over it.
    transfers = ranks[0]["transfers"]
    assert transfers["fsdp_gather"][0] > 0 and transfers["fsdp_grad"][0] > 0
    assert transfers["all_reduce"][0] == 3   # the target count, the replicated leaves, the loss


def _jax_specs(sharding_tree):
    return jax.tree.map(lambda sh: tuple(sh.spec), sharding_tree,
                        is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("extra", [{}, {"n_experts": 4}], ids=["dense", "moe"])
def test_param_shardings_fsdp_is_the_jax_layout(extra):
    cfg_kwargs = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4, hidden=64) | extra
    cfg, jax_cfg = llama.LlamaConfig(**cfg_kwargs), jax_llama.LlamaConfig(**cfg_kwargs)
    jax_mesh = jax_make_mesh((4, 2), ("data", "model"))
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    for model_axis in ("model", None):
        want = _jax_specs(jax_llama.param_shardings_fsdp(jax_mesh, jax_cfg, model_axis=model_axis))
        assert llama.param_shardings_fsdp(mesh, cfg, model_axis=model_axis) == want


def test_fsdp_layout_of_the_jax_test(monkeypatch):
    """``test_llama_fsdp_actually_shards_matrices``'s layout, and a rank's
    ``wq`` block: 1/8 of the leaf on a (4, 2) layout."""
    cfg = llama.LlamaConfig(vocab=64, dim=32, n_layers=1, n_heads=4, n_kv_heads=4, hidden=64)
    mesh = Mesh({"data": 4, "model": 2}, {"data": "data group", "model": "model group"})
    sh = llama.param_shardings_fsdp(mesh, cfg)
    assert sh["layers"][0]["wq"] == ("data", "model")
    assert sh["layers"][0]["wo"] == ("model", "data")
    assert sh["embed"] == ("model", "data")
    assert sh["norm_out"] == ()
    assert llama.param_shardings_fsdp(mesh, cfg, model_axis=None)["layers"][0]["wq"] == \
        ("data", None)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    monkeypatch.setattr(llama.dist, "get_rank", lambda group: 1)
    block = llama.shard_params(params, sh, mesh)
    full = params["layers"][0]["wq"]
    assert block["layers"][0]["wq"].numel() * 8 == full.numel()
    torch.testing.assert_close(block["layers"][0]["wq"], full[8:16, 16:32], rtol=0, atol=0)
    assert block["norm_out"].shape == params["norm_out"].shape


def test_a_data_axis_that_does_not_divide_raises():
    cfg = llama.LlamaConfig(**CFG)
    with pytest.raises(ValueError, match="'data' axis"):
        llama.param_shardings_fsdp(types.SimpleNamespace(shape={"data": 3}), cfg, model_axis=None)
    with pytest.raises(ValueError, match="n_kv_heads"):   # the model axis' own check
        llama.param_shardings_fsdp(types.SimpleNamespace(shape={"data": 2, "model": 8}), cfg)


def test_unshard_over_each_axis_gives_the_tree_back(monkeypatch):
    cfg = llama.LlamaConfig(**CFG)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = Mesh({"data": 2, "model": 2}, {"data": "data", "model": "model"})
    sh = llama.param_shardings_fsdp(mesh, cfg)
    blocks = {}
    for d in range(2):
        for m in range(2):
            monkeypatch.setattr(llama.dist, "get_rank", lambda group: d if group == "data" else m)
            blocks[d, m] = llama.shard_params(params, sh, mesh)
    by_model = [llama.unshard_params([blocks[0, m], blocks[1, m]], sh, axis="data")
                for m in range(2)]
    back = llama.unshard_params(by_model, sh, axis="model")
    for got, want in zip(llama.param_leaves(back), llama.param_leaves(params)):
        assert torch.equal(got, want)


def test_gather_for_use_without_a_group_is_a_cast():
    t = torch.randn(4, 3)
    assert comm.gather_for_use(t, None, 0) is t
    assert comm.gather_for_use(t, None, 0, torch.bfloat16).dtype == torch.bfloat16


def test_fsdp_refuses_another_data_group_and_a_layers_fn():
    cfg = llama.LlamaConfig(**CFG)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(TOKENS)}
    with pytest.raises(ValueError, match="data_group"):
        llama.loss_fn(params, batch, cfg, fsdp_group="a", data_group="b")
    with pytest.raises(ValueError, match="layers_fn"):
        llama.apply(params, batch["tokens"], cfg, fsdp_group="a",
                    layers_fn=lambda layers, x: (x, 0.0))
