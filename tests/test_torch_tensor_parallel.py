"""Tensor and expert parallelism on the port against the JAX package: a
TINY-width Llama with 4 experts (layer 1 a mixture), soft and switch
dispatch, whose global batch is split over spawned CPU ranks (gloo) on a
``("data", "seq", "model")`` mesh of (1, 1, 2), (2, 1, 2) or (1, 2, 2) (ring
and Ulysses over the sequence axis, each model rank attending over its own
heads), on the JAX weights (``params_from_jax``, each rank its slice by
``shard_params``).

Bars, float32 compute: the loss at rtol 1e-4 against JAX's ``loss_fn`` on
the global batch; every leaf's gradient (summed over the data and sequence
ranks, the model ranks' slices joined by ``unshard_params``) within 1e-4 of
its largest value from ``jax.grad``; the parameters after one AdamW step
within 1e-4 of optax's (a step moves each by about lr = 3e-4). bfloat16
compute: the loss within 5e-3. Two wrong versions must miss the bars:
slots and capacity reckoned per rank instead of globally, and the router's
gradient left partial over the model group.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel import comm
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.parallel.mesh import Mesh
from petastorm_tpu_torch.parallel.ring_attention import make_ring_attention
from petastorm_tpu_torch.parallel.ulysses_attention import make_ulysses_attention

# TINY's widths; top-2 at a capacity factor of 1 drops tokens of the
# busiest experts, so routing per rank gives other drops than routing over
# the global batch.
CFG = dict(vocab=256, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden=128, n_experts=4,
           moe_every=2, moe_top_k=2, moe_capacity_factor=1.0)
TOKENS = np.random.default_rng(5).integers(0, CFG["vocab"], (2, 32)).astype(np.int32)
#: The meshes, by spawn: the 4-rank meshes share one.
SPAWNS = [[(1, 1, 2)], [(2, 1, 2), (1, 2, 2)]]
CONTROLS = ("per-rank routing", "router unsummed")


def _jax_references(dispatch):
    """JAX's float32 loss and gradients, optax's parameters after one AdamW
    step, and the bfloat16 loss, on the global batch."""
    cfg = jax_llama.LlamaConfig(**CFG, moe_dispatch=dispatch)
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


def _cases(mesh_index, sizes):
    strategies = ["dense"] if sizes[1] == 1 else ["ring", "ulysses"]
    cases = []
    for dispatch in ("soft", "switch"):
        for strategy in strategies:
            cases.append((f"{mesh_index}:{dispatch}-{strategy}", mesh_index, dispatch, strategy,
                          "plain", None))
        first = strategies[0]
        cases.append((f"{mesh_index}:{dispatch}-{first}-xent_remat", mesh_index, dispatch, first,
                      "xent_remat", None))
        cases.append((f"{mesh_index}:{dispatch}-{first}-bf16", mesh_index, dispatch, first, "bf16",
                      None))
    for control in CONTROLS:
        if control == "per-rank routing" and sizes[0] * sizes[1] == 1:
            continue   # one token rank: its routing is the global one
        cases.append((f"{mesh_index}:switch-{control}", mesh_index, "switch", strategies[0],
                      "plain", control))
    return cases


def _tree(shardings, ranks, name, part, mi):
    """The model ranks' trees (at data and seq coordinate 0 of mesh ``mi``)
    of ``name``'s ``part`` (1: gradients, 2: parameters) joined over the
    model axis, as ``param_leaves``."""
    by_model = sorted((r["coords"][mi]["model"], r[name][part]) for r in ranks
                      if r["coords"][mi]["data"] == 0 and r["coords"][mi]["seq"] == 0)
    return llama.param_leaves(llama.unshard_params([t for _, t in by_model], shardings))


def _misses(refs, shardings, ranks, name, mi):
    """What of ``name``'s results (on mesh ``mi``) misses the bars, as a list
    of messages."""
    dispatch = "soft" if ":soft" in name else "switch"
    ref = refs[dispatch]
    misses = []
    losses = [r[name][0] for r in ranks]
    if name.endswith("bf16"):
        if abs(losses[0] - ref["bf16"]) > 5e-3:
            misses.append(f"bf16 loss {losses[0]} vs {ref['bf16']}")
        return misses
    if not np.allclose(losses, losses[0], rtol=1e-6):
        misses.append(f"the ranks' losses differ: {losses}")
    if abs(losses[0] - ref["loss"]) > 1e-4 * abs(ref["loss"]):
        misses.append(f"loss {losses[0]} vs {ref['loss']}")
    want_grads = llama.param_leaves(llama.params_from_jax(ref["grads"], device="cpu"))
    want_after = llama.param_leaves(llama.params_from_jax(ref["after"], device="cpu"))
    names = _leaf_names()
    for leaf, got, want in zip(names, _tree(shardings, ranks, name, 1, mi), want_grads):
        if (got - want).abs().max() > 1e-4 * want.abs().max():
            misses.append(f"gradient of {leaf}: {(got - want).abs().max().item():.3g} off, "
                          f"largest {want.abs().max().item():.3g}")
    for leaf, got, want in zip(names, _tree(shardings, ranks, name, 2, mi), want_after):
        if (got - want).abs().max() > 1e-4:
            misses.append(f"{leaf} after the step: {(got - want).abs().max().item():.3g} off")
    return misses


def _leaf_names():
    cfg = llama.LlamaConfig(**CFG)
    names = []
    for key in sorted(("embed", "layers", "norm_out", "lm_head")):
        if key == "layers":
            specs = llama._param_pspec_tuples(cfg, "model")["layers"]
            names += [f"layers.{i}.{k}" for i, layer in enumerate(specs) for k in sorted(layer)]
        else:
            names.append(key)
    return names


@pytest.fixture(scope="module")
def refs():
    return {d: _jax_references(d) for d in ("soft", "switch")}


@pytest.mark.parametrize("meshes", SPAWNS, ids=lambda ms: "+".join("x".join(map(str, m))
                                                                     for m in ms))
def test_loss_and_every_gradient_match_jax_on_the_mesh(refs, meshes):
    cases = [c for i, sizes in enumerate(meshes) for c in _cases(i, sizes)]
    ranks = run_ranks(torch_tp_ranks.tp_cases, int(np.prod(meshes[0])),
                      args=(meshes, refs["soft"]["params"], CFG, TOKENS, cases), device="cpu",
                      timeout_s=300)
    for mi, sizes in enumerate(meshes):   # the three-axis grid, rank-major, model fastest
        coords = [tuple(r["coords"][mi][a] for a in ("data", "seq", "model")) for r in ranks]
        assert coords == [tuple(c) for c in np.ndindex(*sizes)]
    for name, mi, *_, control in cases:
        shardings = llama.param_shardings(types.SimpleNamespace(shape={"model": meshes[mi][2]}),
                                          llama.LlamaConfig(**CFG))
        misses = _misses(refs, shardings, ranks, name, mi)
        if control is None:
            assert not misses, (meshes[mi], name, misses)
        else:
            assert misses, f"the control {name!r} met every bar on {meshes[mi]}"
            if control == "router unsummed":
                assert any("layers.1.router" in m for m in misses), misses


def test_param_shardings_is_the_jax_layout():
    for extra in ({}, {"n_experts": 4}):
        cfg, jax_cfg = llama.LlamaConfig(**CFG | extra), jax_llama.LlamaConfig(**CFG | extra)
        mesh = types.SimpleNamespace(shape={"model": 4})
        want = jax_llama._param_pspec_tuples(jax_cfg, "model")
        assert llama.param_shardings(mesh, cfg) == want
        assert llama._param_pspec_tuples(cfg, None) == jax_llama._param_pspec_tuples(jax_cfg, None)


def test_param_shardings_rejects_a_model_axis_that_does_not_divide():
    # The JAX dry run folds such a factor into data parallelism; here the
    # layout refuses it (8 heads over 4 kv heads cannot split 8 ways).
    with pytest.raises(ValueError, match="n_kv_heads"):
        llama.param_shardings(types.SimpleNamespace(shape={"model": 8}), llama.LlamaConfig(**CFG))


def test_shard_then_unshard_gives_the_tree_back(monkeypatch):
    cfg = llama.LlamaConfig(**CFG)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = Mesh({"data": 1, "seq": 1, "model": 2}, {"model": "model group"})
    shardings = llama.param_shardings(mesh, cfg)
    slices = []
    for index in range(2):
        monkeypatch.setattr(llama.dist, "get_rank", lambda group: index)
        slices.append(llama.shard_params(params, shardings, mesh))
    assert slices[1]["layers"][1]["ew1"].shape == (2, 64, 128)
    assert slices[0]["embed"].shape == (128, 64) and slices[1]["lm_head"].shape == (64, 128)
    assert slices[1]["layers"][0]["wq"].shape == (64, 32)
    torch.testing.assert_close(slices[1]["layers"][0]["wo"], params["layers"][0]["wo"][32:],
                               rtol=0, atol=0)
    back = llama.unshard_params(slices, shardings)
    for got, want in zip(llama.param_leaves(back), llama.param_leaves(params)):
        assert torch.equal(got, want)


def test_the_pair_without_a_group_is_the_identity():
    x = torch.randn(3, 4)
    assert comm.copy_to_group(x, None) is x and comm.reduce_from_group(x, None) is x


@pytest.mark.parametrize("maker", [make_ring_attention, make_ulysses_attention])
def test_makers_take_the_jax_axes_and_reject_missing_ones(maker):
    mesh = Mesh({"data": 1, "seq": 1}, {"seq": None})
    with pytest.raises(ValueError, match="model"):
        maker(mesh, head_axis="model")
    with pytest.raises(ValueError, match="batch"):
        maker(mesh, data_axis="batch")
    assert maker(mesh, data_axis="data", head_axis=None).supports_gqa
