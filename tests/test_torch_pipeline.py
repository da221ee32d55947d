"""The GPipe pipeline on the port against the JAX package.

The JAX test's toy pipeline (``tests/test_parallel.py:189-220``: 4
microbatches of ``relu(x @ w + b)`` stages, d = 16, 16 rows) on spawned CPU
ranks (gloo) over ``("pipe", "data")`` meshes of (2, 1), (4, 1) and (4, 2),
against JAX's ``make_pipeline`` on the same meshes of its 8 CPU devices:
the output within 1e-5, and the gradients of ``sum(y ** 2)`` with respect
to every stage's parameters and to ``x`` within 1e-4. Then the refusals,
and the JAX dry run's Llama pipeline (one block a stage, 4 microbatches) on
a (2, 2) mesh: the float32 loss within 1e-5 of the sequential layer loop's,
the bfloat16 loss within 5e-3, and every leaf's gradient (``embed``,
summed over the stages from stage 0's; ``norm_out`` and ``lm_head``, whole
on every stage; each stage's block) within 1e-4 of its largest value from
``jax.grad`` of the sequential loss. The control, an output op that sums
its cotangent over the stages (every stage's gradient S times too large),
must miss the gradient bars.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fsdp_ranks
from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from petastorm_tpu.parallel.pipeline import make_pipeline as jax_make_pipeline
from petastorm_tpu.parallel.pipeline import stack_stage_params as jax_stack
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.parallel.pipeline import stack_stage_params

D = 16
X = np.random.default_rng(0).normal(size=(16, D)).astype(np.float32)
PCFG = dict(vocab=128, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden=128, n_experts=0)
PMESH = (2, 2)
PTOKENS = np.random.default_rng(2).integers(0, PCFG["vocab"], (4 * PMESH[1], 33)).astype(np.int32)
#: Meshes by spawn: the 4-rank spawn also runs the Llama pipeline.
SPAWNS = [(2, 1), (4, 1), (4, 2)]


def _stages(count):
    rng = np.random.default_rng(0)
    return [{"w": (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32),
             "b": np.zeros((D,), np.float32)} for _ in range(count)]


def _jax_pipeline(sizes):
    """JAX's output and its gradients of ``sum(y ** 2)`` (stacked stage
    parameters, x) on the ``(pipe, data)`` mesh ``sizes``."""
    stacked = jax_stack([jax.tree.map(jnp.asarray, s) for s in _stages(sizes[0])])
    mesh = jax_make_mesh(sizes, ("pipe", "data"), jax.devices()[:int(np.prod(sizes))])
    pipe = jax_make_pipeline(mesh, lambda p, x: jax.nn.relu(x @ p["w"] + p["b"]),
                             n_microbatches=4, data_axis="data")
    out = jax.jit(pipe)(stacked, jnp.asarray(X))
    g_params, g_x = jax.jit(jax.grad(lambda sp, x: jnp.sum(pipe(sp, x) ** 2),
                                     argnums=(0, 1)))(stacked, jnp.asarray(X))
    return np.asarray(out), jax.tree.map(np.asarray, g_params), np.asarray(g_x)


@pytest.fixture(scope="module")
def llama_ref():
    """JAX's sequential float32 loss and gradients and bfloat16 loss."""
    cfg = jax_llama.LlamaConfig(**PCFG)
    params = jax_llama.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.asarray(PTOKENS)}
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jax_llama.loss_fn, cfg=cfg, compute_dtype=jnp.float32)))(params, batch)
    bf16 = jax.jit(functools.partial(jax_llama.loss_fn, cfg=cfg))(params, batch)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"params": to_np(params), "loss": float(loss), "grads": to_np(grads),
            "bf16": float(bf16)}


def _close(got, want, bar):
    return (torch.as_tensor(got) - torch.from_numpy(np.array(want))).abs().max().item() <= \
        bar * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("sizes", SPAWNS, ids=lambda s: "x".join(map(str, s)))
def test_pipeline_matches_jax_fwd_and_grad(sizes, llama_ref):
    S, dp = sizes
    with_llama = (PMESH, llama_ref["params"], PCFG, PTOKENS) if S * dp == 4 else None
    ranks = run_ranks(torch_fsdp_ranks.pipeline_cases, S * dp,
                      args=([sizes], _stages(S), X, with_llama), device="cpu", timeout_s=300)
    out, g_params, g_x = _jax_pipeline(sizes)
    rows = X.shape[0] // dp
    for r in ranks:
        got = r[sizes]
        p, d = got["coords"]["pipe"], got["coords"]["data"]
        np.testing.assert_allclose(got["y"].numpy(), out[d * rows:(d + 1) * rows], atol=1e-5)
        np.testing.assert_allclose(got["dx"].numpy(), g_x[d * rows:(d + 1) * rows], atol=1e-4)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["grads"][k].numpy(), g_params[k][p], atol=1e-4)
        # The control: S times the gradient, outside the bar.
        assert not np.allclose(got["control grads"]["w"].numpy(), g_params["w"][p], atol=1e-4)
        np.testing.assert_allclose(got["control grads"]["w"].numpy(), S * g_params["w"][p],
                                   rtol=1e-4, atol=1e-4)
    microbatch, one_stage, count = ranks[0]["errors"]
    assert microbatch is not None and "not divisible by 3 microbatches" in microbatch
    assert one_stage is not None and "exactly one stage" in one_stage
    assert count is not None and "exactly one stage" in count
    if with_llama:
        _check_llama(ranks, llama_ref)


def _check_llama(ranks, ref):
    want = ref["grads"]
    for r in ranks:
        got = r["llama"]
        assert abs(got["f32"][0] - ref["loss"]) <= 1e-5, (got["f32"][0], ref["loss"])
        assert abs(got["bf16"][0] - ref["bf16"]) <= 5e-3, (got["bf16"][0], ref["bf16"])
        stage = got["coords"]["pipe"]
        for name, control in (("f32", False), ("control", True)):
            grads = got[name][1]
            pairs = [(k, grads[k], want[k]) for k in ("embed", "lm_head", "norm_out")]
            pairs += [(f"layers.{stage}.{k}", g, want["layers"][stage][k])
                      for k, g in grads["layers"].items()]
            misses = [k for k, g, w in pairs if not _close(g, w, 1e-4)]
            if control:
                assert "embed" in misses and f"layers.{stage}.wq" in misses, misses
                assert "lm_head" not in misses and "norm_out" not in misses, misses
            else:
                assert not misses, misses
    # The sequential layer loop of the port on the same weights.
    cfg = llama.LlamaConfig(**PCFG)
    params = llama.params_from_jax(ref["params"], device="cpu")
    batch = {"tokens": torch.from_numpy(PTOKENS)}
    with torch.no_grad():
        seq32 = llama.loss_fn(params, batch, cfg, compute_dtype=torch.float32).item()
        seq16 = llama.loss_fn(params, batch, cfg).item()
    assert abs(ranks[0]["llama"]["f32"][0] - seq32) <= 1e-5
    assert abs(ranks[0]["llama"]["bf16"][0] - seq16) <= 5e-3


def test_layers_fn_with_remat_layers_raises():
    cfg = llama.LlamaConfig(**PCFG)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="remat_layers"):
        llama.apply(params, torch.from_numpy(PTOKENS), cfg, remat_layers=True,
                    layers_fn=lambda layers, x: (x, 0.0))


def test_layers_fn_replaces_the_layer_loop():
    """``layers_fn`` gets ``params["layers"]`` and the embeddings; a loop
    of ``apply_block`` through it gives the sequential loop's logits."""
    cfg = llama.LlamaConfig(**PCFG)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(PTOKENS)

    def loop(layers, x):
        for layer in layers:
            x = llama.apply_block(layer, x, cfg)[0]
        return x, torch.zeros(())
    torch.testing.assert_close(llama.apply(params, tokens, cfg, layers_fn=loop),
                               llama.apply(params, tokens, cfg), rtol=0, atol=0)


def test_stack_stage_params_stacks_like_jax():
    stages = _stages(3)
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    want = jax_stack([jax.tree.map(jnp.asarray, s) for s in stages])
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
