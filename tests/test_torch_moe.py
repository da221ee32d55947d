"""petastorm_tpu_torch.parallel.moe against petastorm_tpu.parallel.moe, in
one process, on seeded numpy inputs, float32: the dense masks, the aux loss
and the block's output within 1e-6, the block's gradients within 1e-5 (the
block dispatches by index, the JAX package by dense masks, so their sums run
in another order).
The invariants the JAX package's own tests hold its routing to
(tests/test_parallel.py, switch MoE) are held here against its outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu.parallel import moe as jax_moe
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel import moe

BAR = 1e-6


def _logits(n, e, seed):
    return np.random.default_rng(seed).normal(size=(n, e)).astype(np.float32)


def _block_inputs(seed, b=2, s=6, d=8, hid=16, e=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(d, e)).astype(np.float32),
            (rng.normal(size=(e, d, hid)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, d, hid)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, hid, d)) / np.sqrt(hid)).astype(np.float32))


# (top_k, capacity, tokens, experts): enough room, drops in the first round,
# drops only in the second, one slot each.
ROUTES = [(1, 8, 40, 4), (1, 5, 40, 4), (2, 16, 16, 4), (2, 12, 40, 4), (2, 1, 24, 8),
          (1, 3, 10, 2)]


@pytest.mark.parametrize("top_k,capacity,n,e", ROUTES)
def test_switch_route_matches_jax(top_k, capacity, n, e):
    logits = _logits(n, e, seed=capacity)
    want = jax_moe.switch_route(jnp.asarray(logits), top_k, capacity)
    got = moe.switch_route(torch.from_numpy(logits), top_k, capacity)
    for g, w, what in zip(got, want, ("dispatch", "combine", "aux")):
        assert tuple(g.shape) == tuple(w.shape), what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=BAR, err_msg=what)


@pytest.mark.parametrize("top_k,capacity,n,e", ROUTES)
def test_switch_route_invariants_on_the_jax_outputs(top_k, capacity, n, e):
    """Every token occupies at most top_k slots, every slot at most one
    token, no expert more than its capacity, and a kept token carries its
    router probability: each checked on the port and found equal to JAX's."""
    logits = _logits(n, e, seed=capacity)
    dispatch, combine, aux = (t.numpy() for t in
                              moe.switch_route(torch.from_numpy(logits), top_k, capacity))
    want = [np.asarray(t) for t in jax_moe.switch_route(jnp.asarray(logits), top_k, capacity)]
    per_token = dispatch.sum(axis=(1, 2))
    assert set(per_token.tolist()) <= set(float(k) for k in range(top_k + 1))
    assert (dispatch.sum(axis=0) <= 1.0).all()
    assert (dispatch.sum(axis=(0, 2)) <= capacity).all()
    np.testing.assert_array_equal(per_token, want[0].sum(axis=(1, 2)))
    if top_k == 1:
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
        np.testing.assert_allclose(combine.sum(axis=(1, 2)), probs.max(-1) * per_token,
                                   rtol=1e-5)
    assert float(aux) > 0


def test_switch_route_capacity_drops_overflow():
    # All 10 tokens prefer expert 0; capacity 3 keeps exactly 3, the first 3.
    logits = np.tile(np.asarray([[5.0, 0.0]], np.float32), (10, 1))
    dispatch, _, _ = moe.switch_route(torch.from_numpy(logits), top_k=1, capacity=3)
    want, _, _ = jax_moe.switch_route(jnp.asarray(logits), top_k=1, capacity=3)
    assert dispatch[:, 0].sum() == 3.0 and dispatch[:, 1].sum() == 0.0
    assert dispatch[:3, 0].sum(-1).tolist() == [1.0, 1.0, 1.0]
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want))


def test_switch_route_top2_uses_second_expert():
    logits = torch.from_numpy(_logits(16, 4, seed=1))
    d1, _, _ = moe.switch_route(logits, top_k=1, capacity=16)
    d2, _, _ = moe.switch_route(logits, top_k=2, capacity=16)
    assert d2.sum().item() == 2 * d1.sum().item() == 32.0


@pytest.mark.parametrize("top_k", [1, 2])
def test_switch_aux_loss_matches_jax(top_k):
    probs = np.array(jax.nn.softmax(jnp.asarray(_logits(64, 8, seed=top_k)), -1))
    want = jax_moe.switch_aux_loss(jnp.asarray(probs), top_k)
    got = moe.switch_aux_loss(torch.from_numpy(probs), top_k)
    assert abs(got.item() - float(want)) <= BAR


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 1.0), (1, 10.0), (2, 0.5), (2, 1.25),
                                                   (2, 10.0)])
def test_switch_moe_block_matches_jax(top_k, capacity_factor):
    """Output, aux and every input's gradient (of a weighted sum of the
    output plus the aux), with and without dropped tokens."""
    arrays = _block_inputs(seed=top_k)
    weights = np.random.default_rng(9).normal(size=arrays[0].shape).astype(np.float32)

    def jax_obj(*args):
        out, aux = jax_moe.switch_moe_block(*args, top_k=top_k, capacity_factor=capacity_factor)
        return (out * weights).sum() + aux, (out, aux)

    (_, (want, want_aux)), want_grads = jax.value_and_grad(
        jax_obj, argnums=tuple(range(5)), has_aux=True)(*map(jnp.asarray, arrays))
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    with moe.record_routing() as record:
        got, aux = moe.switch_moe_block(*inputs, top_k=top_k, capacity_factor=capacity_factor)
    ((got * torch.from_numpy(weights)).sum() + aux).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=BAR)
    assert abs(aux.item() - float(want_aux)) <= BAR
    for t, w, what in zip(inputs, want_grads, ("h", "router", "ew1", "ew3", "ew2")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=what)
    stats, = record
    n = arrays[0].shape[0] * arrays[0].shape[1]
    assert stats["tokens"] == n and stats["top_k"] == top_k
    assert stats["capacity"] == max(1, int(capacity_factor * top_k * n / arrays[1].shape[1]))
    dispatch, _, _ = jax_moe.switch_route(
        jnp.asarray(arrays[0].reshape(n, -1) @ arrays[1]), top_k, stats["capacity"])
    np.testing.assert_array_equal(stats["kept"].numpy(), np.asarray(dispatch).sum(axis=(0, 2)))


def test_switch_moe_block_matches_manual_dense_compute():
    """Top-1 with room for every token: each token's output is its chosen
    expert's SwiGLU times its router probability."""
    h, router, ew1, ew3, ew2 = _block_inputs(seed=2, e=2)
    out, _ = moe.switch_moe_block(*map(torch.from_numpy, (h, router, ew1, ew3, ew2)),
                                  top_k=1, capacity_factor=10.0)
    x = h.reshape(-1, h.shape[-1])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ router), -1))
    manual = np.zeros_like(x)
    for i, e in enumerate(probs.argmax(-1)):
        gate = np.asarray(jax.nn.silu(jnp.asarray(x[i] @ ew1[e])))
        manual[i] = (gate * (x[i] @ ew3[e])) @ ew2[e] * probs[i, e]
    np.testing.assert_allclose(out.numpy().reshape(x.shape), manual, rtol=2e-4, atol=2e-5)


def test_routing_is_recorded_only_inside_record_routing():
    """Calls outside a ``record_routing`` block keep nothing; a nested block
    collects its own calls, and the outer block's list resumes after it."""
    inputs = tuple(map(torch.from_numpy, _block_inputs(seed=5)))
    moe.switch_moe_block(*inputs, top_k=2)
    with moe.record_routing() as outer:
        moe.switch_moe_block(*inputs, top_k=2)
        with moe.record_routing() as inner:
            moe.switch_moe_block(*inputs, top_k=1)
        moe.switch_moe_block(*inputs, top_k=2)
    moe.switch_moe_block(*inputs, top_k=1)
    assert [r["top_k"] for r in outer] == [2, 2] and [r["top_k"] for r in inner] == [1]
    assert moe._record is None


@pytest.mark.parametrize("dispatch", ["soft", "switch"])
def test_llama_switch_and_soft_match_jax_and_train(dispatch):
    """Both dispatches in the Llama: the float32 loss against the JAX
    package's (abs 1e-4, test_torch_llama's bar), and two AdamW steps in one
    process lower it."""
    kw = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4, hidden=64, n_experts=4,
              moe_every=2, moe_dispatch=dispatch, moe_top_k=2, moe_capacity_factor=2.0)
    jax_cfg, cfg = jax_llama.LlamaConfig(**kw), llama.LlamaConfig(**kw)
    jax_params = jax_llama.init_params(jax.random.PRNGKey(0), jax_cfg)
    tokens = np.random.default_rng(3).integers(0, 64, (4, 17)).astype(np.int32)
    want = jax_llama.loss_fn(jax_params, {"tokens": jnp.asarray(tokens)}, jax_cfg,
                             compute_dtype=jnp.float32)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    got = llama.loss_fn(params, batch, cfg, compute_dtype=torch.float32)
    assert got.item() == pytest.approx(float(want), abs=1e-4)
    init_opt, step = llama.make_train_step(cfg, learning_rate=1e-2)
    opt = init_opt(params)
    _, opt, first = step(params, opt, batch)
    _, opt, second = step(params, opt, batch)
    assert np.isfinite(first.item()) and second.item() < first.item()
