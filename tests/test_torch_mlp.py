"""petastorm_tpu_torch.models.mlp against the JAX package's MNIST MLP, on the
CPU, with the JAX parameters carried across by ``params_from_jax`` and the
batches drawn with numpy.

Bar: :data:`BAR` = 1e-5, as max |port - JAX| over max |JAX| per tensor, for
the logits and for every parameter, momentum, loss and accuracy along 5
steps of ``make_train_step`` (float32 on both sides; summation order is the
only difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import mlp as jax_mlp
from petastorm_tpu_torch.models import mlp

BAR = 1e-5
STEPS = 5


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_mlp.init_params(jax.random.PRNGKey(0)))


def _batches(seed=0, batch=32):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 784)).astype(np.float32)
    for _ in range(STEPS):
        labels = rng.integers(0, 10, batch).astype(np.int32)
        images = (protos[labels] + 0.5 * rng.normal(size=(batch, 784))).astype(np.float32)
        yield images, labels


def test_logits_match_jax(jax_params):
    x = np.random.default_rng(1).normal(size=(16, 784)).astype(np.float32)
    want = jax_mlp.apply(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(x))
    got = mlp.apply(mlp.params_from_jax(jax_params, device="cpu"), torch.from_numpy(x))
    assert rel(got, want) <= BAR


@pytest.mark.parametrize("lr", [1e-3, 0.05])
def test_five_train_steps_match_jax(jax_params, lr):
    step_j = jax.jit(jax_mlp.make_train_step(learning_rate=lr))
    p_j = jax.tree.map(jnp.asarray, jax_params)
    m_j = jax.tree.map(jnp.zeros_like, p_j)
    step = mlp.make_train_step(learning_rate=lr)
    p = mlp.params_from_jax(jax_params, device="cpu")
    m = {layer: {k: torch.zeros_like(v) for k, v in leaves.items()} for layer, leaves in p.items()}
    before = {layer: {k: v.clone() for k, v in leaves.items()} for layer, leaves in p.items()}
    for images, labels in _batches():
        p_j, m_j, loss_j, acc_j = step_j(p_j, m_j, {"image": jnp.asarray(images),
                                                    "label": jnp.asarray(labels)})
        p, m, loss, acc = step(p, m, {"image": torch.from_numpy(images),
                                      "label": torch.from_numpy(labels)})
        assert abs(loss.item() - float(loss_j)) <= BAR * abs(float(loss_j))
        assert acc.item() == pytest.approx(float(acc_j), abs=1e-6)
        for layer in p:
            for k in p[layer]:
                assert rel(p[layer][k], p_j[layer][k]) <= BAR, (layer, k)
                assert rel(m[layer][k], m_j[layer][k]) <= BAR, (layer, k)
    # The step returns new trees and leaves its inputs as they were.
    first = mlp.params_from_jax(jax_params, device="cpu")
    assert all(torch.equal(before[layer][k], first[layer][k])
               for layer in first for k in first[layer])


def test_init_params_has_the_jax_keys_shapes_and_scales(jax_params):
    p = mlp.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert {layer: {k: tuple(v.shape) for k, v in leaves.items()} for layer, leaves in p.items()} \
        == {layer: {k: v.shape for k, v in leaves.items()} for layer, leaves in jax_params.items()}
    assert abs(p["fc1"]["w"].std().item() - np.sqrt(2 / 784)) < 0.002
    assert not p["out"]["b"].any()


def test_loss_fn_matches_jax(jax_params):
    images, labels = next(_batches(seed=4))
    loss_j, acc_j = jax_mlp.loss_fn(jax.tree.map(jnp.asarray, jax_params),
                                    {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    loss, acc = mlp.loss_fn(mlp.params_from_jax(jax_params, device="cpu"),
                            {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    assert abs(loss.item() - float(loss_j)) <= BAR * abs(float(loss_j))
    assert acc.item() == pytest.approx(float(acc_j))
