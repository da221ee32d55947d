"""petastorm_tpu_torch.models.vit against the JAX package's ViT, on the CPU,
with the JAX parameters carried across by ``params_from_jax`` and the inputs
drawn with numpy: image 32, patch 8, dim 64, depth 2, heads 4, MLP 128, 10
classes (the JAX converter example's widths at a smaller image).

Bars, per tensor, as max |port - JAX| over max |JAX|:

* float32 compute on both sides: :data:`F32_BAR` = 1e-5 for the logits;
  :data:`GRAD_BAR` = 1e-4 for the loss and every gradient, and for every
  parameter after one SGD step. Summation order is the only difference
  left (measured: logits 8.5e-7, the loss 1.0e-7, the worst gradient
  1.9e-6).
* Controls built here, the same port with torch's exact-erf GELU and with
  the unbiased variance in its layer norms, must miss :data:`F32_BAR`
  (measured: 1.7e-4 and 1.5e-2).
* bfloat16 compute: :data:`BF16_BAR` = 0.05 for the logits and the loss.
  The two frameworks round bf16 at other places (XLA fuses some casts
  away) and two layers carry each difference (measured 6.8e-3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from petastorm_tpu.models import vit as jax_vit
from petastorm_tpu_torch.models import vit

CFG = dict(image_size=32, patch=8, dim=64, depth=2, heads=4, mlp_dim=128, num_classes=10)
F32_BAR = 1e-5
GRAD_BAR = 1e-4
BF16_BAR = 0.05
BATCH = 4


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_leaves(tree) -> list:
    """The JAX tree's leaves in ``vit.param_leaves``' order (sorted keys)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(np.asarray(node))

    walk(tree)
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_vit.init_params(jax.random.PRNGKey(0), **CFG))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], BATCH).astype(np.int32)
    return images, labels


def _port(jax_params):
    return vit.params_from_jax(jax_params, device="cpu")


def _jax_logits(params, images, dtype):
    return np.asarray(jax_vit.apply(params, jnp.asarray(images), patch=CFG["patch"],
                                    heads=CFG["heads"], compute_dtype=dtype), np.float32)


def _jax_f32_loss(params, images, labels):
    logits = jax_vit.apply(params, images, patch=CFG["patch"], heads=CFG["heads"],
                           compute_dtype=jnp.float32)
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()


def _torch_logits(params, images, dtype):
    return vit.apply(params, torch.from_numpy(images), patch=CFG["patch"], heads=CFG["heads"],
                     compute_dtype=dtype)


@pytest.mark.parametrize("image_size", [32, 36], ids=["exact", "ragged-valid"])
def test_float32_logits_match_jax(jax_params, image_size):
    """At 36 pixels the ``"VALID"`` convolution leaves 4 rows and columns
    out; the patchify must too."""
    images = np.random.default_rng(image_size).normal(
        size=(BATCH, image_size, image_size, 3)).astype(np.float32)
    want = _jax_logits(jax_params, images, jnp.float32)
    got = _torch_logits(_port(jax_params), images, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (BATCH, CFG["num_classes"])
    assert rel(got, want) <= F32_BAR


def test_uint8_images_equal_their_float_values(jax_params):
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    params = _port(jax_params)
    got = vit.apply(params, torch.from_numpy(u8), patch=8, heads=4, compute_dtype=torch.float32)
    want = _torch_logits(params, u8.astype(np.float32), torch.float32)
    assert torch.equal(got, want)


def test_loss_and_every_gradient_match_jax(jax_params, inputs):
    images, labels = inputs
    loss_j, grads_j = jax.value_and_grad(_jax_f32_loss)(
        jax.tree.map(jnp.asarray, jax_params), jnp.asarray(images), jnp.asarray(labels))
    params = _port(jax_params)
    leaves = vit.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, acc = vit.loss_fn(params, {"image": torch.from_numpy(images),
                                     "label": torch.from_numpy(labels)},
                            patch=CFG["patch"], heads=CFG["heads"], compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(loss_j)) <= GRAD_BAR * abs(float(loss_j))
    want = jax_leaves(grads_j)
    assert len(want) == len(grads) == 2 + 1 + 1 + 2 + 2 + CFG["depth"] * 12
    worst = max(rel(g, w) for g, w in zip(grads, want))
    assert worst <= GRAD_BAR, worst
    assert 0.0 <= acc.item() <= 1.0


def test_one_sgd_step_matches_jax(jax_params, inputs):
    """``make_train_step`` is the JAX converter example's step, p - lr g."""
    images, labels = inputs
    lr = 0.05
    grads_j = jax.grad(_jax_f32_loss)(jax.tree.map(jnp.asarray, jax_params),
                                      jnp.asarray(images), jnp.asarray(labels))
    want = jax.tree.map(lambda p, g: np.asarray(p - lr * g), jax_params, grads_j)
    params = _port(jax_params)
    step = vit.make_train_step(lr, patch=CFG["patch"], heads=CFG["heads"],
                               compute_dtype=torch.float32)
    params, loss, acc = step(params, {"image": torch.from_numpy(images),
                                      "label": torch.from_numpy(labels)})
    assert not loss.requires_grad and np.isfinite(loss.item())
    worst = max(rel(p, w) for p, w in zip(vit.param_leaves(params), jax_leaves(want)))
    assert worst <= GRAD_BAR, worst


def test_bf16_forward_and_loss_within_the_bf16_bar(jax_params, inputs):
    images, labels = inputs
    want = _jax_logits(jax_params, images, jnp.bfloat16)
    params = _port(jax_params)
    got = _torch_logits(params, images, torch.bfloat16)
    assert got.dtype == torch.float32
    assert rel(got, want) <= BF16_BAR
    loss_j, _ = jax_vit.loss_fn(jax.tree.map(jnp.asarray, jax_params),
                                {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
                                patch=CFG["patch"], heads=CFG["heads"])
    loss, _ = vit.loss_fn(params, {"image": torch.from_numpy(images),
                                   "label": torch.from_numpy(labels)},
                          patch=CFG["patch"], heads=CFG["heads"])
    assert abs(loss.item() - float(loss_j)) <= BF16_BAR * abs(float(loss_j))


def _erf_gelu(x):
    return F.gelu(x)


def _unbiased_layer_norm(x, p, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


@pytest.mark.parametrize("name,control", [("_gelu", _erf_gelu),
                                          ("_layer_norm", _unbiased_layer_norm)],
                         ids=["exact-erf gelu", "unbiased variance"])
def test_controls_miss_the_float32_bar(jax_params, inputs, monkeypatch, name, control):
    images, _ = inputs
    want = _jax_logits(jax_params, images, jnp.float32)
    params = _port(jax_params)
    assert rel(_torch_logits(params, images, torch.float32), want) <= F32_BAR
    monkeypatch.setattr(vit, name, control)
    assert rel(_torch_logits(params, images, torch.float32), want) > F32_BAR


def test_init_params_has_the_jax_keys_shapes_and_scales(jax_params):
    params = vit.init_params(torch.Generator().manual_seed(0), device="cpu", **CFG)
    got = jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, params))
    assert got == jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, jax_params))
    for p, j in zip(vit.param_leaves(params), jax_leaves(jax_params)):
        assert tuple(p.shape) == j.shape and p.dtype == torch.float32
    assert abs(params["blocks"][0]["mlp1"]["w"].std().item() - math.sqrt(2 / 64)) < 0.02
    assert abs(params["head"]["w"].std().item() - 0.01) < 0.002
    assert abs(params["pos"].std().item() - 0.02) < 0.004
    assert not params["cls"].any() and not params["blocks"][1]["qkv"]["b"].any()
    again = vit.init_params(torch.Generator().manual_seed(0), device="cpu", **CFG)
    assert all(torch.equal(a, b) for a, b in zip(vit.param_leaves(params),
                                                 vit.param_leaves(again)))


def test_params_from_jax_keeps_keys_and_layouts(jax_params):
    params = _port(jax_params)
    assert params["patch_embed"]["w"].shape == (8, 8, 3, 64)
    assert params["blocks"][0]["qkv"]["w"].shape == (64, 192)
    for p, j in zip(vit.param_leaves(params), jax_leaves(jax_params)):
        assert np.array_equal(p.numpy(), j)


def test_flops_per_image():
    # ViT-B/16 at 224: about 35.1 GFLOP a forward.
    assert abs(vit.vit_flops_per_image(**{k: v for k, v in vit.VIT_B16.items()
                                          if k != "heads"}) / 1e9 - 35.1) < 0.1
    # The small config, counted by hand: 16 patches, 17 tokens.
    per_layer = 2 * 17 * (4 * 64 * 64 + 2 * 64 * 128) + 4 * 17 * 17 * 64
    assert vit.vit_flops_per_image(32, 8, 64, 2, 128, 10) == (
        2 * 16 * 8 * 8 * 3 * 64 + 2 * per_layer + 2 * 64 * 10)
