"""petastorm_tpu_torch.models.resnet against the JAX package's ResNet-50,
on the CPU, with the JAX parameters carried across by ``params_from_jax``
and the inputs drawn with numpy.

Both modules' ``_RESNET50_STAGES`` are patched to a small net that still
runs every kind of block (the stem, a stride-2 block with a projection, an
identity block), at 32x32 images (lopsided ``"SAME"`` padding everywhere)
and 40x40 (an even padding at the third stage), except in the one
full-width forward.

Bars, per tensor, as max |port - JAX| over max |JAX|:

* float32 compute (both sides, by patching each module's ``apply`` default):
  :data:`F32_BAR` = 1e-4 for logits, new moving statistics, the loss, every
  gradient and every parameter after two SGD steps. Measured: logits 5e-7
  to 8e-6, statistics 3e-6, gradients 1.4e-5, parameters after two steps
  8e-6. Summation order is the only difference left.
* Controls built here, a forward with symmetric padding (PyTorch's habit)
  and one with the unbiased variance, must miss :data:`F32_BAR`.
* bfloat16 compute: :data:`BF16_BAR` = 0.05 for the logits. The two
  frameworks round bf16 at other places (XLA fuses some casts away) and 5
  to 7 layers carry each difference; measured up to 0.02.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import resnet as jax_resnet
from petastorm_tpu_torch.models import resnet

SMALL = ((1, 8), (2, 8), (1, 16), (1, 16))
CLASSES = 10
F32_BAR = 1e-4
BF16_BAR = 0.05


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def hwio(t: torch.Tensor) -> np.ndarray:
    """A port tensor in the JAX package's layout (OIHW -> HWIO)."""
    a = t.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def jax_leaves(tree) -> list:
    """The JAX tree's leaves in ``resnet.param_leaves``' order (sorted
    keys, moving statistics left out)."""
    out = []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key not in ("mean", "var"):
            out.append(np.asarray(node))

    walk(tree)
    return out


@pytest.fixture(scope="module")
def small():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, "_RESNET50_STAGES", SMALL)
        mp.setattr(resnet, "_RESNET50_STAGES", SMALL)
        jax_params = jax.tree.map(np.asarray,
                                  jax_resnet.init_params(jax.random.PRNGKey(0), CLASSES))
        yield jax_params


@pytest.fixture
def f32_compute(monkeypatch):
    """Both modules' ``apply`` default to float32 compute, so that their
    ``loss_fn`` and train step run in float32."""
    monkeypatch.setattr(jax_resnet, "apply", partial(jax_resnet.apply, compute_dtype=jnp.float32))
    monkeypatch.setattr(resnet, "apply", partial(resnet.apply, compute_dtype=torch.float32))


def _images(size, seed=1, n=4):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def _batches(size, steps=2, seed=2):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((4, size, size, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, 4).astype(np.int32)} for _ in range(steps)]


def _jax_forward(jax_params, images, train, dtype):
    fn = jax.jit(partial(jax_resnet.apply, train=train, compute_dtype=dtype))
    logits, stats = fn(jax_params, jnp.asarray(images))
    return np.asarray(logits), jax.tree.map(np.asarray, stats)


def test_params_from_jax_keeps_keys_and_layouts(small):
    params = resnet.params_from_jax(small, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, small))
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(small)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(hwio(got), want)
    conv = params["stage1"][0]["conv2"]
    assert conv.shape == (8, 8, 3, 3) and conv.is_contiguous(memory_format=torch.channels_last)
    assert params["head"]["w"].shape == (16 * 4, CLASSES)


def test_init_params_has_the_jax_shapes_and_scales(small):
    params = resnet.init_params(torch.Generator().manual_seed(0), CLASSES, device="cpu")
    again = resnet.init_params(torch.Generator().manual_seed(0), CLASSES, device="cpu")
    assert jax.tree.map(lambda t: hwio(t).shape, params) == jax.tree.map(np.shape, small)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)))
    # He-normal: std sqrt(2 / fan_in); the 3x3 convolution of stage 3 has 16*16*9 weights.
    w = params["stage3"][0]["conv2"]
    assert abs(w.std().item() / np.sqrt(2.0 / (9 * 16)) - 1) < 0.1
    bn = params["stage3"][0]["bn2"]
    assert torch.equal(bn["var"], torch.ones(16)) and torch.equal(bn["mean"], torch.zeros(16))


@pytest.mark.parametrize("size,k,stride", [(224, 7, 2), (112, 3, 2), (56, 3, 2), (56, 1, 2),
                                           (56, 3, 1), (5, 3, 2), (7, 3, 2), (1, 3, 2)])
def test_same_padding_is_xla_same(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert resnet._same_padding(size, k, stride) == tuple(want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [32, 40])
def test_forward_f32_matches(small, size, train):
    images = _images(size)
    want_logits, want_stats = _jax_forward(small, images, train, jnp.float32)
    params = resnet.params_from_jax(small, device="cpu")
    logits, stats = resnet.apply(params, torch.from_numpy(images), train=train,
                                 compute_dtype=torch.float32)
    assert logits.shape == (4, CLASSES) and logits.dtype == torch.float32
    assert rel(logits, want_logits) <= F32_BAR
    assert jax.tree.structure(jax.tree.map(lambda _: 0, stats)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want_stats))
    for got, want in zip(jax.tree.leaves(stats), jax.tree.leaves(want_stats)):
        assert rel(got, want) <= F32_BAR


@pytest.mark.parametrize("size", [32, 40])
def test_loss_and_gradients_f32_match(small, f32_compute, size):
    batch = _batches(size, steps=1)[0]
    (want_loss, (want_acc, _)), want_grads = jax.jit(
        jax.value_and_grad(jax_resnet.loss_fn, has_aux=True))(
        small, {k: jnp.asarray(v) for k, v in batch.items()})
    params = resnet.params_from_jax(small, device="cpu")
    leaves = resnet.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, (acc, _) = resnet.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert rel(loss, want_loss) <= F32_BAR and acc.item() == float(want_acc)
    # The moving statistics, which the port does not train, get no
    # gradient in the reference either.
    assert all(not np.any(np.asarray(g)) for path, g in
               jax.tree_util.tree_flatten_with_path(want_grads)[0]
               if path[-1].key in ("mean", "var"))
    want_grads = jax_leaves(want_grads)
    assert len(grads) == len(want_grads)
    assert max(rel(hwio(g), w) for g, w in zip(grads, want_grads)) <= F32_BAR


def test_two_train_steps_f32_match(small, f32_compute):
    batches = _batches(40)
    step = jax.jit(jax_resnet.make_train_step())
    p, v = small, jax.tree.map(np.zeros_like, small)
    want_losses = []
    for b in batches:
        p, v, loss, _ = step(p, v, {k: jnp.asarray(x) for k, x in b.items()})
        want_losses.append(float(loss))
    params = resnet.params_from_jax(small, device="cpu")
    init_opt, train_step = resnet.make_train_step()
    opt = init_opt(params)
    losses = []
    for b in batches:
        params, opt, loss, _ = train_step(params, opt, {k: torch.from_numpy(x) for k, x in b.items()})
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want_losses, rtol=F32_BAR)
    assert losses[1] != losses[0]
    # Every leaf after two steps, the moving statistics included.
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(p)):
        assert rel(hwio(got), want) <= F32_BAR


def test_first_momentum_buffer_is_the_reference_velocity(small):
    """torch.optim.SGD(dampening=0) keeps the reference's v: its first
    buffer is g + wd * p (v from zero), and the update is p - lr * v."""
    params = resnet.params_from_jax(small, device="cpu")
    init_opt, train_step = resnet.make_train_step(learning_rate=0.1, weight_decay=1e-4)
    opt = init_opt(params)
    leaves = resnet.param_leaves(params)
    before = [t.detach().clone() for t in leaves]
    batch = {k: torch.from_numpy(v) for k, v in _batches(32, steps=1)[0].items()}
    loss, _ = resnet.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    train_step(params, opt, batch)
    for t, p0, g in zip(leaves, before, grads):
        v = g + 1e-4 * p0
        torch.testing.assert_close(opt.state[t]["momentum_buffer"], v, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(t.detach(), p0 - 0.1 * v, rtol=1e-6, atol=1e-9)


def test_remat_matches_no_remat(small, f32_compute):
    batch = {k: torch.from_numpy(v) for k, v in _batches(40, steps=1)[0].items()}
    results = []
    for remat in (False, True):
        params = resnet.params_from_jax(small, device="cpu")
        leaves = resnet.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, (_, stats) = resnet.loss_fn(params, batch, remat=remat)
        results.append((loss, torch.autograd.grad(loss, leaves), jax.tree.leaves(stats)))
    (loss0, g0, s0), (loss1, g1, s1) = results
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0 + tuple(s0), g1 + tuple(s1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_bf16_forward_within_its_bar(small):
    images = _images(40)
    for train in (False, True):
        want, _ = _jax_forward(small, images, train, jnp.bfloat16)
        params = resnet.params_from_jax(small, device="cpu")
        logits, _ = resnet.apply(params, torch.from_numpy(images), train=train)
        assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
        assert rel(logits, want) <= BF16_BAR


def _unbiased_batch_norm(x, bn, train, momentum=0.9, eps=1e-5):
    """The reference's batch norm with the unbiased variance (a control)."""
    x32 = x.float()
    mean = x32.mean((0, 2, 3))
    var = x32.var((0, 2, 3), unbiased=True) if train else bn["var"]
    mean = mean if train else bn["mean"]
    inv = torch.rsqrt(var + eps) * bn["scale"]
    out = (x32 - mean[:, None, None]) * inv[:, None, None] + bn["bias"][:, None, None]
    stats = {"mean": momentum * bn["mean"] + (1 - momentum) * mean.detach(),
             "var": momentum * bn["var"] + (1 - momentum) * var.detach()}
    return out.to(x.dtype), stats


@pytest.mark.parametrize("control", ["symmetric padding", "unbiased variance"])
def test_controls_miss_the_f32_bar(small, monkeypatch, control):
    images = _images(32)
    want_logits, want_stats = _jax_forward(small, images, True, jnp.float32)
    if control == "symmetric padding":
        monkeypatch.setattr(resnet, "_same_padding", lambda size, k, stride: ((k - 1) // 2,) * 2)
    else:
        monkeypatch.setattr(resnet, "_batch_norm", _unbiased_batch_norm)
    params = resnet.params_from_jax(small, device="cpu")
    logits, stats = resnet.apply(params, torch.from_numpy(images), train=True,
                                 compute_dtype=torch.float32)
    worst = max([rel(logits, want_logits)] + [
        rel(g, w) for g, w in zip(jax.tree.leaves(stats), jax.tree.leaves(want_stats))])
    assert worst > F32_BAR, worst


def test_full_width_forward_f32_matches():
    """ResNet-50 as the repo defines it (no patch), 1000 classes, at 64x64,
    in training mode (batch statistics down to the last 2x2 stage)."""
    jax_params = jax.tree.map(np.asarray, jax_resnet.init_params(jax.random.PRNGKey(0), 1000))
    images = _images(64, n=2)
    want_logits, want_stats = _jax_forward(jax_params, images, True, jnp.float32)
    params = resnet.params_from_jax(jax_params, device="cpu")
    logits, stats = resnet.apply(params, torch.from_numpy(images), train=True,
                                 compute_dtype=torch.float32)
    assert logits.shape == (2, 1000)
    assert rel(logits, want_logits) <= F32_BAR
    assert max(rel(g, w) for g, w in zip(jax.tree.leaves(stats),
                                         jax.tree.leaves(want_stats))) <= F32_BAR


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.init_params(torch.Generator(), 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.params_from_jax({"head": {"b": np.zeros(2, np.float32)}})
