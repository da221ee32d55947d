"""petastorm_tpu_torch.ops.augment against the JAX package's ops/augment.py.

The draws of ``jax.random`` and a ``torch.Generator`` differ, so the JAX
draws are recomputed here from the same key, exactly as the JAX ops make
them, and fed to the port's apply functions: the uint8 outputs must be
bit-equal (flip, every crop mode the port takes, cutout), and mixup's
float32 output equal within 1e-6 (tolerance stated: it is the same three
float32 operations, one rounding each). Then the properties of
``tests/test_ops.py:45-111`` hold under a ``torch.Generator``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops import augment as jax_augment
from petastorm_tpu_torch.ops import augment

MIXUP_ATOL = 1e-6


def _images(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dtype)


def _jax_crop_offsets(key, b, padding):
    keys = jax.random.split(key, b)
    return np.array(jax.vmap(lambda k: jax.random.randint(k, (2,), 0, 2 * padding + 1))(keys))


def _jax_cutout_centres(key, b, h, w):
    keys = jax.random.split(key, b)

    def centre(k):
        return (jax.random.randint(k, (), 0, h),
                jax.random.randint(jax.random.fold_in(k, 1), (), 0, w))
    cy, cx = jax.vmap(centre)(keys)
    return np.stack([np.asarray(cy), np.asarray(cx)], axis=1)


@pytest.mark.parametrize("p", [0.5, 0.3, 1.0, 0.0])
def test_flip_equals_jax_given_its_draws(p):
    x = _images((6, 5, 7, 3))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_augment.random_flip_horizontal(key, jnp.asarray(x), p=p))
    flips = np.array(jax.random.bernoulli(key, p, (6,)))
    got = augment.apply_flip(torch.from_numpy(x), torch.from_numpy(flips)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", augment.PAD_MODES)
@pytest.mark.parametrize("padding", [0, 2, 4, 9])
def test_crop_equals_jax_given_its_draws(mode, padding):
    """Bit-equal for every pad mode, including a padding wider than the
    image (9 > 7), where reflect and symmetric wrap more than once."""
    x = _images((5, 6, 7, 3), seed=padding)
    key = jax.random.PRNGKey(11 + padding)
    want = np.asarray(jax_augment.random_crop(key, jnp.asarray(x), padding=padding, mode=mode))
    offsets = _jax_crop_offsets(key, 5, padding)
    got = augment.apply_crop(torch.from_numpy(x), torch.from_numpy(offsets), padding, mode)
    assert got.dtype == torch.uint8 and got.shape == x.shape and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_of_one_pixel_axes_matches_jnp_pad():
    x = _images((3, 1, 1, 2))
    for mode in augment.PAD_MODES:
        key = jax.random.PRNGKey(5)
        want = np.asarray(jax_augment.random_crop(key, jnp.asarray(x), padding=2, mode=mode))
        got = augment.apply_crop(torch.from_numpy(x),
                                 torch.from_numpy(_jax_crop_offsets(key, 3, 2)), 2, mode)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)


def test_crop_refuses_a_mode_it_does_not_implement():
    with pytest.raises(ValueError, match="mode"):
        augment.apply_crop(torch.zeros(1, 4, 4, 1, dtype=torch.uint8),
                           torch.zeros(1, 2, dtype=torch.int64), 1, "linear_ramp")


@pytest.mark.parametrize("size,fill,dtype", [(4, 0, np.uint8), (5, 17, np.uint8),
                                             (8, 0, np.float32), (3, -1.5, np.float32)])
def test_cutout_equals_jax_given_its_draws(size, fill, dtype):
    x = _images((6, 9, 11, 3), dtype=dtype, seed=size)
    key = jax.random.PRNGKey(size)
    want = np.asarray(jax_augment.cutout(key, jnp.asarray(x), size=size, fill=fill))
    centres = _jax_cutout_centres(key, 6, 9, 11)
    got = augment.apply_cutout(torch.from_numpy(x), torch.from_numpy(centres), size, fill)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("int_labels", [True, False])
def test_mixup_equals_jax_given_its_draws(int_labels):
    x = _images((5, 4, 4, 3), dtype=np.float32)
    key = jax.random.PRNGKey(9)
    if int_labels:
        labels = np.array([0, 2, 1, 2, 0], np.int32)
        kw = dict(num_classes=3)
    else:
        labels = np.eye(3, dtype=np.float32)[[0, 2, 1, 2, 0]] * 0.9 + 0.1 / 3
        kw = {}
    want_x, want_y = jax_augment.mixup(key, jnp.asarray(x), jnp.asarray(labels), alpha=0.4, **kw)
    lam = jax.random.beta(key, 0.4, 0.4, (5,))
    lam = np.array(jnp.maximum(lam, 1.0 - lam))
    got_x, got_y = augment.apply_mixup(torch.from_numpy(x), torch.from_numpy(labels),
                                       torch.from_numpy(lam), **kw)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=MIXUP_ATOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=MIXUP_ATOL)


# ------------------------------------------ properties under a torch.Generator
def test_random_flip_horizontal_flips_some():
    imgs = torch.arange(4 * 2 * 3 * 1, dtype=torch.float32).reshape(4, 2, 3, 1)
    out = augment.random_flip_horizontal(augment.seeded_generator(0, "cpu"), imgs)
    flipped = imgs.flip(2)
    assert all(torch.equal(out[i], flipped[i]) or torch.equal(out[i], imgs[i])
               for i in range(4))
    assert torch.equal(augment.random_flip_horizontal(augment.seeded_generator(1, "cpu"),
                                                      imgs, p=1.0), flipped)
    assert torch.equal(augment.random_flip_horizontal(augment.seeded_generator(1, "cpu"),
                                                      imgs, p=0.0), imgs)
    many = augment.draw_flips(augment.seeded_generator(2, "cpu"), 4000)
    assert 0.45 < many.float().mean().item() < 0.55


def test_random_crop_shape_content_and_determinism():
    imgs = torch.full((3, 8, 8, 2), 7, dtype=torch.uint8)
    out = augment.random_crop(augment.seeded_generator(0, "cpu"), imgs, padding=2)
    assert out.shape == imgs.shape and out.dtype == imgs.dtype
    assert set(torch.unique(out).tolist()) <= {0, 7}
    again = augment.random_crop(augment.seeded_generator(0, "cpu"), imgs, padding=2)
    assert torch.equal(out, again)
    offsets = augment.draw_crop_offsets(augment.seeded_generator(3, "cpu"), 2000, padding=4)
    assert offsets.min().item() == 0 and offsets.max().item() == 8


def test_cutout_masks_expected_area():
    imgs = torch.ones((2, 16, 16, 3), dtype=torch.float32)
    out = augment.cutout(augment.seeded_generator(3, "cpu"), imgs, size=4)
    zeros_per_sample = (out == 0).all(dim=-1).sum(dim=(1, 2))
    assert (zeros_per_sample > 0).all() and (zeros_per_sample <= 16).all()


def test_mixup_mixes_images_and_labels():
    imgs = torch.stack([torch.zeros((4, 4, 1)), torch.ones((4, 4, 1))])
    labels = torch.tensor([0, 1], dtype=torch.int32)
    mixed, soft = augment.mixup(augment.seeded_generator(0, "cpu"), imgs, labels, alpha=0.4,
                                num_classes=2)
    assert mixed.shape == imgs.shape and soft.shape == (2, 2)
    torch.testing.assert_close(soft.sum(dim=1), torch.ones(2), rtol=1e-5, atol=0)
    assert mixed[0].mean().item() <= 0.5 and mixed[1].mean().item() >= 0.5
    with pytest.raises(ValueError):
        augment.mixup(augment.seeded_generator(0, "cpu"), imgs, labels)
    with pytest.raises(ValueError):
        augment.mixup(augment.seeded_generator(0, "cpu"), imgs.to(torch.uint8), labels,
                      num_classes=2)
    lam = augment.draw_mixup_lam(augment.seeded_generator(4, "cpu"), 5000, alpha=0.2)
    assert lam.dtype == torch.float32 and (lam >= 0.5).all() and (lam <= 1).all()


def test_seeded_generator_keys_streams():
    def draw(key):
        return torch.rand(8, generator=augment.seeded_generator(key, "cpu"))
    assert torch.equal(draw((0, 3)), draw((0, 3)))
    assert not torch.equal(draw((0, 3)), draw((0, 4)))
    assert not torch.equal(draw((0, 3)), draw((3, 0)))
