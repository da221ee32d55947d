"""petastorm_tpu_torch.ops.image_ops against the JAX package's normalize_images.

Inputs come from a seeded numpy generator and go through both packages.
Tolerances: float32 outputs agree to atol=1e-6; bf16 outputs within one
bf16 ulp, because XLA may fuse ``x*scale + bias`` into one FMA (one
rounding) where eager PyTorch rounds the product and the sum separately.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.image_ops import normalize_images as jax_normalize
from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, normalize_factors,
                                               normalize_images,
                                               normalize_images_plain)

CUSTOM = ((0.5, 0.25, 0.125), (0.2, 0.3, 0.4))
DEFAULT = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _ordered_bits16(a: np.ndarray) -> np.ndarray:
    i = a.view(np.int16).astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


def assert_matches_jax(port: torch.Tensor, ref, dtype_name: str):
    ref = np.asarray(ref.astype(jnp.float32)) if dtype_name == "bfloat16" else np.asarray(ref)
    if dtype_name == "float32":
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
        return
    ref_bits = _ordered_bits16(torch.from_numpy(np.array(ref)).to(torch.bfloat16).view(torch.int16).numpy())
    port_bits = _ordered_bits16(port.view(torch.int16).numpy())
    assert np.abs(port_bits - ref_bits).max() <= 1


def _images(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_plain_matches_pallas_interpret_at_tiled_shape(dtype_name):
    imgs = _images((8, 224, 224, 3), 1)
    ref = jax_normalize(jnp.asarray(imgs), out_dtype=getattr(jnp, dtype_name), use_pallas=True)
    port = normalize_images(torch.from_numpy(imgs), out_dtype=getattr(torch, dtype_name))
    assert port.shape == imgs.shape and port.dtype == getattr(torch, dtype_name)
    assert_matches_jax(port, ref, dtype_name)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 5, 5, 3), (3, 4, 6, 1)])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("mean_std", [DEFAULT, CUSTOM], ids=["imagenet", "custom"])
def test_plain_matches_xla_path(shape, dtype_name, mean_std):
    imgs = _images(shape, sum(shape))
    mean, std = mean_std
    ref = jax_normalize(jnp.asarray(imgs), mean=mean, std=std,
                        out_dtype=getattr(jnp, dtype_name), use_pallas=False)
    port = normalize_images(torch.from_numpy(imgs), mean=mean, std=std,
                            out_dtype=getattr(torch, dtype_name))
    assert_matches_jax(port, ref, dtype_name)


def test_factors_are_float32_like_jax():
    scale, bias = normalize_factors(3, *DEFAULT)
    assert scale.dtype == bias.dtype == torch.float32
    mean = np.asarray(DEFAULT[0], np.float32)
    std = np.asarray(DEFAULT[1], np.float32)
    np.testing.assert_array_equal(scale.numpy(), np.float32(1.0) / (np.float32(255.0) * std))
    np.testing.assert_array_equal(bias.numpy(), -mean / std)


def test_cpu_tensor_takes_plain_version_without_counting_a_launch():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_images((2, 4, 4, 3), 3))
    torch.testing.assert_close(normalize_images(x), normalize_images_plain(x), rtol=0, atol=0)
    assert kernels.launch_counts.get(KERNEL_NAME, 0) == 0


@pytest.mark.parametrize("bad", [
    dict(images=torch.zeros(2, 4, 4, 3, dtype=torch.float32), exc=TypeError),
    dict(images=torch.zeros(2, 4, 4, 3, dtype=torch.uint8), out_dtype=torch.int32, exc=TypeError),
    dict(images=torch.zeros(2, 4, 4, 3, dtype=torch.uint8), mean=(0.5,), exc=ValueError),
])
def test_wrapper_rejects_bad_input(bad):
    bad = dict(bad)
    exc = bad.pop("exc")
    with pytest.raises(exc):
        normalize_images(**bad)


def test_missing_nvcc_raises(monkeypatch):
    from petastorm_tpu_torch.kernels import build
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_is_named_after_source_hash(monkeypatch, tmp_path):
    from petastorm_tpu_torch.kernels import build
    (tmp_path / "k.cu").write_text("// one")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two")
    second = build.library_path("k")
    assert first != second and first.parent == build.BUILD_DIR
    assert first.name.startswith("k-") and first.suffix == ".so"
