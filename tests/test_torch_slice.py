"""The whole slice — store -> make_reader -> DataLoader -> normalize_images —
of petastorm_tpu_torch against the JAX package's chain, at 32x32x3 JPEG
images and batch 8.

Staged uint8 bytes must be identical; normalised bf16 outputs within one
bf16 ulp (XLA may fuse the multiply-add into one rounding, eager PyTorch
rounds twice).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.writer import materialize_dataset_local as jax_materialize
from petastorm_tpu.jax.loader import DataLoader as JaxDataLoader
from petastorm_tpu.ops.image_ops import normalize_images as jax_normalize
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import DataLoader, make_reader, normalize_images
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS, SHAPE, BATCH = 40, (32, 32, 3), 8


def _images(seed):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 180, SHAPE[1], dtype=np.float32)[None, :, None]
    return [(ramp + rng.integers(0, 60, SHAPE)).astype(np.uint8) for _ in range(ROWS)]


@pytest.fixture(scope="module", params=["jax_writer", "port_writer"])
def store(request, tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('slice')}/ds"
    if request.param == "jax_writer":
        schema = JaxUnischema("Slice", [
            JaxField("id", np.int64, (), JaxScalarCodec(np.int64), False),
            JaxField("image", np.uint8, SHAPE, JaxImageCodec("jpeg", 90), False)])
        writer = jax_materialize
    else:
        schema = Unischema("Slice", [
            UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
            UnischemaField("image", np.uint8, SHAPE, CompressedImageCodec("jpeg", 90), False)])
        writer = materialize_dataset_local
    with writer(url, schema, rows_per_row_group=8) as w:
        for i, img in enumerate(_images(3)):
            w.write_row({"id": i, "image": img})
    return url


def _ordered_bits16(a: np.ndarray) -> np.ndarray:
    i = a.view(np.int16).astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


@pytest.mark.parametrize("reader_kwargs,loader_kwargs", [
    (dict(reader_pool_type="dummy", shuffle_row_groups=False), {}),
    (dict(reader_pool_type="thread", workers_count=2, seed=21, shuffle_rows=True, num_epochs=2),
     dict(shuffling_queue_capacity=12, seed=8)),
], ids=["ordered", "shuffled_two_epochs"])
def test_slice_matches_jax_chain(store, reader_kwargs, loader_kwargs):
    with make_reader(store, **reader_kwargs) as reader:
        port = [(b["id"], b["image"], normalize_images(b["image"]))
                for b in DataLoader(reader, batch_size=BATCH, device="cpu", **loader_kwargs)]
    with jax_make_reader(store, **reader_kwargs) as reader:
        ref = [(np.asarray(b["id"]), np.asarray(b["image"]), jax_normalize(b["image"]))
               for b in JaxDataLoader(reader, batch_size=BATCH, **loader_kwargs)]
    assert len(port) == len(ref) == ROWS * reader_kwargs.get("num_epochs", 1) // BATCH
    for (ids, imgs, normed), (ref_ids, ref_imgs, ref_normed) in zip(port, ref):
        np.testing.assert_array_equal(ids.numpy(), ref_ids)
        assert imgs.dtype == torch.uint8 and imgs.shape == (BATCH,) + SHAPE
        assert imgs.numpy().tobytes() == ref_imgs.tobytes()
        assert normed.dtype == torch.bfloat16
        ref_bits = torch.from_numpy(np.array(ref_normed.astype(jnp.float32))) \
            .to(torch.bfloat16).view(torch.int16).numpy()
        diff = np.abs(_ordered_bits16(normed.view(torch.int16).numpy()) - _ordered_bits16(ref_bits))
        assert diff.max() <= 1
