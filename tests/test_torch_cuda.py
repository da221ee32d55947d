"""Tests of petastorm_tpu_torch that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, normalize_images,
                                               normalize_images_plain)
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ordered_bits16(t: torch.Tensor) -> torch.Tensor:
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


@pytest.mark.parametrize("shape,dtype", [((8, 224, 224, 3), torch.bfloat16),
                                         ((3, 17, 19, 3), torch.float32),
                                         ((4, 9, 7, 1), torch.float16),
                                         ((2, 5, 5, 4), torch.bfloat16)])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    """f32 within 1e-6; 16-bit outputs within 1 ulp. The means cancel
    against x/255 for some pixels (0.4 = 102/255), where a fused
    multiply-add would differ; the kernel rounds like the plain version."""
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8))
    x = x.to(cuda_device)
    mean, std = (0.4, 0.5, 0.6, 0.7), (0.2, 0.25, 0.3, 0.35)
    kernels.reset_launch_counts()
    got = normalize_images(x, mean, std, out_dtype=dtype)
    want = normalize_images_plain(x, mean, std, out_dtype=dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts[KERNEL_NAME] == 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    else:
        assert (_ordered_bits16(got) - _ordered_bits16(want)).abs().max().item() <= 1


def test_kernel_rejects_non_contiguous_and_wide_channels(cuda_device):
    x = torch.zeros(2, 6, 6, 3, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        normalize_images(x.transpose(1, 2))
    with pytest.raises(ValueError, match="channels"):
        normalize_images(torch.zeros(2, 6, 6, 5, dtype=torch.uint8, device=cuda_device),
                         mean=(0.5,) * 5, std=(0.5,) * 5)


def test_cuda_staging_bytes_equal_cpu_staging(cuda_device, tmp_path):
    url = f"file://{tmp_path}/ds"
    schema = Unischema("S", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("image", np.uint8, (16, 16, 3), CompressedImageCodec("png"), False),
        UnischemaField("m", np.float32, (3, 2), NdarrayCodec(), False)])
    rng = np.random.default_rng(0)
    with materialize_dataset_local(url, schema, rows_per_row_group=5) as w:
        for i in range(37):
            w.write_row({"id": i, "image": rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                         "m": rng.normal(size=(3, 2)).astype(np.float32)})

    def batches(device):
        with make_reader(url, reader_pool_type="dummy", seed=3, shuffle_rows=True) as reader:
            return list(DataLoader(reader, batch_size=4, prefetch=1, pad_last=True,
                                   device=device))

    on_card, on_host = batches(cuda_device), batches("cpu")
    assert len(on_card) == len(on_host) == 10
    for c, h in zip(on_card, on_host):
        assert set(c) == set(h)
        for name, t in h.items():
            assert c[name].is_cuda
            assert torch.equal(c[name].cpu(), t)
