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
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import flash_attn
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


#: Kernel vs plain version: the JAX package's flash bars (f32 2e-5, bf16
#: 3e-2), f16 3e-2 / 8 rounded up (3 more mantissa bits than bf16), lse 2e-5.
_FLASH_BARS = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 4e-3}


@pytest.mark.parametrize("b,sq,sk,h,kv_h,d,causal,dtype", [
    (2, 256, 256, 8, 2, 128, True, torch.bfloat16),
    (1, 100, 100, 4, 2, 64, True, torch.bfloat16),
    (2, 96, 64, 4, 2, 64, True, torch.float32),
    (2, 77, 130, 4, 1, 64, False, torch.float32),
    (1, 130, 130, 4, 4, 32, True, torch.float16),
    (1, 70, 90, 2, 1, 256, False, torch.bfloat16),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, b, sq, sk, h, kv_h, d, causal, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(sq * sk + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
    kernels.reset_launch_counts()
    o, lse = flash_attn.flash_attention_lse(q, k, v, causal=causal)
    assert kernels.launch_counts[flash_attn.KERNEL_NAME] == 1
    o_out = flash_attn.flash_attention(q, k, v, causal=causal)
    assert kernels.launch_counts[flash_attn.KERNEL_NAME] == 2
    want_o, want_lse = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == (b, sq, h, d) and lse.shape == (b, h, sq, 1)
    assert torch.equal(o, o_out)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=_FLASH_BARS[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


def test_flash_kernel_long_rows_on_card(cuda_device):
    """A row that sees n keys has outputs of about sqrt(e / n), 0.04 at
    n = 2048: held to the bars scaled to each output row. Each element
    within one bf16 spacing of its value plus 2**-5 of its row's rms, and
    the rms of the row-scaled error within 2**-7."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = randn(1, 2048, 8, 128), randn(1, 2048, 2, 128), randn(1, 2048, 2, 128)
    want = flash_attn.flash_attention_plain(q, k, v, causal=True)[0].float()
    err = (flash_attn.flash_attention(q, k, v, causal=True).float() - want).abs()
    row = want.square().mean(-1, keepdim=True).sqrt()
    assert ((err - 2 ** -7 * want.abs()) / row).max().item() <= 2 ** -5
    assert (err / row).square().mean().sqrt().item() <= 2 ** -7


def test_flash_kernel_reads_strided_views(cuda_device):
    """q sliced out of a fused qkv projection: strided heads, no copy."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 128, 4 + 2 + 2, 64, generator=gen, device=cuda_device)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = flash_attn.flash_attention(q, k, v, causal=True)
    want, _ = flash_attn.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_flash_kernel_raises_on_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        flash_attn.flash_attention(q, kv[:, :, :1].expand(1, 8, 3, 64), kv[:, :, :1].expand(1, 8, 3, 64))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 8, 4, 320, device=cuda_device, dtype=torch.bfloat16)
        flash_attn.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="dtype"):
        flash_attn.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="devices"):
        flash_attn.flash_attention(q, kv.cpu(), kv.cpu())


def test_token_slice_on_card(cuda_device, tmp_path):
    """Token store -> dense NGram reader -> DataLoader(cuda) -> Llama loss
    with the kernel, against the same chain on the CPU (plain attention):
    identical tokens, loss within 5e-3 in bf16 and 1e-4 in f32."""
    url = f"file://{tmp_path}/tokens"
    write_token_store(url, windows=8, window=64, vocab=llama.TINY.vocab, seed=0)
    ngram = NGram({o: ["ts", "token"] for o in range(64)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    params = llama.init_params(torch.Generator().manual_seed(0), llama.TINY, device="cpu")

    def run(device):
        p = {"embed": params["embed"].to(device), "norm_out": params["norm_out"].to(device),
             "lm_head": params["lm_head"].to(device),
             "layers": [{k: t.to(device) for k, t in layer.items()} for layer in params["layers"]]}
        out = []
        with make_reader(url, schema_fields=ngram, seed=0, workers_count=2) as reader:
            for batch in DataLoader(reader, batch_size=2, device=device):
                losses = [llama.loss_fn(p, {"tokens": batch["token"]}, llama.TINY,
                                        attn_fn=flash_attn.make_flash_attention(causal=True),
                                        compute_dtype=dt, shift="roll").item()
                          for dt in (torch.bfloat16, torch.float32)]
                out.append((batch["token"].cpu(), losses))
        return out

    kernels.reset_launch_counts()
    on_card = run(cuda_device)
    assert kernels.launch_counts[flash_attn.KERNEL_NAME] == 4 * 2 * llama.TINY.n_layers
    on_host = run("cpu")
    assert len(on_card) == len(on_host) == 4
    for (tok_c, (bf16_c, f32_c)), (tok_h, (bf16_h, f32_h)) in zip(on_card, on_host):
        assert torch.equal(tok_c, tok_h)
        assert abs(bf16_c - bf16_h) <= 5e-3 and abs(f32_c - f32_h) <= 1e-4
