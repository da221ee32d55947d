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


#: Backward kernels vs the plain backward: the JAX package's gradient bar in
#: float32 (2e-4), its flash bar in bfloat16 (3e-2), and f16 3e-2 / 8 rounded up.
_BWD_BARS = {torch.float32: 2e-4, torch.bfloat16: 3e-2, torch.float16: 4e-3}


def _bwd_names(dtype, d):
    """Launch-count names of K3 and K4 on the route inputs of ``dtype`` and
    head dim ``d`` take."""
    if flash_attn.bwd_route(dtype, d) == flash_attn.TENSOR_CORES:
        return flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME
    return flash_attn.BWD_DQ_FMA_KERNEL_NAME, flash_attn.BWD_DKV_FMA_KERNEL_NAME


def _bwd_case(device, b, sq, sk, h, kv_h, d, causal, dtype, seed, fused=False):
    """Seeded q, k, v, dO (with ``fused``, q, k, v are views of one
    (b, s, h + 2 kv_h, d) tensor) and the forward's o, lse."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    if fused:
        qkv = randn(b, sq, h + 2 * kv_h, d)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv_h], qkv[:, :, h + kv_h:]
    else:
        q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
    do = randn(b, sq, h, d)
    o, lse = flash_attn.flash_attention_lse(q, k, v, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("b,sq,sk,h,kv_h,d,causal,dtype", [
    (2, 256, 256, 8, 2, 128, True, torch.bfloat16),
    (1, 100, 100, 4, 2, 64, True, torch.bfloat16),
    (2, 96, 64, 4, 2, 64, True, torch.float32),
    (2, 40, 130, 4, 1, 64, True, torch.float32),
    (2, 77, 130, 4, 1, 64, False, torch.float32),
    (1, 130, 130, 4, 4, 32, True, torch.float16),
    (1, 70, 90, 2, 1, 256, False, torch.bfloat16),
    (1, 70, 70, 4, 1, 200, True, torch.float32),
    # The tensor-core route at the edges TMA changes (and d 60, on FMAs).
    (1, 963, 963, 8, 2, 128, True, torch.bfloat16),
    (2, 300, 200, 8, 2, 128, True, torch.bfloat16),
    (2, 200, 300, 8, 2, 128, True, torch.bfloat16),
    (2, 500, 500, 8, 8, 128, True, torch.bfloat16),
    (2, 500, 500, 8, 2, 128, True, torch.float16),
    (2, 500, 500, 8, 2, 64, True, torch.bfloat16),
    (1, 300, 300, 4, 2, 72, True, torch.bfloat16),
    (1, 300, 300, 4, 2, 32, False, torch.float16),
    (1, 130, 130, 4, 2, 60, True, torch.bfloat16),
])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, b, sq, sk, h, kv_h, d, causal, dtype):
    """K3 and K4 against the plain backward on the same (o, lse, dO); each
    launched once on the route its dtype and head dim take, and a second
    launch gives the same bits."""
    q, k, v, o, lse, do = _bwd_case(cuda_device, b, sq, sk, h, kv_h, d, causal, dtype,
                                    seed=sq * sk + d + 1)
    kernels.reset_launch_counts()
    got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert kernels.launch_counts == {name: 1 for name in _bwd_names(dtype, d)}
    again = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=_BWD_BARS[dtype])


def test_flash_bwd_kernels_read_fused_qkv_views_on_card(cuda_device):
    """q, k and v sliced out of one fused projection (strided heads): TMA
    reads them in place, and the gradients match the plain backward's."""
    q, k, v, o, lse, do = _bwd_case(cuda_device, 2, 256, 256, 8, 2, 128, True, torch.bfloat16,
                                    seed=11, fused=True)
    assert all(flash_attn._tma_ready(t) for t in (q, k, v))
    kernels.reset_launch_counts()
    got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert kernels.launch_counts == {flash_attn.BWD_DQ_KERNEL_NAME: 1,
                                     flash_attn.BWD_DKV_KERNEL_NAME: 1}
    want = flash_attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=_BWD_BARS[torch.bfloat16])


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float16, 64),
                                     (torch.float32, 64)])
def test_flash_bwd_kernels_give_equal_bits_over_launches(cuda_device, dtype, d):
    """No atomics on either route: every launch gives the same bits, also
    with other work queued between them."""
    q, k, v, o, lse, do = _bwd_case(cuda_device, 2, 1000, 1000, 8, 2, d, True, dtype, seed=21)
    first = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for _ in range(3):
        torch.randn(4096, 4096, device=cuda_device).square_()
        again = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_has_a_gradient_on_card(cuda_device):
    """The forward on a CUDA tensor that requires grad is recorded by
    autograd (the "lse" launch), and its backward launches K3 and K4 and
    gives the plain version's gradient."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, g = (torch.randn(2, 128, s, 64, generator=gen, device=cuda_device)
                  for s in (4, 2, 2, 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = flash_attn.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    out.backward(g)
    assert kernels.launch_counts == {flash_attn.KERNEL_NAME: 1,
                                     **{name: 1 for name in _bwd_names(torch.float32, 64)}}
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attn.FlashAttentionFunction.apply(*plain, True, flash_attn.flash_attention_plain,
                                            flash_attn.flash_attention_bwd_plain).backward(g)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype,loss_bar", [(torch.float32, 1e-4), (torch.bfloat16, 5e-3)])
def test_tiny_train_step_on_card_matches_cpu(cuda_device, dtype, loss_bar):
    """Two AdamW steps of TINY with flash attention on the card (kernels)
    and on the CPU (plain versions) from the same weights and batches."""
    cfg = llama.TINY
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32))
               for _ in range(2)]
    host = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def run(device):
        # Copies: the step updates its parameters in place.
        params = {k: ([{n: t.to(device, copy=True) for n, t in layer.items()} for layer in v]
                      if k == "layers" else v.to(device, copy=True)) for k, v in host.items()}
        init_opt, step = llama.make_train_step(cfg, attn_fn=flash_attn.make_flash_attention(),
                                               compute_dtype=dtype, shift="roll")
        opt = init_opt(params)
        losses = [float(step(params, opt, {"tokens": t.to(device)})[2]) for t in batches]
        return losses, params

    kernels.reset_launch_counts()
    card_losses, card = run(cuda_device)
    assert kernels.launch_counts == {name: 2 * cfg.n_layers for name in (
        flash_attn.KERNEL_NAME, *_bwd_names(dtype, cfg.head_dim))}
    host_losses, on_host = run("cpu")
    assert card_losses == pytest.approx(host_losses, abs=loss_bar)
    lr = 3e-4
    for a, b in zip(llama.param_leaves(card), llama.param_leaves(on_host)):
        diff = (a.detach().cpu() - b.detach()).abs()
        if dtype == torch.float32:
            assert diff.max() <= 2 * lr
        else:   # see tests/test_torch_train.py for the bfloat16 AdamW bars
            assert diff.max() <= 4 * lr and (diff <= 0.1 * lr).float().mean() >= 0.9
