"""Tests of petastorm_tpu_torch that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama, resnet
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, STRIDED_KERNEL_NAME,
                                               normalize_images, normalize_images_plain)
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


def _strided_cases():
    """(name, function of a contiguous (4, 256, 256, 3) uint8 batch on the
    card, channels) for the general route."""
    return [
        ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3),
        ("transpose(1, 2)", lambda x: x.transpose(1, 2), 3),
        ("NCHW and back through a view",
         lambda x: x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), 3),
        ("C = 1, cropped", lambda x: x[..., :1].contiguous()[:, 3:250, 5:200], 1),
        ("C = 5", lambda x: x.reshape(-1)[:4 * 64 * 64 * 5].view(4, 64, 64, 5), 5),
        ("zero-size crop", lambda x: x[:, 5:5], 3),
    ]


@pytest.mark.parametrize("case", range(len(_strided_cases())),
                         ids=[c[0] for c in _strided_cases()])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_kernel_reads_non_contiguous_and_wide_channels(cuda_device, case, dtype):
    """Every layout and channel count that is not a contiguous batch of at
    most 4 channels goes through the general route, bit-equal to the plain
    version, into a contiguous output of the input's shape; a zero-size
    input launches nothing."""
    name, view, channels = _strided_cases()[case]
    x = view(torch.from_numpy(np.random.default_rng(case).integers(
        0, 256, (4, 256, 256, 3), dtype=np.uint8)).to(cuda_device))
    mean, std = (0.4, 0.5, 0.6, 0.7, 0.45)[:channels], (0.2, 0.25, 0.3, 0.35, 0.3)[:channels]
    kernels.reset_launch_counts()
    got = normalize_images(x, mean, std, out_dtype=dtype)
    assert kernels.launch_counts == ({STRIDED_KERNEL_NAME: 1} if x.numel() else {}), name
    want = normalize_images_plain(x, mean, std, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == x.shape and got.dtype == dtype
    bits = torch.int16 if dtype != torch.float32 else torch.int32
    assert torch.equal(got.view(bits), want.contiguous().view(bits)), name


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


def _fwd_name(dtype, d):
    """Launch-count name of K2 on the route inputs of ``dtype`` and head
    dim ``d`` take."""
    return flash_attn._FWD_KERNELS[flash_attn.fwd_route(dtype, d)]


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
    assert kernels.launch_counts == {_fwd_name(dtype, d): 1}
    o_out = flash_attn.flash_attention(q, k, v, causal=causal)
    assert kernels.launch_counts == {_fwd_name(dtype, d): 2}
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
    d = llama.TINY.dim // llama.TINY.n_heads
    assert kernels.launch_counts == {_fwd_name(torch.bfloat16, d): 4 * llama.TINY.n_layers,
                                     _fwd_name(torch.float32, d): 4 * llama.TINY.n_layers}
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
    assert kernels.launch_counts == {_fwd_name(torch.float32, 64): 1,
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
        _fwd_name(dtype, cfg.head_dim), *_bwd_names(dtype, cfg.head_dim))}
    host_losses, on_host = run("cpu")
    assert card_losses == pytest.approx(host_losses, abs=loss_bar)
    lr = 3e-4
    for a, b in zip(llama.param_leaves(card), llama.param_leaves(on_host)):
        diff = (a.detach().cpu() - b.detach()).abs()
        if dtype == torch.float32:
            assert diff.max() <= 2 * lr
        else:   # see tests/test_torch_train.py for the bfloat16 AdamW bars
            assert diff.max() <= 4 * lr and (diff <= 0.1 * lr).float().mean() >= 0.9


@pytest.mark.parametrize("b,sq,sk,h,kv_h,d,causal,dtype,fused", [
    (1, 100, 100, 4, 2, 64, True, torch.bfloat16, False),     # ragged, GQA
    (2, 96, 64, 4, 2, 64, True, torch.bfloat16, False),       # causal sq > sk
    (2, 40, 130, 4, 1, 128, True, torch.bfloat16, False),     # causal sq < sk
    (2, 77, 130, 4, 1, 64, False, torch.float16, False),      # non-causal, ragged both
    (2, 200, 200, 4, 4, 128, True, torch.bfloat16, False),    # MHA
    (2, 150, 150, 8, 4, 128, False, torch.float16, False),
    (1, 300, 300, 4, 2, 128, True, torch.float16, False),
    (1, 963, 963, 8, 2, 128, True, torch.bfloat16, False),    # not a multiple of 64
    (1, 300, 300, 4, 2, 72, True, torch.bfloat16, False),     # d padded to 128
    (2, 256, 256, 8, 2, 128, True, torch.bfloat16, True),     # fused qkv views
    (2, 130, 130, 4, 2, 64, False, torch.float16, True),
])
def test_flash_tc_forward_matches_plain_on_card(cuda_device, b, sq, sk, h, kv_h, d, causal,
                                                dtype, fused):
    """The tensor-core K2 in "out" and "lse" mode against the plain version,
    each call one launch of the tensor-core route; fused qkv views are read
    in place."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq * sk + d + 3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    if fused:
        qkv = randn(b, sq, h + 2 * kv_h, d)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv_h], qkv[:, :, h + kv_h:]
        assert all(flash_attn._tma_ready(t) for t in (q, k, v))
    else:
        q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
    assert flash_attn.fwd_route(dtype, d) == flash_attn.TENSOR_CORES
    kernels.reset_launch_counts()
    o, lse = flash_attn.flash_attention_lse(q, k, v, causal=causal)
    o_out = flash_attn.flash_attention(q, k, v, causal=causal)
    assert kernels.launch_counts == {flash_attn.KERNEL_NAME: 2}
    want_o, want_lse = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (b, h, sq, 1)
    assert torch.equal(o, o_out)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=_FLASH_BARS[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype,d,forced", [
    (torch.float32, 64, False), (torch.bfloat16, 256, False), (torch.float16, 60, False),
    (torch.bfloat16, 128, True)])
def test_flash_fma_forward_route_on_card(cuda_device, dtype, d, forced):
    """f32, d > 128 and d % 8 != 0 take the FMA K2; forced at bf16 d 128 it
    gives the plain version's output too."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 5)
    q, k, v = (torch.randn(2, 150, s, d, generator=gen, device=cuda_device).to(dtype)
               for s in (4, 2, 2))
    kernels.reset_launch_counts()
    if forced:
        o, lse = flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, True)
    else:
        assert flash_attn.fwd_route(dtype, d) == flash_attn.FMA
        o, lse = flash_attn.flash_attention_lse(q, k, v, causal=True)
    assert kernels.launch_counts == {flash_attn.FMA_KERNEL_NAME: 1}
    want_o, want_lse = flash_attn.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=_FLASH_BARS[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float16, 64),
                                     (torch.float32, 64)])
def test_flash_forward_gives_equal_bits_over_launches(cuda_device, dtype, d):
    """Each block owns its rows and sums in a fixed order: every launch of
    either route gives the same bits, also with other work queued between."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    q, k, v = (torch.randn(2, 1000, s, d, generator=gen, device=cuda_device).to(dtype)
               for s in (8, 2, 2))
    first = flash_attn.flash_attention_lse(q, k, v, causal=True)
    for _ in range(3):
        torch.randn(4096, 4096, device=cuda_device).square_()
        again = flash_attn.flash_attention_lse(q, k, v, causal=True)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("shape,dtype,offset", [((5, 33, 31, 3), torch.bfloat16, 1),
                                                ((5, 33, 31, 3), torch.float32, 7),
                                                ((3, 17, 19, 3), torch.float16, 0),
                                                ((1, 1, 5, 3), torch.bfloat16, 3),
                                                ((7, 13, 11, 2), torch.bfloat16, 0),
                                                ((8, 224, 224, 3), torch.bfloat16, 5)])
def test_normalize_kernel_bit_equal_at_odd_lengths_and_misaligned_views(cuda_device, shape, dtype,
                                                                       offset):
    """K1 on a contiguous view at an odd offset (not 16-byte aligned) and at
    lengths that are not whole 16-byte vectors: bit-equal to the plain
    version, one launch."""
    n = int(np.prod(shape))
    flat = torch.from_numpy(np.random.default_rng(offset).integers(0, 256, n + offset,
                                                                    dtype=np.uint8))
    x = flat.to(cuda_device)[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == (offset % 16 != 0)
    mean, std = (0.4, 0.5, 0.6, 0.7), (0.2, 0.25, 0.3, 0.35)
    kernels.reset_launch_counts()
    got = normalize_images(x, mean, std, out_dtype=dtype)
    assert kernels.launch_counts == {KERNEL_NAME: 1}
    want = normalize_images_plain(x, mean, std, out_dtype=dtype)
    bits = torch.int16 if dtype != torch.float32 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def test_small_resnet_on_card_matches_cpu(cuda_device, monkeypatch):
    """A small ResNet (every kind of block) in float32 with TF32 off: the
    forward in both modes and two SGD steps on the card against the CPU
    from the same weights and batches, within 1e-4 of each tensor's
    largest value (the CPU parity tests' bar against the reference)."""
    monkeypatch.setattr(resnet, "_RESNET50_STAGES", ((1, 8), (2, 8), (1, 16), (1, 16)))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    f32_apply = functools.partial(resnet.apply, compute_dtype=torch.float32)
    monkeypatch.setattr(resnet, "apply", f32_apply)
    host = resnet.init_params(torch.Generator().manual_seed(0), 10, device="cpu")
    rng = np.random.default_rng(0)
    batches = [{"image": torch.from_numpy(rng.random((4, 40, 40, 3)).astype(np.float32)),
                "label": torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32))}
               for _ in range(2)]

    def rel(a, b):
        return ((a.detach().cpu() - b.detach()).abs().max() / b.detach().abs().max()).item()

    def copy(device):
        return _tree_map(lambda t: t.to(device, copy=True), host)

    for train in (False, True):
        card, _ = f32_apply(copy(cuda_device), batches[0]["image"].to(cuda_device), train=train)
        want, _ = f32_apply(copy("cpu"), batches[0]["image"], train=train)
        assert rel(card, want) <= 1e-4

    def run(device):
        params = copy(device)
        init_opt, step = resnet.make_train_step()
        opt = init_opt(params)
        losses = []
        for b in batches:
            params, opt, loss, _ = step(params, opt, {k: v.to(device) for k, v in b.items()})
            losses.append(loss.item())
        return losses, params

    card_losses, card = run(cuda_device)
    host_losses, on_host = run("cpu")
    assert card_losses == pytest.approx(host_losses, rel=1e-4)
    for a, b in zip(resnet.param_leaves(card), resnet.param_leaves(on_host)):
        assert rel(a, b) <= 1e-4


def _tree_map(fn, node):
    """``fn`` over every tensor of a tree of dicts and lists."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def _stats_case(cuda_device, b, sq, sk, h, kv_h, d, dtype, seed):
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=gen, device=cuda_device).to(dtype)
                 for s, n in ((sq, h), (sk, kv_h), (sk, kv_h)))


def _stats_within_bars(got, want, dtype):
    """o (float32, but p is rounded to the inputs' dtype) by the row-scaled
    bars of that dtype; m and l (float32) within 2e-5 and 2e-5 relative."""
    eps, worst_bar, rms_bar = {torch.bfloat16: (2 ** -7, 2 ** -5, 2 ** -7),
                               torch.float16: (2 ** -10, 2 ** -8, 2 ** -10),
                               torch.float32: (2 ** -23, 2 ** -16, 2 ** -18)}[dtype]
    o, w = got[0], want[0]
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    err = (o - w).abs()
    return (((err - eps * w.abs()) / row).max().item() <= worst_bar
            and (err / row).square().mean().sqrt().item() <= rms_bar
            and (got[1] - want[1]).abs().max().item() <= 2e-5
            and ((got[2] - want[2]).abs() / want[2]).max().item() <= 2e-5)


@pytest.mark.parametrize("route", [flash_attn.TENSOR_CORES, flash_attn.FMA])
@pytest.mark.parametrize("b,sq,sk,h,kv_h,d,causal,dtype", [
    (1, 1024, 1024, 8, 2, 128, True, torch.bfloat16),
    (2, 300, 500, 8, 1, 64, False, torch.bfloat16),
    (1, 200, 200, 4, 2, 64, True, torch.float16),
])
def test_flash_stats_kernel_matches_plain_on_card(cuda_device, route, b, sq, sk, h, kv_h, d,
                                                  causal, dtype):
    q, k, v = _stats_case(cuda_device, b, sq, sk, h, kv_h, d, dtype, seed=sq + d)
    want = flash_attn._stats_plain(q, k, v, causal)
    kernels.reset_launch_counts()
    if route == flash_attn.fwd_route(dtype, d):   # the public entry point takes it
        o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=causal)
        got = (o, m.transpose(1, 2), l.transpose(1, 2))
    else:
        got = flash_attn._flash_stats_fwd(route, q, k, v, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {flash_attn._STATS_KERNELS[route]: 1}
    assert got[0].dtype == torch.float32 and got[0].shape == q.shape
    assert _stats_within_bars(got, want, dtype)
    # A wrong normaliser (1 % off) and a wrong max (left in units of log2)
    # fail the same bars.
    assert not _stats_within_bars((want[0], want[1], want[2] * 1.01), want, dtype)
    assert not _stats_within_bars((want[0], want[1] / float(np.log(2.0)), want[2]), want, dtype)


def test_flash_stats_f32_takes_the_fma_route_on_card(cuda_device):
    q, k, v = _stats_case(cuda_device, 2, 150, 150, 8, 2, 64, torch.float32, seed=3)
    kernels.reset_launch_counts()
    o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=True)
    assert kernels.launch_counts == {flash_attn.STATS_FMA_KERNEL_NAME: 1}
    assert _stats_within_bars((o, m.transpose(1, 2), l.transpose(1, 2)),
                              flash_attn._stats_plain(q, k, v, True), torch.float32)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_attention_runs_its_kernels_on_card(cuda_device, strategy):
    """Two ranks on the card: the output stays on the card, the ring
    launches K2 "stats" (rank r: r + 1 blocks) and Ulysses K2 "lse", both
    K3 and K4 in the backward; output and gradients against one process's
    flash attention on the whole sequence (bf16: the flash bar 3e-2 on the
    output, 4 % on each gradient's norm)."""
    import torch_seq_ranks
    from petastorm_tpu_torch.parallel.launch import run_ranks
    seq = 1024
    ranks = run_ranks(torch_seq_ranks.card_attention, 2, args=(seq, strategy), device="cuda",
                      timeout_s=300)
    q, k, v, do = (t.clone() for t in torch_seq_ranks.card_inputs(seq))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = flash_attn.flash_attention(q, k, v, causal=True)
    want.backward(do)
    if strategy == "ring":
        want_counts = [{flash_attn.STATS_KERNEL_NAME: r + 1, flash_attn.BWD_DQ_KERNEL_NAME: r + 1,
                        flash_attn.BWD_DKV_KERNEL_NAME: r + 1} for r in range(2)]
    else:
        want_counts = [{flash_attn.KERNEL_NAME: 1, flash_attn.BWD_DQ_KERNEL_NAME: 1,
                        flash_attn.BWD_DKV_KERNEL_NAME: 1}] * 2
    assert [r[4] for r in ranks] == want_counts
    assert all(r[5] == "cuda" for r in ranks)
    got = [torch.cat([r[i] for r in ranks], dim=1) for i in range(4)]
    torch.testing.assert_close(got[0].float(), want.detach().cpu().float(), rtol=0, atol=3e-2)
    for g, w in zip(got[1:], (q.grad, k.grad, v.grad)):
        w = w.cpu().float()
        assert ((g.float() - w).norm() / w.norm()).item() < 0.04
