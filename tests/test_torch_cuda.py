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
    # The dry run's per-rank shape (``entry.dryrun_multichip(4)``): d = 8 on
    # the tensor-core route, its tiles' columns 8-63 TMA's zero fill.
    (2, 32, 32, 4, 2, 8, True, torch.bfloat16),
    (2, 32, 32, 4, 2, 8, False, torch.bfloat16),
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
    # The dry run's ring-flash block at d = 8 (a diagonal and a past block).
    (2, 32, 32, 4, 2, 8, True, torch.bfloat16),
    (2, 32, 32, 4, 2, 8, False, torch.bfloat16),
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


def _image_store(tmp_path, rows=96):
    schema = Unischema("Img", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                               UnischemaField("image", np.uint8, (32, 40, 3),
                                              CompressedImageCodec("jpeg", 90), False)])
    url = f"file://{tmp_path}/img"
    rng = np.random.default_rng(12)
    with materialize_dataset_local(url, schema, rows_per_row_group=16) as w:
        for i in range(rows):
            w.write_row({"id": i, "image": rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)})
    return url


def test_process_path_batch_normalised_on_card_equals_the_thread_path(cuda_device, tmp_path):
    """The process pool's rows, staged and normalised by K1 on the card,
    are bit-equal to the thread pool's: one batch holds the whole store, in
    id order, so the two pools' delivery orders do not matter."""
    url = _image_store(tmp_path)

    def normalised(pool_type):
        with make_reader(url, reader_pool_type=pool_type, workers_count=2,
                         shuffle_row_groups=False) as reader:
            batch = next(iter(DataLoader(reader, batch_size=96, device=cuda_device)))
        order = torch.argsort(batch["id"])
        kernels.reset_launch_counts()
        out = normalize_images(batch["image"][order].contiguous())
        torch.cuda.synchronize()
        assert kernels.launch_counts == {KERNEL_NAME: 1}
        return batch["id"][order], out

    ids_p, got = normalised("process")
    ids_t, want = normalised("thread")
    assert torch.equal(ids_p, ids_t) and ids_p.tolist() == list(range(96))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_no_process_worker_holds_the_card(cuda_device, tmp_path):
    """While a process reader runs beside this process's CUDA context, no
    worker is on the card (``nvidia-smi`` and
    ``torch.cuda.list_gpu_processes()``, where pynvml is installed) and
    none maps libcuda."""
    import subprocess
    torch.zeros(1, device=cuda_device)      # this process holds a context
    url = _image_store(tmp_path)
    with make_reader(url, reader_pool_type="process", workers_count=2, num_epochs=None) as reader:
        next(reader)
        pids = reader.pool.worker_pids
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        listed = [int(w) for w in smi.split() if w.isdigit()]
        assert not set(listed) & set(pids) and len(listed) <= 1
        try:
            procs = torch.cuda.list_gpu_processes(cuda_device)
        except ModuleNotFoundError:   # pynvml is not installed
            procs = ""
        assert not any(f"process {pid:>10d}" in procs for pid in pids)
        for pid in pids:
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
            assert "libcuda" not in maps and "libtorch" not in maps


def _staged(loader_factory, reader_kwargs, url, device):
    """Every batch of a loader over ``make_batch_reader(url)``, on the host
    (CUDA tensors copied back)."""
    from petastorm_tpu_torch.reader import make_batch_reader
    with make_batch_reader(url, workers_count=2, **reader_kwargs) as reader:
        return [{k: v.cpu().numpy() for k, v in batch.items()}
                for batch in loader_factory(reader, device)]


def _assert_same_bytes(got, want, ordered):
    """Batch for batch, or (``ordered`` False: a process pool delivers in
    the order its workers finish) as rows sorted by ``id``."""
    if not ordered:
        got = [{k: np.concatenate([b[k] for b in got]) for k in got[0]}]
        want = [{k: np.concatenate([b[k] for b in want]) for k in want[0]}]
        for cols in (*got, *want):
            order = np.argsort(cols["id"], kind="stable")
            for k in cols:
                cols[k] = cols[k][order]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("pool_type", ["thread", "process"])
@pytest.mark.parametrize("loader", ["plain", "shuffled", "in memory"])
def test_batched_loaders_on_card_give_the_cpu_bytes(cuda_device, tmp_path, pool_type, loader):
    """BatchedDataLoader (plain and shuffled) and InMemBatchedDataLoader
    stage on the card exactly the bytes they give on the CPU."""
    from petastorm_tpu_torch.benchmark.scalar_bench import generate_tensor_dataset
    from petastorm_tpu_torch.loader import BatchedDataLoader, InMemBatchedDataLoader
    url = generate_tensor_dataset(f"file://{tmp_path}/tensor", rows=3000, files=2,
                                  row_group_size=256)

    def factory(reader, device):
        if loader == "in memory":
            return InMemBatchedDataLoader(reader, batch_size=200, num_epochs=2, seed=3,
                                          device=device)
        shuffle = dict(shuffling_queue_capacity=1024, seed=0) if loader == "shuffled" else {}
        return BatchedDataLoader(reader, batch_size=200, device=device, **shuffle)

    kwargs = dict(reader_pool_type=pool_type, seed=1, shuffle_rows=True)
    want = _staged(factory, kwargs, url, "cpu")
    got = _staged(factory, kwargs, url, cuda_device)
    _assert_same_bytes(got, want, ordered=pool_type == "thread")


def test_a_kept_label_keeps_no_image_on_the_card(cuda_device):
    """The stager copies a column of 1 MiB or more into an allocation of
    its own: the labels of a batch, kept, hold the 192 bytes of the labels
    and ids, not the images."""
    from petastorm_tpu_torch.loader.loader import _PinnedStager
    rng = np.random.default_rng(5)
    cols = {"image": rng.integers(0, 256, (16, 192, 192, 3), dtype=np.uint8),
            "label": np.arange(16, dtype=np.int64), "id": np.arange(16, dtype=np.int32)}
    staged, event = _PinnedStager(cuda_device, 2).stage(cols)
    event.synchronize()
    for k, v in cols.items():
        assert staged[k].is_cuda and np.array_equal(staged[k].cpu().numpy(), v), k
    label, image = staged["label"].untyped_storage(), staged["image"].untyped_storage()
    assert label.data_ptr() == staged["id"].untyped_storage().data_ptr()
    assert label.nbytes() == 192 and image.nbytes() == cols["image"].nbytes


def test_scalar_bench_runs_on_card(cuda_device, tmp_path):
    from petastorm_tpu_torch.benchmark.scalar_bench import (batched_loader_throughput,
                                                            generate_scalar_dataset)
    url = generate_scalar_dataset(f"file://{tmp_path}/scalar", rows=20_000)
    assert batched_loader_throughput(url, warmup_batches=2, measure_batches=20,
                                     device=cuda_device) > 0


# ------------------------------------- augmentations, device cache, checkpoints
@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "symmetric", "wrap"])
def test_augmentations_on_card_equal_the_cpu_given_the_same_draws(cuda_device, mode):
    """Drawn on the card, applied on the card and (with the same draws) on
    the CPU: uint8 flip, crop and cutout bit-equal, then normalised by K1
    and mixed up, within 1e-6 of the CPU (the same three float32
    operations, one rounding each)."""
    from petastorm_tpu_torch.ops import augment
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (16, 40, 36, 3),
                                                             dtype=np.uint8))
    xc = x.to(cuda_device)
    gen = augment.seeded_generator((0, 1), cuda_device)
    flips = augment.draw_flips(gen, 16, device=cuda_device)
    offsets = augment.draw_crop_offsets(gen, 16, 4, cuda_device)
    centres = augment.draw_cutout_centres(gen, 16, 40, 36, cuda_device)
    lam = augment.draw_mixup_lam(gen, 16, 0.2, cuda_device)
    labels = torch.arange(16) % 5

    def chain(images, lab):
        out = augment.apply_flip(images, flips.to(images.device))
        out = augment.apply_crop(out, offsets.to(images.device), 4, mode)
        out = augment.apply_cutout(out, centres.to(images.device), 8)
        return out, augment.apply_mixup(normalize_images_plain(out, out_dtype=torch.float32),
                                        lab, lam.to(images.device), num_classes=5)

    got_u8, (got_x, got_y) = chain(xc, labels.to(cuda_device))
    want_u8, (want_x, want_y) = chain(x, labels)
    assert got_u8.device.type == "cuda" and got_u8.dtype == torch.uint8
    assert torch.equal(got_u8.cpu(), want_u8)
    torch.testing.assert_close(got_x.cpu(), want_x, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_y.cpu(), want_y, rtol=0, atol=1e-6)
    kernels.reset_launch_counts()
    normalize_images(got_u8)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {KERNEL_NAME: 1}


def test_device_cache_epoch_on_card(cuda_device, tmp_path):
    from petastorm_tpu_torch.loader import DeviceCachedDataset
    url = _image_store(tmp_path)
    with make_reader(url, reader_pool_type="thread", workers_count=2,
                     shuffle_row_groups=False) as reader:
        cache = DeviceCachedDataset(reader, device=cuda_device)
    assert cache.num_rows == 96 and cache.nbytes() == 96 * (8 + 32 * 40 * 3)
    epochs = [[], []]
    for i, batch in enumerate(cache.batches(32, num_epochs=2, seed=0)):
        assert batch["image"].device.type == "cuda" and batch["image"].shape == (32, 32, 40, 3)
        assert torch.equal(batch["image"], cache._data["image"][batch["id"]])
        epochs[i // 3].append(batch["id"])
    first, second = torch.cat(epochs[0]), torch.cat(epochs[1])
    assert sorted(first.tolist()) == sorted(second.tolist()) == list(range(96))
    assert not torch.equal(first, second)


def test_checkpoint_round_trip_onto_the_card(cuda_device, tmp_path):
    from petastorm_tpu_torch.loader import CheckpointManager
    torch.manual_seed(0)
    model = torch.nn.Linear(16, 4).to(cuda_device)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(8, 16, device=cuda_device)).square().mean().backward()
    opt.step()
    with CheckpointManager(tmp_path / "ckpt") as mgr:
        mgr.save(1, {"model": model.state_dict(), "opt": opt.state_dict()},
                 reader={"epoch": 0, "offset": 2})
        state, cursor = mgr.restore(map_location="cuda")
    assert cursor == {"epoch": 0, "offset": 2}
    for name, t in model.state_dict().items():
        assert state["model"][name].device.type == "cuda"
        assert torch.equal(state["model"][name], t)
    model2 = torch.nn.Linear(16, 4).to(cuda_device)
    opt2 = torch.optim.SGD(model2.parameters(), lr=0.1, momentum=0.9)
    model2.load_state_dict(state["model"])
    opt2.load_state_dict(state["opt"])
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"], opt2.state[q]["momentum_buffer"])


# -------------------------------------------- row-group selection, transforms
def _bucket_kept(value, fractions, subset) -> bool:
    """``in_pseudorandom_split``'s rule written out: md5 of the value's
    string form, modulo ``sys.maxsize``, inside the subset's bounds."""
    import hashlib
    import sys
    high = [sum(fractions[:i + 1]) for i in range(len(fractions))]
    low = high[subset - 1] if subset else 0.0
    bucket = int(hashlib.md5(str(value).encode("utf-8")).hexdigest(), 16) % sys.maxsize
    return low * (sys.maxsize - 1) <= bucket < high[subset] * (sys.maxsize - 1)


@pytest.mark.parametrize("pool_type", ["thread", "process"])
def test_selected_and_cropped_images_normalised_on_card(cuda_device, tmp_path, pool_type):
    """A pseudorandom split on ``label`` and a center crop in the workers,
    DataLoader onto the card, K1 once a batch: the rows are a numpy filter
    and crop of the store, and each normalised batch equals K1's plain
    version of the same batch."""
    import functools
    import hashlib
    from petastorm_tpu_torch.benchmark.imagenet_bench import write_synthetic_imagenet
    from petastorm_tpu_torch.predicates import in_pseudorandom_split
    from petastorm_tpu_torch.test_util.transforms import center_crop
    from petastorm_tpu_torch.transform import TransformSpec
    url = f"file://{tmp_path}/img"
    write_synthetic_imagenet(url, rows=160, classes=20, rows_per_row_group=16, image_size=32)
    with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        want = sorted((int(r.label), hashlib.sha1(np.ascontiguousarray(
            r.image[4:28, 4:28]).tobytes()).hexdigest())
            for r in reader if _bucket_kept(r.label, [0.75, 0.25], 0))
    spec = TransformSpec(functools.partial(center_crop, field="image", size=24),
                         edit_fields=[("image", np.uint8, (24, 24, 3), False)])
    got = []
    kernels.reset_launch_counts()
    with make_reader(url, reader_pool_type=pool_type, workers_count=2, seed=0,
                     predicate=in_pseudorandom_split([0.75, 0.25], 0, "label"),
                     transform_spec=spec) as reader:
        batches = 0
        for batch in DataLoader(reader, batch_size=32, drop_last=False, device=cuda_device):
            out = normalize_images(batch["image"])
            assert torch.equal(out.view(torch.int16),
                               normalize_images_plain(batch["image"]).view(torch.int16))
            batches += 1
            got += [(int(label), hashlib.sha1(image.tobytes()).hexdigest())
                    for label, image in zip(batch["label"].tolist(), batch["image"].cpu().numpy())]
    torch.cuda.synchronize()
    assert kernels.launch_counts == {KERNEL_NAME: batches}
    assert sorted(got) == want and 0 < len(want) < 160


@pytest.mark.parametrize("pool_type", ["thread", "process"])
def test_filtered_predicated_transformed_columns_on_card_give_the_cpu_bytes(
        cuda_device, tmp_path, pool_type):
    """A hive-partitioned store written with ``partition_by``, read with
    ``filters``, a predicate and a pandas transform, batched onto the card:
    the bytes of the same loader on the CPU, and the rows a numpy filter of
    the store keeps."""
    import functools
    from petastorm_tpu_torch.loader import BatchedDataLoader
    from petastorm_tpu_torch.predicates import in_range
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.test_util.transforms import add_sum_column
    from petastorm_tpu_torch.transform import TransformSpec
    rng = np.random.default_rng(4)
    n = 2000
    cols = {"id": np.arange(n, dtype=np.int64), "f0": rng.standard_normal(n).astype(np.float32),
            "i0": rng.integers(0, 1000, n), "part": (np.arange(n) % 4).astype(np.int32)}
    schema = Unischema("P", [UnischemaField("id", np.int64, ()),
                             UnischemaField("f0", np.float32, ()),
                             UnischemaField("i0", np.int64, ()),
                             UnischemaField("part", np.int32, ())])
    url = f"file://{tmp_path}/parts"
    with materialize_dataset_local(url, schema, rows_per_row_group=128,
                                   partition_by=["part"]) as w:
        for i in range(n):
            w.write_row({k: v[i] for k, v in cols.items()})
    spec = TransformSpec(functools.partial(add_sum_column, name="total", left="i0", right="f0"),
                         edit_fields=[("total", np.float64, (), False)])

    def staged(device):
        with make_batch_reader(url, reader_pool_type=pool_type, workers_count=2, seed=1,
                               filters=[("part", "in", {1, 3})], predicate=in_range("i0", 0, 500),
                               transform_spec=spec) as reader:
            return [{k: v.cpu().numpy() for k, v in b.items()} for b in
                    BatchedDataLoader(reader, batch_size=100, drop_last=False, device=device)]

    got, want = staged(cuda_device), staged("cpu")
    _assert_same_bytes(got, want, ordered=pool_type == "thread")
    keep = np.isin(cols["part"], [1, 3]) & (cols["i0"] < 500)
    ids = np.sort(np.concatenate([b["id"] for b in got]))
    assert np.array_equal(ids, cols["id"][keep])
    total = np.concatenate([b["total"] for b in got])
    assert total.dtype == np.float64 and len(total) == keep.sum()


@pytest.mark.parametrize("pool_type", ["thread", "process"])
def test_deterministic_stream_on_card_gives_the_cpu_bytes(cuda_device, tmp_path, pool_type):
    """A ``sample_order="deterministic"`` reader with a window, batched by
    ``DataLoader(device="cuda")``, stages batch for batch the bytes of the
    same reader batched onto the CPU, in the same order on both pools."""
    url = _image_store(tmp_path)
    kwargs = dict(reader_pool_type=pool_type, workers_count=3, seed=4, shuffle_row_groups=True,
                  shuffle_rows=True, sample_order="deterministic", shuffle_window=3)

    def staged(device):
        with make_reader(url, **kwargs) as reader:
            return [{k: v.cpu() for k, v in b.items()}
                    for b in DataLoader(reader, batch_size=24, device=device)]
    got, want = staged(cuda_device), staged("cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_synthetic_device_step_measures_its_length_on_card(cuda_device):
    """``make_synthetic_device_step(20)`` on the card: the mean of 10 steps,
    each waited for, within 25 % of 20 ms."""
    import time

    from petastorm_tpu_torch.benchmark.throughput import make_synthetic_device_step
    step = make_synthetic_device_step(20, device=cuda_device)
    out = step()
    torch.cuda.synchronize()
    assert out.is_cuda
    t0 = time.perf_counter()
    for _ in range(10):
        step()
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 100
    assert 15 <= ms <= 25, ms


def test_two_host_mesh_loader_on_card_gives_the_cpu_bytes(cuda_device, tmp_path):
    """``MeshDataLoader`` with 2 simulated hosts onto the card and onto the
    CPU over the same plan (seed 3): every batch on the card, every row
    byte-equal to the CPU loader's row of the same id, each id once. The
    hosts' parts meet in the order they arrive, so rows are matched by id."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import MeshDataLoader, MeshReaderFactory
    rng = np.random.default_rng(5)
    pq.write_table(pa.table({"id": np.arange(600, dtype=np.int64),
                             "x": rng.standard_normal(600).astype(np.float32),
                             "v": pa.FixedSizeListArray.from_arrays(
                                 pa.array(rng.standard_normal(600 * 8).astype(np.float32)), 8)}),
                   str(tmp_path / "part0.parquet"), row_group_size=50)

    def rows(device):
        out = {}
        with MeshDataLoader(MeshReaderFactory(f"file://{tmp_path}", batched=True), batch_size=64,
                            num_hosts=2, seed=3, device=device, drop_last=False,
                            pad_last=True) as loader:
            for batch in loader:
                assert all(t.device.type == torch.device(device).type for t in batch.values())
                valid = batch["__valid__"].cpu() if "__valid__" in batch else None
                for k in range(batch["id"].shape[0]):
                    if valid is not None and not valid[k]:
                        continue
                    i = int(batch["id"][k])
                    assert i not in out
                    out[i] = (batch["x"][k].cpu(), batch["v"][k].cpu())
        return out
    got, want = rows("cuda"), rows("cpu")
    assert sorted(got) == sorted(want) == list(range(600))
    for i, (x, v) in want.items():
        assert torch.equal(got[i][0], x) and torch.equal(got[i][1], v), i


def test_two_rank_data_parallel_step_on_card_matches_one_process(cuda_device, tmp_path):
    """Two ranks on ``cuda:0`` each take one bf16 AdamW step on their own
    window (``data_group=``): bit-equal parameters on both ranks, and the
    loss and parameters of one process stepping on both windows (the loss
    within 2e-3 relative; each parameter within 4 lr and 90 % of it within
    0.1 lr, the bf16 bar of the single-process parity test)."""
    import torch_mesh_ranks
    from petastorm_tpu_torch.ops.flash_attn import make_flash_attention
    from petastorm_tpu_torch.parallel.launch import run_ranks
    url = f"file://{tmp_path}/tokens"
    window, lr = 256, 3e-4
    cfg_kwargs = dict(vocab=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden=512)
    write_token_store(url, windows=8, window=window, vocab=cfg_kwargs["vocab"])
    ranks = run_ranks(torch_mesh_ranks.card_data_parallel_step, 2,
                      args=(url, window, cfg_kwargs), device="cuda", timeout_s=300)
    (tok0, loss0, params0), (tok1, loss1, params1) = ranks
    assert loss0 == loss1 and not torch.equal(tok0, tok1)
    for a, b in zip(params0, params1):
        assert torch.equal(a, b)
    cfg = llama.LlamaConfig(**cfg_kwargs)
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    init_opt, step = llama.make_train_step(cfg, learning_rate=lr, shift="roll",
                                           attn_fn=make_flash_attention(causal=True))
    _, _, loss = step(params, init_opt(params), {"tokens": torch.cat([tok0, tok1]).cuda()})
    assert abs(loss.item() - loss0) <= 2e-3 * abs(loss.item())
    for got, want in zip(params0, llama.param_leaves(params)):
        diff = (got - want.detach().cpu()).abs()
        assert diff.max() <= 4 * lr and (diff <= 0.1 * lr).float().mean() >= 0.9


def _lazy_epoch(url, device, mode, pool_type="thread"):
    """One shuffled epoch of ``url`` through a ``mode`` reader and
    ``DataLoader(batch_size=32, shuffling_queue_capacity=64, seed=0)``
    onto ``device`` -> the batches."""
    with make_reader(url, reader_pool_type=pool_type, workers_count=2, seed=3,
                     row_materialization=mode) as reader:
        assert reader.row_materialization == mode
        return list(DataLoader(reader, batch_size=32, shuffling_queue_capacity=64, seed=0,
                               device=device, drop_last=False))


@pytest.mark.parametrize("pool_type", ["thread", "process"])
def test_lazy_loader_on_card_is_the_eager_multiset_and_k1_is_plain(cuda_device, tmp_path,
                                                                   pool_type):
    """A lazy reader's epoch staged onto the card holds the eager epoch's
    rows (multiset of (id, image bytes)), each batch's images pass K1
    bit-equal to the plain version, one launch a batch, and the lazy
    batches on the card are the lazy batches on the CPU, byte for byte."""
    url = _image_store(tmp_path)
    lazy = _lazy_epoch(url, cuda_device, "lazy", pool_type)
    eager = _lazy_epoch(url, cuda_device, "eager", pool_type)
    assert all(b["image"].is_cuda for b in lazy)

    def rows(batches):
        return sorted((int(i), bytes(im.cpu().numpy().tobytes()))
                      for b in batches for i, im in zip(b["id"], b["image"]))
    assert rows(lazy) == rows(eager) and len(rows(lazy)) == 96
    kernels.reset_launch_counts()
    for b in lazy:
        got = normalize_images(b["image"])
        want = normalize_images_plain(b["image"])
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    torch.cuda.synchronize()
    assert kernels.launch_counts == {KERNEL_NAME: len(lazy)}
    if pool_type == "thread":
        on_cpu = _lazy_epoch(url, "cpu", "lazy")
        assert len(on_cpu) == len(lazy)
        for g, w in zip(lazy, on_cpu):
            for k in w:
                assert torch.equal(g[k].cpu(), w[k])


def test_sharded_cache_slice_logic_at_world_size_one_on_card(cuda_device, tmp_path):
    """``DeviceCachedDataset(sharding=)`` in a gloo group of one rank: the
    slice gather (masks, ``index_select`` and the placement on the card)
    serves the unsharded cache's batches bit for bit, tail included."""
    import torch.distributed as dist

    from petastorm_tpu_torch.loader import DeviceCachedDataset
    from petastorm_tpu_torch.parallel import mesh as pmesh
    url = _image_store(tmp_path, rows=90)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        mesh = pmesh.make_mesh([-1], ["data"])

        def cache(sharding):
            with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
                return DeviceCachedDataset(reader, device=cuda_device, sharding=sharding)
        sharded, whole = cache(pmesh.data_sharding(mesh)), cache(None)
        assert sharded.nbytes() == whole.nbytes() and sharded.shard_rows == 90
        for kw in (dict(num_epochs=2, seed=4), dict(shuffle=False, drop_last=False)):
            got = list(sharded.batches(32, **kw))
            want = list(whole.batches(32, **kw))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g["image"].is_cuda
                for k in w:
                    assert torch.equal(g[k], w[k])
    finally:
        dist.destroy_process_group()


def test_switch_moe_block_on_card_matches_cpu(cuda_device):
    """``moe.switch_moe_block`` (top-2, tokens dropped) in float32 on the
    card and on the CPU from the same inputs: the routing's kept slots
    equal, the output and every input's gradient within 1e-4 of the
    largest value."""
    from petastorm_tpu_torch.parallel import moe
    rng = np.random.default_rng(4)
    arrays = (rng.normal(size=(2, 64, 32)), rng.normal(size=(32, 8)),
              rng.normal(size=(8, 32, 64)) / 6, rng.normal(size=(8, 32, 64)) / 6,
              rng.normal(size=(8, 64, 32)) / 8)

    def run(device):
        inputs = [torch.tensor(a, dtype=torch.float32, device=device, requires_grad=True)
                  for a in arrays]
        with moe.record_routing() as record:
            out, aux = moe.switch_moe_block(*inputs, top_k=2, capacity_factor=0.8)
        (out.square().sum() + aux).backward()
        return [out, aux] + [t.grad for t in inputs], record[-1]["kept"].cpu()

    card, card_kept = run(cuda_device)
    host, host_kept = run("cpu")
    assert torch.equal(card_kept, host_kept) and host_kept.sum() < 2 * 128
    for got, want in zip(card, host):
        assert got.is_cuda
        assert (got.detach().cpu() - want.detach()).abs().max() <= 1e-4 * want.abs().max()


def test_tensor_parallel_step_on_card_matches_one_cpu_process(cuda_device):
    """Two model ranks on ``cuda:0`` (gloo) take one float32 AdamW step of
    a switch-MoE Llama with flash attention over their heads (the kernels):
    the loss within 1e-4 relative of one CPU process on the whole model (the
    plain versions), every leaf's joined gradient within 1e-4 of its
    largest value, and the joined parameters within 1e-4 (a step moves each
    by about lr = 3e-4, so a gradient of the wrong sign misses it)."""
    import types

    import torch_tp_ranks
    from petastorm_tpu_torch.parallel.launch import run_ranks
    cfg_kwargs = dict(vocab=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, hidden=256,
                      n_experts=4, moe_dispatch="switch", moe_top_k=2, moe_capacity_factor=1.0)
    tokens = np.random.default_rng(6).integers(0, 256, (2, 64)).astype(np.int32)
    ranks = run_ranks(torch_tp_ranks.card_tp_step, 2, args=(cfg_kwargs, tokens), device="cuda",
                      timeout_s=300)
    cfg = llama.LlamaConfig(**cfg_kwargs)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    init_opt, step = llama.make_train_step(cfg, attn_fn=flash_attn.make_flash_attention(),
                                           shift="roll", compute_dtype=torch.float32)
    opt = init_opt(params)
    grads = []
    opt.register_step_pre_hook(lambda *_: grads.append(
        [t.grad.clone() for t in llama.param_leaves(params)]))
    _, _, loss = step(params, opt, {"tokens": torch.from_numpy(tokens)})
    assert all(abs(r[0] - loss.item()) <= 1e-4 * abs(loss.item()) for r in ranks)
    assert all(r[3] for r in ranks)   # the flash kernels ran on every rank
    shardings = llama.param_shardings(types.SimpleNamespace(shape={"model": 2}), cfg)
    joined = llama.unshard_params([r[1] for r in ranks], shardings)
    for got, want in zip(llama.param_leaves(joined), grads[0]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    joined = llama.unshard_params([r[2] for r in ranks], shardings)
    for got, want in zip(llama.param_leaves(joined), llama.param_leaves(params)):
        assert (got - want.detach()).abs().max() <= 1e-4


def test_fsdp_gather_and_pipeline_hops_on_card_equal_the_cpu(cuda_device):
    """FSDP's autograd all-gather (and its reduce-scatter backward), the
    pipeline's chain hop both ways and its replicate-from-last op, on 2 ranks
    sharing ``cuda:0`` (gloo through pinned host buffers): the results and
    gradients equal those of 2 CPU ranks on the same inputs."""
    import torch_fsdp_ranks
    from petastorm_tpu_torch.parallel.launch import run_ranks
    card = run_ranks(torch_fsdp_ranks.comm_round_trip, 2, args=("cuda",), device="cuda",
                     timeout_s=300)
    host = run_ranks(torch_fsdp_ranks.comm_round_trip, 2, args=("cpu",), device="cpu",
                     timeout_s=300)
    for got, want in zip(card, host):
        assert got.keys() == want.keys()
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=1e-6, atol=1e-6, msg=name)


def _build_store_sparkless(*args, **kwargs) -> dict:
    """``examples/torch_spark_to_vit``'s store builder: the converter's
    cache store written directly."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "torch_spark_to_vit" / "main.py"
    spec = importlib.util.spec_from_file_location("torch_example_spark_to_vit", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_store_sparkless(*args, **kwargs)


def test_converter_k1_vit_float32_on_card_matches_cpu(cuda_device, tmp_path):
    """Converter batches on the card -> K1 (bit-equal to its plain version)
    -> a small ViT in float32 with TF32 off, within 1e-5 of the same forward
    on the CPU; the exact-erf GELU misses that bar."""
    import torch.nn.functional as F

    from petastorm_tpu_torch.models import vit
    from petastorm_tpu_torch.spark.spark_dataset_converter import SparkDatasetConverter
    url = f"file://{tmp_path}/conv"
    stats = _build_store_sparkless(url, rows=64, classes=10, image=32, rows_per_group=16)
    conv = SparkDatasetConverter(url, stats["total_rows"])
    with conv.make_device_loader(batch_size=8, num_epochs=1, shuffle_row_groups=False) as loader:
        batch = next(iter(loader))
    assert batch["image"].device.type == "cuda" and batch["image"].dtype == torch.uint8
    pixels = batch["image"].view(-1, 32, 32, 3)
    kernels.reset_launch_counts()
    images = normalize_images(pixels, out_dtype=torch.float32)
    assert kernels.launch_counts == {KERNEL_NAME: 1}
    assert torch.equal(images, normalize_images_plain(pixels, out_dtype=torch.float32))
    cfg = dict(image_size=32, patch=8, dim=64, depth=2, heads=4, mlp_dim=128, num_classes=10)
    params = vit.init_params(torch.Generator(device="cuda").manual_seed(0), device="cuda", **cfg)
    cpu_params = vit.params_from_jax(
        {k: _to_numpy_tree(v) for k, v in params.items()}, device="cpu")

    def forward(p, x):
        return vit.apply(p, x, patch=8, heads=4, compute_dtype=torch.float32)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = forward(params, images).cpu()
        want = forward(cpu_params, images.cpu())
        rel = ((got - want).abs().max() / want.abs().max()).item()
        gelu = vit._gelu
        vit._gelu = F.gelu
        try:
            control = forward(params, images).cpu()
        finally:
            vit._gelu = gelu
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert rel <= 1e-5, rel
    assert ((control - want).abs().max() / want.abs().max()).item() > 1e-5
    loss, _ = vit.loss_fn(params, {"image": normalize_images(pixels), "label": batch["label"]},
                          patch=8, heads=4)
    assert torch.isfinite(loss)


def _to_numpy_tree(node):
    if isinstance(node, dict):
        return {k: _to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_numpy_tree(v) for v in node]
    return node.detach().cpu().numpy()


def test_mlp_steps_on_card_match_cpu(cuda_device):
    from petastorm_tpu_torch.models import mlp
    params = mlp.init_params(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cpu = {layer: {k: v.cpu() for k, v in leaves.items()} for layer, leaves in params.items()}
    m = {layer: {k: torch.zeros_like(v) for k, v in leaves.items()}
         for layer, leaves in params.items()}
    m_cpu = {layer: {k: v.cpu() for k, v in leaves.items()} for layer, leaves in m.items()}
    step = mlp.make_train_step(0.05)
    rng = np.random.default_rng(0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(3):
            x = torch.from_numpy(rng.normal(size=(64, 784)).astype(np.float32))
            y = torch.from_numpy(rng.integers(0, 10, 64).astype(np.int32))
            params, m, loss, _ = step(params, m, {"image": x.cuda(), "label": y.cuda()})
            cpu, m_cpu, loss_cpu, _ = step(cpu, m_cpu, {"image": x, "label": y})
            assert abs(loss.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for layer in cpu:
        for k in cpu[layer]:
            want = cpu[layer][k]
            assert ((params[layer][k].cpu() - want).abs().max() / want.abs().max()) <= 1e-5


def test_the_torch_adapter_defaults_to_the_card(cuda_device, tmp_path):
    """``petastorm_tpu_torch.pytorch``: tensors on the card without
    ``torch_device``, bool as uint8; ``transform_fn`` output stays on the
    host."""
    from petastorm_tpu_torch import pytorch
    from petastorm_tpu_torch.reader import make_batch_reader
    schema = Unischema("Flags", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("flag", np.bool_, (), ScalarCodec(np.bool_), False)])
    url = f"file://{tmp_path}/flags"
    with materialize_dataset_local(url, schema, rows_per_row_group=8) as w:
        w.write_rows([{"id": i, "flag": i % 2 == 0} for i in range(16)])
    with make_reader(url, shuffle_row_groups=False, num_epochs=1) as r:
        batch = next(iter(pytorch.DataLoader(r, batch_size=8)))
    assert batch["id"].device.type == "cuda" and batch["flag"].device.type == "cuda"
    assert batch["flag"].dtype == torch.uint8
    assert batch["flag"].tolist() == [1, 0] * 4 and batch["id"].tolist() == list(range(8))
    with make_batch_reader(url, shuffle_row_groups=False, num_epochs=1) as r:
        batches = list(pytorch.BatchedDataLoader(r, batch_size=8, transform_fn=np.flip))
    assert isinstance(batches[0]["id"], np.ndarray) and batches[0]["flag"].dtype == np.bool_
    assert batches[0]["id"].tolist() == list(range(7, -1, -1))


def _load_example(name: str):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / name / "main.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_imagenet_example_trains_resnet50_through_k1_on_card(cuda_device, tmp_path):
    """``examples/torch_imagenet`` at the JAX example's sizes (ResNet-50,
    224x224, 100 classes, batch 8 a device), 30 steps on a 512-row store:
    K1 once a step (and the warm-up's), the loss finite and falling."""
    from petastorm_tpu_torch.benchmark.imagenet_bench import write_synthetic_imagenet
    example = _load_example("torch_imagenet")
    url = f"file://{tmp_path}/imagenet"
    write_synthetic_imagenet(url, 512)
    kernels.reset_launch_counts()
    result = example.train(url, steps=30, batch_size=8, device="cuda", log=lambda _: None)
    losses = result["losses"]
    assert kernels.launch_counts == {KERNEL_NAME: 31}
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert result["stall_report"]["steps"] >= 30


def test_llm_tokens_example_trains_through_the_flash_kernels_on_card(cuda_device, tmp_path):
    """``examples/torch_llm_tokens`` at the JAX example's sizes (4,096 chunks,
    vocab 256, batch 8, windows of 4 chunks, 40 steps): K2 ("lse"), K3 and
    K4 once a layer a step, the loss finite and falling."""
    example = _load_example("torch_llm_tokens")
    url = f"file://{tmp_path}/tokens"
    example.write_token_stream(url, 4096, 256)
    kernels.reset_launch_counts()
    result = example.train(url, device="cuda", log=lambda _: None)
    losses = result["losses"]
    per_kernel = 2 * 41   # 2 layers, the warm-up step and 40 more
    assert kernels.launch_counts == {flash_attn.KERNEL_NAME: per_kernel,
                                     flash_attn.BWD_DQ_KERNEL_NAME: per_kernel,
                                     flash_attn.BWD_DKV_KERNEL_NAME: per_kernel}
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_long_context_example_on_two_ranks_on_card(cuda_device, tmp_path):
    """``examples/torch_long_context`` at the JAX example's sizes (8,192
    chunks, vocab 256, windows of 8 chunks, 2 sequences a shard, 30 steps)
    on 2 ranks sharing the card, ring attention with the flash local step:
    every rank launches K2 "stats", K3 and K4, and the window's loss, equal
    on the ranks, is finite and falls."""
    import importlib
    example = importlib.import_module("examples.torch_long_context.main")
    url = f"file://{tmp_path}/lc"
    example.write_token_stream(url, 8192, 256)
    results = example.train(url, ranks=2, device="cuda")
    losses = results[0]["losses"]
    assert results[1]["losses"] == losses
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    for r in results:
        assert {flash_attn.STATS_KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
                flash_attn.BWD_DKV_KERNEL_NAME} <= set(r["launches"]), r["launches"]
