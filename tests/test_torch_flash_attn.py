"""petastorm_tpu_torch.ops.flash_attn and parallel.attention against the JAX
package, on the CPU (the port's plain version; the JAX flash kernel in
Pallas interpret mode where its shape tiles, its dense fallback elsewhere).

Bars are those of the JAX package's own flash tests: float32 atol 2e-5,
bfloat16 atol 3e-2, the float32 logsumexp atol 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.flash_attn import _flash_forward_lse
from petastorm_tpu.ops.flash_attn import flash_attention as jax_flash_attention
from petastorm_tpu.parallel.attention import dense_attention as jax_dense_attention
from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.parallel.attention import dense_attention

_BARS = {"float32": 2e-5, "bfloat16": 3e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(sq, sk, h, kv_h, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, sq, h, d)).astype(np.float32),
            rng.normal(size=(2, sk, kv_h, d)).astype(np.float32),
            rng.normal(size=(2, sk, kv_h, d)).astype(np.float32))


def _pair(arrays, dtype):
    port = [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrays]
    ref = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return port, ref


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# seq 64 runs the JAX kernel (interpret mode); seq 100 takes its dense
# fallback; causal sq 96 > sk 64 is the top-left mask on both sides.
_CASES = [(s, s, causal, rep) for s in (64, 100) for causal in (False, True)
          for rep in (1, 2, 4)] + [(96, 64, True, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,rep", _CASES)
def test_flash_attention_matches_jax(sq, sk, causal, rep, dtype):
    (q, k, v), (jq, jk, jv) = _pair(_inputs(sq, sk, 4, 4 // rep), dtype)
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    assert got.dtype == _TORCH[dtype] and got.shape == q.shape
    _close(got, jax_flash_attention(jq, jk, jv, causal=causal), _BARS[dtype])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rep", [1, 4])
def test_flash_attention_lse_matches_jax_kernel(causal, rep):
    (q, k, v), (jq, jk, jv) = _pair(_inputs(64, 64, 4, 4 // rep), "float32")
    o, lse = flash_attn.flash_attention_lse(q, k, v, causal=causal)
    want_o, want_lse = _flash_forward_lse(jq, jk, jv, causal, 32, 32, True)
    assert lse.shape == (2, 4, 64, 1) and lse.dtype == torch.float32
    _close(o, want_o, 2e-5)
    _close(lse, want_lse, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,h,kv_h,causal", [
    (64, 64, 4, 4, True), (100, 100, 8, 2, True), (96, 64, 4, 1, True), (77, 130, 4, 2, False)])
def test_dense_attention_matches_jax(sq, sk, h, kv_h, causal, dtype):
    (q, k, v), (jq, jk, jv) = _pair(_inputs(sq, sk, h, kv_h, seed=3), dtype)
    got = dense_attention(q, k, v, causal=causal)
    assert got.dtype == _TORCH[dtype]
    _close(got, jax_dense_attention(jq, jk, jv, causal=causal), _BARS[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_is_the_dense_function(causal):
    """The plain version loops over blocks of q rows; one row per block
    gives the same result as the whole at once, up to the float32 sums'
    order (the causal blocks read fewer keys, so the products block
    differently)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(70, 70, 4, 2, seed=5))
    whole = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    saved = flash_attn._PLAIN_SCORE_BYTES
    flash_attn._PLAIN_SCORE_BYTES = 1
    try:
        rowwise = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    finally:
        flash_attn._PLAIN_SCORE_BYTES = saved
    for a, b in zip(whole, rowwise):
        torch.testing.assert_close(a, b, rtol=0, atol=4e-6)
    torch.testing.assert_close(whole[0], dense_attention(q, k, v, causal=causal),
                               rtol=0, atol=2e-5)


def test_make_flash_attention_is_gqa_native_and_runs_plain_on_cpu():
    attn = flash_attn.make_flash_attention(causal=True)
    assert attn.supports_gqa is True
    q, k, v = (torch.from_numpy(a) for a in _inputs(16, 16, 4, 2))
    kernels.reset_launch_counts()
    out = attn(q, k, v)
    assert out.shape == q.shape
    # A CPU tensor takes the plain version: the kernel is never launched.
    assert flash_attn.KERNEL_NAME not in kernels.launch_counts
    torch.testing.assert_close(out, flash_attn.flash_attention(q, k, v, causal=True))


def test_flash_attention_raises_on_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 8, 4, 2))
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        flash_attn.flash_attention(q, k[:, :, :1].expand(2, 8, 3, 64),
                                   v[:, :, :1].expand(2, 8, 3, 64))
    big = torch.zeros(1, 4, 2, flash_attn.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="dtype"):
        flash_attn.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="dtype"):
        flash_attn.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="devices"):
        flash_attn.flash_attention(q, k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="unit-stride"):
        flash_attn.flash_attention(q.transpose(1, 3), k.transpose(1, 3), v.transpose(1, 3))
    with pytest.raises(ValueError, match="unit-stride"):   # q alone strided
        flash_attn.flash_attention(torch.zeros(2, 8, 4, 128)[..., ::2], k, v)
    with pytest.raises(ValueError, match="sk == 0"):
        flash_attn.flash_attention(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="k and v"):
        flash_attn.flash_attention(q, k, v[:, :4])


def test_softmax_scale_is_rounded_once_to_float32():
    assert flash_attn.softmax_scale(128) == float(np.float32(1 / np.sqrt(128)))
    assert flash_attn.softmax_scale(80) == float(np.float32(1 / np.sqrt(80)))


# The forward's route, decided from the dtype and head dim before a launch
# (the backward's rule: tests/test_torch_flash_attn_bwd.py).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [8, 32, 64, 72, 128])
def test_forward_16_bit_inputs_up_to_d128_take_the_tensor_cores(dtype, d):
    assert flash_attn.fwd_route(dtype, d) == flash_attn.TENSOR_CORES


@pytest.mark.parametrize("d", [8, 64, 72, 128, 200, 256])
def test_forward_float32_takes_the_fma_route_at_any_head_dim(d):
    assert flash_attn.fwd_route(torch.float32, d) == flash_attn.FMA


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,route", [(200, "fma"), (256, "fma"), (136, "fma"), (60, "fma"),
                                     (100, "fma"), (72, "tensor cores"), (128, "tensor cores")])
def test_forward_16_bit_head_dims_past_128_or_off_multiples_of_8_take_the_fma_route(dtype, d,
                                                                                      route):
    assert flash_attn.fwd_route(dtype, d) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_forward_and_backward_share_one_route(dtype):
    for d in range(1, flash_attn.MAX_HEAD_DIM + 1):
        assert flash_attn.fwd_route(dtype, d) == flash_attn.bwd_route(dtype, d)


def test_forward_routes_have_their_own_launch_count_names():
    assert flash_attn._FWD_KERNELS == {flash_attn.TENSOR_CORES: "flash_attn_fwd",
                                       flash_attn.FMA: "flash_attn_fwd_fma"}
    assert flash_attn.KERNEL_NAME == "flash_attn_fwd"
    assert flash_attn.FMA_KERNEL_NAME == "flash_attn_fwd_fma"


def _bf16(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()


def test_forward_reads_fused_qkv_views_on_the_tma_path_without_a_copy():
    qkv = _bf16(2, 64, 4 + 2 + 2, 64)
    views = (qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])
    got = flash_attn._fwd_inputs(flash_attn.TENSOR_CORES, *views)
    assert all(a is b for a, b in zip(got, views))
    assert all(flash_attn._tma_ready(t) for t in views)
    # The FMA route reads any view with a unit-stride head dim as it is.
    got = flash_attn._fwd_inputs(flash_attn.FMA, *views)
    assert all(a is b for a, b in zip(got, views))


def test_forward_copies_only_what_tma_cannot_read():
    q, k = _bf16(2, 16, 4, 64, seed=1), _bf16(2, 16, 2, 64, seed=2)
    wide = torch.zeros(2, 16, 2, 68, dtype=torch.bfloat16)
    wide[..., :64] = k
    v = wide[..., :64]                      # a head stride of 136 bytes
    q2, k2, v2 = flash_attn._fwd_inputs(flash_attn.TENSOR_CORES, q, k, v)
    assert q2 is q and k2 is k
    assert v2 is not v and v2.is_contiguous() and torch.equal(v2, v)
    assert flash_attn._fwd_inputs(flash_attn.FMA, q, k, v)[2] is v


def test_cpu_forward_never_reaches_a_route_or_a_launcher(monkeypatch):
    """A CPU tensor takes the plain version before any route is chosen, in
    every entry point: nothing is launched or counted, whatever the dtype."""
    def unreachable(*_a, **_k):
        raise AssertionError("reached on CPU tensors")
    for name in ("fwd_route", "_fwd_inputs", "_flash_fwd", "_fwd_launcher"):
        monkeypatch.setattr(flash_attn, name, unreachable)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(40, 40, 4, 2, d=64, seed=8))
        want_o, want_lse = flash_attn.flash_attention_plain(q, k, v, causal=True)
        kernels.reset_launch_counts()
        o, lse = flash_attn.flash_attention_lse(q, k, v, causal=True)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        assert torch.equal(flash_attn.flash_attention(q, k, v, causal=True), want_o)
        assert torch.equal(flash_attn.make_flash_attention(causal=True)(q, k, v), want_o)
        leaf = q.clone().requires_grad_()
        assert torch.equal(flash_attn.flash_attention(leaf, k, v, causal=True).detach(), want_o)
        assert not kernels.launch_counts
