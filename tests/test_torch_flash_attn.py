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
