"""The port's flash-attention gradients against the JAX package, on the CPU
(the port's plain forward and backward; the JAX Pallas forward and backward
kernels in interpret mode where the shape tiles, its dense fallback
elsewhere).

Bars: the JAX package's own gradient bars, float32 atol 2e-4
(``tests/test_ops.py``, multi-block flash grads against dense) and bfloat16
atol 3e-2 (its flash bar); the plain backward against the JAX backward
kernels on the same ``(o, lse, dO)``, float32 atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.flash_attn import _flash_backward
from petastorm_tpu.ops.flash_attn import flash_attention as jax_flash_attention
from petastorm_tpu.parallel.attention import dense_attention as jax_dense_attention
from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.parallel.attention import dense_attention

_BARS = {"float32": 2e-4, "bfloat16": 3e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(sq, sk, h, kv_h, d=32, seed=0):
    """q, k, v and an output cotangent g, float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, sq, h, d)).astype(np.float32),
            rng.normal(size=(2, sk, kv_h, d)).astype(np.float32),
            rng.normal(size=(2, sk, kv_h, d)).astype(np.float32),
            rng.normal(size=(2, sq, h, d)).astype(np.float32))


def _port_grads(q, k, v, g, causal, dtype):
    q, k, v = (torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_() for a in (q, k, v))
    out = flash_attn.flash_attention(q, k, v, causal=causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return q.grad, k.grad, v.grad


def _close(got: torch.Tensor, want, atol, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol, err_msg=what)


# Several blocks on both axes of the JAX kernels (block_q 32, block_k 64);
# bfloat16 at seq 128 only, to keep the interpret-mode runs short.
@pytest.mark.parametrize("seq,dtype", [(64, "float32"), (128, "float32"), (128, "bfloat16")])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_flash_gradients_match_jax_kernels(seq, rep, causal, dtype):
    q, k, v, g = _inputs(seq, seq, 4, 4 // rep, seed=seq + rep)
    got = _port_grads(q, k, v, g, causal, dtype)
    jdt = getattr(jnp, dtype)

    def loss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, causal=causal, block_q=32, block_k=64)
        return (o.astype(jnp.float32) * g).sum()
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == _TORCH[dtype]
        _close(a, b, _BARS[dtype], f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rep", [1, 4])
def test_plain_backward_matches_jax_backward_kernels(causal, rep):
    """The same (o, lse, dO) into both backwards; the JAX side's two Pallas
    kernels run in interpret mode."""
    q, k, v, do = _inputs(128, 128, 4, 4 // rep, seed=11)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attn.flash_attention_plain(tq, tk, tv, causal=causal)
    got = flash_attn.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal)
    want = jax.jit(lambda *a: _flash_backward(*a, causal, 32, 64, True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(o.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(do))
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape
        _close(a, b, 1e-4, f"d{name}")


@pytest.mark.parametrize("sq,sk,rep", [(96, 64, 2), (40, 100, 4)])
def test_causal_cross_length_matches_jax_dense_gradient(sq, sk, rep):
    """The top-left mask with sq != sk: the JAX package takes its dense
    path there, so its dense gradient is the reference (keys no query sees
    get zero dk and dv)."""
    q, k, v, g = _inputs(sq, sk, 4, 4 // rep, seed=3)
    got = _port_grads(q, k, v, g, True, "float32")
    want = jax.jit(jax.grad(lambda *a: (jax_dense_attention(*a, causal=True) * g).sum(),
                            argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, b in zip("qkv", got, want):
        _close(a, b, 2e-4, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_is_the_same_chunked_row_by_row(causal):
    """The plain backward loops over blocks of q rows; one row per block
    gives the whole-at-once result up to the float32 sums' order, and both
    equal autograd through dense attention."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(70, 70, 4, 2, seed=5))
    o, lse = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    whole = flash_attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    saved = flash_attn._PLAIN_SCORE_BYTES
    flash_attn._PLAIN_SCORE_BYTES = 1
    try:
        rowwise = flash_attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    finally:
        flash_attn._PLAIN_SCORE_BYTES = saved
    for a, b in zip(whole, rowwise):
        torch.testing.assert_close(a, b, rtol=0, atol=4e-6)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    dense_attention(qq, kk, vv, causal=causal).backward(do)
    for a, b in zip(whole, (qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_gradient_runs_through_the_autograd_function_and_plain_on_cpu():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(48, 48, 4, 2, seed=9))
    q.requires_grad_()
    kernels.reset_launch_counts()
    out = flash_attn.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.backward(g)
    # A CPU tensor takes the plain versions: no kernel is ever launched.
    assert not {flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
                flash_attn.BWD_DKV_KERNEL_NAME} & set(kernels.launch_counts)
    assert q.grad is not None and k.grad is None
    # Without grad the forward keeps its plain "out" call and no graph.
    with torch.no_grad():
        assert flash_attn.flash_attention(q, k, v, causal=True).grad_fn is None
    # The same Function with the plain bodies named explicitly.
    q2 = q.detach().clone().requires_grad_()
    flash_attn.FlashAttentionFunction.apply(q2, k, v, True, flash_attn.flash_attention_plain,
                                            flash_attn.flash_attention_bwd_plain).backward(g)
    assert torch.equal(q2.grad, q.grad)


def test_backward_raises_on_mismatched_residuals():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(8, 8, 4, 2))
    o, lse = flash_attn.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="do must match q"):
        flash_attn.flash_attention_bwd(q, k, v, o, lse, do[:, :4])
    with pytest.raises(ValueError, match="o must match q"):
        flash_attn.flash_attention_bwd(q, k, v, o.bfloat16(), lse, do)
    with pytest.raises(ValueError, match="lse"):
        flash_attn.flash_attention_bwd(q, k, v, o, lse[..., 0], do)
