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


# The backward's route, decided from the dtype and head dim before a launch.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [8, 32, 64, 72, 128])
def test_16_bit_inputs_up_to_d128_take_the_tensor_cores(dtype, d):
    assert flash_attn.bwd_route(dtype, d) == flash_attn.TENSOR_CORES


@pytest.mark.parametrize("d", [8, 64, 72, 128, 200, 256])
def test_float32_takes_the_fma_route_at_any_head_dim(d):
    assert flash_attn.bwd_route(torch.float32, d) == flash_attn.FMA


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,route", [(200, "fma"), (256, "fma"), (136, "fma"), (60, "fma"),
                                     (100, "fma"), (72, "tensor cores"), (128, "tensor cores")])
def test_16_bit_head_dims_past_128_or_off_multiples_of_8_take_the_fma_route(dtype, d, route):
    assert flash_attn.bwd_route(dtype, d) == route


def _bf16(*shape):
    return torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).bfloat16()


def test_tma_reads_contiguous_tensors_and_fused_qkv_views_in_place():
    q = _bf16(2, 16, 4, 64)
    assert flash_attn._tma_operand(q) is q
    qkv = _bf16(2, 16, 4 + 2 + 2, 64)
    for view in (qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]):
        assert flash_attn._tma_ready(view) and flash_attn._tma_operand(view) is view
    # A dim of size 1 is never stepped: its stride, whatever it is, is not held against it.
    one = _bf16(1, 16, 1, 64)
    odd = one.as_strided(one.shape, (7, 64, 3, 1))
    assert flash_attn._tma_strides(odd) == [1024, 64, 64]
    assert flash_attn._tma_operand(odd) is odd


@pytest.mark.parametrize("make", [
    lambda: _bf16(2, 16, 4, 68)[..., :64],                       # seq/head strides of 136 bytes
    lambda: _bf16(2 * 16 * 4 * 64 + 1)[1:].view(2, 16, 4, 64),   # base 2 bytes past 16-byte alignment
    lambda: _bf16(2, 16, 1, 64).expand(2, 16, 4, 64),            # a zero head stride
    lambda: _bf16(2, 16, 64, 4).transpose(2, 3),                # a head dim that is not unit-stride
])
def test_views_tma_cannot_take_are_made_contiguous(make):
    t = make()
    assert not flash_attn._tma_ready(t)
    c = flash_attn._tma_operand(t)
    assert c.is_contiguous() and c.data_ptr() % 16 == 0 and flash_attn._tma_ready(c)
    assert torch.equal(c, t)


@pytest.mark.parametrize("route,sq,width", [("tensor cores", 37, 40), ("tensor cores", 64, 64),
                                            ("fma", 37, 37)])
def test_bwd_inputs_hold_lse_and_d_in_one_stats_tensor(route, sq, width):
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(sq, 50, 4, 2, d=64, seed=4))
    o, lse = flash_attn.flash_attention_plain(q, k, v, causal=True)
    q2, k2, v2, do2, stats = flash_attn._bwd_inputs(route, q, k, v, o, lse, do)
    assert all(a is b for a, b in zip((q2, k2, v2, do2), (q, k, v, do)))   # nothing to copy
    assert stats.shape == (2, 2, 4, width) and stats.dtype == torch.float32
    assert torch.equal(stats[0, ..., :sq], lse[..., 0])
    assert torch.equal(stats[1, ..., :sq], flash_attn._rowsum_do_o(do, o).transpose(1, 2))


def test_tensor_core_inputs_copy_only_what_tma_cannot_read():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(16, 16, 4, 2, d=64, seed=6))
    o, lse = flash_attn.flash_attention_plain(q, k, v)
    wide = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)
    wide[..., :64] = do
    got = flash_attn._bwd_inputs(flash_attn.TENSOR_CORES, q, k, v, o, lse, wide[..., :64])
    assert got[0] is q and got[1] is k and got[2] is v
    assert got[3].is_contiguous() and torch.equal(got[3], do)


def test_cpu_backward_never_reaches_the_route(monkeypatch):
    """A CPU tensor takes the plain backward before any route is chosen:
    nothing is launched or counted, whatever the dtype."""
    def unreachable(*_a, **_k):
        raise AssertionError("reached on CPU tensors")
    monkeypatch.setattr(flash_attn, "bwd_route", unreachable)
    monkeypatch.setattr(flash_attn, "_bwd_inputs", unreachable)
    monkeypatch.setattr(flash_attn, "_bwd_call", unreachable)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(40, 40, 4, 2, d=64, seed=8))
        o, lse = flash_attn.flash_attention_plain(q, k, v, causal=True)
        kernels.reset_launch_counts()
        got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        want = flash_attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
        assert not kernels.launch_counts
        for a, b in zip(got, want):
            assert torch.equal(a, b)
