"""petastorm_tpu_torch.ops.flash_attn.flash_attention_stats (K2's "stats"
mode: the unnormalised float32 output, the row max m and the normaliser l)
against the JAX package's ``flash_attention_stats`` (the Pallas kernel in
interpret mode where its shape tiles, its chunked dense stats elsewhere) and
``_dense_stats``, on the CPU, where the port runs its plain version.

Bars: o, m and l at atol 1e-5 (float32 inputs; o sums up to 64 terms of
about 1); the gradient through random (do, dm, dl) cotangents at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.flash_attn import _dense_stats
from petastorm_tpu.ops.flash_attn import flash_attention_stats as jax_flash_attention_stats
from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.ops import flash_attn

ATOL = 1e-5
GRAD_ATOL = 1e-4


def _inputs(s, h, kv_h, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, s, h, d)).astype(np.float32),
            rng.normal(size=(2, s, kv_h, d)).astype(np.float32),
            rng.normal(size=(2, s, kv_h, d)).astype(np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# s 64 runs the JAX kernel (one 64-key tile, so its m is the row max);
# s 20 takes the JAX package's dense fallback.
@pytest.mark.parametrize("s", [64, 20])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,kv_h", [(8, 2), (4, 4)])
def test_stats_match_jax_kernel_and_dense_stats(s, causal, h, kv_h):
    arrays = _inputs(s, h, kv_h, seed=s + h)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    kernels.reset_launch_counts()
    o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=causal)
    assert not kernels.launch_counts   # the CPU takes the plain version
    assert o.dtype == m.dtype == l.dtype == torch.float32
    assert o.shape == q.shape and m.shape == l.shape == q.shape[:3]
    for want in (jax_flash_attention_stats(jq, jk, jv, causal=causal),
                 _dense_stats(jq, jk, jv, causal, block_q=16 if s % 16 == 0 else s)):
        for got, ref in zip((o, m, l), want):
            _close(got, ref, ATOL)
    # The plain version is the same function, in the same layout.
    for got, plain in zip((o, m, l), flash_attn.flash_attention_stats_plain(q, k, v, causal)):
        assert torch.equal(got, plain)


@pytest.mark.parametrize("causal", [False, True])
def test_stats_gradient_matches_jax_vjp(causal):
    """The backward recomputes the plain stats under autograd and pulls all
    three cotangents back, as the JAX package's ``_flash_stats_vjp_bwd``."""
    arrays = _inputs(64, 8, 2, seed=7)
    rng = np.random.default_rng(8)
    cot = (rng.normal(size=(2, 64, 8, 16)).astype(np.float32),
           rng.normal(size=(2, 64, 8)).astype(np.float32),
           rng.normal(size=(2, 64, 8)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = flash_attn.flash_attention_stats(*leaves, causal=causal)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention_stats(q, k, v, causal=causal),
                     *(jnp.asarray(a) for a in arrays))
    for leaf, want in zip(leaves, vjp(tuple(jnp.asarray(c) for c in cot))):
        _close(leaf.grad, want, GRAD_ATOL)


def test_stats_function_is_taken_only_when_a_gradient_is_needed(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _inputs(32, 4, 2, seed=3))
    calls = []
    real = flash_attn.FlashStatsFunction.apply
    monkeypatch.setattr(flash_attn.FlashStatsFunction, "apply",
                        lambda *a: calls.append(1) or real(*a))
    flash_attn.flash_attention_stats(q, k, v, causal=True)
    assert not calls
    o, _, _ = flash_attn.flash_attention_stats(q.requires_grad_(), k, v, causal=True)
    assert calls and o.grad_fn is not None


def test_stats_recombine_to_the_attention_and_its_logsumexp():
    """o / l is flash_attention's output and m + log l its lse (float32)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(48, 8, 2, seed=5))
    o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=True)
    want_o, want_lse = flash_attn.flash_attention_lse(q, k, v, causal=True)
    torch.testing.assert_close(o / l[..., None], want_o, rtol=0, atol=2e-6)
    torch.testing.assert_close((m + l.log()).transpose(1, 2)[..., None], want_lse, rtol=0,
                               atol=2e-6)


def test_stats_kernels_have_their_own_launch_count_names():
    assert flash_attn._STATS_KERNELS == {flash_attn.TENSOR_CORES: "flash_attn_fwd_stats",
                                         flash_attn.FMA: "flash_attn_fwd_stats_fma"}
    assert not set(flash_attn._STATS_KERNELS.values()) & set(flash_attn._FWD_KERNELS.values())


def test_cpu_stats_never_reach_a_route_or_a_launcher(monkeypatch):
    def unreachable(*_a, **_k):
        raise AssertionError("reached on CPU tensors")
    for name in ("fwd_route", "_fwd_inputs", "_flash_stats_fwd", "_fwd_launcher"):
        monkeypatch.setattr(flash_attn, name, unreachable)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(40, 4, 2, seed=9))
    o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=True)
    assert torch.isfinite(o).all() and (l >= 1).all()
