"""Ring and Ulysses attention of petastorm_tpu_torch.parallel against the JAX
package's ``make_ring_attention`` and ``make_ulysses_attention`` on the
virtual CPU mesh, with the port's ranks spawned as processes in one gloo
group (``parallel.launch.run_ranks``), P = 2 and 4. Each spawn runs every
case of its P (``torch_seq_ranks.attention_cases``).

Bars: float32 atol 2e-5 (``tests/test_parallel.py``'s); bfloat16 atol 0.1
against float32 dense attention (its bf16 ring bar); dq, dk and dv against
``jax.vjp`` at 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_seq_ranks
from petastorm_tpu.parallel.attention import dense_attention as jax_dense_attention
from petastorm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from petastorm_tpu.parallel.ring_attention import make_ring_attention as jax_ring
from petastorm_tpu.parallel.ulysses_attention import make_ulysses_attention as jax_ulysses
from petastorm_tpu_torch.parallel import comm
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.parallel.ring_attention import ring_attention
from petastorm_tpu_torch.parallel.ulysses_attention import ulysses_attention

ATOL = 2e-5
GRAD_ATOL = 1e-4
BF16_ATOL = 0.1
B, BLOCK, H, KV_H, D = 2, 16, 8, 4, 8

# (name, strategy, causal, local_attn, local_block_q, dtype, grad, heads)
CASES = [
    ("ring dense causal", "ring", True, "dense", None, "float32", True, None),
    ("ring dense", "ring", False, "dense", None, "float32", False, None),
    ("ring dense causal local_block_q 8", "ring", True, "dense", 8, "float32", True, None),
    ("ring flash causal", "ring", True, "flash", None, "float32", True, None),
    ("ring flash", "ring", False, "flash", None, "float32", True, None),
    ("ulysses dense causal", "ulysses", True, "dense", None, "float32", False, None),
    ("ulysses flash causal", "ulysses", True, "flash", None, "float32", True, None),
    ("ring flash causal bf16", "ring", True, "flash", None, "bfloat16", False, None),
    ("ulysses flash causal bf16", "ulysses", True, "flash", None, "bfloat16", False, None),
    ("ring local_block_q 5", "ring", True, "dense", 5, "float32", False, None),
    # 3 kv heads: P = 2 and 4 divide neither that nor (P = 4) the 6 heads.
    ("ulysses 6 heads over 3", "ulysses", True, "dense", None, "float32", False, (6, 3)),
]
#: The JAX function each float32 case is held against.
JAX_FNS = {
    "ring dense causal": (jax_ring, dict(causal=True)),
    "ring dense": (jax_ring, dict(causal=False)),
    "ring dense causal local_block_q 8": (jax_ring, dict(causal=True, local_block_q=8)),
    "ring flash causal": (jax_ring, dict(causal=True, local_attn="flash")),
    "ring flash": (jax_ring, dict(causal=False, local_attn="flash")),
    "ulysses dense causal": (jax_ulysses, dict(causal=True)),
    "ulysses flash causal": (jax_ulysses, dict(causal=True, local_attn="flash")),
}


def _arrays(p):
    rng = np.random.default_rng(10 + p)
    s = p * BLOCK
    return ([rng.normal(size=(B, s, h, D)).astype(np.float32) for h in (H, KV_H, KV_H)],
            rng.normal(size=(B, s, H, D)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _port(p):
    arrays, cot = _arrays(p)
    per_rank = run_ranks(torch_seq_ranks.attention_cases, p, args=(arrays, cot, CASES),
                         device="cpu", timeout_s=300)
    # Ranks hold consecutive blocks: concatenate along the sequence.
    out = {}
    for name, *_ in CASES:
        parts = [r[name] for r in per_rank]
        if isinstance(parts[0], str):
            out[name] = parts
        else:
            out[name] = tuple(None if parts[0][i] is None
                              else torch.cat([t[i] for t in parts], dim=1) for i in range(4))
    return out


def _jax(p, name):
    """(out, vjp) of the JAX function of ``name`` on a (1, p) mesh."""
    maker, kw = JAX_FNS[name]
    mesh = jax_make_mesh((1, p), ("data", "seq"), devices=jax.devices()[:p])
    fn = jax.jit(maker(mesh, **kw))
    arrays, _ = _arrays(p)
    return jax.vjp(fn, *(jnp.asarray(a) for a in arrays))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("p", [2, 4])
def test_outputs_match_jax(p):
    port = _port(p)
    for name in JAX_FNS:
        want, _ = _jax(p, name)
        assert port[name][0].dtype == torch.float32, name
        _close(port[name][0], want, ATOL)
    # The two strategies are interchangeable.
    _close(port["ring flash causal"][0], port["ulysses flash causal"][0].numpy(), ATOL)
    # bfloat16 inputs: a bfloat16 output within the bar of float32 dense.
    arrays, _ = _arrays(p)
    ref = jax_dense_attention(*(jnp.asarray(a) for a in arrays), causal=True)
    for name in ("ring flash causal bf16", "ulysses flash causal bf16"):
        assert port[name][0].dtype == torch.bfloat16
        _close(port[name][0], ref, BF16_ATOL)
    # Shapes the strategies do not take raise on every rank.
    assert all("local_block_q" in msg for msg in port["ring local_block_q 5"])
    assert all("divisible" in msg for msg in port["ulysses 6 heads over 3"])


@pytest.mark.parametrize("p", [2, 4])
def test_gradients_match_jax_vjp(p):
    port = _port(p)
    _, cot = _arrays(p)
    for name in ("ring dense causal", "ring dense causal local_block_q 8", "ring flash causal",
                 "ring flash", "ulysses flash causal"):
        _, vjp = _jax(p, name)
        for got, want in zip(port[name][1:], vjp(jnp.asarray(cot))):
            _close(got, want, GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_ring_bounds_its_scores_by_local_block_q(monkeypatch, causal):
    """``local_block_q`` bounds the dense ring's scores in the forward and in
    the backward (``flash_attention_bwd_plain(block_q=)``), with the
    gradients of the unchunked ring. One rank (its transfers are no-ops):
    20 keys, d 4, so a product of at most 5 q rows holds at most 5 x 20
    values in any operand or result, where the unchunked ring holds
    20 x 20."""
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.normal(size=(2, 20, 4, 4)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(2, 20, 2, 4)).astype(np.float32)) for _ in range(2))
    sizes, matmul = [], torch.matmul

    def spy(a, b):
        out = matmul(a, b)
        sizes.append(max(t.shape[-2] * t.shape[-1] for t in (a, b, out)))
        return out

    def grads(local_block_q):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sizes.clear()
        with monkeypatch.context() as m:
            m.setattr(torch, "matmul", spy)
            ring_attention(*leaves, group=object(), causal=causal, local_block_q=local_block_q,
                           local_attn="dense").backward(do)
        return max(sizes), [t.grad for t in leaves]

    whole, want = grads(None)
    chunked, got = grads(5)
    assert (whole, chunked) == (20 * 20, 5 * 20)
    for g, w in zip(got, want):   # dk and dv summed over the chunks in another order
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_unknown_local_attn_raises_before_any_transfer():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="local_attn"):
        ring_attention(q, q, q, group=None, local_attn="typo")
    with pytest.raises(ValueError, match="local_attn"):
        ulysses_attention(q, q, q, group=None, local_attn="typo")


def test_a_group_that_is_not_gloo_raises(monkeypatch):
    """No other transport stands in: NCCL (several cards) is not ported."""
    monkeypatch.setattr(comm.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(comm.dist, "get_world_size", lambda group=None: 2)
    t = torch.zeros(3)
    for call in (lambda: comm.rotate([t], object()), lambda: comm.all_to_all([t, t], object()),
                 lambda: comm.all_reduce_([t], object())):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            call()

