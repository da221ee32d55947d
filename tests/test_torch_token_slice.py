"""The token slice as a whole — token store -> dense NGram ``make_reader`` ->
``DataLoader(device="cpu")`` -> Llama ``loss_fn`` with flash attention at
``TINY`` — against the JAX package's chain (``make_reader``, its
``DataLoader``, ``llama.loss_fn`` with ``make_flash_attention``) on the same
parameters.

The staged tokens must be identical; the losses agree within 5e-3 in
bfloat16 (the JAX package's flash-in-Llama bar) and 1e-5 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.jax.loader import DataLoader as JaxDataLoader
from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.ops.flash_attn import make_flash_attention as jax_make_flash
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch import DataLoader, NGram, make_reader
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ops.flash_attn import make_flash_attention

WINDOW, WINDOWS, BATCH = 64, 8, 2


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('token_slice')}/tokens"
    write_token_store(url, windows=WINDOWS, window=WINDOW, vocab=llama.TINY.vocab, seed=0)
    return url


@pytest.fixture(scope="module")
def params():
    jax_params = jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.TINY)
    return llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu"), jax_params


def _spec():
    return ({o: ["ts", "token"] for o in range(WINDOW)},
            dict(delta_threshold=1, timestamp_field="ts", timestamp_overlap=False, dense=True))


@pytest.mark.parametrize("dtype,bar", [("bfloat16", 5e-3), ("float32", 1e-5)])
def test_token_slice_matches_jax_chain(store, params, dtype, bar):
    port_params, jax_params = params
    fields, kw = _spec()
    reader_kwargs = dict(shuffle_row_groups=True, seed=0, workers_count=2)
    with make_reader(store, schema_fields=NGram(fields, **kw), **reader_kwargs) as reader:
        port = [(b["token"], llama.loss_fn(port_params, {"tokens": b["token"]}, llama.TINY,
                                           attn_fn=make_flash_attention(causal=True),
                                           compute_dtype=getattr(torch, dtype), shift="roll"))
                for b in DataLoader(reader, batch_size=BATCH, device="cpu")]
    jax_loss = jax.jit(lambda p, t: jax_llama.loss_fn(
        p, {"tokens": t}, jax_llama.TINY, attn_fn=jax_make_flash(causal=True),
        compute_dtype=getattr(jnp, dtype), shift="roll"))
    with jax_make_reader(store, schema_fields=JaxNGram(fields, **kw), **reader_kwargs) as reader:
        ref = [(np.asarray(b["token"]), float(jax_loss(jax_params, b["token"])))
               for b in JaxDataLoader(reader, batch_size=BATCH)]
    assert len(port) == len(ref) == WINDOWS // BATCH
    for (tokens, loss), (want_tokens, want_loss) in zip(port, ref):
        assert tokens.dtype == torch.int32 and tokens.shape == (BATCH, WINDOW)
        np.testing.assert_array_equal(tokens.numpy(), want_tokens)
        assert torch.isfinite(loss)
        assert float(loss) == pytest.approx(want_loss, abs=bar)
