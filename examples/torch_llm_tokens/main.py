"""LLM pretraining tokens through the PyTorch/CUDA package (BASELINE
config 5): a token-stream Parquet store read as NGram windows, batched and
staged onto the card by ``DataLoader``, feeding a Llama-style decoder whose
attention is the flash kernels: K2 ("lse") forward, K3 and K4 backward.

Each row is one fixed-size token *chunk* of a document stream (``seq`` is
the chunk's ordinal, the NGram's timestamp); an NGram of length W joins W
consecutive chunks into one training sequence, never across row groups (so
sharding row groups over ranks needs no coordination between them).

    PYTHONPATH=. python examples/torch_llm_tokens/main.py [--url URL] \
        [--chunks 4096] [--steps 40] [--vocab 256] [--device cuda]

The store goes to ``llm_tokens_torch`` under the temporary directory
(``$TMPDIR``) unless ``--url`` names another place.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from petastorm_tpu_torch import DataLoader, NGram, make_reader
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ops.flash_attn import make_flash_attention
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

CHUNK = 64  # tokens a stored row

TokenSchema = Unischema("TokenSchema", [
    UnischemaField("seq", np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField("tokens", np.int32, (CHUNK,), NdarrayCodec(), False),
])


def token_stream(n_chunks: int, vocab: int, seed: int = 0) -> np.ndarray:
    """A synthetic Markov-like stream with structure to learn: each token is
    ``(previous * 31 + noise) % vocab``, noise in 0..3."""
    rng = np.random.default_rng(seed)
    tokens = np.empty(n_chunks * CHUNK, np.int32)
    tokens[0] = 1
    noise = rng.integers(0, 4, n_chunks * CHUNK)
    for i in range(1, len(tokens)):
        tokens[i] = (tokens[i - 1] * 31 + noise[i]) % vocab
    return tokens


def write_token_stream(url: str, n_chunks: int, vocab: int, seed: int = 0,
                       rows_per_row_group: int = 256):
    tokens = token_stream(n_chunks, vocab, seed)
    with materialize_dataset_local(url, TokenSchema, rows_per_row_group=rows_per_row_group) as w:
        for c in range(n_chunks):
            w.write_row({"seq": c, "tokens": tokens[c * CHUNK:(c + 1) * CHUNK]})


def train(url: str, steps: int = 40, batch_size: int = 8, window: int = 4, vocab: int = 256,
          device: str = "cuda", log=print) -> dict:
    """``steps`` AdamW steps (lr 1e-3) of a 2-layer Llama (dim 128, 8 heads
    over 4 kv heads) on windows of ``window`` chunks, after one warm-up
    step; returns the losses and tokens/s."""
    dev = torch.device(device)
    cfg = llama.LlamaConfig(vocab=vocab, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                            hidden=256)
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    init_opt, step = llama.make_train_step(cfg, learning_rate=1e-3,
                                           attn_fn=make_flash_attention(causal=True))
    opt = init_opt(params)
    # dense=True: a window arrives as {"tokens": (window, CHUNK)}, and the
    # loader stacks a batch to (batch, window, CHUNK).
    ngram = NGram({i: ["tokens"] for i in range(window)}, delta_threshold=1,
                  timestamp_field="seq", timestamp_overlap=True, dense=True)
    with make_reader(url, schema_fields=ngram, num_epochs=None, shuffle_row_groups=True,
                     seed=0, workers_count=2) as reader:
        loader = DataLoader(reader, batch_size=batch_size, device=dev)
        it = iter(loader)

        def next_tokens():
            return next(it)["tokens"].reshape(batch_size, -1).long()

        params, opt, loss = step(params, opt, {"tokens": next_tokens()})
        loss.item()   # warm-up: the first step builds the kernels
        losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt, loss = step(params, opt, {"tokens": next_tokens()})
            losses.append(loss.item())
            if (i + 1) % 10 == 0:
                log(f"step {i + 1}: loss={np.mean(losses[-10:]):.4f}")
        dt = time.perf_counter() - t0
        it.close()
    return {"losses": losses, "tokens_per_sec": steps * batch_size * window * CHUNK / dt}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="file://" + os.path.join(tempfile.gettempdir(),
                                                                   "llm_tokens_torch"))
    parser.add_argument("--chunks", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if not os.path.exists(args.url.replace("file://", "") + "/_common_metadata"):
        print("writing token stream store...")
        write_token_stream(args.url, args.chunks, args.vocab)
    result = train(args.url, steps=args.steps, vocab=args.vocab, device=args.device)
    losses = result["losses"]
    print(f"throughput={result['tokens_per_sec']:,.0f} tokens/sec seq_len={4 * CHUNK} "
          f"final_loss={losses[-1]:.4f} (random={np.log(args.vocab):.2f})")
    assert losses[-1] < losses[0], "loss did not decrease"


if __name__ == "__main__":
    main()
