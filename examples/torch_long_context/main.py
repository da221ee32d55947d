"""Long-context training end to end: NGram token windows -> batches on a
data x sequence mesh of ranks -> Llama with GQA ring (or Ulysses) attention,
sequence parallelism.

* **Data**: a chunked token-stream Parquet store read as dense NGram
  windows. The JAX example merges small row groups with
  ``rowgroup_coalescing`` so its windows may span them; this package has no
  coalescing yet, so the store is written in groups of 256 chunks, large
  enough that no window spans two.
* **Staging**: each rank's ``DataLoader`` stages its data shard's windows
  onto its device (every rank of a sequence group reads the same windows in
  the same order: the thread pool's seeded round-robin order).
* **Compute**: the window is split over the ``seq`` ranks; ring attention
  rotates K/V blocks around them at native GQA width (its local step the
  flash kernels: K2 "stats", K3, K4), Ulysses swaps sequence for heads with
  all-to-alls around a local flash attention (K2 "lse", K3, K4).

The ranks are processes in one gloo group
(:func:`~petastorm_tpu_torch.parallel.launch.run_ranks`); with
``--device cuda`` they share ``cuda:0``.

    PYTHONPATH=. python examples/torch_long_context/main.py [--url URL] \
        [--ranks 2] [--dp 1] [--attn ring|ulysses] [--steps 30] [--device cuda]

The store goes to ``long_context_torch`` under the temporary directory
(``$TMPDIR``) unless ``--url`` names another place.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

CHUNK = 64  # tokens a stored row
#: Chunks a row group: larger than any window, so none spans two groups.
ROWS_PER_GROUP = 256


def write_token_stream(url: str, n_chunks: int, vocab: int, seed: int = 0):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("TokenSchema", [
        UnischemaField("seq", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("tokens", np.int32, (CHUNK,), NdarrayCodec(), False),
    ])
    rng = np.random.default_rng(seed)
    tokens = np.empty(n_chunks * CHUNK, np.int32)
    tokens[0] = 1
    noise = rng.integers(0, 4, n_chunks * CHUNK)
    for i in range(1, len(tokens)):
        tokens[i] = (tokens[i - 1] * 31 + noise[i]) % vocab
    with materialize_dataset_local(url, schema, rows_per_row_group=ROWS_PER_GROUP) as w:
        for c in range(n_chunks):
            w.write_row({"seq": c, "tokens": tokens[c * CHUNK:(c + 1) * CHUNK]})


def rank_train(rank: int, world_size: int, url: str, steps: int, per_shard_batch: int,
               window: int, vocab: int, dp: int, attn_kind: str, local_attn: str,
               device: str) -> dict:
    """One rank: its data shard's windows of ``window`` chunks, its block of
    each, AdamW (lr 1e-3) on a 2-layer Llama (dim 128, 8 heads over 4 kv
    heads). The loss is the window's (``shift="roll"``: the model reads
    ``window * CHUNK`` tokens and predicts each next one, the last left
    out), summed over the mesh. Returns the losses, tokens/s and this
    rank's kernel launch counts."""
    from petastorm_tpu_torch import DataLoader, NGram, kernels, make_reader
    from petastorm_tpu_torch.models import llama
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.ring_attention import make_ring_attention
    from petastorm_tpu_torch.parallel.ulysses_attention import make_ulysses_attention

    dev = torch.device(device)
    if dev.type == "cpu":
        # The ranks share the host's cores: one intra-op pool each would
        # oversubscribe them.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    sp = world_size // dp
    mesh = make_mesh((dp, sp), ("data", "seq"))
    maker = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}[attn_kind]
    attn = maker(mesh, seq_axis="seq", data_axis="data", causal=True, local_attn=local_attn)
    cfg = llama.LlamaConfig(vocab=vocab, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                            hidden=256)
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    init_opt, step = llama.make_train_step(
        cfg, learning_rate=1e-3, attn_fn=attn, shift="roll", seq_group=mesh.group("seq"),
        data_group=mesh.group("data") if dp > 1 else None)
    opt = init_opt(params)
    ngram = NGram({i: ["tokens"] for i in range(window)}, delta_threshold=1,
                  timestamp_field="seq", timestamp_overlap=True, dense=True)
    shard = {"cur_shard": rank // sp, "shard_count": dp} if dp > 1 else {}
    with make_reader(url, schema_fields=ngram, num_epochs=None, shuffle_row_groups=True, seed=0,
                     workers_count=2, **shard) as reader:
        loader = DataLoader(reader, batch_size=per_shard_batch, device=dev)
        it = iter(loader)

        def next_tokens():
            return next(it)["tokens"].reshape(per_shard_batch, -1).long()

        params, opt, loss = step(params, opt, {"tokens": next_tokens()})
        loss.item()   # warm-up: the first step builds the kernels
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt, loss = step(params, opt, {"tokens": next_tokens()})
            losses.append(loss.item())
        dt = time.perf_counter() - t0
        it.close()
    return {"losses": losses,
            "tokens_per_sec": steps * per_shard_batch * dp * window * CHUNK / dt,
            "launches": dict(kernels.launch_counts)}


def train(url: str, ranks: int = 2, dp: int = 1, steps: int = 30, per_shard_batch: int = 2,
          window: int = 8, vocab: int = 256, attn_kind: str = "ring", local_attn: str = "flash",
          device: str = "cuda") -> list:
    """:func:`rank_train` on ``ranks`` spawned ranks (a ``dp`` x
    ``ranks // dp`` mesh); returns each rank's result."""
    from petastorm_tpu_torch.parallel.launch import run_ranks
    if ranks % dp:
        raise ValueError(f"--ranks ({ranks}) must be a multiple of --dp ({dp})")
    if (window * CHUNK) % (ranks // dp):
        raise ValueError(f"the window ({window * CHUNK} tokens) must split into "
                         f"{ranks // dp} equal blocks")
    return run_ranks(rank_train, ranks,
                     args=(url, steps, per_shard_batch, window, vocab, dp, attn_kind,
                           local_attn, device), device=device)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="file://" + os.path.join(tempfile.gettempdir(),
                                                                   "long_context_torch"))
    parser.add_argument("--chunks", type=int, default=8192)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--attn", default="ring", choices=["ring", "ulysses"])
    parser.add_argument("--local-attn", default="flash", choices=["flash", "dense"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if not os.path.exists(args.url.replace("file://", "") + "/_common_metadata"):
        write_token_stream(args.url, args.chunks, args.vocab)
    results = train(args.url, ranks=args.ranks, dp=args.dp, steps=args.steps,
                    window=args.window, vocab=args.vocab, attn_kind=args.attn,
                    local_attn=args.local_attn, device=args.device)
    losses = results[0]["losses"]
    print(f"mesh dp{args.dp} x sp{args.ranks // args.dp} seq_len={args.window * CHUNK} "
          f"throughput={results[0]['tokens_per_sec']:,.0f} tokens/sec "
          f"final_loss={losses[-1]:.4f} (random={np.log(args.vocab):.2f})")
    assert losses[-1] < losses[0], "loss did not decrease"


if __name__ == "__main__":
    main()
