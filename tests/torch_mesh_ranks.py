"""Rank functions for the data-parallel tests of petastorm_tpu_torch.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package (as ``torch_seq_ranks``). Each function runs several cases in
one spawn and returns plain values for the test process to hold against the
JAX package.
"""
import numpy as np
import torch

from petastorm_tpu_torch.benchmark.llm_bench import run_llm_bench
from petastorm_tpu_torch.loader import MeshDataLoader, MeshReaderFactory
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel import mesh as pmesh


def _error(fn):
    """``"<type>: <message>"`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type and the message
        return f"{type(e).__name__}: {e}"
    return None


def mesh_arithmetic(rank, world):
    """``parallel.mesh``'s rank arithmetic on this rank, over a 1-D data mesh
    and a (data, seq) mesh of one data rank."""
    data = pmesh.make_mesh([-1], ["data"])
    grid = pmesh.make_mesh([1, world], ["data", "seq"])
    return {
        "shard": pmesh.reader_shard_for_mesh(data),
        "shard_default": pmesh.reader_shard_for_mesh(),
        "shard_grid": pmesh.reader_shard_for_mesh(grid),
        "topology": pmesh.mesh_feed_topology(data),
        "topology_same": pmesh.mesh_feed_topology(data, num_hosts=world),
        "topology_conflict": _error(lambda: pmesh.mesh_feed_topology(data, num_hosts=world + 1)),
        "topology_grid": pmesh.mesh_feed_topology(grid),
        "local_batch": pmesh.process_local_batch_size(8, data),
        "local_batch_ragged": _error(lambda: pmesh.process_local_batch_size(7, data)),
        "global_batch": pmesh.global_batch_size(3, data),
        "shard_count": pmesh.batch_shard_count(data, ("data",)),
    }


def _valid(batch, column="id"):
    ids = batch[column]
    if "__valid__" in batch:
        ids = ids[batch["__valid__"]]
    return ids.tolist()


def data_parallel_cases(rank, world, url, token_url, batch_size, seed, jax_params, cfg_kwargs,
                        token_batches, tiny_bench):
    """Everything the data-parallel tests read off the ranks, in one spawn:

    * ``stream``: each batch of a 2-epoch ``MeshDataLoader`` over ``url``
      (batched reader, ``batch_size`` global rows, pad_last) as
      ``(ids, valid rows)``, the cursor after the first batch, and the
      error of ``kill_host`` and of a ragged global batch;
    * ``train``: two float32 AdamW steps of the Llama (``params_from_jax``)
      with ``data_group=``, this rank's rows of each of ``token_batches``
      -> the losses and the parameters after the steps;
    * ``bench``: ``run_llm_bench(mesh_ingest=True)`` on ``token_url``.
    """
    torch.set_num_threads(1)
    out = {}
    factory = MeshReaderFactory(url, batched=True)
    loader = MeshDataLoader(factory, batch_size=batch_size, seed=seed, num_epochs=2,
                            device="cpu", drop_last=False, pad_last=True)
    batches, cursor = [], None
    with loader:
        for batch in loader:
            batches.append((batch["id"].tolist(), _valid(batch)))
            if cursor is None:
                cursor = loader.state_dict()
                out["kill_host"] = _error(lambda: loader.kill_host(0))
        out["report"] = loader.mesh_report()
    out["stream"] = batches
    out["cursor"] = cursor
    out["plan"] = [loader.epoch_plan(e) for e in range(2)]
    out["ragged"] = _error(lambda: MeshDataLoader(factory, batch_size=world * 3 + 1,
                                                  device="cpu", pad_last=True))

    cfg = llama.LlamaConfig(**cfg_kwargs)
    group = pmesh.make_mesh([-1], ["data"]).group("data")
    params = llama.params_from_jax(jax_params, device="cpu")
    init_opt, step = llama.make_train_step(cfg, shift="roll", compute_dtype=torch.float32,
                                           data_group=group)
    opt = init_opt(params)
    rows = token_batches[0].shape[0] // world
    losses = []
    for toks in token_batches:
        mine = torch.from_numpy(np.ascontiguousarray(toks[rank * rows:(rank + 1) * rows]))
        _, opt, loss = step(params, opt, {"tokens": mine})
        losses.append(loss.item())
    out["train"] = (losses, [t.detach().clone() for t in llama.param_leaves(params)])

    result = run_llm_bench(token_url, mesh_ingest=True, device="cpu", **tiny_bench)
    out["bench"] = result
    return out


def card_data_parallel_step(rank, world, token_url, window, cfg_kwargs):
    """One bf16 AdamW step of ``LlamaConfig(**cfg_kwargs)`` (weights drawn
    from seed 0) on ``cuda:0``, with ``data_group=``, on this rank's first
    batch of a ``MeshDataLoader`` over ``token_url`` (global batch
    ``world``) -> (the rank's tokens, the loss, the parameters after the
    step, on the host)."""
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.ops.flash_attn import make_flash_attention
    cfg = llama.LlamaConfig(**cfg_kwargs)
    ngram = NGram({o: ["ts", "token"] for o in range(window)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    factory = MeshReaderFactory(token_url, schema_fields=ngram)
    with MeshDataLoader(factory, batch_size=world, seed=0, device="cuda") as loader:
        it = iter(loader)
        tokens = next(it)["token"]
        it.close()
    group = pmesh.make_mesh([-1], ["data"]).group("data")
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    init_opt, step = llama.make_train_step(cfg, shift="roll",
                                           attn_fn=make_flash_attention(causal=True),
                                           data_group=group)
    opt = init_opt(params)
    _, _, loss = step(params, opt, {"tokens": tokens})
    return (tokens.cpu(), loss.item(), [t.detach().cpu() for t in llama.param_leaves(params)])

