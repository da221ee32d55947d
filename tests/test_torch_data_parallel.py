"""Data-parallel ingestion and training on 2 spawned CPU gloo ranks
(``tests/torch_mesh_ranks.py``), against the JAX package: each rank's
``MeshDataLoader`` stream is its shard of the JAX loader's plan, read in
order and cut into ``batch_size // 2`` rows; a 2-rank
``make_train_step(data_group=)`` takes the JAX step of the whole batch; and
``run_llm_bench(mesh_ingest=True)`` gives the JAX bench's keys, on the ranks
and in one process.

Bar of the train step: float32 compute, the loss at rtol 1e-4 and every
parameter after two AdamW steps within 1e-4 (a step moves each by about
lr = 3e-4), as the sequence-parallel parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from petastorm_tpu.benchmark.llm_bench import run_llm_bench as jax_run_llm_bench
from petastorm_tpu.jax import MeshDataLoader as JaxMeshDataLoader
from petastorm_tpu.jax import MeshReaderFactory as JaxMeshReaderFactory
from petastorm_tpu.models import llama as jax_llama
from petastorm_tpu_torch.benchmark.llm_bench import run_llm_bench, write_token_store
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.parallel.launch import run_ranks

P = 2
BATCH, SEED, GROUP_ROWS, ROWS = 30, 5, 20, 800
CFG = dict(vocab=64, dim=32, n_layers=2, n_heads=8, n_kv_heads=2, hidden=64)
TINY = dict(vocab=128, dim=32, n_layers=2, n_heads=2, n_kv_heads=1, hidden=64)
BENCH = dict(steps=2, batch_size=8, window=16, model_kwargs=TINY)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = tmp_path_factory.mktemp("torch_dp_scalar")
    pq.write_table(pa.table({"id": np.arange(ROWS, dtype=np.int64),
                             "x": (np.arange(ROWS) * 0.5).astype(np.float32)}),
                   str(path / "part0.parquet"), row_group_size=GROUP_ROWS)
    token_url = f"file://{tmp_path_factory.mktemp('torch_dp_tokens')}/tokens"
    write_token_store(token_url, windows=16, window=16, vocab=128)
    return f"file://{path}", token_url


@pytest.fixture(scope="module")
def model():
    jax_cfg = jax_llama.LlamaConfig(**CFG)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), jax_cfg))
    batches = [np.random.default_rng(s).integers(0, CFG["vocab"], (4, 32)).astype(np.int32)
               for s in (3, 4)]
    return jax_cfg, tree, batches


@pytest.fixture(scope="module")
def ranks(stores, model):
    url, token_url = stores
    _, tree, batches = model
    return run_ranks(torch_mesh_ranks.data_parallel_cases, P,
                     args=(url, token_url, BATCH, SEED, tree, CFG, batches,
                           dict(BENCH, mesh_hosts=P)),
                     device="cpu", timeout_s=300)


def _jax_plan(url, epoch):
    loader = JaxMeshDataLoader(JaxMeshReaderFactory(url, batched=True), batch_size=8,
                               num_hosts=P, seed=SEED)
    plan = loader.epoch_plan(epoch)
    loader.close()
    return plan


@pytest.mark.parametrize("rank", range(P))
def test_each_rank_streams_its_jax_shard_in_order(stores, ranks, rank):
    url, _ = stores
    step = BATCH // P
    want = []
    for epoch in range(2):
        ids = [i for g in _jax_plan(url, epoch)[rank]
               for i in range(GROUP_ROWS * g, GROUP_ROWS * (g + 1))]
        full = len(ids) // step
        want += [(ids[k * step:(k + 1) * step], ids[k * step:(k + 1) * step])
                 for k in range(full)]
        tail = ids[full * step:]
        if tail:   # padded with zeros to this rank's rows, under a __valid__ mask
            want.append((tail + [0] * (step - len(tail)), tail))
    got = [(list(ids), list(valid)) for ids, valid in ranks[rank]["stream"]]
    assert got == want
    assert ranks[rank]["plan"] == [_jax_plan(url, e) for e in range(2)]


def test_the_ranks_together_read_the_store_once_an_epoch(ranks):
    per_epoch = [[], []]
    for r in ranks:
        batches = r["stream"]
        half = len(batches) // 2
        for epoch, part in enumerate((batches[:half], batches[half:])):
            per_epoch[epoch] += [i for _, valid in part for i in valid]
    for ids in per_epoch:
        assert sorted(ids) == list(range(ROWS))


@pytest.mark.parametrize("rank", range(P))
def test_a_rank_reports_and_checkpoints_only_its_own_host(ranks, rank):
    r = ranks[rank]
    report = r["report"]
    assert report["hosts"] == P and report["multiprocess"] is True
    assert list(report["per_host"]) == [rank]
    assert report["per_host"][rank]["rows"] == 2 * ROWS // P
    assert report["reshard_events"] == 0 and report["hosts_lost"] == []
    cursor = r["cursor"]
    assert set(cursor["hosts"]) == {str(rank)} and cursor["num_hosts"] == P
    assert cursor["epoch"] == 0 and cursor["num_rowgroups"] == ROWS // GROUP_ROWS


@pytest.mark.parametrize("rank", range(P))
def test_ranks_refuse_kill_host_and_a_ragged_global_batch(ranks, rank):
    assert ranks[rank]["kill_host"].startswith("NotImplementedError")
    assert ranks[rank]["ragged"].startswith("ValueError") and \
        "divide evenly" in ranks[rank]["ragged"]


def test_two_rank_train_step_equals_the_jax_step_on_the_whole_batch(ranks, model):
    jax_cfg, tree, batches = model
    jax_init, jax_step = jax_llama.make_train_step(jax_cfg, shift="roll",
                                                   compute_dtype=jnp.float32)
    jax_step = jax.jit(jax_step)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jax_init(params)
    jax_losses = []
    for toks in batches:
        params, opt, loss = jax_step(params, opt, {"tokens": jnp.asarray(toks)})
        jax_losses.append(float(loss))
    want = llama.param_leaves(llama.params_from_jax(jax.tree.map(np.asarray, params),
                                                    device="cpu"))
    (losses0, params0), (losses1, params1) = (r["train"] for r in ranks)
    assert losses0 == losses1
    np.testing.assert_allclose(losses0, jax_losses, rtol=1e-4)
    for got0, got1, w in zip(params0, params1, want):
        assert np.array_equal(got0.numpy(), got1.numpy())   # the same summed update
        np.testing.assert_allclose(got0.numpy(), w.numpy(), rtol=0, atol=1e-4)
    moved = [not np.array_equal(a.numpy(), b.numpy()) for a, b in
             zip(params0, llama.param_leaves(llama.params_from_jax(tree, device="cpu")))]
    assert all(moved)


def test_a_train_step_without_the_gradient_sum_misses_the_bar(model):
    """The control: a rank that steps on its own rows' gradient alone (what
    leaving out the sum gives) is outside the bar the ranks meet."""
    jax_cfg, tree, batches = model
    jax_init, jax_step = jax_llama.make_train_step(jax_cfg, shift="roll",
                                                   compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, tree)
    params, _, _ = jax.jit(jax_step)(params, jax_init(params), {"tokens": jnp.asarray(batches[0])})
    want = llama.param_leaves(llama.params_from_jax(jax.tree.map(np.asarray, params),
                                                    device="cpu"))
    cfg = llama.LlamaConfig(**CFG)
    mine = llama.params_from_jax(tree, device="cpu")
    init_opt, step = llama.make_train_step(cfg, shift="roll", compute_dtype=torch.float32)
    step(mine, init_opt(mine), {"tokens": torch.from_numpy(batches[0][:2])})
    worst = max(np.abs(g.detach().numpy() - w.numpy()).max()
                for g, w in zip(llama.param_leaves(mine), want))
    assert worst > 1e-4


def test_bench_on_ranks_gives_the_jax_keys_and_the_global_batch(ranks, stores):
    _, token_url = stores
    want = jax_run_llm_bench(token_url, mesh_ingest=True, mesh_hosts=P, **BENCH)
    r0, r1 = (r["bench"] for r in ranks)
    for got in (r0, r1):
        assert set(want) <= set(got), set(want) - set(got)
        assert got["devices"] == P and got["mesh_ingest"] is True and got["mesh_hosts"] == P
        assert got["tokens_per_step"] == want["tokens_per_step"] == 8 * 16
        assert got["mesh_report"]["multiprocess"] is True
        assert set(got["mesh_report"]) == set(want["mesh_report"]) - {"quality"}
    # Both ranks take the same update and report the global batch's loss.
    assert r0["loss_first"] == r1["loss_first"] and r0["loss_last"] == r1["loss_last"]
    assert np.isfinite(r0["loss_first"]) and np.isfinite(r0["loss_last"])


def test_bench_in_one_process_gives_the_jax_keys(stores):
    _, token_url = stores
    want = jax_run_llm_bench(token_url, mesh_ingest=True, mesh_hosts=P, **BENCH)
    got = run_llm_bench(token_url, mesh_ingest=True, mesh_hosts=P, device="cpu", **BENCH)
    assert set(want) <= set(got), set(want) - set(got)
    assert got["mesh_hosts"] == want["mesh_hosts"] == P and got["devices"] == 1
    report = got["mesh_report"]
    assert report["hosts"] == P and report["multiprocess"] is False
    assert sum(h["rows"] for h in report["per_host"].values()) >= 3 * 8
    with pytest.raises(ValueError, match="dense=True"):
        run_llm_bench(token_url, mesh_ingest=True, dense=False, device="cpu", **BENCH)
