"""Data-parallel ResNet-50 on 2 spawned CPU gloo ranks
(``tests/torch_resnet_ranks.py``) against the JAX package on the global
batch: the cross-rank batch norm (``data_group=``) in the forward and the
backward, with and without remat, and the train step; a per-rank batch norm
as the control; the sharded ``DeviceCachedDataset`` against the unsharded
one; ``run_imagenet_bench`` on the ranks; and ``LoaderBase(sharding=)``'s
refusals.

Both modules' ``_RESNET50_STAGES`` are a small net that runs every kind of
block (as ``test_torch_resnet.py``), at 32x32, float32 compute, a global
batch of 8 rows (4 a rank). Bar, per tensor, max |port - JAX| over max
|JAX|: :data:`F32_BAR` = 1e-4 (``test_torch_resnet.py``'s) for the logits,
the loss, the moving statistics, every summed gradient and every parameter
after two SGD steps. The JAX batch norm reduces over the whole batch in one
``jnp.mean``/``jnp.var``; the port folds each rank's count, mean and M2, so
summation order is the only difference left. A per-rank batch norm (4 rows'
statistics) must miss the bar.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_resnet_ranks
from petastorm_tpu.benchmark import imagenet_bench as jax_bench
from petastorm_tpu.models import resnet as jax_resnet
from petastorm_tpu_torch.benchmark.imagenet_bench import write_synthetic_imagenet
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.loader import DataLoader, DeviceCachedDataset
from petastorm_tpu_torch.models import resnet
from petastorm_tpu_torch.parallel import mesh as pmesh
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

P = 2
SMALL = ((1, 8), (2, 8), (1, 16), (1, 16))
CLASSES, SIZE, GLOBAL = 10, 32, 8
F32_BAR = 1e-4
CACHE_ROWS, CACHE_BATCH = 37, 8
BENCH = dict(steps=2, per_device_batch=4, workers_count=2, classes=4, resident_steps=1)


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_leaves(tree) -> list:
    """The JAX tree's leaves in ``resnet.param_leaves``' order, convolutions
    as OIHW."""
    out = []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key not in ("mean", "var"):
            a = np.asarray(node)
            out.append(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)

    walk(tree)
    return out


def stat_leaves(tree) -> list:
    """Every moving statistic of a tree of statistics (or of parameters),
    in a fixed order."""
    out = []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key in ("mean", "var"):
            out.append(np.asarray(node.detach() if isinstance(node, torch.Tensor) else node))

    walk(tree)
    return out


@pytest.fixture(scope="module")
def model():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, "_RESNET50_STAGES", SMALL)
        tree = jax.tree.map(np.asarray, jax.jit(jax_resnet.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), CLASSES))
        rng = np.random.default_rng(2)
        batches = [{"image": rng.random((GLOBAL, SIZE, SIZE, 3)).astype(np.float32),
                    "label": rng.integers(0, CLASSES, GLOBAL).astype(np.int32)}
                   for _ in range(2)]
        mp.setattr(jax_resnet, "apply", partial(jax_resnet.apply, compute_dtype=jnp.float32))

        @jax.jit
        def forward_backward(params, batch):
            logits, _ = jax_resnet.apply(params, batch["image"], train=True)
            (loss, (_, stats)), grads = jax.value_and_grad(jax_resnet.loss_fn, has_aux=True)(
                params, batch)
            return logits, loss, stats, grads

        params = jax.tree.map(jnp.asarray, tree)
        logits, loss, stats, grads = forward_backward(params,
                                                      jax.tree.map(jnp.asarray, batches[0]))
        step = jax.jit(jax_resnet.make_train_step(learning_rate=0.05))
        velocity = jax.tree.map(lambda p: p * 0, params)
        trained, losses = params, []
        for b in batches:
            trained, velocity, step_loss, _ = step(trained, velocity, jax.tree.map(jnp.asarray, b))
            losses.append(float(step_loss))
        want = {"logits": np.asarray(logits), "loss": float(loss), "stats": stat_leaves(stats),
                "grads": jax_leaves(grads), "losses": losses,
                "params": jax_leaves(trained), "trained_stats": stat_leaves(trained)}
    return tree, batches, want


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_resnet_dp")
    cache_url = f"file://{path}/cache"
    schema = Unischema("Cache", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("pixels", np.uint8, (4, 4, 3), NdarrayCodec(), False)])
    rng = np.random.default_rng(7)
    with materialize_dataset_local(cache_url, schema, rows_per_row_group=8) as w:
        for i in range(CACHE_ROWS):
            w.write_row({"id": i, "pixels": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)})
    bench_url = f"file://{path}/img32"
    write_synthetic_imagenet(bench_url, rows=96, classes=4, rows_per_row_group=16,
                             image_size=SIZE)
    return cache_url, bench_url


@pytest.fixture(scope="module")
def ranks(model, stores):
    tree, batches, _ = model
    cache_url, bench_url = stores
    return run_ranks(torch_resnet_ranks.resnet_dp_cases, P,
                     args=(SMALL, tree, batches, cache_url, bench_url, CACHE_BATCH, BENCH),
                     device="cpu", timeout_s=300)


@pytest.mark.parametrize("remat", [False, True])
def test_cross_rank_batch_norm_is_the_jax_global_batch_norm(ranks, model, remat):
    _, _, want = model
    r0, r1 = (r["forward"][remat] for r in ranks)
    logits = torch.cat([r0["logits"], r1["logits"]])
    assert rel(logits, want["logits"]) <= F32_BAR
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - want["loss"]) <= F32_BAR * abs(want["loss"])
    for got0, got1, w in zip(stat_leaves(r0["stats"]), stat_leaves(r1["stats"]), want["stats"]):
        assert np.array_equal(got0, got1)   # the same global statistics on both ranks
        assert rel(got0, w) <= F32_BAR
    assert len(r0["grads"]) == len(want["grads"])
    for got0, got1, w in zip(r0["grads"], r1["grads"], want["grads"]):
        assert torch.equal(got0, got1)
        assert rel(got0, w) <= F32_BAR


def test_a_per_rank_batch_norm_misses_the_bar(ranks, model):
    """The control: each rank's statistics over its own 4 rows (what a
    data-parallel step without the cross-rank batch norm computes)."""
    _, _, want = model
    worst = max(rel(g, w) for g, w in zip(ranks[0]["control"]["grads"], want["grads"]))
    assert worst > F32_BAR


def test_two_rank_train_steps_equal_the_jax_steps(ranks, model):
    tree, _, want = model
    r0, r1 = (r["train"] for r in ranks)
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=F32_BAR)
    start = resnet.param_leaves(resnet.params_from_jax(tree, device="cpu"))
    for got0, got1, w, p0 in zip(r0["params"], r1["params"], want["params"], start):
        assert torch.equal(got0, got1)
        assert rel(got0, w) <= F32_BAR
        assert not torch.equal(got0, p0)
    for got0, got1, w in zip(stat_leaves(r0["stats"]), stat_leaves(r1["stats"]),
                             want["trained_stats"]):
        assert np.array_equal(got0, got1)
        assert rel(got0, w) <= F32_BAR


def _unsharded(url):
    with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        return DeviceCachedDataset(reader, device="cpu")


def test_sharded_cache_slices_concatenate_to_the_unsharded_batches(ranks, stores):
    cache_url, _ = stores
    whole = _unsharded(cache_url)
    c0, c1 = (r["cache"] for r in ranks)
    assert c0["num_rows"] == c1["num_rows"] == CACHE_ROWS
    assert c0["shard_rows"] == c1["shard_rows"] == -(-CACHE_ROWS // P)   # padded to 38
    assert c0["nbytes"] == c1["nbytes"] == c0["shard_rows"] * (8 + 48)
    for got, want in ((zip(c0["epochs"], c1["epochs"]),
                       whole.batches(CACHE_BATCH, num_epochs=2, seed=3)),
                      (zip(c0["tail"], c1["tail"]),
                       whole.batches(CACHE_BATCH, shuffle=False, drop_last=False))):
        got, want = list(got), list(want)
        assert len(got) == len(want)
        for (a, b), w in zip(got, want):
            assert len(a["id"]) == len(b["id"]) or len(w["id"]) % P
            for name in w:
                assert torch.equal(torch.cat([a[name], b[name]]), w[name])
    assert len(c0["epochs"]) == 2 * (CACHE_ROWS // CACHE_BATCH)
    assert [len(b["id"]) for b in c0["tail"]][-1] == 3 and len(c1["tail"][-1]["id"]) == 2
    assert c0["ragged"].startswith("ValueError") and "divide" in c0["ragged"]


def test_bench_on_ranks_gives_the_jax_keys(ranks, stores):
    _, bench_url = stores
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, "_RESNET50_STAGES", SMALL)
        want = jax_bench.run_imagenet_bench(bench_url, **dict(BENCH, steps=1,
                                                               per_device_batch=1))
    r0, r1 = (r["bench"] for r in ranks)
    for got in (r0, r1):
        assert set(got) == set(want) | {"gloo_s"}
        assert got["devices"] == P and got["global_batch"] == P * BENCH["per_device_batch"]
        assert got["samples_per_sec_per_chip"] == got["samples_per_sec"] / P
        assert got["gloo_s"] > 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(resnet, "_RESNET50_STAGES", SMALL)
            assert got["model_flops_per_step_per_chip"] == resnet.resnet50_flops_per_step(
                BENCH["per_device_batch"], SIZE, BENCH["classes"])
    # Both ranks take the same update and report the global batch's loss.
    assert (r0["loss_first"], r0["loss_last"]) == (r1["loss_first"], r1["loss_last"])
    assert np.isfinite(r0["loss_first"]) and np.isfinite(r0["loss_last"])
    for r in ranks:
        assert {"bn_stats", "bn_grad", "all_reduce"} <= set(r["transfers"])


def test_loader_sharding_refusals(stores):
    cache_url, _ = stores
    mesh = pmesh.Mesh({"data": 1, "model": 1}, {})
    with make_reader(cache_url, reader_pool_type="dummy") as reader:
        with pytest.raises(TypeError, match="BatchSharding"):
            DataLoader(reader, batch_size=4, device="cpu", sharding=("data",))
        with pytest.raises(ValueError, match="lacks"):
            DataLoader(reader, batch_size=4, device="cpu",
                       sharding=pmesh.BatchSharding(mesh, ("seq",)))
        with pytest.raises(ValueError, match="other than the batch"):
            DataLoader(reader, batch_size=4, device="cpu",
                       sharding=pmesh.BatchSharding(mesh, ("data", "model")))
        loader = DataLoader(reader, batch_size=4, device="cpu",
                            sharding=pmesh.BatchSharding(mesh, ("data", None, None)))
        with pytest.raises(ValueError, match="fewer than the sharding spec"):
            next(iter(loader))
    with make_reader(cache_url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        batches = list(DataLoader(reader, batch_size=4, device="cpu",
                                  sharding=pmesh.data_sharding(mesh)))
    assert [b["id"].tolist() for b in batches[:2]] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(TypeError, match="BatchSharding"):
        with make_reader(cache_url, reader_pool_type="dummy") as reader:
            DeviceCachedDataset(reader, device="cpu", sharding="data")
