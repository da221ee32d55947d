"""Rank functions for the data-parallel ResNet-50 tests of petastorm_tpu_torch.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package (as ``torch_mesh_ranks``). One function runs every case in one
spawn and returns plain values for the test process to hold against the JAX
package.
"""
from functools import partial

import numpy as np
import torch

from petastorm_tpu_torch.benchmark.imagenet_bench import run_imagenet_bench
from petastorm_tpu_torch.loader import DeviceCachedDataset
from petastorm_tpu_torch.models import resnet
from petastorm_tpu_torch.parallel import comm
from petastorm_tpu_torch.parallel import mesh as pmesh
from petastorm_tpu_torch.reader import make_reader


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _grads(params) -> list:
    return [t.grad.detach().clone() for t in resnet.param_leaves(params)]


def resnet_dp_cases(rank, world, stages, jax_params, batches, cache_url, bench_url, cache_batch,
                    bench):
    """Everything the data-parallel ResNet tests read off the ranks:

    * ``forward``: for ``remat`` False and True, this rank's rows of
      ``batches[0]`` through ``loss_fn(data_group=)`` in float32 on the
      ``params_from_jax`` weights -> its logits, the loss, the new moving
      statistics and the gradients summed over the ranks;
    * ``control``: the same with a per-rank batch norm (no ``data_group``
      in the forward; this rank's mean loss, gradients averaged over the
      ranks);
    * ``train``: two SGD steps of ``make_train_step(data_group=)`` on this
      rank's rows of ``batches`` -> the losses and the parameters and
      moving statistics after them;
    * ``cache``: ``DeviceCachedDataset(sharding=data_sharding(mesh))`` of
      ``cache_url`` -> this rank's rows and bytes, and its slices of 2
      epochs at the global ``cache_batch`` (and a ``drop_last=False`` pass);
    * ``bench``: ``run_imagenet_bench(**bench)`` on ``bench_url``.
    """
    torch.set_num_threads(1)
    resnet._RESNET50_STAGES = stages
    f32_apply = resnet.apply
    resnet.apply = partial(f32_apply, compute_dtype=torch.float32)
    mesh = pmesh.make_mesh([-1], ["data"])
    group = mesh.group("data")
    out = {}
    rows = batches[0]["image"].shape[0] // world
    mine = [_tensors({k: v[rank * rows:(rank + 1) * rows] for k, v in b.items()})
            for b in batches]

    forward = {}
    for remat in (False, True):
        params = resnet.params_from_jax(jax_params, device="cpu")
        for t in resnet.param_leaves(params):
            t.requires_grad_(True)
        logits = resnet.apply(params, mine[0]["image"], train=True, data_group=group)[0]
        loss, (acc, stats) = resnet.loss_fn(params, mine[0], remat=remat, data_group=group)
        loss.backward()
        grads = _grads(params)
        comm.all_reduce_(grads, group)
        summed = loss.detach().clone()
        comm.all_reduce_([summed], group)
        forward[remat] = {"logits": logits.detach(), "loss": summed.item(),
                          "stats": stats, "grads": grads}
    out["forward"] = forward

    params = resnet.params_from_jax(jax_params, device="cpu")
    for t in resnet.param_leaves(params):
        t.requires_grad_(True)
    loss, _ = resnet.loss_fn(params, mine[0])
    loss.backward()
    grads = _grads(params)
    comm.all_reduce_(grads, group)
    out["control"] = {"grads": [g / world for g in grads]}

    params = resnet.params_from_jax(jax_params, device="cpu")
    init_opt, step = resnet.make_train_step(learning_rate=0.05, data_group=group)
    opt = init_opt(params)
    losses = []
    for b in mine:
        params, opt, loss, _ = step(params, opt, b)
        losses.append(loss.item())
    out["train"] = {"losses": losses,
                    "params": [t.detach().clone() for t in resnet.param_leaves(params)],
                    "stats": params}

    with make_reader(cache_url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        cache = DeviceCachedDataset(reader, device="cpu",
                                    sharding=pmesh.data_sharding(mesh))
    out["cache"] = {"nbytes": cache.nbytes(), "shard_rows": cache.shard_rows,
                    "num_rows": cache.num_rows,
                    "epochs": [{k: v.clone() for k, v in b.items()}
                               for b in cache.batches(cache_batch, num_epochs=2, seed=3)],
                    "tail": [{k: v.clone() for k, v in b.items()}
                             for b in cache.batches(cache_batch, shuffle=False,
                                                    drop_last=False)],
                    "ragged": _error(lambda: next(cache.batches(cache_batch + 1)))}

    resnet.apply = f32_apply   # the bench trains in bf16, as it does on the card
    comm.reset_transfer_stats()
    out["bench"] = run_imagenet_bench(bench_url, device="cpu", **bench)
    out["transfers"] = dict(comm.transfer_stats)
    return out


def _error(fn):
    """``"<type>: <message>"`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type and the message
        return f"{type(e).__name__}: {e}"
    return None
