"""A dataset held in device memory (the JAX package's ``jax/device_cache.py``).

:class:`InMemBatchedDataLoader` keeps a dataset in host memory and copies
every batch onto the card. A dataset that fits in device memory needs no
host in the loop at all: :class:`DeviceCachedDataset` loads every row onto
the card once, then serves each epoch as gathers on the card
(``index_select``) in an order drawn on the card from a ``torch.Generator``
seeded from ``(seed, epoch)``. After the load an epoch makes no
host-to-device copy.

The permutations cannot be ``jax.random``'s, so a shuffled epoch agrees
with the JAX package's by its properties (every row once, a new order each
epoch, the same order for the same seed); with ``shuffle=False`` the
batches are the JAX package's, bit for bit.

Sharded layout (``sharding=``, a :class:`~petastorm_tpu_torch.parallel.mesh.BatchSharding`
over one mesh axis of data ranks): the JAX cache lays its rows out over the
devices of the axis and gathers a global permutation across them. Here rank
r of the axis holds the r-th contiguous shard of the rows, padded with zero
rows up to a multiple of the axis size as the JAX cache pads. Every rank
draws the same order, and each step's global batch is split over the ranks
in order: rank r serves its slice of the step and gathers the rows that the
other ranks hold through :func:`~petastorm_tpu_torch.parallel.comm.all_to_all`
(through the host: gloo). The ranks' slices, concatenated, are the unsharded
cache's batch, bit for bit.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from petastorm_tpu_torch.loader.dtypes import DEFAULT_POLICY, DTypePolicy, sanitize_batch
from petastorm_tpu_torch.loader.loader import InMemBatchedDataLoader, resolve_device
from petastorm_tpu_torch.ops.augment import seeded_generator


def _data_axis(sharding):
    """``(group, ranks, rank)`` of the mesh axis a ``BatchSharding`` splits
    the batch over, or None for a replicated layout."""
    from petastorm_tpu_torch.parallel.mesh import BatchSharding
    if not isinstance(sharding, BatchSharding):
        raise TypeError(f"sharding must be a parallel.mesh.BatchSharding, got "
                        f"{type(sharding).__name__}")
    spec = tuple(sharding.spec)
    if not spec or spec[0] is None:
        return None
    if not isinstance(spec[0], str):
        raise ValueError(f"DeviceCachedDataset shards its rows over one mesh axis; got the "
                         f"batch spec {spec[0]!r}")
    group = sharding.mesh.group(spec[0])
    return group, torch.distributed.get_world_size(group), torch.distributed.get_rank(group)


class DeviceCachedDataset:
    """Load all rows of ``reader`` onto ``device``; iterate epochs of
    shuffled fixed-size batches without touching the host again.

    :param reader: a ``make_reader`` or ``make_batch_reader`` reader (read
        to its end here, not closed). With ``sharding`` every rank reads the
        whole dataset and keeps its shard
    :param device: ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``
    :param dtype_policy: how columns become tensors; columns it keeps on the
        host are left out, with a warning
    :param sharding: ``None`` (the whole cache on this device), or a
        ``BatchSharding``: over one data axis, this rank holds its shard of
        the rows (see the module docstring); replicated, the whole cache
    """

    def __init__(self, reader, device="cuda", dtype_policy: DTypePolicy = DEFAULT_POLICY,
                 sharding=None):
        self._device = resolve_device(device)
        self._axis = None if sharding is None else _data_axis(sharding)
        # The in-memory loader's one read and its column rules; it is never
        # iterated, so it stays on the CPU.
        staging = InMemBatchedDataLoader(reader, batch_size=1, num_epochs=1, shuffle=False,
                                         device="cpu", dtype_policy=dtype_policy)
        host = staging._data
        del staging
        device_cols, host_cols = sanitize_batch(host, dtype_policy)
        del host
        if host_cols:
            warnings.warn(f"Columns {sorted(host_cols)} are not device-representable and stay "
                          f"on the host; they are not served by DeviceCachedDataset batches.")
        if not device_cols:
            raise ValueError(f"No device-representable columns remain after sanitization "
                             f"(host-only: {sorted(host_cols)}); adjust the DTypePolicy or the "
                             f"schema_fields selection")
        self.num_rows = len(next(iter(device_cols.values())))
        #: Rows a rank holds (its shard, padding included; all rows unsharded).
        self.shard_rows = self.num_rows
        lo = 0
        if self._axis is not None:
            ranks, rank = self._axis[1], self._axis[2]
            self.shard_rows = -(-self.num_rows // ranks)
            lo = rank * self.shard_rows
        # One column at a time, each host copy dropped before the next
        # upload: the host holds about one copy of the dataset at most.
        self._data = {}
        for name in list(device_cols):
            col = device_cols.pop(name)
            if not isinstance(col, torch.Tensor):
                col = torch.from_numpy(np.ascontiguousarray(col))
            shard = col[lo:lo + self.shard_rows]
            if len(shard) < self.shard_rows:   # the last shard's zero padding
                pad = shard.new_zeros((self.shard_rows - len(shard),) + tuple(shard.shape[1:]))
                shard = torch.cat([shard, pad])
            self._data[name] = shard.to(self._device)
            del col, shard

    @property
    def columns(self):
        return sorted(self._data)

    def nbytes(self) -> int:
        """Bytes of the cached columns on this device (this rank's shard)."""
        return sum(v.nbytes for v in self._data.values())

    def batches(self, batch_size: int, num_epochs: int = 1, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True):
        """Yield ``{name: tensor}`` batches on the device, ``num_epochs``
        epochs, each in a new order when ``shuffle`` (drawn on the device
        from a generator seeded from ``(seed, epoch)``). With ``drop_last``
        the short last batch of an epoch is skipped; without, it is served.

        Sharded: ``batch_size`` is the global batch, which must divide over
        the ranks; rank r yields rows ``[r B/P, (r+1) B/P)`` of each step's
        global batch (a short last batch splits as ``np.array_split``
        splits it). Every rank must iterate in step: each batch is a
        collective."""
        n = self.num_rows
        steps = n // batch_size if drop_last else -(-n // batch_size)
        if steps == 0:
            raise ValueError(f"batch_size {batch_size} exceeds dataset rows {n}")
        if self._axis is not None and batch_size % self._axis[1]:
            raise ValueError(f"the global batch_size {batch_size} must divide over the "
                             f"{self._axis[1]} data ranks")
        for epoch in range(num_epochs):
            if shuffle:
                order = torch.randperm(n, generator=seeded_generator((seed, epoch), self._device),
                                       device=self._device)
            else:
                order = torch.arange(n, device=self._device)
            for step in range(steps):
                idx = order[step * batch_size:(step + 1) * batch_size]
                if self._axis is None:
                    yield {k: v.index_select(0, idx) for k, v in self._data.items()}
                else:
                    yield self._gather_slice(idx)

    def _gather_slice(self, idx: torch.Tensor) -> dict:
        """This rank's slice of the global batch ``idx``: the rows it holds
        gathered on the card, the others received from their ranks."""
        from petastorm_tpu_torch.parallel import comm
        group, ranks, rank = self._axis
        slices = torch.tensor_split(idx, ranks)
        owner = [s // self.shard_rows for s in slices]
        # What each rank receives from here: its slice's rows held here, in
        # slice order; what this rank receives from each: the same rule.
        send_pos = [slices[d][owner[d] == rank] - rank * self.shard_rows for d in range(ranks)]
        mine = [owner[rank] == src for src in range(ranks)]
        counts = [int(m.sum()) for m in mine]
        out = {}
        for name, col in self._data.items():
            chunks = [col.index_select(0, p) for p in send_pos]
            got = comm.all_to_all(chunks, group,
                                  recv_shapes=[(c,) + tuple(col.shape[1:]) for c in counts])
            batch = col.new_empty((len(slices[rank]),) + tuple(col.shape[1:]))
            for src in range(ranks):
                batch[mine[src]] = got[src]
            out[name] = batch
        return out
