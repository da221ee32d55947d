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
batches are the JAX package's, bit for bit. The JAX package's ``sharding=``
(a cache laid out over several devices) is not ported: one card holds the
cache.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from petastorm_tpu_torch.loader.dtypes import DEFAULT_POLICY, DTypePolicy, sanitize_batch
from petastorm_tpu_torch.loader.loader import InMemBatchedDataLoader, resolve_device
from petastorm_tpu_torch.ops.augment import seeded_generator


class DeviceCachedDataset:
    """Load all rows of ``reader`` onto ``device``; iterate epochs of
    shuffled fixed-size batches without touching the host again.

    :param reader: a ``make_reader`` or ``make_batch_reader`` reader (read
        to its end here, not closed)
    :param device: ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``
    :param dtype_policy: how columns become tensors; columns it keeps on the
        host are left out, with a warning
    """

    def __init__(self, reader, device="cuda", dtype_policy: DTypePolicy = DEFAULT_POLICY):
        self._device = resolve_device(device)
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
        # One column at a time, each host copy dropped before the next
        # upload: the host holds about one copy of the dataset at most.
        self._data = {}
        for name in list(device_cols):
            col = device_cols.pop(name)
            if not isinstance(col, torch.Tensor):
                col = torch.from_numpy(np.ascontiguousarray(col))
            self._data[name] = col.to(self._device)
            del col

    @property
    def columns(self):
        return sorted(self._data)

    def nbytes(self) -> int:
        """Bytes of the cached columns on the device."""
        return sum(v.nbytes for v in self._data.values())

    def batches(self, batch_size: int, num_epochs: int = 1, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True):
        """Yield ``{name: tensor}`` batches on the device, ``num_epochs``
        epochs, each in a new order when ``shuffle`` (drawn on the device
        from a generator seeded from ``(seed, epoch)``). With ``drop_last``
        the short last batch of an epoch is skipped; without, it is served."""
        n = self.num_rows
        steps = n // batch_size if drop_last else -(-n // batch_size)
        if steps == 0:
            raise ValueError(f"batch_size {batch_size} exceeds dataset rows {n}")
        for epoch in range(num_epochs):
            if shuffle:
                order = torch.randperm(n, generator=seeded_generator((seed, epoch), self._device),
                                       device=self._device)
            else:
                order = torch.arange(n, device=self._device)
            for step in range(steps):
                idx = order[step * batch_size:(step + 1) * batch_size]
                yield {k: v.index_select(0, idx) for k, v in self._data.items()}
