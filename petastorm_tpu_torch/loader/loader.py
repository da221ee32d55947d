"""``DataLoader``: reader rows -> fixed-size batches of tensors on the card.

Rows from a ``make_reader`` reader are (optionally) shuffled through a
seeded row buffer, collated into ``{field: array}`` batches of
``batch_size`` rows, and staged onto ``device`` by a background thread that
keeps ``prefetch`` batches ready. The collated host batches are the ones
the JAX package's ``DataLoader`` builds from the same reader settings.
NGram windows collate to a dense ``(batch, length, *shape)`` array per
field (see :meth:`DataLoader._collate_ngram`).

Staging to a CUDA device:

* each column is copied into a **pinned** host buffer, reused per
  (names, shapes, dtypes) signature from a ring of ``prefetch + 1``;
* the host-to-device copy is issued ``non_blocking`` on a side
  ``torch.cuda.Stream`` and an event is recorded after it;
* the consumer's stream waits on that event when the batch is delivered,
  and ``record_stream`` marks the tensors as used by the consumer's stream;
* a pinned buffer is refilled only after its copy's event has completed.

``device="cpu"`` hands out tensors that share the collated numpy memory.

``echo=k`` (data echoing, Choi et al., arXiv:1907.05550) yields each staged
batch ``k`` times: the repeats are ``.clone()``s of its tensors (one copy on
the card, no decode, no host-to-device copy), never aliases, so a consumer
that writes into or frees a batch cannot touch its repeats.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from petastorm_tpu_torch.loader.dtypes import DEFAULT_POLICY, DTypePolicy, sanitize_batch
from petastorm_tpu_torch.reader_impl.shuffling_buffer import RandomShufflingBuffer

#: Consumer poll period on the staged-batch queue: bounds how late a dead
#: staging thread is noticed, not delivery latency.
_STAGE_POLL_S = 0.5


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; a CUDA device must exist (the loader
    never moves to the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} but no CUDA device is available; "
                               f"pass device='cpu' to stage batches on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
    return dev


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _PinnedStager:
    """Host -> CUDA copies through a ring of pinned buffers per batch
    signature, issued on a side stream. Runs on the staging thread."""

    def __init__(self, device: torch.device, ring_size: int):
        self._device = device
        self._ring_size = ring_size
        self._stream = torch.cuda.Stream(device)
        self._rings: Dict[tuple, list] = {}   # signature -> [[buffers, event]]
        self._next: Dict[tuple, int] = {}

    def stage(self, cols: Dict[str, object]):
        """numpy arrays or CPU tensors -> (``{name: cuda tensor}``, event
        recorded after the copies)."""
        sig = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in cols.items())
        ring = self._rings.setdefault(sig, [])
        pos = self._next.get(sig, 0)
        self._next[sig] = (pos + 1) % self._ring_size
        if pos == len(ring):
            ring.append([{k: torch.empty(tuple(v.shape), dtype=_torch_dtype(v.dtype),
                                         pin_memory=True)
                          for k, v in cols.items()}, None])
        slot = ring[pos]
        buffers, event = slot
        if event is not None:
            event.synchronize()   # the previous copy out of this slot is done
        for k, v in cols.items():
            if isinstance(v, torch.Tensor):
                buffers[k].copy_(v)
            else:
                np.copyto(buffers[k].numpy(), v, casting="no")
        with torch.cuda.stream(self._stream):
            staged = {k: b.to(self._device, non_blocking=True) for k, b in buffers.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        slot[1] = event
        return staged, event


class DataLoader:
    """Batches of a row reader, staged onto ``device``.

    :param reader: a ``make_reader`` reader
    :param batch_size: rows per batch
    :param shuffling_queue_capacity: > 1 enables a seeded row shuffling buffer
    :param min_after_retrieve: shuffle-quality floor of the buffer (default
        half its capacity)
    :param seed: buffer RNG seed
    :param drop_last: drop the last batch when it is short (default)
    :param pad_last: zero-pad the last batch to ``batch_size`` instead and
        add a boolean ``__valid__`` column
    :param prefetch: staged batches kept ready ahead of the consumer
    :param device: ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``
    :param echo: yield each staged batch this many times (repeats are
        clones of its tensors; host columns pass through)
    :param dtype_policy: how columns become tensors (:class:`DTypePolicy`;
        the default keeps every type torch has)
    """

    def __init__(self, reader, batch_size: int,
                 shuffling_queue_capacity: int = 0,
                 min_after_retrieve: Optional[int] = None,
                 seed: Optional[int] = None,
                 drop_last: bool = True, pad_last: bool = False,
                 prefetch: int = 2, device="cuda", echo: int = 1,
                 dtype_policy: DTypePolicy = DEFAULT_POLICY):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if echo < 1:
            raise ValueError(f"echo must be >= 1, got {echo}")
        self._device = resolve_device(device)
        self._reader = reader
        self._ngram = getattr(reader, "ngram", None)
        self._batch_size = batch_size
        self._shuffling_capacity = shuffling_queue_capacity
        self._min_after = min_after_retrieve
        self._seed = seed
        self._pad_last = pad_last
        self._drop_last = drop_last and not pad_last
        self._prefetch = max(1, prefetch)
        self._echo = echo
        self._dtype_policy = dtype_policy
        self._in_iter = False
        self._stage_stop: Optional[threading.Event] = None

    # ----------------------------------------------------------- host side
    def _row_iterator(self):
        if self._reader.last_row_consumed:
            self._reader.reset()
        if not (self._shuffling_capacity and self._shuffling_capacity > 1):
            yield from self._reader
            return
        buf = RandomShufflingBuffer(
            self._shuffling_capacity,
            min_after_retrieve=(self._min_after if self._min_after is not None
                                else self._shuffling_capacity // 2),
            extra_capacity=max(1000, self._shuffling_capacity),
            seed=self._seed)
        it = iter(self._reader)
        exhausted = False
        while True:
            while not exhausted and buf.can_add:
                try:
                    buf.add_many([next(it)])
                except StopIteration:
                    exhausted = True
                    buf.finish()
            if buf.can_retrieve:
                yield buf.retrieve()
            elif exhausted:
                return

    def _collate(self, rows) -> Dict[str, np.ndarray]:
        if self._ngram is not None:
            return self._collate_ngram(rows)
        out = {}
        fields = self._reader.schema.fields
        for name in rows[0]._fields:
            values = [getattr(r, name) for r in rows]
            field = fields.get(name)
            if field is not None and any(d is None for d in field.shape):
                arr = np.empty(len(values), object)   # ragged: stays on the host
                for i, v in enumerate(values):
                    arr[i] = v
                out[name] = arr
                continue
            if any(v is None for v in values):
                raise ValueError(f"Field {name!r} contains nulls; exclude the field "
                                 f"or fill the nulls before batching")
            out[name] = np.stack([np.asarray(v) for v in values])
        return out

    def _collate_ngram(self, windows) -> Dict[str, np.ndarray]:
        """NGram windows -> one array per field with the window offsets as
        a dense sequence axis, ``(batch, length, *shape)``. Dense windows
        (``{name: (length, *shape)}``) stack once per field. Row windows
        (``{offset: namedtuple}``) stack per offset when every offset has
        the same fields, and otherwise flatten to ``"{name}/{offset}"`` keys
        of ``(batch, *shape)``."""
        if self._ngram.dense:
            out = {}
            for name in windows[0]:
                arr = np.stack([w[name] for w in windows])
                if arr.dtype == object:
                    raise ValueError(f"Field {name!r} contains nulls or ragged values; "
                                     f"exclude the field or fill them before batching")
                out[name] = arr
            return out
        offsets = sorted(windows[0].keys())
        fieldsets = [tuple(windows[0][o]._fields) for o in offsets]
        fields = self._reader.schema.fields

        def column(name, values):
            field = fields.get(name)
            if any(v is None for v in values):
                raise ValueError(f"Field {name!r} contains nulls; exclude the field "
                                 f"or fill the nulls before batching")
            if field is not None and any(d is None for d in field.shape):
                raise ValueError(f"Field {name!r} is variable-length; NGram windows "
                                 f"stack into dense arrays: exclude the field or pad "
                                 f"it at write time")
            return np.stack([np.asarray(v) for v in values])

        out = {}
        if all(fs == fieldsets[0] for fs in fieldsets):
            for name in fieldsets[0]:
                out[name] = np.stack([column(name, [getattr(w[o], name) for w in windows])
                                      for o in offsets], axis=1)
        else:
            for o in offsets:
                for name in windows[0][o]._fields:
                    out[f"{name}/{o}"] = column(name, [getattr(w[o], name) for w in windows])
        return out

    def _finalize_tail(self, cols: Dict[str, np.ndarray], count: int):
        """The short last batch: dropped, zero-padded with a ``__valid__``
        mask, or emitted as is."""
        if count == self._batch_size:
            return cols
        if self._drop_last:
            return None
        if self._pad_last:
            pad = self._batch_size - count
            out = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)) for k, v in cols.items()}
            out["__valid__"] = np.concatenate([np.ones(count, np.bool_),
                                               np.zeros(pad, np.bool_)])
            return out
        return cols

    def _host_batches(self):
        rows = []
        for row in self._row_iterator():
            rows.append(row)
            if len(rows) == self._batch_size:
                yield self._collate(rows)
                rows = []
        if rows:
            tail = self._finalize_tail(self._collate(rows), len(rows))
            if tail is not None:
                yield tail

    # -------------------------------------------------------------- staging
    def _prefetched(self, host_batches):
        """Collate and stage on a background thread, ``prefetch`` batches
        ahead; deliver on the consumer's thread and stream."""
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        self._stage_stop = stop
        end, err = object(), object()
        cuda = self._device.type == "cuda"

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if cuda:
                    torch.cuda.set_device(self._device)
                    stager = _PinnedStager(self._device, self._prefetch + 1)
                for hb in host_batches:
                    if stop.is_set():
                        return
                    cols, host_cols = sanitize_batch(hb, self._dtype_policy)
                    if cuda:
                        staged, event = stager.stage(cols)
                    else:
                        staged = {k: v.contiguous() if isinstance(v, torch.Tensor)
                                  else torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in cols.items()}
                        event = None
                    staged.update(host_cols)
                    if not put((None, staged, event)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
                put((err, e, None))
            finally:
                put((end, None, None))
                host_batches.close()

        thread = threading.Thread(target=produce, daemon=True, name="petastorm-torch-stage")
        thread.start()
        try:
            while True:
                try:
                    kind, item, event = q.get(timeout=_STAGE_POLL_S)
                except queue.Empty:
                    if thread.is_alive() or not q.empty():
                        continue
                    raise RuntimeError("Loader staging thread died without delivering "
                                       "a batch, an error or end-of-stream") from None
                if kind is end:
                    return
                if kind is err:
                    raise item
                if event is not None:
                    consumer = torch.cuda.current_stream(self._device)
                    consumer.wait_event(event)
                    for v in item.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(consumer)
                yield item
                for _ in range(self._echo - 1):
                    yield {k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in item.items()}
        finally:
            stop.set()
            self._stage_stop = None
            thread.join(5.0)

    def __iter__(self):
        if self._in_iter:
            raise RuntimeError("Loader is already being iterated")
        self._in_iter = True
        try:
            it = self._prefetched(self._host_batches())
            try:
                yield from it
            finally:
                it.close()
        finally:
            self._in_iter = False

    def close(self):
        """Stop the staging thread (if an iterator was abandoned) and stop
        and join the reader. ``with loader: ...`` does this on exit."""
        if self._stage_stop is not None:
            self._stage_stop.set()
        self._reader.stop()
        self._reader.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
