"""Loaders: reader output -> fixed-size batches of tensors on the card.

* :class:`DataLoader`: rows from a ``make_reader`` reader are (optionally)
  shuffled through a seeded row buffer and collated into
  ``{field: array}`` batches of ``batch_size`` rows. NGram windows collate
  to a dense ``(batch, length, *shape)`` array per field (see
  :meth:`DataLoader._collate_ngram`). A lazy reader
  (``row_materialization="lazy"``) is read a row group at a time and
  shuffled and collated a column at a time (:meth:`DataLoader._lazy_host_batches`).
* :class:`BatchedDataLoader`: the row groups of a ``make_batch_reader``
  reader are re-chunked into batches by vectorized column buffers
  (:mod:`.batched_buffer`), optionally shuffled.
* :class:`InMemBatchedDataLoader`: a batched reader is read once, then
  epochs are served from memory, reshuffled each epoch.

Each stages its batches onto ``device`` from a background thread that
keeps ``prefetch`` batches ready (:class:`LoaderBase`). The host batches
are the ones the JAX package's loaders build from the same reader
settings. :func:`aligned_steps_per_epoch` gives the batch count every
shard can deliver, for ``steps_per_epoch``.

Staging to a CUDA device:

* every column of a batch is copied into one **pinned** host buffer, each
  at a 64-byte aligned offset; the buffers are reused per (names, shapes,
  dtypes) signature from a ring of ``prefetch + 1``, which grows (at the
  staging thread's next batch) when the prefetch depth is raised;
* the columns under 1 MiB (``_OWN_COPY_BYTES``) lie together in the
  buffer and go to the card in one host-to-device copy, and each larger
  column in one of its own (:class:`BatchLayout`); the copies are issued
  ``non_blocking`` on a side ``torch.cuda.Stream`` and an event is
  recorded after them;
* the batch's small columns are views of one device allocation, so a
  small column kept alive (labels kept for an epoch's metrics) keeps the
  batch's other small columns on the card, and never a large one;
* the consumer's stream waits on that event when the batch is delivered,
  and ``record_stream`` marks the tensors as used by the consumer's stream;
* a pinned buffer is refilled only after its copy's event has completed.

``device="cpu"`` hands out tensors that share the collated numpy memory:
on a batched process reader, a batch inside one row group shares the
shared-memory ring's record, which stays pinned until the tensor is
dropped. Such memory is read-only (torch warns when it wraps it): clone a
batch before writing into it.

``echo=k`` (data echoing, Choi et al., arXiv:1907.05550) yields each staged
batch ``k`` times: the repeats are ``.clone()``s of its tensors (one copy on
the card, no decode, no host-to-device copy), never aliases, so a consumer
that writes into or frees a batch cannot touch its repeats.

Checkpointing: :meth:`LoaderBase.state_dict` is the reader's cursor as of
the last batch the consumer received, not the reader's own, which the
staging thread drives ``prefetch`` batches ahead. The cursor is read on the
staging thread between reader pulls, right after a batch is assembled, and
travels with that batch through the queue. It is whatever the reader's
``state_dict()`` gives: a deterministic reader's cursor (with its
``shuffle_window``), or a ``WeightedSamplingReader``'s members' cursors with
its ``seed`` and ``step``. Loaders with a host-side shuffling buffer
refuse: no reader cursor describes the rows such a buffer holds (a
deterministic reader's ``shuffle_window`` mixes with an exact resume).

Tuning: :attr:`LoaderBase.prefetch_depth` is a live knob
(:meth:`LoaderBase.set_prefetch_depth`): the staging thread puts a batch
only while fewer than the depth wait, and a change wakes it. When the
reader runs an autotune controller (``make_reader(autotune=True)``), the
loader registers its prefetch depth on it while a staging pipeline runs,
and its shuffling buffer's target while a pass runs.

Telemetry: a loader over a reader adopts the reader's registry
(``loader.telemetry``, :mod:`petastorm_tpu_torch.telemetry`), so one
snapshot holds the workers' decode, the pool wait, the shuffle, the staging
and the consumer's wait. ``loader.metrics``
(:class:`~petastorm_tpu_torch.metrics.PipelineMetrics`) counts the staged
batches; the spans ``petastorm_tpu.host_batch`` and ``petastorm_tpu.stage``
name the two halves of staging in a profiler trace and in the registry.
:meth:`LoaderBase.stall_report`, :meth:`~LoaderBase.stage_breakdown`,
:meth:`~LoaderBase.critical_path_report` and :meth:`~LoaderBase.export_trace`
read them, as the JAX package's loaders do.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from petastorm_tpu_torch.loader.batched_buffer import (BatchedNoopShufflingBuffer,
                                                       BatchedRandomShufflingBuffer)
from petastorm_tpu_torch.loader.dtypes import (DEFAULT_POLICY, DTypePolicy, sanitize_array,
                                               sanitize_batch)
from petastorm_tpu_torch.metrics import PipelineMetrics, traced_span
from petastorm_tpu_torch.telemetry import (CriticalPathAttributor, StallAttributor,
                                           make_registry, write_chrome_trace)
from petastorm_tpu_torch.reader_impl.batch_plane import concat_column_slices
from petastorm_tpu_torch.reader_impl.shuffling_buffer import (BatchShufflingBuffer,
                                                              RandomShufflingBuffer)

#: Consumer poll period on the staged-batch queue: bounds how late a dead
#: staging thread is noticed, not delivery latency.
_STAGE_POLL_S = 0.5

_SHUFFLE_HAZARD = ("shuffling_queue_capacity buffers a random sample of rows host-side; "
                   "checkpoint with the reader's seeded shuffling instead "
                   "(shuffle_row_groups + seed), or, for more mixing with an exact resume, "
                   "the reader's sample_order='deterministic' + shuffle_window=")


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


#: Byte alignment of each column in a staged batch's buffer.
_STAGE_ALIGN = 64
#: A column of at least this many bytes is copied to the card on its own,
#: into a device allocation of its own.
_OWN_COPY_BYTES = 1 << 20


class BatchLayout:
    """Where each column of a batch lies in one byte buffer, and how the
    buffer goes to the card: each column at an offset that is a multiple of
    :data:`_STAGE_ALIGN`; the columns under :data:`_OWN_COPY_BYTES` together
    in the buffer's first span, in order, and each larger column in a span
    of its own after them. Each span is one copy and one allocation."""

    def __init__(self, cols: Dict[str, object]):
        self.columns = []   # (name, shape, torch dtype, span, offset in span, bytes)
        small, large = [], []
        for k, v in cols.items():
            dtype = _torch_dtype(v.dtype)
            nbytes = int(np.prod(v.shape, dtype=np.int64)) * dtype.itemsize
            (small if nbytes < _OWN_COPY_BYTES else large).append((k, tuple(v.shape), dtype,
                                                                   nbytes))
        self.spans = []     # (start, stop) in the buffer
        pos = 0
        for group in ([small] if small else []) + [[c] for c in large]:
            start = pos
            for k, shape, dtype, nbytes in group:
                self.columns.append((k, shape, dtype, len(self.spans), pos - start, nbytes))
                pos += -(-nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
            self.spans.append((start, pos))
        order = {k: i for i, k in enumerate(cols)}
        self.columns.sort(key=lambda c: order[c[0]])
        self.total = pos

    def views(self, buffer: torch.Tensor, copy=None) -> Dict[str, torch.Tensor]:
        """The columns as views of ``buffer`` (1-D uint8 of ``total``
        bytes), or of ``copy(span)`` for each span of it."""
        spans = [buffer[start:stop] for start, stop in self.spans]
        if copy is not None:
            spans = [copy(span) for span in spans]
        return {k: spans[i][offset:offset + nbytes].view(dtype).view(shape)
                for k, shape, dtype, i, offset, nbytes in self.columns}


def _numpy_view(t: torch.Tensor) -> Optional[np.ndarray]:
    try:
        return t.numpy()
    except TypeError:   # a dtype numpy lacks (bfloat16)
        return None


def _check_sharding(sharding) -> None:
    """Raise where the layout cannot describe a rank's batch (see
    :class:`LoaderBase`'s ``sharding``)."""
    if sharding is None:
        return
    from petastorm_tpu_torch.parallel.mesh import BatchSharding
    if not isinstance(sharding, BatchSharding):
        raise TypeError(f"sharding must be a parallel.mesh.BatchSharding, got "
                        f"{type(sharding).__name__}")
    spec = tuple(sharding.spec)
    for entry in spec:
        for name in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            if name not in sharding.mesh.shape:
                raise ValueError(f"sharding spec {spec} names the axis {name!r}, which the "
                                 f"mesh {sharding.mesh.shape} lacks")
    if any(entry is not None for entry in spec[1:]):
        raise ValueError(f"sharding spec {spec} splits a dimension other than the batch's; a "
                         f"rank stages whole rows of its slice of the batch")


def _check_sharded_columns(sharding, cols) -> None:
    if sharding is None:
        return
    for name, v in cols.items():
        if v.ndim < len(sharding.spec):
            raise ValueError(f"column {name!r} has {v.ndim} dimension(s), fewer than the "
                             f"sharding spec {tuple(sharding.spec)} names")


class _PinnedStager:
    """Host -> CUDA copies of whole batches: the columns packed into one
    pinned buffer per batch signature (a ring of them), one copy a span of
    its :class:`BatchLayout` on a side stream, the columns viewed in the
    device spans. Runs on the staging thread."""

    def __init__(self, device: torch.device, ring_size: int):
        self._device = device
        self.ring_size = ring_size
        self._stream = torch.cuda.Stream(device)
        self._layouts: Dict[tuple, BatchLayout] = {}
        # signature -> [[buffer, {name: (tensor view, numpy view)}, event]]
        self._rings: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}

    def stage(self, cols: Dict[str, object]):
        """numpy arrays or CPU tensors -> (``{name: cuda tensor}``, event
        recorded after the copies)."""
        sig = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in cols.items())
        layout = self._layouts.get(sig)
        if layout is None:
            layout = self._layouts[sig] = BatchLayout(cols)
        ring = self._rings.setdefault(sig, [])
        pos = self._next.get(sig, 0)
        # A ring that grew since (a raised prefetch depth) adds its new slots
        # as ``pos`` reaches them.
        self._next[sig] = (pos + 1) % max(self.ring_size, len(ring))
        if pos == len(ring):
            buffer = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
            ring.append([buffer, {k: (t, _numpy_view(t)) for k, t in layout.views(buffer).items()},
                         None])
        slot = ring[pos]
        buffer, host, event = slot
        if event is not None:
            event.synchronize()   # the previous copy out of this slot is done
        for k, v in cols.items():
            if isinstance(v, torch.Tensor):
                host[k][0].copy_(v)
            else:
                np.copyto(host[k][1], v, casting="no")
        with torch.cuda.stream(self._stream):
            staged = layout.views(buffer, copy=lambda span: span.to(self._device,
                                                                    non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        slot[2] = event
        return staged, event


class LoaderBase:
    """Staging shared by the loaders: a background thread sanitizes each
    host batch (:class:`DTypePolicy`) and stages it onto ``device``,
    ``prefetch`` batches ahead; the short last batch is dropped, padded or
    kept (:meth:`_finalize_tail`); ``echo`` repeats each batch;
    ``steps_per_epoch`` cuts each pass at a fixed count of batches.

    :param batch_size: rows per batch
    :param drop_last: drop the last batch when it is short (default)
    :param pad_last: zero-pad the last batch to ``batch_size`` instead and
        add a boolean ``__valid__`` column
    :param prefetch: staged batches kept ready ahead of the consumer
    :param device: ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``. On the
        card a batch's columns under 1 MiB share one allocation: keeping one
        of them (say the labels) keeps the others, never a larger column
    :param echo: yield each staged batch this many times (repeats are
        clones of its tensors; host columns pass through)
    :param dtype_policy: how columns become tensors (:class:`DTypePolicy`;
        the default keeps every type torch has)
    :param steps_per_epoch: each ``iter()`` yields exactly this many
        batches from one pipeline that lives across passes (no staged batch
        is lost between them), and raises ``RuntimeError`` when the stream
        ends sooner; see :func:`aligned_steps_per_epoch`
    :param pad_variable_length_to: a variable-length field (a ``None`` in
        its shape) is zero-padded (or cut) along its first axis to this
        length, an int or ``{field: length}``, and gets an int32
        ``<name>__len`` column of the true lengths; without it such a field
        stays a host column of per-row arrays (an NGram window raises)
    :param keep_host_fields: hand out the columns the dtype policy keeps
        on the host (strings, objects) beside the staged ones; ``False``
        drops them
    :param sharding: a :class:`~petastorm_tpu_torch.parallel.mesh.BatchSharding`
        describing how the global batch lies over the ranks. A rank's batch
        already is its slice, so it is staged as it is: the argument only
        checks the layout, and raises where the JAX loader's
        ``make_array_from_process_local_data`` would (another type, an
        axis the mesh lacks, a split of a dimension other than the batch's,
        a column with fewer dimensions than the spec names)
    :param telemetry: the pipeline's
        :class:`~petastorm_tpu_torch.telemetry.TelemetryRegistry`; the
        loaders over a reader default to the reader's (``reader.telemetry``),
        others get a new one (:func:`~petastorm_tpu_torch.telemetry.make_registry`)
    """

    def __init__(self, batch_size: int, drop_last: bool = True, pad_last: bool = False,
                 prefetch: int = 2, device="cuda", echo: int = 1,
                 dtype_policy: DTypePolicy = DEFAULT_POLICY,
                 steps_per_epoch: Optional[int] = None, sharding=None, telemetry=None,
                 pad_variable_length_to=None, keep_host_fields: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if echo < 1:
            raise ValueError(f"echo must be >= 1, got {echo}")
        if steps_per_epoch is not None and steps_per_epoch < 1:
            raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
        self._device = resolve_device(device)
        self._sharding = sharding
        _check_sharding(sharding)
        self._batch_size = batch_size
        self._pad_last = pad_last
        self._drop_last = drop_last and not pad_last
        self._prefetch = max(1, prefetch)
        # The running pipeline's put condition, notified by a depth change.
        self._space: Optional[threading.Condition] = None
        self._echo = echo
        self._dtype_policy = dtype_policy
        self._pad_varlen = pad_variable_length_to
        self._keep_host = keep_host_fields
        self._steps_per_epoch = steps_per_epoch
        self._persistent_it = None
        self._in_iter = False
        self._stage_stop: Optional[threading.Event] = None
        self._skipped_warned: set = set()
        # Per-column sticky conversion of object columns: "drop" or
        # (kind, row_shape, dtype).
        self._object_column_mode: Dict[str, object] = {}
        #: The pipeline's registry: a reader's, when the loader reads one, so
        #: decode, pool wait, shuffle, staging and stall land in one snapshot.
        self.telemetry = telemetry if telemetry is not None else make_registry()
        #: Counts and seconds of the staged batches.
        self.metrics = PipelineMetrics(telemetry=self.telemetry)
        #: Per delivered batch: host-bound, device-bound or balanced
        #: (:meth:`stall_report`).
        self.stall = StallAttributor(registry=self.telemetry)
        #: Per delivered batch: the stage that accrued the most self-time
        #: (:meth:`critical_path_report`).
        self.critical_path = CriticalPathAttributor(self.telemetry)
        self._shuffle_time = self.telemetry.counter("loader.shuffle_s")
        # The registry is pipeline-cumulative: a second loader over the same
        # reader must not count the first one's shuffle seconds.
        self._shuffle_base = self._shuffle_time.value
        # Why state_dict() would lose rows with this configuration, or None.
        self._ckpt_hazard: Optional[str] = None
        # A cursor taken where the loader buffered no rows, for loaders that
        # hold rows across batches; None = read the reader's live cursor.
        self._pending_safe_state: Optional[dict] = None
        self._last_input_state: Optional[dict] = None

    # ----------------------------------------------------- object columns
    def _batchable_columns(self, group) -> Dict[str, np.ndarray]:
        """The batchable columns of one row group of a batched reader (its
        ``{column: ndarray}``, or the namedtuple ``next(reader)`` gives).

        An object column of uniform numeric rows densifies into a
        ``(rows, *row_shape)`` array; a Decimal column converts by the
        dtype policy; a ragged or string column is dropped with one
        warning. The first group that carries the column decides, with the
        exact row shape and dtype, for the whole stream, so a column never
        changes form between groups: later null rows of a float column
        become NaN, and any other difference raises ``ValueError`` naming
        the column. An entirely null first group locks a column to "drop";
        declare the field's shape to avoid that."""
        cols, skipped = {}, []
        items = (group.items() if isinstance(group, dict)
                 else ((name, getattr(group, name)) for name in group._fields))
        for name, arr in items:
            if arr.dtype != object:
                cols[name] = arr
                continue
            mode = self._object_column_mode.get(name)
            if mode is None:
                mode, converted = self._decide_object_mode(arr)
                self._object_column_mode[name] = mode
                if mode != "drop":
                    cols[name] = converted
                    continue
            elif mode != "drop":
                kind, row_shape, dtype = mode
                converted = (self._try_sanitize(arr) if kind == "sanitize"
                             else self._try_densify(arr))
                if converted is None and np.dtype(dtype).kind == "f":
                    converted = self._densify_with_nan_fill(arr, row_shape, np.dtype(dtype))
                if (converted is None or converted.shape[1:] != row_shape
                        or converted.dtype != dtype):
                    got = ("null/ragged/non-numeric rows" if converted is None
                           else f"rows of shape {converted.shape[1:]} {converted.dtype}")
                    raise ValueError(
                        f"Column {name!r} batched as shape {row_shape} {dtype} earlier in "
                        f"the stream but this row group has {got}; declare the field's "
                        f"shape (or exclude the column) for consistent batches")
                cols[name] = converted
                continue
            skipped.append(name)
        self._warn_skipped_fields(skipped)
        return cols

    def _decide_object_mode(self, arr):
        """First sight of an object column: the dtype policy's conversion
        (Decimal), then uniform-row densify, else drop."""
        converted = self._try_sanitize(arr)
        if converted is not None:
            return ("sanitize", converted.shape[1:], converted.dtype), converted
        dense = self._try_densify(arr)
        if dense is not None:
            return ("dense", dense.shape[1:], dense.dtype), dense
        return "drop", None

    def _try_sanitize(self, obj_column) -> Optional[np.ndarray]:
        try:
            out = sanitize_array(obj_column, self._dtype_policy)
        except (TypeError, ValueError, ArithmeticError):
            return None
        return out if out is not None and out.dtype != object else None

    @staticmethod
    def _densify_with_nan_fill(obj_column, row_shape, dtype) -> Optional[np.ndarray]:
        """A float-locked column with null rows, stacked with NaN rows; None
        when a non-null row differs from the locked layout."""
        fill = np.full(row_shape, np.nan, dtype)
        rows = []
        for v in obj_column:
            if v is None:
                rows.append(fill)
                continue
            try:
                a = np.asarray(v, dtype=dtype)
            except (TypeError, ValueError):
                return None
            if a.shape != tuple(row_shape):
                return None
            rows.append(a)
        return np.stack(rows) if rows else None

    @staticmethod
    def _try_densify(obj_column) -> Optional[np.ndarray]:
        """An object column of equal-shape numeric rows, stacked; None when
        a row is missing, ragged or not numeric."""
        try:
            if any(v is None for v in obj_column):
                return None
            dense = np.stack([np.asarray(v) for v in obj_column])
        except ValueError:
            return None
        return dense if dense.dtype.kind in "biufc" else None

    def _warn_skipped_fields(self, names):
        """One warning per newly dropped column."""
        new = [n for n in names if n not in self._skipped_warned]
        if new:
            self._skipped_warned.update(new)
            warnings.warn(
                f"Dropping non-batchable column(s) {sorted(new)}: ragged/null/string values "
                f"cannot form fixed-shape batches. Read them with the row reader to keep them.")

    def _finalize_tail(self, cols: Dict[str, np.ndarray], count: int,
                       target_rows: Optional[int] = None):
        """The short last batch: dropped, zero-padded with a ``__valid__``
        mask, or emitted as is. ``target_rows`` replaces ``batch_size`` as the
        pad target (a data rank pads to its own rows a step)."""
        target = self._batch_size if target_rows is None else target_rows
        if count == 0:
            return None
        if count == target:
            return cols
        if self._drop_last:
            return None
        if self._pad_last:
            pad = target - count
            out = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)) for k, v in cols.items()}
            out["__valid__"] = np.concatenate([np.ones(count, np.bool_),
                                               np.zeros(pad, np.bool_)])
            return out
        return cols

    # ---------------------------------------------------------------- knobs
    @property
    def prefetch_depth(self) -> int:
        """Staged batches kept ready ahead of the consumer."""
        return self._prefetch

    def set_prefetch_depth(self, n: int) -> None:
        """The prefetch depth as a live knob (the autotune controller's
        ``prefetch_depth``; ``tools/check_knobs.py`` checks that only
        :mod:`petastorm_tpu_torch.autotune` calls it), at least 1. It takes
        effect at the staging thread's next put: a lower depth stages
        nothing new until the consumer drains below it (staged batches stay
        valid); a higher one grows the pinned ring at the next batch."""
        self._prefetch = max(1, int(n))
        self.telemetry.gauge("loader.prefetch_queue_capacity").set(self._prefetch)
        space = self._space
        if space is not None:
            with space:
                space.notify_all()

    def _autotune_controller(self):
        """The reader's autotune controller, or None: a loader registers its
        knobs on the reader's, so one loop sees the whole pipeline."""
        return getattr(getattr(self, "_reader", None), "autotune", None)

    def _register_shuffle_actuator(self, buf):
        """The buffer's target as the controller's ``shuffle_target`` (when
        there is a controller and the buffer has the knob); returns the
        actuator, which the pass unregisters at its end, or None."""
        controller = self._autotune_controller()
        if controller is None or not hasattr(buf, "set_target_capacity"):
            return None
        from petastorm_tpu_torch.autotune import ShuffleTargetActuator
        return controller.register(ShuffleTargetActuator(buf))

    def _unregister_actuator(self, actuator) -> None:
        if actuator is not None:
            self._autotune_controller().unregister(actuator.name)

    # -------------------------------------------------------------- staging
    def _prefetched(self, host_batches):
        """Collate and stage on a background thread, ``prefetch_depth``
        batches ahead (read at every put); deliver on the consumer's thread
        and stream. Each delivered batch but the first (the pipeline's
        spin-up) feeds the stall attributor: the wait in the queue against
        the time the consumer spent away from it; each feeds the
        critical-path attributor."""
        # Unbounded: puts are gated on the live depth, which a fixed maxsize
        # could not follow.
        q: queue.Queue = queue.Queue()
        stop = threading.Event()
        self._stage_stop = stop
        # The consumer notifies after every get, so a put waits no longer
        # than the slot takes to free; a depth change notifies too.
        space = self._space = threading.Condition()
        end, err = object(), object()
        cuda = self._device.type == "cuda"
        telemetry = self.telemetry
        # One bound method, so the teardown below clears exactly this one.
        depth_fn = q.qsize
        telemetry.gauge("loader.prefetch_queue_depth", depth_fn)
        telemetry.gauge("loader.prefetch_queue_capacity").set(self._prefetch)

        def put(item, force=False) -> bool:
            with space:
                while not stop.is_set():
                    if force or q.qsize() < self._prefetch:
                        q.put(item)
                        return True
                    space.wait(0.05)
            return False

        def produce():
            try:
                if cuda:
                    torch.cuda.set_device(self._device)
                    stager = _PinnedStager(self._device, self._prefetch + 1)
                batch_seq = 0
                while not stop.is_set():
                    batch_seq += 1
                    batch_trace = f"b{batch_seq}"
                    t0 = time.perf_counter()
                    with traced_span("petastorm_tpu.host_batch", telemetry, trace=batch_trace,
                                     track="stager"):
                        hb = next(host_batches, None)
                    if hb is None:
                        return
                    # The cursor between reader pulls covers exactly the rows
                    # assembled so far, so it travels with this batch.
                    snap = self._snapshot_input_state()
                    t1 = time.perf_counter()
                    with traced_span("petastorm_tpu.stage", telemetry, trace=batch_trace,
                                     stage="stage", track="stager"):
                        cols, host_cols = self._split_batch(hb)
                        _check_sharded_columns(self._sharding, cols)
                        if cuda:
                            stager.ring_size = max(stager.ring_size, self._prefetch + 1)
                            staged, event = stager.stage(cols)
                        else:
                            staged = {k: v.contiguous() if isinstance(v, torch.Tensor)
                                      else torch.from_numpy(np.ascontiguousarray(v))
                                      for k, v in cols.items()}
                            event = None
                    t2 = time.perf_counter()
                    rows = len(next(iter(hb.values()))) if hb else 0
                    self.metrics.record_batch(rows, sum(v.nbytes for v in cols.values()),
                                              t1 - t0, t2 - t1)
                    if self._keep_host:
                        staged.update(host_cols)
                    # Not kept while the queue is full: on a process reader
                    # the host batch's columns may pin ring records.
                    del hb, cols, host_cols
                    if not put((None, staged, event, snap)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
                put((err, e, None, None), force=True)
            finally:
                put((end, None, None, None), force=True)
                host_batches.close()

        thread = threading.Thread(target=produce, daemon=True, name="petastorm-torch-stage")
        thread.start()
        controller = self._autotune_controller()
        prefetch_actuator = None
        if controller is not None:
            from petastorm_tpu_torch.autotune import PrefetchDepthActuator
            prefetch_actuator = controller.register(PrefetchDepthActuator(self))
        try:
            last_resume = None
            while True:
                t0 = time.perf_counter()
                while True:   # one wait, however many polls it takes
                    try:
                        kind, item, event, snap = q.get(timeout=_STAGE_POLL_S)
                        break
                    except queue.Empty:
                        if thread.is_alive() or not q.empty():
                            continue
                        raise RuntimeError("Loader staging thread died without delivering "
                                           "a batch, an error or end-of-stream") from None
                with space:
                    space.notify()
                t1 = time.perf_counter()
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
                if last_resume is not None:
                    self.stall.observe(wait_s=t1 - t0, busy_s=t0 - last_resume)
                self.critical_path.observe_batch()
                self._last_input_state = snap
                # Taken before the yield: the consumer's step runs while this
                # generator is suspended, so the next t0 - last_resume is it.
                last_resume = time.perf_counter()
                yield item
                for _ in range(self._echo - 1):
                    yield {k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in item.items()}
        finally:
            stop.set()
            with space:
                space.notify_all()   # a producer waiting for room exits now
            self._stage_stop = None
            self._space = None
            self._unregister_actuator(prefetch_actuator)
            # The registry outlives this pass: a gauge left on the queue's
            # bound method would keep its staged batches alive.
            telemetry.gauge("loader.prefetch_queue_depth").clear_function(depth_fn)
            thread.join(5.0)

    def _split_batch(self, host_batch: dict):
        """(columns to stage onto the device, columns handed out as they
        are) of one host batch: the dtype policy's split."""
        return sanitize_batch(host_batch, self._dtype_policy)

    def _host_batches(self):
        """The host batches of one pass, as ``{name: ndarray}``."""
        raise NotImplementedError

    # -------------------------------------------------------- checkpointing
    def _snapshot_live_state(self) -> Optional[dict]:
        reader = getattr(self, "_reader", None)
        return None if reader is None else reader.state_dict()

    def _snapshot_input_state(self) -> Optional[dict]:
        if self._pending_safe_state is not None:
            return dict(self._pending_safe_state)
        return self._snapshot_live_state()

    def state_dict(self) -> Optional[dict]:
        """The resume point of the delivered stream: the reader's cursor as
        of the last batch this loader yielded (before the first, the
        reader's cursor when iteration began; None for a loader without a
        reader). Pass it as the reader's ``resume_state=``: staged batches
        the consumer never received are read again, not skipped. Raises
        ``ValueError`` for a loader with a shuffling buffer: use the
        reader's seeded shuffling, or ``sample_order='deterministic'`` with
        ``shuffle_window=``, to checkpoint."""
        if self._ckpt_hazard is not None:
            raise ValueError(f"state_dict() would lose data with this loader configuration: "
                             f"{self._ckpt_hazard}")
        return self._last_input_state

    def __iter__(self):
        if self._in_iter:
            raise RuntimeError("Loader is already being iterated")
        self._in_iter = True
        if self._persistent_it is None:
            # A fresh pipeline: a safe cursor left by a torn-down one is stale
            # (a live persistent pipeline keeps its own, which still guards
            # the rows it buffers).
            self._pending_safe_state = None
        if self._last_input_state is None:
            self._last_input_state = self._snapshot_input_state()
        try:
            if self._steps_per_epoch is None:
                it = self._prefetched(self._host_batches())
                try:
                    yield from it
                finally:
                    it.close()
                return
            # One pipeline for every pass: tearing it down between passes
            # would drop its staged batches from the stream, so with
            # num_epochs=None the next pass continues where this one stopped.
            if self._persistent_it is None:
                self._persistent_it = self._prefetched(self._host_batches())
            for step in range(self._steps_per_epoch):
                try:
                    batch = next(self._persistent_it)
                except StopIteration:
                    self._persistent_it = None
                    # A short pass would leave this rank out of collectives
                    # its peers enter: fail loudly instead.
                    raise RuntimeError(
                        f"stream ended after {step} of {self._steps_per_epoch} "
                        f"steps_per_epoch: a finite reader ran dry mid-pass. Open the reader "
                        f"with num_epochs=None (continuous aligned passes) or bound "
                        f"steps_per_epoch to what every epoch can deliver") from None
                except BaseException:
                    # A real failure ends the pipeline: a retrying caller
                    # builds a new one.
                    self._persistent_it = None
                    raise
                yield batch
        finally:
            self._in_iter = False

    # ------------------------------------------------------------ telemetry
    def stall_report(self) -> dict:
        """Stall attribution of this loader's delivered batches: counts and
        fractions of host-bound, device-bound and balanced steps, the
        delivery wait against the consumer's busy time, and the host side's
        ``host_wait_s`` (production) against ``stage_s`` (staging)."""
        return self.stall.report(self.metrics)

    def critical_path_report(self) -> dict:
        """Per delivered batch, the stage (``fetch``, ``decode``,
        ``transport``, ``shuffle``, ``stage``, ``assemble``) that accrued the
        most self-time: counts per stage, the dominant one, and the recent
        batches' self-times."""
        return self.critical_path.report()

    def timeline_report(self) -> dict:
        """The pipeline's rolling timeline ring. A loader over a Reader
        shares its registry, so this is the reader's timeline: one ring
        covering decode through staging. Empty when the ops plane is off."""
        timeline = getattr(self.telemetry, "timeline", None)
        return {} if timeline is None else timeline.as_dict()

    def export_trace(self, path: str) -> int:
        """Write the registry's retained spans to ``path`` as a Chrome trace
        (``ui.perfetto.dev``, ``chrome://tracing``); returns the count of
        spans written. Needs trace mode (``PETASTORM_TPU_TELEMETRY_TRACE=1``
        when the registry is made, or ``telemetry.recorder.enable_trace()``)
        and raises otherwise: an empty trace would read as "nothing
        happened"."""
        rec = self.telemetry.recorder
        if not rec.trace_enabled:
            raise RuntimeError("trace mode is off: set PETASTORM_TPU_TELEMETRY_TRACE=1 (or call "
                               "telemetry.recorder.enable_trace()) before the epoch you want "
                               "to export")
        spans = [sp.as_dict() for sp in rec.spans()]
        write_chrome_trace(path, spans,
                           metadata={"critical_path": self.critical_path.report()["counts"]})
        return len(spans)

    def stage_breakdown(self) -> dict:
        """Cumulative seconds by pipeline stage, the JAX loaders' keys:

        * ``decode_s``: the workers' read and decode (thread and dummy
          pools; 0 on processes, whose workers do not share the registry);
        * ``pool_queue_s``: the reader blocked on the pool's results;
        * ``shuffle_s``: the shuffling buffer's adds and retrievals;
        * ``host_wait_s``: the staging thread waiting on a host batch
          (reader pull and collate; it overlaps the two above);
        * ``stage_s``: sanitizing and the copy onto the device;
        * ``device_put_wait_s``: the consumer blocked on the staged queue,
          the stall a training step sees.

        The loader's entries count this loader's batches; the reader's
        (decode, pool wait) are the pipeline's, shared with any other loader
        over the same reader."""
        hists = self.telemetry.snapshot(include_trace=False)["histograms"]
        m = self.metrics.as_dict()
        shuffle_total = self._shuffle_time.value
        if shuffle_total < self._shuffle_base:
            self._shuffle_base = 0.0   # a registry-wide reset() under us
        return {
            "decode_s": round(hists.get("worker.decode_s", {}).get("sum", 0.0), 6),
            "pool_queue_s": round(hists.get("reader.pool_wait_s", {}).get("sum", 0.0), 6),
            "shuffle_s": round(shuffle_total - self._shuffle_base, 6),
            "host_wait_s": m["host_wait_s"],
            "stage_s": m["stage_s"],
            "device_put_wait_s": self.stall.report()["delivery_wait_s"],
        }

    def _register_shuffle_gauges(self, buf):
        """The buffer's fill and capacity gauges; returns the closures so the
        pass's teardown clears exactly these."""
        fill_fn = lambda: buf.size  # noqa: E731 - identity matters
        capacity_fn = lambda: buf.capacity  # noqa: E731
        self.telemetry.gauge("shuffle_buffer.fill", fill_fn)
        self.telemetry.gauge("shuffle_buffer.capacity", capacity_fn)
        return fill_fn, capacity_fn

    def _clear_shuffle_gauges(self, fns) -> None:
        """Drop the gauges' closures at the end of a pass (the registry lives
        as long as the reader, and a closure would keep the buffer and its
        rows), only where they are still this pass's."""
        fill_fn, capacity_fn = fns
        self.telemetry.gauge("shuffle_buffer.fill").clear_function(fill_fn)
        self.telemetry.gauge("shuffle_buffer.capacity").clear_function(capacity_fn)

    def close(self):
        """Stop the staging thread (if an iterator was abandoned or a
        ``steps_per_epoch`` pipeline lives) and stop and join the reader,
        when the loader holds one. ``with loader: ...`` does this on exit."""
        if self._persistent_it is not None:
            self._persistent_it.close()
            self._persistent_it = None
        if self._stage_stop is not None:
            self._stage_stop.set()
        reader = getattr(self, "_reader", None)
        if reader is not None:
            reader.stop()
            reader.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _pad_to(arrays, target_len: int):
    """Arrays of one or more dimensions zero-padded (or cut) along the
    first to ``target_len`` and stacked -> ``(stacked, int32 lengths)``,
    the lengths before the cut."""
    lengths = np.asarray([len(a) for a in arrays], np.int32)
    first = arrays[0]
    out = np.zeros((len(arrays), target_len) + first.shape[1:], dtype=first.dtype)
    for i, a in enumerate(arrays):
        n = min(len(a), target_len)
        out[i, :n] = a[:n]
    return out, lengths


class DataLoader(LoaderBase):
    """Batches of a row reader, staged onto ``device``.

    :param reader: a ``make_reader`` reader
    :param batch_size: rows per batch
    :param shuffling_queue_capacity: > 1 enables a seeded row shuffling buffer
    :param min_after_retrieve: shuffle-quality floor of the buffer (default
        half its capacity)
    :param seed: buffer RNG seed
    :param shuffle_fast_rng: the buffer draws its indices in blocks of 63-bit
        words (the default); ``False`` draws one bounded index a pop, the
        stream the JAX package gives with ``shuffle_fast_rng=False``

    The other arguments are :class:`LoaderBase`'s (``telemetry`` defaults to
    the reader's registry). On the card a batch's fields under 1 MiB are
    views of one allocation: a field kept past its batch (the labels, for
    metrics) keeps those, and no larger field.
    """

    #: Rows between flushes of the row shuffle's seconds into the shared
    #: counter (two locked adds a row would cost more than they measure).
    _SHUFFLE_FLUSH_ROWS = 256

    def __init__(self, reader, batch_size: int,
                 shuffling_queue_capacity: int = 0,
                 min_after_retrieve: Optional[int] = None,
                 seed: Optional[int] = None,
                 drop_last: bool = True, pad_last: bool = False,
                 prefetch: int = 2, device="cuda", echo: int = 1,
                 dtype_policy: DTypePolicy = DEFAULT_POLICY,
                 steps_per_epoch: Optional[int] = None, sharding=None, telemetry=None,
                 pad_variable_length_to=None, keep_host_fields: bool = True,
                 shuffle_fast_rng: bool = True):
        super().__init__(batch_size, drop_last=drop_last, pad_last=pad_last, prefetch=prefetch,
                         device=device, echo=echo, dtype_policy=dtype_policy,
                         steps_per_epoch=steps_per_epoch, sharding=sharding,
                         telemetry=(telemetry if telemetry is not None
                                    else getattr(reader, "telemetry", None)),
                         pad_variable_length_to=pad_variable_length_to,
                         keep_host_fields=keep_host_fields)
        self._reader = reader
        self._ngram = getattr(reader, "ngram", None)
        self._shuffling_capacity = shuffling_queue_capacity
        self._min_after = min_after_retrieve
        self._seed = seed
        self._shuffle_fast_rng = bool(shuffle_fast_rng)
        if shuffling_queue_capacity and shuffling_queue_capacity > 1:
            self._ckpt_hazard = _SHUFFLE_HAZARD

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
            seed=self._seed, batched_rng=self._shuffle_fast_rng)
        gauge_fns = self._register_shuffle_gauges(buf)
        shuffle_actuator = self._register_shuffle_actuator(buf)
        shuffle_time = self._shuffle_time
        pending_s, rows_out = 0.0, 0
        it = iter(self._reader)
        exhausted = False
        try:
            while True:
                while not exhausted and buf.can_add:
                    try:
                        row = next(it)
                    except StopIteration:
                        exhausted = True
                        buf.finish()
                        break
                    t0 = time.perf_counter()
                    buf.add_many([row])
                    pending_s += time.perf_counter() - t0
                if buf.can_retrieve:
                    t0 = time.perf_counter()
                    row = buf.retrieve()
                    pending_s += time.perf_counter() - t0
                    rows_out += 1
                    if rows_out % self._SHUFFLE_FLUSH_ROWS == 0:
                        shuffle_time.add(pending_s)
                        pending_s = 0.0
                    yield row
                elif exhausted:
                    return
        finally:
            shuffle_time.add(pending_s)
            self._unregister_actuator(shuffle_actuator)
            self._clear_shuffle_gauges(gauge_fns)

    def _collate(self, rows) -> Dict[str, np.ndarray]:
        if self._ngram is not None:
            return self._collate_ngram(rows)
        out = {}
        for name in rows[0]._fields:
            out.update(self._columns(name, [getattr(r, name) for r in rows]))
        return out

    def _varlen(self, name: str) -> bool:
        field = self._reader.schema.fields.get(name)
        return field is not None and any(d is None for d in field.shape)

    def _pad_target(self, name: str):
        return (self._pad_varlen.get(name) if isinstance(self._pad_varlen, dict)
                else self._pad_varlen)

    def _columns(self, name: str, values: list) -> Dict[str, np.ndarray]:
        """One field's values as batch columns: for a variable-length field
        padded to ``pad_variable_length_to`` with its ``<name>__len``, or
        without it an object array (a host column); else one stack, nulls
        raising."""
        if self._varlen(name):
            if self._pad_varlen is not None:
                padded, lengths = _pad_to(values, self._pad_target(name))
                return {name: padded, name + "__len": lengths}
            arr = np.empty(len(values), object)
            for i, v in enumerate(values):
                arr[i] = v
            return {name: arr}
        if any(v is None for v in values):
            raise ValueError(f"Field {name!r} contains nulls; exclude the field "
                             f"or fill the nulls before batching")
        return {name: np.stack([np.asarray(v) for v in values])}

    def _collate_ngram(self, windows) -> Dict[str, np.ndarray]:
        """NGram windows -> one array per field with the window offsets as
        a dense sequence axis, ``(batch, length, *shape)``. Dense windows
        (``{name: (length, *shape)}``) stack once per field. Row windows
        (``{offset: namedtuple}``) stack per offset when every offset has
        the same fields, and otherwise flatten to ``"{name}/{offset}"`` keys
        of ``(batch, *shape)``. A variable-length field needs
        ``pad_variable_length_to``; its ``__len`` column has the same
        layout."""
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

        def column(name, values):
            """(the batch-stacked array, its lengths or None) of one offset."""
            if any(v is None for v in values):
                raise ValueError(f"Field {name!r} contains nulls; exclude the field "
                                 f"or fill the nulls before batching")
            if self._varlen(name):
                if self._pad_varlen is None:
                    raise ValueError(f"Field {name!r} is variable-length; NGram windows "
                                     f"stack into dense arrays: pass pad_variable_length_to, "
                                     f"exclude the field or pad it at write time")
                return _pad_to(values, self._pad_target(name))
            return np.stack([np.asarray(v) for v in values]), None

        out = {}
        if all(fs == fieldsets[0] for fs in fieldsets):
            for name in fieldsets[0]:
                per_offset = [column(name, [getattr(w[o], name) for w in windows])
                              for o in offsets]
                out[name] = np.stack([arr for arr, _ in per_offset], axis=1)
                if per_offset[0][1] is not None:
                    out[name + "__len"] = np.stack([ln for _, ln in per_offset], axis=1)
        else:
            for o in offsets:
                for name in windows[0][o]._fields:
                    arr, lengths = column(name, [getattr(w[o], name) for w in windows])
                    out[f"{name}/{o}"] = arr
                    if lengths is not None:
                        out[f"{name}/{o}__len"] = lengths
        return out

    def _lazy_columns(self, batch) -> Dict[str, np.ndarray]:
        """One ColumnarBatch's columns as arrays, by :meth:`_collate`'s rule
        (:meth:`_columns`), applied once a column instead of once a row; an
        array column of a fixed-shape field passes through."""
        out = {}
        for name, col in batch.columns.items():
            if isinstance(col, np.ndarray) and col.dtype != object and not self._varlen(name):
                out[name] = col
            else:
                out.update(self._columns(name, list(col)))
        return out

    def _lazy_host_batches(self):
        """The lazy row plane (the JAX package's ``_batch_native_host_batches``):
        whole ColumnarBatches off ``reader.next_batch()``, shuffled as
        permuted slices by a :class:`BatchShufflingBuffer` when
        ``shuffling_queue_capacity > 1``, else re-chunked in order, and
        collated by one ``np.concatenate`` a column: no loop over rows
        between the worker and the pinned stager. A batch of one slice is a
        view of the buffer's pool; the stager copies it before the next
        batch is assembled."""
        reader = self._reader
        if reader.last_row_consumed:
            reader.reset()
        shuffled = self._shuffling_capacity and self._shuffling_capacity > 1
        if shuffled:
            buf = BatchShufflingBuffer(
                self._shuffling_capacity,
                min_after_retrieve=(self._min_after if self._min_after is not None
                                    else self._shuffling_capacity // 2),
                seed=self._seed)
        else:
            buf = BatchedNoopShufflingBuffer(self._batch_size)
        gauge_fns = self._register_shuffle_gauges(buf)
        shuffle_actuator = self._register_shuffle_actuator(buf)
        shuffle_time = self._shuffle_time
        exhausted = False
        buffered_rows = 0
        parts, part_rows = [], 0
        try:
            while True:
                while not exhausted and buf.can_add:
                    if buffered_rows == 0 and part_rows == 0:
                        # Nothing buffered: every later batch is made of rows
                        # pulled after this cursor, so it resumes without loss.
                        self._pending_safe_state = self._snapshot_live_state()
                    try:
                        cols = self._lazy_columns(reader.next_batch())
                    except StopIteration:
                        exhausted = True
                        buf.finish()
                        break
                    if cols:
                        buffered_rows += len(next(iter(cols.values())))
                        t0 = time.perf_counter()
                        buf.add_many(cols)
                        shuffle_time.add(time.perf_counter() - t0)
                if buf.can_retrieve:
                    t0 = time.perf_counter()
                    piece = (buf.retrieve_batch(self._batch_size - part_rows) if shuffled
                             else buf.retrieve())
                    shuffle_time.add(time.perf_counter() - t0)
                    n = len(next(iter(piece.values())))
                    buffered_rows = max(0, buffered_rows - n)
                    parts.append(piece)
                    part_rows += n
                    # A slice is capped at what the batch still needs, and the
                    # FIFO serves whole batches up to its short tail: a batch
                    # is exact, never overshot.
                    if part_rows == self._batch_size:
                        yield concat_column_slices(parts)
                        parts, part_rows = [], 0
                elif exhausted:
                    break
            if part_rows:
                tail = self._finalize_tail(concat_column_slices(parts), part_rows)
                if tail is not None:
                    yield tail
        finally:
            self._unregister_actuator(shuffle_actuator)
            self._clear_shuffle_gauges(gauge_fns)

    def _host_batches(self):
        if getattr(self._reader, "row_materialization", "eager") == "lazy" and self._ngram is None:
            yield from self._lazy_host_batches()
            return
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



class BatchedDataLoader(LoaderBase):
    """Batches of a batched reader (``make_batch_reader``), staged onto
    ``device``: each row group's columns go through a vectorized buffer
    that re-chunks them into ``batch_size`` rows, in order, or drawn at
    random when ``shuffling_queue_capacity > 1``.

    :param reader: a ``make_batch_reader`` reader
    :param batch_size: rows per batch
    :param shuffling_queue_capacity: > 1 enables a seeded shuffling buffer of
        that many rows (a row group is added whole)
    :param min_after_retrieve: shuffle-quality floor of the buffer (default
        half its capacity)
    :param seed: buffer RNG seed

    The other arguments are :class:`LoaderBase`'s. On the card a batch's
    columns under 1 MiB are views of one allocation: a column kept past its
    batch keeps those, and no larger column. Without shuffling, a
    batch inside one row group is a slice of the reader's arrays: on a
    process reader those view the ring until the batch is staged (or, on
    ``device="cpu"``, until its tensors are dropped). Such ``device="cpu"``
    tensors wrap read-only memory (the ring's, or Arrow's on threads):
    ``.clone()`` one before writing into it.
    """

    def __init__(self, reader, batch_size: int, shuffling_queue_capacity: int = 0,
                 min_after_retrieve: Optional[int] = None, seed: Optional[int] = None,
                 **kwargs):
        if kwargs.get("telemetry") is None:
            kwargs["telemetry"] = getattr(reader, "telemetry", None)
        super().__init__(batch_size, **kwargs)
        if not getattr(reader, "batched_output", False):
            raise TypeError("BatchedDataLoader consumes make_batch_reader readers")
        self._reader = reader
        self._shuffling_capacity = shuffling_queue_capacity
        self._min_after = min_after_retrieve
        self._seed = seed
        if shuffling_queue_capacity and shuffling_queue_capacity > 1:
            self._ckpt_hazard = _SHUFFLE_HAZARD

    def _host_batches(self):
        if self._reader.last_row_consumed:
            self._reader.reset()
        if self._shuffling_capacity and self._shuffling_capacity > 1:
            buf = BatchedRandomShufflingBuffer(
                self._shuffling_capacity,
                min_after_retrieve=(self._min_after if self._min_after is not None
                                    else self._shuffling_capacity // 2),
                batch_size=self._batch_size, seed=self._seed)
        else:
            buf = BatchedNoopShufflingBuffer(self._batch_size)
        gauge_fns = self._register_shuffle_gauges(buf)
        shuffle_actuator = self._register_shuffle_actuator(buf)
        shuffle_time = self._shuffle_time
        telemetry = self.telemetry
        exhausted = False
        tail = None
        buffered_rows = 0
        try:
            while True:
                while not exhausted and buf.can_add:
                    if buffered_rows == 0:
                        # Nothing buffered: every later batch is made of rows
                        # pulled after this cursor, so it resumes without loss.
                        # Batches cut from a buffered group keep the older
                        # cursor (resume reads the group again); the plain
                        # buffer holds up to two batches, so it empties only
                        # where the stream does, as in the JAX package.
                        self._pending_safe_state = self._snapshot_live_state()
                    try:
                        cols = self._batchable_columns(self._reader.next_batch())
                    except StopIteration:
                        exhausted = True
                        buf.finish()
                        continue
                    if cols:
                        buffered_rows += len(next(iter(cols.values())))
                        t0 = time.perf_counter()
                        with telemetry.span("petastorm_tpu.shuffle_add", stage="shuffle",
                                            track="shuffler"):
                            buf.add_many(cols)
                        shuffle_time.add(time.perf_counter() - t0)
                    # A group left in this frame would pin its ring record
                    # while the generator waits at a yield.
                    del cols
                if buf.can_retrieve:
                    t0 = time.perf_counter()
                    with telemetry.span("petastorm_tpu.shuffle_retrieve", stage="shuffle",
                                        track="shuffler"):
                        batch = buf.retrieve()
                    shuffle_time.add(time.perf_counter() - t0)
                    n = len(next(iter(batch.values())))
                    buffered_rows = max(0, buffered_rows - n)
                    if n == self._batch_size:
                        yield batch
                    else:
                        tail = batch
                elif exhausted:
                    break
            if tail is not None:
                tail = self._finalize_tail(tail, len(next(iter(tail.values()))))
                if tail is not None:
                    yield tail
        finally:
            self._unregister_actuator(shuffle_actuator)
            self._clear_shuffle_gauges(gauge_fns)


class InMemBatchedDataLoader(LoaderBase):
    """Reads ``reader`` once into memory, then serves ``num_epochs`` epochs
    of batches from it, in a new ``default_rng(seed)`` permutation each
    epoch when ``shuffle``. A batched reader's batchable columns
    (:meth:`LoaderBase._batchable_columns`) or a row reader's fixed-shape,
    non-null fields are kept, copied off the reader's buffers as each group
    arrives (so no ring record stays pinned); the reader is not closed.

    The other arguments are :class:`LoaderBase`'s.
    """

    def __init__(self, reader, batch_size: int, num_epochs: int = 1, shuffle: bool = True,
                 seed: Optional[int] = None, **kwargs):
        if kwargs.get("telemetry") is None:
            kwargs["telemetry"] = getattr(reader, "telemetry", None)
        super().__init__(batch_size, **kwargs)
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._data = {}
        if getattr(reader, "batched_output", False):
            columns: Dict[str, list] = {}
            for group in reader:
                # Copies, not views: on a process reader a column views its
                # ring record, and records pinned until the whole read ends
                # would fill the rings before a large store is read.
                owned = {name: arr.copy() if arr.base is not None else arr
                         for name, arr in self._batchable_columns(group).items()}
                del group
                for name, arr in owned.items():
                    columns.setdefault(name, []).append(arr)
            self._data = {k: np.concatenate(v) for k, v in columns.items()}
        else:
            rows = list(reader)
            if not rows:
                raise ValueError("Reader yielded no rows")
            for name in rows[0]._fields:
                values = [getattr(r, name) for r in rows]
                if any(v is None for v in values) or isinstance(values[0], (str, bytes)):
                    self._warn_skipped_fields([name])
                    continue
                try:
                    self._data[name] = np.stack([np.asarray(v) for v in values])
                except ValueError:
                    self._warn_skipped_fields([name])   # ragged
        if not self._data:
            raise ValueError("No batchable (fixed-shape, non-null, numeric) fields found")
        self._num_rows = len(next(iter(self._data.values())))

    def _host_batches(self):
        for _ in range(self._num_epochs):
            order = (self._rng.permutation(self._num_rows) if self._shuffle
                     else np.arange(self._num_rows))
            for start in range(0, self._num_rows, self._batch_size):
                idx = order[start:start + self._batch_size]
                batch = self._finalize_tail({k: v[idx] for k, v in self._data.items()},
                                            len(idx))
                if batch is not None:
                    yield batch


def aligned_steps_per_epoch(dataset_url_or_urls, batch_size: int,
                            shard_count: Optional[int] = None,
                            drop_last: bool = True, shard_seed: Optional[int] = None,
                            filters=None, storage_options: Optional[dict] = None,
                            filesystem=None) -> int:
    """Batches every shard of the store can deliver in one epoch: the
    least, over shards ``index % shard_count == shard`` of the store's row
    groups (the readers' sharding: after the partition ``filters`` and the
    ``random.Random(shard_seed)`` shuffle, when given, as the readers plan
    them), of the shard's rows over ``batch_size`` (floored, or ceiled when
    not ``drop_last``). Every rank computes the same number from the
    metadata, without communicating; pass it as ``steps_per_epoch`` so no
    rank steps into a collective its peers skip. ``shard_count`` defaults
    to the ``torch.distributed`` world size when a process group is
    initialised, else 1.

    The bound holds for readers that deliver every row of their shard (a
    row reader, or a batched reader; not an NGram's windows). The row
    counts come from the summary ``_metadata`` when it lists every planned
    group (one read), else from the footers. ``storage_options`` and
    ``filesystem`` reach the store as the readers' do."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, load_row_groups,
                                                          summary_row_group_row_counts)
    from petastorm_tpu_torch.reader import _apply_filters, _shard_row_groups

    if shard_count is None:
        dist = torch.distributed
        shard_count = (dist.get_world_size() if dist.is_available() and dist.is_initialized()
                       else 1)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    ctx = DatasetContext(dataset_url_or_urls, storage_options=storage_options,
                         filesystem=filesystem)
    groups = load_row_groups(ctx)
    if filters:
        groups = _apply_filters(groups, filters)
    paths = sorted({rg.path for rg in groups})
    planned = collections.Counter(rg.path for rg in groups)
    summary = summary_row_group_row_counts(ctx) or {}
    summary = {os.path.normpath(p): rows for p, rows in summary.items()}
    rows_by_path = {p: summary.get(os.path.normpath(p)) for p in paths}
    if any(rows is None or len(rows) != planned[p] for p, rows in rows_by_path.items()):
        # No summary, or a stale one: the footers.
        def footer_rows(path):
            with ctx.filesystem.open(path, "rb") as f:
                md = pq.ParquetFile(f).metadata
                return path, [md.row_group(i).num_rows for i in range(md.num_row_groups)]

        with ThreadPoolExecutor(max_workers=10) as pool:
            rows_by_path = dict(pool.map(footer_rows, paths))
    steps = []
    for shard in range(shard_count):
        refs = _shard_row_groups(groups, shard, shard_count, shard_seed)
        rows = sum(rows_by_path[rg.path][rg.row_group] for rg in refs)
        n = rows // batch_size if drop_last else -(-rows // batch_size)
        if n == 0:
            raise ValueError(
                f"shard {shard}/{shard_count} holds only {rows} rows, fewer than one batch "
                f"of {batch_size}{' (drop_last)' if drop_last else ''}. Use a smaller batch, "
                f"fewer shards or larger row groups")
        steps.append(n)
    return min(steps)
