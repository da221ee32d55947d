"""Data-parallel ingestion: one dataset read by H hosts, each a disjoint
shard of its row groups, delivered as one batch a step.

The port of ``petastorm_tpu/jax/mesh_loader.py``. :class:`MeshDataLoader`
runs H per-host readers, opened by a :class:`MeshReaderFactory` over row-group
ordinals, and assembles their rows into batches:

* **in one process** (no ``torch.distributed`` group, or a group of one)
  every host is simulated here: a puller thread a host, and each step takes
  ``batch_size`` rows from the parts the hosts delivered. The batch goes to
  ``device`` whole;
* **across ranks** (an initialised default group of P > 1 ranks, a mesh
  with a ``"data"`` axis of size H) one host is one data rank: each rank
  reads only its own shard and delivers ``batch_size // H`` rows a step to
  its own device. A rank's batch is its slice of the global batch; nothing
  is gathered (the JAX loader binds the slices into one global array).

A host's reader is pulled one item at a time: a batched reader's row group,
a lazy row reader's ``ColumnarBatch`` (``row_materialization="lazy"`` among
the factory's arguments; through ``next_batch()``, its list columns stacked
once), a row reader's row or a dense NGram window.

Shard plan
----------
:meth:`MeshDataLoader.epoch_plan` applies the reader's own shard arithmetic
(``reader._shard_row_groups``: ``index % H == h``, after a
``random.Random(seed + epoch)`` shuffle) to the ordinals ``0..G-1``, and host
h opens a reader with ``rowgroup_subset=plan[h]``: its rows are those of a
``cur_shard=h, shard_count=H, shard_seed=seed + epoch`` reader. A host whose
shard is empty (more hosts than row groups) feeds nothing that epoch.

Host loss and elastic reshard
-----------------------------
An exception that escapes a host's reader, or :meth:`MeshDataLoader.kill_host`,
marks the host lost. In one process its row groups not yet delivered are
dealt round-robin to the surviving hosts, which read them after their own
(recovery sources). "Delivered" is a watermark a source keeps as it hands
parts over: with a batched reader on one thread or inline worker
(:attr:`MeshReaderFactory.fifo_delivery`) groups arrive in plan order and the
watermark counts them exactly, so a lost host's groups are read again exactly
once; otherwise it is the reader's own cursor, which never counts a group not
handed out (no row lost, a group may come twice). ``strict=True``, a
multi-rank topology (a peer's range cannot be read from here) or a loss with
no survivor raises :class:`MeshHostLostError` instead.

Cursor
------
:meth:`~petastorm_tpu_torch.loader.loader.LoaderBase.state_dict` gives
``{"mesh": True, "epoch", "hosts": {h: plan position}, "num_rowgroups",
"num_hosts"}`` (plus ``"recovered"``, the ordinals delivered by recovery
sources, and ``"resharded"`` after a reshard), the JAX loader's cursor key
for key: each crosses to the other package's loader. A cursor resumes only
under the same host and row-group counts; a cursor with a ``"growth"``
table (live data) raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.loader.loader import LoaderBase
from petastorm_tpu_torch.reader_impl.batch_plane import ColumnarBatch

logger = logging.getLogger(__name__)

__all__ = ["MeshDataLoader", "MeshReaderFactory", "MeshHostLostError"]


class MeshHostLostError(RuntimeError):
    """A host's input pipeline died and could not be resharded: ``strict=True``,
    a multi-rank topology, or no surviving host."""


class _HostKilled(Exception):
    """:meth:`MeshDataLoader.kill_host` interrupting a puller."""


class _ConfigError(Exception):
    """A collation or configuration error: every survivor would fail alike
    on the reassigned groups, so it fails the loader instead of the host."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class MeshReaderFactory:
    """The per-host reader of one dataset: ``factory(ordinals)`` opens a
    one-epoch reader over exactly those row groups, in that order
    (``make_batch_reader`` when ``batched``, else ``make_reader``), with
    every other reader argument passed through.

    ``workers_count`` defaults to 1: with one thread (or the inline pool) a
    batched reader delivers its groups in plan order, which makes the
    loader's reshard exactly-once (:attr:`fifo_delivery`). The hosts give
    the parallelism; more workers a host trade that for a reshard that may
    read a group twice.
    """

    #: The loader's own arguments: the shard plan, the epochs and the order.
    _OWNED = frozenset({"cur_shard", "shard_count", "shard_seed", "rowgroup_subset",
                        "num_epochs", "shuffle_row_groups", "resume_state"})

    def __init__(self, dataset_url: str, batched: bool = False, **reader_kwargs):
        owned = self._OWNED & set(reader_kwargs)
        if owned:
            raise ValueError(f"MeshDataLoader owns {sorted(owned)}; configure sharding, epochs "
                             f"and order on the loader, not the factory")
        self.dataset_url = dataset_url
        self.batched = bool(batched)
        self.reader_kwargs = dict(reader_kwargs)
        self.reader_kwargs.setdefault("workers_count", 1)
        pool = self.reader_kwargs.get("reader_pool_type", "thread")
        #: True when a host's groups arrive in plan order (a batched reader,
        #: one item a group, on one thread or the inline pool): the reshard
        #: then counts delivered groups exactly.
        self.fifo_delivery = (self.batched and self.reader_kwargs["workers_count"] == 1
                              and pool in ("thread", "dummy"))

    def num_rowgroups(self) -> int:
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, load_row_groups
        return len(load_row_groups(DatasetContext(self.dataset_url)))

    def __call__(self, rowgroup_subset: Sequence[int]):
        from petastorm_tpu_torch.reader import make_batch_reader, make_reader
        make = make_batch_reader if self.batched else make_reader
        return make(self.dataset_url, rowgroup_subset=list(rowgroup_subset),
                    shuffle_row_groups=False, num_epochs=1, **self.reader_kwargs)


class _Source:
    """One reader's worth of a host's work: ordinals read in order.
    ``pulled`` counts the items handed to the assembler."""

    __slots__ = ("ordinals", "reader", "pulled", "recovery", "plan_base", "fifo", "counted",
                 "safe_delivered", "plan_positions")

    def __init__(self, ordinals, recovery: bool = False, plan_base: int = 0,
                 plan_positions=None):
        self.ordinals = list(ordinals)
        self.reader = None
        self.pulled = 0
        self.recovery = recovery
        #: Position of ``ordinals[0]`` in the host's epoch plan (primary
        #: sources), so a delivered count maps back to a plan position.
        self.plan_base = plan_base
        #: Plan position of each ordinal when the list has holes (a resume
        #: left out ordinals that recovery sources delivered); None:
        #: contiguous from ``plan_base``.
        self.plan_positions = None if plan_positions is None else list(plan_positions)
        #: Counts delivered groups by enqueues (the factory's FIFO claim,
        #: held only for a batched reader: one item is one group).
        self.fifo = False
        #: Groups already in the host's ``rowgroups`` counter.
        self.counted = 0
        #: Delivered groups as of the last enqueue: the only watermark the
        #: reshard may trust (the live one may count a group pulled from the
        #: reader but never enqueued).
        self.safe_delivered = 0

    def plan_watermark(self, delivered: int) -> int:
        """Plan position after ``delivered`` groups of this source."""
        if self.plan_positions is None:
            return self.plan_base + delivered
        if delivered <= 0:
            return self.plan_base
        return self.plan_positions[min(delivered, len(self.plan_positions)) - 1] + 1

    def delivered_groups(self) -> int:
        """Groups handed to the assembler, never more: enqueues on a FIFO
        source; else the reader's cursor (a finished pass counts whole)."""
        if self.fifo:
            return self.pulled
        if self.reader is None:
            return 0
        try:
            state = self.reader.state_dict()
        except Exception:  # noqa: BLE001 - a dying reader still has a plan
            return 0
        if int(state.get("epoch", 0)) > 0:
            return len(self.ordinals)
        return int(state.get("offset", 0))


class _Part:
    """One item's batchable columns, consumed by the assembler in slices."""

    __slots__ = ("host", "cols", "rows", "off", "source", "delivered_after")

    def __init__(self, host: int, cols: Dict[str, np.ndarray], rows: int, source: _Source):
        self.host = host
        self.cols = cols
        self.rows = rows
        self.off = 0
        self.source = source
        #: The source's delivered groups when this part was enqueued: once
        #: the part is in a delivered batch, so are that many groups.
        self.delivered_after = 0


class _HostFeed:
    """A host's pipeline in one epoch: its sources, its puller thread, its
    queue of ready parts, and its loss and consumption state."""

    def __init__(self, idx: int, stop: threading.Event):
        self.idx = idx
        #: The epoch's teardown flag, set for good when the epoch ends.
        self.stop = stop
        self.sources: collections.deque = collections.deque()
        self.current: Optional[_Source] = None
        self.queue: collections.deque = collections.deque()
        self.thread: Optional[threading.Thread] = None
        self.killed = threading.Event()
        self.lost: Optional[BaseException] = None
        self.exhausted = False
        #: Groups of this host's plan consumed into delivered batches.
        self.primary_consumed = 0


class MeshDataLoader(LoaderBase):
    """H per-host readers -> one batch a step on ``device``.

    :param reader_factory: ``callable(ordinals) -> reader``, a one-epoch
        reader over exactly those row groups in that order
        (:class:`MeshReaderFactory`, which also gives ``num_rowgroups()``
        and ``fifo_delivery``)
    :param batch_size: the **global** rows a step. In one process a batch
        holds all of them; on a rank of H data ranks, ``batch_size // H``
    :param mesh: a :class:`~petastorm_tpu_torch.parallel.mesh.Mesh`; with an
        initialised default group of more than one rank the default is
        ``make_mesh([-1], ["data"])`` (every rank must construct the loader).
        The batch is split over its data axis only: the JAX loader's
        ``partition_spec=`` is left out
    :param num_hosts: hosts simulated in one process (default 1); across
        ranks it is the data axis' size and may only repeat it
    :param num_epochs: passes over the dataset (``None``: endless)
    :param seed: epoch e plans with shard seed ``seed + e``; ``None`` keeps
        ordinal order
    :param strict: a lost host raises :class:`MeshHostLostError` instead of
        resharding (always so across ranks)
    :param resume_state: a :meth:`state_dict` of this loader or of the JAX
        package's: the epoch and each host's plan position
    :param num_rowgroups: the store's row groups, instead of asking the factory
    :param host_queue_depth: decoded parts a host keeps ready (backpressure)

    The other arguments are :class:`~petastorm_tpu_torch.loader.loader.LoaderBase`'s
    (``device``, ``prefetch``, ``pad_last``, ``echo``, ...). The short last
    batch must be dropped (the default) or padded, to this rank's rows.
    """

    def __init__(self, reader_factory, batch_size: int, mesh=None, *,
                 num_hosts: Optional[int] = None, num_epochs: Optional[int] = 1,
                 seed: Optional[int] = None, strict: bool = False,
                 resume_state: Optional[dict] = None, num_rowgroups: Optional[int] = None,
                 host_queue_depth: int = 2, **kwargs):
        from petastorm_tpu_torch.parallel.mesh import make_mesh, mesh_feed_topology
        super().__init__(batch_size, **kwargs)
        if not self._drop_last and not self._pad_last:
            raise ValueError("a ragged tail batch cannot be split over the mesh's data ranks; "
                             "keep drop_last=True or pass pad_last=True")
        if mesh is None and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            mesh = make_mesh([-1], ["data"])
        self._mesh = mesh
        shards = int(mesh.shape["data"]) if mesh is not None else 1
        if batch_size % shards:
            raise ValueError(f"global batch_size {batch_size} must divide evenly over the "
                             f"{shards} ranks of the mesh's 'data' axis")
        self._H, self._local_host, self._multiprocess = mesh_feed_topology(mesh, num_hosts)
        #: Rows a step this process delivers.
        self._step_rows = batch_size // self._H if self._multiprocess else batch_size
        # A peer rank's range cannot be read from here, and a lost peer
        # would leave the collectives waiting either way.
        self._strict = bool(strict) or self._multiprocess

        self._factory = reader_factory
        if num_rowgroups is None:
            probe = getattr(reader_factory, "num_rowgroups", None)
            if probe is None:
                raise ValueError("pass num_rowgroups= or a factory with num_rowgroups() "
                                 "(MeshReaderFactory has it)")
            num_rowgroups = int(probe())
        if num_rowgroups < 1:
            raise ValueError(f"dataset has no row groups ({num_rowgroups})")
        self._G = num_rowgroups
        self._fifo = bool(getattr(reader_factory, "fifo_delivery", False))
        self._seed = seed
        if num_epochs is not None and num_epochs < 1:
            raise ValueError(f"num_epochs must be >= 1 or None, got {num_epochs}")
        self._num_epochs = num_epochs
        self._host_queue_depth = max(1, int(host_queue_depth))

        self._resume_epoch = 0
        self._resume_offsets: Optional[List[int]] = None
        self._resume_recovered: List[int] = []
        if resume_state is not None:
            self._load_resume_state(resume_state)

        # The live epoch's state, rebuilt by _epoch_batches.
        self._cond = threading.Condition()
        self._feeds: List[_HostFeed] = []
        self._outstanding = 0
        self._epoch_done = False
        self._fatal: Optional[BaseException] = None
        self._collate_lock = threading.Lock()
        self._canonical_keys: Optional[frozenset] = None
        #: Did this epoch reshard (provenance on the cursor)?
        self._epoch_resharded = False
        #: Ordinals delivered this epoch by recovery sources: the cursor's
        #: ``recovered`` set, which a resume leaves out of every host's plan.
        self._recovered_live: set = set()
        #: The live epoch's stop flag, which close() sets.
        self._live_stop: Optional[threading.Event] = None
        self._closing = False
        self._lost_hosts: List[dict] = []
        self._epoch_t0: Optional[float] = None

        # mesh_report's counters (the JAX loader keeps them as ``mesh.*``
        # counters in its registry; this loader's registry, LoaderBase's,
        # holds the staging, stall and critical-path metrics only).
        self._reshard_events = 0
        self._wall_s = 0.0
        self._host_ids = [self._local_host] if self._multiprocess else list(range(self._H))
        self._host_stall_s = {h: 0.0 for h in self._host_ids}
        self._host_rows = {h: 0 for h in self._host_ids}
        self._host_groups = {h: 0 for h in self._host_ids}

        # Checkpointable from step 0: the (resumed) epoch's start.
        hosts0 = {str(h): 0 for h in range(self._H)}
        if self._resume_offsets is not None:
            hosts0 = {str(h): o for h, o in enumerate(self._resume_offsets)}
        self._last_input_state = {"mesh": True, "epoch": self._resume_epoch, "hosts": hosts0,
                                  "num_rowgroups": self._G, "num_hosts": self._H}

    # ------------------------------------------------------------- planning
    def epoch_plan(self, epoch: int) -> List[List[int]]:
        """Each host's row-group ordinals for ``epoch``: host h's list is what
        a ``cur_shard=h, shard_count=H, shard_seed=seed + epoch`` reader
        plans, in its order; a host may get none."""
        from petastorm_tpu_torch.reader import _shard_row_groups
        ordinals = list(range(self._G))
        shard_seed = None if self._seed is None else int(self._seed) + int(epoch)
        plan: List[List[int]] = []
        for h in range(self._H):
            try:
                plan.append([int(o) for o in _shard_row_groups(ordinals, h, self._H, shard_seed)])
            except NoDataAvailableError:
                plan.append([])
        return plan

    def _load_resume_state(self, state: dict) -> None:
        if not isinstance(state, dict) or "hosts" not in state:
            raise ValueError(f"not a MeshDataLoader state_dict: {state!r}")
        if state.get("num_hosts") != self._H:
            raise ValueError(f"resume_state was saved over {state.get('num_hosts')} hosts but "
                             f"this loader plans {self._H}; the per-host shard cursors do not "
                             f"transfer")
        if state.get("growth"):
            raise NotImplementedError(
                "resume_state carries a live-data growth table; growing datasets are not "
                "ported yet (ROADMAP Queue A item 9, live data)")
        recorded = int(state.get("num_rowgroups", -1))
        if recorded != self._G:
            raise ValueError(f"resume_state was saved over {recorded} row groups but this "
                             f"loader plans {self._G}; the shard plans do not transfer (a grown "
                             f"dataset is live data, not ported yet)")
        self._resume_epoch = int(state.get("epoch", 0))
        hosts = state["hosts"]
        if isinstance(hosts, dict):
            offsets = [int(hosts.get(str(h), hosts.get(h, 0))) for h in range(self._H)]
        else:
            offsets = [int(v) for v in hosts]
        if len(offsets) != self._H:
            raise ValueError(f"resume_state carries {len(offsets)} host cursors, need {self._H}")
        self._resume_offsets = offsets
        self._resume_recovered = sorted(int(o) for o in state.get("recovered", ()))

    # ------------------------------------------------------------ host side
    def kill_host(self, host: int) -> None:
        """Fault drill: cut host ``host``'s pipeline at its next item. Parts it
        already handed over stay in the stream; its unread groups are
        resharded to the survivors (or raise, ``strict``). Only while an
        epoch is live."""
        if self._multiprocess:
            raise NotImplementedError("kill_host simulates the loss of a host in one process; "
                                      "across ranks, stop the rank's process")
        with self._cond:
            feeds = self._feeds
            if not feeds:
                raise RuntimeError("no live epoch to kill a host in")
            if not 0 <= host < len(feeds):
                raise ValueError(f"host {host} out of range [0, {len(feeds)})")
            feeds[host].killed.set()
            self._cond.notify_all()

    def _pull_host(self, feed: _HostFeed) -> None:
        try:
            while True:
                with self._cond:
                    while (not feed.sources and not self._epoch_done
                           and not feed.killed.is_set() and not feed.stop.is_set()):
                        # Parked: a reshard may still hand this host a
                        # recovery source.
                        self._cond.wait(0.1)
                    if feed.stop.is_set():
                        return
                    if feed.killed.is_set():
                        raise _HostKilled(f"host {feed.idx} killed")
                    if not feed.sources:
                        return   # the epoch is complete
                    src = feed.sources.popleft()
                    feed.current = src
                self._run_source(feed, src)
                # Cleared only on a clean end: a failed source stays visible
                # to _on_host_lost, which reshards its undelivered groups.
                feed.current = None
        except _ConfigError as e:
            with self._cond:
                if self._fatal is None:
                    self._fatal = e.cause
                self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 - any failure is the host's loss
            self._on_host_lost(feed, e)
        finally:
            with self._cond:
                feed.exhausted = True
                self._cond.notify_all()

    def _items(self, reader):
        # A batched or lazy reader hands over a row group a pull (a lazy
        # one as a ColumnarBatch), with the row readers' delivery watermark.
        if reader.batched_output or getattr(reader, "row_materialization", "eager") == "lazy":
            while True:
                try:
                    yield reader.next_batch()
                except StopIteration:
                    return
        else:
            yield from reader

    def _run_source(self, feed: _HostFeed, src: _Source) -> None:
        reader = self._factory(src.ordinals)
        src.reader = reader
        src.fifo = self._fifo and bool(reader.batched_output)
        try:
            it = self._items(reader)
            while True:
                if feed.killed.is_set():
                    raise _HostKilled(f"host {feed.idx} killed")
                item = next(it, None)
                if item is None:
                    break
                part = self._part_from_item(feed, src, item)
                del item
                if part is None:
                    src.pulled += 1   # empty after column selection: delivered vacuously
                    continue
                with self._cond:
                    while (len(feed.queue) >= self._host_queue_depth
                           and not feed.killed.is_set() and not feed.stop.is_set()):
                        self._cond.wait(0.05)
                    if feed.stop.is_set():
                        return
                    if feed.killed.is_set():
                        raise _HostKilled(f"host {feed.idx} killed")
                    src.pulled += 1
                    part.delivered_after = src.delivered_groups()
                    src.safe_delivered = part.delivered_after
                    feed.queue.append(part)
                    self._host_rows[feed.idx] += part.rows
                    if part.delivered_after > src.counted:
                        self._host_groups[feed.idx] += part.delivered_after - src.counted
                        src.counted = part.delivered_after
                    self._cond.notify_all()
            with self._cond:
                # A clean end delivered every group (a row reader confirms
                # its last group only after its last row).
                if src.counted < len(src.ordinals):
                    self._host_groups[feed.idx] += len(src.ordinals) - src.counted
                    src.counted = len(src.ordinals)
                self._source_done(1)
        finally:
            try:
                reader.stop()
                reader.join()
            except Exception as e:  # noqa: BLE001 - teardown is best effort
                logger.warning("mesh host %d reader teardown failed: %s", feed.idx, e)

    def _source_done(self, n: int) -> None:
        """Caller holds ``self._cond``."""
        self._outstanding -= n
        if self._outstanding <= 0:
            self._epoch_done = True
        self._cond.notify_all()

    def _on_host_lost(self, feed: _HostFeed, exc: BaseException) -> None:
        with self._cond:
            if feed.stop.is_set() or feed.lost is not None:
                return
            feed.lost = exc
            self._lost_hosts.append({"host": feed.idx, "error": repr(exc)})
            # The undelivered range: the in-flight source past its safe
            # watermark and every source not started. Parts already queued
            # were handed over: the assembler still drains them.
            undelivered: List[int] = []
            abandoned = 0
            if feed.current is not None:
                s = feed.current
                undelivered.extend(s.ordinals[s.safe_delivered:])
                abandoned += 1
            for s in feed.sources:
                undelivered.extend(s.ordinals)
            abandoned += len(feed.sources)
            feed.sources.clear()
            survivors = [f for f in self._feeds if f is not feed and f.lost is None
                         and f.thread is not None and not f.exhausted]
            if self._strict or not survivors:
                why = "strict=True" if self._strict else "no surviving hosts"
                fatal = MeshHostLostError(
                    f"host {feed.idx} lost mid-epoch with {len(undelivered)} row group(s) "
                    f"undelivered and elastic reshard unavailable ({why}): {exc!r}")
                fatal.__cause__ = exc if isinstance(exc, Exception) else None
                self._fatal = fatal
                self._source_done(abandoned)
                return
            # Deal the range round-robin to the survivors. The cursor stays
            # valid: recovery deliveries fold into its ``recovered`` set.
            self._epoch_resharded = True
            buckets: List[List[int]] = [[] for _ in survivors]
            for i, o in enumerate(undelivered):
                buckets[i % len(survivors)].append(o)
            added = 0
            for f, bucket in zip(survivors, buckets):
                if bucket:
                    f.sources.append(_Source(bucket, recovery=True))
                    added += 1
            self._reshard_events += 1
            logger.warning("mesh host %d lost (%r); resharded %d row group(s) to %d survivor(s)",
                           feed.idx, exc, len(undelivered), len(survivors))
            self._outstanding += added
            self._source_done(abandoned)

    # ------------------------------------------------------------- collation
    def _part_from_item(self, feed: _HostFeed, src: _Source, item) -> Optional[_Part]:
        try:
            with self._collate_lock:
                if isinstance(item, ColumnarBatch):
                    cols = self._lazy_batch_columns(item)
                elif src.reader.batched_output:
                    cols = self._batchable_columns(item)
                elif hasattr(item, "_fields"):
                    cols = self._row_columns(item)
                elif isinstance(item, dict):
                    cols = self._ngram_columns(item)
                else:
                    raise TypeError(f"mesh host reader yielded {type(item).__name__}; expected "
                                    f"a namedtuple, a batch of columns, a ColumnarBatch or an "
                                    f"NGram dense window")
                if not cols:
                    return None
                rows = len(next(iter(cols.values())))
                keys = frozenset(cols)
                if self._canonical_keys is None:
                    self._canonical_keys = keys
                elif keys != self._canonical_keys:
                    raise ValueError(
                        f"host {feed.idx} produced batchable columns {sorted(keys)} but the "
                        f"stream established {sorted(self._canonical_keys)}; make nullable or "
                        f"ragged columns uniform with a TransformSpec (or exclude them) so "
                        f"every host contributes the same fields")
        except (TypeError, ValueError) as e:
            raise _ConfigError(e) from e
        return _Part(feed.idx, cols, rows, src)

    def _lazy_batch_columns(self, batch: ColumnarBatch) -> Dict[str, np.ndarray]:
        """A lazy reader's ColumnarBatch -> batchable columns: array columns
        pass through, list columns stack once; strings, objects, nulls and
        ragged cells are dropped with the loaders' one warning, as on the
        row path."""
        cols, skipped = {}, []
        for name, col in batch.columns.items():
            if isinstance(col, np.ndarray):
                if col.dtype == object or col.dtype.kind in "US":
                    skipped.append(name)
                else:
                    cols[name] = col
                continue
            try:
                if any(v is None for v in col):
                    skipped.append(name)
                    continue
                arr = np.stack([np.asarray(v) for v in col])
            except (TypeError, ValueError):
                skipped.append(name)
                continue
            if arr.dtype == object or arr.dtype.kind in "US":
                skipped.append(name)
            else:
                cols[name] = arr
        self._warn_skipped_fields(skipped)
        return cols

    def _row_columns(self, row) -> Dict[str, np.ndarray]:
        """A row's namedtuple -> 1-row columns; strings, objects and nulls
        are dropped with the loaders' one warning."""
        cols, skipped = {}, []
        for name in row._fields:
            value = getattr(row, name)
            if value is None:
                skipped.append(name)
                continue
            arr = np.asarray(value)
            if arr.dtype == object or arr.dtype.kind in "US":
                skipped.append(name)
                continue
            cols[name] = arr[None]
        self._warn_skipped_fields(skipped)
        return cols

    @staticmethod
    def _ngram_columns(window: dict) -> Dict[str, np.ndarray]:
        """A dense NGram window -> 1-row columns, the window axis as
        dimension 1, as ``DataLoader``'s dense collate."""
        first = next(iter(window.values()), None)
        if hasattr(first, "_fields"):
            raise ValueError("mesh ingestion of NGram readers requires dense=True (column-major "
                             "windows); per-offset namedtuple windows have no fixed-shape batch")
        cols = {}
        for name, value in window.items():
            arr = np.asarray(value)
            if arr.dtype == object:
                raise ValueError(f"Field {name!r} contains nulls or ragged values; fill them "
                                 f"with a TransformSpec before mesh batching")
            cols[name] = arr[None]
        return cols

    # ------------------------------------------------------------- assembly
    def _host_batches(self):
        epoch = self._resume_epoch
        offsets = self._resume_offsets
        recovered = self._resume_recovered
        passes = 0
        while self._num_epochs is None or passes < self._num_epochs:
            yield from self._epoch_batches(epoch, offsets, recovered)
            if self._closing:
                return   # close() abandoned the epoch: start no other
            offsets, recovered = None, ()
            passes += 1
            epoch += 1

    def _epoch_batches(self, epoch: int, offsets: Optional[List[int]], recovered=()):
        plan = self.epoch_plan(epoch)
        stop = threading.Event()
        self._epoch_resharded = bool(recovered)
        self._recovered_live = set(int(o) for o in recovered)
        self._live_stop = stop
        feeds = [_HostFeed(h, stop) for h in range(self._H)]
        active = [feeds[self._local_host]] if self._multiprocess else feeds
        with self._cond:
            self._feeds = feeds
            self._epoch_done = False
            self._fatal = None
            self._outstanding = 0
            for feed in active:
                base = offsets[feed.idx] if offsets else 0
                feed.primary_consumed = base
                if self._recovered_live:
                    # A resume after a reshard: leave out what recovery
                    # sources delivered, keeping each ordinal's plan position.
                    positions = [i for i in range(base, len(plan[feed.idx]))
                                 if plan[feed.idx][i] not in self._recovered_live]
                    ordinals = [plan[feed.idx][i] for i in positions]
                    src = (_Source(ordinals, plan_base=base, plan_positions=positions)
                           if ordinals else None)
                else:
                    ordinals = plan[feed.idx][base:]
                    src = _Source(ordinals, plan_base=base) if ordinals else None
                if src is not None:
                    feed.sources.append(src)
                    self._outstanding += 1
            if self._outstanding == 0:
                self._epoch_done = True
        for feed in active:
            # Every active host gets a puller, an empty plan too: it parks,
            # and a reshard can hand it a recovery source.
            feed.thread = threading.Thread(target=self._pull_host, args=(feed,), daemon=True,
                                           name=f"petastorm-mesh-host{feed.idx}")
            feed.thread.start()

        pool: collections.deque = collections.deque()
        pool_rows = 0
        self._epoch_t0 = time.perf_counter()
        try:
            while True:
                with self._cond:
                    if self._fatal is not None:
                        raise self._fatal
                    if stop.is_set():
                        return   # close() mid-iteration
                    for feed in active:
                        while feed.queue:
                            part = feed.queue.popleft()
                            pool.append(part)
                            pool_rows += part.rows
                    self._cond.notify_all()   # wake the pullers held by backpressure
                    if pool_rows < self._step_rows:
                        if not (self._outstanding > 0 or any(f.queue for f in active)):
                            break
                        t0 = time.perf_counter()
                        self._cond.wait(0.05)
                        waited = time.perf_counter() - t0
                        for feed in active:
                            # Starved: live, nothing ready, and owed work (a
                            # parked host with no plan is not late).
                            if (not feed.queue and feed.lost is None and not feed.exhausted
                                    and (feed.current is not None or feed.sources)):
                                self._host_stall_s[feed.idx] += waited
                        continue
                while pool_rows >= self._step_rows:
                    cols, consumed = self._take(pool, self._step_rows)
                    self._mark_consumed(consumed, epoch)
                    pool_rows -= self._step_rows
                    yield cols
            if pool_rows:
                cols, consumed = self._take(pool, pool_rows)
                tail = self._finalize_tail(cols, pool_rows, target_rows=self._step_rows)
                if tail is not None:
                    self._mark_consumed(consumed, epoch)
                    yield tail
            # The epoch is complete: the next epoch's start is the cursor.
            self._pending_safe_state = self._cursor(epoch + 1, fresh=True)
        finally:
            self._wall_s += time.perf_counter() - self._epoch_t0
            self._epoch_t0 = None
            self._live_stop = None
            self._teardown_feeds(feeds, stop)

    @staticmethod
    def _take(pool, n: int):
        """``n`` rows off the pool of parts -> (columns, parts used up)."""
        chunks: Dict[str, list] = {}
        consumed = []
        need = n
        while need:
            part = pool[0]
            take = min(need, part.rows - part.off)
            for name, arr in part.cols.items():
                chunks.setdefault(name, []).append(arr[part.off:part.off + take])
            part.off += take
            need -= take
            if part.off == part.rows:
                pool.popleft()
                consumed.append(part)
        return {name: np.concatenate(parts) for name, parts in chunks.items()}, consumed

    def _mark_consumed(self, consumed_parts, epoch: int) -> None:
        """Advance the plan positions of the consumed primary parts, fold
        recovery deliveries into ``recovered``, and leave the cursor the
        staging thread snapshots with this batch."""
        for part in consumed_parts:
            src = part.source
            if src.recovery:
                self._recovered_live.update(src.ordinals[:part.delivered_after])
            else:
                feed = self._feeds[part.host]
                feed.primary_consumed = max(feed.primary_consumed,
                                            src.plan_watermark(part.delivered_after))
        self._pending_safe_state = self._cursor(epoch)

    def _cursor(self, epoch: int, fresh: bool = False) -> dict:
        feeds = [self._feeds[self._local_host]] if self._multiprocess else self._feeds
        hosts = {str(f.idx): (0 if fresh else f.primary_consumed) for f in feeds}
        state = {"mesh": True, "epoch": epoch, "hosts": hosts, "num_rowgroups": self._G,
                 "num_hosts": self._H}
        if not fresh and self._recovered_live:
            state["recovered"] = sorted(int(o) for o in self._recovered_live)
        if self._epoch_resharded and not fresh:
            state["resharded"] = True
        return state

    def _teardown_feeds(self, feeds, stop: threading.Event) -> None:
        # The flag stays set: a puller that outlives the join below still
        # exits at its next check.
        stop.set()
        with self._cond:
            self._cond.notify_all()
        for feed in feeds:
            if feed.thread is not None:
                feed.thread.join(10.0)
                if feed.thread.is_alive():
                    logger.warning("mesh host %d puller still busy at teardown; it exits at its "
                                   "next stop-flag check", feed.idx)
        with self._cond:
            self._feeds = []

    def close(self):
        """Stop the staging thread and the live epoch's hosts, and wait for the
        pullers, each of which stops and joins its own readers: no puller is
        left running when this returns."""
        self._closing = True
        with self._cond:
            if self._live_stop is not None:
                self._live_stop.set()
            feeds = list(self._feeds)
            self._cond.notify_all()
        super().close()
        for feed in feeds:
            if feed.thread is not None:
                feed.thread.join(15.0)

    # ------------------------------------------------------------ reporting
    def mesh_report(self) -> dict:
        """Ingestion health: each host's rows, row groups and input stall (the
        seconds the assembler waited on it while it owed work, also as a
        share of the ingest wall time), the reshards, the lost hosts and the
        skew between the most and least stalled host."""
        with self._cond:
            wall = self._wall_s
            if self._epoch_t0 is not None:
                wall += time.perf_counter() - self._epoch_t0
            per_host = {}
            for h in self._host_ids:
                stall = self._host_stall_s[h]
                per_host[h] = {"rows": int(self._host_rows[h]),
                               "rowgroups": int(self._host_groups[h]),
                               "input_stall_s": round(stall, 6),
                               "input_stall_pct": round(100.0 * stall / wall, 2) if wall else 0.0}
            stalls = [v["input_stall_s"] for v in per_host.values()]
            return {"hosts": self._H, "multiprocess": self._multiprocess,
                    "ingest_wall_s": round(wall, 6), "reshard_events": self._reshard_events,
                    "hosts_lost": list(self._lost_hosts),
                    "host_skew_s": round(max(stalls) - min(stalls), 6) if stalls else 0.0,
                    "per_host": per_host}
