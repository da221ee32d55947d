"""One pinned copy a batch against one copy a column, on the card. The
loaders' stager (``loader._PinnedStager``: a batch's columns in one pinned
buffer, one host-to-device copy for the columns under 1 MiB and one for
each larger column) and the stager it replaced (``PerColumnStager`` below:
one pinned buffer and one copy a column) are swapped in turn into the
package's loaders. For each:

* the staging alone of one batch of the scalar, tensor and image paths
  (``chip_smoke.staging_batches``), host milliseconds, median of 200, the
  two stagers in turns;
* ``chip_smoke.py`` phase 12's scalar bench onto the card (3 threads, 2
  processes) and its tensor store's plain ``BatchedDataLoader`` epoch (8
  threads, 8 processes), each in the order one copy a column, a batch, a
  batch, a column; every tensor epoch's values are held against a
  ``pyarrow.parquet`` read of the store and counted.

Run it from the repository's root on a machine with a CUDA card:

    python3 tools/torch_staging_probe.py

Every reading is printed; only a wrong value fails the run."""
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

import chip_smoke as smoke
from petastorm_tpu_torch.benchmark.scalar_bench import (batched_loader_throughput,
                                                        generate_scalar_dataset,
                                                        generate_tensor_dataset)
from petastorm_tpu_torch.loader import BatchedDataLoader
from petastorm_tpu_torch.loader import loader as loader_module

REPS = 200


class PerColumnStager:
    """The loaders' earlier staging: one pinned buffer and one
    host-to-device copy per column, on a side stream."""

    def __init__(self, device: torch.device, ring_size: int):
        self._device = device
        self._ring_size = ring_size
        self._stream = torch.cuda.Stream(device)
        self._rings, self._next = {}, {}

    def stage(self, cols):
        sig = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in cols.items())
        ring = self._rings.setdefault(sig, [])
        pos = self._next.get(sig, 0)
        self._next[sig] = (pos + 1) % self._ring_size
        if pos == len(ring):
            ring.append([{k: torch.empty(tuple(v.shape), dtype=loader_module._torch_dtype(v.dtype),
                                         pin_memory=True) for k, v in cols.items()}, None])
        slot = ring[pos]
        buffers, event = slot
        if event is not None:
            event.synchronize()
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


STAGERS = {"one copy a column": PerColumnStager,
           "one copy a batch": loader_module._PinnedStager}
ORDER = ["one copy a column", "one copy a batch", "one copy a batch", "one copy a column"]


class staged_by:
    """``with staged_by(cls):`` the package's loaders stage with ``cls``."""

    def __init__(self, stager):
        self._stager, self._saved = stager, loader_module._PinnedStager

    def __enter__(self):
        loader_module._PinnedStager = self._stager

    def __exit__(self, *exc):
        loader_module._PinnedStager = self._saved
        return False


def staging_ms(cols: dict) -> dict:
    """Host milliseconds each stager takes to stage ``cols`` (the copies
    issued, the consumer's stream made to wait), median of ``REPS``, the
    two timed in turns after a warm-up."""
    device = torch.device("cuda", torch.cuda.current_device())
    made = {name: cls(device, 3) for name, cls in STAGERS.items()}
    consumer = torch.cuda.current_stream()
    for stager in made.values():
        for _ in range(10):
            stager.stage(cols)
    torch.cuda.synchronize()
    times = {name: [] for name in made}
    for rep in range(REPS):
        for name in (list(made) if rep % 2 == 0 else list(made)[::-1]):
            t0 = time.perf_counter()
            staged, event = made[name].stage(cols)
            consumer.wait_event(event)
            for v in staged.values():
                v.record_stream(consumer)
            times[name].append(time.perf_counter() - t0)
            del staged
    torch.cuda.synchronize()
    return {name: 1e3 * statistics.median(t) for name, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_staging_probe: no CUDA device is available", file=sys.stderr)
        return 1
    print(smoke.phase_probe(), flush=True)
    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        scalar_url = generate_scalar_dataset(f"file://{tmp}/scalar_100k")
        for what, cols in smoke.staging_batches(scalar_url).items():
            ms = staging_ms(cols)
            print(f"[staging] alone, a {what} batch ({len(cols)} columns, "
                  f"{sum(v.nbytes for v in cols.values())} bytes): "
                  + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
                  + f" (host, median of {REPS})", flush=True)
        for pool_type, workers in smoke.SCALAR_WORKERS.items():
            for name in ORDER:
                with staged_by(STAGERS[name]):
                    rate = batched_loader_throughput(scalar_url, workers_count=workers,
                                                     pool_type=pool_type, device="cuda",
                                                     **smoke.SCALAR_BENCH)
                print(f"[staging] scalar bench, {pool_type} x{workers} -> cuda, {name}: "
                      f"{rate:.1f} rows/s", flush=True)
        tensor_url = generate_tensor_dataset(f"file://{tmp}/tensor", rows=smoke.TENSOR_ROWS,
                                             files=smoke.TENSOR_FILES,
                                             row_group_size=smoke.TENSOR_GROUP,
                                             list_size=smoke.TENSOR_LIST)
        ref = smoke._tensor_reference(tensor_url)
        for pool_type in ("thread", "process"):
            for name in ORDER:
                with staged_by(STAGERS[name]):
                    r = smoke._tensor_loader_epoch(
                        tensor_url, pool_type,
                        lambda reader: BatchedDataLoader(reader, batch_size=smoke.COLUMNAR_BATCH,
                                                         device="cuda"), ref)
                what = (f"tensor BatchedDataLoader plain, {pool_type} "
                        f"x{smoke.COLUMNAR_WORKERS}, {name}")
                print("[staging] " + smoke._columnar_line(what, r)[len("[columnar] "):]
                      + f"; {r['mismatches']} values differ", flush=True)
                if r["rows"] != smoke.TENSOR_ROWS or not r["every_row_once"] or r["mismatches"]:
                    wrong.append(what)
        del ref
    if wrong:
        print(f"torch_staging_probe: wrong values in {wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
