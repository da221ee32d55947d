#!/usr/bin/env python
"""Does the end of an epoch read as a throughput collapse?

A batch reader with ``timeline_interval_s=0.1`` and the default anomaly
bank feeds ``BatchedDataLoader(batch_size=500)`` (prefetch 2), whose
consumer spends ``--step-s`` seconds a batch as a training step would. Once
the reader has delivered its last row the loader's prefetched batches keep
the consumer busy, the reader's ``rows_per_s`` reads 0, and the bank may
flag ``throughput_collapse``. The probe prints, for each run, the windows,
the window that delivered the last row, and the detections with their
windows. It runs either package on the CPU:

    python tests/torch_epoch_end_probe.py --package torch
    JAX_PLATFORMS=cpu python tests/torch_epoch_end_probe.py --package jax

(the repo root on ``PYTHONPATH``).
"""
import argparse
import tempfile
import time

import numpy as np


def _store(rows: int) -> str:
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = tempfile.mkdtemp(prefix="epoch-end-")
    pq.write_table(pa.table({"id": pa.array(np.arange(rows, dtype=np.int64)),
                             "x": pa.array(np.random.default_rng(0).standard_normal(rows))}),
                   f"{path}/part0.parquet", row_group_size=250)
    return f"file://{path}"


def run(package: str, url: str, rows: int, step_s: float) -> dict:
    if package == "jax":
        from petastorm_tpu.jax import BatchedDataLoader
        from petastorm_tpu.reader import make_batch_reader
        loader_kw = {}
    else:
        from petastorm_tpu_torch.loader import BatchedDataLoader
        from petastorm_tpu_torch.reader import make_batch_reader
        loader_kw = {"device": "cpu"}
    with make_batch_reader(url, workers_count=2, num_epochs=1, shuffle_row_groups=False,
                           timeline_interval_s=0.1) as reader:
        for _ in BatchedDataLoader(reader, batch_size=500, **loader_kw):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < step_s:   # the step's stand-in: busy
                pass
    windows = reader.timeline_report()["windows"]
    delivered, last_row_window = 0.0, None
    for w in windows:
        delivered += (w["series"].get("rows_per_s") or 0.0) * w["dt_s"]
        if last_row_window is None and delivered >= rows - 0.01:
            last_row_window = w["index"]
    return {"windows": len(windows), "last_row_window": last_row_window,
            "detections": [(d["rule"], d["window"])
                           for d in reader.anomaly_report()["detections"]]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("jax", "torch"), required=True)
    parser.add_argument("--rows", type=int, default=4000)
    parser.add_argument("--step-s", type=float, default=0.15)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    url = _store(args.rows)
    for i in range(args.runs):
        print(f"{args.package} run {i}: {run(args.package, url, args.rows, args.step_s)}",
              flush=True)


if __name__ == "__main__":
    main()
