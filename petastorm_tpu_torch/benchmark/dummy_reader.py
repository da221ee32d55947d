"""A synthetic reader for the loader's throughput alone, without Parquet
I/O (the JAX package's ``benchmark/dummy_reader.py``)::

    python -m petastorm_tpu_torch.benchmark.dummy_reader [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.test_util.reader_mock import ReaderMock
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

DummyBenchSchema = Unischema("DummyBench", [
    UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField("value", np.float32, (128,), NdarrayCodec(), False),
])


def make_dummy_reader(num_rows: int = 100000, seed: int = 0) -> ReaderMock:
    """``num_rows`` of one constant row: the loader's cost, not the rows'."""
    rng = np.random.default_rng(seed)
    row = {"id": np.int64(0), "value": rng.normal(size=128).astype(np.float32)}
    return ReaderMock(DummyBenchSchema, lambda _schema: row, num_rows=num_rows)


def loader_throughput_sweep(batch_sizes=(10, 100, 1000, 10000), rows: int = 50000,
                            device="cuda") -> dict:
    """Samples per second of the port's ``DataLoader`` onto ``device`` at
    each batch size (each batch waited for on the card); prints a line
    each."""
    import torch

    from petastorm_tpu_torch.loader import DataLoader
    results = {}
    for bs in batch_sizes:
        loader = DataLoader(make_dummy_reader(rows), batch_size=bs, device=device)
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += len(batch["id"])
            if batch["id"].device.type == "cuda":
                torch.cuda.synchronize(batch["id"].device)
        dt = time.perf_counter() - t0
        results[bs] = n / dt
        print(f"batch_size={bs}: {n / dt:,.0f} samples/sec")
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    loader_throughput_sweep(device=ap.parse_args().device)
