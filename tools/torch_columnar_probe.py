"""What the Arrow serializer's lead bytes buy on this host: one row group of
the columnar path's tensor store (65,536 rows: ``id``, 8 float32 and 2
float32 ``FixedSizeList(64)`` columns, 36.2 MB) serialized as the process
pool's workers serialize it, laid where a ring record's payload lies (5
bytes past an 8-byte boundary), then deserialized and converted as the
consumer does, with the stream on an 8-byte boundary (the serializer's
``LEAD`` bytes) and without them. For each: whether the columns view the
record and their alignment, then the time for ``BatchedDataLoader(
batch_size=1024)`` to serve the group as ``device`` batches (its staging
thread, pinned buffers and side stream onto the card; plain tensors where
there is no card), until the last batch is on the device, in turns. Run it
from the repository's root:

    python3 tools/torch_columnar_probe.py

Every reading is printed, nothing is judged."""
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import pyarrow as pa
import torch

from petastorm_tpu_torch.loader import BatchedDataLoader
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import LEAD, ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.batch_reader_worker import arrow_table_to_numpy_dict
from petastorm_tpu_torch.unischema import Unischema

ROWS, BATCH, LIST, REPS = 1 << 16, 1024, 64, 7


def group_table() -> pa.Table:
    rng = np.random.default_rng(0)
    cols = {"id": np.arange(ROWS, dtype=np.int64)}
    cols.update({f"f{i}": rng.standard_normal(ROWS).astype(np.float32) for i in range(8)})
    for j in range(2):
        flat = rng.standard_normal(ROWS * LIST).astype(np.float32)
        cols[f"emb{j}"] = pa.FixedSizeListArray.from_arrays(pa.array(flat), LIST)
    return pa.table(cols)


def as_record(payload: bytes) -> memoryview:
    """``payload`` copied to an address 5 bytes past an 8-byte boundary."""
    buf = np.zeros(len(payload) + 16, np.uint8)
    start = (5 - buf.ctypes.data) % 8
    buf[start:start + len(payload)] = np.frombuffer(payload, np.uint8)
    return memoryview(buf)[start:start + len(payload)]


class OneGroup:
    """A batched reader that yields one row group's columns once."""
    batched_output = True
    last_row_consumed = False

    def __init__(self, cols: dict):
        self._cols = cols

    def next_batch(self) -> dict:
        if self._cols is None:
            raise StopIteration
        cols, self._cols = self._cols, None
        return cols


def stage(cols: dict, device: str) -> None:
    for _ in BatchedDataLoader(OneGroup(cols), batch_size=BATCH, device=device):
        pass
    if device == "cuda":
        torch.cuda.synchronize()


def main():
    device = "cuda" if torch.cuda.is_available() else "cpu"
    print(f"device {torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'}; "
          f"pyarrow {pa.__version__}; numpy {np.__version__}; torch {torch.__version__}")
    table = group_table()
    schema = Unischema.from_arrow_schema(table.schema)
    aligned = bytes(memoryview(ArrowTableSerializer().serialize(table)))
    records = {"aligned (lead)": as_record(aligned),
               "misaligned (no lead)": as_record(aligned[LEAD:])}
    cols = {}
    for name, rec in records.items():
        stream = rec[LEAD:] if name.startswith("aligned") else rec
        table = pa.ipc.open_stream(pa.py_buffer(stream)).read_all()
        out = arrow_table_to_numpy_dict(table, schema)
        base = np.frombuffer(rec.obj, np.uint8)
        views = all(np.may_share_memory(v, base) for v in out.values())
        print(f"{name}: columns view the record {views}; "
              f"addresses mod 8 {sorted({v.ctypes.data % 8 for v in out.values()})}; "
              f"numpy ALIGNED {all(v.flags.aligned for v in out.values())}")
        cols[name] = out
    times = {name: [] for name in cols}
    order = list(cols) + list(cols)[::-1]
    for _ in range(REPS):
        for name in order:
            t0 = time.perf_counter()
            stage(cols[name], device)
            times[name].append(time.perf_counter() - t0)
    nbytes = sum(v.nbytes for v in cols["aligned (lead)"].values())
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"{name}: stage {ROWS // BATCH} batches of {BATCH} rows ({nbytes / 1e6:.1f} MB) "
              f"{'onto the card' if device == 'cuda' else 'as CPU tensors'}: median {med * 1e3:.3f} ms "
              f"({nbytes / med / 1e9:.2f} GB/s) over {len(ts)} runs, min {min(ts) * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
