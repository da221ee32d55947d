"""Where the process reader's time goes on this host: the cost of a page's
first touch, a 9.6 MB record (one 64-row group of 224x224x3 images,
pickled) through a fresh ring against a prefaulted one, and the reader
alone with threads against processes at two ring capacities, on a store
like ``chip_smoke.py``'s phase 4 (2048 rows, 224x224x3 JPEG q90, 64 rows a
row group). Run it from the repository's root:

    python3 tools/torch_ring_probe.py

Every reading is printed, nothing is judged; rates move from one run to
the next, so compare them only within one run. It needs no GPU."""
import mmap
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np

from petastorm_tpu_torch import native
from petastorm_tpu_torch import reader as reader_mod
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec, native_decode_status
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers_pool.process_pool import prefault

RECORD = 9_633_000
PAGE = 4096


def page_touch():
    for kind in ("anonymous", "/dev/shm"):
        n = 256 << 20
        if kind == "anonymous":
            m = mmap.mmap(-1, n)
        else:
            path = f"/dev/shm/pt_probe_touch_{os.getpid()}"
            fd = os.open(path, os.O_CREAT | os.O_RDWR)
            os.ftruncate(fd, n)
            m = mmap.mmap(fd, n)
            os.close(fd)
            os.unlink(path)
        a = np.frombuffer(m, np.uint8)
        t = time.perf_counter()
        a[::PAGE] = 1
        first = time.perf_counter() - t
        t = time.perf_counter()
        a[::PAGE] = 2
        second = time.perf_counter() - t
        print(f"{kind} 256 MiB: first touch {1e6 * first / (n // PAGE):.2f} us a page, "
              f"again {1e6 * second / (n // PAGE):.3f} us a page", flush=True)
        del a
        m.close()


def ring_records():
    payload = np.random.default_rng(0).integers(0, 256, RECORD, dtype=np.uint8).tobytes()
    for cap, warm in ((128 << 20, False), (128 << 20, True), (32 << 20, False)):
        name = f"/pt_probe_ring_{os.getpid()}_{cap}_{warm}"
        ring = native.make_ring(name, capacity=cap, create=True, impl="native")
        if warm:
            prefault(ring, write=True)
        ms = []
        for _ in range(16):
            t = time.perf_counter()
            ring.write_tagged(ord("D"), payload)
            _, view = ring.read_tagged_view()
            bytes(view)
            view.release()
            ring.advance()
            ms.append(1000 * (time.perf_counter() - t))
        ring.close()
        print(f"ring {cap >> 20} MiB{', prefaulted' if warm else ''}: a {RECORD / 1e6:.1f} MB "
              f"record written and copied out, ms: " + " ".join(f"{x:.1f}" for x in ms), flush=True)


def smooth_image(rng, shape=(224, 224, 3)):
    coarse = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)
    ys = np.linspace(0, 6, shape[0])
    xs = np.linspace(0, 6, shape[1])
    img = coarse[np.round(ys).astype(int)][:, np.round(xs).astype(int)]
    return np.clip(img + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)


def reader_rates():
    with tempfile.TemporaryDirectory() as tmp:
        url = f"file://{tmp}/store"
        schema = Unischema("ImageNetLike", [
            UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
            UnischemaField("image", np.uint8, (224, 224, 3), CompressedImageCodec("jpeg", 90),
                           False)])
        rng = np.random.default_rng(1234)
        with materialize_dataset_local(url, schema, rows_per_row_group=64) as w:
            for i in range(2048):
                w.write_row({"id": i, "image": smooth_image(rng)})

        def rate(pool_type, workers, epochs):
            t0 = time.perf_counter()
            with make_reader(url, reader_pool_type=pool_type, workers_count=workers,
                             num_epochs=epochs, seed=0) as r:
                n = 0
                for _ in r:
                    if n == 0:
                        t1 = time.perf_counter()
                    n += 1
                t2 = time.perf_counter()
            return (f"{pool_type} x{workers}: first row {t1 - t0:.2f} s, "
                    f"{(n - 1) / (t2 - t1):.0f} rows/s")

        for cap in (128 << 20, 32 << 20):
            reader_mod.DEFAULT_RING_CAPACITY = cap
            print(f"ring {cap >> 20} MiB | " + " | ".join(
                rate(p, 8, e) for p, e in (("thread", 2), ("process", 2), ("process", 6))),
                flush=True)


if __name__ == "__main__":
    print(f"{os.cpu_count()} cores; decode {native_decode_status()}", flush=True)
    page_touch()
    ring_records()
    reader_rates()
