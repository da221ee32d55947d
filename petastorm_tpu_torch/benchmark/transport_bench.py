"""Transport micro-benchmark: the process pool's shared-memory ring
against bytes over a pipe (the JAX package's
``benchmark/transport_bench.py``).

One producer process streams payloads of one size to this process, the
consumer: ``_WARMUP`` items, then ``n`` timed ones. The consumer reads the
warm-up, starts the clock, reads ``n`` items and stops it, so the
producer's start-up is not counted, and the buffer's backpressure keeps the
producer at most a buffer ahead. The ring is the package's native one
(``native/ringbuf.cpp``), or the pure-Python ``PyShmRing`` where g++ is
missing; the producers are started as the process pool starts its
workers (:mod:`..workers_pool.exec_in_new_process`).

:func:`reader_transport_sweep` times the reader end to end on threads and
on processes over the rings. ::

    python -m petastorm_tpu_torch.benchmark.transport_bench [--sizes ...]
    python -m petastorm_tpu_torch.benchmark.transport_bench --reader-sweep URL

prints one JSON line per payload size and transport and a markdown table.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from multiprocessing.connection import Connection, Pipe

_WARMUP = 64
_JOIN_S = 30
_READ_TIMEOUT_MS = 60_000
#: The record tag of a payload (the process pool's data records use it).
_DATA = ord("D")


def _ring_producer(name: str, impl: str, size: int, n: int) -> None:
    from petastorm_tpu_torch.native import make_ring
    ring = make_ring(name, create=False, impl=impl)
    payload = b"\x5a" * size
    for _ in range(_WARMUP + n):
        ring.write_tagged(_DATA, payload)
    ring.close_producer()


def _pipe_producer(fd: int, size: int, n: int) -> None:
    conn = Connection(fd)
    payload = b"\x5a" * size
    for _ in range(_WARMUP + n):
        conn.send_bytes(payload)
    conn.close()


def _finish(proc) -> None:
    import subprocess
    try:
        proc.wait(timeout=_JOIN_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def ring_throughput(size: int, n: int, capacity: int = 8 << 20, zero_copy: bool = False) -> dict:
    """Items/s and MB/s of the ring at one payload size: each record
    copied out (``read_tagged``), or with ``zero_copy`` looked at in place
    and released. ``ring_impl`` in the result says which ring ran."""
    from petastorm_tpu_torch.native import make_ring, resolve_ring_impl
    from petastorm_tpu_torch.workers_pool.exec_in_new_process import exec_in_new_process
    impl = resolve_ring_impl()
    name = f"/pt_torch_bench_ring_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    ring = make_ring(name, capacity=capacity, create=True, impl=impl)
    proc = exec_in_new_process(_ring_producer, name, impl, size, n)
    try:
        for _ in range(_WARMUP):
            ring.read_tagged(_READ_TIMEOUT_MS)
        t0 = time.perf_counter()
        if zero_copy:
            checksum = 0
            for _ in range(n):
                _kind, view = ring.read_tagged_view(_READ_TIMEOUT_MS)
                checksum += len(view)   # touched in place, not copied out
                view.release()
                ring.advance()
        else:
            for _ in range(n):
                ring.read_tagged(_READ_TIMEOUT_MS)
        dt = time.perf_counter() - t0
    finally:
        _finish(proc)
        ring.close()
    return _result(f"shm_ring{'_zero_copy' if zero_copy else ''}", size, n, dt, impl)


def pipe_throughput(size: int, n: int) -> dict:
    """Items/s and MB/s of a ``multiprocessing`` pipe (``send_bytes`` /
    ``recv_bytes``, its fastest mode; a pickling pool adds pickle framing)."""
    from petastorm_tpu_torch.workers_pool.exec_in_new_process import exec_in_new_process
    rx, tx = Pipe(duplex=False)
    proc = exec_in_new_process(_pipe_producer, tx.fileno(), size, n, pass_fds=(tx.fileno(),))
    tx.close()
    try:
        for _ in range(_WARMUP):
            rx.recv_bytes()
        t0 = time.perf_counter()
        for _ in range(n):
            rx.recv_bytes()
        dt = time.perf_counter() - t0
    finally:
        _finish(proc)
        rx.close()
    return _result("pipe", size, n, dt)


def _result(transport: str, size: int, n: int, dt: float, impl=None) -> dict:
    out = {"transport": transport, "payload_bytes": size, "items": n,
           "items_per_sec": round(n / dt, 1), "us_per_item": round(1e6 * dt / n, 2),
           "mb_per_sec": round(n * size / dt / 1e6, 1)}
    if impl is not None:
        out["ring_impl"] = impl
    return out


def run_sweep(sizes=(1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20),
              total_bytes: int = 64 << 20) -> list:
    """One row per payload size and transport; each cell moves about
    ``total_bytes`` (200 to 20,000 items)."""
    rows = []
    for size in sizes:
        n = max(200, min(20_000, total_bytes // size))
        rows.append(pipe_throughput(size, n))
        rows.append(ring_throughput(size, n))
        rows.append(ring_throughput(size, n, zero_copy=True))
    return rows


def reader_transport_sweep(dataset_url: str, workers: int = 2, warmup: int = 400,
                           measure: int = 4000, reruns: int = 2) -> dict:
    """Reader throughput end to end (``reader_throughput``, rows) on
    ``workers`` threads and on ``workers`` processes over the rings, each
    configuration in a fresh interpreter. (The JAX package's zmq arms have
    no counterpart: the port's pool has one transport.)"""
    import subprocess
    import sys

    from petastorm_tpu_torch.workers_pool.exec_in_new_process import PACKAGE_ROOT
    child = (
        "import json, os\n"
        "from petastorm_tpu_torch.benchmark.throughput import reader_throughput\n"
        "cfg = json.loads(os.environ['PT_SWEEP_CFG'])\n"
        "samples = [reader_throughput(cfg['url'], warmup_cycles=cfg['warmup'],\n"
        "                             measure_cycles=cfg['measure'], pool_type=cfg['pool'],\n"
        "                             loaders_count=cfg['workers']).samples_per_second\n"
        "           for _ in range(cfg['reruns'])]\n"
        "print('BENCHJSON:' + json.dumps(samples))\n")

    def run(pool):
        env = dict(os.environ, PT_SWEEP_CFG=json.dumps({
            "url": dataset_url, "pool": pool, "workers": workers, "warmup": warmup,
            "measure": measure, "reruns": reruns}))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_ROOT, env.get("PYTHONPATH"))
                                            if p)
        p = subprocess.run([sys.executable, "-c", child], env=env, capture_output=True,
                           text=True, timeout=900)
        for line in p.stdout.splitlines():
            if line.startswith("BENCHJSON:"):
                return json.loads(line[len("BENCHJSON:"):])
        raise RuntimeError(f"{pool}: rc={p.returncode}, stderr tail {p.stderr[-300:]!r}")

    return {f"thread_x{workers}": run("thread"), f"process_x{workers}_shm": run("process")}


def to_markdown(rows) -> str:
    by_size = {}
    for r in rows:
        by_size.setdefault(r["payload_bytes"], {})[r["transport"]] = r
    lines = ["| payload | pipe us/item | ring us/item | ring0cp us/item | "
             "pipe MB/s | ring MB/s | ring speedup |",
             "|---|---|---|---|---|---|---|"]
    for size in sorted(by_size):
        cell = by_size[size]
        pipe, ring = cell.get("pipe"), cell.get("shm_ring")
        zc = cell.get("shm_ring_zero_copy")
        if not (pipe and ring):
            continue
        speed = pipe["us_per_item"] / ring["us_per_item"]
        label = f"{size // 1024} KB" if size < (1 << 20) else f"{size // (1 << 20)} MB"
        lines.append(f"| {label} | {pipe['us_per_item']} | {ring['us_per_item']} | "
                     f"{zc['us_per_item'] if zc else '-'} | {pipe['mb_per_sec']} | "
                     f"{ring['mb_per_sec']} | {speed:.2f}x |")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20])
    ap.add_argument("--total-mb", type=int, default=64)
    ap.add_argument("--reader-sweep", metavar="DATASET_URL",
                    help="instead of the transport sweep, the reader end to end on threads "
                         "and on processes over the rings, on this store")
    args = ap.parse_args(argv)
    if args.reader_sweep:
        print(json.dumps(reader_transport_sweep(args.reader_sweep)))
        return 0
    rows = run_sweep(args.sizes, args.total_mb << 20)
    for r in rows:
        print(json.dumps(r))
    print()
    print(to_markdown(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
