"""The throughput CLI and the small benches of petastorm_tpu_torch against
the JAX package's (``benchmark/{throughput,cli,hello_world,dummy_reader,
transport_bench}.py``, ``test_util/reader_mock.py``), on the CPU.

* The hello-world store written by the port decodes to the JAX writer's
  rows, read by either package.
* ``reader_throughput(..., device="cpu")`` fills every ``BenchmarkResult``
  field on both read methods, and the CLI's ``--json`` keys are the JAX
  CLI's.
* RSS from ``/proc/self/status`` agrees with ``resource``'s peak within
  8 MiB plus 5 % in a fresh interpreter that has just touched 256 MiB (the
  module imports no torch until a device is used), and the CPU meter reads
  a busy loop as busy.
* ``loader_throughput_sweep`` and ``run_sweep`` run at small sizes.
"""
import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from petastorm_tpu.benchmark import cli as jax_cli
from petastorm_tpu.benchmark.hello_world import \
    generate_hello_world_dataset as jax_generate_hello_world_dataset
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.test_util.reader_mock import ReaderMock as JaxReaderMock
from petastorm_tpu_torch.benchmark import cli
from petastorm_tpu_torch.benchmark.dummy_reader import (DummyBenchSchema, loader_throughput_sweep,
                                                        make_dummy_reader)
from petastorm_tpu_torch.benchmark.hello_world import (HelloWorldSchema,
                                                       generate_hello_world_dataset)
from petastorm_tpu_torch.benchmark.throughput import (BenchmarkResult, CpuMeter,
                                                      make_synthetic_device_step,
                                                      process_rss_mb, reader_throughput)
from petastorm_tpu_torch.benchmark.transport_bench import run_sweep, to_markdown
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.test_util.reader_mock import ReaderMock

REPO = Path(__file__).resolve().parent.parent
ROWS = 6


@pytest.fixture(scope="module")
def hello_stores(tmp_path_factory):
    path = tmp_path_factory.mktemp("hello")
    port = generate_hello_world_dataset(f"file://{path}/port", rows_count=ROWS,
                                        rows_per_row_group=2)
    ref = jax_generate_hello_world_dataset(f"file://{path}/jax", rows_count=ROWS,
                                           rows_per_row_group=2)
    return port, ref


def _decoded(factory, url, **extra):
    with factory(url, shuffle_row_groups=False, reader_pool_type="dummy", **extra) as r:
        rows = sorted(r, key=lambda row: int(row.id))
    return [(int(row.id), np.asarray(row.image1), np.asarray(row.array_4d)) for row in rows]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_hello_world_store_decodes_to_the_jax_writers_rows(hello_stores, reader):
    factory, extra = ((make_reader, {}) if reader == "port"
                      else (jax_make_reader, {}))
    got = _decoded(factory, hello_stores[0], **extra)
    want = _decoded(jax_make_reader, hello_stores[1])
    assert [r[0] for r in got] == list(range(ROWS))
    for (i, img, arr), (j, want_img, want_arr) in zip(got, want):
        assert i == j
        assert img.shape == (128, 256, 3) and np.array_equal(img, want_img)
        assert arr.shape == (4, 128, 30, 3) and np.array_equal(arr, want_arr)
    assert sorted(HelloWorldSchema.fields) == ["array_4d", "id", "image1"]


FIELDS = {"samples_per_second", "memory_rss_mb", "cpu_percent", "input_stall_percent",
          "device_step_ms_actual"}


@pytest.mark.parametrize("read_method,step_ms", [("python", None), ("torch", None),
                                                 ("torch", 5.0)])
def test_reader_throughput_fills_every_field(hello_stores, read_method, step_ms):
    result = reader_throughput(hello_stores[0], warmup_cycles=16, measure_cycles=64,
                               read_method=read_method, device_step_ms=step_ms, device="cpu")
    assert isinstance(result, BenchmarkResult)
    assert set(result.as_dict()) == FIELDS
    assert result.samples_per_second > 0 and result.memory_rss_mb > 0
    assert result.cpu_percent >= 0
    if step_ms is None:
        assert result.input_stall_percent is None and result.device_step_ms_actual is None
    else:
        assert 0 <= result.input_stall_percent <= 100
        # The CPU step sleeps: its measured length is about the request.
        assert step_ms * 0.9 <= result.device_step_ms_actual <= step_ms * 3
    assert "samples/sec" in str(result)


def test_reader_throughput_refuses_an_unknown_read_method(hello_stores):
    with pytest.raises(ValueError, match="read_method"):
        reader_throughput(hello_stores[0], read_method="jax", device="cpu")


def test_cli_json_keys_equal_the_jax_clis(hello_stores):
    args = ["-m", "4", "-n", "20", "--json"]
    outs = []
    for main, url in ((cli.main, hello_stores[0]), (jax_cli.main, hello_stores[1])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([url, *args]) == 0
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    assert set(outs[0]) == set(outs[1]) == FIELDS
    assert outs[0]["samples_per_second"] > 0


def test_cli_flags_are_the_jax_ones_less_tf_and_coalescing():
    """The name is kept from before the port took ``--rowgroup-coalescing``:
    the flags are now the JAX CLI's, and ``--device``."""
    ours = {a.dest for a in cli.build_parser()._actions}
    theirs = {a.dest for a in jax_cli.build_parser()._actions}
    assert ours == theirs | {"device"}
    read_method = next(a for a in cli.build_parser()._actions if a.dest == "read_method")
    # The JAX CLI's "jax" is the port's "torch"; "tf" is the same in both.
    assert read_method.choices == ["python", "tf", "torch"]


def test_cli_runs_as_a_module_in_a_new_interpreter(hello_stores):
    out = subprocess.run([sys.executable, "-m", "petastorm_tpu_torch.benchmark.cli",
                          hello_stores[0], "-d", "torch", "--device", "cpu", "-m", "16", "-n",
                          "32", "--json", "--spawn-new-process"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert set(json.loads(out.stdout.strip().splitlines()[-1])) == FIELDS


def test_rss_from_proc_agrees_with_resource():
    """In a fresh interpreter that has just touched 256 MiB, the resident set
    is at its peak: ``/proc/self/status``'s VmRSS and ``ru_maxrss`` agree
    within 8 MiB plus 5 %."""
    code = ("import resource, numpy as np\n"
            "from petastorm_tpu_torch.benchmark.throughput import process_rss_mb\n"
            "a = np.ones(256 << 20, np.uint8)\n"
            "rss = process_rss_mb()\n"
            "peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024\n"
            "print(rss, peak)\n")
    # Linux records the high-water mark of the memory image that exec
    # replaces in ru_maxrss, and a child of this process starts from a copy
    # of this process's image: the measuring interpreter is a grandchild,
    # started by a small one.
    hop = f"import subprocess, sys; subprocess.run([sys.executable, '-c', {code!r}], check=True)"
    out = subprocess.run([sys.executable, "-c", hop], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rss, peak = map(float, out.stdout.split())
    assert rss >= 256
    assert abs(rss - peak) <= 8 + 0.05 * peak
    # In this process, the current resident set never exceeds the peak.
    import resource
    assert process_rss_mb() <= resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 + 8


def test_cpu_meter_reads_busy_and_idle():
    """A loop that burns 0.2 s of this process's CPU time reads busier than
    a 0.2 s sleep, however loaded the host (the loop runs on CPU time, not
    on the wall clock)."""
    meter = CpuMeter()
    cpu0 = time.process_time()
    while time.process_time() - cpu0 < 0.2:
        pass
    busy = meter.percent()
    idle = CpuMeter()
    time.sleep(0.2)
    assert busy > 10 and idle.percent() < busy


def test_cpu_synthetic_step_sleeps_for_its_length():
    step = make_synthetic_device_step(20, device="cpu")
    t0 = time.perf_counter()
    step()
    assert 0.019 <= time.perf_counter() - t0 < 0.2


def test_dummy_reader_and_reader_mock_match_jax():
    reader = make_dummy_reader(num_rows=5)
    rows = list(reader)
    assert len(rows) == 5 and reader.last_row_consumed and reader.state_dict() is None
    assert rows[0].value.shape == (128,) and sorted(DummyBenchSchema.fields) == ["id", "value"]
    reader.reset()
    assert len(list(reader)) == 5
    # The default generator draws the JAX mock's values from the same seed.
    got = next(ReaderMock(DummyBenchSchema))
    want = next(JaxReaderMock(DummyBenchSchema))
    assert int(got.id) == int(want.id) and np.array_equal(got.value, want.value)


def test_loader_throughput_sweep_on_the_cpu(capsys):
    rates = loader_throughput_sweep(batch_sizes=(10, 100), rows=500, device="cpu")
    assert set(rates) == {10, 100} and all(r > 0 for r in rates.values())
    assert "batch_size=100" in capsys.readouterr().out


def test_transport_sweep_at_small_sizes():
    rows = run_sweep(sizes=(1 << 10, 16 << 10), total_bytes=256 << 10)
    assert [(r["payload_bytes"], r["transport"]) for r in rows] == [
        (size, t) for size in (1 << 10, 16 << 10)
        for t in ("pipe", "shm_ring", "shm_ring_zero_copy")]
    assert all(r["items"] == max(200, (256 << 10) // r["payload_bytes"])
               and r["items_per_sec"] > 0 for r in rows)
    table = to_markdown(rows)
    assert "| 1 KB |" in table and "| 16 KB |" in table


def test_reader_transport_sweep_runs_both_arms(hello_stores):
    """Threads and processes over the rings, each in a fresh interpreter;
    the JAX sweep's zmq arm has no counterpart."""
    from petastorm_tpu_torch.benchmark.transport_bench import reader_transport_sweep
    out = reader_transport_sweep(hello_stores[0], workers=1, warmup=4, measure=20, reruns=1)
    assert set(out) == {"thread_x1", "process_x1_shm"}
    assert all(len(v) == 1 and v[0] > 0 for v in out.values())
