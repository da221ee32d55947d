"""Import boundary of petastorm_tpu_torch: it, chip_smoke.py and the
port's examples (``examples/torch_*``) import neither ``jax`` nor the JAX
package ``petastorm_tpu`` (not even its modules that do not import JAX), nor
``zmq``, ``dill`` or ``psutil``; every module imports on a host without
``nvcc`` or a GPU, and the Spark and TensorFlow adapters without ``pyspark``
and ``tensorflow``; and the modules a spawned reader worker runs import
without ``torch``."""
import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "petastorm_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
#: The rank functions spawned ranks import by name (no JAX either), and the
#: writer of petastorm-format stores that chip_smoke.py imports.
RANK_MODULES = sorted((REPO / "tests").glob("torch_*_ranks.py")) + [
    REPO / "tests" / "torch_legacy_store.py"]
#: The port's examples (run as scripts; importing one does no work).
EXAMPLES = sorted((REPO / "examples").glob("torch_*/main.py"))

#: The ops plane: timeline, anomaly bank, SLO watch, black box, accounting,
#: federation, the fabric (the standard library's sockets, no zmq) and the CLI.
OPS_PLANE_MODULES = ("petastorm_tpu_torch.telemetry.timeseries",
                     "petastorm_tpu_torch.telemetry.anomaly", "petastorm_tpu_torch.telemetry.slo",
                     "petastorm_tpu_torch.telemetry.postmortem",
                     "petastorm_tpu_torch.telemetry.accounting",
                     "petastorm_tpu_torch.telemetry.federation",
                     "petastorm_tpu_torch.telemetry.fabric",
                     "petastorm_tpu_torch.telemetry.__main__")

_BLOCKER = r'''
import importlib.abc, os, sys

ALSO = tuple(filter(None, os.environ.get("BLOCK_ALSO", "").split(",")))

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") + ALSO or name == "petastorm_tpu" \
                or name.startswith("petastorm_tpu."):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib") + ALSO or m == "petastorm_tpu"
                or m.startswith("petastorm_tpu."))
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
'''


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_blocker_does_not_block_the_port_by_prefix():
    # A bare prefix match on "petastorm_tpu" would also block
    # "petastorm_tpu_torch"; the subprocess below would then fail loudly,
    # but check the rule itself too.
    assert not ("petastorm_tpu_torch" == "petastorm_tpu"
                or "petastorm_tpu_torch".startswith("petastorm_tpu."))


def test_every_module_imports_without_jax_or_the_jax_package():
    modules = [_module_name(p) for p in SOURCES + EXAMPLES]
    assert {"petastorm_tpu_torch.ops.image_ops", "petastorm_tpu_torch.ops.flash_attn",
            "petastorm_tpu_torch.ngram", "petastorm_tpu_torch.models.llama",
            "petastorm_tpu_torch.parallel.attention",
            "petastorm_tpu_torch.benchmark.llm_bench",
            "petastorm_tpu_torch.benchmark.imagenet_bench", "petastorm_tpu_torch.models.resnet",
            "petastorm_tpu_torch.benchmark.throughput", "petastorm_tpu_torch.entry",
            "petastorm_tpu_torch.loader.dtypes", "petastorm_tpu_torch.parallel.comm",
            "petastorm_tpu_torch.parallel.mesh", "petastorm_tpu_torch.parallel.launch",
            "petastorm_tpu_torch.parallel.moe",
            "petastorm_tpu_torch.parallel.ring_attention",
            "petastorm_tpu_torch.parallel.ulysses_attention",
            "petastorm_tpu_torch.benchmark.seq_parallel_bench", "chip_smoke",
            "petastorm_tpu_torch.native", "petastorm_tpu_torch.native.imgcodec",
            "petastorm_tpu_torch.reader_impl.shm_ring",
            "petastorm_tpu_torch.reader_impl.pickle_serializer",
            "petastorm_tpu_torch.workers_pool.process_pool",
            "petastorm_tpu_torch.workers_pool.exec_in_new_process",
            "petastorm_tpu_torch.workers_pool.exec_in_new_process_entrypoint",
            "petastorm_tpu_torch.utils.decode",
            "petastorm_tpu_torch.test_util.stub_workers",
            "petastorm_tpu_torch.reader_impl.batch_reader_worker",
            "petastorm_tpu_torch.reader_impl.arrow_table_serializer",
            "petastorm_tpu_torch.loader.batched_buffer", "petastorm_tpu_torch.loader.loader",
            "petastorm_tpu_torch.benchmark.scalar_bench", "petastorm_tpu_torch.metrics",
            "petastorm_tpu_torch.ops.augment", "petastorm_tpu_torch.loader.checkpoint",
            "petastorm_tpu_torch.loader.device_cache", "petastorm_tpu_torch.transform",
            "petastorm_tpu_torch.predicates", "petastorm_tpu_torch.selectors",
            "petastorm_tpu_torch.etl.rowgroup_indexers",
            "petastorm_tpu_torch.etl.rowgroup_indexing",
            "petastorm_tpu_torch.test_util.transforms",
            "petastorm_tpu_torch.loader.mesh_loader",
            "petastorm_tpu_torch.parallel.pipeline", "petastorm_tpu_torch.models.vit",
            "petastorm_tpu_torch.models.mlp", "petastorm_tpu_torch.spark",
            "petastorm_tpu_torch.spark.spark_dataset_converter",
            "petastorm_tpu_torch.spark.spark_utils", "petastorm_tpu_torch.pytorch",
            "petastorm_tpu_torch.tf_utils", "petastorm_tpu_torch.tools",
            "petastorm_tpu_torch.tools.copy_dataset",
            "petastorm_tpu_torch.tools.spark_session_cli",
            "petastorm_tpu_torch.etl.generate_metadata",
            "petastorm_tpu_torch.etl.metadata_util", "examples.torch_hello_world.main",
            "examples.torch_mnist.main", "examples.torch_spark_to_vit.main",
            "petastorm_tpu_torch.telemetry", "petastorm_tpu_torch.telemetry.histogram",
            "petastorm_tpu_torch.telemetry.registry", "petastorm_tpu_torch.telemetry.recorder",
            "petastorm_tpu_torch.telemetry.stall", "petastorm_tpu_torch.telemetry.trace",
            "petastorm_tpu_torch.telemetry.exporters", "examples.torch_imagenet.main",
            "examples.torch_llm_tokens.main", "examples.torch_long_context.main",
            "petastorm_tpu_torch.cache", "petastorm_tpu_torch.autotune",
            "petastorm_tpu_torch.autotune.budget", "petastorm_tpu_torch.autotune.actuators",
            "petastorm_tpu_torch.autotune.placement", "petastorm_tpu_torch.autotune.controller",
            "petastorm_tpu_torch.autotune.mem_cache",
            "petastorm_tpu_torch.reader_impl.readahead", "petastorm_tpu_torch.plan",
            "petastorm_tpu_torch.plan.plan", "petastorm_tpu_torch.plan.validate",
            "petastorm_tpu_torch.plan.lowering", "petastorm_tpu_torch.plan.fusion",
            "petastorm_tpu_torch.plan.cache", "petastorm_tpu_torch.plan.optimizer",
            "petastorm_tpu_torch.explain", "petastorm_tpu_torch.explain.spec",
            *OPS_PLANE_MODULES, *INDEX_MODULES, *LIVE_DATA_MODULES,
            *REFERENCE_STORE_MODULES} <= set(modules)
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *modules], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout


def test_rank_modules_import_without_jax_or_the_jax_package():
    names = [p.stem for p in RANK_MODULES]
    assert {"torch_seq_ranks", "torch_mesh_ranks", "torch_tp_ranks",
            "torch_fsdp_ranks", "torch_legacy_store"} <= set(names)
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *names], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO),
                               "PYTHONPATH": f"{REPO}:{REPO / 'tests'}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(names)}" in proc.stdout


def test_spark_and_tf_adapters_import_without_pyspark_or_tensorflow():
    """pyspark and tensorflow are imported inside the functions that need
    them, so the package, the converter, the tools and the adapters import
    where neither is installed."""
    modules = ["petastorm_tpu_torch", "petastorm_tpu_torch.spark",
               "petastorm_tpu_torch.spark.spark_dataset_converter",
               "petastorm_tpu_torch.spark.spark_utils", "petastorm_tpu_torch.tf_utils",
               "petastorm_tpu_torch.pytorch", "petastorm_tpu_torch.tools.copy_dataset",
               "petastorm_tpu_torch.tools.spark_session_cli",
               "petastorm_tpu_torch.etl.dataset_metadata", "petastorm_tpu_torch.unischema",
               "petastorm_tpu_torch.benchmark.cli", "examples.torch_spark_to_vit.main"]
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *modules], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO),
                               "BLOCK_ALSO": "pyspark,tensorflow"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout


@pytest.mark.parametrize("path", SOURCES + RANK_MODULES + EXAMPLES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path.name} imports {name}"
        assert name != "petastorm_tpu" and not name.startswith("petastorm_tpu."), \
            f"{path.name} imports {name}"
        # The process pool's control plane is the standard library's.
        assert top not in ("zmq", "dill", "psutil"), f"{path.name} imports {name}"


#: What a spawned reader worker imports: the pool, the workers, the pickled
#: arguments' modules (schema, NGram, predicates, transforms, serializers)
#: and the decoders.
WORKER_MODULES = ("petastorm_tpu_torch.workers_pool.process_pool",
                  "petastorm_tpu_torch.workers_pool.exec_in_new_process_entrypoint",
                  "petastorm_tpu_torch.reader_impl.row_reader_worker",
                  "petastorm_tpu_torch.reader_impl.shm_ring",
                  "petastorm_tpu_torch.native.imgcodec", "petastorm_tpu_torch.utils.decode",
                  "petastorm_tpu_torch.ngram", "petastorm_tpu_torch.etl.dataset_metadata",
                  "petastorm_tpu_torch.test_util.stub_workers",
                  "petastorm_tpu_torch.reader_impl.batch_reader_worker",
                  "petastorm_tpu_torch.reader_impl.arrow_table_serializer",
                  "petastorm_tpu_torch.reader_impl.pickle_serializer",
                  "petastorm_tpu_torch.unischema", "petastorm_tpu_torch.transform",
                  "petastorm_tpu_torch.predicates", "petastorm_tpu_torch.selectors",
                  "petastorm_tpu_torch.etl.rowgroup_indexers",
                  "petastorm_tpu_torch.test_util.transforms",
                  "petastorm_tpu_torch.reader_impl.epoch_plan",
                  "petastorm_tpu_torch.reader_impl.batch_plane",
                  "petastorm_tpu_torch.workers_pool.thread_pool",
                  "petastorm_tpu_torch.workers_pool.dummy_pool",
                  "petastorm_tpu_torch.resilience", "petastorm_tpu_torch.resilience.policy",
                  "petastorm_tpu_torch.resilience.faults",
                  "petastorm_tpu_torch.resilience.quarantine",
                  "petastorm_tpu_torch.resilience.recovery",
                  "petastorm_tpu_torch.resilience.deadline",
                  "petastorm_tpu_torch.resilience.hedging",
                  "petastorm_tpu_torch.resilience.watchdog",
                  # A spawned worker unpickles the reader's memory cache.
                  "petastorm_tpu_torch.cache", "petastorm_tpu_torch.autotune",
                  "petastorm_tpu_torch.autotune.mem_cache",
                  "petastorm_tpu_torch.autotune.budget",
                  "petastorm_tpu_torch.reader_impl.readahead",
                  # ... or reopens its disk cache.
                  "petastorm_tpu_torch.local_disk_cache",
                  # The live data's plan pieces and the discovery plane.
                  "petastorm_tpu_torch.utils.growth",
                  "petastorm_tpu_torch.workers_pool.ventilator",
                  "petastorm_tpu_torch.discovery", "petastorm_tpu_torch.discovery.listing",
                  "petastorm_tpu_torch.discovery.snapshot",
                  "petastorm_tpu_torch.discovery.admission",
                  "petastorm_tpu_torch.discovery.watcher",
                  # A spawned worker unpickles a depickled petastorm schema
                  # and opens hdfs:// stores.
                  "petastorm_tpu_torch.etl.legacy", "petastorm_tpu_torch.hdfs",
                  "petastorm_tpu_torch.hdfs.namenode")

#: Stores written by petastorm and the rest of the reader's surface: the
#: restricted unpickler, the HDFS HA resolver and the Arrow helpers import
#: without torch.
REFERENCE_STORE_MODULES = ("petastorm_tpu_torch.etl.legacy", "petastorm_tpu_torch.hdfs",
                           "petastorm_tpu_torch.hdfs.namenode",
                           "petastorm_tpu_torch.pyarrow_helpers",
                           "petastorm_tpu_torch.pyarrow_helpers.batching_table_queue",
                           "petastorm_tpu_torch.test_util.shuffling_analysis")

#: Live appending datasets: the growth schedule, the ventilator, the epoch
#: plan and the discovery plane import without torch.
LIVE_DATA_MODULES = ("petastorm_tpu_torch.utils.growth",
                     "petastorm_tpu_torch.workers_pool.ventilator",
                     "petastorm_tpu_torch.reader_impl.epoch_plan", "petastorm_tpu_torch.discovery",
                     "petastorm_tpu_torch.discovery.listing",
                     "petastorm_tpu_torch.discovery.snapshot",
                     "petastorm_tpu_torch.discovery.admission",
                     "petastorm_tpu_torch.discovery.watcher")

#: The disk cache and the random-access plane (its gather imports torch
#: only where it stages tensors).
INDEX_MODULES = ("petastorm_tpu_torch.local_disk_cache", "petastorm_tpu_torch.index",
                 "petastorm_tpu_torch.index.sidecar", "petastorm_tpu_torch.index.build",
                 "petastorm_tpu_torch.index.lookup", "petastorm_tpu_torch.index.view",
                 "petastorm_tpu_torch.index.gather")

#: The telemetry core: workers record spans and ship them to the parent, so
#: it imports without torch (and without the JAX package's telemetry), and so
#: does the ops plane and its CLI.
TELEMETRY_MODULES = ("petastorm_tpu_torch.telemetry", "petastorm_tpu_torch.telemetry.histogram",
                     "petastorm_tpu_torch.telemetry.registry",
                     "petastorm_tpu_torch.telemetry.recorder",
                     "petastorm_tpu_torch.telemetry.stall", "petastorm_tpu_torch.telemetry.trace",
                     "petastorm_tpu_torch.telemetry.exporters", *OPS_PLANE_MODULES)


def test_worker_modules_import_without_torch():
    """The package's ``__init__`` exports lazily: importing a worker's
    modules must not import torch (each spawned worker would pay for it)."""
    code = ("import importlib, sys\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n"
            "import petastorm_tpu_torch\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code, *WORKER_MODULES], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]


def test_live_data_modules_import_with_torch_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *LIVE_DATA_MODULES], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO),
                               "BLOCK_ALSO": "torch"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(LIVE_DATA_MODULES)}" in proc.stdout


def test_reference_store_modules_import_with_torch_blocked():
    modules = [*REFERENCE_STORE_MODULES, "torch_legacy_store"]
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *modules], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO),
                               "PYTHONPATH": f"{REPO}:{REPO / 'tests'}",
                               "BLOCK_ALSO": "torch"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout


def test_index_plane_imports_with_torch_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *INDEX_MODULES], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO),
                               "BLOCK_ALSO": "torch"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(INDEX_MODULES)}" in proc.stdout


def test_telemetry_imports_with_torch_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *TELEMETRY_MODULES], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO),
                               "BLOCK_ALSO": "torch"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(TELEMETRY_MODULES)}" in proc.stdout


def test_package_exports_load_on_first_use():
    import petastorm_tpu_torch
    for name in petastorm_tpu_torch.__all__:
        assert getattr(petastorm_tpu_torch, name) is not None
    assert set(petastorm_tpu_torch.__all__) <= set(dir(petastorm_tpu_torch))
    with pytest.raises(AttributeError):
        petastorm_tpu_torch.not_an_export
