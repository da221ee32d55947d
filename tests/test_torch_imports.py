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
#: The rank functions spawned ranks import by name (no JAX either).
RANK_MODULES = sorted((REPO / "tests").glob("torch_*_ranks.py"))
#: The port's examples (run as scripts; importing one does no work).
EXAMPLES = sorted((REPO / "examples").glob("torch_*/main.py"))

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
            "examples.torch_llm_tokens.main", "examples.torch_long_context.main"} <= set(modules)
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *modules], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout


def test_rank_modules_import_without_jax_or_the_jax_package():
    names = [p.stem for p in RANK_MODULES]
    assert {"torch_seq_ranks", "torch_mesh_ranks", "torch_tp_ranks",
            "torch_fsdp_ranks"} <= set(names)
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
                  "petastorm_tpu_torch.workers_pool.dummy_pool")

#: The telemetry core: workers record spans and ship them to the parent, so
#: it imports without torch (and without the JAX package's telemetry).
TELEMETRY_MODULES = ("petastorm_tpu_torch.telemetry", "petastorm_tpu_torch.telemetry.histogram",
                     "petastorm_tpu_torch.telemetry.registry",
                     "petastorm_tpu_torch.telemetry.recorder",
                     "petastorm_tpu_torch.telemetry.stall", "petastorm_tpu_torch.telemetry.trace",
                     "petastorm_tpu_torch.telemetry.exporters")


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
