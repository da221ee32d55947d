"""Import boundary of petastorm_tpu_torch: it and chip_smoke.py import
neither ``jax`` nor the JAX package ``petastorm_tpu`` (not even its modules
that do not import JAX), and every module imports on a host without
``nvcc`` or a GPU."""
import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "petastorm_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

_BLOCKER = r'''
import importlib.abc, sys

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") or name == "petastorm_tpu" \
                or name.startswith("petastorm_tpu."):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib") or m == "petastorm_tpu"
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
    modules = [_module_name(p) for p in SOURCES]
    assert {"petastorm_tpu_torch.ops.image_ops", "petastorm_tpu_torch.ops.flash_attn",
            "petastorm_tpu_torch.ngram", "petastorm_tpu_torch.models.llama",
            "petastorm_tpu_torch.parallel.attention",
            "petastorm_tpu_torch.benchmark.llm_bench",
            "petastorm_tpu_torch.benchmark.imagenet_bench", "chip_smoke"} <= set(modules)
    proc = subprocess.run([sys.executable, "-c", _BLOCKER, *modules], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(modules)}" in proc.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path.name} imports {name}"
        assert name != "petastorm_tpu" and not name.startswith("petastorm_tpu."), \
            f"{path.name} imports {name}"
