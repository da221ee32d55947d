"""Row-group indexes across the two packages: an index built by the JAX
package is read by the port (in a subprocess where ``petastorm_tpu`` cannot
be imported, so its restricted unpickler must not import it), and an index
built by the port is read by the JAX package, which selects the same row
groups. The port's unpickler refuses any other class."""
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest

from petastorm_tpu.etl import rowgroup_indexers as jx
from petastorm_tpu.etl import rowgroup_indexing as ji
from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxContext
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.selectors import SingleIndexSelector as JaxSelector
from petastorm_tpu_torch.etl import rowgroup_indexing as ti
from petastorm_tpu_torch.etl.rowgroup_indexers import FieldNotNullIndexer, SingleFieldIndexer
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.selectors import (IntersectIndexSelector, SingleIndexSelector,
                                           UnionIndexSelector)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _write(url, seed=0):
    schema = Unischema("Ix", [UnischemaField("id", np.int64, ()),
                              UnischemaField("label", np.int64, ()),
                              UnischemaField("tag", np.str_, (), nullable=True)])
    rng = np.random.default_rng(seed)
    with materialize_dataset_local(url, schema, rows_per_row_group=6) as w:
        for i in range(60):
            w.write_row({"id": i, "label": int(rng.integers(0, 12)),
                         "tag": None if i < 30 or i % 4 else f"t{i % 3}"})


@pytest.fixture
def store(tmp_path):
    url = f"file://{tmp_path}/ds"
    _write(url)
    return url


def _groups(indexer):
    return getattr(indexer, "_index", None) or getattr(indexer, "_row_groups")


def _jax_build(url):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ji.build_rowgroup_index(url, [jx.SingleFieldIndexer("label_ix", "label"),
                                             jx.FieldNotNullIndexer("tag_ix", "tag")],
                                       emit_field_index=False)


_BLOCKED_READ = r'''
import importlib.abc, sys

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "petastorm_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
indexes = get_row_group_indexes(sys.argv[1])
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "petastorm_tpu")]
print(repr({name: sorted((k, sorted(v)) for k, v in ix._index.items())
            if hasattr(ix, "_index") else sorted(ix._row_groups)
            for name, ix in sorted(indexes.items())}))
'''


def test_an_index_built_by_the_jax_package_loads_in_a_process_without_it(store):
    built = _jax_build(store)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_READ, store], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "", "HOME": str(REPO), "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = {"label_ix": sorted((k, sorted(v)) for k, v in built["label_ix"]._index.items()),
            "tag_ix": sorted(built["tag_ix"]._row_groups)}
    assert eval(proc.stdout) == want


def test_the_port_selects_the_jax_index_groups(store):
    _jax_build(store)
    indexes = ti.get_row_group_indexes(store)
    assert isinstance(indexes["label_ix"], SingleFieldIndexer)
    assert isinstance(indexes["tag_ix"], FieldNotNullIndexer)
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False)
    with make_reader(store, rowgroup_selector=SingleIndexSelector("label_ix", [2, 5]),
                     **kwargs) as reader:
        port_ids = [int(r.id) for r in reader]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_make_reader(store, rowgroup_selector=JaxSelector("label_ix", [2, 5]),
                             **kwargs) as reader:
            jax_ids = [int(r.id) for r in reader]
    assert port_ids == jax_ids and port_ids


def test_an_index_built_by_the_port_is_read_by_the_jax_package(store):
    built = ti.build_rowgroup_index(store, [SingleFieldIndexer("label_ix", "label"),
                                            FieldNotNullIndexer("tag_ix", "tag")])
    loaded = ji.get_row_group_indexes(JaxContext(store))
    assert isinstance(loaded["label_ix"], jx.SingleFieldIndexer)
    assert isinstance(loaded["tag_ix"], jx.FieldNotNullIndexer)
    assert loaded["label_ix"]._index == built["label_ix"]._index
    assert loaded["tag_ix"]._row_groups == built["tag_ix"]._row_groups
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_make_reader(store, rowgroup_selector=JaxSelector("label_ix", [7]),
                             **kwargs) as reader:
            jax_ids = [int(r.id) for r in reader]
    with make_reader(store, rowgroup_selector=SingleIndexSelector("label_ix", [7]),
                     **kwargs) as reader:
        port_ids = [int(r.id) for r in reader]
    assert jax_ids == port_ids and port_ids


def test_both_packages_build_the_same_index(store, tmp_path):
    other = f"file://{tmp_path}/other"
    _write(other)
    port = ti.build_rowgroup_index(store, [SingleFieldIndexer("label_ix", "label"),
                                           FieldNotNullIndexer("tag_ix", "tag")])
    jax = _jax_build(other)
    assert {k: _groups(v) for k, v in port.items()} == {k: _groups(v) for k, v in jax.items()}


def test_selectors_compose(store):
    indexes = ti.build_rowgroup_index(store, [SingleFieldIndexer("label_ix", "label"),
                                              FieldNotNullIndexer("tag_ix", "tag")])
    a, b = SingleIndexSelector("label_ix", [1, 3]), SingleIndexSelector("tag_ix", [None])
    both = IntersectIndexSelector([a, b]).select_row_groups(indexes)
    either = UnionIndexSelector([a, b]).select_row_groups(indexes)
    assert both == a.select_row_groups(indexes) & b.select_row_groups(indexes)
    assert either == a.select_row_groups(indexes) | b.select_row_groups(indexes)
    assert IntersectIndexSelector([a, b]).get_index_names() == ["label_ix", "tag_ix"]
    assert b.select_row_groups(indexes) == set(range(5, 10))


def test_the_unpickler_refuses_other_classes():
    class Evil:
        def __reduce__(self):
            return (print, ("not run",))

    with pytest.raises(pickle.UnpicklingError):
        ti.loads_index(pickle.dumps({"x": Evil()}))
    with pytest.raises(pickle.UnpicklingError):
        ti.loads_index(pickle.dumps({"x": SingleFieldIndexer("x", "y")}).replace(
            b"petastorm_tpu_torch.etl.rowgroup_indexers", b"petastorm_tpu_torch.etl.writer_____"))


def test_petastorm_names_and_attributes_load(store):
    """A pickle of petastorm's own indexer (its module name, ``_column_name``
    and ``_index_data``) loads as the port's class."""
    ix = SingleFieldIndexer("label_ix", "label")
    ix.__dict__ = {"_index_name": "label_ix", "_column_name": "label",
                   "_index_data": {3: {0, 2}}}
    data = ti.dumps_index({"label_ix": ix}).replace(b"petastorm_tpu.etl.", b"petastorm.etl.")
    loaded = ti.loads_index(data)["label_ix"]
    assert loaded.get_row_group_indexes(3) == {0, 2} and loaded.column_names == ["label"]
