"""The port's row-group planning sources against the JAX package's: the
stored map (this package's key and petastorm's), a multi-URL view's parent
index, the summary ``_metadata`` split and the footer scan. Each case plans
the same store through both packages' ``load_row_groups`` behind a
filesystem that counts data-file opens: the plans and the counts are
equal, and 0 where the JAX package reads no footer."""
import glob
import json
import os
import shutil

import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu.etl import dataset_metadata as jmd
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.errors import MetadataGenerationError
from petastorm_tpu_torch.etl import dataset_metadata as tmd
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from torch_legacy_store import DataFileOpenCounter, reference_unischema_pickle

SCHEMA = Unischema("WriteSchema", [
    UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False),
])


def _write(root, n, rows_per_row_group=10, rows_per_file=20):
    rng = np.random.default_rng(0)
    with materialize_dataset_local(f"file://{root}", SCHEMA,
                                   rows_per_row_group=rows_per_row_group,
                                   rows_per_file=rows_per_file) as w:
        for i in range(n):
            w.write_row({"id": i, "vec": rng.normal(size=4).astype(np.float32)})
    return root


def _plans(url_or_urls):
    """``{package: (plan, data-file opens)}`` of both packages."""
    out = {}
    for pkg, md in (("jax", jmd), ("port", tmd)):
        ctx = md.DatasetContext(url_or_urls)
        ctx.filesystem = DataFileOpenCounter(ctx.filesystem)
        refs = md.load_row_groups(ctx)
        out[pkg] = ([(r.path, r.row_group, r.partition_values) for r in refs],
                    ctx.filesystem.data_file_opens)
    return out


def _summary_only(tmp_path, n=60):
    root = _write(f"{tmp_path}/ds", n)
    tmd.write_summary_metadata(f"file://{root}")
    os.remove(f"{root}/_common_metadata")
    return root


def test_summary_split_plans_with_no_footer_read(tmp_path):
    root = _summary_only(tmp_path)
    plans = _plans(f"file://{root}")
    assert plans["port"] == plans["jax"]
    plan, opens = plans["port"]
    assert len(plan) == 6 and opens == 0
    with pq.ParquetFile(plan[0][0]) as f:
        assert f.read_row_group(plan[0][1]).num_rows == 10


def test_stale_summary_falls_back_to_the_footers(tmp_path):
    root = _summary_only(tmp_path, n=40)
    shutil.copy(sorted(glob.glob(f"{root}/*.parquet"))[0], f"{root}/zzz-appended.parquet")
    plans = _plans(f"file://{root}")
    assert plans["port"] == plans["jax"]
    plan, opens = plans["port"]
    assert len(plan) == 6 and opens == 3   # 4 + 2 appended groups, every footer read


def test_corrupt_summary_falls_back_to_the_footers(tmp_path):
    root = _write(f"{tmp_path}/ds", 20)
    os.remove(f"{root}/_common_metadata")
    with open(f"{root}/_metadata", "wb") as f:
        f.write(b"PAR1 this is not a parquet footer")
    plans = _plans(f"file://{root}")
    assert plans["port"] == plans["jax"]
    assert len(plans["port"][0]) == 2 and plans["port"][1] == 1


@pytest.mark.parametrize("count", [2, 3])
def test_multi_url_view_plans_from_the_parent_index(tmp_path, count):
    root = _write(f"{tmp_path}/ds", 60)
    files = sorted(glob.glob(f"{root}/*.parquet"))
    plans = _plans([f"file://{f}" for f in files[:count]])
    assert plans["port"] == plans["jax"]
    plan, opens = plans["port"]
    assert len(plan) == 2 * count and opens == 0
    assert {p for p, _, _ in plan} == set(files[:count])


def test_multi_url_view_over_two_directories_reads_the_footers(tmp_path):
    a = sorted(glob.glob(f"{_write(f'{tmp_path}/a', 40)}/*.parquet"))
    b = sorted(glob.glob(f"{_write(f'{tmp_path}/b', 40)}/*.parquet"))
    plans = _plans([f"file://{a[0]}", f"file://{b[1]}"])
    assert plans["port"] == plans["jax"]
    assert len(plans["port"][0]) == 4 and plans["port"][1] == 2


def test_petastorm_row_group_map_plans_with_no_footer_read(tmp_path):
    """A store whose ``_common_metadata`` holds only petastorm's keys (its
    pickled schema and its row-group map)."""
    src = sorted(glob.glob(f"{_write(f'{tmp_path}/src', 60)}/*.parquet"))
    from torch_legacy_store import link_reference_store
    pickled = reference_unischema_pickle("WriteSchema", [
        ("id", np.int64, (), ("scalar", "LongType"), False),
        ("vec", np.float32, (4,), ("ndarray",), False)])
    link_reference_store(src, f"{tmp_path}/ref", pickled)
    plans = _plans(f"file://{tmp_path}/ref")
    assert plans["port"] == plans["jax"]
    assert len(plans["port"][0]) == 6 and plans["port"][1] == 0
    assert tmd.get_schema(tmd.DatasetContext(f"file://{tmp_path}/ref")) == SCHEMA


def test_a_stale_stored_map_warns_and_reads_the_footers(tmp_path, caplog):
    root = _write(f"{tmp_path}/ds", 40)
    shutil.copy(sorted(glob.glob(f"{root}/*.parquet"))[0], f"{root}/zzz-appended.parquet")
    plans = _plans(f"file://{root}")
    assert plans["port"] == plans["jax"]
    assert len(plans["port"][0]) == 6 and plans["port"][1] == 3
    assert any("stale" in r.message for r in caplog.records
               if r.name == "petastorm_tpu_torch.etl.dataset_metadata")


def test_summary_row_counts_equal_jax(tmp_path):
    root = _summary_only(tmp_path)
    got = tmd.summary_row_group_row_counts(tmd.DatasetContext(f"file://{root}"))
    assert got == jmd.summary_row_group_row_counts(jmd.DatasetContext(f"file://{root}"))
    assert sorted(len(v) for v in got.values()) == [2, 2, 2]
    files = [f"file://{f}" for f in sorted(glob.glob(f"{root}/*.parquet"))]
    assert tmd.summary_row_group_row_counts(tmd.DatasetContext(files)) is None


def test_summary_write_rescues_legacy_kv_from_metadata(tmp_path):
    """A store whose petastorm keys live only in ``_metadata``: summarizing
    moves them into ``_common_metadata`` first, in both packages."""
    root = _write(f"{tmp_path}/ds", 20)
    os.remove(f"{root}/_common_metadata")
    pickled = reference_unischema_pickle("WriteSchema", [
        ("id", np.int64, (), ("scalar", "LongType"), False),
        ("vec", np.float32, (4,), ("ndarray",), False)])
    files = sorted(glob.glob(f"{root}/*.parquet"))
    kv = {tmd.LEGACY_UNISCHEMA_KEY: pickled,
          tmd.LEGACY_ROW_GROUPS_PER_FILE_KEY: json.dumps(
              {os.path.basename(f): 2 for f in files}).encode()}
    pq.write_metadata(pq.read_schema(files[0]).with_metadata(kv), f"{root}/_metadata")
    jax_root = f"{tmp_path}/jax"
    shutil.copytree(root, jax_root)
    assert tmd.get_schema(tmd.DatasetContext(f"file://{root}")) == SCHEMA
    tmd.write_summary_metadata(f"file://{root}")
    jmd.write_summary_metadata(f"file://{jax_root}")
    for r in (root, jax_root):
        assert pq.read_metadata(f"{r}/_metadata").num_row_groups == 2
        common = pq.read_schema(f"{r}/_common_metadata").metadata
        assert common[tmd.LEGACY_UNISCHEMA_KEY] == pickled
        assert tmd.LEGACY_ROW_GROUPS_PER_FILE_KEY in common
    assert tmd.get_schema(tmd.DatasetContext(f"file://{root}")) == SCHEMA
    assert [(r.path[len(root):], r.row_group) for r in
            tmd.load_row_groups(tmd.DatasetContext(f"file://{root}"))] == \
        [(r.path[len(jax_root):], r.row_group) for r in
         jmd.load_row_groups(jmd.DatasetContext(f"file://{jax_root}"))]


def test_metadata_of_a_multi_url_view_is_refused(tmp_path):
    root = _write(f"{tmp_path}/ds", 40)
    urls = [f"file://{f}" for f in sorted(glob.glob(f"{root}/*.parquet"))]
    ctx = tmd.DatasetContext(urls)
    assert ctx.is_multi_path and ctx.root_path == urls[0][len("file://"):]
    with pytest.raises(MetadataGenerationError, match="multi-URL"):
        tmd.write_dataset_metadata(ctx, SCHEMA)
    with pytest.raises(MetadataGenerationError, match="multi-URL"):
        tmd.write_summary_metadata(ctx)
    assert ctx.key_value_metadata() == {}


def test_schema_from_a_url_list_is_the_stored_one_through_the_parent(tmp_path):
    """A multi-URL view reads no sidecar: its schema is inferred, as in the
    JAX package, and its rows are planned from the parent index."""
    root = _write(f"{tmp_path}/ds", 40)
    urls = [f"file://{f}" for f in sorted(glob.glob(f"{root}/*.parquet"))]
    got = tmd.infer_or_load_unischema(tmd.DatasetContext(urls))
    want = jmd.infer_or_load_unischema(jmd.DatasetContext(urls))
    assert sorted(got.fields) == sorted(want.fields) == ["id", "vec"]
    assert tmd.get_schema_from_dataset_url(f"file://{root}") == SCHEMA


@pytest.mark.parametrize("stale", [False, True])
def test_aligned_steps_count_rows_from_the_summary(tmp_path, stale):
    """``aligned_steps_per_epoch`` reads the rows of a summary that covers
    the plan with no footer, and the footers behind a stale one; its count
    is the JAX package's."""
    import fsspec
    from petastorm_tpu.jax.loader import aligned_steps_per_epoch as jax_aligned
    from petastorm_tpu_torch.loader import aligned_steps_per_epoch
    root = _summary_only(tmp_path)
    if stale:
        shutil.copy(sorted(glob.glob(f"{root}/*.parquet"))[0], f"{root}/zzz-appended.parquet")
    fs = DataFileOpenCounter(fsspec.filesystem("file"))
    got = aligned_steps_per_epoch(f"file://{root}", 7, shard_count=2, filesystem=fs)
    assert got == jax_aligned(f"file://{root}", 7, shard_count=2) == (5 if stale else 4)
    assert fs.data_file_opens == (8 if stale else 0)
