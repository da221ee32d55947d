"""The kernel build's library naming, on the CPU: a library is named by a
hash of its source, of every header under ``csrc/`` and of the flags, so
an edit to any of them builds anew instead of loading a stale library."""
from petastorm_tpu_torch.kernels import build


def _csrc(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// k')
    (tmp_path / "common.cuh").write_text("// helpers, first version")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    return tmp_path


def test_editing_a_header_renames_the_library(monkeypatch, tmp_path):
    csrc = _csrc(monkeypatch, tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first   # stable while nothing changes
    (csrc / "common.cuh").write_text("// helpers, second version")
    assert build.library_path("k") != first


def test_adding_or_renaming_a_header_renames_the_library(monkeypatch, tmp_path):
    csrc = _csrc(monkeypatch, tmp_path)
    first = build.library_path("k")
    (csrc / "more.cuh").write_text("// more helpers")
    second = build.library_path("k")
    (csrc / "more.cuh").rename(csrc / "other.cuh")
    third = build.library_path("k")
    assert len({first, second, third}) == 3


def test_other_files_and_other_sources_do_not_rename_it(monkeypatch, tmp_path):
    csrc = _csrc(monkeypatch, tmp_path)
    first = build.library_path("k")
    (csrc / "notes.txt").write_text("not a header")
    (csrc / "j.cu").write_text("// another kernel's source")
    assert build.library_path("k") == first


def test_changing_a_flag_renames_the_library(monkeypatch, tmp_path):
    _csrc(monkeypatch, tmp_path)
    first = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lcuda",))
    assert build.library_path("k") != first
