"""petastorm_tpu_torch.loader.checkpoint.CheckpointManager against the JAX
package's ``jax/checkpoint.py``: the same input-state sidecar at the same
relative path with the same content, the retention, ``latest_step``, no
reader -> ``None``, the rank-count checks, remote URLs through fsspec and
torn saves; and a training state (a model's and an SGD optimizer's
``state_dict()``) that comes back bit for bit."""
import json
import os
import pickle

import fsspec
import jax.numpy as jnp
import pytest
import torch

import petastorm_tpu_torch.loader.checkpoint as ckpt_mod
from petastorm_tpu.jax.checkpoint import CheckpointManager as JaxCheckpointManager
from petastorm_tpu_torch.loader import CheckpointManager, DataLoader
from petastorm_tpu_torch.reader import make_reader

CURSOR = {"epoch": 1, "offset": 4, "items": 10, "seed": 7}


def test_sidecar_path_and_content_equal_the_jax_packages(tmp_path):
    extra = {"tokens_seen": 1234}
    with JaxCheckpointManager(str(tmp_path / "jax")) as mgr:
        mgr.save(3, {"x": jnp.zeros(2)}, reader=CURSOR, extra_input_state=extra)
    with CheckpointManager(str(tmp_path / "port")) as mgr:
        mgr.save(3, {"x": torch.zeros(2)}, reader=CURSOR, extra_input_state=extra)
    rel = os.path.join("3", "input_state.0.json")
    with open(tmp_path / "jax" / rel) as f, open(tmp_path / "port" / rel) as g:
        assert json.load(g) == json.load(f) == {"process_count": 1, "state": CURSOR,
                                                "extra": extra}


def test_training_state_round_trips_bit_for_bit(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 3))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, weight_decay=1e-4)
    x, y = torch.randn(8, 6), torch.randint(0, 3, (8,))

    def step(m, o):
        loss = torch.nn.functional.cross_entropy(m(x), y)
        loss.backward()
        o.step()
        o.zero_grad()
        return loss.detach()

    for _ in range(2):
        step(model, opt)
    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(2, {"model": model.state_dict(), "opt": opt.state_dict()})
        state, input_state = mgr.restore(map_location="cpu")
    assert input_state is None
    model2 = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 3))
    opt2 = torch.optim.SGD(model2.parameters(), lr=0.1, momentum=0.9, weight_decay=1e-4)
    model2.load_state_dict(state["model"])
    opt2.load_state_dict(state["opt"])
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[a]["momentum_buffer"], opt2.state[b]["momentum_buffer"])
    assert torch.equal(step(model, opt), step(model2, opt2))
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


class Opaque:
    """An object ``torch.load(weights_only=True)`` must refuse."""


def test_restore_loads_weights_only(tmp_path):
    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(1, {"thing": Opaque()})
        with pytest.raises(pickle.UnpicklingError):
            mgr.restore()


def test_saved_cursor_resumes_the_stream(tmp_path, synthetic_dataset):
    kw = dict(schema_fields=["id"], reader_pool_type="dummy", shuffle_row_groups=True, seed=11,
              num_epochs=2)
    with make_reader(synthetic_dataset.url, **kw) as r:
        consumed = [int(next(r).id) for _ in range(25)]
        with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
            mgr.save(3, {"w": torch.arange(8.0)}, reader=r)
        rest = [int(row.id) for row in r]
    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        state, input_state = mgr.restore()
    assert torch.equal(state["w"], torch.arange(8.0))
    with make_reader(synthetic_dataset.url, resume_state=input_state, **kw) as r2:
        resumed = [int(row.id) for row in r2]
    assert resumed == consumed[20:] + rest


def test_loader_cursor_is_the_delivered_one(tmp_path, synthetic_dataset):
    """``save(loader=...)`` takes the loader's cursor (the last delivered
    batch), not the reader's, which the staging thread drove ahead; a
    reader passed beside it wins."""
    kw = dict(schema_fields=["id"], reader_pool_type="thread", workers_count=1,
              shuffle_row_groups=False, num_epochs=1)
    with make_reader(synthetic_dataset.url, **kw) as r, \
            CheckpointManager(tmp_path / "c") as mgr:
        loader = DataLoader(r, batch_size=10, prefetch=4, device="cpu")
        it = iter(loader)
        next(it)
        mgr.save(1, {}, loader=loader)
        mgr.save(2, {}, reader={"epoch": 0, "offset": 7}, loader=loader)
        it.close()
        assert mgr.restore(1)[1] == {"epoch": 0, "offset": 1, "items": 10, "seed": None}
        assert mgr.restore(2)[1] == {"epoch": 0, "offset": 7}


def test_shuffling_loader_refuses_to_checkpoint(tmp_path, synthetic_dataset):
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy") as r, \
            CheckpointManager(tmp_path / "c") as mgr:
        loader = DataLoader(r, batch_size=5, shuffling_queue_capacity=20, device="cpu")
        with pytest.raises(ValueError, match="shuffling_queue_capacity"):
            mgr.save(1, {}, loader=loader)
        assert mgr.all_steps() == []


def test_retention_and_latest(tmp_path):
    with CheckpointManager(str(tmp_path / "c"), max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        for s in (1, 2, 3):
            mgr.save(s, {"x": torch.zeros(2)}, reader={"epoch": 0, "offset": s})
        assert mgr.latest_step() == 3
        assert mgr.all_steps() == [2, 3]
        assert sorted(os.listdir(tmp_path / "c")) == ["2", "3"]
        _, inp = mgr.restore()
        assert inp == {"epoch": 0, "offset": 3}
        with pytest.raises(ValueError, match="max_to_keep"):
            CheckpointManager(str(tmp_path / "d"), max_to_keep=0)


def test_no_reader_means_none_input(tmp_path):
    with CheckpointManager(str(tmp_path / "c2")) as mgr:
        mgr.save(1, {"x": torch.zeros(2)})
        _, inp = mgr.restore()
    assert inp is None
    assert not (tmp_path / "c2" / "1" / "input_state.0.json").exists()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_rejects_a_rank_count_mismatch(tmp_path, monkeypatch):
    with CheckpointManager(str(tmp_path / "c3")) as mgr:
        mgr.save(1, {"x": torch.zeros(2)}, reader={"epoch": 0, "offset": 1})
        monkeypatch.setattr(ckpt_mod, "_process_info", lambda: (0, 4))
        with pytest.raises(ValueError, match="4"):
            mgr.restore()


def test_sidecar_is_per_rank(tmp_path, monkeypatch):
    with CheckpointManager(str(tmp_path / "c4")) as mgr:
        monkeypatch.setattr(ckpt_mod, "_process_info", lambda: (0, 2))
        mgr.save(1, {"x": torch.zeros(2)}, reader={"epoch": 0, "offset": 3})
        monkeypatch.setattr(ckpt_mod, "_process_info", lambda: (1, 2))
        mgr.save(1, {"x": torch.ones(2)}, reader={"epoch": 0, "offset": 7})
        state, inp1 = mgr.restore()
        assert inp1 == {"epoch": 0, "offset": 7}
        # Only rank 0 writes the training state.
        assert torch.equal(state["x"], torch.zeros(2))
        monkeypatch.setattr(ckpt_mod, "_process_info", lambda: (0, 2))
        assert mgr.restore()[1] == {"epoch": 0, "offset": 3}


def test_rank_count_mismatch_detected_without_own_file(tmp_path, monkeypatch):
    with CheckpointManager(str(tmp_path / "c5")) as mgr:
        mgr.save(1, {"x": torch.zeros(2)}, reader={"epoch": 0, "offset": 2})
        monkeypatch.setattr(ckpt_mod, "_process_info", lambda: (3, 4))
        with pytest.raises(ValueError, match="4"):
            mgr.restore()


def test_remote_url_not_mangled():
    url = "memory://bucket/torch_ckpt"
    with CheckpointManager(url, max_to_keep=1) as mgr:
        mgr.save(4, {"x": torch.arange(3)}, reader={"epoch": 1, "offset": 9})
        mgr.save(5, {"x": torch.arange(4)}, reader={"epoch": 1, "offset": 10})
        assert mgr.all_steps() == [5]
        state, inp = mgr.restore(step=5)
    assert inp == {"epoch": 1, "offset": 10} and torch.equal(state["x"], torch.arange(4))
    fs, _ = fsspec.core.url_to_fs(url)
    assert fs.exists("bucket/torch_ckpt/5/input_state.0.json")
    assert fs.exists("bucket/torch_ckpt/5/train_state.pt")
    assert not fs.exists("bucket/torch_ckpt/4")
    assert not os.path.exists(os.path.join(os.getcwd(), "memory:"))


def test_file_scheme_is_local(tmp_path):
    with CheckpointManager(f"file://{tmp_path}/ck") as mgr:
        mgr.save(1, {"x": torch.zeros(2)}, reader={"epoch": 0, "offset": 1})
        _, inp = mgr.restore()
    assert inp == {"epoch": 0, "offset": 1}
    assert (tmp_path / "ck" / "1" / "input_state.0.json").exists()
    assert (tmp_path / "ck" / "1" / "train_state.pt").exists()


def test_torn_saves_never_restore_a_wrong_cursor(tmp_path, monkeypatch):
    """A save cut after the state commits restores ``None`` as the input
    state; one cut while the state is written leaves no step (and a
    temporary directory left by a killed process is not one)."""
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(1, {"x": torch.zeros(2)}, reader={"epoch": 0, "offset": 1})

    def no_sidecar(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(mgr, "_write_json", no_sidecar)
    with pytest.raises(OSError):
        mgr.save(2, {"x": torch.ones(2)}, reader={"epoch": 0, "offset": 2})
    monkeypatch.undo()
    state, inp = mgr.restore()
    assert mgr.latest_step() == 2 and inp is None and torch.equal(state["x"], torch.ones(2))

    def cut(*args, **kwargs):
        raise OSError("killed")
    monkeypatch.setattr(ckpt_mod.torch, "save", cut)
    with pytest.raises(OSError):
        mgr.save(3, {"x": torch.ones(2)}, reader={"epoch": 0, "offset": 3})
    monkeypatch.undo()
    (tmp_path / "c" / ".4.tmp-killed").mkdir()
    assert mgr.all_steps() == [1, 2]
    assert sorted(os.listdir(tmp_path / "c")) == [".4.tmp-killed", "1", "2"]
    assert mgr.restore(1)[1] == {"epoch": 0, "offset": 1}
