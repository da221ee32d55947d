"""Joint checkpoints of the training state and the input position (the JAX
package's ``jax/checkpoint.py``, with ``torch.save`` where it has orbax)::

    mgr = CheckpointManager("/ckpt", max_to_keep=3)
    mgr.save(step, {"model": params, "opt": opt.state_dict()}, loader=loader)
    ...
    train_state, input_state = mgr.restore(map_location="cuda")
    reader = make_reader(url, resume_state=input_state, ...)

Layout, one directory per step: ``<dir>/<step>/train_state.pt`` (the
``train_state`` dict through ``torch.save``) and, written after it, the JSON
sidecar ``<dir>/<step>/input_state.<rank>.json``, the path the JAX package
uses, with the same content: ``{"process_count", "state", "extra"}``. A
local step is written into a temporary directory that is then renamed into
place, so a step either exists whole or not at all; a save torn between the
state and its sidecar restores ``None`` as the input state, never a wrong
cursor. Remote URLs (``scheme://``, not ``file://``) are kept as they are
and opened through fsspec.

The cursor is per rank (each reads its own shard): the rank and the rank
count come from ``torch.distributed`` when a process group is initialised,
else ``(0, 1)``, and a restore under another rank count raises. With
several ranks every rank calls ``save``: rank 0 writes the training state,
a barrier follows, then each rank writes its own sidecar.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, List, Optional

import torch

TRAIN_STATE_FILE = "train_state.pt"


def _process_info():
    """(rank, rank count) of this process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _url_scheme(url: str) -> Optional[str]:
    m = re.match(r"^([A-Za-z][A-Za-z0-9+.-]*)://", url)
    return m.group(1).lower() if m else None


class CheckpointManager:
    """Saves ``train_state`` and the input cursor of each step under
    ``directory``, keeping the newest ``max_to_keep`` steps (all when
    None)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got {max_to_keep}")
        directory = str(directory)
        scheme = _url_scheme(directory)
        self._max_to_keep = max_to_keep
        if scheme in (None, "file"):
            local = directory[len("file://"):] if scheme == "file" else directory
            self._fs = None
            self._dir = os.path.abspath(local)
            os.makedirs(self._dir, exist_ok=True)
        else:
            # os.path.abspath would turn 'gs://b/p' into '/cwd/gs:/b/p' and
            # checkpoint onto the local disk.
            import fsspec
            self._fs, _ = fsspec.core.url_to_fs(directory)
            self._dir = directory.rstrip("/")

    # ------------------------------------------------------------------ save
    def save(self, step: int, train_state: Any, reader=None, loader=None,
             extra_input_state: Optional[dict] = None) -> bool:
        """Save ``train_state`` (a dict of ``state_dict()``s, or anything
        ``torch.save`` takes) and the input cursor of ``step``.

        ``reader`` is a reader (its ``state_dict()`` is taken: a free or a
        deterministic cursor, or a ``WeightedSamplingReader``'s members'
        cursors with its ``seed`` and ``step``) or a cursor dict; when given
        it wins. For loader-fed training pass ``loader``:
        its ``state_dict()`` is the position of the last delivered batch,
        where the reader's own has run ahead by the prefetched batches.
        Returns True."""
        step = int(step)
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        state = self._resolve_input_state(reader, loader)
        rank, count = _process_info()
        if rank == 0:
            self._write_train_state(step, train_state)
        if count > 1 and torch.distributed.is_initialized():
            # Every rank's sidecar lands after the state is committed.
            torch.distributed.barrier()
        if state is not None or extra_input_state is not None:
            # One file per rank: concurrent saves of several ranks never
            # rewrite a shared file.
            payload = {"process_count": count, "state": state, "extra": extra_input_state or {}}
            self._write_json(self._path(step, f"input_state.{rank}.json"), payload)
        if rank == 0:
            self._apply_retention()
        return True

    def _write_train_state(self, step: int, train_state):
        if self._fs is not None:
            # An object store's put is all or nothing.
            with self._fs.open(self._path(step, TRAIN_STATE_FILE), "wb") as f:
                torch.save(train_state, f)
            return
        final = os.path.join(self._dir, str(step))
        tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=self._dir)
        try:
            torch.save(train_state, os.path.join(tmp, TRAIN_STATE_FILE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, map_location=None):
        """``(train_state, input_state)`` of ``step`` (default: the latest).
        ``train_state`` is loaded with ``torch.load(weights_only=True)`` onto
        ``map_location``; ``input_state`` is this rank's cursor (pass it as
        ``resume_state=``), or None when the step has no sidecar of its own.
        Raises ``ValueError`` when the step was saved by another number of
        ranks (its shard cursors do not transfer)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
        with self._open(self._path(step, TRAIN_STATE_FILE), "rb") as f:
            train_state = torch.load(f, map_location=map_location, weights_only=True)
        rank, count = _process_info()
        own = self._path(step, f"input_state.{rank}.json")
        # Check the rank count against this rank's sidecar, else rank 0's:
        # a rank without a file of its own still sees a changed count.
        check = own if self._exists(own) else self._path(step, "input_state.0.json")
        input_state = None
        if self._exists(check):
            with self._open(check, "r") as f:
                payload = json.load(f)
            if payload.get("process_count") != count:
                raise ValueError(f"checkpoint was saved with {payload.get('process_count')} "
                                 f"processes but this job has {count}; the per-rank shard "
                                 f"cursors do not transfer")
            if check == own:
                input_state = payload.get("state")
        return train_state, input_state

    # ------------------------------------------------------------------ misc
    def all_steps(self) -> List[int]:
        """The saved steps, ascending (steps still being written excluded)."""
        if self._fs is None:
            names = os.listdir(self._dir)  # listing-ok: checkpoint steps, not dataset files
        elif self._fs.exists(self._dir):
            names = [p.rstrip("/").rsplit("/", 1)[-1]
                     for p in self._fs.ls(self._dir, detail=False)]  # listing-ok: as above
        else:
            names = []
        return sorted(int(name) for name in names
                      if name.isdigit() and self._exists(self._path(int(name), TRAIN_STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing is held open between calls; kept for the JAX package's
        interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------- internals
    def _path(self, step: int, name: str) -> str:
        if self._fs is None:
            return os.path.join(self._dir, str(step), name)
        return f"{self._dir}/{step}/{name}"

    def _exists(self, path: str) -> bool:
        return os.path.exists(path) if self._fs is None else self._fs.exists(path)

    def _open(self, path: str, mode: str):
        return open(path, mode) if self._fs is None else self._fs.open(path, mode)

    def _write_json(self, path: str, payload: dict):
        if self._fs is not None:
            with self._fs.open(path, "w") as f:
                json.dump(payload, f)
            return
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _apply_retention(self):
        if self._max_to_keep is None:
            return
        for step in self.all_steps()[:-self._max_to_keep]:
            if self._fs is None:
                shutil.rmtree(os.path.join(self._dir, str(step)), ignore_errors=True)
            else:
                self._fs.rm(f"{self._dir}/{step}", recursive=True)

    @staticmethod
    def _resolve_input_state(reader, loader) -> Optional[dict]:
        if reader is not None:
            return reader if isinstance(reader, dict) else reader.state_dict()
        if loader is not None:
            # A loader with a shuffling buffer raises here rather than
            # persisting a cursor that would lose rows.
            state = loader.state_dict()
            if state is not None:
                return state
            inner = getattr(loader, "_reader", None)
            if inner is not None:
                return inner.state_dict()
        return None
