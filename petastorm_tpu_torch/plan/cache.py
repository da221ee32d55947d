"""Persisted winning plans, so a warm start skips the placement trial (the
JAX package's ``plan/cache.py``: the same keys, hashing, record format and
environment variables, so a record written by either package loads in the
other).

When a reader's placement trial resolves, it persists the winner here; the
next reader built for the same key starts on the winning backend with the
trial pinned off and the tuned knob values seeded
(:mod:`petastorm_tpu_torch.plan.optimizer`). The key is (dataset
fingerprint, store type, host): the md5 of the dataset URL and the sorted
output field names, the filesystem scheme, and ``socket.gethostname()``.

Records live under ``$PETASTORM_TPU_PLAN_CACHE`` (default
``$XDG_CACHE_HOME/petastorm_tpu/plans``, else ``~/.cache/...``), one JSON
file a key, written atomically (a temporary file, then a rename). Every
failure reads as a miss: corrupt JSON (the file is removed), another plan
schema version, a key mismatch, a record older than
``$PETASTORM_TPU_PLAN_TTL_S`` (default 30 days), an unreadable directory.
``PETASTORM_TPU_PLAN_CACHE=0`` turns persistence off.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import time
from dataclasses import dataclass
from typing import Optional

from petastorm_tpu_torch.plan.plan import PLAN_SCHEMA_VERSION

__all__ = ["PlanCache", "PlanKey", "PLAN_CACHE_ENV", "PLAN_CACHE_TTL_ENV",
           "DEFAULT_PLAN_TTL_S", "plan_cache_dir"]

PLAN_CACHE_ENV = "PETASTORM_TPU_PLAN_CACHE"
PLAN_CACHE_TTL_ENV = "PETASTORM_TPU_PLAN_TTL_S"

#: Records older than this are stale.
DEFAULT_PLAN_TTL_S = 30 * 24 * 3600.0


def plan_cache_dir() -> Optional[str]:
    """The cache directory, or None when persistence is off."""
    configured = os.environ.get(PLAN_CACHE_ENV, "").strip()
    if configured.lower() in ("0", "off", "false"):
        return None
    if configured:
        return configured
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "petastorm_tpu", "plans")


@dataclass(frozen=True)
class PlanKey:
    """What a persisted plan is keyed by (see the module docstring)."""

    fingerprint: str
    store_type: str
    host: str

    @classmethod
    def for_dataset(cls, dataset_url, schema_field_names,
                    host: Optional[str] = None) -> "PlanKey":
        url_text = dataset_url if isinstance(dataset_url, str) else "|".join(dataset_url)
        fields = ",".join(schema_field_names or ())
        fp = hashlib.md5(f"{url_text}::{fields}".encode()).hexdigest()
        scheme = url_text.split("://", 1)[0] if "://" in url_text else "file"
        return cls(fingerprint=fp, store_type=scheme, host=host or socket.gethostname())

    @property
    def filename(self) -> str:
        tag = hashlib.md5(f"{self.fingerprint}:{self.store_type}:{self.host}".encode()).hexdigest()
        return f"plan_{tag}.json"

    def to_dict(self) -> dict:
        return {"fingerprint": self.fingerprint, "store_type": self.store_type,
                "host": self.host}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanKey":
        return cls(fingerprint=d["fingerprint"], store_type=d["store_type"], host=d["host"])


class PlanCache:
    """Loads and stores persisted plan records; never raises."""

    def __init__(self, directory: Optional[str] = None, ttl_s: Optional[float] = None):
        self.directory = directory if directory is not None else plan_cache_dir()
        if ttl_s is None:
            env_ttl = os.environ.get(PLAN_CACHE_TTL_ENV, "").strip()
            try:
                ttl_s = float(env_ttl) if env_ttl else DEFAULT_PLAN_TTL_S
            except ValueError:
                ttl_s = DEFAULT_PLAN_TTL_S
        self.ttl_s = ttl_s

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    def _path(self, key: PlanKey) -> str:
        return os.path.join(self.directory, key.filename)

    def load(self, key: PlanKey) -> Optional[dict]:
        """The record for ``key``, or None for a miss, a stale or corrupt
        record (removed) or one of another schema or key (left alone)."""
        if not self.enabled:
            return None
        path = self._path(key)
        try:
            with open(path, encoding="utf-8") as f:
                record = json.load(f)
        except OSError:
            # A miss, or a transient failure of a shared directory: only a
            # corrupt record is removed.
            return None
        except ValueError:
            self._discard(path)
            return None
        if not isinstance(record, dict):
            self._discard(path)
            return None
        if record.get("plan_schema_version") != PLAN_SCHEMA_VERSION:
            return None
        saved_key = record.get("key") or {}
        if saved_key.get("fingerprint") != key.fingerprint \
                or saved_key.get("store_type") != key.store_type \
                or saved_key.get("host") != key.host:
            return None
        created = record.get("created_at")
        if not isinstance(created, (int, float)) \
                or (self.ttl_s is not None and time.time() - created > self.ttl_s):
            return None
        if record.get("backend") not in ("thread", "process"):
            return None
        return record

    def store(self, key: PlanKey, record: dict) -> bool:
        """Persist ``record`` under ``key`` atomically; whether it landed."""
        if not self.enabled:
            return False
        payload = dict(record)
        payload["plan_schema_version"] = PLAN_SCHEMA_VERSION
        payload["key"] = key.to_dict()
        payload.setdefault("created_at", time.time())
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
            return True
        except OSError:
            self._discard(tmp)
            return False

    @staticmethod
    def _discard(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass
