"""Deterministic, seeded fault injection for the input pipeline (the JAX
package's ``resilience/faults.py``).

A :class:`FaultPlan` is a picklable list of :class:`FaultSpec` rules that
instrumented sites consult via :meth:`FaultPlan.fire`. The port's sites:

==================  ========================================================
site                fired
==================  ========================================================
``rowgroup.read``   per row-group read attempt in both reader workers
                    (``key`` = parquet file path)
``worker.item``     at the start of each ventilated item in a reader worker
                    (the site for ``worker_kill``; ``key`` = file path)
``cache.fill``      per LocalDiskCache miss, before the fill runs
                    (``key`` = cache key)
``discovery.list``  per :class:`~petastorm_tpu_torch.discovery.DatasetWatcher`
                    listing attempt (``key`` = the dataset root):
                    ``ioerror`` retries under the listing's RetryPolicy,
                    ``latency`` models a crawling store. Plan-time
                    ``file_paths()`` listings take the same retried path
                    but predate the reader's fault plan, so they never fire
``discovery.footer`` per new-file footer read of the watcher (``key`` =
                    file path): ``ioerror``/``corruption`` leave the file
                    ``pending_retry``, ``latency`` models a slow footer
``hdfs.call``       per proxied call of the HA HDFS client
                    (:class:`~petastorm_tpu_torch.hdfs.namenode.HAHdfsClient`;
                    ``key`` = the method's name)
==================  ========================================================

The JAX package has more sites (its service plane), which this package does
not have.

Determinism: ``at=N`` fires on exactly the Nth matching access *in this
process* (each spawned worker counts its own accesses); ``rate=p`` draws
from a ``random.Random`` seeded by ``(plan.seed, spec index, worker_id)``,
so a given worker's fault sequence is identical run-to-run. Fault
exceptions carry the :class:`InjectedFault` mixin so tests and quarantine
reports can tell injected failures from real ones.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import List, Optional

__all__ = [
    "FaultSpec", "FaultPlan", "InjectedFault", "InjectedIOError",
    "InjectedCorruptionError", "mark_spawned_worker", "in_spawned_worker",
]

_KINDS = ("ioerror", "corruption", "latency", "worker_kill")

# Set by ProcessPool's worker bootstrap: worker_kill faults refuse to fire
# in a process that isn't a spawned pool worker (killing the trainer or the
# pytest process is never what a fault plan means).
_IN_SPAWNED_WORKER = False


def mark_spawned_worker() -> None:
    global _IN_SPAWNED_WORKER
    _IN_SPAWNED_WORKER = True


def in_spawned_worker() -> bool:
    return _IN_SPAWNED_WORKER


class InjectedFault:
    """Mixin marking an exception as fault-plan-injected."""


class InjectedIOError(InjectedFault, IOError):
    """A transient-classified injected failure (subclasses IOError so the
    default classifier retries it)."""


class InjectedCorruptionError(InjectedFault, ValueError):
    """A permanent-classified injected failure — stands in for corrupt
    Parquet bytes (``pa.ArrowInvalid`` also subclasses ValueError)."""


@dataclasses.dataclass
class FaultSpec:
    """One injection rule.

    :param site: site name the rule applies to (exact match)
    :param kind: ``ioerror`` | ``corruption`` | ``latency`` | ``worker_kill``
    :param at: fire on the Nth matching access (1-based) in each process
    :param rate: fire with this probability per access (seeded; exclusive
        with ``at``)
    :param times: cap on total firings per process (default 1 for ``at``,
        unlimited for ``rate``)
    :param key_substring: only accesses whose ``key`` contains this fire
    :param worker: only fire in this pool worker id. Essential for
        ``worker_kill``: access counters are per-process, so an unrestricted
        ``at=N`` kill would fire in EVERY worker that reaches its Nth item
        (and again in whichever worker inherits the re-ventilated work) —
        pinning the spec to one worker kills exactly one process.
    :param latency_s: base sleep duration for ``latency`` faults
    :param latency_jitter_s: additional seeded jitter for ``latency``
        faults — each injection sleeps ``latency_s + j`` where ``j`` is a
        fresh **decorrelated** draw in ``(0, latency_jitter_s]``
        (AWS-style ``min(jit, uniform(jit/10, 3 * prev))``, per
        ``(spec, worker)`` RNG keyed off the plan seed). Real straggler
        distributions are long-tailed and uncorrelated injection-to-
        injection, not a constant; the seeded draw keeps tests and
        benchmarks byte-reproducible run-to-run. The
        jitter RNG stream is separate from the ``rate`` decision stream,
        so adding jitter to an existing plan never shifts which accesses
        fire.
    :param message: carried in the injected exception
    """

    site: str
    kind: str = "ioerror"
    at: Optional[int] = None
    rate: Optional[float] = None
    times: Optional[int] = None
    key_substring: Optional[str] = None
    worker: Optional[int] = None
    latency_s: float = 0.05
    latency_jitter_s: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if (self.at is None) == (self.rate is None):
            raise ValueError("exactly one of at=N / rate=p must be set "
                             f"(site={self.site!r})")
        if self.at is not None and self.at < 1:
            raise ValueError(f"at is 1-based, got {self.at}")
        if self.rate is not None and not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.latency_jitter_s < 0:
            raise ValueError(f"latency_jitter_s must be >= 0, "
                             f"got {self.latency_jitter_s}")


class FaultPlan:
    """A seeded set of fault rules; picklable (access counters restart at
    zero in each process — per-process determinism, which is the useful kind
    when spawned workers each see a different item subset)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        # Thread pools share one plan across worker threads: counters and
        # RNG draws mutate under this lock so at=N / times budgets stay
        # exact (fault execution itself runs outside it — a latency fault
        # must not serialize the other workers' accesses).
        self._lock = threading.Lock()
        self._seen = [0] * len(self.specs)    # matching accesses per spec
        self._fired = [0] * len(self.specs)   # firings per spec
        self._rngs = {}                       # (spec_idx, worker_id) -> Random
        # Decorrelated latency-jitter state: separate RNG stream and
        # previous-draw memory per (spec, worker), so jitter draws never
        # perturb the rate-decision sequences above.
        self._jitter_rngs = {}
        self._jitter_prev = {}

    # Counters/RNGs are per-process runtime state, not plan identity.
    def __getstate__(self):
        return {"specs": self.specs, "seed": self.seed}

    def __setstate__(self, state):
        self.__init__(state["specs"], state["seed"])

    def _rng(self, idx: int, worker_id: int) -> random.Random:
        rng = self._rngs.get((idx, worker_id))
        if rng is None:
            # String seed: deterministic across runs/platforms (tuple
            # seeding is hash-based and deprecated).
            rng = self._rngs[(idx, worker_id)] = random.Random(
                f"{self.seed}:{idx}:{worker_id}")
        return rng

    def fire(self, site: str, key: str = "", worker_id: int = 0) -> None:
        """Consult the plan at an instrumented site; raises / sleeps / kills
        when a rule decides to fire, else returns."""
        for idx, spec in enumerate(self.specs):
            with self._lock:
                decided = self._should_fire(idx, spec, site, key, worker_id)
            if decided:
                # A raising kind aborts the loop here, so later specs never
                # see this access — same ordering a single-threaded walk of
                # the spec list produces.
                self._execute(spec, site, key, idx, worker_id)

    def _should_fire(self, idx: int, spec: FaultSpec, site: str, key: str,
                     worker_id: int) -> bool:
        """Counter bookkeeping for one spec under the lock; True = execute."""
        if spec.site != site:
            return False
        if spec.key_substring is not None and spec.key_substring not in str(key):
            return False
        if spec.worker is not None and worker_id != spec.worker:
            return False
        self._seen[idx] += 1
        budget = spec.times if spec.times is not None else (
            1 if spec.at is not None else None)
        if budget is not None and self._fired[idx] >= budget:
            return False
        if spec.at is not None:
            if self._seen[idx] != spec.at:
                return False
        elif self._rng(idx, worker_id).random() >= spec.rate:
            return False
        self._fired[idx] += 1
        return True

    def _latency_jitter(self, idx: int, spec: FaultSpec,
                        worker_id: int) -> float:
        """One decorrelated seeded jitter draw in ``(0, latency_jitter_s]``
        (state mutates under the lock; the sleep itself happens outside)."""
        jit = spec.latency_jitter_s
        with self._lock:
            k = (idx, worker_id)
            rng = self._jitter_rngs.get(k)
            if rng is None:
                rng = self._jitter_rngs[k] = random.Random(
                    f"{self.seed}:{idx}:{worker_id}:jitter")
            prev = self._jitter_prev.get(k, jit / 3.0)
            draw = min(jit, rng.uniform(jit / 10.0,
                                        max(jit / 10.0, 3.0 * prev)))
            self._jitter_prev[k] = draw
        return draw

    def _execute(self, spec: FaultSpec, site: str, key: str,
                 idx: int = 0, worker_id: int = 0) -> None:
        detail = spec.message or f"injected {spec.kind} at {site} ({key})"
        if spec.kind == "ioerror":
            raise InjectedIOError(detail)
        if spec.kind == "corruption":
            raise InjectedCorruptionError(detail)
        if spec.kind == "latency":
            delay = spec.latency_s
            if spec.latency_jitter_s > 0:
                delay += self._latency_jitter(idx, spec, worker_id)
            time.sleep(delay)
            return
        # worker_kill: hard SIGKILL, the crashed-decode-worker shape. Only
        # legal inside a spawned pool worker — anywhere else the "fault"
        # would kill the training job itself, which is the opposite of what
        # a fault plan tests.
        if not in_spawned_worker():
            raise RuntimeError(
                "worker_kill fault fired outside a spawned process-pool "
                "worker; use reader_pool_type='process' for kill faults")
        import os
        import signal
        os.kill(os.getpid(), signal.SIGKILL)

    def stats(self) -> dict:
        """Per-spec ``{site, kind, seen, fired}`` for this process."""
        with self._lock:
            return {"specs": [
                {"site": s.site, "kind": s.kind,
                 "seen": self._seen[i], "fired": self._fired[i]}
                for i, s in enumerate(self.specs)]}
