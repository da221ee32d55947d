"""The one raw-listing path (the JAX package's ``discovery/listing.py``):
every listing of a dataset's files goes through :func:`list_data_files`,
where it is retried under a
:class:`~petastorm_tpu_torch.resilience.RetryPolicy` (fault site
``discovery.list``), bounded by a
:class:`~petastorm_tpu_torch.resilience.StageDeadline` and timed into the
``discovery.list_s`` histogram.

``python tools/check_listing.py <files>`` flags any ``fs.ls``/``find``/
``listdir``/``glob`` outside ``petastorm_tpu_torch/discovery/``: a raw
listing is an unretried, unbounded and uncounted IO call.
"""
from __future__ import annotations

import posixpath
import time
from typing import List, Sequence, Union

__all__ = ["list_data_files", "is_data_file", "DEFAULT_LIST_POLICY", "DEFAULT_LIST_DEADLINE"]


def _default_list_policy():
    """A couple of quick retries: a flaky listing heals, a dead store fails
    soon enough that the next poll (or planning's caller) sees it."""
    from petastorm_tpu_torch.resilience import ExponentialBackoff, RetryPolicy
    return RetryPolicy(max_attempts=3,
                       backoff=ExponentialBackoff(base=0.05, multiplier=2.0, cap=1.0),
                       jitter="none", seed=0)


#: The module's default policy, made at the first listing (importing the
#: module does not import the resilience package).
DEFAULT_LIST_POLICY = None


class _LazyDeadline:
    """The default listing deadline, made on first use: a listing past 30 s
    is taken for a hung store, discarded and retried. Cooperative, as every
    deadline here: a blocked call is not interrupted, but the watcher lists
    off the consumer's thread."""

    _real = None

    def start(self, *args, **kwargs):
        if _LazyDeadline._real is None:
            from petastorm_tpu_torch.resilience import StageDeadline
            _LazyDeadline._real = StageDeadline(soft_s=15.0, hard_s=30.0)
        return _LazyDeadline._real.start(*args, **kwargs)


DEFAULT_LIST_DEADLINE = _LazyDeadline()


def is_data_file(path: str) -> bool:
    """Hidden files and sidecars (``_metadata``, ``_common_metadata``,
    dotfiles) are never data; ``*.parquet``/``*.parq`` or extension-less
    files are."""
    base = posixpath.basename(path)
    if base.startswith(("_", ".")):
        return False
    return base.endswith((".parquet", ".parq")) or "." not in base


def list_data_files(filesystem, path_or_paths: Union[str, Sequence[str]], *,
                    retry_policy=None, deadline=None, fault_plan=None, telemetry=None,
                    worker_id: int = 0) -> List[str]:
    """Every data file under ``path_or_paths``, sorted.

    Each attempt fires the ``discovery.list`` fault site and runs under the
    optional per-attempt ``deadline`` (an attempt that ends past its hard
    budget is discarded and retried), and the attempts follow
    ``retry_policy`` (default: 3 attempts, short backoff). With a registry
    as ``telemetry``: the ``discovery.list_s`` histogram and the
    ``discovery.list_retries_total`` and ``discovery.list_failures_total``
    counters. The last exception is raised when the policy gives up."""
    global DEFAULT_LIST_POLICY
    if retry_policy is None:
        if DEFAULT_LIST_POLICY is None:
            DEFAULT_LIST_POLICY = _default_list_policy()
        retry_policy = DEFAULT_LIST_POLICY
    paths = (list(path_or_paths) if isinstance(path_or_paths, (list, tuple))
             else [path_or_paths])
    hist = retries = failures = None
    if telemetry is not None:
        hist = telemetry.histogram("discovery.list_s")
        retries = telemetry.counter("discovery.list_retries_total")
        failures = telemetry.counter("discovery.list_failures_total")

    def attempt() -> List[str]:
        timer = deadline.start() if deadline is not None else None
        t0 = time.perf_counter()
        if fault_plan is not None:
            fault_plan.fire("discovery.list", key=str(paths[0]), worker_id=worker_id)
        found: List[str] = []
        for p in paths:
            if filesystem.isdir(p):
                listed = filesystem.find(p)
                if timer is not None:
                    # Between roots: one crawling root cancels here.
                    timer.check()
                found.extend(f for f in listed if is_data_file(f))
            else:
                found.append(p)
        if timer is not None:
            # A listing that finished past the hard budget is discarded
            # (StageDeadlineExceeded is an IOError, so it is retried).
            timer.finish()
        if hist is not None:
            hist.observe(time.perf_counter() - t0)
        return sorted(found)

    def on_retry(attempt_no, exc, delay):
        if retries is not None:
            retries.add(1)

    def on_give_up(attempts, exc):
        if failures is not None:
            failures.add(1)

    return retry_policy.call(attempt, on_retry=on_retry, on_give_up=on_give_up)
