"""The input pipeline's fault-tolerance layer (the JAX package's
``petastorm_tpu/resilience``, whose ``docs/resilience.md`` describes it).

Four pieces threaded through every layer that can fail:

* :mod:`~petastorm_tpu_torch.resilience.policy` — composable
  :class:`RetryPolicy` (seeded exponential backoff + jitter, deadlines,
  transient-vs-permanent classifiers).
* :mod:`~petastorm_tpu_torch.resilience.quarantine` — worker-side
  :class:`RowGroupGuard` (retry, then skip-and-record in
  ``degraded_mode``) and the consumer-side :class:`RowGroupQuarantine`
  report on the Reader.
* :mod:`~petastorm_tpu_torch.resilience.recovery` — process-pool
  worker-crash detection + re-ventilation of lost row groups under a crash
  budget.
* :mod:`~petastorm_tpu_torch.resilience.faults` — deterministic seeded
  :class:`FaultPlan` injection (IOError / corruption / latency with seeded
  jitter / worker-kill) for tests and benchmarks.

Latency faults, the *slow* failure mode that nothing raises for, get three
more:

* :mod:`~petastorm_tpu_torch.resilience.deadline` — per-attempt
  :class:`StageDeadline` soft/hard budgets: soft overruns emit
  ``resilience.straggler`` telemetry, hard overruns cancel the attempt
  into the retry/quarantine machinery above.
* :mod:`~petastorm_tpu_torch.resilience.hedging` — :class:`HedgePolicy`-driven
  speculative duplicate row-group reads after a quantile-tracked delay;
  first result wins, byte-identical either way.
* :mod:`~petastorm_tpu_torch.resilience.watchdog` — :class:`PipelineWatchdog`
  monitor thread: detects a hung pipeline, dumps thread stacks to the
  registry, escalates nudge → cancel/kill → :class:`PipelineHungError`.

Every retry/quarantine/recovery event lands on the pipeline's telemetry
registry: ``resilience.retries_total``, ``resilience.giveups_total``,
``resilience.quarantined_rowgroups``, ``resilience.worker_crashes``,
``resilience.reventilated_items``, the straggler, hedge and watchdog
counters, and ``transport.rings_reclaimed`` from the process pool. The
package imports neither torch nor the JAX package: spawned workers load it.
"""
from petastorm_tpu_torch.resilience.deadline import (CancellationToken,
                                               DeadlineTimer, StageDeadline,
                                               StageDeadlineExceeded,
                                               StragglerMonitor)
from petastorm_tpu_torch.resilience.faults import (FaultPlan, FaultSpec,
                                             InjectedCorruptionError,
                                             InjectedFault, InjectedIOError,
                                             in_spawned_worker,
                                             mark_spawned_worker)
from petastorm_tpu_torch.resilience.hedging import HedgedReadExecutor, HedgePolicy
from petastorm_tpu_torch.resilience.policy import (DEFAULT_READ_POLICY, PERMANENT,
                                             TRANSIENT, ExponentialBackoff,
                                             RetryPolicy,
                                             default_io_classifier,
                                             failover_classifier, no_retry,
                                             sqlite_classifier)
from petastorm_tpu_torch.resilience.quarantine import (QuarantineRecord,
                                                 RowGroupGuard,
                                                 RowGroupQuarantine,
                                                 RowGroupSkipped,
                                                 RowGroupSkippedMessage)
from petastorm_tpu_torch.resilience.recovery import (CrashBudgetExceededError,
                                               ItemStartedMessage,
                                               WorkerCrashRecovery)
from petastorm_tpu_torch.resilience.watchdog import (PipelineHungError,
                                               PipelineWatchdog,
                                               dump_thread_stacks)

__all__ = [
    "CancellationToken", "CrashBudgetExceededError", "DEFAULT_READ_POLICY",
    "DeadlineTimer", "ExponentialBackoff", "FaultPlan", "FaultSpec",
    "HedgePolicy", "HedgedReadExecutor", "InjectedCorruptionError",
    "InjectedFault", "InjectedIOError", "ItemStartedMessage", "PERMANENT",
    "PipelineHungError", "PipelineWatchdog", "QuarantineRecord",
    "RetryPolicy", "RowGroupGuard", "RowGroupQuarantine", "RowGroupSkipped",
    "RowGroupSkippedMessage", "StageDeadline", "StageDeadlineExceeded",
    "StragglerMonitor", "TRANSIENT", "WorkerCrashRecovery",
    "default_io_classifier", "dump_thread_stacks", "failover_classifier",
    "in_spawned_worker", "mark_spawned_worker", "no_retry",
    "sqlite_classifier",
]
