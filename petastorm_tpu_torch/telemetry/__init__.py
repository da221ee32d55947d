"""End-to-end pipeline telemetry (the JAX package's telemetry core).

One :class:`TelemetryRegistry` per pipeline collects:

* **spans** — monotonic-clock timed sections with thread/process provenance
  (ring-buffer bounded, :class:`SpanRecorder`), named like the
  ``torch.profiler`` ranges emitted on the same paths
  (:func:`petastorm_tpu_torch.metrics.traced_span`);
* **histograms** — streaming fixed-bucket latency / byte-size distributions
  (:class:`StreamingHistogram`);
* **gauges** — live queue depths: ventilator backlog, worker-pool results
  queue, shuffling-buffer fill, prefetch queue;
* **counters** — rows, batches, bytes, per-stage cumulative seconds;
* **stall attribution** — per-``__next__`` host-bound / device-bound /
  balanced classification (:class:`StallAttributor`);
* **critical-path attribution** — per delivered batch, the stage that
  accrued the most self-time (:class:`CriticalPathAttributor`).

Exports: Prometheus text format and JSON snapshots
(:mod:`petastorm_tpu_torch.telemetry.exporters`), Chrome traces
(:mod:`petastorm_tpu_torch.telemetry.trace`). Names, buckets and formats
are the JAX package's, so either package's exports read alike.

Stage metric names (the keys behind a loader's ``stage_breakdown()``):

==============================  =================================================
metric                          meaning
==============================  =================================================
``worker.decode_s``             in-worker row-group read+decode (histogram;
                                thread and dummy pools only)
``reader.pool_wait_s``          consumer blocked on the pool's results
``transport.deserialize_s``     process pool: results deserialized off the rings
``loader.shuffle_s``            shuffling-buffer add/retrieve time (counter)
``loader.host_wait_s``          staging thread waiting on batch production
``loader.stage_s``              sanitize + host-to-device copy
``loader.delivery_wait_s``      consumer blocked on the staged-batch queue
``ventilator.backlog``          ventilated-but-unprocessed row groups (gauge)
``pool.results_queue_depth``    results queue fill (gauge)
``shuffle_buffer.fill``         shuffling-buffer occupancy (gauge)
==============================  =================================================

Nothing here imports torch: reader workers import these modules.
"""
from petastorm_tpu_torch.telemetry.exporters import (PeriodicExporter, from_json,
                                                     parse_prometheus_text, to_json,
                                                     to_prometheus_text, write_snapshot)
from petastorm_tpu_torch.telemetry.histogram import (LATENCY_BOUNDS_S, SIZE_BOUNDS,
                                                     StreamingHistogram)
from petastorm_tpu_torch.telemetry.recorder import Span, SpanRecorder
from petastorm_tpu_torch.telemetry.registry import (SNAPSHOT_SCHEMA_VERSION, Counter, Gauge,
                                                    TelemetryRegistry)
from petastorm_tpu_torch.telemetry.stall import StallAttributor
from petastorm_tpu_torch.telemetry.trace import (CriticalPathAttributor, TraceContext,
                                                 complete_lineages, lineage_index,
                                                 to_chrome_trace, write_chrome_trace)

#: Environment variable: when set to a path, every Reader starts a
#: PeriodicExporter writing JSON snapshots there (a ``.prom`` suffix
#: switches to Prometheus text format).
TELEMETRY_EXPORT_ENV = "PETASTORM_TPU_TELEMETRY_EXPORT"

#: Environment variable: any non-empty value enables span recording on every
#: new registry (spans default off — gauges/counters/histograms are always
#: on, they are cheap).
TELEMETRY_SPANS_ENV = "PETASTORM_TPU_TELEMETRY_SPANS"

#: Environment variable: any non-empty value puts every new registry in
#: TRACE mode — spans on, lineage (trace/stage/track) fields recorded, ring
#: capacity grown so a whole epoch survives for a Chrome-trace export.
#: Implies TELEMETRY_SPANS_ENV.
TELEMETRY_TRACE_ENV = "PETASTORM_TPU_TELEMETRY_TRACE"


def make_registry() -> TelemetryRegistry:
    """A registry honoring :data:`TELEMETRY_SPANS_ENV` and
    :data:`TELEMETRY_TRACE_ENV`."""
    import os
    registry = TelemetryRegistry(spans_enabled=bool(os.environ.get(TELEMETRY_SPANS_ENV)))
    if os.environ.get(TELEMETRY_TRACE_ENV):
        registry.recorder.enable_trace()
    return registry


__all__ = [
    "Counter", "CriticalPathAttributor", "Gauge", "LATENCY_BOUNDS_S", "PeriodicExporter",
    "SIZE_BOUNDS", "SNAPSHOT_SCHEMA_VERSION", "Span", "SpanRecorder", "StallAttributor",
    "StreamingHistogram", "TELEMETRY_EXPORT_ENV", "TELEMETRY_SPANS_ENV", "TELEMETRY_TRACE_ENV",
    "TelemetryRegistry", "TraceContext", "complete_lineages", "from_json", "lineage_index",
    "make_registry", "parse_prometheus_text", "to_chrome_trace", "to_json",
    "to_prometheus_text", "write_chrome_trace", "write_snapshot",
]
