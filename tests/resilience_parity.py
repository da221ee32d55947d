"""What the resilience parity tests share (``tests/test_torch_resilience.py``,
``tests/test_torch_straggler.py``): the two packages side by side, an exact
comparison, a zero-delay policy, and one read of a store through either
package's reader or the port's process pool."""
import petastorm_tpu.resilience as jres
import petastorm_tpu_torch.resilience as tres
from petastorm_tpu.telemetry import TelemetryRegistry as JaxRegistry
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.telemetry import TelemetryRegistry

PACKAGES = [(jres, JaxRegistry), (tres, TelemetryRegistry)]


def both(fn):
    """``fn(resilience_module, registry_class)`` for the JAX package, then
    the port: the two results, for an exact comparison."""
    return [fn(r, reg) for r, reg in PACKAGES]


def fast_policy(r, attempts=3):
    """Zero-delay policy: full retry semantics, no sleeps."""
    return r.RetryPolicy(max_attempts=attempts,
                         backoff=r.ExponentialBackoff(base=0.0, multiplier=1.0, cap=0.0),
                         jitter="none", seed=0)


def same(pair):
    jax_value, port_value = pair
    assert port_value == jax_value
    return port_value


def records(report):
    """A quarantine report without its wall-clock stamps."""
    return {**report, "pieces": [{k: v for k, v in p.items() if k != "wall_time"}
                                 for p in report["pieces"]]}


def read_stream(factory, r, url, batched, **kwargs):
    """Ids in delivery order, the cursor after each unit, the resilience
    counters, the quarantine report and the skips the ordered gate recorded,
    of one read through ``factory`` (either package's reader; ``r`` its
    resilience module) under a five-attempt zero-delay policy."""
    ids, states = [], []
    with factory(url, schema_fields=["id"], retry_policy=fast_policy(r, attempts=5),
                 **kwargs) as reader:
        for sample in reader:
            ids.extend(int(v) for v in (sample.id if batched else [sample.id]))
            states.append(reader.state_dict())
        counters = reader.telemetry.snapshot()["counters"]
        report = records(reader.quarantine_report())
        skips = (counters.get("order.skips_recorded", 0) if r is jres
                 else reader.counters.get("skips_recorded", 0))
    resilience = {k: v for k, v in counters.items() if k.startswith("resilience.")}
    return ids, states, resilience, report, skips


def process_read(url, specs, budget, **kwargs):
    """Sorted ids, counters and watchdog report of one epoch of the port's
    reader on 3 spawned workers under ``specs`` and a crash budget."""
    plan = tres.FaultPlan(specs, seed=0)
    with make_reader(url, schema_fields=["id"], reader_pool_type="process", workers_count=3,
                     shuffle_row_groups=False, fault_plan=plan, worker_crash_budget=budget,
                     **kwargs) as reader:
        ids = sorted(int(s.id) for s in reader)
        counters = reader.telemetry.snapshot()["counters"]
        report = reader.watchdog_report()
    return ids, counters, report
