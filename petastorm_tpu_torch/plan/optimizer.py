"""The plan optimizer: persisted placement and seeded capacities (the JAX
package's ``plan/optimizer.py``).

* :func:`consult_plan_cache`, from lowering, when the caller asked for
  placement tuning (``autotune=True`` with
  ``autotune_config.placement=True``): a valid record for the plan's key
  rewrites ``plan.placement["decode"]`` to the recorded winner, marks the
  plan ``source="persisted"`` and carries the recorded verdict and
  capacity seeds; the reader builds that pool, pins the placement knob and
  starts its actuators at the tuned values. Anything else is a miss.
* :func:`record_trial_outcome`, from the reader when its trial resolves:
  persists the winner, the verdict, the final actuator values and the
  operator profile. The port has no ``explain()`` profile yet and
  persists ``profile: None``, as the JAX reader does when its profile
  fails.
* :func:`roofline_seeds`: the persisted actuator values, and the
  roofline ``X = min_i p_i / s_i`` over a persisted profile's operators
  (none without a profile).

Without ``autotune_config.placement`` all three are no-ops.
"""
from __future__ import annotations

from typing import Optional

from petastorm_tpu_torch.plan.cache import PlanCache, PlanKey
from petastorm_tpu_torch.plan.plan import PipelinePlan

__all__ = ["consult_plan_cache", "record_trial_outcome", "roofline_seeds"]


def _placement_opted_in(kwargs: dict) -> bool:
    if not kwargs.get("autotune"):
        return False
    return bool(getattr(kwargs.get("autotune_config"), "placement", False))


def roofline_seeds(record: dict) -> dict:
    """``{"actuators": {...}, "roofline": {...}}`` of a persisted record:
    the run's converged knob values (not the placement), and the
    bottleneck operator of its profile, if it has one."""
    seeds: dict = {}
    actuators = record.get("actuators")
    if isinstance(actuators, dict) and actuators:
        seeds["actuators"] = {name: int(value) for name, value in actuators.items()
                              if isinstance(value, (int, float)) and name != "placement"}
    profile = record.get("profile") or {}
    rates = {}
    for op_id, cost in (profile.get("operators") or {}).items():
        service = cost.get("service_per_row_s")
        if service:
            rates[op_id] = max(1, int(cost.get("parallelism", 1))) / float(service)
    if rates:
        bottleneck = min(rates, key=rates.get)
        seeds["roofline"] = {"projected_rows_per_s": round(rates[bottleneck], 3),
                             "bottleneck": bottleneck}
    return seeds


def consult_plan_cache(plan: PipelinePlan, kwargs: dict, *, schema_field_names=None,
                       cache: Optional[PlanCache] = None) -> None:
    """The warm-start consult (see the module docstring): changes ``plan``
    only on a valid hit, and records the outcome in ``plan.cache``."""
    if not _placement_opted_in(kwargs):
        plan.cache = "off"
        return
    if plan.pool_type not in ("thread", "process"):
        # A dummy pool is an explicit inline choice the optimizer keeps.
        plan.cache = "ineligible"
        return
    plan.key = PlanKey.for_dataset(kwargs.get("dataset_url") or kwargs.get("dataset_url_or_urls"),
                                   schema_field_names)
    cache = cache or PlanCache()
    if not cache.enabled:
        plan.cache = "disabled"
        return
    record = cache.load(plan.key)
    if record is None:
        plan.cache = "miss"
        return
    plan.cache = "hit"
    backend = record["backend"]
    if backend != plan.placement.get("decode"):
        plan.placement["decode"] = backend
        decode = plan.operators.get("decode")
        if decode is not None:
            decode.placement = backend
            # The transport operator exists exactly when decode is spawned.
            if backend == "process" and "transport" not in plan.operators:
                from petastorm_tpu_torch.plan.lowering import transport_node
                plan.operators["transport"] = transport_node({"persisted_plan": backend})
            elif backend != "process":
                plan.operators.pop("transport", None)
    plan.source = "persisted"
    plan.trial = record.get("trial")
    plan.capacity_seeds = roofline_seeds(record)


def record_trial_outcome(plan: PipelinePlan, outcome: dict, *,
                         actuators: Optional[dict] = None, profile: Optional[dict] = None,
                         cache: Optional[PlanCache] = None) -> bool:
    """Persist a resolved placement trial under ``plan.key`` (the plan's
    source and trial are updated either way); whether the record landed."""
    plan.source = "trial"
    plan.trial = dict(outcome)
    if plan.key is None:
        return False
    cache = cache or PlanCache()
    record = {"backend": outcome.get("backend"), "trial": dict(outcome),
              "actuators": dict(actuators or {}), "profile": profile}
    return cache.store(plan.key, record)
