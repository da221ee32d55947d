"""Kwarg lowering: ``make_reader``/``make_batch_reader`` -> PipelinePlan
(the JAX package's ``plan/lowering.py``).

Every kwarg of the port's two entry points lowers to operators, or to a
plan-time role, by :data:`LOWERING_TABLE`; a test checks that the table
names each of them. Lowering stands up exactly the operators the reader
builds for the same kwargs; only the fusion pass
(:mod:`petastorm_tpu_torch.plan.fusion`, each fusion byte-identical to the
unfused path) and the persisted-placement warm start (with
``autotune_config.placement``; :mod:`petastorm_tpu_torch.plan.optimizer`)
change anything downstream.
"""
from __future__ import annotations

from typing import List, Optional

from petastorm_tpu_torch.explain.spec import OperatorNode, link_chain
from petastorm_tpu_torch.plan.plan import PipelinePlan
from petastorm_tpu_torch.plan.validate import validate_reader_config

__all__ = ["LOWERING_TABLE", "lower_reader_kwargs"]

#: kwarg -> the operator ids it induces or configures. Pseudo-targets:
#: ``plan`` (plan-time row-group selection: filters, sharding, pruning run
#: once, before any operator), ``optimizer`` (the autotune loop),
#: ``telemetry`` (the ops plane's registry sidecars), ``compat``
#: (petastorm's arguments, ignored). The JAX package's rows for kwargs the
#: port does not take are left out.
LOWERING_TABLE = {
    # store identity and planning inputs
    "dataset_url": ("plan",),
    "dataset_url_or_urls": ("plan",),
    "schema_fields": ("decode", "materialize"),
    "storage_options": ("plan", "decode"),
    "filesystem": ("plan", "decode"),
    "filters": ("plan",),
    "rowgroup_selector": ("plan",),
    "rowgroup_pruning": ("plan",),
    "rowgroup_subset": ("plan", "ventilate"),
    "rowgroup_coalescing": ("plan", "ventilate"),
    "cur_shard": ("plan",),
    "shard_count": ("plan",),
    "shard_seed": ("plan",),
    # ventilation and ordering
    "shuffle_row_groups": ("ventilate",),
    "num_epochs": ("ventilate",),
    "seed": ("ventilate", "decode", "ordered_gate"),
    "resume_state": ("ventilate", "ordered_gate"),
    "sample_order": ("ordered_gate",),
    "shuffle_window": ("ordered_gate",),
    "shuffle_row_drop_partitions": ("ventilate", "decode"),
    # the decode stage and its resilience
    "reader_pool_type": ("decode", "transport"),
    "workers_count": ("decode",),
    "results_queue_size": ("decode", "transport"),
    "shuffle_rows": ("decode",),
    "predicate": ("plan", "decode"),
    "transform_spec": ("decode",),
    "pool_profiling_enabled": ("decode",),
    "retry_policy": ("decode",),
    "degraded_mode": ("decode",),
    "fault_plan": ("decode",),
    "worker_crash_budget": ("decode",),
    "stage_deadline_s": ("decode",),
    "hedge_policy": ("decode",),
    "hang_timeout_s": ("decode",),
    "convert_early_to_numpy": ("decode", "transport"),
    "row_materialization": ("decode", "materialize"),
    # the fetch stage
    "readahead_depth": ("fetch",),
    "readahead_max_bytes": ("fetch",),
    # transport
    "serializer": ("transport",),
    # caches
    "cache_type": ("cache",),
    "cache_location": ("cache",),
    "cache_size_limit": ("cache",),
    "cache_row_size_estimate": ("cache",),
    "cache_extra_settings": ("cache",),
    "memory_cache_size_bytes": ("cache",),
    # live data
    "refresh_interval_s": ("discovery",),
    # the control loop
    "autotune": ("optimizer",),
    "autotune_config": ("optimizer",),
    # the ops plane (registry sidecars, no data-path operator)
    "timeline_interval_s": ("telemetry",),
    "timeline_anomaly": ("telemetry",),
    "telemetry_publish": ("telemetry",),
    "tenant": ("telemetry",),
    # petastorm's arguments, accepted for compatibility, warned about, ignored
    "hdfs_driver": ("compat",),
    "pyarrow_serialize": ("compat",),
}


def _induced(kwargs: dict, *names) -> dict:
    """A node's ``induced_by``: the listed kwargs at their values."""
    return {n: kwargs.get(n) for n in names if n in kwargs}


def lower_reader_kwargs(flavor: str, kwargs: dict, *,
                        schema_field_names: Optional[list] = None,
                        ngram: bool = False) -> PipelinePlan:
    """One entry point's kwargs as a :class:`PipelinePlan`: the validation
    pass (conflicts raise here), the operators, the fusion pass, then the
    plan-cache consult (only with ``autotune_config.placement``).

    :param flavor: ``"row"`` or ``"batch"``
    :param kwargs: the entry point's kwargs, defaults resolved
    :param schema_field_names: the sorted output field names (part of the
        plan cache's dataset fingerprint)
    :param ngram: ``schema_fields`` is an NGram (no mask fusion)
    """
    validated = validate_reader_config(kwargs)
    pool_type = kwargs.get("reader_pool_type", "thread")
    ops: List[OperatorNode] = []
    refresh = kwargs.get("refresh_interval_s")
    if refresh is not None:
        ops.append(OperatorNode(
            op_id="discovery", name="dataset discovery watcher", layer="L5",
            placement="background" if refresh > 0 else "consumer", kind="sidecar",
            capacity={"poll_interval_s": refresh},
            induced_by=_induced(kwargs, "refresh_interval_s"), downstream=("ventilate",)))
    ops.append(OperatorNode(
        op_id="ventilate", name="row-group ventilation", layer="L3", placement="ventilator",
        induced_by=_induced(kwargs, "shuffle_row_groups", "seed", "num_epochs",
                            "rowgroup_coalescing", "shuffle_row_drop_partitions")))

    readahead_depth = kwargs.get("readahead_depth")
    if readahead_depth and pool_type != "process":
        ops.append(OperatorNode(
            op_id="fetch", name="async readahead fetch", layer="L3", placement="fetcher",
            parallelism=min(2, int(readahead_depth)), stage="fetch",
            capacity={"depth": int(readahead_depth)},
            induced_by=_induced(kwargs, "readahead_depth", "readahead_max_bytes")))

    worker = "BatchReaderWorker" if flavor == "batch" else "RowReaderWorker"
    pool_placement = "inline" if pool_type == "dummy" else pool_type
    workers = int(kwargs.get("workers_count", 4)) if pool_type != "dummy" else 1
    ops.append(OperatorNode(
        op_id="decode", name=f"row-group read+decode ({worker})", layer="L2",
        placement=pool_placement, parallelism=workers, stage="decode",
        capacity={"workers_count": workers,
                  "results_queue_capacity": int(kwargs.get("results_queue_size", 50))},
        induced_by=dict(
            _induced(kwargs, "reader_pool_type", "workers_count", "row_materialization"),
            # Objects by type: induced_by stays JSON-safe.
            **({"predicate": type(kwargs["predicate"]).__name__}
               if kwargs.get("predicate") is not None else {}),
            **({"transform_spec": "batched"
                if getattr(kwargs.get("transform_spec"), "batched", False) else "per_row"}
               if kwargs.get("transform_spec") is not None else {}))))

    if kwargs.get("memory_cache_size_bytes"):
        ops.append(OperatorNode(
            op_id="cache", name="row-group cache (InMemoryRowGroupCache)", layer="L3",
            placement=pool_placement, kind="sidecar",
            capacity={"size_limit_bytes": kwargs.get("memory_cache_size_bytes")},
            induced_by=_induced(kwargs, "memory_cache_size_bytes"), downstream=("decode",)))
    elif kwargs.get("cache_type") not in (None, "null"):
        ops.append(OperatorNode(
            op_id="cache", name="row-group cache (LocalDiskCache)", layer="L3",
            placement=pool_placement, kind="sidecar",
            capacity={"size_limit_bytes": kwargs.get("cache_size_limit")},
            induced_by=_induced(kwargs, "cache_type", "cache_location", "cache_size_limit"),
            downstream=("decode",)))

    if pool_type == "process":
        ops.append(transport_node(dict(
            _induced(kwargs, "reader_pool_type"),
            **({"serializer": type(kwargs["serializer"]).__name__}
               if kwargs.get("serializer") is not None else {}))))

    if kwargs.get("sample_order", "free") == "deterministic":
        ops.append(OperatorNode(
            op_id="ordered_gate", name="ordered delivery gate", layer="L3",
            placement="consumer",
            capacity={"shuffle_window": int(kwargs.get("shuffle_window") or 0)},
            induced_by=_induced(kwargs, "sample_order", "shuffle_window")))

    materialization = kwargs.get("row_materialization", "eager")
    ops.append(OperatorNode(
        op_id="materialize",
        name=("columnar batch view" if flavor == "batch"
              else f"{materialization} row materialization"),
        layer="L5", placement="consumer",
        capacity={"mode": "batched" if flavor == "batch" else materialization},
        induced_by=_induced(kwargs, "row_materialization")))
    link_chain(ops)

    plan = PipelinePlan(ops, flavor=flavor, placement={"decode": pool_type})
    plan.validated = validated

    from petastorm_tpu_torch.plan.fusion import apply_fusions
    apply_fusions(plan, kwargs, ngram=ngram)

    from petastorm_tpu_torch.plan.optimizer import consult_plan_cache
    consult_plan_cache(plan, kwargs, schema_field_names=schema_field_names)
    return plan


def transport_node(induced_by: dict) -> OperatorNode:
    """The process pool's transport operator: the shared-memory rings."""
    return OperatorNode(op_id="transport", name="shm ring transport", layer="L3",
                        placement="consumer", stage="transport", induced_by=induced_by)
