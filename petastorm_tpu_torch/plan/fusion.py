"""Operator fusions, each byte-identical to the unfused path (the JAX
package's ``plan/fusion.py``). A fusion may change when work happens,
never what comes out.

``mask_decode_transform`` (L2)
    With a worker-side ``predicate`` the unfused row worker reads a group
    twice (the predicate's columns, then the rest, once a row passes) and
    the batch worker likewise; the row worker also decodes the predicate's
    columns twice when they are output columns. Fused: one read of every
    needed column, and the whole-group decode of the predicate's columns
    reused for the output by index selection (every decode is
    cell-independent, so select-then-decode equals decode-then-select).
    Declined for NGram readers, whose windows sort rows across the mask.

``decode_transport`` (L2/L3)
    A batch reader on an in-process pool: the workers turn each Arrow
    table into numpy columns themselves (the same
    ``arrow_table_to_numpy_dict`` call on the same table) and the consumer
    pops ready column dicts. On the process pool the rings' Arrow stream is
    the transport, so spawned workers never get it; a placement migration
    re-decides it, as the reader builds worker args per pool flavor.

``PETASTORM_TPU_PLAN_FUSION=0`` turns every fusion off.
"""
from __future__ import annotations

import os

from petastorm_tpu_torch.plan.plan import PipelinePlan

__all__ = ["FUSION_MASK_DECODE", "FUSION_DECODE_TRANSPORT", "PLAN_FUSION_ENV",
           "apply_fusions", "fusions_enabled"]

#: The workers' ``plan_fusions`` names.
FUSION_MASK_DECODE = "mask_decode_transform"
FUSION_DECODE_TRANSPORT = "decode_transport"

#: ``0``, ``off`` or ``false`` turns every fusion off.
PLAN_FUSION_ENV = "PETASTORM_TPU_PLAN_FUSION"


def fusions_enabled() -> bool:
    return os.environ.get(PLAN_FUSION_ENV, "").strip().lower() not in ("0", "off", "false")


def _record(plan: PipelinePlan, name: str, operators: tuple, applied: bool,
            reason: str) -> None:
    plan.fusions.append({"name": name, "operators": list(operators),
                         "applied": bool(applied), "reason": reason})


def apply_fusions(plan: PipelinePlan, kwargs: dict, *, ngram: bool = False) -> None:
    """Every fusion pass over ``plan``, each candidate recorded applied or
    declined with the reason (the JAX package's reasons, word for word)."""
    enabled = fusions_enabled()

    ops = ("decode",)
    if not enabled:
        _record(plan, FUSION_MASK_DECODE, ops, False, f"disabled via {PLAN_FUSION_ENV}")
    elif kwargs.get("predicate") is None:
        _record(plan, FUSION_MASK_DECODE, ops, False,
                "no worker-side predicate: nothing to fuse")
    elif ngram:
        _record(plan, FUSION_MASK_DECODE, ops, False,
                "NGram readers window across the mask boundary; unfused "
                "path keeps the documented per-row assembly")
    else:
        _record(plan, FUSION_MASK_DECODE, ops, True,
                "one read + one predicate-column decode per row group, "
                "reused for the output by index selection")

    if plan.flavor != "batch":
        return
    ops = ("decode", "transport")
    if not enabled:
        _record(plan, FUSION_DECODE_TRANSPORT, ops, False, f"disabled via {PLAN_FUSION_ENV}")
    elif kwargs.get("convert_early_to_numpy"):
        _record(plan, FUSION_DECODE_TRANSPORT, ops, False,
                "convert_early_to_numpy already moves the conversion into "
                "the workers (the fusion is the kwarg's default-on form)")
    elif plan.pool_type == "process":
        # Recorded for the constructed placement: a migration to threads
        # re-fuses through the in-process worker args.
        _record(plan, FUSION_DECODE_TRANSPORT, ops, True,
                "applies only while decode runs in-process: the process "
                "pool's Arrow IPC serializer is load-bearing (spawned "
                "workers publish tables; a thread-migration re-fuses)")
    else:
        _record(plan, FUSION_DECODE_TRANSPORT, ops, True,
                "producer and consumer share a process: workers convert "
                "Arrow->numpy themselves; the consumer pops ready column "
                "dicts (no serializer, no consumer-side conversion)")
