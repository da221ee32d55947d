"""PipelinePlan: the executable form of a reader configuration (the JAX
package's ``plan/plan.py``).

``make_reader``/``make_batch_reader`` lower their kwargs
(:mod:`petastorm_tpu_torch.plan.lowering`) into a :class:`PipelinePlan`:
:class:`~petastorm_tpu_torch.explain.spec.OperatorNode` s plus the
decisions taken on them:

* ``placement``: where each placeable operator runs (the decode stage's
  pool backend, the knob the placement trial tunes);
* ``fusions``: the operator fusions the fusion pass applied or declined,
  with the reason (:mod:`petastorm_tpu_torch.plan.fusion`);
* ``source``: where the placement came from: ``"default"`` (the kwargs),
  ``"persisted"`` (a warm start from the plan cache) or ``"trial"`` (this
  run's placement trial);
* ``capacity_seeds``: knob start values from a persisted run
  (:mod:`petastorm_tpu_torch.plan.optimizer`).

:meth:`PipelinePlan.to_dict`/:meth:`~PipelinePlan.from_dict` carry
:data:`PLAN_SCHEMA_VERSION`, the JAX package's: a record of another
version is a plan-cache miss.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from petastorm_tpu_torch.explain.spec import OperatorNode

__all__ = ["PipelinePlan", "PLAN_SCHEMA_VERSION", "PLAN_SOURCES"]

#: Version of the persisted plan shape (operators, placement, fusions,
#: seeds); the JAX package's.
PLAN_SCHEMA_VERSION = 1

#: Where a plan's placement decision came from.
PLAN_SOURCES = ("default", "persisted", "trial")


class PipelinePlan:
    """One reader configuration, lowered to operators and decisions.

    :param operators: data-path and sidecar nodes, upstream first
        (duplicate ids raise)
    :param flavor: ``"row"`` (make_reader) or ``"batch"``
        (make_batch_reader)
    :param placement: placeable operators' placements;
        ``placement["decode"]`` is the pool backend the reader builds
    """

    def __init__(self, operators: List[OperatorNode], *, flavor: str,
                 placement: Optional[Dict[str, str]] = None):
        if flavor not in ("row", "batch"):
            raise ValueError(f"flavor must be 'row' or 'batch', got {flavor!r}")
        self.flavor = flavor
        self.operators: Dict[str, OperatorNode] = {}
        for op in operators:
            if op.op_id in self.operators:
                raise ValueError(f"duplicate operator id {op.op_id!r}")
            self.operators[op.op_id] = op
        self.placement: Dict[str, str] = dict(placement or {})
        #: Fusion-pass outcomes: ``{"name", "operators", "applied",
        #: "reason"}`` a candidate.
        self.fusions: List[dict] = []
        #: ``"default"``, ``"persisted"`` or ``"trial"``.
        self.source: str = "default"
        #: The placement trial's verdict once one resolved (or the persisted
        #: record's on a warm start).
        self.trial: Optional[dict] = None
        #: The plan-cache consult: ``"off"`` (no placement tuning asked
        #: for), ``"ineligible"``, ``"disabled"``, ``"miss"`` or ``"hit"``.
        self.cache: str = "off"
        #: The :class:`~petastorm_tpu_torch.plan.cache.PlanKey` the plan
        #: persists under (None when the cache is off or disabled).
        self.key = None
        #: Warm-start knob values (actuator name -> value) and the roofline
        #: that vetted them.
        self.capacity_seeds: dict = {}
        #: Names of the validation rules the plan-time pass checked.
        self.validated: List[str] = []

    @property
    def pool_type(self) -> str:
        """The decode pool backend the reader builds."""
        return self.placement.get("decode", "thread")

    def fusion_names(self) -> frozenset:
        """Names of the fusions that applied (the workers' ``plan_fusions``)."""
        return frozenset(f["name"] for f in self.fusions if f["applied"])

    def fusion(self, name: str) -> Optional[dict]:
        for f in self.fusions:
            if f["name"] == name:
                return f
        return None

    def operator(self, op_id: str) -> OperatorNode:
        return self.operators[op_id]

    def describe(self) -> dict:
        """The decisions, for ``Reader.plan_report()``: not the node graph."""
        return {
            "flavor": self.flavor,
            "placement": dict(self.placement),
            "source": self.source,
            "trial": dict(self.trial) if self.trial else None,
            "cache": self.cache,
            "key": self.key.to_dict() if self.key is not None else None,
            "fusions": [dict(f) for f in self.fusions],
            "capacity_seeds": dict(self.capacity_seeds),
        }

    def to_dict(self) -> dict:
        return {
            "plan_schema_version": PLAN_SCHEMA_VERSION,
            "flavor": self.flavor,
            "placement": dict(self.placement),
            "source": self.source,
            "trial": dict(self.trial) if self.trial else None,
            "cache": self.cache,
            "key": self.key.to_dict() if self.key is not None else None,
            "fusions": [dict(f) for f in self.fusions],
            "capacity_seeds": dict(self.capacity_seeds),
            "validated": list(self.validated),
            "operators": [op.to_dict() for op in self.operators.values()],
        }

    @classmethod
    def from_dict(cls, payload: dict) -> "PipelinePlan":
        """The plan of a :meth:`to_dict` payload; ``ValueError`` on another
        schema version."""
        version = payload.get("plan_schema_version")
        if version != PLAN_SCHEMA_VERSION:
            raise ValueError(f"plan schema version mismatch: payload has {version!r}, "
                             f"this build speaks {PLAN_SCHEMA_VERSION}")
        ops = [OperatorNode(op_id=od["op_id"], name=od["name"], layer=od["layer"],
                            placement=od["placement"],
                            parallelism=int(od.get("parallelism", 1)),
                            stage=od.get("stage"), kind=od.get("kind", "stage"),
                            capacity=dict(od.get("capacity", {})),
                            induced_by=dict(od.get("induced_by", {})),
                            upstream=tuple(od.get("upstream", ())),
                            downstream=tuple(od.get("downstream", ())))
               for od in payload.get("operators", [])]
        plan = cls(ops, flavor=payload["flavor"], placement=payload.get("placement"))
        plan.source = payload.get("source", "default")
        plan.trial = payload.get("trial")
        plan.cache = payload.get("cache", "off")
        plan.fusions = [dict(f) for f in payload.get("fusions", [])]
        plan.capacity_seeds = dict(payload.get("capacity_seeds", {}))
        plan.validated = list(payload.get("validated", []))
        key = payload.get("key")
        if key:
            from petastorm_tpu_torch.plan.cache import PlanKey
            plan.key = PlanKey.from_dict(key)
        return plan
