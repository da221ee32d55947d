"""The operator-node schema of the JAX package's ``explain/spec.py``: one
node of a reader's operator graph (name, layer, placement, parallelism,
capacities, the kwargs that induced it, its edges). The planning layer
(:mod:`petastorm_tpu_torch.plan`) lowers reader kwargs into these nodes;
the same ``to_dict`` form round-trips through the plan cache, so a plan
written by either package reads in the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["OperatorNode"]


@dataclass
class OperatorNode:
    """One operator in the pipeline graph.

    ``stage`` names the critical-path stage this operator's time counts
    under (``fetch``, ``decode``, ``transport``...), or None for
    coordination operators (ventilation, ordering, row materialization).
    ``kind`` is ``"stage"`` for operators on the data path and
    ``"sidecar"`` for operators that serve one (a cache serving decode).
    """
    op_id: str
    name: str
    layer: str
    placement: str
    parallelism: int = 1
    stage: Optional[str] = None
    kind: str = "stage"
    capacity: dict = field(default_factory=dict)
    induced_by: dict = field(default_factory=dict)
    upstream: Tuple[str, ...] = ()
    downstream: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {
            "op_id": self.op_id, "name": self.name, "layer": self.layer,
            "placement": self.placement, "parallelism": self.parallelism,
            "stage": self.stage, "kind": self.kind,
            "capacity": dict(self.capacity),
            "induced_by": dict(self.induced_by),
            "upstream": list(self.upstream),
            "downstream": list(self.downstream),
        }


def link_chain(ops: List[OperatorNode]) -> None:
    """Wire upstream/downstream edges along the data path, in list order
    (sidecars stay off the chain)."""
    chain = [op for op in ops if op.kind == "stage"]
    for prev, nxt in zip(chain, chain[1:]):
        prev.downstream = prev.downstream + (nxt.op_id,)
        nxt.upstream = nxt.upstream + (prev.op_id,)
