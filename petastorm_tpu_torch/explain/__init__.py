"""The reader's operator graph. Only the node schema the planning layer
(:mod:`petastorm_tpu_torch.plan`) builds its plans from is here so far:
:class:`~petastorm_tpu_torch.explain.spec.OperatorNode`."""
from petastorm_tpu_torch.explain.spec import OperatorNode

__all__ = ["OperatorNode"]
