"""Adaptive tuning of the input pipeline and the decoded row-group cache
(the JAX package's ``petastorm_tpu/autotune``).

* :mod:`~petastorm_tpu_torch.autotune.controller`: a background feedback
  controller that samples the pipeline's registry, diagnoses the stage that
  holds it back and moves clamped knobs with hysteresis;
* :mod:`~petastorm_tpu_torch.autotune.actuators`: the knobs (the thread
  pool's admission gate, the ventilator's in-flight cap, the shuffling
  buffers' targets, the readahead depth, the loaders' prefetch depth);
  ``tools/check_knobs.py`` checks that nothing outside this package calls
  their setters;
* :mod:`~petastorm_tpu_torch.autotune.budget`: the shared byte ledger;
* :mod:`~petastorm_tpu_torch.autotune.mem_cache`: the in-memory decoded
  row-group cache;
* :mod:`~petastorm_tpu_torch.autotune.placement`: the thread-or-process
  knob the controller's placement trial drives.

Turn them on with ``make_reader(..., autotune=True,
memory_cache_size_bytes=...)``. The package imports no torch: spawned
workers unpickle the cache.
"""
from petastorm_tpu_torch.autotune.actuators import (Actuator, PrefetchDepthActuator,
                                                    ReadaheadDepthActuator,
                                                    ShuffleTargetActuator,
                                                    VentilatorDepthActuator,
                                                    WorkerConcurrencyActuator)
from petastorm_tpu_torch.autotune.budget import MemoryBudget, payload_nbytes
from petastorm_tpu_torch.autotune.controller import AutotuneConfig, AutotuneController
from petastorm_tpu_torch.autotune.mem_cache import InMemoryRowGroupCache
from petastorm_tpu_torch.autotune.placement import PlacementActuator

__all__ = [
    "Actuator", "AutotuneConfig", "AutotuneController", "InMemoryRowGroupCache",
    "MemoryBudget", "PlacementActuator", "PrefetchDepthActuator", "ReadaheadDepthActuator",
    "ShuffleTargetActuator", "VentilatorDepthActuator", "WorkerConcurrencyActuator",
    "payload_nbytes",
]
