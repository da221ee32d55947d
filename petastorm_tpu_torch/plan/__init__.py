"""Executable pipeline plans (the JAX package's ``plan/``).

``make_reader``/``make_batch_reader`` lower their kwargs
(:mod:`~petastorm_tpu_torch.plan.lowering`) into a
:class:`~petastorm_tpu_torch.plan.plan.PipelinePlan`: one plan-time
validation pass (:mod:`~petastorm_tpu_torch.plan.validate`), operator
fusions byte-identical to the unfused path
(:mod:`~petastorm_tpu_torch.plan.fusion`), and an optimizer
(:mod:`~petastorm_tpu_torch.plan.optimizer`) that persists winning
placements per (dataset fingerprint, store type, host)
(:mod:`~petastorm_tpu_torch.plan.cache`), so a warm start skips the
placement trial.
"""
from petastorm_tpu_torch.plan.cache import (DEFAULT_PLAN_TTL_S, PLAN_CACHE_ENV,
                                            PLAN_CACHE_TTL_ENV, PlanCache, PlanKey,
                                            plan_cache_dir)
from petastorm_tpu_torch.plan.fusion import (FUSION_DECODE_TRANSPORT, FUSION_MASK_DECODE,
                                             PLAN_FUSION_ENV, apply_fusions, fusions_enabled)
from petastorm_tpu_torch.plan.lowering import LOWERING_TABLE, lower_reader_kwargs
from petastorm_tpu_torch.plan.optimizer import (consult_plan_cache, record_trial_outcome,
                                                roofline_seeds)
from petastorm_tpu_torch.plan.plan import PLAN_SCHEMA_VERSION, PLAN_SOURCES, PipelinePlan
from petastorm_tpu_torch.plan.validate import (CONFLICT_RULES, ValidationRule,
                                               validate_reader_config)

__all__ = [
    "PipelinePlan", "PLAN_SCHEMA_VERSION", "PLAN_SOURCES",
    "LOWERING_TABLE", "lower_reader_kwargs",
    "CONFLICT_RULES", "ValidationRule", "validate_reader_config",
    "FUSION_MASK_DECODE", "FUSION_DECODE_TRANSPORT", "PLAN_FUSION_ENV",
    "apply_fusions", "fusions_enabled",
    "PlanCache", "PlanKey", "plan_cache_dir", "PLAN_CACHE_ENV",
    "PLAN_CACHE_TTL_ENV", "DEFAULT_PLAN_TTL_S",
    "consult_plan_cache", "record_trial_outcome", "roofline_seeds",
]
