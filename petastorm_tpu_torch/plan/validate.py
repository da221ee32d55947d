"""Plan-time kwarg validation: the readers' mutual-exclusion rules in one
pass, with the JAX package's messages (its ``plan/validate.py``).

Each rule of :data:`CONFLICT_RULES` names the kwargs in conflict and the
operators they induce. The JAX package's rule over a kwarg the port does
not take (``serializer=``) is left out. ``Reader.__init__`` runs the same
pass, so a direct ``Reader(...)`` gets the same messages.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["CONFLICT_RULES", "ValidationRule", "validate_reader_config"]


class ValidationRule:
    """:param name: the rule's id (recorded in ``plan.validated``)
    :param kwargs: the kwargs in conflict (named in the message)
    :param operators: the operator ids they induce
    :param check: ``cfg -> None | str``, the message's detail when the rule
        fires"""

    def __init__(self, name: str, kwargs: tuple, operators: tuple, check):
        self.name = name
        self.kwargs = kwargs
        self.operators = operators
        self.check = check

    def error(self, detail: str) -> str:
        ops = " + ".join(self.operators)
        kws = " and ".join(self.kwargs)
        return (f"{kws} conflict at plan time: {detail} "
                f"[operators: {ops}; see the lowering table in "
                f"docs/plan.md]")


def _subset_x_shard(cfg):
    if cfg.get("rowgroup_subset") is not None and cfg.get("cur_shard") is not None:
        return ("mutually exclusive — an explicit ordinal subset IS a "
                "shard assignment (the mesh layer computes it with the "
                "same index %% shard_count arithmetic; docs/mesh.md)")
    return None


def _subset_x_shuffle(cfg):
    if cfg.get("rowgroup_subset") is not None and cfg.get("shuffle_row_groups"):
        return ("rowgroup_subset delivers row groups in exactly the given "
                "order; pass shuffle_row_groups=False and shuffle the "
                "ordinal list itself instead (docs/mesh.md)")
    return None


def _refresh_x_subset(cfg):
    if cfg.get("refresh_interval_s") is not None and cfg.get("rowgroup_subset") is not None:
        return ("mutually exclusive — an explicit ordinal plan is frozen "
                "by construction; the mesh layer folds growth into its own "
                "shard plans (MeshDataLoader.admit_growth, docs/mesh.md)")
    return None


def _refresh_x_shard_seed(cfg):
    if cfg.get("refresh_interval_s") is not None and cfg.get("shard_seed") is not None:
        return ("cannot compose — a shard_seed pre-shuffled shard "
                "partition reorders on every new file, so growth could "
                "not extend monotonically (docs/live_data.md)")
    return None


def _memcache_x_diskcache(cfg):
    if cfg.get("memory_cache_size_bytes") and cfg.get("cache_type") not in (None, "null"):
        return (f"mutually exclusive with cache_type="
                f"{cfg.get('cache_type')!r}: the memory tier caches "
                f"decoded payloads, the disk tier raw ones — pick the "
                f"tier matching where the time goes (docs/autotune.md)")
    return None


def _window_x_order(cfg):
    window = int(cfg.get("shuffle_window") or 0)
    if window and cfg.get("sample_order", "free") != "deterministic":
        return ("shuffle_window is the deterministic plane's "
                "window-shuffle mode; pass sample_order='deterministic' "
                "with it (docs/determinism.md)")
    return None


#: The mutual-exclusion table, in check order: the pass raises on the
#: first violation.
CONFLICT_RULES = (
    ValidationRule("rowgroup_subset_x_cur_shard",
                   ("rowgroup_subset", "cur_shard/shard_count"),
                   ("ventilate",), _subset_x_shard),
    ValidationRule("rowgroup_subset_x_shuffle_row_groups",
                   ("rowgroup_subset", "shuffle_row_groups"),
                   ("ventilate",), _subset_x_shuffle),
    ValidationRule("refresh_x_rowgroup_subset",
                   ("refresh_interval_s", "rowgroup_subset"),
                   ("discovery", "ventilate"), _refresh_x_subset),
    ValidationRule("refresh_x_shard_seed",
                   ("refresh_interval_s", "shard_seed"),
                   ("discovery", "ventilate"), _refresh_x_shard_seed),
    ValidationRule("memory_cache_x_disk_cache",
                   ("memory_cache_size_bytes", "cache_type"),
                   ("cache", "decode"), _memcache_x_diskcache),
    ValidationRule("shuffle_window_x_sample_order",
                   ("shuffle_window", "sample_order"),
                   ("ordered_gate",), _window_x_order),
)


def validate_reader_config(cfg: dict, rules=CONFLICT_RULES) -> List[str]:
    """Every rule over a kwarg dict: ``ValueError`` (naming the kwargs and
    the operators) on the first violation, else the checked rules' names.
    A missing key reads as its default; then the enumerated values."""
    checked = []
    for rule in rules:
        detail = rule.check(cfg)
        if detail is not None:
            raise ValueError(rule.error(detail))
        checked.append(rule.name)
    _validate_enums(cfg)
    return checked


def _validate_enums(cfg: dict) -> None:
    sample_order = cfg.get("sample_order", "free")
    if sample_order not in ("free", "deterministic"):
        raise ValueError(f"sample_order must be 'free' or 'deterministic', "
                         f"got {sample_order!r}")
    window: Optional[int] = cfg.get("shuffle_window")
    if window is not None and int(window) < 0:
        raise ValueError(f"shuffle_window must be >= 0, got {window}")
    materialization = cfg.get("row_materialization", "eager")
    if materialization not in ("eager", "lazy"):
        raise ValueError(f"row_materialization must be 'eager' or 'lazy', "
                         f"got {materialization!r}")
