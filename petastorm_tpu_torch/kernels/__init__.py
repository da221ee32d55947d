"""Hand-written CUDA kernels: build/load helpers and per-kernel launch counts.

Each kernel wrapper adds one to its entry of :data:`launch_counts` where it
launches its kernel, and nowhere else, so a run can show which kernels its
main path went through.
"""
from typing import Dict

#: Kernel name -> launches since the last :func:`reset_launch_counts`.
launch_counts: Dict[str, int] = {}


def count_launch(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def reset_launch_counts() -> None:
    launch_counts.clear()
