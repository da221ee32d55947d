"""Shuffle quality: how far a reader's order correlates with the store's."""
from __future__ import annotations

import numpy as np


def compute_correlation_distance(reader_factory, id_field: str = "id",
                                 num_runs: int = 1) -> float:
    """Mean absolute Pearson correlation, over ``num_runs`` fresh readers
    from ``reader_factory()``, between the position of each row in the read
    and its ``id_field``: about 0 when well shuffled, 1 when not shuffled."""
    correlations = []
    for _ in range(num_runs):
        with reader_factory() as reader:
            ids = np.asarray([getattr(s, id_field) for s in reader], dtype=np.float64)
        if len(ids) < 2:
            raise ValueError("Need at least 2 rows to measure shuffle quality")
        correlations.append(abs(np.corrcoef(np.arange(len(ids)), ids)[0, 1]))
    return float(np.mean(correlations))
