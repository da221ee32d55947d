"""A FIFO of Arrow tables re-chunked into batches of a fixed row count."""
from __future__ import annotations

from collections import deque

import pyarrow as pa


class BatchingTableQueue:
    """``put`` tables of any size; ``get`` returns tables of exactly
    ``batch_size`` rows, in order (slices and concatenations, no copy of a
    column)."""

    def __init__(self, batch_size: int):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self._batch_size = batch_size
        self._chunks = deque()
        self._rows = 0

    def put(self, table: pa.Table) -> None:
        if table.num_rows:
            self._chunks.append(table)
            self._rows += table.num_rows

    def empty(self) -> bool:
        """True while fewer than ``batch_size`` rows are buffered."""
        return self._rows < self._batch_size

    def get(self) -> pa.Table:
        if self.empty():
            raise RuntimeError("Not enough rows buffered; check empty() first")
        parts = []
        need = self._batch_size
        while need:
            chunk = self._chunks[0]
            if chunk.num_rows <= need:
                parts.append(self._chunks.popleft())
                need -= chunk.num_rows
            else:
                parts.append(chunk.slice(0, need))
                self._chunks[0] = chunk.slice(need)
                need = 0
        self._rows -= self._batch_size
        return pa.concat_tables(parts) if len(parts) > 1 else parts[0]
