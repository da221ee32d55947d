"""Token store for the LLM pipeline: token store -> NGram windows ->
DataLoader -> Llama.

:func:`write_token_store` writes the store the JAX package's
``benchmark/llm_bench.py`` writes, row for row and row group for row group,
from the same seed.
"""
from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

TOKEN_SCHEMA = Unischema("TokSchema", [
    UnischemaField("ts", np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField("token", np.int32, (), ScalarCodec(np.int32), False),
])


def write_token_store(url: str, windows: int, window: int,
                      vocab: int = 32000, seed: int = 0) -> None:
    """Timestamped token store, one NGram window per row group (windows
    never cross row groups): row ``i`` holds ``ts = i`` and a token drawn
    from ``np.random.default_rng(seed)``. The tokens are drawn in one call;
    numpy's generator gives the same values as one draw per row."""
    n = windows * window
    tokens = np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)
    with materialize_dataset_local(url, TOKEN_SCHEMA, rows_per_row_group=window) as w:
        for i in range(n):
            w.write_row({"ts": np.int64(i), "token": tokens[i]})
