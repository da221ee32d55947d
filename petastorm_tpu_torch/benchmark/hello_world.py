"""The reference's hello-world benchmark store, written by the port's writer
(the JAX package's ``benchmark/hello_world.py``).

The schema and the row count of the reference tutorial store: ``id``
int32, ``image1`` (128, 256, 3) PNG, ``array_4d`` uint8 of shape
``(None, 128, 30, None)``; 10 rows, one a row group. The values come from
``np.random.default_rng(seed)`` drawn as the JAX package draws them, so the
two packages' stores decode to the same rows.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema("HelloWorldSchema", [
    UnischemaField("id", np.int32, (), ScalarCodec(np.int32), False),
    UnischemaField("image1", np.uint8, (128, 256, 3), CompressedImageCodec("png"), False),
    UnischemaField("array_4d", np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def generate_hello_world_dataset(output_url: Optional[str] = None, rows_count: int = 10,
                                 seed: int = 0, rows_per_row_group: int = 1) -> str:
    """Write the store and return its URL (default: ``hello_world_dataset``
    in the temporary directory). The defaults give the reference's 10-row
    store of one row a group; ``rows_count=10_000, rows_per_row_group=100``
    a steady-state store, whose throughput is bound by reading and
    decoding rather than by per-row overhead."""
    if output_url is None:
        output_url = f"file://{os.path.join(tempfile.gettempdir(), 'hello_world_dataset')}"
    rng = np.random.default_rng(seed)
    with materialize_dataset_local(output_url, HelloWorldSchema,
                                   rows_per_row_group=rows_per_row_group) as writer:
        for i in range(rows_count):
            writer.write_row({
                "id": np.int32(i),
                "image1": rng.integers(0, 255, (128, 256, 3)).astype(np.uint8),
                "array_4d": rng.integers(0, 255, (4, 128, 30, 3)).astype(np.uint8),
            })
    return output_url
