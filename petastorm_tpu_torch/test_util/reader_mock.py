"""``ReaderMock``: a reader of synthetic rows for a schema, with no I/O (the
JAX package's ``test_util/reader_mock.py``)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from petastorm_tpu_torch.unischema import Unischema


def schema_data_generator_example(schema: Unischema, seed: int = 0) -> Callable:
    """A function of the schema giving random rows that match it."""
    from petastorm_tpu_torch.test_util.generator import random_row_for_schema
    rng = np.random.default_rng(seed)

    def generate(schema_):
        return random_row_for_schema(schema_, rng)
    return generate


class ReaderMock:
    """Yields rows of ``schema`` forever, or ``num_rows`` times.

    :param schema: the Unischema to fake
    :param data_generator: ``f(schema) -> row dict``; random rows by default
    :param num_rows: rows of a pass (None: endless)
    """

    def __init__(self, schema: Unischema, data_generator: Optional[Callable] = None,
                 num_rows: Optional[int] = None):
        self.schema = schema
        self.ngram = None
        self.batched_output = False
        self.last_row_consumed = False
        self._generate = data_generator or schema_data_generator_example(schema)
        self._num_rows = num_rows
        self._produced = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._num_rows is not None and self._produced >= self._num_rows:
            self.last_row_consumed = True
            raise StopIteration
        self._produced += 1
        return self.schema.make_namedtuple_from_dict(self._generate(self.schema))

    def state_dict(self):
        """A mock has no position to resume (the loaders ask for one)."""
        return None

    def reset(self):
        self._produced = 0
        self.last_row_consumed = False

    def stop(self):
        pass

    def join(self):
        pass

    @property
    def diagnostics(self):
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
