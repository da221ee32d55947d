"""Mix several readers into one stream with given sampling probabilities
(the JAX package's ``weighted_sampling_reader.py``).

Every pick is drawn from a generator keyed by ``(seed, step)``, a function
of the mix position and not of a stream's state, so a resumed mixture
replays the same picks from its recorded ``step``. The draws come in blocks
of 256 from ``default_rng([seed, step // 256, _MIX_STREAM])``, bit for bit
the JAX package's, so both packages pick the same members. With no seed one
is minted and recorded in ``state_dict``.

Starvation telemetry, per member ``i``, on the mixer's own registry
(``mixer.telemetry``; the members keep theirs) under the JAX names: the
counters ``mixer.m{i}.draws_total`` (picks) and ``mixer.m{i}.starved_total``
(picks that met an exhausted member: the draw that ended the mixture) and
the gauge ``mixer.m{i}.lag_s`` (seconds since the member last delivered),
rolled up by :meth:`WeightedSamplingReader.report`: a growing member that
lags shows before it stalls the mixture.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from petastorm_tpu_torch.reader_impl.epoch_plan import mint_seed
from petastorm_tpu_torch.telemetry import make_registry

#: Extra entropy word: the mixer's (seed, step) streams never collide with
#: the readers' (seed, epoch, position) shuffle streams.
_MIX_STREAM = 0x301C

#: Draws per generator: block ``step // _DRAW_BLOCK`` is regenerated on a
#: resume, and a draw costs an index into it.
_DRAW_BLOCK = 256


class WeightedSamplingReader:
    """:param readers: readers to mix (one schema, one NGram kind, all row
        or all batched readers, and all deterministic or all free)
    :param probabilities: relative weights, normalized here
    :param seed: the picks' seed (minted when None, recorded in
        :meth:`state_dict`)
    :param start_step: where the pick sequence resumes (a
        :meth:`state_dict`'s ``step``); the members resume through their own
        ``resume_state`` (:meth:`resume_states`)
    """

    def __init__(self, readers: Sequence, probabilities: Sequence[float],
                 seed: Optional[int] = None, start_step: int = 0):
        if len(readers) != len(probabilities):
            raise ValueError("readers and probabilities must have equal length")
        if not readers:
            raise ValueError("need at least one reader")
        self._readers = list(readers)
        total = float(sum(probabilities))
        if total <= 0:
            raise ValueError("probabilities must sum to a positive value")
        self._cum = np.cumsum([p / total for p in probabilities])
        self._seed = int(mint_seed() if seed is None else seed)
        self._step = int(start_step)
        self._draw_block_idx = -1
        self._draws = None

        first = readers[0]
        for other in readers[1:]:
            if other.schema != first.schema:
                raise ValueError("All readers must share the same output schema")
            if bool(getattr(other, "ngram", None)) != bool(getattr(first, "ngram", None)):
                raise ValueError("Cannot mix ngram and non-ngram readers")
            if (getattr(getattr(other, "ngram", None), "dense", False)
                    != getattr(getattr(first, "ngram", None), "dense", False)):
                raise ValueError("Cannot mix dense and row-format ngram readers: their sample "
                                 "types differ ({name: array} vs {offset: namedtuple})")
            if other.batched_output != first.batched_output:
                raise ValueError("Cannot mix batched and row readers")
        orders = {getattr(r, "sample_order", "free") for r in readers}
        if "deterministic" in orders and orders != {"deterministic"}:
            # The free members reorder under load: the mixture could never
            # be replayed, though the deterministic members promise it.
            raise ValueError("Cannot mix sample_order='deterministic' members with free-order "
                             "ones: the free members' delivery order depends on pool timing, "
                             "so the mixture stream would not be reproducible. Open every "
                             "member with sample_order='deterministic' (or none)")
        self.schema = first.schema
        self.ngram = getattr(first, "ngram", None)
        self.batched_output = first.batched_output
        #: ``'deterministic'`` when every member is: the mixture is then a
        #: function of the members' seeds and the mixer's (seed, step).
        self.sample_order = "deterministic" if orders == {"deterministic"} else "free"
        #: ``'lazy'`` only when every member is: a mix of lazy and eager
        #: members would hand out batches of two kinds.
        self.row_materialization = (
            "lazy" if all(getattr(r, "row_materialization", "eager") == "lazy" for r in readers)
            else "eager")
        self.last_row_consumed = False

        n = len(self._readers)
        self._weights = [float(p) / total for p in probabilities]
        #: The mixer's registry (the members keep theirs).
        self.telemetry = make_registry()
        self._c_draws = [self.telemetry.counter(f"mixer.m{i}.draws_total") for i in range(n)]
        self._c_starved = [self.telemetry.counter(f"mixer.m{i}.starved_total") for i in range(n)]
        self._t0 = time.monotonic()
        #: Monotonic time of each member's last delivery (None: never; its
        #: lag counts from the mixer's creation).
        self._last_served: List[Optional[float]] = [None] * n
        for i in range(n):
            self.telemetry.gauge(f"mixer.m{i}.lag_s", lambda i=i: self._lag_s(i))

    def _lag_s(self, idx: int) -> float:
        last = self._last_served[idx]
        return time.monotonic() - (self._t0 if last is None else last)

    @property
    def counters(self) -> dict:
        """The starvation counters and lags under the JAX names."""
        out = {}
        for i in range(len(self._readers)):
            out[f"mixer.m{i}.draws_total"] = int(self._c_draws[i].value)
            out[f"mixer.m{i}.starved_total"] = int(self._c_starved[i].value)
            out[f"mixer.m{i}.lag_s"] = self._lag_s(i)
        return out

    def report(self) -> dict:
        """Each member's draws, starved picks, seconds since it last
        delivered and normalized weight, with the mix's step and seed."""
        members = [{"index": i, "weight": round(self._weights[i], 6),
                    "draws": int(self._c_draws[i].value),
                    "starved": int(self._c_starved[i].value),
                    "lag_s": round(self._lag_s(i), 3),
                    "exhausted": bool(getattr(r, "last_row_consumed", False))}
                   for i, r in enumerate(self._readers)]
        return {"step": self._step, "seed": self._seed, "members": members}

    def __iter__(self):
        return self

    def _pick(self) -> int:
        """Draw ``step`` of the ``(seed, step)`` sequence: the block holding
        it comes from a generator keyed ``(seed, step // _DRAW_BLOCK)``."""
        block, offset = divmod(self._step, _DRAW_BLOCK)
        if block != self._draw_block_idx:
            rng = np.random.default_rng([self._seed & 0xFFFFFFFF, block, _MIX_STREAM])
            self._draws = rng.random(_DRAW_BLOCK)
            self._draw_block_idx = block
        self._step += 1
        idx = int(np.searchsorted(self._cum, float(self._draws[offset]), side="right"))
        return min(idx, len(self._readers) - 1)

    def _serve(self, take):
        idx = self._pick()
        self._c_draws[idx].add(1)
        try:
            sample = take(self._readers[idx])
        except StopIteration:
            self._c_starved[idx].add(1)
            self.last_row_consumed = True
            raise
        self._last_served[idx] = time.monotonic()
        return sample

    def __next__(self):
        return self._serve(next)

    def next_batch(self):
        """Mix at batch granularity: one pick serves that member's next
        whole batch, untouched (a batched member's ``{column: array}``, a
        lazy member's ``ColumnarBatch``). The weights then apply per batch,
        not per row (the same mixture in expectation for equal row
        groups)."""
        return self._serve(lambda r: r.next_batch())

    def reset(self):
        """Start another pass: reset the exhausted members and the pick
        sequence (another pass replays the same draws)."""
        for r in self._readers:
            if r.last_row_consumed:
                r.reset()
        self._step = 0
        self.last_row_consumed = False

    def state_dict(self) -> dict:
        """Each member's cursor, in order, and the mixer's ``seed`` and
        ``step``: a mix resumed with ``seed=state['seed'],
        start_step=state['step']`` replays the remaining draws while each
        member continues from its cursor. Deterministic members mixed by
        :meth:`next_batch` (or whose units are one sample each) cut on unit
        boundaries and resume the mixture exactly; otherwise a member's unit
        read in part is read again whole."""
        return {"readers": [r.state_dict() for r in self._readers],
                "seed": self._seed, "step": self._step}

    @staticmethod
    def resume_states(state: dict) -> List[dict]:
        """A :meth:`state_dict` split into the members' ``resume_state``s."""
        return list(state["readers"])

    def stop(self):
        for r in self._readers:
            r.stop()

    def join(self):
        for r in self._readers:
            r.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
        return False
