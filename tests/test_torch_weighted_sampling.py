"""``WeightedSamplingReader`` of petastorm_tpu_torch against the JAX
package's.

* The pick sequence equals the JAX mixer's draw for draw for the same seed,
  probabilities and ``start_step``, across the 256-draw block edges.
* Over real deterministic readers the mixture's stream is the JAX
  mixture's, by batch and by row.
* Members of mixed order, schema, NGram kind or batching are refused.
* ``state_dict`` / ``resume_states`` round-trip: the resumed mixture is
  the rest of the uninterrupted one; ``report()`` counts the draws and the
  starved pick under the JAX names.
"""
import numpy as np
import pytest
import torch

from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.weighted_sampling_reader import \
    WeightedSamplingReader as JaxWeightedSamplingReader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader


class _Tagged:
    """An endless member that yields its own index."""

    schema = "schema"
    ngram = None
    batched_output = False
    sample_order = "deterministic"
    last_row_consumed = False

    def __init__(self, tag):
        self.tag = tag

    def __next__(self):
        return self.tag

    def next_batch(self):
        return self.tag

    def state_dict(self):
        return {"tag": self.tag}

    def stop(self):
        pass

    def join(self):
        pass


@pytest.mark.parametrize("seed,probabilities,start_step", [
    (21, [0.6, 0.4], 0),
    (7, [1, 2, 3, 4], 200),
    (2 ** 32 + 5, [0.7, 0.3], 255),
    (0, [5, 0, 1], 511),
], ids=["two members", "four from 200", "seed past 32 bits", "a zero weight"])
def test_pick_sequence_equals_jax(seed, probabilities, start_step):
    n = len(probabilities)
    port = WeightedSamplingReader([_Tagged(i) for i in range(n)], probabilities, seed=seed,
                                  start_step=start_step)
    ref = JaxWeightedSamplingReader([_Tagged(i) for i in range(n)], probabilities, seed=seed,
                                    start_step=start_step)
    got = [next(port) for _ in range(300)] + [port.next_batch() for _ in range(300)]
    want = [next(ref) for _ in range(300)] + [ref.next_batch() for _ in range(300)]
    assert got == want
    assert port.state_dict() == ref.state_dict()
    counts = np.bincount(got, minlength=n) / len(got)
    weights = np.asarray(probabilities, float) / sum(probabilities)
    assert np.abs(counts - weights).max() < 0.07
    # Resumed at any step, the draws are the uninterrupted ones.
    for k in (1, 56, 57, 300):
        again = WeightedSamplingReader([_Tagged(i) for i in range(n)], probabilities, seed=seed,
                                       start_step=start_step + k)
        assert [next(again) for _ in range(40)] == got[k:k + 40]


def _batch_member(factory, url, **extra):
    return factory(url, schema_fields=["id"], reader_pool_type="dummy", num_epochs=2,
                   sample_order="deterministic", seed=9, **extra)


def _take_batches(mix, n):
    return [[int(v) for v in mix.next_batch()["id"]] for _ in range(n)]


def test_batch_mixture_equals_jax_and_resumes(scalar_dataset):
    url = scalar_dataset.url
    with JaxWeightedSamplingReader([_batch_member(jax_make_batch_reader, url)
                                    for _ in range(2)], [0.6, 0.4], seed=21) as mix:
        want = _take_batches(mix, 16)
    with WeightedSamplingReader([_batch_member(make_batch_reader, url) for _ in range(2)],
                                [0.6, 0.4], seed=21) as mix:
        full = _take_batches(mix, 16)
        assert mix.sample_order == "deterministic"
    assert full == want

    with WeightedSamplingReader([_batch_member(make_batch_reader, url) for _ in range(2)],
                                [0.6, 0.4], seed=21) as mix:
        first = _take_batches(mix, 7)
        state = mix.state_dict()
    assert state["step"] == 7 and state["seed"] == 21 and len(state["readers"]) == 2
    members = [make_batch_reader(url, schema_fields=["id"], reader_pool_type="thread",
                                 workers_count=2, num_epochs=2, sample_order="deterministic",
                                 resume_state=part)
               for part in WeightedSamplingReader.resume_states(state)]
    with WeightedSamplingReader(members, [0.6, 0.4], seed=state["seed"],
                                start_step=state["step"]) as mix:
        rest = _take_batches(mix, 9)
    assert first + rest == full


def test_row_mixture_of_one_row_groups_equals_jax_and_resumes(synthetic_dataset):
    """Row mixing: each member's cursor backs up over a group read in part,
    so the resumed mixture repeats those rows; with the cut after whole
    groups it is exactly the rest."""
    from petastorm_tpu.reader import make_reader as jax_make_reader

    def members(factory, **extra):
        return [factory(synthetic_dataset.url, schema_fields=["id"], reader_pool_type="dummy",
                        num_epochs=1, sample_order="deterministic", seed=s, shuffle_window=3,
                        **extra) for s in (1, 2)]
    with JaxWeightedSamplingReader(members(jax_make_reader),
                                   [0.5, 0.5], seed=4) as mix:
        want = [int(next(mix).id) for _ in range(120)]
    with WeightedSamplingReader(members(make_reader), [0.5, 0.5], seed=4) as mix:
        got = [int(next(mix).id) for _ in range(120)]
        report = mix.report()
        counters = mix.counters
    assert got == want
    assert sum(m["draws"] for m in report["members"]) == 120 == report["step"]
    assert counters["mixer.m0.draws_total"] + counters["mixer.m1.draws_total"] == 120
    assert set(counters) == {f"mixer.m{i}.{name}" for i in (0, 1)
                             for name in ("draws_total", "starved_total", "lag_s")}


def test_starved_member_ends_the_mixture():
    class Finite(_Tagged):
        def __init__(self, tag, n):
            super().__init__(tag)
            self.n = n

        def __next__(self):
            if self.n == 0:
                self.last_row_consumed = True
                raise StopIteration
            self.n -= 1
            return self.tag

    mix = WeightedSamplingReader([Finite(0, 3), Finite(1, 1000)], [0.5, 0.5], seed=1)
    got = list(mix)
    assert got.count(0) == 3 and mix.last_row_consumed
    report = mix.report()
    assert report["members"][0]["starved"] == 1 and report["members"][0]["exhausted"]
    assert sum(m["draws"] for m in report["members"]) == len(got) + 1


def test_mixed_order_and_mismatched_members_are_refused(synthetic_dataset, scalar_dataset):
    url = synthetic_dataset.url
    det = make_reader(url, reader_pool_type="dummy", sample_order="deterministic", seed=1)
    free = make_reader(url, reader_pool_type="dummy", seed=1, shuffle_row_groups=False)
    narrow = make_reader(url, schema_fields=["id"], reader_pool_type="dummy")
    batched = make_batch_reader(scalar_dataset.url, reader_pool_type="dummy")
    try:
        with pytest.raises(ValueError, match="deterministic"):
            WeightedSamplingReader([det, free], [0.5, 0.5], seed=0)
        with pytest.raises(ValueError, match="schema"):
            WeightedSamplingReader([det, narrow], [0.5, 0.5], seed=0)
        with pytest.raises(ValueError, match="batched"):
            class Batched(_Tagged):
                batched_output = True
            WeightedSamplingReader([_Tagged(0), Batched(1)], [1, 1])
        with pytest.raises(ValueError, match="ngram"):
            class WithNGram(_Tagged):
                ngram = object()
            WeightedSamplingReader([_Tagged(0), WithNGram(1)], [1, 1])
        with pytest.raises(ValueError, match="equal length"):
            WeightedSamplingReader([det], [0.5, 0.5])
        with pytest.raises(ValueError, match="positive"):
            WeightedSamplingReader([det], [0])
    finally:
        for r in (det, free, narrow, batched):
            r.stop()
            r.join()


def test_unseeded_mix_mints_and_records_a_seed():
    mix = WeightedSamplingReader([_Tagged(0), _Tagged(1)], [1, 1])
    next(mix)
    state = mix.state_dict()
    assert 0 <= state["seed"] < 2 ** 32 and state["step"] == 1
    assert state["readers"] == [{"tag": 0}, {"tag": 1}]
    assert WeightedSamplingReader.resume_states(state) == state["readers"]


def test_checkpoint_manager_keeps_the_mixture_and_its_members_cursors(tmp_path, scalar_dataset):
    """``CheckpointManager.save(loader=...)`` over a mixer of deterministic
    batch readers stores the mixer's ``seed`` and ``step`` and each member's
    deterministic cursor; restored, they resume the mixture's batches."""
    from petastorm_tpu_torch.loader import CheckpointManager

    url = scalar_dataset.url

    def mixture(states=None, step=0):
        members = [make_batch_reader(url, schema_fields=["id"], reader_pool_type="thread",
                                     workers_count=2, num_epochs=2, sample_order="deterministic",
                                     shuffle_window=2, seed=None if states else s,
                                     resume_state=states[i] if states else None)
                   for i, s in enumerate((9, 10))]
        return WeightedSamplingReader(members, [0.7, 0.3], seed=3, start_step=step)

    with mixture() as mix:
        full = _take_batches(mix, 12)
    mgr = CheckpointManager(tmp_path / "ckpt")
    with mixture() as mix:
        head = _take_batches(mix, 5)
        mgr.save(5, {"w": torch.zeros(1)}, reader=mix)
    _, input_state = mgr.restore()
    assert input_state["step"] == 5 and input_state["seed"] == 3
    assert [s["sample_order"] for s in input_state["readers"]] == ["deterministic"] * 2
    with mixture(WeightedSamplingReader.resume_states(input_state), input_state["step"]) as mix:
        rest = _take_batches(mix, 7)
    assert head + rest == full
