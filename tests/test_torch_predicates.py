"""petastorm_tpu_torch.predicates against the JAX package's predicates on the
same seeded numpy columns: ints, floats with NaN, strings and nulls.
``do_include``, ``do_include_batch``, ``intervals``, the row mask and the
``in_pseudorandom_split`` buckets must be equal."""
import numpy as np
import pytest

import petastorm_tpu.predicates as jp
import petastorm_tpu_torch.predicates as tp
from petastorm_tpu.reader_impl.batch_plane import evaluate_predicate_mask as jax_mask

N = 64
#: One NaN object for both packages' sets (NaN is not equal to another NaN).
NAN = float("nan")


def _columns():
    rng = np.random.default_rng(0)
    floats = rng.standard_normal(N)
    floats[rng.random(N) < 0.2] = np.nan
    f32 = floats.astype(np.float32)
    strings = np.array([f"s{v}" for v in rng.integers(0, 12, N)])
    nullable = [None if rng.random() < 0.25 else int(v) for v in rng.integers(0, 9, N)]
    lists = [list(rng.integers(0, 6, rng.integers(0, 4))) for _ in range(N)]
    return {"i": rng.integers(-20, 20, N), "u": rng.integers(0, 40, N).astype(np.uint16),
            "f": floats, "f32": f32, "s": strings, "n": nullable, "l": lists}


def _in_lambda(pkg):
    return pkg.in_lambda(["i", "f"], _lambda_fn)


def _lambda_fn(values):
    return values["i"] > 0 and not values["f"] != values["f"]


def _in_lambda_state(pkg):
    return pkg.in_lambda(["i"], _lambda_state_fn, state=3)


def _lambda_state_fn(values, state):
    return values["i"] % state == 0


#: name -> a function of a predicates module that makes the case's predicate from it.
CASES = {
    "in_set ints": lambda p: p.in_set({-3, 0, 5, 7.0, 2.5, "x"}, "i"),
    "in_set uint16": lambda p: p.in_set({1, 2, 39, 2 ** 40}, "u"),
    "in_set floats": lambda p: p.in_set({NAN, 0.0, 1}, "f"),
    "in_set strings": lambda p: p.in_set({"s1", "s3", 3}, "s"),
    "in_set nulls": lambda p: p.in_set({None, 2, 4}, "n"),
    "in_range ints": lambda p: p.in_range("i", -5, 6),
    "in_range ints closed": lambda p: p.in_range("i", -5, 6, include_lower=False,
                                                 include_upper=True),
    "in_range floats": lambda p: p.in_range("f", -0.5, 0.5),
    "in_range float32 NaN": lambda p: p.in_range("f32", upper=0.25),
    "in_range strings": lambda p: p.in_range("s", "s2", "s7"),
    "in_range nulls": lambda p: p.in_range("n", 2),
    "in_intersection": lambda p: p.in_intersection({1, 4}, "l"),
    "in_lambda": _in_lambda,
    "in_lambda state": _in_lambda_state,
    "in_negate": lambda p: p.in_negate(p.in_set({1, 2, 3}, "i")),
    "in_negate lambda": lambda p: p.in_negate(_in_lambda(p)),
    "in_reduce all": lambda p: p.in_reduce([p.in_range("i", 0), p.in_set({"s1", "s2"}, "s")],
                                           all),
    "in_reduce any": lambda p: p.in_reduce([p.in_range("f", 1.0), p.in_set({3}, "i")], any),
    "in_reduce opaque": lambda p: p.in_reduce([p.in_range("i", 0), p.in_range("u", 5)], sum),
    "in_reduce with lambda": lambda p: p.in_reduce([p.in_range("i", 0), _in_lambda(p)], all),
    "split ints": lambda p: p.in_pseudorandom_split([0.3, 0.3, 0.4], 1, "i"),
    "split strings": lambda p: p.in_pseudorandom_split([0.5, 0.5], 0, "s"),
    "split floats": lambda p: p.in_pseudorandom_split([0.25, 0.75], 1, "f"),
    "split nulls": lambda p: p.in_pseudorandom_split([0.6, 0.2], 1, "n"),
}


def _rows(columns, fields):
    return [{f: columns[f][i] for f in fields} for i in range(N)]


def _domain(d):
    return None if d is None else (d.values, d.intervals, d.include_null)


@pytest.mark.parametrize("case", sorted(CASES))
def test_predicate_answers_equal_the_jax_predicate(case):
    jax_pred, port_pred = CASES[case](jp), CASES[case](tp)
    assert port_pred.get_fields() == jax_pred.get_fields()
    columns = {f: v for f, v in _columns().items() if f in jax_pred.get_fields()}
    rows = _rows(columns, columns)
    assert [port_pred.do_include(r) for r in rows] == [jax_pred.do_include(r) for r in rows]
    want, got = jax_pred.do_include_batch(columns), port_pred.do_include_batch(columns)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tp.evaluate_predicate_mask(port_pred, columns, N),
                                  jax_mask(jax_pred, columns, N))
    want_iv, got_iv = jax_pred.intervals(), port_pred.intervals()
    assert (got_iv is None) == (want_iv is None)
    if want_iv is not None:
        assert [(f, _domain(d)) for f, d in got_iv] == [(f, _domain(d)) for f, d in want_iv]


@pytest.mark.parametrize("value", [0, 1, -7, 2 ** 62, 3.5, float("nan"), "id-17", "", None,
                                   np.int64(12), np.float32(0.1), b"bytes", (1, 2)])
@pytest.mark.parametrize("buckets", [2, 7, 2 ** 63 - 1])
def test_hash_buckets_are_the_jax_buckets(value, buckets):
    assert tp._hash_bucket(value, buckets) == jp._hash_bucket(value, buckets)


def test_pseudorandom_split_partitions_the_ids_as_the_jax_package_does():
    ids = np.arange(2000)
    fractions = [0.6, 0.25, 0.15]
    port = [np.array([tp.in_pseudorandom_split(fractions, k, "id").do_include({"id": int(i)})
                      for i in ids]) for k in range(3)]
    jax = [np.array([jp.in_pseudorandom_split(fractions, k, "id").do_include({"id": int(i)})
                     for i in ids]) for k in range(3)]
    for p, j in zip(port, jax):
        np.testing.assert_array_equal(p, j)
    assert (np.sum(port, axis=0) == 1).all()


@pytest.mark.parametrize("make", [
    lambda p: p.in_range("x"),
    lambda p: p.in_range("x", 5, 1),
    lambda p: p.in_range("x", 2, 2),
    lambda p: p.in_pseudorandom_split([0.5, 0.5], 2, "x"),
    lambda p: p.in_pseudorandom_split([0.7, 0.7], 0, "x"),
    lambda p: p.in_pseudorandom_split([0.5, 0.5], 0, "x").do_include({"y": 1}),
], ids=["no bound", "upside down", "empty", "subset out of range", "over one", "no key"])
def test_errors_are_the_jax_errors(make):
    with pytest.raises(Exception) as want:
        make(jp)
    with pytest.raises(want.type):
        make(tp)


def test_field_domain_union_and_stats_match():
    class Stats:
        def __init__(self, lo, hi, nulls, rows):
            self.has_min_max, self.min, self.max = lo is not None, lo, hi
            self.null_count, self.num_rows = nulls, rows

    doms = [(tp.FieldDomain(values={1, 5}), jp.FieldDomain(values={1, 5})),
            (tp.FieldDomain(intervals=((0, 3, True, False),), include_null=True),
             jp.FieldDomain(intervals=((0, 3, True, False),), include_null=True)),
            (tp.FieldDomain(), jp.FieldDomain())]
    stats = [Stats(3, 4, 0, 10), Stats(5, 9, 1, 10), Stats(None, None, None, None),
             Stats(0, 0, 10, 10), Stats(3, 3, 0, 4)]
    for (pa_, ja_) in doms:
        for (pb, jb) in doms:
            assert _domain(pa_.union(pb)) == _domain(ja_.union(jb))
        for st in stats:
            assert pa_.admits_stats(st) == ja_.admits_stats(st)


def test_mask_refuses_a_short_kernel_answer():
    class Short(tp.PredicateBase):
        def get_fields(self):
            return {"i"}

        def do_include_batch(self, columns):
            return np.ones(3, bool)

    with pytest.raises(ValueError):
        tp.evaluate_predicate_mask(Short(), {"i": np.arange(5)}, 5)
