"""The plain reference on a case worked by hand, and its comparison."""

import numpy as np
import pytest

from portbench.reference import numpy_ref

PLAN = [
    {"op": "ffi_reader", "table": "t", "columns": ["k", "q", "p"]},
    {"op": "filter", "predicates": [
        {"binary": "le", "left": {"col": "q"}, "right": {"lit": 50,
                                                     "type": "int32"}},
        {"binary": "gt", "left": {"col": "p"}, "right": {"lit": 10.0,
                                                     "type": "float64"}}]},
    {"op": "project", "exprs": [
        {"name": "k", "expr": {"col": "k"}},
        {"name": "amount", "expr": {"binary": "mul",
                                    "left": {"cast": "float64",
                                             "arg": {"col": "q"}},
                                    "right": {"col": "p"}}},
        {"name": "p", "expr": {"col": "p"}}]},
    {"op": "agg", "modes": ["partial", "final"], "group_by": ["k"],
     "aggs": [
        {"fn": "sum", "arg": {"col": "amount"}, "type": "float64",
         "name": "s"},
        {"fn": "count", "arg": None, "type": "int64", "name": "n"},
        {"fn": "avg", "arg": {"col": "p"}, "type": "float64", "name": "a"},
        {"fn": "min", "arg": {"col": "p"}, "type": "float64", "name": "lo"},
        {"fn": "max", "arg": {"col": "amount"}, "type": "float64",
         "name": "hi"}]},
]

# rows: key (None = null), quantity (None = null), price (None = null)
ROWS = [(7, 2, 12.5),     # kept: amount 25.0
        (7, 60, 20.0),    # quantity > 50: dropped
        (None, 1, 11.0),  # kept in the null group: amount 11.0
        (3, 4, 10.0),     # price not > 10: dropped
        (3, None, 30.0),  # null quantity: dropped
        (7, 3, 15.25),    # kept: amount 45.75
        (3, 5, None),     # null price: dropped
        (3, 10, 40.0),    # kept: amount 400.0
        (None, 2, 20.5)]  # kept in the null group: amount 41.0


def _cols(rows):
    def col(i, dtype):
        vals = np.array([r[i] if r[i] is not None else 0 for r in rows],
                        dtype)
        return vals, np.array([r[i] is not None for r in rows])
    return {"k": col(0, np.int32), "q": col(1, np.int32),
            "p": col(2, np.float64)}


def _eval(cols, plan=PLAN, precision="float64"):
    def columns(table, names):
        assert table == "t"
        return {n: cols[n] for n in names}
    return numpy_ref.evaluate(plan, columns, precision)


def test_reference_matches_the_hand_worked_case():
    out = _eval(_cols(ROWS))
    assert out.keys == ["k"] and out.rel == {"s", "a"}
    keys, key_ok = out.cols["k"]
    # null group first, then keys ascending
    assert key_ok.tolist() == [False, True, True]
    assert keys[key_ok].tolist() == [3, 7]
    a = out.cols
    assert a["n"][0].tolist() == [2, 1, 2]
    assert a["s"][0].tolist() == [52.0, 400.0, 70.75]
    assert a["a"][0].tolist() == [15.75, 40.0, 13.875]
    assert a["lo"][0].tolist() == [11.0, 40.0, 12.5]
    assert a["hi"][0].tolist() == [41.0, 400.0, 45.75]
    for name in ("n", "s", "a", "lo", "hi"):
        assert a[name][1].all()


def _copy(rel):
    return {k: (v.copy(), ok.copy()) for k, (v, ok) in rel.cols.items()}


def test_compare_counts_each_kind_of_difference():
    want = _eval(_cols(ROWS))
    assert numpy_ref.compare(_copy(want), want) == {
        "mismatched": 0.0, "sum_rel_err": 0.0}

    sums = _copy(want)
    sums["s"][0][1] *= 1 + 1e-6
    got = numpy_ref.compare(sums, want)
    assert got["mismatched"] == 0.0
    assert abs(got["sum_rel_err"] - 1e-6) < 1e-12

    counts = _copy(want)
    counts["n"][0][2] += 1
    assert numpy_ref.compare(counts, want)["mismatched"] == 1.0

    extreme = _copy(want)
    extreme["lo"][0][0] += 0.01       # a minimum is held exactly
    assert numpy_ref.compare(extreme, want)["mismatched"] == 1.0

    missing = {k: (v[1:], ok[1:]) for k, (v, ok) in want.cols.items()}
    assert numpy_ref.compare(missing, want)["mismatched"] == 1.0

    twice = {k: (np.concatenate([v, v[:1]]), np.concatenate([ok, ok[:1]]))
             for k, (v, ok) in want.cols.items()}
    assert numpy_ref.compare(twice, want)["mismatched"] == 1.0

    lacking = _copy(want)
    del lacking["hi"]
    assert numpy_ref.compare(lacking, want)["mismatched"] == 3.0


def test_rows_without_keys_are_compared_in_order():
    plan = PLAN[:3]
    want = _eval(_cols(ROWS), plan)
    assert want.keys == [] and want.n == 5
    got = _copy(want)
    assert numpy_ref.compare(got, want)["mismatched"] == 0.0
    swapped = {k: (v[::-1].copy(), ok[::-1].copy())
               for k, (v, ok) in got.items()}
    assert numpy_ref.compare(swapped, want)["mismatched"] == 4.0
    short = {k: (v[:3], ok[:3]) for k, (v, ok) in got.items()}
    assert numpy_ref.compare(short, want)["mismatched"] == 2.0


@pytest.mark.parametrize("op,want_v,want_ok", [
    # left: true, false, null, null; right: null, null, true, false
    ("and", [False, False, False, False], [False, True, False, True]),
    ("or", [True, False, True, False], [True, False, True, False])])
def test_and_or_are_three_valued(op, want_v, want_ok):
    b = np.array([True, False, False, False])
    bv = np.array([True, True, False, False])
    c = np.array([False, False, True, False])
    cv = np.array([False, False, True, True])
    rel = numpy_ref.relation({"b": (b, bv), "c": (c, cv)})
    ctx = numpy_ref.Context(lambda t, n: {})
    v, ok = ctx.expr({"binary": op, "left": {"col": "b"},
                      "right": {"col": "c"}}, rel)
    assert ok.tolist() == want_ok
    assert (v & ok).tolist() == want_v


def test_a_partial_alone_has_no_reference():
    plan = PLAN[:3] + [dict(PLAN[3], modes=["partial"])]
    with pytest.raises(ValueError, match="final"):
        _eval(_cols(ROWS), plan)


def test_sorting_and_direct_grouping_agree():
    rng = np.random.default_rng(5)
    n = 5000
    cols = {"k": (rng.integers(-40, 40, n).astype(np.int32),
                  rng.random(n) > 0.1),
            "q": (rng.integers(1, 101, n).astype(np.int32),
                  rng.random(n) > 0.04),
            "p": (np.round(rng.random(n) * 200, 2), rng.random(n) > 0.04)}
    direct = _eval(cols)
    wide = dict(cols)
    # a key span past DENSE_SLOTS takes the sorting path
    wide["k"] = (cols["k"][0].astype(np.int64) * (1 << 40), cols["k"][1])
    sorted_ = _eval(wide)
    assert np.array_equal(sorted_.cols["k"][0] // (1 << 40),
                          direct.cols["k"][0])
    for name in ("s", "n", "a", "lo", "hi"):
        assert np.array_equal(sorted_.cols[name][0], direct.cols[name][0])


def test_control_in_float32_is_not_the_reference():
    rng = np.random.default_rng(6)
    n = 20000
    cols = {"k": (rng.integers(1, 30, n).astype(np.int32), None),
            "q": (rng.integers(1, 101, n).astype(np.int32), None),
            "p": (np.round(rng.random(n) * 200, 2), None)}
    want = _eval(cols)
    low = _eval(cols, precision="float32")
    got = numpy_ref.compare(low.cols, want)
    assert got["mismatched"] > 0       # float32 minima and maxima
    assert got["sum_rel_err"] > 1e-8
