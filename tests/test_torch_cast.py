"""The port's casts (blaze_tpu_torch/exprs/cast.py), decimal arithmetic and
the bitwise and shift ops against the JAX package's, on the CPU.

The cast and decimal cases of tests/test_exprs.py, then every arm of the
cast matrix over seeded columns with their edge rows: the int8..int64
bounds, +-0.5 ties, NaN and infinities, dates before 1970 and negative
day numbers, timestamps, narrow and wide decimals (INT64_MIN limbs,
+-(10^38 - 1)), malformed strings, and nulls. Both packages build the
batch from the same host values and evaluate the expression eagerly.
Tolerance: values and validity of the live rows equal bit for bit (NaN
equal to NaN), doubles included; a pair the JAX package refuses must
raise the same exception class in the port.
"""

from decimal import Decimal

import numpy as np
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import ir as jir
from blaze_tpu.exprs.compiler import compile_expr as jcompile
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir as tir
from blaze_tpu_torch.exprs.compiler import compile_expr as tcompile

N = 400


def _dt(T, kind):
    if kind.startswith("dec"):
        p, s = kind[3:].split("_")
        return T.decimal(int(p), int(s))
    return getattr(T, kind)


def _values(kind, rng, n=N):
    """Seeded host values of a kind with its edge rows; None marks
    nulls."""
    if kind == "BOOLEAN":
        v = list(rng.random(n) < 0.5)
    elif kind in ("INT8", "INT16", "INT32", "INT64"):
        it = getattr(np, kind.lower())
        info = np.iinfo(it)
        v = list(rng.integers(info.min, info.max, n, endpoint=True,
                              dtype=np.int64).astype(it))
        v[:6] = [info.min, info.max, 0, -1, 1, 99]
    elif kind in ("FLOAT32", "FLOAT64"):
        ft = np.float32 if kind == "FLOAT32" else np.float64
        v = list((rng.standard_normal(n) * 10 ** rng.integers(0, 20, n))
                 .astype(ft))
        v[:14] = [ft(x) for x in (0.5, -0.5, 1.5, -1.5, 2.5, 0.005, -0.0,
                                  np.nan, np.inf, -np.inf, 1e18, -1e18,
                                  123.456, 2.0 ** 63)]
    elif kind == "DATE":
        v = list(rng.integers(-800_000, 800_000, n).astype(np.int32))
        v[:6] = [0, -1, -719162, 11385, -165, 2932896]
    elif kind == "TIMESTAMP":
        v = list(rng.integers(-2 ** 52, 2 ** 52, n))
        v[:4] = [0, -1, -86_400_000_001, 1_000_000]
    elif kind.startswith("dec"):
        p, s = (int(x) for x in kind[3:].split("_"))
        bound = 10 ** p
        v = [int(rng.integers(-2 ** 62, 2 ** 62)) * int(rng.integers(
            1, 2 ** 62)) % bound * (1 if rng.random() < 0.5 else -1)
             for _ in range(n)]
        v[:8] = [0, 5, -5, 15, -15, bound - 1, -(bound - 1), 10 ** s]
        if p > 18:
            v[8:10] = [-(1 << 63), (1 << 64) - 1]
    elif kind == "STRING":
        words = ["42", " -7 ", "abc", "", "99999999999999999999", "+5",
                 "1.5", "-2.25e2", "1e3", ".5", "3.", "1e", "--1", "1.2.3",
                 "2001-03-04", "1969-07-20", "0001-01-01", "2023-2-9",
                 "2000-13-01", "1600-02-29", "2000-02-30", "1999",
                 "1999-12", " true", "N", "yes", "0", "e5", "9223372036854775807",
                 "-9223372036854775808", "2147483648", "-129", "0.0000001",
                 "12345678901234567890123", "1e400", "-1e-400", "  12  "]
        v = [words[i] for i in rng.integers(0, len(words), n)]
        v[:len(words)] = words
    else:
        raise ValueError(kind)
    nulls = rng.random(n) < 0.1
    nulls[:40] = False
    return [None if z else x for x, z in zip(v, nulls)]


def _batches(kinds, seed):
    rng = np.random.default_rng(seed)
    data = {f"c{i}": _values(k, rng) for i, k in enumerate(kinds)}
    out = []
    for T, Batch, kw in ((TT, ColumnBatch, {"device": "cpu"}),
                         (JT, JBatch, {})):
        schema = T.Schema([T.Field(f"c{i}", _dt(T, k))
                           for i, k in enumerate(kinds)])
        out.append(Batch.from_numpy(
            {n: np.array(v, object) for n, v in data.items()}, schema,
            capacity=512, **kw))
    return out


def _host(col, n):
    """(validity, values) of the first n rows: numbers as float64 or int
    arrays, strings as bytes, wide decimals as Python ints."""
    valid = np.asarray(col.valid_mask())[:n].astype(bool)
    d = col.data
    if hasattr(d, "children"):
        from blaze_tpu_torch.columnar import int128 as i128

        hi, lo = (np.asarray(ch.data)[:n] for ch in d.children)
        return valid, [v if ok else None for v, ok in zip(
            i128.ints_from_np(np.array(hi), np.array(lo)), valid)]
    if hasattr(d, "lengths"):
        b, ln = np.asarray(d.bytes)[:n], np.asarray(d.lengths)[:n]
        return valid, [bytes(b[i, :ln[i]]) if valid[i] else None
                       for i in range(n)]
    a = np.asarray(d)[:n]
    return valid, np.where(valid, a, np.zeros((), a.dtype))


def _same(tc, jc, n=N):
    assert repr(tc.dtype) == repr(jc.dtype)
    tv, td = _host(tc, n)
    jv, jd = _host(jc, n)
    np.testing.assert_array_equal(tv, jv)
    if isinstance(td, list):
        assert td == jd
    else:
        assert td.dtype == jd.dtype
        np.testing.assert_array_equal(td, jd)


def _run(make, kinds, seed=0):
    tb, jb = _batches(kinds, seed)
    return (tcompile(make(tir, TT), tb.schema)(tb),
            jcompile(make(jir, JT), jb.schema)(jb))


SOURCES = ["BOOLEAN", "INT8", "INT16", "INT32", "INT64", "FLOAT32",
           "FLOAT64", "DATE", "TIMESTAMP", "dec10_2", "dec18_4", "dec38_6",
           "STRING"]
TARGETS = SOURCES + ["dec5_0", "dec20_0", "BINARY"]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("src", SOURCES)
def test_cast_matrix_matches_jax(src, target):
    """Every (source, target) pair: equal rows, or the JAX package's
    refusal raised as the same exception class. One departure: string ->
    wide decimal, where the JAX package puts the narrow path's int64
    values under a wide type (no limb planes; its float -> int64 step
    saturates where torch's conversion is undefined); the port refuses
    it as both refuse float -> wide, and the planner's wide-decimal walk
    never plans it."""
    make = lambda ir, T: ir.Cast(ir.col("c0"), _dt(T, target))  # noqa
    tb, jb = _batches([src], hash((src, target)) & 0xFFFF)
    if src == "STRING" and _dt(TT, target).wide_decimal:
        with pytest.raises(NotImplementedError):
            tcompile(make(tir, TT), tb.schema)(tb)
        return
    try:
        jc = jcompile(make(jir, JT), jb.schema)(jb)
    except (TypeError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            tcompile(make(tir, TT), tb.schema)(tb)
        return
    _same(tcompile(make(tir, TT), tb.schema)(tb), jc)


def test_null_column_casts():
    """A null column casts to an all-null column of any type, as Spark
    casts NULL. The JAX package refuses null -> string (TypeError) and
    null -> wide decimal (NotImplementedError); the port gives the
    all-null column there too (null -> string since string columns
    came)."""
    for target in ("INT32", "FLOAT64", "STRING", "dec38_2", "dec10_2",
                   "DATE"):
        make = lambda ir, T: ir.Cast(ir.Literal(T.NULL, None),  # noqa
                                     _dt(T, target))
        if target in ("STRING", "dec38_2"):
            tb, jb = _batches(["INT32"], 0)
            with pytest.raises((TypeError, NotImplementedError)):
                jcompile(make(jir, JT), jb.schema)(jb)
            tc = tcompile(make(tir, TT), tb.schema)(tb)
            assert repr(tc.dtype) == repr(_dt(TT, target))
            assert _host(tc, N)[1] == [None] * N if tc.dtype.wide_decimal \
                else tc.is_string
        else:
            tc, jc = _run(make, ["INT32"])
            _same(tc, jc)
        assert not tc.valid_mask().any()


def test_cast_float_to_int_saturation():
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), T.INT32), ["FLOAT64"])
    _same(tc, jc)
    assert tc.data[8:10].tolist() == [2 ** 31 - 1, -(2 ** 31)]  # +-inf


def test_cast_string_to_int():
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), T.INT64), ["STRING"])
    _same(tc, jc)
    _, vals = _host(tc, 6)
    valid = tc.valid_mask()[:6].tolist()
    assert [v if ok else None for v, ok in zip(vals.tolist(), valid)] == [
        42, -7, None, None, None, 5]


def test_cast_string_to_double():
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), T.FLOAT64),
                  ["STRING"])
    _same(tc, jc)
    assert tc.data[6:11].tolist() == [1.5, -225.0, 1000.0, 0.5, 3.0]
    assert not tc.valid_mask()[2]


def test_cast_string_to_date_and_back():
    """yyyy[-m[m][-d[d]]] to days since the epoch, days before 1970
    included, and back to 'yyyy-mm-dd' (the flooring calendar
    arithmetic of days_from_civil and civil_from_days)."""
    date = lambda ir, T: ir.Cast(ir.col("c0"), T.DATE)  # noqa
    tc, jc = _run(date, ["STRING"])
    _same(tc, jc)
    assert tc.data[14:17].tolist() == [11385, -165, -719162]
    back = lambda ir, T: ir.Cast(date(ir, T), T.STRING)  # noqa
    tc, jc = _run(back, ["STRING"])
    _same(tc, jc)
    _, s = _host(tc, 17)
    assert s[14:17] == [b"2001-03-04", b"1969-07-20", b"0001-01-01"]
    # days to strings: before the epoch and past year 9999 (clamped as
    # the JAX package clamps)
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), T.STRING), ["DATE"])
    _same(tc, jc)


def test_cast_int_to_string():
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), T.STRING), ["INT64"])
    _same(tc, jc)
    _, s = _host(tc, 5)
    assert s == [b"-9223372036854775808", b"9223372036854775807", b"0",
                 b"-1", b"1"]


@pytest.mark.parametrize("src", ["INT32", "INT64"])
@pytest.mark.parametrize("target", ["dec18_0", "dec10_2", "dec12_2",
                                    "dec38_2", "dec20_0"])
def test_int_bounds_into_decimal(src, target):
    """int32 and int64 at their bounds into narrow and wide decimals: a
    product that wraps or leaves the precision is null."""
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), _dt(T, target)),
                  [src])
    _same(tc, jc)


@pytest.mark.parametrize("target", ["dec10_0", "dec18_2", "dec3_1",
                                    "dec38_2"])
def test_float_to_decimal_half_up(target):
    """HALF_UP at .5 ties (floor(x + 0.5), ceil(x - 0.5) by sign): 0.5 ->
    1, -0.5 -> -1, 1.5 -> 2, 2.5 -> 3 at scale 0; NaN and infinities and
    values past the precision null. A wide target is the JAX package's
    refusal (NotImplementedError)."""
    make = lambda ir, T: ir.Cast(ir.col("c0"), _dt(T, target))  # noqa
    if target == "dec38_2":
        tb, _ = _batches(["FLOAT64"], 0)
        with pytest.raises(NotImplementedError):
            tcompile(make(tir, TT), tb.schema)(tb)
        return
    tc, jc = _run(make, ["FLOAT64"])
    _same(tc, jc)
    if target == "dec10_0":
        assert tc.data[:5].tolist() == [1, -1, 2, -2, 3]


def test_decimal_rescale_half_up_and_check_overflow():
    """decimal(18,4) -> decimal(18,1) rounds the magnitude half up (5 ->
    1 at one place, -15 -> -2), and CheckOverflow nulls beyond the
    precision, narrow and wide."""
    tc, jc = _run(lambda ir, T: ir.Cast(ir.col("c0"), T.decimal(18, 1)),
                  ["dec18_4"])
    _same(tc, jc)
    for p, s in ((10, 2), (6, 4), (20, 2), (38, 6), (25, 0)):
        for src in ("dec18_4", "dec38_6"):
            tc, jc = _run(lambda ir, T: ir.CheckOverflow(ir.col("c0"), p, s),
                          [src])
            _same(tc, jc)


def _arrow_batches():
    import pyarrow as pa

    from blaze_tpu.columnar.arrow_io import batch_from_arrow as jfrom
    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow

    rb = pa.record_batch({
        "x": pa.array([Decimal("1.50"), Decimal("-2.00"), Decimal("0.05"),
                       Decimal("-0.05"), None], pa.decimal128(10, 2)),
        "y": pa.array([Decimal("0.25"), Decimal("3.00"), Decimal("0.00"),
                       Decimal("0.10"), Decimal("1.00")],
                      pa.decimal128(10, 2))})
    return batch_from_arrow(rb, device="cpu"), jfrom(rb)


@pytest.mark.parametrize("op,rt", [
    ("ADD", (11, 2)), ("SUB", (11, 2)), ("MUL", (21, 4)), ("DIV", (15, 6)),
    ("MUL", (18, 3)), ("DIV", (37, 20)), ("ADD", (38, 2)), ("SUB", (5, 1)),
])
def test_decimal_arith(op, rt):
    """test_exprs.py's decimal arithmetic and its neighbours: narrow
    results at the planned type (HALF_UP products and quotients; a zero
    divisor is null), and wide ones on the limb planes."""
    tb, jb = _arrow_batches()

    def make(ir, T):
        return ir.Binary(getattr(ir.BinOp, op), ir.col("x"), ir.col("y"),
                         result_type=T.decimal(*rt))

    tc = tcompile(make(tir, TT), tb.schema)(tb)
    jc = jcompile(make(jir, JT), jb.schema)(jb)
    _same(tc, jc, 5)
    if (op, rt) == ("ADD", (11, 2)):
        assert tc.data[:2].tolist() == [175, 100]
    if (op, rt) == ("DIV", (15, 6)):
        assert tc.data[:2].tolist() == [6000000, -666667]
        assert not tc.valid_mask()[2]


def test_decimal_literals_narrow_and_wide():
    """Decimal literals (a wide one past int64, and null) in arithmetic
    and comparison with a column."""
    big = 10 ** 30 + 7
    for lit_dt, v, op, rt in (((10, 2), 5, "ADD", (11, 2)),
                              ((38, 2), big, "SUB", (38, 2)),
                              ((38, 2), -big, "GT", None),
                              ((20, 2), None, "ADD", (21, 2))):
        def make(ir, T):
            return ir.Binary(getattr(ir.BinOp, op), ir.col("c0"),
                             ir.Literal(T.decimal(*lit_dt), v),
                             result_type=None if rt is None
                             else T.decimal(*rt))

        tc, jc = _run(make, ["dec10_2"])
        _same(tc, jc)
        neg = lambda ir, T: ir.Negate(ir.Literal(T.decimal(*lit_dt), v))  # noqa
        tc, jc = _run(neg, ["dec10_2"])
        _same(tc, jc)


def test_make_decimal_and_unscaled_value():
    for make in (lambda ir, T: ir.UnscaledValue(ir.col("c0")),
                 lambda ir, T: ir.MakeDecimal(ir.col("c0"), 17, 2),
                 lambda ir, T: ir.MakeDecimal(ir.UnscaledValue(
                     ir.col("c0")), 12, 2)):
        tc, jc = _run(make, ["dec10_2"])
        _same(tc, jc)


@pytest.mark.parametrize("op", ["BIT_AND", "BIT_OR", "BIT_XOR",
                                "SHIFT_LEFT", "SHIFT_RIGHT"])
@pytest.mark.parametrize("kinds", [("INT64", "INT64"), ("INT32", "INT32"),
                                   ("INT64", "INT32"), ("INT16", "INT8")])
def test_bitwise_and_shift_ops(op, kinds):
    """The five ops over int columns with nulls; shift counts 0 and 63
    among the edge rows (the count column is the value column's low six
    bits, so every count lies in [0, 63])."""
    def make(ir, T):
        right = ir.col("c1")
        if op.startswith("SHIFT"):
            right = ir.Binary(ir.BinOp.BIT_AND, ir.col("c1"),
                              ir.Literal(getattr(T, kinds[1]), 63))
        return ir.Binary(getattr(ir.BinOp, op), ir.col("c0"), right)

    tc, jc = _run(make, list(kinds), seed=3)
    _same(tc, jc)


def test_shift_counts_0_and_63():
    tb, jb = _batches(["INT64", "INT64"], 4)
    for n in (0, 1, 62, 63):
        for op in ("SHIFT_LEFT", "SHIFT_RIGHT"):
            def make(ir, T):
                return ir.Binary(getattr(ir.BinOp, op), ir.col("c0"),
                                 ir.Literal(T.INT64, n))

            _same(tcompile(make(tir, TT), tb.schema)(tb),
                  jcompile(make(jir, JT), jb.schema)(jb))
