"""Parity of the port's expression compiler (blaze_tpu_torch/exprs) with the
JAX package's (blaze_tpu/exprs), on the CPU: bench.py's predicates and
projection plus the arithmetic, comparison, Kleene-logic, numeric-cast,
CASE/IF and [NOT] IN cases around them, evaluated on the identical batch
in both packages. Values and validity of live rows must be bitwise equal
(NaN == NaN).

MOD is the exception: the port computes Java's remainder (`np.fmod`,
Spark's `%`), and the JAX package's formula differs from it. Those cases
hold the port to `np.fmod` and bound the reference's difference."""

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

N = 3000
FIELDS = [("qty", "INT32"), ("price", "FLOAT64"), ("qn", "INT32"),
          ("pn", "FLOAT64"), ("big", "FLOAT64"), ("flag", "BOOLEAN"),
          ("l", "INT64")]


def _batches():
    rng = np.random.default_rng(7)
    big = rng.standard_normal(N) * 1e12
    big[::17] = np.nan
    big[::23] = np.inf
    big[::29] = -np.inf
    data = {
        "qty": rng.integers(1, 100, N).astype(np.int32),
        "price": rng.random(N) * 100,
        "qn": rng.integers(0, 10, N).astype(np.int32),
        "pn": rng.random(N) * 20,
        "big": big,
        "flag": rng.random(N) < 0.5,
        "l": rng.integers(-2**40, 2**40, N).astype(np.int64),
    }
    validity = {"qn": rng.random(N) < 0.7, "pn": rng.random(N) < 0.6,
                "flag": rng.random(N) < 0.8}
    js = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in FIELDS])
    ts = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
    jb = JBatch.from_numpy(data, js, capacity=4096, validity=validity)
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity))
              for c in jb.columns]
    tb = ColumnBatch.from_host_arrays(ts, arrays, N, 4096, device="cpu")
    return jb, tb


def _lit(ir, T, kind, v):
    return ir.Literal(getattr(T, kind), v)


def _bin(ir, op, a, b):
    return ir.Binary(getattr(ir.BinOp, op), a, b)


def _p1(ir, T):
    return _bin(ir, "LE", ir.col("qty"), _lit(ir, T, "INT32", 50))


def _p2(ir, T):
    return _bin(ir, "GT", ir.col("price"), _lit(ir, T, "FLOAT64", 10.0))


EXPRS = {
    # bench.py's filter and projection
    "qty<=50": _p1,
    "price>10": _p2,
    "p1 AND p2": lambda ir, T: _bin(ir, "AND", _p1(ir, T), _p2(ir, T)),
    "CAST(qty AS double)*price": lambda ir, T: _bin(
        ir, "MUL", ir.Cast(ir.col("qty"), T.FLOAT64), ir.col("price")),
    # Kleene logic over nullable operands
    "qn<=5 AND pn>10": lambda ir, T: _bin(
        ir, "AND", _bin(ir, "LE", ir.col("qn"), _lit(ir, T, "INT32", 5)),
        _bin(ir, "GT", ir.col("pn"), _lit(ir, T, "FLOAT64", 10.0))),
    "qn<=5 OR pn>10": lambda ir, T: _bin(
        ir, "OR", _bin(ir, "LE", ir.col("qn"), _lit(ir, T, "INT32", 5)),
        _bin(ir, "GT", ir.col("pn"), _lit(ir, T, "FLOAT64", 10.0))),
    "flag AND p1": lambda ir, T: _bin(ir, "AND", ir.col("flag"), _p1(ir, T)),
    "NOT flag": lambda ir, T: ir.Not(ir.col("flag")),
    "qn IS NULL": lambda ir, T: ir.IsNull(ir.col("qn")),
    "pn IS NOT NULL": lambda ir, T: ir.IsNotNull(ir.col("pn")),
    # arithmetic
    "qty+qn": lambda ir, T: _bin(ir, "ADD", ir.col("qty"), ir.col("qn")),
    "qty-l": lambda ir, T: _bin(ir, "SUB", ir.col("qty"), ir.col("l")),
    "qty/qn": lambda ir, T: _bin(ir, "DIV", ir.col("qty"), ir.col("qn")),
    "price/pn": lambda ir, T: _bin(ir, "DIV", ir.col("price"), ir.col("pn")),
    "qty%qn": lambda ir, T: _bin(ir, "MOD", ir.col("qty"), ir.col("qn")),
    "l%7": lambda ir, T: _bin(ir, "MOD", ir.col("l"),
                              _lit(ir, T, "INT64", -7)),
    "-price": lambda ir, T: ir.Negate(ir.col("price")),
    "qty+NULL": lambda ir, T: _bin(ir, "ADD", ir.col("qty"),
                                   _lit(ir, T, "INT32", None)),
    # comparisons
    "qn=3": lambda ir, T: _bin(ir, "EQ", ir.col("qn"),
                               _lit(ir, T, "INT32", 3)),
    "qn!=qty": lambda ir, T: _bin(ir, "NEQ", ir.col("qn"), ir.col("qty")),
    "price<pn": lambda ir, T: _bin(ir, "LT", ir.col("price"), ir.col("pn")),
    "qty>=l": lambda ir, T: _bin(ir, "GE", ir.col("qty"), ir.col("l")),
    "qn<=>qn": lambda ir, T: _bin(ir, "EQ_NULLSAFE", ir.col("qn"),
                                  ir.col("qn")),
    # numeric casts
    "CAST(big AS int)": lambda ir, T: ir.Cast(ir.col("big"), T.INT32),
    "CAST(price AS smallint)": lambda ir, T: ir.Cast(
        _bin(ir, "MUL", ir.col("price"), _lit(ir, T, "FLOAT64", 1000.0)),
        T.INT16),
    "CAST(qty*qty*qty*qty AS tinyint)": lambda ir, T: ir.Cast(
        _bin(ir, "MUL", _bin(ir, "MUL", ir.col("qty"), ir.col("qty")),
             _bin(ir, "MUL", ir.col("qty"), ir.col("qty"))), T.INT8),
    "CAST(l AS int)": lambda ir, T: ir.Cast(ir.col("l"), T.INT32),
    "CAST(price AS float)": lambda ir, T: ir.Cast(ir.col("price"),
                                                 T.FLOAT32),
    "CAST(flag AS bigint)": lambda ir, T: ir.Cast(ir.col("flag"), T.INT64),
    "CAST(qn AS boolean)": lambda ir, T: ir.Cast(ir.col("qn"), T.BOOLEAN),
    # CASE / IF over nullable conditions and values
    "CASE WHEN qn<=5 THEN price WHEN flag THEN pn ELSE -price": lambda ir, T:
        ir.CaseWhen(((_bin(ir, "LE", ir.col("qn"), _lit(ir, T, "INT32", 5)),
                      ir.col("price")),
                     (ir.col("flag"), ir.col("pn"))),
                    ir.Negate(ir.col("price"))),
    "CASE WHEN flag THEN pn (no ELSE)": lambda ir, T: ir.CaseWhen(
        ((ir.col("flag"), ir.col("pn")),), None),
    "CASE WHEN p1 THEN 1.0 ELSE 0.0": lambda ir, T: ir.CaseWhen(
        ((_p1(ir, T), _lit(ir, T, "FLOAT64", 1.0)),),
        _lit(ir, T, "FLOAT64", 0.0)),
    "CASE WHEN pn>10 THEN NULL ELSE qn": lambda ir, T: ir.CaseWhen(
        ((_bin(ir, "GT", ir.col("pn"), _lit(ir, T, "FLOAT64", 10.0)),
          _lit(ir, T, "INT32", None)),), ir.col("qn")),
    "IF(flag, qty, qn)": lambda ir, T: ir.If(ir.col("flag"), ir.col("qty"),
                                            ir.col("qn")),
    # [NOT] IN, three-valued
    "qn IN (1, 3, 5)": lambda ir, T: ir.InList(
        ir.col("qn"), tuple(_lit(ir, T, "INT32", v) for v in (1, 3, 5))),
    "qn IN (2, NULL)": lambda ir, T: ir.InList(
        ir.col("qn"), (_lit(ir, T, "INT32", 2), _lit(ir, T, "INT32", None))),
    "qty NOT IN (7, 9)": lambda ir, T: ir.InList(
        ir.col("qty"), (_lit(ir, T, "INT32", 7), _lit(ir, T, "INT32", 9)),
        True),
    "qn NOT IN (4, NULL)": lambda ir, T: ir.InList(
        ir.col("qn"), (_lit(ir, T, "INT32", 4), _lit(ir, T, "INT32", None)),
        True),
    "l IN (qty, 3)": lambda ir, T: ir.InList(
        ir.col("l"), (ir.Cast(ir.col("qty"), T.INT64),
                      _lit(ir, T, "INT64", 3))),
}


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(batches, name):
    jb, tb = batches
    je = EXPRS[name](jir, JT)
    te = EXPRS[name](tir, TT)
    assert je.key() == te.key()
    jc = jcompile(je, jb.schema)(jb)
    tc = tcompile(te, tb.schema)(tb)
    assert repr(tc.dtype) == repr(jc.dtype)
    live = np.arange(4096) < N
    jv = np.asarray(jc.valid_mask()) & live
    tv = tc.valid_mask().numpy() & live
    np.testing.assert_array_equal(tv, jv)
    jd = np.asarray(jc.data)[jv]
    td = tc.data.numpy()[tv]
    assert td.dtype == jd.dtype
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("expr", [
    lambda ir, T: ir.Cast(ir.Literal(T.STRING, "1"), T.INT32),
    lambda ir, T: ir.ScalarFn("upper", (ir.Literal(T.STRING, "x"),)),
    lambda ir, T: ir.ScalarFn("abs", (ir.col("price"),)),
    lambda ir, T: ir.Cast(ir.col("qty"), T.STRING),
    lambda ir, T: _bin(ir, "ADD", ir.Literal(T.decimal(10, 2), 5),
                       ir.col("l")),
])
def test_unported_expressions_raise(batches, expr):
    """Expressions that used to raise in the port: the scalar functions
    (upper, abs), the casts to and from strings and decimal literal
    arithmetic. Each now equals the JAX package's, bit for bit."""
    jb, tb = batches
    te = expr(tir, TT)
    jc = jcompile(expr(jir, JT), jb.schema)(jb)
    tc = tcompile(te, tb.schema)(tb)
    assert repr(tc.dtype) == repr(jc.dtype)
    live = np.arange(4096) < N
    jv = np.asarray(jc.valid_mask()) & live
    tv = tc.valid_mask().numpy() & live
    np.testing.assert_array_equal(tv, jv)
    if tc.is_string:
        n = int(tv.sum())
        assert n and tc.data.lengths.numpy()[tv].tolist() == \
            np.asarray(jc.data.lengths)[jv].tolist()
        np.testing.assert_array_equal(tc.data.bytes.numpy()[tv],
                                      np.asarray(jc.data.bytes)[jv])
        return
    np.testing.assert_array_equal(tc.data.numpy()[tv],
                                  np.asarray(jc.data)[jv])


def test_cse_scope_evaluates_once(batches):
    from blaze_tpu_torch.exprs.compiler import cse_scope

    _, tb = batches
    fn = tcompile(EXPRS["CAST(qty AS double)*price"](tir, TT), tb.schema)
    with cse_scope():
        assert fn(tb) is fn(tb)
    assert fn(tb) is not fn(tb)


def _pair(kind, a, b):
    """Columns a and b in both packages, with the MOD of each."""
    js = JT.Schema([JT.Field("a", getattr(JT, kind)),
                    JT.Field("b", getattr(JT, kind))])
    ts = TT.Schema([TT.Field("a", getattr(TT, kind)),
                    TT.Field("b", getattr(TT, kind))])
    jb = JBatch.from_numpy({"a": a, "b": b}, js, capacity=len(a))
    tb = ColumnBatch.from_numpy({"a": a, "b": b}, ts, capacity=len(a),
                                device="cpu")
    jr = jcompile(_bin(jir, "MOD", jir.col("a"), jir.col("b")), js)(jb)
    tr = tcompile(_bin(tir, "MOD", tir.col("a"), tir.col("b")), ts)(tb)
    return np.asarray(jr.data), tr.data.numpy()


def test_mod_float64_is_java_remainder():
    """f64 `%` on a uniform on +-1e6, b on +-1e3: the port equals np.fmod
    bit for bit. The reference computes a - trunc(a/b)*b, whose one
    rounding puts it within half an ulp of a of the exact remainder."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-1e6, 1e6, 4096)
    b = rng.uniform(-1e3, 1e3, 4096)
    ref, port = _pair("FLOAT64", a, b)
    want = np.fmod(a, b)
    np.testing.assert_array_equal(port, want)
    assert np.all(np.abs(ref - want) <= np.spacing(np.abs(a)) / 2)
    assert np.any(ref != want)  # the reference really differs


def test_mod_int64_min_is_java_remainder():
    """int64 `%` at INT64_MIN: Java (and Spark, and np.fmod) give
    -2^63 % 3 = -2 and 5 % -2^63 = 5; the port agrees on every row. The
    reference's sign(a) * (|a| % |b|) overflows |INT64_MIN| and differs at
    exactly those two rows (-1 and -9223372036854775803)."""
    a = np.array([-2**63, 5, 7, -7, 2**62, -2**63 + 1], np.int64)
    b = np.array([3, -2**63, 3, -3, -5, 7], np.int64)
    ref, port = _pair("INT64", a, b)
    want = np.fmod(a, b)
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(np.nonzero(ref != want)[0], [0, 1])
    np.testing.assert_array_equal(ref[:2], [-1, -9223372036854775803])
