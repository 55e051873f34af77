"""Wide decimals (p > 18) end to end in the port against the JAX package,
on the CPU: storage, serde, expressions, aggregates, hash, grouping,
joins, casts, division and the planner's gating.

Every case of tests/test_wide_decimal.py: the same plan is built over
each package's plan model from the same seeded Parquet file and run
through each package's `run_plan` (the JAX package inline, its supervisor
and threaded pipeline off). The rows must be equal bit for bit (unscaled
values as Python ints), and the JAX test's Python-Decimal oracle holds on
the port's rows too.

Doubles are the one exception, and only against the JAX package's jitted
stages: XLA rewrites a division by a constant into a multiplication by
its reciprocal, which is not correctly rounded (-100000000000654580 /
1e4 comes out 10000000000065.459 under `jax.jit`, .457 eagerly, in numpy
and in torch). So a double from a wide -> double cast is held bit for bit
to the JAX package's expression run eagerly (IEEE division, as Java's
`long / 10^scale` in Spark's Decimal.toDouble), and to its `run_plan`
rows within one unit in the last place.
"""

import copy
from decimal import ROUND_HALF_UP, Decimal
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.config import conf as jconf
from blaze_tpu.exprs import ir as jir
from blaze_tpu.spark import plan_model as jpm
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.local_runner import run_plan as jrun_plan
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir as tir
from blaze_tpu_torch.spark import plan_model as tpm
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.local_runner import run_plan
from torch_parity import no_jax_native

PKGS = {
    "port": SimpleNamespace(T=TT, ir=tir, SparkPlan=tpm.SparkPlan,
                            apply=apply_strategy, Batch=ColumnBatch),
    "jax": SimpleNamespace(T=JT, ir=jir, SparkPlan=jpm.SparkPlan,
                           apply=japply, Batch=JBatch),
}


@pytest.fixture(autouse=True)
def _inline_jax(monkeypatch):
    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)


def _vals(rng, n, digits=22, scale=4):
    out = []
    for _ in range(n):
        mag = int(rng.integers(1, 10)) * 10 ** int(rng.integers(0, digits))
        v = mag + int(rng.integers(0, 10 ** 6))
        out.append(Decimal(v if rng.integers(0, 2) else -v).scaleb(-scale))
    return out


@pytest.fixture
def wide_table(tmp_path, rng):
    n = 400
    df = pd.DataFrame({"k": np.arange(n, dtype=np.int64),
                       "a": _vals(rng, n), "b": _vals(rng, n)})
    df.loc[5, "a"] = None
    df.loc[9, "b"] = Decimal(0)
    p = str(tmp_path / "w.parquet")
    pq.write_table(pa.Table.from_pandas(df, schema=pa.schema(
        [("k", pa.int64()), ("a", pa.decimal128(25, 4)),
         ("b", pa.decimal128(25, 4))])), p)
    return df, p


def _scan(k, path):
    T = k.T
    w25 = T.decimal(25, 4)
    return k.SparkPlan("FileSourceScanExec", T.Schema(
        [T.Field("k", T.INT64), T.Field("a", w25), T.Field("b", w25)]),
        [], {"format": "parquet", "files": [(path, [])]})


def _both(make, tmp_path, parts=1):
    """Run the plan make(k) builds in each package: (port rows, JAX rows),
    asserted equal."""
    got = run_plan(make(PKGS["port"]), num_partitions=parts,
                   work_dir=str(tmp_path / "port"),
                   device="cpu").to_numpy()
    want = jrun_plan(make(PKGS["jax"]), num_partitions=parts,
                     work_dir=str(tmp_path / "jax"),
                     mesh_exchange="off").to_numpy()
    assert list(got) == list(want)
    for name in want:
        g, w = ([None if x is None else x.item() if hasattr(x, "item")
                 else x for x in col] for col in (got[name], want[name]))
        if any(isinstance(x, float) for x in w):
            assert [x is None for x in g] == [x is None for x in w], name
            np.testing.assert_array_max_ulp(
                np.array([x for x in g if x is not None]),
                np.array([x for x in w if x is not None]), maxulp=1)
            continue
        assert g == w, name
    return got


def test_batch_roundtrip():
    vals = [Decimal("12345678901234567890.1234"), None,
            Decimal("-99999999999999999999.9999"), Decimal("0.0001"),
            10 ** 38 - 1, -(10 ** 38 - 1)]
    rows = {}
    for name, k in PKGS.items():
        schema = k.T.Schema([k.T.Field("a", k.T.decimal(38, 4))])
        kw = {"device": "cpu"} if name == "port" else {}
        rows[name] = k.Batch.from_numpy({"a": np.array(vals, object)},
                                        schema, **kw).to_numpy()["a"]
    assert rows["port"] == rows["jax"]
    assert rows["port"][1] is None
    assert rows["port"][0] == int(vals[0].scaleb(4))
    assert rows["port"][4:] == [10 ** 38 - 1, -(10 ** 38 - 1)]


def test_serde_roundtrip(rng):
    """Frames of a wide column are byte-identical in both packages and
    decode back in either."""
    from blaze_tpu.columnar import serde as jserde
    from blaze_tpu_torch.columnar import serde

    vals = _vals(rng, 50) + [None, Decimal(0)]
    tschema = TT.Schema([TT.Field("a", TT.decimal(25, 4))])
    jschema = JT.Schema([JT.Field("a", JT.decimal(25, 4))])
    tb = ColumnBatch.from_numpy({"a": np.array(vals, object)}, tschema,
                                device="cpu")
    jb = JBatch.from_numpy({"a": np.array(vals, object)}, jschema)
    frame = serde.serialize_batch(tb)
    assert frame == jserde.serialize_batch(jb)
    want = [None if v is None else int(v.scaleb(4)) for v in vals]
    assert serde.deserialize_batch(frame, tschema,
                                   device="cpu").to_numpy()["a"] == want
    assert jserde.deserialize_batch(frame, jschema).to_numpy()["a"] == want


def test_project_add_mul_neg(wide_table, tmp_path):
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        m_t = T.decimal(28, 4)
        return k.SparkPlan("ProjectExec", T.Schema(
            [T.Field("k", T.INT64), T.Field("s", T.decimal(26, 4)),
             T.Field("m", m_t), T.Field("n", T.decimal(25, 4))]),
            [_scan(k, p)], {"exprs": [
                ir.col("k"),
                ir.Binary(ir.BinOp.ADD, ir.col("a"), ir.col("b"),
                          result_type=T.decimal(26, 4)),
                ir.Binary(ir.BinOp.MUL, ir.col("a"),
                          ir.Literal(T.decimal(2, 0), 3), result_type=m_t),
                ir.Negate(ir.col("a"))], "names": ["k", "s", "m", "n"]})

    d = _both(make, tmp_path)
    for k_, s, m, n in zip(d["k"], d["s"], d["m"], d["n"]):
        a, b = df.a[int(k_)], df.b[int(k_)]
        if a is None:
            assert s is None and m is None and n is None
            continue
        assert (s, m, n) == (int((a + b).scaleb(4)), int((a * 3).scaleb(4)),
                             -int(a.scaleb(4)))


def test_filter_compare_and_sort(wide_table, tmp_path):
    df, p = wide_table
    thresh = Decimal("1000000000000000000.0")  # past an int64 unscaled

    def flt(k):
        T, ir = k.T, k.ir
        s = _scan(k, p)
        return k.SparkPlan("FilterExec", s.schema, [s], {
            "condition": ir.Binary(ir.BinOp.GT, ir.col("a"), ir.Literal(
                T.decimal(25, 4), int(thresh.scaleb(4))))})

    d = _both(flt, tmp_path)
    assert len(d["k"]) == int((df.a.notna() & (df.a > thresh)).sum())

    def srt(k):
        s = _scan(k, p)
        return k.SparkPlan("SortExec", s.schema, [s],
                           {"orders": [(k.ir.col("a"), True, True)]})

    vals = _both(srt, tmp_path / "s")["a"]
    assert vals[0] is None
    assert vals[1:] == sorted(vals[1:])


def test_shuffle_roundtrip_wide_passthrough(wide_table, tmp_path):
    """Wide columns ride the exchange (a narrow hash key) intact; the
    shuffle files hold the JAX package's frames."""
    df, p = wide_table

    def make(k):
        s = _scan(k, p)
        ex = k.SparkPlan("ShuffleExchangeExec", s.schema, [s],
                         {"keys": [k.ir.col("k")], "num_partitions": 3})
        return k.SparkPlan("SortExec", ex.schema, [ex],
                           {"orders": [(k.ir.col("k"), True, True)]})

    d = _both(make, tmp_path, parts=3)
    assert d["a"] == [None if v is None else int(v.scaleb(4))
                      for v in df.a]


def _global_agg(k, p, fn, dtype):
    def mk(mode, child):
        return k.SparkPlan("HashAggregateExec", k.T.Schema(
            [] if mode == "partial" else [k.T.Field("s", dtype)]), [child],
            {"mode": mode, "grouping": [], "grouping_names": [],
             "aggs": [{"fn": fn, "args": [k.ir.col("a")], "dtype": dtype,
                       "name": "s"}]})
    return mk("final", mk("partial", _scan(k, p)))


@pytest.mark.parametrize("fn,prec,scale", [("sum", 35, 4), ("min", 25, 4),
                                           ("max", 25, 4), ("avg", 29, 8)])
def test_global_sum_min_max_avg_on_wide_native(wide_table, tmp_path, fn,
                                               prec, scale):
    """Wide-decimal aggregates convert and run on the limb planes."""
    df, p = wide_table
    probe = _global_agg(PKGS["port"], p, fn, TT.decimal(prec, scale))
    assert apply_strategy(probe).strategy != "NeverConvert"
    got = _both(lambda k: _global_agg(k, p, fn, k.T.decimal(prec, scale)),
                tmp_path)["s"][0]
    vals = df.a.dropna()
    want = {"sum": vals.sum(), "min": vals.min(), "max": vals.max()}.get(fn)
    if fn == "avg":
        assert got == int((vals.sum().scaleb(8) / len(vals)).quantize(
            Decimal(1), rounding=ROUND_HALF_UP))
    else:
        assert Decimal(got).scaleb(-4) == want


def test_wide_decimal_hash_matches_java_semantics(rng):
    """The wide hash is murmur3 over the minimal big-endian two's
    complement bytes (Java's BigInteger.toByteArray): the port's equals
    the JAX package's and the pure-Python oracle."""
    import sys

    sys.path.insert(0, "tests")
    from test_hash import py_hash_bytes, to_i32

    from blaze_tpu.exprs.hash import hash_columns as jhash
    from blaze_tpu_torch.exprs.hash import hash_columns

    def java_bytes(v: int) -> bytes:
        n = max(1, (v.bit_length() + 8) // 8) if v >= 0 else \
            max(1, ((~v).bit_length() + 8) // 8)
        return v.to_bytes(n, "big", signed=True)

    vals = [0, 1, -1, 127, 128, -128, -129, 255, 256, -256, 2**63,
            -(2**63) - 1, 10**25 + 12345, -(10**30), 2**120, -(2**120),
            10**38 - 1, -(10**38 - 1)]
    vals += [int(rng.integers(-2**62, 2**62)) * int(rng.integers(1, 2**60))
             for _ in range(20)]
    tb = ColumnBatch.from_numpy({"a": np.array(vals, object)}, TT.Schema(
        [TT.Field("a", TT.decimal(38, 4))]), device="cpu")
    jb = JBatch.from_numpy({"a": np.array(vals, object)}, JT.Schema(
        [JT.Field("a", JT.decimal(38, 4))]))
    got = hash_columns(tb.columns).numpy()[:len(vals)]
    np.testing.assert_array_equal(got, np.asarray(jhash(jb.columns))[
        :len(vals)])
    assert list(got) == [to_i32(py_hash_bytes(java_bytes(v), 42))
                         for v in vals]


def test_group_by_wide_key(wide_table, tmp_path):
    """GROUP BY a wide column across a 3-partition exchange on it: the
    wide hash partitions the rows as the JAX package does."""
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir

        def mk(mode, child, fields):
            return k.SparkPlan("HashAggregateExec", T.Schema(fields),
                               [child], {
                                   "mode": mode, "grouping": [ir.col("a")],
                                   "grouping_names": ["a"],
                                   "aggs": [{"fn": "count",
                                             "args": [ir.col("k")],
                                             "dtype": T.INT64, "name": "c"}]})

        w = T.decimal(25, 4)
        partial = mk("partial", _scan(k, p), [T.Field("a", w)])
        ex = k.SparkPlan("ShuffleExchangeExec", partial.schema, [partial],
                         {"keys": [ir.col("a")], "num_partitions": 3})
        return mk("final", ex, [T.Field("a", w), T.Field("c", T.INT64)])

    probe = make(PKGS["port"])
    assert apply_strategy(probe).strategy != "NeverConvert"
    d = _both(make, tmp_path, parts=3)
    got = {v: int(c) for v, c in zip(d["a"], d["c"])}
    for val, cnt in df.dropna(subset=["a"]).groupby("a")["k"].count(
            ).items():
        assert got[int(val.scaleb(4))] == cnt
    assert got.get(None, 0) == 1


def test_join_on_wide_key(wide_table, tmp_path):
    """A sort-merge self-join on a wide key: every non-null row meets
    itself once."""
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        w = T.decimal(25, 4)
        return k.SparkPlan("SortMergeJoinExec", T.Schema(
            [T.Field("k", T.INT64), T.Field("a", w), T.Field("b", w),
             T.Field("k2", T.INT64), T.Field("a2", w), T.Field("b2", w)]),
            [_scan(k, p), _scan(k, p)],
            {"left_keys": [ir.col("a")], "right_keys": [ir.col("a")],
             "join_type": "inner", "condition": None})

    probe = make(PKGS["port"])
    assert apply_strategy(probe).strategy != "NeverConvert"
    d = _both(make, tmp_path)
    assert len(d["k"]) == int(df.a.notna().sum())


def test_sum_overflow_goes_null(tmp_path):
    """A sum past the result precision is null (Spark non-ANSI): 1.2e38
    lies past 10^38 (the finalize's precision check)."""
    big = Decimal(6) * 10 ** 37
    df = pd.DataFrame({"k": np.array([0, 1], np.int64), "a": [big, big]})
    p = str(tmp_path / "ovf.parquet")
    pq.write_table(pa.Table.from_pandas(df, schema=pa.schema(
        [("k", pa.int64()), ("a", pa.decimal128(38, 0))])), p)

    def make(k):
        T, ir = k.T, k.ir
        w = T.decimal(38, 0)
        scan = k.SparkPlan("FileSourceScanExec", T.Schema(
            [T.Field("k", T.INT64), T.Field("a", w)]), [],
            {"format": "parquet", "files": [(p, [])]})

        def mk(mode, child):
            return k.SparkPlan("HashAggregateExec", T.Schema(
                [] if mode == "partial" else [T.Field("s", w)]), [child],
                {"mode": mode, "grouping": [], "grouping_names": [],
                 "aggs": [{"fn": "sum", "args": [ir.col("a")],
                           "dtype": w, "name": "s"}]})
        return mk("final", mk("partial", scan))

    assert _both(make, tmp_path)["s"] == [None]


def test_upscale_wrap_goes_null(wide_table, tmp_path):
    """An ADD whose scale alignment (4 -> 30) would wrap 2^128 is null,
    not a wrapped residue (rescale_checked)."""
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        rt = T.decimal(38, 30)
        return k.SparkPlan("ProjectExec", T.Schema(
            [T.Field("k", T.INT64), T.Field("s", rt)]), [_scan(k, p)],
            {"exprs": [ir.col("k"), ir.Binary(ir.BinOp.ADD, ir.col("a"),
                                              ir.col("b"), result_type=rt)],
             "names": ["k", "s"]})

    d = _both(make, tmp_path)
    bound = Decimal(10) ** 8
    for k_, s in zip(d["k"], d["s"]):
        a, b = df.a[int(k_)], df.b[int(k_)]
        if a is None or abs(a) >= bound or abs(b) >= bound:
            assert s is None
        else:
            assert s == int((a + b).scaleb(30))


def test_grouped_wide_sum_through_shuffle(wide_table, tmp_path):
    """A grouped wide sum across an exchange: the partial state's limb
    planes and validity cross the serde and merge."""
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        wsum = T.decimal(35, 4)
        grp = k.SparkPlan("ProjectExec", T.Schema(
            [T.Field("g", T.INT64), T.Field("a", T.decimal(25, 4))]),
            [_scan(k, p)], {"exprs": [
                ir.Binary(ir.BinOp.MOD, ir.col("k"), ir.Literal(T.INT64, 7)),
                ir.col("a")], "names": ["g", "a"]})

        def agg(mode, child, fields):
            return k.SparkPlan("HashAggregateExec", T.Schema(fields),
                               [child], {
                                   "mode": mode, "grouping": [ir.col("g")],
                                   "grouping_names": ["g"],
                                   "aggs": [{"fn": "sum",
                                             "args": [ir.col("a")],
                                             "dtype": wsum, "name": "s"}]})

        partial = agg("partial", grp, [T.Field("g", T.INT64)])
        ex = k.SparkPlan("ShuffleExchangeExec", partial.schema, [partial],
                         {"keys": [ir.col("g")], "num_partitions": 3})
        return agg("final", ex, [T.Field("g", T.INT64),
                                 T.Field("s", wsum)])

    d = _both(make, tmp_path, parts=3)
    got = {int(g): Decimal(s).scaleb(-4) for g, s in zip(d["g"], d["s"])}
    for g, v in df.assign(g=df.k % 7).dropna(subset=["a"]).groupby(
            "g")["a"].sum().items():
        assert got[int(g)] == v


def test_cast_and_check_overflow(wide_table, tmp_path):
    """Wide -> decimal(10,2) (HALF_UP, overflow null), wide -> double
    (bit-equal: one division in the same order), int -> wide, and
    CheckOverflow to decimal(20,2)."""
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        return k.SparkPlan("ProjectExec", T.Schema(
            [T.Field("k", T.INT64), T.Field("c", T.decimal(10, 2)),
             T.Field("f", T.FLOAT64), T.Field("w", T.decimal(38, 6)),
             T.Field("o", T.decimal(20, 2))]), [_scan(k, p)], {"exprs": [
                 ir.col("k"), ir.Cast(ir.col("a"), T.decimal(10, 2)),
                 ir.Cast(ir.col("a"), T.FLOAT64),
                 ir.Cast(ir.col("k"), T.decimal(38, 6)),
                 ir.CheckOverflow(ir.col("a"), 20, 2)],
                 "names": ["k", "c", "f", "w", "o"]})

    d = _both(make, tmp_path)
    # the double bit for bit against the JAX expression run eagerly
    from blaze_tpu.columnar.arrow_io import batch_from_arrow as jfrom
    from blaze_tpu.exprs.compiler import compile_expr as jcompile
    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow
    from blaze_tpu_torch.exprs.compiler import compile_expr

    rb = pq.read_table(p).to_batches()[0]
    tb, jb = batch_from_arrow(rb, device="cpu"), jfrom(rb)
    tc = compile_expr(tir.Cast(tir.col("a"), TT.FLOAT64), tb.schema)(tb)
    jc = jcompile(jir.Cast(jir.col("a"), JT.FLOAT64), jb.schema)(jb)
    live = tc.valid_mask().numpy() & (np.arange(tb.capacity) < len(df))
    np.testing.assert_array_equal(live, np.asarray(jc.valid_mask()) & (
        np.arange(tb.capacity) < len(df)))
    np.testing.assert_array_equal(tc.data.numpy()[live],
                                  np.asarray(jc.data)[live])
    for k_, c, f, w, o in zip(d["k"], d["c"], d["f"], d["w"], d["o"]):
        a = df.a[int(k_)]
        assert w == int(k_) * 10 ** 6
        if a is None:
            assert c is None and f is None and o is None
            continue
        r2 = a.quantize(Decimal("0.01"), rounding=ROUND_HALF_UP)
        assert c == (int(r2.scaleb(2)) if abs(a) < Decimal(10) ** 8
                     else None)
        assert o == (int(r2.scaleb(2)) if abs(r2) < Decimal(10) ** 18
                     else None)
        np.testing.assert_allclose(f, float(a), rtol=1e-12)


def test_project_division(wide_table, tmp_path):
    """The 128-bit long division with HALF_UP at the planned scale:
    wide / wide and wide / narrow match Python's Decimal; divide by zero
    is null."""
    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        q_t = T.decimal(38, 10)
        return k.SparkPlan("ProjectExec", T.Schema(
            [T.Field("k", T.INT64), T.Field("q", q_t),
             T.Field("qn", T.decimal(30, 6))]), [_scan(k, p)], {"exprs": [
                 ir.col("k"),
                 ir.Binary(ir.BinOp.DIV, ir.col("a"), ir.col("b"),
                           result_type=q_t),
                 ir.Binary(ir.BinOp.DIV, ir.col("a"),
                           ir.Literal(T.decimal(2, 0), 7),
                           result_type=T.decimal(30, 6))],
                 "names": ["k", "q", "qn"]})

    probe = copy.deepcopy(make(PKGS["port"]))
    assert apply_strategy(probe).strategy != "NeverConvert"
    d = _both(make, tmp_path)
    for k_, q, qn in zip(d["k"], d["q"], d["qn"]):
        a, b = df.a[int(k_)], df.b[int(k_)]
        if a is None:
            assert q is None and qn is None
            continue
        if b == 0:
            assert q is None
        else:
            assert q == int((a / b).quantize(
                Decimal(1).scaleb(-10), rounding=ROUND_HALF_UP).scaleb(10))
        assert qn == int((a / Decimal(7)).quantize(
            Decimal(1).scaleb(-6), rounding=ROUND_HALF_UP).scaleb(6))


def test_division_gating_regression(wide_table, tmp_path):
    """A division whose scale alignment cannot provably fit 128 bits tags
    NeverConvert in both packages' wide-decimal walk, so it runs on the
    row interpreter. The JAX package's Python Decimal division raises on
    the table's zero divisor (pinned); the port's answers as Spark does
    off ANSI mode: NULL for the zero divisor and the NULL dividend, every
    other row the quotient rounded HALF_UP to the result scale, exactly."""
    import decimal

    df, p = wide_table

    def make(k):
        T, ir = k.T, k.ir
        q = T.decimal(38, 20)   # delta 20: 25 + 20 > 38
        return k.SparkPlan("ProjectExec", T.Schema([T.Field("q", q)]),
                           [_scan(k, p)], {"exprs": [ir.Binary(
                               ir.BinOp.DIV, ir.col("a"), ir.col("b"),
                               result_type=q)], "names": ["q"]})

    for k in PKGS.values():
        plan = make(k)
        k.apply(plan)
        assert plan.strategy == "NeverConvert"
    with pytest.raises(decimal.DivisionByZero):
        jrun_plan(make(PKGS["jax"]), num_partitions=1,
                  work_dir=str(tmp_path / "jax"), mesh_exchange="off")
    got = run_plan(make(PKGS["port"]), num_partitions=1,
                   work_dir=str(tmp_path / "port"),
                   device="cpu").to_numpy()["q"]
    ctx = decimal.Context(prec=80, rounding=decimal.ROUND_HALF_UP)
    want = [None if a is None or pd.isna(a) or b == 0 else
            int(ctx.divide(a, b).scaleb(20, context=ctx).to_integral_value(
                context=ctx))
            for a, b in zip(df["a"], df["b"])]
    assert want[5] is None and want[9] is None
    assert list(got) == want
