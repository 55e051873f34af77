"""Parity of the port's row interpreter and its bridge (blaze_tpu_torch/
spark/fallback.py, expr_subtree_fallback.py and the FFI bridge of
local_runner.run_plan) with the JAX package's, on the CPU.

- `PYTHON_FNS`: the default table has the JAX table's names, covers the
  port's whole scalar-function registry, and gives item for item the JAX
  table's outputs on the cases of tests/test_fallback_fns.py (plus nulls,
  NaN and empty strings); its murmur3 equals the port's device hash.
- NeverConvert subtrees: catalogue queries run with one kind of operator
  switched off (`conf.enable_ops`) in both packages, so that scans,
  filters, projections, sorts, aggregates (partial, final, over shuffle
  reads), joins and limits run on the row interpreter and enter the
  native pipeline through the FFI bridge. Rows equal the JAX package's:
  integers and strings exactly, floats within rtol 1e-12, in order; the
  port counts its bridge in run_info. Where the JAX package's interpreter
  fails (a fallback final aggregate over an empty shuffle partition of
  native partial state, an empty string column out of the interpreter),
  the JAX package's exception stays pinned and the port's interpreter
  answers: its rows equal the JAX package's for the same query with the
  operator left on.
- The expression-subtree wrap: the plans of tests/test_expr_subtree_
  fallback.py rewrite to the same expressions and resource ids
  (`fallbackfn:<name>:<kind>`) and run to the JAX package's rows.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.config import conf as jconf
from blaze_tpu.exprs import ir as jir
from blaze_tpu.spark import fallback as jfallback
from blaze_tpu.spark import plan_model as JP
from blaze_tpu.spark import tpcds as jtpcds
from blaze_tpu.spark import validator as jvalidator
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.local_runner import run_plan as jrun_plan
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import functions
from blaze_tpu_torch.exprs import ir as tir
from blaze_tpu_torch.spark import fallback
from blaze_tpu_torch.spark import plan_model as TP
from blaze_tpu_torch.spark import tpcds, validator
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.local_runner import run_plan
from test_torch_plan_json import same_rows
from torch_parity import no_jax_native

ROWS = 2000
CATALOGUES = {"tpcds": (tpcds, jtpcds), "core": (validator, jvalidator)}


def arr(*vals):
    return np.array(vals, object)


# (name, args) of tests/test_fallback_fns.py, with nulls, NaN, empty
# strings and more edge rows
FN_CASES = [
    ("lower", (arr("AbC", None, ""),)), ("upper", (arr("AbC", None),)),
    ("initcap", (arr("hello wORLD", "", " a  b"),)),
    ("lpad", (arr("hi", "abc", None), arr(5, -1, 3), arr("xy", "x", "z"))),
    ("rpad", (arr("hi", "abcdef"), arr(1, 3), arr("x", ""))),
    ("substr", (arr("hello", "hello", "hello", None), arr(2, -3, -10, 1),
                arr(3, 2, 3, 1))),
    ("substring", (arr("hello"), arr(0))),
    ("split_part", (arr("a,b,c", "a,b,c", "a", "x"), arr(",", ",", ",", ""),
                    arr(2, -1, 5, 1))),
    ("translate", (arr("abcba", "abc"), arr("ab", "aa"), arr("x", "xy"))),
    ("left", (arr("spark", "sp"), arr(2, -1))),
    ("right", (arr("spark", "sp"), arr(2, 0))),
    ("repeat", (arr("ab", "x", None), arr(3, 0, 2))),
    ("reverse", (arr("abc", ""),)),
    ("concat", (arr("a", None, ""), arr("b", "c", "d"))),
    ("concat_ws", (arr(",", None, "-"), arr("a", "x", None),
                   arr("b", "c", "y"))),
    ("strpos", (arr("hello", "hello", ""), arr("ll", "", "a"))),
    ("instr", (arr("hello"), arr("o"))), ("position", (arr("abc"), arr("z"))),
    ("length", (arr("héllo", "", None),)),
    ("char_length", (arr("abc"),)), ("character_length", (arr("ab"),)),
    ("octet_length", (arr("héllo"),)), ("bit_length", (arr("héllo", ""),)),
    ("ascii", (arr("A", ""),)), ("chr", (arr(66, 322, -1),)),
    ("trim", (arr(" a ", ""),)), ("btrim", (arr("xax"), arr("x"))),
    ("ltrim", (arr("  a "),)), ("rtrim", (arr(" a  "),)),
    ("replace", (arr("banana", "x"), arr("an", "x"), arr("AN", ""))),
    ("string_space", (arr(3, 0, -2),)),
    ("hex", (arr(255, -1, 0),)), ("to_hex", (arr("AB"),)),
    ("ceil", (np.array([1.2, -1.2, np.nan]),)),
    ("floor", (np.array([1.8, -1.2, np.nan]),)),
    ("trunc", (np.array([1.9, -1.9]),)),
    ("round", (np.array([2.5, 3.5, -2.5, 2.675, np.inf]), np.array([0]))),
    ("round", (np.array([1.005, 2.675, -0.125]), np.array([2]))),
    ("nullif", (arr(1, 2, None), arr(1, 3, 1))),
    ("nullifzero", (arr(0, 5, None),)), ("null_if_zero", (arr(0.0, 1.5),)),
    ("coalesce", (arr(None, 5, None), arr(7, 8, None))),
    ("abs", (np.array([-1.5, 2.0, np.nan]),)),
    ("sqrt", (np.array([4.0, 2.0]),)), ("exp", (np.array([0.0, 1.0]),)),
    ("ln", (np.array([1.0, 10.0]),)), ("log", (np.array([2.0]),)),
    ("log10", (np.array([100.0]),)), ("log2", (np.array([8.0]),)),
    ("sin", (np.array([0.5]),)), ("cos", (np.array([0.5]),)),
    ("tan", (np.array([0.5]),)), ("asin", (np.array([0.5]),)),
    ("acos", (np.array([0.5]),)), ("atan", (np.array([0.5]),)),
    ("atan2", (np.array([1.0, -1.0]), np.array([2.0, 0.5]))),
    ("signum", (np.array([-3.0, 0.0, 2.0]),)),
    ("pow", (np.array([2.0, 9.0]), np.array([10.0, 0.5]))),
    ("power", (np.array([3.0]), np.array([2.0]))),
    ("md5", (arr("blaze", ""),)), ("sha224", (arr("blaze"),)),
    ("sha256", (arr("blaze"),)), ("sha384", (arr("b"),)),
    ("sha512", (arr("b"),)), ("sha2", (arr("blaze", "blaze"), arr(0, 1))),
    ("crc32", (arr("blaze", "", None),)),
    ("get_json_object", (arr('{"a": {"b": [1, 2]}, "s": "x"}', "{bad"),
                         arr("$.a.b[1]", "$.s"))),
    ("get_parsed_json_object", (arr('{"s": "x"}'), arr("$.s"))),
    ("parse_json", (arr("{bad", '{"a": 1}'),)),
    ("make_array", (arr(1, 2), arr(3, 4))),
    ("year", (np.array([np.datetime64("2024-03-05")], object),)),
    ("month", (np.array([np.datetime64("2024-03-05")], object),)),
    ("day", (np.array([np.datetime64("2024-03-05")], object),)),
    ("dayofmonth", (np.array([np.datetime64("2024-03-31")], object),)),
    ("dayofweek", (np.array([np.datetime64("2024-03-05"),
                             np.datetime64("1969-12-31")], object),)),
    ("date_add", (np.array([np.datetime64("2024-03-05")], object),
                  arr(30))),
    ("date_sub", (np.array([np.datetime64("2024-03-05")], object), arr(5))),
    ("datediff", (arr(np.datetime64("2024-03-05")),
                  arr(np.datetime64("2024-03-01")))),
    ("hash", (np.array([1, -7, 0, 2**31 - 1], np.int32),
              np.array([5, -1, 2**40, 0], np.int64),
              np.array([0.5, -0.0, 3.25e10, -17.75]),
              arr("", "a", "hello world", None))),
    ("murmur3_hash", (np.array([1.5, 0.0], np.float32), arr("x", "y"))),
    ("isnan", (np.array([np.nan, 1.0]),)),
    ("nanvl", (np.array([np.nan, 1.0]), np.array([7.0, 7.0]))),
]


def _same(a, b) -> bool:
    if isinstance(a, (list, np.ndarray)) and isinstance(b, (list,
                                                           np.ndarray)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    return a == b and type(a) is type(b)


def _fresh_defaults(module, monkeypatch):
    table = {}
    monkeypatch.setattr(module, "PYTHON_FNS", table)
    module._register_default_fns()
    return table


def test_default_table_names_match_jax(monkeypatch):
    port = _fresh_defaults(fallback, monkeypatch)
    jax = _fresh_defaults(jfallback, monkeypatch)
    assert sorted(port) == sorted(jax)
    assert [n for n in functions.registered_names() if n not in port] == []
    assert {n for n, _ in FN_CASES} == set(port)


@pytest.mark.parametrize("k", range(len(FN_CASES)),
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FN_CASES)])
def test_python_fn_matches_jax(k):
    name, args = FN_CASES[k]
    got = list(fallback.PYTHON_FNS[name](*args))
    want = list(jfallback.PYTHON_FNS[name](*args))
    assert _same(got, want), (name, got, want)


def test_murmur3_matches_device():
    """The interpreter's murmur3 equals the port's device hash_columns
    across int32/int64/float64/string columns with nulls."""
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.exprs.hash import hash_columns

    schema = TT.Schema([TT.Field("i", TT.INT32), TT.Field("l", TT.INT64),
                        TT.Field("d", TT.FLOAT64), TT.Field("s", TT.STRING)])
    data = {"i": np.array([1, -7, 0, 2**31 - 1], np.int32),
            "l": np.array([5, -1, 2**40, 0], np.int64),
            "d": np.array([0.5, -0.0, 3.25e10, -17.75]),
            "s": np.array(["", "a", "hello world", "blaze"], object)}
    b = ColumnBatch.from_numpy(data, schema, device="cpu")
    want = hash_columns(b.columns).numpy()[:4]
    got = fallback.PYTHON_FNS["hash"](data["i"], data["l"], data["d"],
                                      data["s"])
    assert list(got) == list(want)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    out = {}
    for suite, (port, jax) in CATALOGUES.items():
        d = tmp_path_factory.mktemp(suite)
        (d / "port").mkdir()
        (d / "jax").mkdir()
        out[suite] = (port.generate_tables(str(d / "port"), rows=ROWS),
                      jax.generate_tables(str(d / "jax"), rows=ROWS))
    return out


@pytest.fixture
def ops_off(monkeypatch):
    """Switch operator kinds off in both packages; the JAX package runs
    its inline runner, the path the port mirrors."""
    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)

    def off(kinds):
        flags = {k: False for k in kinds}
        monkeypatch.setattr(conf, "enable_ops", flags)
        monkeypatch.setattr(jconf, "enable_ops", dict(flags))

    return off


NEVER_CONVERT = [
    ("tpcds", "q02", "bhj", ("hashaggregate",)),
    ("tpcds", "q01", "bhj", ("hashaggregate",)),
    ("tpcds", "q09", "bhj", ("project",)),
    ("core", "q1_scan_filter_project", "bhj", ("filter",)),
    ("core", "q3_join_agg_sort", "smj", ("sortmergejoin",)),
    ("core", "q4_repartition_sort", "bhj", ("sort",)),
    ("core", "q7_left_outer_join", "smj", ("sortmergejoin",)),
    ("core", "q9_substr_group", "bhj", ("hashaggregate",)),
    ("core", "q2_q06_core_agg", "bhj", ("filesourcescan",)),
]
# the JAX package's interpreter fails these; the port's answers them
BOTH_FAIL = [
    ("tpcds", "q03", "bhj", ("broadcasthashjoin",)),
    ("tpcds", "q05", "bhj", ("expand",)),
    ("core", "q5_multijoin_limit", "bhj", ("globallimit", "locallimit")),
    ("core", "q6_semi_join", "bhj", ("broadcasthashjoin",)),
]


def _runs(tables, tmp_path, suite, q, mode):
    port, jax = CATALOGUES[suite]
    (paths, frames), (jpaths, jframes) = tables[suite]
    info = {}

    def run_port():
        return run_plan(port.QUERIES[q](paths, frames, mode)[0],
                        num_partitions=3, work_dir=str(tmp_path / "p"),
                        run_info=info, device="cpu")

    def run_jax():
        return jrun_plan(jax.QUERIES[q](jpaths, jframes, mode)[0],
                         num_partitions=3, work_dir=str(tmp_path / "j"),
                         mesh_exchange="off")

    return run_port, run_jax, info


@pytest.mark.parametrize("suite,q,mode,kinds", NEVER_CONVERT)
def test_never_convert_subtrees_match_jax(tables, ops_off, tmp_path, suite,
                                          q, mode, kinds):
    ops_off(kinds)
    run_port, run_jax, info = _runs(tables, tmp_path, suite, q, mode)
    out = run_port()
    same_rows(out.to_numpy(), run_jax().to_numpy())
    assert info["fallback_exports"] >= 1
    assert info["bridge_rows"] >= 1 and info["bridge_s"] > 0
    assert info["bridge_batches"] >= 1 and info["bridge_card_batches"] == 0
    assert out.device.type == "cpu"


@pytest.mark.parametrize("suite,q,mode,kinds", BOTH_FAIL)
def test_interpreter_failures_match_jax(tables, ops_off, tmp_path, suite, q,
                                        mode, kinds):
    run_port, run_jax, _ = _runs(tables, tmp_path, suite, q, mode)
    want = run_jax().to_numpy()  # the operator left on: native
    ops_off(kinds)
    with pytest.raises((KeyError, TypeError)):
        run_jax()
    same_rows(run_port().to_numpy(), want)


# ---- the expression-subtree wrap (tests/test_expr_subtree_fallback.py) ----

PKGS = {"port": (TT, tir, TP, fallback, apply_strategy),
        "jax": (JT, jir, JP, jfallback, japply)}


def _exotic(a, b):
    av = np.asarray([x if x is not None else np.nan for x in a], np.float64)
    bv = np.asarray([x if x is not None else np.nan for x in b], np.float64)
    return np.sqrt(np.abs(av)) * 3.0 + bv


def _exotic_str(a):
    return np.asarray([None if x is None else f"<{x}>" for x in a], object)


def _mystery_dec(a):
    return np.asarray([float(x) * 2.0 for x in a], np.float64)


for _fb in (fallback, jfallback):
    _fb.register_python_fn("exotic_metric", _exotic)
    _fb.register_python_fn("exotic_str", _exotic_str)
    _fb.register_python_fn("mystery_dec", _mystery_dec)


@pytest.fixture(scope="module")
def kv_table(tmp_path_factory):
    rng = np.random.default_rng(42)
    n = 3000
    df = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                       "v": rng.random(n) * 100 - 20})
    path = str(tmp_path_factory.mktemp("kv") / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df), path)
    return path


def _wrapped_plan(pkg, path):
    T, ir, P, _, _ = PKGS[pkg]
    schema = T.Schema([T.Field("k", T.INT64), T.Field("v", T.FLOAT64)])
    sc = P.scan(schema, [(path, [])])
    return P.project(
        sc, [ir.col("k"),
             ir.ScalarFn("exotic_metric",
                         (ir.Binary(ir.BinOp.MUL, ir.col("v"),
                                    ir.lit(2.0)), ir.col("v")),
                         result_type=T.FLOAT64),
             ir.Binary(ir.BinOp.ADD, ir.col("v"), ir.lit(1.0))],
        ["k", "m", "v1"],
        T.Schema([T.Field("k", T.INT64), T.Field("m", T.FLOAT64),
                  T.Field("v1", T.FLOAT64)]))


def _string_plan(pkg, path):
    T, ir, P, _, _ = PKGS[pkg]
    schema = T.Schema([T.Field("k", T.INT64), T.Field("v", T.FLOAT64)])
    sc = P.scan(schema, [(path, [])])
    return P.project(sc, [ir.col("k"), ir.ScalarFn(
        "exotic_str", (ir.col("v"),), result_type=T.STRING)], ["k", "s"],
        T.Schema([T.Field("k", T.INT64), T.Field("s", T.STRING)]))


def test_wrap_rewrites_like_jax(kv_table):
    """One unknown function with a fixed-width return wraps alone (the
    operator stays native) under the JAX package's resource id; a string
    return stays unwrapped and demotes its operator."""
    for make in (_wrapped_plan, _string_plan):
        plans = {pkg: make(pkg, kv_table) for pkg in PKGS}
        for pkg, plan in plans.items():
            PKGS[pkg][4](plan)
        port, jax = plans["port"], plans["jax"]
        assert port.strategy == jax.strategy
        assert repr(port.attrs["exprs"]) == repr(jax.attrs["exprs"])
    wrapped = _wrapped_plan("port", kv_table)
    apply_strategy(wrapped)
    assert wrapped.strategy != "NeverConvert"
    assert wrapped.attrs["exprs"][1].resource_id == \
        "fallbackfn:exotic_metric:float64"


@pytest.mark.parametrize("make", [_wrapped_plan, _string_plan])
def test_wrapped_plans_match_jax(kv_table, ops_off, tmp_path, make):
    ops_off(())
    info = {}
    out = run_plan(make("port", kv_table), num_partitions=2,
                   work_dir=str(tmp_path / "p"), run_info=info,
                   device="cpu")
    jout = jrun_plan(make("jax", kv_table), num_partitions=2,
                     work_dir=str(tmp_path / "j"), mesh_exchange="off")
    same_rows(out.to_numpy(), jout.to_numpy())
    if make is _wrapped_plan:
        assert info["udf_crossings"] >= 1 and info["fallback_exports"] == 0
    else:
        assert info["fallback_exports"] >= 1


def test_wrapped_expr_on_never_convert_operator(tmp_path, ops_off):
    """The rewrite runs before tagging, so an operator that still tags
    NeverConvert (a wide-decimal column) evaluates the wrapped node on the
    row interpreter, in both packages."""
    from decimal import Decimal

    ops_off(())
    rng = np.random.default_rng(42)
    vals = [Decimal(int(rng.integers(1, 10**15)) * 10**15
                    + int(rng.integers(0, 10**15))).scaleb(-4)
            for _ in range(200)]
    path = str(tmp_path / "w.parquet")
    pq.write_table(pa.Table.from_pandas(
        pd.DataFrame({"a": vals}),
        schema=pa.schema([("a", pa.decimal128(38, 4))])), path)
    outs = {}
    for pkg in PKGS:
        T, ir, P, _, _ = PKGS[pkg]
        sc = P.scan(T.Schema([T.Field("a", T.decimal(38, 4))]),
                    [(path, [])])
        proj = P.project(sc, [ir.ScalarFn(
            "mystery_dec", (ir.Cast(ir.col("a"), T.FLOAT64),),
            result_type=T.FLOAT64)], ["m"],
            T.Schema([T.Field("m", T.FLOAT64)]))
        if pkg == "port":
            outs[pkg] = run_plan(proj, num_partitions=1,
                                 work_dir=str(tmp_path / pkg), device="cpu")
        else:
            outs[pkg] = jrun_plan(proj, num_partitions=1,
                                  work_dir=str(tmp_path / pkg),
                                  mesh_exchange="off")
    same_rows(outs["port"].to_numpy(), outs["jax"].to_numpy())
    np.testing.assert_allclose(
        sorted(float(x) for x in outs["port"].to_numpy()["m"]),
        sorted(float(v) * 2.0 for v in vals), rtol=1e-9)


def test_scalar_subquery_reads_its_provider():
    """A ScalarSubquery compiles to a literal column of its provider's
    value, as in the JAX package."""
    from blaze_tpu.columnar.batch import ColumnBatch as JBatch
    from blaze_tpu.exprs.compiler import compile_expr as jcompile
    from blaze_tpu.runtime import resources as jres
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.exprs.compiler import compile_expr
    from blaze_tpu_torch.runtime import resources

    for value in (7.25, None):
        resources.put("subq:test", lambda v=value: v)
        jres.put("subq:test", lambda v=value: v)
        tb = ColumnBatch.from_numpy({"x": np.arange(5)}, TT.Schema(
            [TT.Field("x", TT.INT64)]), device="cpu")
        jb = JBatch.from_numpy({"x": np.arange(5)}, JT.Schema(
            [JT.Field("x", JT.INT64)]))
        tc = compile_expr(tir.ScalarSubquery("subq:test", TT.FLOAT64),
                          tb.schema)(tb)
        jc = jcompile(jir.ScalarSubquery("subq:test", JT.FLOAT64),
                      jb.schema)(jb)
        live = np.arange(tb.capacity) < 5
        np.testing.assert_array_equal(tc.valid_mask().numpy()[live],
                                      np.asarray(jc.valid_mask())[live])
        if value is not None:
            np.testing.assert_array_equal(tc.data.numpy()[live],
                                          np.asarray(jc.data)[live])
        resources.pop("subq:test")
        jres.pop("subq:test")
