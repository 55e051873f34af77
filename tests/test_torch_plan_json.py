"""Parity of the port's Spark-facing entry (blaze_tpu_torch/spark/
plan_json.py, shims.py, pyspark_ext.py) with the JAX package's, on the
CPU.

The plans of tests/test_plan_json.py and tests/test_shims.py (Spark 3.0-
3.5 TreeNode JSON in each dialect) decode in both packages to the same
stage plans, compared as the bytes of `plan_stages(..., namespace="")`
(the random `__jvm_export__:<uuid>` ids of FFI bridges normalized), and
run through both `run_plan`s to equal rows: integers and strings exactly,
floats within rtol 1e-12, in order. Inputs each package must refuse raise
PlanJsonError in both. The seeded mutations of tests/test_plan_json_fuzz
.py either raise PlanJsonError in both packages or decode to identical
stage bytes; no other exception may escape the port's decoder.
"""

import copy
import json
import random
import re

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import test_plan_json as tpj
import test_plan_json_fuzz as fuzz
from blaze_tpu.config import conf as jconf
from blaze_tpu.spark import plan_json as jplan_json
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.local_runner import run_plan as jrun_plan
from blaze_tpu.spark.stages import plan_stages as jplan_stages
from blaze_tpu_torch.spark import plan_json
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.local_runner import run_plan
from blaze_tpu_torch.spark.stages import plan_stages
from torch_parity import no_jax_native

SPARK = tpj.SPARK
attr, lit, binop, scan_node, agg_expr = (tpj.attr, tpj.lit, tpj.binop,
                                         tpj.scan_node, tpj.agg_expr)


@pytest.fixture
def jax_inline(monkeypatch):
    """The JAX package's inline runner, the path the port mirrors."""
    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("plan_json")
    n_ss, n_dd = 3000, 200
    ss = pd.DataFrame({
        "ss_sold_date_sk": rng.integers(0, n_dd, n_ss),
        "ss_item_sk": rng.integers(0, 25, n_ss),
        "ss_ext_sales_price": np.round(rng.random(n_ss) * 100, 4),
    })
    dd = pd.DataFrame({
        "d_date_sk": np.arange(n_dd),
        "d_moy": ((np.arange(n_dd) // 30) % 12 + 1).astype(np.int32),
    })
    v = pd.DataFrame({"v": rng.random(50) * 10})
    paths = {"ss": str(d / "ss.parquet"), "dd": str(d / "dd.parquet"),
             "v": str(d / "v.parquet"), "ss100": str(d / "ss100.parquet")}
    for name, df in (("ss", ss), ("dd", dd), ("v", v),
                     ("ss100", ss.head(100))):
        pq.write_table(pa.Table.from_pandas(df), paths[name])
    return paths


A_DATE = lambda: attr("ss_sold_date_sk", "long", 1)   # noqa: E731
A_ITEM = lambda: attr("ss_item_sk", "long", 2)        # noqa: E731
A_PRICE = lambda: attr("ss_ext_sales_price", "double", 3)  # noqa: E731


def _filter_scan(p):
    cond = [{"class": f"{SPARK}.catalyst.expressions.GreaterThan",
             "num-children": 2, "left": 0, "right": 1}] + A_PRICE() + \
        [lit(50.0, "double")]
    return [{"class": f"{SPARK}.execution.FilterExec", "num-children": 1,
             "condition": cond, "child": 0},
            scan_node([p["ss"]], [A_DATE(), A_ITEM(), A_PRICE()])]


def _q3_shaped(p):
    dd_cond = [{"class": f"{SPARK}.catalyst.expressions.EqualTo",
                "num-children": 2, "left": 0, "right": 1}] + \
        attr("d_moy", "integer", 5) + [lit(11, "integer")]
    hash_part = [{
        "class": f"{SPARK}.catalyst.plans.physical.HashPartitioning",
        "num-children": 1, "numPartitions": 4, "expressions": [0]}]
    return [
        {"class": f"{SPARK}.execution.aggregate.HashAggregateExec",
         "num-children": 1, "groupingExpressions": [A_ITEM()],
         "aggregateExpressions": [
             agg_expr("Sum", A_PRICE(), "Final", 77, "double")],
         "child": 0},
        {"class": f"{SPARK}.execution.exchange.ShuffleExchangeExec",
         "num-children": 1, "outputPartitioning": hash_part + A_ITEM(),
         "child": 0},
        {"class": f"{SPARK}.execution.aggregate.HashAggregateExec",
         "num-children": 1, "groupingExpressions": [A_ITEM()],
         "aggregateExpressions": [
             agg_expr("Sum", A_PRICE(), "Partial", 77, "double")],
         "child": 0},
        {"class": f"{SPARK}.execution.WholeStageCodegenExec",
         "num-children": 1, "child": 0, "codegenStageId": 1},
        {"class": f"{SPARK}.execution.joins.SortMergeJoinExec",
         "num-children": 2, "leftKeys": [A_DATE()],
         "rightKeys": [attr("d_date_sk", "long", 4)],
         "joinType": "Inner", "condition": None, "left": 0, "right": 1},
        scan_node([p["ss"]], [A_DATE(), A_ITEM(), A_PRICE()]),
        {"class": f"{SPARK}.execution.FilterExec", "num-children": 1,
         "condition": dd_cond, "child": 0},
        scan_node([p["dd"]], [attr("d_date_sk", "long", 4),
                              attr("d_moy", "integer", 5)]),
    ]


def _sort_order(a, direction="Ascending", nulls="NullsFirst"):
    return [{"class": f"{SPARK}.catalyst.expressions.SortOrder",
             "num-children": 1, "child": 0, "direction": direction,
             "nullOrdering": nulls, "sameOrderExpressions": []}] + a


def _take_ordered(p):
    return [{"class": f"{SPARK}.execution.TakeOrderedAndProjectExec",
             "num-children": 1, "limit": 7,
             "sortOrder": [_sort_order(A_PRICE(), "Descending",
                                       "NullsLast")],
             "projectList": None, "child": 0},
            scan_node([p["ss"]], [A_ITEM(), A_PRICE()])]


def _window(p):
    rn = tpj._window_call({"class": f"{SPARK}.catalyst.expressions."
                           "RowNumber", "num-children": 0}, 30,
                          frame_type="RowFrame$")
    sm = tpj._window_call(agg_expr("Sum", A_PRICE(), "Complete", 99,
                                   "double"), 31)
    return [{"class": f"{SPARK}.execution.window.WindowExec",
             "num-children": 1, "windowExpression": [rn, sm],
             "partitionSpec": [A_ITEM()], "orderSpec": [
                 _sort_order(A_PRICE())], "child": 0},
            scan_node([p["ss"]], [A_ITEM(), A_PRICE()])]


def _expand(p):
    return [{"class": f"{SPARK}.execution.ExpandExec", "num-children": 1,
             "projections": [[A_ITEM(), [lit(0, "long")]],
                             [A_ITEM(), [lit(1, "long")]]],
             "output": [A_ITEM(), attr("tag", "long", 40)], "child": 0},
            scan_node([p["ss"]], [A_ITEM()])]


def _generate(p):
    gen = [{"class": f"{SPARK}.catalyst.expressions.Explode",
            "num-children": 1, "child": 0},
           {"class": f"{SPARK}.catalyst.expressions.CreateArray",
            "num-children": 2, "children": [0, 1]}] + A_PRICE() + A_PRICE()
    return [{"class": f"{SPARK}.execution.GenerateExec", "num-children": 1,
             "generator": gen, "requiredChildOutput": [A_ITEM()],
             "outer": False, "generatorOutput": [attr("col", "double", 50)],
             "child": 0},
            scan_node([p["ss"]], [A_ITEM(), A_PRICE()])]


def _bnlj(p):
    cond = binop("LessThan", A_ITEM()[0], attr("d_date_sk", "long", 4)[0])
    return [{"class": f"{SPARK}.execution.joins.BroadcastNestedLoopJoinExec",
             "num-children": 2, "left": 0, "right": 1,
             "buildSide": {"object":
                           f"{SPARK}.catalyst.optimizer.BuildRight$"},
             "joinType": "Cross", "condition": cond},
            scan_node([p["ss100"]], [A_ITEM()]),
            {"class": f"{SPARK}.execution.exchange.BroadcastExchangeExec",
             "num-children": 1, "mode": {}, "child": 0},
            scan_node([p["dd"]], [attr("d_date_sk", "long", 4)])]


def _shim_shell(cls):
    def make(p):
        return [{"class": f"{SPARK}.execution.adaptive.{cls}",
                 "num-children": 1, "child": 0},
                scan_node([p["v"]], [attr("v", "double", 1)])]

    return make


def _cast(fields):
    def make(p):
        cast = [{"class": f"{SPARK}.catalyst.expressions.Cast",
                 "num-children": 1, "child": 0, "dataType": "long",
                 **fields}] + attr("v", "double", 1)
        alias = [{"class": f"{SPARK}.catalyst.expressions.Alias",
                  "num-children": 1, "child": 0, "name": "c",
                  "exprId": {"id": 9, "jvmId": "x"}, "qualifier": []}]
        return [{"class": f"{SPARK}.execution.ProjectExec",
                 "num-children": 1, "projectList": [alias + cast],
                 "child": 0},
                scan_node([p["v"]], [attr("v", "double", 1)])]

    return make


def _promote_precision(p):
    pp = [{"class": f"{SPARK}.catalyst.expressions.PromotePrecision",
           "num-children": 1, "child": 0}] + attr("v", "double", 1)
    return [{"class": f"{SPARK}.execution.FilterExec", "num-children": 1,
             "condition": [{"class": f"{SPARK}.catalyst.expressions."
                            "GreaterThan", "num-children": 2, "left": 0,
                            "right": 1}] + pp + [lit(5.0, "double")],
             "child": 0},
            scan_node([p["v"]], [attr("v", "double", 1)])]


def _limit(offset):
    def make(p):
        return [{"class": f"{SPARK}.execution.GlobalLimitExec",
                 "num-children": 1, "limit": 10, "offset": offset,
                 "child": 0},
                scan_node([p["v"]], [attr("v", "double", 1)])]

    return make


def _window_bad(kind):
    def make(p):
        if kind == "first":
            fa = tpj._window_call(agg_expr("First", A_ITEM(), "Complete",
                                           96, "long"), 62)
            calls = [fa]
        else:
            frame = (tpj.default_frame(frame_type="RowFrame$")
                     if kind == "rows" else
                     [{"class": f"{SPARK}.catalyst.expressions."
                       "SpecifiedWindowFrame", "num-children": 2,
                       "frameType": {}, "lower": 0, "upper": 1},
                      {"class": f"{SPARK}.catalyst.expressions."
                       "UnboundedPreceding$", "num-children": 0},
                      lit(3, "integer")])
            spec = [{"class": f"{SPARK}.catalyst.expressions."
                     "WindowSpecDefinition", "num-children": 1,
                     "frameSpecification": 0}] + frame
            calls = [[{"class": f"{SPARK}.catalyst.expressions.Alias",
                       "num-children": 1, "child": 0, "name": "w60",
                       "exprId": {"id": 60, "jvmId": "x"},
                       "qualifier": []},
                      {"class": f"{SPARK}.catalyst.expressions."
                       "WindowExpression", "num-children": 2,
                       "windowFunction": 0, "windowSpec": 1}]
                     + agg_expr("Sum", A_ITEM(), "Complete", 97, "long")
                     + spec]
        return [{"class": f"{SPARK}.execution.window.WindowExec",
                 "num-children": 1, "windowExpression": calls,
                 "partitionSpec": [], "orderSpec": [], "child": 0},
                scan_node([p["ss"]], [A_ITEM()])]

    return make


# name -> (builder, Spark version)
DECODES = {
    "filter_scan": (_filter_scan, None),
    "q3_shaped": (_q3_shaped, "3.3.2"),
    "take_ordered": (_take_ordered, None),
    "window": (_window, None),
    "expand": (_expand, None),
    "generate": (_generate, None),
    "bnlj": (_bnlj, None),
    "custom_shuffle_reader_30": (_shim_shell("CustomShuffleReaderExec"),
                                 "3.0.2"),
    "custom_shuffle_reader_unversioned": (
        _shim_shell("CustomShuffleReaderExec"), None),
    "result_query_stage_35": (_shim_shell("ResultQueryStageExec"), "3.5.1"),
    "cast_legacy_34": (_cast({"evalMode": "LEGACY"}), "3.4.0"),
    "cast_ansi_off_33": (_cast({"ansiEnabled": False}), "3.3.2"),
    "promote_precision_33": (_promote_precision, "3.3.0"),
    "limit_offset_0_34": (_limit(0), "3.4.1"),
}
REFUSED = {
    "result_query_stage_33": (_shim_shell("ResultQueryStageExec"), "3.3.0"),
    "cast_ansi_34": (_cast({"evalMode": "ANSI"}), "3.4.0"),
    "cast_try_unversioned": (_cast({"evalMode": "TRY"}), None),
    "cast_ansi_33": (_cast({"ansiEnabled": True}), "3.3.0"),
    "limit_offset_34": (_limit(5), "3.4.1"),
    "limit_offset_33": (_limit(5), "3.3.0"),
    "window_bounded_frame": (_window_bad("bounded"), None),
    "window_first": (_window_bad("first"), None),
    "window_rows_frame": (_window_bad("rows"), None),
    "unsupported_node": (lambda p: [{"class": f"{SPARK}.execution."
                                     "SomeExoticExec", "num-children": 0}],
                         None),
    "spark_24": (_filter_scan, "2.4.8"),
    "not_a_plan": (lambda p: {"class": "x"}, None),
}

_EXPORT_ID = re.compile(rb"__jvm_export__:[0-9a-f]{12}")


def stage_bytes(root, apply, stages_of):
    """The stage plans' bytes, FFI export ids normalized."""
    apply(root)
    return [(s.kind, _EXPORT_ID.sub(b"__jvm_export__:*",
                                    s.plan.SerializeToString()))
            for s in stages_of(root, default_partitions=4, namespace="")]


def same_rows(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        g, w = list(got[k]), list(want[k])
        assert len(g) == len(w), k
        assert [x is None for x in g] == [x is None for x in w], k
        gv = [x for x in g if x is not None]
        wv = [x for x in w if x is not None]
        if wv and isinstance(wv[0], (bytes, str)):
            assert gv == wv, k
        elif wv and isinstance(wv[0], (float, np.floating)):
            np.testing.assert_allclose(np.array(gv, np.float64),
                                       np.array(wv, np.float64),
                                       rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(np.array(gv), np.array(wv),
                                          err_msg=k)


@pytest.mark.parametrize("name", sorted(DECODES))
def test_decoded_plan_matches_jax(tables, jax_inline, tmp_path, name):
    build, version = DECODES[name]
    text = json.dumps(build(tables))
    port = plan_json.decode_plan_json(text, version)
    jax = jplan_json.decode_plan_json(text, version)
    assert stage_bytes(port, apply_strategy, plan_stages) == \
        stage_bytes(jax, japply, jplan_stages)
    out = run_plan(plan_json.decode_plan_json(text, version),
                   num_partitions=2, work_dir=str(tmp_path / "p"),
                   device="cpu")
    jout = jrun_plan(jplan_json.decode_plan_json(text, version),
                     num_partitions=2, work_dir=str(tmp_path / "j"),
                     mesh_exchange="off")
    same_rows(out.to_numpy(), jout.to_numpy())


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_in_both(tables, name):
    build, version = REFUSED[name]
    text = json.dumps(build(tables))
    with pytest.raises(jplan_json.PlanJsonError):
        jplan_json.decode_plan_json(text, version)
    with pytest.raises(plan_json.PlanJsonError):
        plan_json.decode_plan_json(text, version)


def test_datatypes_and_shims_match_jax():
    from blaze_tpu.spark import shims as jshims
    from blaze_tpu_torch.spark import shims

    for dt in ("long", "double", "decimal(12,2)", "string", "date",
               {"type": "array", "elementType": "long",
                "containsNull": True},
               {"type": "map", "keyType": "string", "valueType": "double"},
               {"type": "struct", "fields": [
                   {"name": "a", "type": "integer", "nullable": False}]}):
        assert repr(plan_json.decode_datatype(dt)) == \
            repr(jplan_json.decode_datatype(dt))
    for bad in ("wat", {"type": "udt"}, 3):
        with pytest.raises(plan_json.PlanJsonError):
            plan_json.decode_datatype(bad)
    for v in (None, "3.0.3", "3.1.1", "3.2.0", "3.3.2", "3.4.1", "3.5.0",
              "3.6.0", "4.0.0"):
        assert shims.for_version(v).version == jshims.for_version(v).version
        assert shims.for_version(v).transparent_wrappers() == \
            jshims.for_version(v).transparent_wrappers()
    for v in ("2.4.8", "nonsense"):
        with pytest.raises(shims.ShimError):
            shims.for_version(v)


def _fuzz_outcome(decode, apply, stages_of, error, text, version=None):
    try:
        root = decode(text, version)
    except error:
        return "PlanJsonError"
    try:
        return stage_bytes(root, apply, stages_of)
    except Exception as e:  # noqa: BLE001 - compared between packages
        return type(e).__name__


def _both(text, version=None):
    got = _fuzz_outcome(plan_json.decode_plan_json, apply_strategy,
                        plan_stages, plan_json.PlanJsonError, text, version)
    want = _fuzz_outcome(jplan_json.decode_plan_json, japply,
                         jplan_stages, jplan_json.PlanJsonError, text,
                         version)
    assert got == want


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_mutations_match_jax(seed):
    """The seeded mutations of tests/test_plan_json_fuzz.py (field order,
    unknown fields, dropped fields, junk values, unknown classes,
    truncated node lists, mixed dialects): the same outcome in both
    packages."""
    rng = random.Random(seed)
    for base in fuzz._corpus():
        mutated = fuzz._shuffle_keys(copy.deepcopy(base), rng)
        for d in fuzz._all_dicts(mutated, []):
            if rng.random() < 0.3:
                d[f"__future_field_{rng.randrange(99)}"] = rng.choice(
                    [None, 1, "x", [], {"nested": True}])
        _both(json.dumps(mutated))
    for k in range(5):
        rng = random.Random(1000 + 5 * seed + k)
        base = copy.deepcopy(rng.choice(fuzz._corpus()))
        dicts = fuzz._all_dicts(base, [])
        for _ in range(rng.randrange(1, 4)):
            d = rng.choice(dicts)
            action = rng.randrange(4)
            if action == 0 and d:
                d.pop(rng.choice(list(d.keys())), None)
            elif action == 1 and d:
                d[rng.choice(list(d.keys()))] = rng.choice(
                    [None, -1, "garbage", [], {}, 2 ** 67, [1, 2, 3]])
            elif action == 2:
                d["class"] = f"{SPARK}.execution.TotallyUnknownExec"
            elif isinstance(base, list) and len(base) > 1:
                base.pop()
        _both(json.dumps(base))
    rng = random.Random(2000 + seed)
    base = copy.deepcopy(rng.choice(fuzz._corpus()))
    for d in fuzz._all_dicts(base, []):
        if rng.random() < 0.3:
            d["evalMode"] = rng.choice(
                [{"object": "org.apache.spark.sql.catalyst.expressions."
                  "EvalMode$LEGACY"}, "ANSI", "TRY", 3, None])
        if rng.random() < 0.2:
            d["ansiEnabled"] = rng.choice([True, False, "yes", None])
    for version in ("3.0.3", "3.3.2", "3.4.1", "3.5.0", None, "weird"):
        _both(json.dumps(base), version)


def test_pyspark_ext_gated():
    """The module imports without pyspark; run_sql runs on the card by
    default (device=None)."""
    import importlib
    import inspect

    from blaze_tpu_torch.spark import pyspark_ext

    importlib.reload(pyspark_ext)
    assert isinstance(pyspark_ext.pyspark_available(), bool)
    assert "device=None" in inspect.getsource(pyspark_ext.run_sql)


# ---- chip_smoke.py's runner_spark_json plans, at a tiny size ----

@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    """chip_smoke.py's TPC-DS files at 2^14-row fact files and dimensions
    cut 100x, its JSON oracles, and its UDFs registered in both
    packages."""
    import chip_smoke as cs
    from blaze_tpu.columnar import types as JT
    from blaze_tpu.spark import hive_udf as jhive

    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "FACT_FILE_ROWS", 1 << 14)
    mp.setattr(cs, "TPCDS_FILES", {"web_sales": 2, "catalog_sales": 2,
                                   "store_sales": 2})
    mp.setattr(cs, "CUSTOMERS", 3000)
    mp.setattr(cs, "SS_DIMS", (("item", 2000), ("cdemo", 2000),
                               ("store", 40), ("promo", 100)))
    mp.setattr(cs, "DIM_ROWS", {"item": 2000, "customer": 3000,
                                "customer_address": 1000,
                                "customer_demographics": 2000,
                                "store": 40, "promotion": 100})
    mp.setattr(cs, "STORES", 40)
    mp.setattr(cs, "SR_ROWS", 1 << 12)
    paths, orc = cs.write_tpcds(str(tmp_path_factory.mktemp("smoke")),
                                seed=7)
    cs.register_json_udfs()
    jhive.register_udf("item_label", cs._item_label, JT.STRING)
    jhive.register_udf("profit_band", cs._profit_band, JT.INT64)
    jhive.register_udf("sort_key", cs._sort_key, JT.STRING)
    yield cs, paths, orc, cs.json_oracles(paths)
    mp.undo()


@pytest.mark.parametrize("q", ["json_q02", "json_report",
                               "json_report_arith", "json_udf"])
def test_smoke_json_plans_match_jax(smoke_data, jax_inline, tmp_path, q):
    """Each plan of chip_smoke.py's runner_spark_json decodes to the JAX
    package's stage bytes and rows, and passes the phase's own numpy,
    hashlib and zlib check on the CPU. json_report's dayofweek is the one
    departure: the JAX decoder has no DayOfWeek entry and refuses the
    plan, the port decodes it; its rows are held to the oracle alone.
    json_report_arith is the same report with the weekday computed from
    the date key, so the rest of the report is held to the JAX package's
    stage bytes and rows too."""
    cs, paths, orc, jorc = smoke_data
    if q == "json_report_arith":
        text = cs.json_report(paths, dayofweek=False)
    else:
        text = cs.JSON_QUERIES[q](paths)
    port = plan_json.decode_plan_json(text, cs.JSON_VERSION)
    info = {}
    out = run_plan(port, num_partitions=4, work_dir=str(tmp_path / "p"),
                   run_info=info, device="cpu")
    if q == "json_report":
        with pytest.raises(jplan_json.PlanJsonError, match="DayOfWeek"):
            jplan_json.decode_plan_json(text, cs.JSON_VERSION)
        cs.check_json_report(out, jorc)
        assert info["hostfn_crossings"] >= 2
        return
    assert stage_bytes(plan_json.decode_plan_json(text, cs.JSON_VERSION),
                       apply_strategy, plan_stages) == stage_bytes(
        jplan_json.decode_plan_json(text, cs.JSON_VERSION), japply,
        jplan_stages)
    jout = jrun_plan(jplan_json.decode_plan_json(text, cs.JSON_VERSION),
                     num_partitions=4, work_dir=str(tmp_path / "j"),
                     mesh_exchange="off")
    same_rows(out.to_numpy(), jout.to_numpy())
    if q == "json_report_arith":
        cs.check_json_report(out, jorc)
        assert info["hostfn_crossings"] >= 2
    elif q == "json_udf":
        cs.check_json_udf(out, jorc)
        assert info["fallback_exports"] >= 1 and info["udf_crossings"] >= 1
    else:
        runner = run_plan(cs._runner_plan("q02", paths),
                          work_dir=str(tmp_path / "r"), device="cpu")
        cs.check_json_q02(out, orc, runner.to_numpy())
