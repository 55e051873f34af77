"""Parity of the port's UDF registry (blaze_tpu_torch/spark/hive_udf.py)
and the UDF wrapper of its compiler with the JAX package's, on the CPU.

The plans of tests/test_hive_udf.py (a ScalaUDF with a numeric return,
which stays native through the UDF wrapper's host crossing; a
HiveSimpleUDF with a string return, whose Project runs on the row
interpreter; an evaluator returning nulls) decode in both packages, with
the same evaluators registered in each, to the same stage bytes and run
through both `run_plan`s to equal rows (floats within rtol 1e-12). An
unregistered UDF is refused at decode time by both. `udf_name` and the
adapter's crossing contract give the JAX package's results.
"""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.config import conf as jconf
from blaze_tpu.spark import hive_udf as jhive
from blaze_tpu.spark import plan_json as jplan_json
from blaze_tpu.spark.convert_strategy import apply_strategy as japply
from blaze_tpu.spark.local_runner import run_plan as jrun_plan
from blaze_tpu.spark.stages import plan_stages as jplan_stages
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.spark import hive_udf, plan_json
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.local_runner import run_plan
from blaze_tpu_torch.spark.stages import plan_stages
from test_plan_json import SPARK, attr, scan_node
from test_torch_plan_json import same_rows, stage_bytes
from torch_parity import no_jax_native


def _squish(v):
    return np.asarray([None if x is None else float(x) * 2 + 1 for x in v])


def _tagit(k):
    return np.asarray([None if x is None else f"row-{int(x)}" for x in k],
                      object)


def _odd_only(k):
    return np.asarray([int(x) if x is not None and int(x) % 2 else None
                       for x in k], object)


def _typed(k):
    """Sensitive to the element type the adapter hands over: a numpy
    integer triples, anything else (a Python int) gives -1."""
    return np.asarray([None if x is None else
                       (x * 3 if isinstance(x, np.integer) else -1)
                       for x in k], object)


UDFS = {"squish": (_squish, "FLOAT64"), "tagit": (_tagit, "STRING"),
        "odd_only": (_odd_only, "INT64"), "typed": (_typed, "INT64")}


@pytest.fixture(autouse=True)
def registered(monkeypatch):
    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)
    for name, (fn, kind) in UDFS.items():
        hive_udf.register_udf(name, fn, getattr(TT, kind))
        jhive.register_udf(name, fn, getattr(JT, kind))


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    rng = np.random.default_rng(42)
    df = pd.DataFrame({"k": np.arange(300, dtype=np.int64),
                       "v": np.round(rng.random(300) * 10, 4)})
    df.loc[::7, "v"] = np.nan      # nulls through the crossing
    p = str(tmp_path_factory.mktemp("udf") / "t.parquet")
    pq.write_table(pa.Table.from_pandas(df), p)
    return p


def _udf_plan(path, udf_tree, out_dtype):
    proj = [{"class": f"{SPARK}.catalyst.expressions.Alias",
             "num-children": 1, "child": 0, "name": "u",
             "exprId": {"id": 77, "jvmId": "x"}, "qualifier": [],
             "dataType": out_dtype}] + udf_tree
    return json.dumps([
        {"class": f"{SPARK}.execution.ProjectExec", "num-children": 1,
         "projectList": [attr("k", "long", 1), proj], "child": 0},
        scan_node([path], [attr("k", "long", 1), attr("v", "double", 2)]),
    ])


def _scala(name, arg, dtype):
    return [{"class": f"{SPARK}.catalyst.expressions.ScalaUDF",
             "num-children": 1, "function": None, "dataType": dtype,
             "children": [0], "udfName": [name]}] + arg


def _hive(name, arg):
    return [{"class": f"{SPARK}.hive.HiveSimpleUDF", "num-children": 1,
             "name": f"default.{name}", "children": [0]}] + arg


PLANS = {
    "scala_numeric": lambda p: _udf_plan(
        p, _scala("squish", attr("v", "double", 2), "double"), "double"),
    "hive_string": lambda p: _udf_plan(
        p, _hive("tagit", attr("k", "long", 1)), "string"),
    "scala_nulls": lambda p: _udf_plan(
        p, _scala("odd_only", attr("k", "long", 1), "bigint"), "long"),
    "scala_typed": lambda p: _udf_plan(
        p, _scala("typed", attr("k", "long", 1), "bigint"), "long"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_udf_plan_matches_jax(table, tmp_path, name):
    text = PLANS[name](table)
    assert stage_bytes(plan_json.decode_plan_json(text), apply_strategy,
                       plan_stages) == \
        stage_bytes(jplan_json.decode_plan_json(text), japply, jplan_stages)
    info = {}
    out = run_plan(plan_json.decode_plan_json(text), num_partitions=1,
                   work_dir=str(tmp_path / "p"), run_info=info,
                   device="cpu")
    jout = jrun_plan(jplan_json.decode_plan_json(text), num_partitions=1,
                     work_dir=str(tmp_path / "j"), mesh_exchange="off")
    same_rows(out.to_numpy(), jout.to_numpy())
    if name == "hive_string":
        # a string return runs on the row interpreter, through the bridge
        assert info["fallback_exports"] == 1 and info["bridge_rows"] == 300
    else:
        assert info["udf_crossings"] >= 1 and info["fallback_exports"] == 0


def test_unregistered_udf_refused_by_both(table):
    text = _udf_plan(table, _hive("nosuch", attr("k", "long", 1)), "string")
    with pytest.raises(jplan_json.PlanJsonError, match="no registered"):
        jplan_json.decode_plan_json(text)
    with pytest.raises(plan_json.PlanJsonError, match="no registered"):
        plan_json.decode_plan_json(text)


def test_names_registry_and_adapter_match_jax():
    assert hive_udf.UDF_CLASSES == jhive.UDF_CLASSES
    for tree in ({"name": "default.fn"}, {"udfName": ["db.g"]},
                 {"udfName": "h"}, {"name": ""}, {}, {"udfName": []}):
        assert hive_udf.udf_name(tree) == jhive.udf_name(tree)
    assert hive_udf.lookup("SQUISH")[0] is _squish
    # the crossing contract: (values, validity) per param (a string param
    # as bytes, lengths, validity) then num_rows, at full capacity
    b = np.zeros((4, 8), np.uint8)
    b[0, :2] = list(b"ab")
    lens = np.array([2, 0, 0, 0], np.int32)
    ok = np.array([True, True, False, False])
    vals = np.array([1.5, -2.0, 0.0, 0.0])
    for fn, kind, args in ((_squish, "FLOAT64", (vals, ok, 3)),
                           (lambda s, x: np.asarray(
                               [None if a is None else len(a) + (y or 0)
                                for a, y in zip(s, x)], object),
                            "INT64", (b, lens, ok, vals, ok, 3))):
        got = hive_udf._adapter(fn, getattr(TT, kind))(*args)
        want = jhive._adapter(fn, getattr(JT, kind))(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # each element reaches the evaluator as the JAX package hands it: a
    # numpy scalar of the column's dtype, None where invalid
    seen = []

    def record(*cols):
        seen.append([[type(x) for x in c] for c in cols])
        return np.zeros(len(cols[0]))

    mask = np.array([True, False, True, True])
    args = [a for dt in (np.int64, np.int32, np.float32, np.float64, bool)
            for a in (np.array([1, 2, 3, 4], dt), mask)] + [3]
    hive_udf._adapter(record, TT.FLOAT64)(*args)
    jhive._adapter(record, JT.FLOAT64)(*args)
    assert seen[0] == seen[1]
