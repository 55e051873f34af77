"""The port's main path against the JAX package and a numpy oracle, on the
CPU: bench.py's q06 plan (ffi_reader -> filter -> project -> partial/final
agg) as TaskDefinition bytes, decoded and collected in both packages over
the identical batches (4 x 2^12 rows, 2^10 groups). Keys and counts must be
equal, float sums within rtol 1e-12 of the JAX package and 1e-9 of numpy.

Also: collect_arrow, a partial-only plan, an avg aggregate, min/max on the dense path,
the fallback of stages the dense path declines, the typed
NotImplementedError of undecoded plan nodes, the import guard that keeps
jax, `blaze_tpu` and (at import) pandas out of the port, and the no-CUDA
construction error.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
from blaze_tpu.runtime import resources as jres
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.plan import plan_pb2 as tpb
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.runtime.executor import collect, collect_fetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, N_BATCHES, GROUPS = 1 << 12, 4, 1 << 10
JSCHEMA = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in [
    ("ss_item_sk", "INT32"), ("ss_quantity", "INT32"),
    ("ss_sales_price", "FLOAT64"), ("ss_ext_sales_price", "FLOAT64")]])


@pytest.fixture
def small(monkeypatch):
    """chip_smoke's copies of bench.py's workload, cut to test size."""
    monkeypatch.setattr(cs, "ROWS", ROWS)
    monkeypatch.setattr(cs, "GROUPS", GROUPS)
    return cs


def _both(datas, key_offset=0):
    """The same batches in both packages (the port's carried over from
    the JAX batches' host arrays) registered under one resource id."""
    jbs = []
    for d in datas:
        d = dict(d, ss_item_sk=d["ss_item_sk"] + key_offset)
        jbs.append(JBatch.from_numpy(d, JSCHEMA, capacity=ROWS))
    tbs = [ColumnBatch.from_host_arrays(
        cs.SCHEMA, [(np.asarray(c.data), None) for c in jb.columns],
        int(jb.num_rows), jb.capacity, device="cpu") for jb in jbs]
    rid = resources.register(lambda: iter(tbs))
    jres.put(rid, lambda: iter(jbs))
    return rid


def _sorted(res: dict, key="ss_item_sk"):
    order = np.argsort(np.asarray(res[key]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in res.items()}


def _run(task: bytes):
    plan, _ = decode_task_definition(task)
    jplan, _ = jdecode(task)
    out = collect(plan)
    assert out.device == torch.device("cpu")
    return _sorted(out.to_numpy()), _sorted(jcollect(jplan).to_numpy()), out


def test_bench_plan_matches_jax_and_numpy(small):
    datas = [small._make_data(s) for s in range(N_BATCHES)]
    rid = _both(datas)
    task = small._build_task(small.SCHEMA_PB, rid)
    t, j, out = _run(task)
    assert set(t) == {"ss_item_sk", "sum_amount", "cnt"}
    np.testing.assert_array_equal(t["ss_item_sk"], j["ss_item_sk"])
    np.testing.assert_array_equal(t["cnt"], j["cnt"])
    np.testing.assert_allclose(t["sum_amount"], j["sum_amount"], rtol=1e-12)
    ref = small._item_oracle(datas)
    ref_sums, ref_cnts = ref["sum_amount"], ref["cnt"]
    nz = ref_cnts > 0
    np.testing.assert_array_equal(t["ss_item_sk"], np.nonzero(nz)[0])
    np.testing.assert_array_equal(t["cnt"], ref_cnts[nz])
    np.testing.assert_allclose(t["sum_amount"], ref_sums[nz], rtol=1e-9)
    assert out.schema.names() == ["ss_item_sk", "sum_amount", "cnt"]
    assert repr(out.columns[2].dtype) == "int64"


def test_collect_arrow_matches_jax(small):
    """executor.collect_arrow: the collected rows as one Arrow batch, the
    JAX package's schema and values (sums within rtol 1e-12)."""
    from blaze_tpu.runtime.executor import collect_arrow as jcollect_arrow
    from blaze_tpu_torch.runtime.executor import collect_arrow

    rid = _both([small._make_data(s) for s in range(N_BATCHES)])
    task = small._build_task(small.SCHEMA_PB, rid)
    rb = collect_arrow(decode_task_definition(task)[0])
    jrb = jcollect_arrow(jdecode(task)[0])
    assert rb.schema == jrb.schema and rb.num_rows == jrb.num_rows > 0
    t = _sorted({k: rb.column(k).to_numpy() for k in rb.schema.names})
    j = _sorted({k: jrb.column(k).to_numpy() for k in jrb.schema.names})
    np.testing.assert_array_equal(t["ss_item_sk"], j["ss_item_sk"])
    np.testing.assert_array_equal(t["cnt"], j["cnt"])
    np.testing.assert_allclose(t["sum_amount"], j["sum_amount"], rtol=1e-12)


def test_collect_fetch_digest_and_memo(small):
    """collect_fetch returns the packed result on the host; a second run
    reuses the memoized dense range and gives the same digest."""
    datas = [small._make_data(s) for s in range(N_BATCHES)]
    rid = _both(datas)
    plan, _ = decode_task_definition(small._build_task(small.SCHEMA_PB, rid))
    full = collect_fetch(plan, small._full)
    d1 = collect_fetch(plan, small._digest)
    d2 = collect_fetch(plan, small._digest)
    assert isinstance(full, np.ndarray) and full.dtype == np.float64
    np.testing.assert_array_equal(d1, d2)
    cap = (len(full) - 1) // 3
    n = int(full[0])
    w = (np.arange(cap) % 8191.0) + 1.0
    wl = np.where(np.arange(cap) < n, w, 0.0)
    np.testing.assert_allclose(
        d1, [n, full[1:1 + cap] @ wl, full[1 + cap:1 + 2 * cap] @ wl,
             full[1 + 2 * cap:] @ wl], rtol=1e-12)
    assert plan.metrics["stage_compiled"] == 3
    assert plan.metrics["output_rows"] == 3 * n


def test_partial_only_plan_state_columns(small):
    datas = [small._make_data(s) for s in range(N_BATCHES)]
    rid = _both(datas)
    task = small._build_task(small.SCHEMA_PB, rid, final=False)
    t, j, out = _run(task)
    names = out.schema.names()
    assert names == ["ss_item_sk", "#9223372036854775807.0.sum",
                     "#9223372036854775807.0.nonempty",
                     "#9223372036854775807.1.count"]
    assert list(t) == list(j) == names
    np.testing.assert_array_equal(t[names[0]], j[names[0]])
    np.testing.assert_allclose(t[names[1]], j[names[1]], rtol=1e-12)
    np.testing.assert_array_equal(t[names[2]], j[names[2]])
    np.testing.assert_array_equal(t[names[3]], j[names[3]])


@pytest.mark.parametrize("final", [True, False])
def test_avg_aggregate(small, final):
    datas = [small._make_data(s) for s in range(N_BATCHES)]
    rid = _both(datas, key_offset=5000)  # non-zero key minimum
    task = small._build_task(small.SCHEMA_PB, rid,
                             agg_fns=("avg", "count", "sum"), final=final)
    t, j, _ = _run(task)
    assert list(t) == list(j)
    for k in t:
        if t[k].dtype.kind == "f":
            np.testing.assert_allclose(t[k], j[k], rtol=1e-12)
        else:
            np.testing.assert_array_equal(t[k], j[k])
    if final:
        ref = small._item_oracle(datas)
        ref_sums, ref_cnts = ref["sum_amount"], ref["cnt"]
        nz = ref_cnts > 0
        np.testing.assert_array_equal(t["ss_item_sk"] - 5000,
                                      np.nonzero(nz)[0])
        np.testing.assert_allclose(t["avg_amount"],
                                   ref_sums[nz] / ref_cnts[nz], rtol=1e-9)


def _plan_with_source(batches, **task_kw):
    rid = resources.register(lambda: iter(batches))
    return decode_task_definition(cs._build_task(cs.SCHEMA_PB, rid,
                                                 **task_kw))[0]


def _oracle_check(out, datas):
    """`out` (a finalized sum/count plan) against chip_smoke's numpy
    oracle, over keys up to the largest in `datas`."""
    t = _sorted(out.to_numpy())
    size = 1 + max(int(d["ss_item_sk"].max()) for d in datas)
    ref = cs._numpy_grouped(
        datas, lambda i, keep: datas[i]["ss_item_sk"][keep], size)
    nz = ref["cnt"] > 0
    np.testing.assert_array_equal(t["ss_item_sk"], np.nonzero(nz)[0])
    np.testing.assert_array_equal(t["cnt"], ref["cnt"][nz])
    np.testing.assert_allclose(t["sum_amount"], ref["sum_amount"][nz],
                               rtol=1e-9)


def test_key_range_beyond_dense_range_raises(small):
    """No longer raises: a key range one bucket past dense_agg_range makes
    the dense path decline after draining the source, and the captured
    batches replay through the streaming AggExec. Equal to the JAX
    package's answer from the same bytes, and to numpy."""
    datas = [small._make_data(s) for s in range(2)]
    datas[1]["ss_item_sk"][0] = (1 << 16) + 7   # range one bucket too wide
    datas[1]["ss_quantity"][0] = 1
    datas[1]["ss_sales_price"][0] = 50.0
    task = small._build_task(small.SCHEMA_PB, _both(datas))
    t, j, out = _run(task)
    np.testing.assert_array_equal(t["ss_item_sk"], j["ss_item_sk"])
    np.testing.assert_array_equal(t["cnt"], j["cnt"])
    np.testing.assert_allclose(t["sum_amount"], j["sum_amount"], rtol=1e-12)
    _oracle_check(out, datas)
    plan, _ = decode_task_definition(task)
    collect(plan)
    assert plan.metrics["stage_compiled"] == 0
    assert plan.metrics["stage_fallbacks"] == 1
    assert plan.metrics["collapses"] >= 1


def test_min_max_aggregates_raise(small):
    """No longer raises: min/max, which made the dense path decline, now
    ride its dense carriers, equal to the JAX package's answer."""
    datas = [small._make_data(s) for s in range(N_BATCHES)]
    rid = _both(datas)
    td = tpb.TaskDefinition.FromString(cs._build_task(cs.SCHEMA_PB, rid))
    for node in (td.plan.agg, td.plan.agg.input.agg):
        node.aggs[0].fn = tpb.AGG_MIN
    task = td.SerializeToString()
    t, j, _ = _run(task)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    plan, _ = decode_task_definition(task)
    collect(plan)
    assert plan.metrics["stage_compiled"] == 1


def test_batches_of_different_shapes_raise(small):
    """No longer raises: batches of two capacities fall back to the
    streaming AggExec over the captured batches."""
    d = small._make_data(0)
    plan = _plan_with_source([
        ColumnBatch.from_numpy(d, cs.SCHEMA, device="cpu"),
        ColumnBatch.from_numpy(d, cs.SCHEMA, capacity=2 * ROWS,
                               device="cpu")])
    _oracle_check(collect(plan), [d, d])
    assert plan.metrics["stage_fallbacks"] == 1


@pytest.mark.parametrize("arm", ["sort", "union", "limit", "parquet_scan"])
def test_undecodable_node_raises(arm):
    """A plan node the port does not decode raises naming it. Every arm
    the JAX decoder decodes decodes in the port, so what is left is a node
    with no arm set (below sort, union and limit: "plan node None") and
    the `row_num` expression, which neither package decodes (parquet_scan's
    pruning predicate)."""
    node = tpb.PlanNode()
    getattr(node, arm).SetInParent()
    if arm != "parquet_scan":
        inner = (node.union.inputs.add() if arm == "union"
                 else getattr(node, arm).input)
        inner.Clear()
    else:
        node.parquet_scan.pruning_predicates.add().row_num.SetInParent()
    td = tpb.TaskDefinition()
    td.plan.CopyFrom(node)
    name = ("expression kind row_num" if arm == "parquet_scan"
            else "plan node None")
    with pytest.raises(NotImplementedError, match=name):
        decode_task_definition(td.SerializeToString())


def test_ffi_reader_rejects_arrow_batches():
    """Arrow RecordBatches are ingested (columnar/arrow_io.py), string,
    list and wide-decimal columns included: a decimal128(30, 2) column
    comes out as its limb planes and round-trips to the same values."""
    import decimal

    import pyarrow as pa

    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.shuffle import FfiReaderExec

    schema = TT.Schema([TT.Field("a", TT.INT32),
                        TT.Field("l", TT.list_of(TT.INT32))])
    rb = pa.record_batch([pa.array([1, 2], pa.int32()),
                          pa.array([[1], None], pa.list_(pa.int32()))],
                         names=["a", "l"])
    rid = resources.register(lambda: iter([rb]))
    out = list(FfiReaderExec(schema, rid).execute(ExecContext(device="cpu")))
    assert [None if v is None else list(v)
            for v in out[0].to_numpy()["l"]] == [[1], None]
    wide = TT.Schema([TT.Field("a", TT.INT32),
                      TT.Field("d", TT.decimal(30, 2))])
    rb = pa.record_batch([pa.array([1], pa.int32()),
                          pa.array([decimal.Decimal("1.5")],
                                   pa.decimal128(30, 2))], names=["a", "d"])
    rid = resources.register(lambda: iter([rb]))
    out = list(FfiReaderExec(wide, rid).execute(ExecContext(device="cpu")))
    assert out[0].to_numpy()["d"] == [150]
    assert out[0].columns[1].data.children[1].data[0].item() == 150
    from blaze_tpu_torch.columnar.arrow_io import batch_to_arrow

    assert batch_to_arrow(out[0]).column(1).to_pylist() == [
        decimal.Decimal("1.50")]
    strs = TT.Schema([TT.Field("a", TT.INT32), TT.Field("s", TT.STRING)])
    rb = pa.record_batch([pa.array([1, 2], pa.int32()),
                          pa.array(["x", None])], names=["a", "s"])
    rid = resources.register(lambda: iter([rb]))
    out = list(FfiReaderExec(strs, rid).execute(ExecContext(device="cpu")))
    np.testing.assert_array_equal(out[0].to_numpy()["a"], [1, 2])
    assert out[0].to_numpy()["s"] == [b"x", None]


def test_plan_bytes_decode_in_both_packages():
    """Both plan_pb2 modules load in one process (the proto file is added
    to the default pool twice and deduped) and parse the same bytes."""
    task = cs._build_task(cs.SCHEMA_PB, "rid:x")
    a = jpb.TaskDefinition.FromString(task)
    b = tpb.TaskDefinition.FromString(task)
    assert a.SerializeToString() == b.SerializeToString() == task
    assert jpb.DESCRIPTOR.name == tpb.DESCRIPTOR.name == "plan.proto"
    assert tpb.DESCRIPTOR.package == "blaze_tpu.plan"


def test_port_imports_neither_jax_nor_blaze_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import blaze_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    blaze_tpu_torch.__path__, 'blaze_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "need = {'blaze_tpu_torch.' + m for m in ('ops.join', 'ops.parquet',\n"
        "        'columnar.arrow_io', 'runtime.filesystem', 'plan.to_proto',\n"
        "        'plan.fingerprint', 'spark.plan_model', 'spark.converters',\n"
        "        'spark.expr_subtree_fallback', 'spark.convert_strategy',\n"
        "        'spark.stages', 'spark.aqe', 'spark.shuffle_manager',\n"
        "        'spark.local_runner', 'spark.tpcds', 'spark.validator',\n"
        "        'exprs.strings', 'exprs.functions', 'exprs.hostfns',\n"
        "        'spark.fallback', 'spark.hive_udf', 'spark.shims',\n"
        "        'spark.plan_json', 'spark.pyspark_ext', 'runtime.trace',\n"
        "        'runtime.faults', 'runtime.pipeline', 'runtime.supervisor',\n"
        "        'runtime.journal', 'runtime.monitor', 'parallel.shuffle',\n"
        "        'parallel.stage_exchange', 'runtime.history',\n"
        "        'runtime.doctor', 'runtime.progress',\n"
        "        'runtime.flight_recorder', 'runtime.profiler',\n"
        "        'runtime.executor_pool', 'runtime.shuffle_server',\n"
        "        'runtime.compile_service', 'runtime.jit_cache',\n"
        "        'runtime.native_entry', 'native', 'tools.chaos_soak',\n"
        "        'tools.trace_report', 'tools.history_report',\n"
        "        'tools.blaze_doctor', 'tools.blaze_inspect', 'tools.blaze_top',\n"
        "        'tools.blaze_prof', 'tools.blazelint',\n"
        "        'tools.blazelint.__main__', 'tools.pipeline_bench',\n"
        "        'tools.zerocopy_bench', 'tools.perf_baseline',\n"
        "        'tools.mesh_scaling', 'tools.compile_warm_bench')}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'blaze_tpu' or k.startswith('blaze_tpu.')\n"
        "       or k == 'tools' or k.startswith('tools.')\n"
        "       or k == 'pandas' or k.startswith('pandas.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|blaze_tpu|tools)(\.|\s|$)",
                     re.M)
    srcs = [os.path.join(dp, f) for dp, _, fs in os.walk(
        os.path.join(REPO, "blaze_tpu_torch")) for f in fs
        if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    offenders = [p for p in srcs if pat.search(open(p).read())]
    assert offenders == []
    # the native binding and the C++ the port adds name no module of the
    # JAX package (the task entry calls blaze_tpu_torch's native_entry)
    native_srcs = [os.path.join(REPO, "blaze_tpu_torch", "native",
                                "__init__.py")] + [
        os.path.join(REPO, "blaze_tpu_torch", "csrc", f)
        for f in ("task_runtime.cpp", "zstd_codec.cpp")]
    mod = re.compile(r"\bblaze_tpu\.")
    assert [p for p in native_srcs if mod.search(open(p).read())] == []
    assert "blaze_tpu_torch.runtime.native_entry" in open(
        native_srcs[1]).read()


def test_from_numpy_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ColumnBatch.from_numpy({"x": np.arange(4, dtype=np.int32)},
                               TT.Schema([TT.Field("x", TT.INT32)]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ColumnBatch.empty(TT.Schema([TT.Field("x", TT.INT32)]))
