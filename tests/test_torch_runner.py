"""The port's `run_plan` against the JAX package's, on the CPU.

Each package generates its tables from the same seed (the TPC-DS
catalogue's at 6000 store_sales rows, the validator core catalogue's at
6000), makes each plan with its own query function, and runs it through
its own `run_plan`: the port at its defaults (the supervisor's pool of
four, the threaded pipeline, the device-mesh exchange on its one CPU
device, the monitor), the JAX package with `mesh_exchange="off"` and its
supervisor and pipeline off, with its native layer taken out
(`no_jax_native`); a few cases run both packages at their defaults, the
port's mesh patched to as many logical CPU devices as the JAX package's
exchange uses of its eight. The results must be equal row for row, in
order (integers bitwise, floats within rtol 1e-12), each package's answer
must pass its validator's `_compare` against the pandas oracle, and the
two runs must agree on `run_info`'s shuffle stages (the port's mesh and
file stages together against the JAX package's file stages),
`broadcast_stages` and on the whole-stage routes (`stage_compiled`,
`stage_fallbacks`; the JAX package counts neither per query, so the test
tallies its metric updates).

Every plan arm the JAX decoder decodes must decode in the port. What the
port's runner leaves out must raise NotImplementedError naming the
missing module: every conf knob that would switch on an unported
module. A NeverConvert subtree runs on the row
interpreter, which raises, as the JAX package's does, for an operator or
a function it has no body for.
"""

import os
import re

import jax
import numpy as np
import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import metrics as jmetrics
from blaze_tpu.runtime import stage_compiler as jstage
from blaze_tpu.spark import tpcds as jtpcds
from blaze_tpu.spark import validator as jvalidator
from blaze_tpu.spark.local_runner import run_plan as jrun_plan
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import col as ir_col
from blaze_tpu_torch.plan import decode_plan
from blaze_tpu_torch.spark import plan_model as P
from blaze_tpu_torch.spark import tpcds, validator
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.local_runner import run_plan
from blaze_tpu_torch.spark.stages import plan_stages
from torch_parity import assert_same_stages, no_jax_native

ROWS = 6000
CATALOGUES = {"tpcds": (tpcds, jtpcds), "core": (validator, jvalidator)}
RUNS = [("tpcds", "q02", "bhj"), ("tpcds", "q02", "smj"),
        ("tpcds", "q04", "bhj"), ("tpcds", "q04", "smj"),
        ("tpcds", "q09", "bhj"),
        ("core", "q1_scan_filter_project", "bhj"),
        ("core", "q2_q06_core_agg", "bhj"),
        ("core", "q3_join_agg_sort", "bhj"),
        ("core", "q3_join_agg_sort", "smj"),
        ("core", "q4_repartition_sort", "bhj"),
        ("core", "q6_semi_join", "bhj"),
        ("core", "q6_semi_join", "smj")]
# the queries that carry string columns, and q05's ROLLUP (an Expand), in
# both join modes
RUNS += [(suite, q, mode)
         for suite, q in [("tpcds", "q01"), ("tpcds", "q03"),
                          ("tpcds", "q05"),
                          ("tpcds", "q06"), ("tpcds", "q07"),
                          ("tpcds", "q08"), ("tpcds", "q10"),
                          ("core", "q5_multijoin_limit"),
                          ("core", "q7_left_outer_join"),
                          ("core", "q8_category_like"),
                          ("core", "q9_substr_group")]
         for mode in ("bhj", "smj")]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Each package's tables, written from the same seed."""
    out = {}
    for suite, (port, jax) in CATALOGUES.items():
        d = tmp_path_factory.mktemp(suite)
        (d / "port").mkdir()
        (d / "jax").mkdir()
        out[suite] = (port.generate_tables(str(d / "port"), rows=ROWS),
                      jax.generate_tables(str(d / "jax"), rows=ROWS))
    return out


@pytest.fixture
def jax_routes(monkeypatch):
    """Tally the JAX package's whole-stage routes under the port's names:
    its operators' `stage_compiled` metric updates (not the process-wide
    compile-service tally), and its `_fallback` calls."""
    from blaze_tpu.runtime import compile_service

    counts = {"stage_compiled": 0, "stage_fallbacks": 0}
    real_add, real_fallback = jmetrics.MetricsSet.add, jstage._fallback

    def add(self, name, delta):
        if name in counts and self is not compile_service.TELEMETRY:
            counts[name] += int(delta)
        return real_add(self, name, delta)

    def fallback(root, *args):
        counts["stage_fallbacks"] += 1
        return real_fallback(root, *args)

    monkeypatch.setattr(jmetrics.MetricsSet, "add", add)
    monkeypatch.setattr(jstage, "_fallback", fallback)
    # the JAX package's tasks one after another on the driver thread
    monkeypatch.setattr(jconf, "enable_supervisor", False)
    monkeypatch.setattr(jconf, "enable_pipeline", False)
    no_jax_native(monkeypatch)
    return counts


def _same_rows(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert len(g) == len(w), k
        gnull = np.array([x is None for x in g], bool)
        wnull = np.array([x is None for x in w], bool)
        np.testing.assert_array_equal(gnull, wnull, err_msg=k)
        g, w = g[~gnull], w[~wnull]
        if any(isinstance(x, (bytes, str)) for x in w):
            assert list(g) == list(w), k
        elif any(isinstance(x, float) for x in w) or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


@pytest.mark.parametrize("suite,q,mode", RUNS)
def test_run_plan_matches_jax(tables, jax_routes, tmp_path, suite, q, mode):
    port, jax = CATALOGUES[suite]
    (paths, frames), (jpaths, jframes) = tables[suite]
    plan, oracle = port.QUERIES[q](paths, frames, mode)
    info = {}
    out = run_plan(plan, num_partitions=4, work_dir=str(tmp_path / "port"),
                   run_info=info, device="cpu")
    jplan, joracle = jax.QUERIES[q](jpaths, jframes, mode)
    jinfo = {}
    jout = jrun_plan(jplan, num_partitions=4, work_dir=str(tmp_path / "jax"),
                     mesh_exchange="off", run_info=jinfo)
    _same_rows(out.to_numpy(), jout.to_numpy())
    assert validator._compare(validator._to_pandas(out).reset_index(
        drop=True), oracle().reset_index(drop=True)) is None
    assert jvalidator._compare(jvalidator._to_pandas(jout).reset_index(
        drop=True), joracle().reset_index(drop=True)) is None
    assert_same_stages(info, jinfo)
    assert {k: info[k] for k in jax_routes} == jax_routes


def mesh_like_jax(monkeypatch, partitions: int = 4) -> None:
    """The port's mesh on as many logical CPU devices as the JAX package's
    exchange takes of its eight for `partitions` (its use_d, ref
    stage_exchange.py:116-118)."""
    import torch

    from blaze_tpu_torch.parallel import stage_exchange

    d = min(len(jax.devices()), partitions)
    monkeypatch.setattr(stage_exchange, "mesh_devices",
                        lambda dev: [torch.device("cpu")] * d)


@pytest.mark.parametrize("suite,q,mode", [
    ("tpcds", "q02", "bhj"), ("tpcds", "q05", "smj"),
    ("core", "q5_multijoin_limit", "bhj"), ("tpcds", "q03", "bhj"),
    ("core", "q3_join_agg_sort", "smj")])
def test_run_plan_matches_jax_both_at_defaults(tables, monkeypatch, tmp_path,
                                               suite, q, mode):
    """Both packages at their defaults: the supervisor's pool, the threaded
    pipeline, the mesh exchange (the port's over the JAX package's device
    count) and the monitor on each side (the JAX package's native layer
    out). The SMJ cases take AQE's decisions off the mesh's logical
    bytes."""
    no_jax_native(monkeypatch)
    mesh_like_jax(monkeypatch)
    assert conf.enable_supervisor and conf.enable_pipeline
    assert jconf.enable_supervisor and jconf.enable_pipeline
    assert conf.monitor_enabled and jconf.monitor_enabled
    port, jax = CATALOGUES[suite]
    (paths, frames), (jpaths, jframes) = tables[suite]
    info, jinfo = {}, {}
    out = run_plan(port.QUERIES[q](paths, frames, mode)[0], num_partitions=4,
                   work_dir=str(tmp_path / "port"), run_info=info,
                   device="cpu")
    jout = jrun_plan(jax.QUERIES[q](jpaths, jframes, mode)[0],
                     num_partitions=4, work_dir=str(tmp_path / "jax"),
                     run_info=jinfo)
    _same_rows(out.to_numpy(), jout.to_numpy())
    for key in ("mesh_stages", "file_stages", "broadcast_stages",
                "map_tasks_run", "pipeline_live_streams", "resource_leaks"):
        assert info[key] == jinfo[key], key
    assert info["mesh_stages"] > 0
    assert info["pipeline_streams"] > 0


def test_tables_match_jax(tables):
    """The port's generators write the JAX package's frames."""
    for suite in CATALOGUES:
        (_, frames), (_, jframes) = tables[suite]
        assert list(frames) == list(jframes)
        for name in frames:
            assert frames[name].equals(jframes[name]), (suite, name)


def _plan_arms(p) -> set:
    """The plan-node arms of a PlanNode tree."""
    from blaze_tpu_torch.plan import plan_pb2 as pb

    which = p.WhichOneof("node")
    if which is None:
        return set()
    arms = {which}
    for fd, value in getattr(p, which).ListFields():
        if fd.message_type is pb.PlanNode.DESCRIPTOR:
            for k in ([value] if isinstance(value, pb.PlanNode) else value):
                arms |= _plan_arms(k)
    return arms


def _window_and_generate(paths) -> list:
    """A window over store_sales (row_number and a running sum by store,
    ordered by date) and an explode of make_array(item, customer)."""
    scan = _scan_ss(paths)
    w_schema = T.Schema(list(tpcds.SS.fields) + [
        T.Field("rn", T.INT32, False), T.Field("run", T.FLOAT64)])
    win = P.window(scan, [
        {"fn": "row_number", "args": [], "dtype": T.INT32, "name": "rn"},
        {"fn": "sum", "args": [ir_col("ss_net_profit")], "dtype": T.FLOAT64,
         "name": "run"}],
        [ir_col("ss_store_sk")], [(ir_col("ss_sold_date_sk"), True, True)],
        w_schema)
    lst = T.list_of(T.INT64)
    arr = P.project(scan, [ir_col("ss_store_sk"),
                           ir.ScalarFn("make_array",
                                       (ir_col("ss_item_sk"),
                                        ir_col("ss_customer_sk")), lst)],
                    ["ss_store_sk", "xs"],
                    T.Schema([T.Field("ss_store_sk", T.INT64),
                              T.Field("xs", lst)]))
    gen = P.generate(arr, ir_col("xs"), [0], ["pos", "x"], True, False,
                     T.Schema([T.Field("ss_store_sk", T.INT64),
                               T.Field("pos", T.INT32, False),
                               T.Field("x", T.INT64)]))
    return [win, gen]


def test_every_plan_arm_decodes(tables):
    """The port's decoder refuses no plan or expression arm that
    blaze_tpu/plan/from_proto.py decodes: the stage plans of both
    catalogues in both join modes (q05's expand among them) and a window
    and a generate plan decode whole, and every arm the JAX decoder names,
    set alone, fails (if at all) on its missing parts, never on itself."""
    import inspect

    from blaze_tpu.plan import from_proto as jfp
    from blaze_tpu_torch.plan import plan_pb2 as pb
    from blaze_tpu_torch.plan.from_proto import decode_expr
    from blaze_tpu_torch.spark import converters

    seen = set()
    for suite, (port, _) in CATALOGUES.items():
        (paths, frames), _ = tables[suite]
        for q in port.QUERIES:
            for mode in ("bhj", "smj"):
                plan, _ = port.QUERIES[q](paths, frames, mode)
                apply_strategy(plan)
                for stage in plan_stages(plan, default_partitions=4):
                    decode_plan(stage.plan)
                    seen |= _plan_arms(stage.plan)
    (paths, _), _ = tables["tpcds"]
    for node in _window_and_generate(paths):
        p = converters.try_convert(node)
        decode_plan(p)
        seen |= _plan_arms(p)
    assert {"expand", "window", "generate"} <= seen, sorted(seen)

    plan_arms = set(re.findall(r'which == "(\w+)"',
                               inspect.getsource(jfp.decode_plan)))
    expr_arms = set(re.findall(r'which == "(\w+)"',
                               inspect.getsource(jfp.decode_expr)))
    assert {"expand", "window", "generate"} <= plan_arms
    for arms, msg, decode, make in (
            (plan_arms, "plan node", decode_plan, pb.PlanNode),
            (expr_arms, "expression kind", decode_expr, pb.ExprNode)):
        for arm in arms:
            node = make()
            getattr(node, arm).SetInParent()
            try:
                decode(node)
            except NotImplementedError as e:
                assert f"{msg} {arm}" not in str(e), arm
            except (KeyError, ValueError, IndexError, TypeError):
                pass  # an empty arm's fields are not a plan


def _scan_ss(paths):
    return P.scan(tpcds.SS, [(paths["store_sales"], [])])


def test_never_convert_subtree_raises(tables, tmp_path):
    """A node no converter takes is tagged NeverConvert and runs on the
    row interpreter, which has no operator for this one: it raises naming
    it, as the JAX package's interpreter does."""
    (paths, _), _ = tables["tpcds"]
    odd = P.SparkPlan("CartesianProductExec", tpcds.SS, [_scan_ss(paths)])
    with pytest.raises(NotImplementedError,
                       match="no operator for CartesianProductExec"):
        run_plan(odd, work_dir=str(tmp_path), device="cpu")
    assert odd.strategy == "NeverConvert"


def test_unsupported_scalar_function_raises(tables, tmp_path):
    """A scalar function outside the native registry and the row
    interpreter's table demotes its operator to the interpreter, which
    raises naming it."""
    from blaze_tpu_torch.exprs import ir

    (paths, _), _ = tables["tpcds"]
    proj = P.project(_scan_ss(paths),
                     [ir.ScalarFn("soundex", (ir.col("ss_item_sk"),),
                                  T.INT64)],
                     ["x"], T.Schema([T.Field("x", T.INT64)]))
    with pytest.raises(NotImplementedError,
                       match="no Python fallback for scalar fn soundex"):
        run_plan(proj, work_dir=str(tmp_path), device="cpu")
    assert proj.strategy == "NeverConvert"


@pytest.mark.parametrize("knob,value,module", [
    ("metrics_port", 9091, "runtime/monitor.py"),
    ("trace_export_dir", "/nonexistent", "runtime/trace.py"),
    ("history_dir", "/nonexistent", "runtime/history.py"),
    ("progress_enabled", True, "runtime/progress.py"),
    ("autopilot_enabled", True, "runtime/autopilot.py"),
    ("flight_dir", "/nonexistent", "runtime/flight_recorder.py"),
    ("profile_enabled", True, "runtime/profiler.py"),
    ("executor_count", 2, "runtime/executor_pool.py"),
])
def test_left_out_modules_raise(tables, monkeypatch, tmp_path, knob, value,
                                module):
    """Every knob that once named a module the port did not have now has
    its module, and run_plan raises for none of them: the observability
    knobs (trace_export_dir, history_dir, progress_enabled, flight_dir,
    profile_enabled), the service layer's (metrics_port, served on a free
    port; autopilot_enabled, with an autopilot_dir), and executor_count,
    which run_plan does not read (it reads the active pool, as the JAX
    package's does). Each runs the query to the oracle's rows, its
    directory under tmp_path."""
    import socket

    from blaze_tpu_torch.runtime import monitor, profiler
    from blaze_tpu_torch.spark import local_runner

    (paths, frames), _ = tables["tpcds"]
    plan, oracle = tpcds.QUERIES["q09"](paths, frames, "bhj")
    assert not hasattr(local_runner, "_LEFT_OUT")
    assert os.path.exists(os.path.join(
        os.path.dirname(local_runner.__file__), "..", module))
    if knob == "metrics_port":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            value = s.getsockname()[1]
    if knob == "autopilot_enabled":
        monkeypatch.setattr(conf, "autopilot_dir", str(tmp_path / "ap"))
    monkeypatch.setattr(conf, knob, str(tmp_path / knob)
                        if isinstance(value, str) else value)
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    info = {}
    try:
        out = run_plan(plan, work_dir=str(tmp_path / "w"), device="cpu",
                       run_info=info)
        if knob == "metrics_port":
            assert monitor.serve_path("/healthz")[0] == 200
            assert monitor.sampler() is not None
    finally:
        profiler.stop()  # the sampler thread begin_query started
        monitor.shutdown()  # the endpoint and gauge sampler, likewise
    if knob == "autopilot_enabled":
        assert info["autopilot"]["fingerprint"]
    assert validator._compare(validator._to_pandas(out).reset_index(
        drop=True), oracle().reset_index(drop=True)) is None


def test_run_plan_defaults_to_the_card(tables):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    (paths, frames), _ = tables["tpcds"]
    plan, _ = tpcds.QUERIES["q09"](paths, frames, "bhj")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_plan(plan)


def test_shuffle_manager_readers(tmp_path):
    """Two map outputs committed through writer slots: MapStatus lengths
    come from the .index, the device reader and the host-frame reader
    return the same rows, and the runner's all-partitions resource
    (spark/aqe.py) chains every partition."""
    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.ops.host_sort import host_concat, host_to_pylike
    from blaze_tpu_torch.ops.shuffle import Partitioning, ShuffleWriterExec
    from blaze_tpu_torch.runtime import resources
    from blaze_tpu_torch.spark.aqe import _all_partitions_resource
    from blaze_tpu_torch.spark.shuffle_manager import BlazeShuffleManager

    schema = T.Schema([T.Field("k", T.INT64), T.Field("v", T.FLOAT64)])
    mgr = BlazeShuffleManager(str(tmp_path))
    handle = mgr.register_shuffle(0, 3, schema)
    rng = np.random.default_rng(5)
    for m in range(2):
        data = {"k": rng.integers(0, 50, 700), "v": rng.random(700)}
        batch = ColumnBatch.from_numpy(data, schema, device="cpu")
        slot = mgr.get_writer(handle, m)
        writer = ShuffleWriterExec(
            MemorySourceExec([batch]),
            Partitioning("hash", 3, (ir_col("k"),)),
            slot.data_path, slot.index_path)
        list(writer.execute(ExecContext(partition=m, num_partitions=2,
                                        device="cpu")))
        status = slot.commit()
        assert sum(status.partition_lengths) == os.path.getsize(
            slot.data_path)
    assert [s.map_id for s in mgr.map_statuses(0)] == [0, 1]

    def rows(batches):
        out = [b.to_numpy() for b in batches]
        return {k: np.concatenate([o[k] for o in out]) for k in ("k", "v")}

    total = 0
    for p in range(3):
        dev = rows(mgr.get_reader(handle, p, device="cpu"))
        host = host_to_pylike(host_concat(list(mgr.get_reader_host(handle,
                                                                   p))))
        for k in ("k", "v"):
            np.testing.assert_array_equal(dev[k], host[k])
        total += len(dev["k"])
    assert total == 1400
    # the runner's chained resource, which broadcast stages read
    rid = "test/shuffle:0"
    resources.put(rid, lambda p: mgr.get_reader_host(handle, p))
    all_rid = _all_partitions_resource(rid, 3)
    every = host_to_pylike(host_concat(list(resources.get(all_rid)(0))))
    resources.pop(all_rid)
    resources.pop(rid)
    assert len(every["k"]) == 1400
    mgr.unregister_shuffle(0)
    assert not any(f.endswith((".data", ".index"))
                   for f in os.listdir(tmp_path))
