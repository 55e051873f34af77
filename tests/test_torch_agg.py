"""The port's streaming AggExec and dense min/max/first carriers against the
JAX package's, on the CPU.

Batches come from a seeded numpy generator: nullable int32 and int8 keys
(composite keys, a null group), a float column with NaN and +-inf for
min/max/first, finite floats and integers for the sums. Outputs of both
packages are in the same (key-sorted) row order and must agree: keys,
counts, min/max, first and row order bitwise (NaN equal to NaN), f64 sums
and averages within rtol 1e-12. collapse_threshold is set small enough
that every run collapses several times.
"""

import os

import numpy as np
import pytest

import chip_smoke as cs
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import agg as jagg
from blaze_tpu.ops import basic as JB
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
from blaze_tpu.runtime import resources as jres
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import overlay_scope
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import agg
from blaze_tpu_torch.ops import basic as B
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.runtime.executor import collect

FIELDS = [("k0", "INT32"), ("k1", "INT8"), ("x", "FLOAT64"),
          ("y", "FLOAT64"), ("z", "INT32"), ("w", "INT64")]
# (fn, input column, result type, name)
CALLS = [("sum", "y", "FLOAT64", "sum_y"), ("sum", "z", "INT64", "sum_z"),
         ("count", "x", "INT64", "cnt_x"), ("count", "z", "INT64", "cnt_z"),
         ("avg", "y", "FLOAT64", "avg_y"), ("avg", "z", "FLOAT64", "avg_z"),
         ("min", "x", "FLOAT64", "min_x"), ("max", "x", "FLOAT64", "max_x"),
         ("min", "z", "INT32", "min_z"), ("max", "w", "INT64", "max_w"),
         ("first", "x", "FLOAT64", "first_x"),
         ("first_ignores_null", "x", "FLOAT64", "fin_x"),
         ("first", "z", "INT32", "first_z"),
         ("first_ignores_null", "w", "INT64", "fin_w")]


def _batches(seed, sizes, cap=512, keys=6, key_nulls=True):
    """The same batches in both packages."""
    rng = np.random.default_rng(seed)
    jschema = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in FIELDS])
    tschema = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
    pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -3.0, 7.25])
    jbs, tbs = [], []
    for n in sizes:
        data = {"k0": rng.integers(0, keys, n), "k1": rng.integers(-2, 2, n),
                "x": rng.choice(pool, n), "y": rng.standard_normal(n) * 1e3,
                "z": rng.integers(-1000, 1000, n),
                "w": rng.integers(-2**62, 2**62, n)}
        valid = {name: rng.random(n) >= 0.15 for name, _ in FIELDS}
        if not key_nulls:
            valid["k0"] = valid["k1"] = np.ones(n, bool)
        jb = JBatch.from_numpy(data, jschema, capacity=cap, validity=valid)
        arrays = [(np.asarray(c.data),
                   None if c.validity is None else np.asarray(c.validity))
                  for c in jb.columns]
        jbs.append(jb)
        tbs.append(ColumnBatch.from_host_arrays(tschema, arrays, n, cap,
                                                device="cpu"))
    return jbs, tbs


def _plan(pkg, batches, keys, calls, modes, threshold):
    """MemorySource -> Agg(modes[0]) -> Agg(modes[1]) ... in one package."""
    T_, irm, A, Bm = ((TT, ir, agg, B) if pkg == "torch"
                      else (JT, jir, jagg, JB))
    node = Bm.MemorySourceExec(batches)
    aggcalls = [A.AggCall(fn, (irm.col(c),), getattr(T_, t), name)
                for fn, c, t, name in calls]
    for mode in modes:
        node = A.AggExec(node, [irm.col(k) for k in keys], list(keys),
                         aggcalls, getattr(A.AggMode, mode),
                         collapse_threshold=threshold)
    return node


def _run(pkg, plan, ctx=None):
    if pkg == "torch":
        out = list(plan.execute(ctx or ExecContext(device="cpu")))
    else:
        out = list(plan.execute(JCtx()))
    assert len(out) <= 1
    return out[0] if out else None


def _live(batch, i):
    n = int(batch.num_rows)
    c = batch.columns[i]
    d = np.asarray(c.data)[:n]
    v = (np.ones(n, bool) if c.validity is None
         else np.asarray(c.validity)[:n])
    return v, np.where(v, d, np.zeros((), d.dtype))


def _assert_same(tb, jb, float_sums=("sum", "avg")):
    """Row for row; float columns whose name names a sum or an average
    within rtol 1e-12, every other column bitwise."""
    assert tb.schema.names() == list(jb.schema.names())
    assert int(tb.num_rows) == int(jb.num_rows)
    for i, name in enumerate(tb.schema.names()):
        tv, td = _live(tb, i)
        jv, jd = _live(jb, i)
        np.testing.assert_array_equal(tv, jv, err_msg=name)
        if td.dtype.kind == "f" and any(s in name for s in float_sums):
            np.testing.assert_allclose(td, jd, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(td, jd, err_msg=name)


MODES = {"partial": ["PARTIAL"], "final": ["PARTIAL", "FINAL"],
         "merge": ["PARTIAL", "PARTIAL_MERGE", "FINAL"],
         "merge_state": ["PARTIAL", "PARTIAL_MERGE"]}


@pytest.mark.parametrize("modes", list(MODES))
@pytest.mark.parametrize("keys", [["k0"], ["k0", "k1"]])
def test_streaming_agg_matches_jax(modes, keys):
    jbs, tbs = _batches(len(keys), [500, 0, 512, 37, 300])
    threshold = 400  # several raw collapses, and state collapses after
    t = _run("torch", _plan("torch", tbs, keys, CALLS, MODES[modes],
                            threshold))
    j = _run("jax", _plan("jax", jbs, keys, CALLS, MODES[modes], threshold))
    _assert_same(t, j)
    assert int(t.num_rows) > 6  # null groups and composite keys present


def test_collapses_do_not_change_the_answer():
    """One collapse at the end and collapses after every batch give the
    same rows."""
    _, tbs = _batches(5, [500, 400, 300, 200])
    a = _plan("torch", tbs, ["k0", "k1"], CALLS, MODES["final"], 64)
    b = _plan("torch", tbs, ["k0", "k1"], CALLS, MODES["final"], 1 << 20)
    ta, tb = _run("torch", a), _run("torch", b)
    _assert_same(ta, tb)
    assert a.children[0].metrics["collapses"] >= 7
    assert b.children[0].metrics["collapses"] == 1


def test_global_aggregate_and_empty_input():
    jbs, tbs = _batches(6, [300, 200])
    t = _run("torch", _plan("torch", tbs, [], CALLS, MODES["final"], 100))
    j = _run("jax", _plan("jax", jbs, [], CALLS, MODES["final"], 100))
    assert int(t.num_rows) == 1
    _assert_same(t, j)
    # zero live rows: one row of initial state (count 0, the rest null)
    jbs, tbs = _batches(7, [0, 0])
    for modes in ("final", "partial"):
        t = _run("torch", _plan("torch", tbs, [], CALLS, MODES[modes], 100))
        j = _run("jax", _plan("jax", jbs, [], CALLS, MODES[modes], 100))
        _assert_same(t, j)
    # a grouped aggregate over nothing yields nothing; with no input batch
    # at all the context's device holds the global row
    assert _run("torch", _plan("torch", tbs, ["k0"], CALLS,
                               MODES["final"], 100)) is None
    empty = B.EmptyPartitionsExec(tbs[0].schema)
    a = agg.AggExec(empty, [], [], [agg.AggCall("count", (ir.col("x"),),
                                                TT.INT64, "c")],
                    agg.AggMode.PARTIAL)
    out = _run("torch", a)
    assert out.device.type == "cpu" and out.to_numpy()["#9223372036854775807"
                                                       ".0.count"][0] == 0


def test_memory_returns_to_zero_and_peak_is_recorded():
    _, tbs = _batches(8, [500, 500, 500])
    mgr = M.MemManager(1 << 30)
    ctx = ExecContext(device="cpu", mem_manager=mgr)
    plan = _plan("torch", tbs, ["k0"], CALLS, MODES["final"], 300)
    _run("torch", plan, ctx)
    assert mgr.mem_used() == 0
    assert mgr.peak_used > 0
    assert mgr._consumers == []


def test_release_collapses_raw_rows_and_init_sets_the_budget():
    """MemManager.release asks the largest consumer to spill: an agg state
    holding raw rows collapses them; a second release, with nothing left
    to collapse, writes the collapsed state to a host spill file, and the
    merged state reads it back unchanged. init() replaces the manager."""
    from blaze_tpu_torch.runtime.memory import close_all_quietly

    _, tbs = _batches(15, [100] * 8, cap=4096, keys=50)
    old = M.get_manager()
    try:
        mgr = M.init(1 << 30)
        assert M.get_manager() is mgr and mgr.total == 1 << 30
        plan = _plan("torch", tbs, ["k0"], CALLS[2:4], MODES["partial"],
                     1 << 20)
        state = agg._AggState(plan, mgr)
        for b in tbs:  # 8 sparse batches collapse into one small state
            state.add_raw(plan._to_work(b), 100)
        raw = state.mem_used()
        assert mgr.release(1) > 0 and state.collapses == 1
        assert 0 < state.mem_used() < raw and not state.raw
        collapsed, before = state.states[0], state.mem_used()
        assert mgr.release(1) == before
        assert state.mem_used() == 0 and len(state.spills) == 1
        # then the spill file's unsynced pages, then nothing is left
        assert mgr.release(1) == state.spills[0].bytes_written > 0
        assert mgr.release(1) == 0
        back = state.merged()
        assert back.device.type == "cpu"
        _assert_same(back, collapsed)
        path = state.spills[0].path
        state.close()
        assert mgr.mem_used() == 0 and not os.path.exists(path)
    finally:
        M._global = old

    class Bad:
        def close(self):
            raise OSError("disk gone")

    closed = []

    class Good:
        def close(self):
            closed.append(1)

    close_all_quietly([Bad(), Good()], "test")
    assert closed == [1]


def test_state_over_budget_raises_naming_serde():
    """Over its budget the state no longer raises: the partial spills its
    collapsed state to host files and merges it back. Every column equals
    the JAX package's under the same budget; the manager ends empty."""
    from blaze_tpu.runtime import memory as JM

    jbs, tbs = _batches(9, [500, 500], keys=400)
    ctx = ExecContext(device="cpu", mem_manager=M.MemManager(2000))
    plan = _plan("torch", tbs, ["k0"], CALLS, MODES["final"], 1 << 20)
    got = _run("torch", plan, ctx)
    assert plan.children[0].metrics["spill_count"] >= 2
    jplan = _plan("jax", jbs, ["k0"], CALLS, MODES["final"], 1 << 20)
    want = list(jplan.execute(JCtx(mem_manager=JM.MemManager(2000))))[0]
    _assert_same(got, want)
    assert ctx.mem_manager.mem_used() == 0


@pytest.mark.parametrize("fn,dtype,match", [
    pytest.param("sum", TT.decimal(30, 2), "wide_decimal",
                 id="sum-dtype2-wide_decimal")])
def test_unported_aggregates_raise_before_reading(fn, dtype, match):
    """Wide-decimal sums used to raise before reading; now they run on
    limb-plane state (exprs/wide_decimal.py) and equal the JAX package's
    through PARTIAL then FINAL: exact sums, nulls, an empty group and a
    group whose sum passes the precision (null, Spark non-ANSI)."""
    assert agg.W.__name__.endswith(match)
    rng = np.random.default_rng(10)
    big = 10 ** (dtype.precision - 1)
    jbs, tbs = [], []
    for n in (40, 17, 33):
        keys = rng.integers(0, 5, n)
        vals = [int(rng.integers(-2**62, 2**62)) * int(rng.integers(1, 2**30))
                for _ in range(n)]
        vals = [None if (k == 4 or i % 5 == 0) else
                (9 * big if k == 3 else v)
                for i, (k, v) in enumerate(zip(keys, vals))]
        data = {"k0": keys.astype(np.int32), "x": vals}
        jbs.append(JBatch.from_numpy(data, JT.Schema(
            [JT.Field("k0", JT.INT32), JT.Field("x", JT.decimal(
                dtype.precision, dtype.scale))]), capacity=64))
        tbs.append(ColumnBatch.from_numpy(data, TT.Schema(
            [TT.Field("k0", TT.INT32), TT.Field("x", dtype)]), capacity=64,
            device="cpu"))
    calls = [(fn, "x", None, "r")]

    def plan(pkg, bs):
        T_, irm, A, Bm = ((TT, ir, agg, B) if pkg == "torch"
                          else (JT, jir, jagg, JB))
        node = Bm.MemorySourceExec(bs)
        dt = T_.decimal(dtype.precision, dtype.scale)
        for mode in MODES["final"]:
            node = A.AggExec(node, [irm.col("k0")], ["k0"],
                             [A.AggCall(f, (irm.col(c),), dt, name)
                              for f, c, _, name in calls],
                             getattr(A.AggMode, mode), collapse_threshold=50)
        return node

    got = _run("torch", plan("torch", tbs)).to_numpy()
    want = _run("jax", plan("jax", jbs)).to_numpy()
    assert list(got["k0"]) == list(want["k0"]) == [0, 1, 2, 3, 4]
    assert got["r"] == want["r"]
    assert got["r"][3] is None and got["r"][4] is None
    assert all(isinstance(v, int) for v in got["r"][:3])


# ---------------------------------------------------------------------------
# dense carriers (runtime/stage_compiler.py) on bench.py's plan
# ---------------------------------------------------------------------------

def _sorted_rows(batch, key_cols):
    """Each column's (validity, data) with the rows in key order."""
    n = int(batch.num_rows)
    keys = [np.asarray(batch.columns[i].data)[:n] for i in key_cols]
    order = np.lexsort(keys[::-1])
    return [tuple(a[order] for a in _live(batch, i))
            for i in range(len(batch.columns))]


def _assert_same_rows(t, j, names, key_cols):
    assert int(t.num_rows) == int(j.num_rows)
    for name, (tv, td), (jv, jd) in zip(names, _sorted_rows(t, key_cols),
                                        _sorted_rows(j, key_cols)):
        np.testing.assert_array_equal(tv, jv, err_msg=name)
        if "sum" in name or "avg" in name:
            np.testing.assert_allclose(td, jd, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(td, jd, err_msg=name)


# every function, in the 26 planes and 16 words one accumulate launch takes
DENSE_CALLS = [c for c in CALLS if c[3] in (
    "sum_y", "cnt_x", "avg_z", "min_x", "max_x", "min_z", "max_w",
    "first_x", "fin_x", "first_z", "fin_w")]


@pytest.mark.parametrize("modes", ["final", "partial"])
def test_dense_carriers_match_jax(modes):
    """Every aggregate, min/max/first/first_ignores_null included, on the
    dense path of both packages (non-null composite keys in range), over
    inputs with nulls, NaN and +-inf; and the port's dense answer equals
    its streaming one."""
    from blaze_tpu.runtime.stage_compiler import try_run_stage as jtry
    from blaze_tpu_torch.runtime.stage_compiler import try_run_stage

    jbs, tbs = _batches(13, [500, 512, 300], key_nulls=False)
    keys = ["k0", "k1"]
    plan = _plan("torch", tbs, keys, DENSE_CALLS, MODES[modes], 100)
    t = try_run_stage(plan, ExecContext(device="cpu"))
    assert plan.metrics["stage_compiled"] == 1
    jplan = _plan("jax", jbs, keys, DENSE_CALLS, MODES[modes], 100)
    j = jtry(jplan, JCtx())
    assert jplan.metrics["stage_compiled"] == 1
    names = t.schema.names()
    assert names == list(j.schema.names())
    _assert_same_rows(t, j, names, [0, 1])
    s = _run("torch", _plan("torch", tbs, keys, DENSE_CALLS, MODES[modes],
                            100))
    _assert_same_rows(t, s, names, [0, 1])


@pytest.mark.parametrize("modes", ["final", "partial"])
def test_many_planes_split_across_launches(monkeypatch, modes):
    """All 14 aggregates need 43 digit planes in 23 words, more than one
    launch of the accumulate kernel takes (32 planes, 16 words): the dense
    path cuts them into two launch groups, each with its own carry, and
    makes two accumulates a batch, with the JAX package's dense answer and
    the port's streaming one."""
    from blaze_tpu.runtime.stage_compiler import try_run_stage as jtry
    from blaze_tpu_torch.ops import mxu_agg
    from blaze_tpu_torch.runtime.stage_compiler import try_run_stage

    planes = []
    real = mxu_agg.accumulate_into

    def counting(acc, keys, valid, words, recipe, rng):
        planes.append(len(recipe))
        assert len(words) <= mxu_agg._MAX_WORDS
        real(acc, keys, valid, words, recipe, rng)

    monkeypatch.setattr(mxu_agg, "accumulate_into", counting)
    jbs, tbs = _batches(14, [500, 512], key_nulls=False)
    plan = _plan("torch", tbs, ["k0"], CALLS, MODES[modes], 100)
    t = try_run_stage(plan, ExecContext(device="cpu"))
    assert plan.metrics["stage_compiled"] == 1
    assert plan.metrics["stage_fallbacks"] == 0
    assert len(planes) == 2 * len(tbs)
    assert planes[:2] == planes[2:] and sum(planes[:2]) == 43
    assert max(planes) <= mxu_agg._MAX_PLANES
    jplan = _plan("jax", jbs, ["k0"], CALLS, MODES[modes], 100)
    j = jtry(jplan, JCtx())
    assert jplan.metrics["stage_compiled"] == 1
    names = t.schema.names()
    assert names == list(j.schema.names())
    _assert_same_rows(t, j, names, [0])
    s = _run("torch", _plan("torch", tbs, ["k0"], CALLS, MODES[modes], 100))
    _assert_same_rows(t, s, names, [0])


def test_dense_carriers_from_plan_bytes(monkeypatch):
    """bench.py's plan with min/max/first aggregates, from the same
    TaskDefinition bytes in both packages; +inf prices pass the filter
    and reach max(amount) (a sum of them would make the dense path
    decline: non-finite values have no digit planes)."""
    monkeypatch.setattr(cs, "ROWS", 1 << 11)
    monkeypatch.setattr(cs, "GROUPS", 1 << 9)
    datas = [cs._make_data(s) for s in range(3)]
    for d in datas:
        d["ss_sales_price"][::97] = np.inf
        d["ss_quantity"][::97] = 3
    jschema = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in [
        ("ss_item_sk", "INT32"), ("ss_quantity", "INT32"),
        ("ss_sales_price", "FLOAT64"), ("ss_ext_sales_price", "FLOAT64")]])
    jbs = [JBatch.from_numpy(d, jschema, capacity=cs.ROWS) for d in datas]
    tbs = [ColumnBatch.from_host_arrays(
        cs.SCHEMA, [(np.asarray(c.data), None) for c in jb.columns],
        int(jb.num_rows), jb.capacity, device="cpu") for jb in jbs]
    rid = resources.register(lambda: iter(tbs))
    jres.put(rid, lambda: iter(jbs))
    aggs = [("min", "ss_sales_price", "f64", "min_price"),
            ("max", "amount", "f64", "max_amount"),
            ("first", "amount", "f64", "first_amount"),
            ("first_ignores_null", "ss_sales_price", "f64", "fin_price"),
            ("sum", "ss_ext_sales_price", "f64", "sum_ext"),
            ("count", None, "i64", "cnt")]
    task = cs._build_task(cs.SCHEMA_PB, rid, aggs=aggs)
    plan, _ = decode_task_definition(task)
    t = collect(plan)
    assert plan.metrics["stage_compiled"] == 1
    j = jcollect(jdecode(task)[0])
    names = t.schema.names()
    _assert_same_rows(t, j, names, [0])
    assert np.isinf(_live(t, names.index("max_amount"))[1]).any()
    with overlay_scope({"enable_stage_compiler": False}):
        plan2, _ = decode_task_definition(task)
        s = collect(plan2)
    assert plan2.metrics["stage_compiled"] == 0
    _assert_same_rows(t, s, names, [0])


def test_rebuild_replaces_only_the_stage_source():
    """The fallback swaps THE stage source (identity), never every leaf: an
    agg over a union of two sources must count each row once."""
    from blaze_tpu_torch.runtime.stage_compiler import _match, _rebuild

    _, tbs = _batches(12, [300, 200])
    union = B.UnionExec([B.MemorySourceExec(tbs[:1]),
                         B.MemorySourceExec(tbs[1:])])
    calls = [("count", "z", "INT64", "cnt_z"), ("sum", "z", "INT64", "s")]
    plan = _plan("torch", [tbs[0]], ["k0"], calls, MODES["final"], 100)
    plan.children[0].children = [union]
    _, _, chain, source = _match(plan)
    assert source is union and chain == []
    captured = B.MemorySourceExec(list(union.execute(ExecContext())))
    rebuilt = _rebuild(plan, source, captured)
    assert rebuilt.children[0].children[0] is captured
    assert rebuilt is not plan and rebuilt.children[0] is not plan.children[0]
    assert plan.children[0].children[0] is union  # the original is intact
    out = collect(plan, ExecContext(device="cpu"))  # null keys: fallback
    assert plan.metrics["stage_fallbacks"] == 1
    cnt = int(np.asarray(out.to_numpy()["cnt_z"]).sum())
    assert cnt == sum(int(np.asarray(b.columns[4].valid_mask()[:n]).sum())
                      for b, n in zip(tbs, (300, 200)))
