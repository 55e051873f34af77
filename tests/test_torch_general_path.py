"""The general aggregation, sort and limit path of the port against the JAX
package, end to end on the CPU.

Each plan is one TaskDefinition (chip_smoke.py's `_build_task`), decoded by
both packages and collected over the identical batches: bench.py's q06
rows with a nullable ss_customer_sk, grouped by it (chip_smoke's
general_agg plan), at 3 x 2^11 rows. The plans: null keys, a key range
past dense_agg_range, batches of two shapes, a partial-only stage, sort
with a fetch limit and a limit node, union, and the agg-less chain stage.
Keys, counts, min/max and row order must be bitwise equal, sums and
averages within rtol 1e-12 of the JAX package and 1e-9 of numpy.
"""

import numpy as np
import pytest

import chip_smoke as cs
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
from blaze_tpu.runtime import resources as jres
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops.agg import AggExec
from blaze_tpu_torch.ops.sort import SortExec
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import metrics, resources
from blaze_tpu_torch.runtime.executor import collect

ROWS, N_BATCHES = 1 << 11, 3
JSCHEMA = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in [
    ("ss_customer_sk", "INT32"), ("ss_item_sk", "INT32"),
    ("ss_quantity", "INT32"), ("ss_sales_price", "FLOAT64"),
    ("ss_ext_sales_price", "FLOAT64")]])


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "ROWS", ROWS)
    monkeypatch.setattr(cs, "GROUPS", 1 << 10)
    return cs


def _workload(customers=cs.CUSTOMERS, null_share=cs.NULL_SHARE,
              caps=None, seed=0):
    """(datas, customers) of N_BATCHES batches, made with numpy."""
    datas = [cs._make_data(seed + s) for s in range(N_BATCHES)]
    rng = np.random.default_rng(seed + 77)
    cust = [(rng.integers(1, customers + 1, ROWS).astype(np.int32),
             rng.random(ROWS) >= null_share) for _ in datas]
    return datas, cust


def _register(datas, cust, caps=None):
    """The batches in both packages under one resource id."""
    jbs = []
    for i, (d, (k, v)) in enumerate(zip(datas, cust)):
        cap = caps[i] if caps else ROWS
        jbs.append(JBatch.from_numpy(dict(d, ss_customer_sk=k), JSCHEMA,
                                     capacity=cap,
                                     validity={"ss_customer_sk": v}))
    tbs = [ColumnBatch.from_host_arrays(
        cs.GENERAL_SCHEMA,
        [(np.asarray(c.data),
          None if c.validity is None else np.asarray(c.validity))
         for c in jb.columns], int(jb.num_rows), jb.capacity, device="cpu")
        for jb in jbs]
    rid = resources.register(lambda: iter(tbs))
    jres.put(rid, lambda: iter(jbs))
    return rid


def _task(rid, **kw):
    kw.setdefault("aggs", cs.GENERAL_AGGS)
    kw.setdefault("key", "ss_customer_sk")
    return cs._build_task(cs.GENERAL_SCHEMA_PB, rid, **kw)


def _collect_both(task):
    plan, _ = decode_task_definition(task)
    out = collect(plan)
    assert out.device.type == "cpu"
    return plan, out, jcollect(jdecode(task)[0])


def _live(batch, i):
    n = int(batch.num_rows)
    c = batch.columns[i]
    d = np.asarray(c.data)[:n]
    v = (np.ones(n, bool) if c.validity is None
         else np.asarray(c.validity)[:n])
    return v, np.where(v, d, np.zeros((), d.dtype))


def _assert_same(t, j):
    """Row for row: sum/avg columns within rtol 1e-12, the rest bitwise."""
    assert t.schema.names() == list(j.schema.names())
    assert int(t.num_rows) == int(j.num_rows)
    for i, name in enumerate(t.schema.names()):
        tv, td = _live(t, i)
        jv, jd = _live(j, i)
        np.testing.assert_array_equal(tv, jv, err_msg=name)
        if td.dtype.kind == "f" and ("sum" in name or "avg" in name):
            np.testing.assert_allclose(td, jd, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(td, jd, err_msg=name)


def _assert_oracle(out, keys, cols):
    """`out` (finalized GENERAL_AGGS) against chip_smoke's numpy oracle."""
    v, k = _live(out, 0)
    np.testing.assert_array_equal(np.where(v, k, -1), keys)
    for name in ("cnt", "min_price", "max_amount"):
        np.testing.assert_array_equal(
            _live(out, out.schema.names().index(name))[1], cols[name])
    for name in ("sum_amount", "avg_price"):
        np.testing.assert_allclose(
            _live(out, out.schema.names().index(name))[1], cols[name],
            rtol=1e-9)


def _fell_back(plan):
    assert plan.metrics["stage_compiled"] == 0
    assert plan.metrics["stage_fallbacks"] == 1
    assert plan.children[0].metrics["collapses"] >= 1


def test_null_keys(small):
    datas, cust = _workload(customers=500)
    plan, t, j = _collect_both(_task(_register(datas, cust)))
    _fell_back(plan)
    _assert_same(t, j)
    assert not bool(t.columns[0].validity[0])  # the null group comes first
    _assert_oracle(t, *cs._general_oracle(datas, cust))


def test_key_range_past_dense_agg_range(small):
    datas, cust = _workload(null_share=0.0)
    plan, t, j = _collect_both(_task(_register(datas, cust)))
    _fell_back(plan)
    _assert_same(t, j)
    _assert_oracle(t, *cs._general_oracle(datas, cust))


def test_batches_of_two_shapes(small):
    datas, cust = _workload(customers=300, null_share=0.0)
    rid = _register(datas, cust, caps=[ROWS, 2 * ROWS, ROWS])
    plan, t, j = _collect_both(_task(rid))
    _fell_back(plan)
    _assert_same(t, j)
    _assert_oracle(t, *cs._general_oracle(datas, cust))


def test_partial_only_stage(small):
    datas, cust = _workload(customers=1000)
    plan, t, j = _collect_both(_task(_register(datas, cust), final=False))
    assert isinstance(plan, AggExec)
    assert t.schema.names()[1:] == [f.name for f in plan._state_fields]
    _assert_same(t, j)


@pytest.mark.parametrize("fetch", [cs.TOP_N, 7])
def test_sort_with_fetch_limit(small, fetch):
    datas, cust = _workload(customers=200)
    rid = _register(datas, cust)
    plan, t, j = _collect_both(_task(rid, sort=cs.TOP_SORT, fetch=fetch))
    assert isinstance(plan, SortExec) and plan.fetch == fetch
    _assert_same(t, j)
    keys, cols = cs._top_oracle(*cs._general_oracle(datas, cust))
    n = min(fetch, cs.TOP_N)
    cut = {k: v[:n] for k, v in cols.items()}
    _assert_oracle(t, keys[:n], cut)


def test_limit_over_sort(small):
    """A limit node over a sort without fetch: decoded in both packages
    from the same bytes, the first rows of the full sort."""
    datas, cust = _workload(customers=200)
    td = jpb.TaskDefinition.FromString(
        _task(_register(datas, cust), sort=cs.TOP_SORT))
    lim = jpb.PlanNode()
    lim.limit.input.CopyFrom(td.plan)
    lim.limit.limit = 25
    setattr(lim.limit, "global", True)
    td.plan.CopyFrom(lim)
    plan, t, j = _collect_both(td.SerializeToString())
    assert int(t.num_rows) == 25
    _assert_same(t, j)


def test_union_of_two_stages(small):
    """Union of two scan->filter->project chains over different sources,
    then the general aggregate over the union, from the same bytes."""
    d1, c1 = _workload(customers=100, seed=0)
    d2, c2 = _workload(customers=100, seed=50)
    r1, r2 = _register(d1, c1), _register(d2, c2)
    t1 = jpb.TaskDefinition.FromString(_task(r1, agg=False))
    t2 = jpb.TaskDefinition.FromString(_task(r2, agg=False))
    union = jpb.PlanNode()
    union.union.inputs.add().CopyFrom(t1.plan)
    union.union.inputs.add().CopyFrom(t2.plan)
    td = jpb.TaskDefinition()
    td.plan.CopyFrom(union)
    plan, t, j = _collect_both(td.SerializeToString())
    assert int(t.num_rows) == int(j.num_rows) > 2 * ROWS
    _assert_same(t, j)
    # the general aggregate over the union: the stage source is the union
    full = jpb.TaskDefinition.FromString(_task(r1))
    full.plan.agg.input.agg.input.CopyFrom(union)
    plan, t, j = _collect_both(full.SerializeToString())
    _fell_back(plan)
    _assert_same(t, j)
    _assert_oracle(t, *cs._general_oracle(d1 + d2, c1 + c2))


def test_chain_stage(small):
    """The agg-less q06 scan->filter->project stage compacts every batch's
    survivors into one batch, rows in input order; amount is qty * price
    on both sides."""
    datas, cust = _workload()
    plan, t, j = _collect_both(_task(_register(datas, cust), agg=False))
    assert plan.metrics["stage_compiled"] == 1
    assert t.capacity == N_BATCHES * ROWS
    _assert_same(t, j)
    keep = [cs._kept(d) for d in datas]
    np.testing.assert_array_equal(
        _live(t, 1)[1], np.concatenate([a for _, a in keep]))
    np.testing.assert_array_equal(
        _live(t, 0)[1], np.concatenate(
            [np.where(v[m], k[m], 0) for (m, _), (k, v) in zip(keep, cust)]))


def test_host_pulls_are_counted(small):
    """Every device read of the general path goes through to_host: a
    collect of the null-key plan makes a handful a batch, no more."""
    datas, cust = _workload(customers=500)
    plan, _ = decode_task_definition(_task(_register(datas, cust)))
    metrics.HOST_PULLS = 0
    collect(plan)
    assert N_BATCHES <= metrics.HOST_PULLS <= 12 * N_BATCHES
