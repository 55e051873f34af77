"""ops/sort_keys.py, ops/sort.py and ops/common.py of the port against the
JAX package's, on the CPU.

Inputs come from a seeded numpy generator, with nulls, few distinct
values (so ties test stability), and NaN, +-inf and -0.0 for floats. Each
batch carries a row-id column, so comparing it compares the permutation:
row order must be bitwise equal, as must every value (NaN equal to NaN).
"""

import itertools

import numpy as np
import pytest
import torch

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.ops import basic as JB
from blaze_tpu.ops import common as jcommon
from blaze_tpu.ops import sort as jsortmod
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.sort_keys import SortSpec as JSpec
from blaze_tpu.ops.sort_keys import sort_batch as jsort
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops import basic as B
from blaze_tpu_torch.ops import common
from blaze_tpu_torch.ops import sort as sortmod
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch

KINDS = ["BOOLEAN", "INT8", "INT16", "INT32", "INT64", "DATE", "TIMESTAMP",
         "FLOAT32", "FLOAT64"]
PAIRS = list(itertools.product([True, False], [True, False]))


def _values(rng, kind, n):
    if kind == "BOOLEAN":
        return rng.random(n) < 0.5
    if kind.startswith("FLOAT"):
        pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.25,
                         1e300 if kind == "FLOAT64" else 3e38, -7.0])
        return rng.choice(pool, n)
    big = {"INT8": 127, "INT16": 32767, "INT32": 2**31 - 1,
           "DATE": 2**31 - 1}.get(kind, 2**63 - 1)
    pool = np.array([-big - 1, big, 0, -1, 1, 42, -42], dtype=np.int64)
    return rng.choice(pool, n)


def _pair(seed, kinds, n=300, cap=512, null_p=0.2):
    """The same batch (columns c0.., then an int32 row id) in both
    packages."""
    rng = np.random.default_rng(seed)
    fields = [(f"c{i}", k) for i, k in enumerate(kinds)]
    data = {n_: _values(rng, k, n) for n_, k in fields}
    valid = {n_: rng.random(n) >= null_p for n_, _ in fields}
    fields.append(("rid", "INT32"))
    data["rid"] = np.arange(n, dtype=np.int32)
    jschema = JT.Schema([JT.Field(a, getattr(JT, k)) for a, k in fields])
    tschema = TT.Schema([TT.Field(a, getattr(TT, k)) for a, k in fields])
    jb = JBatch.from_numpy(data, jschema, capacity=cap, validity=valid)
    return jb, _to_port(jb, tschema)


def _to_port(jb, tschema):
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity))
              for c in jb.columns]
    return ColumnBatch.from_host_arrays(tschema, arrays, int(jb.num_rows),
                                        jb.capacity, device="cpu")


def _live(batch, i):
    """(validity, data with nulls zeroed) of column i's live rows."""
    n = int(batch.num_rows)
    c = batch.columns[i]
    d = np.asarray(c.data)[:n]
    v = (np.ones(n, bool) if c.validity is None
         else np.asarray(c.validity)[:n])
    return v, np.where(v, d, np.zeros((), d.dtype))


def _assert_same(tb, jb):
    """Same names, row count, validity and values (NaN equal to NaN; the
    sign of a zero compared too)."""
    assert tb.schema.names() == list(jb.schema.names())
    assert int(tb.num_rows) == int(jb.num_rows)
    for i, name in enumerate(tb.schema.names()):
        tv, td = _live(tb, i)
        jv, jd = _live(jb, i)
        np.testing.assert_array_equal(tv, jv, err_msg=name)
        np.testing.assert_array_equal(td, jd, err_msg=name)
        if td.dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(td), np.signbit(jd),
                                          err_msg=name)


@pytest.mark.parametrize("asc,nulls_first", PAIRS)
@pytest.mark.parametrize("kind", KINDS)
def test_sort_batch_single_key(kind, asc, nulls_first):
    jb, tb = _pair(KINDS.index(kind), [kind])
    _assert_same(sort_batch(tb, [SortSpec(0, asc, nulls_first)]),
                 jsort(jb, [JSpec(0, asc, nulls_first)]))


@pytest.mark.parametrize("asc,nulls_first", PAIRS)
def test_sort_batch_multi_key_stable(asc, nulls_first):
    """Three keys of few distinct values: every tie is broken by input
    order (the row id), as in the JAX package's stable variadic sort."""
    kinds = ["INT8", "FLOAT64", "BOOLEAN"]
    jb, tb = _pair(7, kinds)
    specs = [(0, asc, nulls_first), (1, not asc, nulls_first),
             (2, asc, not nulls_first)]
    got = sort_batch(tb, [SortSpec(*s) for s in specs])
    _assert_same(got, jsort(jb, [JSpec(*s) for s in specs]))


def test_sort_keys_pack_into_one_word():
    """liveness + null flag + int32 value is one int64 word; liveness +
    flag + int16 + int8 one int32 word; an int64 key stands alone."""
    from blaze_tpu_torch.ops.sort_keys import batch_sort_keys

    _, tb = _pair(3, ["INT32", "INT16", "INT8", "INT64"])
    keys = batch_sort_keys(tb, [SortSpec(0)])
    assert [k.dtype for k in keys] == [torch.int64]
    keys = batch_sort_keys(tb, [SortSpec(1), SortSpec(2)])
    assert [k.dtype for k in keys] == [torch.int32]
    keys = batch_sort_keys(tb, [SortSpec(3)])
    assert [k.dtype for k in keys] == [torch.int32, torch.int64]


def test_padding_rows_sort_last():
    jb, tb = _pair(11, ["INT32"], n=100, cap=256)
    for asc, nf in PAIRS:
        out = sort_batch(tb, [SortSpec(0, asc, nf)])
        assert set(out.columns[1].data[:100].tolist()) == set(range(100))


def _streams(seed, sizes, kinds=("INT32", "FLOAT64")):
    """Batches of the given live sizes in both packages."""
    jbs, tbs = [], []
    for i, n in enumerate(sizes):
        jb, tb = _pair(seed + i, list(kinds), n=n, cap=256)
        jbs.append(jb)
        tbs.append(tb)
    return jbs, tbs


@pytest.mark.parametrize("fetch", [None, 1, 37, 1000])
def test_sort_exec_matches_jax(fetch):
    jbs, tbs = _streams(20, [200, 0, 150, 256, 3])
    specs = [(1, False, False), (0, True, True)]
    top = sortmod.SortExec(B.MemorySourceExec(tbs),
                           [SortSpec(*s) for s in specs], fetch=fetch)
    jtop = jsortmod.SortExec(JB.MemorySourceExec(jbs),
                             [JSpec(*s) for s in specs], fetch=fetch)
    t = list(top.execute(ExecContext(device="cpu")))
    j = list(jtop.execute(JCtx()))
    assert len(t) == len(j) == 1
    _assert_same(t[0], j[0])
    if fetch is not None:
        assert int(t[0].num_rows) == min(fetch, 609)


def test_take_ordered_and_sorter_memory_released():
    from blaze_tpu_torch.runtime import memory as M

    jbs, tbs = _streams(30, [100, 100])
    mgr = M.MemManager(1 << 30)
    ctx = ExecContext(device="cpu", mem_manager=mgr)
    out = list(sortmod.SortExec(B.MemorySourceExec(tbs),
                                [SortSpec(0)]).execute(ctx))
    assert mgr.mem_used() == 0 and mgr.peak_used > 0
    jout = list(jsortmod.SortExec(JB.MemorySourceExec(jbs),
                                  [JSpec(0)]).execute(JCtx()))
    _assert_same(out[0], jout[0])
    t = list(sortmod.TakeOrderedExec(B.MemorySourceExec(tbs), [SortSpec(0)],
                                     5).execute(ctx))
    _assert_same(t[0], sortmod.truncate(out[0], 5))


def test_sort_over_budget_raises_naming_serde():
    """Over its budget the sort no longer raises: each batch's sorted run
    spills to a host file and the runs merge back on the host. Row order,
    row ids included, equals the JAX package's external sort under the
    same budget; the manager ends empty."""
    from blaze_tpu.runtime import memory as JM
    from blaze_tpu_torch.runtime import memory as M

    jbs, tbs = _streams(40, [200, 200])
    ctx = ExecContext(device="cpu", mem_manager=M.MemManager(1000))
    op = sortmod.SortExec(B.MemorySourceExec(tbs), [SortSpec(0)])
    out = common.concat_batches(list(op.execute(ctx)))
    assert op.metrics["spill_count"] == 2
    jop = jsortmod.SortExec(JB.MemorySourceExec(jbs), [JSpec(0)])
    jout = jcommon.concat_batches(list(jop.execute(JCtx(
        mem_manager=JM.MemManager(1000)))))
    assert jop.metrics["spill_count"] == 2
    _assert_same(out, jout)
    assert ctx.mem_manager.mem_used() == 0


@pytest.mark.parametrize("limit", [1, 100, 200, 5000])
def test_truncate_matches_jax(limit):
    jb, tb = _pair(50, ["INT64", "FLOAT32"], n=200, cap=256)
    t, j = sortmod.truncate(tb, limit), jsortmod.truncate(jb, limit)
    assert t.capacity == j.capacity
    _assert_same(t, j)


@pytest.mark.parametrize("sizes", [[5], [200, 0, 37], [256, 256, 1]])
def test_concat_batches_matches_jax(sizes):
    jbs, tbs = _streams(60, sizes)
    t, j = common.concat_batches(tbs), jcommon.concat_batches(jbs)
    assert t.capacity == j.capacity
    _assert_same(t, j)


@pytest.mark.parametrize("start,count", [(0, 10), (37, 100), (150, 200),
                                         (300, 5)])
def test_slice_batch_matches_jax(start, count):
    jb, tb = _pair(70, ["INT16", "DATE"], n=200, cap=256)
    t = common.slice_batch(tb, start, count)
    j = jcommon.slice_batch(jb, start, count)
    assert t.capacity == j.capacity
    _assert_same(t, j)
