"""Nested columns of the port (columnar/batch.py ListData and StructData)
against the JAX package's, on the CPU.

Both packages build batches from the same seeded values: lists with null
rows, empty rows and null elements, lists of strings and of lists,
structs (with a string field and a list field) and maps. Storage, take,
concatenation, slicing, sorts, serde frames, shuffle files, Arrow in and
out, `make_array` and the struct and map expressions must come out equal
to the JAX package's, bit for bit: integers, offsets, list elements and
their order. Where the JAX package refuses (a join over list columns; a
struct or map Arrow column in) the port is held to a numpy or pyarrow
oracle instead.
"""

import io

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.columnar import serde as JS
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import ir as jir
from blaze_tpu.exprs.compiler import compile_expr as jcompile
from blaze_tpu.ops import join as JJ
from blaze_tpu.ops import shuffle as JSh
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.ops.common import concat_batches as jconcat
from blaze_tpu.ops.common import slice_batch as jslice
from blaze_tpu.ops.sort import SortExec as JSort
from blaze_tpu.ops.sort_keys import SortSpec as JSpec
from blaze_tpu.ops.sort_keys import sort_batch as jsort_batch
from blaze_tpu.runtime import memory as JM
from blaze_tpu.runtime.executor import collect as jcollect
from blaze_tpu.runtime.executor import execute_plan as jexec
from blaze_tpu_torch.columnar import arrow_io as A
from blaze_tpu_torch.columnar import serde as S
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.ops import join as J
from blaze_tpu_torch.ops import shuffle as Sh
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.ops.common import concat_batches, slice_batch
from blaze_tpu_torch.ops.sort import SortExec
from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.executor import collect

CPU = ExecContext(device="cpu")


def _dt(T, spec):
    """A dtype of module T (either package's types) from a spec: a kind
    name, ("list", e), ("map", k, v) or ("struct", [(name, spec)])."""
    if isinstance(spec, str):
        return getattr(T, spec)
    if spec[0] == "list":
        return T.list_of(_dt(T, spec[1]))
    if spec[0] == "map":
        return T.map_of(_dt(T, spec[1]), _dt(T, spec[2]))
    return T.struct_of([T.Field(n, _dt(T, s)) for n, s in spec[1]])


def _schema(T, fields):
    return T.Schema([T.Field(n, _dt(T, s)) for n, s in fields])


FIELDS = [("id", "INT64"),
          ("xs", ("list", "INT64")),
          ("ls", ("list", "STRING")),
          ("ll", ("list", ("list", "INT32"))),
          ("st", ("struct", [("a", "INT64"), ("b", "STRING"),
                             ("c", ("list", "INT64"))])),
          ("m", ("map", "STRING", "INT64"))]


def _values(seed, n):
    """Seeded host values of FIELDS: null rows, empty lists, null
    elements and fields."""
    rng = np.random.default_rng(seed)

    def maybe(v, p=0.15):
        return None if rng.random() < p else v

    def ints(k, lo=-50, hi=50):
        return [maybe(int(x), 0.1) for x in rng.integers(lo, hi, k)]

    def word():
        return "w" * int(rng.integers(0, 12)) + str(int(rng.integers(0, 9)))

    return {
        "id": rng.permutation(n).astype(np.int64),
        "xs": [maybe(ints(int(rng.integers(0, 5)))) for _ in range(n)],
        "ls": [maybe([maybe(word(), 0.1)
                      for _ in range(int(rng.integers(0, 4)))])
               for _ in range(n)],
        "ll": [maybe([maybe(ints(int(rng.integers(0, 3))), 0.2)
                      for _ in range(int(rng.integers(0, 3)))])
               for _ in range(n)],
        "st": [maybe((maybe(int(rng.integers(0, 99))), maybe(word()),
                      maybe(ints(int(rng.integers(0, 3))))))
               for _ in range(n)],
        "m": [maybe({f"k{int(j)}": maybe(int(j) * 3)
                     for j in rng.choice(6, int(rng.integers(0, 4)),
                                         replace=False)})
              for _ in range(n)],
    }


def _pair(seed=0, n=40, cap=None, fields=FIELDS):
    vals = _values(seed, n)
    vals = {k: vals[k] for k, _ in fields}
    jb = JBatch.from_numpy(vals, _schema(JT, fields), capacity=cap)
    tb = ColumnBatch.from_numpy(vals, _schema(TT, fields), capacity=cap,
                                device="cpu")
    return jb, tb


def _norm(v):
    """Host values in one comparable form: numpy scalars as Python
    scalars, lists, dicts and tuples recursively."""
    if isinstance(v, dict):
        return {_norm(k): _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return type(v)(_norm(x) for x in v) if not isinstance(
            v, np.ndarray) else [_norm(x) for x in v]
    return v.item() if hasattr(v, "item") else v


def _same(t, j):
    """Two batches' live rows equal, column by column."""
    tn, jn = t.to_numpy(), j.to_numpy()
    assert list(tn) == list(jn)
    for k in jn:
        assert _norm(tn[k]) == _norm(jn[k]), k


@pytest.mark.parametrize("seed,n,cap", [(0, 40, None), (1, 100, 256),
                                        (2, 1, None)])
def test_storage_round_trip_matches_jax(seed, n, cap):
    jb, tb = _pair(seed, n, cap)
    assert tb.capacity == jb.capacity
    _same(tb, jb)
    xs = tb.columns[1].data
    assert xs.offsets.dtype == torch.int32
    assert xs.offsets.shape == (tb.capacity + 1,)
    np.testing.assert_array_equal(xs.offsets.numpy(),
                                  np.asarray(jb.columns[1].data.offsets))
    assert xs.elements.capacity == jb.columns[1].data.elements.capacity


@pytest.mark.parametrize("seed", [0, 1])
def test_take_matches_jax(seed):
    jb, tb = _pair(seed, 60, 64)
    rng = np.random.default_rng(seed + 10)
    for idx in (rng.permutation(64), np.sort(rng.choice(64, 20, False))):
        n = min(len(idx), 60)
        j = jb.take(jnp.asarray(idx), n)
        t = tb.take(torch.from_numpy(idx), n)
        _same(t, j)


def test_concat_and_slice_match_jax():
    pairs = [_pair(s, n, cap) for s, n, cap in
             [(3, 7, 16), (4, 0, 8), (5, 30, 32), (6, 2, 128)]]
    j = jconcat([p[0] for p in pairs])
    t = concat_batches([p[1] for p in pairs])
    assert int(t.num_rows) == 39
    _same(t, j)
    for start, count in [(0, 5), (3, 20), (35, 10), (39, 3)]:
        _same(slice_batch(t, start, count), jslice(j, start, count))


@pytest.mark.parametrize("lo,hi", [(0, None), (0, 17), (5, 40), (40, 40)])
def test_serde_frames_byte_identical(lo, hi):
    jb, tb = _pair(7, 40, 64)
    frame = S.to_host(tb).serialize(lo, hi)
    assert frame == JS.to_host(jb).serialize(lo, hi)
    back = S.deserialize_batch(frame, tb.schema, device="cpu")
    assert int(back.num_rows) == (40 if hi is None else hi) - lo
    _same(back, jslice(jb, lo, int(back.num_rows)))


def test_each_package_decodes_the_others_frames():
    jb, tb = _pair(8, 33)
    mine = S.deserialize_batch(JS.serialize_batch(jb), tb.schema,
                               device="cpu")
    theirs = JS.deserialize_batch(S.serialize_batch(tb), jb.schema)
    _same(mine, jb)
    _same(tb, theirs)
    buf = io.BytesIO(S.serialize_batch(tb) + S.serialize_batch(tb))
    got = list(S.read_batches(buf, tb.schema, device="cpu"))
    assert [int(b.num_rows) for b in got] == [33, 33]


def test_nested_byte_counts_match_jax():
    jb, tb = _pair(9, 50)
    assert M.batch_nbytes(tb) == JM.batch_nbytes(jb)
    assert S.host_batch_nbytes(S.to_host(tb)) > 0


def test_shuffle_files_with_nested_columns_byte_identical(tmp_path):
    """A hash shuffle of list, struct and map payloads: the map outputs are
    byte-identical, and each package reads the other's partitions; the
    IPC reader coalesces the host frames into one upload."""
    pairs = [_pair(s, n) for s, n in [(10, 50), (11, 31)]]
    jbs, tbs = [p[0] for p in pairs], [p[1] for p in pairs]
    jd, ji = str(tmp_path / "j.data"), str(tmp_path / "j.index")
    td, ti = str(tmp_path / "t.data"), str(tmp_path / "t.index")
    jw = JSh.ShuffleWriterExec(
        JMem(jbs, jbs[0].schema),
        JSh.Partitioning("hash", 5, (jir.col("id"),)), jd, ji)
    list(jexec(jw, JCtx(partition=1, num_partitions=2)))
    tw = Sh.ShuffleWriterExec(
        MemorySourceExec(tbs, tbs[0].schema),
        Sh.Partitioning("hash", 5, (ir.col("id"),)), td, ti)
    list(tw.execute(ExecContext(partition=1, num_partitions=2,
                                device="cpu")))
    for x, y in ((jd, td), (ji, ti)):
        with open(x, "rb") as f, open(y, "rb") as g:
            assert f.read() == g.read()
    rows = 0
    for p in range(5):
        mine = list(Sh.read_shuffle_partition(jd, ji, p, tbs[0].schema,
                                              device="cpu"))
        theirs = list(JSh.read_shuffle_partition(td, ti, p, jbs[0].schema))
        for t, j in zip(mine, theirs):
            _same(t, j)
            rows += int(t.num_rows)
    assert rows == 81


def _sorted_pair(specs_j, specs_t, seed=12):
    jb, tb = _pair(seed, 45, 64)
    return jsort_batch(jb, specs_j), sort_batch(tb, specs_t)


def test_sort_carries_nested_payloads_like_jax():
    j, t = _sorted_pair([JSpec(0, asc=False)], [SortSpec(0, asc=False)])
    _same(t, j)
    assert [int(x) for x in t.to_numpy()["id"]] == sorted(range(45),
                                                           reverse=True)


def test_spilled_sort_with_list_columns_merges_on_device():
    """Over a small budget the sort spills runs holding list columns; the
    host merge cannot slice them, so they merge on the device
    (`_merge_runs_device`), as in the JAX package. Ids are unique, so the
    order is total."""
    fields = FIELDS[:3]
    pairs = [_pair(s, 64, 64, fields) for s in range(20, 26)]
    for k, (jb, tb) in enumerate(pairs):  # unique ids across batches
        jb.columns[0] = jb.columns[0].__class__(
            jb.columns[0].dtype, jb.columns[0].data * 10 + k, None)
        tb.columns[0].data = tb.columns[0].data * 10 + k
    jplan = JSort(JMem([p[0] for p in pairs], pairs[0][0].schema),
                  [JSpec(0)])
    tplan = SortExec(MemorySourceExec([p[1] for p in pairs],
                                      pairs[0][1].schema), [SortSpec(0)])
    jout = jcollect(jplan, JCtx(mem_manager=JM.MemManager(6000)))
    mgr = M.MemManager(6000)
    tout = collect(tplan, ExecContext(device="cpu", mem_manager=mgr))
    assert tplan.metrics["spill_count"] >= 2
    _same(tout, jout)
    ids = [int(x) for x in tout.to_numpy()["id"]]
    assert ids == sorted(ids) and len(ids) == 384
    assert mgr.mem_used() == 0


def _struct_map_values():
    return {"st": [(1, "x"), (2, "y"), None, (4, None)],
            "m": [{"a": 1, "b": 2}, {"b": 5}, {}, None],
            "im": [{1: "one", 2: "two"}, {2: "zwei"}, None, {7: None}],
            "xs": [[1, 2, 3], [], [7], None]}


_SM_FIELDS = [("st", ("struct", [("a", "INT64"), ("b", "STRING")])),
              ("m", ("map", "STRING", "INT64")),
              ("im", ("map", "INT64", "STRING")),
              ("xs", ("list", "INT64"))]


def _exprs(I, T):
    st = _dt(T, _SM_FIELDS[0][1])
    ns = I.NamedStruct(("x", "y"), (I.col("xs"), I.col("st")),
                       T.struct_of([T.Field("x", T.list_of(T.INT64)),
                                    T.Field("y", st)]))
    return {
        "st.a": I.GetStructField(I.col("st"), 0),
        "st.b": I.GetStructField(I.col("st"), 1),
        "ns": ns,
        "ns.y.b": I.GetStructField(I.GetStructField(ns, 1), 1),
        "xs[0]": I.GetIndexedField(I.col("xs"), I.Literal(T.INT64, 0)),
        "xs[2]": I.GetIndexedField(I.col("xs"), I.Literal(T.INT64, 2)),
        "xs[-1]": I.GetIndexedField(I.col("xs"), I.Literal(T.INT64, -1)),
        "xs[null]": I.GetIndexedField(I.col("xs"),
                                      I.Literal(T.INT64, None)),
        "m[b]": I.GetMapValue(I.col("m"), I.Literal(T.STRING, "b")),
        "m[zz]": I.GetMapValue(I.col("m"), I.Literal(T.STRING, "zz")),
        "m[null]": I.GetMapValue(I.col("m"), I.Literal(T.STRING, None)),
        "im[2]": I.GetMapValue(I.col("im"), I.Literal(T.INT64, 2)),
        "im[7]": I.GetMapValue(I.col("im"), I.Literal(T.INT64, 7)),
        "null_list": I.Literal(T.list_of(T.INT64), None),
        "null_struct": I.Literal(st, None),
    }


@pytest.mark.parametrize("name", list(_exprs(ir, TT)))
def test_struct_and_map_exprs_match_jax(name):
    vals = _struct_map_values()
    jb = JBatch.from_numpy(vals, _schema(JT, _SM_FIELDS))
    tb = ColumnBatch.from_numpy(vals, _schema(TT, _SM_FIELDS), device="cpu")
    je, te = _exprs(jir, JT)[name], _exprs(ir, TT)[name]
    jc = jcompile(je, jb.schema)(jb)
    tc = compile_expr(te, tb.schema)(tb)
    assert repr(tc.dtype) == repr(jc.dtype)
    jout = JBatch(JT.Schema([JT.Field("r", jc.dtype)]), [jc], jb.num_rows,
                  jb.capacity)
    tout = ColumnBatch(TT.Schema([TT.Field("r", tc.dtype)]), [tc],
                       tb.num_rows, tb.capacity)
    _same(tout, jout)


@pytest.mark.parametrize("kind", ["INT64", "FLOAT64", "STRING"])
def test_make_array_matches_jax(kind):
    rng = np.random.default_rng(13)
    n = 37
    if kind == "STRING":
        cols = {c: [None if rng.random() < 0.2 else "s" * int(k)
                    for k in rng.integers(0, 20, n)] for c in "abc"}
    else:
        dt = np.int64 if kind == "INT64" else np.float64
        cols = {c: np.array([None if rng.random() < 0.2 else dt(v)
                             for v in rng.integers(-9, 9, n)], object)
                for c in "abc"}
    js = JT.Schema([JT.Field(c, getattr(JT, kind)) for c in "abc"])
    ts = TT.Schema([TT.Field(c, getattr(TT, kind)) for c in "abc"])
    jb = JBatch.from_numpy(cols, js)
    tb = ColumnBatch.from_numpy(cols, ts, device="cpu")
    args_j = tuple(jir.col(c) for c in "abc")
    args_t = tuple(ir.col(c) for c in "abc")
    jc = jcompile(jir.ScalarFn("make_array", args_j), js)(jb)
    tc = compile_expr(ir.ScalarFn("make_array", args_t), ts)(tb)
    jout = JBatch(JT.Schema([JT.Field("r", jc.dtype)]), [jc], jb.num_rows,
                  jb.capacity)
    tout = ColumnBatch(TT.Schema([TT.Field("r", tc.dtype)]), [tc],
                       tb.num_rows, tb.capacity)
    _same(tout, jout)
    assert tout.to_numpy()["r"][0] == [cols[c][0] if kind != "STRING"
                                       or cols[c][0] is None
                                       else cols[c][0].encode()
                                       for c in "abc"]


def test_arrow_nested_in_and_out():
    """List, large_list, struct and map Arrow columns (sliced, with nulls)
    come in and go out equal to pyarrow's own values; the list columns
    also equal the JAX package's ingestion."""
    from blaze_tpu.columnar import arrow_io as JA

    rb = pa.record_batch({
        "id": pa.array([1, 2, 3, 4], pa.int64()),
        "xs": pa.array([[1, 2], None, [], [None, 5]], pa.list_(pa.int64())),
        "lx": pa.array([[1], [2, 3], None, []], pa.large_list(pa.int32())),
        "ls": pa.array([["a", None], [], ["bb"], None],
                       pa.list_(pa.string())),
        "m": pa.array([[("a", 1)], None, [("b", 2), ("c", None)], []],
                      pa.map_(pa.string(), pa.int64())),
        "s": pa.array([{"x": 1, "y": "a"}, None, {"x": None, "y": "c"},
                       {"x": 4, "y": None}]),
    })
    for batch in (rb, rb.slice(1)):
        tb = A.batch_from_arrow(batch, device="cpu")
        back = A.batch_to_arrow(tb)
        for i in range(batch.num_columns):
            assert back.column(i).to_pylist() == \
                batch.column(i).to_pylist(), batch.schema.names[i]
        lists = batch.select(["id", "xs", "lx", "ls"])
        jb = JA.batch_from_arrow(lists)
        _same(A.batch_from_arrow(lists, device="cpu"), jb)


@pytest.mark.parametrize("how,build_left", [("inner", False),
                                            ("left", False),
                                            ("inner", True)])
def test_join_carries_list_payloads(how, build_left):
    """Joins gather list and map payloads on both sides, with fan-out
    (each key repeats on both sides), against a numpy oracle: each output
    row is a pair of input rows. The JAX package refuses joins over list
    columns."""
    lf = [("k", "INT64"), ("xs", ("list", "INT64")),
          ("m", ("map", "STRING", "INT64"))]
    rf = [("rk", "INT64"), ("rxs", ("list", ("list", "INT32"))),
          ("rm", ("map", "STRING", "INT64"))]
    lv, rv = _values(14, 30), _values(15, 20)
    lvals = {"k": np.arange(30) % 7, "xs": lv["xs"], "m": lv["m"]}
    rvals = {"rk": np.arange(20) % 5, "rxs": rv["ll"], "rm": rv["m"]}
    ls, rs = _schema(TT, lf), _schema(TT, rf)
    lb = ColumnBatch.from_numpy(lvals, ls, device="cpu")
    rb = ColumnBatch.from_numpy(rvals, rs, device="cpu")
    jt = {"inner": J.JoinType.INNER, "left": J.JoinType.LEFT}[how]
    node = J.BroadcastJoinExec(MemorySourceExec([lb], ls),
                               MemorySourceExec([rb], rs),
                               [J.JoinKey(0, 0)], jt,
                               build_is_left=build_left)
    out = collect(node, CPU).to_numpy()
    names = [n for n, _ in lf + rf]
    got = sorted(zip(*[_norm(list(out[n])) for n in names]), key=repr)

    def host(v):
        if isinstance(v, dict):
            return {k.encode(): x for k, x in v.items()}
        return v

    want = []
    for i in range(30):
        left = [int(lvals["k"][i]), lvals["xs"][i], host(lvals["m"][i])]
        hits = [j for j in range(20) if rvals["rk"][j] == lvals["k"][i]]
        for j in hits:
            want.append(tuple(left + [int(rvals["rk"][j]), rvals["rxs"][j],
                                      host(rvals["rm"][j])]))
        if not hits and how == "left":
            want.append(tuple(left + [None, None, None]))
    assert got == sorted((tuple(_norm(list(w))) for w in want), key=repr)
    js = _schema(JT, lf)
    with pytest.raises(NotImplementedError, match="list"):
        JJ.BroadcastJoinExec(JMem([], js), JMem([], js), [JJ.JoinKey(0, 0)],
                             JJ.JoinType.INNER)


def test_filter_keeps_list_element_ranges_like_jax():
    """A filter compacts list rows with their element ranges."""
    from blaze_tpu.ops.basic import FilterExec as JFilter
    from blaze_tpu_torch.ops.basic import FilterExec

    jb, tb = _pair(16, 50, 64)
    j = jcollect(JFilter(JMem([jb], jb.schema),
                         [jir.Binary(jir.BinOp.GE, jir.col("id"),
                                     jir.lit(25))]))
    t = collect(FilterExec(MemorySourceExec([tb], tb.schema),
                           [ir.Binary(ir.BinOp.GE, ir.col("id"),
                                      ir.lit(25))]), CPU)
    assert int(t.num_rows) == 25
    _same(t, j)


def test_nested_exprs_through_the_plan_proto_like_jax():
    """NamedStruct, GetStructField, GetIndexedField and GetMapValue encode
    to the JAX package's bytes and decode back to the same IR."""
    from blaze_tpu.plan.to_proto import encode_expr as jencode
    from blaze_tpu_torch.plan.from_proto import decode_expr
    from blaze_tpu_torch.plan.to_proto import encode_expr

    st = TT.struct_of([TT.Field("x", TT.INT64), TT.Field("y", TT.STRING)])
    jst = JT.struct_of([JT.Field("x", JT.INT64), JT.Field("y", JT.STRING)])
    pairs = [
        (ir.NamedStruct(("x", "y"), (ir.col("a"),
                                     ir.Literal(TT.STRING, "w")), st),
         jir.NamedStruct(("x", "y"), (jir.col("a"),
                                      jir.Literal(JT.STRING, "w")), jst)),
        (ir.GetStructField(ir.col("st"), 1),
         jir.GetStructField(jir.col("st"), 1)),
        (ir.GetMapValue(ir.col("m"), ir.Literal(TT.STRING, "k")),
         jir.GetMapValue(jir.col("m"), jir.Literal(JT.STRING, "k"))),
        (ir.GetIndexedField(ir.col("xs"), ir.Literal(TT.INT64, 3)),
         jir.GetIndexedField(jir.col("xs"), jir.Literal(JT.INT64, 3))),
        (ir.ScalarFn("make_array", (ir.col("a"), ir.col("b")),
                     TT.list_of(TT.INT64)),
         jir.ScalarFn("make_array", (jir.col("a"), jir.col("b")),
                      JT.list_of(JT.INT64)))]
    for t, j in pairs:
        p = encode_expr(t)
        assert p.SerializeToString() == jencode(j).SerializeToString()
        assert decode_expr(p) == t


def test_parquet_round_trip_of_nested_columns(tmp_path):
    """List, map and struct columns through the Parquet sink and scan."""
    from blaze_tpu_torch.ops.parquet import ParquetScanExec, ParquetSinkExec

    _, tb = _pair(17, 45)
    out = str(tmp_path / "out.parquet")
    list(ParquetSinkExec(MemorySourceExec([tb], tb.schema), out).execute(
        ExecContext(device="cpu")))
    back = collect(ParquetScanExec([(out, [])], tb.schema, []), CPU)
    tn, bn = tb.to_numpy(), back.to_numpy()
    for k in tn:
        assert _norm(bn[k]) == _norm(tn[k]), k
