"""ops/join.py of the port against the JAX package's, on the CPU.

The same seeded numpy batches go through both packages: `match_ranges` and
`expand_pairs` must give equal arrays, and every join type under SMJ and
BHJ, with the build side on either side, must give the same rows in the
same order (integers, flags and validity bitwise, floats within rtol
1e-12, NaN equal to NaN). Keys carry nulls, duplicates, NaN, +-0.0 and
null-safe comparison; two probe batches differ in validity so that the
per-batch flag layout and the matched-build flags across batches are
exercised. Join filters on inner and non-inner joins, the chunked build
of an oversized broadcast side, a skewed key and BNLJ with empty sides
come last.
"""

import numpy as np
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.config import conf as jconf
from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import join as JJ
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import join as J
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec

JOIN_TYPES = [t.name for t in J.JoinType]


def _values(rng, kind, n, pool):
    if kind.startswith("FLOAT"):
        fp = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, 7.0])
        return rng.choice(fp, n)
    return rng.integers(0, pool, n)


def _side(rng, prefix, kinds, n, cap, null_p, pool=12):
    """(fields, data, validity) of one side: key columns of `kinds`, then
    a float payload and an int32 row id."""
    fields = [(f"{prefix}k{i}", k) for i, k in enumerate(kinds)]
    fields += [(f"{prefix}v", "FLOAT64"), (f"{prefix}id", "INT32")]
    data = {f"{prefix}k{i}": _values(rng, k, n, pool)
            for i, k in enumerate(kinds)}
    data[f"{prefix}v"] = rng.random(n)
    data[f"{prefix}id"] = np.arange(n, dtype=np.int32)
    valid = None
    if null_p:
        valid = {f"{prefix}k{i}": rng.random(n) >= null_p
                 for i in range(len(kinds))}
        valid[f"{prefix}v"] = rng.random(n) >= null_p
    return fields, data, valid


def _pair(fields, data, valid, cap):
    """The same batch in both packages (the port's built from the JAX
    batch's host arrays, padding rows included)."""
    jschema = JT.Schema([JT.Field(a, getattr(JT, k)) for a, k in fields])
    tschema = TT.Schema([TT.Field(a, getattr(TT, k)) for a, k in fields])
    jb = JBatch.from_numpy(data, jschema, capacity=cap, validity=valid)
    arrays = [(np.asarray(c.data),
               None if c.validity is None else np.asarray(c.validity))
              for c in jb.columns]
    tb = ColumnBatch.from_host_arrays(tschema, arrays, int(jb.num_rows),
                                      jb.capacity, device="cpu")
    return jb, tb


def _sides(seed, kinds=("INT64",), n=(300, 200), caps=(512, 256),
           null_p=0.15, pool=12, probe_batches=2, build_batches=2):
    """Left batches (probe_batches of them; the first without validity)
    and right batches, in both packages: ([jax], [port]) per side."""
    rng = np.random.default_rng(seed)
    out = []
    for prefix, nb, rows, cap in (("l", probe_batches, n[0], caps[0]),
                                  ("r", build_batches, n[1], caps[1])):
        js, ts = [], []
        for b in range(nb):
            p = 0.0 if (prefix == "l" and b == 0) else null_p
            fields, data, valid = _side(rng, prefix, kinds, rows, cap, p,
                                        pool)
            jb, tb = _pair(fields, data, valid, cap)
            js.append(jb)
            ts.append(tb)
        out.append((js, ts))
    return out


def _columns(batches):
    """Live rows of a stream, column by column: (values, validity)."""
    cols = None
    for b in batches:
        n = int(b.num_rows)
        part = []
        for c in b.columns:
            d = np.asarray(c.data)[:n]
            v = (np.ones(n, bool) if c.validity is None
                 else np.asarray(c.validity)[:n])
            part.append((d, v))
        cols = part if cols is None else [
            (np.concatenate([a, d]), np.concatenate([av, v]))
            for (a, av), (d, v) in zip(cols, part)]
    return cols or []


def _assert_same(jouts, touts):
    assert [int(b.num_rows) for b in jouts] == \
        [int(b.num_rows) for b in touts]
    for (jd, jv), (td, tv) in zip(_columns(jouts), _columns(touts)):
        np.testing.assert_array_equal(jv, tv)
        jd, td = np.where(jv, jd, 0), np.where(tv, td, 0)
        if jd.dtype.kind == "f":
            np.testing.assert_allclose(td, jd, rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(td, jd)


def _keys(nkeys, null_safe=False):
    return ([JJ.JoinKey(i, i, null_safe) for i in range(nkeys)],
            [J.JoinKey(i, i, null_safe) for i in range(nkeys)])


def _run_both(jop, top):
    jouts = list(jop.execute(JCtx()))
    touts = list(top.execute(ExecContext(device="cpu")))
    return jouts, touts


def _hash_joins(cls_name, left, right, keys, jt, build_is_left=False,
                jfilter=None, tfilter=None):
    (jl, tl), (jr, tr) = left, right
    jk, tk = keys
    jop = getattr(JJ, cls_name)(
        JMem(jl, jl[0].schema), JMem(jr, jr[0].schema), jk,
        JJ.JoinType[jt], build_is_left=build_is_left, join_filter=jfilter)
    top = getattr(J, cls_name)(
        MemorySourceExec(tl, tl[0].schema), MemorySourceExec(tr, tr[0].schema),
        tk, J.JoinType[jt], build_is_left=build_is_left, join_filter=tfilter)
    return jop, top


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds,null_safe", [
    (("INT64",), False), (("FLOAT64",), False), (("INT32", "INT64"), False),
    (("INT64",), True), (("FLOAT32", "INT16"), True)])
def test_match_ranges_and_expand_pairs_equal(kinds, null_safe):
    (jl, tl), (jr, tr) = _sides(11, kinds, build_batches=1)
    nk = len(kinds)
    cols = list(range(nk))
    ns = [null_safe] * nk
    for jp, tp in zip(jl, tl):
        force = [jr[0].columns[c].validity is not None
                 or jp.columns[c].validity is not None for c in cols]
        jb = JJ.sort_batch_by_keys(
            jr[0], JJ._join_sort_keys(jr[0], cols, ns, force, 0))
        tb = J.sort_batch_by_keys(
            tr[0], J._join_sort_keys(tr[0], cols, ns, force, 0))
        _assert_same([jb], [tb])
        js, jc, jm = JJ.match_ranges(jb, jp, cols, cols, ns, force)
        ts, tc, tm = J.match_ranges(tb, tp, cols, cols, ns, force)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        nb = int(jb.num_rows)
        np.testing.assert_array_equal(np.asarray(jm)[:nb], tm.numpy()[:nb])
        assert int(np.asarray(jc).sum()) > 0
        for emit in (False, True):
            total = int((np.maximum(np.asarray(jc), 1) if emit
                         else np.asarray(jc))[:int(jp.num_rows)].sum())
            out_cap = 1 << max(total - 1, 1).bit_length()
            jr_ = JJ.expand_pairs(js, jc, out_cap, emit,
                                  probe_mask=jp.row_mask())
            tr_ = J.expand_pairs(ts, tc, out_cap, emit,
                                 probe_mask=tp.row_mask())
            for a, b in zip(jr_, tr_):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("cls_name", ["SortMergeJoinExec",
                                      "BroadcastJoinExec"])
@pytest.mark.parametrize("build_is_left", [False, True])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_types_equal(cls_name, build_is_left, jt):
    left, right = _sides(3)
    jop, top = _hash_joins(cls_name, left, right, _keys(1), jt,
                           build_is_left)
    _assert_same(*_run_both(jop, top))


@pytest.mark.parametrize("kinds,null_safe", [
    (("FLOAT64",), False), (("FLOAT32",), True), (("INT64",), True),
    (("INT32", "INT64"), False), (("INT64", "DATE"), True)])
@pytest.mark.parametrize("jt", ["INNER", "FULL", "LEFT_ANTI"])
def test_join_key_kinds_equal(kinds, null_safe, jt):
    left, right = _sides(5, kinds, pool=4)
    jop, top = _hash_joins("SortMergeJoinExec", left, right,
                           _keys(len(kinds), null_safe), jt)
    jouts, touts = _run_both(jop, top)
    _assert_same(jouts, touts)


def test_float_keys_match_nan_and_signed_zero():
    """NaN joins NaN and -0.0 joins 0.0, as the sort encoding orders them."""
    fields = [("k", "FLOAT64"), ("id", "INT32")]
    lj, lt = _pair(fields, {"k": np.array([np.nan, -0.0, 1.0]),
                            "id": np.arange(3, dtype=np.int32)}, None, 1024)
    rfields = [("rk", "FLOAT64"), ("rid", "INT32")]
    rj, rt = _pair(rfields, {"rk": np.array([0.0, np.nan, 2.0]),
                             "rid": np.arange(3, dtype=np.int32)}, None, 1024)
    jop, top = _hash_joins("SortMergeJoinExec", ([lj], [lt]), ([rj], [rt]),
                           _keys(1), "INNER")
    jouts, touts = _run_both(jop, top)
    _assert_same(jouts, touts)
    ids = _columns(touts)
    assert sorted(zip(ids[1][0], ids[3][0])) == [(0, 1), (1, 0)]


def _filters():
    """lv > rv, over the pair schema (left fields ++ right fields)."""
    return (jir.Binary(jir.BinOp.GT, jir.col("lv"), jir.col("rv")),
            ir.Binary(ir.BinOp.GT, ir.col("lv"), ir.col("rv")))


@pytest.mark.parametrize("build_is_left", [False, True])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_filter_equal(build_is_left, jt):
    left, right = _sides(7, pool=6)
    jf, tf = _filters()
    jop, top = _hash_joins("BroadcastJoinExec", left, right, _keys(1), jt,
                           build_is_left, jf, tf)
    _assert_same(*_run_both(jop, top))


@pytest.mark.parametrize("jt", ["INNER", "LEFT_SEMI", "LEFT_ANTI",
                                "EXISTENCE"])
def test_chunked_build_equal(monkeypatch, jt):
    """A broadcast side past bhj_fallback_rows_threshold is joined in
    sorted chunks of 1024 rows, in both packages."""
    for c in (conf, jconf):
        monkeypatch.setattr(c, "bhj_fallback_rows_threshold", 1000)
    left, right = _sides(9, n=(1500, 1500), caps=(2048, 2048), pool=300,
                         build_batches=2)
    jop, top = _hash_joins("BroadcastJoinExec", left, right, _keys(1), jt)
    _assert_same(*_run_both(jop, top))
    assert jop.metrics["bhj_fallback_to_smj"] == \
        top.metrics["bhj_fallback_to_smj"] == 1


def test_skewed_key_expands_to_the_same_capacity():
    """One key on 90% of the rows of both sides: a probe batch of 2^12
    rows expands far past its capacity, to the bucket the JAX package
    picks."""
    rng = np.random.default_rng(21)
    sides = []
    for prefix, n in (("l", 1 << 12), ("r", 64)):
        fields = [(f"{prefix}k0", "INT64"), (f"{prefix}v", "FLOAT64")]
        data = {f"{prefix}k0": np.where(rng.random(n) < 0.9, 3, 5),
                f"{prefix}v": rng.random(n)}
        jb, tb = _pair(fields, data, None, n)
        sides.append(([jb], [tb]))
    jop, top = _hash_joins("SortMergeJoinExec", *sides, _keys(1), "INNER")
    jouts, touts = _run_both(jop, top)
    _assert_same(jouts, touts)
    assert [b.capacity for b in jouts] == [b.capacity for b in touts]
    assert touts[0].capacity > 1 << 16


def _bnlj(left, right, jt, cond):
    (jl, tl), (jr, tr) = left, right
    jc, tc = _filters() if cond else (None, None)
    jop = JJ.BroadcastNestedLoopJoinExec(
        JMem(jl, jl[0].schema), JMem(jr, jr[0].schema), JJ.JoinType[jt], jc)
    top = J.BroadcastNestedLoopJoinExec(
        MemorySourceExec(tl, tl[0].schema), MemorySourceExec(tr, tr[0].schema),
        J.JoinType[jt], tc)
    return jop, top


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_bnlj_equal(monkeypatch, cond, jt):
    """Left chunks of batch_size * 16 // |right| rows: 3 chunks here."""
    for c in (conf, jconf):
        monkeypatch.setattr(c, "batch_size", 64)
    left, right = _sides(13, n=(120, 20), caps=(128, 32), probe_batches=2)
    _assert_same(*_run_both(*_bnlj(left, right, jt, cond)))


@pytest.mark.parametrize("empty", ["left", "right", "both"])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_bnlj_empty_sides_equal(empty, jt):
    left, right = _sides(17, n=(40, 30), caps=(64, 32))
    if empty in ("left", "both"):
        left = tuple([b.with_num_rows(0) for b in side] for side in left)
    if empty in ("right", "both"):
        right = tuple([b.with_num_rows(0) for b in side] for side in right)
    _assert_same(*_run_both(*_bnlj(left, right, jt, True)))


def _replay(items):
    return lambda: iter(items)


def _join_task(kind, jt, rid_l, rid_r, fields_l, fields_r):
    """TaskDefinition bytes of one join node over two ffi_readers: on
    lk0 = rk0 (null-safe for SMJ), with lv > rv as the join filter (the
    BNLJ's condition), the build on the left for BHJ."""
    from blaze_tpu_torch.plan import plan_pb2 as pb

    kinds = {"INT64": pb.TK_INT64, "FLOAT64": pb.TK_FLOAT64,
             "INT32": pb.TK_INT32}
    td = pb.TaskDefinition()
    node = getattr(td.plan, kind)
    for side, rid, fields in (("left", rid_l, fields_l),
                              ("right", rid_r, fields_r)):
        src = getattr(node, side).ffi_reader
        src.export_iter_resource_id = rid
        for name, k in fields:
            f = src.schema.fields.add()
            f.name, f.nullable = name, True
            f.dtype.kind = kinds[k]
    node.join_type = getattr(pb, "JOIN_" + jt)
    cond = node.condition if kind == "broadcast_nested_loop_join" \
        else node.join_filter
    cond.binary.op = pb.OP_GT
    cond.binary.left.column.name = "lv"
    cond.binary.right.column.name = "rv"
    if kind != "broadcast_nested_loop_join":
        on = node.on.add()
        on.left.column.name, on.right.column.name = "lk0", "rk0"
        on.null_safe = kind == "sort_merge_join"
        node.existence_name = "has_match"
    if kind == "broadcast_join":
        node.build_is_left = True
    return td.SerializeToString()


@pytest.mark.parametrize("kind", ["sort_merge_join", "broadcast_join",
                                  "broadcast_nested_loop_join"])
@pytest.mark.parametrize("jt", ["INNER", "FULL", "EXISTENCE"])
def test_join_nodes_decode_from_the_same_bytes(kind, jt):
    from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
    from blaze_tpu.runtime import resources as jres
    from blaze_tpu_torch.plan.from_proto import decode_task_definition
    from blaze_tpu_torch.runtime import resources

    (jl, tl), (jr, tr) = _sides(19, n=(60, 30), caps=(64, 32),
                                probe_batches=1, build_batches=1)
    rids = []
    for jb, tb in ((jl, tl), (jr, tr)):
        rid = resources.register(_replay(tb))
        jres.put(rid, _replay(jb))
        rids.append(rid)
    task = _join_task(kind, jt, *rids,
                      [(f.name, f.dtype.kind.name) for f in tl[0].schema],
                      [(f.name, f.dtype.kind.name) for f in tr[0].schema])
    jop, _ = jdecode(task)
    top, _ = decode_task_definition(task)
    assert type(top).__name__ == type(jop).__name__
    assert top.join_type.value == jop.join_type.value == jt.lower()
    assert top.schema.names() == jop.schema.names()
    if kind != "broadcast_nested_loop_join":
        assert [k.key() for k in top.keys] == [k.key() for k in jop.keys]
        assert top.build_is_left == jop.build_is_left
    _assert_same(*_run_both(jop, top))
