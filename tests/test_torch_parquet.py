"""ops/parquet.py of the port against the JAX package's, on the CPU.

Seeded numpy tables are written to Parquet files (several row groups,
nulls, a sorted column for pruning) and scanned by both packages: the
batches must be equal, bitwise over their whole capacity, with the same
row-group pruning counts, hive partition values and corrupt-file
handling. Both packages' sinks write the same rows under the same names;
the files read back equal. The plan nodes decode from the same
TaskDefinition bytes in both packages, and a remote (`memory://`) path
goes through runtime/filesystem.py.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu.columnar import types as JT
from blaze_tpu.config import conf as jconf
from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.ops.parquet import ParquetScanExec as JScan
from blaze_tpu.ops.parquet import ParquetSinkExec as JSink
from blaze_tpu.plan.from_proto import decode_task_definition as jdecode
from blaze_tpu_torch.columnar import arrow_io
from blaze_tpu_torch.columnar import types as TT
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.ops.parquet import ParquetScanExec, ParquetSinkExec
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import filesystem
from test_torch_arrow_io import _same

FIELDS = [("a", "INT64"), ("b", "FLOAT64"), ("c", "INT32"), ("d", "DATE"),
          ("s", "STRING")]
JSCHEMA = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in FIELDS])
TSCHEMA = TT.Schema([TT.Field(n, getattr(TT, k)) for n, k in FIELDS])
N = 4096


def _table(seed, n=N, start=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(np.arange(start, start + n), pa.int64()),  # sorted
        "b": pa.array(rng.random(n), mask=rng.random(n) < 0.1),
        "c": pa.array(rng.integers(-5, 5, n).astype(np.int32)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.date32(), mask=rng.random(n) < 0.05),
        "s": pa.array([f"r{i}" for i in range(n)]),
    })


def _write(tmp_path, nfiles=3, row_group=1000):
    paths = []
    for i in range(nfiles):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(_table(i, start=i * N), p, row_group_size=row_group)
        paths.append(p)
    return paths


def _scan_both(files, projection, jpreds=(), tpreds=(), jpart=None,
               tpart=None, batch_rows=None):
    jop = JScan(files, JSCHEMA, projection, partition_schema=jpart,
                pruning_predicates=jpreds, batch_rows=batch_rows)
    top = ParquetScanExec(files, TSCHEMA, projection, partition_schema=tpart,
                          pruning_predicates=tpreds, batch_rows=batch_rows)
    jouts = list(jop.execute(JCtx()))
    touts = list(top.execute(ExecContext(device="cpu")))
    assert len(jouts) == len(touts)
    for jb, tb in zip(jouts, touts):
        assert jb.schema.names() == tb.schema.names()
        _same(jb, tb)
    return jop, top, touts


@pytest.mark.parametrize("projection", [[0, 1, 2, 3], [3, 1], [2], []])
@pytest.mark.parametrize("batch_rows", [None, 1024])
def test_scan_projection_equal(tmp_path, projection, batch_rows):
    files = [(p, []) for p in _write(tmp_path)]
    proj = projection or [0, 1, 2, 3]
    jop, top, touts = _scan_both(files, proj, batch_rows=batch_rows)
    assert sum(int(b.num_rows) for b in touts) == 3 * N
    assert jop.metrics["bytes_scanned"] == top.metrics["bytes_scanned"] > 0
    assert top.metrics["io_time_ns"] > 0


def _pred(mod, op, name, v, flip=False):
    c, lit = mod.col(name), mod.lit(v)
    bop = getattr(mod.BinOp, op)
    return mod.Binary(bop, lit, c) if flip else mod.Binary(bop, c, lit)


@pytest.mark.parametrize("preds", [
    [("GE", "a", 3500)], [("LT", "a", 1000)], [("EQ", "a", 9000)],
    [("LE", "a", 2999, True)], [("GT", "a", 99999)],
    [("GE", "a", 2000), ("LT", "a", 6000)], [("EQ", "c", 100)],
    [("NEQ", "a", 5)]])
def test_row_group_pruning_counts_equal(tmp_path, preds):
    files = [(p, []) for p in _write(tmp_path)]
    jp = [_pred(jir, *p) for p in preds]
    tp = [_pred(ir, *p) for p in preds]
    jop, top, _ = _scan_both(files, [0, 2], jp, tp)
    assert jop.metrics["row_groups_pruned"] == \
        top.metrics["row_groups_pruned"]
    if preds[0][:2] == ("GE", "a") and len(preds) == 1:
        assert top.metrics["row_groups_pruned"] == 3  # file 0, a < 3000


def test_and_predicate_prunes():
    from blaze_tpu_torch.ops.parquet import _stat_prune

    both = ir.Binary(ir.BinOp.AND, _pred(ir, "GE", "a", 10),
                     _pred(ir, "LT", "a", 5))
    assert _stat_prune(both, {"a": (0, 7)}) is True
    assert _stat_prune(_pred(ir, "GE", "a", 5), {"a": (0, 7)}) is False
    assert _stat_prune(_pred(ir, "GE", "a", 5), {}) is False


def test_partition_values_equal(tmp_path):
    paths = _write(tmp_path, nfiles=2)
    jpart = JT.Schema([JT.Field("year", JT.INT32), JT.Field("k", JT.INT64)])
    tpart = TT.Schema([TT.Field("year", TT.INT32), TT.Field("k", TT.INT64)])
    sv = pb.ScalarValue()
    sv.dtype.kind = pb.TK_INT64
    sv.int_value = -7
    files = [(paths[0], [2024, sv]), (paths[1], [1999, sv])]
    jfiles = [(p, [jir.Literal(JT.INT32, y), v]) for p, (y, v) in
              zip(paths, [(2024, sv), (1999, sv)])]
    jop = JScan(jfiles, JSCHEMA, [0], partition_schema=jpart)
    top = ParquetScanExec(files, TSCHEMA, [0], partition_schema=tpart)
    jouts = list(jop.execute(JCtx()))
    touts = list(top.execute(ExecContext(device="cpu")))
    for jb, tb in zip(jouts, touts):
        _same(jb, tb)
    years = np.concatenate([b.columns[1].data.numpy()[:int(b.num_rows)]
                            for b in touts])
    assert sorted(set(years.tolist())) == [1999, 2024]
    assert set(touts[0].columns[2].data.numpy().tolist()) == {-7}


@pytest.mark.parametrize("ignore", [True, False])
def test_corrupt_files(tmp_path, monkeypatch, ignore):
    good = _write(tmp_path, nfiles=1)[0]
    bad = str(tmp_path / "bad.parquet")
    with open(bad, "wb") as f:
        f.write(b"not a parquet file")
    for c in (conf, jconf):
        monkeypatch.setattr(c, "ignore_corrupt_files", ignore)
    files = [(bad, []), (good, [])]
    if ignore:
        _, _, touts = _scan_both(files, [0, 1])
        assert sum(int(b.num_rows) for b in touts) == N
    else:
        with pytest.raises(Exception):
            list(JScan(files, JSCHEMA, [0]).execute(JCtx()))
        with pytest.raises(Exception):
            list(ParquetScanExec(files, TSCHEMA, [0]).execute(
                ExecContext(device="cpu")))


def _sink_rows(tmp_path, seed=3):
    """The same three batches (numeric, with nulls) in both packages."""
    from test_torch_join import _pair

    rng = np.random.default_rng(seed)
    pairs = []
    for n in (100, 700, 0):
        data = {"k": rng.integers(0, 50, n), "v": rng.random(n),
                "d": rng.integers(0, 9000, n).astype(np.int32)}
        valid = {"v": rng.random(n) >= 0.2}
        pairs.append(_pair([("k", "INT64"), ("v", "FLOAT64"), ("d", "DATE")],
                           data, valid, 1024))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("tasks", [1, 2])
def test_sink_files_equal(tmp_path, tasks):
    jbs, tbs = _sink_rows(tmp_path)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for part in range(tasks):
        jsink = JSink(JMem(jbs, jbs[0].schema), jdir,
                      row_group_rows=256, props={"compression": "snappy"})
        tsink = ParquetSinkExec(MemorySourceExec(tbs, tbs[0].schema), tdir,
                                row_group_rows=256,
                                props={"compression": "snappy"})
        jstat = list(jsink.execute(JCtx(partition=part,
                                        num_partitions=tasks)))[0]
        tstat = list(tsink.execute(ExecContext(
            partition=part, num_partitions=tasks, device="cpu")))[0]
        assert int(np.asarray(jstat.columns[1].data)[0]) == \
            int(tstat.columns[1].data[0]) == 800
        tpath = tstat.to_numpy()["path"][0].decode()
        assert int(tstat.columns[2].data[0]) == os.path.getsize(tpath)
        jpath = jstat.to_numpy()["path"][0].decode()
        assert os.path.relpath(tpath, tdir) == os.path.relpath(jpath, jdir)
    if tasks == 1:
        names = [("jax", "port")]
    else:
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(tdir)) == \
            ["part-00000.parquet", "part-00001.parquet"]
        names = [(os.path.join("jax", n), os.path.join("port", n))
                 for n in names]
    for jn, tn in names:
        jt = pq.read_table(str(tmp_path / jn))
        tt = pq.read_table(str(tmp_path / tn))
        assert tt.equals(jt)
        assert pq.ParquetFile(str(tmp_path / tn)).num_row_groups == \
            pq.ParquetFile(str(tmp_path / jn)).num_row_groups == 4
    if tasks == 2:   # a part directory: a rerun starts from none
        ParquetSinkExec.clear_stale_parts(tdir)
        assert os.listdir(tdir) == []


def _scan_task(paths, projection, predicate=None):
    node = pb.PlanNode()
    sc = node.parquet_scan
    for p in paths:
        sc.file_group.files.add().path = p
    for name, kind in FIELDS:
        f = sc.file_schema.fields.add()
        f.name = name
        f.nullable = True
        f.dtype.kind = getattr(pb, {"INT64": "TK_INT64",
                                    "FLOAT64": "TK_FLOAT64",
                                    "INT32": "TK_INT32", "DATE": "TK_DATE32",
                                    "STRING": "TK_STRING"}[kind])
    sc.projection.extend(projection)
    if predicate is not None:
        e = sc.pruning_predicates.add()
        e.binary.op = pb.OP_GE
        e.binary.left.column.name = predicate[0]
        e.binary.right.literal.dtype.kind = pb.TK_INT64
        e.binary.right.literal.int_value = predicate[1]
    return node


def test_scan_and_sink_decode_from_the_same_bytes(tmp_path):
    paths = _write(tmp_path, nfiles=2)
    scan = _scan_task(paths, [0, 3], ("a", 5000))
    td = pb.TaskDefinition()
    td.plan.parquet_sink.input.CopyFrom(scan)
    td.plan.parquet_sink.path = str(tmp_path / "out")
    td.plan.parquet_sink.row_group_rows = 512
    kv = td.plan.parquet_sink.props.add()
    kv.key, kv.value = "compression", "zstd"
    jsink, _ = jdecode(td.SerializeToString())
    tsink, _ = decode_task_definition(td.SerializeToString())
    assert isinstance(tsink, ParquetSinkExec)
    assert isinstance(tsink.children[0], ParquetScanExec)
    assert tsink.row_group_rows == jsink.row_group_rows == 512
    jscan, tscan = jsink.children[0], tsink.children[0]
    assert tscan.schema.names() == jscan.schema.names() == ["a", "d"]
    jouts = list(jscan.execute(JCtx()))
    touts = list(tscan.execute(ExecContext(device="cpu")))
    for jb, tb in zip(jouts, touts):
        _same(jb, tb)
    assert tscan.metrics["row_groups_pruned"] == \
        jscan.metrics["row_groups_pruned"] == 5
    list(tsink.execute(ExecContext(device="cpu")))
    back = pq.read_table(str(tmp_path / "out"))
    assert back.num_rows == sum(int(b.num_rows) for b in touts)
    assert back.column("a").to_pylist() == \
        arrow_io.batch_to_arrow(touts[0]).column("a").to_pylist() + \
        [v for b in touts[1:] for v in
         arrow_io.batch_to_arrow(b).column("a").to_pylist()]


def test_remote_paths_go_through_fsspec():
    fsspec = pytest.importorskip("fsspec")
    assert filesystem.path_scheme("memory://x/y.parquet") == "memory"
    assert filesystem.path_scheme("file:///tmp/x") is None
    assert filesystem.path_scheme("/tmp/x") is None
    url = "memory://blaze_tpu_torch_test/t.parquet"
    with fsspec.open(url, "wb") as f:
        pq.write_table(_table(1, n=300), f)
    assert filesystem.exists(url) and filesystem.size(url) > 0
    op = ParquetScanExec([(url, [])], TSCHEMA, [0, 2])
    out = list(op.execute(ExecContext(device="cpu")))
    assert out[0].columns[0].data.numpy()[:300].tolist() == list(range(300))
    _, tbs = _sink_rows(None)
    sink = ParquetSinkExec(MemorySourceExec(tbs, tbs[0].schema),
                           "memory://blaze_tpu_torch_test/out.parquet")
    list(sink.execute(ExecContext(device="cpu")))
    with fsspec.open("memory://blaze_tpu_torch_test/out.parquet", "rb") as f:
        assert pq.read_table(f).num_rows == 800
