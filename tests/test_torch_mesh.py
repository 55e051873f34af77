"""The port's device-mesh exchange (parallel/shuffle.py,
parallel/stage_exchange.py) against the JAX package's, on the CPU.

The same seeded numpy rows go into a batch of each package. The JAX
package's exchange runs inside `shard_map` over D of its eight virtual CPU
devices (tests/conftest.py); the port's over D logical CPU devices (one
process, a list of devices, as the JAX module's one process over its
mesh). Function level: `partition_ids` is bitwise equal on int64, double,
string and wide-decimal keys, padding sentinel included;
`_stage_by_partition`'s staged rows, counts and overflow are equal for
quotas with and without overflow; `mesh_shuffle_batch_grouped` gives
every device the same rows in the same order, the same counts and
overflow for D = 4 and P = 4, 8 and 16. Stage level:
`run_mesh_shuffle_stage`'s partitions hold the reference's rows in order
at the same D; at D = 1 they hold the port's own file path's rows; a quota
overflow goes to files with the rows unchanged, each map subplan running
once; and a retryable fault at `exchange.stage` degrades the stage to the
file path with the reference's counters and rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.parallel import shuffle as jshuffle
from blaze_tpu.parallel import stage_exchange as jstage
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.plan.to_proto import encode_schema as jencode_schema
from blaze_tpu.runtime import resources as jresources
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.parallel import shuffle, stage_exchange
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.to_proto import encode_schema
from blaze_tpu_torch.runtime import resources
from torch_parity import no_jax_native, resilience

CPU = torch.device("cpu")
D = 4
LOCAL_CAP = 64
FIELDS = [("k", "INT64"), ("x", "FLOAT64"), ("s", "STRING"),
          ("dec", "WIDE"), ("v", "FLOAT64")]
KEYSETS = [[0], [1], [2], [3], [0, 2, 3]]


def _schema(mod):
    dt = {"WIDE": mod.decimal(28, 2)}
    return mod.Schema([mod.Field(n, dt.get(k) or getattr(mod, k))
                       for n, k in FIELDS])


def _data(rng, n):
    """n seeded rows; 10% null keys and the last row's (every batch of
    2 rows or more has the same validity layout); strings of 1-12 bytes
    (row 0 the longest, so every batch has one width); wide decimals past
    int64."""
    k = rng.integers(0, 1000, n).astype(np.int64)
    x = rng.standard_normal(n) * 100
    s = [b"s%d" % i + b"x" * int(i % 9) for i in rng.integers(0, 500, n)]
    if n:
        s[0] = b"y" * 12
    dec = [int(i) * 10 ** 19 + int(j) for i, j in
           zip(rng.integers(-50, 50, n), rng.integers(0, 10 ** 6, n))]
    data = {"k": k.astype(object), "x": x.astype(object),
            "s": np.array(s, object), "dec": np.array(dec, object),
            "v": rng.random(n)}
    for name in ("k", "x", "s", "dec"):
        null = rng.random(n) < 0.1
        null[-1:] = True
        null[:1] = False
        data[name][null] = None
    return data


def _pair(data, cap):
    return (JBatch.from_numpy(data, _schema(JT), capacity=cap),
            ColumnBatch.from_numpy(data, _schema(T), capacity=cap,
                                   device="cpu"))


def _rows(batch) -> dict:
    return {k: list(v) for k, v in batch.to_numpy().items()}


def _multiset(rows: dict) -> list:
    """Rows as a sorted list, numpy scalars as Python values."""
    return sorted((tuple(x.item() if isinstance(x, np.generic) else x
                         for x in r) for r in zip(*rows.values())),
                  key=repr)


@pytest.mark.parametrize("keys", KEYSETS)
@pytest.mark.parametrize("P", [3, 8, 200])
def test_partition_ids_match_jax(rng, keys, P):
    jb, tb = _pair(_data(rng, 150), 256)
    want = np.asarray(jshuffle.partition_ids(jb, keys, P))
    got = shuffle.partition_ids(tb, keys, P).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[150:] == P).all() and (got[:150] < P).all()


def test_keyless_partition_ids_match_jax(rng):
    jb, tb = _pair(_data(rng, 50), 64)
    np.testing.assert_array_equal(
        shuffle.partition_ids(tb, [], 6).numpy(),
        np.asarray(jshuffle.partition_ids(jb, [], 6)))


@pytest.mark.parametrize("quota", [64, 20, 3])
def test_stage_by_partition_matches_jax(rng, quota):
    P = 8
    jb, tb = _pair(_data(rng, 60), 64)
    jstaged, jcounts, jover = jshuffle._stage_by_partition(
        jb, jshuffle.partition_ids(jb, [0], P), P, quota)
    staged, counts, over = shuffle._stage_by_partition(
        tb, shuffle.partition_ids(tb, [0], P), P, quota)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(over) == int(jover)
    assert (int(over) > 0) == (quota == 3)
    # the live slots of every bucket, in slot order
    pos = np.concatenate([p * quota + np.arange(c) for p, c in
                          enumerate(np.asarray(jcounts))]).astype(np.int64)
    assert _rows(staged.take(torch.from_numpy(pos), len(pos))) == _rows(
        jstaged.take(jnp.asarray(pos), len(pos)))


def _jax_grouped(jbatches, keys, P, k, quota):
    """The JAX package's mesh_shuffle_batch_grouped in shard_map over the
    first D devices: each device's (rows, counts) and the overflow."""
    schema = jbatches[0].schema
    cols = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, 0),
                                  *[b.columns for b in jbatches])
    num_rows = jnp.asarray([int(b.num_rows) for b in jbatches], jnp.int32)
    mesh = Mesh(np.array(jax.devices()[:D]), ("p",))

    def step(local_cols, local_num_rows):
        b = JBatch(schema, local_cols, local_num_rows[0], LOCAL_CAP)
        out, counts, overflow = jshuffle.mesh_shuffle_batch_grouped(
            b, keys, "p", P, k, quota)
        return out.columns, out.num_rows[None], counts[None], overflow[None]

    run = jax.jit(jstage._shard_map(
        step, mesh=mesh, in_specs=(JP("p"), JP("p")),
        out_specs=(JP("p"), JP("p"), JP("p"), JP("p"))))
    out_cols, out_rows, counts, overflow = run(cols, num_rows)
    cap = D * quota
    per_dev = []
    for d in range(D):
        b = JBatch(schema, jax.tree_util.tree_map(
            lambda a: a[d * cap:(d + 1) * cap], out_cols),
            int(out_rows[d]), cap)
        per_dev.append((_rows(b), np.asarray(counts[d])))
    return per_dev, int(np.asarray(overflow).max())


@pytest.mark.parametrize("P", [4, 8, 16])
@pytest.mark.parametrize("quota", [LOCAL_CAP, 8])
def test_grouped_exchange_matches_jax(rng, P, quota):
    k = P // D
    sizes = [64, 10, 2, 37]
    pairs = [_pair(_data(rng, n), LOCAL_CAP) for n in sizes]
    keys = [0, 2, 3]
    want, want_over = _jax_grouped([j for j, _ in pairs], keys, P, k, quota)
    outs, counts, over = shuffle.mesh_shuffle_batch_grouped(
        [t for _, t in pairs], keys, [CPU] * D, P, k, quota)
    assert int(over) == want_over
    assert (want_over > 0) == (quota == 8)
    for d in range(D):
        rows, jcounts = want[d]
        np.testing.assert_array_equal(counts[d].numpy(), jcounts)
        assert _rows(outs[d]) == rows, d
    if quota == LOCAL_CAP:
        # every row arrives once, at the device owning its partition
        got = [r for d in range(D) for r in _multiset(_rows(outs[d]))]
        sent = [r for _, t in pairs for r in _multiset(_rows(t))]
        assert sorted(got, key=repr) == sorted(sent, key=repr)


def test_mesh_shuffle_batch_sends_each_row_to_its_partition(rng):
    pairs = [_pair(_data(rng, n), LOCAL_CAP) for n in (64, 2, 30, 5)]
    outs, over = shuffle.mesh_shuffle_batch([t for _, t in pairs], [0],
                                            [CPU] * D, D)
    assert int(over) == 0
    for d, out in enumerate(outs):
        assert (shuffle.partition_ids(out, [0], D)[:int(out.num_rows)]
                == d).all()
    assert sum(int(o.num_rows) for o in outs) == 101


# -- stage level -------------------------------------------------------------


def _writer_node(mod, encode, schema, rid, P, key="k"):
    node = mod.PlanNode()
    w = node.shuffle_writer
    w.input.ffi_reader.schema.CopyFrom(encode(schema))
    w.input.ffi_reader.export_iter_resource_id = rid
    w.partitioning.kind = mod.HashRepartition.HASH
    w.partitioning.num_partitions = P
    w.partitioning.keys.add().column.name = key
    return node


def _partition_rows(reader, P, host_to_device) -> list:
    """Each partition's rows, in the order its provider serves them."""
    out = []
    for p in range(P):
        acc = {}
        for b in reader(p):
            if not hasattr(b, "to_numpy"):
                b = host_to_device(b)
            for k, v in _rows(b).items():
                acc.setdefault(k, []).extend(v)
        out.append(acc)
    return out


def _stage_both(monkeypatch, tmp_path, batches, P, quota=None, d=None):
    """run_mesh_shuffle_stage over the same map batches in each package,
    the port on as many logical devices as the JAX package uses (d, or its
    use_d); returns (port partitions, JAX partitions, map calls)."""
    from blaze_tpu.ops.host_sort import host_to_device as jh2d
    from blaze_tpu_torch.ops.host_sort import host_to_device

    no_jax_native(monkeypatch)
    d = d or min(len(jax.devices()), P)
    monkeypatch.setattr(stage_exchange, "mesh_devices",
                        lambda dev: [CPU] * d)
    calls = {"port": 0, "jax": 0}

    def source(side, items):
        def provider():
            calls[side] += 1
            return iter(items)
        return provider

    rid = resources.register(source("port", [t for _, t in batches]))
    jrid = jresources.register(source("jax", [j for j, _ in batches]))
    try:
        assert stage_exchange.run_mesh_shuffle_stage(
            _writer_node(pb, encode_schema, _schema(T), rid, P), 991, 1,
            quota=quota, work_dir=str(tmp_path / "port"), device="cpu")
        assert jstage.run_mesh_shuffle_stage(
            _writer_node(jpb, jencode_schema, _schema(JT), jrid, P), 991, 1,
            quota=quota, work_dir=str(tmp_path / "jax"))
        got = _partition_rows(resources.get("shuffle:991"), P,
                              lambda hb: host_to_device(hb, device="cpu"))
        want = _partition_rows(jresources.get("shuffle:991"), P, jh2d)
    finally:
        for mod, r in ((resources, rid), (jresources, jrid)):
            mod.pop("shuffle:991")
            mod.pop(r)
    return got, want, calls


@pytest.mark.parametrize("P", [4, 16])
def test_mesh_stage_partitions_match_jax(rng, monkeypatch, tmp_path, P):
    batches = [_pair(_data(rng, n), 256) for n in (200, 37, 256)]
    got, want, calls = _stage_both(monkeypatch, tmp_path, batches, P)
    assert got == want
    assert calls == {"port": 1, "jax": 1}
    assert sum(len(p["k"]) for p in got) == 493


def test_one_device_matches_the_file_path(rng, monkeypatch, tmp_path):
    """At D = 1 (the exchange_local route) every partition holds the rows
    the port's own file path writes for it."""
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.ops.shuffle import (
        Partitioning, ShuffleWriterExec, read_shuffle_partition,
    )
    from blaze_tpu_torch.exprs.ir import col

    P = 8
    tbs = [_pair(_data(rng, n), 256)[1] for n in (200, 0, 129)]
    monkeypatch.setattr(stage_exchange, "mesh_devices", lambda dev: [dev])
    rid = resources.register(lambda: iter(tbs))
    stats = {}
    try:
        assert stage_exchange.run_mesh_shuffle_stage(
            _writer_node(pb, encode_schema, _schema(T), rid, P), 992, 1,
            stats=stats, device="cpu")
        mesh = _partition_rows(resources.get("shuffle:992"), P, None)
    finally:
        resources.pop("shuffle:992")
        resources.pop(rid)
    data, index = str(tmp_path / "m.data"), str(tmp_path / "m.index")
    list(ShuffleWriterExec(MemorySourceExec(tbs, _schema(T)),
                           Partitioning("hash", P, (col("k"),)), data,
                           index).execute(ExecContext(device="cpu")))
    for p in range(P):
        fp = {}
        for b in read_shuffle_partition(data, index, p, _schema(T),
                                        device="cpu"):
            for k, v in _rows(b).items():
                fp.setdefault(k, []).extend(v)
        assert _multiset(mesh[p]) == _multiset(fp), p
    from blaze_tpu_torch.runtime.memory import batch_nbytes

    assert stats["bytes"] > 0 and len(stats["ops"]) == 1
    # the half-budget rule's count: the batches kept, the empty one not
    assert stats["pinned"] == batch_nbytes(tbs[0]) + batch_nbytes(tbs[2])


def test_overflow_goes_to_files_once(rng, monkeypatch, tmp_path):
    """A clean batch exchanges; a fully skewed one overflows a tiny quota
    and goes to the file path in place: the map subplan runs once, and
    each partition serves its mesh slices, then its file segments, with
    the reference's rows in the reference's order."""
    clean = _pair(_data(rng, 64), 64)
    skew = _data(rng, 64)
    skew["k"] = np.full(64, 7, object)
    batches = [clean, _pair(skew, 64)]
    got, want, calls = _stage_both(monkeypatch, tmp_path, batches, 4,
                                   quota=8)
    assert calls == {"port": 1, "jax": 1}
    assert got == want
    assert sum(len(p["k"]) for p in got) == 128
    assert (tmp_path / "port" / "stage991_meshovf0.data").exists()


def _run_plan_both(monkeypatch, tmp_path, build, **kw):
    """A plan of each package's plan_model through its run_plan at its
    defaults, the port's mesh over the JAX package's device count."""
    from blaze_tpu.exprs import ir as jir
    from blaze_tpu.spark import plan_model as JPM
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.spark import plan_model as PM
    from blaze_tpu_torch.spark.local_runner import run_plan

    no_jax_native(monkeypatch)
    monkeypatch.setattr(stage_exchange, "mesh_devices",
                        lambda dev: [CPU] * min(len(jax.devices()), 4))
    info, jinfo = {}, {}
    out = run_plan(build(PM, T, ir), num_partitions=4, run_info=info,
                   work_dir=str(tmp_path / "port"), device="cpu", **kw)
    jout = jrun_plan(build(JPM, JT, jir), num_partitions=4, run_info=jinfo,
                     work_dir=str(tmp_path / "jax"), **kw)
    return (out.to_numpy(), info), (jout.to_numpy(), jinfo)


def _same(rows: dict, jrows: dict) -> None:
    """Keys bitwise, sums within rtol 1e-12: the two packages' aggregates
    add the same rows in different orders."""
    assert list(rows) == list(jrows)
    for k in rows:
        g, w = np.asarray(rows[k]), np.asarray(jrows[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, w)


def _skewed_table(rng, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "t.parquet")
    v = rng.random(1000)
    pq.write_table(pa.table({"k": pa.array(np.full(1000, 7), pa.int64()),
                             "v": pa.array(v)}), path)
    return path, v


def _skew_plan(path):
    def build(PM, mod, ir):
        s = mod.Schema([mod.Field("k", mod.INT64),
                        mod.Field("v", mod.FLOAT64)])
        x = PM.shuffle_exchange(PM.scan(s, [(path, [])]), [ir.col("k")], 4)
        return PM.hash_agg(x, "partial", [ir.col("k")], ["k"],
                           [{"fn": "sum", "args": [ir.col("v")],
                             "dtype": mod.FLOAT64, "name": "s"}],
                           mod.Schema([mod.Field("k", mod.INT64)]))
    return build


def test_run_plan_quota_overflow_falls_back(rng, monkeypatch, tmp_path):
    """mesh_quota=8 with every row on one key (the reference's
    test_stage_exchange_overflow_falls_back): the stage still counts as a
    mesh stage, its rows go through files, and the answer is the
    reference's and numpy's."""
    path, v = _skewed_table(rng, tmp_path)
    (rows, info), (jrows, jinfo) = _run_plan_both(
        monkeypatch, tmp_path, _skew_plan(path), mesh_quota=8)
    _same(rows, jrows)
    (total,) = [np.asarray(x) for k, x in rows.items() if k.endswith("sum")]
    np.testing.assert_allclose(float(total[0]), float(v.sum()), rtol=1e-9)
    for key in ("mesh_stages", "file_stages"):
        assert info[key] == jinfo[key] == (1 if key == "mesh_stages" else 0)
    # every batch overflowed the quota: none stayed on the devices
    assert info["mesh_pinned_bytes"] == 0
    assert list((tmp_path / "port").glob("stage*_meshovf*.data"))


def test_exchange_fault_degrades_to_files(rng, monkeypatch, tmp_path):
    """A seeded retryable fault at exchange.stage: the stage runs on the
    file path, and the degradation counters and rows are the
    reference's."""
    from blaze_tpu.runtime import faults as jfaults
    from blaze_tpu_torch.runtime import faults

    path, _ = _skewed_table(rng, tmp_path)
    spec = {"seed": 11, "points": {"exchange.stage": {"kind": "io",
                                                      "nth": 1}}}
    faults.install(spec)
    jfaults.install(spec)
    try:
        (rows, info), (jrows, jinfo) = _run_plan_both(
            monkeypatch, tmp_path, _skew_plan(path))
    finally:
        faults.install(None)
        jfaults.install(None)
    assert info["degraded.mesh_to_file"] == jinfo["degraded.mesh_to_file"] \
        == 1
    assert resilience(info) == resilience(jinfo)
    assert (info["mesh_stages"], info["file_stages"]) == (
        jinfo["mesh_stages"], jinfo["file_stages"]) == (0, 1)
    _same(rows, jrows)
