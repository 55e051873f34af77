"""The port's native library (blaze_tpu_torch/native) and its task entry
(runtime/native_entry.py) against the JAX package's, on the CPU.

Every case loads a private build of the port's library, made by g++ into a
temporary directory from the repository's sources (nothing is written into
native/). The port of tests/test_native.py's nine cases: murmur3 against
the device hash, BTB1 frames against the Python encoder, the C++ shuffle
writer's file format, bn_call end to end, its error relay (a bad task and
a Python exception with its sentinel message), bn_call_arrow's Arrow C
stream, nulls and decimals across it, and the host-driven bn_spill. Then:
hash_columns and pmod equal the JAX package's device functions; the C++
encoder's frames equal the port's Python encoder's bytes; call_native's
frames and call_arrow's tables equal the JAX package's library's for the
same task; a kill requested during a call arrives as category 5; a task
without CUDA that asked for no device raises; bt_zstd_* frames round trip
through the `zstandard` wheel both ways; with the wheel hidden the serde
takes the library's codec, not the zlib shim; the native writer and the
Python writer commit the same files; and MemManager.mem_used races 2,000
writer closes without touching a freed writer.
"""

import io
import os
import shutil
import struct
import subprocess
import threading

import numpy as np
import pytest
import torch
import zstandard

from blaze_tpu.columnar import serde as jserde
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.runtime import resources as jres
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.base import TaskKilledError
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime import native_entry, resources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [("k", "INT64"), ("v", "FLOAT64"), ("s", "STRING"), ("b", "BOOLEAN")]
SCHEMA = T.Schema([T.Field(n, getattr(T, k)) for n, k in NAMES])
JSCHEMA = JT.Schema([JT.Field(n, getattr(JT, k)) for n, k in NAMES])


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The port's binding over a private build of its library; tasks run
    on the host (native.init(device="cpu"))."""
    from blaze_tpu_torch import native as N

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    mp = pytest.MonkeyPatch()
    mp.setattr(N, "BUILD_DIR", tmp_path_factory.mktemp("native_build"))
    mp.setattr(N, "_lib", None)
    mp.setattr(N, "_error", None)
    assert N.available(), N.build_error()
    N.init(0, device="cpu")
    yield N
    native_entry.set_device(None)
    mp.undo()


@pytest.fixture(autouse=True)
def spill_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))


def _data(rng, n, nulls=False):
    data = {"k": rng.integers(-10**9, 10**9, n).astype(np.int64),
            "v": rng.random(n),
            "s": [f"key_{i}" for i in rng.integers(0, 1000, n)],
            "b": rng.random(n) > 0.5}
    valid = ({c: rng.random(n) > 0.3 for c in ("k", "v", "s")}
             if nulls else None)
    return data, valid


def _batch(rng, n, nulls=False):
    data, valid = _data(rng, n, nulls)
    return ColumnBatch.from_numpy(data, SCHEMA, validity=valid, device="cpu")


def _reader(mod, rid):
    node = mod.PlanNode()
    sch = node.ipc_reader.schema
    for name, kind in [("k", mod.TK_INT64), ("v", mod.TK_FLOAT64),
                       ("s", mod.TK_STRING), ("b", mod.TK_BOOL)]:
        sch.fields.add(name=name, dtype=mod.DataType(kind=kind))
    node.ipc_reader.provider_resource_id = rid
    return node


def _filter_task(mod, rid, stage=1):
    """ipc_reader -> Filter(v > 0.5) as TaskDefinition bytes."""
    flt = mod.PlanNode()
    flt.filter.input.CopyFrom(_reader(mod, rid))
    p = flt.filter.predicates.add()
    p.binary.op = mod.OP_GT
    p.binary.left.column.name = "v"
    p.binary.right.literal.dtype.kind = mod.TK_FLOAT64
    p.binary.right.literal.float_value = 0.5
    return mod.TaskDefinition(task_id="t", stage_id=stage, partition_id=0,
                              plan=flt).SerializeToString()


# ---- tests/test_native.py's nine cases, on the port ----

def test_murmur3_parity_with_device(native, rng):
    import jax.numpy as jnp

    from blaze_tpu.exprs.hash import hash_columns as jhash
    from blaze_tpu.exprs.hash import pmod as jpmod
    from blaze_tpu_torch.exprs.hash import hash_columns, pmod

    data, valid = _data(rng, 500, nulls=True)
    b = ColumnBatch.from_numpy(data, SCHEMA, validity=valid, device="cpu")
    jb = JBatch.from_numpy(data, JSCHEMA, validity=valid)
    n = 500
    want = hash_columns([b.columns[0], b.columns[2]],
                        row_mask=b.row_mask()).numpy()[:n]
    jwant = np.asarray(jhash([jb.columns[0], jb.columns[2]],
                             row_mask=jb.row_mask()))[:n]
    got = native.hash_columns([
        {"kind": "i64", "data": b.columns[0].data.numpy()[:n],
         "validity": b.columns[0].valid_mask().numpy()[:n]},
        {"kind": "bytes", "data": b.columns[2].data.bytes.numpy()[:n],
         "lengths": b.columns[2].data.lengths.numpy()[:n],
         "validity": b.columns[2].valid_mask().numpy()[:n]},
    ])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jwant)
    for P in (16, 200):
        pid = native.pmod(got, P)
        np.testing.assert_array_equal(pid, pmod(torch.from_numpy(want),
                                                P).numpy())
        np.testing.assert_array_equal(pid, np.asarray(jpmod(
            jnp.asarray(jwant), P)))


@pytest.mark.parametrize("nulls", [False, True])
def test_serde_frame_parity(native, rng, nulls):
    """The C++ encoder's frame is the Python encoder's, byte for byte (the
    payload always; the zstd body too where the wheel and libzstd agree at
    level 1, as here), and both decode to the same rows."""
    b = _batch(rng, 123, nulls=nulls)
    hb = serde.to_host(b)
    py_frame = hb.serialize(10, 100)
    c_frame = native.serialize_host_batch(hb, 10, 100, conf.zstd_level)
    d1 = serde.deserialize_batch(py_frame, SCHEMA, device="cpu").to_numpy()
    d2 = serde.deserialize_batch(c_frame, SCHEMA, device="cpu").to_numpy()
    for k in d1:
        assert repr(d1[k]) == repr(d2[k]), k

    def raw(frame):
        rl, cl = struct.unpack("<II", frame[4:12])
        return zstandard.ZstdDecompressor().decompress(
            frame[12:12 + cl], max_output_size=rl)

    assert raw(py_frame) == raw(c_frame)
    assert py_frame == c_frame


def test_native_shuffle_writer_format(native, rng, tmp_path):
    from blaze_tpu_torch.ops.shuffle import read_shuffle_partition

    hb = serde.to_host(_batch(rng, 400))
    w = native.NativeShuffleWriter(4, spill_dir=str(tmp_path),
                                   mem_budget=10_000)
    # uneven frames, a spill midway
    for i, (lo, hi) in enumerate([(0, 100), (100, 250), (250, 400)]):
        w.push(i % 4, hb.serialize(lo, hi))
    w.spill()
    w.push(3, hb.serialize(0, 50))
    lengths = w.commit(str(tmp_path / "n.data"), str(tmp_path / "n.index"))
    w.close()
    assert w.mem_used() == 0
    with pytest.raises(RuntimeError, match="closed"):
        w.push(0, b"")
    offs = np.frombuffer((tmp_path / "n.index").read_bytes(), "<u8")
    assert len(offs) == 5 and offs[0] == 0
    assert offs[-1] == os.path.getsize(tmp_path / "n.data")
    assert list(offs[1:] - offs[:-1]) == lengths
    conf_checks = conf.artifact_checksums
    conf.artifact_checksums = False  # a bare pair, no commit footer
    try:
        counts = [sum(int(x.num_rows) for x in read_shuffle_partition(
            str(tmp_path / "n.data"), str(tmp_path / "n.index"), p, SCHEMA,
            device="cpu")) for p in range(4)]
    finally:
        conf.artifact_checksums = conf_checks
    assert counts == [100, 150, 150, 50]


def test_call_native_task(native, rng):
    b = _batch(rng, 80)
    rid = resources.register(lambda: iter([serde.serialize_batch(b)]))
    try:
        out = native.call_native(_filter_task(pb, rid))
    finally:
        resources.pop(rid)
    frames = list(serde.read_batches(io.BytesIO(out), SCHEMA, device="cpu"))
    total = sum(int(f.num_rows) for f in frames)
    assert total == sum(1 for v in b.to_numpy()["v"] if v > 0.5) > 0


def test_call_native_error_relay(native):
    with pytest.raises(RuntimeError) as e:
        native.call_native(b"definitely not a protobuf")
    assert "bn_call failed" in str(e.value)
    assert native.last_error_category() in (3, 4)


def test_call_native_python_exception_relay(native, rng):
    """An exception raised mid-execution crosses the C ABI with its
    message in bn_last_error."""
    b = _batch(rng, 10)

    def exploding_provider():
        yield serde.serialize_batch(b)
        raise ValueError("exploding-provider-sentinel-42")

    rid = resources.register(lambda: exploding_provider())
    td = pb.TaskDefinition(task_id="t", stage_id=9, partition_id=0,
                           plan=_reader(pb, rid))
    try:
        with pytest.raises(RuntimeError) as exc:
            native.call_native(td.SerializeToString())
    finally:
        resources.pop(rid)
    assert "exploding-provider-sentinel-42" in str(exc.value)


def test_call_arrow_stream_roundtrip(native, rng):
    import pyarrow as pa

    b = _batch(rng, 120)
    rid = resources.register(lambda: iter([serde.serialize_batch(b)]))
    td = pb.TaskDefinition(task_id="t", stage_id=1, partition_id=0,
                           plan=_reader(pb, rid))
    try:
        table = native.call_arrow(td.SerializeToString()).read_all()
    finally:
        resources.pop(rid)
    assert table.schema.names == ["k", "v", "s", "b"]
    assert table.schema.types == [pa.int64(), pa.float64(), pa.string(),
                                  pa.bool_()]
    d = b.to_numpy()
    assert table.column("k").to_pylist() == [int(x) for x in d["k"]]
    assert table.column("v").to_pylist() == [float(x) for x in d["v"]]
    assert table.column("s").to_pylist() == [x.decode() for x in d["s"]]
    assert table.column("b").to_pylist() == [bool(x) for x in d["b"]]


def test_arrow_stream_nulls_and_decimal(native):
    from decimal import Decimal

    import pyarrow as pa

    schema = T.Schema([T.Field("x", T.INT64), T.Field("d", T.decimal(10, 2))])
    b = ColumnBatch.from_numpy(
        {"x": np.array([1, 2, 3, 4], np.int64),
         "d": np.array([125, -250, 0, 999], np.int64)},
        schema, validity={"x": np.array([True, False, True, True])},
        device="cpu")
    payload = native_entry.arrow_payload_header(schema) + \
        serde.serialize_batch(b)
    table = native.arrow_stream_from_payload(payload).read_all()
    assert table.column("x").to_pylist() == [1, None, 3, 4]
    assert table.schema.field("d").type == pa.decimal128(10, 2)
    assert table.column("d").to_pylist() == [
        Decimal("1.25"), Decimal("-2.50"), Decimal("0.00"), Decimal("9.99")]


def test_native_spill_hook(native):
    """bn_spill: the host asks the engine to release memory; operator state
    spills and the freed byte count crosses the C ABI."""
    from blaze_tpu_torch.ops.sort import ExternalSorter
    from blaze_tpu_torch.ops.sort_keys import SortSpec

    mgr = M.init(1 << 30)  # roomy: nothing spills on its own
    schema = T.Schema([T.Field("v", T.INT64)])
    sorter = ExternalSorter(schema, [SortSpec(0)], mgr)
    try:
        sorter.add(ColumnBatch.from_numpy(
            {"v": np.arange(5000, dtype=np.int64)}, schema, device="cpu"))
        held = sorter.mem_used()
        assert held > 0
        freed = native._require().bn_spill(1)
        assert freed >= held and sorter.mem_used() == 0
        assert len(sorter.runs) == 1  # the state moved to a disk run
        assert sum(int(b.num_rows) for b in sorter.finish()) == 5000
    finally:
        sorter.abort()
        M.init(1 << 30)


# ---- against the JAX package's library ----

@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's binding over a private build of its library."""
    from blaze_tpu import native as JN

    src = os.path.join(REPO, "native")
    lib = str(tmp_path_factory.mktemp("jax_native") /
              "libblaze_tpu_native.so")
    srcs = sorted(os.path.join(src, "src", f)
                  for f in os.listdir(os.path.join(src, "src"))
                  if f.endswith(".cpp"))
    subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-I",
                    os.path.join(src, "include"), *srcs, "-shared",
                    "-lzstd", "-ldl", "-o", lib],
                   check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "_LIB_PATH", lib)
    mp.setattr(JN, "_lib", None)
    yield JN
    mp.undo()


def test_call_native_and_arrow_equal_jax(native, jax_native, rng):
    """The same rows and task through each package's bn_call and
    bn_call_arrow: the same frame bytes and the same Arrow tables."""
    data, _ = _data(rng, 300)
    b = ColumnBatch.from_numpy(data, SCHEMA, device="cpu")
    jb = JBatch.from_numpy(data, JSCHEMA)
    rid = resources.register(lambda: iter([serde.serialize_batch(b)]))
    jrid = jres.register(lambda: iter([jserde.serialize_batch(jb)]))
    try:
        for task, jtask in ((_filter_task(pb, rid), _filter_task(jpb, jrid)),
                            (pb.TaskDefinition(plan=_reader(pb, rid))
                             .SerializeToString(),
                             jpb.TaskDefinition(plan=_reader(jpb, jrid))
                             .SerializeToString())):
            frames = native.call_native(task)
            assert frames == jax_native.call_native(jtask) and frames
            table = native.call_arrow(task).read_all()
            assert table.equals(jax_native.call_arrow(jtask).read_all())
            assert table.num_rows > 0
    finally:
        resources.pop(rid)
        jres.pop(jrid)


def test_a_kill_arrives_as_category_5(native, rng):
    b = _batch(rng, 64)

    def provider():
        yield serde.serialize_batch(b)
        native.request_kill()  # while bn_call runs the task
        yield serde.serialize_batch(b)

    rid = resources.register(lambda: provider())
    try:
        with pytest.raises(TaskKilledError):
            native.call_native(_filter_task(pb, rid))
        assert native.last_error_category() == 5
        assert native.kill_requested()
    finally:
        native.clear_kill()
        resources.pop(rid)
    assert not native.kill_requested()
    assert native_entry.error_category_code(TaskKilledError("x")) == 5
    assert isinstance(native_entry.exception_for_code(5), TaskKilledError)


def test_a_task_without_cuda_must_ask_for_the_cpu(native, rng):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    b = _batch(rng, 8)
    rid = resources.register(lambda: iter([serde.serialize_batch(b)]))
    native_entry.set_device(None)
    try:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            native.call_native(_filter_task(pb, rid))
    finally:
        native.init(0, device="cpu")
        resources.pop(rid)


# ---- the codec ----

@pytest.mark.parametrize("level", [1, 3])
def test_zstd_round_trip_with_the_wheel(native, rng, level):
    for n in (0, 1, 1000, 1 << 17, 3 << 20):
        raw = rng.integers(0, 64, n, dtype=np.uint8).tobytes()
        comp = native.zstd_compress(raw, level)
        assert comp[:4] == b"\x28\xb5\x2f\xfd"  # a zstd frame
        assert zstandard.ZstdDecompressor().decompress(
            comp, max_output_size=n) == raw
        wheel = zstandard.ZstdCompressor(level=level).compress(raw)
        assert native.zstd_decompress(memoryview(wheel), n) == raw
    with pytest.raises(ValueError, match="corrupt"):
        native.zstd_decompress(b"\x28\xb5\x2f\xfd" + b"\0" * 9, 100)


def test_without_the_wheel_the_serde_takes_the_library_codec(native, rng,
                                                             monkeypatch):
    b = _batch(rng, 200, nulls=True)
    hb = serde.to_host(b)
    wheel_frame = hb.serialize()
    monkeypatch.setattr(serde, "zstandard", None)
    monkeypatch.setattr(serde, "_CODEC", None)
    assert serde.codec() == "libzstd " + native.zstd_version()
    frame = hb.serialize()
    rl, cl = struct.unpack("<II", frame[4:12])
    body = frame[12:12 + cl]
    assert body[:4] == b"\x28\xb5\x2f\xfd"  # zstd, not the zlib shim's
    # the wheel reads the library's frame: the wheel's frame's payload
    wl, wc = struct.unpack("<II", wheel_frame[4:12])
    assert zstandard.ZstdDecompressor().decompress(
        body, max_output_size=rl) == zstandard.ZstdDecompressor().decompress(
        wheel_frame[12:12 + wc], max_output_size=wl)
    # one libzstd: the serde's frame is the C++ encoder's, byte for byte,
    # and the serde decodes it through the library
    c_frame = native.serialize_host_batch(hb, 0, hb.num_rows,
                                          conf.zstd_level)
    assert c_frame == frame
    got = serde.deserialize_batch(c_frame, SCHEMA, device="cpu").to_numpy()
    assert repr(got) == repr(b.to_numpy())


# ---- the writer ----

def test_native_and_python_writers_write_the_same_files(native, rng,
                                                        tmp_path,
                                                        monkeypatch):
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops import shuffle as S
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.basic import MemorySourceExec

    batches = [_batch(rng, n, nulls=True) for n in (500, 200, 61)]
    files, writers = [], []
    for route in ("native", "python"):
        if route == "python":
            monkeypatch.setattr(native, "available", lambda: False)
        d, i = str(tmp_path / f"{route}.data"), str(tmp_path /
                                                    f"{route}.index")
        w = S.ShuffleWriterExec(
            MemorySourceExec(batches, SCHEMA),
            S.Partitioning("hash", 7, (ir.col("k"), ir.col("s"))), d, i)
        assert list(w.execute(ExecContext(partition=1, num_partitions=3,
                                          device="cpu"))) == []
        files.append((open(d, "rb").read(), open(i, "rb").read()))
        writers.append(w.metrics["shuffle_writer_native"])
    assert files[0] == files[1]
    assert writers == [1, 0]


def test_mem_used_races_writer_closes(native):
    """A MemManager summing its consumers on one thread while another
    closes native writers, 2,000 rounds: mem_used of a closed writer is 0
    and never reaches a freed C++ writer (the JAX package's segfaults
    here)."""
    from blaze_tpu_torch.ops.shuffle import _NativeWriterState

    mgr = M.MemManager(1 << 40)
    stop = threading.Event()
    sums = []

    def hammer():
        while not stop.is_set():
            sums.append(mgr.mem_used())

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for r in range(2000):
            w = _NativeWriterState(4, mgr)
            w.push(r % 4, b"x" * (1 + r % 64))
            w.close()
            assert w.mem_used() == 0
    finally:
        stop.set()
        t.join()
    assert sums and all(s >= 0 for s in sums)
    assert mgr.mem_used() == 0
