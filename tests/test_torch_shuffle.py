"""The port's shuffle writers and readers (ops/shuffle.py) and map-output commit
(runtime/artifacts.py) against the JAX package's, on the CPU.

The same batches go through both packages' ShuffleWriterExec under hash,
single and round-robin partitioning: the committed .data and .index files,
checksum footer included, must be byte-identical, and each package reads
the other's partitions. Also: restart-stable round robin, the writer's spill
to a tempfile, the RSS writer's frames, IpcWriterExec -> IpcReaderExec, a
flipped byte in either file raising CorruptArtifactError, crash-atomic
commit, sweep_orphans, and the decoder's four shuffle arms. The JAX
package runs with its native layer out (tests/torch_parity.py), but for
one case that builds its own copy of the native library and holds the
port's files to its C++ writer's.
"""

import io
import os
import subprocess

import numpy as np
import pytest

from blaze_tpu.exprs import ir as jir
from blaze_tpu.ops import shuffle as JS
from blaze_tpu.ops.base import ExecContext as JCtx
from blaze_tpu.ops.basic import MemorySourceExec as JMem
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.runtime import resources as jres
from blaze_tpu.runtime.executor import execute_plan as jexec
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import shuffle as S
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.basic import MemorySourceExec
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import artifacts, memory, resources
from test_torch_serde import _assert_rows_equal, _pair
from torch_parity import no_jax_native

HASH_KEYS = ("c5", "c9", "c4")   # int64, float64, bool


@pytest.fixture(autouse=True)
def spill_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    no_jax_native(monkeypatch)


def _batches():
    """Three (JAX, port) batch pairs of every dense kind, two shapes."""
    return [_pair(n, cap, seed=s) for s, (n, cap) in
            enumerate([(500, 512), (200, 1024), (61, 512)])]


def _part(mod, irmod, kind, P):
    keys = HASH_KEYS if kind == "hash" else ()
    return mod.Partitioning(kind, P, tuple(irmod.col(k) for k in keys))


def _write_both(tmp_path, kind, P, task=2, manager=None, pairs=None):
    """Both packages' map outputs of the same batches; returns the paths
    ((jax data, index), (port data, index)) and the port writer."""
    pairs = pairs or _batches()
    jbs, tbs = [j for j, _ in pairs], [t for _, t in pairs]
    jd, ji = str(tmp_path / "j.data"), str(tmp_path / "j.index")
    td, ti = str(tmp_path / "t.data"), str(tmp_path / "t.index")
    jw = JS.ShuffleWriterExec(JMem(jbs, jbs[0].schema),
                              _part(JS, jir, kind, P), jd, ji)
    list(jexec(jw, JCtx(partition=task, num_partitions=3)))
    tw = S.ShuffleWriterExec(MemorySourceExec(tbs, tbs[0].schema),
                             _part(S, ir, kind, P), td, ti)
    assert list(tw.execute(ExecContext(partition=task, num_partitions=3,
                                       device="cpu",
                                       mem_manager=manager))) == []
    return (jd, ji), (td, ti), tw, pairs


def _same_files(a, b):
    for x, y in zip(a, b):
        with open(x, "rb") as f, open(y, "rb") as g:
            assert f.read() == g.read(), (x, y)


@pytest.mark.parametrize("kind,P", [("hash", 7), ("hash", 200),
                                    ("single", 1), ("round_robin", 5)])
def test_map_output_byte_identical_and_cross_read(tmp_path, kind, P):
    (jd, ji), (td, ti), tw, pairs = _write_both(tmp_path, kind, P)
    _same_files((jd, ji), (td, ti))
    assert artifacts.verify_pair(td, ti)
    offsets, meta = artifacts.read_index(ti)
    assert len(offsets) == 8 * (P + 1) and meta["n_frames"] > 0
    assert tw.metrics["shuffle_bytes_written"] == os.path.getsize(td)
    schema, jschema = pairs[0][1].schema, pairs[0][0].schema
    rows = 0
    for p in range(P):
        # the port reads the JAX file, the JAX package the port's
        mine = list(S.read_shuffle_partition(jd, ji, p, schema, device="cpu"))
        theirs = list(JS.read_shuffle_partition(td, ti, p, jschema))
        assert len(mine) == len(theirs)
        for t, j in zip(mine, theirs):
            _assert_rows_equal(t, j)
            rows += int(t.num_rows)
        hosts = list(S.read_shuffle_partition_host(td, ti, p, schema))
        assert [h.num_rows for h in hosts] == [int(t.num_rows) for t in mine]
    assert rows == 761


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """A copy of the JAX package's native library, built from the sources
    into a temp dir (so no other test's build of
    native/libblaze_tpu_native.so is ever read half-written)."""
    import shutil

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the native library")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    lib = str(tmp_path_factory.mktemp("native") / "libblaze_tpu_native.so")
    srcs = sorted(os.path.join(src, "src", f)
                  for f in os.listdir(os.path.join(src, "src"))
                  if f.endswith(".cpp"))
    subprocess.run([cxx, "-O2", "-fPIC", "-std=c++17", "-I",
                    os.path.join(src, "include"), *srcs, "-shared",
                    "-lzstd", "-ldl", "-o", lib],
                   check=True, capture_output=True)
    return lib


@pytest.mark.parametrize("kind,P", [("hash", 7), ("round_robin", 5)])
def test_map_output_matches_the_native_writer(tmp_path, monkeypatch,
                                              native_lib, kind, P):
    """The JAX package's C++ map-output writer and frame encoder
    (native/), loaded from `native_lib`, write the port's bytes."""
    from blaze_tpu import native

    monkeypatch.setattr(native, "_LIB_PATH", native_lib)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "available",
                        lambda: native._load() is not None)
    assert native.available()
    made = []
    real_init = JS._NativeWriterState.__init__

    def init(self, *args):
        real_init(self, *args)
        made.append(self)

    monkeypatch.setattr(JS._NativeWriterState, "__init__", init)
    (jd, ji), (td, ti), _, _ = _write_both(tmp_path, kind, P)
    assert len(made) == 1  # the JAX writer was the C++ one
    _same_files((jd, ji), (td, ti))


def test_rows_keep_input_order_inside_a_partition(tmp_path):
    """Round robin over one batch of row ids: partition p holds rows
    (p - start) mod P, P + ..., ascending."""
    (_, _), (td, ti), _, pairs = _write_both(tmp_path, "round_robin", 5)
    schema = pairs[0][1].schema
    start = S.round_robin_start(2, 5)
    first = pairs[0][1]
    ints = first.columns[2].data[:500].numpy()
    for p in range(5):
        got = list(S.read_shuffle_partition(td, ti, p, schema, device="cpu"))
        head = got[0].columns[2].data[:int(got[0].num_rows)].numpy()
        want = ints[[i for i in range(500) if (start + i) % 5 == p]]
        np.testing.assert_array_equal(head, want)


def test_round_robin_is_restart_stable(tmp_path):
    """A retried task (same partition id) writes the same files; another
    task starts elsewhere."""
    pairs = _batches()
    a = _write_both(tmp_path / "a", "round_robin", 5, pairs=pairs)[1]
    b = _write_both(tmp_path / "b", "round_robin", 5, pairs=pairs)[1]
    c = _write_both(tmp_path / "c", "round_robin", 5, task=3,
                    pairs=pairs)[1]
    _same_files(a, b)
    assert open(a[1], "rb").read() != open(c[1], "rb").read()
    assert S.round_robin_start(2, 5) != S.round_robin_start(3, 5)


def test_writer_spill_keeps_the_files(tmp_path):
    """Under a budget of a few KB the writer's frame buffers spill to a
    tempfile and the commit replays them: the files stay byte-identical to
    the JAX package's unspilled ones."""
    mgr = memory.MemManager(4096)
    jfiles, tfiles, tw, _ = _write_both(tmp_path, "hash", 7, manager=mgr)
    assert tw.metrics["spill_count"] > 0 and mgr.spill_count > 0
    _same_files(jfiles, tfiles)
    assert os.listdir(conf.spill_dir) == []  # the tempfile is gone


class _Rss:
    """An RSS partition writer that keeps what it is sent."""

    def __init__(self):
        self.frames, self.flushes = [], 0

    def write(self, partition_id, payload):
        self.frames.append((partition_id, bytes(payload)))

    def flush(self):
        self.flushes += 1


def test_rss_writer_sends_the_jax_packages_frames():
    pairs = _batches()
    jbs, tbs = [j for j, _ in pairs], [t for _, t in pairs]
    jw, tw = _Rss(), _Rss()
    rid = resources.register(tw)
    jres.put(rid, jw)
    list(jexec(JS.RssShuffleWriterExec(JMem(jbs, jbs[0].schema),
                                       _part(JS, jir, "hash", 7), rid),
               JCtx(partition=1)))
    S.RssShuffleWriterExec(MemorySourceExec(tbs, tbs[0].schema),
                           _part(S, ir, "hash", 7), rid).execute(
        ExecContext(partition=1, device="cpu"))
    assert tw.frames == jw.frames and len(tw.frames) > 7
    assert tw.flushes == jw.flushes == 1


def _live_rows(batches):
    """Live rows of port batches as numpy columns (invalid slots zeroed)."""
    cols = []
    for i in range(len(batches[0].columns)):
        parts = []
        for b in batches:
            n = int(b.num_rows)
            c = b.columns[i]
            v = c.valid_mask()[:n].numpy()
            d = c.data[:n].numpy()
            parts.append(np.where(v, d.view(np.int64) if d.dtype.kind == "f"
                                  and d.itemsize == 8 else d, 0))
        cols.append(np.concatenate(parts))
    return cols


def test_ipc_writer_to_reader_round_trip():
    """IpcWriterExec sends one frame a non-empty batch; IpcReaderExec
    decodes frames on the host and uploads them as ONE macro-batch."""
    pairs = _batches()
    tbs = [t for _, t in pairs]
    empty = _pair(0, 512, seed=9)[1]
    frames = []
    cid = resources.register(frames.append)
    w = S.IpcWriterExec(MemorySourceExec(tbs + [empty], tbs[0].schema), cid)
    assert list(w.execute(ExecContext(device="cpu"))) == []
    assert len(frames) == 3
    assert w.metrics["ipc_bytes_written"] == sum(len(f) for f in frames)
    pid = resources.register(lambda: iter(frames))
    out = list(S.IpcReaderExec(tbs[0].schema, pid).execute(
        ExecContext(device="cpu")))
    assert len(out) == 1 and out[0].device.type == "cpu"
    for a, b in zip(_live_rows(out), _live_rows(tbs)):
        np.testing.assert_array_equal(a, b)


def test_ipc_reader_takes_jax_frames_streams_and_batches(tmp_path):
    """The provider may yield the JAX package's frames, file-like frame
    streams, host batches and ready batches; ready batches pass through,
    flushing what was pending before them."""
    pairs = _batches()
    jbs, tbs = [j for j, _ in pairs], [t for _, t in pairs]
    jframes = []
    cid = resources.register(jframes.append)
    jres.put(cid, jframes.append)
    list(jexec(JS.IpcWriterExec(JMem(jbs, jbs[0].schema), cid), JCtx()))
    stream = io.BytesIO(b"".join(jframes))
    items = [jframes[0], stream, serde.to_host(tbs[2]), tbs[0]]
    pid = resources.register(lambda: iter(items))
    out = list(S.IpcReaderExec(tbs[0].schema, pid).execute(
        ExecContext(device="cpu")))
    assert len(out) == 2 and out[1] is tbs[0]
    want = _live_rows([tbs[0], tbs[0], tbs[1], tbs[2], tbs[2]])
    for a, b in zip(_live_rows([out[0]]), want):
        np.testing.assert_array_equal(a, b)


def test_ipc_reader_cuts_macro_batches_at_the_target():
    """Under a small budget the byte target is 256 KB, so 3 MB of frames
    come out as several uploads, rows in order."""
    pairs = [_pair(4096, 4096, seed=s) for s in range(12)]
    tbs = [t for _, t in pairs]
    frames = [serde.serialize_batch(t) for t in tbs]
    pid = resources.register(lambda: iter(frames))
    out = list(S.IpcReaderExec(tbs[0].schema, pid).execute(
        ExecContext(device="cpu", mem_manager=memory.MemManager(1 << 20))))
    assert 2 <= len(out) < 12
    for a, b in zip(_live_rows(out), _live_rows(tbs)):
        np.testing.assert_array_equal(a, b)


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("where", ["data", "index", "footer", "short",
                                   "no_footer"])
def test_corrupt_map_output_raises(tmp_path, where):
    _, (td, ti), _, pairs = _write_both(tmp_path, "hash", 7)
    schema = pairs[0][1].schema
    offsets = np.frombuffer(artifacts.read_index(ti)[0], "<u8")
    p = int(np.argmax(np.diff(offsets)))   # the largest segment
    if where == "data":
        _flip(td, int(offsets[p]) + 20)
        match = "frame checksum mismatch"
    elif where == "index":
        _flip(ti, 8 * (p + 1) + 1)
        match = "index checksum mismatch"
    elif where == "footer":
        _flip(ti, os.path.getsize(ti) - 2)
        match = "mangled index footer"
    elif where == "no_footer":
        # the index cut back to exactly its offsets
        with open(ti, "r+b") as f:
            f.truncate(8 * len(offsets))
        match = "no checksum footer"
    else:
        with open(td, "r+b") as f:
            f.truncate(int(offsets[-1]) - 5)
        p = len(offsets) - 2
        while offsets[p + 1] == offsets[p]:
            p -= 1
        match = "short segment"
    with pytest.raises(artifacts.CorruptArtifactError, match=match) as e:
        list(S.read_shuffle_partition(td, ti, p, schema, device="cpu"))
    assert "lineage repair" in str(e.value)
    assert not artifacts.verify_pair(td, ti)


def test_commit_is_crash_atomic(tmp_path):
    """A writer that fails mid-commit leaves neither final file nor temp."""
    d, i = str(tmp_path / "x.data"), str(tmp_path / "x.index")

    def write(tmp_d, tmp_i):
        with open(tmp_d, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        artifacts.commit_shuffle_pair(write, d, i)
    assert os.listdir(tmp_path) == []
    artifacts.commit_file(lambda p: open(p, "wb").write(b"ok"), d)
    assert open(d, "rb").read() == b"ok" and os.listdir(tmp_path) == [
        "x.data"]


def test_commit_refuses_data_that_is_not_frames(tmp_path):
    """Data that does not walk as serde frames cannot be stamped, so the
    commit fails rather than publish an index without its footer."""
    d, i = str(tmp_path / "x.data"), str(tmp_path / "x.index")

    def write(tmp_d, tmp_i):
        with open(tmp_d, "wb") as f:
            f.write(b"not a frame stream")
        with open(tmp_i, "wb") as f:
            f.write(np.array([0, 18], "<u8").tobytes())

    with pytest.raises(ValueError, match="bad frame header"):
        artifacts.commit_shuffle_pair(write, d, i)
    assert os.listdir(tmp_path) == []


def test_sweep_orphans_removes_dead_writers_temps(tmp_path):
    dead = []
    for _ in range(2):
        p = subprocess.Popen(["true"])
        p.wait()
        dead.append(p.pid)
    me = os.getpid()
    names = [f"a.data{artifacts.ORPHAN_TAG}{dead[0]}.0",
             f"a.index{artifacts.ORPHAN_TAG}{dead[0]}.1",
             f"blz{dead[0]}-x1.spill",
             f"b.data{artifacts.ORPHAN_TAG}{me}.0", f"blz{me}-y.spill",
             "c.data", "c.index", "notes.txt"]
    for n in names:
        (tmp_path / n).write_bytes(b"x")
    # a lock left by a dead sweeper is broken and retaken
    (tmp_path / artifacts.SWEEP_LOCK).write_text(str(dead[0]))
    removed = artifacts.sweep_orphans([str(tmp_path)])
    assert sorted(os.path.basename(r) for r in removed) == sorted(names[:3])
    assert sorted(os.listdir(tmp_path)) == sorted(names[3:])
    # a second dead writer's temps go too; the live process's stay
    later = [f"d.data{artifacts.ORPHAN_TAG}{dead[1]}.2",
             f"blz{dead[1]}-w.spill"]
    for n in later:
        (tmp_path / n).write_bytes(b"x")
    removed = artifacts.sweep_orphans(str(tmp_path))
    assert sorted(os.path.basename(r) for r in removed) == sorted(later)
    assert sorted(os.listdir(tmp_path)) == sorted(names[3:])
    # a live sweeper's lock makes the sweep skip the directory
    (tmp_path / artifacts.SWEEP_LOCK).write_text(str(me))
    (tmp_path / f"blz{dead}-z.spill").write_bytes(b"x")
    assert artifacts.sweep_orphans([str(tmp_path)]) == []


@pytest.mark.parametrize("arm", ["shuffle_writer", "rss_shuffle_writer",
                                 "ipc_writer", "ipc_reader"])
def test_decoder_builds_the_shuffle_arms(arm):
    src = jpb.PlanNode()
    f = src.ffi_reader.schema.fields.add()
    f.name = "k"
    f.dtype.kind = jpb.TK_INT64
    src.ffi_reader.export_iter_resource_id = "rid:src"
    node = jpb.PlanNode()
    n = getattr(node, arm)
    if arm == "ipc_reader":
        n.schema.CopyFrom(src.ffi_reader.schema)
        n.provider_resource_id = "rid:p"
        n.num_partitions = 4
    else:
        n.input.CopyFrom(src)
    if arm in ("shuffle_writer", "rss_shuffle_writer"):
        n.partitioning.kind = jpb.HashRepartition.HASH
        n.partitioning.num_partitions = 9
        n.partitioning.keys.add().column.name = "k"
    if arm == "shuffle_writer":
        n.data_file, n.index_file = "/x.data", "/x.index"
    if arm == "rss_shuffle_writer":
        n.rss_writer_resource_id = "rid:rss"
    if arm == "ipc_writer":
        n.consumer_resource_id = "rid:c"
    td = jpb.TaskDefinition()
    td.plan.CopyFrom(node)
    op, _ = decode_task_definition(td.SerializeToString())
    cls = {"shuffle_writer": S.ShuffleWriterExec,
           "rss_shuffle_writer": S.RssShuffleWriterExec,
           "ipc_writer": S.IpcWriterExec,
           "ipc_reader": S.IpcReaderExec}[arm]
    assert type(op) is cls
    if arm == "ipc_reader":
        assert op.num_partitions == 4 and op.schema.names() == ["k"]
    else:
        assert isinstance(op.children[0], S.FfiReaderExec)
    if arm in ("shuffle_writer", "rss_shuffle_writer"):
        assert op.partitioning.kind == "hash"
        assert op.partitioning.num_partitions == 9
        assert len(op.partitioning.key_exprs) == 1
