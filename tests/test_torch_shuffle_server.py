"""The port's shuffle server and wire (runtime/shuffle_server.py) against
the JAX package's, on the CPU.

- The wire: `send_msg` frames are byte-equal to the JAX package's for the
  same header and blob, and each package parses the other's BCS2 frames
  and hand-made BCS1 frames; malformed frames (flipped blob byte,
  oversized length, raw_len mismatch, EOF mid-frame) raise alike.
- Both directions across the packages: a port `ShuffleClient` fetches
  from the JAX package's `ShuffleServer` and the JAX package's client
  from the port's server, with the same frames and the same
  `shuffle_mmap_hits` / `shuffle_mmap_fallbacks` counts as the JAX
  package's client against its own server: the mmap hit (memoryview
  slices), the broadcast miss and the corrupt-segment fallback (the
  socket path serves the repaired lineage, the next fetch maps it).
- The fault schedule with net.* points armed: `net_rule` and `inject`
  interleaved over a seeded spec fire on the same calls in both packages,
  and the hook arms and disarms with the spec.

Every comparison is exact (bytes, counts, fire lists); there is no float
tolerance here.
"""

import socket
import struct
import threading
import time
import zlib

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import artifacts as jartifacts
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime import monitor as jmonitor
from blaze_tpu.runtime import shuffle_server as jss
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import artifacts, faults, monitor
from blaze_tpu_torch.runtime import shuffle_server as ss

PKG = {"port": (ss, artifacts, monitor, conf),
       "jax": (jss, jartifacts, jmonitor, jconf)}


@pytest.fixture(autouse=True)
def _knobs():
    saved = [(c, c.artifact_checksums, c.monitor_enabled,
              c.shuffle_mmap_enabled) for c in (conf, jconf)]
    for c in (conf, jconf):
        c.artifact_checksums = True
        c.monitor_enabled = True
        c.shuffle_mmap_enabled = True
    yield
    for c, a, m, s in saved:
        c.artifact_checksums, c.monitor_enabled = a, m
        c.shuffle_mmap_enabled = s
    for f in (faults, jfaults):
        f.install(None)


# ---- the wire ----


class _Capture:
    """A socket stand-in that records what send_msg writes."""

    def __init__(self):
        self.buf = bytearray()

    def sendall(self, b):
        self.buf += b


@pytest.mark.parametrize("header,blob", [
    ({"type": "task", "k": [1, 2, 3], "s": "é"}, b""),
    ({"type": "result", "ok": True, "epoch": 7}, bytes(range(256)) * 50),
    ({}, b"x"),
])
def test_send_msg_bytes_equal_jax(header, blob):
    got, want = _Capture(), _Capture()
    ss.send_msg(got, header, blob)
    jss.send_msg(want, header, blob)
    assert bytes(got.buf) == bytes(want.buf)
    assert bytes(got.buf[:4]) == b"BCS2"


def _frame(mod, header_raw: bytes, blob: bytes = b"", magic=None,
           crc=None) -> bytes:
    magic = magic or mod.MAGIC2
    comp = zlib.compress(header_raw, 1)
    buf = mod._HEAD.pack(magic, len(header_raw), len(comp), len(blob))
    if magic == mod.MAGIC2:
        if crc is None:
            crc = zlib.crc32(blob, zlib.crc32(comp)) & 0xFFFFFFFF
        buf += mod._CRC_TAIL.pack(crc)
    return buf + comp + blob


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_frames_parse_across_packages(writer, reader):
    wmod, rmod = PKG[writer][0], PKG[reader][0]
    a, b = socket.socketpair()
    try:
        wmod.send_msg(a, {"type": "fetch", "rid": "q/shuffle:0",
                          "partition": 3, "req": 9}, b"blob" * 1000)
        msg, blob = rmod.recv_msg(b)
        assert msg == {"type": "fetch", "rid": "q/shuffle:0",
                       "partition": 3, "req": 9}
        assert blob == b"blob" * 1000
        # a legacy BCS1 frame (no CRC tail) still parses
        a.sendall(_frame(wmod, b'{"type":"old"}', b"b1", magic=wmod.MAGIC))
        assert rmod.recv_msg(b) == ({"type": "old"}, b"b1")
    finally:
        a.close()
        b.close()


def _flipped(mod):
    bad = bytearray(_frame(mod, b'{"type":"x"}', b"payload-bytes"))
    bad[-3] ^= 0xFF
    return bytes(bad), "CRC mismatch"


def _oversized(mod):
    return (mod._HEAD.pack(mod.MAGIC2, 10, 10, mod.MAX_FRAME + 1)
            + mod._CRC_TAIL.pack(0)), "MAX_FRAME"


def _raw_len(mod):
    comp = zlib.compress(b'{"type":"x"}', 1)
    crc = zlib.crc32(b"", zlib.crc32(comp)) & 0xFFFFFFFF
    return (mod._HEAD.pack(mod.MAGIC2, 999, len(comp), 0)
            + mod._CRC_TAIL.pack(crc) + comp), "raw_len"


def _bad_magic(mod):
    return b"XXXX" + b"\x00" * 12, "magic"


@pytest.mark.parametrize("make", [_flipped, _oversized, _raw_len,
                                  _bad_magic])
def test_malformed_frames_rejected_alike(make):
    for mod in (ss, jss):
        raw, match = make(mod)
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            with pytest.raises(mod.WireError, match=match):
                mod.recv_msg(b)
        finally:
            a.close()
            b.close()


def test_eof_mid_frame_is_a_connection_error():
    for mod in (ss, jss):
        a, b = socket.socketpair()
        try:
            full = _frame(mod, b'{"type":"x"}', b"0123456789" * 100)
            a.sendall(full[: len(full) // 2])
            a.close()
            with pytest.raises(ConnectionError, match="mid-frame"):
                mod.recv_msg(b)
        finally:
            b.close()
    assert not issubclass(ss.WireError, jss.WireError)
    assert issubclass(ss.WireError, ConnectionError)


def test_split_frames_matches_jax():
    blob = b"".join(b"BTB1" + struct.pack("<II", n, n) + bytes([n]) * n
                    for n in (5, 0, 40))
    assert ss.split_frames(blob) == jss.split_frames(blob)
    assert len(ss.split_frames(blob)) == 3
    for mod in (ss, jss):
        with pytest.raises(mod.WireError, match="truncated"):
            mod.split_frames(blob[:-1])


# ---- server and client across the packages ----


def _sframe(payload: bytes) -> bytes:
    return b"BTB1" + struct.pack("<II", len(payload), len(payload)) + payload


def _commit_pair(arts, tmp_path, payloads, name="shuffle_0_0"):
    data = str(tmp_path / f"{name}.data")
    index = str(tmp_path / f"{name}.index")
    frames = [_sframe(p) for p in payloads]
    offsets = [0]
    for fr in frames:
        offsets.append(offsets[-1] + len(fr))

    def write(tmp_data, tmp_index):
        with open(tmp_data, "wb") as f:
            f.write(b"".join(frames))
        with open(tmp_index, "wb") as f:
            f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        return tuple(len(fr) for fr in frames)

    arts.commit_shuffle_pair(write, data, index)
    return data, index, frames


def _counts(mon):
    z = mon.zerocopy_stats()
    copied, moved = mon.copy_totals()
    return (z["shuffle_mmap_hits"], z["shuffle_mmap_fallbacks"],
            copied["shuffle"], moved["shuffle"])


def _delta(after, before):
    return tuple(a - b for a, b in zip(after, before))


def _hit(server_pkg, client_pkg, tmp_path):
    smod, sarts = PKG[server_pkg][:2]
    cmod, _, cmon, _ = PKG[client_pkg]
    data, index, frames = _commit_pair(
        sarts, tmp_path, [b"alpha" * 40, b"beta" * 30, b"gamma" * 20])
    server = smod.ShuffleServer(str(tmp_path / "s.sock"))
    server.register_shuffle("q/shuffle:0", [(data, index)])
    server.start()
    client = cmod.ShuffleClient(server.sock_path)
    try:
        c0 = _counts(cmon)
        got = [client.fetch_frames("q/shuffle:0", p) for p in range(3)]
        kinds = [all(isinstance(g, memoryview) for g in part)
                 for part in got]
        assert [b"".join(bytes(g) for g in part) for part in got] == frames
        return kinds, _delta(_counts(cmon), c0)
    finally:
        client.close()
        server.close()


def _broadcast(server_pkg, client_pkg, tmp_path):
    smod = PKG[server_pkg][0]
    cmod, _, cmon, _ = PKG[client_pkg]
    server = smod.ShuffleServer(str(tmp_path / "b.sock"))
    frames = [_sframe(b"bc" * 10), _sframe(b"dd" * 3)]
    server.register_frames("q/broadcast:1", frames)
    server.start()
    client = cmod.ShuffleClient(server.sock_path)
    try:
        c0 = _counts(cmon)
        got = client.fetch_frames("q/broadcast:1", 0)
        assert [bytes(g) for g in got] == frames
        again = client.fetch_frames("q/broadcast:1", 0)  # cached miss
        assert [bytes(g) for g in again] == frames
        with pytest.raises(KeyError):
            client.fetch("q/broadcast:9", 0)
        return [type(g).__name__ for g in got], _delta(_counts(cmon), c0)
    finally:
        client.close()
        server.close()


def _corrupt(server_pkg, client_pkg, tmp_path):
    smod, sarts = PKG[server_pkg][:2]
    cmod, _, cmon, _ = PKG[client_pkg]
    payloads = [b"p0" * 30, b"p1" * 30, b"p2" * 30]
    data, index, frames = _commit_pair(sarts, tmp_path, payloads)

    def repair():
        return _commit_pair(sarts, tmp_path, payloads, name="repaired")[:2]

    sarts.register_repair(data, repair)
    server = smod.ShuffleServer(str(tmp_path / "c.sock"))
    server.register_shuffle("q/shuffle:0", [(data, index)])
    server.start()
    client = cmod.ShuffleClient(server.sock_path)
    try:
        offsets, _meta = sarts.read_index(index)
        off1 = struct.unpack("<Q", offsets[8:16])[0]
        with open(data, "r+b") as f:
            f.seek(off1 + 13)
            b = f.read(1)
            f.seek(off1 + 13)
            f.write(bytes([b[0] ^ 0x40]))
        before = sarts.corruption_stats()
        c0 = _counts(cmon)
        got = client.fetch_frames("q/shuffle:0", 1)
        assert b"".join(bytes(g) for g in got) == frames[1]
        got2 = client.fetch_frames("q/shuffle:0", 2)
        assert b"".join(bytes(g) for g in got2) == frames[2]
        after = sarts.corruption_stats()
        assert after["repaired"] - before["repaired"] == 1
        return ([type(g).__name__ for g in got],
                [type(g).__name__ for g in got2]), _delta(_counts(cmon), c0)
    finally:
        client.close()
        server.close()
        sarts.forget_repair(data)


_WANT = {}   # case -> the JAX client's result against the JAX server


@pytest.mark.parametrize("case", [_hit, _broadcast, _corrupt])
@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_fetch_across_packages_matches_jax(case, server_pkg, client_pkg,
                                           tmp_path):
    if case not in _WANT:
        (tmp_path / "ref").mkdir()
        _WANT[case] = case("jax", "jax", tmp_path / "ref")
    (tmp_path / "got").mkdir()
    assert case(server_pkg, client_pkg, tmp_path / "got") == _WANT[case]


def test_server_counts_dropped_conns_like_jax(tmp_path):
    for name, mod in (("p", ss), ("j", jss)):
        server = mod.ShuffleServer(str(tmp_path / f"{name}.sock"))
        server.start()
        try:
            server.register_frames("b:1", [b"x"])
            client = mod.ShuffleClient(server.sock_path)
            assert client.fetch("b:1", 0) == b"x"
            client.close()
            time.sleep(0.1)
            assert server.conns_dropped == 0
            raw = socket.socket(socket.AF_UNIX)
            raw.connect(server.sock_path)
            raw.sendall(mod._HEAD.pack(mod.MAGIC2, 100, 100, 0)
                        + mod._CRC_TAIL.pack(0) + b"\x00" * 40)
            raw.close()
            deadline = time.monotonic() + 5
            while server.conns_dropped == 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert server.conns_dropped == 1
            assert server.registered() == ["b:1"]
            server.unregister_prefix("b:")
            assert server.registered() == []
        finally:
            server.close()


def test_server_locate_and_fetch_errors_like_jax(tmp_path):
    """The locate reply names the committed pair; an unknown rid relays
    the same KeyError text from either server."""
    out = []
    for name, (mod, arts, _mon, _c) in PKG.items():
        d = tmp_path / name
        d.mkdir()
        data, index, _ = _commit_pair(arts, d, [b"a" * 8])
        server = mod.ShuffleServer(str(d / "l.sock"))
        server.register_shuffle("q/shuffle:0", [(data, index)])
        server.start()
        client = ss.ShuffleClient(server.sock_path)
        try:
            with client._lock:
                outs = client._locate_locked("q/shuffle:0")
                missing = client._locate_locked("q/none")
            assert outs == [(data, index)] and missing is None
            with pytest.raises(KeyError) as e:
                client.fetch("q/none", 0)
            out.append(str(e.value))
        finally:
            client.close()
            server.close()
    assert out[0] == out[1]


# ---- the net.* fault schedule ----


SPEC = {"seed": 11, "points": {
    "net.control.send": {"kind": "reset", "prob": 0.3},
    "net.control.recv": {"kind": "dup", "nth": 4},
    "net.shuffle.fetch": {"kind": "delay", "ms": 0, "fail_times": 3},
    "net.telemetry": {"kind": "io", "fail_times": 5},
    "serde.encode": {"kind": "io", "prob": 0.2},
}}


def _schedule(fmod, smod):
    fmod.install(SPEC)
    assert smod.NET_HOOK is fmod.net_rule
    fired = []
    for i in range(300):
        for point in ("net.control.send", "net.control.recv",
                      "net.shuffle.fetch", "net.telemetry"):
            rule = smod.net_rule(point)
            fired.append((point, None if rule is None else rule["kind"]))
        try:
            fmod.inject("serde.encode")
            fired.append(("serde.encode", None))
        except Exception as e:  # noqa: BLE001 — the schedule's raise
            fired.append(("serde.encode", fmod.classify(e)))
    log = list(fmod.injection_log)
    fmod.install(None)
    assert smod.NET_HOOK is None
    return fired, log, fmod.TELEMETRY.snapshot().get("faults_injected")


def test_net_fault_schedule_equals_jax():
    for f in (faults, jfaults):
        f.reset_telemetry()
    got = _schedule(faults, ss)
    want = _schedule(jfaults, jss)
    assert got == want
    kinds = {k for _, k in got[0] if k}
    assert {"reset", "dup", "delay"} <= kinds
    # an "io" rule on a net.* point is no wire fault: net_rule never fires it
    assert ("net.telemetry", "io") not in got[0]


def test_recv_applies_injected_faults():
    a, b = socket.socketpair()
    try:
        for kind, exc in (("reset", ConnectionResetError),
                          ("torn", ss.WireError),
                          ("blackhole", ConnectionError)):
            with pytest.raises(exc):
                ss.recv_msg(b, net_fault={"kind": kind, "ms": 0})
        ss.send_msg(a, {"type": "x"}, net_fault={"kind": "dup"})
        assert ss.recv_msg(b) == ({"type": "x"}, b"")
        assert ss.recv_msg(b) == ({"type": "x"}, b"")
        lock = threading.Lock()
        with pytest.raises(ConnectionResetError):
            ss.send_msg(a, {"type": "y"}, lock=lock,
                        net_fault={"kind": "reset"})
    finally:
        a.close()
        b.close()


class _DrainingPool:
    """A pool's stats surface with seat 0 draining: the JAX package's
    stub of tests/test_network.py:455."""

    def __init__(self, live=2, slots=2, draining=1):
        self.live, self.slots, self.draining = live, slots, draining
        self.deaths_total = self.restarts_total = self.tasks_done = 0

    def capacity(self):
        return (self.live - self.draining) * self.slots

    def live_count(self):
        return self.live

    def on_membership(self, cb):
        pass

    def stats(self):
        return {"count": 2, "live": self.live, "capacity": self.capacity(),
                "slots": self.slots, "inflight": 0,
                "draining": self.draining, "deaths_total": 0,
                "restarts_total": 0, "reconnects_total": 2,
                "drains_total": 1, "drain_requeues_total": 0,
                "fenced_total": 0, "tasks_done": 0,
                "shuffle_conns_dropped": 3}

    def executors(self):
        return [{"exec_id": f"exec{i}", "pid": 1000 + i, "generation": 0,
                 "up": True, "inflight": 0, "draining": i == 0,
                 "conn_broken": False, "reconnects": 2 * i}
                for i in range(2)]


def test_healthz_and_prometheus_report_draining():
    """A draining seat degrades capacity, not health; the draining,
    reconnect, drain and dropped-connection series read the pool's
    numbers (the JAX package's case, tests/test_network.py:484, on both
    packages)."""
    from blaze_tpu.runtime import executor_pool as jep
    from blaze_tpu_torch.runtime import executor_pool as ep

    want = ('blaze_executor_draining{exec_id="exec0"} 1',
            'blaze_executor_draining{exec_id="exec1"} 0',
            'blaze_executor_reconnects_total{exec_id="exec1"} 2',
            "blaze_executor_drains_total 1",
            "blaze_shuffle_conn_dropped_total 3")
    rows = []
    for pool_mod, mon in ((ep, monitor), (jep, jmonitor)):
        stub = _DrainingPool()
        pool_mod.activate(stub)
        try:
            snap = mon.health_snapshot()
            text = mon.prometheus_text()
        finally:
            pool_mod.deactivate(stub)
        assert snap["executors_draining"] == 1 and snap["ok"]
        assert all(line in text for line in want)
        rows.append(sorted(line for line in text.splitlines()
                           if line.startswith(("blaze_executor_",
                                               "blaze_shuffle_conn"))))
    assert rows[0] == rows[1]
