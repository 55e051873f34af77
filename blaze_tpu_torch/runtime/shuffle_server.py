"""Shuffle service: serves committed `.data`/`.index` segments (and
broadcast frame lists) to executor processes over a Unix socket.

Port of blaze_tpu/runtime/shuffle_server.py, whole. Ref: Spark's shuffle
service: reduce tasks fetch map outputs from the node that committed
them, not from the writer task (which may be dead). The driver owns the
crash-atomic artifacts (artifacts.py commit protocol), so it serves them:
an executor's ipc_reader resolves a "<qid>/shuffle:<sid>" resource to a
client that fetches partition segments from THIS server. Segments are
read from the committed files, so a map executor can die after commit
and its output stays fetchable: the lineage property executor-death
recovery relies on (re-execute only the LOST partitions).

Wire format (shared with the executor control socket,
runtime/executor_pool.py), byte for byte the JAX package's:
`u32 magic | u32 raw_len | u32 comp_len | u32 blob_len | [u32 crc32 when
magic is BCS2] | zlib(json header) | blob`; the CRC covers compressed
header + blob, and BCS1 frames (no checksum) still parse. The blob is
opaque bytes: for segment replies a concatenation of serde "BTB1" frames,
handed to IpcReaderExec undecoded. The control socket also carries
`{"type": "telemetry", "seq": N, ...}` batches (executor_pool's
federation path) over the same framing.

On the same host the client maps the committed `.data` files read-only
and hands out `memoryview` slices of them (`fetch_frames`); serde decodes
a frame from a memoryview without copying it to bytes.

Kept import-light on purpose: executor worker processes import this
before deciding whether a task needs the engine at all, so nothing here
may pull torch or numpy at import time.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

MAGIC = b"BCS1"
_HEAD = struct.Struct("<4sIII")
# BCS2 appends a CRC32 of the frame body (compressed header + blob) so
# torn/corrupted frames raise a typed WireError instead of decoding
# garbage. The first 16 bytes stay layout-compatible with BCS1: recv
# branches on the magic, so old BCS1 frames still parse (version-
# tolerant rolling upgrades between driver and executors).
MAGIC2 = b"BCS2"
_CRC_TAIL = struct.Struct("<I")
# largest accepted frame: a poisoned/corrupt length prefix must not make
# recv_msg attempt a multi-GiB allocation
MAX_FRAME = 1 << 31

# Network fault seam (faults.py net.* points). faults.install() points
# this at faults.net_rule when a spec arms any net.* point, and back to
# None on reset — a plain module global so this module stays import-
# light (no config/faults import at module load; worker processes never
# arm it because fault_injection_spec is stripped from their conf).
NET_HOOK = None


def net_rule(point: str):
    """Fire the driver-side net fault schedule for `point`; returns the
    armed rule dict (kind/ms/...) when this call should inject a wire
    fault, else None. Call sites pass the rule to send_msg/recv_msg via
    net_fault= so injection happens at the exact socket operation."""
    hook = NET_HOOK
    return hook(point) if hook is not None else None


class WireError(ConnectionError):
    """Framing violation (bad magic / oversized length / CRC mismatch):
    the peer is not speaking the protocol — callers treat it like a
    lost connection."""


def _apply_send_fault(sock: socket.socket, buf: bytes, rule: dict) -> bool:
    """Apply a fired net.* rule to an outgoing frame. Returns True when
    the frame was (ab)used by the fault and must not be sent again;
    raises for connection-fatal kinds."""
    kind = rule.get("kind")
    if kind == "delay":
        time.sleep(float(rule.get("ms", 25)) / 1000.0)
        return False
    if kind == "dup":
        sock.sendall(buf + buf)  # duplicate delivery: same frame twice
        return True
    if kind == "reset":
        raise ConnectionResetError("injected: connection reset by peer")
    if kind == "blackhole":
        # the peer sees nothing; the sender stalls then loses the conn
        time.sleep(float(rule.get("ms", 2000)) / 1000.0)
        raise ConnectionError("injected: blackhole (frame never sent)")
    if kind == "torn":
        sock.sendall(buf[: max(1, len(buf) // 2)])
        raise ConnectionResetError("injected: torn frame (partial write)")
    return False


def send_msg(sock: socket.socket, header: dict, blob: bytes = b"",
             lock: Optional[threading.Lock] = None,
             net_fault: Optional[dict] = None) -> None:
    """Serialize + frame one message; `lock` serializes concurrent
    senders sharing the socket (a torn frame is unrecoverable).
    `net_fault` is a pre-fired net.* rule (from net_rule) applied at
    the sendall boundary — wire-level chaos without monkeypatching."""
    raw = json.dumps(header, separators=(",", ":")).encode()
    comp = zlib.compress(raw, 1)
    crc = zlib.crc32(blob, zlib.crc32(comp)) & 0xFFFFFFFF
    buf = (_HEAD.pack(MAGIC2, len(raw), len(comp), len(blob))
           + _CRC_TAIL.pack(crc) + comp + blob)
    if lock is not None:
        with lock:
            if net_fault and _apply_send_fault(sock, buf, net_fault):
                return
            sock.sendall(buf)
    else:
        if net_fault and _apply_send_fault(sock, buf, net_fault):
            return
        sock.sendall(buf)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if chunks else "peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket,
             net_fault: Optional[dict] = None) -> Tuple[dict, bytes]:
    """Read one framed message; raises ConnectionError on EOF/short read
    and WireError on a malformed frame. Accepts both BCS1 (legacy, no
    checksum) and BCS2 (CRC32 over compressed header + blob) frames."""
    if net_fault:
        kind = net_fault.get("kind")
        if kind == "delay":
            time.sleep(float(net_fault.get("ms", 25)) / 1000.0)
        elif kind == "reset":
            raise ConnectionResetError("injected: connection reset on recv")
        elif kind == "blackhole":
            time.sleep(float(net_fault.get("ms", 2000)) / 1000.0)
            raise ConnectionError("injected: blackhole on recv")
        elif kind == "torn":
            raise WireError("injected: torn frame on recv")
        # "dup" is applied by callers that own the message loop (the
        # frame itself arrives once; duplication is a delivery property)
    head = _recv_exact(sock, _HEAD.size)
    magic, raw_len, comp_len, blob_len = _HEAD.unpack(head)
    if magic not in (MAGIC, MAGIC2):
        raise WireError(f"bad frame magic {magic!r}")
    if max(raw_len, comp_len, blob_len) > MAX_FRAME:
        raise WireError("frame length exceeds MAX_FRAME")
    want_crc = None
    if magic == MAGIC2:
        want_crc = _CRC_TAIL.unpack(_recv_exact(sock, _CRC_TAIL.size))[0]
    comp = _recv_exact(sock, comp_len)
    blob = _recv_exact(sock, blob_len) if blob_len else b""
    if want_crc is not None:
        got = zlib.crc32(blob, zlib.crc32(comp)) & 0xFFFFFFFF
        if got != want_crc:
            raise WireError(
                f"frame CRC mismatch (want {want_crc:#010x}, "
                f"got {got:#010x})")
    raw = zlib.decompress(comp)
    if len(raw) != raw_len:
        raise WireError("frame raw_len mismatch")
    return json.loads(raw.decode()), blob


def _read_segment(data_path: str, index_path: str, partition: int) -> bytes:
    """One map output's VERIFIED bytes for `partition`, located through
    the committed little-endian u64 offsets index (the FileSegment fetch
    of shuffle_manager.get_reader, without the decode). Delegates to
    artifacts.fetch_segment — checksum verification, quarantine and
    lineage repair happen server-side, where the repair closures live.
    The import is lazy to keep this module import-light (worker
    processes import it before deciding whether they need the engine;
    _read_segment only ever runs driver-side)."""
    from blaze_tpu_torch.runtime import artifacts

    return artifacts.fetch_segment(data_path, index_path, partition)


class ShuffleServer:
    """Driver-side artifact server. `register_shuffle` publishes a
    completed stage's map outputs under its resource id;
    `register_frames` publishes a broadcast stage's frame list. Executors
    fetch with {"type": "fetch", "rid": ..., "partition": p} and get the
    concatenated serde frames back as the reply blob."""

    def __init__(self, sock_path: str) -> None:
        self.sock_path = sock_path
        self._lock = threading.Lock()
        # rid -> list of (data_path, index_path) map outputs
        self._shuffles: Dict[str, List[Tuple[str, str]]] = {}
        # rid -> broadcast frame list (already serde frames)
        self._frames: Dict[str, List[bytes]] = {}
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self.fetches = 0
        # unclean client disconnects (mid-frame EOF, framing violation,
        # reply send failure) — partition chaos made observable server-
        # side; clean EOF between requests is a normal client close
        self.conns_dropped = 0

    # -- registry ------------------------------------------------------

    def register_shuffle(self, rid: str,
                         outputs: Sequence[Tuple[str, str]]) -> None:
        with self._lock:
            self._shuffles[rid] = list(outputs)

    def register_frames(self, rid: str, frames: Sequence[bytes]) -> None:
        with self._lock:
            self._frames[rid] = list(frames)

    def unregister(self, rid: str) -> None:
        with self._lock:
            self._shuffles.pop(rid, None)
            self._frames.pop(rid, None)

    def unregister_prefix(self, prefix: str) -> None:
        """Drop every rid of a finished query's namespace."""
        with self._lock:
            for reg in (self._shuffles, self._frames):
                for rid in [r for r in reg if r.startswith(prefix)]:
                    reg.pop(rid, None)

    def registered(self) -> List[str]:
        with self._lock:
            return sorted(self._shuffles) + sorted(self._frames)

    # -- serving -------------------------------------------------------

    def start(self) -> None:
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(self.sock_path)
        listener.listen(64)
        self._listener = listener
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="blz-shufsrv", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="blz-shufsrv-conn", daemon=True).start()

    def _conn_dropped(self, why: str) -> None:
        """Count + trace one unclean client disconnect. Lazy trace
        import (this only runs driver-side; the module must stay
        import-light for worker processes)."""
        with self._lock:
            self.conns_dropped += 1
        from blaze_tpu_torch.runtime import trace

        trace.event("shuffle_conn_dropped", why=why)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                try:
                    msg, _blob = recv_msg(conn)
                except WireError as e:
                    self._conn_dropped(f"wire_error: {e}")
                    return
                except ConnectionError as e:
                    # clean EOF between requests is a normal client
                    # close; a mid-frame EOF is a dropped connection
                    if "mid-frame" in str(e):
                        self._conn_dropped("eof_mid_frame")
                    return
                if msg.get("type") == "locate":
                    # publish the committed artifact paths for a shuffle
                    # rid so a same-host client can mmap the .data files
                    # instead of streaming segments over the socket.
                    # Redirects are resolved HERE: quarantine/repair
                    # state lives in this (driver) process, so clients
                    # re-locating after a checksum fallback see the
                    # repaired pair, not the quarantined one.
                    rid = msg.get("rid", "")
                    echo = {k: msg[k] for k in ("req",) if k in msg}
                    with self._lock:
                        outputs = self._shuffles.get(rid)
                    if outputs is None:
                        # broadcast frame lists have no file backing;
                        # unknown rids are equally non-mappable
                        send_msg(conn, {"ok": False, "rid": rid,
                                        "error": f"not file-backed: {rid}",
                                        **echo})
                        continue
                    from blaze_tpu_torch.runtime import artifacts

                    resolved = [list(artifacts.resolve_artifact(d, i))
                                for d, i in outputs]
                    send_msg(conn, {"ok": True, "rid": rid,
                                    "outputs": resolved, **echo})
                    continue
                if msg.get("type") != "fetch":
                    send_msg(conn, {"ok": False,
                                    "error": "unknown request type"})
                    continue
                rid = msg.get("rid", "")
                partition = int(msg.get("partition", 0))
                # echo the client's request id so it can discard stale
                # or duplicated replies (absent on old clients — the
                # reply then carries no "req" and is accepted as-is)
                echo = {k: msg[k] for k in ("req",) if k in msg}
                try:
                    blob = self._fetch(rid, partition)
                except Exception as e:  # noqa: BLE001 — relayed to peer
                    send_msg(conn, {"ok": False, "rid": rid,
                                    "error": f"{type(e).__name__}: {e}",
                                    **echo})
                    continue
                try:
                    send_msg(conn, {"ok": True, "rid": rid, **echo}, blob,
                             net_fault=net_rule("net.shuffle.fetch"))
                except (ConnectionError, OSError) as e:
                    self._conn_dropped(f"send_failed: {e}")
                    return
        finally:
            conn.close()

    def _fetch(self, rid: str, partition: int) -> bytes:
        with self._lock:
            outputs = self._shuffles.get(rid)
            frames = self._frames.get(rid)
            self.fetches += 1
        if outputs is not None:
            return b"".join(_read_segment(d, i, partition)
                            for d, i in outputs)
        if frames is not None:
            return b"".join(frames)
        raise KeyError(f"resource not served: {rid}")

    def close(self) -> None:
        self._closed.set()
        if self._listener is not None:
            try:
                # wakes the accept loop now (a bare close leaves it
                # blocked until the join below times out)
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            finally:
                self._listener = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=1.0)
            self._accept_thread = None
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass


class ShuffleClient:
    """Executor-side fetch client: one connection, request/response under
    a lock (concurrent task slots in one worker share it)."""

    def __init__(self, sock_path: str) -> None:
        self.sock_path = sock_path
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        # monotone request id: replies echo it back so a duplicated or
        # stale reply (net.* dup chaos, a retry racing its first answer)
        # is discarded instead of being matched to the wrong request
        self._req = 0
        # rid -> same-host mmap fast-path state: a list of per-output
        # dicts (buf/offsets/frames/seen, see _map_one), or None caching
        # a negative answer (broadcast rid, legacy index without frame
        # checksums, paths not visible from this process)
        self._maps: Dict[str, Optional[List[dict]]] = {}

    @staticmethod
    def _timeout_ms() -> float:
        # lazy conf import: the module stays free of package imports at
        # import time
        from blaze_tpu_torch.config import conf

        return float(conf.shuffle_connect_timeout_ms)

    def _ensure_locked(self) -> socket.socket:
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            timeout_ms = self._timeout_ms()
            if timeout_ms > 0:
                # bounds connect AND every recv: a hung shuffle server
                # surfaces as socket.timeout (an OSError the retry
                # ladder absorbs) instead of blocking the task forever
                s.settimeout(timeout_ms / 1000.0)
            s.connect(self.sock_path)
            self._sock = s
        return self._sock

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _fetch_once_locked(self, rid: str,
                           partition: int) -> Tuple[dict, bytes]:
        sock = self._ensure_locked()
        self._req += 1
        req = self._req
        send_msg(sock, {"type": "fetch", "rid": rid,
                        "partition": partition, "req": req})
        while True:
            msg, blob = recv_msg(sock)
            got = msg.get("req")
            # accept replies without a req echo (old servers); discard
            # duplicated/stale replies for earlier request ids
            if got is None or got == req:
                return msg, blob
            if got > req:
                raise WireError(f"reply for future request {got} > {req}")

    def fetch(self, rid: str, partition: int) -> bytes:
        """Fetch one partition segment, retrying lost/hung connections
        on a bounded exponential-backoff ladder: the whole ladder (and
        each socket read) fits inside conf.shuffle_connect_timeout_ms,
        so a hung or restarting shuffle server costs a bounded wait,
        never a wedged task. 0 restores the legacy posture — blocking
        socket, one reconnect."""
        timeout_ms = self._timeout_ms()
        with self._lock:
            if timeout_ms <= 0:
                try:
                    msg, blob = self._fetch_once_locked(rid, partition)
                except (ConnectionError, OSError):
                    # one reconnect: the driver may have restarted the
                    # listener; a second failure is the caller's problem
                    self._close_locked()
                    msg, blob = self._fetch_once_locked(rid, partition)
            else:
                deadline = time.monotonic() + timeout_ms / 1000.0
                delay = 0.01
                attempt = 0
                while True:
                    try:
                        msg, blob = self._fetch_once_locked(rid, partition)
                        break
                    except (ConnectionError, OSError) as e:
                        self._close_locked()
                        attempt += 1
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise ConnectionError(
                                f"shuffle fetch {rid}[{partition}] "
                                f"failed after {attempt} attempts "
                                f"within {int(timeout_ms)}ms: {e}"
                            ) from e
                        time.sleep(min(delay, remaining))
                        delay = min(delay * 2.0, 0.5)
        if not msg.get("ok"):
            raise KeyError(msg.get("error", f"fetch failed: {rid}"))
        return blob

    # -- same-host mmap fast path -------------------------------------

    def _locate_locked(self, rid: str) -> Optional[List[Tuple[str, str]]]:
        """Ask the server for rid's committed (data, index) paths.
        None when the rid is not file-backed (broadcast frame list) or
        the server predates the locate message (it replies ok=False
        "unknown request type" without a req echo — accepted here the
        same way fetch accepts echo-less replies from old servers)."""
        sock = self._ensure_locked()
        self._req += 1
        req = self._req
        send_msg(sock, {"type": "locate", "rid": rid, "req": req})
        while True:
            msg, _blob = recv_msg(sock)
            got = msg.get("req")
            if got is None or got == req:
                break
            if got > req:
                raise WireError(f"reply for future request {got} > {req}")
        if not msg.get("ok"):
            return None
        return [(str(d), str(i)) for d, i in msg.get("outputs") or []]

    @staticmethod
    def _map_one(data_path: str, index_path: str) -> Optional[dict]:
        """mmap one committed output read-only. None when the pair is
        not visible from this process or the index carries no per-frame
        checksums (legacy commit): lazy verification is then impossible
        and the socket path — which verifies whole segments server-side
        — stays authoritative."""
        import mmap as _mmap

        from blaze_tpu_torch.runtime import artifacts

        if not (os.path.exists(data_path) and os.path.exists(index_path)):
            return None
        offsets_bytes, meta = artifacts.read_index(index_path)
        if not meta or not meta.get("frames"):
            return None
        n = len(offsets_bytes) // 8
        offsets = struct.unpack("<%dQ" % n, offsets_bytes[: 8 * n])
        with open(data_path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            buf = (_mmap.mmap(f.fileno(), 0, prot=_mmap.PROT_READ)
                   if size else b"")
        return {"buf": buf, "offsets": offsets,
                "frames": dict(meta["frames"]), "seen": set()}

    @staticmethod
    def _slice_frames(state: dict,
                      partition: int) -> Optional[List[memoryview]]:
        """Zero-copy frame views for one partition of a mapped output,
        verifying each frame's committed CRC32 on FIRST touch only
        (`seen` remembers verified frame offsets). None on any
        discrepancy — truncated mapping, unindexed frame boundary,
        checksum mismatch — so the caller falls back to the socket path
        where fetch_segment quarantines + lineage-repairs the pair."""
        offsets = state["offsets"]
        if partition + 1 >= len(offsets):
            return None
        lo, hi = offsets[partition], offsets[partition + 1]
        buf = state["buf"]
        if hi > len(buf) or lo > hi:
            return None
        view = memoryview(buf)
        frames: List[memoryview] = []
        off = lo
        while off < hi:
            if off + 12 > hi:
                return None
            (comp_len,) = struct.unpack_from("<I", buf, off + 8)
            end = off + 12 + comp_len
            if end > hi:
                return None
            if off not in state["seen"]:
                want = state["frames"].get(off)
                if want is None:
                    return None
                if zlib.crc32(view[off:end]) & 0xFFFFFFFF != want:
                    return None
                state["seen"].add(off)
            frames.append(view[off:end])
            off = end
        return frames

    def _mmap_fetch(self, rid: str, partition: int):
        """Returns (frames, nbytes, status) with status one of "hit"
        (zero-copy views returned), "miss" (rid is not mmap-eligible —
        broadcast, legacy index, remote paths; cached so later fetches
        skip the locate round-trip), "fallback" (mapping was live but
        verification failed: the cache is dropped so the next fetch
        re-locates, picking up any repaired redirect)."""
        with self._lock:
            if rid not in self._maps:
                outputs = self._locate_locked(rid)
                if outputs is None:
                    self._maps[rid] = None
                    return None, 0, "miss"
                states: Optional[List[dict]] = []
                for d, i in outputs:
                    st = self._map_one(d, i)
                    if st is None:
                        states = None
                        break
                    states.append(st)
                self._maps[rid] = states
                if states is None:
                    return None, 0, "fallback"
            states = self._maps[rid]
            if states is None:
                return None, 0, "miss"
            frames: List[memoryview] = []
            nbytes = 0
            for st in states:
                part = self._slice_frames(st, partition)
                if part is None:
                    self._maps.pop(rid, None)
                    return None, 0, "fallback"
                frames.extend(part)
                nbytes += sum(len(f) for f in part)
            return frames, nbytes, "hit"

    def fetch_frames(self, rid: str, partition: int) -> List:
        """One partition's serde frames (memoryview on the mmap path,
        bytes on the socket path), preferring the same-host
        zero-copy path: when the server's committed .data/.index pair is
        visible from this process, the data file is mmap'd read-only and
        partition segments come back as memoryview slices — no socket
        streaming, no blob copy — with per-frame CRC32s verified lazily
        on first touch. Any discrepancy falls back to the socket fetch,
        whose server-side fetch_segment runs the existing quarantine +
        lineage-repair protocol; a later fetch_frames re-locates and
        maps the repaired pair. Bookkeeping is single-entry per logical
        transfer: a mmap hit books moved bytes only (nothing was
        copied), the socket path books copied bytes reader-side."""
        from blaze_tpu_torch.config import conf

        status = "miss"
        if conf.shuffle_mmap_enabled:
            try:
                frames, nbytes, status = self._mmap_fetch(rid, partition)
            except (ConnectionError, OSError, ValueError, struct.error):
                # locate/map plumbing failure: the socket retry ladder
                # below owns reconnection; treat as a fallback
                frames, status = None, "fallback"
                self._drop_maps(rid)
            if frames is not None:
                from blaze_tpu_torch.runtime import monitor

                if conf.monitor_enabled:
                    monitor.count_move("shuffle", nbytes)
                    monitor.count_zerocopy("shuffle_mmap_hits")
                if conf.trace_enabled:
                    from blaze_tpu_torch.runtime import trace

                    trace.event("shuffle_mmap_fetch", rid=rid,
                                partition=partition, nbytes=nbytes,
                                frames=len(frames))
                return frames
        blob = self.fetch(rid, partition)
        from blaze_tpu_torch.runtime import monitor

        if conf.monitor_enabled:
            monitor.count_copy("shuffle", len(blob))
            if status == "fallback":
                monitor.count_zerocopy("shuffle_mmap_fallbacks")
        return split_frames(blob)

    def _drop_maps(self, rid: Optional[str] = None) -> None:
        with self._lock:
            if rid is None:
                self._maps.clear()
            else:
                self._maps.pop(rid, None)

    def close(self) -> None:
        with self._lock:
            self._close_locked()
            self._maps.clear()


def split_frames(blob: bytes) -> List[bytes]:
    """Split a fetched segment into its serde "BTB1" frames (layout:
    columnar/serde.py — u32 magic | u32 raw_len | u32 comp_len | body).
    IpcReaderExec decodes raw frame bytes itself, so executors never need
    the serde module just to route segments."""
    frames: List[bytes] = []
    off = 0
    total = len(blob)
    while off < total:
        if off + 12 > total:
            raise WireError("truncated shuffle frame header")
        _raw_len, comp_len = struct.unpack_from("<II", blob, off + 4)
        end = off + 12 + comp_len
        if end > total:
            raise WireError("truncated shuffle frame body")
        frames.append(blob[off:end])
        off = end
    return frames
