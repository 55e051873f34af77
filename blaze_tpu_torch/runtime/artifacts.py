"""Crash-atomic artifact commit, checksummed shuffle indexes, quarantine
and lineage repair, epoch fencing, orphan sweep.

Port of blaze_tpu/runtime/artifacts.py. A killed task must never
leave a partial `.data`/`.index` visible to a reader (the reference gets
this from Spark's IndexShuffleBlockResolver, which writes tempfiles and
renames them into place):

  stage    write the payload to `<final>.inprogress.<pid>.<seq>`
  publish  fsync the temp, then os.replace() it onto the final name
           (data before index for shuffle pairs, so a visible index
           always names complete data)
  sweep    a task removes `.inprogress.` temps (and `blz<pid>-*.spill`
           spill files) whose writing process is dead; a kill mid-commit
           orphans the temp, never the final name.

Integrity: under `conf.artifact_checksums` (default on) the commit appends
a checksum footer to the `.index` (per-frame CRC32s and a whole-file
digest), and every read verifies the segment it is about to decode
(`fetch_segment`). A mismatch, or an index without its footer, is
corruption: this module never returns unverified bytes. The reader
quarantines the pair (`<path>.quarantine`) and re-runs only the producing
map task under a fresh epoch (`handle_corruption`, through the repair
closure the runner registered with `register_repair`), then reads the
repaired pair. A speculative twin and its primary arbitrate the publish
through a first-commit-wins gate (runtime/supervisor.CommitGate).

The `shuffle.commit` fault point sits between staging and publishing, and
`corrupt.shuffle_data` / `corrupt.shuffle_index` flip a byte of a pair
after it is published (runtime/faults.py).
"""

from __future__ import annotations

import itertools
import os
import re
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import faults, trace
from blaze_tpu_torch.runtime.faults import CorruptArtifactError

ORPHAN_TAG = ".inprogress."
QUARANTINE_TAG = ".quarantine"
# checksum footer appended to committed .index files:
#   BIXC | u32 n_frames | n x (u64 frame_offset, u32 frame_crc)
#        | u32 data_crc | u32 index_crc | u32 footer_len | BIXC
# index_crc covers the offsets region AND the footer through data_crc, so
# a flip anywhere but the trailing 12 bytes is caught by one crc; those
# last bytes are structural (length + magic) and fail the parse.
CHECKSUM_MAGIC = b"BIXC"
_SPILL_RE = re.compile(r"^blz(\d+)-.*\.spill$")
_EPOCH_RE = re.compile(r"\.e(\d+)(\.[A-Za-z0-9_]+)$")
_seq = itertools.count()

# Per-directory sweep mutex, pid-stamped so that a sweeper that died
# mid-sweep does not wedge the directory: a lock held by a dead pid is
# broken and retaken.
SWEEP_LOCK = ".blz_sweep.lock"


def stage_path(final_path: str) -> str:
    """Temp path for `final_path`, unique per (process, call), carrying the
    writer pid so the sweeper can tell live commits from orphans."""
    return f"{final_path}{ORPHAN_TAG}{os.getpid()}.{next(_seq)}"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def publish(tmp_path: str, final_path: str, fsync: bool = True) -> None:
    """fsync a staged temp (unless `fsync` is False: a best-effort
    export), then atomically rename it onto its final name."""
    if fsync:
        _fsync_path(tmp_path)
    os.replace(tmp_path, final_path)


def commit_file(write_fn: Callable[[str], None], final_path: str,
                fsync: bool = True) -> None:
    """stage -> write_fn(tmp) -> publish; the temp goes on any failure."""
    tmp = stage_path(final_path)
    try:
        write_fn(tmp)
        publish(tmp, final_path, fsync=fsync)
    except BaseException:
        _unlink_quiet(tmp)
        raise


def commit_shuffle_pair(write_fn, data_path: str, index_path: str,
                        gate=None):
    """Commit a map task's `.data`/`.index` pair crash-atomically.

    `write_fn(tmp_data, tmp_index) -> lengths` writes both files. The
    checksum footer is stamped onto the staged index, both temps are
    fsync'd, then data is published before the index: readers find
    segments through the index, so it must never name data that is not in
    place. The `shuffle.commit` fault point fires between staging and
    publishing. On any failure only `.inprogress.` temps existed, and they
    are removed.

    `gate` (supervisor CommitGate, via ExecContext.commit_gate): the
    first-commit-wins arbiter between an attempt and its speculative twin,
    claimed after staging, just before publishing. The loser finds it
    taken, removes its temps and raises SpeculationLostError, so exactly
    one pair is published; a claimant whose publish then fails releases
    the gate so the task's retry can commit."""
    tmp_data = stage_path(data_path)
    tmp_index = stage_path(index_path)
    claimed = False
    try:
        lengths = write_fn(tmp_data, tmp_index)
        if conf.artifact_checksums:
            _append_index_footer(tmp_data, tmp_index)
        _fsync_path(tmp_data)
        _fsync_path(tmp_index)
        faults.inject("shuffle.commit")
        if gate is not None:
            if not gate.claim():
                from blaze_tpu_torch.ops.base import SpeculationLostError

                raise SpeculationLostError(
                    f"lost first-commit-wins race for {data_path}")
            claimed = True
        os.replace(tmp_data, data_path)
        os.replace(tmp_index, index_path)
        trace.event("artifact_commit", what="shuffle_pair",
                    gated=gate is not None)
        faults.maybe_corrupt("corrupt.shuffle_data", data_path)
        faults.maybe_corrupt("corrupt.shuffle_index", index_path)
        return lengths
    except BaseException:
        if claimed:
            gate.abort()  # let the surviving lineage's retry commit
        _unlink_quiet(tmp_data)
        _unlink_quiet(tmp_index)
        raise


# ---------------------------------------------------------------------------
# integrity: commit-time checksums, read-path verification
# ---------------------------------------------------------------------------

def walk_frames(fp) -> Tuple[List[Tuple[int, int]], int]:
    """Walk a .data file's serde frames: ([(offset, frame_crc32)],
    whole_file_crc32); ValueError on a torn or non-frame layout."""
    frames: List[Tuple[int, int]] = []
    data_crc = 0
    off = 0
    while True:
        head = fp.read(12)
        if not head:
            return frames, data_crc
        try:
            _raw_len, comp_len = serde.frame_header(head)
        except ValueError:
            raise ValueError(f"bad frame header at offset {off}") from None
        body = fp.read(comp_len)
        if len(body) != comp_len:
            raise ValueError(f"truncated frame at offset {off}")
        frames.append((off, zlib.crc32(body, zlib.crc32(head))))
        data_crc = zlib.crc32(body, zlib.crc32(head, data_crc))
        off += 12 + comp_len


def _append_index_footer(tmp_data: str, tmp_index: str) -> None:
    """Stamp the checksum footer onto a STAGED index (before fsync and
    publish). Data that does not walk as serde frames raises ValueError
    (the commit then fails and removes its temps): readers refuse an
    index without a footer, so none is ever published."""
    with open(tmp_data, "rb") as f:
        frames, data_crc = walk_frames(f)
    with open(tmp_index, "rb") as f:
        offsets = f.read()
    body = bytearray(CHECKSUM_MAGIC)
    body += struct.pack("<I", len(frames))
    for off, crc in frames:
        body += struct.pack("<QI", off, crc)
    body += struct.pack("<I", data_crc)
    index_crc = zlib.crc32(bytes(body), zlib.crc32(offsets))
    body += struct.pack("<II", index_crc, len(body) + 12)
    body += CHECKSUM_MAGIC
    with open(tmp_index, "ab") as f:
        f.write(bytes(body))


def split_index(raw: bytes, path: str = "") -> Tuple[bytes, Optional[dict]]:
    """Strip and parse the checksum footer of raw .index bytes.

    Returns (offsets_bytes, meta): meta is {"frames": {abs_offset: crc},
    "data_crc": int, "n_frames": int}. With conf.artifact_checksums on, a
    missing or mangled footer or an index checksum mismatch raises
    CorruptArtifactError (both packages' writers always stamp one); off,
    the footer is stripped as far as it parses and meta may be None."""
    verify = bool(conf.artifact_checksums)
    where = path or "<index>"
    if len(raw) >= 24 and raw[-4:] == CHECKSUM_MAGIC:
        (footer_len,) = struct.unpack_from("<I", raw, len(raw) - 8)
        start = len(raw) - footer_len
        ok = (24 <= footer_len <= len(raw)
              and (footer_len - 24) % 12 == 0
              and raw[start:start + 4] == CHECKSUM_MAGIC)
        if ok:
            (n,) = struct.unpack_from("<I", raw, start + 4)
            ok = footer_len == 24 + 12 * n
        if not ok:
            if verify:
                raise CorruptArtifactError(f"mangled index footer in {where}")
            return raw, None
        if verify:
            (index_crc,) = struct.unpack_from("<I", raw, len(raw) - 12)
            if zlib.crc32(raw[:len(raw) - 12]) != index_crc:
                raise CorruptArtifactError(
                    f"index checksum mismatch in {where}")
        frames: Dict[int, int] = {}
        for i in range(n):
            foff, fcrc = struct.unpack_from("<QI", raw, start + 8 + 12 * i)
            frames[foff] = fcrc
        (data_crc,) = struct.unpack_from("<I", raw, start + 8 + 12 * n)
        return raw[:start], {"frames": frames, "data_crc": data_crc,
                             "n_frames": n}
    if verify:
        # a footer whose trailing magic is gone is a flipped byte in it;
        # no footer at all is an index cut back to its offsets
        if CHECKSUM_MAGIC in raw:
            raise CorruptArtifactError(f"mangled index footer in {where}")
        raise CorruptArtifactError(f"no checksum footer in {where}")
    return raw, None


def read_index(path: str) -> Tuple[bytes, Optional[dict]]:
    """Offsets bytes and checksum meta of a committed .index (every index
    reader goes through here, so none sees footer bytes)."""
    with open(path, "rb") as f:
        raw = f.read()
    return split_index(raw, path)


def verify_segment(blob: bytes, base: int, meta: Optional[dict],
                   data_path: str) -> None:
    """Verify a fetched segment's frames (`blob` starts at file offset
    `base`) against the commit-time frame crcs; a no-op with checksums
    off."""
    if not conf.artifact_checksums:
        return
    frames = meta["frames"]
    off = 0
    total = len(blob)
    while off < total:
        try:
            _raw_len, comp_len = serde.frame_header(blob[off:off + 12])
        except ValueError:
            raise CorruptArtifactError(
                f"torn frame at {data_path}+{base + off}") from None
        end = off + 12 + comp_len
        if end > total:
            raise CorruptArtifactError(
                f"truncated frame at {data_path}+{base + off}")
        want = frames.get(base + off)
        if want is None or zlib.crc32(blob[off:end]) != want:
            raise CorruptArtifactError(
                f"frame checksum mismatch at {data_path}+{base + off}")
        off = end


def _fetch_segment_once(data_path: str, index_path: str,
                        partition: int) -> bytes:
    offsets_raw, meta = read_index(index_path)
    n = len(offsets_raw) // 8
    if partition + 1 >= n:
        raise IndexError(f"partition {partition} out of range for "
                         f"{index_path} ({n - 1} partitions)")
    start, end = struct.unpack_from("<2Q", offsets_raw, partition * 8)
    if end == start:
        return b""
    with open(data_path, "rb") as f:
        f.seek(start)
        blob = f.read(end - start)
    if len(blob) != end - start:
        raise CorruptArtifactError(
            f"short segment read from {data_path} (the index names bytes "
            "the data file does not have)")
    verify_segment(blob, start, meta, data_path)
    return blob


def fetch_segment(data_path: str, index_path: str, partition: int) -> bytes:
    """One partition's verified segment bytes from a committed pair,
    following quarantine redirects; detected corruption quarantines the
    pair and re-runs the producing map task once (the repaired lineage is
    then read)."""
    for attempt in range(2):
        data_path, index_path = resolve_artifact(data_path, index_path)
        try:
            return _fetch_segment_once(data_path, index_path, partition)
        except CorruptArtifactError as e:
            if attempt:
                raise
            data_path, index_path = handle_corruption(
                data_path, index_path, str(e))
    raise AssertionError("unreachable")


def verify_pair(data_path: str, index_path: str) -> bool:
    """Full offline check of a committed pair: the footer parses, the index
    checksum matches, and every frame crc and the whole-file digest match.
    Never raises."""
    try:
        _offsets, meta = read_index(index_path)
    except (OSError, CorruptArtifactError):
        return False
    if meta is None:
        return True  # checksums off: nothing to verify against
    try:
        with open(data_path, "rb") as f:
            frames, data_crc = walk_frames(f)
    except (OSError, ValueError):
        return False
    return data_crc == meta["data_crc"] and dict(frames) == meta["frames"]


# -- quarantine + lineage repair --------------------------------------------

_repair_cv = threading.Condition(threading.Lock())
_repairs: Dict[str, Callable[[], Tuple[str, str]]] = {}
_redirects: Dict[str, Tuple[str, str]] = {}
_repairing: Set[str] = set()
_integrity_stats = {"corruptions": 0, "quarantined": 0, "repaired": 0}


def corruption_stats() -> Dict[str, int]:
    """Process-lifetime integrity counters (monitor exports
    blaze_artifact_corruptions_total from "corruptions")."""
    with _repair_cv:
        return dict(_integrity_stats)


def register_repair(data_path: str,
                    fn: Callable[[], Tuple[str, str]]) -> None:
    """Register the lineage re-execution closure for a committed map
    output: fn() re-runs ONLY the producing map task under a fresh
    epoch, commits, and returns the new (data_path, index_path)."""
    with _repair_cv:
        _repairs[data_path] = fn


def forget_repair(data_path: str) -> None:
    with _repair_cv:
        _repairs.pop(data_path, None)
        _redirects.pop(data_path, None)


def resolve_artifact(data_path: str,
                     index_path: str) -> Tuple[str, str]:
    """Follow quarantine redirects: after a repair, readers holding the
    original registered paths transparently read the repaired pair."""
    with _repair_cv:
        seen = set()
        while data_path in _redirects and data_path not in seen:
            seen.add(data_path)
            data_path, index_path = _redirects[data_path]
        return data_path, index_path


def quarantine(path: str) -> str:
    """Move a corrupt artifact aside as `<path>.quarantine` (suffixed
    `.quarantine.<n>` on name collision — repeated corruption of the
    same lineage must not clobber earlier evidence). Returns the
    quarantine name, or '' when the file is already gone."""
    qpath = path + QUARANTINE_TAG
    n = 0
    while os.path.exists(qpath):
        n += 1
        qpath = f"{path}{QUARANTINE_TAG}.{n}"
    try:
        os.replace(path, qpath)
    except OSError:
        return ""
    return qpath


def note_corruption(path: str, detail: str = "") -> str:
    """Count + trace + quarantine a corrupt artifact with NO lineage
    repair (spill files: the owning task's retry rebuilds them from its
    input stream). Returns the quarantine name ('' if already gone)."""
    with _repair_cv:
        _integrity_stats["corruptions"] += 1
    faults.TELEMETRY.add("artifact_corruptions", 1)
    trace.event("artifact_corrupt", path=os.path.basename(path),
                detail=detail[:200])
    qpath = quarantine(path)
    with _repair_cv:
        _integrity_stats["quarantined"] += 1
    trace.event("artifact_quarantined", path=os.path.basename(path),
                quarantined_as=os.path.basename(qpath) if qpath else "")
    return qpath


def handle_corruption(data_path: str, index_path: str,
                      detail: str) -> Tuple[str, str]:
    """Quarantine a corrupt pair and repair it via lineage re-execution.

    First detector wins: it quarantines both files and runs the
    registered repair closure; concurrent detectors of the SAME pair
    park on the condition and follow the winner's redirect. Returns the
    repaired (data_path, index_path); raises CorruptArtifactError when
    no repair is registered or the re-execution itself failed."""
    with _repair_cv:
        red = _redirects.get(data_path)
        if red is not None:
            return red
        while data_path in _repairing:
            _repair_cv.wait(timeout=60.0)
            red = _redirects.get(data_path)
            if red is not None:
                return red
        red = _redirects.get(data_path)
        if red is not None:
            return red
        _repairing.add(data_path)
        fn = _repairs.get(data_path)
        _integrity_stats["corruptions"] += 1
    try:
        faults.TELEMETRY.add("artifact_corruptions", 1)
        trace.event("artifact_corrupt",
                    path=os.path.basename(data_path),
                    detail=detail[:200])
        qd = quarantine(data_path)
        quarantine(index_path)
        with _repair_cv:
            _integrity_stats["quarantined"] += 1
        trace.event("artifact_quarantined",
                    path=os.path.basename(data_path),
                    quarantined_as=os.path.basename(qd) if qd else "")
        faults.TELEMETRY.add("artifact_quarantines", 1)
        if fn is None:
            raise CorruptArtifactError(
                f"corrupt artifact {data_path}: {detail} "
                f"(no lineage repair registered)")
        new_pair = fn()
        pair = (str(new_pair[0]), str(new_pair[1]))
        with _repair_cv:
            _redirects[data_path] = pair
            _integrity_stats["repaired"] += 1
        return pair
    finally:
        with _repair_cv:
            _repairing.discard(data_path)
            _repair_cv.notify_all()


# ---------------------------------------------------------------------------
# Epoch fencing (process-isolated executor attempts)
# ---------------------------------------------------------------------------
#
# A zombie executor — declared dead on heartbeat staleness but still
# running — may finish its task and write/report AFTER the driver has
# re-queued the task to a survivor. Fencing makes the late attempt
# harmless twice over: (1) every attempt writes to EPOCH-STAMPED final
# names (`shuffle_0_1.e2.data`), so a stale attempt can never overwrite
# the retried attempt's files; (2) the driver admits a result only when
# its epoch matches the fence, so a stale attempt can never double-count
# in the ledger. sweep_stale_epochs() reclaims the losers' files.


def stamp_epoch(path: str, epoch: int) -> str:
    """Epoch-stamped twin of `path` (`x.data` -> `x.e<epoch>.data`).
    Epoch <= 0 (the in-process runtime) leaves the name unchanged."""
    if epoch <= 0:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.e{epoch}{ext}"


def epoch_of(path: str) -> int:
    """Attempt epoch embedded in a stamped name; 0 for unstamped names."""
    m = _EPOCH_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else 0


def sweep_stale_epochs(data_path: str, index_path: str,
                       accepted_epoch: int) -> List[str]:
    """Remove stale-epoch twins of a committed pair: every `.e<k>.` twin
    of either name with k != accepted_epoch. Returns removed paths."""
    removed: List[str] = []
    for final in (data_path, index_path):
        d = os.path.dirname(final) or "."
        base, ext = os.path.splitext(os.path.basename(final))
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if not (name.startswith(base + ".e") and name.endswith(ext)):
                continue
            mid = name[len(base):]
            m = _EPOCH_RE.match(mid)
            if m is None or int(m.group(1)) == accepted_epoch:
                continue
            path = os.path.join(d, name)
            _unlink_quiet(path)
            removed.append(path)
    if removed:
        trace.event("orphan_sweep", removed=len(removed),
                    what="stale_epoch")
    return removed


class EpochFence:
    """Per-task attempt-epoch arbiter for the executor pool.

    The driver holds ONE fence per pool: `advance(key)` mints the next
    attempt epoch for a task (called at first dispatch and at every
    re-queue after an executor death), and `admit(key, epoch)` accepts a
    result only when it carries the CURRENT epoch — anything older was
    fenced by a re-queue and is dropped (counted, traced, files swept by
    the caller). `check(key, epoch)` is the raising form for commit
    paths that want the StaleAttemptError surface."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._epochs: Dict[str, int] = {}
        self.fenced_total = 0

    def advance(self, key: str) -> int:
        with self._lock:
            nxt = self._epochs.get(key, 0) + 1
            self._epochs[key] = nxt
            return nxt

    def current(self, key: str) -> int:
        with self._lock:
            return self._epochs.get(key, 0)

    def admit(self, key: str, epoch: int) -> bool:
        with self._lock:
            ok = self._epochs.get(key, 0) == epoch
            if not ok:
                self.fenced_total += 1
        if not ok:
            faults.TELEMETRY.add("attempts_fenced", 1)
            trace.event("epoch_fenced", task=key, epoch=epoch)
        return ok

    def check(self, key: str, epoch: int) -> None:
        if not self.admit(key, epoch):
            raise faults.StaleAttemptError(
                f"attempt epoch {epoch} fenced for {key} "
                f"(current {self.current(key)})")

    def forget(self, key: str) -> None:
        with self._lock:
            self._epochs.pop(key, None)


# ---------------------------------------------------------------------------
# orphan sweep
# ---------------------------------------------------------------------------

def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def _orphan_pid(name: str) -> int:
    """Writer pid in an artifact temp or spill file name; -1 when the name
    does not parse (treated as live: never delete what is not understood)."""
    if ORPHAN_TAG in name:
        pid = name.rsplit(ORPHAN_TAG, 1)[1].split(".", 1)[0]
        return int(pid) if pid.isdigit() else -1
    m = _SPILL_RE.match(name)
    return int(m.group(1)) if m else -1


def _acquire_sweep_lock(d: str) -> bool:
    """Take the per-directory sweep lock, breaking it if its holder died.
    False when another live process is sweeping (skip the directory: it is
    being cleaned anyway)."""
    path = os.path.join(d, SWEEP_LOCK)
    for _ in range(2):  # second pass only after breaking a stale lock
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                with open(path, "r") as f:
                    holder = f.read().strip()
            except OSError:
                return False  # the holder removed it in between
            if holder.isdigit() and _pid_alive(int(holder)):
                return False
            _unlink_quiet(path)  # stale: holder dead or wrote garbage
            continue
        except OSError:
            return False  # unwritable directory: nothing to sweep safely
        try:
            os.write(fd, str(os.getpid()).encode())
        finally:
            os.close(fd)
        return True
    return False


def _release_sweep_lock(d: str) -> None:
    _unlink_quiet(os.path.join(d, SWEEP_LOCK))


def sweep_orphans(directories: Sequence[str], include_self: bool = False
                  ) -> List[str]:
    """Remove dead writers' leftovers from `directories`; returns the
    removed paths. `include_self` also reclaims THIS process's temps
    (only where no commit is in flight, as in test harnesses). Each
    directory is swept under its pid-stamped lockfile."""
    removed: List[str] = []
    if isinstance(directories, str):
        directories = [directories]
    for d in directories:
        if not _acquire_sweep_lock(d):
            continue
        try:
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                pid = _orphan_pid(name)
                if pid < 0:
                    continue
                if _pid_alive(pid) and not (include_self
                                            and pid == os.getpid()):
                    continue
                path = os.path.join(d, name)
                _unlink_quiet(path)
                removed.append(path)
        finally:
            _release_sweep_lock(d)
    if removed:
        faults.TELEMETRY.add("orphans_swept", len(removed))
        trace.event("orphan_sweep", removed=len(removed))
    return removed


def find_orphans(directories: Sequence[str]) -> List[str]:
    """List artifact temps and spill leftovers without removing them."""
    found: List[str] = []
    if isinstance(directories, str):
        directories = [directories]
    for d in directories:
        try:
            names = os.listdir(d)
        except OSError:
            continue
        found.extend(os.path.join(d, n) for n in names
                     if _orphan_pid(n) >= 0)
    return found
