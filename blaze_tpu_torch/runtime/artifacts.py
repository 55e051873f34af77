"""Crash-atomic artifact commit, checksummed shuffle indexes, orphan sweep.

Port of parts of blaze_tpu/runtime/artifacts.py. A killed task must never
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
(`fetch_segment`). A mismatch, or an index without its footer, raises
CorruptArtifactError: this module never returns unverified bytes. The JAX package then quarantines the pair
and re-runs the producing map task (lineage repair), with a
first-commit-wins gate between speculative attempts, fault points and
epoch fencing; those come with the service slice (runtime/supervisor.py,
runtime/faults.py).
"""

from __future__ import annotations

import itertools
import os
import re
import struct
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.config import conf

ORPHAN_TAG = ".inprogress."
# checksum footer appended to committed .index files:
#   BIXC | u32 n_frames | n x (u64 frame_offset, u32 frame_crc)
#        | u32 data_crc | u32 index_crc | u32 footer_len | BIXC
# index_crc covers the offsets region AND the footer through data_crc, so
# a flip anywhere but the trailing 12 bytes is caught by one crc; those
# last bytes are structural (length + magic) and fail the parse.
CHECKSUM_MAGIC = b"BIXC"
_SPILL_RE = re.compile(r"^blz(\d+)-.*\.spill$")
_seq = itertools.count()

# Per-directory sweep mutex, pid-stamped so that a sweeper that died
# mid-sweep does not wedge the directory: a lock held by a dead pid is
# broken and retaken.
SWEEP_LOCK = ".blz_sweep.lock"


class CorruptArtifactError(RuntimeError):
    """A committed shuffle or spill artifact failed its checksum."""


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


def publish(tmp_path: str, final_path: str) -> None:
    """fsync a staged temp, then atomically rename it onto its final
    name."""
    _fsync_path(tmp_path)
    os.replace(tmp_path, final_path)


def commit_file(write_fn: Callable[[str], None], final_path: str) -> None:
    """stage -> write_fn(tmp) -> publish; the temp goes on any failure."""
    tmp = stage_path(final_path)
    try:
        write_fn(tmp)
        publish(tmp, final_path)
    except BaseException:
        _unlink_quiet(tmp)
        raise


def commit_shuffle_pair(write_fn, data_path: str, index_path: str):
    """Commit a map task's `.data`/`.index` pair crash-atomically.

    `write_fn(tmp_data, tmp_index) -> lengths` writes both files. The
    checksum footer is stamped onto the staged index, both temps are
    fsync'd, then data is published before the index: readers find
    segments through the index, so it must never name data that is not in
    place. On any failure only `.inprogress.` temps existed, and they are
    removed."""
    tmp_data = stage_path(data_path)
    tmp_index = stage_path(index_path)
    try:
        lengths = write_fn(tmp_data, tmp_index)
        if conf.artifact_checksums:
            _append_index_footer(tmp_data, tmp_index)
        _fsync_path(tmp_data)
        _fsync_path(tmp_index)
        os.replace(tmp_data, data_path)
        os.replace(tmp_index, index_path)
        return lengths
    except BaseException:
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
    """One partition's verified segment bytes from a committed pair.
    Corruption raises: the JAX package's quarantine and lineage repair
    (re-running the producing map task) come with the service slice."""
    try:
        return _fetch_segment_once(data_path, index_path, partition)
    except CorruptArtifactError as e:
        raise CorruptArtifactError(
            f"{e} (quarantine and lineage repair of the map output wait "
            "for the service slice: runtime/artifacts.handle_corruption, "
            "runtime/supervisor.py)") from e


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


def sweep_orphans(directories: Sequence[str]) -> List[str]:
    """Remove dead writers' leftovers from `directories`; returns the
    removed paths. Each directory is swept under its pid-stamped
    lockfile."""
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
                if _pid_alive(pid):
                    continue
                path = os.path.join(d, name)
                _unlink_quiet(path)
                removed.append(path)
        finally:
            _unlink_quiet(os.path.join(d, SWEEP_LOCK))
    return removed
