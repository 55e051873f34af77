"""Build and bind the port's native library: the C++ layer of the C ABI.

Port of blaze_tpu/native/__init__.py, with its names. The library is the
boundary a Spark executor crosses (ref blaze-jni-bridge): Spark murmur3 and
pmod, the BTB1 frame encoder, the shuffle map-output writer, the Arrow C
stream, and the task entry (`bn_call`, `bn_call_arrow`) that hands a
TaskDefinition to this process's engine (runtime/native_entry.py), which
runs it on the CUDA card. Host code throughout; no kernel of the card.

The JAX package builds its library with `make -C native`; the port builds
its own at first use, as `kernels` builds the CUDA libraries: g++ compiles
the JAX package's C++ sources in place (murmur3, batch_serde,
shuffle_file, arrow_stream, jni_bridge; never edited, nothing written into
native/) with the port's csrc/task_runtime.cpp (the task entry, calling
this package) and csrc/zstd_codec.cpp (the serde's codec where the
`zstandard` wheel is missing) into the build directory. The file name
carries a hash of the sources and flags; one process builds at a time (a
lock file beside it), writing a temporary file that it renames, so a
concurrent loader never reads a half-written library.
libzstd is linked by its soname, and csrc/zstd_abi declares its API for a
host that has the runtime library but not its development header.

`available()` is False only where the library cannot build (no g++, no
libzstd); `build_error()` then says why. A call that fails raises; it
never makes the library unavailable.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_REPO = _PKG.parent
_CSRC = _PKG / "csrc"
_NATIVE = _REPO / "native"
SOURCES = [_NATIVE / "src" / f"{name}.cpp" for name in (
    "murmur3", "batch_serde", "shuffle_file", "arrow_stream", "jni_bridge")
] + [_CSRC / "task_runtime.cpp", _CSRC / "zstd_codec.cpp"]
HEADERS = [_NATIVE / "include" / "blaze_native.h",
           _CSRC / "zstd_abi" / "zstd.h"]
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-I", "native/include",
             "-idirafter", "blaze_tpu_torch/csrc/zstd_abi"]
LD_FLAGS = ["-shared", "-l:libzstd.so.1", "-ldl"]
# where the library is built; None: the CUDA kernels' build directory
# (kernels.BUILD_DIR, which BLAZE_TPU_TORCH_BUILD_DIR overrides)
BUILD_DIR: Optional[Path] = None
# {"seconds": wall time of this process's build, "path": the library}
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


class _BnCol(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_uint8),
        ("item_size", ctypes.c_uint8),
        ("data", ctypes.c_void_p),
        ("width", ctypes.c_int32),
        ("lengths", ctypes.c_void_p),
        ("validity", ctypes.c_void_p),
    ]


def library_path(build_dir: Optional[Path] = None) -> Path:
    """The library's path under `build_dir`, named by a hash of every
    source, header and flag."""
    from blaze_tpu_torch import kernels

    h = hashlib.sha1(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for p in SOURCES + HEADERS:
        h.update(p.name.encode() + p.read_bytes())
    d = Path(build_dir or BUILD_DIR or kernels.BUILD_DIR)
    return d / f"libblaze_tpu_torch_native-{h.hexdigest()[:12]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Build the library unless it is on disk already; its path. Raises
    RuntimeError with the compiler's output when it cannot build. Reports
    the build (or the hit) to the compile service."""
    from blaze_tpu_torch.runtime import compile_service

    out = library_path(build_dir)
    if out.exists():
        compile_service.note_build("native", None)
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ to build the native library")
    out.parent.mkdir(parents=True, exist_ok=True)
    # one build at a time across processes: the others wait for it and
    # then find the library on disk
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            compile_service.note_build("native", None)
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, *map(str, SOURCES), *LD_FLAGS, "-o", str(tmp)],
            cwd=str(_REPO), capture_output=True, text=True)
        if proc.returncode != 0:
            if tmp.exists():
                tmp.unlink()
            raise RuntimeError("g++ could not build the native library:\n"
                               + (proc.stderr or proc.stdout).strip())
        os.replace(tmp, out)  # atomic: a loader never sees half a file
    seconds = time.perf_counter() - t0
    BUILD_INFO.update(seconds=seconds, path=str(out))
    compile_service.note_build("native", int(seconds * 1e9))
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I64, I32, I = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                      ctypes.c_int)
    sigs = {
        "bn_serialize_bound": ([ctypes.POINTER(_BnCol), I32, I64, I64], I64),
        "bn_serialize": ([ctypes.POINTER(_BnCol), I32, I64, I64, I32,
                          ctypes.c_char_p, I64], I64),
        "bn_shuffle_new": ([I32, ctypes.c_char_p, I64], P),
        "bn_shuffle_push": ([P, I32, ctypes.c_char_p, I64], I),
        "bn_shuffle_commit": ([P, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.POINTER(I64)], I),
        "bn_shuffle_free": ([P], None),
        "bn_shuffle_mem_used": ([P], I64),
        "bn_shuffle_spill": ([P], I),
        "bn_call": ([ctypes.c_char_p, I64,
                     ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                     ctypes.POINTER(I64)], I),
        "bn_call_arrow": ([ctypes.c_char_p, I64, P], I),
        "bn_arrow_stream_from_payload": ([ctypes.c_char_p, I64, P], I),
        "bn_init": ([I64], I),
        "bn_spill": ([I64], I64),
        "bn_last_error": ([], ctypes.c_char_p),
        "bn_last_error_category": ([], I),
        "bn_request_kill": ([], I),
        "bn_clear_kill": ([], I),
        "bn_kill_requested": ([], I),
        "bn_free_buffer": ([ctypes.POINTER(ctypes.c_uint8)], None),
        "bn_hash_i32": ([P, P, I64, P], None),
        "bn_hash_i64": ([P, P, I64, P], None),
        "bn_hash_bytes": ([P, P, I64, I32, P, P], None),
        "bn_pmod": ([P, I64, I32, P], None),
        "bt_zstd_version": ([], ctypes.c_uint),
        "bt_zstd_bound": ([I64], I64),
        "bt_zstd_compress": ([P, I64, P, I64, I32], I64),
        "bt_zstd_decompress": ([P, I64, P, I64], I64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _load_state() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(the library or None, why it could not load or None), read under
    the lock; the first call builds and loads it."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError) as e:
                _error = str(e)
        return _lib, _error


def _load() -> Optional[ctypes.CDLL]:
    return _load_state()[0]


def _require() -> ctypes.CDLL:
    lib, error = _load_state()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {error}")
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not build (the compiler's output), or None."""
    return _load_state()[1]


def init(mem_budget: int = 0, device=None) -> None:
    """bn_init: the engine's memory budget (0 keeps the current one).
    `device` is where native tasks run (None: the CUDA card; "cpu" asks for
    the host); the C signature of bn_init has no such argument, so it is
    set on the Python side of the entry."""
    from blaze_tpu_torch.runtime import native_entry

    lib = _require()
    native_entry.set_device(device)
    rc = lib.bn_init(int(mem_budget))
    if rc != 0:
        raise _native_error("bn_init", rc)


def last_error_category() -> int:
    """bn_last_error_category wire code of this thread's last failure."""
    return int(_require().bn_last_error_category())


def request_kill() -> None:
    """bn_request_kill: cooperatively cancel running native tasks."""
    _require().bn_request_kill()


def clear_kill() -> None:
    """bn_clear_kill: re-arm after a kill so the next task may run."""
    _require().bn_clear_kill()


def kill_requested() -> bool:
    """bn_kill_requested: whether the native kill flag is set."""
    return int(_require().bn_kill_requested()) > 0


def _native_error(what: str, rc: int) -> Exception:
    """Map the C ABI error category onto the faults taxonomy, so the
    resilience ladder treats a native failure like a Python one."""
    from blaze_tpu_torch.runtime import faults

    lib = _require()
    msg = f"{what} failed ({rc}): {lib.bn_last_error().decode()}"
    cat = faults.NATIVE_CODE_CATEGORIES.get(last_error_category())
    if cat == "killed":
        from blaze_tpu_torch.ops.base import TaskKilledError

        return TaskKilledError(msg)
    cls = faults.CATEGORY_CLASSES.get(cat)
    return cls(msg) if cls is not None else RuntimeError(msg)


def _ptr(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.c_void_p)


def hash_columns(cols, seed: int = 42) -> np.ndarray:
    """Spark murmur3 over host column dicts, as exprs/hash.py computes it.

    `cols`: list of dicts {kind: 'i32'|'i64'|'bytes', data, lengths?,
    validity?} with numpy arrays."""
    lib = _require()
    n = len(cols[0]["data"])
    h = np.full(n, np.uint32(seed), np.uint32)
    for c in cols:
        v = c.get("validity")
        v8 = None if v is None else np.ascontiguousarray(v, np.uint8)
        if c["kind"] == "i32":
            lib.bn_hash_i32(_ptr(np.ascontiguousarray(c["data"], np.int32)),
                            _ptr(v8), n, _ptr(h))
        elif c["kind"] == "i64":
            lib.bn_hash_i64(_ptr(np.ascontiguousarray(c["data"], np.int64)),
                            _ptr(v8), n, _ptr(h))
        elif c["kind"] == "bytes":
            mat = np.ascontiguousarray(c["data"], np.uint8)
            lens = np.ascontiguousarray(c["lengths"], np.int32)
            lib.bn_hash_bytes(_ptr(mat), _ptr(lens), n, mat.shape[1],
                              _ptr(v8), _ptr(h))
        else:
            raise ValueError(c["kind"])
    return h.view(np.int32)


def pmod(h: np.ndarray, num_partitions: int) -> np.ndarray:
    lib = _require()
    out = np.zeros(len(h), np.int32)
    lib.bn_pmod(_ptr(h.view(np.uint32)), len(h), num_partitions, _ptr(out))
    return out


def serialize_host_batch(host_batch, lo: int, hi: int,
                         level: int = 1) -> bytes:
    """C++ encoder for a serde.HostBatch slice: the bytes of
    HostBatch.serialize at the same zstd level and library. Columns the C
    ABI does not cover (dictionaries, lists, structs) raise."""
    lib = _require()
    cols = host_batch.cols
    carr = (_BnCol * len(cols))()
    keep = []  # keep contiguous arrays alive
    for i, c in enumerate(cols):
        if c.kind == "num":
            d = np.ascontiguousarray(c.data)
            keep.append(d)
            carr[i].kind, carr[i].item_size = 0, d.dtype.itemsize
            carr[i].data = d.ctypes.data
        elif c.kind == "str":
            d = np.ascontiguousarray(c.data, np.uint8)
            lens = np.ascontiguousarray(c.lengths, np.int32)
            keep += [d, lens]
            carr[i].kind, carr[i].item_size = 1, 1
            carr[i].data, carr[i].width = d.ctypes.data, d.shape[1]
            carr[i].lengths = lens.ctypes.data
        elif c.kind == "null":
            carr[i].kind = 2
        else:
            raise NotImplementedError(f"native serde: {c.kind} column")
        if c.validity is not None:
            v = np.ascontiguousarray(c.validity, np.uint8)
            keep.append(v)
            carr[i].validity = v.ctypes.data
    bound = lib.bn_serialize_bound(carr, len(cols), lo, hi)
    out = ctypes.create_string_buffer(bound)
    n = lib.bn_serialize(carr, len(cols), lo, hi, level, out, bound)
    if n < 0:
        raise RuntimeError(f"bn_serialize failed: {n}")
    return ctypes.string_at(out, n)


def zstd_version() -> str:
    """The linked libzstd's version, e.g. "1.5.5"."""
    v = int(_require().bt_zstd_version())
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def zstd_compress(raw, level: int) -> bytes:
    """One zstd frame of `raw` at `level` (bt_zstd_compress)."""
    lib = _require()
    src = np.frombuffer(raw, np.uint8)
    cap = int(lib.bt_zstd_bound(src.size))
    dst = ctypes.create_string_buffer(cap)
    n = lib.bt_zstd_compress(_ptr(src), src.size, dst, cap, int(level))
    if n < 0:
        raise RuntimeError("bt_zstd_compress failed")
    return ctypes.string_at(dst, n)


def zstd_decompress(comp, raw_len: int) -> bytes:
    """The `raw_len` bytes of one zstd frame (bt_zstd_decompress)."""
    lib = _require()
    src = np.frombuffer(comp, np.uint8)
    dst = ctypes.create_string_buffer(max(int(raw_len), 1))
    n = lib.bt_zstd_decompress(_ptr(src), src.size, dst, int(raw_len))
    if n != raw_len:
        raise ValueError(f"corrupt zstd frame ({n} of {raw_len} bytes)")
    return ctypes.string_at(dst, n)


class _ArrowArrayStream(ctypes.Structure):
    """Arrow C stream interface struct (stable ABI): four function
    pointers and private_data."""
    _fields_ = [("get_schema", ctypes.c_void_p),
                ("get_next", ctypes.c_void_p),
                ("get_last_error", ctypes.c_void_p),
                ("release", ctypes.c_void_p),
                ("private_data", ctypes.c_void_p)]


def call_arrow(task_def: bytes):
    """bn_call_arrow: run a TaskDefinition and import the result as a
    pyarrow.RecordBatchReader through the standard Arrow C stream (ref
    blaze/src/rt.rs:76-80)."""
    import pyarrow as pa

    lib = _require()
    stream = _ArrowArrayStream()
    rc = lib.bn_call_arrow(task_def, len(task_def), ctypes.byref(stream))
    if rc != 0:
        raise _native_error("bn_call_arrow", rc)
    return pa.RecordBatchReader._import_from_c(ctypes.addressof(stream))


def arrow_stream_from_payload(payload: bytes):
    """Import a BTAS payload (schema header + BTB1 frames) as a pyarrow
    RecordBatchReader via bn_arrow_stream_from_payload."""
    import pyarrow as pa

    lib = _require()
    stream = _ArrowArrayStream()
    rc = lib.bn_arrow_stream_from_payload(payload, len(payload),
                                          ctypes.byref(stream))
    if rc != 0:
        raise RuntimeError("bn_arrow_stream_from_payload failed")
    return pa.RecordBatchReader._import_from_c(ctypes.addressof(stream))


def call_native(task_def: bytes) -> bytes:
    """The callNative entry: serialized TaskDefinition -> result frames."""
    lib = _require()
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.bn_call(task_def, len(task_def), ctypes.byref(out),
                     ctypes.byref(out_len))
    if rc != 0:
        raise _native_error("bn_call", rc)
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.bn_free_buffer(out)


class NativeShuffleWriter:
    """ctypes wrapper over bn_shuffle_* (the C++ map-output writer).

    One lock guards the C++ writer and its pointer: `close` frees it under
    the lock and clears the pointer, and `mem_used` of a closed writer is 0,
    so a memory manager summing its consumers from another thread never
    hands bn_shuffle_mem_used a freed writer (the JAX package's writer can,
    and segfaults)."""

    def __init__(self, num_partitions: int, spill_dir: str = "/tmp",
                 mem_budget: int = 1 << 30) -> None:
        self._lib = _require()
        self._lock = threading.Lock()
        self.P = num_partitions
        self._w = self._lib.bn_shuffle_new(num_partitions,
                                           spill_dir.encode(), mem_budget)

    def _live_locked(self):
        """The writer's pointer; the caller holds self._lock."""
        if not self._w:
            raise RuntimeError("native shuffle writer is closed")
        return self._w

    def push(self, partition: int, frame: bytes) -> None:
        with self._lock:
            rc = self._lib.bn_shuffle_push(self._live_locked(), partition,
                                           frame, len(frame))
        if rc != 0:
            raise _native_error("bn_shuffle_push", rc)

    def mem_used(self) -> int:
        with self._lock:
            return int(self._lib.bn_shuffle_mem_used(self._w)) \
                if self._w else 0

    def spill(self) -> None:
        with self._lock:
            rc = self._lib.bn_shuffle_spill(self._live_locked())
        if rc != 0:
            raise _native_error("bn_shuffle_spill", rc)

    def commit(self, data_path: str, index_path: str) -> List[int]:
        lengths = (ctypes.c_int64 * self.P)()
        with self._lock:
            rc = self._lib.bn_shuffle_commit(
                self._live_locked(), data_path.encode(), index_path.encode(),
                lengths)
        if rc != 0:
            raise _native_error("bn_shuffle_commit", rc)
        return list(lengths)

    def close(self) -> None:
        with self._lock:
            if self._w:
                self._lib.bn_shuffle_free(self._w)
                self._w = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
