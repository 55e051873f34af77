"""Compact columnar batch serialization with zstd framing.

Port of blaze_tpu/columnar/serde.py (ref: datafusion-ext-commons
io/batch_serde.rs: a column-wise format in zstd level-1 frames with
bit-packed validity, :257-302), the wire format of shuffle segments, spill
files and broadcast payloads. The bytes are the JAX package's: a frame one
package writes, the other reads.

Frame layout (little-endian):
  u32 magic "BTB1" | u32 raw_len | u32 comp_len | zstd(payload)
Payload:
  u32 num_rows | u16 num_cols | colblock*
Colblock:
  u8 has_validity | [ceil(n/8) bytes packed validity (LSB-first)]
  numeric/bool: n * itemsize raw LE values
  string/binary: u32 total | n x u32 lengths | concatenated bytes
  string/binary (dict): u32 0xFFFFFFFF | u32 K | u32 dict_total |
                        K x u32 dict_lengths | dict bytes | n x u32 codes
  list/map: u32 total | n x u32 lengths | the element colblock of
            `total` rows (a map's elements are its (key, value) structs)
  struct: one colblock per field, n rows each (a wide decimal: its hi
          and lo int64 planes, types.wide_decimal_storage)
  null column: nothing

The dict form (conf.dict_encode_strings) writes each distinct string of a
slice once plus per-row codes; code 0 is always the empty string. A slice
past conf.dict_max_cardinality distinct strings, or where the dict form is
not smaller, is written plain. A column that is already a dictionary
(`DictData`) ships its dictionary and the slice's codes as they are, and
decodes back into one. List offsets are int32 on the device and int64
on the host; a struct keeps one validity a level.

Frames are zstd: through the `zstandard` wheel where it is installed,
else through the system's libzstd in the port's native library (where the
card's host has no wheel), else a zlib shim (`codec()` says which).

`to_host` pulls a batch to the host in ONE device->host copy (all columns
packed into one byte tensor, counted in metrics.HOST_PULLS); `HostBatch`
then serializes row ranges of it (`serialize(lo, hi)`), which is how the
shuffle writer cuts one partition-sorted batch into per-partition frames.
Decoding builds host columns (`read_batch_host`, `deserialize_batch_host`)
and uploads them in one host->device copy onto the caller's device
(ops/host_sort.host_to_device); `device=None` is the CUDA card. The
fault points are the JAX module's (`serde.encode`, `device.get`,
`serde.decode`, runtime/faults.py), and so are its runtime/monitor.py
counts: a frame's raw and compressed bytes and its encode or decode time
at the serde boundary, a pull's host bytes at the ffi boundary.
"""

from __future__ import annotations

import dataclasses
import io
import struct
import time
import types
import zlib
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import zstandard

    _CODEC = "zstandard"
except ModuleNotFoundError:  # pragma: no cover - environment-dependent
    zstandard = None  # chosen by codec() at the first frame
    _CODEC = None

from blaze_tpu_torch import native
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import (
    DataType, Schema, TypeKind, storage_element, struct_fields,
)
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike
from blaze_tpu_torch.runtime import faults, metrics, monitor

MAGIC = b"BTB1"
DICT_SENTINEL = 0xFFFFFFFF  # an impossible plain string `total`


class _LibCompressor:
    """zstd through the native library's bt_zstd_compress (libzstd)."""

    def __init__(self, level=1, **_kw):
        self.level = int(level)

    def compress(self, raw):
        return native.zstd_compress(raw, self.level)


class _LibDecompressor:
    def decompress(self, comp, max_output_size=0):
        return native.zstd_decompress(comp, max_output_size)


class _ZlibCompressor:
    def __init__(self, level=1, **_kw):
        self.level = min(max(int(level), 1), 9)

    def compress(self, raw):
        return zlib.compress(raw, self.level)


class _ZlibDecompressor:
    def decompress(self, comp, max_output_size=0):
        return zlib.decompress(comp)


def codec() -> str:
    """Which codec compresses this process's frames: "zstandard" (the
    wheel), "libzstd <version>" (the system's libzstd through the native
    library, where the wheel is missing) or "zlib" (a shim for a host with
    neither). The first two write the same zstd frames as the C++ encoder;
    the zlib shim's frames are NOT zstd-interoperable, and it engages only
    where the native library cannot build, so no C++ frame meets a zlib
    one. Decided once, at the first frame."""
    global zstandard, _CODEC
    if _CODEC is None:
        if native.available():
            zstandard = types.SimpleNamespace(
                ZstdCompressor=_LibCompressor,
                ZstdDecompressor=_LibDecompressor)
            _CODEC = "libzstd " + native.zstd_version()
        else:
            zstandard = types.SimpleNamespace(
                ZstdCompressor=_ZlibCompressor,
                ZstdDecompressor=_ZlibDecompressor)
            _CODEC = "zlib"
    return _CODEC


def _zstd():
    """The codec's module-like namespace (ZstdCompressor,
    ZstdDecompressor), decided at first use."""
    if _CODEC is None:
        codec()
    return zstandard


@dataclasses.dataclass
class _HostCol:
    kind: str                        # num | str | dict | list | struct | null
    data: Optional[np.ndarray]       # (n,) values, bool as uint8 when
                                     # pulled | (n, W) bytes | dict: (K, W)
    validity: Optional[np.ndarray]   # (n,) bool, None = all valid
    lengths: Optional[np.ndarray] = None  # str: (n,) | dict: (K,) int32
    codes: Optional[np.ndarray] = None    # dict: (n,) int32 codes
    offsets: Optional[np.ndarray] = None  # list: (n + 1,) int64 from 0
    child: Optional["_HostCol"] = None    # list: the element column
    children: Optional[List["_HostCol"]] = None  # struct: field columns


@dataclasses.dataclass
class HostBatch:
    """Live rows of a batch on the host, sliceable for serde."""
    schema: Schema
    cols: List[_HostCol]
    num_rows: int

    def serialize(self, lo: int = 0, hi: Optional[int] = None) -> bytes:
        # the window opens before the fault point: an injected encode
        # stall is real wall time and lands in SERDE_NS and serde_encode
        t0 = time.perf_counter_ns()
        if conf.fault_injection_spec:
            faults.inject("serde.encode")
        hi = self.num_rows if hi is None else hi
        out = io.BytesIO()
        out.write(struct.pack("<IH", max(hi - lo, 0), len(self.cols)))
        for c in self.cols:
            _write_col(out, c, lo, hi)
        raw = out.getvalue()
        comp = _zstd().ZstdCompressor(level=conf.zstd_level).compress(raw)
        frame = MAGIC + struct.pack("<II", len(raw), len(comp)) + comp
        ns = time.perf_counter_ns() - t0
        metrics.bump(metrics.SERDE_NS, "encode", ns)
        metrics.bump(metrics.SERDE_BYTES, "raw", len(raw))
        metrics.bump(metrics.SERDE_BYTES, "frames", len(frame))
        if conf.monitor_enabled:
            # copied: the raw payload rebuilt row by row into the frame;
            # moved: the compressed frame that crosses
            monitor.count_copy("serde", len(raw), moved=len(frame))
            monitor.count_time("serde_encode", ns)
        return frame


def _dict_encode_slice(b: np.ndarray, lens: np.ndarray):
    """Distinct strings of a slice -> (dict (K, W), dict_lens (K,),
    codes (n,)) with entry 0 the empty string, or None past the
    cardinality cap. The length is part of the key: b"a\\x00" and b"a"
    share padded bytes but are different strings."""
    w = int(b.shape[1]) if b.ndim == 2 else 0
    pos = np.arange(w)[None, :] < lens[:, None]
    canon = np.where(pos, b, 0).astype(np.uint8, copy=False)
    key = np.concatenate(
        [canon, lens.astype("<u4")[:, None].view(np.uint8)], axis=1)
    # an all-zero first row sorts first and pins code 0 to the empty string
    key = np.vstack([np.zeros((1, w + 4), np.uint8), key])
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    if uniq.shape[0] - 1 > conf.dict_max_cardinality:
        return None
    dmat = np.ascontiguousarray(uniq[:, :w])
    dlens = np.ascontiguousarray(uniq[:, w:]).view("<u4").reshape(-1)
    return dmat, dlens, inv.reshape(-1)[1:].astype(np.uint32)


def _write_dict_block(out, dmat: np.ndarray, dlens: np.ndarray,
                      codes: np.ndarray) -> None:
    dlens = dlens.astype(np.uint32)
    out.write(struct.pack("<III", DICT_SENTINEL, dlens.shape[0],
                          int(dlens.sum())))
    out.write(dlens.tobytes())
    if dmat.size:
        pos = np.arange(dmat.shape[1])[None, :] < dlens[:, None]
        out.write(np.ascontiguousarray(dmat)[pos].tobytes())
    out.write(codes.astype(np.uint32).tobytes())
    if conf.monitor_enabled:
        monitor.count_zerocopy("dict_cols_encoded")


def _write_col(out, c: _HostCol, lo: int, hi: int) -> None:
    has_v = c.validity is not None
    out.write(struct.pack("<B", 1 if has_v else 0))
    if has_v:
        out.write(np.packbits(c.validity[lo:hi].astype(np.uint8),
                              bitorder="little").tobytes())
    if c.kind == "null":
        return
    if c.kind == "dict":
        # already encoded: the dictionary and the slice's codes
        _write_dict_block(out, c.data, c.lengths, c.codes[lo:hi])
        return
    if c.kind == "str":
        lens = c.lengths[lo:hi].astype(np.uint32)
        total = int(lens.sum())
        n = int(lens.shape[0])
        if conf.dict_encode_strings and n:
            enc = _dict_encode_slice(c.data[lo:hi], lens)
            if enc is not None:
                dmat, dlens, codes = enc
                dict_sz = 12 + 4 * dlens.shape[0] + int(dlens.sum()) + 4 * n
                if dict_sz < 4 + 4 * n + total:
                    if conf.trace_enabled:
                        from blaze_tpu_torch.runtime import trace
                        trace.event("dict_encode", rows=n,
                                    entries=int(dlens.shape[0]))
                    _write_dict_block(out, dmat, dlens, codes)
                    return
        out.write(struct.pack("<I", total) + lens.tobytes())
        if total:
            b = c.data[lo:hi]
            pos = np.arange(b.shape[1])[None, :] < lens[:, None]
            out.write(b[pos].tobytes())
        return
    if c.kind == "list":
        lens = (c.offsets[lo + 1:hi + 1] - c.offsets[lo:hi]).astype(
            np.uint32)
        elo, ehi = int(c.offsets[lo]), int(c.offsets[hi])
        out.write(struct.pack("<I", ehi - elo) + lens.tobytes())
        _write_col(out, c.child, elo, ehi)
        return
    if c.kind == "struct":
        for ch in c.children:
            _write_col(out, ch, lo, hi)
        return
    out.write(np.ascontiguousarray(c.data[lo:hi]).tobytes())


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    # bool data leaves as uint8, the JAX package's host form of it
    if t.dtype == torch.bool:
        return np.dtype(np.uint8)
    return np.dtype(str(t.dtype).replace("torch.", ""))


def _column_parts(c, parts: List[torch.Tensor]) -> None:
    """Append the byte views of a column's tensors, children first-order,
    in the order `_host_column` reads them back."""
    d = c.data
    if c.is_list:
        parts.append(_bytes_of(d.offsets))
        _column_parts(d.elements, parts)
    elif c.is_struct:
        for ch in d.children:
            _column_parts(ch, parts)
    elif c.is_dict:
        parts += [_bytes_of(d.codes), _bytes_of(d.dict_bytes),
                  _bytes_of(d.dict_lengths)]
    elif c.is_string:
        parts += [_bytes_of(d.bytes), _bytes_of(d.lengths)]
    else:
        parts.append(_bytes_of(d))
    if c.validity is not None:
        parts.append(_bytes_of(c.validity))


def _host_column(c, dtype: DataType, n: int, take) -> _HostCol:
    """Rows [0, n) of a column from the pulled buffer; `take(np dtype,
    count)` reads the next part."""
    i32, u8 = np.dtype(np.int32), np.dtype(np.uint8)
    if c.is_list:
        offs = take(i32, c.capacity + 1)[:n + 1].astype(np.int64)
        child = _host_column(c.data.elements, c.data.elements.dtype,
                             int(offs[n]) if n else 0, take)
        hc = _HostCol("list", None, None, offsets=offs, child=child)
    elif c.is_struct:
        hc = _HostCol("struct", None, None, children=[
            _host_column(ch, f.dtype, n, take)
            for ch, f in zip(c.data.children, struct_fields(dtype))])
    elif c.is_dict:
        d = c.data
        codes = take(i32, c.capacity)[:n]
        dmat = take(u8, d.dict_capacity * d.width).reshape(
            d.dict_capacity, d.width)
        dlens = take(i32, d.dict_capacity)
        hc = _HostCol("dict", dmat, None, dlens, codes)
    elif c.is_string:
        w = c.data.width
        mat = take(u8, c.capacity * w).reshape(c.capacity, w)[:n]
        hc = _HostCol("str", mat, None, take(i32, c.capacity)[:n])
    else:
        data = take(_np_dtype(c.data), c.capacity)[:n]
        null = dtype.kind == TypeKind.NULL
        hc = _HostCol("null" if null else "num", None if null else data,
                      None)
    if c.validity is not None:
        hc.validity = take(np.dtype(bool), c.capacity)[:n]
    return hc


def to_host_with(batch: ColumnBatch, extra: Sequence[torch.Tensor] = ()
                 ) -> Tuple[HostBatch, List[np.ndarray]]:
    """Pull `batch` (and `extra` tensors on its device) to the host in ONE
    device->host copy: every column, its validity (children and list
    elements included, at their capacities), the extras and the row
    count are packed into one byte tensor first, then viewed back per
    part on the host."""
    if conf.fault_injection_spec:
        faults.inject("device.get")
    parts: List[torch.Tensor] = []
    for c in batch.columns:
        _column_parts(c, parts)
    parts.extend(_bytes_of(e) for e in extra)
    parts.append(_bytes_of(batch.num_rows.to(torch.int64).reshape(1)))
    buf = metrics.to_host(torch.cat(parts)).numpy()
    n = int(buf[-8:].view(np.int64)[0])
    off = 0

    def take(dtype: np.dtype, count: int) -> np.ndarray:
        nonlocal off
        arr = buf[off:off + count * dtype.itemsize].view(dtype)
        off += count * dtype.itemsize
        return arr

    cols = [_host_column(c, f.dtype, n, take)
            for f, c in zip(batch.schema, batch.columns)]
    extras = [take(_np_dtype(e), e.numel()).reshape(tuple(e.shape))
              for e in extra]
    hb = HostBatch(batch.schema, cols, n)
    if conf.monitor_enabled:
        monitor.count_copy("ffi", host_batch_nbytes(hb))
    return hb, extras


def to_host(batch: ColumnBatch) -> HostBatch:
    """Live rows of `batch` on the host, in one device->host copy."""
    return to_host_with(batch)[0]


def host_batch_nbytes(hb: HostBatch) -> int:
    """Host footprint of a pulled batch."""
    return sum(_host_nbytes(c) for c in hb.cols)


def _host_nbytes(c: _HostCol) -> int:
    total = sum(arr.nbytes for arr in (c.data, c.validity, c.lengths,
                                       c.codes, c.offsets)
                if arr is not None)
    if c.child is not None:
        total += _host_nbytes(c.child)
    return total + sum(_host_nbytes(ch) for ch in c.children or ())


def serialize_batch(batch: ColumnBatch) -> bytes:
    return to_host(batch).serialize()


def serialize_slice(hb: HostBatch, lo: int, hi: int) -> bytes:
    """Row-range frame, through the C++ encoder of the native library
    where it loads and covers the columns, as the JAX package's does: the
    same payload bytes, compressed by the same libzstd as the wheel-less
    codec's. The encoder predates the dict colblock, so string columns
    take the Python encoder while dict encoding is on."""
    dict_strings = conf.dict_encode_strings and any(
        c.kind in ("str", "dict") for c in hb.cols)
    if native.available() and not dict_strings and \
            all(c.kind in ("num", "str", "null") for c in hb.cols):
        t0 = time.perf_counter_ns()
        if conf.fault_injection_spec:
            faults.inject("serde.encode")
        frame = native.serialize_host_batch(hb, lo, hi, conf.zstd_level)
        (raw_len,) = struct.unpack_from("<I", frame, 4)
        ns = time.perf_counter_ns() - t0
        metrics.bump(metrics.SERDE_NS, "encode", ns)
        metrics.bump(metrics.SERDE_BYTES, "raw", raw_len)
        metrics.bump(metrics.SERDE_BYTES, "frames", len(frame))
        if conf.monitor_enabled:
            monitor.count_copy("serde", raw_len, moved=len(frame))
            monitor.count_time("serde_encode", ns)
        return frame
    return hb.serialize(lo, hi)


def write_batch(fp: BinaryIO, batch: ColumnBatch) -> int:
    buf = serialize_batch(batch)
    fp.write(buf)
    return len(buf)


def _read_exact(fp: BinaryIO, n: int) -> bytes:
    b = fp.read(n)
    if len(b) != n:
        raise EOFError("truncated batch frame")
    return b


def _decode_payload(raw: bytes, schema: Schema) -> HostBatch:
    bio = io.BytesIO(raw)
    n, ncols = struct.unpack("<IH", _read_exact(bio, 6))
    if ncols != len(schema.fields):
        raise ValueError(f"frame has {ncols} columns, the schema "
                         f"{len(schema.fields)}")
    return HostBatch(schema, [_decode_col_host(bio, f.dtype, n)
                              for f in schema], n)


def _read_dict_block(fp: BinaryIO, n: int):
    """A dict colblock's body (after the sentinel) -> (dict (K, w),
    dict_lens int32 (K,), codes int32 (n,))."""
    K, dict_total = struct.unpack("<II", _read_exact(fp, 8))
    dlens = np.frombuffer(_read_exact(fp, 4 * K), np.uint32)
    payload = np.frombuffer(_read_exact(fp, dict_total), np.uint8)
    w = max(int(dlens.max()) if K else 1, 1)
    dmat = np.zeros((K, w), np.uint8)
    if K:
        dmat[np.arange(w)[None, :] < dlens[:, None]] = payload
    codes = np.frombuffer(_read_exact(fp, 4 * n), np.uint32).astype(np.int32)
    if conf.trace_enabled:
        from blaze_tpu_torch.runtime import trace
        trace.event("dict_decode", rows=n, entries=K)
    return dmat, dlens.astype(np.int32), codes


def _decode_col_host(fp: BinaryIO, dtype: DataType, n: int) -> _HostCol:
    (hasv,) = struct.unpack("<B", _read_exact(fp, 1))
    validity = None
    if hasv:
        vb = _read_exact(fp, (n + 7) // 8)
        validity = np.unpackbits(np.frombuffer(vb, np.uint8), count=n,
                                 bitorder="little").astype(bool)
    if dtype.kind == TypeKind.NULL:
        return _HostCol("null", None, validity if validity is not None
                        else np.zeros((n,), bool))
    if dtype.kind in (TypeKind.LIST, TypeKind.MAP):
        (total,) = struct.unpack("<I", _read_exact(fp, 4))
        lens = np.frombuffer(_read_exact(fp, 4 * n), np.uint32)
        offs = np.zeros((n + 1,), np.int64)
        np.cumsum(lens, out=offs[1:])
        child = _decode_col_host(fp, storage_element(dtype), total)
        return _HostCol("list", None, validity, offsets=offs, child=child)
    if dtype.kind == TypeKind.STRUCT or dtype.wide_decimal:
        return _HostCol("struct", None, validity, children=[
            _decode_col_host(fp, f.dtype, n) for f in struct_fields(dtype)])
    if dtype.is_string_like:
        (total,) = struct.unpack("<I", _read_exact(fp, 4))
        if total == DICT_SENTINEL:
            dmat, dlens, codes = _read_dict_block(fp, n)
            return _HostCol("dict", dmat, validity, dlens, codes)
        lens = np.frombuffer(_read_exact(fp, 4 * n), np.uint32)
        payload = np.frombuffer(_read_exact(fp, total), np.uint8)
        w = max(int(lens.max()) if n else 1, 1)
        mat = np.zeros((n, w), np.uint8)
        if n:
            mat[np.arange(w)[None, :] < lens[:, None]] = payload
        return _HostCol("str", mat, validity, lens.astype(np.int32))
    if dtype.kind == TypeKind.BOOLEAN:
        raw = np.frombuffer(_read_exact(fp, n), np.uint8).astype(bool)
        return _HostCol("num", raw, validity)
    npdt = np.dtype(dtype.np_dtype())
    raw = np.frombuffer(_read_exact(fp, npdt.itemsize * n), npdt)
    return _HostCol("num", raw, validity)


def frame_header(head: bytes) -> Tuple[int, int]:
    """(raw_len, comp_len) of a frame's 12-byte header; ValueError if it is
    not one. The one parser of the header: runtime/artifacts.py walks and
    verifies frames through it."""
    if len(head) != 12 or head[:4] != MAGIC:
        raise ValueError("bad batch frame header")
    return struct.unpack("<II", head[4:])


def frame_headers(fp: BinaryIO) -> Iterator[Tuple[int, int]]:
    """(raw_len, comp_len) of each frame of a stream, seeking past the
    bodies: a stream's payload and compressed sizes without decoding."""
    while head := fp.read(12):
        raw_len, comp_len = frame_header(head)
        fp.seek(comp_len, io.SEEK_CUR)
        yield raw_len, comp_len


def _decode_frame(comp, raw_len: int, comp_len: int, schema: Schema, dctx,
                  t0: int) -> HostBatch:
    """Decompress and decode one frame; its decode window opened at `t0`,
    before the caller's fault point and frame read, as the JAX package's
    does (an injected stall and the read are real decode time)."""
    raw = (dctx or _zstd().ZstdDecompressor()).decompress(
        comp, max_output_size=raw_len)
    if conf.monitor_enabled:
        monitor.count_copy("serde", raw_len, moved=12 + comp_len)
    hb = _decode_payload(raw, schema)
    ns = time.perf_counter_ns() - t0
    metrics.bump(metrics.SERDE_NS, "decode", ns)
    if conf.monitor_enabled:
        monitor.count_time("serde_decode", ns)
    return hb


def deserialize_batch_host(buf, schema: Schema) -> HostBatch:
    """Decode one frame held in memory (bytes or a memoryview) to host
    columns."""
    t0 = time.perf_counter_ns()
    if conf.fault_injection_spec:
        faults.inject("serde.decode")
    mv = memoryview(buf)
    if len(mv) == 0:
        raise ValueError("empty batch frame")
    raw_len, comp_len = frame_header(bytes(mv[:12]))
    return _decode_frame(mv[12:12 + comp_len], raw_len, comp_len, schema,
                         None, t0)


def read_batch_host(fp: BinaryIO, schema: Schema,
                    dctx=None) -> Optional[HostBatch]:
    """Read one frame to host columns; None at clean EOF. `dctx` lets a
    stream reader reuse one decompressor across frames."""
    t0 = time.perf_counter_ns()
    if conf.fault_injection_spec:
        faults.inject("serde.decode")
    head = fp.read(12)
    if not head:
        return None
    raw_len, comp_len = frame_header(head)
    return _decode_frame(_read_exact(fp, comp_len), raw_len, comp_len,
                         schema, dctx, t0)


def read_batches_host(fp: BinaryIO, schema: Schema) -> Iterator[HostBatch]:
    dctx = _zstd().ZstdDecompressor()
    while True:
        hb = read_batch_host(fp, schema, dctx=dctx)
        if hb is None:
            return
        yield hb


def deserialize_batch(buf, schema: Schema, capacity: Optional[int] = None,
                      device: DeviceLike = None) -> ColumnBatch:
    """One frame -> a batch on `device` (None: the CUDA card)."""
    from blaze_tpu_torch.ops.host_sort import upload

    return upload(deserialize_batch_host(buf, schema), capacity, device)


def read_batch(fp: BinaryIO, schema: Schema, capacity: Optional[int] = None,
               dctx=None, device: DeviceLike = None
               ) -> Optional[ColumnBatch]:
    """Read one frame onto `device`; None at clean EOF."""
    from blaze_tpu_torch.ops.host_sort import upload

    hb = read_batch_host(fp, schema, dctx)
    return None if hb is None else upload(hb, capacity, device)


def read_batches(fp: BinaryIO, schema: Schema,
                 device: DeviceLike = None) -> Iterator[ColumnBatch]:
    dctx = _zstd().ZstdDecompressor()
    while True:
        b = read_batch(fp, schema, dctx=dctx, device=device)
        if b is None:
            return
        yield b
