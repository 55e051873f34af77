"""Arrow <-> device batch conversion.

Port of blaze_tpu/columnar/arrow_io.py (ref: the JVM<->native Arrow
boundary, ArrowFFIStreamImportIterator / ArrowFFIExportIterator and the
FFI stream export in blaze/src/rt.rs:76-80) for the column kinds the
port's batches hold: bool, the int kinds, f32/f64, date, timestamp,
decimal with precision <= 18 (unscaled int64) and above it (two int64
limb planes: the 16-byte little-endian Arrow value is the (lo, hi) word
pair, columnar/int128.py), and string, large_string,
binary, large_binary and dictionary-of-string columns, which become
fixed-width byte matrices (`StringData`). Validity comes from the Arrow
bitmap, and sliced arrays (a non-zero offset) are honoured.

A null-free fixed-width column is viewed in place (`np.frombuffer` over
the Arrow data buffer) and uploaded in one copy to the requested device;
only a batch shorter than its capacity bucket pays a host copy for the
padding. Every other column goes through pyarrow's fill_null and one
upload.

List, large_list, map and struct columns convert recursively: a list's
offsets (rebased to 0) go up as int32 and its values become the element
column, with a capacity of their bucket; a map is a list of its
(key, value) entry structs; a struct's fields become its children, each
carrying the struct's nulls too (`StructArray.flatten`). The JAX package
takes lists in and lists out.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, ListData, StringData, StructData, _column_to_host,
    bucket_capacity, bucket_width, strings_to_host,
)
from blaze_tpu_torch.device import DeviceLike, resolve_device

_ARROW_TO_KIND = {
    pa.types.is_boolean: T.BOOLEAN,
    pa.types.is_int8: T.INT8,
    pa.types.is_int16: T.INT16,
    pa.types.is_int32: T.INT32,
    pa.types.is_int64: T.INT64,
    pa.types.is_float32: T.FLOAT32,
    pa.types.is_float64: T.FLOAT64,
    pa.types.is_date32: T.DATE,
    pa.types.is_null: T.NULL,
}


def dtype_from_arrow(at: pa.DataType) -> T.DataType:
    for pred, dt in _ARROW_TO_KIND.items():
        if pred(at):
            return dt
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.STRING
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return T.BINARY
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_decimal(at):
        return T.decimal(at.precision, at.scale)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return T.list_of(dtype_from_arrow(at.value_type))
    if pa.types.is_map(at):
        return T.map_of(dtype_from_arrow(at.key_type),
                        dtype_from_arrow(at.item_type))
    if pa.types.is_struct(at):
        return T.struct_of(T.Field(f.name, dtype_from_arrow(f.type),
                                   f.nullable) for f in at)
    if pa.types.is_dictionary(at):
        return dtype_from_arrow(at.value_type)
    raise TypeError(f"unsupported arrow type {at}")


def dtype_to_arrow(dt: T.DataType) -> pa.DataType:
    k = T.TypeKind
    m = {
        k.NULL: pa.null(), k.BOOLEAN: pa.bool_(), k.INT8: pa.int8(),
        k.INT16: pa.int16(), k.INT32: pa.int32(), k.INT64: pa.int64(),
        k.FLOAT32: pa.float32(), k.FLOAT64: pa.float64(),
        k.STRING: pa.string(), k.BINARY: pa.binary(), k.DATE: pa.date32(),
        k.TIMESTAMP: pa.timestamp("us"),
    }
    if dt.kind in m:
        return m[dt.kind]
    if dt.kind == k.DECIMAL:
        return pa.decimal128(dt.precision, dt.scale)
    if dt.kind == k.LIST:
        return pa.list_(dtype_to_arrow(dt.element))
    if dt.kind == k.MAP:
        return pa.map_(dtype_to_arrow(dt.key), dtype_to_arrow(dt.element))
    if dt.kind == k.STRUCT:
        return pa.struct([pa.field(f.name, dtype_to_arrow(f.dtype),
                                   f.nullable) for f in dt.fields])
    raise TypeError(f"unsupported dtype {dt}")


def schema_from_arrow(s: pa.Schema) -> T.Schema:
    return T.Schema([T.Field(f.name, dtype_from_arrow(f.type), f.nullable)
                     for f in s])


def schema_to_arrow(s: T.Schema) -> pa.Schema:
    return pa.schema([pa.field(f.name, dtype_to_arrow(f.dtype), f.nullable)
                      for f in s])


_ZC_KINDS = {
    T.TypeKind.INT8: pa.int8(), T.TypeKind.INT16: pa.int16(),
    T.TypeKind.INT32: pa.int32(), T.TypeKind.INT64: pa.int64(),
    T.TypeKind.FLOAT32: pa.float32(), T.TypeKind.FLOAT64: pa.float64(),
    T.TypeKind.DATE: pa.date32(),
}


def _upload(host: np.ndarray, cap: int, dev: torch.device) -> torch.Tensor:
    """One host->device copy of `host`, zero-padded to `cap`. A read-only
    view of an Arrow buffer is uploaded as it is when it already fills the
    capacity and the device is not the host; otherwise it is copied into a
    fresh padded array first (the CPU route never aliases Arrow memory)."""
    n = host.shape[0]
    if n == cap and dev.type != "cpu":
        with warnings.catch_warnings():
            # the tensor only feeds the copy to the device, nothing writes it
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(host).to(dev)
    full = np.zeros((cap,), host.dtype)
    full[:n] = host
    return torch.from_numpy(full).to(dev)


def _numeric_zero_copy(arr: pa.Array, dtype: T.DataType, cap: int,
                       dev: torch.device) -> Optional[Column]:
    """Null-free fixed-width column: the Arrow data buffer viewed in place
    at its offset and uploaded in one copy; None when it does not apply."""
    at = _ZC_KINDS.get(dtype.kind)
    if at is None or arr.type != at or arr.null_count != 0:
        return None
    buf = arr.buffers()[1]
    if buf is None:
        return None
    npd = dtype.np_dtype()
    view = np.frombuffer(buf, npd, count=len(arr),
                         offset=arr.offset * npd.itemsize)
    return Column(dtype, _upload(view, cap, dev), None)


def _varbin_to_fixed(arr: pa.Array, cap: int, min_width: int = 0):
    """Variable-length binary Arrow array -> (cap, W) uint8 matrix and
    int32 lengths, W the bucket of the longest value. The values between
    the first and the last offset are contiguous, so one boolean-mask
    assignment places them row by row."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    arr = arr.cast(pa.large_binary())
    n = len(arr)
    offsets = np.frombuffer(arr.buffers()[1], np.int64, count=n + 1,
                            offset=arr.offset * 8)
    databuf = arr.buffers()[2]
    data = (np.frombuffer(databuf, np.uint8) if databuf is not None
            else np.zeros(0, np.uint8))
    lengths = np.zeros((cap,), np.int32)
    lengths[:n] = offsets[1:] - offsets[:-1]
    width = bucket_width(max(int(lengths.max()) if n else 0, min_width, 1))
    mat = np.zeros((cap, width), np.uint8)
    if n:
        mat[np.arange(width)[None, :] < lengths[:, None]] = \
            data[offsets[0]:offsets[n]]
    return mat, lengths


def column_from_arrow(arr, dtype: T.DataType, cap: int,
                      device: DeviceLike = None) -> Column:
    """One Arrow array (or chunked array) as a column of capacity `cap` on
    `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    n = len(arr)
    if dtype.is_nested:
        return _nested_from_arrow(arr, dtype, cap, dev)
    if dtype.kind == T.TypeKind.NULL:
        return Column(dtype, torch.zeros((cap,), dtype=dtype.torch_dtype(),
                                         device=dev),
                      torch.zeros((cap,), dtype=torch.bool, device=dev))
    fast = _numeric_zero_copy(arr, dtype, cap, dev)
    if fast is not None:
        return fast
    validity = None
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
        validity = _upload(valid, cap, dev)
    if dtype.is_string_like:
        mat, lens = _varbin_to_fixed(arr, cap)
        if validity is not None:
            # null rows are zeroed on the host (the batch invariant)
            mat[:n][~valid] = 0
            lens[:n][~valid] = 0
        return Column(dtype, StringData(torch.from_numpy(mat).to(dev),
                                        torch.from_numpy(lens).to(dev)),
                      validity)
    if dtype.is_decimal:
        d = arr.cast(pa.decimal128(dtype.precision, dtype.scale)
                     ).fill_null(0)
        # decimal128 is 16-byte little-endian two's complement: the low
        # int64 word is the unscaled value for precision <= 18
        words = np.frombuffer(d.buffers()[1], np.int64, count=2 * n,
                              offset=d.offset * 16)
        if dtype.wide_decimal:
            # the (lo, hi) word pairs are the two limb planes
            hi, lo = (Column(T.INT64, _upload(np.ascontiguousarray(w), cap,
                                              dev))
                      for w in (words[1::2], words[0::2]))
            return Column(dtype, StructData([hi, lo]),
                          validity).normalized()
        vals = words[0::2]
    elif dtype.kind == T.TypeKind.TIMESTAMP:
        vals = np.asarray(arr.cast(pa.timestamp("us")).fill_null(0),
                          np.int64)
    elif dtype.kind == T.TypeKind.BOOLEAN:
        vals = np.asarray(arr.fill_null(False))
    else:
        vals = np.asarray(arr.fill_null(0)).astype(dtype.np_dtype())
    vals = np.ascontiguousarray(vals, dtype.np_dtype())
    return Column(dtype, _upload(vals, cap, dev), validity).normalized()


def _nested_from_arrow(arr: pa.Array, dtype: T.DataType, cap: int,
                       dev: torch.device) -> Column:
    n = len(arr)
    validity = (_upload(np.asarray(arr.is_valid()), cap, dev)
                if arr.null_count else None)
    if dtype.kind == T.TypeKind.STRUCT:
        kids = [column_from_arrow(a, f.dtype, cap, dev)
                for a, f in zip(arr.flatten(), dtype.fields)]
        return Column(dtype, StructData(kids), validity)
    # list, large_list and map: offsets with the array's slice applied,
    # the values between the first and the last offset
    offs = np.asarray(arr.offsets, np.int64)
    flat = arr.values.slice(int(offs[0]), int(offs[-1] - offs[0]))
    offsets = np.full((cap + 1,), offs[-1] - offs[0], np.int32)
    offsets[:n + 1] = offs - offs[0]
    elems = column_from_arrow(flat, T.storage_element(dtype),
                              bucket_capacity(len(flat)), dev)
    return Column(dtype, ListData(torch.from_numpy(offsets).to(dev), elems),
                  validity)


def batch_from_arrow(rb: pa.RecordBatch, capacity: Optional[int] = None,
                     schema: Optional[T.Schema] = None,
                     device: DeviceLike = None) -> ColumnBatch:
    """An Arrow RecordBatch as a batch on `device` (None: the CUDA card):
    one upload a column."""
    schema = schema or schema_from_arrow(rb.schema)
    dev = resolve_device(device)
    cap = capacity or bucket_capacity(rb.num_rows)
    cols = [column_from_arrow(rb.column(i), f.dtype, cap, dev)
            for i, f in enumerate(schema)]
    return ColumnBatch(schema, cols,
                       torch.tensor(rb.num_rows, dtype=torch.int32,
                                    device=dev), cap)


def _validity_bitmap(valid: np.ndarray) -> pa.Buffer:
    return pa.py_buffer(np.packbits(valid, bitorder="little").tobytes())


def _decimal_array(at: pa.DataType, n: int, words: np.ndarray,
                   valid: np.ndarray) -> pa.Array:
    """A decimal128 array from its (n, 2) int64 (lo, hi) words."""
    bitmap = None if valid.all() else _validity_bitmap(valid)
    return pa.Array.from_buffers(
        at, n, [bitmap, pa.py_buffer(np.ascontiguousarray(
            words, np.int64).tobytes())],
        null_count=int(n - valid.sum()))


def batch_to_arrow(batch: ColumnBatch) -> pa.RecordBatch:
    """The live rows of `batch` as an Arrow RecordBatch (one device->host
    copy a column)."""
    from blaze_tpu_torch.runtime.metrics import to_host

    n = int(to_host(batch.num_rows))
    arrays: List[pa.Array] = []
    for f, c in zip(batch.schema, batch.columns):
        valid = to_host(c.valid_mask()[:n]).numpy()
        at = dtype_to_arrow(f.dtype)
        if f.dtype.is_nested:
            # lists, dicts and tuples, as to_numpy gives them
            arrays.append(pa.array(_column_to_host(c, n), at))
            continue
        if c.is_string:
            vals = strings_to_host(c, n, valid)
            if f.dtype.kind == T.TypeKind.STRING:
                vals = [None if v is None else v.decode("utf-8", "replace")
                        for v in vals]
            arrays.append(pa.array(vals, at))
            continue
        if f.dtype.wide_decimal:
            # the planes as 16-byte little-endian (lo, hi) word pairs
            hi, lo = (to_host(ch.data[:n]).numpy()
                      for ch in c.data.children)
            words = np.stack([np.where(valid, lo, 0),
                              np.where(valid, hi, 0)], axis=1)
            arrays.append(_decimal_array(at, n, words, valid))
            continue
        d = to_host(c.data[:n]).numpy()
        if f.dtype.kind == T.TypeKind.NULL:
            arrays.append(pa.nulls(n))
        elif f.dtype.is_decimal:
            # unscaled int64 -> 16-byte two's complement (sign-extended)
            d = np.where(valid, d, 0).astype(np.int64)
            arrays.append(_decimal_array(at, n, np.stack([d, d >> 63],
                                                         axis=1), valid))
        else:
            arrays.append(pa.array(d, type=at,
                                   mask=None if valid.all() else ~valid))
    return pa.RecordBatch.from_arrays(arrays,
                                      schema=schema_to_arrow(batch.schema))
