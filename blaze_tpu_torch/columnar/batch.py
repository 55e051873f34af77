"""Device-resident columnar batches with static (bucketed) shapes.

Port of blaze_tpu/columnar/batch.py for every column kind it holds: dense
(numeric, boolean, date, timestamp, compact decimal), wide decimal,
string/binary and nested (list, map, struct). A batch is:

  * a static `capacity` (bucketed power of two),
  * a `num_rows` 0-d int32 tensor on the batch's device: rows
    [0, num_rows) are live, the rest padding (a tensor, not a Python int,
    so that compaction and the whole-stage path never wait on the host),
  * one `Column` per field: dense tensor + optional bool validity tensor;
    strings/binary are fixed-width uint8 matrices (capacity, W) + int32
    lengths (`StringData`), or int32 codes into a small dictionary of that
    form (`DictData`), with W bucketed as well; a list is int32 offsets
    (capacity + 1) into a flat element column with its own (bucketed)
    capacity (`ListData`), a map the list of its (key, value) structs,
    and a struct one row-aligned child column per field (`StructData`);
    a wide decimal (precision > 18) is a `StructData` of two int64 limb
    planes, hi and lo (types.wide_decimal_storage, columnar/int128.py).

Invariants ops may rely on (the same as the JAX package's):
  * invalid slots among LIVE rows contain the dtype's zero (see
    `Column.normalized`); string bytes past a row's length are zero;
  * padding rows (>= num_rows) have UNSPECIFIED content — any op that
    reduces or sorts full-capacity tensors MUST mask with `row_mask()`;
  * `validity is None` means all live rows valid;
  * list and struct columns are not normalized: a null list row may hold
    elements, and a struct's validity is its own level's, beside its
    children's.

The device is fixed where a batch is made (`from_numpy`,
`from_host_arrays`, `empty`): `device=None` means CUDA, and construction
raises when there is none. Everything downstream follows the tensors.
"""

from __future__ import annotations

import dataclasses
import decimal
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from blaze_tpu_torch.columnar import int128 as i128
from blaze_tpu_torch.columnar.types import (
    INT64, DataType, Schema, TypeKind, storage_element,
)
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike, resolve_device


def bucket_capacity(n: int) -> int:
    """Round row count up to a power-of-two capacity bucket."""
    cap = max(int(conf.min_capacity), 1)
    while cap < n:
        cap <<= 1
    return cap


def bucket_width(w: int) -> int:
    """Round string byte-width up to a power-of-two bucket (min 4).

    Raises beyond conf.max_string_width: a single huge value would
    otherwise inflate the whole (capacity, width) matrix."""
    b = max(int(conf.min_string_width), 4)
    while b < w:
        b <<= 1
    if b > conf.max_string_width:
        raise ValueError(
            f"string width {w} (bucket {b}) exceeds max_string_width="
            f"{conf.max_string_width}")
    return b


def bucket_dict_rows(k: int) -> int:
    """Round a dictionary's entry count up to a power-of-two bucket (min
    8): dictionaries are small, so they get their own bucket ladder."""
    cap = 8
    while cap < k:
        cap <<= 1
    return cap


@dataclasses.dataclass
class StringData:
    """Fixed-width string/binary storage: (capacity, width) uint8 + int32
    lengths. Bytes past a row's length are zero."""

    bytes: torch.Tensor    # uint8 (capacity, width)
    lengths: torch.Tensor  # int32 (capacity,)

    @property
    def capacity(self) -> int:
        return self.bytes.shape[0]

    @property
    def width(self) -> int:
        return self.bytes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lengths.device


@dataclasses.dataclass
class DictData:
    """Dictionary-encoded string/binary storage: per-row int32 codes into a
    small (dict_capacity, width) uint8 dictionary.

    Entry 0 is always the empty string (all-zero row, length 0):
    `Column.normalized` nulls a row by pointing its code at 0. `bytes` and
    `lengths` expand to the `StringData` layout by a gather, so hashing,
    comparison and sort keys work on the encoded form as they are."""

    codes: torch.Tensor         # int32 (capacity,)
    dict_bytes: torch.Tensor    # uint8 (dict_capacity, width)
    dict_lengths: torch.Tensor  # int32 (dict_capacity,)

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]

    @property
    def width(self) -> int:
        return self.dict_bytes.shape[1]

    @property
    def dict_capacity(self) -> int:
        return self.dict_bytes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def bytes(self) -> torch.Tensor:
        return self.dict_bytes[self.codes.long()]

    @property
    def lengths(self) -> torch.Tensor:
        return self.dict_lengths[self.codes.long()]


@dataclasses.dataclass
class ListData:
    """list<T> storage: row i's elements are [offsets[i], offsets[i+1]) of
    a flat element column, which has its own (bucketed) capacity. Rows
    past num_rows have length 0 where this package builds the column.
    Arrow's offsets and child, with static capacities."""

    offsets: torch.Tensor  # int32 (capacity + 1,), monotone
    elements: "Column"     # flat element column

    @property
    def capacity(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]


@dataclasses.dataclass
class StructData:
    """struct<...> storage: one row-aligned child Column per field. A map
    has no container of its own: it is list<struct<key, value>>
    (types.storage_element), so the list machinery covers maps."""

    children: List["Column"]

    @property
    def capacity(self) -> int:
        return self.children[0].capacity

    @property
    def device(self) -> torch.device:
        return self.children[0].device


@dataclasses.dataclass
class Column:
    dtype: DataType
    data: Union[torch.Tensor, StringData, DictData, ListData, StructData]
    validity: Optional[torch.Tensor] = None  # bool (capacity,); None = all valid

    @property
    def capacity(self) -> int:
        if isinstance(self.data, torch.Tensor):
            return self.data.shape[0]
        return self.data.capacity

    @property
    def is_string(self) -> bool:
        return isinstance(self.data, (StringData, DictData))

    @property
    def is_dict(self) -> bool:
        return isinstance(self.data, DictData)

    @property
    def is_list(self) -> bool:
        return isinstance(self.data, ListData)

    @property
    def is_struct(self) -> bool:
        return isinstance(self.data, StructData)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((self.capacity,), dtype=torch.bool,
                              device=self.device)
        return self.validity

    def normalized(self) -> "Column":
        """Zero out data in invalid slots (canonical form for hash, sort
        and serde). List and struct columns are left as they are, as in
        the JAX package; a wide decimal's two planes are zeroed."""
        if self.validity is None or self.is_list:
            return self
        v = self.validity
        if self.dtype.wide_decimal:
            return Column(self.dtype, StructData(
                [Column(ch.dtype, torch.where(v, ch.data,
                                              torch.zeros_like(ch.data)))
                 for ch in self.data.children]), v)
        if self.is_struct:
            return self
        if self.is_dict:
            # entry 0 is the empty string, so nulling a row rewrites its
            # code; the dictionary stays shared
            d = self.data
            return Column(self.dtype, DictData(
                torch.where(v, d.codes, torch.zeros_like(d.codes)),
                d.dict_bytes, d.dict_lengths), v)
        if self.is_string:
            d = self.data
            return Column(self.dtype, StringData(
                torch.where(v[:, None], d.bytes, torch.zeros_like(d.bytes)),
                torch.where(v, d.lengths, torch.zeros_like(d.lengths))), v)
        return Column(self.dtype,
                      torch.where(self.validity, self.data,
                                  torch.zeros((), dtype=self.data.dtype,
                                              device=self.data.device)),
                      self.validity)

    def take(self, indices: torch.Tensor, *,
             index_valid: Optional[torch.Tensor] = None) -> "Column":
        """Gather rows by index (clamped into the capacity). Rows whose
        `index_valid` is False become null (the outer joins' null
        extension).

        A list column keeps its element capacity: right for permutations
        and subsets (sort, filter, limit); a gather that repeats rows
        (a join's fan-out) sizes its element storage with `take_rows`."""
        idx = indices.clamp(0, self.capacity - 1)
        v = self.validity[idx] if self.validity is not None else None
        if index_valid is not None:
            v = index_valid if v is None else (v & index_valid)
        d = self.data
        if self.is_list:
            data = _list_take(d, idx)
        elif self.is_struct:
            data = StructData([ch.take(idx) for ch in d.children])
        elif self.is_dict:
            # codes only: the column stays encoded through filter, sort,
            # join and limit
            data = DictData(d.codes[idx], d.dict_bytes, d.dict_lengths)
        elif self.is_string:
            data = StringData(d.bytes[idx], d.lengths[idx])
        else:
            data = d[idx]
        return Column(self.dtype, data, v)


@dataclasses.dataclass
class ColumnBatch:
    schema: Schema
    columns: List[Column]
    num_rows: torch.Tensor  # int32 0-d, on the batch's device
    capacity: int           # static

    # ---- construction ----
    @staticmethod
    def empty(schema: Schema, capacity: Optional[int] = None,
              device: DeviceLike = None) -> "ColumnBatch":
        dev = resolve_device(device)
        cap = capacity or bucket_capacity(0)
        cols = [_zero_column(f.dtype, cap, dev) for f in schema]
        return ColumnBatch(schema, cols, _rows(0, dev), cap)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray], schema: Schema,
                   capacity: Optional[int] = None,
                   validity: Optional[Dict[str, np.ndarray]] = None,
                   device: DeviceLike = None) -> "ColumnBatch":
        """numpy (or a list of str/bytes for strings; of lists, dicts or
        tuples for list, map and struct fields) per field -> batch on
        `device` (None = the CUDA card).

        Object arrays holding None mark those rows null, as in the JAX
        package."""
        dev = resolve_device(device)
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity or bucket_capacity(n)
        cols = []
        for f in schema:
            v_np = None if validity is None else validity.get(f.name)
            cols.append(_host_to_column(f.dtype, data[f.name], cap, v_np,
                                        dev))
        return ColumnBatch(schema, cols, _rows(n, dev), cap)

    @staticmethod
    def from_host_arrays(schema: Schema,
                         arrays: Sequence[Tuple[np.ndarray,
                                                Optional[np.ndarray]]],
                         num_rows: int, capacity: int,
                         device: DeviceLike = None) -> "ColumnBatch":
        """Rebuild a batch from full-capacity host arrays, one
        (data, validity|None) pair per field — e.g. the arrays of a
        `blaze_tpu` batch pulled to the host — so that both packages
        compute on the identical batch, padding rows included. A string
        field's data is a (bytes (capacity, W), lengths) pair."""
        dev = resolve_device(device)
        if len(arrays) != len(schema):
            raise ValueError(
                f"{len(arrays)} arrays for a {len(schema)}-field schema")
        cols = []
        for f, (data, valid) in zip(schema, arrays):
            if f.dtype.is_nested or f.dtype.wide_decimal:
                raise TypeError(
                    f"column {f.name}: from_host_arrays takes dense and "
                    "string fields; nested and wide-decimal ones come from "
                    "from_numpy")
            v = None
            if valid is not None:
                v = torch.from_numpy(np.array(valid, bool, copy=True,
                                              order="C")).to(dev)
            if f.dtype.is_string_like:
                b, l = (np.array(a, t, copy=True, order="C")
                        for a, t in zip(data, (np.uint8, np.int32)))
                if b.shape[0] != capacity or l.shape != (capacity,):
                    raise ValueError(
                        f"column {f.name}: shape {b.shape} != "
                        f"({capacity}, W)")
                cols.append(Column(f.dtype, StringData(
                    torch.from_numpy(b).to(dev),
                    torch.from_numpy(l).to(dev)), v))
                continue
            # copies: arrays pulled from another framework may be read-only
            data = np.array(data, f.dtype.np_dtype(), copy=True, order="C")
            if data.shape != (capacity,):
                raise ValueError(
                    f"column {f.name}: shape {data.shape} != ({capacity},)")
            cols.append(Column(f.dtype, torch.from_numpy(data).to(dev), v))
        return ColumnBatch(schema, cols, _rows(num_rows, dev), capacity)

    # ---- views ----
    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def row_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def shape_key(self) -> tuple:
        """Shape signature (capacity, per-column layout and validity)."""
        return (self.capacity,) + tuple(_col_shape_key(c)
                                        for c in self.columns)

    # ---- transforms ----
    def with_columns(self, schema: Schema,
                     columns: Sequence[Column]) -> "ColumnBatch":
        return ColumnBatch(schema, list(columns), self.num_rows, self.capacity)

    def with_num_rows(self, num_rows) -> "ColumnBatch":
        return ColumnBatch(self.schema, self.columns,
                           _rows(num_rows, self.device), self.capacity)

    def normalized(self) -> "ColumnBatch":
        return self.with_columns(self.schema,
                                 [c.normalized() for c in self.columns])

    def take(self, indices: torch.Tensor, num_rows) -> "ColumnBatch":
        # output capacity = len(indices): callers pass bucket-sized index
        # tensors (compact does) to keep capacities on the bucket ladder
        cols = [c.take(indices) for c in self.columns]
        return ColumnBatch(self.schema, cols, _rows(num_rows, self.device),
                           int(indices.shape[0]))

    def compact(self, keep: torch.Tensor) -> "ColumnBatch":
        """Filter: keep rows where `keep & row_mask`, compacted to the front
        in their original order; capacity unchanged. A stable sort on the
        drop flag keeps it free of host synchronisation."""
        mask = keep & self.row_mask()
        n = mask.sum(dtype=torch.int32)
        idx = torch.sort((~mask).to(torch.uint8), stable=True).indices
        return self.take(idx, n)

    # ---- host export (tests, the driver's collect) ----
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Pull live rows to the host: numpy per field, an object array
        with None for nulls where a column has any; strings as a list of
        bytes or None, as the JAX package gives them."""
        # the ordered collect (spark/local_runner.py) orders the rows on
        # the host and caches them here, so the driver does not pull the
        # same rows from the device a second time
        cached = getattr(self, "_host_numpy", None)
        if cached is not None:
            return cached
        n = int(self.num_rows)
        return {f.name: _column_to_host(c, n)
                for f, c in zip(self.schema, self.columns)}


def _column_to_host(c: Column, n: int):
    """The first n rows of a column as `ColumnBatch.to_numpy` gives them:
    lists as lists, maps as dicts, structs as tuples, None where null."""
    valid = c.valid_mask()[:n].cpu().numpy()
    if c.dtype.wide_decimal:
        # the unscaled values as Python ints, as the JAX package gives them
        hi, lo = (ch.data[:n].cpu().numpy() for ch in c.data.children)
        return [v if ok else None
                for v, ok in zip(i128.ints_from_np(hi, lo), valid)]
    if c.is_list:
        offs = c.data.offsets[:n + 1].cpu().numpy()
        elems = _column_to_host(c.data.elements, int(offs[n]) if n else 0)
        pack = dict if c.dtype.kind == TypeKind.MAP else list
        return [pack(elems[offs[i]:offs[i + 1]]) if valid[i] else None
                for i in range(n)]
    if c.is_struct:
        kids = [_column_to_host(ch, n) for ch in c.data.children]
        return [tuple(k[i] for k in kids) if valid[i] else None
                for i in range(n)]
    if c.is_string:
        return strings_to_host(c, n, valid)
    d = c.data[:n].cpu().numpy()
    if valid.all():
        return d
    o = d.astype(object)
    o[~valid] = None
    return o


def _col_shape_key(c: Column) -> tuple:
    if c.is_list:
        return ("l", c.data.elements.capacity,
                _col_shape_key(c.data.elements), c.validity is not None)
    if c.is_struct:
        return ("t", tuple(_col_shape_key(ch) for ch in c.data.children),
                c.validity is not None)
    if c.is_dict:
        return ("d", c.data.width, c.data.dict_capacity,
                c.validity is not None)
    if c.is_string:
        return ("s", c.data.width, c.validity is not None)
    return (str(c.data.dtype), c.validity is not None)


def map_tensors(c: Column, fn) -> Column:
    """`c` with `fn` applied to each of its tensors (data, lengths,
    offsets, validity), children and elements included."""
    d = c.data
    if c.is_list:
        data = ListData(fn(d.offsets), map_tensors(d.elements, fn))
    elif c.is_struct:
        data = StructData([map_tensors(ch, fn) for ch in d.children])
    elif c.is_dict:
        data = DictData(fn(d.codes), fn(d.dict_bytes), fn(d.dict_lengths))
    elif c.is_string:
        data = StringData(fn(d.bytes), fn(d.lengths))
    else:
        data = fn(d)
    return Column(c.dtype, data,
                  None if c.validity is None else fn(c.validity))


def _list_take(ld: ListData, idx: torch.Tensor,
               ecap: Optional[int] = None) -> ListData:
    """Gather list rows: offsets rebuilt from the gathered lengths, the
    referenced element ranges compacted to the front of an element
    storage of capacity `ecap` (default: the input's)."""
    from blaze_tpu_torch.ops.segment import element_rows

    lens = ld.lengths()[idx]
    new_off = torch.cat([lens.new_zeros(1),
                         torch.cumsum(lens, 0, dtype=torch.int32)])
    ecap = ld.elements.capacity if ecap is None else ecap
    _, row, within, live = element_rows(new_off, idx.shape[0], ecap)
    src = ld.offsets[idx[row]].to(torch.int64) + within
    src = torch.where(live, src, torch.zeros_like(src))
    gather = take_rows if ecap != ld.elements.capacity else Column.take
    return ListData(new_off, gather(ld.elements, src))


def has_list(dtype: DataType) -> bool:
    """Whether a column of `dtype` holds list storage at any depth."""
    if dtype.kind in (TypeKind.LIST, TypeKind.MAP):
        return True
    return dtype.kind == TypeKind.STRUCT and any(
        has_list(f.dtype) for f in dtype.fields)


def take_rows(c: Column, indices: torch.Tensor,
              index_valid: Optional[torch.Tensor] = None) -> Column:
    """`Column.take` for a gather that may repeat rows (a join's fan-out):
    a list column's element storage, at any depth, is sized to the
    gathered elements, one host pull of their count a list column. The
    JAX package refuses joins over list columns instead."""
    if not has_list(c.dtype):
        return c.take(indices, index_valid=index_valid)
    from blaze_tpu_torch.runtime.metrics import to_host

    idx = indices.clamp(0, c.capacity - 1)
    v = c.validity[idx] if c.validity is not None else None
    if index_valid is not None:
        v = index_valid if v is None else (v & index_valid)
    if c.is_struct:
        data = StructData([take_rows(ch, idx) for ch in c.data.children])
    else:
        total = int(to_host(c.data.lengths()[idx].sum()))
        data = _list_take(c.data, idx, bucket_capacity(total))
    return Column(c.dtype, data, v)


def strings_to_host(c: Column, n: int, valid: np.ndarray) -> list:
    """The first n rows of a string column as bytes, None where null. A
    dictionary column pulls its codes and the small dictionary, never the
    expanded matrix."""
    d = c.data
    if c.is_dict:
        codes = d.codes[:n].cpu().numpy()
        db = d.dict_bytes.cpu().numpy()
        dl = d.dict_lengths.cpu().numpy()
        return [bytes(db[k, :dl[k]]) if ok else None
                for k, ok in zip(codes, valid)]
    b = d.bytes[:n].cpu().numpy()
    ln = d.lengths[:n].cpu().numpy()
    return [bytes(b[i, :ln[i]]) if valid[i] else None for i in range(n)]


def _zero_column(dtype: DataType, cap: int, dev: torch.device) -> Column:
    if dtype.wide_decimal:
        return Column(dtype, StructData(
            [Column(INT64, torch.zeros((cap,), dtype=torch.int64,
                                       device=dev)) for _ in range(2)]))
    if dtype.is_string_like:
        return Column(dtype, StringData(
            torch.zeros((cap, bucket_width(1)), dtype=torch.uint8,
                        device=dev),
            torch.zeros((cap,), dtype=torch.int32, device=dev)))
    if dtype.kind in (TypeKind.LIST, TypeKind.MAP):
        return Column(dtype, ListData(
            torch.zeros((cap + 1,), dtype=torch.int32, device=dev),
            _zero_column(storage_element(dtype), bucket_capacity(0), dev)))
    if dtype.kind == TypeKind.STRUCT:
        return Column(dtype, StructData(
            [_zero_column(f.dtype, cap, dev) for f in dtype.fields]))
    return Column(dtype, torch.zeros(
        (cap,), dtype=dtype.torch_dtype(), device=dev),
        torch.zeros((cap,), dtype=torch.bool, device=dev)
        if dtype.kind == TypeKind.NULL else None)


def _pad_validity(validity_np, n: int, cap: int, dev: torch.device
                  ) -> Optional[torch.Tensor]:
    if validity_np is None:
        return None
    vp = np.zeros((cap,), bool)
    vp[:n] = np.asarray(validity_np, bool)[:n]
    return torch.from_numpy(vp).to(dev)


def _host_to_column(dtype: DataType, raw, cap: int, validity_np,
                    dev: torch.device) -> Column:
    """Host values of one field -> a column of capacity `cap` (the JAX
    package's `_host_to_column`). A list or map field takes a list of
    lists (of dicts or (key, value) pairs for a map) or None; a struct
    field a list of tuples, dicts or None; a wide decimal field a list of
    Python Decimals, unscaled ints or None."""
    if dtype.wide_decimal:
        return _wide_to_column(dtype, raw, cap, validity_np, dev)
    if dtype.is_string_like:
        return _strings_to_column(dtype, raw, cap, validity_np, dev)
    if dtype.is_nested:
        vals = list(raw)
        if validity_np is None and any(v is None for v in vals):
            validity_np = np.array([v is not None for v in vals], bool)
        n = len(vals)
        if dtype.kind == TypeKind.STRUCT:
            kids = [_host_to_column(
                f.dtype, [None if v is None else v.get(f.name)
                          if isinstance(v, dict) else v[fi] for v in vals],
                cap, None, dev) for fi, f in enumerate(dtype.fields)]
            return Column(dtype, StructData(kids),
                          _pad_validity(validity_np, n, cap, dev))
        if dtype.kind == TypeKind.MAP:
            vals = [[] if v is None else list(v.items())
                    if isinstance(v, dict) else list(v) for v in vals]
        else:
            vals = [[] if v is None else list(v) for v in vals]
        offsets = np.zeros((cap + 1,), np.int32)
        offsets[1:n + 1] = np.cumsum([len(v) for v in vals])
        offsets[n + 1:] = offsets[n]
        flat = [x for v in vals for x in v]
        elems = _host_to_column(storage_element(dtype), flat,
                                bucket_capacity(len(flat)), None, dev)
        return Column(dtype, ListData(torch.from_numpy(offsets).to(dev),
                                      elems),
                      _pad_validity(validity_np, n, cap, dev))
    arr = np.asarray(raw)
    n = arr.shape[0]
    if validity_np is None and arr.dtype == object:
        validity_np = np.array([v is not None for v in arr], bool)
        arr = np.array([v if v is not None else 0 for v in arr])
    out = np.zeros((cap,), dtype.np_dtype())
    out[:n] = arr.astype(dtype.np_dtype())
    return Column(dtype, torch.from_numpy(out).to(dev),
                  _pad_validity(validity_np, n, cap, dev)).normalized()


def _wide_to_column(dtype: DataType, raw, cap: int,
                    validity_np: Optional[np.ndarray],
                    dev: torch.device) -> Column:
    """Decimals (scaled by the type's scale) or unscaled ints -> a
    normalized limb-plane column (the JAX package's wide arm of
    `_host_to_column`)."""
    vals = list(raw)
    if validity_np is None and any(v is None for v in vals):
        validity_np = np.array([v is not None for v in vals], bool)
    ints = [0 if v is None else int(v.scaleb(dtype.scale))
            if isinstance(v, decimal.Decimal) else int(v) for v in vals]
    n = len(ints)
    planes = []
    for p in i128.np_from_ints(ints):
        full = np.zeros((cap,), np.int64)
        full[:n] = p
        planes.append(Column(INT64, torch.from_numpy(full).to(dev)))
    return Column(dtype, StructData(planes),
                  _pad_validity(validity_np, n, cap, dev)).normalized()


def _strings_to_column(dtype: DataType, raw, cap: int,
                       validity_np: Optional[np.ndarray],
                       dev: torch.device) -> Column:
    """A list of str/bytes/None -> a normalized StringData column (the JAX
    package's `_host_to_column` string arm)."""
    raw = list(raw)
    vals = [v.encode() if isinstance(v, str) else bytes(v)
            if v is not None else b"" for v in raw]
    if validity_np is None and any(v is None for v in raw):
        validity_np = np.array([v is not None for v in raw], bool)
    n = len(vals)
    w = bucket_width(max((len(v) for v in vals), default=1) or 1)
    mat = np.zeros((cap, w), np.uint8)
    lens = np.zeros((cap,), np.int32)
    for i, v in enumerate(vals):
        mat[i, :len(v)] = np.frombuffer(v, np.uint8)
        lens[i] = len(v)
    return Column(dtype, StringData(torch.from_numpy(mat).to(dev),
                                    torch.from_numpy(lens).to(dev)),
                  _pad_validity(validity_np, n, cap, dev)).normalized()


def _rows(n, device: torch.device) -> torch.Tensor:
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32)
    return torch.tensor(int(n), dtype=torch.int32, device=device)
