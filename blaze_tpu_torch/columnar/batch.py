"""Device-resident columnar batches with static (bucketed) shapes.

Port of blaze_tpu/columnar/batch.py for dense (numeric, boolean, date,
timestamp, compact decimal) columns. A batch is:

  * a static `capacity` (bucketed power of two),
  * a `num_rows` 0-d int32 tensor on the batch's device: rows
    [0, num_rows) are live, the rest padding (a tensor, not a Python int,
    so that compaction and the whole-stage path never wait on the host),
  * one `Column` per field: dense tensor + optional bool validity tensor.

Invariants ops may rely on (the same as the JAX package's):
  * invalid slots among LIVE rows contain the dtype's zero (see
    `Column.normalized`);
  * padding rows (>= num_rows) have UNSPECIFIED content — any op that
    reduces or sorts full-capacity tensors MUST mask with `row_mask()`;
  * `validity is None` means all live rows valid.

The device is fixed where a batch is made (`from_numpy`,
`from_host_arrays`, `empty`): `device=None` means CUDA, and construction
raises when there is none. Everything downstream follows the tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.columnar.types import DataType, Schema, TypeKind
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike, resolve_device


def bucket_capacity(n: int) -> int:
    """Round row count up to a power-of-two capacity bucket."""
    cap = max(int(conf.min_capacity), 1)
    while cap < n:
        cap <<= 1
    return cap


def require_dense_kind(dtype: DataType, name: str = "") -> None:
    """Raise for a column kind the port's batches cannot hold yet, naming
    the module that will carry it (ROADMAP item 19)."""
    where = None
    if dtype.is_string_like:
        where = "exprs/strings.py"
    elif dtype.is_nested:
        where = "the nested storage of columnar/batch.py"
    elif dtype.wide_decimal:
        where = "columnar/int128.py"
    if where is not None:
        raise NotImplementedError(
            f"{dtype} column {name!r} needs {where}, not yet ported")


@dataclasses.dataclass
class Column:
    dtype: DataType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None  # bool (capacity,); None = all valid

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((self.capacity,), dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    def normalized(self) -> "Column":
        """Zero out data in invalid slots (canonical form)."""
        if self.validity is None:
            return self
        return Column(self.dtype,
                      torch.where(self.validity, self.data,
                                  torch.zeros((), dtype=self.data.dtype,
                                              device=self.data.device)),
                      self.validity)

    def take(self, indices: torch.Tensor, *,
             index_valid: Optional[torch.Tensor] = None) -> "Column":
        """Gather rows by index (clamped into the capacity). Rows whose
        `index_valid` is False become null (the outer joins' null
        extension)."""
        idx = indices.clamp(0, self.capacity - 1)
        v = self.validity[idx] if self.validity is not None else None
        if index_valid is not None:
            v = index_valid if v is None else (v & index_valid)
        return Column(self.dtype, self.data[idx], v)


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
        cols = []
        for f in schema:
            require_dense_kind(f.dtype, f.name)
            cols.append(Column(f.dtype, torch.zeros(
                (cap,), dtype=f.dtype.torch_dtype(), device=dev),
                torch.zeros((cap,), dtype=torch.bool, device=dev)
                if f.dtype.kind == TypeKind.NULL else None))
        return ColumnBatch(schema, cols, _rows(0, dev), cap)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray], schema: Schema,
                   capacity: Optional[int] = None,
                   validity: Optional[Dict[str, np.ndarray]] = None,
                   device: DeviceLike = None) -> "ColumnBatch":
        """numpy per field -> batch on `device` (None = the CUDA card).

        Object arrays holding None mark those rows null, as in the JAX
        package."""
        dev = resolve_device(device)
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity or bucket_capacity(n)
        cols = []
        for f in schema:
            require_dense_kind(f.dtype, f.name)
            arr = np.asarray(data[f.name])
            v_np = None if validity is None else validity.get(f.name)
            if v_np is None and arr.dtype == object:
                v_np = np.array([v is not None for v in arr], bool)
                arr = np.array([v if v is not None else 0 for v in arr])
            out = np.zeros((cap,), f.dtype.np_dtype())
            out[:n] = arr.astype(f.dtype.np_dtype())
            v = None
            if v_np is not None:
                vp = np.zeros((cap,), bool)
                vp[:n] = np.asarray(v_np, bool)[:n]
                v = torch.from_numpy(vp).to(dev)
            cols.append(Column(f.dtype, torch.from_numpy(out).to(dev),
                               v).normalized())
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
        compute on the identical batch, padding rows included."""
        dev = resolve_device(device)
        if len(arrays) != len(schema):
            raise ValueError(
                f"{len(arrays)} arrays for a {len(schema)}-field schema")
        cols = []
        for f, (data, valid) in zip(schema, arrays):
            require_dense_kind(f.dtype, f.name)
            # copies: arrays pulled from another framework may be read-only
            data = np.array(data, f.dtype.np_dtype(), copy=True, order="C")
            if data.shape != (capacity,):
                raise ValueError(
                    f"column {f.name}: shape {data.shape} != ({capacity},)")
            v = None
            if valid is not None:
                v = torch.from_numpy(np.array(valid, bool, copy=True,
                                              order="C")).to(dev)
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
        """Shape signature (capacity, per-column dtype and validity)."""
        parts: list = [self.capacity]
        for c in self.columns:
            parts.append((str(c.data.dtype), c.validity is not None))
        return tuple(parts)

    # ---- transforms ----
    def with_columns(self, schema: Schema,
                     columns: Sequence[Column]) -> "ColumnBatch":
        return ColumnBatch(schema, list(columns), self.num_rows, self.capacity)

    def with_num_rows(self, num_rows) -> "ColumnBatch":
        return ColumnBatch(self.schema, self.columns,
                           _rows(num_rows, self.device), self.capacity)

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
        with None for nulls where a column has any."""
        # the ordered collect (spark/local_runner.py) orders the rows on
        # the host and caches them here, so the driver does not pull the
        # same rows from the device a second time
        cached = getattr(self, "_host_numpy", None)
        if cached is not None:
            return cached
        n = int(self.num_rows)
        out: Dict[str, np.ndarray] = {}
        for f, c in zip(self.schema, self.columns):
            d = c.data[:n].cpu().numpy()
            valid = c.valid_mask()[:n].cpu().numpy()
            if valid.all():
                out[f.name] = d
            else:
                o = d.astype(object)
                o[~valid] = None
                out[f.name] = o
        return out


def _rows(n, device: torch.device) -> torch.Tensor:
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32)
    return torch.tensor(int(n), dtype=torch.int32, device=device)
