"""Shared operator utilities: batch concatenation and slicing.

Port of `concat_batches` and `slice_batch` from blaze_tpu/ops/common.py
(ref: concat_batches in datafusion-ext-commons lib.rs:33-61) for every
column kind the port's batches hold. String columns of different width
buckets are padded to the widest first, and dictionary columns come out
expanded, as in the JAX package. A list column's elements concatenate
the same way one level down, into an element storage of the bucket of
their total; a struct's children, and a wide decimal's two limb planes,
concatenate row-aligned.
`adaptive_target_bytes` sizes the IPC reader's macro-batches, and
`adaptive_batch_rows` (over `schema_row_bytes`) the Parquet scan's.

The JAX versions run as one jitted program per (schema, shapes) so as to
pay one dispatch instead of one per column on a remote-attached chip;
here the same gathers run eagerly.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, ListData, StringData, StructData, bucket_capacity,
)
from blaze_tpu_torch.columnar.types import (
    Schema, TypeKind, storage_element, struct_fields,
)
from blaze_tpu_torch.exprs import strings as S
from blaze_tpu_torch.runtime.metrics import to_host


def _cat_rows(tensors, counts, pad: int) -> torch.Tensor:
    """The first counts[i] rows of each tensor, then `pad` zero rows."""
    out = [t[:n] for t, n in zip(tensors, counts)]
    if pad:
        out.append(tensors[0].new_zeros((pad,) + tuple(tensors[0].shape[1:])))
    return torch.cat(out)


def concat_batches(batches: List[ColumnBatch],
                   schema: Optional[Schema] = None) -> ColumnBatch:
    """Concatenate the live rows of several batches into one, in order.

    Materialization point: the row counts come to the host in one pull
    (the JAX package reads them one batch at a time), because the output
    capacity depends on their total; a list column pulls its parts'
    element counts too, one pull a nesting level. Padding rows are zeros
    (empty lists)."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    schema = schema or batches[0].schema
    counts = to_host(torch.stack([b.num_rows for b in batches])).tolist()
    total = sum(counts)
    cap = bucket_capacity(total)
    cols = [_concat_column([b.columns[ci] for b in batches], counts,
                           cap - total, field.dtype)
            for ci, field in enumerate(schema.fields)]
    return ColumnBatch(schema, cols,
                       torch.tensor(total, dtype=torch.int32,
                                    device=batches[0].device), cap)


def _concat_column(parts: List[Column], counts: List[int], pad: int,
                   dtype) -> Column:
    """The first counts[i] rows of each part, then `pad` zero rows."""
    valid = None
    if any(p.validity is not None for p in parts):
        valid = _cat_rows([p.valid_mask() for p in parts], counts, pad)
    if parts[0].is_struct:
        kids = [_concat_column([p.data.children[i] for p in parts], counts,
                               pad, f.dtype)
                for i, f in enumerate(struct_fields(dtype))]
        return Column(dtype, StructData(kids), valid)
    if parts[0].is_list:
        # the element ranges of rows [0, n) start at 0 (ListData's
        # offsets[0] is 0 wherever the port builds one)
        ends = to_host(torch.stack([p.data.offsets[n].to(torch.int64)
                                    for p, n in zip(parts, counts)]))
        ecounts = ends.tolist()
        etotal = sum(ecounts)
        elems = _concat_column([p.data.elements for p in parts], ecounts,
                               bucket_capacity(etotal) - etotal,
                               storage_element(dtype))
        offs, base = [parts[0].data.offsets.new_zeros(1)], 0
        for p, n, e in zip(parts, counts, ecounts):
            offs.append(p.data.offsets[1:n + 1] + base)
            base += e
        offs.append(offs[0].new_full((pad,), base))
        return Column(dtype, ListData(torch.cat(offs), elems), valid)
    if parts[0].is_string:
        w = max(p.data.width for p in parts)
        datas = [S.ensure_width(StringData(p.data.bytes, p.data.lengths), w)
                 for p in parts]
        data = StringData(_cat_rows([d.bytes for d in datas], counts, pad),
                          _cat_rows([d.lengths for d in datas], counts, pad))
    else:
        data = _cat_rows([p.data for p in parts], counts, pad)
    return Column(dtype, data, valid)


def schema_row_bytes(schema: Schema) -> int:
    """Rough per-row device bytes (validity + typical string width), the
    JAX package's estimate for every kind, held ones or not."""
    total = 0
    for f in schema.fields:
        total += _field_row_bytes(f.dtype) + 1
    return max(total, 1)


def _field_row_bytes(dtype) -> int:
    k = dtype.kind
    if k in (TypeKind.STRING, TypeKind.BINARY):
        return 36  # 32-byte width bucket guess + lengths
    if k in (TypeKind.LIST, TypeKind.MAP):
        return 64
    if dtype.wide_decimal:
        return 16  # two int64 limb planes
    if k == TypeKind.STRUCT:
        return sum(_field_row_bytes(f.dtype) + 1 for f in dtype.fields)
    return dtype.byte_width()


def adaptive_target_bytes(manager=None) -> int:
    """Macro-batch byte target: conf.target_batch_bytes clamped so that one
    batch stays well inside the memory budget; a small budget (spill
    tests) gets small bounded batches back. A query session degraded by
    the resilience ladder (rung 1 halves the target) clamps further via
    its own override, so one query's degradation never shrinks another's
    batches."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import memory as M
    from blaze_tpu_torch.runtime import supervisor as sup_mod

    mgr = manager or M.get_manager()
    target = conf.target_batch_bytes
    sess = sup_mod.current_session()
    if sess is not None and sess.batch_target:
        target = min(target, sess.batch_target)
    return max(min(target, mgr.total // 8), 1 << 18)


def adaptive_batch_rows(schema: Schema, manager=None) -> int:
    """Source batch row target for macro-batching: the byte target over
    the row estimate, clamped to [conf.batch_size, conf.max_batch_rows]
    and rounded down to a power of two (so capacities stay few)."""
    from blaze_tpu_torch.config import conf

    rows = adaptive_target_bytes(manager) // schema_row_bytes(schema)
    rows = max(conf.batch_size, min(int(rows), conf.max_batch_rows))
    return 1 << (max(int(rows), 1).bit_length() - 1)


def slice_batch(batch: ColumnBatch, start: int, count: int) -> ColumnBatch:
    """Live rows [start, start+count) into a fresh batch of capacity
    bucket_capacity(count); no host pull (the row count stays on the
    device)."""
    cap = bucket_capacity(count)
    idx = torch.arange(cap, dtype=torch.int64, device=batch.device) + start
    n = (batch.num_rows - start).clamp(0, count)
    return batch.take(idx.clamp(0, batch.capacity - 1), n)
