"""Host-side (numpy) row-encoded sort keys, run merge, and host batches.

Port of blaze_tpu/ops/host_sort.py for the dense, wide-decimal and string
column kinds (plain and dictionary); host batches also concatenate and
upload list and struct columns, and take structs. Spilled sort
runs live in host files as serde frames, so their k-way merge runs on the
host, as the reference's LoserTree over spilled cursors does
(datafusion-ext-commons loser_tree.rs:1-118, sort_exec.rs:419-475), and
each merged macro-batch is uploaded once. IpcReaderExec coalesces decoded
shuffle frames into macro-batches here too (`host_concat`, one upload).

Keys are ONE memcmp-comparable byte string per row: each sort column adds
big-endian bytes whose unsigned byte order is the requested
(asc, nulls_first) Spark order, and the concatenation is viewed as a
fixed-width `S` column that numpy compares with memcmp.

float64 keys are exact IEEE total order (NaN greatest, -0.0 == 0.0), as
the port's device sort (ops/sort_keys.py) orders them. The JAX package
compares f64 at double-double resolution when its device sorts that way
(`_device_sorts_f64_exact` false on the TPU, which has no 64-bit bitcast);
CUDA has the bitcast, so that branch is gone here.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from blaze_tpu_torch.columnar import int128 as i128
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, DictData, ListData, StringData, StructData,
    bucket_capacity, bucket_dict_rows, bucket_width, has_list,
)
from blaze_tpu_torch.columnar.serde import HostBatch, _HostCol
# one count serves both names: the JAX package's host_nbytes and
# host_batch_nbytes differ only on string and dictionary columns
from blaze_tpu_torch.columnar.serde import host_batch_nbytes as host_nbytes
from blaze_tpu_torch.columnar.types import (
    Schema, TypeKind, storage_element, struct_fields,
)
from blaze_tpu_torch.device import DeviceLike, resolve_device
from blaze_tpu_torch.ops.sort_keys import DEFAULT_MAX_STRING_WORDS, SortSpec

_I64_MIN = np.int64(-(1 << 63))
_I32_MIN = np.uint32(1 << 31)


def _be(a: np.ndarray) -> np.ndarray:
    """(n,) unsigned -> (n, itemsize) uint8, big-endian."""
    k = a.dtype.itemsize
    return np.ascontiguousarray(
        a.astype(a.dtype.newbyteorder(">"))).view(np.uint8).reshape(-1, k)


def _f64_total_order(x: np.ndarray) -> np.ndarray:
    x = np.where(np.isnan(x), np.float64(np.nan), x)
    x = np.where(x == 0.0, np.float64(0.0), x)
    u = x.view(np.uint64)
    neg = (u >> np.uint64(63)) != 0
    return np.where(neg, ~u, u ^ np.uint64(1 << 63))


def _f32_total_order(x: np.ndarray) -> np.ndarray:
    x = np.where(np.isnan(x), np.float32(np.nan), x)
    x = np.where(x == np.float32(0.0), np.float32(0.0), x)
    u = x.view(np.uint32)
    neg = (u >> np.uint32(31)) != 0
    return np.where(neg, ~u, u ^ _I32_MIN)


def _value_parts(c: _HostCol, kind: TypeKind, wide: bool
                 ) -> List[np.ndarray]:
    """Big-endian byte planes whose concatenated order is the ascending
    value order (ops/sort_keys.encode_column, case by case)."""
    if kind == TypeKind.NULL:
        return []
    if wide:
        # the signed hi plane, then the lo plane read unsigned
        hi, lo = (ch.data.astype(np.int64) for ch in c.children)
        return [_be((hi ^ _I64_MIN).view(np.uint64)),
                _be(lo.view(np.uint64))]
    if kind in (TypeKind.STRING, TypeKind.BINARY):
        # the device key's 8-word prefix, then the length
        w = DEFAULT_MAX_STRING_WORDS * 8
        if c.kind == "dict":
            # the prefix plane of the K entries, gathered by code
            dp = np.zeros((c.data.shape[0], w), np.uint8)
            dp[:, :min(w, c.data.shape[1])] = c.data[:, :w]
            return [dp[c.codes], _be(c.lengths[c.codes].astype(np.uint32))]
        prefix = np.zeros((c.data.shape[0], w), np.uint8)
        prefix[:, :min(w, c.data.shape[1])] = c.data[:, :w]
        return [prefix, _be(c.lengths.astype(np.uint32))]
    if kind == TypeKind.BOOLEAN:
        return [c.data.astype(np.uint8).reshape(-1, 1)]
    if kind == TypeKind.FLOAT64:
        return [_be(_f64_total_order(c.data.astype(np.float64)))]
    if kind == TypeKind.FLOAT32:
        return [_be(_f32_total_order(c.data.astype(np.float32)))]
    if kind in (TypeKind.INT64, TypeKind.TIMESTAMP, TypeKind.DECIMAL):
        x = c.data.astype(np.int64)
        return [_be((x ^ _I64_MIN).view(np.uint64))]
    # int8/16/32/date: any self-consistent width gives the same order
    x = c.data.astype(np.int32)
    return [_be(x.view(np.uint32) ^ _I32_MIN)]


def encode_keys(hb: HostBatch, specs: Sequence[SortSpec]) -> np.ndarray:
    """(n,) `S`-bytes array whose memcmp order is the requested order.
    Host batches hold live rows only, so there is no liveness plane."""
    n = hb.num_rows
    planes: List[np.ndarray] = []
    for spec in specs:
        c = hb.cols[spec.col]
        f = hb.schema.fields[spec.col]
        # the flag plane follows the FIELD's nullability, not whether this
        # frame carried a validity array: keys of every frame of a column
        # must share one byte width or the merge compares misaligned planes
        if f.nullable:
            valid = (c.validity if c.validity is not None
                     else np.ones((n,), bool))
            first = spec.nulls_first
            flag = np.where(valid, np.uint8(1 if first else 0),
                            np.uint8(0 if first else 1))
            planes.append(flag.reshape(-1, 1))
        else:
            valid = None
        for p in _value_parts(c, f.dtype.kind, f.dtype.wide_decimal):
            if valid is not None:
                p = np.where(valid[:, None], p, np.uint8(0))
            planes.append(p if spec.asc else ~p)
    if not planes:
        return np.zeros((n,), "S1")
    mat = np.ascontiguousarray(np.concatenate(planes, axis=1))
    return mat.view(f"S{mat.shape[1]}").reshape(-1)


def sort_perm(hb: HostBatch, specs: Sequence[SortSpec]) -> np.ndarray:
    return np.argsort(encode_keys(hb, specs), kind="stable")


# ---------------------------------------------------------------------------
# host batch manipulation (take / concat / device upload)
# ---------------------------------------------------------------------------

def host_supported(schema: Schema) -> bool:
    """Whether the host sort, merge and take hold every column: all kinds
    but lists and maps at any depth, whose rows are not sliceable one by
    one here (as in the JAX package)."""
    return not any(has_list(f.dtype) for f in schema.fields)


def _col_take(c: _HostCol, idx: np.ndarray) -> _HostCol:
    v = c.validity[idx] if c.validity is not None else None
    if c.kind == "struct":
        return _HostCol("struct", None, v,
                        children=[_col_take(ch, idx) for ch in c.children])
    if c.kind == "dict":
        # codes only; the dictionary is shared
        return _HostCol("dict", c.data, v, c.lengths, c.codes[idx])
    if c.kind == "str":
        return _HostCol("str", c.data[idx], v, c.lengths[idx])
    return _HostCol(c.kind, None if c.data is None else c.data[idx], v)


def host_take(hb: HostBatch, idx: np.ndarray) -> HostBatch:
    return HostBatch(hb.schema, [_col_take(c, idx) for c in hb.cols],
                     len(idx))


def _widen(m: np.ndarray, w: int) -> np.ndarray:
    if m.shape[1] >= w:
        return m
    out = np.zeros((m.shape[0], w), np.uint8)
    out[:, :m.shape[1]] = m
    return out


def _dict_expand(c: _HostCol) -> _HostCol:
    """A dict host column in the plain (n, W) layout."""
    if c.kind != "dict":
        return c
    return _HostCol("str", c.data[c.codes], c.validity, c.lengths[c.codes])


def _string_concat(parts: List[_HostCol], rows: List[int],
                   v: Optional[np.ndarray]) -> _HostCol:
    """The JAX package's rule: all-dictionary parts merge their
    dictionaries by offsetting codes (part 0's entry 0 keeps code 0 the
    empty string) while the merged dictionary has at most max(rows, 8)
    entries; otherwise every part expands to the plain layout."""
    entries = sum(p.data.shape[0] for p in parts if p.kind == "dict")
    if all(p.kind == "dict" for p in parts) and entries <= max(sum(rows), 8):
        w = max(p.data.shape[1] for p in parts)
        codes, base = [], 0
        for p in parts:
            codes.append(p.codes + np.int32(base))
            base += p.data.shape[0]
        return _HostCol("dict",
                        np.concatenate([_widen(p.data, w) for p in parts]),
                        v, np.concatenate([p.lengths for p in parts]),
                        np.concatenate(codes))
    parts = [_dict_expand(p) for p in parts]
    w = max(p.data.shape[1] for p in parts)
    return _HostCol("str", np.concatenate([_widen(p.data, w) for p in parts]),
                    v, np.concatenate([p.lengths for p in parts]))


def _col_concat(parts: List[_HostCol], rows: List[int]) -> _HostCol:
    if any(p.validity is not None for p in parts):
        v = np.concatenate([p.validity if p.validity is not None
                            else np.ones((n,), bool)
                            for p, n in zip(parts, rows)])
    else:
        v = None
    if parts[0].kind == "null":
        return _HostCol("null", None, v)
    if parts[0].kind in ("str", "dict"):
        return _string_concat(parts, rows, v)
    if parts[0].kind == "struct":
        return _HostCol("struct", None, v, children=[
            _col_concat([p.children[i] for p in parts], rows)
            for i in range(len(parts[0].children))])
    if parts[0].kind == "list":
        ends = [int(p.offsets[-1]) for p in parts]
        bases = np.cumsum([0] + ends[:-1])
        offs = np.concatenate([np.zeros(1, np.int64)] + [
            p.offsets[1:] + b for p, b in zip(parts, bases)])
        return _HostCol("list", None, v, offsets=offs, child=_col_concat(
            [p.child for p in parts], ends))
    return _HostCol("num", np.concatenate([p.data for p in parts]), v)


def host_concat(parts: List[HostBatch]) -> HostBatch:
    if len(parts) == 1:
        return parts[0]
    rows = [p.num_rows for p in parts]
    cols = [_col_concat([p.cols[i] for p in parts], rows)
            for i in range(len(parts[0].schema.fields))]
    return HostBatch(parts[0].schema, cols, sum(rows))


def _layout(c: _HostCol, dtype, n: int, cap: int, alloc) -> tuple:
    """The parts of a column of capacity `cap` in the upload buffer:
    (column, dtype, rows, capacity, part ids, validity id or None, child
    layouts)."""
    kids = []
    if c.kind == "dict":
        K = c.data.shape[0]
        w = bucket_width(max(int(c.lengths.max()) if K else 1, 1))
        kcap = bucket_dict_rows(max(K, 1))
        ids = [alloc(np.int32, (cap,)), alloc(np.uint8, (kcap, w)),
               alloc(np.int32, (kcap,))]
    elif c.kind == "str":
        w = bucket_width(max(int(c.lengths.max()) if n else 1, 1))
        ids = [alloc(np.uint8, (cap, w)), alloc(np.int32, (cap,))]
    elif c.kind == "list":
        ids = [alloc(np.int32, (cap + 1,))]
        ne = int(c.offsets[n])
        kids = [_layout(c.child, storage_element(dtype), ne,
                        bucket_capacity(ne), alloc)]
    elif c.kind == "struct":
        ids = []
        kids = [_layout(ch, f.dtype, n, cap, alloc)
                for ch, f in zip(c.children, struct_fields(dtype))]
    elif c.kind == "null":
        ids = []
    else:
        ids = [alloc(dtype.np_dtype(), (cap,))]
    vid = (alloc(np.bool_, (cap,))
           if c.kind == "null" or c.validity is not None else None)
    return c, dtype, n, cap, ids, vid, kids


def _fill(lay: tuple, host) -> None:
    """Rows [0, n) of a column into its parts of the host buffer. Invalid
    rows of dense and string columns are zeroed (the batch invariant; a
    dictionary row's code 0 is the empty string)."""
    c, _, n, _, ids, vid, kids = lay
    rows = []
    if c.kind == "dict":
        K = c.data.shape[0]
        rows = [host(ids[0])[:n]]
        rows[0][:] = c.codes
        db = host(ids[1])
        cw = min(db.shape[1], c.data.shape[1])
        db[:K, :cw] = c.data[:, :cw]
        host(ids[2])[:K] = c.lengths
    elif c.kind == "str":
        rows = [host(ids[0])[:n], host(ids[1])[:n]]
        cw = min(rows[0].shape[1], c.data.shape[1])
        rows[0][:, :cw] = c.data[:, :cw]
        rows[1][:] = c.lengths
    elif c.kind == "list":
        offs = host(ids[0])
        offs[:n + 1] = c.offsets[:n + 1]
        offs[n + 1:] = c.offsets[n]
    elif c.kind == "num":
        rows = [host(ids[0])[:n]]
        rows[0][:] = c.data
    if vid is not None:
        host(vid)[:n] = c.validity if c.validity is not None else False
        for r in rows:
            r[~c.validity] = 0
    for k in kids:
        _fill(k, host)


def _build(lay: tuple, view) -> Column:
    c, dtype, _, cap, ids, vid, kids = lay
    valid = None if vid is None else view(vid, torch.bool)
    if c.kind == "dict":
        data = DictData(view(ids[0], torch.int32), view(ids[1], torch.uint8),
                        view(ids[2], torch.int32))
    elif c.kind == "str":
        data = StringData(view(ids[0], torch.uint8),
                          view(ids[1], torch.int32))
    elif c.kind == "list":
        data = ListData(view(ids[0], torch.int32),
                        _build(kids[0], view))
    elif c.kind == "struct":
        data = StructData([_build(k, view) for k in kids])
        if dtype.wide_decimal:
            # the planes carry no validity of their own to zero them
            return Column(dtype, data, valid).normalized()
    elif c.kind == "null":
        data = torch.zeros((cap,), dtype=torch.int8,
                           device=valid.device)
    else:
        data = view(ids[0], dtype.torch_dtype())
    return Column(dtype, data, valid)


def host_to_device(hb: HostBatch, capacity: Optional[int] = None,
                   device: DeviceLike = None) -> ColumnBatch:
    """`upload`, its host bytes counted at the monitor's ffi boundary."""
    from blaze_tpu_torch.config import conf

    if conf.monitor_enabled:
        from blaze_tpu_torch.runtime import monitor

        monitor.count_copy("ffi", host_nbytes(hb))
    return upload(hb, capacity, device)


def upload(hb: HostBatch, capacity: Optional[int] = None,
           device: DeviceLike = None) -> ColumnBatch:
    """A host batch onto `device` (None: the CUDA card) in ONE host->device
    copy: every column and validity is laid out, padded to the capacity,
    in one byte buffer, uploaded, and viewed back per column. Invalid
    slots are zeroed first (the batch invariant). A string column's width
    is the bucket of its longest row; a dictionary keeps its entries in a
    `bucket_dict_rows` table; a list's elements take the bucket of their
    count. The copy is a plain blocking one: `non_blocking` from unpinned
    numpy memory may read the buffer after it is freed. Uncounted by the
    monitor: serde's device decode calls it, a frame the JAX package
    decodes straight onto the device and counts at the serde boundary
    alone."""
    from blaze_tpu_torch.config import conf

    if conf.fault_injection_spec:
        from blaze_tpu_torch.runtime import faults

        faults.inject("device.put")
    dev = resolve_device(device)
    n = hb.num_rows
    cap = capacity or bucket_capacity(n)
    # (offset, np dtype, shape) of each part; offsets are 8-byte aligned
    views: list = []
    size = 0

    def alloc(t, shape) -> int:
        nonlocal size
        t = np.dtype(t)
        views.append((size, t, shape))
        size += -(-int(np.prod(shape)) * t.itemsize // 8) * 8
        return len(views) - 1

    lays = [_layout(c, f.dtype, n, cap, alloc)
            for f, c in zip(hb.schema.fields, hb.cols)]
    buf = np.zeros((size,), np.uint8)

    def host(i):
        off, t, shape = views[i]
        return buf[off:off + int(np.prod(shape)) * t.itemsize].view(
            t).reshape(shape)

    for lay in lays:
        _fill(lay, host)
    flat = torch.from_numpy(buf).to(dev)

    def view(i, tdt):
        off, t, shape = views[i]
        return flat[off:off + int(np.prod(shape)) * t.itemsize].view(
            tdt).reshape(shape)

    cols = [_build(lay, view) for lay in lays]
    return ColumnBatch(hb.schema, cols,
                       torch.tensor(n, dtype=torch.int32, device=dev), cap)


def _pylike(c: _HostCol, dtype, n: int):
    """Rows [0, n) of a host column as `ColumnBatch.to_numpy` gives them."""
    valid = c.validity if c.validity is not None else np.ones((n,), bool)
    if c.kind == "null":
        return np.full((n,), None, object)
    if dtype.wide_decimal:
        hi, lo = (ch.data[:n].astype(np.int64) for ch in c.children)
        return [v if ok else None
                for v, ok in zip(i128.ints_from_np(hi, lo), valid)]
    if c.kind in ("str", "dict"):
        c = _dict_expand(c)
        return [bytes(c.data[i, :c.lengths[i]]) if valid[i] else None
                for i in range(n)]
    if c.kind == "list":
        offs = c.offsets
        elems = _pylike(c.child, storage_element(dtype), int(offs[n]))
        pack = dict if dtype.kind == TypeKind.MAP else list
        return [pack(elems[offs[i]:offs[i + 1]]) if valid[i] else None
                for i in range(n)]
    if c.kind == "struct":
        kids = [_pylike(ch, f.dtype, n)
                for ch, f in zip(c.children, dtype.fields)]
        return [tuple(k[i] for k in kids) if valid[i] else None
                for i in range(n)]
    d = np.asarray(c.data[:n]).astype(dtype.np_dtype(), copy=False)
    if valid.all():
        return d
    o = d.astype(object)
    o[~valid] = None
    return o


def host_to_pylike(hb: HostBatch) -> dict:
    """`ColumnBatch.to_numpy()`'s dict from a host batch: numpy per field,
    an object array with None for nulls where a column has any, strings
    as a list of bytes or None, lists, maps and structs as lists, dicts
    and tuples. The ordered collect hands it to the driver without a
    second device pull."""
    return {f.name: _pylike(c, f.dtype, hb.num_rows)
            for f, c in zip(hb.schema.fields, hb.cols)}


# ---------------------------------------------------------------------------
# k-way merge of sorted spill runs
# ---------------------------------------------------------------------------

def merge_sorted_host(frame_iters: List[Iterator[HostBatch]],
                      specs: Sequence[SortSpec],
                      emit_bytes: int) -> Iterator[HostBatch]:
    """Merge k sorted runs of host frames into sorted HostBatches.

    Pool-and-sort rounds, all numpy (the LoserTree's role): each round loads
    the next frame of every run whose loaded rows were consumed, sorts the
    pool (memcmp row keys, one stable argsort), and emits every row <= the
    smallest loaded frontier among active runs: no unread row can sort
    below an active run's frontier. Rows whose whole keys tie are not kept
    in input order when the ties span frames of several runs (a round
    emits its ties before a run's unread ones, and carried rows come
    before new ones); the JAX package merges the same way, and Spark
    leaves the order of ties open. The working set stays O(k x frame)
    rows (the spill writer sizes frames against the memory budget);
    rounds past `emit_bytes` emit in chunks of about that size."""
    k = len(frame_iters)
    iters = [iter(it) for it in frame_iters]
    need_load = [True] * k
    exhausted = [False] * k
    frontier: List[Optional[bytes]] = [None] * k
    carry_hb: Optional[HostBatch] = None
    carry_keys: Optional[np.ndarray] = None

    while True:
        pieces: List[HostBatch] = []
        piece_keys: List[np.ndarray] = []
        for r in range(k):
            if exhausted[r] or not need_load[r]:
                continue
            # pull until a NON-empty frame (or exhaustion): an empty frame
            # must not clear this run's frontier for the round, or rows
            # could emit out of order
            while True:
                hb = next(iters[r], None)
                if hb is None:
                    exhausted[r] = True
                    frontier[r] = None
                    break
                if hb.num_rows:
                    keys = encode_keys(hb, specs)
                    pieces.append(hb)
                    piece_keys.append(keys)
                    frontier[r] = keys[-1]
                    need_load[r] = False
                    break
        hbs = ([carry_hb] if carry_hb is not None else []) + pieces
        if not hbs:
            if all(exhausted):
                return
            continue
        keys = np.concatenate(
            ([carry_keys] if carry_keys is not None else []) + piece_keys)
        pooled = host_concat(hbs) if len(hbs) > 1 else hbs[0]
        order = np.argsort(keys, kind="stable")
        keys_sorted = keys[order]
        active = [f for r, f in enumerate(frontier) if not exhausted[r]
                  and f is not None]
        if active:
            bound = min(active)
            cut = int(np.searchsorted(keys_sorted, bound, side="right"))
        else:
            cut = len(keys_sorted)
        if cut:
            row_b = max(host_nbytes(pooled) // max(pooled.num_rows, 1), 1)
            step = max(int(emit_bytes // row_b), 1)
            for lo in range(0, cut, step):
                yield host_take(pooled, order[lo:min(lo + step, cut)])
        if cut < len(keys_sorted):
            carry_hb = host_take(pooled, order[cut:])
            carry_keys = keys_sorted[cut:]
        else:
            carry_hb, carry_keys = None, None
        for r in range(k):
            if exhausted[r] or frontier[r] is None:
                continue
            if not active or frontier[r] <= bound:
                need_load[r] = True  # its loaded rows are all emitted
