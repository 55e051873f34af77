"""Row-based fallback execution of non-native SparkPlan subtrees.

Port of blaze_tpu/spark/fallback.py. The reference's central safety
property is fallback-by-construction: any operator that fails conversion
keeps running on vanilla Spark, and a `ConvertToNativeExec` bridge feeds
its rows into the native engine over an Arrow FFI export iterator (ref
ConvertToNativeBase.scala:59-98, BlazeConverters.scala tryConvert:
224-236). In deployment the JVM executes the fallback subtree; in the
local runner this module *is* the vanilla engine: a small pandas/numpy
row interpreter that executes the NeverConvert subtree on the host and
exports pyarrow RecordBatches to the native FfiReaderExec, which uploads
them to the task's device.

Scalar functions unknown to the device registry (the reason a node usually
falls back) evaluate here through `PYTHON_FNS`, the analog of Spark
evaluating a UDF on the JVM. Shuffle frames read here decode on the host
(`serde.deserialize_batch_host`); nothing round-trips through the card.
"""

from __future__ import annotations

import decimal
import math
import operator
from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import pyarrow as pa

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.spark.plan_model import SparkPlan


class _Pandas:
    """pandas, imported on first use: the rest of the port (the builders,
    `run_plan` of a plan without fallback) imports without it."""

    def __getattr__(self, name):
        import pandas

        return getattr(pandas, name)


pd = _Pandas()

# name -> fn(*numpy_arrays) -> numpy array; the embedding layer registers
# Python implementations of engine-unknown functions here (Spark-side UDFs).
PYTHON_FNS: Dict[str, Callable[..., np.ndarray]] = {}


def register_python_fn(name: str, fn: Callable[..., np.ndarray]) -> None:
    PYTHON_FNS[name.lower()] = fn


# -- default implementations -------------------------------------------------
# The interpreter must never die on a scalar fn the ENGINE would have
# handled natively: a NeverConvert parent (e.g. an inconvertible join
# sibling) drags convertible expressions onto this path with it, so every
# registry fn (exprs/functions.py) gets a numpy/pandas body here. Spark
# null semantics: null in -> null out unless noted (concat_ws, coalesce).


def _rows(*args):
    """Broadcast scalars; yield per-row tuples over object arrays."""
    n = max((len(a) for a in args if isinstance(a, np.ndarray) and a.ndim),
            default=1)
    cols = []
    for a in args:
        if isinstance(a, np.ndarray) and a.ndim and len(a) == n:
            cols.append(a)
        elif isinstance(a, np.ndarray) and a.ndim == 1 and len(a) == 1:
            cols.append(np.full(n, a[0], object))
        else:
            cols.append(np.full(n, a, object))
    return n, cols


def _rowfn(fn):
    """Lift a per-row python fn to arrays; None/NaN args -> null row."""
    def wrapped(*args):
        n, cols = _rows(*args)
        out = np.empty(n, object)
        for i in range(n):
            vals = [c[i] for c in cols]
            if any(pd.isna(v) for v in vals):
                out[i] = None
            else:
                try:
                    out[i] = fn(*vals)
                except Exception:  # noqa: BLE001 - Spark: expr errors -> null
                    out[i] = None
        return out
    return wrapped


def _s(v) -> str:
    return v if isinstance(v, str) else str(v)


def _register_default_fns() -> None:
    import hashlib
    import zlib

    from blaze_tpu_torch.exprs import hostfns

    reg = register_python_fn
    for name, np_fn in [
            ("abs", np.abs), ("sqrt", np.sqrt), ("exp", np.exp),
            ("sin", np.sin), ("cos", np.cos), ("tan", np.tan),
            ("asin", np.arcsin), ("acos", np.arccos), ("atan", np.arctan),
            ("atan2", np.arctan2), ("ln", np.log), ("log", np.log),
            ("log10", np.log10),
            ("log2", np.log2), ("signum", np.sign), ("isnan", np.isnan),
            ("pow", np.power), ("power", np.power)]:
        reg(name, np_fn)
    import math

    reg("ceil", _rowfn(lambda a: int(math.ceil(a))))
    reg("floor", _rowfn(lambda a: int(math.floor(a))))
    # Spark HALF_UP rounding (numpy rounds half-even)
    reg("round", lambda a, d=None: _round_half_up(a, d))
    reg("trunc", _rowfn(lambda a: float(math.trunc(a))))  # numeric, as
    # the native registry's trunc (exprs/functions.py torch.trunc)
    reg("nanvl", lambda a, b: np.where(np.isnan(
        np.asarray(a, np.float64)), b, a))

    def _coalesce(*args):
        n, cols = _rows(*args)
        out = np.full(n, None, object)
        for c in cols:
            mask = pd.isna(out)
            if not mask.any():
                break
            out[mask] = np.asarray(c, object)[mask]
        return out
    reg("coalesce", _coalesce)
    reg("nullif", _rowfn(lambda a, b: None if a == b else a))
    for nm in ("nullifzero", "null_if_zero"):
        reg(nm, _rowfn(lambda a: None if a == 0 else a))

    # strings (Spark 1-based indexing where applicable)
    reg("lower", _rowfn(lambda s: _s(s).lower()))
    reg("upper", _rowfn(lambda s: _s(s).upper()))
    reg("trim", _rowfn(lambda s: _s(s).strip()))
    reg("btrim", _rowfn(lambda s, t=None: _s(s).strip(
        None if t is None else _s(t))))
    reg("ltrim", _rowfn(lambda s: _s(s).lstrip()))
    reg("rtrim", _rowfn(lambda s: _s(s).rstrip()))
    reg("reverse", _rowfn(lambda s: _s(s)[::-1]))
    reg("initcap", _rowfn(lambda s: " ".join(
        w[:1].upper() + w[1:].lower() if w else w
        for w in _s(s).split(" "))))
    for nm in ("length", "char_length", "character_length"):
        reg(nm, _rowfn(lambda s: len(_s(s))))
    reg("bit_length", _rowfn(lambda s: 8 * len(_s(s).encode())))
    reg("octet_length", _rowfn(lambda s: len(_s(s).encode())))
    reg("ascii", _rowfn(lambda s: ord(_s(s)[0]) if _s(s) else 0))
    reg("chr", _rowfn(lambda c: chr(int(c) % 256) if int(c) >= 0 else ""))
    reg("repeat", _rowfn(lambda s, n: _s(s) * max(int(n), 0)))
    reg("replace", _rowfn(lambda s, a, b="": _s(s).replace(_s(a), _s(b))))
    def _translate_map(frm: str, to: str) -> dict:
        m: dict = {}
        for i, f in enumerate(frm):
            m.setdefault(ord(f), to[i] if i < len(to) else None)
        return m  # Spark: FIRST occurrence of a duplicated source wins
    reg("translate", _rowfn(lambda s, frm, to: _s(s).translate(
        _translate_map(_s(frm), _s(to)))))
    reg("left", _rowfn(lambda s, n: _s(s)[:max(int(n), 0)]))
    reg("right", _rowfn(lambda s, n: _s(s)[-int(n):] if int(n) > 0 else ""))
    reg("lpad", _rowfn(lambda s, n, p=" ": _lpad(_s(s), int(n), _s(p))))
    reg("rpad", _rowfn(lambda s, n, p=" ": _rpad(_s(s), int(n), _s(p))))
    reg("string_space", _rowfn(lambda n: " " * max(int(n), 0)))
    reg("substr", _rowfn(lambda s, pos, ln=None: _substr(
        _s(s), int(pos), None if ln is None else int(ln))))
    reg("substring", PYTHON_FNS["substr"])
    for nm in ("strpos", "position", "instr"):
        reg(nm, _rowfn(lambda s, sub: _s(s).find(_s(sub)) + 1))
    reg("split_part", _rowfn(lambda s, d, n: _split_part(
        _s(s), _s(d), int(n))))
    reg("concat", _rowfn(lambda *parts: "".join(_s(p) for p in parts)))

    def _concat_ws(sep, *args):
        n, cols = _rows(sep, *args)
        out = np.empty(n, object)
        for i in range(n):
            sp = cols[0][i]
            if pd.isna(sp):
                out[i] = None
                continue
            parts = [_s(c[i]) for c in cols[1:] if not pd.isna(c[i])]
            out[i] = _s(sp).join(parts)
        return out
    reg("concat_ws", _concat_ws)
    reg("hex", _rowfn(_hex_value))
    reg("to_hex", PYTHON_FNS["hex"])

    # digests (hostfns.DIGESTS is the engine-side table)
    for nm, (_, fn) in hostfns.DIGESTS.items():
        reg(nm, _rowfn(lambda s, fn=fn: fn(
            s if isinstance(s, bytes) else _s(s).encode()).decode()))
    def _sha2(s, bits):
        if int(bits) not in (0, 224, 256, 384, 512):
            return None  # Spark: null for unsupported bit lengths
        return hashlib.new(
            f"sha{int(bits) or 256}",
            s if isinstance(s, bytes) else _s(s).encode()).hexdigest()
    reg("sha2", _rowfn(_sha2))
    reg("crc32", _rowfn(lambda s: zlib.crc32(
        s if isinstance(s, bytes) else _s(s).encode()) & 0xFFFFFFFF))

    # JSON (hostfns implements the Spark path semantics)
    reg("get_json_object", _rowfn(lambda s, p: _json_path(s, p)))
    reg("get_parsed_json_object", PYTHON_FNS["get_json_object"])
    reg("parse_json", _rowfn(lambda s: _validate_json(s)))

    # collections
    def _make_array(*args):
        n, cols = _rows(*args)
        out = np.empty(n, object)
        for i in range(n):
            out[i] = [c[i] for c in cols]
        return out
    reg("make_array", _make_array)

    # dates (fallback frames carry datetime64/date objects)
    reg("year", _rowfn(lambda d: pd.Timestamp(d).year))
    reg("month", _rowfn(lambda d: pd.Timestamp(d).month))
    for nm in ("day", "dayofmonth"):
        reg(nm, _rowfn(lambda d: pd.Timestamp(d).day))
    reg("dayofweek", _rowfn(lambda d: (pd.Timestamp(d).dayofweek + 1) % 7
                            + 1))
    reg("date_add", _rowfn(lambda d, n: (pd.Timestamp(d)
                                         + pd.Timedelta(days=int(n))).date()))
    reg("date_sub", _rowfn(lambda d, n: (pd.Timestamp(d)
                                         - pd.Timedelta(days=int(n))).date()))
    reg("datediff", _rowfn(lambda a, b: (pd.Timestamp(a)
                                         - pd.Timestamp(b)).days))

    # hashes (Spark murmur3, seed 42, per-column fold — exprs/hash.py is
    # the device twin; golden values shared via tests/test_hash.py)
    def _hash_one(v, dt, h: int) -> int:
        if dt is not None and dt.kind in "iu" and dt.itemsize <= 4:
            narrow_int = True
        else:
            narrow_int = isinstance(v, (np.int8, np.int16, np.int32))
        if isinstance(v, np.float32) or (dt is not None and dt == np.float32):
            f = np.float32(0.0) if v == 0.0 else np.float32(v)
            return _mm3_int(int(f.view(np.int32)), h)
        if isinstance(v, (float, np.floating)):
            f = np.float64(0.0) if v == 0.0 else np.float64(v)
            return _mm3_long(int(f.view(np.int64)), h)
        if isinstance(v, (bool, np.bool_)):
            return _mm3_int(int(v), h)
        if isinstance(v, (int, np.integer)):
            return _mm3_int(int(v), h) if narrow_int \
                else _mm3_long(int(v), h)
        return _mm3_bytes(v if isinstance(v, bytes) else _s(v).encode(), h)

    def _murmur3(*args):
        n, cols = _rows(*args)
        dts = [a.dtype if isinstance(a, np.ndarray)
               and a.dtype != object else None for a in args]
        dts += [None] * (len(cols) - len(dts))
        out = np.empty(n, np.int32)
        for i in range(n):
            h = 42
            for c, dt in zip(cols, dts):
                v = c[i]
                if not pd.isna(v):
                    h = _hash_one(v, dt, h)
            out[i] = np.int32(np.uint32(h & 0xFFFFFFFF))
        return out
    for nm in ("hash", "murmur3_hash"):
        reg(nm, _murmur3)


_M = 0xFFFFFFFF


def _mm3_mix_k1(k1: int) -> int:
    k1 = (k1 * 0xCC9E2D51) & _M
    k1 = ((k1 << 15) | (k1 >> 17)) & _M
    return (k1 * 0x1B873593) & _M


def _mm3_mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & _M
    return (h1 * 5 + 0xE6546B64) & _M


def _mm3_fmix(h1: int, length: int) -> int:
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M
    return h1 ^ (h1 >> 16)


def _mm3_int(v: int, seed: int) -> int:
    return _mm3_fmix(_mm3_mix_h1(seed & _M, _mm3_mix_k1(v & _M)), 4)


def _mm3_long(v: int, seed: int) -> int:
    h1 = _mm3_mix_h1(seed & _M, _mm3_mix_k1(v & _M))
    h1 = _mm3_mix_h1(h1, _mm3_mix_k1((v >> 32) & _M))
    return _mm3_fmix(h1, 8)


def _mm3_bytes(b: bytes, seed: int) -> int:
    """Spark hashUnsafeBytes: 4-byte little-endian words, then per-byte
    tail as SIGNED ints (matches exprs/hash.py hash_bytes)."""
    h1 = seed & _M
    n4 = len(b) // 4 * 4
    for i in range(0, n4, 4):
        w = int.from_bytes(b[i:i + 4], "little")
        h1 = _mm3_mix_h1(h1, _mm3_mix_k1(w))
    for i in range(n4, len(b)):
        sb = b[i] - 256 if b[i] >= 128 else b[i]
        h1 = _mm3_mix_h1(h1, _mm3_mix_k1(sb & _M))
    return _mm3_fmix(h1, len(b))


def _round_half_up(a, d):
    """Spark Round on doubles: BigDecimal.valueOf(d).setScale(s, HALF_UP).
    BigDecimal.valueOf goes through Double.toString (shortest repr), which
    Python's repr matches — so decimal.Decimal(repr(x)) reproduces the JVM
    result on boundary values like round(2.675, 2) where float math does
    not (2.675 is stored as 2.67499...95, but its shortest repr is
    "2.675", which HALF_UP rounds to 2.68)."""
    av = np.asarray(a, np.float64)
    nd = int(np.asarray(d).reshape(-1)[0]) if d is not None else 0
    q = decimal.Decimal(1).scaleb(-nd)

    def one(x):
        if not math.isfinite(x):
            return x
        # java BigDecimal.setScale has unbounded precision; the default
        # 28-digit context raises InvalidOperation for |x| >= ~1e26.
        # 400 covers the full double range (1e308) at any target scale.
        # (localcontext(prec=...) kwargs need 3.11+; set it on the copy.)
        with decimal.localcontext() as ctx:
            ctx.prec = 400
            return float(decimal.Decimal(repr(x)).quantize(
                q, rounding=decimal.ROUND_HALF_UP))

    return np.asarray([one(float(x)) for x in np.ravel(av)],
                      np.float64).reshape(av.shape)


def _lpad(s: str, n: int, p: str) -> str:
    if n <= 0:
        return ""
    if n <= len(s):
        return s[:n]
    if not p:
        return s
    pad = (p * ((n - len(s)) // len(p) + 1))[: n - len(s)]
    return pad + s


def _rpad(s: str, n: int, p: str) -> str:
    if n <= 0:
        return ""
    if n <= len(s):
        return s[:n]
    if not p:
        return s
    pad = (p * ((n - len(s)) // len(p) + 1))[: n - len(s)]
    return s + pad


def _substr(s: str, pos: int, ln) -> str:
    """Spark substringSQL: virtual positions before the string consume
    the length (substr('hello', -10, 3) == '')."""
    if pos > 0:
        start = pos - 1
    elif pos < 0:
        start = len(s) + pos
    else:
        start = 0
    end = len(s) if ln is None else start + max(ln, 0)
    return s[max(start, 0):max(end, 0)]


def _split_part(s: str, d: str, n: int):
    if not d:
        return None
    parts = s.split(d)
    if n == 0 or abs(n) > len(parts):
        return ""
    return parts[n - 1] if n > 0 else parts[n]


def _hex_value(v):
    if isinstance(v, (int, np.integer)):
        return format(int(v) & 0xFFFFFFFFFFFFFFFF, "X")
    b = v if isinstance(v, bytes) else _s(v).encode()
    return b.hex().upper()


def _json_path(s, p):
    from blaze_tpu_torch.exprs import hostfns

    steps = hostfns.parse_json_path(_s(p))
    if steps is None:
        return None
    out = hostfns.get_json_object_row(
        s if isinstance(s, bytes) else _s(s).encode(), steps)
    return None if out is None else out.decode()


def _validate_json(s):
    from blaze_tpu_torch.exprs import hostfns

    out = hostfns.validate_json_row(
        s if isinstance(s, bytes) else _s(s).encode())
    return None if out is None else out.decode()


_register_default_fns()


def export_iterator(plan: SparkPlan, partition: int,
                    num_partitions: int) -> Iterator[pa.RecordBatch]:
    """Execute the subtree for one task partition; yield Arrow batches
    (what the registered ArrowFFIExportIterator yields in the reference).
    The export, its rows and its host time count in `metrics.BRIDGE`."""
    from blaze_tpu_torch.spark.converters import bridge_schema

    yield export_batch(plan, partition, num_partitions, bridge_schema(plan))


def export_batch(plan: SparkPlan, partition: int, num_partitions: int,
                 schema: T.Schema) -> pa.RecordBatch:
    """The subtree's rows for one task partition as one Arrow batch of
    `schema`. Every route onto the row interpreter goes through here, so
    `metrics.BRIDGE` counts each export, its rows and its host time, and
    the monitor its bytes at the fallback boundary (the JAX package counts
    those of export_iterator alone, not a result task's fallback)."""
    import time

    from blaze_tpu_torch.config import conf as _conf
    from blaze_tpu_torch.runtime import metrics

    t0 = time.perf_counter_ns()
    df = _execute(plan, partition, num_partitions)
    rb = _to_arrow(df, schema)
    if _conf.monitor_enabled:
        from blaze_tpu_torch.runtime import monitor

        # the row interpreter's result exported as a fresh Arrow batch
        monitor.count_copy("fallback", rb.nbytes)
    metrics.bump(metrics.BRIDGE, "exports", 1)
    metrics.bump(metrics.BRIDGE, "rows", rb.num_rows)
    metrics.bump(metrics.BRIDGE, "ns", time.perf_counter_ns() - t0)
    return rb


_ARROW_TYPES = {
    T.TypeKind.BOOLEAN: pa.bool_(), T.TypeKind.INT8: pa.int8(),
    T.TypeKind.INT16: pa.int16(), T.TypeKind.INT32: pa.int32(),
    T.TypeKind.INT64: pa.int64(), T.TypeKind.FLOAT32: pa.float32(),
    T.TypeKind.FLOAT64: pa.float64(), T.TypeKind.STRING: pa.string(),
    T.TypeKind.DATE: pa.date32(),
}


def _to_arrow(df: pd.DataFrame, schema: T.Schema) -> pa.RecordBatch:
    arrays = []
    names = []
    for i, f in enumerate(schema.fields):
        col = df.iloc[:, i] if i < df.shape[1] else pd.Series([])
        at = _ARROW_TYPES.get(f.dtype.kind)
        if at is None:  # decimal / timestamp etc.
            arr = pa.array(col.to_numpy())
        else:
            arr = pa.array(col.to_numpy(), type=at, from_pandas=True)
        if isinstance(arr, pa.ChunkedArray):
            # pyarrow hands an empty float column converted to a string
            # type back as a ChunkedArray, which a RecordBatch refuses
            arr = arr.combine_chunks()
        arrays.append(arr)
        names.append(f.name)
    return pa.RecordBatch.from_arrays(arrays, names=names)


# ---- operators ----

def _execute(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    fn = _OPS.get(plan.kind)
    if fn is None:
        raise NotImplementedError(
            f"fallback interpreter has no operator for {plan.kind}")
    return fn(plan, part, nparts)


def _names(plan: SparkPlan) -> List[str]:
    return [f.name for f in plan.schema.fields]


def _op_scan(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    import pyarrow.parquet as pq

    frames = []
    # split work across tasks at file granularity (Spark splits at file/
    # row-group granularity); a stage running N tasks must not read the
    # same file N times
    for i, (path, _part_vals) in enumerate(plan.attrs.get("files", [])):
        if nparts > 1 and i % nparts != part:
            continue
        t = pq.read_table(path, columns=_names(plan))
        frames.append(t.to_pandas())
    if not frames:
        return pd.DataFrame({n: [] for n in _names(plan)})
    return pd.concat(frames, ignore_index=True)


def _op_ipc_reader(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.ops import host_sort
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.shuffle import _call_provider

    source = _call_provider(resources.get(plan.attrs["resource_id"]),
                            ExecContext(partition=part, num_partitions=nparts,
                                        device="cpu"))
    frames = []
    for item in source:
        if isinstance(item, serde.HostBatch):
            # shuffle get_reader_host yields host frames; no device trip
            frames.append(pd.DataFrame(host_sort.host_to_pylike(item)))
        elif hasattr(item, "num_rows") and hasattr(item, "to_numpy"):
            frames.append(pd.DataFrame(item.to_numpy()))  # ColumnBatch
        elif isinstance(item, pa.RecordBatch):
            frames.append(item.to_pandas())
        elif isinstance(item, (bytes, bytearray, memoryview)):
            hb = serde.deserialize_batch_host(bytes(item), plan.schema)
            frames.append(pd.DataFrame(host_sort.host_to_pylike(hb)))
        else:  # file-like segment of serialized frames
            for hb in serde.read_batches_host(item, plan.schema):
                frames.append(pd.DataFrame(host_sort.host_to_pylike(hb)))
    if not frames:
        return pd.DataFrame({n: [] for n in _names(plan)})
    return pd.concat(frames, ignore_index=True)


def _op_filter(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    keep = _eval(plan.attrs["condition"], df)
    keep = pd.Series(keep, index=df.index).fillna(False).astype(bool)
    return df[keep].reset_index(drop=True)


def _op_project(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    out = {}
    for name, e in zip(plan.attrs["names"], plan.attrs["exprs"]):
        v = _eval(e, df)
        out[name] = pd.Series(v, index=df.index) if np.ndim(v) else \
            pd.Series(np.full(len(df), v), index=df.index)
    return pd.DataFrame(out)


def _op_sort(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    return _op_sort_frame(plan, df)


def _op_sort_frame(plan: SparkPlan, df: pd.DataFrame) -> pd.DataFrame:
    keys, ascending = [], []
    tmp = df.copy()
    for i, (e, asc, nulls_first) in enumerate(plan.attrs["orders"]):
        v = pd.Series(np.asarray(_eval(e, df)), index=df.index)
        # per-key null placement: an explicit null-rank column sorted ahead
        # of the key (pandas' na_position is global, not per-key)
        tmp[f"__sortnull_{i}"] = v.isna().astype(int)
        tmp[f"__sortkey_{i}"] = v
        keys += [f"__sortnull_{i}", f"__sortkey_{i}"]
        ascending += [not nulls_first, asc]
    tmp = tmp.sort_values(keys, ascending=ascending, kind="stable")
    out = tmp[df.columns].reset_index(drop=True)
    if plan.attrs.get("fetch"):
        out = out.head(plan.attrs["fetch"])
    return out


def _op_limit(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    return df.head(plan.attrs["limit"]).reset_index(drop=True)


def _op_union(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    return pd.concat([_execute(c, part, nparts) for c in plan.children],
                     ignore_index=True)


def _merge_collected(series, dedup: bool):
    """Flatten collect_list/collect_set state lists group-wise."""
    vals = [x for lst in series for x in (lst or [])]
    if dedup:
        seen, out = set(), []
        for x in vals:
            if x not in seen:
                seen.add(x)
                out.append(x)
        vals = out
    return vals


# the agg state column suffixes of ops/agg.state_fields
_STATE_PARTS = ("sum", "nonempty", "count", "val", "has", "valid", "list")


def _op_agg(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    """Grouped aggregation matching the native agg state contract
    (ops/agg.py state_fields) so a fallback partial agg can feed a native
    final agg across the shuffle and vice versa."""
    df = _execute(plan.children[0], part, nparts)
    mode = plan.attrs["mode"]
    gnames = list(plan.attrs["grouping_names"])
    if mode == "partial":
        for name, g in zip(gnames, plan.attrs["grouping"]):
            df[name] = np.asarray(_eval(g, df))
    else:
        # state-layout input (group cols + state cols BY POSITION, ref
        # NativeAggBase): the original grouping exprs reference pre-shuffle
        # columns that no longer exist — bind positionally instead
        df = df.rename(columns=dict(zip(df.columns[:len(gnames)], gnames)))
        if not len(df):
            # an empty shuffle partition comes back with the reader's
            # SparkPlan columns, which name no agg state: give the
            # state columns the groupby below reads, empty
            from blaze_tpu_torch.ops.agg import AGG_BUF_PREFIX

            for i in range(len(plan.attrs["aggs"])):
                for part in _STATE_PARTS:
                    name = f"{AGG_BUF_PREFIX}.{i}.{part}"
                    if name not in df.columns:
                        df[name] = pd.Series([], dtype=object)
    # GLOBAL aggregate (no grouping): synthesize one constant group —
    # Spark emits exactly one row even over empty input, so guarantee a
    # row exists for the synthetic group
    synthetic = not gnames
    if synthetic:
        gnames = ["__global__"]
        df["__global__"] = np.int32(0)
        # a global FINAL/MERGE over empty state still emits one row
        # (count 0, sum/min/max null); a partial emits none and the
        # final side synthesizes
        if not len(df) and mode != "partial":
            df = _global_identity_rows(plan)

    from blaze_tpu_torch.ops.agg import AGG_BUF_PREFIX

    out_cols: Dict[str, Any] = {}
    grouped = df.groupby(gnames, dropna=False, sort=True)
    gkeys = grouped.size().reset_index()[gnames]
    for n in gnames:
        out_cols[n] = gkeys[n].to_numpy()

    for i, call in enumerate(plan.attrs["aggs"]):
        p = f"{AGG_BUF_PREFIX}.{i}"
        fn = call["fn"]
        if mode == "partial":
            arg = pd.Series(np.asarray(_eval(call["args"][0], df))
                            if call["args"] else np.ones(len(df)),
                            index=df.index)
            g = arg.groupby([df[n] for n in gnames], dropna=False, sort=True)
            if fn == "sum":
                out_cols[f"{p}.sum"] = g.sum().to_numpy()
                out_cols[f"{p}.nonempty"] = (g.count() > 0).to_numpy()
            elif fn == "count":
                out_cols[f"{p}.count"] = g.count().to_numpy()
            elif fn in ("min", "max"):
                v = g.min() if fn == "min" else g.max()
                out_cols[f"{p}.val"] = v.to_numpy()
                out_cols[f"{p}.has"] = (g.count() > 0).to_numpy()
            elif fn == "avg":
                out_cols[f"{p}.sum"] = g.sum().to_numpy()
                out_cols[f"{p}.count"] = g.count().to_numpy()
            elif fn == "first":
                out_cols[f"{p}.val"] = g.apply(
                    lambda s: s.iloc[0] if len(s) else None).to_numpy()
                out_cols[f"{p}.valid"] = g.apply(
                    lambda s: bool(len(s)) and pd.notna(s.iloc[0])
                ).to_numpy()
                out_cols[f"{p}.has"] = (g.size() > 0).to_numpy()
            elif fn == "first_ignores_null":
                out_cols[f"{p}.val"] = g.apply(
                    lambda s: (s.dropna().iloc[0]
                               if s.notna().any() else None)).to_numpy()
                out_cols[f"{p}.has"] = g.apply(
                    lambda s: s.notna().any()).to_numpy()
            elif fn in ("collect_list", "collect_set"):
                def coll(s, dedup=(fn == "collect_set")):
                    vals = [x for x in s if pd.notna(x)]
                    if dedup:
                        seen, out = set(), []
                        for x in vals:
                            if x not in seen:
                                seen.add(x)
                                out.append(x)
                        vals = out
                    return vals
                out_cols[f"{p}.list"] = g.apply(coll).to_numpy()
            else:
                raise NotImplementedError(f"fallback partial agg {fn}")
        elif mode == "final":
            # input carries state columns (from a native or fallback partial)
            def gcol(name):
                return df[name].groupby([df[n] for n in gnames],
                                        dropna=False, sort=True)
            if fn == "sum":
                out_cols[call["name"]] = gcol(f"{p}.sum").sum().to_numpy()
            elif fn == "count":
                out_cols[call["name"]] = gcol(f"{p}.count").sum().to_numpy()
            elif fn == "min":
                out_cols[call["name"]] = gcol(f"{p}.val").min().to_numpy()
            elif fn == "max":
                out_cols[call["name"]] = gcol(f"{p}.val").max().to_numpy()
            elif fn == "avg":
                s = gcol(f"{p}.sum").sum().to_numpy()
                c = gcol(f"{p}.count").sum().to_numpy()
                out_cols[call["name"]] = s / np.maximum(c, 1)
            elif fn == "first":
                has = gcol(f"{p}.has")
                first_pos = has.apply(
                    lambda s: s[s].index[0] if s.any() else s.index[0])
                out_cols[call["name"]] = np.where(
                    df.loc[first_pos, f"{p}.valid"].to_numpy(),
                    df.loc[first_pos, f"{p}.val"].to_numpy(), None)
            elif fn == "first_ignores_null":
                has = gcol(f"{p}.has")
                first_pos = has.apply(
                    lambda s: s[s].index[0] if s.any() else s.index[0])
                out_cols[call["name"]] = np.where(
                    has.apply(lambda s: s.any()).to_numpy(),
                    df.loc[first_pos, f"{p}.val"].to_numpy(), None)
            elif fn in ("collect_list", "collect_set"):
                dd = fn == "collect_set"
                out_cols[call["name"]] = gcol(f"{p}.list").apply(
                    lambda s, dd=dd: _merge_collected(s, dd)).to_numpy()
            else:
                raise NotImplementedError(f"fallback final agg {fn}")
        elif mode == "partial_merge":
            # merge state columns group-wise, keeping the state layout
            def gcol(name):
                return df[name].groupby([df[n] for n in gnames],
                                        dropna=False, sort=True)
            if fn in ("sum",):
                out_cols[f"{p}.sum"] = gcol(f"{p}.sum").sum().to_numpy()
                out_cols[f"{p}.nonempty"] = gcol(
                    f"{p}.nonempty").any().to_numpy()
            elif fn == "count":
                out_cols[f"{p}.count"] = gcol(f"{p}.count").sum().to_numpy()
            elif fn == "avg":
                out_cols[f"{p}.sum"] = gcol(f"{p}.sum").sum().to_numpy()
                out_cols[f"{p}.count"] = gcol(f"{p}.count").sum().to_numpy()
            elif fn in ("min", "max"):
                v = gcol(f"{p}.val")
                out_cols[f"{p}.val"] = (v.min() if fn == "min"
                                        else v.max()).to_numpy()
                out_cols[f"{p}.has"] = gcol(f"{p}.has").any().to_numpy()
            elif fn in ("first", "first_ignores_null"):
                has = gcol(f"{p}.has")
                first_pos = has.apply(
                    lambda s: s[s].index[0] if s.any() else s.index[0])
                out_cols[f"{p}.val"] = df.loc[first_pos,
                                              f"{p}.val"].to_numpy()
                if fn == "first":
                    out_cols[f"{p}.valid"] = df.loc[
                        first_pos, f"{p}.valid"].to_numpy()
                out_cols[f"{p}.has"] = has.any().to_numpy()
            elif fn in ("collect_list", "collect_set"):
                dd = fn == "collect_set"
                out_cols[f"{p}.list"] = gcol(f"{p}.list").apply(
                    lambda s, dd=dd: _merge_collected(s, dd)).to_numpy()
            else:
                raise NotImplementedError(f"fallback merge agg {fn}")
        else:
            raise NotImplementedError(f"fallback agg mode {mode}")
    out = pd.DataFrame(out_cols)
    if synthetic:
        out = out.drop(columns=["__global__"])
    return out


def _global_identity_rows(plan: SparkPlan) -> pd.DataFrame:
    """One identity STATE row for a global final/merge over empty input;
    the reductions over it produce Spark's global-agg-on-empty answers
    (count 0, sum/min/max null)."""
    from blaze_tpu_torch.ops.agg import AGG_BUF_PREFIX

    row: Dict[str, Any] = {"__global__": np.int32(0)}
    for i, call in enumerate(plan.attrs["aggs"]):
        p = f"{AGG_BUF_PREFIX}.{i}"
        fn = call["fn"]
        if fn == "sum":
            row[f"{p}.sum"] = 0
            row[f"{p}.nonempty"] = False
        elif fn == "count":
            row[f"{p}.count"] = 0
        elif fn == "avg":
            row[f"{p}.sum"] = 0
            row[f"{p}.count"] = 0
        elif fn in ("min", "max"):
            row[f"{p}.val"] = None
            row[f"{p}.has"] = False
        elif fn in ("first", "first_ignores_null"):
            row[f"{p}.val"] = None
            row[f"{p}.has"] = False
            if fn == "first":
                row[f"{p}.valid"] = False
        elif fn in ("collect_list", "collect_set"):
            row[f"{p}.list"] = []
    return pd.DataFrame([row])


def _op_join(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    """SMJ/BHJ on the row engine (a NeverConvert join must not kill the
    query — exactly the failure mode the bridge exists to prevent)."""
    ldf = _execute(plan.children[0], part, nparts)
    rdf = _execute(plan.children[1], part, nparts)
    jt = plan.attrs["join_type"]
    cond = plan.attrs.get("condition")

    lk = [np.asarray(_eval(e, ldf)) for e in plan.attrs["left_keys"]]
    rk = [np.asarray(_eval(e, rdf)) for e in plan.attrs["right_keys"]]
    lt = ldf.copy()
    rt = rdf.copy()
    kcols = []
    for i, (a, b) in enumerate(zip(lk, rk)):
        lt[f"__jk{i}"] = a
        rt[f"__jk{i}"] = b
        kcols.append(f"__jk{i}")
    lt["__lrow"] = np.arange(len(lt))
    rt["__rrow"] = np.arange(len(rt))

    # spark equi-join: NULL keys never match (pandas merge would pair
    # NaN with NaN) — null-key rows drop out of the match phase and
    # surface only through the unmatched/outer paths below
    lvalid = ~lt[kcols].isna().any(axis=1)
    rvalid = ~rt[kcols].isna().any(axis=1)
    inner = lt[lvalid].merge(rt[rvalid], on=kcols, how="inner",
                             suffixes=("", "__rdup"))
    if cond is not None:
        pair = pd.concat(
            [ldf.iloc[inner["__lrow"].to_numpy()].reset_index(drop=True),
             rdf.iloc[inner["__rrow"].to_numpy()].reset_index(drop=True)],
            axis=1)
        ok = pd.Series(np.asarray(_eval(cond, pair))).fillna(False).astype(
            bool).to_numpy()
        inner = inner[ok].reset_index(drop=True)

    matched_l = set(inner["__lrow"])
    matched_r = set(inner["__rrow"])

    def pair_frame(lrows, rrows):
        lpart = (ldf.iloc[lrows].reset_index(drop=True) if lrows is not None
                 else pd.DataFrame(
                     {c: [None] * n_null for c in ldf.columns}))
        rpart = (rdf.iloc[rrows].reset_index(drop=True) if rrows is not None
                 else pd.DataFrame(
                     {c: [None] * n_null for c in rdf.columns}))
        return pd.concat([lpart, rpart], axis=1)

    if jt in ("left_semi", "left_anti"):
        keep = (ldf.index.isin(matched_l) if jt == "left_semi"
                else ~ldf.index.isin(matched_l))
        return ldf[keep].reset_index(drop=True)
    if jt == "existence":
        out = ldf.copy()
        out["exists"] = ldf.index.isin(matched_l)
        return out.reset_index(drop=True)

    frames = [pair_frame(inner["__lrow"].to_numpy(),
                         inner["__rrow"].to_numpy())]
    if jt in ("left", "full"):
        lost = [i for i in range(len(ldf)) if i not in matched_l]
        n_null = len(lost)
        if lost:
            frames.append(pair_frame(lost, None))
    if jt in ("right", "full"):
        lost = [i for i in range(len(rdf)) if i not in matched_r]
        n_null = len(lost)
        if lost:
            frames.append(pair_frame(None, lost))
    return pd.concat(frames, ignore_index=True)


def _op_window(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    parts_keys = [f"__wp{i}" for i in range(len(plan.attrs["partition_by"]))]
    tmp = df.copy()
    for k, e in zip(parts_keys, plan.attrs["partition_by"]):
        tmp[k] = np.asarray(_eval(e, df))
    order = plan.attrs["order_by"]
    okeys, sort_cols, sort_asc = [], [], []
    for i, (e, a, nulls_first) in enumerate(order):
        v = pd.Series(np.asarray(_eval(e, df)), index=tmp.index)
        tmp[f"__wonull{i}"] = v.isna().astype(int)
        tmp[f"__wo{i}"] = v
        okeys.append(f"__wo{i}")
        sort_cols += [f"__wonull{i}", f"__wo{i}"]
        sort_asc += [not nulls_first, a]
    if parts_keys or sort_cols:
        tmp = tmp.sort_values(parts_keys + sort_cols,
                              ascending=[True] * len(parts_keys) + sort_asc,
                              kind="stable")
    grouped = tmp.groupby(parts_keys, dropna=False, sort=False) \
        if parts_keys else tmp.groupby(np.zeros(len(tmp)))
    for call in plan.attrs["calls"]:
        fn, name = call["fn"], call["name"]
        if fn == "row_number":
            tmp[name] = grouped.cumcount() + 1
        elif fn in ("rank", "dense_rank"):
            if not okeys:
                tmp[name] = 1  # no ORDER BY: every row is peer rank 1
            else:
                # rows are already in window order; rank = position of the
                # peer group's first row (direction-agnostic, unlike
                # Series.rank which always ranks ascending by VALUE)
                peer_cols = parts_keys + okeys
                cur, prev = tmp[peer_cols], tmp[peer_cols].shift()
                # null-aware change detection: NULL order values are PEERS
                # (NaN != NaN would split them into distinct groups)
                neq = (cur != prev) & ~(cur.isna() & prev.isna())
                is_start = neq.any(axis=1)
                if len(is_start):
                    is_start.iloc[0] = True
                within = grouped.cumcount()
                if fn == "rank":
                    start_pos = within.where(is_start)
                    part_key = (tmp[parts_keys].apply(tuple, axis=1)
                                if parts_keys else pd.Series(
                                    0, index=tmp.index))
                    tmp[name] = (start_pos.groupby(
                        part_key, sort=False).ffill() + 1).astype(int)
                else:
                    part_key = (tmp[parts_keys].apply(tuple, axis=1)
                                if parts_keys else pd.Series(
                                    0, index=tmp.index))
                    tmp[name] = is_start.astype(int).groupby(
                        part_key, sort=False).cumsum().astype(int)
        else:  # running aggregate leveled to the peer group (RANGE frame)
            arg = pd.Series(np.asarray(_eval(call["args"][0], tmp)),
                            index=tmp.index)
            tmp["__warg"] = arg
            agg = {"sum": "cumsum", "count": "cumcount", "avg": None,
                   "min": "cummin", "max": "cummax"}[fn]
            g2 = tmp.groupby(parts_keys, dropna=False, sort=False) \
                if parts_keys else tmp.groupby(np.zeros(len(tmp)))
            if fn == "count":
                run = g2["__warg"].transform(
                    lambda s: s.notna().cumsum())
            elif fn == "avg":
                sums = g2["__warg"].transform(lambda s: s.fillna(0).cumsum())
                cnts = g2["__warg"].transform(lambda s: s.notna().cumsum())
                run = sums / cnts.clip(lower=1)
            else:
                run = g2["__warg"].transform(agg)
            if okeys:
                # level to the last row of each peer group
                peer = parts_keys + okeys
                run = run.groupby(
                    [tmp[c] for c in peer], dropna=False).transform("last")
            else:
                run = g2["__warg"].transform(
                    {"sum": "sum", "count": "count", "min": "min",
                     "max": "max"}.get(fn, "sum")) if fn != "avg" else \
                    g2["__warg"].transform("mean")
            tmp[name] = run
    out_names = [f.name for f in plan.schema.fields]
    return tmp[out_names].reset_index(drop=True)


def _op_expand(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    names = _names(plan)
    frames = []
    for proj in plan.attrs["projections"]:
        cols = {}
        for name, e in zip(names, proj):
            v = _eval(e, df)
            cols[name] = (pd.Series(v, index=df.index) if np.ndim(v)
                          else pd.Series(np.full(len(df), v),
                                         index=df.index))
        frames.append(pd.DataFrame(cols))
    return pd.concat(frames, ignore_index=True)


def _op_generate(plan: SparkPlan, part: int, nparts: int) -> pd.DataFrame:
    df = _execute(plan.children[0], part, nparts)
    lists = _eval(plan.attrs["generator"], df)
    required = plan.attrs["required_cols"]
    out_names = plan.attrs["output_names"]
    pos, outer = plan.attrs["pos"], plan.attrs["outer"]
    rows = []
    for i in range(len(df)):
        vals = lists.iloc[i] if hasattr(lists, "iloc") else lists[i]
        base = [df[c].iloc[i] for c in required]
        if vals is None or (isinstance(vals, float) and pd.isna(vals)) \
                or len(vals) == 0:
            if outer:
                rows.append(base + ([None, None] if pos else [None]))
            continue
        for j, v in enumerate(vals):
            rows.append(base + ([j, v] if pos else [v]))
    names = [f.name for f in plan.schema.fields]
    return pd.DataFrame(rows, columns=names)


_OPS: Dict[str, Callable[[SparkPlan, int, int], pd.DataFrame]] = {
    "FileSourceScanExec": _op_scan,
    "__IpcReader": _op_ipc_reader,
    "FilterExec": _op_filter,
    "ProjectExec": _op_project,
    "SortExec": _op_sort,
    "LocalLimitExec": _op_limit,
    "GlobalLimitExec": _op_limit,
    "UnionExec": _op_union,
    "HashAggregateExec": _op_agg,
    "SortAggregateExec": _op_agg,
    "ObjectHashAggregateExec": _op_agg,
    "SortMergeJoinExec": _op_join,
    "BroadcastHashJoinExec": _op_join,
    "ShuffledHashJoinExec": _op_join,
    "WindowExec": _op_window,
    "ExpandExec": _op_expand,
    "GenerateExec": _op_generate,
}


# ---- expressions (numpy/pandas semantics, null via NaN/None) ----

_BINOPS = {
    ir.BinOp.ADD: operator.add, ir.BinOp.SUB: operator.sub,
    ir.BinOp.MUL: operator.mul, ir.BinOp.DIV: operator.truediv,
    ir.BinOp.MOD: operator.mod,
    ir.BinOp.EQ: operator.eq, ir.BinOp.NEQ: operator.ne,
    ir.BinOp.LT: operator.lt, ir.BinOp.LE: operator.le,
    ir.BinOp.GT: operator.gt, ir.BinOp.GE: operator.ge,
    ir.BinOp.BIT_AND: operator.and_, ir.BinOp.BIT_OR: operator.or_,
    ir.BinOp.BIT_XOR: operator.xor,
}

_NUMPY_DTYPES = {
    T.TypeKind.BOOLEAN: np.bool_, T.TypeKind.INT8: np.int8,
    T.TypeKind.INT16: np.int16, T.TypeKind.INT32: np.int32,
    T.TypeKind.INT64: np.int64, T.TypeKind.FLOAT32: np.float32,
    T.TypeKind.FLOAT64: np.float64,
}


def _decimal_div(l, r, scale: int) -> pd.Series:
    """Spark's decimal division off ANSI mode: NULL where either side is
    NULL or the divisor is zero, else the quotient rounded HALF_UP to the
    result scale (DecimalPrecision's `divide` result type)."""
    ls, rs = pd.Series(l), pd.Series(r)
    if len(ls) != len(rs):
        ls, rs = ((ls.repeat(len(rs)).reset_index(drop=True), rs)
                  if len(ls) == 1 else
                  (ls, rs.repeat(len(ls)).reset_index(drop=True)))
    quantum = decimal.Decimal(1).scaleb(-scale)
    ctx = decimal.Context(prec=80, rounding=decimal.ROUND_HALF_UP)
    out = []
    for a, b in zip(ls.tolist(), rs.tolist()):
        if a is None or b is None or pd.isna(a) or pd.isna(b) or b == 0:
            out.append(None)
        else:
            out.append(ctx.divide(decimal.Decimal(a), decimal.Decimal(b))
                       .quantize(quantum, context=ctx))
    return pd.Series(out, index=ls.index, dtype=object)


def _eval(e: ir.Expr, df: pd.DataFrame):
    if isinstance(e, ir.Literal):
        return e.value
    if isinstance(e, ir.Col):
        return df[e.name]
    if isinstance(e, ir.BoundRef):
        return df.iloc[:, e.index]
    if isinstance(e, ir.Binary):
        l, r = _eval(e.left, df), _eval(e.right, df)
        if e.op == ir.BinOp.AND:
            return pd.Series(l).astype(bool) & pd.Series(r).astype(bool)
        if e.op == ir.BinOp.OR:
            return pd.Series(l).astype(bool) | pd.Series(r).astype(bool)
        if (e.op == ir.BinOp.DIV and e.result_type is not None
                and e.result_type.kind == T.TypeKind.DECIMAL):
            return _decimal_div(l, r, e.result_type.scale)
        return _BINOPS[e.op](l, r)
    if isinstance(e, ir.Not):
        return ~pd.Series(_eval(e.child, df)).astype(bool)
    if isinstance(e, ir.IsNull):
        return pd.isna(_eval(e.child, df))
    if isinstance(e, ir.IsNotNull):
        return ~pd.isna(_eval(e.child, df))
    if isinstance(e, ir.Negate):
        return -_eval(e.child, df)
    if isinstance(e, ir.Cast):
        v = _eval(e.child, df)
        nd = _NUMPY_DTYPES.get(e.dtype.kind)
        if nd is None:
            return v
        return pd.Series(v).astype(nd)
    if isinstance(e, ir.If):
        return np.where(np.asarray(_eval(e.cond, df), bool),
                        _eval(e.then, df), _eval(e.otherwise, df))
    if isinstance(e, ir.CaseWhen):
        result = _eval(e.otherwise, df) if e.otherwise is not None else np.nan
        for cond, val in reversed(e.branches):
            result = np.where(np.asarray(_eval(cond, df), bool),
                              _eval(val, df), result)
        return result
    if isinstance(e, ir.InList):
        v = pd.Series(_eval(e.child, df))
        hit = v.isin([x.value for x in e.values])
        return ~hit if e.negated else hit
    if isinstance(e, ir.StringPredicate):
        s = pd.Series(_eval(e.child, df)).astype(str)
        pat = e.pattern.decode() if isinstance(e.pattern, bytes) else e.pattern
        if e.op == "starts_with":
            return s.str.startswith(pat)
        if e.op == "ends_with":
            return s.str.endswith(pat)
        return s.str.contains(pat, regex=False)
    if isinstance(e, ir.ScalarFn):
        fn = PYTHON_FNS.get(e.name.lower())
        if fn is None:
            raise NotImplementedError(
                f"no Python fallback for scalar fn {e.name}")
        return fn(*[np.asarray(_eval(a, df)) for a in e.args])
    if isinstance(e, ir.UdfWrapper):
        # a NeverConvert parent can drag a wrapped expression onto this
        # path. Two wrapper origins, two registries:
        #   udf:<name>          — hive_udf registrations
        #   fallbackfn:<name>:<ret-kind> — expr_subtree_fallback rewrites
        #     of PYTHON_FNS-covered scalar fns (the rewrite runs BEFORE
        #     tagging, so a later NeverConvert decision must still be
        #     able to evaluate the wrapped node here)
        parts = e.resource_id.split(":")
        if parts[0] == "fallbackfn" and len(parts) >= 2:
            fn = PYTHON_FNS.get(parts[1])
            if fn is not None:
                return fn(*[np.asarray(_eval(p, df)) for p in e.params])
        from blaze_tpu_torch.spark import hive_udf

        name = parts[1] if len(parts) > 1 else parts[0]
        hit = hive_udf.lookup(name)
        if hit is None:
            raise NotImplementedError(f"no evaluator for UDF {name}")
        return hit[0](*[np.asarray(_eval(p, df), object)
                        for p in e.params])
    raise NotImplementedError(f"fallback eval for {type(e).__name__}")
