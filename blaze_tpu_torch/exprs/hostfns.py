"""Host-evaluated scalar kernels: crypto digests, CRC32, JSON path.

Port of blaze_tpu/exprs/hostfns.py. Ref: datafusion-ext-functions
lib.rs:28-53 registers the Md5/Sha*/Crc32 digests, and
spark_get_json_object.rs implements the Spark JSON path evaluator with a
parsed-JSON cache. These are bytewise-serial algorithms with no vector
formulation worth building, so they run on the host: per batch one
device->host copy of the argument (the string column's bytes, lengths and
validity, and the row count, packed into one byte tensor), the row
function in Python over the live rows, and one host->device copy of the
result to the batch's device. The same crossing carries the UDF wrapper
(exprs/compiler.py `_compile_udf_wrapper`). The JAX package also has a
traced path (`jax.pure_callback`); the port evaluates eagerly, so it has
only this one.

The JSON path evaluator supports the Spark/Hive subset: `$`, `.field`,
`['field']`, `[n]`, `[*]`. A small parsed-JSON LRU mirrors the
reference's GetParsedJsonObject/ParseJson caching pair: parse results are
memoised by content, so a projection evaluating several paths over one
column parses each value once.
"""

from __future__ import annotations

import hashlib
import json
import time
import zlib
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.columnar.batch import Column, ColumnBatch, StringData
from blaze_tpu_torch.columnar.types import INT64, STRING
from blaze_tpu_torch.runtime import metrics

# ---------------------------------------------------------------------------
# host crossing
# ---------------------------------------------------------------------------


def pull(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """`tensors` (on one device) as numpy arrays, in ONE device->host copy
    counted in `metrics.HOST_PULLS`: their bytes are packed into one byte
    tensor first."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = metrics.to_host(torch.cat(parts)).numpy()
    out, off = [], 0
    for t, p in zip(tensors, parts):
        n = p.numel()
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        out.append(buf[off:off + n].view(dt).reshape(tuple(t.shape)))
        off += n
    return out


def upload(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """numpy arrays onto `device` in ONE host->device copy. Each part
    starts on an 8-byte boundary, so every typed view is aligned."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 8) * 8
    buf = np.zeros(max(total, 8), np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    return [dev_buf[o:o + a.nbytes].view(getattr(torch, a.dtype.name))
            .reshape(a.shape) for a, o in zip(arrays, offs)]


def host_apply(callback: Callable, shapes, device, kind: str,
               *args: torch.Tensor) -> List[torch.Tensor]:
    """Run `callback(*numpy_args) -> tuple of numpy arrays` on the host:
    one pull of the arguments, one upload of the results to `device`.
    `shapes` gives each result's (shape, torch dtype), as the JAX
    package's `jax.ShapeDtypeStruct`s do: on the `meta` device (the
    operators' dtype probes) the results are data-free tensors of those
    shapes and nothing crosses. A crossing's count and host seconds go to
    `metrics.HOST_EVAL` under `kind` ("hostfn" or "udf")."""
    if torch.device(device).type == "meta":
        return [torch.empty(shape, dtype=dt, device="meta")
                for shape, dt in shapes]
    t0 = time.perf_counter_ns()
    outs = callback(*pull(args))
    res = upload(outs, device)
    metrics.note_host_eval(kind, time.perf_counter_ns() - t0)
    return res


def _string_args(col: Column, batch: ColumnBatch):
    sd = col.data
    valid = col.valid_mask() & batch.row_mask()
    return (sd.bytes, sd.lengths, valid,
            batch.num_rows.to(torch.int64).reshape(1))


def host_bytes_to_string(col: Column, batch: ColumnBatch, out_width: int,
                         row_fn: Callable[[bytes], Optional[bytes]]
                         ) -> Column:
    """Apply `row_fn` to each live, valid row's bytes on the host.

    row_fn returning None marks the row null; results longer than
    `out_width` are nulled too (never silently truncated)."""
    cap = batch.capacity

    def callback(b, lens, ok, n):
        out_b = np.zeros((cap, out_width), np.uint8)
        out_l = np.zeros((cap,), np.int32)
        out_ok = np.zeros((cap,), bool)
        for i in range(int(n[0])):
            if not ok[i]:
                continue
            r = row_fn(b[i, :lens[i]].tobytes())
            if r is None or len(r) > out_width:
                continue
            out_b[i, :len(r)] = np.frombuffer(r, np.uint8)
            out_l[i] = len(r)
            out_ok[i] = True
        return out_b, out_l, out_ok

    shapes = [((cap, out_width), torch.uint8), ((cap,), torch.int32),
              ((cap,), torch.bool)]
    ob, ol, ook = host_apply(callback, shapes, batch.device, "hostfn",
                             *_string_args(col, batch))
    return Column(STRING, StringData(ob, ol), ook)


def host_bytes_to_int64(col: Column, batch: ColumnBatch,
                        row_fn: Callable[[bytes], int]) -> Column:
    cap = batch.capacity

    def callback(b, lens, ok, n):
        out = np.zeros((cap,), np.int64)
        for i in range(int(n[0])):
            if ok[i]:
                out[i] = row_fn(b[i, :lens[i]].tobytes())
        return (out,)

    (out,) = host_apply(callback, [((cap,), torch.int64)], batch.device,
                        "hostfn", *_string_args(col, batch))
    return Column(INT64, out, col.validity)


# ---------------------------------------------------------------------------
# digests (ref lib.rs digest registrations)
# ---------------------------------------------------------------------------

DIGESTS = {
    "md5": (32, lambda b: hashlib.md5(b).hexdigest().encode()),
    "sha224": (56, lambda b: hashlib.sha224(b).hexdigest().encode()),
    "sha256": (64, lambda b: hashlib.sha256(b).hexdigest().encode()),
    "sha384": (96, lambda b: hashlib.sha384(b).hexdigest().encode()),
    "sha512": (128, lambda b: hashlib.sha512(b).hexdigest().encode()),
}


def crc32_value(b: bytes) -> int:
    return zlib.crc32(b) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# JSON path (ref spark_get_json_object.rs)
# ---------------------------------------------------------------------------


def parse_json_path(path: str) -> Optional[List]:
    """'$.a.b[0][*]' -> [('key','a'), ('key','b'), ('idx',0), ('star',)].
    Returns None for malformed paths (Spark: the result is NULL)."""
    if not path.startswith("$"):
        return None
    steps: List[Tuple] = []
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            name = path[i + 1:j]
            if not name:
                return None
            steps.append(("key", name))
            i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            inner = path[i + 1:j].strip()
            if inner == "*":
                steps.append(("star",))
            elif (len(inner) >= 2 and inner[0] in "'\""
                  and inner[-1] == inner[0]):
                steps.append(("key", inner[1:-1]))
            else:
                try:
                    steps.append(("idx", int(inner)))
                except ValueError:
                    return None
            i = j + 1
        else:
            return None
    return steps


_PARSE_CACHE: "OrderedDict[bytes, object]" = OrderedDict()
_PARSE_CACHE_MAX = 4096
_INVALID = object()


def cached_parse(raw: bytes):
    """Parsed-JSON memo (ref: ParseJson + UserDefinedArray caching)."""
    hit = _PARSE_CACHE.get(raw)
    if hit is not None:
        _PARSE_CACHE.move_to_end(raw)
        return hit
    try:
        v = json.loads(raw)
        if v is None:
            v = _INVALID
    except (ValueError, RecursionError):  # bad JSON, undecodable bytes
        v = _INVALID
    _PARSE_CACHE[raw] = v
    if len(_PARSE_CACHE) > _PARSE_CACHE_MAX:
        _PARSE_CACHE.popitem(last=False)
    return v


def eval_json_path(value, steps: List[Tuple]):
    """Returns (found, value). [*] fans out and collects matches."""
    cur = [value]
    for st in steps:
        nxt = []
        if st[0] == "key":
            for v in cur:
                if isinstance(v, dict) and st[1] in v:
                    nxt.append(v[st[1]])
        elif st[0] == "idx":
            for v in cur:
                if isinstance(v, list) and -len(v) <= st[1] < len(v):
                    nxt.append(v[st[1]])
        else:  # star
            for v in cur:
                if isinstance(v, list):
                    nxt.extend(v)
        cur = nxt
        if not cur:
            return False, None
    if len(cur) == 1:
        return True, cur[0]
    return True, cur


def render_json_value(v) -> Optional[bytes]:
    """Spark rendering: strings raw (unquoted), null -> NULL, containers as
    compact JSON."""
    if v is None:
        return None
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, bool):
        return b"true" if v else b"false"
    if isinstance(v, (int, float)):
        return json.dumps(v).encode()
    return json.dumps(v, separators=(",", ":")).encode()


def get_json_object_row(raw: bytes, steps: List[Tuple]) -> Optional[bytes]:
    v = cached_parse(raw)
    if v is _INVALID:
        return None
    found, out = eval_json_path(v, steps)
    if not found:
        return None
    return render_json_value(out)


def validate_json_row(raw: bytes) -> Optional[bytes]:
    """parse_json: NULL for invalid documents, the input text otherwise."""
    return raw if cached_parse(raw) is not _INVALID else None
