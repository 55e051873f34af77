"""Scalar function registry: Spark-compatible functions on device columns.

Port of blaze_tpu/exprs/functions.py. Ref: the 64-entry ScalarFunction
enum of the plan contract (blaze.proto:186-252) plus the spark-ext
functions (datafusion-ext-functions lib.rs:28-53). Math, null handling,
dates and hashing are torch ops over the port's `Column`s; string
functions ride the fixed-width kernels of exprs/strings.py; the digests,
CRC32 and the JSON path functions cross to the host (exprs/hostfns.py).
The registry's names are the JAX package's, so plan tagging and stage
bytes come out as its do; a name outside the registry raises as
unsupported, which keeps that subtree on the fallback path.

Float -> integer results saturate and map NaN to 0 (`cast._float_to_int`),
as XLA's conversion does: C++'s is undefined out of range and differs
between the CPU and CUDA. `signum` keeps ±0 and NaN as `jnp.sign` does
(`torch.sign` maps both to 0).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, StringData, bucket_width,
)
from blaze_tpu_torch.columnar.types import (
    FLOAT64, INT32, INT64, STRING, DataType,
)
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs import strings as S
from blaze_tpu_torch.exprs.cast import (
    _and_valid, _float_to_int, civil_from_days, const_string, div_exact,
)

# fn(cols, batch, expr) -> Column
FunctionImpl = Callable[[List[Column], ColumnBatch, ir.ScalarFn], Column]

_REGISTRY: Dict[str, FunctionImpl] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def is_supported(name: str) -> bool:
    """Plan-time check used by the convert strategy's expression walk."""
    return name.lower() in _REGISTRY


def registered_names():
    """All native scalar-function names (the row interpreter's coverage is
    tested against this)."""
    return sorted(_REGISTRY)


# functions evaluated on the host (hostfns.py)
HOST_EVAL_FNS = ir.HOST_EVAL_FNS


def is_host_fn(name: str) -> bool:
    return name.lower() in HOST_EVAL_FNS


def compile_function(expr: ir.ScalarFn, schema):
    from blaze_tpu_torch.exprs.compiler import compile_expr

    name = expr.name.lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"scalar function {expr.name} not supported on device")
    impl = _REGISTRY[name]
    arg_fns = [compile_expr(a, schema) for a in expr.args]
    return lambda b: impl([f(b) for f in arg_fns], b, expr)


def _strict(cols: List[Column]):
    v = None
    for c in cols:
        if c.validity is not None:
            v = c.validity if v is None else (v & c.validity)
    return v


def _to_int(x: torch.Tensor, dt: DataType) -> torch.Tensor:
    """Float -> integer of `dt`: saturating, NaN -> 0."""
    return _float_to_int(x, None, dt).data


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded, as Java's Math.sqrt and XLA's are. CUDA's double
    sqrt is; torch's CPU one is not always (sqrt(0.5) comes out one unit
    in the last place low), so a CPU tensor takes numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _signum(x: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


# ---- math ----

def _math1(fn, domain=None, out_dtype: DataType = FLOAT64):
    def impl(cols, batch, expr):
        (c,) = cols
        x = c.data.to(torch.float64)
        valid = _strict(cols)
        if domain is not None:
            ok = domain(x)
            x = torch.where(ok, x, torch.ones_like(x))
            valid = _and_valid(valid, ok)
        return Column(out_dtype, fn(x), valid)

    return impl


for _name, _fn, _dom in [
    ("sqrt", _sqrt, lambda x: x >= 0),
    ("exp", torch.exp, None),
    ("ln", torch.log, lambda x: x > 0),
    ("log", torch.log, lambda x: x > 0),
    ("log10", torch.log10, lambda x: x > 0),
    ("log2", torch.log2, lambda x: x > 0),
    ("sin", torch.sin, None),
    ("cos", torch.cos, None),
    ("tan", torch.tan, None),
    ("asin", torch.asin, lambda x: torch.abs(x) <= 1),
    ("acos", torch.acos, lambda x: torch.abs(x) <= 1),
    ("atan", torch.atan, None),
    ("signum", _signum, None),
]:
    _REGISTRY[_name] = _math1(_fn, _dom)


@register("abs")
def _abs(cols, batch, expr):
    (c,) = cols
    return Column(c.dtype, torch.abs(c.data), c.validity)


def _round_fn(fn):
    def impl(cols, batch, expr):
        (c,) = cols
        if c.dtype.is_integral:
            return Column(INT64, c.data.to(torch.int64), c.validity)
        return Column(INT64, _to_int(fn(c.data.to(torch.float64)), INT64),
                      c.validity)

    return impl


_REGISTRY["ceil"] = _round_fn(torch.ceil)
_REGISTRY["floor"] = _round_fn(torch.floor)


def _static_int_arg(expr, i: int, what: str) -> int:
    """A literal int argument from the IR (non-literal arguments make the
    whole expression fall back at plan time, ref tryConvert)."""
    arg = expr.args[i]
    if not isinstance(arg, ir.Literal) or arg.value is None:
        raise NotImplementedError(
            f"{expr.name}: {what} must be a non-null literal")
    return int(arg.value)


@register("round")
def _round(cols, batch, expr):
    c = cols[0]
    scale = 0
    if len(cols) > 1:
        scale = _static_int_arg(expr, 1, "scale")
    if c.dtype.is_integral and scale >= 0:
        return c
    p = 10.0 ** scale
    x = c.data.to(torch.float64) * p
    # Spark rounds HALF_UP (away from zero), not half-even; the division
    # by a device tensor is correctly rounded on CUDA too
    r = div_exact(torch.where(x >= 0, torch.floor(x + 0.5),
                              torch.ceil(x - 0.5)), p)
    if c.dtype.is_integral:
        return Column(c.dtype, _to_int(r, c.dtype), c.validity)
    if c.dtype.is_floating:
        return Column(c.dtype, r.to(c.dtype.torch_dtype()), c.validity)
    return Column(FLOAT64, r, c.validity)


@register("trunc")
def _trunc(cols, batch, expr):
    (c,) = cols
    r = torch.trunc(c.data.to(torch.float64))
    if c.data.is_floating_point():
        return Column(c.dtype, r.to(c.data.dtype), c.validity)
    return Column(c.dtype, _to_int(r, c.dtype), c.validity)


@register("pow")
@register("power")
def _pow(cols, batch, expr):
    a, b = cols
    return Column(FLOAT64, torch.pow(a.data.to(torch.float64),
                                     b.data.to(torch.float64)),
                  _strict(cols))


@register("atan2")
def _atan2(cols, batch, expr):
    a, b = cols
    return Column(FLOAT64, torch.atan2(a.data.to(torch.float64),
                                       b.data.to(torch.float64)),
                  _strict(cols))


# ---- null handling ----

@register("nullif")
def _nullif(cols, batch, expr):
    a, b = cols
    eq = S.equals(a.data, b.data) if a.is_string else a.data == b.data
    return Column(a.dtype, a.data,
                  _and_valid(a.validity, ~(eq & b.valid_mask())))


@register("nullifzero")
@register("null_if_zero")
def _nullifzero(cols, batch, expr):
    (a,) = cols
    return Column(a.dtype, a.data, _and_valid(a.validity, a.data != 0))


@register("coalesce")
def _coalesce(cols, batch, expr):
    out_dtype = cols[0].dtype
    acc_v = torch.zeros((batch.capacity,), dtype=torch.bool,
                        device=batch.device)
    if cols[0].is_string:
        w = max(c.data.width for c in cols)
        datas = [S.ensure_width(StringData(c.data.bytes, c.data.lengths), w)
                 for c in cols]
        acc_b = torch.zeros_like(datas[0].bytes)
        acc_l = torch.zeros_like(datas[0].lengths)
        for c, d in zip(cols, datas):
            fire = c.valid_mask() & ~acc_v
            acc_b = torch.where(fire[:, None], d.bytes, acc_b)
            acc_l = torch.where(fire, d.lengths, acc_l)
            acc_v = acc_v | fire
        return Column(out_dtype, StringData(acc_b, acc_l), acc_v)
    acc = torch.zeros_like(cols[0].data)
    for c in cols:
        fire = c.valid_mask() & ~acc_v
        acc = torch.where(fire, c.data.to(acc.dtype), acc)
        acc_v = acc_v | fire
    return Column(out_dtype, acc, acc_v)


# ---- string functions ----

@register("upper")
def _upper(cols, batch, expr):
    (c,) = cols
    return Column(c.dtype, S.upper_ascii(c.data), c.validity)


@register("lower")
def _lower(cols, batch, expr):
    (c,) = cols
    return Column(c.dtype, S.lower_ascii(c.data), c.validity)


@register("character_length")
@register("char_length")
@register("length")
def _char_length(cols, batch, expr):
    (c,) = cols
    return Column(INT32, S.char_length(c.data), c.validity)


@register("octet_length")
def _octet_length(cols, batch, expr):
    (c,) = cols
    return Column(INT32, c.data.lengths, c.validity)


@register("bit_length")
def _bit_length(cols, batch, expr):
    (c,) = cols
    return Column(INT32, c.data.lengths * 8, c.validity)


@register("ascii")
def _ascii(cols, batch, expr):
    (c,) = cols
    first = c.data.bytes[:, 0].to(torch.int32)
    return Column(INT32, torch.where(c.data.lengths > 0, first,
                                     torch.zeros_like(first)), c.validity)


@register("substr")
@register("substring")
def _substr(cols, batch, expr):
    c = cols[0]
    start = cols[1].data.to(torch.int32)
    if len(cols) > 2:
        length = cols[2].data.to(torch.int32)
    else:
        length = torch.full((batch.capacity,), c.data.width,
                            dtype=torch.int32, device=batch.device)
    return Column(c.dtype, S.substring(c.data, start, length), _strict(cols))


@register("concat")
def _concat(cols, batch, expr):
    # Spark concat: null if any argument is null
    return Column(STRING, S.concat([c.data for c in cols]), _strict(cols))


@register("concat_ws")
def _concat_ws(cols, batch, expr):
    """The first argument is the separator; null arguments are skipped
    (Spark semantics)."""
    sep = cols[0].data
    parts = cols[1:]
    if not parts:
        return Column(STRING, const_string(b"", batch.capacity,
                                           batch.device), None)
    # for each part, an effective (possibly empty) piece after a
    # separator that shows only between two valid pieces
    pieces = []
    seen_any = torch.zeros((batch.capacity,), dtype=torch.bool,
                           device=batch.device)
    zero = torch.zeros_like(sep.lengths)
    for c in parts:
        v = c.valid_mask()
        need_sep = seen_any & v
        pieces.append(StringData(sep.bytes,
                                 torch.where(need_sep, sep.lengths, zero)))
        pieces.append(StringData(c.data.bytes, torch.where(
            v, c.data.lengths, torch.zeros_like(c.data.lengths))))
        seen_any = seen_any | v
    return Column(STRING, S.concat(pieces), cols[0].validity)


@register("trim")
@register("btrim")
def _trim(cols, batch, expr):
    c = cols[0]
    return Column(c.dtype, S.trim(c.data, True, True), c.validity)


@register("ltrim")
def _ltrim(cols, batch, expr):
    c = cols[0]
    return Column(c.dtype, S.trim(c.data, True, False), c.validity)


@register("rtrim")
def _rtrim(cols, batch, expr):
    c = cols[0]
    return Column(c.dtype, S.trim(c.data, False, True), c.validity)


@register("repeat")
def _repeat(cols, batch, expr):
    c = cols[0]
    n = _static_int_arg(expr, 1, "repeat count")
    return Column(c.dtype, S.repeat(c.data, n), c.validity)


@register("string_space")
def _string_space(cols, batch, expr):
    (n,) = cols
    count = torch.clamp(n.data.to(torch.int32), 0, 128)
    w = bucket_width(128)
    j = torch.arange(w, dtype=torch.int32, device=batch.device)
    mat = (j[None, :] < count[:, None]).to(torch.uint8) * 0x20
    return Column(STRING, StringData(mat, count), n.validity)


@register("reverse")
def _reverse(cols, batch, expr):
    (c,) = cols
    return Column(c.dtype, S.reverse(c.data), c.validity)


@register("initcap")
def _initcap(cols, batch, expr):
    (c,) = cols
    return Column(c.dtype, S.initcap(c.data), c.validity)


@register("left")
def _left(cols, batch, expr):
    c = cols[0]
    length = torch.clamp(cols[1].data.to(torch.int32), min=0)  # <= 0: empty
    return Column(c.dtype, S.substring(c.data, torch.ones_like(length),
                                       length), _strict(cols))


@register("right")
def _right(cols, batch, expr):
    c = cols[0]
    length = torch.clamp(cols[1].data.to(torch.int32), min=0)
    start = torch.where(length > 0, -length, torch.ones_like(length))
    return Column(c.dtype, S.substring(c.data, start, length),
                  _strict(cols))


def _static_str_arg(expr, i: int, what: str) -> bytes:
    arg = expr.args[i]
    if not isinstance(arg, ir.Literal) or arg.value is None:
        raise NotImplementedError(
            f"{expr.name}: {what} must be a non-null literal")
    v = arg.value
    return v.encode() if isinstance(v, str) else bytes(v)


@register("lpad")
def _lpad(cols, batch, expr):
    c = cols[0]
    n = _static_int_arg(expr, 1, "length")
    pad = _static_str_arg(expr, 2, "pad") if len(cols) > 2 else b" "
    return Column(c.dtype, S.lpad(c.data, n, pad), c.validity)


@register("rpad")
def _rpad(cols, batch, expr):
    c = cols[0]
    n = _static_int_arg(expr, 1, "length")
    pad = _static_str_arg(expr, 2, "pad") if len(cols) > 2 else b" "
    return Column(c.dtype, S.rpad(c.data, n, pad), c.validity)


@register("strpos")
@register("instr")
@register("position")
def _strpos(cols, batch, expr):
    c = cols[0]
    pat = _static_str_arg(expr, 1, "substring")
    return Column(INT32, S.strpos(c.data, pat), _strict(cols))


@register("replace")
def _replace(cols, batch, expr):
    c = cols[0]
    search = _static_str_arg(expr, 1, "search")
    rep = _static_str_arg(expr, 2, "replacement") if len(cols) > 2 else b""
    return Column(c.dtype, S.replace(c.data, search, rep), _strict(cols[:1]))


@register("translate")
def _translate(cols, batch, expr):
    c = cols[0]
    frm = _static_str_arg(expr, 1, "from")
    to = _static_str_arg(expr, 2, "to")
    return Column(c.dtype, S.translate(c.data, frm, to), c.validity)


@register("split_part")
def _split_part(cols, batch, expr):
    c = cols[0]
    delim = _static_str_arg(expr, 1, "delimiter")
    res, defined = S.split_part(c.data, delim, cols[2].data)
    return Column(c.dtype, res, _and_valid(_strict(cols), defined))


@register("chr")
def _chr(cols, batch, expr):
    (n,) = cols
    return Column(STRING, S.chr_fn(n.data, batch.capacity), n.validity)


@register("to_hex")
@register("hex")
def _to_hex(cols, batch, expr):
    (n,) = cols
    return Column(STRING, S.to_hex(n.data.to(torch.int64), batch.capacity),
                  n.validity)


# ---- dates (days since 1970-01-01) ----

@register("year")
def _year(cols, batch, expr):
    (c,) = cols
    return Column(INT32, civil_from_days(c.data)[0], c.validity)


@register("month")
def _month(cols, batch, expr):
    (c,) = cols
    return Column(INT32, civil_from_days(c.data)[1], c.validity)


@register("day")
@register("dayofmonth")
def _day(cols, batch, expr):
    (c,) = cols
    return Column(INT32, civil_from_days(c.data)[2], c.validity)


@register("dayofweek")
def _dayofweek(cols, batch, expr):
    (c,) = cols
    # 1970-01-01 was a Thursday; Spark's dayofweek is 1 = Sunday .. 7;
    # a floor modulo keeps dates before 1970 in range
    dow = torch.remainder(c.data.to(torch.int64) + 4, 7)  # 0 = Sunday
    return Column(INT32, (dow + 1).to(torch.int32), c.validity)


@register("date_add")
def _date_add(cols, batch, expr):
    a, b = cols
    return Column(a.dtype, a.data + b.data.to(torch.int32), _strict(cols))


@register("date_sub")
def _date_sub(cols, batch, expr):
    a, b = cols
    return Column(a.dtype, a.data - b.data.to(torch.int32), _strict(cols))


@register("datediff")
def _datediff(cols, batch, expr):
    a, b = cols
    return Column(INT32, a.data - b.data, _strict(cols))


# ---- hash ----

@register("murmur3_hash")
@register("hash")
def _murmur3(cols, batch, expr):
    from blaze_tpu_torch.exprs.hash import hash_columns

    return Column(INT32, hash_columns(cols, 42), None)


# ---- digests, CRC32 and JSON (host kernels, see hostfns.py) ----

def _digest_impl(name):
    def impl(cols, batch, expr):
        from blaze_tpu_torch.exprs import hostfns as H

        width, row_fn = H.DIGESTS[name]
        return H.host_bytes_to_string(cols[0], batch, bucket_width(width),
                                      row_fn)

    return impl


for _d in ("md5", "sha224", "sha256", "sha384", "sha512"):
    _REGISTRY[_d] = _digest_impl(_d)


@register("crc32")
def _crc32(cols, batch, expr):
    from blaze_tpu_torch.exprs import hostfns as H

    return H.host_bytes_to_int64(cols[0], batch, H.crc32_value)


@register("get_json_object")
@register("get_parsed_json_object")
def _get_json_object(cols, batch, expr):
    from blaze_tpu_torch.exprs import hostfns as H

    c = cols[0]
    steps = H.parse_json_path(
        _static_str_arg(expr, 1, "json path").decode())
    if steps is None:
        # a malformed path: an all-null column of the input's width
        return Column(STRING, StringData(torch.zeros_like(c.data.bytes),
                                         torch.zeros_like(c.data.lengths)),
                      torch.zeros((batch.capacity,), dtype=torch.bool,
                                  device=batch.device))
    return H.host_bytes_to_string(
        c, batch, c.data.width,
        lambda raw: H.get_json_object_row(raw, steps))


@register("parse_json")
def _parse_json(cols, batch, expr):
    from blaze_tpu_torch.exprs import hostfns as H

    c = cols[0]
    return H.host_bytes_to_string(c, batch, c.data.width,
                                  H.validate_json_row)


# ---- collections ----

@register("make_array")
def _make_array(cols, batch, expr):
    """Spark array(...): a list of k elements in every row (ref
    spark_make_array.rs): offsets step by k, element i*k + j is argument
    j of row i, and each element keeps its argument's validity."""
    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.columnar.batch import ListData

    k = len(cols)
    if k == 0:
        raise NotImplementedError("make_array() with no args")
    cap, dev = batch.capacity, batch.device
    offsets = torch.arange(cap + 1, dtype=torch.int32, device=dev) * k
    if cols[0].is_string:
        w = max(c.data.width for c in cols)
        datas = [S.ensure_width(StringData(c.data.bytes, c.data.lengths), w)
                 for c in cols]
        data = StringData(
            torch.stack([d.bytes for d in datas], 1).reshape(cap * k, w),
            torch.stack([d.lengths for d in datas], 1).reshape(cap * k))
    else:
        data = torch.stack([c.data for c in cols], 1).reshape(cap * k)
    valid = None
    if any(c.validity is not None for c in cols):
        valid = torch.stack([c.valid_mask() for c in cols],
                            1).reshape(cap * k)
    elem = Column(cols[0].dtype, data, valid)
    return Column(T.list_of(cols[0].dtype), ListData(offsets, elem), None)
