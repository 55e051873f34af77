"""Scalar function registry: Spark-compatible functions on device columns.

Port of blaze_tpu/exprs/functions.py. The registry holds every name of
the JAX package's (the tagging pass reads `is_supported`, so plans tag and
stage bytes come out as the JAX package's), but only `substring`/`substr`
(over `strings.substring`) and `make_array` run here. Compiling any other
registered name
raises NotImplementedError naming this module; a name outside the
registry raises as unsupported, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from blaze_tpu_torch.columnar.batch import Column, ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs import strings as S

# fn(cols, batch, expr) -> Column
FunctionImpl = Callable[[List[Column], ColumnBatch, ir.ScalarFn], Column]

_REGISTRY: Dict[str, FunctionImpl] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _not_ported(cols, batch, expr):
    raise NotImplementedError(
        f"scalar function {expr.name} (exprs/functions.py) not yet ported")


# the JAX registry's names (blaze_tpu/exprs/functions.py
# registered_names()); each not ported raises when compiled
for _name in (
        "abs", "acos", "ascii", "asin", "atan", "atan2", "bit_length",
        "btrim", "ceil", "char_length", "character_length", "chr",
        "coalesce", "concat", "concat_ws", "cos", "crc32", "date_add",
        "date_sub", "datediff", "day", "dayofmonth", "dayofweek", "exp",
        "floor", "get_json_object", "get_parsed_json_object", "hash", "hex",
        "initcap", "instr", "left", "length", "ln", "log", "log10", "log2",
        "lower", "lpad", "ltrim", "make_array", "md5", "month",
        "murmur3_hash", "null_if_zero", "nullif", "nullifzero",
        "octet_length", "parse_json", "position", "pow", "power", "repeat",
        "replace", "reverse", "right", "round", "rpad", "rtrim", "sha224",
        "sha256", "sha384", "sha512", "signum", "sin", "split_part", "sqrt",
        "string_space", "strpos", "tan", "to_hex", "translate", "trim",
        "trunc", "upper", "year"):
    _REGISTRY[_name] = _not_ported


def is_supported(name: str) -> bool:
    return name.lower() in _REGISTRY


def compile_function(expr: ir.ScalarFn, schema):
    from blaze_tpu_torch.exprs.compiler import compile_expr

    name = expr.name.lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"scalar function {expr.name} not supported on device")
    impl = _REGISTRY[name]
    if impl is _not_ported:
        _not_ported(None, None, expr)
    arg_fns = [compile_expr(a, schema) for a in expr.args]
    return lambda b: impl([f(b) for f in arg_fns], b, expr)


def _strict(cols: List[Column]):
    v = None
    for c in cols:
        if c.validity is not None:
            v = c.validity if v is None else (v & c.validity)
    return v


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


@register("make_array")
def _make_array(cols, batch, expr):
    """Spark array(...): a list of k elements in every row (ref
    spark_make_array.rs): offsets step by k, element i*k + j is argument
    j of row i, and each element keeps its argument's validity."""
    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.columnar.batch import ListData, StringData

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
