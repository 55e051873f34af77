"""Spark cast semantics on device — the numeric subset.

Port of blaze_tpu/exprs/cast.py (TryCast: invalid -> null, ANSI off) for
casts among integers, floats and booleans. String, decimal, date and
timestamp casts raise NotImplementedError until they are ported.
"""

from __future__ import annotations

import torch

from blaze_tpu_torch.columnar.batch import Column
from blaze_tpu_torch.columnar.types import DataType, TypeKind

_INT_BOUNDS = {
    TypeKind.INT8: (-(2**7), 2**7 - 1),
    TypeKind.INT16: (-(2**15), 2**15 - 1),
    TypeKind.INT32: (-(2**31), 2**31 - 1),
    TypeKind.INT64: (-(2**63), 2**63 - 1),
}


def cast_column(col: Column, target: DataType) -> Column:
    src = col.dtype
    if src == target:
        return col
    if src.kind == TypeKind.NULL and target.is_string_like:
        from blaze_tpu_torch.exprs.compiler import const_string

        dev = col.data.device
        return Column(target, const_string(b"", col.capacity, dev),
                      torch.zeros((col.capacity,), dtype=torch.bool,
                                  device=dev))
    if (src.is_string_like or target.is_string_like or src.is_decimal
            or target.is_decimal or src.is_nested or target.is_nested):
        raise NotImplementedError(
            f"cast {src} -> {target} (exprs/cast.py non-numeric casts) "
            "not yet ported")

    k, tk = src.kind, target.kind
    valid = col.validity
    data = col.data

    if k == TypeKind.NULL:
        return Column(target,
                      torch.zeros((col.capacity,), dtype=target.torch_dtype(),
                                  device=data.device),
                      torch.zeros((col.capacity,), dtype=torch.bool,
                                  device=data.device))
    if k == TypeKind.BOOLEAN and (target.is_integral or target.is_floating):
        return Column(target, data.to(target.torch_dtype()), valid)
    if tk == TypeKind.BOOLEAN and src.is_numeric:
        return Column(target, data != 0, valid)

    if src.is_integral:
        if target.is_integral:
            return _int_to_int(data, valid, target)
        if target.is_floating:
            return Column(target, data.to(target.torch_dtype()), valid)
    if src.is_floating:
        if target.is_floating:
            return Column(target, data.to(target.torch_dtype()), valid)
        if target.is_integral:
            return _float_to_int(data, valid, target)

    raise NotImplementedError(f"cast {src} -> {target} not yet ported")


def _int_to_int(data: torch.Tensor, valid, target: DataType) -> Column:
    # Java narrowing semantics: wrap (two's complement truncation)
    return Column(target, data.to(target.torch_dtype()), valid)


def _float_to_int(data: torch.Tensor, valid, target: DataType) -> Column:
    """Saturate; NaN -> 0 (spark semantics, ext-commons cast.rs). The
    range test happens in the float domain: an out-of-range float->int
    conversion is undefined in C++ and differs between the CPU and CUDA."""
    lo, hi = _INT_BOUNDS[target.kind]
    x = data.to(torch.float64)
    # largest doubles inside [lo, hi]: 2^63-1 itself rounds up to 2^63
    safe = x.clamp(float(lo), float(min(hi, 2**63 - 1024)))
    out = safe.to(target.torch_dtype())
    top = torch.full_like(out, hi)
    out = torch.where(x >= float(hi), top, out)
    out = torch.where(torch.isnan(x), torch.zeros_like(out), out)
    return Column(target, out, valid)
