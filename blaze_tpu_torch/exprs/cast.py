"""Spark cast semantics on device (TryCast: invalid -> null, ANSI off).

Port of blaze_tpu/exprs/cast.py (ref: datafusion-ext-exprs/src/cast.rs
TryCastExpr and datafusion-ext-commons/src/cast.rs: float->int
saturation, string parsing, decimal rescale with HALF_UP). Every arm of
the JAX module: among integers, floats and booleans; decimal to and from
them and between scales (wide ones through exprs/wide_decimal.py); date
and timestamp; string to int, double, decimal, date and boolean, parsed
on the device over the byte matrix; int, boolean and date to string.

HALF_UP rounds the magnitude (`abs // div`, then `+ (2 * rem >= div)`,
then the sign); torch.round, which rounds half to even, is never used.
Integer division floors (`//`, as jnp's does), including the calendar
arithmetic before 1970.
"""

from __future__ import annotations

import torch

from blaze_tpu_torch.columnar.batch import (
    Column, StringData, _zero_column, bucket_width,
)
from blaze_tpu_torch.columnar.types import DATE, STRING, DataType, TypeKind

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
    if src.is_string_like and target.is_string_like:
        return Column(target, col.data, col.validity)
    if src.kind == TypeKind.NULL:
        # any type's all-null column (the JAX package refuses null ->
        # string and null -> wide decimal; Spark casts NULL to any type)
        return _null_column(target, col)
    if src.is_string_like:
        return _from_string(col, target)
    if target.is_string_like:
        return _to_string(col, target)

    if src.wide_decimal or target.wide_decimal:
        from blaze_tpu_torch.exprs import wide_decimal as W

        if target.wide_decimal:
            return W.cast_to_wide(col, target)
        return W.cast_from_wide(col, target)

    k, tk = src.kind, target.kind
    valid = col.validity
    data = col.data

    if k == TypeKind.BOOLEAN:
        if target.is_integral or target.is_floating:
            return Column(target, data.to(target.torch_dtype()), valid)
        if target.is_decimal:
            return _int_to_decimal(data.to(torch.int64), valid, target)
    if tk == TypeKind.BOOLEAN and src.is_numeric:
        return Column(target, data != 0, valid)

    # date and timestamp as their underlying ints
    if k == TypeKind.DATE and target.is_integral:
        return _int_to_int(data, valid, target)
    if src.is_integral and tk == TypeKind.DATE:
        return _int_to_int(data, valid, target)
    if k == TypeKind.TIMESTAMP and (target.is_integral or target.is_floating):
        # Spark: timestamp -> long is seconds, -> double fractional seconds
        if target.is_integral:
            return _int_to_int(data // 1_000_000, valid, target)
        return Column(target, div_exact(data.to(torch.float64), 1e6),
                      valid)
    if src.is_integral and tk == TypeKind.TIMESTAMP:
        return Column(target, data.to(torch.int64) * 1_000_000, valid)
    if k == TypeKind.DATE and tk == TypeKind.TIMESTAMP:
        return Column(target, data.to(torch.int64) * 86_400_000_000, valid)
    if k == TypeKind.TIMESTAMP and tk == TypeKind.DATE:
        return Column(target, (data // 86_400_000_000).to(torch.int32),
                      valid)

    if src.is_integral:
        if target.is_integral:
            return _int_to_int(data, valid, target)
        if target.is_floating:
            return Column(target, data.to(target.torch_dtype()), valid)
        if target.is_decimal:
            return _int_to_decimal(data.to(torch.int64), valid, target)
    if src.is_floating:
        if target.is_floating:
            return Column(target, data.to(target.torch_dtype()), valid)
        if target.is_integral:
            return _float_to_int(data, valid, target)
        if target.is_decimal:
            return _float_to_decimal(data, valid, target)
    if src.is_decimal:
        scale_div = 10 ** src.scale
        if target.is_floating:
            return Column(target, div_exact(data.to(torch.float64),
                                            scale_div), valid)
        if target.is_integral:
            # toward zero
            trunc = torch.sign(data) * (torch.abs(data) // scale_div)
            return _int_to_int(trunc, valid, target)
        if target.is_decimal:
            return _decimal_rescale(data, valid, src, target)

    raise TypeError(f"unsupported cast {src} -> {target}")


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: CUDA divides a tensor by
    a host scalar as a multiplication by its reciprocal, which can be one
    unit in the last place off (XLA's jit does the same); a divisor
    tensor on x's device keeps the true division."""
    return x / torch.full_like(x, float(d))


def _null_column(target: DataType, col: Column) -> Column:
    z = _zero_column(target, col.capacity, col.device)
    return Column(target, z.data, torch.zeros(
        (col.capacity,), dtype=torch.bool, device=col.device))


# ---- numeric helpers ----

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


def _int_to_decimal(data: torch.Tensor, valid, target: DataType) -> Column:
    """Scale an int64 by 10^s; a product that wraps (`data != out // mul`)
    or leaves the precision goes null."""
    mul = 10 ** target.scale
    out = data * mul
    overflow = ((torch.abs(out) >= 10 ** target.precision)
                | (data != out // mul))
    return Column(target, torch.where(overflow, 0, out),
                  _and_valid(valid, ~overflow))


def _float_to_decimal(data: torch.Tensor, valid, target: DataType
                      ) -> Column:
    scaled = data.to(torch.float64) * (10.0 ** target.scale)
    # HALF_UP on the magnitude
    rounded = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                          torch.ceil(scaled - 0.5))
    bad = torch.isnan(scaled) | (torch.abs(rounded)
                                 >= float(10 ** target.precision))
    out = torch.where(bad, 0.0, rounded).to(torch.int64)
    return Column(target, out, _and_valid(valid, ~bad))


def _decimal_rescale(data: torch.Tensor, valid, src: DataType,
                     target: DataType) -> Column:
    ds = target.scale - src.scale
    if ds >= 0:
        out = data * (10 ** ds)
        ok = ((out // (10 ** ds)) == data if ds > 0
              else torch.ones_like(data, dtype=torch.bool))
    else:
        div = 10 ** (-ds)
        q = torch.abs(data) // div
        r = torch.abs(data) % div
        q = q + (2 * r >= div).to(q.dtype)  # HALF_UP on the magnitude
        out = torch.sign(data) * q
        ok = torch.ones_like(data, dtype=torch.bool)
    ok = ok & (torch.abs(out) < 10 ** min(target.precision, 18))
    return Column(target, torch.where(ok, out, 0), _and_valid(valid, ok))


def check_overflow(col: Column, precision: int, scale: int) -> Column:
    """Spark CheckOverflow (ref proto CheckOverflow): null the values
    beyond the precision."""
    target = DataType(TypeKind.DECIMAL, precision=precision, scale=scale)
    if col.dtype.wide_decimal or target.wide_decimal:
        from blaze_tpu_torch.exprs import wide_decimal as W

        return W.check_overflow(col, precision, scale, target)
    ok = torch.abs(col.data) < 10 ** min(precision, 18)
    return Column(target, torch.where(ok, col.data, 0),
                  _and_valid(col.validity, ok))


def _and_valid(valid, extra):
    return extra if valid is None else (valid & extra)


# ---- string parsing (device) ----

def _argmax_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none), as int32:
    jnp.argmax of a bool matrix."""
    return torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)


def _cols(s) -> torch.Tensor:
    return torch.arange(s.width, dtype=torch.int32, device=s.device)


def _trimmed(s):
    """Start index and length after trimming ASCII spaces."""
    j = _cols(s)
    in_len = j[None, :] < s.lengths[:, None]
    nonspace = in_len & (s.bytes != 0x20)
    any_ns = nonspace.any(dim=1)
    first = _argmax_first(nonspace)
    last = s.width - 1 - _argmax_first(torch.flip(nonspace, [1]))
    zero = torch.zeros_like(first)
    return (torch.where(any_ns, first, zero),
            torch.where(any_ns, last + 1 - first, zero))


def _shifted(s, start: torch.Tensor) -> torch.Tensor:
    """The byte matrix with each row shifted left to `start`."""
    idx = (start[:, None] + _cols(s)[None, :]).clamp(0, s.width - 1)
    return torch.gather(s.bytes, 1, idx.to(torch.int64))


def _byte_at(b: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.gather(b, 1, pos.clamp(0, b.shape[1] - 1).to(
        torch.int64)[:, None])[:, 0]


def _parse_int64(s):
    """(value, ok): an optional sign then digits; overflow or junk is not
    ok."""
    start, length = _trimmed(s)
    b = _shifted(s, start)
    first = b[:, 0]
    neg = first == 0x2D
    has_sign = (neg | (first == 0x2B)).to(torch.int32)
    ndigits = length - has_sign
    acc = torch.zeros((s.capacity,), dtype=torch.int64, device=s.device)
    ok = (ndigits > 0) & (ndigits <= 19)
    overflow = torch.zeros_like(ok)
    for pos in range(min(s.width, 20)):
        c = _byte_at(b, pos + has_sign)
        in_num = pos < ndigits
        ok = ok & (~in_num | ((c >= 0x30) & (c <= 0x39)))
        # uint8 arithmetic, as the JAX package's: a non-digit wraps, and
        # its row is not ok already
        new_acc = acc * 10 + torch.where(in_num, (c - 0x30).to(torch.int64),
                                         0)
        overflow = overflow | (in_num & (new_acc < acc) & (acc > 0))
        acc = torch.where(in_num, new_acc, acc)
    # values longer than the width cannot be digit-complete
    ok = ok & (ndigits <= s.width) & ~overflow
    return torch.where(neg, -acc, acc), ok


def _parse_float64(s):
    """(value, ok): [+-]digits[.digits][eE[+-]digits]."""
    start, length = _trimmed(s)
    j = _cols(s)
    b = _shifted(s, start)
    in_len = j[None, :] < length[:, None]
    is_digit = (b >= 0x30) & (b <= 0x39) & in_len
    is_dot = (b == 0x2E) & in_len
    is_e = ((b == 0x65) | (b == 0x45)) & in_len

    # the first 'e', and the '.' before it
    has_e = is_e.any(dim=1)
    e_pos = torch.where(has_e, _argmax_first(is_e), length)
    dot_in_mant = is_dot & (j[None, :] < e_pos[:, None])
    has_dot = dot_in_mant.any(dim=1)
    dot_pos = torch.where(has_dot, _argmax_first(dot_in_mant), e_pos)

    neg = (b[:, 0] == 0x2D) & in_len[:, 0]
    mstart = (((b[:, 0] == 0x2B) | (b[:, 0] == 0x2D))
              & in_len[:, 0]).to(torch.int32)

    # mantissa digits: positions in [mstart, e_pos) but the dot
    mant = torch.zeros((s.capacity,), dtype=torch.float64, device=s.device)
    frac_digits = torch.zeros((s.capacity,), dtype=torch.int32,
                              device=s.device)
    valid_chars = torch.ones((s.capacity,), dtype=torch.bool,
                             device=s.device)
    for pos in range(s.width):
        here = (pos >= mstart) & (pos < e_pos) & in_len[:, pos]
        d = here & is_digit[:, pos]
        dot_here = here & (pos == dot_pos) & has_dot
        valid_chars = valid_chars & (~here | d | dot_here)
        mant = torch.where(d, mant * 10 + (b[:, pos] - 0x30).to(
            torch.float64), mant)
        frac_digits = frac_digits + (d & (pos > dot_pos) & has_dot).to(
            torch.int32)
    any_mant_digit = (is_digit & (j[None, :] < e_pos[:, None])).any(dim=1)

    # the exponent
    es_start = e_pos + 1
    esign_b = _byte_at(b, es_start)
    eneg = has_e & (esign_b == 0x2D)
    e_has_sign = has_e & ((esign_b == 0x2B) | (esign_b == 0x2D))
    ed_start = es_start + e_has_sign.to(torch.int32)
    exp = torch.zeros((s.capacity,), dtype=torch.int32, device=s.device)
    any_exp_digit = torch.zeros_like(has_e)
    for pos in range(s.width):
        here = has_e & (pos >= ed_start) & (pos < length) & in_len[:, pos]
        d = here & is_digit[:, pos]
        valid_chars = valid_chars & (~here | d)
        step = exp * 10 + (b[:, pos] - 0x30).to(torch.int32)
        exp = torch.where(d, step.clamp(max=400), exp)
        any_exp_digit = any_exp_digit | d
    exp = torch.where(eneg, -exp, exp).to(torch.float64)

    ok = ((length > 0) & valid_chars & any_mant_digit
          & (~has_e | any_exp_digit))
    val = mant * torch.pow(10.0, exp - frac_digits.to(torch.float64))
    return torch.where(neg, -val, val), ok


def _from_string(col: Column, target: DataType) -> Column:
    s = col.data
    tk = target.kind
    if tk == TypeKind.DATE:
        return _string_to_date(col)
    if target.is_integral:
        val, ok = _parse_int64(s)
        lo, hi = _INT_BOUNDS[tk]
        ok = ok & (val >= lo) & (val <= hi)
        return Column(target, torch.where(ok, val, 0).to(
            target.torch_dtype()), _and_valid(col.validity, ok))
    if target.is_floating:
        val, ok = _parse_float64(s)
        return Column(target, torch.where(ok, val, 0.0).to(
            target.torch_dtype()), _and_valid(col.validity, ok))
    if target.wide_decimal:
        # a float source, as exprs/wide_decimal.cast_to_wide refuses it
        # (the JAX package would put int64 values under the wide type)
        raise NotImplementedError(f"cast {col.dtype} -> {target}")
    if target.is_decimal:
        val, ok = _parse_float64(s)
        return _float_to_decimal(torch.where(ok, val, 0.0),
                                 _and_valid(col.validity, ok), target)
    if tk == TypeKind.BOOLEAN:
        from blaze_tpu_torch.exprs import strings as S

        low = S.lower_ascii(StringData(s.bytes, s.lengths))
        cap, dev = col.capacity, col.device

        def any_of(words):
            hit = torch.zeros((cap,), dtype=torch.bool, device=dev)
            for w in words:
                hit = hit | S.equals(low, const_string(w, cap, dev,
                                                       s.width))
            return hit

        truthy = any_of((b"true", b"t", b"yes", b"y", b"1"))
        falsy = any_of((b"false", b"f", b"no", b"n", b"0"))
        return Column(target, truthy,
                      _and_valid(col.validity, truthy | falsy))
    if tk == TypeKind.TIMESTAMP:
        raise TypeError("string->timestamp not yet device-native")
    raise TypeError(f"unsupported cast string -> {target}")


def _string_to_date(col: Column) -> Column:
    """Parse yyyy-[m]m-[d]d (also a bare yyyy or yyyy-mm) to days since
    the epoch."""
    s = col.data
    cap, dev = col.capacity, col.device
    start, length = _trimmed(s)
    j = _cols(s)
    b = _shifted(s, start)
    in_len = j[None, :] < length[:, None]
    is_digit = (b >= 0x30) & (b <= 0x39)
    is_dash = b == 0x2D

    # split on dashes into up to 3 numeric parts: a position's part is
    # the count of dashes before it
    part = torch.cumsum((is_dash & in_len).to(torch.int32), dim=1,
                        dtype=torch.int32)
    part = torch.cat([torch.zeros_like(part[:, :1]), part[:, :-1]], dim=1)
    vals = torch.zeros((cap, 3), dtype=torch.int32, device=dev)
    counts = torch.zeros_like(vals)
    ok = torch.ones((cap,), dtype=torch.bool, device=dev)
    three = torch.arange(3, dtype=torch.int32, device=dev)
    for pos in range(s.width):
        here = in_len[:, pos]
        d = here & is_digit[:, pos]
        ok = (ok & (~here | d | is_dash[:, pos])
              & (~here | (part[:, pos] <= 2)))
        onehot = (part[:, pos].clamp(0, 2)[:, None] == three).to(
            torch.int32)
        digit = (b[:, pos] - 0x30).to(torch.int32)
        # int32 throughout, so that a long run of digits wraps as in the
        # JAX package
        step = vals * (onehot * 9 + 1) + onehot * digit[:, None]
        vals = torch.where(d[:, None], step, vals)
        counts = counts + torch.where(d[:, None], onehot, 0)
    nparts = torch.where(in_len, part, 0).max(dim=1).values.clamp(0, 2) + 1
    year, month, day = vals[:, 0], vals[:, 1], vals[:, 2]
    month = torch.where(nparts >= 2, month, 1)
    day = torch.where(nparts >= 3, day, 1)
    ok = (ok & (length > 0) & (counts[:, 0] >= 1) & (counts[:, 0] <= 4)
          & ((nparts < 2) | (counts[:, 1] >= 1))
          & ((nparts < 3) | (counts[:, 2] >= 1))
          & (month >= 1) & (month <= 12) & (day >= 1) & (day <= 31))
    days = days_from_civil(year, month, day)
    return Column(DATE, torch.where(ok, days, 0).to(torch.int32),
                  _and_valid(col.validity, ok))


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """Howard Hinnant's algorithm, in flooring int64 arithmetic."""
    y, m, d = (t.to(torch.int64) for t in (y, m, d))
    y = y - (m <= 2).to(torch.int64)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def civil_from_days(z: torch.Tensor):
    z = z.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def const_string(value: bytes, cap: int, device, min_width: int = 4
                 ) -> StringData:
    """`value` in every one of `cap` rows, at least `min_width` wide."""
    w = bucket_width(max(len(value), 1, min_width))
    mat = torch.zeros((cap, w), dtype=torch.uint8, device=device)
    if value:
        mat[:, :len(value)] = torch.tensor(list(value), dtype=torch.uint8,
                                           device=device)
    return StringData(mat, torch.full((cap,), len(value), dtype=torch.int32,
                                      device=device))


# ---- number -> string (device digit formatting) ----

def _int_to_string(data: torch.Tensor, valid) -> Column:
    """int64 -> decimal digits. Twenty digits cover -9223372036854775808:
    the digits come from the non-positive value, which holds every
    int64's magnitude (the JAX package's uint64 has no CUDA arithmetic)."""
    v = data.to(torch.int64)
    neg = v < 0
    npos = torch.where(neg, v, -v)   # <= 0
    W = 20
    digits = []
    for _ in range(W):
        q = torch.div(npos, 10, rounding_mode="trunc")
        digits.append((q * 10 - npos).to(torch.uint8))
        npos = q
    digit_mat = torch.stack(digits[::-1], dim=1)  # most significant first
    ndig = (W - _argmax_first(digit_mat != 0)).clamp(min=1)
    ndig = torch.where(v == 0, 1, ndig)
    negi = neg.to(torch.int32)
    total = ndig + negi
    j = torch.arange(bucket_width(W + 1), dtype=torch.int32,
                     device=v.device)
    # output char j: '-' at 0 when negative, else digit W - ndig + j - neg
    src = (W - ndig[:, None] + j[None, :] - negi[:, None]).clamp(0, W - 1)
    dig = torch.gather(digit_mat, 1, src.to(torch.int64)) + 0x30
    out = torch.where(neg[:, None] & (j[None, :] == 0), 0x2D, dig).to(
        torch.uint8)
    mask = j[None, :] < total[:, None]
    return Column(STRING, StringData(torch.where(mask, out, 0).to(
        torch.uint8), total), valid)


def _to_string(col: Column, target: DataType) -> Column:
    k = col.dtype.kind
    if k == TypeKind.BOOLEAN:
        # Spark: 'true' / 'false'
        cap, dev = col.capacity, col.device
        t = const_string(b"true", cap, dev, 5)
        f = const_string(b"false", cap, dev, 5)
        return Column(target, StringData(
            torch.where(col.data[:, None], t.bytes, f.bytes),
            torch.where(col.data, t.lengths, f.lengths)), col.validity)
    if col.dtype.is_integral:
        return _int_to_string(col.data, col.validity)
    if k == TypeKind.DATE:
        return _date_to_string(col, target)
    raise TypeError(f"cast {col.dtype} -> string not yet device-native")


def _date_to_string(col: Column, target: DataType) -> Column:
    y, m, d = civil_from_days(col.data)
    cap, dev = col.capacity, col.device
    dash = torch.full((cap,), 0x2D, dtype=torch.int32, device=dev)
    y = y.clamp(0, 9999)
    chars = [y // div % 10 + 0x30 for div in (1000, 100, 10, 1)]
    chars += [dash, m // 10 + 0x30, m % 10 + 0x30, dash, d // 10 + 0x30,
              d % 10 + 0x30]
    mat = torch.stack(chars, dim=1).to(torch.uint8)
    pad = torch.zeros((cap, bucket_width(10) - 10), dtype=torch.uint8,
                      device=dev)
    return Column(target, StringData(
        torch.cat([mat, pad], dim=1),
        torch.full((cap,), 10, dtype=torch.int32, device=dev)),
        col.validity)
