"""Decimal128 (p > 18) expression kernels over int64 limb-plane columns.

Port of blaze_tpu/exprs/wide_decimal.py (ref: the reference computes
decimals as Decimal128 end to end; NativeConverters.scala:599-676 supplies
the result precision and scale Spark planned). Narrow decimals (p <= 18)
stay unscaled int64; these kernels cover operations whose operands or
result are wide, held as StructData [hi int64, lo int64 read as unsigned]
(columnar/int128.py).

Covered, and enforced at plan time by the wide-decimal walk of
spark/converters.py: add and sub; mul while p1 + p2 <= 38 (the product
fits 128 bits); division by bit-serial 128-bit long division
(int128.divmod_full) with HALF_UP at the planned scale while the scale
alignment provably fits 128 bits; every comparison; negation; casts from
int, narrow and wide decimal to wide, and from wide to narrow, int and
float64; CheckOverflow (null outside 10^p, Spark non-ANSI); and the
segmented sum, min, max and avg kernels of ops/agg.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from blaze_tpu_torch.columnar import int128 as i128
from blaze_tpu_torch.columnar.batch import Column, StructData
from blaze_tpu_torch.columnar.types import FLOAT64, INT64, DataType, TypeKind
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.cast import div_exact

Planes = Tuple[torch.Tensor, torch.Tensor]

_I64_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF
# any |sum| past this is beyond every valid decimal precision (10^38 <
# 1.5e38 < 2^127), so flagging it cannot null a representable result; it
# catches the true 128-bit wraps that CheckOverflow's range test cannot see
_OVERFLOW_BOUND = 1.5e38


def planes(col: Column) -> Planes:
    """(hi, lo) planes of a decimal column, widening narrow storage."""
    if col.dtype.wide_decimal:
        return col.data.children[0].data, col.data.children[1].data
    return i128.from_i64(col.data)


def build(dtype: DataType, hi: torch.Tensor, lo: torch.Tensor,
          validity: Optional[torch.Tensor]) -> Column:
    return Column(dtype, StructData(
        [Column(INT64, hi, None), Column(INT64, lo, None)]), validity)


def _and_ok(validity: Optional[torch.Tensor], ok: torch.Tensor
            ) -> torch.Tensor:
    return ok if validity is None else (validity & ok)


def _rescale_to(col: Column, out_scale: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, lo, ok): rows with ok=False wrapped during an upscale (their
    true magnitude passes 2^127 after it) and must go null or saturate."""
    h, l = planes(col)
    return i128.rescale_checked(h, l, out_scale - col.dtype.scale)


def arith(lc: Column, rc: Column, op: ir.BinOp, result_type: DataType,
          validity: Optional[torch.Tensor]) -> Column:
    """ADD/SUB/MUL/DIV with a wide operand or result (plan-checked bounds).
    Rows whose operands wrap during the scale alignment come out null,
    which is Spark's own result there after CheckOverflow."""
    out_s = result_type.scale
    if op in (ir.BinOp.ADD, ir.BinOp.SUB):
        lh, ll, lok = _rescale_to(lc, out_s)
        rh, rl, rok = _rescale_to(rc, out_s)
        h, l = (i128.add(lh, ll, rh, rl) if op == ir.BinOp.ADD
                else i128.sub(lh, ll, rh, rl))
        return _shape(result_type, h, l, _and_ok(validity, lok & rok))
    if op == ir.BinOp.MUL:
        h, l = _mul(lc, rc)
        h, l, ok = i128.rescale_checked(
            h, l, out_s - (lc.dtype.scale + rc.dtype.scale))
        return _shape(result_type, h, l, _and_ok(validity, ok))
    if op == ir.BinOp.DIV:
        return _div(lc, rc, result_type, validity)
    raise NotImplementedError(f"wide decimal op {op}")


def _div(lc: Column, rc: Column, result_type: DataType,
         validity: Optional[torch.Tensor]) -> Column:
    """Spark decimal division: HALF_UP at the planner's result scale.

    value = round(a * 10^delta / b) with delta = out_s - a.s + b.s; a
    negative delta scales the DIVISOR up instead (both checked for a
    128-bit wrap). Divide by zero and quotients outside the precision go
    null (Spark non-ANSI; ref Spark Decimal.divide, BigDecimal HALF_UP)."""
    delta = result_type.scale - lc.dtype.scale + rc.dtype.scale
    ah, al = planes(lc)
    bh, bl = planes(rc)
    if delta >= 0:
        ah, al, ok = i128.rescale_checked(ah, al, delta, half_up=False)
    else:
        bh, bl, ok = i128.rescale_checked(bh, bl, -delta, half_up=False)
    nonzero = (bh != 0) | (bl != 0)
    sign = i128.is_neg(ah, al) ^ i128.is_neg(bh, bl)
    qh, ql, rh, rl = i128.divmod_full(ah, al, bh, bl)
    # HALF_UP: bump |q| when 2 * rem >= |b| (128-bit unsigned compare;
    # rem < |b| < 2^127, so a carry out of the doubling decides alone)
    abh, abl = i128.abs_(bh, bl)
    carry = (rh >> 63) & 1
    r2h = (rh << 1) | ((rl >> 63) & 1)
    r2l = rl << 1
    ge = (carry == 1) | ~(i128._u_lt(r2h, abh)
                          | ((r2h == abh) & i128._u_lt(r2l, abl)))
    qh, ql = i128.add(qh, ql, torch.zeros_like(qh), ge.to(torch.int64))
    nh, nl = i128.neg(qh, ql)
    h = torch.where(sign, nh, qh)
    l = torch.where(sign, nl, ql)
    ok = ok & nonzero & i128.in_precision(h, l, result_type.precision)
    return _shape(result_type, h, l, _and_ok(validity, ok))


def _mul(lc: Column, rc: Column) -> Planes:
    if not lc.dtype.wide_decimal and not rc.dtype.wide_decimal:
        return i128.mul_i64(lc.data.to(torch.int64),
                            rc.data.to(torch.int64))
    # one side wide: |product| < 10^38 < 2^127 (plan bound p1 + p2 <= 38),
    # so sign-magnitude schoolbook on the low 128 bits is exact
    ah, al = planes(lc)
    bh, bl = planes(rc)
    sign = i128.is_neg(ah, al) ^ i128.is_neg(bh, bl)
    ah, al = i128.abs_(ah, al)
    bh, bl = i128.abs_(bh, bl)
    ph, pl = i128._mul_u64(al, bl)
    ph = ph + al * bh + ah * bl          # low-64 wraps of the cross terms
    nh, nl = i128.neg(ph, pl)
    return torch.where(sign, nh, ph), torch.where(sign, nl, pl)


def _shape(result_type: DataType, h: torch.Tensor, l: torch.Tensor,
           validity: Optional[torch.Tensor]) -> Column:
    """Wide results keep the limb planes; a narrow result type (Spark may
    plan p <= 18 for an expression over wide operands) compacts back."""
    if result_type.wide_decimal:
        return build(result_type, h, l, validity)
    v64, fits = i128.to_i64_checked(h, l)
    return Column(result_type, v64, _and_ok(validity, fits))


def compare(lc: Column, rc: Column
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lt, eq, gt) with the scales aligned (Catalyst normally equalizes
    the types; unequal scales upscale the smaller side). A side that would
    wrap during the upscale saturates to +/-max128: its true magnitude
    beats anything representable, so the order holds."""
    s = max(lc.dtype.scale, rc.dtype.scale)
    lh, ll, lok = _rescale_to(lc, s)
    rh, rl, rok = _rescale_to(rc, s)
    lh, ll = _saturate(lh, ll, lok, *planes(lc))
    rh, rl = _saturate(rh, rl, rok, *planes(rc))
    c = i128.cmp(lh, ll, rh, rl)
    return c < 0, c == 0, c > 0


def _saturate(h: torch.Tensor, l: torch.Tensor, ok: torch.Tensor,
              oh: torch.Tensor, ol: torch.Tensor) -> Planes:
    neg = i128.is_neg(oh, ol)
    sat_h = torch.where(neg, _I64_MIN, (1 << 63) - 1)
    sat_l = torch.where(neg, 0, -1)
    return torch.where(ok, h, sat_h), torch.where(ok, l, sat_l)


def negate(col: Column) -> Column:
    nh, nl = i128.neg(*planes(col))
    return build(col.dtype, nh, nl, col.validity)


def check_overflow(col: Column, precision: int, scale: int,
                   result_type: DataType) -> Column:
    """Spark CheckOverflow (non-ANSI): rescale, then null outside 10^p."""
    h, l, rok = _rescale_to(col, scale)
    ok = rok & i128.in_precision(h, l, precision)
    return _shape(result_type, h, l, _and_ok(col.validity, ok))


def cast_to_wide(col: Column, target: DataType) -> Column:
    """int / narrow decimal / wide decimal -> wide decimal."""
    src = col.dtype
    if src.is_decimal:
        h, l, rok = _rescale_to(col, target.scale)
    elif src.kind in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                      TypeKind.INT64, TypeKind.BOOLEAN):
        h, l = i128.from_i64(col.data.to(torch.int64))
        h, l, rok = i128.rescale_checked(h, l, target.scale)
    else:
        raise NotImplementedError(f"cast {src} -> {target}")
    ok = rok & i128.in_precision(h, l, target.precision)
    return build(target, h, l, _and_ok(col.validity, ok))


def cast_from_wide(col: Column, target: DataType) -> Column:
    """wide decimal -> narrow decimal / integral / float64."""
    h, l = planes(col)
    if target.is_decimal and not target.wide_decimal:
        h, l = i128.rescale(h, l, target.scale - col.dtype.scale)
        v64, fits = i128.to_i64_checked(h, l)
        ok = fits & i128.in_precision(h, l, target.precision)
        return Column(target, v64, _and_ok(col.validity, ok))
    if target.kind == TypeKind.FLOAT64:
        # convert the MAGNITUDE: a negative value as hi * 2^64 + lo would
        # cancel catastrophically (-2^64 + u64(lo) loses the low bits)
        neg = i128.is_neg(h, l)
        ah, al = i128.abs_(h, l)
        lo_f = al.to(torch.float64)
        lo_u = torch.where(al < 0, lo_f + 2.0 ** 64, lo_f)
        v = ah.to(torch.float64) * 2.0 ** 64 + lo_u
        v = torch.where(neg, -v, v)
        return Column(FLOAT64, div_exact(v, 10.0 ** col.dtype.scale),
                      col.validity)
    if target.kind in (TypeKind.INT32, TypeKind.INT64):
        # truncate the fraction, then narrow with overflow to null
        h, l = i128.rescale(h, l, -col.dtype.scale, half_up=False)
        out, fits = i128.to_i64_checked(h, l)
        if target.kind == TypeKind.INT32:
            fits = fits & (out >= -(1 << 31)) & (out < (1 << 31))
            out = out.to(torch.int32)
        return Column(target, out, _and_ok(col.validity, fits))
    raise NotImplementedError(f"cast {col.dtype} -> {target}")


# -- segmented aggregation kernels (ops/agg.py's wide branches) ------------


def seg_sum_wide(h: torch.Tensor, l: torch.Tensor, valid: torch.Tensor,
                 layout, seg) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Per-group 128-bit sums via four signed 32-bit limb plane sums (each
    limb sum is int64-exact below 2^31 rows). Returns (hi, lo, ok) per
    group slot; ok=False marks a magnitude overflow, seen on an f64 shadow
    (sums beyond 2^127 wrap mod 2^128)."""
    neg = h < 0
    nh, nl = i128.neg(h, l)
    ah = torch.where(neg, nh, h)
    al = torch.where(neg, nl, l)
    sgn = torch.where(neg, -1, 1)
    limbs = [al & _M32, (al >> 32) & _M32, ah & _M32, (ah >> 32) & _M32]
    s0, s1, s2, s3 = (seg.seg_sum(limb * sgn, layout, valid)
                      for limb in limbs)
    # the low 128 bits: s0 + s1 * 2^32 + (s2 + s3 * 2^32) * 2^64
    h1, l1 = i128.mul_small(*i128.from_i64(s1), 1 << 32)
    acc_h, acc_l = i128.add(*i128.from_i64(s0), h1, l1)
    acc_h = acc_h + s2 + (s3 << 32)
    # the f64 shadow: the exact magnitude to ~2^-50 relative
    approx = (s0.to(torch.float64) + s1.to(torch.float64) * 2.0 ** 32
              + s2.to(torch.float64) * 2.0 ** 64
              + s3.to(torch.float64) * 2.0 ** 96)
    return acc_h, acc_l, approx.abs() < _OVERFLOW_BOUND


def seg_minmax_wide(h: torch.Tensor, l: torch.Tensor, valid: torch.Tensor,
                    layout, seg, is_min: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group 128-bit min/max: reduce the signed hi plane, then the lo
    plane among the rows at the winning hi (lo compared unsigned through
    the sign flip)."""
    red = seg.seg_min if is_min else seg.seg_max
    mh, has = red(h, layout, valid)
    at_extreme = valid & (h == mh[layout.gid.clamp(min=0)])
    ml_s, _ = red(l ^ _I64_MIN, layout, at_extreme)
    return mh, ml_s ^ _I64_MIN, has


def div_by_count(h: torch.Tensor, l: torch.Tensor, cnt: torch.Tensor,
                 result: DataType, extra_scale: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum * 10^extra_scale) / cnt with HALF_UP: the avg finalize. Returns
    (hi, lo, ok); ok=False where the upscale wrapped or the count passes
    the limb division's < 2^31 divisor bound (such groups go null rather
    than divide by a clamped count)."""
    rok = torch.ones(h.shape, dtype=torch.bool, device=h.device)
    if extra_scale:
        h, l, rok = i128.rescale_checked(h, l, extra_scale)
    sign = h < 0
    cnt_ok = cnt < (1 << 31)
    dd = cnt.clamp(1, (1 << 31) - 1)
    qh, ql, rem = i128.divmod_small(h, l, dd)
    bump = (2 * rem >= dd).to(torch.int64)
    qh, ql = i128.add(qh, ql, torch.zeros_like(qh), bump)
    nh, nl = i128.neg(qh, ql)
    ok = rok & cnt_ok & i128.in_precision(qh, ql, result.precision)
    return torch.where(sign, nh, qh), torch.where(sign, nl, ql), ok
