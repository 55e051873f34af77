"""Expression compiler: IR -> torch column functions.

Port of blaze_tpu/exprs/compiler.py for the dense, decimal, string and
nested kinds: columns, literals (a nested one only null, as in the JAX
package; a wide decimal one as its two limb planes), casts, arithmetic
(decimal arithmetic at the planned result type, wide through
exprs/wide_decimal.py), the bitwise and shift ops, comparisons, Kleene
AND/OR, NOT, IS [NOT] NULL, negation, IF, CASE WHEN and [NOT] IN, the
string predicates (StartsWith/EndsWith/Contains), LIKE, the scalar
functions of exprs/functions.py, MakeDecimal, UnscaledValue and
CheckOverflow, and struct and map access (GetStructField,
GetIndexedField, GetMapValue, NamedStruct). A compiled expression is
`fn(batch: ColumnBatch) -> Column`, evaluated eagerly on the batch's
device; null semantics are Spark's (strict nulls for most ops, Kleene
AND/OR). The UDF wrapper crosses to a host evaluator (exprs/hostfns.py)
and a scalar subquery reads its value from a registered provider.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from blaze_tpu_torch.columnar import int128 as i128
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, StringData, StructData, _zero_column,
)
from blaze_tpu_torch.columnar.types import (
    BOOLEAN, FLOAT64, INT64, DataType, TypeKind,
)
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs import strings as S
from blaze_tpu_torch.exprs import wide_decimal as W
from blaze_tpu_torch.exprs.cast import (
    _and_valid, cast_column, check_overflow, const_string,
)

CompiledExpr = Callable[[ColumnBatch], Column]

# ---------------------------------------------------------------------------
# common-subexpression elimination (ref cached_exprs_evaluator.rs:38-60):
# within one cse_scope — one batch flowing through one operator — each
# distinct expression key evaluates once.
# ---------------------------------------------------------------------------

_cse_tls = threading.local()


@contextlib.contextmanager
def cse_scope():
    prev = getattr(_cse_tls, "memo", None)
    _cse_tls.memo = {}
    try:
        yield
    finally:
        _cse_tls.memo = prev


def compile_expr(expr: ir.Expr, schema) -> CompiledExpr:
    """Bind + lower an expression against an input schema (with CSE when
    evaluated inside a cse_scope)."""
    inner = _compile_expr(expr, schema)
    key = ("cse", expr.key())

    def run(b: ColumnBatch) -> Column:
        memo = getattr(_cse_tls, "memo", None)
        if memo is None:
            return inner(b)
        # the entry RETAINS the batch: keying by id() alone would let a
        # freed batch's address be recycled within the scope
        bkey = (id(b),) + key
        hit = memo.get(bkey)
        if hit is None:
            hit = (b, inner(b))
            memo[bkey] = hit
        return hit[1]

    return run


def _compile_expr(expr: ir.Expr, schema) -> CompiledExpr:
    if isinstance(expr, ir.Col):
        idx = schema.index_of(expr.name)
        return lambda b: b.columns[idx]
    if isinstance(expr, ir.BoundRef):
        idx = expr.index
        return lambda b: b.columns[idx]
    if isinstance(expr, ir.Literal):
        return _compile_literal(expr)
    if isinstance(expr, ir.Binary):
        return _compile_binary(expr, schema)
    if isinstance(expr, ir.Not):
        c = compile_expr(expr.child, schema)
        return lambda b: _map_col(c(b), BOOLEAN, lambda d: ~d)
    if isinstance(expr, ir.Negate):
        c = compile_expr(expr.child, schema)

        def run_neg(b):
            col = c(b)
            if col.dtype.wide_decimal:
                return W.negate(col)
            return Column(col.dtype, -col.data, col.validity)

        return run_neg
    if isinstance(expr, ir.IsNull):
        c = compile_expr(expr.child, schema)
        return lambda b: Column(BOOLEAN, ~c(b).valid_mask(), None)
    if isinstance(expr, ir.IsNotNull):
        c = compile_expr(expr.child, schema)
        return lambda b: Column(BOOLEAN, c(b).valid_mask(), None)
    if isinstance(expr, ir.Cast):
        c = compile_expr(expr.child, schema)
        dt = expr.dtype
        return lambda b: cast_column(c(b), dt)
    if isinstance(expr, ir.If):
        return _compile_case(((expr.cond, expr.then),), expr.otherwise,
                             schema)
    if isinstance(expr, ir.CaseWhen):
        return _compile_case(expr.branches, expr.otherwise, schema)
    if isinstance(expr, ir.InList):
        return _compile_inlist(expr, schema)
    if isinstance(expr, ir.StringPredicate):
        c = compile_expr(expr.child, schema)
        fn = {"starts_with": S.starts_with, "ends_with": S.ends_with,
              "contains": S.contains}[expr.op]
        pat = expr.pattern

        def run_pred(b):
            col = c(b)
            return Column(BOOLEAN, fn(col.data, pat), col.validity)

        return run_pred
    if isinstance(expr, ir.Like):
        c = compile_expr(expr.child, schema)
        pat, esc = expr.pattern, expr.escape

        def run_like(b):
            col = c(b)
            return Column(BOOLEAN, S.like_match(col.data, pat, esc),
                          col.validity)

        return run_like
    if isinstance(expr, ir.ScalarFn):
        from blaze_tpu_torch.exprs.functions import compile_function

        return compile_function(expr, schema)
    if isinstance(expr, ir.MakeDecimal):
        c = compile_expr(expr.child, schema)
        dt = DataType(TypeKind.DECIMAL, precision=expr.precision,
                      scale=expr.scale)

        def run_make(b):
            col = c(b)
            return Column(dt, col.data.to(torch.int64), col.validity)

        return run_make
    if isinstance(expr, ir.UnscaledValue):
        c = compile_expr(expr.child, schema)

        def run_unscaled(b):
            col = c(b)
            return Column(INT64, col.data.to(torch.int64), col.validity)

        return run_unscaled
    if isinstance(expr, ir.CheckOverflow):
        c = compile_expr(expr.child, schema)
        p, s = expr.precision, expr.scale
        return lambda b: check_overflow(c(b), p, s)
    if isinstance(expr, ir.GetStructField):
        c = compile_expr(expr.child, schema)
        i = expr.index

        def run_gsf(b):
            col = c(b)
            child = col.data.children[i]
            v = None
            if col.validity is not None or child.validity is not None:
                v = col.valid_mask() & child.valid_mask()
            return Column(child.dtype, child.data, v)

        return run_gsf
    if isinstance(expr, ir.GetIndexedField):
        return _compile_get_indexed(expr, schema)
    if isinstance(expr, ir.GetMapValue):
        return _compile_get_map_value(expr, schema)
    if isinstance(expr, ir.NamedStruct):
        val_fns = [compile_expr(v, schema) for v in expr.values]
        rt = expr.result_type
        return lambda b: Column(rt, StructData([fn(b) for fn in val_fns]),
                                None)
    if isinstance(expr, ir.UdfWrapper):
        return _compile_udf_wrapper(expr, schema)
    if isinstance(expr, ir.ScalarSubquery):
        return _compile_scalar_subquery(expr)
    raise NotImplementedError(f"cannot compile {type(expr).__name__}")


def _compile_udf_wrapper(expr: ir.UdfWrapper, schema) -> CompiledExpr:
    """Host evaluation of an engine-external expression.

    Ref: SparkUDFWrapperExpr (spark_udf_wrapper.rs): the param columns are
    computed natively and cross to the embedding layer, which evaluates
    the expression row by row and returns the result array
    (SparkUDFWrapperContext.scala:63-111). The crossing is hostfns'
    (one pull of every param column a batch, one upload of the result).
    The registered resource is `fn(*param_numpy_arrays, num_rows) ->
    (values ndarray, validity ndarray | None)`; a string param crosses as
    its (bytes, lengths) pair, every param with its validity after it.
    """
    import numpy as np

    from blaze_tpu_torch.exprs.hostfns import host_apply
    from blaze_tpu_torch.runtime import resources as _res

    param_fns = [compile_expr(p, schema) for p in expr.params]
    rt = expr.return_type
    if rt.is_string_like or rt.kind in (TypeKind.LIST, TypeKind.MAP,
                                        TypeKind.STRUCT):
        raise NotImplementedError(
            f"udf wrapper return type {rt} not yet supported")
    rid = expr.resource_id

    def run(b: ColumnBatch) -> Column:
        host_args = []
        for p in (fn(b) for fn in param_fns):
            if p.is_string:
                host_args += [p.data.bytes, p.data.lengths]
            else:
                host_args.append(p.data)
            host_args.append(p.valid_mask())
        host_args.append(b.num_rows.to(torch.int64).reshape(1))

        def callback(*arrs):
            vals, validity = _res.get(rid)(*arrs[:-1], int(arrs[-1][0]))
            out_v = np.zeros((b.capacity,), rt.np_dtype())
            out_ok = np.zeros((b.capacity,), bool)
            n = min(len(vals), b.capacity)
            out_v[:n] = np.asarray(vals)[:n]
            out_ok[:n] = (True if validity is None
                          else np.asarray(validity)[:n])
            return out_v, out_ok

        shapes = [((b.capacity,), rt.torch_dtype()),
                  ((b.capacity,), torch.bool)]
        vals, ok = host_apply(callback, shapes, b.device, "udf", *host_args)
        return Column(rt, vals, ok & b.row_mask() if expr.nullable else None)

    return run


def _compile_scalar_subquery(expr: ir.ScalarSubquery) -> CompiledExpr:
    """Ref SparkScalarSubqueryWrapperExpr: the provider resource returns
    the (Python) scalar when evaluated; it becomes a literal column."""
    from blaze_tpu_torch.runtime import resources as _res

    def run(b: ColumnBatch) -> Column:
        value = _res.get(expr.resource_id)()
        return _compile_literal(ir.Literal(expr.return_type, value))(b)

    return run


def _compile_get_indexed(expr: ir.GetIndexedField, schema) -> CompiledExpr:
    """Spark GetArrayItem: a 0-based element gather; a negative or
    out-of-range index gives null (ref get_indexed_field.rs). A null index
    makes every row null while keeping the element dtype."""
    c = compile_expr(expr.child, schema)
    i = -1 if expr.index.value is None else int(expr.index.value)

    def run(b: ColumnBatch) -> Column:
        col = c(b)
        ld = col.data
        ok = col.valid_mask() & (i >= 0) & (ld.lengths() > i)
        src = (ld.offsets[:-1].to(torch.int64) + i).clamp(
            0, ld.elements.capacity - 1)
        elem = ld.elements.take(torch.where(ok, src, torch.zeros_like(src)))
        v = ok if elem.validity is None else (elem.validity & ok)
        return Column(elem.dtype, elem.data, v)

    return run


def _compile_get_map_value(expr: ir.GetMapValue, schema) -> CompiledExpr:
    """map[key]: the literal key matched against each row's entries
    (stored as list<struct<key, value>>, types.storage_element), the first
    match's value gathered; no match gives null (ref get_map_value.rs). A
    null key gives null in every row."""
    from blaze_tpu_torch.ops.segment import element_rows

    c = compile_expr(expr.child, schema)
    key_lit = expr.map_key
    lit = _compile_literal(ir.Literal(key_lit.dtype, key_lit.value))

    def run(b: ColumnBatch) -> Column:
        mcol = c(b)
        ld = mcol.data
        kcol, vcol = ld.elements.data.children
        ecap, cap, dev = kcol.capacity, mcol.capacity, mcol.device
        if key_lit.value is None:
            none = torch.zeros((cap,), dtype=torch.int64, device=dev)
            return Column(vcol.dtype, vcol.take(none).data,
                          torch.zeros((cap,), dtype=torch.bool, device=dev))
        slot, row, _, in_row = element_rows(ld.offsets, cap, ecap)
        in_row = in_row & (slot >= ld.offsets[row])
        key = lit(_Rows(ecap, dev))
        if kcol.is_string:
            match = S.equals(kcol.data, key.data)
        else:
            match = kcol.data == key.data
        hit = in_row & match & kcol.valid_mask()
        # the first matching entry of each row: a scatter-min of the slot
        idx = torch.full((cap + 1,), ecap, dtype=torch.int64, device=dev)
        idx.scatter_reduce_(0, torch.where(hit, row, cap),
                            torch.where(hit, slot, ecap), "amin",
                            include_self=True)
        idx = idx[:cap]
        ok = (idx < ecap) & mcol.valid_mask()
        val = vcol.take(idx.clamp(0, ecap - 1))
        v = ok if val.validity is None else (val.validity & ok)
        return Column(vcol.dtype, val.data, v)

    return run


class _Rows:
    """The capacity and device of a batch, all a literal reads."""

    def __init__(self, capacity: int, device) -> None:
        self.capacity, self.device = capacity, device


def _compile_literal(expr: ir.Literal) -> CompiledExpr:
    dt, v = expr.dtype, expr.value
    if dt.is_nested and v is None:
        # a null list, map or struct: empty storage, every row invalid
        def run_null(b: ColumnBatch) -> Column:
            z = _zero_column(dt, b.capacity, b.device)
            return Column(dt, z.data, torch.zeros(
                (b.capacity,), dtype=torch.bool, device=b.device))

        return run_null
    if dt.is_nested:
        raise TypeError(f"a {dt} literal has no device form (only null)")
    if dt.wide_decimal:
        # the limb words split on the host: the value may pass int64
        hi, lo = (int(p[0]) for p in i128.np_from_ints(
            [0 if v is None else int(v)]))

        def run_wide(b: ColumnBatch) -> Column:
            cap, dev = b.capacity, b.device
            valid = (torch.zeros((cap,), dtype=torch.bool, device=dev)
                     if v is None else None)
            return W.build(dt, *(torch.full((cap,), w, dtype=torch.int64,
                                            device=dev) for w in (hi, lo)),
                           valid)

        return run_wide
    if dt.is_string_like:
        raw = b"" if v is None else (
            v.encode() if isinstance(v, str) else bytes(v))

        def run_str(b: ColumnBatch) -> Column:
            cap, dev = b.capacity, b.device
            valid = (torch.zeros((cap,), dtype=torch.bool, device=dev)
                     if v is None else None)
            return Column(dt, const_string(raw, cap, dev), valid)

        return run_str
    tdt = dt.torch_dtype()

    def run(b: ColumnBatch) -> Column:
        cap, dev = b.capacity, b.device
        if v is None:
            return Column(dt, torch.zeros((cap,), dtype=tdt, device=dev),
                          torch.zeros((cap,), dtype=torch.bool, device=dev))
        return Column(dt, torch.full((cap,), v, dtype=tdt, device=dev), None)

    return run


def _map_col(col: Column, dtype: DataType, fn) -> Column:
    return Column(dtype, fn(col.data), col.validity)


_CMP = {ir.BinOp.EQ, ir.BinOp.NEQ, ir.BinOp.LT, ir.BinOp.LE, ir.BinOp.GT,
        ir.BinOp.GE, ir.BinOp.EQ_NULLSAFE}


def _compile_binary(expr: ir.Binary, schema) -> CompiledExpr:
    lf = compile_expr(expr.left, schema)
    rf = compile_expr(expr.right, schema)
    op = expr.op

    if op in (ir.BinOp.AND, ir.BinOp.OR):
        return _compile_kleene(lf, rf, op)
    if op in _CMP:
        return lambda b: _compare(lf(b), rf(b), op)

    rt = expr.result_type

    def run(b: ColumnBatch) -> Column:
        return _arith(lf(b), rf(b), op, rt)

    return run


def _compare(lc: Column, rc: Column, op: ir.BinOp) -> Column:
    if lc.dtype.wide_decimal or rc.dtype.wide_decimal:
        lt, eq, gt = W.compare(lc, rc)
        res = {ir.BinOp.EQ: eq, ir.BinOp.NEQ: ~eq, ir.BinOp.LT: lt,
               ir.BinOp.LE: lt | eq, ir.BinOp.GT: gt, ir.BinOp.GE: gt | eq,
               ir.BinOp.EQ_NULLSAFE: eq}[op]
        if op == ir.BinOp.EQ_NULLSAFE:
            lv, rv = lc.valid_mask(), rc.valid_mask()
            return Column(BOOLEAN, (~lv & ~rv) | (lv & rv & res), None)
        return Column(BOOLEAN, res, _strict(lc, rc))
    if lc.is_string or rc.is_string:
        lt, eq = S.compare(lc.data, rc.data)
        res = {ir.BinOp.EQ: eq, ir.BinOp.NEQ: ~eq, ir.BinOp.LT: lt,
               ir.BinOp.LE: lt | eq, ir.BinOp.GT: ~lt & ~eq,
               ir.BinOp.GE: ~lt, ir.BinOp.EQ_NULLSAFE: eq}[op]
        if op == ir.BinOp.EQ_NULLSAFE:
            lv, rv = lc.valid_mask(), rc.valid_mask()
            return Column(BOOLEAN, (~lv & ~rv) | (lv & rv & res), None)
        return Column(BOOLEAN, res, _strict(lc, rc))
    ld, rd = _promote(lc, rc)
    if op == ir.BinOp.EQ:
        res = ld == rd
    elif op == ir.BinOp.NEQ:
        res = ld != rd
    elif op == ir.BinOp.LT:
        res = ld < rd
    elif op == ir.BinOp.LE:
        res = ld <= rd
    elif op == ir.BinOp.GT:
        res = ld > rd
    elif op == ir.BinOp.GE:
        res = ld >= rd
    else:  # EQ_NULLSAFE
        lv, rv = lc.valid_mask(), rc.valid_mask()
        return Column(BOOLEAN, (~lv & ~rv) | (lv & rv & (ld == rd)), None)
    return Column(BOOLEAN, res, _strict(lc, rc))


def _strict(*cols: Column):
    v = None
    for c in cols:
        v = c.validity if v is None else (
            v if c.validity is None else (v & c.validity))
    return v


def _promote(lc: Column, rc: Column):
    ld, rd = lc.data, rc.data
    if ld.dtype != rd.dtype:
        target = torch.promote_types(ld.dtype, rd.dtype)
        ld, rd = ld.to(target), rd.to(target)
    return ld, rd


def _compile_kleene(lf, rf, op) -> CompiledExpr:
    def run(b: ColumnBatch) -> Column:
        lc, rc = lf(b), rf(b)
        lv, rv = lc.valid_mask(), rc.valid_mask()
        lt = lc.data.to(torch.bool)
        rt_ = rc.data.to(torch.bool)
        if lc.validity is not None:
            lt = lt & lv
        if rc.validity is not None:
            rt_ = rt_ & rv
        if op == ir.BinOp.AND:
            val = lt & rt_
            # false & anything = false (valid); else null if either null
            valid = (lv & rv) | (lv & ~lt) | (rv & ~rt_)
        else:
            val = lt | rt_
            valid = (lv & rv) | (lv & lt) | (rv & rt_)
        if lc.validity is None and rc.validity is None:
            return Column(BOOLEAN, val, None)
        return Column(BOOLEAN, val & valid, valid)

    return run


def _arith(lc: Column, rc: Column, op: ir.BinOp,
           result_type: Optional[DataType]) -> Column:
    validity = _strict(lc, rc)
    if lc.dtype.is_decimal or rc.dtype.is_decimal:
        return _decimal_arith(lc, rc, op, result_type, validity)
    ld, rd = _promote(lc, rc)
    out_dt = result_type or (lc.dtype if lc.dtype.is_numeric else rc.dtype)
    if op == ir.BinOp.ADD:
        return Column(out_dt, ld + rd, validity)
    if op == ir.BinOp.SUB:
        return Column(out_dt, ld - rd, validity)
    if op == ir.BinOp.MUL:
        return Column(out_dt, ld * rd, validity)
    if op == ir.BinOp.DIV:
        if lc.dtype.is_integral and rc.dtype.is_integral:
            ld = ld.to(torch.float64)
            rd = rd.to(torch.float64)
            out_dt = result_type or FLOAT64
        zero = rd == 0
        res = ld / torch.where(zero, torch.ones_like(rd), rd)
        return Column(out_dt, torch.where(zero, torch.zeros_like(res), res),
                      _and_valid(validity, ~zero))
    if op == ir.BinOp.MOD:
        zero = rd == 0
        safe = torch.where(zero, torch.ones_like(rd), rd)
        # spark/java remainder: sign follows dividend
        res = torch.fmod(ld, safe)
        return Column(out_dt, torch.where(zero, torch.zeros_like(res), res),
                      _and_valid(validity, ~zero))
    if op in _BITWISE:
        return Column(out_dt, _BITWISE[op](ld, rd), validity)
    if op in (ir.BinOp.SHIFT_LEFT, ir.BinOp.SHIFT_RIGHT):
        return Column(out_dt, _shift(ld, rd, op == ir.BinOp.SHIFT_LEFT),
                      validity)
    raise NotImplementedError(f"arith op {op}")


_BITWISE = {ir.BinOp.BIT_AND: torch.bitwise_and,
            ir.BinOp.BIT_OR: torch.bitwise_or,
            ir.BinOp.BIT_XOR: torch.bitwise_xor}


def _shift(ld: torch.Tensor, rd: torch.Tensor, left: bool) -> torch.Tensor:
    """XLA's shift semantics, which the JAX package's `<<` and `>>` have:
    a count outside [0, bits) shifts every bit out (0, or the sign's fill
    for a right shift). torch shifts by such counts differently on the CPU
    and on CUDA, so the count is clamped into range and the out-of-range
    rows are set apart."""
    bits = torch.iinfo(ld.dtype).bits
    out_of_range = (rd < 0) | (rd >= bits)
    n = rd.clamp(0, bits - 1)
    if left:
        return torch.where(out_of_range, 0, ld << n).to(ld.dtype)
    fill = torch.where(ld < 0, -1, 0).to(ld.dtype)
    return torch.where(out_of_range, fill, ld >> n)


def _decimal_arith(lc: Column, rc: Column, op: ir.BinOp,
                   result_type: Optional[DataType], validity) -> Column:
    """Unscaled int64 decimal arithmetic at the result type the plan gives
    (ref NativeConverters.scala:599-676, the decimal special cases); a
    wide operand or result goes through exprs/wide_decimal.py."""
    if (lc.dtype.wide_decimal or rc.dtype.wide_decimal
            or (result_type is not None and result_type.wide_decimal)):
        if result_type is None or not result_type.is_decimal:
            raise NotImplementedError(
                "wide decimal arithmetic needs a planned result type")
        return W.arith(lc, rc, op, result_type, validity)
    ls = lc.dtype.scale if lc.dtype.is_decimal else 0
    rs = rc.dtype.scale if rc.dtype.is_decimal else 0
    ld = lc.data.to(torch.int64)
    rd = rc.data.to(torch.int64)
    if result_type is None or not result_type.is_decimal:
        # a plausible result type where the plan gave none
        if op in (ir.BinOp.ADD, ir.BinOp.SUB):
            scale = max(ls, rs)
        elif op == ir.BinOp.MUL:
            scale = ls + rs
        else:
            scale = max(6, ls + rs + 1)
        result_type = DataType(TypeKind.DECIMAL, precision=18, scale=scale)
    out_s = result_type.scale
    if op in (ir.BinOp.ADD, ir.BinOp.SUB):
        lu = ld * (10 ** max(out_s - ls, 0))
        ru = rd * (10 ** max(out_s - rs, 0))
        res = lu + ru if op == ir.BinOp.ADD else lu - ru
        return Column(result_type, res, validity)
    if op == ir.BinOp.MUL:
        prod = ld * rd  # at scale ls + rs
        ds = out_s - (ls + rs)
        if ds >= 0:
            return Column(result_type, prod * (10 ** ds), validity)
        return Column(result_type, _div_half_up(prod, 10 ** (-ds)),
                      validity)
    if op == ir.BinOp.DIV:
        zero = rd == 0
        safe = torch.where(zero, 1, rd)
        # q = l / r at out_s: (ld * 10^(out_s + rs - ls)) / rd, HALF_UP
        shift = out_s + rs - ls
        num = ld * (10 ** max(shift, 0))
        den = safe * (10 ** max(-shift, 0))
        q = torch.sign(num) * torch.sign(den) * _div_half_up(
            torch.abs(num), torch.abs(den))
        return Column(result_type, torch.where(zero, 0, q),
                      _and_valid(validity, ~zero))
    raise NotImplementedError(f"decimal op {op}")


def _div_half_up(x: torch.Tensor, div) -> torch.Tensor:
    """x / div rounded HALF_UP on the magnitude, with x's sign (div > 0)."""
    q = torch.abs(x) // div
    r = torch.abs(x) % div
    return torch.sign(x) * (q + (2 * r >= div).to(q.dtype))


def _compile_case(branches, otherwise, schema) -> CompiledExpr:
    """CASE WHEN (and IF, one branch): the first branch whose condition is
    true and valid wins; no branch and no ELSE gives null."""
    conds = [compile_expr(c, schema) for c, _ in branches]
    vals = [compile_expr(v, schema) for _, v in branches]
    other = compile_expr(otherwise, schema) if otherwise is not None else None

    def run(b: ColumnBatch) -> Column:
        vcols = [f(b) for f in vals]
        ocol = other(b) if other is not None else None
        all_vals = vcols + ([ocol] if ocol is not None else [])
        out_dtype = all_vals[0].dtype
        is_str = all_vals[0].is_string
        if is_str:
            # every branch at the widest branch's width
            w = max(v.data.width for v in all_vals)
            all_vals = [Column(v.dtype, S.ensure_width(StringData(
                v.data.bytes, v.data.lengths), w), v.validity)
                for v in all_vals]
            vcols = all_vals[:len(vcols)]
            ocol = all_vals[-1] if ocol is not None else None
        # start from the ELSE (or null), then apply the branches; the
        # `taken` mask lets an earlier branch win over a later one
        if ocol is not None:
            acc_data, acc_valid = ocol.data, ocol.valid_mask()
        else:
            proto = all_vals[0].data
            acc_data = (StringData(torch.zeros_like(proto.bytes),
                                   torch.zeros_like(proto.lengths))
                        if is_str else torch.zeros_like(proto))
            acc_valid = torch.zeros((b.capacity,), dtype=torch.bool,
                                    device=b.device)
        taken = torch.zeros((b.capacity,), dtype=torch.bool, device=b.device)
        for cf, vcol in zip(conds, vcols):
            ccol = cf(b)
            fire = ccol.data.to(torch.bool) & ccol.valid_mask() & ~taken
            if is_str:
                acc_data = StringData(
                    torch.where(fire[:, None], vcol.data.bytes,
                                acc_data.bytes),
                    torch.where(fire, vcol.data.lengths, acc_data.lengths))
            else:
                acc_data = torch.where(fire, vcol.data, acc_data)
            acc_valid = torch.where(fire, vcol.valid_mask(), acc_valid)
            taken = taken | fire
        return Column(out_dtype, acc_data, acc_valid)

    return run


def _compile_inlist(expr: ir.InList, schema) -> CompiledExpr:
    """Spark's three-valued IN: TRUE on a match; NULL when the operand is
    null, or when nothing matched and the list holds a null; FALSE
    otherwise. NOT IN flips the value and keeps the nullness."""
    cf = compile_expr(expr.child, schema)
    lits = [compile_expr(v, schema) for v in expr.values]
    negated = expr.negated
    has_null_lit = any(isinstance(v, ir.Literal) and v.value is None
                       for v in expr.values)

    def run(b: ColumnBatch) -> Column:
        ccol = cf(b)
        hit = torch.zeros((b.capacity,), dtype=torch.bool, device=b.device)
        for lf in lits:
            lcol = lf(b)
            if ccol.is_string:
                eq = S.equals(ccol.data, lcol.data)
            else:
                ld, rd = _promote(ccol, lcol)
                eq = ld == rd
            hit = hit | (eq & lcol.valid_mask())
        res = ~hit if negated else hit
        if ccol.validity is None and not has_null_lit:
            return Column(BOOLEAN, res, None)
        valid = ccol.valid_mask()
        if has_null_lit:
            valid = valid & hit
        return Column(BOOLEAN, res, valid)

    return run
