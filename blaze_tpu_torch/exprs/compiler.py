"""Expression compiler: IR -> torch column functions.

Port of blaze_tpu/exprs/compiler.py for the dense, string and nested
kinds: columns, literals (a nested one only null, as in the JAX package),
casts, arithmetic and comparisons, Kleene AND/OR, NOT, IS [NOT] NULL,
negation, IF, CASE WHEN and [NOT] IN, the string predicates
(StartsWith/EndsWith/Contains), LIKE, the scalar functions of
exprs/functions.py, and struct and map access (GetStructField,
GetIndexedField, GetMapValue, NamedStruct). A compiled expression is
`fn(batch: ColumnBatch) -> Column`, evaluated eagerly on the batch's
device; null semantics are Spark's (strict nulls for most ops, Kleene
AND/OR). The decimal, UDF and subquery kinds raise NotImplementedError
naming the module they wait for.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, StringData, StructData, _zero_column, bucket_width,
)
from blaze_tpu_torch.columnar.types import BOOLEAN, DataType, FLOAT64
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs import strings as S
from blaze_tpu_torch.exprs.cast import cast_column

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
    module = _MODULE_OF.get(type(expr), "exprs/compiler.py")
    raise NotImplementedError(
        f"expression {type(expr).__name__} ({module}) not yet ported")


# the modules the expression kinds still to port wait for
_MODULE_OF = {ir.MakeDecimal: "exprs/wide_decimal.py",
              ir.UnscaledValue: "exprs/wide_decimal.py",
              ir.CheckOverflow: "exprs/wide_decimal.py",
              ir.UdfWrapper: "spark/hive_udf.py",
              ir.ScalarSubquery: "spark/fallback.py"}


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


def const_string(value: bytes, cap: int, device) -> StringData:
    """`value` in every one of `cap` rows."""
    mat = torch.zeros((cap, bucket_width(max(len(value), 1))),
                      dtype=torch.uint8, device=device)
    if value:
        mat[:, :len(value)] = torch.tensor(list(value), dtype=torch.uint8,
                                           device=device)
    return StringData(mat, torch.full((cap,), len(value), dtype=torch.int32,
                                      device=device))


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
    if dt.is_decimal:
        raise NotImplementedError(f"{dt} literals not yet ported")
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


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


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
    if lc.dtype.is_decimal or rc.dtype.is_decimal:
        raise NotImplementedError(
            "decimal arithmetic (exprs/compiler.py _decimal_arith) not yet "
            "ported")
    validity = _strict(lc, rc)
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
    raise NotImplementedError(f"arith op {op} not yet ported")


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
