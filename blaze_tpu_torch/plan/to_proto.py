"""IR/schema -> protobuf encoders (the driver-side half of the contract).

Port of blaze_tpu/plan/to_proto.py over the port's plan_pb2 (ref:
NativeConverters.scala's type/schema/expression serialization). It
encodes every expression kind the JAX package encodes, strings, Like and
ScalarFn included, and writes the fields in the same order, so a plan
encodes to the same bytes in both packages. The encoder is pure Python;
the decoder (from_proto.py), not the encoder, rejects a kind the port
cannot run yet.
"""

from __future__ import annotations

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.from_proto import _FN_NAME

_KIND_TO_PB = {
    T.TypeKind.NULL: pb.TK_NULL,
    T.TypeKind.BOOLEAN: pb.TK_BOOL,
    T.TypeKind.INT8: pb.TK_INT8,
    T.TypeKind.INT16: pb.TK_INT16,
    T.TypeKind.INT32: pb.TK_INT32,
    T.TypeKind.INT64: pb.TK_INT64,
    T.TypeKind.FLOAT32: pb.TK_FLOAT32,
    T.TypeKind.FLOAT64: pb.TK_FLOAT64,
    T.TypeKind.STRING: pb.TK_STRING,
    T.TypeKind.BINARY: pb.TK_BINARY,
    T.TypeKind.DATE: pb.TK_DATE32,
    T.TypeKind.TIMESTAMP: pb.TK_TIMESTAMP_MICROS,
    T.TypeKind.DECIMAL: pb.TK_DECIMAL,
    T.TypeKind.LIST: pb.TK_LIST,
    T.TypeKind.MAP: pb.TK_MAP,
    T.TypeKind.STRUCT: pb.TK_STRUCT,
}

_BINOP_TO_PB = {
    ir.BinOp.ADD: pb.OP_ADD, ir.BinOp.SUB: pb.OP_SUB,
    ir.BinOp.MUL: pb.OP_MUL, ir.BinOp.DIV: pb.OP_DIV,
    ir.BinOp.MOD: pb.OP_MOD, ir.BinOp.EQ: pb.OP_EQ,
    ir.BinOp.NEQ: pb.OP_NEQ, ir.BinOp.LT: pb.OP_LT,
    ir.BinOp.LE: pb.OP_LE, ir.BinOp.GT: pb.OP_GT,
    ir.BinOp.GE: pb.OP_GE, ir.BinOp.AND: pb.OP_AND,
    ir.BinOp.OR: pb.OP_OR, ir.BinOp.EQ_NULLSAFE: pb.OP_EQ_NULLSAFE,
    ir.BinOp.BIT_AND: pb.OP_BIT_AND, ir.BinOp.BIT_OR: pb.OP_BIT_OR,
    ir.BinOp.BIT_XOR: pb.OP_BIT_XOR,
    ir.BinOp.SHIFT_LEFT: pb.OP_SHIFT_LEFT,
    ir.BinOp.SHIFT_RIGHT: pb.OP_SHIFT_RIGHT,
}

_FN_TO_PB = {name: val for val, name in _FN_NAME.items()}


def encode_dtype(dt: T.DataType) -> pb.DataType:
    out = pb.DataType(kind=_KIND_TO_PB[dt.kind])
    if dt.kind == T.TypeKind.DECIMAL:
        out.precision, out.scale = dt.precision, dt.scale
    elif dt.kind == T.TypeKind.LIST:
        out.element.CopyFrom(encode_dtype(dt.element))
    elif dt.kind == T.TypeKind.MAP:
        out.map_key.CopyFrom(encode_dtype(dt.key))
        out.element.CopyFrom(encode_dtype(dt.element))
    elif dt.kind == T.TypeKind.STRUCT:
        for f in dt.fields:
            out.struct_fields.add(name=f.name,
                                  dtype=encode_dtype(f.dtype),
                                  nullable=f.nullable)
    return out


def encode_schema(schema: T.Schema) -> pb.Schema:
    out = pb.Schema()
    for f in schema:
        out.fields.add(name=f.name, dtype=encode_dtype(f.dtype),
                       nullable=f.nullable)
    return out


def encode_literal(lit: ir.Literal) -> pb.ScalarValue:
    out = pb.ScalarValue(dtype=encode_dtype(lit.dtype))
    v = lit.value
    if v is None:
        out.is_null = True
        return out
    k = lit.dtype.kind
    if k == T.TypeKind.BOOLEAN:
        out.bool_value = bool(v)
    elif k in (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32,
               T.TypeKind.INT64, T.TypeKind.DATE, T.TypeKind.TIMESTAMP):
        out.int_value = int(v)
    elif k == T.TypeKind.DECIMAL:
        u = int(v)
        if lit.dtype.wide_decimal:
            lo_u = u & 0xFFFFFFFFFFFFFFFF
            hi_u = (u >> 64) & 0xFFFFFFFFFFFFFFFF
            out.decimal_unscaled = (lo_u - (1 << 64)
                                    if lo_u >= (1 << 63) else lo_u)
            out.decimal_unscaled_hi = (hi_u - (1 << 64)
                                       if hi_u >= (1 << 63) else hi_u)
        else:
            out.decimal_unscaled = u
    elif k in (T.TypeKind.FLOAT32, T.TypeKind.FLOAT64):
        out.float_value = float(v)
    elif k == T.TypeKind.STRING:
        out.string_value = v.decode() if isinstance(v, bytes) else str(v)
    elif k == T.TypeKind.BINARY:
        out.binary_value = bytes(v)
    else:
        raise NotImplementedError(f"literal of {lit.dtype}")
    return out


def encode_expr(e: ir.Expr) -> pb.ExprNode:
    out = pb.ExprNode()
    if isinstance(e, ir.Col):
        out.column.name = e.name
    elif isinstance(e, ir.BoundRef):
        out.bound_reference.index = e.index
    elif isinstance(e, ir.Literal):
        out.literal.CopyFrom(encode_literal(e))
    elif isinstance(e, ir.Binary):
        out.binary.op = _BINOP_TO_PB[e.op]
        out.binary.left.CopyFrom(encode_expr(e.left))
        out.binary.right.CopyFrom(encode_expr(e.right))
        if e.result_type is not None:
            out.binary.result_type.CopyFrom(encode_dtype(e.result_type))
    elif isinstance(e, ir.Cast):
        out.cast.child.CopyFrom(encode_expr(e.child))
        out.cast.dtype.CopyFrom(encode_dtype(e.dtype))
    elif isinstance(e, ir.Not):
        getattr(out, "not").CopyFrom(encode_expr(e.child))
    elif isinstance(e, ir.IsNull):
        out.is_null.CopyFrom(encode_expr(e.child))
    elif isinstance(e, ir.IsNotNull):
        out.is_not_null.CopyFrom(encode_expr(e.child))
    elif isinstance(e, ir.Negate):
        out.negative.CopyFrom(encode_expr(e.child))
    elif isinstance(e, ir.InList):
        out.in_list.child.CopyFrom(encode_expr(e.child))
        for v in e.values:
            out.in_list.values.add().CopyFrom(encode_expr(v))
        out.in_list.negated = e.negated
    elif isinstance(e, ir.If):
        out.if_expr.condition.CopyFrom(encode_expr(e.cond))
        out.if_expr.then.CopyFrom(encode_expr(e.then))
        out.if_expr.else_expr.CopyFrom(encode_expr(e.otherwise))
    elif isinstance(e, ir.CaseWhen):
        for w, t in e.branches:
            b = out.case.branches.add()
            b.when.CopyFrom(encode_expr(w))
            b.then.CopyFrom(encode_expr(t))
        if e.otherwise is not None:
            out.case.else_expr.CopyFrom(encode_expr(e.otherwise))
    elif isinstance(e, ir.ScalarFn):
        if e.name in _FN_TO_PB:
            out.scalar_fn.fn = _FN_TO_PB[e.name]
        else:
            out.scalar_fn.fn = pb.FN_EXT
            out.scalar_fn.ext_name = e.name
        for a in e.args:
            out.scalar_fn.args.add().CopyFrom(encode_expr(a))
        if e.result_type is not None:
            out.scalar_fn.result_type.CopyFrom(encode_dtype(e.result_type))
    elif isinstance(e, ir.StringPredicate):
        op = {"starts_with": pb.StringPredicateExpr.STARTS_WITH,
              "ends_with": pb.StringPredicateExpr.ENDS_WITH,
              "contains": pb.StringPredicateExpr.CONTAINS}[e.op]
        out.string_predicate.op = op
        out.string_predicate.child.CopyFrom(encode_expr(e.child))
        out.string_predicate.pattern = e.pattern
    elif isinstance(e, ir.Like):
        out.like.child.CopyFrom(encode_expr(e.child))
        out.like.pattern = e.pattern
        out.like.escape = e.escape
    elif isinstance(e, ir.GetStructField):
        out.get_struct_field.child.CopyFrom(encode_expr(e.child))
        out.get_struct_field.index = e.index
    elif isinstance(e, ir.GetIndexedField):
        out.get_indexed_field.child.CopyFrom(encode_expr(e.child))
        out.get_indexed_field.index.CopyFrom(encode_literal(e.index))
    elif isinstance(e, ir.GetMapValue):
        out.get_map_value.child.CopyFrom(encode_expr(e.child))
        out.get_map_value.key.CopyFrom(encode_literal(e.map_key))
    elif isinstance(e, ir.NamedStruct):
        out.named_struct.names.extend(e.names)
        for v in e.values:
            out.named_struct.values.add().CopyFrom(encode_expr(v))
        out.named_struct.result_type.CopyFrom(encode_dtype(e.result_type))
    elif isinstance(e, ir.MakeDecimal):
        out.make_decimal.child.CopyFrom(encode_expr(e.child))
        out.make_decimal.precision = e.precision
        out.make_decimal.scale = e.scale
    elif isinstance(e, ir.UnscaledValue):
        out.unscaled_value.CopyFrom(encode_expr(e.child))
    elif isinstance(e, ir.CheckOverflow):
        out.check_overflow.child.CopyFrom(encode_expr(e.child))
        out.check_overflow.precision = e.precision
        out.check_overflow.scale = e.scale
    elif isinstance(e, ir.UdfWrapper):
        out.udf_wrapper.resource_id = e.resource_id
        out.udf_wrapper.return_type.CopyFrom(encode_dtype(e.return_type))
        out.udf_wrapper.nullable = e.nullable
        for p in e.params:
            out.udf_wrapper.params.add().CopyFrom(encode_expr(p))
    elif isinstance(e, ir.ScalarSubquery):
        out.scalar_subquery.resource_id = e.resource_id
        out.scalar_subquery.return_type.CopyFrom(encode_dtype(e.return_type))
        out.scalar_subquery.nullable = e.nullable
    else:
        raise NotImplementedError(f"encode {type(e).__name__}")
    return out
