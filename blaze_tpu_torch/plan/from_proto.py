"""Proto plan -> operator tree decoder.

Port of blaze_tpu/plan/from_proto.py (ref: blaze-serde from_proto.rs:
121-793, lib.rs:191-535). The same `TaskDefinition` bytes decode in both
packages: plan_pb2.py is the JAX package's generated module, copied.
Every arm the JAX decoder decodes decodes here: types and scalars, every
expression kind, the UDF wrapper and the scalar subquery included, and
every plan node, expand, window and generate included. An arm neither decodes (an unset
node, the `row_num` expression) raises NotImplementedError naming it.
"""

from __future__ import annotations

from typing import List, Tuple

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import basic as B
from blaze_tpu_torch.ops.agg import AggCall, AggExec, AggMode
from blaze_tpu_torch.ops import shuffle as S
from blaze_tpu_torch.ops.base import Operator
from blaze_tpu_torch.ops.expand import ExpandExec, GenerateExec
from blaze_tpu_torch.ops.join import (
    BroadcastJoinExec, BroadcastNestedLoopJoinExec, JoinKey, JoinType,
    SortMergeJoinExec,
)
from blaze_tpu_torch.ops.sort import SortExec
from blaze_tpu_torch.ops.sort_keys import SortSpec
from blaze_tpu_torch.ops.window import WindowCall, WindowExec
from blaze_tpu_torch.plan import plan_pb2 as pb

# ---------------------------------------------------------------------------
# types / scalars
# ---------------------------------------------------------------------------

_KIND_MAP = {
    pb.TK_NULL: T.TypeKind.NULL,
    pb.TK_BOOL: T.TypeKind.BOOLEAN,
    pb.TK_INT8: T.TypeKind.INT8,
    pb.TK_INT16: T.TypeKind.INT16,
    pb.TK_INT32: T.TypeKind.INT32,
    pb.TK_INT64: T.TypeKind.INT64,
    pb.TK_FLOAT32: T.TypeKind.FLOAT32,
    pb.TK_FLOAT64: T.TypeKind.FLOAT64,
    pb.TK_STRING: T.TypeKind.STRING,
    pb.TK_BINARY: T.TypeKind.BINARY,
    pb.TK_DATE32: T.TypeKind.DATE,
    pb.TK_TIMESTAMP_MICROS: T.TypeKind.TIMESTAMP,
    pb.TK_DECIMAL: T.TypeKind.DECIMAL,
    pb.TK_LIST: T.TypeKind.LIST,
    pb.TK_MAP: T.TypeKind.MAP,
    pb.TK_STRUCT: T.TypeKind.STRUCT,
}


def decode_dtype(p: pb.DataType) -> T.DataType:
    kind = _KIND_MAP[p.kind]
    if kind == T.TypeKind.DECIMAL:
        return T.decimal(p.precision, p.scale)
    if kind == T.TypeKind.LIST:
        return T.list_of(decode_dtype(p.element))
    if kind == T.TypeKind.MAP:
        return T.map_of(decode_dtype(p.map_key), decode_dtype(p.element))
    if kind == T.TypeKind.STRUCT:
        return T.struct_of(
            T.Field(f.name, decode_dtype(f.dtype), f.nullable)
            for f in p.struct_fields)
    return T.DataType(kind)


def decode_schema(p: pb.Schema) -> T.Schema:
    return T.Schema([T.Field(f.name, decode_dtype(f.dtype), f.nullable)
                     for f in p.fields])


def decode_scalar(p: pb.ScalarValue) -> ir.Literal:
    dt = decode_dtype(p.dtype)
    if p.is_null:
        return ir.Literal(dt, None)
    which = p.WhichOneof("value")
    if which is None:
        return ir.Literal(dt, None)
    v = getattr(p, which)
    if which == "binary_value":
        v = bytes(v)
    if which == "decimal_unscaled" and dt.wide_decimal:
        u = ((p.decimal_unscaled_hi & ((1 << 64) - 1)) << 64) | \
            (int(v) & ((1 << 64) - 1))
        v = u - (1 << 128) if u >= (1 << 127) else u
    return ir.Literal(dt, v)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_BINOP_MAP = {
    pb.OP_ADD: ir.BinOp.ADD, pb.OP_SUB: ir.BinOp.SUB,
    pb.OP_MUL: ir.BinOp.MUL, pb.OP_DIV: ir.BinOp.DIV,
    pb.OP_MOD: ir.BinOp.MOD,
    pb.OP_EQ: ir.BinOp.EQ, pb.OP_NEQ: ir.BinOp.NEQ,
    pb.OP_LT: ir.BinOp.LT, pb.OP_LE: ir.BinOp.LE,
    pb.OP_GT: ir.BinOp.GT, pb.OP_GE: ir.BinOp.GE,
    pb.OP_AND: ir.BinOp.AND, pb.OP_OR: ir.BinOp.OR,
    pb.OP_EQ_NULLSAFE: ir.BinOp.EQ_NULLSAFE,
    pb.OP_BIT_AND: ir.BinOp.BIT_AND, pb.OP_BIT_OR: ir.BinOp.BIT_OR,
    pb.OP_BIT_XOR: ir.BinOp.BIT_XOR,
    pb.OP_SHIFT_LEFT: ir.BinOp.SHIFT_LEFT,
    pb.OP_SHIFT_RIGHT: ir.BinOp.SHIFT_RIGHT,
    # short-circuit variants evaluate both sides on a vector machine
    pb.OP_SC_AND: ir.BinOp.AND, pb.OP_SC_OR: ir.BinOp.OR,
}

_FN_NAME = {
    pb.FN_ABS: "abs", pb.FN_ACOS: "acos", pb.FN_ASIN: "asin",
    pb.FN_ATAN: "atan", pb.FN_ATAN2: "atan2", pb.FN_CEIL: "ceil",
    pb.FN_COS: "cos", pb.FN_EXP: "exp", pb.FN_FLOOR: "floor",
    pb.FN_LN: "ln", pb.FN_LOG: "log", pb.FN_LOG10: "log10",
    pb.FN_LOG2: "log2", pb.FN_POW: "pow", pb.FN_ROUND: "round",
    pb.FN_SIGNUM: "signum", pb.FN_SIN: "sin", pb.FN_SQRT: "sqrt",
    pb.FN_TAN: "tan", pb.FN_TRUNC: "trunc", pb.FN_COALESCE: "coalesce",
    pb.FN_NULLIF: "nullif", pb.FN_ISNAN: "isnan", pb.FN_NANVL: "nanvl",
    pb.FN_ASCII: "ascii", pb.FN_BIT_LENGTH: "bit_length",
    pb.FN_BTRIM: "btrim", pb.FN_CHAR_LENGTH: "char_length",
    pb.FN_CHR: "chr", pb.FN_CONCAT: "concat", pb.FN_CONCAT_WS: "concat_ws",
    pb.FN_INITCAP: "initcap", pb.FN_LEFT: "left", pb.FN_LOWER: "lower",
    pb.FN_LPAD: "lpad", pb.FN_LTRIM: "ltrim",
    pb.FN_OCTET_LENGTH: "octet_length", pb.FN_REPEAT: "repeat",
    pb.FN_REPLACE: "replace", pb.FN_REVERSE: "reverse",
    pb.FN_RIGHT: "right", pb.FN_RPAD: "rpad", pb.FN_RTRIM: "rtrim",
    pb.FN_SPLIT_PART: "split_part", pb.FN_STARTS_WITH: "starts_with",
    pb.FN_STRPOS: "strpos", pb.FN_SUBSTR: "substr", pb.FN_TO_HEX: "to_hex",
    pb.FN_TRANSLATE: "translate", pb.FN_TRIM: "trim", pb.FN_UPPER: "upper",
    pb.FN_STRING_SPACE: "string_space", pb.FN_MD5: "md5",
    pb.FN_SHA224: "sha224", pb.FN_SHA256: "sha256", pb.FN_SHA384: "sha384",
    pb.FN_SHA512: "sha512", pb.FN_CRC32: "crc32",
    pb.FN_MURMUR3_HASH: "murmur3_hash",
    pb.FN_NULL_IF_ZERO: "null_if_zero",
    pb.FN_MAKE_ARRAY: "make_array",
    pb.FN_GET_JSON_OBJECT: "get_json_object", pb.FN_PARSE_JSON: "parse_json",
    pb.FN_DATE_ADD: "date_add", pb.FN_DATE_SUB: "date_sub",
    pb.FN_DATEDIFF: "datediff", pb.FN_YEAR: "year", pb.FN_MONTH: "month",
    pb.FN_DAY: "day",
}

def decode_expr(p: pb.ExprNode) -> ir.Expr:
    which = p.WhichOneof("expr")
    if which == "column":
        return ir.col(p.column.name)
    if which == "bound_reference":
        return ir.BoundRef(p.bound_reference.index)
    if which == "literal":
        return decode_scalar(p.literal)
    if which == "binary":
        b = p.binary
        rt = (decode_dtype(b.result_type)
              if b.HasField("result_type") else None)
        return ir.Binary(_BINOP_MAP[b.op], decode_expr(b.left),
                         decode_expr(b.right), rt)
    if which == "cast":
        return ir.Cast(decode_expr(p.cast.child), decode_dtype(p.cast.dtype))
    if which == "not":
        return ir.Not(decode_expr(getattr(p, "not")))
    if which == "is_null":
        return ir.IsNull(decode_expr(p.is_null))
    if which == "is_not_null":
        return ir.IsNotNull(decode_expr(p.is_not_null))
    if which == "negative":
        return ir.Negate(decode_expr(p.negative))
    if which == "in_list":
        il = p.in_list
        return ir.InList(decode_expr(il.child),
                         tuple(decode_expr(v) for v in il.values),
                         il.negated)
    if which == "case":
        c = p.case
        return ir.CaseWhen(
            tuple((decode_expr(w.when), decode_expr(w.then))
                  for w in c.branches),
            decode_expr(c.else_expr) if c.HasField("else_expr") else None)
    if which == "if_expr":
        i = p.if_expr
        return ir.If(decode_expr(i.condition), decode_expr(i.then),
                     decode_expr(i.else_expr))
    if which == "scalar_fn":
        f = p.scalar_fn
        name = f.ext_name if f.fn == pb.FN_EXT else _FN_NAME[f.fn]
        rt = (decode_dtype(f.result_type)
              if f.HasField("result_type") else None)
        return ir.ScalarFn(name, tuple(decode_expr(a) for a in f.args), rt)
    if which == "string_predicate":
        sp = p.string_predicate
        op = {pb.StringPredicateExpr.STARTS_WITH: "starts_with",
              pb.StringPredicateExpr.ENDS_WITH: "ends_with",
              pb.StringPredicateExpr.CONTAINS: "contains"}[sp.op]
        return ir.StringPredicate(op, decode_expr(sp.child),
                                  bytes(sp.pattern))
    if which == "like":
        lk = p.like
        return ir.Like(decode_expr(lk.child), bytes(lk.pattern),
                       bytes(lk.escape) or b"\\")
    if which == "get_struct_field":
        g = p.get_struct_field
        return ir.GetStructField(decode_expr(g.child), g.index)
    if which == "get_indexed_field":
        g = p.get_indexed_field
        return ir.GetIndexedField(decode_expr(g.child),
                                  decode_scalar(g.index))
    if which == "get_map_value":
        g = p.get_map_value
        return ir.GetMapValue(decode_expr(g.child), decode_scalar(g.key))
    if which == "named_struct":
        g = p.named_struct
        return ir.NamedStruct(tuple(g.names),
                              tuple(decode_expr(v) for v in g.values),
                              decode_dtype(g.result_type))
    if which == "make_decimal":
        m = p.make_decimal
        return ir.MakeDecimal(decode_expr(m.child), m.precision, m.scale)
    if which == "unscaled_value":
        return ir.UnscaledValue(decode_expr(p.unscaled_value))
    if which == "check_overflow":
        c = p.check_overflow
        return ir.CheckOverflow(decode_expr(c.child), c.precision, c.scale)
    if which == "udf_wrapper":
        u = p.udf_wrapper
        return ir.UdfWrapper(u.resource_id, decode_dtype(u.return_type),
                             u.nullable,
                             tuple(decode_expr(x) for x in u.params))
    if which == "scalar_subquery":
        s = p.scalar_subquery
        return ir.ScalarSubquery(s.resource_id, decode_dtype(s.return_type),
                                 s.nullable)
    raise NotImplementedError(f"expression kind {which}")


def _col_index(e: ir.Expr, schema: T.Schema) -> int:
    if isinstance(e, ir.Col):
        return schema.index_of(e.name)
    if isinstance(e, ir.BoundRef):
        return e.index
    raise NotImplementedError(
        f"expected a column reference, got {type(e).__name__}")


def _sort_spec(term: pb.SortTerm, schema: T.Schema) -> SortSpec:
    return SortSpec(_col_index(decode_expr(term.expr), schema),
                    term.ascending, term.nulls_first)


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------

_JOIN_TYPE = {
    pb.JOIN_INNER: JoinType.INNER, pb.JOIN_LEFT: JoinType.LEFT,
    pb.JOIN_RIGHT: JoinType.RIGHT, pb.JOIN_FULL: JoinType.FULL,
    pb.JOIN_LEFT_SEMI: JoinType.LEFT_SEMI,
    pb.JOIN_LEFT_ANTI: JoinType.LEFT_ANTI,
    pb.JOIN_EXISTENCE: JoinType.EXISTENCE,
}

_AGG_FN = {
    pb.AGG_MIN: "min", pb.AGG_MAX: "max", pb.AGG_SUM: "sum",
    pb.AGG_AVG: "avg", pb.AGG_COUNT: "count", pb.AGG_FIRST: "first",
    pb.AGG_FIRST_IGNORES_NULL: "first_ignores_null",
    pb.AGG_COLLECT_LIST: "collect_list", pb.AGG_COLLECT_SET: "collect_set",
}

_AGG_MODE = {
    pb.AGG_PARTIAL: AggMode.PARTIAL,
    pb.AGG_PARTIAL_MERGE: AggMode.PARTIAL_MERGE,
    pb.AGG_FINAL: AggMode.FINAL,
}


def _join_keys(on, lschema: T.Schema, rschema: T.Schema) -> List[JoinKey]:
    return [JoinKey(_col_index(decode_expr(o.left), lschema),
                    _col_index(decode_expr(o.right), rschema),
                    o.null_safe) for o in on]


def _join_filter(n, field: str):
    return decode_expr(getattr(n, field)) if n.HasField(field) else None


def _partitioning(p: pb.HashRepartition) -> S.Partitioning:
    kind = {pb.HashRepartition.HASH: "hash",
            pb.HashRepartition.SINGLE: "single",
            pb.HashRepartition.ROUND_ROBIN: "round_robin"}[p.kind]
    return S.Partitioning(kind, p.num_partitions,
                          tuple(decode_expr(k) for k in p.keys))


def decode_plan(p: pb.PlanNode) -> Operator:
    which = p.WhichOneof("node")
    n = getattr(p, which) if which is not None else None

    if which == "projection":
        child = decode_plan(n.input)
        return B.ProjectExec(child, [decode_expr(e) for e in n.exprs],
                             list(n.names))
    if which == "filter":
        child = decode_plan(n.input)
        return B.FilterExec(child, [decode_expr(e) for e in n.predicates])
    if which == "sort_merge_join":
        left, right = decode_plan(n.left), decode_plan(n.right)
        return SortMergeJoinExec(
            left, right, _join_keys(n.on, left.schema, right.schema),
            _JOIN_TYPE[n.join_type],
            join_filter=_join_filter(n, "join_filter"),
            existence_name=n.existence_name or "exists")
    if which == "broadcast_join":
        left, right = decode_plan(n.left), decode_plan(n.right)
        return BroadcastJoinExec(
            left, right, _join_keys(n.on, left.schema, right.schema),
            _JOIN_TYPE[n.join_type], build_is_left=n.build_is_left,
            join_filter=_join_filter(n, "join_filter"),
            existence_name=n.existence_name or "exists")
    if which == "broadcast_nested_loop_join":
        left, right = decode_plan(n.left), decode_plan(n.right)
        return BroadcastNestedLoopJoinExec(
            left, right, _JOIN_TYPE[n.join_type],
            condition=_join_filter(n, "condition"))
    if which == "agg":
        child = decode_plan(n.input)
        calls = [AggCall(_AGG_FN[a.fn],
                         tuple(decode_expr(x) for x in a.args),
                         decode_dtype(a.result_type), a.name)
                 for a in n.aggs]
        return AggExec(child, [decode_expr(g) for g in n.grouping],
                       list(n.grouping_names), calls, _AGG_MODE[n.mode])
    if which == "sort":
        child = decode_plan(n.input)
        specs = [_sort_spec(t, child.schema) for t in n.terms]
        fetch = n.fetch_limit if n.fetch_limit > 0 else None
        return SortExec(child, specs, fetch=fetch)
    if which == "union":
        return B.UnionExec([decode_plan(c) for c in n.inputs])
    if which == "empty_partitions":
        return B.EmptyPartitionsExec(decode_schema(n.schema),
                                     n.num_partitions)
    if which == "rename_columns":
        return B.RenameColumnsExec(decode_plan(n.input), list(n.renamed))
    if which == "limit":
        child = decode_plan(n.input)
        cls = B.GlobalLimitExec if getattr(n, "global") else B.LocalLimitExec
        return cls(child, n.limit)
    if which == "ffi_reader":
        return S.FfiReaderExec(decode_schema(n.schema),
                               n.export_iter_resource_id)
    if which == "coalesce_batches":
        return B.CoalesceBatchesExec(decode_plan(n.input),
                                     n.batch_size or None)
    if which == "shuffle_writer":
        return S.ShuffleWriterExec(decode_plan(n.input),
                                   _partitioning(n.partitioning),
                                   n.data_file, n.index_file)
    if which == "rss_shuffle_writer":
        return S.RssShuffleWriterExec(decode_plan(n.input),
                                      _partitioning(n.partitioning),
                                      n.rss_writer_resource_id)
    if which == "ipc_writer":
        return S.IpcWriterExec(decode_plan(n.input), n.consumer_resource_id)
    if which == "ipc_reader":
        return S.IpcReaderExec(decode_schema(n.schema),
                               n.provider_resource_id,
                               n.num_partitions or 1)
    if which == "debug":
        return B.DebugExec(decode_plan(n.input), n.debug_id)
    if which == "parquet_scan":
        from blaze_tpu_torch.ops.parquet import ParquetScanExec

        return ParquetScanExec(
            files=[(f.path, list(f.partition_values))
                   for f in n.file_group.files],
            file_schema=decode_schema(n.file_schema),
            projection=list(n.projection),
            partition_schema=decode_schema(n.partition_schema),
            pruning_predicates=[decode_expr(e)
                                for e in n.pruning_predicates],
            fs_resource_id=n.fs_resource_id or None)
    if which == "parquet_sink":
        from blaze_tpu_torch.ops.parquet import ParquetSinkExec

        return ParquetSinkExec(decode_plan(n.input), n.path,
                               fs_resource_id=n.fs_resource_id or None,
                               row_group_rows=n.row_group_rows or None,
                               props={kv.key: kv.value for kv in n.props})
    if which == "expand":
        child = decode_plan(n.input)
        return ExpandExec(child, [[decode_expr(e) for e in pl.exprs]
                                  for pl in n.projections],
                          decode_schema(n.schema))
    if which == "window":
        child = decode_plan(n.input)
        calls = []
        for w in n.window_exprs:
            if w.WhichOneof("fn") == "builtin":
                name = {pb.WIN_ROW_NUMBER: "row_number", pb.WIN_RANK: "rank",
                        pb.WIN_DENSE_RANK: "dense_rank"}[w.builtin]
                calls.append(WindowCall(name, (),
                                        decode_dtype(w.result_type), w.name))
            else:
                a = w.agg
                calls.append(WindowCall(
                    _AGG_FN[a.fn], tuple(decode_expr(x) for x in a.args),
                    decode_dtype(a.result_type), w.name))
        return WindowExec(child, calls,
                          [decode_expr(e) for e in n.partition_by],
                          [_sort_spec(t, child.schema) for t in n.order_by])
    if which == "generate":
        child = decode_plan(n.input)
        pos = {pb.GenerateNode.EXPLODE: False,
               pb.GenerateNode.POS_EXPLODE: True}[n.kind]
        return GenerateExec(child, decode_expr(n.child_expr),
                            list(n.required_columns),
                            list(n.generator_output_names),
                            pos=pos, outer=n.outer)
    raise NotImplementedError(f"plan node {which}")


def decode_task_definition(buf: bytes) -> Tuple[Operator, pb.TaskDefinition]:
    td = pb.TaskDefinition()
    td.ParseFromString(buf)
    return decode_plan(td.plan), td
