"""Per-operator Spark->native converters with fallback-by-construction.

Port of blaze_tpu/spark/converters.py. Ref: BlazeConverters.scala —
dispatcher convertSparkPlan (:133-222), the tryConvert catch-to-fallback
pattern (:224-236), per-op enable flags (:76-110), BHJ build-side handling
(:420-434), and convertToNative boundary insertion (:786-791). Stage
boundaries (shuffle/broadcast exchanges) are handled by stages.py; this
module converts a single stage's tree.

Every converter either returns a pb.PlanNode or raises — `try_convert`
turns raises into a non-native subtree bridged with an FfiReaderNode (the
ConvertToNativeExec analog: the embedding layer registers a row->Arrow
export iterator under the derived resource id, ref
ConvertToNativeBase.scala:59-98): spark/local_runner.py registers the
row interpreter's (spark/fallback.py) export iterator under each id.

Tagging needs to know which scalar functions the engine runs natively:
the port's exprs/functions.py registers the JAX registry's names, so
tagging decides as the JAX package decides and stage bytes do not move.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Callable, Dict, Iterator, List, Optional

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.types import Schema, TypeKind
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import functions, ir
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.to_proto import (
    encode_dtype, encode_expr, encode_schema,
)
from blaze_tpu_torch.spark.plan_model import SparkPlan

logger = logging.getLogger(__name__)

_JOIN_TYPE = {
    "inner": pb.JOIN_INNER, "left": pb.JOIN_LEFT, "right": pb.JOIN_RIGHT,
    "full": pb.JOIN_FULL, "left_semi": pb.JOIN_LEFT_SEMI,
    "left_anti": pb.JOIN_LEFT_ANTI, "existence": pb.JOIN_EXISTENCE,
}

_AGG_FN = {
    "min": pb.AGG_MIN, "max": pb.AGG_MAX, "sum": pb.AGG_SUM,
    "avg": pb.AGG_AVG, "count": pb.AGG_COUNT, "first": pb.AGG_FIRST,
    "first_ignores_null": pb.AGG_FIRST_IGNORES_NULL,
    "collect_list": pb.AGG_COLLECT_LIST, "collect_set": pb.AGG_COLLECT_SET,
}

_AGG_MODE = {"partial": pb.AGG_PARTIAL, "partial_merge": pb.AGG_PARTIAL_MERGE,
             "final": pb.AGG_FINAL}

def is_supported(name: str) -> bool:
    """Plan-time check of the expression walk: does the scalar-function
    registry run this function natively? The registry holds the JAX
    package's names, so tagging decides as it does."""
    return functions.is_supported(name)


class ConversionError(Exception):
    pass


# rid -> the non-native SparkPlan subtree behind each emitted FFI bridge.
# The embedding layer (local_runner here; the JVM shim in deployment)
# drains this after conversion and registers a row-export iterator per rid,
# the ConvertToNativeBase.scala:59-98 resourcesMap handshake.
_pending_exports: Dict[str, SparkPlan] = {}
_exports_lock = threading.Lock()


def drain_exports() -> Dict[str, SparkPlan]:
    with _exports_lock:
        out = dict(_pending_exports)
        _pending_exports.clear()
    return out


def bridge_schema(plan: SparkPlan) -> Schema:
    """The schema actually crossing the FFI bridge for `plan`.

    Usually plan.schema — except partial-mode aggregates, whose SparkPlan
    schema lists only the grouping columns (Spark's partial-agg output is
    opaque to the driver); the rows crossing the bridge carry the native
    agg-state layout (ops/agg.py state_fields) so a native final agg can
    consume them."""
    from blaze_tpu_torch.columnar.types import Schema as TSchema

    if (plan.kind.endswith("AggregateExec")
            and plan.attrs.get("mode") in ("partial", "partial_merge")):
        from blaze_tpu_torch.ops.agg import AggCall, state_fields

        ngroups = len(plan.attrs["grouping_names"])
        groups = list(plan.schema.fields)[:ngroups]
        state = []
        for i, call in enumerate(plan.attrs["aggs"]):
            state.extend(state_fields(
                AggCall(call["fn"], tuple(call["args"]), call["dtype"],
                        call["name"]), i))
        return TSchema(groups + state)
    return plan.schema


def ffi_bridge(plan: SparkPlan) -> pb.PlanNode:
    """Non-native subtree boundary (ConvertToNativeExec analog)."""
    rid = plan.attrs.get("export_resource_id")
    if not rid:
        rid = f"__jvm_export__:{uuid.uuid4().hex[:12]}"
        plan.attrs["export_resource_id"] = rid
    with _exports_lock:
        _pending_exports[rid] = plan
    node = pb.PlanNode()
    node.ffi_reader.schema.CopyFrom(encode_schema(bridge_schema(plan)))
    node.ffi_reader.export_iter_resource_id = rid
    return node


def convert_spark_plan(plan: SparkPlan) -> pb.PlanNode:
    """Convert a stage tree; nodes tagged NeverConvert bridge via FFI."""
    if plan.strategy == "NeverConvert" or plan.convertible is False:
        return ffi_bridge(plan)
    return try_convert(plan)


def try_convert(plan: SparkPlan) -> pb.PlanNode:
    """Ref tryConvert: convert or degrade THIS node to the FFI bridge."""
    fn = _CONVERTERS.get(plan.kind)
    if fn is None or not conf.op_enabled(_flag_name(plan.kind)):
        return ffi_bridge(plan)
    try:
        return fn(plan)
    except Exception as e:  # noqa: BLE001 — fallback is the contract
        logger.info("fallback for %s: %s", plan.kind, e)
        return ffi_bridge(plan)


# Exchanges are stage boundaries converted by stages.py, not _CONVERTERS
# (ref convertShuffleExchangeExec:238 / convertBroadcastExchangeExec:539) —
# tagging must treat them as native-capable, else every exchange cascades
# NeverConvert demotions through _remove_inefficient.
_EXCHANGE_KINDS = {"ShuffleExchangeExec", "BroadcastExchangeExec"}


def check_convertible(plan: SparkPlan) -> bool:
    """Trial conversion of one node (children assumed native) — the
    bottom-up tagging pass of BlazeConvertStrategy.scala:56-69."""
    if plan.kind in _EXCHANGE_KINDS:
        return _exprs_convertible(plan)
    fn = _CONVERTERS.get(plan.kind)
    if fn is None or not conf.op_enabled(_flag_name(plan.kind)):
        return False
    if not _exprs_convertible(plan):
        return False
    try:
        fn(plan)
        return True
    except Exception:  # noqa: BLE001
        return False


def _iter_attr_exprs(obj) -> Iterator[ir.Expr]:
    if isinstance(obj, ir.Expr):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_attr_exprs(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _iter_attr_exprs(v)


def _expr_dtypes(e: ir.Expr):
    for attr in ("dtype", "result_type", "return_type"):
        dt = getattr(e, attr, None)
        if dt is not None and hasattr(dt, "kind"):
            yield dt


def _any_wide_decimal(plan: SparkPlan) -> bool:
    """p>18 anywhere visible at this node: its schema, its CHILDREN's
    schemas (input columns), or any expression-carried dtype."""
    for sch in [plan.schema] + [c.schema for c in plan.children]:
        if any(f.dtype.wide_decimal for f in sch.fields):
            return True
    for root in _iter_attr_exprs(plan.attrs):
        stack = [root]
        while stack:
            e = stack.pop()
            if any(dt.wide_decimal for dt in _expr_dtypes(e)):
                return True
            if isinstance(e, (ir.MakeDecimal, ir.CheckOverflow)) \
                    and e.precision > 18:
                return True
            stack.extend(e.children())
    return False


def _exprs_convertible(plan: SparkPlan) -> bool:
    """Walk every expression in the node's attrs and reject unknown scalar
    functions at tag time — the reference walks expressions during
    conversion (NativeConverters.convertExpr:290-372); serializing an
    unknown fn by name would only explode at execution.

    Wide decimals (p > 18) convert only where the engine's Decimal128
    limb kernels cover the usage (exprs/wide_decimal.py): pass-through /
    sort / scan / exchanges (incl. wide hash keys), grouped aggregates in
    _WIDE_OK_AGG_FNS (sum/avg/min/max/count/first*, wide grouping keys
    included), equality joins on type-matched wide keys, and expression
    subtrees limited to add/sub, bounded mul, compares, negate, null
    tests, supported casts and CheckOverflow. Anything else (window/
    generate on wide, division, BNLJ wide conditions beyond the
    allowlist) stays on the fallback path."""
    if _any_wide_decimal(plan) and not _wide_usage_ok(plan):
        return False
    for root in _iter_attr_exprs(plan.attrs):
        stack = [root]
        while stack:
            e = stack.pop()
            if isinstance(e, ir.ScalarFn) and not is_supported(e.name):
                return False
            stack.extend(e.children())
    return True


# node kinds where wide-decimal columns may appear (given the expression
# checks below); everything else — agg, joins, window, generate, expand —
# falls back until its wide path exists
_WIDE_OK_KINDS = {
    "FileSourceScanExec", "ProjectExec", "FilterExec", "SortExec",
    "LocalLimitExec", "GlobalLimitExec", "UnionExec",
    "TakeOrderedAndProjectExec", "DataWritingCommandExec",
    "InsertIntoHadoopFsRelationCommand",
}

_WIDE_CMP = {ir.BinOp.EQ, ir.BinOp.NEQ, ir.BinOp.LT, ir.BinOp.LE,
             ir.BinOp.GT, ir.BinOp.GE, ir.BinOp.EQ_NULLSAFE}
_WIDE_CASTABLE_SRC = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                      TypeKind.INT64, TypeKind.BOOLEAN)
_WIDE_CAST_TARGETS = (TypeKind.INT32, TypeKind.INT64, TypeKind.FLOAT64)


_AGG_KINDS = {"HashAggregateExec", "SortAggregateExec",
              "ObjectHashAggregateExec"}
# wide-capable agg fns (ops/agg.py limb-plane branches; first* is
# take-based and storage-agnostic)
_WIDE_OK_AGG_FNS = {"sum", "avg", "min", "max", "count", "first",
                    "first_ignores_null"}


_WIDE_JOIN_KINDS = {"SortMergeJoinExec", "BroadcastHashJoinExec",
                    "ShuffledHashJoinExec"}


def _wide_usage_ok(plan: SparkPlan) -> bool:
    in_schema = plan.children[0].schema if plan.children else plan.schema
    if plan.kind in _EXCHANGE_KINDS:
        # wide hash keys partition through the device murmur3 over the
        # minimal big-endian two's-complement bytes (exprs/hash.py,
        # JVM Spark's p>18 semantics); pass-through rides the frame serde
        return True
    if plan.kind in _AGG_KINDS:
        # wide GROUPING keys group via limb-plane neighbor-equality
        # (ops/segment.py struct branch) and two-key sort order; wide
        # AGGREGATES are limited to the limb-kernel set
        for g in plan.attrs.get("grouping", []):
            if not _wide_subtree_ok(g, in_schema):
                return False
        for call in plan.attrs.get("aggs", []):
            wide = (call["dtype"].wide_decimal
                    or any(_touches_wide(a, in_schema)
                           for a in call["args"]))
            if not wide:
                continue
            if call["fn"] not in _WIDE_OK_AGG_FNS:
                return False
            if not all(_wide_subtree_ok(a, in_schema)
                       for a in call["args"]):
                return False
        return True
    if plan.kind in _WIDE_JOIN_KINDS:
        # equality joins compare ENCODED key arrays, which the wide
        # two-key encoding serves — but both sides must share the exact
        # decimal type or equal values encode differently (Spark's key
        # normalization projections guarantee this in real plans)
        lsch = plan.children[0].schema
        rsch = plan.children[1].schema
        for lk, rk in zip(plan.attrs.get("left_keys", []),
                          plan.attrs.get("right_keys", [])):
            lt = _col_dtype(lk, lsch)
            rt = _col_dtype(rk, rsch)
            lw = lt is not None and lt.wide_decimal
            rw = rt is not None and rt.wide_decimal
            if lw != rw or (lw and lt != rt):
                return False
            if not (_wide_subtree_ok(lk, lsch)
                    and _wide_subtree_ok(rk, rsch)):
                return False
        cond = plan.attrs.get("condition")
        if cond is not None:
            joined = Schema(list(lsch.fields) + list(rsch.fields))
            if not _wide_subtree_ok(cond, joined):
                return False
        return True
    if plan.kind not in _WIDE_OK_KINDS:
        return False
    for root in _iter_attr_exprs(plan.attrs):
        if not _wide_subtree_ok(root, in_schema):
            return False
    return True


def _col_dtype(e: ir.Expr, schema) -> Optional[T.DataType]:
    """Result dtype of an expression when statically determinable."""
    if isinstance(e, ir.Col):
        try:
            return schema.fields[schema.index_of(e.name)].dtype
        except KeyError:
            return None
    if isinstance(e, ir.Literal):
        return e.dtype
    if isinstance(e, ir.Cast):
        return e.dtype
    if isinstance(e, ir.Binary):
        return e.result_type
    if isinstance(e, ir.CheckOverflow):
        return T.decimal(e.precision, e.scale)
    if isinstance(e, ir.MakeDecimal):
        return T.decimal(e.precision, e.scale)
    if isinstance(e, ir.Negate):
        return _col_dtype(e.child, schema)
    return None


def _touches_wide(e: ir.Expr, schema) -> bool:
    dt = _col_dtype(e, schema)
    if dt is not None and dt.wide_decimal:
        return True
    for d in _expr_dtypes(e):
        if d.wide_decimal:
            return True
    return any(_touches_wide(c, schema) for c in e.children())


def _wide_subtree_ok(e: ir.Expr, schema) -> bool:
    if not _touches_wide(e, schema):
        return True
    if isinstance(e, (ir.Col, ir.Literal)):
        return True
    if isinstance(e, (ir.IsNull, ir.IsNotNull, ir.Negate,
                      ir.CheckOverflow)):
        return all(_wide_subtree_ok(c, schema) for c in e.children())
    if isinstance(e, ir.Cast):
        src = _col_dtype(e.child, schema)
        dst = e.dtype
        if src is None:
            return False
        if dst.wide_decimal:
            ok = src.is_decimal or src.kind in _WIDE_CASTABLE_SRC
        elif src.wide_decimal:
            ok = ((dst.is_decimal and not dst.wide_decimal)
                  or dst.kind in _WIDE_CAST_TARGETS)
        else:
            ok = True
        return ok and _wide_subtree_ok(e.child, schema)
    if isinstance(e, ir.Binary):
        lt = _col_dtype(e.left, schema)
        rt = _col_dtype(e.right, schema)
        kids_ok = (_wide_subtree_ok(e.left, schema)
                   and _wide_subtree_ok(e.right, schema))
        if e.op in _WIDE_CMP:
            # the limb comparator needs decimal on both sides
            return (kids_ok and lt is not None and rt is not None
                    and lt.is_decimal and rt.is_decimal)
        if e.op in (ir.BinOp.ADD, ir.BinOp.SUB):
            return (kids_ok and e.result_type is not None
                    and e.result_type.is_decimal
                    and lt is not None and rt is not None
                    and lt.is_decimal and rt.is_decimal)
        if e.op == ir.BinOp.MUL:
            # the 128-bit product is exact only while p1+p2 <= 38
            return (kids_ok and e.result_type is not None
                    and e.result_type.is_decimal
                    and lt is not None and rt is not None
                    and lt.is_decimal and rt.is_decimal
                    and lt.precision + rt.precision <= 38)
        if e.op == ir.BinOp.DIV:
            # 128-bit bit-serial long division (int128.divmod_full) with
            # HALF_UP at the planner's result scale; the scale-alignment
            # upscale (numerator when delta >= 0, divisor otherwise) must
            # provably stay within 128 bits — a wrapped upscale would
            # null rows whose true quotient is representable
            if not (kids_ok and e.result_type is not None
                    and e.result_type.is_decimal
                    and lt is not None and rt is not None
                    and lt.is_decimal and rt.is_decimal):
                return False
            delta = e.result_type.scale - lt.scale + rt.scale
            if delta >= 0:
                return lt.precision + delta <= 38
            return rt.precision - delta <= 38
        return False  # mod still needs a kernel
    return False


def _flag_name(kind: str) -> str:
    return kind.replace("Exec", "").lower()


def _child(plan: SparkPlan, i: int = 0) -> pb.PlanNode:
    return convert_spark_plan(plan.children[i])


# ---- converters (one per supported SparkPlan kind) ----

def _convert_scan(plan: SparkPlan) -> pb.PlanNode:
    if plan.attrs.get("format") != "parquet":
        raise ConversionError("only parquet scans convert (ref :272-274)")
    node = pb.PlanNode()
    sc = node.parquet_scan
    sc.file_schema.CopyFrom(encode_schema(plan.schema))
    sc.projection.extend(range(len(plan.schema.fields)))
    for path, part_vals in plan.attrs.get("files", []):
        f = sc.file_group.files.add()
        f.path = path
    for p in plan.attrs.get("pruning_predicates", []):
        sc.pruning_predicates.add().CopyFrom(encode_expr(p))
    if plan.attrs.get("fs_resource_id"):
        sc.fs_resource_id = plan.attrs["fs_resource_id"]
    return node


def _convert_project(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    node.projection.input.CopyFrom(_child(plan))
    for e in plan.attrs["exprs"]:
        node.projection.exprs.add().CopyFrom(encode_expr(e))
    node.projection.names.extend(plan.attrs["names"])
    return node


def _convert_filter(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    node.filter.input.CopyFrom(_child(plan))
    node.filter.predicates.add().CopyFrom(
        encode_expr(plan.attrs["condition"]))
    return node


def _convert_sort(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    node.sort.input.CopyFrom(_child(plan))
    for expr, asc, nulls_first in plan.attrs["orders"]:
        t = node.sort.terms.add()
        t.expr.CopyFrom(encode_expr(expr))
        t.ascending = asc
        t.nulls_first = nulls_first
    if plan.attrs.get("fetch"):
        node.sort.fetch_limit = plan.attrs["fetch"]
    return node


def _normalize_keys(keys: List[ir.Expr], side: SparkPlan) -> List[ir.Expr]:
    """Join keys must be plain column refs; the reference inserts pre/post
    projections for computed keys (buildJoinColumnsProject:818). We require
    the shim to have done that normalization; computed keys raise."""
    for k in keys:
        if not isinstance(k, (ir.Col, ir.BoundRef)):
            raise ConversionError(
                "join keys must be normalized to column refs")
    return keys


def _convert_smj(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    j = node.sort_merge_join
    j.left.CopyFrom(_child(plan, 0))
    j.right.CopyFrom(_child(plan, 1))
    lk = _normalize_keys(plan.attrs["left_keys"], plan.children[0])
    rk = _normalize_keys(plan.attrs["right_keys"], plan.children[1])
    for lkey, rkey in zip(lk, rk):
        on = j.on.add()
        on.left.CopyFrom(encode_expr(lkey))
        on.right.CopyFrom(encode_expr(rkey))
    jt = plan.attrs["join_type"]
    j.join_type = _JOIN_TYPE[jt]
    if jt == "existence":
        j.existence_name = plan.attrs.get("existence_name", "exists")
    cond = plan.attrs.get("condition")
    if cond is not None:
        if jt != "inner" and not conf.enable_smj_inequality_join:
            raise ConversionError(
                "join condition on non-inner SMJ disabled "
                "(spark.blaze.enable.smjInequalityJoin)")
        j.join_filter.CopyFrom(encode_expr(cond))
    return node


def _convert_bhj(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    j = node.broadcast_join
    j.left.CopyFrom(_child(plan, 0))
    j.right.CopyFrom(_child(plan, 1))
    lk = _normalize_keys(plan.attrs["left_keys"], plan.children[0])
    rk = _normalize_keys(plan.attrs["right_keys"], plan.children[1])
    for lkey, rkey in zip(lk, rk):
        on = j.on.add()
        on.left.CopyFrom(encode_expr(lkey))
        on.right.CopyFrom(encode_expr(rkey))
    j.join_type = _JOIN_TYPE[plan.attrs["join_type"]]
    if plan.attrs["join_type"] == "existence":
        j.existence_name = plan.attrs.get("existence_name", "exists")
    # ref :420-434 — the reference rewrites build-side-left plans by
    # flipping children + join type; our engine takes build_is_left directly
    j.build_is_left = plan.attrs.get("build_side", "right") == "left"
    cond = plan.attrs.get("condition")
    if cond is not None:
        # non-inner residual filters run natively (_join_batch_filtered)
        # behind the same conf gate as SMJ (ref BlazeConf.java:35)
        if plan.attrs["join_type"] != "inner" \
                and not conf.enable_smj_inequality_join:
            raise ConversionError(
                "join condition on non-inner BHJ disabled "
                "(spark.blaze.enable.smjInequalityJoin)")
        j.join_filter.CopyFrom(encode_expr(cond))
    return node


def _is_broadcast_child(child: SparkPlan) -> bool:
    if child.kind == "BroadcastExchangeExec":
        return True
    rid = child.attrs.get("resource_id", "")
    local = rid.rsplit("/", 1)[-1]  # strip any "<query_id>/" namespace
    return child.kind == "__IpcReader" and local.startswith("broadcast:")


def _convert_bnlj(plan: SparkPlan) -> pb.PlanNode:
    """Ref convertBroadcastNestedLoopJoinExec (BlazeConverters.scala:470).

    A broadcast child on the join's PRESERVED side cannot convert: every
    task sees the whole broadcast relation, so per-task unmatched emission
    would duplicate its rows across tasks. cross == inner with no keys."""
    jt = plan.attrs["join_type"]
    lcast = _is_broadcast_child(plan.children[0])
    rcast = _is_broadcast_child(plan.children[1])
    if jt in ("left", "left_semi", "left_anti", "existence") and lcast:
        raise ConversionError("broadcast LEFT side of a left-preserving "
                              "BNLJ would duplicate per task")
    if jt == "right" and rcast:
        raise ConversionError("broadcast RIGHT side of a right-preserving "
                              "BNLJ would duplicate per task")
    if jt == "full" and (lcast or rcast):
        raise ConversionError("FULL BNLJ preserves both sides")
    node = pb.PlanNode()
    j = node.broadcast_nested_loop_join
    j.left.CopyFrom(_child(plan, 0))
    j.right.CopyFrom(_child(plan, 1))
    j.join_type = _JOIN_TYPE["inner" if jt == "cross" else jt]
    cond = plan.attrs.get("condition")
    if cond is not None:
        j.condition.CopyFrom(encode_expr(cond))
    return node


def _convert_parquet_insert(plan: SparkPlan) -> pb.PlanNode:
    """Ref convertDataWritingCommandExec (BlazeConverters.scala:774 — Hive
    parquet insert only)."""
    if plan.attrs.get("format", "parquet") != "parquet":
        raise ConversionError("only parquet writes convert (ref :774)")
    node = pb.PlanNode()
    sk = node.parquet_sink
    sk.input.CopyFrom(_child(plan))
    sk.path = plan.attrs["path"]
    if plan.attrs.get("fs_resource_id"):
        sk.fs_resource_id = plan.attrs["fs_resource_id"]
    if plan.attrs.get("row_group_rows"):
        sk.row_group_rows = plan.attrs["row_group_rows"]
    for k, v in (plan.attrs.get("props") or {}).items():
        kv = sk.props.add()
        kv.key, kv.value = str(k), str(v)
    return node


def _convert_agg(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    a = node.agg
    a.input.CopyFrom(_child(plan))
    a.mode = _AGG_MODE[plan.attrs["mode"]]
    for g in plan.attrs["grouping"]:
        a.grouping.add().CopyFrom(encode_expr(g))
    a.grouping_names.extend(plan.attrs["grouping_names"])
    for call in plan.attrs["aggs"]:
        if call["fn"] == "collect_set":
            elem = call["dtype"]
            if elem.kind == TypeKind.LIST:
                elem = elem.element
            if elem is not None and elem.is_nested:
                # set dedup needs a sort encoding; nested values have none
                raise ConversionError(
                    "collect_set over nested value types is not native")
        ae = a.aggs.add()
        ae.fn = _AGG_FN[call["fn"]]
        for arg in call["args"]:
            ae.args.add().CopyFrom(encode_expr(arg))
        ae.result_type.CopyFrom(encode_dtype(call["dtype"]))
        ae.name = call["name"]
    return node


def _convert_window(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    w = node.window
    w.input.CopyFrom(_child(plan))
    for call in plan.attrs["calls"]:
        we = w.window_exprs.add()
        if call["fn"] in ("row_number", "rank", "dense_rank"):
            we.builtin = {"row_number": pb.WIN_ROW_NUMBER,
                          "rank": pb.WIN_RANK,
                          "dense_rank": pb.WIN_DENSE_RANK}[call["fn"]]
        else:
            we.agg.fn = _AGG_FN[call["fn"]]
            for arg in call["args"]:
                we.agg.args.add().CopyFrom(encode_expr(arg))
            we.agg.result_type.CopyFrom(encode_dtype(call["dtype"]))
        we.result_type.CopyFrom(encode_dtype(call["dtype"]))
        we.name = call["name"]
    for e in plan.attrs["partition_by"]:
        w.partition_by.add().CopyFrom(encode_expr(e))
    for expr, asc, nulls_first in plan.attrs["order_by"]:
        t = w.order_by.add()
        t.expr.CopyFrom(encode_expr(expr))
        t.ascending = asc
        t.nulls_first = nulls_first
    return node


def _convert_limit(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    node.limit.input.CopyFrom(_child(plan))
    node.limit.limit = plan.attrs["limit"]
    setattr(node.limit, "global", plan.kind == "GlobalLimitExec")
    return node


def _convert_union(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    for i in range(len(plan.children)):
        node.union.inputs.add().CopyFrom(_child(plan, i))
    return node


def _convert_expand(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    node.expand.input.CopyFrom(_child(plan))
    for proj in plan.attrs["projections"]:
        pl = node.expand.projections.add()
        for e in proj:
            pl.exprs.add().CopyFrom(encode_expr(e))
    node.expand.schema.CopyFrom(encode_schema(plan.schema))
    return node


def _convert_generate(plan: SparkPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    g = node.generate
    g.input.CopyFrom(_child(plan))
    g.kind = (pb.GenerateNode.POS_EXPLODE if plan.attrs.get("pos")
              else pb.GenerateNode.EXPLODE)
    g.child_expr.CopyFrom(encode_expr(plan.attrs["generator"]))
    g.required_columns.extend(plan.attrs["required_cols"])
    g.generator_output_names.extend(plan.attrs["output_names"])
    g.outer = plan.attrs.get("outer", False)
    return node


_CONVERTERS: Dict[str, Callable[[SparkPlan], pb.PlanNode]] = {
    "FileSourceScanExec": _convert_scan,
    "ProjectExec": _convert_project,
    "FilterExec": _convert_filter,
    "SortExec": _convert_sort,
    "SortMergeJoinExec": _convert_smj,
    "BroadcastHashJoinExec": _convert_bhj,
    "HashAggregateExec": _convert_agg,
    "ObjectHashAggregateExec": _convert_agg,
    "SortAggregateExec": _convert_agg,
    "WindowExec": _convert_window,
    "LocalLimitExec": _convert_limit,
    "GlobalLimitExec": _convert_limit,
    "UnionExec": _convert_union,
    "ExpandExec": _convert_expand,
    "GenerateExec": _convert_generate,
    "BroadcastNestedLoopJoinExec": _convert_bnlj,
    "DataWritingCommandExec": _convert_parquet_insert,
    "InsertIntoHadoopFsRelationCommand": _convert_parquet_insert,
}
