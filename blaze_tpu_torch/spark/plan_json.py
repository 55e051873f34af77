"""Ingest Spark physical plans from TreeNode JSON (`plan.toJSON`).

Port of blaze_tpu/spark/plan_json.py.

THE Spark-facing contract: a JVM shim (or pyspark hook, see pyspark_ext.py)
captures `df._jdf.queryExecution().executedPlan().toJSON()` — Spark's
canonical TreeNode serialization — and this module lowers it into
`plan_model.SparkPlan` trees the planner already converts and executes.
This replaces hand-built dataclasses as the driver-side entry: real
Catalyst output, not a Python approximation (ref: the reference's L1/L2
layers read the live SparkPlan in-process, BlazeConverters.scala:133-222;
an out-of-process engine reads the same tree via its JSON form).

Format (Spark TreeNode.toJSON): a JSON array of ALL nodes in PRE-ORDER;
each element carries "class", "num-children" and the node's constructor
fields; nested TreeNodes inside a field (expressions in a plan node) are
embedded as their own pre-order arrays. Attribute identity is `exprId`,
and columns are renamed to the `#<exprId>` convention the reference uses
throughout (plan/Util.scala getFieldNameByExprId) so name collisions
across self-joins cannot alias.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.spark.plan_model import SparkPlan


class PlanJsonError(Exception):
    pass


# ---------------------------------------------------------------------------
# TreeNode pre-order decoding
# ---------------------------------------------------------------------------


def _build_tree(nodes: List[dict], pos: int = 0) -> Tuple[dict, int]:
    """Rebuild one tree from the pre-order array starting at `pos`.
    Returns ({node fields..., "children": [...]}, next_pos)."""
    node = dict(nodes[pos])
    n = int(node.get("num-children", 0))
    pos += 1
    children = []
    for _ in range(n):
        child, pos = _build_tree(nodes, pos)
        children.append(child)
    node["children"] = children
    return node, pos


def _cls(node: dict) -> str:
    return node.get("class", "").rsplit(".", 1)[-1]


def _expr_tree(field) -> Optional[dict]:
    """A TreeNode-valued field is embedded as its own pre-order array."""
    if field is None:
        return None
    if isinstance(field, list):
        if not field:
            return None
        tree, _ = _build_tree(field, 0)
        return tree
    if isinstance(field, dict):
        return field
    raise PlanJsonError(f"unexpected tree field {field!r}")


def _expr_list(field) -> List[dict]:
    """A Seq[Expression] field: list of embedded pre-order arrays."""
    if not field:
        return []
    out = []
    for item in field:
        if isinstance(item, list):
            tree, _ = _build_tree(item, 0)
            out.append(tree)
        elif isinstance(item, dict):
            out.append(item)
    return out


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

_SIMPLE_TYPES = {
    "boolean": T.BOOLEAN, "byte": T.INT8, "short": T.INT16,
    "integer": T.INT32, "long": T.INT64, "float": T.FLOAT32,
    "double": T.FLOAT64, "string": T.STRING, "binary": T.BINARY,
    "date": T.DATE, "timestamp": T.TIMESTAMP, "null": T.NULL,
}


def decode_datatype(dt) -> T.DataType:
    if isinstance(dt, str):
        s = dt.strip().strip('"')
        if s in _SIMPLE_TYPES:
            return _SIMPLE_TYPES[s]
        if s.startswith("decimal(") and s.endswith(")"):
            p, sc = s[8:-1].split(",")
            return T.decimal(int(p), int(sc))
        try:
            return decode_datatype(json.loads(dt))
        except (json.JSONDecodeError, PlanJsonError):
            raise PlanJsonError(f"unknown dataType {dt!r}")
    if isinstance(dt, dict):
        k = dt.get("type")
        if k == "array":
            return T.list_of(decode_datatype(dt["elementType"]))
        if k == "map":
            return T.map_of(decode_datatype(dt["keyType"]),
                            decode_datatype(dt["valueType"]))
        if k == "struct":
            return T.struct_of(
                T.Field(f["name"], decode_datatype(f["type"]),
                        f.get("nullable", True))
                for f in dt.get("fields", []))
        if k == "udt":
            raise PlanJsonError("UDT types are not convertible")
    raise PlanJsonError(f"unknown dataType {dt!r}")


def _attr_name(exprid) -> str:
    """`#<exprId>` naming (ref plan/Util.scala getFieldNameByExprId)."""
    if isinstance(exprid, dict):
        return f"#{exprid.get('id', 0)}"
    return f"#{exprid}"


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_BIN = {
    "Add": ir.BinOp.ADD, "Subtract": ir.BinOp.SUB,
    "Multiply": ir.BinOp.MUL, "Divide": ir.BinOp.DIV,
    "Remainder": ir.BinOp.MOD,
    "EqualTo": ir.BinOp.EQ, "EqualNullSafe": ir.BinOp.EQ_NULLSAFE,
    "LessThan": ir.BinOp.LT, "LessThanOrEqual": ir.BinOp.LE,
    "GreaterThan": ir.BinOp.GT, "GreaterThanOrEqual": ir.BinOp.GE,
    "And": ir.BinOp.AND, "Or": ir.BinOp.OR,
    "BitwiseAnd": ir.BinOp.BIT_AND, "BitwiseOr": ir.BinOp.BIT_OR,
    "BitwiseXor": ir.BinOp.BIT_XOR,
    "ShiftLeft": ir.BinOp.SHIFT_LEFT, "ShiftRight": ir.BinOp.SHIFT_RIGHT,
}

# Catalyst fn class -> engine scalar fn name (exprs/functions registry)
_FN = {
    "Abs": "abs", "Acos": "acos", "Asin": "asin", "Atan": "atan",
    "Atan2": "atan2", "Ceil": "ceil", "Cos": "cos", "Exp": "exp",
    "Floor": "floor", "Log": "ln", "Log10": "log10", "Log2": "log2",
    "Pow": "pow", "Round": "round", "Signum": "signum", "Sin": "sin",
    "Sqrt": "sqrt", "Tan": "tan", "Coalesce": "coalesce",
    "IsNaN": "isnan", "NaNvl": "nanvl",
    "Ascii": "ascii", "BitLength": "bit_length", "Chr": "chr",
    "Concat": "concat", "ConcatWs": "concat_ws", "InitCap": "initcap",
    "Length": "length", "Lower": "lower", "Upper": "upper",
    "StringLPad": "lpad", "StringRPad": "rpad", "StringTrim": "trim",
    "StringTrimLeft": "ltrim", "StringTrimRight": "rtrim",
    "StringRepeat": "repeat", "StringReplace": "replace",
    "StringReverse": "reverse", "StringSpace": "string_space",
    "StringSplit": "split", "Substring": "substr",
    "StringLocate": "strpos", "StringInstr": "instr",
    "StringTranslate": "translate", "SplitPart": "split_part",
    "Left": "left", "Right": "right", "Hex": "to_hex",
    "Md5": "md5", "Crc32": "crc32",
    "GetJsonObject": "get_json_object",
    "Murmur3Hash": "murmur3_hash", "CreateArray": "make_array",
    "DateAdd": "date_add", "DateSub": "date_sub",
    "DateDiff": "datediff", "Year": "year", "Month": "month",
    "DayOfMonth": "day",
    # the JAX package's map lacks DayOfWeek, though its registry runs
    # dayofweek: its decoder refuses plans the port decodes (ROADMAP
    # Queue 3)
    "DayOfWeek": "dayofweek",
}

_AGG_FN = {
    "Sum": "sum", "Count": "count", "Average": "avg", "Min": "min",
    "Max": "max", "First": "first", "CollectList": "collect_list",
    "CollectSet": "collect_set",
}

# engine-external function expressions (single source of truth there)
from blaze_tpu_torch.spark.hive_udf import UDF_CLASSES as _UDF_CLASSES  # noqa: E402


def decode_expr(node: dict) -> ir.Expr:
    cls = _cls(node)
    ch = node["children"]

    if cls in _shim().transparent_expr_wrappers():
        # PromotePrecision (<=3.3) / KnownNotNull / normalized-float
        # hints: identity value semantics on these kernels
        return decode_expr(ch[0])
    if cls == "AttributeReference":
        return ir.Col(_attr_name(node.get("exprId")))
    if cls == "Alias":
        return decode_expr(ch[0])
    if cls == "Literal":
        dt = decode_datatype(node.get("dataType"))
        v = node.get("value")
        if v is None:
            return ir.Literal(dt, None)
        if dt.kind in (T.TypeKind.INT8, T.TypeKind.INT16, T.TypeKind.INT32,
                       T.TypeKind.INT64, T.TypeKind.DATE,
                       T.TypeKind.TIMESTAMP):
            return ir.Literal(dt, int(v))
        if dt.kind in (T.TypeKind.FLOAT32, T.TypeKind.FLOAT64):
            return ir.Literal(dt, float(v))
        if dt.kind == T.TypeKind.BOOLEAN:
            return ir.Literal(dt, v in (True, "true", "True", 1))
        if dt.kind == T.TypeKind.DECIMAL:
            from decimal import Decimal

            return ir.Literal(dt, int(Decimal(str(v)).scaleb(dt.scale)))
        return ir.Literal(dt, str(v))
    if cls in _BIN:
        # Catalyst arithmetic nodes carry their planned dataType — the
        # decimal result precision/scale the engine must honor
        # (NativeConverters.scala:599-676)
        rt = None
        if node.get("dataType") is not None:
            try:
                rt = decode_datatype(node.get("dataType"))
            except PlanJsonError:
                rt = None
        return ir.Binary(_BIN[cls], decode_expr(ch[0]), decode_expr(ch[1]),
                         result_type=rt)
    if cls == "Not":
        return ir.Not(decode_expr(ch[0]))
    if cls == "IsNull":
        return ir.IsNull(decode_expr(ch[0]))
    if cls == "IsNotNull":
        return ir.IsNotNull(decode_expr(ch[0]))
    if cls == "UnaryMinus":
        return ir.Negate(decode_expr(ch[0]))
    if cls == "Cast" or cls == "AnsiCast":
        if cls == "AnsiCast" or not _shim().cast_is_legacy(node):
            # the engine's cast kernels implement LEGACY (non-ANSI)
            # semantics; ANSI/TRY casts must stay on Spark
            raise PlanJsonError("non-LEGACY cast mode stays on Spark")
        return ir.Cast(decode_expr(ch[0]),
                       decode_datatype(node.get("dataType")))
    if cls == "In":
        return ir.InList(decode_expr(ch[0]),
                         tuple(decode_expr(c) for c in ch[1:]), False)
    if cls == "InSet":
        raise PlanJsonError("InSet carries opaque values; stays on Spark")
    if cls == "If":
        return ir.If(decode_expr(ch[0]), decode_expr(ch[1]),
                     decode_expr(ch[2]))
    if cls == "CaseWhen":
        # children: [c1, v1, c2, v2, ..., else?]
        pairs = []
        i = 0
        while i + 1 < len(ch):
            pairs.append((decode_expr(ch[i]), decode_expr(ch[i + 1])))
            i += 2
        other = decode_expr(ch[i]) if i < len(ch) else None
        return ir.CaseWhen(tuple(pairs), other)
    if cls == "StartsWith":
        return _string_pred("starts_with", ch)
    if cls == "EndsWith":
        return _string_pred("ends_with", ch)
    if cls == "Contains":
        return _string_pred("contains", ch)
    if cls == "Like":
        pat = decode_expr(ch[1])
        if not isinstance(pat, ir.Literal):
            raise PlanJsonError("LIKE with non-literal pattern")
        esc = node.get("escapeChar", "\\")
        return ir.Like(decode_expr(ch[0]), _as_bytes(pat.value),
                       _as_bytes(esc))
    if cls == "GetStructField":
        return ir.GetStructField(decode_expr(ch[0]),
                                 int(node.get("ordinal", 0)))
    if cls == "GetArrayItem":
        idx = decode_expr(ch[1])
        if not isinstance(idx, ir.Literal):
            raise PlanJsonError("GetArrayItem with non-literal index")
        return ir.GetIndexedField(decode_expr(ch[0]), idx)
    if cls == "GetMapValue":
        key = decode_expr(ch[1])
        if not isinstance(key, ir.Literal):
            raise PlanJsonError("GetMapValue with non-literal key")
        return ir.GetMapValue(decode_expr(ch[0]), key)
    if cls == "CreateNamedStruct":
        names = []
        vals = []
        for i in range(0, len(ch), 2):
            nm = decode_expr(ch[i])
            names.append(str(nm.value) if isinstance(nm, ir.Literal)
                         else f"col{i // 2}")
            vals.append(decode_expr(ch[i + 1]))
        fields = T.struct_of(T.Field(n, _guess_dtype(v))
                             for n, v in zip(names, vals))
        return ir.NamedStruct(tuple(names), tuple(vals), fields)
    if cls in _FN:
        return ir.ScalarFn(_FN[cls], tuple(decode_expr(c) for c in ch))
    if cls == "ScalarSubquery":
        raise PlanJsonError("scalar subquery needs the JVM wrapper")
    if cls in _UDF_CLASSES:
        from blaze_tpu_torch.spark.hive_udf import decode_json_udf

        return decode_json_udf(node, decode_expr)
    raise PlanJsonError(f"expression {cls} not convertible")


def _string_pred(op: str, ch) -> ir.Expr:
    pat = decode_expr(ch[1])
    if not isinstance(pat, ir.Literal):
        raise PlanJsonError(f"{op} with non-literal pattern")
    return ir.StringPredicate(op, decode_expr(ch[0]), _as_bytes(pat.value))


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    return str(v).encode()


def _guess_dtype(e: ir.Expr) -> T.DataType:
    for attr in ("dtype", "result_type"):
        dt = getattr(e, attr, None)
        if dt is not None:
            return dt
    return T.STRING


_CMP_OPS = {ir.BinOp.EQ, ir.BinOp.NEQ, ir.BinOp.LT, ir.BinOp.LE,
            ir.BinOp.GT, ir.BinOp.GE, ir.BinOp.EQ_NULLSAFE,
            ir.BinOp.AND, ir.BinOp.OR}


def _promote(lt: T.DataType, rt: T.DataType) -> T.DataType:
    """MIRROR the runtime's arithmetic dtype (exprs/compiler._arith
    promotes as numpy does): int+float -> FLOAT64, not the wider operand. A
    declared dtype that disagrees with the executed column corrupts
    shuffle-frame decode at the next stage boundary."""
    import numpy as np

    try:
        got = np.promote_types(lt.np_dtype(), rt.np_dtype())
    except TypeError:
        return lt
    for cand in (T.INT8, T.INT16, T.INT32, T.INT64, T.FLOAT32, T.FLOAT64):
        if np.dtype(cand.np_dtype()) == got:
            return cand
    return lt


def _infer_dtype(e: ir.Expr, schema: T.Schema) -> T.DataType:
    """Result dtype of a decoded expression against its input schema —
    Alias TreeNode JSON carries no dataType, so computed projections must
    infer (defaulting to STRING would corrupt shuffle-frame decode)."""
    if isinstance(e, ir.Col):
        try:
            return schema.fields[schema.index_of(e.name)].dtype
        except KeyError:
            return T.STRING
    if isinstance(e, ir.Literal):
        return e.dtype
    if isinstance(e, ir.Cast):
        return e.dtype
    if isinstance(e, (ir.Not, ir.IsNull, ir.IsNotNull, ir.StringPredicate,
                      ir.Like, ir.InList)):
        return T.BOOLEAN
    if isinstance(e, ir.Negate):
        return _infer_dtype(e.child, schema)
    if isinstance(e, ir.Binary):
        if e.op in _CMP_OPS:
            return T.BOOLEAN
        if e.op == ir.BinOp.DIV:
            lt = _infer_dtype(e.left, schema)
            return lt if lt.kind == T.TypeKind.DECIMAL else T.FLOAT64
        lt = _infer_dtype(e.left, schema)
        rt = _infer_dtype(e.right, schema)
        return _promote(lt, rt)
    if isinstance(e, ir.If):
        return _infer_dtype(e.then, schema)
    if isinstance(e, ir.CaseWhen) and e.branches:
        return _infer_dtype(e.branches[0][1], schema)
    if isinstance(e, ir.NamedStruct):
        return e.result_type
    return _guess_dtype(e)


def _attr_field(a: dict) -> T.Field:
    return T.Field(_attr_name(a.get("exprId")),
                   decode_datatype(a.get("dataType")),
                   bool(a.get("nullable", True)))


def _output_schema(node: dict) -> T.Schema:
    out = node.get("output")
    if out is None:
        raise PlanJsonError("node carries no output attribute list")
    attrs = []
    for item in out:
        tree = _expr_tree(item)
        if tree is None or _cls(tree) != "AttributeReference":
            raise PlanJsonError("non-attribute in output")
        attrs.append(_attr_field(tree))
    return T.Schema(attrs)


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


# decode-time version shim (spark/shims.py); module-level because the
# recursive decoders thread no context object. decode_plan_json is the
# only writer.
_CURRENT_SHIM = None


def _shim():
    global _CURRENT_SHIM
    if _CURRENT_SHIM is None:
        from blaze_tpu_torch.spark.shims import for_version

        _CURRENT_SHIM = for_version(None)
    return _CURRENT_SHIM


def decode_plan_json(text: str, spark_version: str = None) -> SparkPlan:
    """Spark `executedPlan.toJSON` -> SparkPlan tree (planner input).

    spark_version selects the per-version decode shim (spark/shims.py) —
    node-class renames, AQE shells, cast eval-mode and limit-offset
    encodings differ across 3.0-3.5; None = the 3.3 dialect."""
    from blaze_tpu_torch.spark.shims import for_version

    from blaze_tpu_torch.spark.shims import ShimError

    global _CURRENT_SHIM
    prev = _CURRENT_SHIM
    try:
        _CURRENT_SHIM = for_version(spark_version)
        nodes = json.loads(text)
        if not isinstance(nodes, list) or not nodes:
            raise PlanJsonError("expected the TreeNode pre-order array")
        tree, _ = _build_tree(nodes, 0)
        return _decode_node(tree)
    except PlanJsonError:
        raise
    except (ShimError, json.JSONDecodeError) as e:
        # one error contract at this boundary: the embedding layer keys
        # its native/fallback decision on PlanJsonError (tryConvert)
        raise PlanJsonError(str(e)) from e
    except (KeyError, IndexError, TypeError, ValueError,
            AttributeError) as e:
        # malformed/adversarial TreeNode JSON must never escape as a raw
        # crash: live Catalyst variance (unknown nodes, dropped fields,
        # junk values) demotes to fallback, it does not kill the task
        raise PlanJsonError(
            f"malformed plan JSON: {type(e).__name__}: {e}") from e
    finally:
        _CURRENT_SHIM = prev


_JOIN_TYPES = {"Inner": "inner", "LeftOuter": "left", "RightOuter": "right",
               "FullOuter": "full", "LeftSemi": "left_semi",
               "LeftAnti": "left_anti", "Cross": "inner"}


def _decode_node(node: dict) -> SparkPlan:
    shim = _shim()
    cls = shim.normalize_plan_class(_cls(node))
    ch = node["children"]

    # transparent wrappers (AQE shells, columnar transitions, reused
    # exchanges — ref shims AQE node recognition, ShimsImpl.scala:271-299;
    # the per-version shell set lives in spark/shims.py)
    if cls in shim.transparent_wrappers() or cls in (
            "AQEShuffleReadExec", "CollectLimitExec"):
        if cls == "CollectLimitExec":
            if shim.limit_offset(node):
                raise PlanJsonError("limit offset has no kernel; "
                                    "stays on Spark")
            inner = _decode_node(ch[0])
            return SparkPlan("GlobalLimitExec", inner.schema, [inner],
                             {"limit": int(node.get("limit", 0))})
        return _decode_node(ch[0])

    if cls == "FileSourceScanExec":
        # the scan reads the FILE's real column names; a rename projection
        # re-labels them to `#<exprId>` for everything downstream (the
        # reference's addRenameColumnsExec, BlazeConverters.scala:809)
        real_fields, out_fields, exprs, names = [], [], [], []
        for item in node.get("output", []):
            tree = _expr_tree(item)
            if tree is None or _cls(tree) != "AttributeReference":
                raise PlanJsonError("non-attribute in scan output")
            dt = decode_datatype(tree.get("dataType"))
            real = str(tree.get("name"))
            eid = _attr_name(tree.get("exprId"))
            real_fields.append(T.Field(real, dt,
                                       bool(tree.get("nullable", True))))
            out_fields.append(T.Field(eid, dt,
                                      bool(tree.get("nullable", True))))
            exprs.append(ir.Col(real))
            names.append(eid)
        files = [(p, []) for p in _scan_paths(node)]
        scan = SparkPlan("FileSourceScanExec", T.Schema(real_fields), [],
                         {"format": "parquet", "files": files,
                          "pruning_predicates": []})
        return SparkPlan("ProjectExec", T.Schema(out_fields), [scan],
                         {"exprs": exprs, "names": names})
    if cls == "FilterExec":
        child = _decode_node(ch[0])
        cond = decode_expr(_expr_tree(node.get("condition")))
        return SparkPlan("FilterExec", child.schema, [child],
                         {"condition": cond})
    if cls == "ProjectExec":
        child = _decode_node(ch[0])
        exprs, names, fields = [], [], []
        for item in node.get("projectList", []):
            tree = _expr_tree(item)
            e = decode_expr(tree)
            exprs.append(e)
            names.append(_attr_name(tree.get("exprId")))
            if _cls(tree) == "Alias":
                fields.append(T.Field(
                    names[-1], _alias_dtype(tree, e, child.schema), True))
            else:
                fields.append(_attr_field(tree))
        return SparkPlan("ProjectExec", T.Schema(fields), [child],
                         {"exprs": exprs, "names": names})
    if cls == "SortExec":
        child = _decode_node(ch[0])
        return SparkPlan("SortExec", child.schema, [child],
                         {"orders": _decode_sort_orders(node),
                          "fetch": None})
    if cls in ("SortMergeJoinExec", "ShuffledHashJoinExec"):
        left, right = _decode_node(ch[0]), _decode_node(ch[1])
        jt = _JOIN_TYPES.get(str(node.get("joinType")), None)
        if jt is None:
            raise PlanJsonError(f"join type {node.get('joinType')}")
        attrs = {
            "left_keys": [decode_expr(t) for t in
                          _expr_list(node.get("leftKeys"))],
            "right_keys": [decode_expr(t) for t in
                           _expr_list(node.get("rightKeys"))],
            "join_type": jt,
            "condition": (decode_expr(_expr_tree(node.get("condition")))
                          if node.get("condition") else None),
        }
        schema = _join_schema(left, right, jt)
        return SparkPlan("SortMergeJoinExec", schema, [left, right], attrs)
    if cls == "BroadcastHashJoinExec":
        left, right = _decode_node(ch[0]), _decode_node(ch[1])
        jt = _JOIN_TYPES.get(str(node.get("joinType")), None)
        if jt is None:
            raise PlanJsonError(f"join type {node.get('joinType')}")
        schema = _join_schema(left, right, jt)
        return SparkPlan(
            "BroadcastHashJoinExec", schema, [left, right],
            {"left_keys": [decode_expr(t) for t in
                           _expr_list(node.get("leftKeys"))],
             "right_keys": [decode_expr(t) for t in
                            _expr_list(node.get("rightKeys"))],
             "join_type": jt,
             "build_side": ("left" if "Left" in str(node.get("buildSide"))
                            else "right"),
             "condition": (decode_expr(_expr_tree(node.get("condition")))
                           if node.get("condition") else None)})
    if cls in ("HashAggregateExec", "SortAggregateExec",
               "ObjectHashAggregateExec"):
        return _decode_agg(cls, node)
    if cls == "ShuffleExchangeExec":
        child = _decode_node(ch[0])
        part = _expr_tree(node.get("outputPartitioning"))
        keys, nparts, kind = [], 4, None
        if part is not None:
            pcls = _cls(part)
            nparts = int(part.get("numPartitions", 4))
            if pcls == "HashPartitioning":
                keys = [decode_expr(c) for c in part["children"]]
            elif pcls == "RoundRobinPartitioning":
                kind = "round_robin"
            elif pcls == "RangePartitioning":
                # content-preserving stand-in: rows spread round-robin;
                # the ordering a range exchange served is re-established
                # by the SortExec Spark always places above it (and the
                # runner's ordered collect for root sorts)
                kind = "round_robin"
            elif pcls == "SinglePartition":
                nparts = 1
            else:
                raise PlanJsonError(f"partitioning {pcls}")
        return SparkPlan("ShuffleExchangeExec", child.schema, [child],
                         {"keys": keys, "num_partitions": nparts,
                          "kind": kind})
    if cls == "BroadcastExchangeExec":
        child = _decode_node(ch[0])
        return SparkPlan("BroadcastExchangeExec", child.schema, [child], {})
    if cls in ("LocalLimitExec", "GlobalLimitExec"):
        if shim.limit_offset(node):
            raise PlanJsonError("limit offset has no kernel; "
                                "stays on Spark")
        child = _decode_node(ch[0])
        return SparkPlan(cls, child.schema, [child],
                         {"limit": int(node.get("limit", 0))})
    if cls == "UnionExec":
        children = [_decode_node(c) for c in ch]
        return SparkPlan("UnionExec", children[0].schema, children, {})
    if cls == "TakeOrderedAndProjectExec":
        child = _decode_node(ch[0])
        srt = SparkPlan("SortExec", child.schema, [child],
                        {"orders": _decode_sort_orders(node),
                         "fetch": int(node.get("limit", 0))})
        return SparkPlan("GlobalLimitExec", child.schema, [srt],
                         {"limit": int(node.get("limit", 0))})
    if cls == "WindowExec":
        return _decode_window(node)
    if cls == "ExpandExec":
        child = _decode_node(node["children"][0])
        projections = [[decode_expr(t) for t in _expr_list(proj)]
                       for proj in node.get("projections", [])]
        return SparkPlan("ExpandExec", _output_schema(node), [child],
                         {"projections": projections})
    if cls == "GenerateExec":
        return _decode_generate(node)
    if cls == "BroadcastNestedLoopJoinExec":
        left = _decode_node(ch[0])
        right = _decode_node(ch[1])
        jt_raw = str(node.get("joinType"))
        jt = ("cross" if jt_raw == "Cross"
              else _JOIN_TYPES.get(jt_raw))
        if jt is None:
            raise PlanJsonError(f"BNLJ join type {jt_raw}")
        cond = (decode_expr(_expr_tree(node.get("condition")))
                if node.get("condition") else None)
        return SparkPlan(
            "BroadcastNestedLoopJoinExec",
            _join_schema(left, right, jt), [left, right],
            {"join_type": jt, "condition": cond})
    raise PlanJsonError(f"plan node {cls} not supported")


_WINDOW_BUILTINS = {"RowNumber": "row_number", "Rank": "rank",
                    "DenseRank": "dense_rank"}


def _decode_window(node: dict) -> SparkPlan:
    """WindowExec: windowExpression (Alias over WindowExpression),
    partitionSpec, orderSpec. Only default frames convert (the engine's
    rank trio + whole-partition aggregate windows, ops/window.py); an
    explicit non-default frame falls back."""
    child = _decode_node(node["children"][0])
    calls, wfields = [], []
    for item in node.get("windowExpression", []):
        tree = _expr_tree(item)
        if tree is None or _cls(tree) != "Alias":
            raise PlanJsonError("window expression without Alias")
        name = _attr_name(tree.get("exprId"))
        we = tree["children"][0]
        if _cls(we) != "WindowExpression":
            raise PlanJsonError(f"window alias over {_cls(we)}")
        fn_tree = we["children"][0]
        fn_cls = _cls(fn_tree)
        if fn_cls in _WINDOW_BUILTINS:
            # rank-like results are frame-independent — Spark resolves
            # them with their own ROWS frame (RowNumberLike.frame), which
            # must NOT trip the frame check below
            fn = _WINDOW_BUILTINS[fn_cls]
            calls.append({"fn": fn, "args": [], "dtype": T.INT32,
                          "name": name})
            wfields.append(T.Field(name, T.INT32, False))
            continue
        if fn_cls != "AggregateExpression":
            raise PlanJsonError(f"window function {fn_cls}")
        _check_window_frame(we)
        agg_tree = fn_tree["children"][0]
        agg_cls = _cls(agg_tree)
        fn = _AGG_FN.get(agg_cls)
        if fn not in ("count", "sum", "avg", "min", "max"):
            # the engine's window op computes these only (ops/window.py);
            # first/collect would crash mid-query instead of falling back
            raise PlanJsonError(f"window aggregate {agg_cls}")
        args = [decode_expr(c) for c in agg_tree["children"]]
        if fn == "count" and not args:
            args = [ir.Literal(T.INT32, 1)]
        dtype = _agg_dtype(fn, agg_tree, args)
        calls.append({"fn": fn, "args": args, "dtype": dtype, "name": name})
        wfields.append(T.Field(name, dtype, True))
    part_by = [decode_expr(t) for t in _expr_list(node.get("partitionSpec"))]
    order_by = _decode_sort_orders({"sortOrder": node.get("orderSpec", [])})
    return SparkPlan(
        "WindowExec",
        T.Schema(list(child.schema.fields) + wfields), [child],
        {"calls": calls, "partition_by": part_by, "order_by": order_by})


def _check_window_frame(we: dict) -> None:
    """The engine computes default frames only (whole partition, or RANGE
    unbounded-preceding..current-row with peer leveling, ops/window.py).
    A SpecifiedWindowFrame with other bounds — or a ROWS frame ending at
    CURRENT ROW, whose per-row running value differs from RANGE peer
    leveling on ties — must fall back to Spark. Resolved Spark plans
    always materialize the frame, with case-object boundaries serialized
    as '...UnboundedPreceding$' classes."""
    def name_of(v) -> str:
        if isinstance(v, dict):
            v = v.get("object") or v.get("class") or ""
        return str(v).rsplit(".", 1)[-1].rstrip("$")

    def walk(t: dict):
        if _cls(t).rstrip("$") == "SpecifiedWindowFrame":
            bounds = [name_of(b.get("class")) for b in t["children"]]
            for key in ("lower", "upper"):
                if t.get(key) is not None and not isinstance(
                        t.get(key), int):
                    bounds.append(name_of(t.get(key)))
            ok_lower = "UnboundedPreceding" in bounds
            unbounded_upper = "UnboundedFollowing" in bounds
            ok_upper = unbounded_upper or "CurrentRow" in bounds
            if bounds and not (ok_lower and ok_upper):
                raise PlanJsonError(
                    f"non-default window frame {bounds} not convertible")
            ftype = name_of(t.get("frameType"))
            if (bounds and not unbounded_upper
                    and ftype not in ("", "RangeFrame")):
                raise PlanJsonError(
                    f"{ftype} up to CURRENT ROW differs from the engine's "
                    "RANGE peer leveling on ties")
        for c in t.get("children", []):
            walk(c)

    walk(we)


def _decode_generate(node: dict) -> SparkPlan:
    child = _decode_node(node["children"][0])
    gen = _expr_tree(node.get("generator"))
    if gen is None:
        raise PlanJsonError("GenerateExec without generator")
    gcls = _cls(gen)
    if gcls not in ("Explode", "PosExplode"):
        raise PlanJsonError(f"generator {gcls} not convertible")
    gen_child = decode_expr(gen["children"][0])
    req_fields = []
    for item in node.get("requiredChildOutput", []):
        tree = _expr_tree(item)
        if tree is None or _cls(tree) != "AttributeReference":
            raise PlanJsonError("non-attribute in requiredChildOutput")
        req_fields.append(_attr_field(tree))
    out_fields = []
    for item in node.get("generatorOutput", []):
        tree = _expr_tree(item)
        if tree is None or _cls(tree) != "AttributeReference":
            raise PlanJsonError("non-attribute in generatorOutput")
        out_fields.append(_attr_field(tree))
    child_names = child.schema.names()
    try:
        req_idx = [child_names.index(f.name) for f in req_fields]
    except ValueError as e:
        raise PlanJsonError(f"requiredChildOutput not in child: {e}")
    return SparkPlan(
        "GenerateExec", T.Schema(req_fields + out_fields), [child],
        {"pos": gcls == "PosExplode", "generator": gen_child,
         "required_cols": req_idx,
         "output_names": [f.name for f in out_fields],
         "outer": bool(node.get("outer", False))})


def _alias_dtype(tree: dict, e: ir.Expr,
                 schema: Optional[T.Schema] = None) -> T.DataType:
    """Declared dataType when decodable, else inference against the child
    schema, else the expression's own carried dtype."""
    dt = tree.get("dataType")
    if dt is not None:
        try:
            return decode_datatype(dt)
        except PlanJsonError:
            pass
    if schema is not None:
        return _infer_dtype(e, schema)
    return _guess_dtype(e)


def _scan_paths(node: dict) -> List[str]:
    rel = node.get("relation") or {}
    loc = rel.get("location") or {}
    paths = loc.get("rootPaths") or loc.get("paths") or []
    return [p.replace("file:", "", 1) if isinstance(p, str)
            and p.startswith("file:") else p for p in paths]


def _join_schema(left: SparkPlan, right: SparkPlan, jt: str) -> T.Schema:
    if jt in ("left_semi", "left_anti"):
        return left.schema
    return T.Schema(list(left.schema.fields) + list(right.schema.fields))


def _decode_sort_orders(node: dict) -> List[tuple]:
    orders = []
    for item in node.get("sortOrder", []):
        so = _expr_tree(item)
        orders.append((decode_expr(so["children"][0]),
                       so.get("direction") != "Descending",
                       "First" in str(so.get("nullOrdering", ""))))
    return orders


def _decode_agg(cls: str, node: dict) -> SparkPlan:
    ch = node["children"]
    child = _decode_node(ch[0])
    grouping, gnames, gfields = [], [], []
    for item in node.get("groupingExpressions", []):
        tree = _expr_tree(item)
        e = decode_expr(tree)
        grouping.append(e)
        nm = _attr_name(tree.get("exprId"))
        gnames.append(nm)
        gfields.append(T.Field(nm, _alias_dtype(tree, e), True))

    aggs, afields = [], []
    mode = "final"
    for item in node.get("aggregateExpressions", []):
        tree = _expr_tree(item)
        if _cls(tree) != "AggregateExpression":
            raise PlanJsonError("unexpected aggregateExpression entry")
        m = str(tree.get("mode", "")).lower()
        mode = {"partial": "partial", "partialmerge": "partial_merge",
                "final": "final", "complete": "final"}.get(m, "final")
        fn_tree = tree["children"][0]
        fn_cls = _cls(fn_tree)
        fn = _AGG_FN.get(fn_cls)
        if fn is None:
            raise PlanJsonError(f"aggregate fn {fn_cls}")
        if fn == "first" and tree.get("ignoreNulls"):
            fn = "first_ignores_null"
        args = [decode_expr(c) for c in fn_tree["children"]]
        if fn == "count" and not args:
            args = [ir.Literal(T.INT32, 1)]
        rid = tree.get("resultId") or tree.get("exprId") or {}
        name = _attr_name(rid)
        dtype = _agg_dtype(fn, fn_tree, args)
        aggs.append({"fn": fn, "args": args, "dtype": dtype, "name": name})
        afields.append(T.Field(name, dtype, True))

    schema = (T.Schema(gfields) if mode in ("partial", "partial_merge")
              else T.Schema(gfields + afields))
    return SparkPlan(cls, schema, [child],
                     {"mode": mode, "grouping": grouping,
                      "grouping_names": gnames, "aggs": aggs})


def _agg_dtype(fn: str, fn_tree: dict, args: List[ir.Expr]) -> T.DataType:
    dt = fn_tree.get("dataType")
    if dt is not None:
        try:
            return decode_datatype(dt)
        except PlanJsonError:
            pass
    if fn == "count":
        return T.INT64
    if fn == "avg":
        return T.FLOAT64
    if args:
        return _guess_dtype(args[0])
    return T.FLOAT64
