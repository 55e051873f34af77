"""Expression-subtree fallback: wrap only the inconvertible expression.

Port of blaze_tpu/spark/expr_subtree_fallback.py.

Ref: NativeConverters.scala:290-372 — the reference counts inconvertible
children per expression during conversion: a supported expression tree
converts whole; an UNSUPPORTED node whose children convert is wrapped as a
SparkUDFWrapper whose param columns are computed natively, so one exotic
function no longer demotes the entire operator to the row engine.

The out-of-process analog: before strategy tagging, every operator's
expression trees are rewritten bottom-up; a `ScalarFn` the device registry
doesn't implement — but the row interpreter's `PYTHON_FNS` does — becomes
an `ir.UdfWrapper` over the SAME argument subtrees. The engine computes
the params columnar-side and crosses to the host evaluator only for that
one expression (exprs/compiler._compile_udf_wrapper, one pull and one
upload a batch). Everything else in the operator stays on
the accelerated path.

String/nested returns stay unwrapped (the wrapper crossing carries
fixed-width columns only — same gating as hive_udf.decode_json_udf), so
those expressions still demote the whole operator, preserving the old
fallback-by-construction contract.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.spark.plan_model import SparkPlan


def _map_value(v, fn):
    """Rewrite Exprs inside a field value, descending nested tuples
    (CaseWhen carries a tuple of (cond, value) PAIRS)."""
    if isinstance(v, ir.Expr):
        return _map_expr(v, fn)
    if isinstance(v, tuple):
        new = tuple(_map_value(x, fn) for x in v)
        # preserve identity when nothing changed so callers can use a
        # cheap `is` check instead of deep subtree equality
        return v if all(a is b for a, b in zip(new, v)) else new
    return v


def _map_expr(e: ir.Expr, fn: Callable[[ir.Expr], ir.Expr]) -> ir.Expr:
    """Bottom-up rebuild: apply `fn` to every node, children first."""
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        nv = _map_value(v, fn)
        if nv is not v:
            changes[f.name] = nv
    if changes:
        e = dataclasses.replace(e, **changes)
    return fn(e)


def _wrappable_return(dt: T.DataType) -> bool:
    return not (dt.is_string_like
                or dt.kind in (T.TypeKind.LIST, T.TypeKind.MAP,
                               T.TypeKind.STRUCT))


def _wrap_rule(e: ir.Expr) -> ir.Expr:
    from blaze_tpu_torch.exprs.functions import is_supported
    from blaze_tpu_torch.runtime import resources
    from blaze_tpu_torch.spark import fallback, hive_udf

    if not isinstance(e, ir.ScalarFn) or is_supported(e.name):
        return e
    name = e.name.lower()
    host = fallback.PYTHON_FNS.get(name)
    if host is None or e.result_type is None:
        return e  # nothing can run it: whole-operator fallback as before
    if not _wrappable_return(e.result_type):
        return e
    rid = f"fallbackfn:{name}:{e.result_type.kind.name.lower()}"
    if resources.try_get(rid) is None:
        # reuse the Hive-UDF param-column crossing adapter: interleaved
        # (values[, lengths], validity) per param + num_rows in, full
        # capacity (values, validity) out
        resources.put(rid, hive_udf._adapter(host, e.result_type))
    return ir.UdfWrapper(rid, e.result_type, True, e.args)


def _map_attr(obj, fn):
    if isinstance(obj, ir.Expr):
        return _map_expr(obj, fn)
    if isinstance(obj, dict):
        return {k: _map_attr(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_attr(v, fn) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_map_attr(v, fn) for v in obj)
    return obj


def rewrite_plan(plan: SparkPlan) -> None:
    """Rewrite every operator's expression attrs in place (pre-tagging)."""
    for c in plan.children:
        rewrite_plan(c)
    for k, v in list(plan.attrs.items()):
        plan.attrs[k] = _map_attr(v, _wrap_rule)
