"""Expression-subtree fallback: wrap only the inconvertible expression.

Port of blaze_tpu/spark/expr_subtree_fallback.py. Ref:
NativeConverters.scala:290-372 — a supported expression tree converts
whole; an UNSUPPORTED scalar function whose children convert is wrapped
so that only that one expression crosses to a host evaluator, and the
rest of the operator stays native.

In the JAX package the wrapper's evaluator, and the whole-operator
demotion that happens when no wrapper applies, both run on the row
interpreter (spark/fallback.py, with spark/hive_udf.py's adapter). The
port has neither, so a `ScalarFn` the native registry does not name
raises here, naming spark/fallback.py, instead of being wrapped or
demoted. Every `ScalarFn` of the TPC-DS and validator catalogues
(`substring`) is in the registry, so the rewrite leaves their plans
unchanged in both packages.
"""

from __future__ import annotations

from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.spark.plan_model import SparkPlan


def _check_expr(e: ir.Expr) -> None:
    from blaze_tpu_torch.spark.converters import is_supported

    for c in e.children():
        _check_expr(c)
    if isinstance(e, ir.ScalarFn) and not is_supported(e.name):
        raise NotImplementedError(
            f"scalar function {e.name!r} runs only on the row interpreter "
            "(spark/fallback.py), not yet ported")


def rewrite_plan(plan: SparkPlan) -> None:
    """The pre-tagging pass over every operator's expression attrs. The
    JAX package rewrites unsupported scalar functions here; the port has
    nothing to rewrite them into, so it checks that there are none."""
    from blaze_tpu_torch.spark.converters import _iter_attr_exprs

    for c in plan.children:
        rewrite_plan(c)
    for e in _iter_attr_exprs(plan.attrs):
        _check_expr(e)
