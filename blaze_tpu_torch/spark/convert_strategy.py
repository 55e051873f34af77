"""Two-pass conversion strategy with the inefficiency-removal fixpoint.

Port of blaze_tpu/spark/convert_strategy.py: the same tags and demotions.
Ref: BlazeConvertStrategy.scala — pass 1 fills `convertible` tags by trial
conversion bottom-up (:56-69), pass 2 assigns AlwaysConvert/NeverConvert
decisions (:81-131), then `removeInefficientConverts` runs to a fixpoint
killing conversions that force expensive row<->columnar transitions
(:142-203): NonNative child under a native Filter/Agg, native shuffle fed
by a non-native agg, a native Expand/ParquetScan feeding a non-native
parent, and native Sort sandwiched between non-native nodes.
"""

from __future__ import annotations

import enum
from typing import Optional

from blaze_tpu_torch.spark.converters import check_convertible
from blaze_tpu_torch.spark.plan_model import SparkPlan


class ConvertStrategy(enum.Enum):
    DEFAULT = "Default"
    ALWAYS = "AlwaysConvert"
    NEVER = "NeverConvert"


_ALWAYS_KINDS = {"FileSourceScanExec"}  # cheap + unlock children (ref :81+)


def apply_strategy(plan: SparkPlan) -> SparkPlan:
    # expression-subtree fallback first (NativeConverters.scala:290-372):
    # the JAX package wraps a ScalarFn the device registry lacks for the
    # row interpreter; the port raises on one, naming spark/fallback.py
    from blaze_tpu_torch.spark.expr_subtree_fallback import rewrite_plan

    rewrite_plan(plan)
    _tag_convertible(plan)
    _assign(plan)
    changed = True
    while changed:
        changed = _remove_inefficient(plan)
    return plan


def _tag_convertible(plan: SparkPlan) -> None:
    for c in plan.children:
        _tag_convertible(c)
    plan.convertible = check_convertible(plan)


def _assign(plan: SparkPlan) -> None:
    for c in plan.children:
        _assign(c)
    if not plan.convertible:
        plan.strategy = ConvertStrategy.NEVER.value
    elif plan.kind in _ALWAYS_KINDS:
        plan.strategy = ConvertStrategy.ALWAYS.value
    else:
        plan.strategy = ConvertStrategy.DEFAULT.value


def _is_native(plan: SparkPlan) -> bool:
    return plan.strategy in (ConvertStrategy.DEFAULT.value,
                             ConvertStrategy.ALWAYS.value)


def _demote(plan: SparkPlan) -> bool:
    if plan.strategy == ConvertStrategy.DEFAULT.value:
        plan.strategy = ConvertStrategy.NEVER.value
        return True
    return False


def _remove_inefficient(plan: SparkPlan, parent: Optional[SparkPlan] = None
                        ) -> bool:
    """One fixpoint sweep; True if any node was demoted (ref :142-203)."""
    changed = False
    for c in plan.children:
        changed |= _remove_inefficient(c, plan)

    if not _is_native(plan):
        return changed

    kids_native = [(_is_native(c)) for c in plan.children]
    parent_native = parent is not None and _is_native(parent)

    # NonNative -> NativeFilter / NativeAgg: the row->columnar transition
    # costs more than the native op saves
    if plan.kind in ("FilterExec", "HashAggregateExec",
                     "SortAggregateExec", "ObjectHashAggregateExec"):
        if plan.children and not kids_native[0]:
            changed |= _demote(plan)
            return changed
    # non-native agg feeding a native shuffle
    if plan.kind == "ShuffleExchangeExec" and plan.children:
        child = plan.children[0]
        if child.kind.endswith("AggregateExec") and not _is_native(child):
            changed |= _demote(plan)
            return changed
    # NativeExpand / NativeParquetScan -> NonNative parent
    if plan.kind in ("ExpandExec", "FileSourceScanExec"):
        if parent is not None and not parent_native:
            if plan.kind == "ExpandExec":
                changed |= _demote(plan)
                return changed
            # scans stay native only if someone consumes them natively
            if plan.strategy != ConvertStrategy.ALWAYS.value:
                changed |= _demote(plan)
                return changed
    # NonNative -> NativeSort -> NonNative sandwich
    if plan.kind == "SortExec":
        child_native = bool(plan.children) and kids_native[0]
        if not child_native and (parent is None or not parent_native):
            changed |= _demote(plan)
            return changed
    return changed
