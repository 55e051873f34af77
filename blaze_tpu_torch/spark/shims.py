"""Per-Spark-version decode shims for TreeNode-JSON plan ingestion.

Port of blaze_tpu/spark/shims.py.

Ref: the reference ships one shim module per Spark line
(spark-extension-shims-spark30x .. -spark35x; Shims.scala:54-231 is the
dispatch surface, ShimsImpl.scala:271-299 the AQE node recognition) —
version differences live behind one interface so the converter core
stays version-free. Out of process the same differences surface in the
`toJSON` encoding; this module is that interface for the JSON decoder:

  * node-class renames: `CustomShuffleReaderExec` (3.0-3.1) became
    `AQEShuffleReadExec` (3.2+); 3.5 adds `TableCacheQueryStageExec` /
    `ResultQueryStageExec` AQE shells.
  * transparent expression wrappers: `PromotePrecision` wraps decimal
    operands through 3.3 and was REMOVED in 3.4 (SPARK-39316);
    `KnownNotNull` / `KnownFloatingPointNormalized` /
    `NormalizeNaNAndZero` are optimizer hints with identity value
    semantics on this engine's kernels.
  * Cast mode: 3.0-3.3 encode `ansiEnabled: bool`; 3.4+ encode
    `evalMode: LEGACY|ANSI|TRY` (SPARK-40389). This engine implements
    LEGACY (non-ANSI) semantics; ANSI/TRY casts raise PlanJsonError so
    the node falls back to Spark rather than silently changing error
    behavior.
  * limit offsets: 3.4 added `offset` to Global/CollectLimit
    (SPARK-28330); non-zero offsets have no kernel here and fall back.

The shim is selected from the version string the capture tool records
(`pyspark_ext.capture_plan_json` stores `spark.version` alongside the
plan); unknown versions resolve to the nearest known line below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class ShimError(Exception):
    pass


# AQE / codegen / transition shells that decode transparently to their
# child, by the first Spark line that emits them
_BASE_WRAPPERS = frozenset({
    "AdaptiveSparkPlanExec", "QueryStageExec", "ShuffleQueryStageExec",
    "BroadcastQueryStageExec", "InputAdapter", "WholeStageCodegenExec",
    "ColumnarToRowExec", "RowToColumnarExec", "ReusedExchangeExec",
})
_35_WRAPPERS = frozenset({"TableCacheQueryStageExec",
                          "ResultQueryStageExec"})

# optimizer-hint expression wrappers with identity value semantics here
_BASE_EXPR_WRAPPERS = frozenset({
    "PromotePrecision", "KnownNotNull", "KnownFloatingPointNormalized",
    "NormalizeNaNAndZero",
})


@dataclasses.dataclass(frozen=True)
class Shim:
    version: tuple            # (major, minor)

    # ---- plan-node surface ----
    def normalize_plan_class(self, cls: str) -> str:
        # unconditional: 3.2+ never emits the old name, so accepting it
        # under every shim is strictly safe (and a 3.0/3.1 capture
        # decoded without an explicit version must not regress)
        if cls == "CustomShuffleReaderExec":
            return "AQEShuffleReadExec"
        return cls

    def transparent_wrappers(self) -> frozenset:
        w = _BASE_WRAPPERS
        if self.version >= (3, 5):
            w = w | _35_WRAPPERS
        return w

    def limit_offset(self, node: dict) -> int:
        # unconditional (not gated on >= 3.4): the field never appears
        # in <=3.3 JSON, and a 3.4+ capture decoded WITHOUT its version
        # string must still fall back loudly rather than silently drop
        # the offset
        v = node.get("offset", 0)
        return int(v) if v else 0

    # ---- expression surface ----
    def transparent_expr_wrappers(self) -> frozenset:
        # PromotePrecision no longer exists in 3.4+, but accepting it
        # unconditionally is harmless (identity semantics either way)
        return _BASE_EXPR_WRAPPERS

    def cast_is_legacy(self, node: dict) -> bool:
        """True when the cast carries the non-ANSI semantics this
        engine's cast kernels implement (exprs/cast.py).

        BOTH encodings are checked regardless of version: `evalMode`
        (3.4+) and `ansiEnabled` (<=3.3) never coexist, and a 3.4+
        capture decoded without its version string must still reject
        ANSI/TRY casts instead of running them with LEGACY kernels."""
        mode = node.get("evalMode")
        if mode is not None:
            # encoded as a bare enum name or Some(name)
            if isinstance(mode, list) and mode:
                mode = mode[0]
            return str(mode).upper() == "LEGACY"
        return not bool(node.get("ansiEnabled", False))


_KNOWN = [(3, 0), (3, 1), (3, 2), (3, 3), (3, 4), (3, 5)]


def for_version(version: Optional[str]) -> Shim:
    """Shim for a `spark.version` string; None -> the 3.3 dialect the
    checked-in fixtures use. Unknown versions snap to the nearest known
    line at or below (a 3.6 plan decodes with 3.5 rules + fallback on
    anything genuinely new)."""
    if not version:
        return Shim((3, 3))
    try:
        parts = version.split(".")
        mm = (int(parts[0]), int(parts[1]))
    except (ValueError, IndexError):
        raise ShimError(f"unparseable Spark version: {version!r}")
    if mm < _KNOWN[0]:
        # Spark 2.x TreeNode JSON differs materially (no AQE shells,
        # different cast/limit encodings) — fail loudly, don't misdecode
        raise ShimError(f"Spark {version} is older than the supported "
                        "3.0+ lines")
    best = _KNOWN[0]
    for k in _KNOWN:
        if k <= mm:
            best = k
    return Shim(best)
