"""AggExec — grouped aggregation: calls, modes, state layout, schema.

Port of the construction half of blaze_tpu/ops/agg.py (ref:
datafusion-ext-plans agg_exec.rs + agg/): `AggMode`, `AggCall`, the typed
state layout (`state_fields`), result fields, and `AggExec`'s schema and
compiled group/input expressions. The whole-stage dense path
(runtime/stage_compiler.py) executes matching partial(+final) pairs.

The general sort-based streaming `AggExec.execute` (with ops/segment.py,
ops/sort*.py and ops/common.py) is not ported yet: executing an AggExec
outside the whole-stage path raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence, Tuple

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.types import DataType, Field, Schema, TypeKind
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.ops.base import BatchStream, ExecContext, Operator
from blaze_tpu_torch.ops.basic import infer_dtype

AGG_BUF_PREFIX = "#9223372036854775807"  # ref agg/mod.rs:38

STREAMING_AGG_MISSING = (
    "general sort-based aggregation (ops/agg.py streaming path) not yet "
    "ported")


class AggMode(enum.Enum):
    PARTIAL = "partial"
    PARTIAL_MERGE = "partial_merge"
    FINAL = "final"


@dataclasses.dataclass(frozen=True)
class AggCall:
    """One aggregate expression (ref pb.AggFunction, blaze.proto:123-133)."""
    fn: str  # sum|avg|count|min|max|first|first_ignores_null
    inputs: Tuple[ir.Expr, ...]
    dtype: DataType          # Spark result dtype (planner-provided)
    name: str

    def key(self) -> tuple:
        return (self.fn, tuple(e.key() for e in self.inputs),
                repr(self.dtype), self.name)


def _sum_state_dtype(d: DataType) -> DataType:
    # Spark sum: int family -> long, float family -> double, decimal widens
    if d.kind == TypeKind.DECIMAL:
        return d
    if d.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        return T.FLOAT64
    return T.INT64


def collect_state_dtype(call: AggCall) -> DataType:
    """List dtype of a collect_list/collect_set state/result column."""
    return (call.dtype if call.dtype.kind == TypeKind.LIST
            else T.list_of(call.dtype))


def state_fields(call: AggCall, i: int) -> List[Field]:
    """Typed state columns for one agg (named with the agg-buf convention)."""
    p = f"{AGG_BUF_PREFIX}.{i}"
    if call.fn == "sum":
        sd = _sum_state_dtype(call.dtype)
        return [Field(f"{p}.sum", sd), Field(f"{p}.nonempty", T.BOOLEAN)]
    if call.fn == "avg":
        sd = call.dtype if call.dtype.kind == TypeKind.DECIMAL else T.FLOAT64
        return [Field(f"{p}.sum", sd), Field(f"{p}.count", T.INT64)]
    if call.fn == "count":
        return [Field(f"{p}.count", T.INT64)]
    if call.fn in ("min", "max"):
        return [Field(f"{p}.val", call.dtype), Field(f"{p}.has", T.BOOLEAN)]
    if call.fn == "first":
        return [Field(f"{p}.val", call.dtype), Field(f"{p}.valid", T.BOOLEAN),
                Field(f"{p}.has", T.BOOLEAN)]
    if call.fn == "first_ignores_null":
        return [Field(f"{p}.val", call.dtype), Field(f"{p}.has", T.BOOLEAN)]
    if call.fn in ("collect_list", "collect_set"):
        return [Field(f"{p}.list", collect_state_dtype(call))]
    raise NotImplementedError(f"agg function {call.fn}")


def result_field(call: AggCall) -> Field:
    if call.fn == "count":
        return Field(call.name, T.INT64, nullable=False)
    if call.fn == "avg" and call.dtype.kind != TypeKind.DECIMAL:
        return Field(call.name, T.FLOAT64)
    if call.fn == "sum":
        return Field(call.name, _sum_state_dtype(call.dtype))
    return Field(call.name, call.dtype)


class AggExec(Operator):
    def __init__(self, child: Operator, group_exprs: Sequence[ir.Expr],
                 group_names: Sequence[str], aggs: Sequence[AggCall],
                 mode: AggMode) -> None:
        super().__init__([child])
        self.group_exprs = list(group_exprs)
        self.group_names = list(group_names)
        self.aggs = list(aggs)
        self.mode = mode
        self._build_schema()

    # ---- schema plumbing ----
    def _build_schema(self) -> None:
        child_schema = self.children[0].schema
        if self.mode == AggMode.PARTIAL:
            self._group_fns = [compile_expr(e, child_schema)
                               for e in self.group_exprs]
            self._input_fns = [[compile_expr(e, child_schema)
                                for e in call.inputs] for call in self.aggs]
            self._work_jit = not any(
                ir.contains_host_fn(e) for e in list(self.group_exprs) +
                [x for call in self.aggs for x in call.inputs])
            group_fields = [Field(n, infer_dtype(fn, child_schema))
                            for n, fn in zip(self.group_names,
                                             self._group_fns)]
        else:
            # input is group cols + state cols by position
            group_fields = [Field(n, child_schema.fields[i].dtype)
                            for i, n in enumerate(self.group_names)]
        state: List[Field] = []
        for i, call in enumerate(self.aggs):
            state.extend(state_fields(call, i))
        self._group_fields = group_fields
        self._state_fields = state
        if self.mode == AggMode.FINAL:
            out = group_fields + [result_field(c) for c in self.aggs]
        else:
            out = group_fields + state
        self._schema = Schema(out)
        self._state_schema = Schema(group_fields + state)

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("agg", self.mode.value,
                tuple(e.key() for e in self.group_exprs),
                tuple(c.key() for c in self.aggs),
                self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        raise NotImplementedError(STREAMING_AGG_MISSING)
