"""ExpandExec (grouping sets) and GenerateExec (explode).

Port of blaze_tpu/ops/expand.py (ref: datafusion-ext-plans expand_exec.rs,
the projection-list expansion, and generate/, explode and pos_explode of
list columns, generate/mod.rs:29-49). Expand evaluates each projection
list over the whole batch and emits one batch per list (row order within
a partition is not contractual). Generate is the join's gather
expansion: list lengths -> repeated row indices -> an element gather,
with one host pull for the output row count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, ListData, bucket_capacity, take_rows,
)
from blaze_tpu_torch.columnar.types import Field, Schema
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.basic import infer_dtype
from blaze_tpu_torch.runtime.metrics import to_host


class ExpandExec(Operator):
    """Each input row emits one row per projection list (grouping sets):
    one output batch per list and input batch."""

    def __init__(self, child: Operator,
                 projections: Sequence[Sequence[ir.Expr]],
                 schema: Schema) -> None:
        super().__init__([child])
        self.projections = [list(p) for p in projections]
        self._schema = schema
        self._fns = [[compile_expr(e, child.schema) for e in p]
                     for p in self.projections]

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("expand",
                tuple(tuple(e.key() for e in p) for p in self.projections),
                self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            for batch in self.children[0].execute(ctx):
                ctx.check_running()
                for fns in self._fns:
                    with self.metrics.timer():
                        out = batch.with_columns(
                            self._schema, [fn(batch) for fn in fns])
                    yield out

        return count_stream(self, gen())


class GenerateExec(Operator):
    """explode / pos_explode of a list column (ref generate/explode.rs).

    Output: the required input columns (repeated per element), then
    [pos], then the element column. `outer=True` keeps rows whose list is
    empty or null, with a null element (and a null pos), as Spark's
    GenerateExec outer does."""

    def __init__(self, child: Operator, child_expr: ir.Expr,
                 required_cols: Sequence[int], output_names: Sequence[str],
                 pos: bool = False, outer: bool = False) -> None:
        super().__init__([child])
        self.child_expr = child_expr
        self.required_cols = list(required_cols)
        self.output_names = list(output_names)
        self.pos = pos
        self.outer = outer
        self._list_fn = compile_expr(child_expr, child.schema)
        ldt = infer_dtype(self._list_fn, child.schema)
        if ldt.kind != T.TypeKind.LIST:
            raise NotImplementedError(
                f"generate over {ldt} (only list explode supported)")
        for i in self.required_cols:
            if child.schema.fields[i].dtype.kind == T.TypeKind.LIST:
                # refused as in the JAX package, whose fan-out gather
                # keeps the list's element capacity
                raise NotImplementedError(
                    "generate with list-typed required columns")
        fields = [child.schema.fields[i] for i in self.required_cols]
        if pos:
            # posexplode_outer emits a null pos for kept empty/null lists
            fields.append(Field(self.output_names[0], T.INT32,
                                nullable=outer))
        fields.append(Field(self.output_names[-1], ldt.element))
        self._schema = Schema(fields)

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("generate", self.child_expr.key(),
                tuple(self.required_cols), self.pos, self.outer,
                self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            for batch in self.children[0].execute(ctx):
                ctx.check_running()
                with self.metrics.timer():
                    out = self._explode(batch)
                if out is not None:
                    yield out

        return count_stream(self, gen())

    def _explode(self, batch: ColumnBatch) -> Optional[ColumnBatch]:
        lcol = self._list_fn(batch)
        ld: ListData = lcol.data
        cap, dev = batch.capacity, batch.device
        mask = batch.row_mask()
        zero = torch.zeros((cap,), dtype=torch.int64, device=dev)
        lens = torch.where(mask & lcol.valid_mask(),
                           ld.lengths().to(torch.int64), zero)
        eff = lens.clamp(min=1) if self.outer else lens
        eff = torch.where(mask, eff, zero)
        total = int(to_host(eff.sum()))  # the output row count
        if total == 0:
            return None
        out_cap = bucket_capacity(total)
        offs = torch.cat([zero[:1], torch.cumsum(eff, 0)])
        # row i repeated eff[i] times; a spare count of row `cap` fills the
        # capacity past the total, so output_size needs no second pull
        reps = torch.cat([eff, torch.full((1,), out_cap - total,
                                          dtype=torch.int64, device=dev)])
        row = torch.repeat_interleave(
            torch.arange(cap + 1, dtype=torch.int64, device=dev), reps,
            output_size=out_cap)
        slot = torch.arange(out_cap, dtype=torch.int64, device=dev)
        live = slot < total
        row = torch.where(live, row, torch.zeros_like(row))
        within = slot - offs[row]
        elem_ok = (within < lens[row]) & live
        src = ld.offsets[row].to(torch.int64) + within
        src = torch.where(elem_ok, src, torch.zeros_like(src))
        cols = [take_rows(batch.columns[i], row)
                for i in self.required_cols]
        if self.pos:
            cols.append(Column(
                T.INT32, torch.where(elem_ok, within, 0).to(torch.int32),
                elem_ok if self.outer else None))
        cols.append(ld.elements.take(src, index_valid=elem_ok))
        return ColumnBatch(self._schema, cols,
                           torch.tensor(total, dtype=torch.int32, device=dev),
                           out_cap)
