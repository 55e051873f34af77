"""Map-like and source operators: MemorySource, Project, Filter, Rename.

Port of the main-path subset of blaze_tpu/ops/basic.py (ref:
datafusion-ext-plans project_exec.rs / filter_exec.rs /
rename_columns_exec.rs). Filter+Project fuse into one per-batch function
via the executor.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from blaze_tpu_torch.columnar.batch import ColumnBatch, bucket_capacity
from blaze_tpu_torch.columnar.types import Field, Schema
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, MapLikeOp, Operator, count_stream,
)


def infer_dtype(fn, schema: Schema):
    """Result DataType of a compiled expression, found by running it on an
    empty batch on the `meta` device (shapes and dtypes only, no data)."""
    probe = ColumnBatch.empty(schema, capacity=bucket_capacity(0),
                              device="meta")
    return fn(probe).dtype


class MemorySourceExec(Operator):
    """Source from pre-built batches (ref: DataFusion MemoryExec)."""

    def __init__(self, batches: List[ColumnBatch],
                 schema: Optional[Schema] = None) -> None:
        super().__init__([])
        self._batches = batches
        self._schema = schema or batches[0].schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("mem", tuple(self._schema.names()))

    def execute(self, ctx: ExecContext) -> BatchStream:
        return count_stream(self, iter(self._batches))


class ProjectExec(MapLikeOp):
    """Ref: project_exec.rs."""

    def __init__(self, child: Operator, exprs: Sequence[ir.Expr],
                 names: Sequence[str], dtypes=None) -> None:
        super().__init__(child)
        self.exprs = list(exprs)
        self.names = list(names)
        self._fns = [compile_expr(e, child.schema) for e in self.exprs]
        if dtypes is None:
            dtypes = [infer_dtype(fn, child.schema) for fn in self._fns]
        self._schema = Schema([Field(n, d)
                               for n, d in zip(self.names, dtypes)])

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("project", tuple(e.key() for e in self.exprs),
                tuple(self.names), self.child.plan_key())

    def jit_safe(self) -> bool:
        return not any(ir.contains_host_fn(e) for e in self.exprs)

    def make_batch_fn(self) -> Callable[[ColumnBatch], ColumnBatch]:
        fns, schema = self._fns, self._schema

        def run(batch: ColumnBatch) -> ColumnBatch:
            return batch.with_columns(schema, [fn(batch) for fn in fns])

        return run


class FilterExec(MapLikeOp):
    """Ref: filter_exec.rs. Predicate -> mask -> compaction."""

    def __init__(self, child: Operator, predicates: Sequence[ir.Expr]) -> None:
        super().__init__(child)
        self.predicates = list(predicates)
        self._fns = [compile_expr(p, child.schema) for p in self.predicates]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def plan_key(self) -> tuple:
        return ("filter", tuple(p.key() for p in self.predicates),
                self.child.plan_key())

    def jit_safe(self) -> bool:
        return not any(ir.contains_host_fn(p) for p in self.predicates)

    def make_batch_fn(self) -> Callable[[ColumnBatch], ColumnBatch]:
        fns = self._fns

        def run(batch: ColumnBatch) -> ColumnBatch:
            keep = None
            for fn in fns:
                c = fn(batch)
                m = c.data.to(torch.bool) & c.valid_mask()
                keep = m if keep is None else (keep & m)
            return batch.compact(keep)

        return run


class RenameColumnsExec(MapLikeOp):
    """Ref: rename_columns_exec.rs (the `#<exprId>` naming normalizer)."""

    def __init__(self, child: Operator, names: Sequence[str]) -> None:
        super().__init__(child)
        self.names = list(names)
        self._schema = Schema([Field(n, f.dtype, f.nullable)
                               for n, f in zip(self.names, child.schema)])

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("rename", tuple(self.names), self.child.plan_key())

    def make_batch_fn(self):
        schema = self._schema

        def run(batch: ColumnBatch) -> ColumnBatch:
            return batch.with_columns(schema, batch.columns)

        return run
