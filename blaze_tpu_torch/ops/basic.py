"""Map-like, source and stream operators.

Port of blaze_tpu/ops/basic.py (ref: datafusion-ext-plans project_exec.rs,
filter_exec.rs, rename_columns_exec.rs, limit_exec.rs,
empty_partitions_exec.rs, coalesce_stream.rs, debug_exec.rs):
MemorySource, Project, Filter, Rename, Local/GlobalLimit, Union,
EmptyPartitions, CoalesceBatches and Debug. Filter+Project fuse into one
per-batch function via the executor. The JAX module's host-function
expression operators wait for the slices that port their expressions.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence

import torch

from blaze_tpu_torch.columnar.batch import ColumnBatch, bucket_capacity
from blaze_tpu_torch.columnar.types import Field, Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, MapLikeOp, Operator, count_stream,
)
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.runtime.metrics import to_host

logger = logging.getLogger(__name__)


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


class LocalLimitExec(Operator):
    """Ref: limit_exec.rs LocalLimitExec — truncate the stream at k rows."""

    def __init__(self, child: Operator, limit: int) -> None:
        super().__init__([child])
        self.limit = limit

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def plan_key(self) -> tuple:
        return ("local_limit", self.limit, self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            remaining = self.limit
            for batch in self.children[0].execute(ctx):
                if remaining <= 0:
                    break
                n = int(to_host(batch.num_rows))
                if n <= remaining:
                    remaining -= n
                    yield batch
                else:
                    yield batch.with_num_rows(remaining)
                    remaining = 0

        return count_stream(self, gen())


class GlobalLimitExec(LocalLimitExec):
    """Ref: limit_exec.rs GlobalLimitExec (the plan guarantees one
    partition)."""

    def plan_key(self) -> tuple:
        return ("global_limit", self.limit, self.children[0].plan_key())


class UnionExec(Operator):
    """Ref: from_proto.rs :453 Union — the child streams one after
    another."""

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            for child in self.children:
                yield from child.execute(ctx)

        return count_stream(self, gen())


class EmptyPartitionsExec(Operator):
    """Ref: empty_partitions_exec.rs — schema only, zero rows."""

    def __init__(self, schema: Schema, num_partitions: int = 1) -> None:
        super().__init__([])
        self._schema = schema
        self.num_partitions = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("empty", tuple(self._schema.names()))

    def execute(self, ctx: ExecContext) -> BatchStream:
        return iter(())


class CoalesceBatchesExec(Operator):
    """Ref: streams/coalesce_stream.rs — re-chunk to the configured batch
    size: small batches are held and concatenated on the device."""

    def __init__(self, child: Operator,
                 batch_size: Optional[int] = None) -> None:
        super().__init__([child])
        self.batch_size = batch_size

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def plan_key(self) -> tuple:
        return ("coalesce", self.batch_size, self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        target = self.batch_size or ctx.batch_size or conf.batch_size

        def gen():
            pending: List[ColumnBatch] = []
            pending_rows = 0
            for batch in self.children[0].execute(ctx):
                n = int(to_host(batch.num_rows))
                if n == 0:
                    continue
                staged = False
                if n < target // 2 or pending:
                    pending.append(batch)
                    pending_rows += n
                    staged = True
                if pending_rows >= target:
                    yield concat_batches(pending, self.schema)
                    pending, pending_rows = [], 0
                if not staged:
                    yield batch
            if pending:
                yield concat_batches(pending, self.schema)

        return count_stream(self, gen())


class DebugExec(Operator):
    """Ref: debug_exec.rs — log batches flowing through a tagged point
    (one host read a batch, to print its rows)."""

    def __init__(self, child: Operator, tag: str = "") -> None:
        super().__init__([child])
        self.tag = tag

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            for i, batch in enumerate(self.children[0].execute(ctx)):
                logger.info("[DEBUG %s] batch %d: %d rows\n%s", self.tag, i,
                            int(to_host(batch.num_rows)), batch.to_numpy())
                yield batch

        return count_stream(self, gen())
