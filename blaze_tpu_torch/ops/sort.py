"""SortExec / TakeOrderedExec: sort-based pipeline breakers.

Port of blaze_tpu/ops/sort.py (ref: datafusion-ext-plans sort_exec.rs and
take_ordered_exec). In-memory batches are concatenated and sorted by the
stable multi-word key sort of ops/sort_keys.py; the fetch-limited path
folds a bounded top-k over the stream, so unbounded inputs never
materialize.

The JAX package's `sorted_batch_jit` is `sort_keys.sort_batch` here,
without its jit cache and compile-service shape rung: PyTorch runs
eagerly and compiles nothing per shape. The spill path of `ExternalSorter` (sorted runs in host
spill files, merged by ops/host_sort.py) needs columnar/serde.py and
raises until that slice; an in-memory sort over the memory budget raises
with it rather than carry on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from blaze_tpu_torch.columnar.batch import Column, ColumnBatch, bucket_capacity
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.metrics import to_host


def truncate(batch: ColumnBatch, limit: int) -> ColumnBatch:
    """Keep the first `limit` live rows (the batch must be front-compact),
    in a capacity of bucket_capacity(limit) where that is smaller."""
    cap = bucket_capacity(limit)
    n = batch.num_rows.clamp(max=limit)
    if cap >= batch.capacity:
        return batch.with_num_rows(n)
    cols = [Column(c.dtype, c.data[:cap],
                   None if c.validity is None else c.validity[:cap])
            for c in batch.columns]
    return ColumnBatch(batch.schema, cols, n, cap)


class ExternalSorter(M.MemConsumer):
    """Budgeted sort state (ref sort_exec.rs). The in-memory path sorts
    the concatenated batches once at finish; spilling sorted runs to the
    host waits for columnar/serde.py."""

    def __init__(self, schema: Schema, specs: Sequence[SortSpec],
                 manager: Optional[M.MemManager] = None,
                 name: str = "sort") -> None:
        self.schema = schema
        self.specs = list(specs)
        self.manager = manager or M.get_manager()
        self.name = name
        self.pending: List[ColumnBatch] = []
        self.pending_bytes = 0
        self.manager.register(self)

    def mem_used(self) -> int:
        return self.pending_bytes

    def spill(self) -> int:
        if not self.pending:
            return 0
        raise NotImplementedError(
            f"{self.name}: {self.pending_bytes} bytes of sort input exceed "
            f"the memory budget; {M.SPILL_MISSING}")

    def add(self, batch: ColumnBatch) -> None:
        with self.manager.op_lock:
            self.pending.append(batch)
            self.pending_bytes += M.batch_nbytes(batch)
            self.manager.update_mem_used(self)

    def finish(self):
        try:
            if self.pending:
                big = concat_batches(self.pending, self.schema)
                yield sort_batch(big, self.specs)
        finally:
            self.abort()

    def abort(self) -> None:
        """Idempotent cleanup (also the error path)."""
        self.manager.unregister(self)
        self.pending, self.pending_bytes = [], 0


class SortExec(Operator):
    """Full sort, or with `fetch` a bounded top-k."""

    def __init__(self, child: Operator, specs: Sequence[SortSpec],
                 fetch: Optional[int] = None) -> None:
        super().__init__([child])
        self.specs = list(specs)
        self.fetch = fetch

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def plan_key(self) -> tuple:
        return ("sort", tuple(s.key() for s in self.specs), self.fetch,
                self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            child = self.children[0]
            if self.fetch is not None:
                out = self._topk(child.execute(ctx), ctx)
                if out is not None:
                    yield out
                return
            sorter = ExternalSorter(self.schema, self.specs,
                                    M.get_manager(ctx))
            try:
                for batch in child.execute(ctx):
                    ctx.check_running()
                    if int(to_host(batch.num_rows)):
                        with self.metrics.timer():
                            sorter.add(batch)
                with self.metrics.timer():
                    yield from sorter.finish()
            finally:
                sorter.abort()

        return count_stream(self, gen())

    def _topk(self, stream: BatchStream, ctx: ExecContext
              ) -> Optional[ColumnBatch]:
        """Fold a bounded top-k over the stream (ref sort_exec.rs fetch)."""
        state: Optional[ColumnBatch] = None
        for batch in stream:
            ctx.check_running()
            with self.metrics.timer():
                part = truncate(sort_batch(batch, self.specs), self.fetch)
                if state is None:
                    state = part
                else:
                    both = concat_batches([state, part], self.schema)
                    state = truncate(sort_batch(both, self.specs),
                                     self.fetch)
        return state


class TakeOrderedExec(SortExec):
    """Ref: NativeTakeOrderedBase, limit and sort in one node."""

    def __init__(self, child: Operator, specs: Sequence[SortSpec],
                 limit: int) -> None:
        super().__init__(child, specs, fetch=limit)

    def plan_key(self) -> tuple:
        return ("take_ordered", tuple(s.key() for s in self.specs),
                self.fetch, self.children[0].plan_key())
