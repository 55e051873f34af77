"""SortExec / TakeOrderedExec: sort-based pipeline breakers.

Port of blaze_tpu/ops/sort.py (ref: datafusion-ext-plans sort_exec.rs and
take_ordered_exec). In-memory batches are concatenated and sorted by the
stable multi-word key sort of ops/sort_keys.py; the fetch-limited path
folds a bounded top-k over the stream, so unbounded inputs never
materialize. Over the memory budget, `ExternalSorter` spills sorted runs to
host files (runtime/memory.SpillFile) and merges them on the host
(ops/host_sort.merge_sorted_host); runs holding list columns merge on the
device (`_merge_runs_device`), as in the JAX package.

The JAX package's `sorted_batch_jit` is `sorted_batch` here: a
`sort_keys.sort_batch` without its jit cache and without padding to a
compile-service shape rung (PyTorch runs eagerly and compiles nothing per
shape); the shape and its rung are still noted in the compile service.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, ListData, StringData, StructData, bucket_capacity,
)
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.ops.sort_keys import SortSpec, batch_sort_keys, sort_batch
from blaze_tpu_torch.runtime import compile_service
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.metrics import to_host


def sorted_batch(batch: ColumnBatch, specs: Sequence[SortSpec]
                 ) -> ColumnBatch:
    """`sort_batch`, with the batch's shape noted in the compile service
    where the JAX package's sorted_batch_jit notes it: the canonical rung
    (nothing is padded) and a replay payload for the warm driver."""
    compile_service.canonical_batch(batch, "sort_kernel")
    compile_service.record_sort_shape(
        ("sort_kernel", tuple(s.key() for s in specs), batch.shape_key()),
        batch, specs)
    return sort_batch(batch, specs)


def truncate(batch: ColumnBatch, limit: int) -> ColumnBatch:
    """Keep the first `limit` live rows (the batch must be front-compact),
    in a capacity of bucket_capacity(limit) where that is smaller."""
    cap = bucket_capacity(limit)
    n = batch.num_rows.clamp(max=limit)
    if cap >= batch.capacity:
        return batch.with_num_rows(n)
    return ColumnBatch(batch.schema, [_head_rows(c, cap)
                                      for c in batch.columns], n, cap)


def _head_rows(c: Column, cap: int) -> Column:
    """The first `cap` rows of a column: a dictionary column comes out
    expanded and a list keeps its element storage, as in the JAX
    package."""
    v = None if c.validity is None else c.validity[:cap]
    if c.is_list:
        data = ListData(c.data.offsets[:cap + 1], c.data.elements)
    elif c.is_struct:
        data = StructData([_head_rows(ch, cap) for ch in c.data.children])
    elif c.is_string:
        data = StringData(c.data.bytes[:cap], c.data.lengths[:cap])
    else:
        data = c.data[:cap]
    return Column(c.dtype, data, v)


class ExternalSorter(M.MemConsumer):
    """Budgeted sort state (ref sort_exec.rs: in-memory batches, spilled
    sorted runs, and a LoserTree merge over the spill cursors,
    :307-475). A run is a SpillFile of sorted frames; `finish` merges the
    runs on the host and uploads each merged macro-batch once."""

    def __init__(self, schema: Schema, specs: Sequence[SortSpec],
                 manager: Optional[M.MemManager] = None,
                 name: str = "sort") -> None:
        self.schema = schema
        self.specs = list(specs)
        self.manager = manager or M.get_manager()
        self.name = name
        self.pending: List[ColumnBatch] = []
        self.pending_bytes = 0
        self.runs: List[M.SpillFile] = []
        # where the input lives; merged runs go back there
        self.device = None
        # counters survive abort(): metrics read them after cleanup
        self.spill_count = 0
        self.spilled_bytes = 0
        # host time of the run merge and its uploads, the consumer's time
        # between merged batches left out
        self.merge_ns = 0
        self.manager.register(self)

    def mem_used(self) -> int:
        return self.pending_bytes

    def spill(self) -> int:
        """Sort the pending batches into one run and write it to a spill
        file in frames of conf.spill_frame_rows, clamped so that the
        merge's one head frame per run (plus pool and carry, which the
        budget does not see) stays inside the budget class that forced
        the spill: frames of about budget / 8."""
        if not self.pending:
            return 0
        freed = self.pending_bytes
        big = concat_batches(self.pending, self.schema)
        row_bytes = max(M.batch_nbytes(big) // max(big.capacity, 1), 1)
        budget_rows = max(self.manager.total // (8 * row_bytes), 1024)
        frame = int(min(int(conf.spill_frame_rows), budget_rows))
        # one pull of the sorted run, cut into frames on the host
        hb = serde.to_host(sorted_batch(big, self.specs))
        run = M.SpillFile(self.schema, manager=self.manager)
        self.runs.append(run)
        for lo in range(0, hb.num_rows, frame):
            run.write_host(hb, lo, min(lo + frame, hb.num_rows))
        self.spill_count += 1
        self.spilled_bytes += run.bytes_written
        self.pending, self.pending_bytes = [], 0
        return freed

    def add(self, batch: ColumnBatch) -> None:
        # op_lock: a host-driven release() must not run spill() between
        # the append and the accounting update
        with self.manager.op_lock:
            self.device = batch.device
            self.pending.append(batch)
            self.pending_bytes += M.batch_nbytes(batch)
            self.manager.update_mem_used(self)

    def finish(self):
        try:
            if not self.runs:
                if self.pending:
                    big = concat_batches(self.pending, self.schema)
                    yield sorted_batch(big, self.specs)
                return
            if self.pending:
                self.spill()
            yield from self._merge_runs()
        finally:
            self.abort()

    def _merge_runs(self):
        """k-way merge of the spilled runs on the host: the runs are host
        files, so their frames are merged with numpy memcmp keys and each
        merged macro-batch, sized inside the budget class that forced the
        spill, is uploaded once. Schemas with list columns, whose rows the
        host merge does not slice, merge on the device
        (`_merge_runs_device`), as in the JAX package."""
        from blaze_tpu_torch.ops import host_sort

        if not host_sort.host_supported(self.schema):
            yield from self._merge_runs_device()
            return
        t0 = time.perf_counter_ns()
        emit = int(max(self.manager.total // 4, 1 << 20))
        iters = [r.read_host() for r in self.runs]
        for hb in host_sort.merge_sorted_host(iters, self.specs, emit):
            b = host_sort.host_to_device(hb, device=self.device)
            self.merge_ns += time.perf_counter_ns() - t0
            yield b
            t0 = time.perf_counter_ns()
        self.merge_ns += time.perf_counter_ns() - t0

    def _head_key(self, batch: ColumnBatch) -> tuple:
        """The sort key words of a batch's first row, as Python ints (one
        host pull)."""
        keys = batch_sort_keys(batch, self.specs)
        return tuple(to_host(torch.stack([k[0].to(torch.int64)
                                          for k in keys])).tolist())

    def _split_leq(self, pool: ColumnBatch, bound: tuple):
        """(rows whose key is <= bound, the rest), each compacted."""
        keys = batch_sort_keys(pool, self.specs)
        le = torch.zeros((pool.capacity,), dtype=torch.bool,
                         device=pool.device)
        eq = torch.ones_like(le)
        for word, b in zip(keys, bound):
            le = le | (eq & (word < b))
            eq = eq & (word == b)
        mask = le | eq
        return pool.compact(mask), pool.compact(~mask)

    def _merge_runs_device(self):
        """The JAX package's device merge: a pool of the carried rows and
        the run whose head key is least is sorted, and every row up to
        the least head key among the other runs' next batches (and that
        run's own next) is emitted; the rest carries. Each pulled batch's
        head key is read once (one pull), and each round pulls the pool's
        row count."""
        t0 = time.perf_counter_ns()
        streams = [iter(r.read(device=self.device)) for r in self.runs]

        def pull(i):
            b = next(streams[i], None)
            return None if b is None else (b, self._head_key(b))

        current = [pull(i) for i in range(len(streams))]
        carry: Optional[ColumnBatch] = None
        while True:
            active = [i for i, c in enumerate(current) if c is not None]
            if not active:
                if carry is not None and _rows(carry):
                    self.merge_ns += time.perf_counter_ns() - t0
                    yield carry
                break
            i_min = min(active, key=lambda i: current[i][1])
            parts = ([carry] if carry is not None and _rows(carry)
                     else [])
            parts.append(current[i_min][0])
            pool = sorted_batch(parts[0] if len(parts) == 1 else
                                concat_batches(parts, self.schema),
                                self.specs)
            current[i_min] = pull(i_min)
            bounds = [current[i][1] for i in active
                      if current[i] is not None]
            if not bounds:
                emit, carry = pool, None
            else:
                emit, carry = self._split_leq(pool, min(bounds))
            if _rows(emit):
                self.merge_ns += time.perf_counter_ns() - t0
                yield emit
                t0 = time.perf_counter_ns()
        self.merge_ns += time.perf_counter_ns() - t0

    def abort(self) -> None:
        """Idempotent cleanup, also the error path. Closing the runs never
        masks the error being unwound (close_all_quietly)."""
        self.manager.unregister(self)
        self.pending, self.pending_bytes = [], 0
        runs, self.runs = self.runs, []
        M.close_all_quietly(runs, "sort spill run")


def _rows(batch: ColumnBatch) -> int:
    return int(to_host(batch.num_rows))


class SortExec(Operator):
    """Full sort, external when the memory budget forces spilling, or with
    `fetch` a bounded top-k."""

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
                # counters, not the runs list: abort() empties the list
                self.metrics.add("spill_count", sorter.spill_count)
                self.metrics.add("spilled_bytes", sorter.spilled_bytes)
                self.metrics.add("spill_merge_ns", sorter.merge_ns)
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
                part = truncate(sorted_batch(batch, self.specs), self.fetch)
                if state is None:
                    state = part
                else:
                    both = concat_batches([state, part], self.schema)
                    state = truncate(sorted_batch(both, self.specs),
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
