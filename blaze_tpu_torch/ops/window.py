"""WindowExec: ranking and aggregate window functions over sorted
partitions.

Port of blaze_tpu/ops/window.py (ref: datafusion-ext-plans window_exec.rs
and window/: the RowNumber, Rank and DenseRank processors and aggregates
over a window, window/mod.rs:43-51; partition boundaries over sorted
input, window_context.rs:24). Rows are sorted by (partition_by, order_by)
through the `ExternalSorter`, which spills under the memory budget;
partition and peer-group boundaries are neighbour-equality flags, and
every window value is a segmented scan (ops/segment.py):

  row_number : position within the partition
  rank       : position of the peer group's first row, plus one
  dense_rank : running count of peer-group starts within the partition
  count, sum, avg, min, max : the running aggregate, leveled to the peer
               group's last row (Spark's default RANGE UNBOUNDED
               PRECEDING .. CURRENT ROW); without ORDER BY the whole
               partition shares one value

Integer running sums and counts are `segmented_cumsum` (exact, wrapping
int64); float sums, min and max go through `segmented_scan`, whose f64
sums add in another order than the JAX package's scan tree; a row that
adds nothing to a float sum keeps the previous row's value bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import Column, ColumnBatch
from blaze_tpu_torch.columnar.types import DataType, Field, Schema
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr, cse_scope
from blaze_tpu_torch.ops import segment as seg
from blaze_tpu_torch.ops.agg import _sum_state_dtype
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.basic import infer_dtype
from blaze_tpu_torch.ops.common import concat_batches, slice_batch
from blaze_tpu_torch.ops.sort import ExternalSorter
from blaze_tpu_torch.ops.sort_keys import SortSpec
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.metrics import to_host


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One window expression (ref pb.WindowExprNode)."""
    fn: str                       # row_number | rank | dense_rank | <agg fn>
    inputs: Tuple[ir.Expr, ...]   # aggregate window functions only
    dtype: DataType
    name: str

    def key(self) -> tuple:
        return (self.fn, tuple(e.key() for e in self.inputs),
                repr(self.dtype), self.name)

    @property
    def is_rank_like(self) -> bool:
        return self.fn in ("row_number", "rank", "dense_rank")


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def _carry_over_zeros(run: torch.Tensor, starts: torch.Tensor,
                      adds: torch.Tensor) -> torch.Tensor:
    """A float running sum where each row that adds nothing (null or 0)
    takes the previous row's value bit for bit, as a sequential sum does:
    the doubling scan sums every row's prefix in its own association, so
    two rows of one running total could otherwise differ in the last bit
    and no longer tie (an ORDER BY over the running sum would then order
    them apart)."""
    return run[seg.last_marked(adds | starts)]


class WindowExec(Operator):
    def __init__(self, child: Operator, calls: Sequence[WindowCall],
                 partition_exprs: Sequence[ir.Expr],
                 order_specs: Sequence[SortSpec]) -> None:
        super().__init__([child])
        self.calls = list(calls)
        self.partition_exprs = list(partition_exprs)
        self.order_specs = list(order_specs)
        child_schema = child.schema
        self._part_fns = [compile_expr(e, child_schema)
                          for e in self.partition_exprs]
        self._input_fns = [[compile_expr(e, child_schema)
                            for e in c.inputs] for c in self.calls]
        out = list(child_schema.fields)
        for c in self.calls:
            if c.is_rank_like:
                out.append(Field(c.name, T.INT32, nullable=False))
            elif c.fn == "count":
                out.append(Field(c.name, T.INT64, nullable=False))
            elif c.fn == "sum":
                out.append(Field(c.name, _sum_state_dtype(c.dtype)))
            elif c.fn == "avg":
                out.append(Field(c.name, T.FLOAT64))
            else:
                out.append(Field(c.name, c.dtype))
        self._schema = Schema(out)
        # the work layout: the child's columns, then each partition key,
        # then each call's inputs
        fields = list(child_schema.fields)
        self._part_idx = []
        for i, fn in enumerate(self._part_fns):
            self._part_idx.append(len(fields))
            fields.append(Field(f"#part{i}", infer_dtype(fn, child_schema)))
        self._in_idx: List[List[int]] = []
        for c, fns in zip(self.calls, self._input_fns):
            row = []
            for j, fn in enumerate(fns):
                row.append(len(fields))
                fields.append(Field(f"#in{c.name}{j}",
                                    infer_dtype(fn, child_schema)))
            self._in_idx.append(row)
        self._work_schema = Schema(fields)
        self._nin = len(child_schema.fields)

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("window", tuple(c.key() for c in self.calls),
                tuple(e.key() for e in self.partition_exprs),
                tuple(s.key() for s in self.order_specs),
                self.children[0].plan_key())

    def _make_work(self, b: ColumnBatch) -> ColumnBatch:
        with cse_scope():
            cols = list(b.columns)
            cols += [fn(b) for fn in self._part_fns]
            cols += [fn(b) for fns in self._input_fns for fn in fns]
        return b.with_columns(self._work_schema, cols)

    def execute(self, ctx: ExecContext) -> BatchStream:
        """Partition-bounded streaming (ref window_context.rs:24): the
        input is sorted by (partition, order) through the ExternalSorter,
        spilling under the MemManager's budget like any sort; then the
        complete partitions of each merged chunk are computed and emitted,
        and only the open partition's rows carry into the next chunk (one
        host pull a chunk finds where it starts). Peak state is one sort
        pool and the largest single partition."""
        def gen():
            specs = [SortSpec(i) for i in self._part_idx] + list(
                self.order_specs)
            sorter = ExternalSorter(self._work_schema, specs,
                                    M.get_manager(ctx), name="window")
            try:
                for b in self.children[0].execute(ctx):
                    ctx.check_running()
                    if int(to_host(b.num_rows)) == 0:
                        continue
                    sorter.add(self._make_work(b))
                yield from self._emit(sorter, ctx)
                self.metrics.add("spill_count", sorter.spill_count)
            finally:
                sorter.abort()

        return count_stream(self, gen())

    def _emit(self, sorter: ExternalSorter, ctx: ExecContext):
        if not self._part_idx:
            # the global window: one partition spans everything, so the
            # sorted chunks concatenate once
            chunks = [sb for sb in sorter.finish()
                      if int(to_host(sb.num_rows))]
            if chunks:
                yield self._compute(chunks[0] if len(chunks) == 1 else
                                    concat_batches(chunks,
                                                   self._work_schema))
            return
        carry: Optional[ColumnBatch] = None
        for sb in sorter.finish():
            ctx.check_running()
            chunk = (sb if carry is None
                     else concat_batches([carry, sb], self._work_schema))
            n = int(to_host(chunk.num_rows))
            split = self._last_partition_start(chunk)
            if split <= 0:
                carry = chunk
                continue
            carry = slice_batch(chunk, split, n - split)
            yield self._compute(slice_batch(chunk, 0, split))
        if carry is not None and int(to_host(carry.num_rows)):
            yield self._compute(carry)

    def _last_partition_start(self, chunk: ColumnBatch) -> int:
        """Row where the chunk's last (possibly open) partition begins."""
        starts = seg.group_starts(chunk, self._part_idx)
        iota = torch.arange(chunk.capacity, device=chunk.device)
        return int(to_host(torch.where(starts, iota, -1).max()))

    def _compute(self, sb: ColumnBatch) -> ColumnBatch:
        """The window values of a sorted batch of whole partitions."""
        with self.metrics.timer():
            mask = sb.row_mask()
            cap = sb.capacity
            iota = torch.arange(cap, dtype=torch.int64, device=sb.device)
            part = seg.group_layout(sb, self._part_idx)
            peer = seg.group_layout(sb, self._part_idx + [
                s.col for s in self.order_specs])
            part_start = part.start_idx[part.gid.clamp(0, cap - 1)]
            peer_gid = peer.gid.clamp(0, cap - 1)
            # RANGE frame: a running value leveled to the peer group's
            # last row; no ORDER BY: to the partition's last row
            level = (peer.end_idx[peer_gid] if self.order_specs
                     else part.end_idx[part.gid.clamp(0, cap - 1)])
            zero = torch.zeros((cap,), dtype=torch.int32, device=sb.device)
            out = list(sb.columns[:self._nin])
            for call, idxs in zip(self.calls, self._in_idx):
                if call.fn == "row_number":
                    v = (iota - part_start + 1).to(torch.int32)
                elif call.fn == "rank":
                    v = (peer.start_idx[peer_gid] - part_start + 1).to(
                        torch.int32)
                elif call.fn == "dense_rank":
                    v = seg.segmented_cumsum(peer.starts.to(torch.int32),
                                             part.starts)
                else:
                    out.append(self._agg(call, sb.columns[idxs[0]],
                                         part.starts, level, mask))
                    continue
                out.append(Column(T.INT32, torch.where(mask, v, zero), None))
            return ColumnBatch(self._schema, out, sb.num_rows, cap)

    @staticmethod
    def _agg(call: WindowCall, x: Column, starts: torch.Tensor,
             level: torch.Tensor, mask: torch.Tensor) -> Column:
        valid = x.valid_mask() & mask
        cnt = seg.segmented_cumsum(valid.to(torch.int64), starts)
        fn = call.fn
        if fn == "count":
            return Column(T.INT64, cnt[level], None)
        if fn in ("sum", "avg"):
            sd = _sum_state_dtype(call.dtype) if fn == "sum" else T.FLOAT64
            data = x.data.to(sd.torch_dtype())
            v = torch.where(valid, data, torch.zeros_like(data))
            if v.dtype.is_floating_point:
                run = _carry_over_zeros(seg.segmented_scan(v, starts, _add),
                                        starts, v != 0)
            else:
                run = seg.segmented_cumsum(v, starts)
            if fn == "avg":
                run = run / cnt.clamp(min=1).to(torch.float64)
            dtype = sd
        elif fn in ("min", "max"):
            d = x.data
            fl = d.dtype.is_floating_point
            if fn == "min":
                ident = float("inf") if fl else torch.iinfo(d.dtype).max
                op = torch.fmin if fl else torch.minimum
            else:
                ident = float("-inf") if fl else torch.iinfo(d.dtype).min
                op = torch.maximum
            run = seg.segmented_scan(
                torch.where(valid, d, torch.full_like(d, ident)), starts, op)
            if fn == "min" and fl:
                # fmin skipped NaN: a frame whose values are all NaN is
                # NaN, Spark's "NaN greatest" (as segment.seg_min)
                nonnan = seg.segmented_cumsum(
                    (valid & ~torch.isnan(d)).to(torch.int64), starts)
                run = torch.where((cnt > 0) & (nonnan == 0),
                                  torch.full_like(run, float("nan")), run)
            dtype = call.dtype
        else:
            raise NotImplementedError(f"window agg {fn}")
        return Column(dtype, run[level], cnt[level] > 0)
