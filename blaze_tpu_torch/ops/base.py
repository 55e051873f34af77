"""Operator protocol + execution context.

Port of blaze_tpu/ops/base.py. Operators yield batches; consecutive
map-like operators (filter/project/rename) expose a `batch_fn` that the
executor composes into one per-batch function
(runtime/executor.execute_fused), run eagerly on the batch's device.
Every operator's output stream passes `count_stream`, the batch boundary
where the `op.<Kind>` fault point fires and where the trace, the history
store's row tap and live progress see the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional

import torch

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.device import DeviceLike
from blaze_tpu_torch.runtime.metrics import MetricsSet, to_host

BatchStream = Iterator[ColumnBatch]


@dataclasses.dataclass
class ExecContext:
    """Per-task context (ref: TaskContext + SessionContext in exec.rs)."""

    partition: int = 0
    num_partitions: int = 1
    batch_size: Optional[int] = None
    # task-kill cooperation: check_running() at batch boundaries
    is_running: Callable[[], bool] = lambda: True
    # where results made without an input batch go (an empty collect, a
    # global aggregate over no rows): None is the CUDA card
    device: DeviceLike = None
    # memory manager of the task's consumers; None is the process-wide one
    mem_manager: object = None
    # first-commit-wins gate shared by an attempt and its speculative
    # twin (runtime/supervisor.CommitGate); the shuffle writer claims it
    # before publishing, so racing attempts never double-commit. None:
    # uncontended
    commit_gate: Optional[object] = None

    def check_running(self) -> None:
        if not self.is_running():
            raise TaskKilledError("task killed")


class TaskKilledError(RuntimeError):
    pass


class SpeculationLostError(TaskKilledError):
    """This attempt lost the first-commit-wins race to its speculative
    twin: classified "killed", never retried, never counted as an engine
    error (the winner already produced the task's output)."""


class Operator:
    """Base physical operator."""

    def __init__(self, children: List["Operator"]) -> None:
        self.children = children
        self.metrics = MetricsSet()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> BatchStream:
        raise NotImplementedError

    # plan-structure key (must be stable across tasks)
    def plan_key(self) -> tuple:
        return (type(self).__name__,) + tuple(c.plan_key()
                                              for c in self.children)

    def name(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.name() + "\n"
        return s + "".join(c.tree_string(indent + 1) for c in self.children)


class MapLikeOp(Operator):
    """Operator expressible as a pure per-batch transform — fusable.

    Subclasses implement `make_batch_fn()` returning
    `fn(ColumnBatch) -> ColumnBatch`; the executor fuses chains of these.
    """

    def __init__(self, child: Operator) -> None:
        super().__init__([child])

    @property
    def child(self) -> Operator:
        return self.children[0]

    def make_batch_fn(self) -> Callable[[ColumnBatch], ColumnBatch]:
        raise NotImplementedError

    def jit_safe(self) -> bool:
        """False when the batch fn crosses to the host (digests/JSON/UDF);
        such chains cannot ride the whole-stage path."""
        return True

    def execute(self, ctx: ExecContext) -> BatchStream:
        from blaze_tpu_torch.runtime.executor import execute_fused

        return execute_fused(self, ctx)


def count_stream(op: Operator, stream: BatchStream) -> BatchStream:
    """Wrap a stream updating the operator's baseline metrics.

    The batch boundary is also where the `op.<Kind>` fault point fires
    (runtime/faults.py) and where three taps see the batch's rows: the
    trace (conf.trace_enabled, runtime/trace.on_batch), the history
    store's per-operator row tap (conf.history_dir,
    runtime/history.observe_rows) and live progress
    (conf.progress_enabled, runtime/progress.on_batch); off, each costs
    one truthiness check. With conf.enable_input_batch_statistics (the
    reference's batch_statisitcs module) every batch also records its
    device bytes (`stat_bytes`, from capacities and dtypes, no pull) and
    the largest batch's rows (`stat_max_batch_rows`): each operator's
    output stream is its parent's input stream, so one output-side hook
    covers the plan. With the taps and statistics off the row count stays
    a device tensor until someone reads the metric, so the stream never
    waits on the card; with any on, each batch's count is read once and
    shared."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import faults, trace

    stats = conf.enable_input_batch_statistics
    if stats:
        from blaze_tpu_torch.runtime.memory import batch_nbytes
    if conf.history_dir:
        from blaze_tpu_torch.runtime import history
    else:
        history = None
    if conf.progress_enabled:
        from blaze_tpu_torch.runtime import progress
    else:
        progress = None
    fault_point = "op." + op.name()
    rows, counted = [], 0
    try:
        for batch in stream:
            if conf.fault_injection_spec:
                faults.inject(fault_point)
            if conf.trace_enabled or history is not None \
                    or progress is not None or stats:
                n = int(to_host(batch.num_rows))  # one pull, every tap
                if conf.trace_enabled:
                    trace.on_batch(op, n)
                if history is not None:
                    history.observe_rows(op, n)
                if progress is not None:
                    progress.on_batch(op, n)
                if stats:
                    op.metrics.add("stat_bytes", batch_nbytes(batch))
                    op.metrics.set_max("stat_max_batch_rows", n)
                counted += n
            else:
                rows.append(batch.num_rows)
            op.metrics.add("output_batches", 1)
            yield batch
    finally:
        if rows:
            counted += int(to_host(torch.stack(rows).sum()))  # one pull
        op.metrics.add("output_rows", counted)
        # deterministic teardown: when the consumer abandons the stream
        # (kill, speculation loss, downstream error) a pipelined source
        # (runtime/pipeline.PrefetchStream) must quiesce its producer and
        # release its reservations now, not at GC time
        close = getattr(stream, "close", None)
        if close is not None:
            close()
