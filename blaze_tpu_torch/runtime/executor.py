"""Per-task execution: pipeline fusion, collect, and the fetch entry.

Port of the collect subset of blaze_tpu/runtime/executor.py, and of
`execute_stage_or_plan`, the entry of the shuffle writers. Maximal
chains of map-like operators run as one composed per-batch function,
eagerly on the batch's device (PyTorch has no compiled-program cache to
keep small, so there is no jit cache here). `collect` first tries the
whole-stage path of runtime/stage_compiler.py (the dense grouped
aggregation, the agg-less chain stage); anything else streams, and a
stream of several batches concatenates into one (ops/common.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, MapLikeOp, Operator, count_stream,
)
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.runtime.metrics import to_host


def _fused_chain(op: MapLikeOp) -> tuple:
    """Longest chain of MapLikeOps ending at `op` (top-down order)."""
    chain = [op]
    while isinstance(chain[-1].child, MapLikeOp):
        chain.append(chain[-1].child)
    return chain[0], chain[-1].child, list(reversed(chain))


def execute_fused(op: MapLikeOp, ctx: ExecContext) -> BatchStream:
    """Execute a map-like operator, fusing its maximal map-like chain into
    one per-batch function (one CSE scope per operator)."""
    from blaze_tpu_torch.exprs.compiler import cse_scope

    _, source, chain = _fused_chain(op)
    fns = [c.make_batch_fn() for c in chain]

    def gen():
        for batch in source.execute(ctx):
            ctx.check_running()
            with op.metrics.timer():
                for fn in fns:
                    with cse_scope():
                        batch = fn(batch)
            yield batch

    return count_stream(op, gen())


def execute_plan(root: Operator,
                 ctx: Optional[ExecContext] = None) -> BatchStream:
    return root.execute(ctx or ExecContext())


def execute_stage_or_plan(root: Operator,
                          ctx: Optional[ExecContext] = None) -> BatchStream:
    """The whole-stage path first, streaming otherwise; for operators that
    run a whole stage below them (the shuffle writers): a matching
    scan -> filter -> project -> partial agg map task runs as one dense
    stage, one accumulate launch a batch. Agg-less chains stay streaming
    (chain_ok=False): one whole-stage batch would defeat the writer's
    bounded buffers and spill."""
    from blaze_tpu_torch.runtime.stage_compiler import try_run_stage

    ctx = ctx or ExecContext()
    staged = try_run_stage(root, ctx, chain_ok=False)
    if staged is not None:
        return iter([staged])
    return root.execute(ctx)


def collect(root: Operator, ctx: Optional[ExecContext] = None) -> ColumnBatch:
    """Materialize all output into one batch."""
    from blaze_tpu_torch.runtime.stage_compiler import try_run_stage

    ctx = ctx or ExecContext()
    staged = try_run_stage(root, ctx)
    if staged is not None:
        return staged
    return collect_streamed(root, ctx)


def collect_streamed(root: Operator, ctx: ExecContext,
                     device=None) -> ColumnBatch:
    """All of `root`'s streamed output as one batch (concatenated when the
    stream has several); an empty batch on `device`, or the context's,
    when it yields none."""
    batches = list(execute_plan(root, ctx))
    if not batches:
        return ColumnBatch.empty(root.schema, device=device or ctx.device)
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches, root.schema)


def collect_fetch(root: Operator, pack: Callable,
                  ctx: Optional[ExecContext] = None) -> np.ndarray:
    """Run the plan and fetch `pack(batch) -> 1-D tensor` to the host as a
    numpy array."""
    return collect_fetch_async(root, pack, ctx)()


def collect_fetch_async(root: Operator, pack: Callable,
                        ctx: Optional[ExecContext] = None):
    """collect_fetch split into run and fetch: returns a zero-arg
    `finish()` whose call pulls the packed result. The stage's own flags
    pull already happened; `pack` is only enqueued here."""
    packed = pack(collect(root, ctx))
    return lambda: to_host(packed).numpy()
