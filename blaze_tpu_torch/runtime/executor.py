"""Per-task execution: pipeline fusion, collect, and the fetch entry.

Port of blaze_tpu/runtime/executor.py: the collect subset (with
`collect_arrow`), `execute_stage_or_plan` (the entry of the shuffle
writers), `metric_tree`, `run_pool_plan` (the executor process's entry,
runtime/executor_pool.py) and `run_task_with_resilience`, the retry /
degrade / fallback ladder every supervised task runs under
(runtime/supervisor.py), whose retries and rungs also land on the live
progress waterfall (runtime/progress.py). Maximal
chains of map-like operators run as one composed per-batch function,
eagerly on the batch's device (PyTorch has no compiled-program cache to
keep small, so there is no jit cache here). `collect` first tries the
whole-stage path of runtime/stage_compiler.py (the dense grouped
aggregation, the agg-less chain stage); anything else streams, and a
stream of several batches concatenates into one (ops/common.py). Each
fused chain's dispatch bills its host wall time to runtime/monitor.py
(device_compute, or host_compute for a chain with a host function) and
each backoff sleep to retry_backoff, as the JAX package's does.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, MapLikeOp, Operator, count_stream,
)
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.runtime.metrics import MetricNode, to_host


def run_task_with_resilience(attempt: Callable[[], object], *,
                             what: str = "task",
                             run_info: Optional[dict] = None,
                             fallback: Optional[Callable[[], object]] = None,
                             ctx: Optional[ExecContext] = None,
                             deadline: Optional[float] = None,
                             on_error: Optional[Callable] = None,
                             session=None):
    """Drive one task attempt through the resilience ladder.

    `attempt` must be a FULL re-runnable unit of work (decode plan ->
    execute -> commit): every operator here rebuilds its state per
    attempt and artifact commits are crash-atomic (runtime/artifacts.py),
    so re-running after a failure is safe — the Spark task-retry model,
    executed in-engine.

    Policy by error category (faults.classify):
      retryable  bounded retries (conf.max_task_retries) with exponential
                 backoff + jitter (faults.backoff_ms)
      resource   the degradation ladder (conf.enable_degradation_ladder):
                 rung 1 halves conf.target_batch_bytes for the remaining
                 attempts, rung 2 forces a MemManager release (self-spill
                 of every consumer), rung 3 reroutes the task to
                 `fallback` (the CPU row interpreter in the local runner).
                 Ladder off => treated as plain retryable.
      plan/fatal relayed immediately (original exception type preserved)
      killed     relayed immediately, never counted as an engine error

    Rungs and retries are recorded in the process-global resilience
    telemetry and, when given, in `run_info` ("retries", "degradations",
    "degraded.<rung>", "ladder_rung", "errors.<category>").

    `deadline` (time.monotonic seconds, from the supervisor's
    task/query budgets): backoff sleeps are CLAMPED to the remaining
    budget, and a retryable failure with no budget left is reclassified
    to faults.DeadlineError instead of sleeping past the deadline.

    `on_error(exc, category)` is invoked for every classified failure
    except "killed" — the supervisor's per-operator circuit breaker
    counts failures through it.

    `session` (a service.QuerySession) scopes the ladder's degradations
    to ONE query: rung 1 halves the session's batch-target override
    instead of mutating the process-global conf.target_batch_bytes, and
    rung 2's forced spill sweeps only the session tenant's consumers —
    a degrading query cannot shrink another tenant's batches or evict
    its working set."""
    import time as _time

    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.runtime import faults, memory, monitor, trace

    retries = 0
    hang_relaunches = 0
    rung = 0
    saved_target = None
    try:
        while True:
            try:
                return attempt()
            except Exception as e:  # noqa: BLE001 — classify-and-decide
                cat = faults.classify(e)
                if cat == "killed":
                    raise
                faults.note_error(cat, run_info)
                trace.event("task_error", what=what, category=cat,
                            error=type(e).__name__)
                if on_error is not None:
                    try:
                        on_error(e, cat)
                    except Exception:  # noqa: BLE001 — observer only
                        pass
                ladder = cat == "resource" and conf.enable_degradation_ladder
                if ladder:
                    if rung == 0:
                        rung = 1
                        if session is not None:
                            saved_target = (session.batch_target
                                            or conf.target_batch_bytes)
                            session.batch_target = max(
                                saved_target // 2, 1 << 20)
                        else:
                            saved_target = conf.target_batch_bytes
                            conf.target_batch_bytes = max(
                                saved_target // 2, 1 << 20)
                        faults.note_degradation("halve_batch", run_info)
                        trace.event("ladder_rung", what=what, rung=1,
                                    action="halve_batch")
                        _note_rung(run_info, rung)
                        _note_progress("ladder_rung", "halve_batch")
                        continue
                    if rung == 1:
                        rung = 2
                        memory.get_manager(ctx).release(
                            1 << 62,
                            tenant=(session.tenant_id
                                    if session is not None else None))
                        faults.note_degradation("force_spill", run_info)
                        trace.event("ladder_rung", what=what, rung=2,
                                    action="force_spill")
                        _note_rung(run_info, rung)
                        _note_progress("ladder_rung", "force_spill")
                        continue
                    if rung == 2 and fallback is not None:
                        rung = 3
                        faults.note_degradation("fallback", run_info)
                        trace.event("ladder_rung", what=what, rung=3,
                                    action="fallback")
                        _note_rung(run_info, rung)
                        _note_progress("ladder_rung", "fallback")
                        return fallback()
                elif isinstance(e, faults.HungError) and \
                        hang_relaunches < conf.max_task_retries:
                    # a watchdog kill-on-suspicion, not a failure: its
                    # own relaunch budget (a false-positive hang must
                    # not drain the error-retry budget) and no backoff
                    # sleep — but never relaunch past the deadline
                    if deadline is not None and \
                            _time.monotonic() >= deadline:
                        trace.event("deadline_exceeded", what=what,
                                    during="hang_relaunch")
                        raise faults.DeadlineError(
                            f"{what}: hang-relaunch budget exhausted by "
                            f"deadline (after {hang_relaunches} "
                            f"relaunches)") from e
                    faults.note_retry(run_info)
                    hang_relaunches += 1
                    trace.event("hang_relaunch", what=what,
                                n=hang_relaunches)
                    continue
                elif cat in ("retryable", "resource") and \
                        retries < conf.max_task_retries:
                    sleep_s = faults.backoff_ms(retries) / 1000.0
                    if deadline is not None:
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            trace.event("deadline_exceeded", what=what,
                                        during="retry")
                            raise faults.DeadlineError(
                                f"{what}: retry budget exhausted by "
                                f"deadline (after {retries} retries)"
                            ) from e
                        sleep_s = min(sleep_s, remaining)
                    faults.note_retry(run_info)
                    retries += 1
                    trace.event("retry", what=what, n=retries,
                                category=cat,
                                backoff_ms=round(sleep_s * 1000, 2))
                    _note_progress("retry", cat)
                    t0 = _time.perf_counter_ns()
                    faults._sleep(sleep_s)
                    if conf.monitor_enabled:
                        monitor.count_time("retry_backoff",
                                           _time.perf_counter_ns() - t0)
                    continue
                raise faults.ensure_classified(e) from e
    finally:
        if saved_target is not None:
            # restore-to-max: with concurrent tasks two ladders can
            # interleave their save/restore — taking the max keeps a
            # degraded (halved) target from outliving the query even if
            # the saves raced
            if session is not None:
                session.batch_target = max(session.batch_target or 0,
                                           saved_target)
            else:
                conf.target_batch_bytes = max(conf.target_batch_bytes,
                                              saved_target)


# per-task operator metrics a driver sums into run_info: the whole-stage
# routes of runtime/stage_compiler.py and the Parquet scan's bytes and
# Arrow-to-device time (spark/local_runner.py; an executor process reports
# them in its result, runtime/executor_pool.py)
TASK_METRICS = ("stage_compiled", "stage_fallbacks", "bytes_scanned",
                "io_time_ns")


def task_metrics(op: Operator) -> dict:
    """TASK_METRICS summed over an executed operator tree."""
    out = dict.fromkeys(TASK_METRICS, 0)
    stack = [op]
    while stack:
        o = stack.pop()
        for key in TASK_METRICS:
            out[key] += o.metrics[key]
        stack.extend(o.children)
    return out


def run_pool_plan(node, ctx: ExecContext, what: str = "pool_task"):
    """Executor-PROCESS entry for one shipped plan proto
    (runtime/executor_pool.py worker): decode -> execute -> crash-atomic
    commit, driven through the in-process resilience ladder: a transient
    fault burns an executor-local retry (or a resource fault a ladder
    rung) before it costs the driver a cross-process re-queue. No row
    fallback here: the driver owns the lineage and re-executes lost
    partitions itself. conf.task_deadline_ms bounds all attempts, the
    contract of the supervised thread path. Returns the executed operator
    (its metrics carry the statistics the worker reports back)."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.plan import decode_plan

    def attempt():
        op = decode_plan(node)  # fresh operator state per attempt
        list(execute_plan(op, ctx))
        return op

    deadline = None
    if conf.task_deadline_ms and conf.task_deadline_ms > 0:
        deadline = time.monotonic() + conf.task_deadline_ms / 1000.0
    return run_task_with_resilience(attempt, what=what, ctx=ctx,
                                    deadline=deadline)


def _note_rung(run_info: Optional[dict], rung: int) -> None:
    if run_info is not None:
        run_info["ladder_rung"] = max(run_info.get("ladder_rung", 0), rung)


def _note_progress(kind: str, detail: str) -> None:
    """Mirror a resilience event into the live progress registry (the
    waterfall's retry/rung annotations). One truthiness check when live
    progress is off."""
    from blaze_tpu_torch.config import conf

    if conf.progress_enabled:
        from blaze_tpu_torch.runtime import progress

        progress.note_event(kind, detail)


def _fused_chain(op: MapLikeOp) -> tuple:
    """Longest chain of MapLikeOps ending at `op` (top-down order)."""
    chain = [op]
    while isinstance(chain[-1].child, MapLikeOp):
        chain.append(chain[-1].child)
    return chain[0], chain[-1].child, list(reversed(chain))


def execute_fused(op: MapLikeOp, ctx: ExecContext) -> BatchStream:
    """Execute a map-like operator, fusing its maximal map-like chain into
    one per-batch function (one CSE scope per operator)."""
    from blaze_tpu_torch.config import conf
    from blaze_tpu_torch.exprs.compiler import cse_scope
    from blaze_tpu_torch.runtime import monitor

    _, source, chain = _fused_chain(op)
    fns = [c.make_batch_fn() for c in chain]
    # a chain with a host-evaluated expression (digests, JSON, UDFs:
    # Operator.jit_safe) bills host_compute, any other device_compute
    category = ("device_compute" if all(c.jit_safe() for c in chain)
                else "host_compute")

    def gen():
        for batch in source.execute(ctx):
            ctx.check_running()
            t0 = time.perf_counter_ns()
            with op.metrics.timer():
                for fn in fns:
                    with cse_scope():
                        batch = fn(batch)
            if conf.monitor_enabled:
                # the dispatch's host wall time: kernels launch
                # asynchronously, so on the card this is enqueue time
                monitor.count_time(category, time.perf_counter_ns() - t0)
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


def collect_arrow(root: Operator, ctx: Optional[ExecContext] = None):
    """Run the plan and return its output as one pyarrow RecordBatch."""
    from blaze_tpu_torch.columnar.arrow_io import batch_to_arrow

    return batch_to_arrow(collect(root, ctx))


def metric_tree(root: Operator) -> MetricNode:
    """The operator tree's metrics as a MetricNode, with the process-wide
    resilience counters riding along as an extra child (no handler of its
    own). The JAX module's compile-service child comes with that module
    (ROADMAP Queue 1, item 4)."""
    from blaze_tpu_torch.runtime import faults

    node = MetricNode.from_operator(root)
    node.children = list(node.children) + [faults.telemetry_node()]
    return node
