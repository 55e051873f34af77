"""Bounded, memory-charged asynchronous stream pipelining.

Port of blaze_tpu/runtime/pipeline.py, whole. A task's critical path is a
serial chain: Parquet decode, host->device upload, compute, device->host
pull, serialize and compress, shuffle write. The device idles while the
host does I/O and the other way round. The supervisor
(runtime/supervisor.py) overlaps work across tasks; this module overlaps
it inside one: host-side stages run on a shared I/O pool behind bounded
queues while the consumer thread keeps the device busy.

  prefetch(stream, ...)   run the producer ahead on the pool; the
                          consumer pops from a bounded queue of
                          conf.prefetch_batches items.
  offload(stream, fn)     apply `fn` (compress, decode, ...) to each
                          item ahead of consumption on the pool.
  Sink(fn, ...)           the write-side mirror: submit(item) enqueues
                          work (serialize and write a frame) for a pool
                          worker while the caller computes the next
                          batch; close() drains and re-raises.

A pool thread that uploads a batch or launches work does so on its own
current stream, which is the device's default stream as on every other
thread of the process: the consumer sees the batch in stream order with
no cross-stream wait.

Contracts (each backed by tests/test_torch_pipeline.py):

  ordered       a pipelined stream yields exactly the serial stream's
                items in order (single pump, single queue).
  bounded       at most `depth` items sit produced-but-unconsumed, and
                their bytes are reserved against the MemManager budget
                (MemManager.pipeline_reserved): an over-budget stream
                stops producing until the consumer drains — backpressure,
                not OOM. At least one item may always be in flight so
                other consumers' memory can never deadlock the stream.
  error relay   exceptions raised on the pool (including injected
                faults at the `io.prefetch` hand-off point) cross the
                queue after the items produced before them, exactly
                where the serial stream would have raised; the
                taxonomy (runtime/faults.py) classifies them unchanged.
  kill relay    the task kill flag is checked on BOTH sides of the
                queue; a blocked producer or consumer notices a kill /
                deadline / speculation loss within one poll tick and
                the producer is quiesced ("joined") on teardown — no
                orphan work, no leaked reservations. live_streams()
                counts unfinalized streams for leak checks.
  correlated    trace context (query/stage/task/attempt ids) and the
                supervisor's attempt (kill event for faults._stall) are
                snapshotted at construction and replayed on the pool.

No thread is parked on a blocked stream: producers run as short "pump"
tasks that return their pool slot whenever the queue is full or the
budget is exceeded, and are rescheduled by the consumer's dequeue —
so any number of concurrent streams share conf.io_threads without
slot-starvation deadlocks.

`conf.enable_pipeline=False` — or an armed fault spec without
{"concurrent": true} (thread timing would perturb the deterministic
chaos schedule, same rule as the supervisor's pool width) — makes
every adapter an identity: prefetch/offload return serial iterators,
Sink runs submit() inline.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

from blaze_tpu_torch import config
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import trace
from blaze_tpu_torch.runtime import metrics
from blaze_tpu_torch.runtime.metrics import MetricsSet

TELEMETRY = MetricsSet()
TELEMETRY.reset()  # counters only (streams/sinks opened, items, stalls)

# one poll tick bounds how late a blocked side notices kill/close/stop
_POLL_S = 0.02


def enabled() -> bool:
    """Pipelining active? False restores the serial streams bit-for-bit."""
    if not conf.enable_pipeline:
        return False
    spec = conf.fault_injection_spec
    if spec and not spec.get("concurrent"):
        return False
    return True


# -- shared I/O pool ---------------------------------------------------------

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_width = 0


def io_pool() -> ThreadPoolExecutor:
    """The process-wide I/O pool, (re)built at conf.io_threads width."""
    global _pool, _pool_width
    width = max(1, int(conf.io_threads))
    with _pool_lock:
        if _pool is None or _pool_width != width:
            old = _pool
            _pool = ThreadPoolExecutor(max_workers=width,
                                       thread_name_prefix="blz-io")
            _pool_width = width
            if old is not None:
                old.shutdown(wait=False)
        return _pool


def reset_pool() -> None:
    """Tear the pool down (tests); running pumps finish their item first."""
    global _pool, _pool_width
    with _pool_lock:
        if _pool is not None:
            _pool.shutdown(wait=False)
        _pool = None
        _pool_width = 0


# -- leak accounting ---------------------------------------------------------

_live_lock = threading.Lock()
_live = 0
# weak registry of the live objects themselves so the monitor sampler
# can report queue depths without adding state to the hot path
_live_objs: "weakref.WeakSet" = weakref.WeakSet()


def _live_inc(obj=None) -> None:
    global _live
    with _live_lock:
        _live += 1
        if obj is not None:
            _live_objs.add(obj)


def _live_dec(obj=None) -> None:
    global _live
    with _live_lock:
        _live -= 1
        if obj is not None:
            _live_objs.discard(obj)


def live_streams() -> int:
    """Streams/sinks created but not yet finalized — 0 between queries
    (chaos_soak's leaked-thread/reservation check)."""
    with _live_lock:
        return _live


def queue_depths() -> list:
    """Current queue depth of each live prefetch stream — a monitor
    sampler gauge. Depths are read without the stream locks: a torn
    read is fine for a gauge, and taking per-stream locks from the
    sampler thread would invert lock order with producers."""
    with _live_lock:
        objs = list(_live_objs)
    out = []
    for o in objs:
        buf = getattr(o, "_buf", None)
        if buf is not None:
            out.append(len(buf))
    return out


# -- context snapshot --------------------------------------------------------


class _CtxSnapshot:
    """What a pool thread must inherit from the constructing (task)
    thread: trace correlation ids, the supervisor's current
    attempt/task so current_kill_event() / current_commit_gate() —
    and through them faults._stall's kill-interruptible sleep — work
    inside pump bodies exactly as they do at batch boundaries, and the
    query's resolved conf overlay (config.overlay_scope) so producers
    reading adaptive batch knobs see the same per-query conf as the
    task thread that opened the stream, and the task's tally
    (metrics.task_tally) so its kernel launches count wherever they
    run."""

    __slots__ = ("trace_ctx", "sup_attempt", "sup_task",
                 "conf_overlay", "conf_provenance", "tally")

    def __init__(self) -> None:
        self.trace_ctx = trace.current_context()
        self.tally = metrics.current_tally()
        self.sup_attempt = None
        self.sup_task = None
        self.conf_overlay = config.current_overlay()
        self.conf_provenance = config.current_provenance()
        try:
            from blaze_tpu_torch.runtime import supervisor

            self.sup_attempt = getattr(supervisor._current, "attempt", None)
            self.sup_task = getattr(supervisor._current, "task", None)
        except Exception:  # noqa: BLE001 — snapshot must never fail a task
            pass

    def replay(self):
        from contextlib import ExitStack

        from blaze_tpu_torch.runtime import supervisor

        stack = ExitStack()
        stack.enter_context(trace.context(**self.trace_ctx))
        if self.tally is not None:
            stack.enter_context(metrics.task_tally(self.tally))
        if self.conf_overlay:
            stack.enter_context(config.overlay_scope(
                self.conf_overlay, self.conf_provenance))
        cur = supervisor._current
        prev = (getattr(cur, "attempt", None), getattr(cur, "task", None))
        cur.attempt, cur.task = self.sup_attempt, self.sup_task
        stack.callback(lambda: setattr(cur, "task", prev[1]))
        stack.callback(lambda: setattr(cur, "attempt", prev[0]))
        return stack


def _default_nbytes(item) -> int:
    """Budget charge for one in-flight item (host or device batch)."""
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.columnar.batch import ColumnBatch

    if isinstance(item, ColumnBatch):
        from blaze_tpu_torch.runtime.memory import batch_nbytes

        return batch_nbytes(item)
    if isinstance(item, serde.HostBatch):
        from blaze_tpu_torch.ops.host_sort import host_nbytes

        return host_nbytes(item)
    if isinstance(item, (bytes, bytearray, memoryview)):
        return len(item)
    return 0


# -- prefetch ----------------------------------------------------------------


class PrefetchStream:
    """Iterator over `source` whose production runs ahead on the I/O
    pool behind a bounded, budget-charged queue. Create via prefetch()."""

    name = "pipeline"

    def __init__(self, source: Iterable, depth: int, *,
                 name: str = "prefetch", ctx=None, manager=None,
                 charge: Optional[Callable] = None) -> None:
        self._src = iter(source)
        self._depth = max(1, int(depth))
        self._name = name
        self._ctx = ctx
        self._manager = manager
        self._charge = charge or _default_nbytes
        self._snap = _CtxSnapshot()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buf = []           # (item, nbytes) FIFO
        self._inflight = 0       # bytes reserved against the budget
        self._pumping = False    # a pump task is scheduled/running
        self._done = False       # source exhausted or errored
        self._error: Optional[BaseException] = None
        self._closed = False
        self._finalized = False
        # occupancy accounting (monotonic ns)
        self._t_start = time.monotonic_ns()
        self._producer_busy_ns = 0
        self._consumer_wait_ns = 0
        self._items = 0
        self._max_depth = 0
        TELEMETRY.add("streams_opened", 1)
        _live_inc(self)
        with self._lock:
            self._maybe_pump_locked()

    # -- producer side (pool threads) --

    def _maybe_pump_locked(self) -> None:
        """Schedule a pump task if production should run (lock held)."""
        if (self._pumping or self._done or self._closed
                or len(self._buf) >= self._depth
                or self._over_budget_locked()):
            return
        self._pumping = True
        try:
            io_pool().submit(self._pump)
        except BaseException:
            self._pumping = False
            raise

    def _over_budget_locked(self) -> bool:
        """Budget backpressure: pause production while the manager is
        over budget AND we already hold at least one undelivered item
        (never zero: other consumers' memory must not starve us)."""
        if self._manager is None or not self._buf:
            return False
        return self._manager.mem_used() > self._manager.total

    def _pump(self) -> None:
        """One pool task: produce until the queue/budget says stop, then
        yield the slot (the consumer's dequeue reschedules us)."""
        from blaze_tpu_torch.runtime import faults

        try:
            with self._snap.replay():
                while True:
                    with self._lock:
                        if (self._closed or self._done
                                or len(self._buf) >= self._depth
                                or self._over_budget_locked()):
                            self._pumping = False
                            self._cond.notify_all()
                            return
                    if self._ctx is not None:
                        self._ctx.check_running()
                    t0 = time.monotonic_ns()
                    try:
                        item = next(self._src)
                    except StopIteration:
                        with self._lock:
                            self._done = True
                            self._pumping = False
                            self._cond.notify_all()
                        return
                    # the queue hand-off: errors raised here (injected
                    # or real) cross to the consumer via _error
                    if conf.fault_injection_spec:
                        faults.inject("io.prefetch")
                    nbytes = self._charge(item)
                    self._producer_busy_ns += time.monotonic_ns() - t0
                    # reserve BEFORE the item becomes poppable, so a fast
                    # consumer's release can never precede the reserve
                    if self._manager is not None and nbytes:
                        self._manager.reserve_pipeline(nbytes)
                    dropped = False
                    with self._lock:
                        if self._closed:
                            self._pumping = False
                            dropped = True
                        else:
                            self._buf.append((item, nbytes))
                            self._inflight += nbytes
                            self._items += 1
                            depth = len(self._buf)
                            self._max_depth = max(self._max_depth, depth)
                        self._cond.notify_all()
                    if dropped:
                        if self._manager is not None and nbytes:
                            self._manager.release_pipeline(nbytes)
                        return
                    if conf.trace_enabled:
                        trace.record_value("pipeline_queue_depth", depth)
                        trace.event("queue_depth", pipeline=self._name,
                                    depth=depth)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            with self._lock:
                self._error = e
                self._done = True
                self._pumping = False
                self._cond.notify_all()

    # -- consumer side --

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        try:
            return self._next_inner()
        except StopIteration:
            raise
        except BaseException:
            # ANY exceptional exit — a relayed producer error or the
            # consumer's own kill/deadline poll — finalizes the stream:
            # quiesce the pump, release reservations (idempotent)
            self.close()
            raise

    def _next_inner(self):
        t0 = time.monotonic_ns()
        waited = False
        with self._lock:
            while not self._buf:
                if self._done or self._closed:
                    break
                self._maybe_pump_locked()
                waited = True
                self._cond.wait(_POLL_S)
                # a kill/deadline must unblock a consumer waiting on a
                # stalled (or killed) producer within one tick
                if self._ctx is not None:
                    self._ctx.check_running()
            if waited:
                self._consumer_wait_ns += time.monotonic_ns() - t0
            if self._buf:
                item, nbytes = self._buf.pop(0)
                self._inflight -= nbytes
                self._maybe_pump_locked()
            else:
                item, nbytes = None, -1
                # queue empty and producer done: items first, then the
                # error — exactly where the serial stream would have
                # raised. Capture+clear under the lock (raise once;
                # re-next() after the error ends clean).
                err = self._error
                self._error = None
        if nbytes >= 0:
            if self._manager is not None and nbytes:
                self._manager.release_pipeline(nbytes)
            return item
        self.close()
        if err is not None:
            raise err
        raise StopIteration

    def close(self) -> None:
        """Quiesce the producer and release reservations (idempotent).
        Safe from the consumer thread, generator teardown, or __del__."""
        with self._lock:
            if self._finalized:
                return
            self._closed = True
            self._cond.notify_all()
            # "join" the pump cooperatively: it checks _closed between
            # items and exits. Wait a short grace only — a pump stuck in
            # a blocked source read must NOT stall kill propagation; it
            # drops (and releases the reservation of) whatever it was
            # producing the moment the read returns, then exits. No
            # thread leaks either way: the pump is a pool task, not a
            # dedicated thread.
            deadline = time.monotonic() + 4 * _POLL_S
            while self._pumping and time.monotonic() < deadline:
                self._cond.wait(_POLL_S)
            self._finalized = True
            drained = self._inflight
            self._buf.clear()
            self._inflight = 0
        if self._manager is not None and drained:
            self._manager.release_pipeline(drained)
        _live_dec(self)
        TELEMETRY.add("streams_closed", 1)
        self._emit_stats()

    def stats(self) -> dict:
        """Occupancy snapshot. overlap_pct is the share of producer work
        hidden from the consumer: 100 means the consumer never waited."""
        with self._lock:
            busy = self._producer_busy_ns
            wait = self._consumer_wait_ns
            items = self._items
            max_depth = self._max_depth
        overlap = (100.0 * max(0.0, 1.0 - wait / busy)) if busy else 0.0
        wall = max(time.monotonic_ns() - self._t_start, 1)
        return {
            "pipeline": self._name,
            "items": items,
            "max_depth": max_depth,
            "producer_busy_ms": round(busy / 1e6, 3),
            "consumer_wait_ms": round(wait / 1e6, 3),
            "producer_occupancy_pct": round(100.0 * busy / wall, 1),
            "overlap_pct": round(overlap, 1),
        }

    def _emit_stats(self) -> None:
        if not conf.trace_enabled:
            return
        s = self.stats()
        if not s["items"]:
            return
        trace.record_value("pipeline_overlap_pct", int(s["overlap_pct"]))
        trace.record_value("pipeline_producer_busy_us",
                           int(s["producer_busy_ms"] * 1000))
        trace.record_value("pipeline_consumer_wait_us",
                           int(s["consumer_wait_ms"] * 1000))
        with trace.context(**self._snap.trace_ctx):
            trace.event("pipeline_stats", **s)

    def __del__(self):  # last-resort teardown; normal paths call close()
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from GC
            pass


def prefetch(stream: Iterable, depth: Optional[int] = None, *,
             name: str = "prefetch", ctx=None, manager=None,
             charge: Optional[Callable] = None):
    """Run `stream`'s production ahead on the I/O pool behind a bounded
    queue (default conf.prefetch_batches). Identity when pipelining is
    disabled. `ctx` (an ExecContext) threads the kill flag through both
    sides; `manager` charges in-flight bytes against the memory budget."""
    if depth is None:
        depth = conf.prefetch_batches
    if not enabled() or depth <= 0:
        if conf.fault_injection_spec:
            # keep the io.prefetch point alive on the serial path so a
            # non-concurrent (deterministic) chaos spec exercises it too
            return _serial_inject(stream)
        return iter(stream)
    return PrefetchStream(stream, depth, name=name, ctx=ctx,
                          manager=manager, charge=charge)


def _serial_inject(stream: Iterable) -> Iterator:
    from blaze_tpu_torch.runtime import faults

    for item in stream:
        faults.inject("io.prefetch")
        yield item


def offload(stream: Iterable, fn: Callable, depth: Optional[int] = None, *,
            name: str = "offload", ctx=None, manager=None,
            charge: Optional[Callable] = None):
    """Apply `fn` to each item ahead of consumption on the I/O pool
    (decompress, decode, ...). Identity mapping generator when disabled."""
    if not enabled():
        return (fn(item) for item in stream)
    return prefetch((fn(item) for item in stream), depth, name=name,
                    ctx=ctx, manager=manager, charge=charge)


# -- write-side sink ---------------------------------------------------------


class Sink:
    """Bounded async executor of ordered side-effect jobs on the I/O
    pool — the write-side mirror of prefetch: the shuffle writer submits
    (host batch, counts) while the device computes the next batch, and a
    single pool worker serializes+writes in submit order.

    submit() applies backpressure at `depth` pending jobs (and at the
    memory budget), raises any error the worker hit (classified
    unchanged), and polls the kill flag while blocked. close() drains
    and re-raises; abort() discards pending work and quiesces — the
    exception-unwind path, so a failed task leaks neither threads nor
    reservations. Inline (synchronous) when pipelining is disabled."""

    def __init__(self, fn: Callable, depth: Optional[int] = None, *,
                 name: str = "sink", ctx=None, manager=None) -> None:
        self._fn = fn
        self._depth = max(1, int(depth if depth is not None
                                 else conf.prefetch_batches))
        self._name = name
        self._ctx = ctx
        self._manager = manager
        self._inline = not enabled()
        self._snap = None if self._inline else _CtxSnapshot()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._q = []             # (item, nbytes) FIFO
        self._inflight = 0
        self._working = False
        self._error: Optional[BaseException] = None
        self._finalized = False
        self._items = 0
        if not self._inline:
            TELEMETRY.add("sinks_opened", 1)
            _live_inc(self)

    def submit(self, item, nbytes: int = 0) -> None:
        if self._error is not None:
            self._raise_pending()
        if self._inline:
            self._fn(item)
            return
        failed = False
        with self._lock:
            while (len(self._q) >= self._depth
                   or (self._manager is not None and self._q
                       and self._manager.mem_used() > self._manager.total)):
                if self._error is not None:
                    break
                self._cond.wait(_POLL_S)
                if self._ctx is not None:
                    self._ctx.check_running()
            if self._error is not None:
                failed = True
            else:
                # reserve BEFORE the job becomes poppable, so the
                # worker's release can never precede the reserve
                if self._manager is not None and nbytes:
                    self._manager.reserve_pipeline(nbytes)
                self._q.append((item, nbytes))
                self._inflight += nbytes
                self._items += 1
                if not self._working:
                    self._working = True
                    io_pool().submit(self._work)
            qlen = len(self._q)
        if failed:
            self._raise_pending()
        if conf.trace_enabled:
            trace.record_value("pipeline_queue_depth", qlen)

    def _work(self) -> None:
        from blaze_tpu_torch.runtime import faults

        try:
            with self._snap.replay():
                while True:
                    with self._lock:
                        if self._error is not None or not self._q:
                            self._working = False
                            self._cond.notify_all()
                            return
                        item, nbytes = self._q.pop(0)
                        self._inflight -= nbytes
                        self._cond.notify_all()
                    try:
                        if conf.fault_injection_spec:
                            faults.inject("io.prefetch")
                        self._fn(item)
                    finally:
                        if self._manager is not None and nbytes:
                            self._manager.release_pipeline(nbytes)
        except BaseException as e:  # noqa: BLE001 — relayed to submitter
            with self._lock:
                self._error = e
                self._working = False
                self._cond.notify_all()

    def _raise_pending(self):
        with self._lock:
            err = self._error
        self.abort()
        raise err

    def _quiesce(self) -> None:
        """Wait the worker out and release leftover reservations."""
        with self._lock:
            if self._finalized:
                return
            deadline = time.monotonic() + 30.0
            while self._working and time.monotonic() < deadline:
                self._cond.wait(_POLL_S)
            self._finalized = True
            drained = self._inflight
            self._q.clear()
            self._inflight = 0
        if self._manager is not None and drained:
            self._manager.release_pipeline(drained)
        _live_dec(self)
        TELEMETRY.add("sinks_closed", 1)

    def close(self) -> None:
        """Drain every submitted job, then re-raise the first worker
        error (if any). The success-path finalizer."""
        if self._inline:
            return
        with self._lock:
            while (self._q or self._working) and self._error is None:
                self._cond.wait(_POLL_S)
                if self._ctx is not None:
                    self._ctx.check_running()
            err = self._error
        self._quiesce()
        if err is not None:
            raise err

    def abort(self) -> None:
        """Discard pending jobs and quiesce without raising — the
        exception-unwind finalizer. Idempotent; no-op after close()."""
        if self._inline:
            return
        with self._lock:
            if self._finalized:
                return
            self._q.clear()  # drop un-started work; reservations released
            # by _quiesce (worker may still be mid-job; wait it out)
        self._quiesce()
