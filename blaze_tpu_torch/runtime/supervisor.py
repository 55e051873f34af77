"""Task supervisor: bounded concurrency, heartbeats, deadlines, hang
detection, straggler speculation and per-operator circuit breaking.

Port of blaze_tpu/runtime/supervisor.py whole: the process supervision
(`ProcessPeer`, `ProcessWatchdog`: the executor pool's death detector,
runtime/executor_pool.py), and the query sessions and the `FairScheduler`
of the multi-tenant service (runtime/service.py), which every admitted
query submits its tasks to instead of a private pool. A breaker
trip writes a flight dossier, a watchdog kill stashes every thread's
stack for the query's dossier, and each attempt's state lands on the
live progress waterfall, as in the JAX module. The reference
engine gets all of this from Spark's scheduler; this engine is its own
scheduler, so the resilience ladder (retry / degrade / fallback,
executor.run_task_with_resilience) gets its time axis here:

  pool        shuffle-map / broadcast / result tasks run on a bounded
              worker pool (conf.max_concurrent_tasks). Deterministic
              chaos replay serializes the pool to ONE worker while a
              fault spec without {"concurrent": true} is armed:
              scheduling order is part of an injection schedule.

  heartbeat   every `ctx.check_running()` a task makes at a batch
              boundary doubles as its heartbeat (TaskAttempt.is_running
              bumps `last_beat`): proof of liveness and the cancel point
              are the same call.

  watchdog    a daemon thread scans live attempts: a heartbeat stalled
              past conf.hang_detect_ms KILLS the attempt, which the ladder
              relaunches as a fresh attempt; a task or query deadline
              (conf.task_deadline_ms / conf.query_deadline_ms) exceeded
              kills it and relays faults.DeadlineError. Backoff sleeps
              inside the ladder are clamped to the remaining budget.

  speculation a running attempt past conf.speculation_multiplier x the
              median attempt time of its stage gets a speculative twin on
              a thread of its own (not the bounded pool, which must never
              wait on itself). Both race; file-publishing tasks arbitrate
              through a CommitGate threaded into
              artifacts.commit_shuffle_pair, so exactly one `.data`/
              `.index` pair is published and the loser aborts as
              SpeculationLostError with its temps removed.

  breaker     classified failures carrying an `op.<Kind>` fault point
              count against that operator kind; after
              conf.breaker_failure_threshold of them within one query the
              kind TRIPS and every remaining task whose plan contains it
              goes straight to the row-interpreter fallback. The state is
              in the resilience telemetry (`breaker.tripped.<Kind>`) and
              run_info.

Disabled (conf.enable_supervisor=False) the runner runs tasks inline on
the driver thread with the ladder only.

On the card, every pool thread launches on its own current stream, the
device's default stream, so kernels of concurrent tasks queue in one
stream and the caching allocator's blocks stay on it. A sticky CUDA error
is classified fatal (runtime/faults.classify), so the ladder relays it
rather than relaunching on a poisoned context.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import statistics
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from blaze_tpu_torch import config
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.base import ExecContext, TaskKilledError
from blaze_tpu_torch.runtime import faults, metrics, trace

# thread-local plumbing: the attempt running on THIS thread (read by
# faults._stall to make injected stalls kill-interruptible) and the task
# owning it (read by fallback builders to inherit the commit gate).
_current = threading.local()

# task attempts currently executing across every Supervisor instance —
# a pool-occupancy gauge for the monitor sampler / Prometheus endpoint
_active_lock = threading.Lock()
_active = 0


def _active_delta(d: int) -> None:
    global _active
    with _active_lock:
        _active += d


def active_tasks() -> int:
    with _active_lock:
        return _active


def current_session():
    """The QuerySession (runtime/service.py) owning the work on THIS
    thread, or None outside the multi-tenant service. Pool workers reach
    it through their task; the query's driver thread through the
    thread-local run_plan pushes for the run's duration."""
    task = getattr(_current, "task", None)
    if task is not None:
        sess = getattr(task, "session", None)
        if sess is not None:
            return sess
    return getattr(_current, "session", None)


def current_kill_event() -> Optional[threading.Event]:
    att = getattr(_current, "attempt", None)
    return att.kill_event if att is not None else None


def current_commit_gate():
    task = getattr(_current, "task", None)
    return task.gate if task is not None else None


class TaskAttempt:
    """One execution of a task's attempt function. The kill flag is an
    Event so cooperative sleeps (faults._stall, backoff) can block on it;
    `is_running()` is wired into ExecContext, so every batch-boundary
    check is simultaneously the attempt's heartbeat."""

    __slots__ = ("task", "speculative", "started", "last_beat",
                 "kill_event", "kill_reason", "deadline", "attempt_id")

    def __init__(self, task: "_Task", speculative: bool) -> None:
        self.task = task
        self.speculative = speculative
        self.started = time.monotonic()
        self.last_beat = self.started
        self.kill_event = threading.Event()
        self.kill_reason: Optional[str] = None
        self.deadline = task.deadline
        # trace correlation id, unique within the task (speculative twins
        # get their own — "which attempt actually produced partition 7")
        self.attempt_id = task.next_attempt_id()

    def is_running(self) -> bool:
        self.last_beat = time.monotonic()
        return not self.kill_event.is_set()

    def kill(self, reason: str) -> bool:
        """Request cancellation; returns True only for the first kill so
        watchdog telemetry counts each detection once."""
        if self.kill_event.is_set():
            return False
        self.kill_reason = self.kill_reason or reason
        self.kill_event.set()
        return True


class CommitGate:
    """First-commit-wins arbiter shared by an attempt and its
    speculative twin. `claim()` is true exactly once; a claimant whose
    publish then fails calls `abort()` so the surviving lineage's retry
    can still commit."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._committed = False

    def claim(self) -> bool:
        with self._lock:
            if self._committed:
                return False
            self._committed = True
            return True

    def abort(self) -> None:
        with self._lock:
            self._committed = False


class CircuitBreaker:
    """Per-query, per-operator-kind failure counter. Attribution comes
    from the fault `point` the taxonomy attaches to classified errors
    ("op.<Kind>" at operator stream boundaries); unattributable errors
    (no point, or a non-operator point like spill.write) don't count —
    tripping must name an operator to reroute around."""

    def __init__(self, run_info: Optional[dict] = None) -> None:
        self._lock = threading.Lock()
        self._failures: Dict[str, int] = {}
        self._tripped: set = set()
        self._run_info = run_info

    def note_failure(self, exc: BaseException, category: str = "") -> None:
        if category == "killed":
            return
        threshold = int(conf.breaker_failure_threshold)
        if threshold <= 0:
            return
        point = getattr(exc, "point", None)
        if not point:
            point = getattr(getattr(exc, "__cause__", None), "point", None)
        if not isinstance(point, str) or not point.startswith("op."):
            return
        kind = point.split(".", 1)[1]
        with self._lock:
            n = self._failures[kind] = self._failures.get(kind, 0) + 1
            if kind in self._tripped or n < threshold:
                return
            self._tripped.add(kind)
        faults.TELEMETRY.add("breaker.trips", 1)
        faults.TELEMETRY.add(f"breaker.tripped.{kind}", 1)
        trace.event("breaker_trip", op_kind=kind, failures=n)
        if self._run_info is not None:
            self._run_info["breaker_trips"] = \
                self._run_info.get("breaker_trips", 0) + 1
        if conf.flight_dir:
            # black-box dossier at the moment of the trip: the query
            # usually survives (rerouted to fallback), so the end-of-run
            # hook would never see this incident
            from blaze_tpu_torch.runtime import flight_recorder

            qid = trace.current_context().get("query_id")
            if qid:
                flight_recorder.capture(
                    "breaker_trip", qid,
                    error=exc if isinstance(exc, Exception) else None,
                    detail={"op_kind": kind, "failures": n})

    def tripped(self) -> FrozenSet[str]:
        with self._lock:
            return frozenset(self._tripped)

    def should_reroute(self, op_kinds: FrozenSet[str]) -> bool:
        if not op_kinds:
            return False
        with self._lock:
            return not self._tripped.isdisjoint(op_kinds)


class ProcessPeer:
    """One supervised executor process: the PID twin of TaskAttempt.
    `beat()` is bumped by ANY inbound control-socket frame (push beats
    included), the same no-second-instrument posture as the thread
    heartbeat; `poll` is the owner's reaper (subprocess.Popen.poll) so a
    zombie child is seen as dead even though os.kill(pid, 0) still
    succeeds on it."""

    __slots__ = ("key", "pid", "last_beat", "poll", "on_death", "dead",
                 "draining", "stale_ms")

    def __init__(self, key: str, pid: int,
                 on_death: Callable[["ProcessPeer", str, Optional[int]],
                                    None],
                 poll: Optional[Callable[[], Optional[int]]] = None,
                 stale_ms: Optional[int] = None) -> None:
        self.key = key
        self.pid = pid
        self.last_beat = time.monotonic()
        self.poll = poll
        self.on_death = on_death
        self.dead = False
        self.draining = False
        # per-peer staleness override: None -> conf.executor_death_ms;
        # 0 -> pid-liveness ONLY (a peer that never beats this watchdog
        # — the standby watching its primary — must not be declared
        # heartbeat-dead for silence that is perfectly healthy)
        self.stale_ms = stale_ms

    def beat(self) -> None:
        self.last_beat = time.monotonic()


class ProcessWatchdog:
    """Executor-death detector: the thread watchdog's heartbeat/staleness
    scan generalized to PIDs (ROADMAP item 1). A peer is declared dead
    when its process is reaped/vanished (reason "exit", with the exit
    code — negative = killing signal) or when its heartbeat goes stale
    past conf.executor_death_ms (reason "heartbeat" — the process may
    still be RUNNING; the owner must fence its epoch so its late results
    are rejected). Each peer's on_death fires exactly once, off-thread
    from the socket readers, and must never raise."""

    _TICK = 0.05

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: Dict[str, ProcessPeer] = {}
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, key: str, pid: int, on_death,
                 poll=None, stale_ms=None) -> ProcessPeer:
        peer = ProcessPeer(key, pid, on_death, poll=poll,
                           stale_ms=stale_ms)
        with self._lock:
            self._peers[key] = peer
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="blz-procdog", daemon=True)
                self._thread.start()
        return peer

    def unregister(self, key: str) -> None:
        with self._lock:
            self._peers.pop(key, None)

    def beat(self, key: str) -> None:
        with self._lock:
            peer = self._peers.get(key)
        if peer is not None:
            peer.beat()

    def mark_draining(self, key: str) -> None:
        """Flag a peer as gracefully decommissioning: its clean exit
        (rc 0) routes to on_death(reason="drained") with NO
        executor_death event/telemetry — an orderly drain is not a
        death."""
        with self._lock:
            peer = self._peers.get(key)
        if peer is not None:
            peer.draining = True

    def _pid_gone(self, peer: ProcessPeer) -> Tuple[bool, Optional[int]]:
        if peer.poll is not None:
            rc = peer.poll()
            if rc is not None:
                return True, rc
            return False, None
        from blaze_tpu_torch.runtime.artifacts import _pid_alive

        return (not _pid_alive(peer.pid)), None

    def _loop(self) -> None:
        while not self._closed.is_set():
            death_ms = max(int(conf.executor_death_ms), 1)
            self._closed.wait(min(self._TICK, death_ms / 4000.0))
            try:
                self._scan()
            except Exception:  # noqa: BLE001 — watchdog must never die
                pass

    def _scan(self) -> None:
        now = time.monotonic()
        stale_s = max(int(conf.executor_death_ms), 1) / 1000.0
        with self._lock:
            peers = list(self._peers.values())
        for peer in peers:
            if peer.dead:
                continue
            gone, rc = self._pid_gone(peer)
            peer_stale_s = (stale_s if peer.stale_ms is None
                            else max(int(peer.stale_ms), 0) / 1000.0)
            if gone:
                reason = "exit"
            elif peer.draining:
                continue  # a draining peer may idle past staleness
            elif peer_stale_s > 0 and now - peer.last_beat > peer_stale_s:
                reason, rc = "heartbeat", None
            else:
                continue
            peer.dead = True
            self.unregister(peer.key)
            if peer.stale_ms == 0:
                # a pid-liveness-only peer is a SILENT watch on a
                # non-heartbeating process (the standby watching its
                # primary, standby.StandbyDriver) — route the death to
                # the owner but do not account it as an executor death
                try:
                    peer.on_death(peer, reason, rc)
                except Exception:  # noqa: BLE001 — must not kill scan
                    pass
                continue
            if peer.draining and rc in (0, None):
                # clean exit of a decommissioning worker: route to the
                # owner as "drained", no dossier, no death accounting
                try:
                    peer.on_death(peer, "drained", rc)
                except Exception:  # noqa: BLE001 — must not kill scan
                    pass
                continue
            faults.TELEMETRY.add("executor_deaths", 1)
            trace.event("executor_death", exec_id=peer.key, pid=peer.pid,
                        reason=reason, exit_code=rc,
                        stale_ms=round((now - peer.last_beat) * 1000))
            try:
                peer.on_death(peer, reason, rc)
            except Exception:  # noqa: BLE001 — callback must not kill scan
                pass

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            thread = self._thread
            self._peers.clear()
        if thread is not None:
            thread.join(timeout=1.0)


class _SessionQueue:
    """FairScheduler-internal per-session run queue (stride scheduling
    state): FIFO within the session, virtual time across sessions."""

    __slots__ = ("tenant_id", "query_id", "weight", "vt", "items")

    def __init__(self, tenant_id: str, query_id: str, weight: float,
                 vt: float) -> None:
        self.tenant_id = tenant_id
        self.query_id = query_id
        self.weight = max(float(weight), 1e-6)
        self.vt = vt
        self.items: collections.deque = collections.deque()


class FairScheduler:
    """Shared worker pool dispatching TaskSpecs across live query
    sessions with deficit-weighted round robin (stride scheduling).

    The single-query Supervisor submits FIFO into its own pool; under
    the multi-tenant service every live query submits HERE instead, and
    each free worker runs the head of the non-empty session queue with
    the smallest virtual time, then advances that queue's clock by
    1/weight (weight = the tenant's conf.tenant_priority_spec entry).
    Under contention a weight-3 tenant gets ~3x the dispatch share of a
    weight-1 tenant, order within one session stays submission order,
    and no session starves (every dispatch monotonically advances the
    running queue's clock past its peers'). A session entering mid-run
    starts at the scheduler's current clock — it competes from now on,
    it does not get retroactive catch-up dispatches."""

    def __init__(self, width: int) -> None:
        self.width = max(1, int(width))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, _SessionQueue] = {}
        self._vclock = 0.0
        self._closed = False
        # (tenant_id, query_id, what) per dispatch, in dispatch order —
        # how tests observe weighted fairness without timing assertions
        self.dispatch_log: List[Tuple[str, str, str]] = []
        self._threads = [
            threading.Thread(target=self._worker, name=f"blz-svc-{i}",
                             daemon=True)
            for i in range(self.width)]
        for t in self._threads:
            t.start()

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q.items) for q in self._queues.values())

    def submit(self, session, fn: Callable[[], Any],
               what: str = "") -> Future:
        """Enqueue fn under the session's queue; returns a Future that a
        worker completes (cancel() works while still queued)."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("FairScheduler is closed")
            q = self._queues.get(session.query_id)
            if q is None:
                q = _SessionQueue(session.tenant_id, session.query_id,
                                  session.priority, self._vclock)
                self._queues[session.query_id] = q
            # 4th element: enqueue timestamp — dispatch wait (submitted
            # -> picked) is the "sched_queue" critical-path term
            q.items.append((fut, fn, what, time.monotonic()))
            self._cond.notify()
        return fut

    def forget(self, session) -> None:
        """Drop a finished session's queue (cancelling stragglers)."""
        with self._cond:
            q = self._queues.pop(session.query_id, None)
        if q is not None:
            for fut, _fn, _what, _t0 in q.items:
                fut.cancel()

    def _pick_locked(self) -> Optional[tuple]:
        ready = [q for q in self._queues.values() if q.items]
        if not ready:
            return None
        q = min(ready, key=lambda s: (s.vt, s.query_id))
        item = q.items.popleft()
        q.vt += 1.0 / q.weight
        if q.vt > self._vclock:
            self._vclock = q.vt
        self.dispatch_log.append((q.tenant_id, q.query_id, item[2]))
        # per-query dispatch-wait attribution (runtime/doctor.py term
        # "sched_queue"); explicit qid — workers have no trace context
        wait_ns = int((time.monotonic() - item[3]) * 1e9)
        if wait_ns > 0 and conf.monitor_enabled:
            from blaze_tpu_torch.runtime import monitor

            monitor.count_time("sched_queue", wait_ns, qid=q.query_id)
        return item

    def _worker(self) -> None:
        while True:
            with self._cond:
                item = self._pick_locked()
                while item is None and not self._closed:
                    self._cond.wait()
                    item = self._pick_locked()
                if item is None:
                    return  # closed and drained
            fut, fn, _what, _t0 = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — relay via future
                fut.set_exception(e)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            for q in self._queues.values():
                for fut, _fn, _what, _t0 in q.items:
                    fut.cancel()
                q.items.clear()
            self._queues.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)


@dataclasses.dataclass
class TaskSpec:
    """One schedulable unit handed to Supervisor.run_tasks.

    `attempt_fn(ctx)` must be a FULL re-runnable attempt (decode plan ->
    execute -> commit) — it is invoked once per attempt with a fresh
    ExecContext carrying that attempt's kill flag and the task's commit
    gate. `fallback_fn()` is the rung-3 row-interpreter route (also used
    by breaker reroutes). `op_kinds` is the set of operator names in the
    task's plan, for breaker matching."""

    what: str
    attempt_fn: Callable[[ExecContext], Any]
    partition: int = 0
    num_partitions: int = 1
    fallback_fn: Optional[Callable[[], Any]] = None
    op_kinds: FrozenSet[str] = frozenset()
    speculatable: bool = True


class _Task:
    """Supervisor-internal task state: the spec, its commit gate, the
    live attempts (primary + at most one speculative) and the
    first-finish-wins outcome."""

    def __init__(self, spec: TaskSpec, stage_key, deadline: Optional[float],
                 trace_ctx: Optional[Dict[str, Any]] = None,
                 session=None) -> None:
        self.spec = spec
        self.stage_key = stage_key
        self.deadline = deadline
        self.session = session
        self.gate = CommitGate()
        self.done = threading.Event()
        self._lock = threading.Lock()
        self.outcome: Optional[Tuple[str, Any]] = None
        self.live_attempts: List[TaskAttempt] = []
        self.speculated = False
        self.cancelled = False
        self.primary_started: Optional[float] = None
        # driver-thread trace context (query_id/stage_id) captured at
        # submit, replayed inside pool/speculative/watchdog emissions so
        # cross-thread records stay correlated; task_id = spec.what
        self.trace_ctx: Dict[str, Any] = dict(trace_ctx or {})
        self.trace_ctx["task_id"] = spec.what
        # the submitting thread's resolved conf overlay
        # (config.overlay_scope): replayed around every attempt so pool
        # workers and speculative twins read the same per-query conf as
        # the driver thread — one query's overlay never leaks into a
        # concurrent query's tasks
        self.conf_overlay = config.current_overlay()
        self.conf_provenance = config.current_provenance()
        # the submitting query's tally (metrics.task_tally, opened by
        # run_plan), rejoined around every attempt so each query counts
        # its own kernel launches and host pulls while others run
        self.tally = metrics.current_tally()
        self._attempt_seq = itertools.count(1)

    def next_attempt_id(self) -> int:
        return next(self._attempt_seq)

    @property
    def finished(self) -> bool:
        return self.done.is_set()

    def finish(self, kind: str, value: Any) -> bool:
        """Record the outcome; only the FIRST finisher wins."""
        with self._lock:
            if self.outcome is not None:
                return False
            self.outcome = (kind, value)
        self.done.set()
        return True

    def attach(self, att: TaskAttempt) -> None:
        with self._lock:
            self.live_attempts.append(att)
            if not att.speculative and self.primary_started is None:
                self.primary_started = att.started

    def detach(self, att: TaskAttempt) -> None:
        with self._lock:
            try:
                self.live_attempts.remove(att)
            except ValueError:
                pass

    def live(self) -> List[TaskAttempt]:
        with self._lock:
            return list(self.live_attempts)

    def kill_attempts(self, reason: str,
                      speculative: Optional[bool] = None) -> None:
        for att in self.live():
            if speculative is None or att.speculative == speculative:
                att.kill(reason)


class Supervisor:
    """Per-query task supervisor. Create one per run_plan invocation,
    call `run_tasks` per stage, `close()` in the run's finally."""

    _WATCHDOG_TICK = 0.05
    _ABANDON_GRACE = 2.0  # slack past a deadline before abandoning a thread

    def __init__(self, run_info: Optional[dict] = None,
                 session=None, device=None) -> None:
        self.run_info = run_info
        self.session = session
        # the device every attempt's ExecContext carries (None: the card)
        self.device = device
        self.enabled = bool(conf.enable_supervisor)
        self.breaker = CircuitBreaker(run_info)
        self.query_deadline: Optional[float] = None
        if session is not None and session.deadline_at is not None:
            # admission-aware budget: the service stamped the absolute
            # deadline when the query ARRIVED, so time parked in the
            # admission queue counts against conf.query_deadline_ms
            self.query_deadline = session.deadline_at
        elif conf.query_deadline_ms and conf.query_deadline_ms > 0:
            self.query_deadline = (time.monotonic()
                                   + conf.query_deadline_ms / 1000.0)
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._tasks: List[_Task] = []
        self._durations: Dict[Any, List[float]] = {}
        self._spec_threads: List[threading.Thread] = []
        self._closed = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self._abandoned = False

    # -- budgets -----------------------------------------------------------

    def deadline(self) -> Optional[float]:
        """Absolute monotonic deadline for a task launched NOW: the
        tighter of the per-task and remaining per-query budgets."""
        cands = []
        if conf.task_deadline_ms and conf.task_deadline_ms > 0:
            cands.append(time.monotonic() + conf.task_deadline_ms / 1000.0)
        if self.query_deadline is not None:
            cands.append(self.query_deadline)
        return min(cands) if cands else None

    # -- pool / watchdog ---------------------------------------------------

    def _pool_width(self) -> int:
        spec = conf.fault_injection_spec
        if spec and not spec.get("concurrent"):
            # deterministic chaos replay: thread interleavings would make
            # the global nth/fail_times counters consume in racy order
            return 1
        return max(1, int(conf.max_concurrent_tasks))

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._pool_width(),
                    thread_name_prefix="blz-task")
            return self._pool

    def _watchdog_needed(self) -> bool:
        return (self.query_deadline is not None
                or (conf.task_deadline_ms or 0) > 0
                or (conf.hang_detect_ms or 0) > 0
                or (conf.speculation_multiplier or 0) > 0)

    def _ensure_watchdog(self) -> None:
        if not self._watchdog_needed():
            return
        with self._lock:
            if self._watchdog is not None:
                return
            t = threading.Thread(target=self._watchdog_loop,
                                 name="blz-watchdog", daemon=True)
            self._watchdog = t
        t.start()

    def _watchdog_loop(self) -> None:
        while not self._closed.is_set():
            tick = self._WATCHDOG_TICK
            hang_ms = conf.hang_detect_ms or 0
            if hang_ms > 0:
                tick = min(tick, hang_ms / 4000.0)
            self._closed.wait(max(tick, 0.005))
            try:
                self._scan()
            except Exception:  # noqa: BLE001 — watchdog must never die
                pass

    def _scan(self) -> None:
        now = time.monotonic()
        hang_s = (conf.hang_detect_ms or 0) / 1000.0
        with self._lock:
            tasks = list(self._tasks)
        for task in tasks:
            if task.finished:
                continue
            for att in task.live():
                if att.deadline is not None and now > att.deadline:
                    if att.kill("deadline"):
                        self._note("deadline_kills")
                        trace.event("deadline_kill",
                                    attempt_id=att.attempt_id,
                                    **task.trace_ctx)
                        self._stash_stacks(task, "deadline")
                elif hang_s > 0 and now - att.last_beat > hang_s:
                    if att.kill("hung"):
                        self._note("hangs_detected")
                        # a heartbeat miss: the attempt's batch-boundary
                        # check went stale past conf.hang_detect_ms
                        trace.event("hang_detected",
                                    attempt_id=att.attempt_id,
                                    stale_ms=round((now - att.last_beat)
                                                   * 1000),
                                    **task.trace_ctx)
                        self._stash_stacks(task, "hung")
            self._maybe_speculate(task, now)

    def _stash_stacks(self, task: _Task, reason: str) -> None:
        """Snapshot every thread's stack AT detection time for the
        flight recorder: by the time the query unwinds and the dossier
        is written, the hung/overrunning frames are long gone."""
        if not conf.flight_dir:
            return
        qid = task.trace_ctx.get("query_id")
        if not qid:
            return
        from blaze_tpu_torch.runtime import flight_recorder

        flight_recorder.record_stacks(qid, reason)

    def _note(self, key: str, n: int = 1) -> None:
        faults.TELEMETRY.add(key, n)
        if self.run_info is not None:
            self.run_info[key] = self.run_info.get(key, 0) + n

    # -- duration stats (speculation threshold) ----------------------------

    def _record_duration(self, stage_key, seconds: float) -> None:
        with self._lock:
            self._durations.setdefault(stage_key, []).append(seconds)

    def _median_duration(self, stage_key) -> Optional[float]:
        with self._lock:
            ds = self._durations.get(stage_key)
            if not ds or len(ds) < 2:
                return None  # no basis to call anything a straggler yet
            return statistics.median(ds)

    # -- speculation -------------------------------------------------------

    def _maybe_speculate(self, task: _Task, now: float) -> None:
        mult = float(conf.speculation_multiplier or 0)
        if mult <= 0 or task.speculated or task.cancelled or task.finished:
            return
        if not task.spec.speculatable or task.primary_started is None:
            return
        med = self._median_duration(task.stage_key)
        if med is None or now - task.primary_started <= mult * med:
            return
        with task._lock:
            if task.speculated or task.outcome is not None:
                return
            task.speculated = True
        self._note("speculations_launched")
        trace.event("speculation_launch",
                    elapsed_ms=round((now - task.primary_started) * 1000),
                    median_ms=round(med * 1000), **task.trace_ctx)
        t = threading.Thread(target=self._run_speculative, args=(task,),
                             name="blz-speculative", daemon=True)
        with self._lock:
            self._spec_threads.append(t)
        t.start()

    def _run_speculative(self, task: _Task) -> None:
        """The twin: ONE bare attempt, no ladder — if it fails the
        primary's ladder is still driving recovery, and if it wins the
        primary is killed with reason "speculation_lost"."""
        try:
            started = time.monotonic()
            value = self._attempt_once(task, speculative=True)
        except BaseException as e:  # noqa: BLE001 — twin failure non-fatal
            trace.event("speculation_loss", loser="speculative",
                        reason=type(e).__name__, **task.trace_ctx)
            return
        if task.finish("ok", value):
            self._note("speculations_won")
            # the twin won the first-commit-wins race; the primary is
            # killed and records the loss side of the same pair
            trace.event("speculation_win", winner="speculative",
                        **task.trace_ctx)
            self._record_duration(task.stage_key,
                                  time.monotonic() - started)
            trace.record_value("task_latency_us",
                               int((time.monotonic() - started) * 1e6))
            task.kill_attempts("speculation_lost", speculative=False)

    # -- attempt execution -------------------------------------------------

    def _attempt_once(self, task: _Task, speculative: bool) -> Any:
        """Run the spec's attempt function once under a fresh
        TaskAttempt. Supervisor-initiated kills are translated at this
        boundary: "hung" relaunches under the ladder (HungError, its
        own relaunch budget),
        "deadline" is terminal (DeadlineError), everything else —
        speculation_lost / sibling_failed / shutdown — stays killed."""
        if task.cancelled:
            raise TaskKilledError(f"{task.spec.what}: cancelled")
        att = TaskAttempt(task, speculative)
        task.attach(att)
        if conf.progress_enabled:
            from blaze_tpu_torch.runtime import progress
            progress.attempt_update(task.trace_ctx, att.attempt_id,
                                    "running", speculative=speculative)
        else:
            progress = None
        prev_att = getattr(_current, "attempt", None)
        prev_task = getattr(_current, "task", None)
        _current.attempt, _current.task = att, task
        try:
            # replay the driver's correlation ids on THIS thread (pool or
            # speculative twin) and record the attempt as a span — every
            # record inside inherits query/stage/task/attempt ids
            with trace.context(**task.trace_ctx), \
                    metrics.task_tally(task.tally):
                with trace.span("task_attempt",
                                attempt_id=att.attempt_id,
                                partition=task.spec.partition,
                                speculative=speculative) as sp:
                    ctx = ExecContext(
                        partition=task.spec.partition,
                        num_partitions=task.spec.num_partitions,
                        is_running=att.is_running,
                        commit_gate=task.gate, device=self.device)
                    try:
                        if task.conf_overlay:
                            with config.overlay_scope(
                                    task.conf_overlay,
                                    task.conf_provenance):
                                return task.spec.attempt_fn(ctx)
                        return task.spec.attempt_fn(ctx)
                    finally:
                        if att.kill_reason:
                            sp.set(kill_reason=att.kill_reason)
        except TaskKilledError as e:
            if att.kill_reason == "hung":
                raise faults.HungError(
                    f"{task.spec.what}: attempt hung (no heartbeat for "
                    f"{conf.hang_detect_ms}ms), killed and relaunching"
                ) from e
            if att.kill_reason == "deadline":
                raise faults.DeadlineError(
                    f"{task.spec.what}: deadline exceeded") from e
            raise
        finally:
            _current.attempt, _current.task = prev_att, prev_task
            task.detach(att)
            if progress is not None:
                if att.kill_reason:
                    state = f"killed:{att.kill_reason}"
                elif sys.exc_info()[1] is not None:
                    state = "failed"
                else:
                    state = "ok"
                progress.attempt_update(task.trace_ctx, att.attempt_id,
                                        state, speculative=speculative)

    def _run_supervised(self, task: _Task) -> Any:
        """Pool-worker body: breaker reroute, then the resilience
        ladder around `_attempt_once`, racing any speculative twin
        through the task's outcome slot."""
        from blaze_tpu_torch.runtime.executor import run_task_with_resilience

        prev_task = getattr(_current, "task", None)
        _current.task = task
        _active_delta(1)
        try:
            # context on the WORKER thread so the executor's retry/ladder
            # events (emitted between attempts, outside _attempt_once's
            # span) still carry the query/stage/task ids
            with trace.context(**task.trace_ctx), \
                    metrics.task_tally(task.tally):
                self._run_supervised_inner(task, run_task_with_resilience)
        except BaseException as e:  # noqa: BLE001
            if (isinstance(e, TaskKilledError) and not task.finished
                    and not task.cancelled):
                # killed by a twin that should be finishing the task —
                # give it a bounded window, then own the failure (e.g.
                # the twin claimed the gate and then died). A cancelled
                # task (a sibling failed, or shutdown) has no twin to
                # wait for
                task.done.wait(self._twin_grace(task))
            if not task.finish("err", e):
                pass  # a twin already finished; its outcome stands
        finally:
            _active_delta(-1)
            _current.task = prev_task
        task.done.wait()
        kind, value = task.outcome  # type: ignore[misc]
        if kind == "err":
            raise value
        return value

    def _run_supervised_inner(self, task: _Task, run_task_with_resilience
                              ) -> None:
        spec = task.spec

        def attempt():
            # breaker check at EVERY attempt boundary, not just task
            # start: a kind that trips mid-ladder (its own failures
            # count) reroutes this task's next retry instead of
            # burning the remaining budget on a doomed operator
            if (spec.fallback_fn is not None
                    and self.breaker.should_reroute(spec.op_kinds)):
                self._note("breaker_reroutes")
                return spec.fallback_fn()
            return self._attempt_once(task, speculative=False)

        started = time.monotonic()
        value = run_task_with_resilience(
            attempt, what=spec.what, run_info=self.run_info,
            fallback=spec.fallback_fn, deadline=task.deadline,
            on_error=self.breaker.note_failure, session=self.session)
        if task.finish("ok", value):
            self._record_duration(task.stage_key,
                                  time.monotonic() - started)
            trace.record_value(
                "task_latency_us",
                int((time.monotonic() - started) * 1e6))
            if task.speculated:
                # primary beat its own twin: the launched speculation
                # lost the race
                trace.event("speculation_loss", loser="speculative",
                            reason="primary_finished",
                            **task.trace_ctx)
        task.kill_attempts("speculation_lost", speculative=True)

    def _twin_grace(self, task: _Task) -> float:
        if task.deadline is not None:
            return max(0.0, task.deadline - time.monotonic()) \
                + self._ABANDON_GRACE
        return 30.0

    # -- public API --------------------------------------------------------

    def run_tasks(self, stage_key, specs: List[TaskSpec]) -> List[Any]:
        """Run a stage's tasks, returning their values in spec order.
        Raises the first task error after killing the stage's siblings;
        a task that outlives its deadline without cooperating is
        abandoned on its thread and relayed as DeadlineError."""
        if not specs:
            return []
        if not self.enabled:
            return [self._run_sequential(spec) for spec in specs]
        deadline = self.deadline()
        # snapshot the driver's query/stage ids here, on the submitting
        # thread — pool workers and twins replay them via task.trace_ctx
        ctx_snap = trace.current_context()
        tasks = [_Task(spec, stage_key, deadline, ctx_snap,
                       session=self.session)
                 for spec in specs]
        with self._lock:
            self._tasks.extend(tasks)
        self._ensure_watchdog()
        sched = (self.session.scheduler
                 if self.session is not None else None)
        if sched is not None:
            # multi-tenant service: the SHARED pool interleaves this
            # stage's tasks with other live queries', weighted by tenant
            # priority (FairScheduler) — not this query's private FIFO
            futures = [sched.submit(self.session,
                                    lambda t=t: self._run_supervised(t),
                                    what=t.spec.what)
                       for t in tasks]
        else:
            pool = self._ensure_pool()
            futures = [pool.submit(self._run_supervised, t)
                       for t in tasks]
        results: List[Any] = [None] * len(tasks)
        first_err: Optional[BaseException] = None
        for i, (task, fut) in enumerate(zip(tasks, futures)):
            timeout = None
            if task.deadline is not None:
                timeout = max(0.0, task.deadline - time.monotonic()) \
                    + self._ABANDON_GRACE
            try:
                results[i] = fut.result(timeout=timeout)
            except (TimeoutError, FutureTimeoutError):
                # (futures.TimeoutError is a distinct class until py3.11)
                # non-cooperative hang: kill (in case it ever wakes),
                # abandon the thread, relay as a deadline failure
                task.cancelled = True
                task.kill_attempts("deadline")
                self._abandoned = True
                trace.event("task_abandoned", **task.trace_ctx)
                if first_err is None:
                    first_err = faults.DeadlineError(
                        f"{task.spec.what}: task exceeded its deadline "
                        f"without cooperating; attempt abandoned")
                    self._cancel_siblings(tasks, futures, skip=i)
            except BaseException as e:  # noqa: BLE001
                if first_err is None:
                    first_err = e
                    self._cancel_siblings(tasks, futures, skip=i)
        if first_err is not None:
            raise first_err
        return results

    def _cancel_siblings(self, tasks: List[_Task], futures, skip: int
                         ) -> None:
        for j, (t, f) in enumerate(zip(tasks, futures)):
            if j == skip:
                continue
            f.cancel()  # queued-but-unstarted siblings never run
            t.cancelled = True
            t.kill_attempts("sibling_failed")

    def _run_sequential(self, spec: TaskSpec) -> Any:
        """conf.enable_supervisor=False: the inline path (plus the
        breaker and deadline clamps, which cost one lookup each)."""
        from blaze_tpu_torch.runtime.executor import run_task_with_resilience

        ctx = ExecContext(partition=spec.partition,
                          num_partitions=spec.num_partitions,
                          device=self.device)

        def attempt():
            # same per-attempt breaker check as the supervised path
            if (spec.fallback_fn is not None
                    and self.breaker.should_reroute(spec.op_kinds)):
                self._note("breaker_reroutes")
                return spec.fallback_fn()
            return spec.attempt_fn(ctx)

        # sequential path runs on the driver thread: only task_id needs
        # pushing, the query/stage ids are already on this thread's stack
        with trace.context(task_id=spec.what):
            started = time.monotonic()
            _active_delta(1)
            try:
                value = run_task_with_resilience(
                    attempt, what=spec.what,
                    run_info=self.run_info, fallback=spec.fallback_fn,
                    ctx=ctx, deadline=self.deadline(),
                    on_error=self.breaker.note_failure,
                    session=self.session)
            finally:
                _active_delta(-1)
            trace.record_value("task_latency_us",
                               int((time.monotonic() - started) * 1e6))
            return value

    def close(self) -> None:
        """Kill every live attempt, stop the watchdog, drain the pool.
        Safe to call twice; called from the runner's finally."""
        if self._closed.is_set():
            return
        self._closed.set()
        with self._lock:
            tasks = list(self._tasks)
            pool = self._pool
            spec_threads = list(self._spec_threads)
            watchdog = self._watchdog
        for task in tasks:
            task.cancelled = True
            task.kill_attempts("shutdown")
        if pool is not None:
            # after an abandon the stuck thread may never exit; don't
            # let close() inherit its hang
            try:
                pool.shutdown(wait=not self._abandoned,
                              cancel_futures=True)
            except TypeError:  # pragma: no cover — pre-3.9 signature
                pool.shutdown(wait=not self._abandoned)
        for t in spec_threads:
            t.join(timeout=1.0)
        if watchdog is not None:
            watchdog.join(timeout=1.0)
