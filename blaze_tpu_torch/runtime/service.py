"""Multi-tenant query service: admission control, per-tenant quotas,
fair scheduling, and overload shedding.

Port of blaze_tpu/runtime/service.py whole. Its sessions run the port's
run_plan, so `run`/`submit` pass `device=` through (None: the CUDA
card; the tests pass "cpu"). On the card two sessions' kernels queue on
the device's default stream, one after another, and share the caching
allocator. A sticky CUDA error poisons the process's context, so
faults.classify calls it fatal and every session then fails: unlike the
per-query breaker, the card is not isolated between sessions. Each
session's run_info counts its own kernel launches and host pulls
(run_plan's per-query metrics.task_tally).

The single-query driver (spark/local_runner.run_plan) assumes it owns
the process: one Supervisor pool, one global memory budget, one breaker.
`QueryService` turns that driver into a shared service — concurrent
query sessions tagged with a tenant id and priority, with the engine's
existing resilience machinery scoped per query instead of per process:

  admission    a bounded waiting room in front of the run slots
               (conf.max_concurrent_queries running,
               conf.admission_queue_depth parked). A query that arrives
               when every slot is busy PARKS; once the queue is full the
               service load-sheds by REJECTING new arrivals with a typed
               `faults.AdmissionRejected` instead of letting them pile
               up. The absolute query deadline is stamped at ARRIVAL, so
               time spent parked counts against conf.query_deadline_ms —
               a query whose budget expires while parked is shed, not
               started doomed.

  quotas       `MemManager.set_tenant_quotas(conf.tenant_quota_spec)`
               carves per-tenant ceilings out of the shared budget; a
               tenant over its ceiling spills its OWN consumers first
               (memory.py), so one tenant's spill pressure cannot evict
               another's working set.

  fairness     every admitted query submits its TaskSpecs to one shared
               `supervisor.FairScheduler` (stride scheduling across
               session queues, weighted by conf.tenant_priority_spec)
               instead of a private FIFO pool — under contention a
               weight-3 tenant gets ~3x the dispatch share of a
               weight-1 tenant, and no session starves.

  isolation    the breaker stays per-Supervisor (= per query), resource
               ids are namespaced by query id (spark/stages.py), and
               monitor/history attribute by the per-thread trace
               context — query A tripping its breaker or leaking a
               stream never reroutes or bills query B.

Every outcome lands in the run ledger (trace.export_run_ledger): an
admitted query's line carries `tenant_id`, `admission_outcome`
("admitted" | "parked") and `admission_wait_ms`; a shed query gets its
own line with outcome "rejected" — the ledger is the billing/SLO record
for all arrivals, not just the ones that ran.

Synchronous submission from N caller threads and async submission via
`submit()` futures are both supported; `run()` is submit + result.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import faults, memory, supervisor, trace

__all__ = ["QuerySession", "QueryService", "SloTracker", "stats",
           "slo_stats", "capacity"]


class QuerySession:
    """Identity + budgets for one query's lifetime inside the service.

    Duck-typed consumers (Supervisor, executor ladder, ops/common
    adaptive batching) read: `tenant_id`, `query_id`, `priority`,
    `deadline_at` (absolute monotonic, admission-stamped, or None),
    `scheduler` (the shared FairScheduler, or None), and `batch_target`
    (session-scoped ladder override of conf.target_batch_bytes; 0 = no
    override)."""

    __slots__ = ("tenant_id", "query_id", "priority", "deadline_at",
                 "scheduler", "batch_target", "arrived_at",
                 "admission_outcome", "admission_wait_ms")

    def __init__(self, tenant_id: str, priority: Optional[float] = None,
                 scheduler=None) -> None:
        self.tenant_id = tenant_id
        self.query_id = trace.new_query_id()
        if priority is None:
            priority = float(
                (conf.tenant_priority_spec or {}).get(tenant_id, 1.0))
        self.priority = max(float(priority), 1e-6)
        self.arrived_at = time.monotonic()
        self.deadline_at: Optional[float] = None
        if conf.query_deadline_ms and conf.query_deadline_ms > 0:
            self.deadline_at = (self.arrived_at
                                + conf.query_deadline_ms / 1000.0)
        self.scheduler = scheduler
        self.batch_target = 0
        self.admission_outcome = ""
        self.admission_wait_ms = 0.0


class SloTracker:
    """Rolling per-tenant latency-SLO attainment + burn rate.

    `conf.tenant_slo_spec` declares the objectives ({'tenant':
    {'latency_ms': 500, 'target': 0.99}}). Every arrival's TOTAL latency
    (admission wait + execution — the number the run ledger records as
    admission_wait_ms + duration_ms, so offline recomputation from
    ledger lines matches) is scored against the tenant's objective over
    a rolling window of conf.slo_window_queries arrivals; queries SHED
    at admission count as misses. Burn rate is miss_rate /
    error_budget: 1.0 burns the budget exactly at window turnover, 2.0
    burns it in half a window — past conf.slo_burn_alert_rate each
    observation emits a `slo_burn` trace event. monitor.prometheus_text
    exports the numbers as blaze_slo_* gauges via `slo_stats()`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._met: Dict[str, deque] = {}
        self._breaches: Dict[str, int] = {}

    @staticmethod
    def _spec(tenant_id: str) -> Optional[Dict[str, float]]:
        sp = (conf.tenant_slo_spec or {}).get(tenant_id)
        if not isinstance(sp, dict):
            return None
        obj = float(sp.get("latency_ms", 0) or 0)
        if obj <= 0:
            return None
        target = min(max(float(sp.get("target", 0.99)), 0.0), 1.0)
        return {"latency_ms": obj, "target": target}

    def observe(self, tenant_id: str, latency_ms: float,
                rejected: bool = False,
                query_id: Optional[str] = None) -> None:
        """Score one arrival; emits `slo_burn` when the budget runs hot."""
        sp = self._spec(tenant_id)
        if sp is None:
            return
        met = (not rejected) and latency_ms <= sp["latency_ms"]
        with self._lock:
            win = self._met.get(tenant_id)
            if win is None or win.maxlen != max(
                    int(conf.slo_window_queries), 1):
                win = deque(win or (),
                            maxlen=max(int(conf.slo_window_queries), 1))
                self._met[tenant_id] = win
            win.append(met)
            if not met:
                self._breaches[tenant_id] = \
                    self._breaches.get(tenant_id, 0) + 1
            stats = self._stats_locked(tenant_id, sp)
        if stats["burn_rate"] > max(float(conf.slo_burn_alert_rate), 0.0):
            trace.event("slo_burn", tenant_id=tenant_id,
                        latency_ms=round(latency_ms, 1),
                        objective_ms=sp["latency_ms"],
                        attainment=stats["attainment"],
                        burn_rate=stats["burn_rate"])
        # SLO-breach dossier (shed arrivals get their own "shed" dossier
        # in admit()). No locks held here: _release scores after leaving
        # the admission section, and capture does file I/O.
        if not met and not rejected and query_id and conf.flight_dir:
            from blaze_tpu_torch.runtime import flight_recorder

            flight_recorder.capture(
                "slo_breach", query_id, tenant_id=tenant_id,
                detail={"latency_ms": round(latency_ms, 3),
                        "objective_ms": sp["latency_ms"],
                        "attainment": stats["attainment"],
                        "burn_rate": stats["burn_rate"]})

    def _stats_locked(self, tenant_id: str,
                      sp: Dict[str, float]) -> Dict[str, Any]:
        win = self._met.get(tenant_id) or ()
        n = len(win)
        attainment = (sum(1 for m in win if m) / n) if n else 1.0
        budget = 1.0 - sp["target"]
        miss = 1.0 - attainment
        if budget > 0:
            burn = miss / budget
        else:
            burn = 0.0 if miss <= 0 else float(n)  # target=1.0: any miss
        return {"latency_ms": sp["latency_ms"], "target": sp["target"],
                "window": n, "attainment": round(attainment, 4),
                "burn_rate": round(burn, 4),
                "breaches": self._breaches.get(tenant_id, 0)}

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant SLO readout for every tenant in the spec (tenants
        with no observations yet report attainment 1.0 / burn 0.0 — the
        gauges exist from the first scrape, mid-query included)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            tenants = set(self._met) | set(conf.tenant_slo_spec or {})
            for t in sorted(tenants):
                sp = self._spec(t)
                if sp is not None:
                    out[t] = self._stats_locked(t, sp)
        return out

    def reset(self) -> None:
        with self._lock:
            self._met.clear()
            self._breaches.clear()


class QueryService:
    """Shared driver accepting concurrent query sessions.

    Use as a context manager (or start()/close()). `run(root, tenant_id,
    ...)` admits, executes, and returns the result batch; `submit(...)`
    does the same asynchronously on a per-query driver thread and
    returns a Future. Both raise `faults.AdmissionRejected` when the
    query is shed (queue full, or deadline expired while parked)."""

    def __init__(self, max_concurrent: Optional[int] = None,
                 queue_depth: Optional[int] = None) -> None:
        self.max_concurrent = max(1, int(
            max_concurrent if max_concurrent is not None
            else conf.max_concurrent_queries))
        self.queue_depth = max(0, int(
            queue_depth if queue_depth is not None
            else conf.admission_queue_depth))
        self._lock = threading.Lock()
        self._slot_free = threading.Condition(self._lock)
        self._running = 0
        self._parked = 0
        self._admitted_total = 0
        self._parked_total = 0
        self._rejected_total = 0
        self._threads: List[threading.Thread] = []
        self.scheduler: Optional[supervisor.FairScheduler] = None
        self._open = False
        self._pool = None  # attached executor pool (capacity source)
        self._streams: List[Any] = []  # long-lived StreamingQuery sessions

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "QueryService":
        global _active
        # driver-crash recovery before the first admission: incomplete
        # journals from a killed predecessor are replayed (verified
        # stage commits harvested for reuse, the rest billed failed)
        from blaze_tpu_torch.runtime import journal

        journal.ensure_recovery_scan()
        self.scheduler = supervisor.FairScheduler(
            max(1, int(conf.max_concurrent_tasks)))
        memory.get_manager().set_tenant_quotas(conf.tenant_quota_spec)
        with self._lock:
            self._open = True
        _active = self
        # a process-isolated pool that is already active becomes the
        # capacity source automatically (graceful-degradation contract)
        from blaze_tpu_torch.runtime import executor_pool

        pool = executor_pool.active()
        if pool is not None:
            self.attach_pool(pool)
        return self

    def attach_pool(self, pool) -> None:
        """Derive admission capacity from an executor pool: capacity =
        live_executors x slots, recomputed on every membership change
        (death or rejoin). A shrink does not kill running queries — it
        parks new arrivals until a seat rejoins or their deadline sheds
        them; capacity 0 parks everything (and /healthz goes 503)."""
        # plain attribute store: capacity() reads _pool from admission
        # waits that already hold the slot condition — no extra lock
        self._pool = pool
        pool.on_membership(self._on_pool_change)
        self._on_pool_change(pool)

    def _on_pool_change(self, pool) -> None:
        cap = pool.capacity()
        trace.event("capacity_changed", capacity=cap,
                    live_executors=pool.live_count(), slots=pool.slots)
        with self._slot_free:
            # capacity may have GROWN (rejoin): wake the waiting room
            self._slot_free.notify_all()

    def capacity(self) -> int:
        pool = self._pool
        if pool is not None:
            return pool.capacity()
        return self.max_concurrent

    def close(self) -> None:
        global _active
        # detach live streams FIRST (their micro-batches run through
        # admission): non-graceful stop — a service shutdown must not
        # settle a stream's journal, the stream stays adoptable by the
        # next driver (streaming.resume_stream)
        with self._lock:
            streams = list(self._streams)
            self._streams = []
        for sq in streams:
            try:
                sq.stop(graceful=False)
            except Exception:  # noqa: BLE001 — close() must not raise
                pass
        with self._lock:
            self._open = False
            self._slot_free.notify_all()
            drivers = list(self._threads)
        for t in drivers:
            t.join(timeout=30.0)
        if self.scheduler is not None:
            self.scheduler.close()
        memory.get_manager().set_tenant_quotas(None)
        if _active is self:
            _active = None

    def __enter__(self) -> "QueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission ---------------------------------------------------------

    def _shed_locked(self, session: QuerySession, reason: str,
                     wait_ms: float) -> None:
        """Reject (caller holds self._lock): count, trace, write the
        ledger line — shed queries are billed too — raise the typed
        error."""
        self._rejected_total += 1
        session.admission_outcome = "rejected"
        session.admission_wait_ms = wait_ms
        trace.event("admission_rejected", query_id=session.query_id,
                    tenant_id=session.tenant_id, reason=reason,
                    wait_ms=round(wait_ms, 1))
        self._export_shed_ledger(session, reason)
        _slo.observe(session.tenant_id, wait_ms, rejected=True,
                     query_id=session.query_id)
        raise faults.AdmissionRejected(
            f"query {session.query_id} (tenant {session.tenant_id!r}) "
            f"shed at admission: {reason} "
            f"(waited {wait_ms:.0f}ms)",
            tenant_id=session.tenant_id, wait_ms=wait_ms)

    def _export_shed_ledger(self, session: QuerySession,
                            reason: str) -> None:
        d = conf.trace_export_dir
        if not (conf.trace_enabled and d):
            return
        info = {"tenant_id": session.tenant_id,
                "admission_outcome": "rejected",
                "admission_wait_ms": round(session.admission_wait_ms, 1),
                "admission_reject_reason": reason}
        rec = trace.build_run_record(session.query_id, info)
        trace.export_run_ledger(os.path.join(d, "ledger.jsonl"), rec)

    def admit(self, tenant_id: str,
              priority: Optional[float] = None) -> QuerySession:
        """Block until the session holds a run slot (or shed it).

        Immediate admit when a slot is free; PARK while the bounded
        queue has room, waking on slot release; REJECT when the queue is
        full or the parked session's deadline expires. The returned
        session owns a slot — `_release` it exactly once (run/submit do
        this internally)."""
        session = QuerySession(tenant_id, priority, self.scheduler)
        try:
            return self._admit_inner(session)
        except faults.AdmissionRejected as e:
            # shed dossier AFTER the admission lock is released (capture
            # does file I/O; _shed_locked runs holding self._lock)
            if conf.flight_dir:
                from blaze_tpu_torch.runtime import flight_recorder

                flight_recorder.capture(
                    "shed", session.query_id, error=e,
                    tenant_id=session.tenant_id,
                    run_info={
                        "tenant_id": session.tenant_id,
                        "admission_outcome": "rejected",
                        "admission_wait_ms":
                            round(session.admission_wait_ms, 1)})
            raise

    def _admit_inner(self, session: QuerySession) -> QuerySession:
        parked = False
        with self._slot_free:
            if not self._open:
                raise RuntimeError("QueryService is closed")
            if self._running >= self.capacity():
                if self._parked >= self.queue_depth:
                    self._shed_locked(session, "queue_full", 0.0)
                parked = True
                self._parked += 1
                self._parked_total += 1
                trace.event("admission_parked", query_id=session.query_id,
                            tenant_id=session.tenant_id,
                            queue_depth=self._parked)
                try:
                    # capacity() is re-read every wake: an executor death
                    # shrinks it mid-wait (stay parked), a rejoin grows
                    # it (admit)
                    while self._open and self._running >= self.capacity():
                        timeout = None
                        if session.deadline_at is not None:
                            timeout = session.deadline_at - time.monotonic()
                            if timeout <= 0:
                                break
                        self._slot_free.wait(timeout)
                finally:
                    self._parked -= 1
                wait_ms = (time.monotonic() - session.arrived_at) * 1000.0
                if not self._open:
                    raise RuntimeError("QueryService closed while parked")
                if self._running >= self.capacity():
                    # deadline expired in the waiting room — shed without
                    # starting a run that could only end in DeadlineError
                    self._shed_locked(session, "deadline_while_parked",
                                      wait_ms)
            self._running += 1
            self._admitted_total += 1
        wait_ms = (time.monotonic() - session.arrived_at) * 1000.0
        session.admission_outcome = "parked" if parked else "admitted"
        session.admission_wait_ms = wait_ms
        trace.event("admission_admitted", query_id=session.query_id,
                    tenant_id=session.tenant_id,
                    wait_ms=round(wait_ms, 1), parked=parked)
        return session

    def _release(self, session: QuerySession) -> None:
        if self.scheduler is not None:
            self.scheduler.forget(session)
        # total latency since ARRIVAL: admission wait + execution — the
        # same number the ledger line decomposes, scored once per admit
        _slo.observe(session.tenant_id,
                     (time.monotonic() - session.arrived_at) * 1000.0,
                     query_id=session.query_id)
        with self._slot_free:
            self._running -= 1
            self._slot_free.notify_all()

    # -- execution ---------------------------------------------------------

    def run(self, root, tenant_id: str = "", *,
            priority: Optional[float] = None,
            run_info: Optional[Dict[str, Any]] = None,
            conf_pins: Optional[Dict[str, Any]] = None,
            **run_plan_kwargs):
        """Admit + execute on the CALLING thread; returns the result
        batch. Raises faults.AdmissionRejected when shed.

        conf_pins: per-query knob overrides — the highest-precedence
        overlay layer (base -> tenant -> autopilot fingerprint -> pin),
        validated against the Knob registry at resolution."""
        from blaze_tpu_torch.spark import local_runner

        session = self.admit(tenant_id, priority)
        if run_info is None:
            run_info = {}
        run_info["tenant_id"] = session.tenant_id
        run_info["admission_outcome"] = session.admission_outcome
        run_info["admission_wait_ms"] = round(session.admission_wait_ms, 1)
        if conf_pins:
            run_info["conf_pins"] = dict(conf_pins)
        try:
            return local_runner.run_plan(root, run_info=run_info,
                                         session=session,
                                         **run_plan_kwargs)
        finally:
            self._release(session)

    def submit(self, root, tenant_id: str = "", *,
               priority: Optional[float] = None,
               run_info: Optional[Dict[str, Any]] = None,
               conf_pins: Optional[Dict[str, Any]] = None,
               **run_plan_kwargs) -> Future:
        """Admit on the calling thread (so AdmissionRejected raises
        HERE, synchronously — shedding must push back on the submitter),
        then execute on a per-query driver thread; returns a Future.
        conf_pins: as in run() — the per-query overlay layer."""
        from blaze_tpu_torch.spark import local_runner

        session = self.admit(tenant_id, priority)
        if run_info is None:
            run_info = {}
        run_info["tenant_id"] = session.tenant_id
        run_info["admission_outcome"] = session.admission_outcome
        run_info["admission_wait_ms"] = round(session.admission_wait_ms, 1)
        if conf_pins:
            run_info["conf_pins"] = dict(conf_pins)
        fut: Future = Future()

        def drive() -> None:
            if not fut.set_running_or_notify_cancel():
                self._release(session)
                return
            try:
                fut.set_result(local_runner.run_plan(
                    root, run_info=run_info, session=session,
                    **run_plan_kwargs))
            except BaseException as e:  # noqa: BLE001 — relay via future
                fut.set_exception(e)
            finally:
                self._release(session)

        t = threading.Thread(target=drive,
                             name=f"blz-query-{session.query_id}",
                             daemon=True)
        with self._lock:
            # bounded bookkeeping: drop finished driver threads
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
        return fut

    # -- streaming sessions ------------------------------------------------

    def open_stream(self, source, spec, tenant_id: str = "", *,
                    stream_id: Optional[str] = None, **kwargs: Any):
        """Open a long-lived streaming session (runtime/streaming.py)
        bound to this service: every micro-batch is admitted like any
        other query — the tenant's priority weight, quota, fairness
        share and per-batch SLO scoring all apply — so a stream cannot
        starve batch tenants, and admission pressure shows up as stream
        lag rather than unbounded queueing. Returns the started
        StreamingQuery."""
        from blaze_tpu_torch.runtime import streaming

        with self._lock:
            if not self._open:
                raise RuntimeError("QueryService is closed")
        sq = streaming.open_stream(source, spec, stream_id=stream_id,
                                   tenant_id=tenant_id, service=self,
                                   **kwargs)
        with self._lock:
            self._streams = [s for s in self._streams if s.alive()]
            self._streams.append(sq)
        return sq

    def resume_stream(self, stream_id: str, **kwargs: Any):
        """Adopt a dead driver's stream (journal checkpoints) into this
        service — the standby-takeover path."""
        from blaze_tpu_torch.runtime import streaming

        sq = streaming.resume_stream(stream_id, service=self, **kwargs)
        with self._lock:
            self._streams.append(sq)
        return sq

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        cap = self.capacity()
        with self._lock:
            return {
                "running": self._running,
                "queue_depth": self._parked,
                "admitted": self._admitted_total,
                "parked": self._parked_total,
                "rejected": self._rejected_total,
                "capacity": cap,
                "streams": sum(1 for s in self._streams if s.alive()),
            }


_active: Optional[QueryService] = None


def active() -> Optional[QueryService]:
    return _active


def stats() -> Dict[str, int]:
    """Admission stats of the active service; all-zero when none is
    running (monitor.py imports this unconditionally for the Prometheus
    gauges and blaze_top rows)."""
    svc = _active
    if svc is None:
        return {"running": 0, "queue_depth": 0, "admitted": 0,
                "parked": 0, "rejected": 0, "capacity": capacity()}
    return svc.stats()


def capacity() -> int:
    """Current admission capacity: the active service's (pool-derived
    when one is attached), else the active pool's, else the static
    conf.max_concurrent_queries."""
    svc = _active
    if svc is not None:
        return svc.capacity()
    from blaze_tpu_torch.runtime import executor_pool

    pool = executor_pool.active()
    if pool is not None:
        return pool.capacity()
    return max(1, int(conf.max_concurrent_queries))


# SLO state is process-wide, not per-QueryService: objectives describe
# tenants, and tenants outlive service restarts within one process.
_slo = SloTracker()


def slo_stats() -> Dict[str, Dict[str, Any]]:
    """Per-tenant SLO attainment/burn for monitor.prometheus_text and
    blaze_top; one entry per tenant in conf.tenant_slo_spec."""
    return _slo.stats()


def reset_slo() -> None:
    """Drop all SLO windows/breach totals (tests)."""
    _slo.reset()
