"""Resource accounting + live metrics service.

Port of blaze_tpu/runtime/monitor.py whole: the byte and time accounting
with per-query and per-stage attribution, the zero-copy event counters,
the per-query roll-up merged into run_info, the always-on leak check,
the background sampler and the exporters.

  accounting  `count_copy(boundary, nbytes, moved=...)` — called from
              the five copy boundaries of the engine:
                serde     frame encode/decode in columnar/serde.py
                          (copied = raw payload bytes built/rebuilt,
                          moved = compressed frame bytes crossing)
                ffi       device<->host transfers (serde.to_host pull,
                          host_sort.host_to_device upload)
                shuffle   partition-split frames pushed into the map
                          writer's buffers or an RSS writer (ops/shuffle.py)
                spill     SpillFile write + re-read (runtime/memory.py)
                fallback  row-interpreter Arrow export (spark/fallback.py)
              Counts accumulate process-wide AND per query/stage: the
              query id comes from the trace context (the runner pushes it
              whether or not tracing is on, and the supervisor replays it
              on pool threads), else from the runner-registered active
              query. Disabled (conf.monitor_enabled=False) every call is
              one truthiness check at the call site.

  time        `count_time(category, ns)` — host wall time of the
              TIME_CATEGORIES (serde encode/decode, shuffle commit, spill
              I/O, operator dispatch, retry backoff), the same
              attribution. On the card a dispatch's time is its host
              time: kernels launch asynchronously.

  leak check  finish_query() — always on (independent of
              monitor_enabled): live pipeline streams, pipeline
              reservations, or nonzero MemManager consumers at query end
              emit a `resource_leak` trace event and count in run_info.

  federation  the executor-side ship: a worker process drains its
              per-query deltas (drain_remote_deltas) and zero-copy deltas
              (drain_zerocopy) into telemetry frames, and the driver folds
              them into its totals and live roll-ups (merge_remote,
              merge_zerocopy), as runtime/executor_pool.py does.

The sampler and exporters are the JAX module's: ResourceMonitor (the
gauge ring, started with the endpoint), prometheus_text(), health_snapshot()
and MetricsServer on conf.metrics_port (GET /metrics, /healthz, /queries),
which read the service, the executor pool, the autoscaler, the standby,
the autopilot and the streams at call time. `begin_query` starts the
sampling profiler (runtime/profiler.py) under conf.profile_enabled, as the
JAX module's does. The port has no compile service: the roll-up has no
compile_* keys, and the sampler's compile_* gauges and the blaze_compile_*
series read 0, as the JAX module's do before its first compile.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import trace

BOUNDARIES = ("serde", "ffi", "shuffle", "spill", "fallback")

# boundary-time categories: each lands in run_info as "<category>_ms" and
# on stage spans. sched_queue is the service's dispatch wait
# (supervisor.FairScheduler).
TIME_CATEGORIES = ("sched_queue", "serde_encode", "serde_decode",
                   "shuffle_io", "spill", "device_compute",
                   "host_compute", "retry_backoff")

# event counters of the zero-copy data plane: how often the cheap path
# ran (byte volumes live in the "shuffle" boundary)
ZEROCOPY_KEYS = ("shuffle_mmap_hits", "shuffle_mmap_fallbacks",
                 "dict_cols_encoded")

_lock = threading.Lock()
_copied: Dict[str, int] = {b: 0 for b in BOUNDARIES}
_moved: Dict[str, int] = {b: 0 for b in BOUNDARIES}
_zerocopy: Dict[str, int] = {k: 0 for k in ZEROCOPY_KEYS}
# executor-side ship watermark (drain ships disjoint deltas, like
# drain_remote_deltas does for the per-query accumulators)
_zerocopy_shipped: Dict[str, int] = {k: 0 for k in ZEROCOPY_KEYS}
_leaks_total = 0
# runner-registered active query: the attribution fallback for a thread
# with no query in its trace context
_active_qid: Optional[str] = None
_queries: Dict[str, "_QueryAcct"] = {}


class _QueryAcct:
    """Per-query accumulator (popped at query_end into the roll-up)."""

    __slots__ = ("qid", "copied", "moved", "stage_copied", "stage_moved",
                 "t0", "spilled0", "spill_count0", "time_ns",
                 "stage_time_ns", "zc0")

    def __init__(self, qid: str) -> None:
        self.qid = qid
        self.copied: Dict[str, int] = {}
        self.moved: Dict[str, int] = {}
        self.stage_copied: Dict[Any, int] = {}
        self.stage_moved: Dict[Any, int] = {}
        self.t0 = time.time()
        self.spilled0 = 0
        self.spill_count0 = 0
        # wall ns per time category, query-level and per stage
        self.time_ns: Dict[str, int] = {}
        self.stage_time_ns: Dict[Any, Dict[str, int]] = {}
        # zero-copy watermark: query_end reports the delta (a lock-free
        # snapshot: constructors run with and without _lock held)
        self.zc0 = {k: _zerocopy.get(k, 0) for k in ZEROCOPY_KEYS}


# -- copy/byte accounting ----------------------------------------------------


def count_copy(boundary: str, nbytes: int, moved: Optional[int] = None
               ) -> None:
    """Account one copy at `boundary`: `nbytes` bytes duplicated
    (bytes_copied), `moved` bytes crossing the boundary (bytes_moved,
    defaults to nbytes). Call sites gate on conf.monitor_enabled so the
    disabled hot path pays one truthiness check."""
    if not conf.monitor_enabled:
        return
    n = int(nbytes)
    m = n if moved is None else int(moved)
    if n <= 0 and m <= 0:
        return
    ctx = trace.current_context()
    sid = ctx.get("stage_id")
    with _lock:
        _copied[boundary] = _copied.get(boundary, 0) + n
        _moved[boundary] = _moved.get(boundary, 0) + m
        qid = ctx.get("query_id") or _active_qid
        q = _queries.get(qid) if qid else None
        if q is not None:
            q.copied[boundary] = q.copied.get(boundary, 0) + n
            q.moved[boundary] = q.moved.get(boundary, 0) + m
            if sid is not None:
                q.stage_copied[sid] = q.stage_copied.get(sid, 0) + n
                q.stage_moved[sid] = q.stage_moved.get(sid, 0) + m


def count_time(category: str, ns: int, qid: Optional[str] = None,
               sid: Optional[Any] = None) -> None:
    """Account `ns` wall nanoseconds of `category` work against the
    attributed query/stage: the time-domain twin of count_copy.
    Attribution follows count_copy (trace context, then the active
    query) unless qid/sid are passed. Call sites gate on
    conf.monitor_enabled."""
    if not conf.monitor_enabled:
        return
    n = int(ns)
    if n <= 0:
        return
    if qid is None or sid is None:
        ctx = trace.current_context()
        if qid is None:
            qid = ctx.get("query_id")
        if sid is None:
            sid = ctx.get("stage_id")
    with _lock:
        qid = qid or _active_qid
        q = _queries.get(qid) if qid else None
        if q is None:
            return
        q.time_ns[category] = q.time_ns.get(category, 0) + n
        if sid is not None:
            st = q.stage_time_ns.setdefault(sid, {})
            st[category] = st.get(category, 0) + n


def count_move(boundary: str, nbytes: int) -> None:
    """Bytes that crossed `boundary` without a host-side duplication
    (bytes_moved only)."""
    count_copy(boundary, 0, moved=nbytes)


def copy_totals() -> Tuple[Dict[str, int], Dict[str, int]]:
    """(bytes_copied, bytes_moved) per boundary, process lifetime."""
    with _lock:
        return dict(_copied), dict(_moved)


# -- zero-copy event accounting ----------------------------------------------


def count_zerocopy(key: str, n: int = 1) -> None:
    """Count one zero-copy data-plane event: a same-host mmap shuffle
    fetch served without streaming ("shuffle_mmap_hits"), a mmap attempt
    that fell back to the socket ("shuffle_mmap_fallbacks"), or a string
    column shipped dictionary-encoded ("dict_cols_encoded"). Call sites
    gate on conf.monitor_enabled; self-gated too."""
    if not conf.monitor_enabled:
        return
    with _lock:
        _zerocopy[key] = _zerocopy.get(key, 0) + int(n)


def drain_zerocopy() -> Dict[str, int]:
    """Executor-side: zero-copy counter deltas since the last drain
    (empty when nothing new), shipped in telemetry frames next to the
    per-query deltas and folded in driver-side by merge_zerocopy."""
    out: Dict[str, int] = {}
    with _lock:
        for k in ZEROCOPY_KEYS:
            d = _zerocopy.get(k, 0) - _zerocopy_shipped.get(k, 0)
            if d:
                out[k] = d
                _zerocopy_shipped[k] = _zerocopy.get(k, 0)
    return out


def merge_zerocopy(deltas: Dict[str, int]) -> None:
    """Driver-side ingest of executor zero-copy deltas."""
    if not deltas or not conf.monitor_enabled:
        return
    with _lock:
        for k, n in deltas.items():
            _zerocopy[k] = _zerocopy.get(k, 0) + int(n)


def zerocopy_stats() -> Dict[str, int]:
    """Process-lifetime zero-copy event counters."""
    with _lock:
        return {k: _zerocopy.get(k, 0) for k in ZEROCOPY_KEYS}


def leaks_total() -> int:
    with _lock:
        return _leaks_total


def reset() -> None:
    """Clear counters + per-query state (test isolation)."""
    global _active_qid, _leaks_total
    with _lock:
        for d in (_copied, _moved, _zerocopy, _zerocopy_shipped):
            for k in d:
                d[k] = 0
        _queries.clear()
        _active_qid = None
        _leaks_total = 0
        _endpoint_requests.clear()


# -- per-query lifecycle -----------------------------------------------------


def begin_query(qid: str, manager=None) -> None:
    """Register `qid` as the active query (attribution fallback), reset
    the manager's peak-usage watermark, and snapshot the process
    counters the roll-up reports as deltas. Lazily starts the metrics
    endpoint + sampler when conf.metrics_port is set, and the sampling
    profiler when conf.profile_enabled is set."""
    global _active_qid
    if conf.metrics_port:
        ensure_started()
    if conf.profile_enabled:
        from blaze_tpu_torch.runtime import profiler

        profiler.ensure_started()
    if not conf.monitor_enabled:
        return
    acct = _QueryAcct(qid)
    if manager is not None:
        manager.reset_peak()
        acct.spilled0 = manager.spilled_bytes
        acct.spill_count0 = manager.spill_count
    with _lock:
        _queries[qid] = acct
        _active_qid = qid


def ensure_query(qid: str) -> None:
    """Executor-side registration: create the per-query accumulator for
    a driver-issued qid WITHOUT making it the active query or touching
    the manager. Worker processes never call begin_query (the driver
    owns the query lifecycle); they still need an accumulator so
    count_copy/count_time attribute pooled work, which then drains into
    telemetry ships (drain_remote_deltas) instead of a local
    query_end."""
    if not conf.monitor_enabled or not qid:
        return
    with _lock:
        if qid not in _queries:
            _queries[qid] = _QueryAcct(qid)


def drain_remote_deltas() -> Dict[str, Dict[str, Any]]:
    """Pop-and-return every query accumulator's counters as a JSON-safe
    delta doc {qid: {copied, moved, time_ns, stage_copied, stage_moved,
    stage_time_ns}}: the executor-side half of counter federation. The
    accumulators stay registered (a task may still be appending); only
    the counts move, so repeated drains ship disjoint deltas."""
    out: Dict[str, Dict[str, Any]] = {}
    with _lock:
        for qid, q in _queries.items():
            d: Dict[str, Any] = {}
            for field in ("copied", "moved", "time_ns",
                          "stage_copied", "stage_moved", "stage_time_ns"):
                vals = getattr(q, field)
                if vals:
                    d[field] = vals
                    setattr(q, field, {})
            if d:
                out[qid] = d
    return out


def _stage_key(k: Any) -> Any:
    """Stage ids are ints driver-side but stringify over the JSON wire;
    convert back so remote deltas merge into the same buckets."""
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def merge_remote(deltas: Dict[str, Dict[str, Any]]) -> None:
    """Driver-side ingest of executor counter deltas (telemetry frames
    and sidecar recovery): fold into the process-lifetime totals AND the
    per-query accumulators, so query_end roll-ups and stage span attrs
    see pooled work as they see in-process work. Deltas for a query
    already rolled up (a late or recovered ship after query_end) still
    land in the process totals."""
    if not deltas or not conf.monitor_enabled:
        return
    with _lock:
        for qid, d in deltas.items():
            copied = d.get("copied") or {}
            moved = d.get("moved") or {}
            for b, n in copied.items():
                _copied[b] = _copied.get(b, 0) + int(n)
            for b, n in moved.items():
                _moved[b] = _moved.get(b, 0) + int(n)
            q = _queries.get(qid)
            if q is None:
                continue
            for b, n in copied.items():
                q.copied[b] = q.copied.get(b, 0) + int(n)
            for b, n in moved.items():
                q.moved[b] = q.moved.get(b, 0) + int(n)
            for cat, n in (d.get("time_ns") or {}).items():
                q.time_ns[cat] = q.time_ns.get(cat, 0) + int(n)
            for sk, n in (d.get("stage_copied") or {}).items():
                k = _stage_key(sk)
                q.stage_copied[k] = q.stage_copied.get(k, 0) + int(n)
            for sk, n in (d.get("stage_moved") or {}).items():
                k = _stage_key(sk)
                q.stage_moved[k] = q.stage_moved.get(k, 0) + int(n)
            for sk, cats in (d.get("stage_time_ns") or {}).items():
                st = q.stage_time_ns.setdefault(_stage_key(sk), {})
                for cat, n in cats.items():
                    st[cat] = st.get(cat, 0) + int(n)


def query_end(qid: str, manager=None) -> Dict[str, Any]:
    """Pop `qid`'s accumulator; returns the flat roll-up merged into
    run_info: bytes_copied_/bytes_moved_<boundary> and their totals, the
    zero-copy deltas, peak_mem_bytes, spill_bytes, spill_count and one
    <category>_ms a time category seen."""
    global _active_qid
    with _lock:
        acct = _queries.pop(qid, None)
        if _active_qid == qid:
            _active_qid = None
    if acct is None:
        return {}
    roll: Dict[str, Any] = {}
    copied_total = moved_total = 0
    for b in BOUNDARIES:
        c = acct.copied.get(b, 0)
        m = acct.moved.get(b, 0)
        roll[f"bytes_copied_{b}"] = c
        roll[f"bytes_moved_{b}"] = m
        copied_total += c
        moved_total += m
    roll["bytes_copied_total"] = copied_total
    roll["bytes_moved_total"] = moved_total
    # zero-copy deltas over the query's lifetime: process-global counters
    # diffed against the begin_query watermark, so concurrent queries
    # share them (attribution, not an exact ledger)
    with _lock:
        zc_now = {k: _zerocopy.get(k, 0) for k in ZEROCOPY_KEYS}
    for k in ZEROCOPY_KEYS:
        roll[k] = max(zc_now.get(k, 0) - acct.zc0.get(k, 0), 0)
    if manager is not None:
        roll["peak_mem_bytes"] = max(manager.observe_peak(),
                                     manager.peak_used)
        roll["spill_bytes"] = manager.spilled_bytes - acct.spilled0
        roll["spill_count"] = manager.spill_count - acct.spill_count0
    for cat, ns in acct.time_ns.items():
        roll[f"{cat}_ms"] = round(ns / 1e6, 3)
    return roll


def stage_span_attrs(qid: str, stage_id) -> Dict[str, Any]:
    """{moved_bytes, copied_bytes} plus any per-stage `<category>_ms`
    accumulated for one stage so far: the local runner stamps them onto
    the stage span before it closes. {} when unattributed."""
    with _lock:
        q = _queries.get(qid)
        if q is None:
            return {}
        m = q.stage_moved.get(stage_id, 0)
        c = q.stage_copied.get(stage_id, 0)
        times = dict(q.stage_time_ns.get(stage_id, ()))
    out: Dict[str, Any] = {}
    if m or c:
        out = {"moved_bytes": m, "copied_bytes": c}
    for cat in sorted(times):
        out[f"{cat}_ms"] = round(times[cat] / 1e6, 3)
    return out


def finish_query(qid: str, run_info: Dict[str, Any], manager=None) -> None:
    """Query-end hook: merge the roll-up into run_info and run the
    always-on leak check (independent of conf.monitor_enabled): live
    pipeline streams, pipeline reservations, or nonzero MemManager
    consumers at query end are a `resource_leak` trace event and
    run_info's "resource_leaks"."""
    global _leaks_total
    if conf.monitor_enabled:
        run_info.update(query_end(qid, manager))
    leaks: List[str] = []
    live = run_info.get("pipeline_live_streams", 0)
    if live:
        leaks.append(f"pipeline_live_streams={live}")
    if manager is not None:
        if manager.pipeline_reserved:
            leaks.append(
                f"pipeline_reserved={manager.pipeline_reserved}")
        held = [(c.name, c.mem_used())
                for c in manager._consumers_snapshot() if c.mem_used() > 0]
        if held:
            leaks.append("consumers=" + ",".join(
                f"{name}:{used}" for name, used in held))
    run_info["resource_leaks"] = len(leaks)
    if leaks:
        with _lock:
            _leaks_total += len(leaks)
        trace.event("resource_leak", query_id=qid, leaks="; ".join(leaks))


def running_queries() -> List[Dict[str, Any]]:
    """Live queries (id, seconds running, bytes so far)."""
    now = time.time()
    with _lock:
        return [{"query_id": q.qid,
                 "seconds": round(now - q.t0, 1),
                 "bytes_copied": sum(q.copied.values()),
                 "bytes_moved": sum(q.moved.values())}
                for q in _queries.values()]


def query_t0(qid: str) -> Optional[float]:
    """Wall-clock start of a STILL-REGISTERED query (None after
    query_end pops it)."""
    with _lock:
        q = _queries.get(qid)
        return q.t0 if q is not None else None


def query_time_breakdown(qid: str) -> Dict[str, float]:
    """Wall ms per time category accumulated SO FAR for one running
    query; {} when unregistered or the monitor is disabled."""
    with _lock:
        q = _queries.get(qid)
        if q is None:
            return {}
        return {cat: round(ns / 1e6, 3)
                for cat, ns in sorted(q.time_ns.items())}


# The compile service (the JAX module's XLA compile cache) is not ported:
# its counters read 0 here, what the JAX module's read before its first
# compile (the sampler's compile_* gauges, the blaze_compile_* series).
_COMPILE_COUNTERS = ("compile_count", "compile_ns", "cache_hits",
                     "cache_misses", "canonicalization_waste_rows",
                     "stage_attempts", "stage_compiled",
                     "whole_stage_coverage_pct")


def _compile_snapshot() -> Dict[str, int]:
    return dict.fromkeys(_COMPILE_COUNTERS, 0)


class ResourceMonitor:
    """Background sampler recording engine gauges into a bounded
    time-series ring (deque maxlen: oldest samples drop first). Explicit
    start()/stop(); sample_now() is callable without the thread (tests,
    blaze_top --once)."""

    def __init__(self, capacity: Optional[int] = None,
                 sample_ms: Optional[int] = None, manager=None) -> None:
        self._cap = int(capacity or conf.monitor_ring_samples)
        self._sample_ms = sample_ms
        self._manager = manager
        self._ring: deque = deque(maxlen=max(self._cap, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_now(self) -> Dict[str, Any]:
        from blaze_tpu_torch.runtime import faults, memory, pipeline, supervisor

        mgr = self._manager or memory.get_manager()
        used = mgr.observe_peak()
        depths = pipeline.queue_depths()
        comp = _compile_snapshot()
        copied, moved = copy_totals()
        s = {
            "ts": time.time(),
            "mem_used": used,
            "mem_total": mgr.total,
            "mem_peak": mgr.peak_used,
            "pipeline_reserved": mgr.pipeline_reserved,
            "spill_pages": mgr.spill_pages_pending(),
            "host_spill_bytes": mgr.host_spill_bytes,
            "spilled_bytes": mgr.spilled_bytes,
            "pipeline_live_streams": pipeline.live_streams(),
            "pipeline_queue_depth": sum(depths),
            "pipeline_queue_streams": len(depths),
            "supervisor_active_tasks": supervisor.active_tasks(),
            "io_pool_width": max(1, int(conf.io_threads)),
            "task_pool_width": max(1, int(conf.max_concurrent_tasks)),
            "queries_running": len(running_queries()),
            "bytes_copied": sum(copied.values()),
            "bytes_moved": sum(moved.values()),
            "compile_cache_hits": comp.get("cache_hits", 0),
            "compile_cache_misses": comp.get("cache_misses", 0),
            "compile_ms": round(comp.get("compile_ns", 0) / 1e6),
            "breaker_trips": faults.TELEMETRY.snapshot().get(
                "breaker.trips", 0),
        }
        from blaze_tpu_torch.runtime import service

        st = service.stats()
        s["admission_queue_depth"] = st["queue_depth"]
        s["admission_parked"] = st["parked"]
        s["admission_rejected"] = st["rejected"]
        from blaze_tpu_torch.runtime import executor_pool

        ps = executor_pool.pool_stats()
        if ps is not None:
            s["executors_live"] = ps["live"]
            s["executor_capacity"] = ps["capacity"]
            s["executor_deaths"] = ps["deaths_total"]
            s["executor_restarts"] = ps["restarts_total"]
        self._ring.append(s)
        return s

    def ring(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def ring_since(self, since_ts: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
        """Samples with ts >= since_ts (whole ring when None) — the
        "gauges over the query's lifetime" slice dossiers embed."""
        ring = list(self._ring)
        if since_ts is None:
            return ring
        return [s for s in ring if s.get("ts", 0) >= since_ts]

    def start(self) -> "ResourceMonitor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="blz-monitor", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_now()
            except Exception:  # noqa: BLE001 — the sampler must never die
                pass
            ms = self._sample_ms
            if ms is None:
                ms = conf.monitor_sample_ms
            self._stop.wait(max(int(ms), 1) / 1000.0)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


# -- Prometheus exporter -----------------------------------------------------

# The scrape contract: every fixed sample family prometheus_text() emits,
# declared up front. Dashboards/alerts key on these names — renaming one is
# a breaking change, so tools/blazelint's registry-sync checker verifies
# each emit() literal appears here AND that each entry is still emitted
# (a stale registry row means a dashboard series silently went dark).
# Dynamic telemetry families (per-counter gauges minted from MetricsSet
# keys, histogram summaries) are constrained to GAUGE_PREFIXES instead.
GAUGE_NAMES = (
    "blaze_bytes_copied_total",
    "blaze_bytes_moved_total",
    "blaze_resource_leaks_total",
    "blaze_mem_used_bytes",
    "blaze_mem_budget_bytes",
    "blaze_mem_peak_bytes",
    "blaze_mem_pipeline_reserved_bytes",
    "blaze_spill_pages_bytes",
    "blaze_spilled_bytes_total",
    "blaze_spill_count_total",
    "blaze_trace_dropped_events_total",
    "blaze_trace_buffer_events",
    "blaze_trace_buffer_capacity",
    "blaze_monitor_ring_samples",
    "blaze_monitor_ring_capacity",
    "blaze_pipeline_live_streams",
    "blaze_pipeline_queue_depth",
    "blaze_supervisor_active_tasks",
    "blaze_queries_running",
    "blaze_admission_queue_depth",
    "blaze_admission_admitted_total",
    "blaze_admission_parked_total",
    "blaze_admission_rejected_total",
    "blaze_tenant_mem_used_bytes",
    "blaze_slo_objective_ms",
    "blaze_slo_attainment",
    "blaze_slo_burn_rate",
    "blaze_slo_breaches_total",
    "blaze_flight_dossiers_total",
    "blaze_query_progress_ratio",
    "blaze_endpoint_requests_total",
    "blaze_executor_up",
    "blaze_executor_live",
    "blaze_executor_restarts_total",
    "blaze_executor_deaths_total",
    "blaze_executor_heartbeat_age_ms",
    "blaze_executor_busy_slots",
    "blaze_executor_tasks_done_total",
    "blaze_executor_telemetry_bytes_total",
    "blaze_executor_draining",
    "blaze_executor_reconnects_total",
    "blaze_executor_drains_total",
    "blaze_shuffle_conn_dropped_total",
    "blaze_shuffle_mmap_hits_total",
    "blaze_shuffle_mmap_fallbacks_total",
    "blaze_dict_cols_encoded_total",
    "blaze_service_capacity",
    "blaze_artifact_corruptions_total",
    "blaze_recovered_queries_total",
    "blaze_autoscale_target_seats",
    "blaze_autoscale_decisions_total",
    "blaze_autopilot_overlays_active",
    "blaze_autopilot_promotions_total",
    "blaze_autopilot_rollbacks_total",
    "blaze_driver_role",
    "blaze_stream_lag_ms",
    "blaze_stream_batches_total",
    "blaze_stream_checkpoint_bytes",
    "blaze_profile_samples_total",
    "blaze_profile_remote_samples_total",
    "blaze_profile_recovered_samples_total",
    "blaze_profile_stacks",
    "blaze_profile_dropped_total",
    "blaze_profile_duty_pct",
    "blaze_profile_fleet_duty_pct",
)
GAUGE_PREFIXES = (
    "blaze_pipeline_",  # pipeline.TELEMETRY counters
    "blaze_faults_",    # faults.TELEMETRY counters
    "blaze_compile_",   # compile-service counters (all 0)
    "blaze_hist_",      # trace histogram summaries
)


def _prom_name(raw: str) -> str:
    """Sanitize to the metric-name grammar [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = [ch if (ch.isalnum() and ch.isascii()) or ch in "_:" else "_"
           for ch in raw]
    name = "".join(out) or "_"
    if name[0].isdigit():
        name = "_" + name
    return name


def _prom_escape(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def prometheus_text() -> str:
    """The whole registry in Prometheus text exposition format
    (# HELP/# TYPE headers, one sample per line, trailing newline)."""
    from blaze_tpu_torch.runtime import faults, memory, pipeline, supervisor

    lines: List[str] = []

    def emit(name, mtype, help_text, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lab = ""
            if labels:
                lab = "{" + ",".join(
                    f'{k}="{_prom_escape(v)}"'
                    for k, v in sorted(labels.items())) + "}"
            lines.append(f"{name}{lab} {value}")

    copied, moved = copy_totals()
    emit("blaze_bytes_copied_total", "counter",
         "Bytes duplicated at each copy boundary",
         [({"boundary": b}, copied.get(b, 0)) for b in BOUNDARIES])
    emit("blaze_bytes_moved_total", "counter",
         "Bytes crossing each copy boundary",
         [({"boundary": b}, moved.get(b, 0)) for b in BOUNDARIES])
    emit("blaze_resource_leaks_total", "counter",
         "Queries that ended with leaked streams/reservations/consumers",
         [({}, leaks_total())])

    zc = zerocopy_stats()
    emit("blaze_shuffle_mmap_hits_total", "counter",
         "Same-host shuffle fetches served as zero-copy mmap views",
         [({}, zc.get("shuffle_mmap_hits", 0))])
    emit("blaze_shuffle_mmap_fallbacks_total", "counter",
         "mmap shuffle fetch attempts that fell back to the socket path",
         [({}, zc.get("shuffle_mmap_fallbacks", 0))])
    emit("blaze_dict_cols_encoded_total", "counter",
         "String columns shipped dictionary-encoded in serde frames",
         [({}, zc.get("dict_cols_encoded", 0))])

    mgr = memory.get_manager()
    emit("blaze_mem_used_bytes", "gauge",
         "MemManager usage (consumers + spill pages + pipeline_reserved)",
         [({}, mgr.mem_used())])
    emit("blaze_mem_budget_bytes", "gauge", "MemManager budget",
         [({}, mgr.total)])
    emit("blaze_mem_peak_bytes", "gauge",
         "Peak MemManager usage since the last query began",
         [({}, mgr.peak_used)])
    emit("blaze_mem_pipeline_reserved_bytes", "gauge",
         "Bytes held by in-flight pipelined batches",
         [({}, mgr.pipeline_reserved)])
    emit("blaze_spill_pages_bytes", "gauge",
         "Spill-file pages buffered but not yet synced",
         [({}, mgr.spill_pages_pending())])
    emit("blaze_spilled_bytes_total", "counter",
         "Bytes freed by consumer spills", [({}, mgr.spilled_bytes)])
    emit("blaze_spill_count_total", "counter", "Consumer spill operations",
         [({}, mgr.spill_count)])

    # trace-ring health: a nonzero dropped counter means the bounded
    # ring overflowed and the exported traces are truncated — previously
    # visible only in the ledger, now scrapeable
    emit("blaze_trace_dropped_events_total", "counter",
         "Trace records dropped by the bounded ring (oldest-first)",
         [({}, trace.TRACE.dropped)])
    emit("blaze_trace_buffer_events", "gauge",
         "Records currently held in the trace ring",
         [({}, len(trace.TRACE))])
    emit("blaze_trace_buffer_capacity", "gauge",
         "Trace ring capacity (conf.trace_buffer_events)",
         [({}, int(conf.trace_buffer_events))])
    s = sampler()
    ring = s.ring() if s is not None else []
    emit("blaze_monitor_ring_samples", "gauge",
         "Samples held in the resource-monitor ring",
         [({}, len(ring))])
    emit("blaze_monitor_ring_capacity", "gauge",
         "Resource-monitor ring capacity (conf.monitor_ring_samples)",
         [({}, int(conf.monitor_ring_samples))])

    depths = pipeline.queue_depths()
    emit("blaze_pipeline_live_streams", "gauge",
         "Prefetch streams/sinks created but not yet finalized",
         [({}, pipeline.live_streams())])
    emit("blaze_pipeline_queue_depth", "gauge",
         "Items queued across live prefetch streams", [({}, sum(depths))])
    emit("blaze_supervisor_active_tasks", "gauge",
         "Task attempts currently executing", [({}, supervisor.active_tasks())])
    emit("blaze_queries_running", "gauge", "Queries currently executing",
         [({}, len(running_queries()))])

    # multi-tenant service (runtime/service.py): admission control +
    # per-tenant memory attribution. All-zero with no service running.
    from blaze_tpu_torch.runtime import service

    st = service.stats()
    emit("blaze_admission_queue_depth", "gauge",
         "Queries parked in the service admission queue",
         [({}, st["queue_depth"])])
    emit("blaze_admission_admitted_total", "counter",
         "Queries granted a run slot by admission control",
         [({}, st["admitted"])])
    emit("blaze_admission_parked_total", "counter",
         "Queries that waited in the admission queue before running",
         [({}, st["parked"])])
    emit("blaze_admission_rejected_total", "counter",
         "Queries load-shed at admission (queue full or deadline)",
         [({}, st["rejected"])])
    # finished tenants (zero bytes held) drop out of the exposition —
    # the {tenant=} cardinality tracks tenants with live usage, not
    # every tenant the process ever served
    emit("blaze_tenant_mem_used_bytes", "gauge",
         "MemManager bytes in use per tenant (consumers + pipeline; "
         "zero-usage tenants are pruned from the exposition)",
         [({"tenant": t}, v)
          for t, v in sorted(mgr.tenant_usage().items()) if v])

    # per-tenant SLO tracking (runtime/service.SloTracker over
    # conf.tenant_slo_spec): objective, rolling attainment, burn rate.
    # Present whenever a spec is configured — including mid-query.
    slo = service.slo_stats()
    emit("blaze_slo_objective_ms", "gauge",
         "Configured per-tenant latency objective (tenant_slo_spec)",
         [({"tenant": t}, s["latency_ms"])
          for t, s in sorted(slo.items())])
    emit("blaze_slo_attainment", "gauge",
         "Rolling share of arrivals meeting the tenant's objective",
         [({"tenant": t}, s["attainment"])
          for t, s in sorted(slo.items())])
    emit("blaze_slo_burn_rate", "gauge",
         "Error-budget burn rate (miss rate / allowed miss rate; "
         ">1 = budget burning hot)",
         [({"tenant": t}, s["burn_rate"])
          for t, s in sorted(slo.items())])
    emit("blaze_slo_breaches_total", "counter",
         "Arrivals that missed the tenant's latency objective",
         [({"tenant": t}, s["breaches"])
          for t, s in sorted(slo.items())])

    # process-isolated executor pool (runtime/executor_pool.py): per-seat
    # liveness, restart/death counters, and the degraded admission
    # capacity. Families stay present (empty) with no pool attached so
    # dashboards see a series disappear per-executor, never per-family.
    from blaze_tpu_torch.runtime import executor_pool

    ps = executor_pool.pool_stats()
    execs = (ps or {}).get("executors", ())
    emit("blaze_executor_up", "gauge",
         "Executor process liveness (1 = heartbeating, 0 = declared dead)",
         [({"exec_id": e["exec_id"]}, 1 if e["up"] else 0) for e in execs])
    # telemetry-federation pane (blaze_top's executor rows): heartbeat
    # freshness, occupancy, lifetime work and shipped-telemetry volume
    emit("blaze_executor_heartbeat_age_ms", "gauge",
         "Milliseconds since the executor's last control-socket frame",
         [({"exec_id": e["exec_id"]}, e.get("heartbeat_age_ms", 0))
          for e in execs])
    emit("blaze_executor_busy_slots", "gauge",
         "Tasks currently in flight on the executor",
         [({"exec_id": e["exec_id"]}, e.get("inflight", 0))
          for e in execs])
    emit("blaze_executor_tasks_done_total", "counter",
         "Tasks the executor completed successfully",
         [({"exec_id": e["exec_id"]}, e.get("tasks_done", 0))
          for e in execs])
    emit("blaze_executor_telemetry_bytes_total", "counter",
         "Telemetry payload bytes shipped by the executor (incl. "
         "sidecar-recovered)",
         [({"exec_id": e["exec_id"]}, e.get("telemetry_bytes", 0))
          for e in execs])
    # partition-tolerant control plane: draining seats (excluded from
    # capacity without a death) and per-seat control-session resumes
    emit("blaze_executor_draining", "gauge",
         "Executor is gracefully decommissioning (1 = drain mode)",
         [({"exec_id": e["exec_id"]}, 1 if e.get("draining") else 0)
          for e in execs])
    emit("blaze_executor_reconnects_total", "counter",
         "Control-session resumes after a transport blip, per seat",
         [({"exec_id": e["exec_id"]}, e.get("reconnects", 0))
          for e in execs])
    emit("blaze_executor_drains_total", "counter",
         "Executors gracefully decommissioned (drain completed)",
         [({}, ps.get("drains_total", 0))] if ps else [])
    emit("blaze_shuffle_conn_dropped_total", "counter",
         "Shuffle-server client connections dropped mid-request",
         [({}, ps.get("shuffle_conns_dropped", 0))] if ps else [])
    emit("blaze_executor_live", "gauge",
         "Live executor processes in the pool",
         [({}, ps["live"])] if ps else [])
    emit("blaze_executor_restarts_total", "counter",
         "Executor processes respawned after a death",
         [({}, ps["restarts_total"])] if ps else [])
    emit("blaze_executor_deaths_total", "counter",
         "Executor deaths declared (exit, heartbeat, send error)",
         [({}, ps["deaths_total"])] if ps else [])
    emit("blaze_service_capacity", "gauge",
         "Admission capacity (live_executors x slots when a pool is "
         "attached, else max_concurrent_queries)",
         [({}, service.capacity())])

    # incident capture + live introspection (flight_recorder/progress):
    # lazy imports — both modules import monitor at module level
    from blaze_tpu_torch.runtime import flight_recorder, progress

    emit("blaze_flight_dossiers_total", "counter",
         "Incident dossiers written by the flight recorder, by trigger",
         [({"trigger": t}, n)
          for t, n in sorted(flight_recorder.counts().items())])
    from blaze_tpu_torch.runtime import artifacts, journal

    emit("blaze_artifact_corruptions_total", "counter",
         "Corrupt artifacts detected on read paths (checksum mismatch)",
         [({}, artifacts.corruption_stats()["corruptions"])])
    emit("blaze_recovered_queries_total", "counter",
         "Queries that reused journaled stage commits after a driver "
         "restart",
         [({}, journal.recovered_queries_total())])

    # elastic fleet & driver HA (runtime/autoscaler.py, standby.py):
    # the policy's seat target + decision counters, and which role this
    # process holds — a standby scrapes role=standby until takeover
    from blaze_tpu_torch.runtime import autoscaler, standby

    asc = autoscaler.state()
    emit("blaze_autoscale_target_seats", "gauge",
         "Autoscaler's desired serving seat count (absent with the "
         "policy loop off)",
         [({}, asc["target_seats"])] if asc else [])
    emit("blaze_autoscale_decisions_total", "counter",
         "Autoscaler actuations, by direction",
         [({"direction": d}, n)
          for d, n in sorted((asc or {}).get("decisions", {}).items())])
    emit("blaze_driver_role", "gauge",
         "Driver role of this process (1 for the held role)",
         [({"role": standby.role()}, 1)])

    # self-tuning autopilot (runtime/autopilot.py): the folded
    # OverlayStore posture — fingerprints with a live overlay, lifetime
    # promotions, and rollbacks by knob (restart-persistent: the fold is
    # what a restarted driver resumes from, so the counters are too)
    from blaze_tpu_torch.runtime import autopilot

    apm = autopilot.metrics()
    emit("blaze_autopilot_overlays_active", "gauge",
         "Plan fingerprints with a settled or canary overlay (absent "
         "with the autopilot off)",
         [({}, apm["overlays_active"])] if apm else [])
    emit("blaze_autopilot_promotions_total", "counter",
         "Canary overlays promoted to settled",
         [({}, apm["promotions_total"])] if apm else [])
    emit("blaze_autopilot_rollbacks_total", "counter",
         "Canary overlays rolled back + quarantined, by knob",
         [({"knob": k}, n) for k, n in
          sorted((apm or {}).get("rollbacks_total", {}).items())])

    # durable streaming (runtime/streaming.py): one series per LIVE
    # stream — a stopped stream's series disappears from the exposition
    # (same bounded-cardinality posture as the progress ring)
    from blaze_tpu_torch.runtime import streaming

    ss = streaming.stream_stats()
    emit("blaze_stream_lag_ms", "gauge",
         "Per-stream end-to-end lag (age of the oldest unconsumed "
         "source file; 0 when caught up)",
         [({"qid": sid}, s["lag_ms"]) for sid, s in sorted(ss.items())])
    emit("blaze_stream_batches_total", "counter",
         "Micro-batches committed per stream (resumed batches included)",
         [({"qid": sid}, s["batches_total"])
          for sid, s in sorted(ss.items())])
    emit("blaze_stream_checkpoint_bytes", "gauge",
         "Serialized size of each stream's last durable checkpoint",
         [({"qid": sid}, s["checkpoint_bytes"])
          for sid, s in sorted(ss.items())])
    # bounded label cardinality: live queries plus the last-N finished
    # ring (progress.finished_queries) — older finished series age out of
    # the exposition instead of accumulating one {qid=} series per query
    # for the life of the endpoint
    emit("blaze_query_progress_ratio", "gauge",
         "Per-query progress ratio (0-1, monotone; finished queries "
         "linger in a bounded last-N ring, then their series is pruned)",
         [({"qid": s["query_id"]}, s["progress_ratio"])
          for s in progress.snapshot_queries()
          if s.get("progress_ratio") is not None]
         + [({"qid": s["query_id"]}, s["progress_ratio"])
            for s in progress.finished_queries()
            if s.get("progress_ratio") is not None])
    with _lock:
        reqs = dict(_endpoint_requests)
    emit("blaze_endpoint_requests_total", "counter",
         "Debug-endpoint requests served, by route",
         [({"route": r}, n) for r, n in sorted(reqs.items())])

    # continuous sampling profiler (runtime/profiler.py): fleet-merged
    # folded-stack table posture — local + federated executor samples
    from blaze_tpu_torch.runtime import profiler

    ps = profiler.stats()
    emit("blaze_profile_samples_total", "counter",
         "Thread-samples folded locally by this process's sampler",
         [({}, ps["samples"])])
    emit("blaze_profile_remote_samples_total", "counter",
         "Executor samples federated driver-ward on telemetry frames",
         [({}, ps["remote_samples"])])
    emit("blaze_profile_recovered_samples_total", "counter",
         "Remote samples replayed from a dead worker's sidecar spill",
         [({}, ps["recovered_samples"])])
    emit("blaze_profile_stacks", "gauge",
         "Distinct (attribution, folded-stack) entries in the bounded "
         "aggregate table",
         [({}, ps["stacks"])])
    emit("blaze_profile_dropped_total", "counter",
         "Samples dropped with the table at capacity",
         [({}, ps["dropped"])])
    emit("blaze_profile_duty_pct", "gauge",
         "Sampler overhead: cpu seconds inside sampling passes per "
         "wall second alive, this process",
         [({}, ps["duty_pct"])])
    emit("blaze_profile_fleet_duty_pct", "gauge",
         "Sampler overhead summed across this driver and every "
         "executor's shipped duty ledger",
         [({}, ps["fleet_duty_pct"])])

    for prefix, help_text, snap in (
            ("blaze_pipeline", "pipeline telemetry",
             pipeline.TELEMETRY.snapshot()),
            ("blaze_faults", "resilience telemetry",
             faults.TELEMETRY.snapshot()),
            ("blaze_compile", "compile-service telemetry",
             _compile_snapshot())):
        for k, v in sorted(snap.items()):
            if not isinstance(v, (int, float)):
                continue
            emit(_prom_name(f"{prefix}_{k}"), "gauge",
                 f"{help_text}: {k}", [({}, v)])

    # engine histograms (task_latency_us, pipeline_*, shuffle_write_
    # bytes, ...): proper Prometheus histogram exposition — cumulative
    # _bucket{le=...} series straight from the log2 bucket counts
    # (metrics.Histogram.bucket_upper_bound), plus _sum/_count. Replaces
    # the earlier quantile-summary rendering: quantiles cannot be
    # aggregated across processes, buckets can.
    from blaze_tpu_torch.runtime.metrics import Histogram

    for name, snap in sorted(trace.histograms_snapshot().items()):
        base = _prom_name(f"blaze_hist_{name}")
        counts = snap.get("counts") or []
        last = max((i for i, c in enumerate(counts) if c), default=-1)
        lines.append(f"# HELP {base} engine histogram {name}")
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for i in range(last + 1):
            cum += counts[i]
            le = Histogram.bucket_upper_bound(i)
            lines.append(f'{base}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {snap["count"]}')
        lines.append(f"{base}_sum {snap['total']}")
        lines.append(f"{base}_count {snap['count']}")

    return "\n".join(lines) + "\n"


# per-route request counters for the debug endpoints (exported as
# blaze_endpoint_requests_total{route=})
_endpoint_requests: Dict[str, int] = {}


def _note_request(route: str) -> None:
    with _lock:
        _endpoint_requests[route] = _endpoint_requests.get(route, 0) + 1


def health_snapshot() -> Dict[str, Any]:
    """Cheap liveness payload (GET /healthz): ring occupancy + sampler
    staleness for container probes, without the full exposition. With an
    executor pool attached, ok flips False ONLY at zero live executors
    (degraded-but-serving capacity is healthy — the probe must not
    restart a pod that is recovering one seat). Reports this process's
    driver `role` and the autoscaler's policy state: a warm standby has
    no pool attached, so it serves 200 with role=standby — load
    balancers probe both drivers with the same check."""
    from blaze_tpu_torch.runtime import autoscaler, executor_pool, standby

    s = sampler()
    ring = s.ring() if s is not None else []
    last_ts = ring[-1].get("ts") if ring else None
    ps = executor_pool.pool_stats()
    ok = True
    if ps is not None:
        ok = ps["live"] > 0
    asc = autoscaler.state()
    return {
        "ok": ok,
        "role": standby.role(),
        "standby_enabled": bool(conf.standby_enabled),
        "autoscaler": (None if asc is None else {
            "target_seats": asc["target_seats"],
            "last_decision": asc["last_decision"],
            "cooldown_remaining_ms": asc["cooldown_remaining_ms"],
        }),
        "executors_live": ps["live"] if ps else None,
        "executors_draining": ps.get("draining") if ps else None,
        "capacity": ps["capacity"] if ps else None,
        "ring_samples": len(ring),
        "ring_capacity": int(conf.monitor_ring_samples),
        "sampler_alive": bool(s is not None and s._thread is not None
                              and s._thread.is_alive()),
        "sampler_staleness_s": (round(time.time() - last_ts, 3)
                                if last_ts is not None else None),
        "trace_events": len(trace.TRACE),
        "trace_dropped": trace.TRACE.dropped,
        "queries_running": len(running_queries()),
    }


def serve_path(path: str) -> Tuple[int, str, bytes]:
    """Route one debug-endpoint GET -> (status, content-type, body).
    Factored out of the socket handler so tests and blaze_inspect can
    hit the routes without a live server."""
    if path in ("/metrics", "/"):
        _note_request("metrics")
        return (200, "text/plain; version=0.0.4",
                prometheus_text().encode())
    if path == "/healthz":
        _note_request("healthz")
        snap = health_snapshot()
        # 503 only at zero live executors: a load balancer must keep
        # routing to a DEGRADED pool (it still serves, at reduced
        # capacity) and only eject a truly dead one
        return (200 if snap["ok"] else 503, "application/json",
                json.dumps(snap).encode())
    # live introspection (runtime/progress.py): lazy import — progress
    # imports monitor at module level
    if path == "/queries":
        _note_request("queries")
        from blaze_tpu_torch.runtime import progress

        return (200, "application/json",
                json.dumps(progress.render_queries(),
                           default=str).encode())
    if path.startswith("/queries/"):
        _note_request("query_detail")
        from blaze_tpu_torch.runtime import progress

        snap = progress.render_query(path[len("/queries/"):])
        if snap is None:
            return (404, "application/json",
                    b'{"error": "unknown or finished query"}')
        return (200, "application/json",
                json.dumps(snap, default=str).encode())
    _note_request("other")
    return 404, "text/plain", b"not found"


class MetricsServer:
    """Metrics + debug-endpoint server on a stdlib http.server daemon
    thread: GET /metrics (Prometheus exposition), /healthz (liveness),
    /queries and /queries/<qid> (live progress). Port 0 binds an
    ephemeral port (tests); `host` defaults to conf.metrics_host —
    loopback unless an operator deliberately exposes it.
    close() shuts the socket down and joins the thread."""

    def __init__(self, port: int, host: Optional[str] = None) -> None:
        if host is None:
            host = str(conf.metrics_host or "127.0.0.1")

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server contract
                try:
                    status, ctype, body = serve_path(
                        self.path.split("?")[0])
                except Exception as e:  # noqa: BLE001 — scrape, not crash
                    self.send_error(500, str(e)[:100])
                    return
                if status != 200 and not body:
                    self.send_error(status)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="blz-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# -- global endpoint + sampler (lazily started by the local runner) ----------

_global_lock = threading.Lock()
_server: Optional[MetricsServer] = None
_sampler: Optional[ResourceMonitor] = None


def ensure_started() -> Optional[MetricsServer]:
    """Idempotent: serve /metrics on conf.metrics_port (restarting when
    the port changed) and run the background sampler. No-op when
    conf.metrics_port is 0."""
    global _server, _sampler
    port = int(conf.metrics_port or 0)
    with _global_lock:
        if port <= 0:
            return _server
        if _server is not None and _server.port != port:
            _server.close()
            _server = None
        if _server is None:
            _server = MetricsServer(port)
        if _sampler is None and conf.monitor_sample_ms > 0:
            _sampler = ResourceMonitor().start()
        return _server


def sampler() -> Optional[ResourceMonitor]:
    with _global_lock:
        return _sampler


def ring_slice(since_ts: Optional[float] = None) -> List[Dict[str, Any]]:
    """Global-sampler ring samples with ts >= since_ts ([] when the
    sampler never started) — the flight recorder's monitor slice."""
    s = sampler()
    if s is None:
        return []
    return s.ring_since(since_ts)


def shutdown() -> None:
    """Stop the global endpoint + sampler (tests / embedder teardown)."""
    global _server, _sampler
    with _global_lock:
        if _server is not None:
            _server.close()
            _server = None
        if _sampler is not None:
            _sampler.stop()
            _sampler = None
