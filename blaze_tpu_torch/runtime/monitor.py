"""Resource accounting: bytes and time at the engine's copy boundaries.

Port of the half of blaze_tpu/runtime/monitor.py that a default query
runs (its :66-510): the byte and time accounting with per-query and
per-stage attribution, the zero-copy event counters, the per-query
roll-up merged into run_info, and the always-on leak check.

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

What the JAX module also has waits for the modules it reads: the sampler and
exporters (ResourceMonitor, prometheus_text, MetricsServer, ...) for the
service-layer modules they read (ROADMAP Queue 1, item 3);
conf.metrics_port stays refused until then (spark/local_runner.py), and
`sampler()`/`ring_slice()` give what the JAX module's give while no
sampler runs: None and []. `begin_query` starts the sampling profiler
(runtime/profiler.py) under conf.profile_enabled, as the JAX module's
does. The roll-up has no compile_* keys: the port compiles no programs
(its ops run eagerly).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import trace

BOUNDARIES = ("serde", "ffi", "shuffle", "spill", "fallback")

# boundary-time categories: each lands in run_info as "<category>_ms" and
# on stage spans. sched_queue belongs to the service's fair scheduler,
# which is not ported, so nothing counts it yet.
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


# -- per-query lifecycle -----------------------------------------------------


def begin_query(qid: str, manager=None) -> None:
    """Register `qid` as the active query (attribution fallback), reset
    the manager's peak-usage watermark, and snapshot the process
    counters the roll-up reports as deltas. Starts the sampling profiler
    when conf.profile_enabled is set."""
    global _active_qid
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


def sampler():
    """The global gauge sampler: None, as in the JAX module while
    conf.metrics_port is 0 (the sampler comes with the service layer,
    ROADMAP Queue 1, item 3)."""
    return None


def ring_slice(since_ts: Optional[float] = None) -> List[Dict[str, Any]]:
    """Global-sampler ring samples with ts >= since_ts, the flight
    recorder's monitor slice: [], as in the JAX module while its sampler
    never started."""
    return []
