"""Live per-query progress: stage waterfalls, attempt states, ETA.

Port of blaze_tpu/runtime/progress.py, whole, with the stream hooks
(begin_stream, stream_batch, stream_lag) that runtime/streaming.py
calls. The monitor's metrics server (conf.metrics_port) serves
render_queries()/render_query() as GET /queries and /queries/<qid>.

The monitor answers "how much is the process doing"; this module
answers "how far along is query X" while it runs. A per-query record
tracks stage lifecycles (from the local runner), batch-boundary rows
(from ops/base.count_stream — the SAME heartbeat call site trace and
history tap, so the hot path gains no new check points), task attempt
states (from the supervisor), and resilience counters (retries, ladder
rungs, speculation — from the executor/supervisor hooks). Snapshots are
served by the metrics HTTP server as `GET /queries` (all live sessions:
tenant, phase, progress ratio, ETA, SLO headroom) and
`GET /queries/<qid>` (per-stage waterfall + live critical-path-so-far
from the monitor's boundary-time accounting).

ETA comes from history: at stage begin, the fingerprint's
`StatisticsFeed.observed_stage_cost()` p50 becomes the stage's expected
cost; remaining = sum(expected - elapsed) over unfinished stages. With
no history the ETA is null and the progress ratio falls back to stage
counts. The reported ratio is CLAMPED MONOTONE per query (a scraper
never sees progress go backwards).

Gating: every hook is one `conf.progress_enabled` truthiness check at
the call site (count_stream uses the same conditional-import posture as
the history tap); disabled, the registry stays empty and the endpoints
serve [].
"""

from __future__ import annotations

import threading
import time

from collections import deque
from typing import Any, Dict, List, Optional

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import monitor, trace

_lock = threading.Lock()
_queries: Dict[str, "_QueryProgress"] = {}
# bounded ring of final summary rows for COMPLETED queries: the metrics
# exposition serves blaze_query_progress_ratio for live + last-N
# finished queries, so the {qid=} label cardinality on a long-lived
# endpoint is live+N instead of one series per query ever run. A module
# constant, not a knob — the bound exists to cap cardinality, not to be
# tuned per deployment.
FINISHED_RING = 32
_finished: deque = deque(maxlen=FINISHED_RING)


class _StageProgress:
    __slots__ = ("stage_id", "kind", "fingerprint", "tasks", "started_at",
                 "finished_at", "rows", "batches", "expected_ms", "error",
                 "attempts", "retries", "rungs", "speculations")

    def __init__(self, stage_id, kind, fingerprint, tasks,
                 expected_ms) -> None:
        self.stage_id = stage_id
        self.kind = kind
        self.fingerprint = fingerprint
        self.tasks = tasks
        self.started_at = time.time()
        self.finished_at: Optional[float] = None
        self.rows = 0
        self.batches = 0
        self.expected_ms = expected_ms
        self.error: Optional[str] = None
        # attempt_id -> {task, state, speculative, ts}
        self.attempts: Dict[Any, Dict[str, Any]] = {}
        self.retries = 0
        self.rungs: List[str] = []
        self.speculations = 0

    def elapsed_ms(self, now: float) -> float:
        end = self.finished_at if self.finished_at is not None else now
        return max(end - self.started_at, 0.0) * 1000.0


class _QueryProgress:
    __slots__ = ("query_id", "tenant_id", "started_at", "stages", "order",
                 "current_stage", "last_ratio", "slo_ms", "rows", "phase",
                 "streaming", "batch_epoch", "batches", "lag_ms",
                 "batch_ms_ewma", "resumed_batches")

    def __init__(self, query_id: str, tenant_id: Optional[str],
                 slo_ms: Optional[float]) -> None:
        self.query_id = query_id
        self.tenant_id = tenant_id or ""
        self.started_at = time.time()
        self.stages: Dict[Any, _StageProgress] = {}
        self.order: List[Any] = []
        self.current_stage: Any = None
        self.last_ratio = 0.0
        self.slo_ms = slo_ms
        self.rows = 0
        self.phase = "running"
        # unbounded (streaming) sessions: a 0..1 ratio is meaningless
        # over an infinite plan, so the summary reports per-batch
        # progress + a lag/watermark ETA instead
        self.streaming = False
        self.batch_epoch = 0
        self.batches = 0
        self.lag_ms = 0.0
        self.batch_ms_ewma: Optional[float] = None
        self.resumed_batches = 0


def _slo_objective_ms(tenant_id: Optional[str]) -> Optional[float]:
    spec = conf.tenant_slo_spec
    if not tenant_id or not isinstance(spec, dict):
        return None
    ten = spec.get(tenant_id)
    if isinstance(ten, dict) and ten.get("latency_ms"):
        return float(ten["latency_ms"])
    return None


def _stage_expectation(fingerprint: Optional[str]) -> Optional[float]:
    """Historical p50 stage cost for `fingerprint` (None without a
    history store or first-ever plan) — the ETA's unit of work."""
    if not fingerprint or not conf.history_dir:
        return None
    try:
        from blaze_tpu_torch.runtime.history import StatisticsFeed

        exp = StatisticsFeed().observed_stage_cost(fingerprint)
    except Exception:  # noqa: BLE001 — ETA is advisory, never fatal
        return None
    return exp.get("ms_p50") if exp else None


# -- lifecycle hooks (call sites gate on conf.progress_enabled) --------------


def begin_query(query_id: str, tenant_id: Optional[str] = None) -> None:
    if not query_id:
        return
    q = _QueryProgress(query_id, tenant_id, _slo_objective_ms(tenant_id))
    with _lock:
        _queries[query_id] = q


def finish_query(query_id: str) -> None:
    """Drop the query from the live registry (endpoints list live
    queries only; the flight recorder + ledger own the postmortem) and
    stash its final summary row in the bounded finished ring for the
    metrics exposition."""
    now = time.time()
    with _lock:
        q = _queries.pop(query_id, None)
        if q is not None:
            q.phase = "finished"
            q.current_stage = None
            _finished.append(_summary_locked(q, now))


def begin_stream(stream_id: str, tenant_id: Optional[str] = None) -> None:
    """Register a long-lived streaming session (runtime/streaming.py).
    Unlike bounded queries it never reports a completion-fraction ratio;
    batches/epoch/lag carry its progress until finish_query drops it."""
    if not stream_id:
        return
    q = _QueryProgress(stream_id, tenant_id, _slo_objective_ms(tenant_id))
    q.streaming = True
    q.phase = "streaming"
    with _lock:
        _queries[stream_id] = q


def stream_batch(stream_id: str, epoch: int, rows: int, lag_ms: float,
                 batch_ms: float, resumed: bool = False) -> None:
    """One committed micro-batch: advances the epoch, feeds the lag-ETA
    estimator (EWMA of batch cost), and counts batches replayed from a
    checkpoint after a resume."""
    with _lock:
        q = _queries.get(stream_id)
        if q is None or not q.streaming:
            return
        q.batch_epoch = int(epoch)
        q.batches += 1
        q.rows += int(rows)
        q.lag_ms = float(lag_ms)
        q.batch_ms_ewma = (float(batch_ms) if q.batch_ms_ewma is None
                           else 0.7 * q.batch_ms_ewma + 0.3 * float(batch_ms))
        if resumed:
            q.resumed_batches += 1


def stream_lag(stream_id: str, lag_ms: float) -> None:
    """Between-batch lag refresh (idle ticks still age the watermark)."""
    with _lock:
        q = _queries.get(stream_id)
        if q is not None and q.streaming:
            q.lag_ms = float(lag_ms)


def stage_begin(query_id: str, stage_id, kind: str,
                fingerprint: Optional[str] = None,
                tasks: int = 1) -> None:
    expected = _stage_expectation(fingerprint)
    with _lock:
        q = _queries.get(query_id)
        if q is None:
            return
        st = _StageProgress(stage_id, kind, fingerprint, tasks, expected)
        q.stages[stage_id] = st
        if stage_id not in q.order:
            q.order.append(stage_id)
        q.current_stage = stage_id


def stage_end(query_id: str, stage_id, error: Optional[str] = None) -> None:
    with _lock:
        q = _queries.get(query_id)
        st = q.stages.get(stage_id) if q else None
        if st is None:
            return
        st.finished_at = time.time()
        st.error = error
        if q.current_stage == stage_id:
            q.current_stage = None


def on_batch(op, rows: int) -> None:
    """Batch-boundary tap (ops/base.count_stream). Attribution follows
    the monitor: trace context when present (supervised pool threads
    replay it), else the query's driver-registered current stage."""
    ctx = trace.current_context()
    qid = ctx.get("query_id")
    sid = ctx.get("stage_id")
    with _lock:
        if qid is None and len(_queries) == 1:
            qid = next(iter(_queries))
        q = _queries.get(qid) if qid else None
        if q is None:
            return
        q.rows += rows
        if sid is None:
            sid = q.current_stage
        st = q.stages.get(sid) if sid is not None else None
        if st is not None:
            st.rows += rows
            st.batches += 1


def attempt_update(trace_ctx: Dict[str, Any], attempt_id,
                   state: str, speculative: bool = False) -> None:
    """Task-attempt state export (supervisor._attempt_once): `state` is
    running -> ok | failed | killed:<reason>."""
    qid = trace_ctx.get("query_id")
    sid = trace_ctx.get("stage_id")
    with _lock:
        q = _queries.get(qid) if qid else None
        if q is None:
            return
        st = q.stages.get(sid if sid is not None else q.current_stage)
        if st is None:
            return
        rec = st.attempts.setdefault(
            attempt_id, {"task": trace_ctx.get("task_id"),
                         "speculative": bool(speculative)})
        rec["state"] = state
        rec["ts"] = time.time()
        if speculative and state == "running":
            st.speculations += 1


def note_event(kind: str, detail: Optional[str] = None) -> None:
    """Resilience-event tap (executor): retries and ladder rungs land on
    the attributed stage's waterfall row."""
    ctx = trace.current_context()
    qid = ctx.get("query_id")
    sid = ctx.get("stage_id")
    with _lock:
        if qid is None and len(_queries) == 1:
            qid = next(iter(_queries))
        q = _queries.get(qid) if qid else None
        if q is None:
            return
        st = q.stages.get(sid if sid is not None else q.current_stage)
        if st is None:
            return
        if kind == "retry":
            st.retries += 1
        elif kind == "ladder_rung" and detail:
            st.rungs.append(detail)


# -- snapshots ---------------------------------------------------------------


def _eta_ms(q: _QueryProgress, now: float) -> Optional[float]:
    """Remaining work from history expectations: sum over unfinished
    stages of (expected - elapsed), floored at 0. None until at least
    one live stage has an expectation (first-ever plans)."""
    known = False
    remaining = 0.0
    for st in q.stages.values():
        if st.finished_at is not None or st.expected_ms is None:
            continue
        known = True
        remaining += max(st.expected_ms - st.elapsed_ms(now), 0.0)
    return round(remaining, 3) if known else None


def _ratio(q: _QueryProgress, now: float) -> float:
    """Progress in [0, 1), monotone per query. Expected-cost weighted
    when history covers the stages seen so far; stage-count fallback
    otherwise (scaled by 0.9: the total stage count is unknown until
    the query ends, so the ratio never claims completion)."""
    total = done = 0.0
    weighted = True
    for sid in q.order:
        st = q.stages[sid]
        if st.expected_ms is None:
            weighted = False
            break
        total += st.expected_ms
        done += (st.elapsed_ms(now) if st.finished_at is None
                 else st.expected_ms)
    if weighted and total > 0:
        ratio = min(done / total, 0.99)
    else:
        n = len(q.order)
        fin = sum(1 for st in q.stages.values()
                  if st.finished_at is not None)
        ratio = 0.9 * fin / n if n else 0.0
    q.last_ratio = max(q.last_ratio, ratio)
    return round(q.last_ratio, 4)


def _summary_locked(q: _QueryProgress, now: float) -> Dict[str, Any]:
    elapsed = (now - q.started_at) * 1000.0
    if q.streaming:
        # unbounded session: no 0..1 ratio (the plan has no end). The
        # ETA reported is the LAG eta — expected time to drain the
        # current backlog at the observed per-batch cost — and the
        # per-batch fields carry the "how far along" story.
        lag_eta = (0.0 if q.lag_ms <= 0 else q.batch_ms_ewma)
        return {
            "query_id": q.query_id,
            "tenant_id": q.tenant_id,
            "phase": q.phase,
            "streaming": True,
            "elapsed_ms": round(elapsed, 3),
            "progress_ratio": None,
            "eta_ms": None,
            "batch_epoch": q.batch_epoch,
            "batches": q.batches,
            "lag_ms": round(q.lag_ms, 3),
            "lag_eta_ms": (round(lag_eta, 3)
                           if lag_eta is not None else None),
            "batch_ms": (round(q.batch_ms_ewma, 3)
                         if q.batch_ms_ewma is not None else None),
            "resumed_batches": q.resumed_batches,
            "slo_objective_ms": q.slo_ms,
            "slo_headroom_ms": None,
            "rows": q.rows,
            "stages_total": len(q.order),
            "stages_done": sum(1 for st in q.stages.values()
                               if st.finished_at is not None),
        }
    eta = _eta_ms(q, now)
    return {
        "query_id": q.query_id,
        "tenant_id": q.tenant_id,
        "phase": q.phase if q.current_stage is None
        else f"stage:{q.current_stage}",
        "elapsed_ms": round(elapsed, 3),
        "progress_ratio": _ratio(q, now),
        "eta_ms": eta,
        "slo_objective_ms": q.slo_ms,
        "slo_headroom_ms": (round(q.slo_ms - elapsed, 3)
                            if q.slo_ms else None),
        "rows": q.rows,
        "stages_total": len(q.order),
        "stages_done": sum(1 for st in q.stages.values()
                           if st.finished_at is not None),
    }


def snapshot_queries() -> List[Dict[str, Any]]:
    """Summary row per live query (the /queries payload)."""
    now = time.time()
    with _lock:
        return [_summary_locked(q, now) for q in _queries.values()]


def finished_queries() -> List[Dict[str, Any]]:
    """Final summary rows of the last FINISHED_RING completed queries
    (oldest-first) — the bounded tail the metrics exposition appends to
    the live rows."""
    with _lock:
        return list(_finished)


def snapshot_query(query_id: str) -> Optional[Dict[str, Any]]:
    """Per-stage waterfall + live critical-path-so-far for one live
    query (the /queries/<qid> payload); None when not live."""
    now = time.time()
    with _lock:
        q = _queries.get(query_id)
        if q is None:
            return None
        doc = _summary_locked(q, now)
        stages = []
        for sid in q.order:
            st = q.stages[sid]
            stages.append({
                "stage_id": st.stage_id,
                "kind": st.kind,
                "fingerprint": st.fingerprint,
                "state": ("failed" if st.error else
                          "done" if st.finished_at is not None
                          else "running"),
                "started_offset_ms": round(
                    (st.started_at - q.started_at) * 1000.0, 3),
                "elapsed_ms": round(st.elapsed_ms(now), 3),
                "expected_ms": st.expected_ms,
                "rows": st.rows,
                "batches": st.batches,
                "tasks": st.tasks,
                "attempts": [dict(v, attempt_id=k)
                             for k, v in st.attempts.items()],
                "retries": st.retries,
                "rungs": list(st.rungs),
                "speculations": st.speculations,
                "error": st.error,
            })
        doc["stages"] = stages
    # live critical-path-so-far: the monitor's boundary-time accounting
    # for the still-registered query (the doctor's term inputs, live)
    doc["critical_path_so_far_ms"] = monitor.query_time_breakdown(query_id)
    return doc


def render_queries() -> List[Dict[str, Any]]:
    """Endpoint wrapper: snapshot + a progress_snapshot trace event (the
    scrape itself is part of the query's record)."""
    snaps = snapshot_queries()
    trace.event("progress_snapshot", scope="queries", live=len(snaps))
    return snaps


def render_query(query_id: str) -> Optional[Dict[str, Any]]:
    snap = snapshot_query(query_id)
    if snap is not None:
        trace.event("progress_snapshot", query_id=query_id, scope="query")
    return snap


def active() -> List[str]:
    with _lock:
        return list(_queries)


def reset() -> None:
    with _lock:
        _queries.clear()
        _finished.clear()
