"""Structured query tracing: a correlated span/event log and its exporters.

Port of blaze_tpu/runtime/trace.py, whole. The supervisor
retries, degrades, speculates, kills and reroutes tasks; this module
records every such decision as a structured record with correlation ids:

  TraceLog    process-global, locked, BOUNDED ring of records
              (conf.trace_buffer_events; overflow drops the oldest and
              counts it in `dropped`). Monotonic and wall timestamps come
              from injectable clocks, so tests pin exact durations.

  spans       `with span(kind, **attrs):` records one "span" with its
              begin and duration; id kwargs (query_id/stage_id/task_id/
              attempt_id) also become thread-local CONTEXT inherited by
              every record opened inside. The supervisor copies the
              driver's context into its pool and speculation threads, and
              the pipeline into its I/O threads.

  events      `event(kind, **attrs)` records a point: retries, ladder
              rungs, heartbeat misses, deadline kills, speculation
              launch/win/loss, breaker trips, fault injections, spills.

  histograms  named process-global `metrics.Histogram`s (log2 buckets):
              batch_rows, task_latency_us, shuffle_write_bytes.

  exporters   export_chrome_trace() — Chrome/Perfetto trace-event JSON,
              one row per task, spans nested under stages.
              explain_analyze() — EXPLAIN ANALYZE-style operator tree
              merging per-op counters with span wall-times, throughput
              and resilience annotations, the doctor's breakdown and the
              profiler's hot frames.
              export_run_ledger() — one JSONL summary line per query
              (build_run_record: ids, durations, per-stage timings,
              counters, histogram percentiles, the critical path), the
              line the JAX package's doctor and trend tools read;
              export_query() writes it and the Chrome trace under
              conf.trace_export_dir, and rotate_export_dir() bounds that
              directory.

Everything is gated on `conf.trace_enabled`: off, span() returns a shared
no-op context manager and event() returns after one truthiness check.
`profiled_span` captures the device timeline with torch.profiler under
`conf.profiler_dir`. While the autoscaler (runtime/autoscaler.py) is
active, every ledger line carries its "fleet" posture, as the JAX
module's does. Both reports end with the compile service's summary line
(runtime/compile_service.telemetry_summary, '' while it is idle) and the
resilience one.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime.metrics import Histogram

# correlation-id keys: hoisted out of attrs onto the record top level and
# inherited by nested records through the thread-local context stack
ID_KEYS = ("query_id", "tenant_id", "stage_id", "task_id", "attempt_id")

_ctx = threading.local()
_qid_seq = itertools.count(1)


def new_query_id() -> str:
    """Process-unique query correlation id (pid-tagged so ledger lines
    from different drivers sharing a trace dir never collide)."""
    return f"q{os.getpid()}-{next(_qid_seq)}"


def _ctx_stack() -> List[Dict[str, Any]]:
    s = getattr(_ctx, "stack", None)
    if s is None:
        s = _ctx.stack = []
    return s


def current_context() -> Dict[str, Any]:
    """Merged correlation ids active on THIS thread (innermost wins).
    The supervisor snapshots this on the driver thread and replays it
    inside pool/speculative threads (trace.context(**snap))."""
    merged: Dict[str, Any] = {}
    for d in _ctx_stack():
        merged.update(d)
    return merged


# thread ident -> merged correlation ids, mirrored by context() while
# conf.profile_enabled: the sampling profiler's daemon thread cannot
# read another thread's threading.local stack, so the push/pop sites
# publish the merged ids here for it to join against
# sys._current_frames(). Empty (and never written) while profiling is
# off — the mirror costs one truthiness check per push/pop.
_live_ctx: Dict[int, Dict[str, Any]] = {}


@contextlib.contextmanager
def context(**ids):
    """Push correlation ids for records opened inside the block."""
    stack = _ctx_stack()
    stack.append({k: v for k, v in ids.items() if v is not None})
    if conf.profile_enabled:
        _live_ctx[threading.get_ident()] = current_context()
    try:
        yield
    finally:
        stack.pop()
        if conf.profile_enabled:
            ident = threading.get_ident()
            if stack:
                _live_ctx[ident] = current_context()
            else:
                _live_ctx.pop(ident, None)


class TraceLog:
    """Bounded, lock-protected span/event log.

    `clock` returns monotonic nanoseconds (ordering + durations), `wall`
    epoch nanoseconds (cross-process correlation); both injectable so
    tests pin exact timings. Capacity is re-read from
    conf.trace_buffer_events per append unless fixed at construction."""

    def __init__(self, capacity: Optional[int] = None,
                 clock: Optional[Callable[[], int]] = None,
                 wall: Optional[Callable[[], int]] = None) -> None:
        self._lock = threading.Lock()
        self._buf: deque = deque()
        self._capacity = capacity
        self.clock = clock or time.monotonic_ns
        self.wall = wall or time.time_ns
        self.dropped = 0

    def _cap(self) -> int:
        if self._capacity is not None:
            return max(int(self._capacity), 1)
        return max(int(conf.trace_buffer_events), 1)

    def append(self, rec: Dict[str, Any]) -> None:
        cap = self._cap()
        with self._lock:
            while len(self._buf) >= cap:
                self._buf.popleft()
                self.dropped += 1
            self._buf.append(rec)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Records oldest-first (copies of the list, records shared)."""
        with self._lock:
            return list(self._buf)

    def drain(self) -> List[Dict[str, Any]]:
        """Pop and return every buffered record (oldest-first). The
        executor-side telemetry shipper uses this so records buffer in
        the bounded ring between ships and leave exactly once; the
        `dropped` counter is cumulative and survives the drain."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            return out

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


TRACE = TraceLog()

# -- declared record-kind registries -----------------------------------------
# Every event/span kind emitted anywhere in the engine, declared up front:
# exporters and trend tooling key on these strings, so an ad-hoc kind is a
# silent contract break. tools/blazelint's registry-sync checker verifies
# every `trace.event(...)`/`trace.span(...)` literal (and the static prefix
# of dynamic names like f"compile_{event}") resolves here, and flags
# registered-but-never-emitted kinds as stale. Add the kind HERE in the
# same change that introduces the call site.

EVENT_KINDS = (
    "admission_admitted",   # service: query granted a run slot
    "admission_parked",     # service: query queued behind a full pool
    "admission_rejected",   # service: load shed (queue full / deadline)
    "artifact_commit",      # runtime/artifacts.py: first-commit-wins publish
    "artifact_corrupt",     # artifacts: read-path checksum mismatch
    "artifact_quarantined", # artifacts: corrupt file renamed .quarantine
    "autopilot_apply",      # local_runner: stored overlay applied to a
                            # fingerprinted query at admission
    "autopilot_explore",    # autopilot: canary proposed / canary win
    "autopilot_promote",    # autopilot: canary graduated to settled
    "autopilot_rollback",   # autopilot: canary reverted + quarantined
                            # (regression verdict or inconclusive)
    "batch",                # ops/base.count_stream batch boundary
    "breaker_trip",         # supervisor: per-operator circuit breaker
    "compile_compiled",     # compile_service: a library built
    "compile_hit",          # compile_service: library or callable reused
    "compile_miss",         # compile_service: library or callable built
    "capacity_changed",     # service: admission capacity recomputed on
                            # executor-pool membership change
    "control_reconnect",    # executor_pool: worker resumed its control
                            # session after a transport blip (no death)
    "deadline_exceeded",    # executor: task/query budget exhausted
    "deadline_kill",        # supervisor: budget exhausted mid-attempt
    "degrade",              # executor: resilience-ladder rung taken
    "dict_decode",          # serde: dictionary string column expanded
                            # at the result-merge edge
    "dict_encode",          # serde: string column shipped as
                            # (dictionary, codes) instead of raw bytes
    "driver_failover",      # standby: warm standby fenced the dead
                            # primary's lease and took over the fleet
    "driver_recovery",      # journal: recovery scan replayed a journal
    "epoch_fenced",         # artifacts.EpochFence: stale attempt rejected
    "executor_adopted",     # executor_pool: rebound listener adopted a
                            # surviving worker via its resume handshake
    "executor_death",       # supervisor/pool: executor process declared dead
    "executor_drain",       # executor_pool: seat gracefully decommissioned
                            # (drain completed; not a death)
    "executor_spawn",       # executor_pool: worker process launched
    "executor_task_requeued",  # executor_pool: displaced/failed task re-queued
    "fault_injected",       # faults.inject: armed point fired
    "flight_capture",       # flight_recorder: incident dossier written
    "hang_detected",        # supervisor watchdog: heartbeat stale
    "hang_relaunch",        # supervisor: killed attempt relaunched
    "journal_replay",       # local_runner: committed stage reused from
                            # a recovered write-ahead journal
    "ladder_rung",          # executor: degradation ladder transition
    "lease_expired",        # executor_pool worker: driver unreachable past
                            # executor_death_ms; self-fenced (exit 17)
    "lease_fenced",         # standby: a stale primary saw a higher lease
                            # epoch on renew and stood down
    "mem_release",          # memory: reservation released by sweep
    "orphan_sweep",         # artifacts: stale attempt files removed
    "partition_suspected",  # executor_pool: control conn broken but the
                            # process looks alive — reconnect window open
    "pipeline_stats",       # pipeline: per-stream close statistics
    "profile_export",       # profiler: per-query collapsed-stack +
                            # speedscope files committed
    "profile_merge",        # profiler: executor folded-stack deltas
                            # federated into the driver table
    "progress_snapshot",    # monitor endpoints: live progress scraped
    "queue_depth",          # pipeline: sampler queue-depth reading
    "resource_leak",        # monitor: leaked reservation/stream detected
    "retry",                # executor: retryable failure retried
    "scale_down",           # autoscaler: idlest seat drained out
                            # (evidence: utilization, idle ticks)
    "scale_up",             # autoscaler: seat spawned (evidence: parked
                            # arrivals / SLO burn / utilization)
    "shuffle_conn_dropped", # shuffle_server: client connection dropped
                            # mid-request (reset/torn frame/CRC mismatch)
    "shuffle_mmap_fetch",   # shuffle_server client: partition served as
                            # zero-copy mmap views (no socket stream)
    "slo_burn",             # service: tenant SLO budget burning hot
    "speculation_launch",   # supervisor: straggler twin launched
    "speculation_loss",     # supervisor: attempt lost the commit race
    "speculation_win",      # supervisor: speculative twin won
    "spill",                # memory: spill file written
    "spill_pages_flush",    # memory: spill page pool flushed
    "stream_batch",         # streaming: micro-batch merged into the
                            # stream's aggregation state
    "stream_checkpoint",    # streaming: offsets+state+epoch made durable
                            # in one crash-atomic journal record
    "stream_resume",        # streaming: state restored from the last
                            # committed checkpoint after a crash/takeover
    "task_abandoned",       # supervisor: attempt abandoned post-kill
    "task_error",           # supervisor: classified attempt failure
    "telemetry_recovered",  # executor_pool: dead worker's sidecar-spilled
                            # ring tail ingested (records marked truncated)
    "telemetry_shipped",    # executor_pool: batched executor telemetry
                            # frame federated into the driver ring
    "tenant_over_quota",    # memory: tenant ceiling hit, self-spilling
    "whole_stage_attempt",  # stage_compiler: fused single-dispatch try
    "whole_stage_fallback", # stage_compiler: fused path bailed out
    "whole_stage_groups",   # stage_compiler: dense-agg group stats
)

SPAN_KINDS = (
    "profile",       # trace.profiled_span: device profiler capture
    "query",         # local_runner: one per query
    "stage",         # executor: shuffle-map/broadcast/result stage
    "task_attempt",  # supervisor: one per (task, attempt)
)

# run-record wire format (ledger lines + history records). Bump on
# shape changes; readers treat a MISSING field as version 1 (PR-9-era
# lines predate the stamp) and must keep loading old lines.
SCHEMA_VERSION = 2

# -- named histogram registry ------------------------------------------------

_hist_lock = threading.Lock()
_HISTS: Dict[str, Histogram] = {}


def histogram(name: str) -> Histogram:
    h = _HISTS.get(name)
    if h is None:
        with _hist_lock:
            h = _HISTS.setdefault(name, Histogram(name))
    return h


def record_value(name: str, value: int) -> None:
    """Record into a named histogram when tracing is enabled."""
    if conf.trace_enabled:
        histogram(name).record(value)


def histograms_snapshot(reset: bool = False) -> Dict[str, dict]:
    with _hist_lock:
        hists = dict(_HISTS)
        if reset:
            _HISTS.clear()
    return {k: h.snapshot() for k, h in hists.items() if h.count}


def reset_histograms() -> None:
    with _hist_lock:
        _HISTS.clear()


def reset() -> None:
    """Clear the global log + histograms (test/bench isolation)."""
    TRACE.reset()
    reset_histograms()


# -- recording ---------------------------------------------------------------


def _base_record(rtype: str, kind: str, attrs: Dict[str, Any]
                 ) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"type": rtype, "kind": kind}
    rec.update(current_context())
    for k in ID_KEYS:
        if k in attrs:
            v = attrs.pop(k)
            if v is not None:
                rec[k] = v
    rec["thread"] = threading.current_thread().name
    if attrs:
        rec["attrs"] = attrs
    return rec


def event(kind: str, **attrs) -> None:
    """Record a point event (no-op unless conf.trace_enabled).

    Correlation ids come from the thread context; explicit id kwargs
    (query_id=..., task_id=...) override it — watchdog-thread callers
    pass them directly since they run outside any task context."""
    if not conf.trace_enabled:
        return
    log = TRACE
    rec = _base_record("event", kind, attrs)
    rec["ts"] = log.clock()
    rec["wall"] = log.wall()
    log.append(rec)


class _Span:
    """Live span handle: `attrs` may be mutated (or set()) before exit —
    the stage spans learn their transport only after the mesh attempt."""

    __slots__ = ("kind", "attrs", "ids", "t0", "wall0", "_cm", "error")

    def __init__(self, kind: str, ids: Dict[str, Any],
                 attrs: Dict[str, Any]) -> None:
        self.kind = kind
        self.ids = ids
        self.attrs = attrs
        self.error: Optional[str] = None
        self.t0 = 0
        self.wall0 = 0
        self._cm = None

    def set(self, **kw) -> "_Span":
        self.attrs.update(kw)
        return self


class _NullSpan:
    """Shared disabled-path span: enter/exit/set are no-ops."""

    __slots__ = ()
    attrs: Dict[str, Any] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


_NULL_SPAN = _NullSpan()


class _SpanCM:
    __slots__ = ("span",)

    def __init__(self, span: _Span) -> None:
        self.span = span

    def __enter__(self) -> _Span:
        sp = self.span
        sp.t0 = TRACE.clock()
        sp.wall0 = TRACE.wall()
        cm = context(**sp.ids)
        cm.__enter__()
        sp._cm = cm
        return sp

    def __exit__(self, etype, exc, tb) -> bool:
        sp = self.span
        log = TRACE
        dur = log.clock() - sp.t0
        sp._cm.__exit__(etype, exc, tb)
        rec = _base_record("span", sp.kind, dict(sp.attrs))
        rec.update({k: v for k, v in sp.ids.items() if v is not None})
        rec["ts"] = sp.t0
        rec["wall"] = sp.wall0
        rec["dur"] = dur
        if exc is not None:
            rec["error"] = f"{type(exc).__name__}: {exc}"[:200]
        elif sp.error:
            rec["error"] = sp.error
        log.append(rec)
        return False


def span(kind: str, **attrs):
    """Context manager recording a span (one record at exit, with begin
    timestamp + duration). Id kwargs double as context for the block:

        with span("stage", stage_id=3, stage_kind="shuffle_map") as sp:
            ...                       # children inherit stage_id=3
            sp.set(transport="mesh")  # attrs may be refined before exit
    """
    if not conf.trace_enabled:
        return _NULL_SPAN
    ids = {k: attrs.pop(k) for k in ID_KEYS if k in attrs}
    return _SpanCM(_Span(kind, ids, attrs))


@contextlib.contextmanager
def profiled_span(name: str = "query"):
    """Device-profiler capture as a trace span: records a "profile" span
    in the ring and, when conf.profiler_dir is set, wraps the block in a
    torch.profiler capture (CPU and, where present, CUDA activity) with a
    `record_function(name)` range, writing a Chrome trace into
    profiler_dir so the device timeline lands next to the engine spans.
    The capture honours profiler_dir even with tracing off."""
    with span("profile", scope=name) as sp:
        if not conf.profiler_dir:
            yield sp
            return
        import torch

        sp.set(profiler_dir=conf.profiler_dir)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(conf.profiler_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(name):
                yield sp
        prof.export_chrome_trace(os.path.join(
            conf.profiler_dir,
            f"{name}_{os.getpid()}_{next(_profile_seq)}.json"))


_profile_seq = itertools.count(1)


def on_batch(op, rows: int) -> None:
    """Batch-boundary hook (ops/base.count_stream — the same place the
    heartbeat/kill check lives, so the hot path gains no new check
    points): batch-size histogram + one trace event per batch."""
    histogram("batch_rows").record(rows)
    event("batch", op=op.name(), rows=rows)


def query_records(query_id: str,
                  records: Optional[Iterable[dict]] = None) -> List[dict]:
    """Records correlated to one query (plus globals recorded with no
    query id inside its window — compile/spill events from helper
    threads keep their ids when context was present, so uncorrelated
    records are rare and excluded)."""
    recs = TRACE.snapshot() if records is None else list(records)
    return [r for r in recs if r.get("query_id") == query_id]


# -- cross-process federation (executor telemetry -> driver ring) ------------


def ingest_remote(records: Iterable[dict], *, exec_id: str,
                  pid: Optional[int] = None, offset_ns: int = 0,
                  truncated: bool = False) -> int:
    """Federate executor-side trace records into the driver's ring.

    Each record's monotonic `ts` is rebased by the executor's estimated
    clock offset (handshake echo, runtime/executor_pool.py) so merged
    exports order driver and executor spans on one timeline, and the
    record is stamped with the shipping executor ("exec", "exec_pid").
    `truncated=True` marks records recovered from a dead worker's
    sidecar spill — the span stream ended mid-flight. Returns the count
    ingested; malformed entries are skipped, never fatal."""
    if not conf.trace_enabled:
        return 0
    n = 0
    off = int(offset_ns)
    for rec in records:
        if not isinstance(rec, dict) or "kind" not in rec:
            continue
        r = dict(rec)
        try:
            r["ts"] = int(r.get("ts", 0)) + off
        except (TypeError, ValueError):
            continue
        r["exec"] = exec_id
        if pid is not None:
            r["exec_pid"] = pid
        if truncated:
            r["truncated"] = True
        TRACE.append(r)
        n += 1
    return n


def ingest_histograms(snaps: Dict[str, dict]) -> None:
    """Merge executor-shipped histogram snapshots (bucket-count deltas)
    into the driver's named histograms — task_latency_us etc. then cover
    pooled and in-process work in one distribution."""
    if not conf.trace_enabled or not snaps:
        return
    for name, s in snaps.items():
        if not isinstance(s, dict):
            continue
        tmp = Histogram(str(name))
        counts = list(s.get("counts") or ())[:Histogram.N_BUCKETS]
        counts += [0] * (Histogram.N_BUCKETS - len(counts))
        tmp.counts = [int(c) for c in counts]
        tmp.count = int(s.get("count") or 0)
        tmp.total = int(s.get("total") or 0)
        tmp.vmin = s.get("min")
        tmp.vmax = s.get("max")
        if tmp.count:
            histogram(str(name)).merge(tmp)


# -- exporter 1: Chrome/Perfetto trace-event JSON ----------------------------


def export_chrome_trace(path: str,
                        records: Optional[Iterable[dict]] = None) -> dict:
    """Write records as Chrome trace-event JSON (load in Perfetto /
    chrome://tracing, next to the torch.profiler traces from
    conf.profiler_dir).

    Row model: one process per query — plus, for federated runs, one
    process per (query, executor): executor-shipped records carry an
    "exec" stamp (ingest_remote) and render on their own pid row named
    "blaze_tpu <qid> [execN]", timestamps already rebased onto the
    driver clock so the merged timeline is one trace. Within a process,
    one row (tid) per task — spans nest by time on their row, so
    task-attempt spans sit under their stage's span on the driver row
    timeline. "X" complete events carry spans; instant events ("i")
    carry points; metadata events name the rows. Returns
    {"events": n, "path": path}."""
    recs = TRACE.snapshot() if records is None else list(records)
    pids: Dict[tuple, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[dict] = []

    def pid_of(rec) -> int:
        q = str(rec.get("query_id", "-"))
        ex = rec.get("exec")
        key = (q, ex)
        if key not in pids:
            pids[key] = len(pids) + 1
            name = f"blaze_tpu {q}" if ex is None else \
                f"blaze_tpu {q} [{ex}]"
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[key], "tid": 0,
                           "args": {"name": name}})
        return pids[key]

    def tid_of(rec, pid: int) -> int:
        row = rec.get("task_id")
        label = str(row) if row is not None else "driver"
        key = (pid, label)
        if key not in tids:
            tids[key] = 1 if row is None else len(tids) + 2
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": label}})
        return tids[key]

    for rec in recs:
        pid = pid_of(rec)
        tid = tid_of(rec, pid)
        args = {k: rec[k] for k in ID_KEYS if k in rec}
        args.update(rec.get("attrs") or {})
        if rec.get("error"):
            args["error"] = rec["error"]
        if rec.get("exec"):
            args["exec"] = rec["exec"]
            if rec.get("exec_pid") is not None:
                args["exec_pid"] = rec["exec_pid"]
        if rec.get("truncated"):
            args["truncated"] = True
        ev = {"name": rec["kind"], "cat": rec["type"],
              "ts": rec["ts"] / 1000.0, "pid": pid, "tid": tid,
              "args": args}
        if rec["type"] == "span":
            ev["ph"] = "X"
            ev["dur"] = max(rec.get("dur", 0), 1) / 1000.0
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)

    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"dropped_events": TRACE.dropped}}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return {"events": len(events), "path": path}




# -- exporter 2: EXPLAIN ANALYZE ---------------------------------------------


def human_bytes(n: int) -> str:
    """1536 -> '1.5KiB' (the *_bytes analog of *_ns -> ms rendering)."""
    n = int(n)
    for unit, shift in (("GiB", 30), ("MiB", 20), ("KiB", 10)):
        if abs(n) >= (1 << shift):
            return f"{n / (1 << shift):.1f}{unit}"
    return f"{n}B"


def fmt_metric(k: str, v) -> str:
    if k.endswith("_ns"):
        return f"{k[:-3]}={v / 1e6:.1f}ms"
    if k.endswith("_bytes"):
        return f"{k}={human_bytes(v)}"
    return f"{k}={v}"


def metric_report(root) -> str:
    """Operator tree with its metrics, one line per op (post-run) — the
    analog of the reference's metric push into the Spark UI
    (blaze/src/metrics.rs:21-50), absorbed from the retired
    runtime/tracing.py shim.

    Counters are read via MetricsSet.snapshot() — supervisor pool
    threads mutate the raw dicts while a report renders, and iterating
    them unlocked raises RuntimeError("dict changed size during
    iteration"). `*_ns` values render as ms, `*_bytes` as KiB/MiB
    (fmt_metric). For the span-correlated superset (stage wall-times,
    throughput, resilience annotations) use explain_analyze(root,
    run_info)."""
    lines: List[str] = []

    def walk(op, depth: int) -> None:
        vals = {k: v for k, v in op.metrics.snapshot().items() if v}
        shown = ", ".join(fmt_metric(k, v)
                          for k, v in sorted(vals.items()))
        lines.append("  " * depth + f"{op.name()}: {shown}")
        for c in op.children:
            walk(c, depth + 1)

    walk(root, 0)
    from blaze_tpu_torch.runtime import compile_service, faults

    # both summaries include their per-category breakdowns (the faults
    # one appends [plan=1 retryable=2 ...] error counts, not only totals)
    for summary in (compile_service.telemetry_summary(),
                    faults.telemetry_summary()):
        if summary:
            lines.append(summary)
    return "\n".join(lines)


_RESILIENCE_EVENT_KINDS = (
    "retry", "ladder_rung", "hang_detected", "hang_relaunch",
    "deadline_kill", "deadline_exceeded", "speculation_launch",
    "speculation_win", "speculation_loss", "breaker_trip",
    "fault_injected", "task_error", "degrade", "executor_death",
    "executor_task_requeued", "epoch_fenced",
    # partition-tolerant control plane: wire blips and their outcomes
    # (run records count them so doctor's network_flaky rule can rank)
    "control_reconnect", "partition_suspected", "shuffle_conn_dropped",
    "lease_expired", "executor_drain",
)


def _stage_annotations(stage_events: List[dict]) -> str:
    """'2 retries, rung=halve_batch, speculated: won' from one stage's
    resilience events."""
    notes: List[str] = []
    retries = sum(1 for e in stage_events if e["kind"] == "retry")
    if retries:
        notes.append(f"{retries} retr{'y' if retries == 1 else 'ies'}")
    rungs = [e.get("attrs", {}).get("action") for e in stage_events
             if e["kind"] == "ladder_rung"]
    if rungs:
        notes.append(f"rung={rungs[-1]}")
    hangs = sum(1 for e in stage_events if e["kind"] == "hang_detected")
    if hangs:
        notes.append(f"{hangs} hang kill(s)")
    if any(e["kind"] == "speculation_launch" for e in stage_events):
        won = any(e["kind"] == "speculation_win" for e in stage_events)
        notes.append("speculated: " + ("won" if won else "lost"))
    trips = [e.get("attrs", {}).get("op_kind") for e in stage_events
             if e["kind"] == "breaker_trip"]
    if trips:
        notes.append(f"breaker tripped: {','.join(map(str, trips))}")
    faults_fired = sum(1 for e in stage_events
                       if e["kind"] == "fault_injected")
    if faults_fired:
        notes.append(f"{faults_fired} fault(s) injected")
    return ", ".join(notes)


def _stage_overlap(pipeline_events: List[dict]) -> Optional[int]:
    """Producer-time-weighted overlap % across a stage's pipelined
    streams (runtime/pipeline.py "pipeline_stats" events): the share of
    pool-side production hidden behind the consumer's compute. None when
    the stage ran no pipelines (serial mode or no pipelined sources)."""
    busy = wait = 0.0
    for e in pipeline_events:
        a = e.get("attrs", {})
        busy += a.get("producer_busy_ms", 0.0)
        wait += a.get("consumer_wait_ms", 0.0)
    if busy <= 0:
        return None
    return int(round(100.0 * max(0.0, 1.0 - wait / busy)))


def explain_analyze(root, run_info: Optional[dict] = None,
                    records: Optional[Iterable[dict]] = None) -> str:
    """EXPLAIN ANALYZE-style report: the operator tree with per-operator
    counters (bytes humanized, times in ms, row throughput), then
    per-stage span wall-times with resilience annotations, histogram
    percentiles and the process telemetry summaries.

    `root` is an executed Operator tree (its MetricsSet snapshots are
    read under their locks); `records` defaults to the global TraceLog —
    pass query_records(qid) to scope a multi-query log."""
    lines: List[str] = ["== EXPLAIN ANALYZE =="]

    def walk(op, depth: int) -> None:
        vals = {k: v for k, v in op.metrics.snapshot().items() if v}
        parts = [fmt_metric(k, v) for k, v in sorted(vals.items())]
        ns = vals.get("elapsed_compute_ns", 0)
        rows = vals.get("output_rows", 0)
        if ns and rows:
            parts.append(f"throughput={rows / (ns / 1e9):,.0f} rows/s")
        lines.append("  " * depth + f"{op.name()}: " + ", ".join(parts))
        for c in op.children:
            walk(c, depth + 1)

    walk(root, 0)

    recs = TRACE.snapshot() if records is None else list(records)
    stage_spans = [r for r in recs
                   if r["type"] == "span" and r["kind"] == "stage"]
    # expected-vs-observed column: with a history store configured, each
    # stage's wall time is shown against the fingerprint's historical
    # median (runtime/history.StatisticsFeed)
    feed = None
    if conf.history_dir and stage_spans:
        try:
            from blaze_tpu_torch.runtime.history import StatisticsFeed

            feed = StatisticsFeed()
        except Exception:  # noqa: BLE001 — reporting, never fatal
            feed = None
    if stage_spans:
        lines.append("-- stages --")
        for sp in stage_spans:
            a = sp.get("attrs", {})
            sid = sp.get("stage_id")
            head = (f"stage {sid} {a.get('stage_kind', '?')}"
                    f"[{a.get('transport', '-')}] "
                    f"{sp.get('dur', 0) / 1e6:.1f}ms tasks={a.get('tasks', 1)}")
            if feed is not None and a.get("fingerprint"):
                exp = feed.observed_stage_cost(a["fingerprint"])
                if exp:
                    head += (f" expect~{exp['ms_p50']:.1f}ms "
                             f"(n={exp['n']})")
            if a.get("bytes"):
                head += f" bytes={human_bytes(a['bytes'])}"
            mv, cp = a.get("moved_bytes", 0), a.get("copied_bytes", 0)
            if mv or cp:
                # copy ratio per stage: the zero-copy roadmap's target
                pct = round(100.0 * cp / mv) if mv else 0
                head += (f" moved {human_bytes(mv)}, copied "
                         f"{human_bytes(cp)} ({pct}%)")
            notes = _stage_annotations(
                [r for r in recs if r["type"] == "event"
                 and r.get("stage_id") == sid
                 and r["kind"] in _RESILIENCE_EVENT_KINDS])
            ov = _stage_overlap(
                [r for r in recs if r["type"] == "event"
                 and r.get("stage_id") == sid
                 and r["kind"] == "pipeline_stats"])
            if ov is not None:
                notes = (notes + ", " if notes else "") + f"overlap={ov}%"
            if sp.get("error"):
                notes = (notes + ", " if notes else "") + \
                    f"error={sp['error']}"
            lines.append("  " + head + (f"  [{notes}]" if notes else ""))
    qspans = [r for r in recs
              if r["type"] == "span" and r["kind"] == "query"]
    for q in qspans:
        lines.append(f"query {q.get('query_id')}: "
                     f"{q.get('dur', 0) / 1e6:.1f}ms")

    # doctor section: additive wall-time breakdown + ranked findings for
    # the (last) query span in scope (runtime/doctor.py — pure function
    # of the records, so the rendering is deterministic per run record)
    if conf.doctor_enabled and qspans:
        from blaze_tpu_torch.runtime import doctor

        qid = qspans[-1].get("query_id")
        drec = build_run_record(qid, run_info, recs)
        cp = drec.get("critical_path") or {}
        if cp.get("total_ms"):
            lines.append("-- critical path --")
            lines.extend(doctor.render_critical_path(cp))
        findings = doctor.diagnose(drec, records=query_records(qid, recs),
                                   feed=feed)
        if findings:
            lines.append("-- findings --")
            lines.extend(doctor.render_findings(findings))

    hists = histograms_snapshot()
    if hists:
        lines.append("-- distributions --")
        for name in sorted(hists):
            lines.append("  " + histogram(name).summary())

    # continuous-profiler section: top self-time frames for the (last)
    # query span in scope — the "which code, not just which stage"
    # answer, fleet-merged (executor samples federate driver-ward)
    if conf.profile_enabled:
        from blaze_tpu_torch.runtime import profiler

        hot = profiler.hot_frames(
            qspans[-1].get("query_id") if qspans else None, top=5)
        if hot:
            lines.append("-- hot frames --")
            for h in hot:
                lines.append(f"  {h['frame']:<48} {h['samples']:>6} "
                             f"samples  {h['pct']:>5.1f}%")

    from blaze_tpu_torch.runtime import compile_service, faults

    for summary in (compile_service.telemetry_summary(),
                    faults.telemetry_summary()):
        if summary:
            lines.append(summary)
    if run_info:
        shown = ", ".join(f"{k}={v}" for k, v in sorted(run_info.items())
                          if not isinstance(v, (dict, list)))
        lines.append(f"run_info: {shown}")
    return "\n".join(lines)


# -- exporter 3: run ledger (JSONL, one line per query) ----------------------


def build_run_record(query_id: str, run_info: Optional[dict] = None,
                     records: Optional[Iterable[dict]] = None) -> dict:
    """One query's ledger line: ids, durations, per-stage timings,
    run_info counters, histogram snapshots, drop accounting."""
    recs = query_records(query_id, records)
    qspan = next((r for r in recs if r["type"] == "span"
                  and r["kind"] == "query"), None)
    stages = []
    for sp in recs:
        if sp["type"] != "span" or sp["kind"] != "stage":
            continue
        a = sp.get("attrs", {})
        stages.append({"stage_id": sp.get("stage_id"),
                       "fingerprint": a.get("fingerprint"),
                       "kind": a.get("stage_kind"),
                       "transport": a.get("transport"),
                       "ms": round(sp.get("dur", 0) / 1e6, 3),
                       "tasks": a.get("tasks", 1),
                       "bytes": a.get("bytes", 0),
                       "moved_bytes": a.get("moved_bytes", 0),
                       "copied_bytes": a.get("copied_bytes", 0)})
    event_counts: Dict[str, int] = {}
    for r in recs:
        if r["type"] == "event" and r["kind"] in _RESILIENCE_EVENT_KINDS:
            event_counts[r["kind"]] = event_counts.get(r["kind"], 0) + 1
    info = run_info or {}
    rec = {
        "schema_version": SCHEMA_VERSION,
        "query_id": query_id,
        # billing/SLO attribution: every ledger line names its tenant and
        # how admission handled the query (admitted/parked/rejected +
        # wait); the service also writes lines for queries SHED at
        # admission, which never reach a query span
        "tenant_id": info.get("tenant_id", ""),
        "admission_outcome": info.get("admission_outcome", "admitted"),
        "admission_wait_ms": info.get("admission_wait_ms", 0),
        "wall_ns": qspan.get("wall") if qspan else None,
        "duration_ms": (round(qspan.get("dur", 0) / 1e6, 3)
                        if qspan else None),
        "stages": stages,
        "events": len(recs),
        "resilience_events": event_counts,
        "counters": {k: v for k, v in (run_info or {}).items()
                     if not isinstance(v, (dict, list))},
        "histograms": {
            name: {"count": s["count"], "total": s["total"],
                   "min": s["min"], "max": s["max"],
                   "p50": histogram(name).percentile(50),
                   "p95": histogram(name).percentile(95),
                   "p99": histogram(name).percentile(99)}
            for name, s in histograms_snapshot().items()},
        "dropped_events": TRACE.dropped,
    }
    # elastic-fleet evidence (runtime/autoscaler.py): while the policy
    # loop is active, every ledger line carries the fleet posture at
    # query end so doctor's fleet_under/overprovisioned rules can rank
    # offline, from the record alone
    from blaze_tpu_torch.runtime import autoscaler

    fleet = autoscaler.fleet_snapshot()
    if fleet:
        rec["fleet"] = fleet
    # streaming evidence (runtime/streaming.py): a micro-batch ledger
    # line carries its stream's lag posture so doctor's stream_lag rule
    # can rank offline, from the record alone
    if isinstance(info.get("stream"), dict):
        rec["stream"] = dict(info["stream"])
    # conf-overlay provenance (runtime/autopilot.py): the resolved
    # overlay, which layer set each value, and the canary posture — the
    # 3am "why did my query's conf change" answer, in the ledger line
    if isinstance(info.get("autopilot"), dict):
        rec["autopilot"] = dict(info["autopilot"])
    # sampling-profiler evidence (runtime/profiler.py): top self-time
    # frames so doctor's host_cpu_bound rule ranks offline, from the
    # record alone (diagnose() stays a pure function of its inputs)
    if conf.profile_enabled:
        from blaze_tpu_torch.runtime import profiler

        prof = profiler.profile_summary(query_id)
        if prof:
            rec["profile"] = prof
    if conf.doctor_enabled:
        from blaze_tpu_torch.runtime import doctor

        rec["critical_path"] = doctor.compute_critical_path(rec, recs)
    return rec


def export_run_ledger(path: str, record: dict) -> None:
    """Append one JSONL line (atomic enough for trend tooling: a single
    write() of one line; concurrent drivers interleave whole lines). A
    crash-torn tail (a prior driver died mid-write, leaving a line with
    no newline) is healed before appending, the history-store posture —
    the new record must never concatenate onto garbage."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "ab+") as f:
        if f.tell() > 0:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
        f.write((json.dumps(record, default=str) + "\n").encode())


def rotate_export_dir(export_dir: Optional[str] = None,
                      keep: Optional[int] = None) -> Dict[str, int]:
    """Bound the trace export dir: trim ledger.jsonl to its last `keep`
    lines and delete the oldest trace_<qid>.json files beyond `keep`
    (default conf.history_retention_runs). The local runner applies
    this on driver start alongside the orphan sweep — before it, the
    ledger grew one line per query forever. Returns
    {"ledger_trimmed", "traces_pruned"} (zeros when under the bound)."""
    d = export_dir or conf.trace_export_dir
    out = {"ledger_trimmed": 0, "traces_pruned": 0}
    if not d or not os.path.isdir(d):
        return out
    if keep is None:
        keep = conf.history_retention_runs
    keep = max(int(keep), 1)
    ledger = os.path.join(d, "ledger.jsonl")
    if os.path.exists(ledger):
        try:
            with open(ledger) as f:
                lines = f.readlines()
            if len(lines) > keep:
                tmp = ledger + ".tmp"
                with open(tmp, "w") as f:
                    f.writelines(lines[-keep:])
                os.replace(tmp, ledger)  # crash-atomic, like the spills
                out["ledger_trimmed"] = len(lines) - keep
        except OSError:
            pass
    try:
        traces = [os.path.join(d, n) for n in os.listdir(d)
                  if n.startswith("trace_") and n.endswith(".json")]
    except OSError:
        return out
    if len(traces) > keep:
        traces.sort(key=lambda p: (os.path.getmtime(p), p))
        for p in traces[:len(traces) - keep]:
            try:
                os.remove(p)
                out["traces_pruned"] += 1
            except OSError:
                pass
    return out


def export_query(query_id: str, run_info: Optional[dict] = None,
                 export_dir: Optional[str] = None) -> Optional[dict]:
    """Per-query auto-export (the local runner calls this at query-span
    close when conf.trace_export_dir is set): writes
    <dir>/trace_<query_id>.json and appends <dir>/ledger.jsonl."""
    d = export_dir or conf.trace_export_dir
    if not d:
        return None
    recs = query_records(query_id)
    export_chrome_trace(os.path.join(d, f"trace_{query_id}.json"), recs)
    rec = build_run_record(query_id, run_info, recs)
    export_run_ledger(os.path.join(d, "ledger.jsonl"), rec)
    return rec
