"""Black-box incident capture: one self-contained dossier per incident.

Port of blaze_tpu/runtime/flight_recorder.py, whole. A capture makes no
device call (no torch.cuda query, no tensor read): after a sticky CUDA
error the context is poisoned, and the dossier of that failure must
still be written. A dossier's `executor_pool` is
executor_pool.pool_stats(): None while no pool is active.

The observability ladder (trace ring -> monitor -> history -> doctor) is
aggregate and postmortem: when a query fails, is shed, blows its
deadline, breaches its tenant SLO, trips a breaker, or leaks resources,
the evidence evaporates with the bounded rings unless an operator was
exporting at that exact moment. This module is the flight recorder: at
the moment an incident fires, it snapshots everything the rings know
about the query and commits it crash-atomically (artifacts.commit_file:
temp + fsync + os.replace) as one JSON *dossier* under conf.flight_dir —
one file answers "what happened to query X at 3am".

  triggers   failure / shed / deadline / hang / slo_breach /
             breaker_trip / resource_leak / executor_death /
             driver_restart / driver_failover — each (query, trigger)
             pair captures at most ONCE (a retry storm must not write
             a dossier per retry; a standby takeover writes exactly one
             driver_failover dossier, keyed on its lease epoch).
             conf.flight_triggers ("all" or a comma list) selects
             which classes arm.

  contents   schema-versioned: the query's trace-ring slice, the
             monitor ring's gauge samples over the query's lifetime,
             the doctor's additive critical-path breakdown + ranked
             findings, the resolved knob overlay, per-stage
             StatisticsFeed expectations (and which stages violated
             them), all thread stacks (sys._current_frames) for
             hang/deadline triggers, an executor-pool snapshot
             (pool_stats) when a pool is live, and the run-ledger
             line. Pooled queries need no special casing: the
             trace-ring slice already contains the federated
             executor-side spans (trace.ingest_remote appends them to
             the driver ring), and executor_death dossiers embed the
             worker's recovered sidecar ring slice under
             detail["executor_trace"] (stamped by executor_pool's
             death path).

  retention  the newest conf.flight_retention dossiers are kept; older
             ones are pruned after each capture.

Everything is gated on `conf.flight_dir` truthiness — unset (the
default), every hook is one check. Capture itself must never mask the
incident it is recording: any internal failure is swallowed into
`last_error()` and the original exception keeps propagating.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

from typing import Any, Dict, List, Optional

from blaze_tpu_torch.config import KNOBS, conf
from blaze_tpu_torch.runtime import artifacts, monitor, trace

# dossier wire format; bump on shape changes. Readers (blaze_inspect)
# treat unknown versions as opaque but still render the common fields.
SCHEMA_VERSION = 1

TRIGGERS = ("failure", "shed", "deadline", "hang", "slo_breach",
            "breaker_trip", "resource_leak", "executor_death",
            "driver_restart", "driver_failover", "stream_stall",
            "autopilot_rollback")

_lock = threading.Lock()
_captured: set = set()            # (query_id, trigger): exactly-once
_stacks: Dict[str, dict] = {}     # qid -> stacks recorded at kill time
# qid -> (final run_info, t0): stashed at query end so POST-run captures
# (the service's slo_breach scoring fires after run_plan returns) still
# build a ledger with the full monitor counter roll-up
_run_infos: Dict[str, tuple] = {}
_counts: Dict[str, int] = {}      # trigger -> dossiers written
_last_error: Optional[str] = None
# dedupe-set bound: far above any real incident rate; clearing risks a
# duplicate dossier only after 4096 *distinct* incidents in one process
_CAPTURED_MAX = 4096
_STACKS_MAX = 32
_RUN_INFOS_MAX = 64


def enabled(trigger: str) -> bool:
    """One-truthiness-check gate all hook sites share."""
    if not conf.flight_dir:
        return False
    spec = (conf.flight_triggers or "all").strip()
    if spec in ("all", "*", ""):
        return True
    return trigger in {t.strip() for t in spec.split(",")}


def counts() -> Dict[str, int]:
    """Dossiers written per trigger (feeds blaze_flight_dossiers_total)."""
    with _lock:
        return dict(_counts)


def last_error() -> Optional[str]:
    """The most recent swallowed capture failure (debugging aid)."""
    with _lock:
        return _last_error


def reset() -> None:
    """Clear in-memory state (test isolation) — files are left alone."""
    global _last_error
    with _lock:
        _captured.clear()
        _stacks.clear()
        _run_infos.clear()
        _counts.clear()
        _last_error = None


# -- thread stacks -----------------------------------------------------------


def thread_stacks() -> List[Dict[str, Any]]:
    """Every live thread's stack via sys._current_frames(), names from
    threading.enumerate() — the "where was everyone" page of the dossier
    for hang/deadline incidents."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append({
            "thread_id": ident,
            "name": names.get(ident, "?"),
            "frames": [ln.rstrip("\n")
                       for ln in traceback.format_stack(frame)],
        })
    return out


def record_stacks(query_id: Optional[str], reason: str) -> None:
    """Stash stacks at the MOMENT of a watchdog kill (supervisor._scan):
    by the time the DeadlineError/HungError propagates out of run_plan
    the hung frames are gone, so the watchdog captures them live and the
    dossier written later prefers this stash over a fresh capture."""
    if not query_id or not conf.flight_dir:
        return
    rec = {"reason": reason, "wall": time.time(), "stacks": thread_stacks()}
    with _lock:
        if len(_stacks) >= _STACKS_MAX:
            _stacks.pop(next(iter(_stacks)))
        _stacks[query_id] = rec


# -- capture -----------------------------------------------------------------


def _knob_overlay() -> Dict[str, Any]:
    """The resolved knob set, JSON-safe (non-scalar values repr'd)."""
    out: Dict[str, Any] = {}
    for name in sorted(KNOBS):
        try:
            v = getattr(conf, name)
        except Exception:  # noqa: BLE001 — capture must never fail
            continue
        if isinstance(v, (bool, int, float, str, type(None))):
            out[name] = v
        else:
            out[name] = repr(v)
    return out


def _expectations(ledger: dict, feed) -> List[Dict[str, Any]]:
    """Per-stage fingerprint vs StatisticsFeed history: what the stage
    cost, what history predicted (p50/p95), and whether it violated the
    p95 expectation — the "was this run anomalous" page."""
    out: List[Dict[str, Any]] = []
    if feed is None:
        return out
    for st in ledger.get("stages", ()):
        fp = st.get("fingerprint")
        if not fp:
            continue
        exp = feed.observed_stage_cost(fp)
        if not exp:
            continue
        ms = st.get("ms") or 0.0
        out.append({
            "stage_id": st.get("stage_id"),
            "fingerprint": fp,
            "ms": ms,
            "expected_ms_p50": exp.get("ms_p50"),
            "expected_ms_p95": exp.get("ms_p95"),
            "n": exp.get("n"),
            "violated": bool(exp.get("ms_p95") is not None
                             and ms > exp["ms_p95"]),
        })
    return out


def capture(trigger: str, query_id: Optional[str], *,
            tenant_id: Optional[str] = None,
            error: Optional[BaseException] = None,
            run_info: Optional[dict] = None,
            detail: Optional[dict] = None,
            include_stacks: bool = False,
            started_at: Optional[float] = None) -> Optional[str]:
    """Write one dossier for `trigger` on `query_id`; returns the path,
    or None when disabled / already captured / capture failed. Never
    raises — this runs inside failure paths."""
    global _last_error
    if not query_id or not enabled(trigger):
        return None
    with _lock:
        key = (query_id, trigger)
        if key in _captured:
            return None
        if len(_captured) >= _CAPTURED_MAX:
            _captured.clear()
        _captured.add(key)
    try:
        return _capture_locked_out(trigger, query_id, tenant_id, error,
                                   run_info, detail, include_stacks,
                                   started_at)
    except Exception as e:  # noqa: BLE001 — must not mask the incident
        with _lock:
            _last_error = f"{type(e).__name__}: {e}"
        return None


def _capture_locked_out(trigger, query_id, tenant_id, error, run_info,
                        detail, include_stacks, started_at) -> str:
    now = time.time()
    recs = trace.query_records(query_id)
    # a capture firing after run_plan returned (the service's SLO
    # scoring) has neither run_info nor the monitor acct — fall back to
    # the roll-up on_query_end stashed
    with _lock:
        stashed_info = _run_infos.get(query_id)
    if run_info is None and stashed_info is not None:
        run_info = stashed_info[0]
    # monitor ring slice over the query's lifetime: prefer the live
    # accumulator's t0 (query still registered), else the caller's
    t0 = started_at
    if t0 is None:
        t0 = monitor.query_t0(query_id)
    if t0 is None and stashed_info is not None:
        t0 = stashed_info[1]
    samples = monitor.ring_slice(t0)

    info = dict(run_info or {})
    if tenant_id and "tenant_id" not in info:
        info["tenant_id"] = tenant_id
    ledger = trace.build_run_record(query_id, info, recs)

    from blaze_tpu_torch.runtime import doctor

    critical_path = ledger.get("critical_path")
    if critical_path is None:
        critical_path = doctor.compute_critical_path(ledger, recs)
    feed = None
    if conf.history_dir:
        try:
            from blaze_tpu_torch.runtime.history import StatisticsFeed

            feed = StatisticsFeed()
        except Exception:  # noqa: BLE001 — history is optional context
            feed = None
    findings = [f.to_dict() for f in
                doctor.diagnose(ledger, records=recs, feed=feed,
                                critical_path=critical_path)]

    with _lock:
        stashed = _stacks.get(query_id)
    stacks_doc = stashed
    if stacks_doc is None and include_stacks:
        stacks_doc = {"reason": trigger, "wall": now,
                      "stacks": thread_stacks()}

    doc: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "captured_at": now,
        "trigger": trigger,
        "query_id": query_id,
        "tenant_id": tenant_id or info.get("tenant_id") or "",
        "error": ({"type": type(error).__name__,
                   "message": str(error)[:2000]}
                  if error is not None else None),
        "detail": detail,
        "knobs": _knob_overlay(),
        # conf-overlay provenance (runtime/autopilot.py): the resolved
        # overlay + which layer (tenant/fingerprint/pin) set each value
        # and the canary posture — "why did my query's conf change"
        "autopilot": (dict(info["autopilot"])
                      if isinstance(info.get("autopilot"), dict)
                      else None),
        "trace_events": recs,
        "trace_dropped": trace.TRACE.dropped,
        "monitor_samples": samples,
        "critical_path": critical_path,
        "findings": findings,
        "expectations": _expectations(ledger, feed),
        "thread_stacks": stacks_doc,
        "ledger": ledger,
    }
    # continuous-profiler upgrade (runtime/profiler.py): the aggregated
    # window the sampler collected around the incident — what the code
    # was doing leading up to the hang/deadline, fleet-merged, instead
    # of only the single thread_stacks instant above. Exactly-once per
    # (query, trigger) rides the existing _captured dedup.
    if conf.profile_enabled:
        from blaze_tpu_torch.runtime import profiler

        doc["profile_window"] = profiler.window(query_id)
    else:
        doc["profile_window"] = None
    try:
        from blaze_tpu_torch.runtime import executor_pool

        doc["executor_pool"] = executor_pool.pool_stats()
    except Exception:  # noqa: BLE001 — pool snapshot is optional context
        doc["executor_pool"] = None

    os.makedirs(conf.flight_dir, exist_ok=True)
    qid_safe = "".join(ch if ch.isalnum() or ch in "-_" else "_"
                       for ch in query_id)
    name = f"dossier_{int(now * 1000):013d}_{trigger}_{qid_safe}.json"
    path = os.path.join(conf.flight_dir, name)
    payload = json.dumps(doc, indent=1, default=str)

    def _write(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(payload)

    artifacts.commit_file(_write, path)
    _prune()
    with _lock:
        _counts[trigger] = _counts.get(trigger, 0) + 1
    trace.event("flight_capture", query_id=query_id, trigger=trigger,
                dossier=name)
    return path


def _prune() -> None:
    """Bounded retention: keep the newest conf.flight_retention dossiers
    (filenames embed a millisecond stamp, so name order is time order)."""
    keep = max(int(conf.flight_retention), 1)
    try:
        names = sorted(n for n in os.listdir(conf.flight_dir)
                       if n.startswith("dossier_") and n.endswith(".json"))
    except OSError:
        return
    for n in names[:max(len(names) - keep, 0)]:
        try:
            os.remove(os.path.join(conf.flight_dir, n))
        except OSError:
            pass


# -- query-end hook (spark/local_runner.run_plan finally block) --------------


def on_query_end(query_id: str, run_info: Optional[dict],
                 started_at: Optional[float] = None) -> None:
    """Classify how the query ended and capture accordingly. Called from
    run_plan's finally AFTER the monitor roll-up (so the ledger line in
    the dossier carries the full counters) — inside a finally the
    propagating exception is visible via sys.exc_info()."""
    if not conf.flight_dir:
        return
    from blaze_tpu_torch.runtime import faults

    with _lock:
        if len(_run_infos) >= _RUN_INFOS_MAX:
            _run_infos.pop(next(iter(_run_infos)))
        _run_infos[query_id] = (dict(run_info or {}), started_at)
    exc = sys.exc_info()[1]
    if isinstance(exc, Exception):
        if isinstance(exc, faults.DeadlineError):
            trigger = "deadline"
        elif isinstance(exc, faults.HungError):
            trigger = "hang"
        elif isinstance(exc, faults.AdmissionRejected):
            trigger = "shed"
        else:
            trigger = "failure"
        capture(trigger, query_id, error=exc, run_info=run_info,
                include_stacks=trigger in ("deadline", "hang"),
                started_at=started_at)
    if run_info and run_info.get("resource_leaks"):
        capture("resource_leak", query_id, run_info=run_info,
                detail={"resource_leaks": run_info["resource_leaks"]},
                started_at=started_at)
    with _lock:
        _stacks.pop(query_id, None)


# -- reading (tools/blaze_inspect.py) ----------------------------------------


def list_dossiers(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """Newest-first summaries of the dossiers in `directory` (default
    conf.flight_dir): path, trigger, query, tenant, error, top finding."""
    d = directory or conf.flight_dir
    if not d or not os.path.isdir(d):
        return []
    out = []
    for n in sorted(os.listdir(d), reverse=True):
        if not (n.startswith("dossier_") and n.endswith(".json")):
            continue
        path = os.path.join(d, n)
        try:
            doc = load(path)
        except (OSError, ValueError):
            continue
        findings = doc.get("findings") or []
        out.append({
            "path": path,
            "schema_version": doc.get("schema_version"),
            "captured_at": doc.get("captured_at"),
            "trigger": doc.get("trigger"),
            "query_id": doc.get("query_id"),
            "tenant_id": doc.get("tenant_id"),
            "error": (doc.get("error") or {}).get("type")
            if doc.get("error") else None,
            "top_finding": findings[0].get("code") if findings else None,
        })
    return out


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
