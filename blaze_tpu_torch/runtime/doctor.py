"""Query doctor: critical-path extraction + rule-based bottleneck
diagnosis over the run ledger and exported traces.

Port of blaze_tpu/runtime/doctor.py, whole: pure functions of the
records, so the same ledger line gives the same breakdown and findings
in both packages. The port has no compile service yet (ROADMAP Queue 1,
item 4): no run_info carries `compile_ms`, so the `compile` term reads 0
and compile_storm never fires on the port's own records. On the card a
fused chain's `device_compute` is its host dispatch time (kernels launch
asynchronously), so device work that outlasts its launch surfaces in the
term of the next host sync: serde_encode, a host pull, or residual.

The runtime emits rich raw telemetry — span rings with correlation ids
(trace.py), copy-boundary byte and boundary-time counters (monitor.py),
plan-fingerprinted history (history.py), per-tenant ledger lines
(service.py) — but nothing *interprets* it. This module closes that
loop:

  critical path   `compute_critical_path(record, records)` decomposes a
                  query's wall time into an ADDITIVE breakdown:
                  admission wait, fair-scheduler queue wait, compile,
                  device compute, host compute, serde encode/decode,
                  shuffle I/O, spill, retry/backoff, speculation waste,
                  result merge, residual. Task-thread terms are measured
                  wall-clock per category (monitor.count_time) and can
                  overlap under the concurrent pool, so they are scaled
                  by the query's effective parallelism (`parallel_scale`)
                  to fit inside the measured query span — the breakdown
                  always sums to the measured wall time by construction,
                  with `residual` naming the un-attributed driver
                  overhead instead of hiding it. The longest task chain
                  per stage (`chains`) names the attempt sequence that
                  bounded each stage's wall time.

  findings        `diagnose(record, ...)` runs a fixed rule catalog and
                  returns ranked, typed `Finding`s — each with a score
                  (share of wall time explained), machine-readable
                  evidence (stage/task ids, fingerprints, byte counts)
                  and one suggested knob. Rules: serde_bound,
                  skewed_partition, straggler_dominated, spill_bound,
                  compile_storm, admission_starved, queue_contended,
                  breaker_degraded, network_flaky, pipeline_underlap,
                  executor_skew, fleet_underprovisioned,
                  fleet_overprovisioned, stream_lag,
                  regression_vs_history. The
                  executor_skew rule is pooled-run only: federated task
                  spans carry the shipping worker's exec id (stamped by
                  trace.ingest_remote), so the doctor can attribute
                  wall time per executor process and flag one worker
                  dominating the pool.

Everything here is a PURE function of its inputs (ledger record + span
records [+ StatisticsFeed]): no clocks, no randomness, stable sort
orders — the same trace dir always produces byte-identical findings, so
chaos soak and `make check-doctor` can gate on the output. The CLI over
exported artifacts lives in tools/blaze_doctor.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from blaze_tpu_torch.config import conf

__all__ = ["Finding", "TERMS", "compute_critical_path", "diagnose",
           "render_critical_path", "render_findings", "load_ledger",
           "load_trace_records", "diagnose_dir"]

# additive breakdown terms, in render order. All task-thread terms
# (everything between "sched_queue" and "result_merge") are measured on
# concurrent pool threads and scaled together by parallel_scale.
TERMS = (
    "admission_wait",     # service: parked in the admission waiting room
    "sched_queue",        # FairScheduler: submitted -> dispatched
    "compile",            # compile_service: XLA compile time
    "device_compute",     # executor: jit-safe fused-chain batch time
    "host_compute",       # executor: host-path fused-chain batch time
    "serde_encode",       # columnar/serde: encode (compress + frame)
    "serde_decode",       # columnar/serde: decode (read + decompress)
    "shuffle_io",         # ops/shuffle: map-output commit to disk
    "spill",              # memory: spill file write time
    "retry_backoff",      # executor: sleep between retry attempts
    "speculation_waste",  # supervisor: losing speculative attempts
    "result_merge",       # local_runner: result-stage merge
    "residual",           # everything un-attributed (driver overhead)
)

# run-record counter key -> term (monitor.count_time categories land in
# run_info as <category>_ms via monitor.query_end)
_COUNTER_TERMS = (
    ("sched_queue_ms", "sched_queue"),
    ("compile_ms", "compile"),
    ("device_compute_ms", "device_compute"),
    ("host_compute_ms", "host_compute"),
    ("serde_encode_ms", "serde_encode"),
    ("serde_decode_ms", "serde_decode"),
    ("shuffle_io_ms", "shuffle_io"),
    ("spill_ms", "spill"),
    ("retry_backoff_ms", "retry_backoff"),
)

# rule thresholds (absolute floors keep clean small queries finding-free)
_MIN_TERM_MS = 50.0        # a term below this never becomes a finding
_MIN_TERM_SHARE = 0.30     # ... nor below this share of wall time
_MIN_STAGE_SHARE = 0.20    # skew/straggler need a significant stage
_MIN_ADMISSION_MS = 100.0
_MIN_ADMISSION_SHARE = 0.25
_MIN_QUEUE_SHARE = 0.25
_MIN_SPILL_SHARE = 0.20
_UNDERLAP_PCT = 40         # pipeline overlap below this is "underlap"


@dataclass
class Finding:
    """One diagnosis: `code` is the typed rule name, `score` the share
    of query wall time the finding explains (ranking key), `evidence`
    machine-readable span ids / fingerprints / byte counts, and
    `suggestion` the knob to turn."""

    code: str
    score: float
    summary: str
    suggestion: str
    evidence: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "score": round(self.score, 4),
                "summary": self.summary, "suggestion": self.suggestion,
                "evidence": self.evidence}


def _r(v: float) -> float:
    return round(float(v), 3)


# -- critical path -----------------------------------------------------------


def _task_spans(records: Iterable[dict]) -> List[dict]:
    return [r for r in records
            if r.get("type") == "span" and r.get("kind") == "task_attempt"]


def _stage_spans(records: Iterable[dict]) -> List[dict]:
    return [r for r in records
            if r.get("type") == "span" and r.get("kind") == "stage"]


def _dur_ms(rec: dict) -> float:
    return rec.get("dur", 0) / 1e6


def _chains(records: Iterable[dict]) -> List[dict]:
    """Longest task chain per stage: the task whose attempt sequence
    (retries + speculation included) accumulated the most wall time —
    the chain that bounded the stage."""
    recs = list(records)
    out: List[dict] = []
    for sp in sorted(_stage_spans(recs),
                     key=lambda s: (str(s.get("stage_id")),)):
        sid = sp.get("stage_id")
        per_task: Dict[str, List[dict]] = {}
        for t in _task_spans(recs):
            if t.get("stage_id") == sid and t.get("task_id") is not None:
                per_task.setdefault(str(t["task_id"]), []).append(t)
        if not per_task:
            continue
        chain_ms = {tid: sum(_dur_ms(t) for t in spans)
                    for tid, spans in per_task.items()}
        # deterministic winner: longest chain, ties by task id
        top = sorted(chain_ms, key=lambda tid: (-chain_ms[tid], tid))[0]
        out.append({"stage_id": sid, "task_id": top,
                    "attempts": len(per_task[top]),
                    "ms": _r(chain_ms[top]),
                    "stage_ms": _r(_dur_ms(sp))})
    return out


def _speculation_waste_ms(records: Iterable[dict]) -> float:
    """Wall time burned by attempts that lost a commit race or were
    abandoned after a kill — resource waste, attributed so the breakdown
    names it instead of folding it into compute."""
    waste = 0.0
    for t in _task_spans(records):
        a = t.get("attrs") or {}
        if a.get("kill_reason") or t.get("error"):
            waste += _dur_ms(t)
        elif a.get("speculative") and not a.get("won", True):
            waste += _dur_ms(t)
    return waste


def compute_critical_path(record: dict,
                          records: Optional[Iterable[dict]] = None
                          ) -> dict:
    """Additive wall-time breakdown for one run record (a ledger line /
    `trace.build_run_record` dict), optionally refined with the query's
    raw span records (trace-internal format; use `load_trace_records`
    to lift an exported Chrome trace back into it).

    total_ms = admission_wait + query-span duration, exactly; terms
    measured on concurrent task threads are scaled by `parallel_scale`
    so their sum fits the measured span, and `residual` absorbs what no
    instrument claimed. Pure + deterministic."""
    recs = list(records) if records is not None else []
    counters = record.get("counters") or {}
    admission_ms = float(record.get("admission_wait_ms") or 0.0)
    exec_ms = float(record.get("duration_ms") or 0.0)
    total_ms = admission_ms + exec_ms

    terms: Dict[str, float] = {t: 0.0 for t in TERMS}
    terms["admission_wait"] = admission_ms
    for key, term in _COUNTER_TERMS:
        try:
            terms[term] = max(float(counters.get(key, 0.0) or 0.0), 0.0)
        except (TypeError, ValueError):
            terms[term] = 0.0
    terms["result_merge"] = sum(
        float(s.get("ms") or 0.0) for s in (record.get("stages") or [])
        if s.get("kind") == "result")
    if recs:
        terms["speculation_waste"] = _speculation_waste_ms(recs)

    # scale concurrent-thread terms into the measured query span: they
    # are real wall-clock per category but can overlap under the pool
    scaled = [t for t in TERMS if t not in ("admission_wait", "residual")]
    attributed = sum(terms[t] for t in scaled)
    scale = 1.0
    if exec_ms > 0 and attributed > exec_ms:
        scale = exec_ms / attributed
        for t in scaled:
            terms[t] *= scale
    terms["residual"] = max(
        exec_ms - sum(terms[t] for t in scaled), 0.0)

    ranked = sorted((t for t in TERMS if t != "residual"),
                    key=lambda t: (-terms[t], TERMS.index(t)))
    out = {
        "total_ms": _r(total_ms),
        "terms": {t: _r(terms[t]) for t in TERMS},
        "top_term": ranked[0] if ranked and terms[ranked[0]] > 0 else "",
        "parallel_scale": round(scale, 4),
        "chains": _chains(recs),
    }
    return out


def render_critical_path(cp: dict) -> List[str]:
    """explain_analyze lines for one breakdown (indented, no header)."""
    lines: List[str] = []
    total = cp.get("total_ms") or 0.0
    for term in TERMS:
        ms = (cp.get("terms") or {}).get(term, 0.0)
        if not ms:
            continue
        pct = 100.0 * ms / total if total else 0.0
        mark = " <- top" if term == cp.get("top_term") else ""
        lines.append(f"  {term:<17} {ms:9.1f}ms {pct:5.1f}%{mark}")
    if cp.get("parallel_scale", 1.0) < 1.0:
        lines.append(f"  (task-thread terms scaled x"
                     f"{cp['parallel_scale']:.2f} to fit the span)")
    for ch in cp.get("chains") or []:
        lines.append(
            f"  chain stage {ch['stage_id']}: task {ch['task_id']} "
            f"{ch['ms']:.1f}ms/{ch['stage_ms']:.1f}ms stage "
            f"({ch['attempts']} attempt(s))")
    return lines


# -- diagnosis rules ---------------------------------------------------------


def _share(cp: dict, *terms: str) -> float:
    total = cp.get("total_ms") or 0.0
    if total <= 0:
        return 0.0
    return sum((cp.get("terms") or {}).get(t, 0.0) for t in terms) / total


def _term_ms(cp: dict, *terms: str) -> float:
    return sum((cp.get("terms") or {}).get(t, 0.0) for t in terms)


def _stage_task_durs(records: List[dict], sid) -> List[float]:
    """Per-task effective duration for one stage: winning attempt per
    task (clean attempts preferred), sorted ascending."""
    per_task: Dict[str, float] = {}
    for t in _task_spans(records):
        if t.get("stage_id") != sid or t.get("task_id") is None:
            continue
        a = t.get("attrs") or {}
        if a.get("kill_reason") or t.get("error"):
            continue
        tid = str(t["task_id"])
        per_task[tid] = max(per_task.get(tid, 0.0), _dur_ms(t))
    return sorted(per_task.values())


def _median(vals: List[float]) -> float:
    if not vals:
        return 0.0
    n = len(vals)
    mid = n // 2
    if n % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def diagnose(record: dict,
             records: Optional[Iterable[dict]] = None,
             feed=None,
             critical_path: Optional[dict] = None) -> List[Finding]:
    """Run the rule catalog over one run record; returns findings ranked
    worst-first ((-score, code) — deterministic). `records` enables the
    span-level rules (skew/straggler/underlap); `feed` (a
    history.StatisticsFeed) enables regression-vs-history."""
    recs = list(records) if records is not None else []
    cp = critical_path or record.get("critical_path") \
        or compute_critical_path(record, recs)
    counters = record.get("counters") or {}
    resil = record.get("resilience_events") or {}
    total = cp.get("total_ms") or 0.0
    findings: List[Finding] = []

    # serde_bound: encode+decode dominate the breakdown. Evidence now
    # carries the zero-copy data plane's counters (mmap hit ratio, dict
    # columns shipped encoded, residual copied bytes by boundary) so the
    # suggestion can name the knob that is actually OFF instead of
    # always reaching for frame size.
    serde_ms = _term_ms(cp, "serde_encode", "serde_decode")
    if serde_ms >= _MIN_TERM_MS and \
            _share(cp, "serde_encode", "serde_decode") >= _MIN_TERM_SHARE:
        mmap_hits = counters.get("shuffle_mmap_hits", 0)
        mmap_falls = counters.get("shuffle_mmap_fallbacks", 0)
        dict_cols = counters.get("dict_cols_encoded", 0)
        sh_copied = counters.get("bytes_copied_shuffle", 0)
        sh_moved = counters.get("bytes_moved_shuffle", 0)
        attempts = mmap_hits + mmap_falls
        findings.append(Finding(
            "serde_bound", _share(cp, "serde_encode", "serde_decode"),
            f"serde encode/decode took {serde_ms:.0f}ms "
            f"({100 * _share(cp, 'serde_encode', 'serde_decode'):.0f}% "
            f"of wall time)",
            # suggestion stays an inline literal expression so the
            # doctor-knob-sync checker (and the autopilot's verb parser)
            # can see every conf.<knob> mention statically
            ("raise conf.shuffle_mmap_enabled (serve same-host shuffle "
             "fetches as zero-copy mmap views instead of socket "
             "streams) and raise conf.dict_encode_strings (ship string "
             "columns as i32 codes)")
            if sh_copied > 0 and mmap_hits == 0 else
            ("raise conf.dict_encode_strings (ship string columns "
             "dictionary-encoded so filter/join/groupby run on i32 "
             "codes) or raise conf.target_batch_bytes (fewer, larger "
             "frames)")
            if counters.get("bytes_copied_serde", 0) > 0
            and dict_cols == 0 else
            ("raise conf.target_batch_bytes (fewer, larger frames) or "
             "keep shuffle host-format to amortize per-frame encode"),
            {"serde_encode_ms": _r(_term_ms(cp, "serde_encode")),
             "serde_decode_ms": _r(_term_ms(cp, "serde_decode")),
             "bytes_copied_serde": counters.get("bytes_copied_serde", 0),
             "bytes_copied_shuffle": sh_copied,
             "bytes_moved_shuffle": sh_moved,
             "shuffle_mmap_hits": mmap_hits,
             "shuffle_mmap_fallbacks": mmap_falls,
             "shuffle_mmap_hit_ratio":
                 _r(mmap_hits / attempts) if attempts else 0.0,
             "dict_cols_encoded": dict_cols}))

    # host_cpu_bound: the host_compute term dominates AND the sampling
    # profiler names the code — the term alone is a black box; the
    # run record's "profile" block (runtime/profiler.py, attached by
    # build_run_record while conf.profile_enabled) turns it into an
    # actionable top-self-time-frames list
    prof = record.get("profile") or {}
    hot = prof.get("hot_frames") or []
    host_ms = _term_ms(cp, "host_compute")
    if hot and host_ms >= _MIN_TERM_MS and \
            _share(cp, "host_compute") >= _MIN_TERM_SHARE:
        top = hot[0]
        findings.append(Finding(
            "host_cpu_bound", _share(cp, "host_compute"),
            f"host-side compute took {host_ms:.0f}ms "
            f"({100 * _share(cp, 'host_compute'):.0f}% of wall time); "
            f"top frame {top.get('frame')} "
            f"({top.get('pct')}% of samples)",
            "inspect the flamegraph (conf.profile_export_dir exports "
            "collapsed stacks per query) and raise "
            "conf.target_batch_bytes so per-batch host overhead "
            "amortizes over more rows",
            {"host_compute_ms": _r(host_ms),
             "profiled_samples": prof.get("samples", 0),
             "hot_frames": hot}))

    # skew / straggler: one task bounds a significant stage
    skew_ratio = max(float(conf.doctor_skew_ratio), 1.0)
    for ch in cp.get("chains") or []:
        sid = ch["stage_id"]
        stage_ms = ch.get("stage_ms") or 0.0
        if total <= 0 or stage_ms / total < _MIN_STAGE_SHARE:
            continue
        durs = _stage_task_durs(recs, sid)
        if len(durs) < 2:
            continue
        med, worst = _median(durs), durs[-1]
        if worst < _MIN_TERM_MS or med <= 0 or worst / med < skew_ratio:
            continue
        stage_events = [r for r in recs if r.get("type") == "event"
                        and r.get("stage_id") == sid]
        env = [e for e in stage_events
               if e.get("kind") in ("speculation_launch", "hang_detected",
                                    "retry", "hang_relaunch")]
        score = 0.8 * (worst - med) / total
        evidence = {"stage_id": sid, "task_id": ch["task_id"],
                    "worst_ms": _r(worst), "median_ms": _r(med),
                    "ratio": _r(worst / med), "tasks": len(durs)}
        if env:
            evidence["env_events"] = sorted(
                {str(e.get("kind")) for e in env})
            findings.append(Finding(
                "straggler_dominated", score,
                f"stage {sid} bounded by straggling task "
                f"{ch['task_id']} ({worst:.0f}ms vs {med:.0f}ms median, "
                f"with {len(env)} environmental event(s))",
                "lower conf.speculation_multiplier to launch twins "
                "earlier, or lower conf.hang_detect_ms",
                evidence))
        else:
            findings.append(Finding(
                "skewed_partition", score,
                f"stage {sid} bounded by skewed task {ch['task_id']} "
                f"({worst:.0f}ms vs {med:.0f}ms median, "
                f"x{worst / med:.1f})",
                "repartition on a higher-cardinality key (raise the "
                "run_plan num_partitions argument) and lower "
                "conf.speculation_multiplier so a twin can cover the "
                "hot partition",
                evidence))

    # executor_skew: one pooled worker dominates federated wall time.
    # Only federated (executor-shipped) task spans carry "exec" — on
    # rehydrated traces it survives inside attrs — so in-process runs
    # (no exec ids) never trigger this rule.
    exec_ms: Dict[str, float] = {}
    for t in _task_spans(recs):
        ex = t.get("exec") or (t.get("attrs") or {}).get("exec")
        if not ex:
            continue
        exec_ms[str(ex)] = exec_ms.get(str(ex), 0.0) + _dur_ms(t)
    if len(exec_ms) >= 2 and total > 0:
        evals = sorted(exec_ms.values())
        # median of the OTHER executors, not of all: pools are small
        # (2-4 seats), and with 2 seats a median including the dominant
        # worker averages it in — worst/median could never reach the
        # ratio no matter how lopsided the pool
        emed, eworst = _median(evals[:-1]), evals[-1]
        etop = sorted(exec_ms, key=lambda e: (-exec_ms[e], e))[0]
        if (eworst >= _MIN_TERM_MS and emed > 0
                and eworst / emed >= skew_ratio
                and eworst / total >= _MIN_STAGE_SHARE):
            findings.append(Finding(
                "executor_skew",
                min(0.8 * (eworst - emed) / total, 1.0),
                f"executor {etop} dominated pooled wall time "
                f"({eworst:.0f}ms vs {emed:.0f}ms median across "
                f"{len(exec_ms) - 1} other executor(s))",
                "rebalance partitions (raise num_partitions) or raise "
                "conf.executor_slots so the pool can spread hot tasks",
                {"exec_id": etop, "worst_ms": _r(eworst),
                 "median_ms": _r(emed), "ratio": _r(eworst / emed),
                 "executors": len(exec_ms)}))

    # spill_bound: spill I/O claims real wall time (quota pressure)
    spill_share = _share(cp, "spill")
    spill_bytes = counters.get("spill_bytes", 0) or 0
    if _term_ms(cp, "spill") >= _MIN_TERM_MS and \
            spill_share >= _MIN_SPILL_SHARE:
        findings.append(Finding(
            "spill_bound", spill_share,
            f"spill I/O took {_term_ms(cp, 'spill'):.0f}ms "
            f"({int(spill_bytes)} bytes spilled)",
            "raise conf.memory_budget or this tenant's share in "
            "conf.tenant_quota_spec",
            {"spill_ms": _r(_term_ms(cp, "spill")),
             "spill_bytes": spill_bytes,
             "spill_count": counters.get("spill_count", 0)}))

    # compile_storm: compile dominates and the cache is missing
    misses = counters.get("compile_cache_misses", 0) or 0
    hits = counters.get("compile_cache_hits", 0) or 0
    if _term_ms(cp, "compile") >= _MIN_TERM_MS and \
            _share(cp, "compile") >= _MIN_TERM_SHARE and misses > hits:
        findings.append(Finding(
            "compile_storm", _share(cp, "compile"),
            f"XLA compile took {_term_ms(cp, 'compile'):.0f}ms with "
            f"{misses} cache miss(es) vs {hits} hit(s)",
            "pre-warm the persistent compile cache (`make warm`) and "
            "keep conf.enable_compile_canonicalization on so capacity "
            "buckets collapse onto fewer compiled shapes",
            {"compile_ms": _r(_term_ms(cp, "compile")),
             "compile_cache_misses": misses, "compile_cache_hits": hits}))

    # admission_starved: the waiting room ate the latency budget
    adm_ms = _term_ms(cp, "admission_wait")
    outcome = record.get("admission_outcome") or "admitted"
    if outcome == "rejected" or (
            adm_ms >= _MIN_ADMISSION_MS
            and _share(cp, "admission_wait") >= _MIN_ADMISSION_SHARE):
        findings.append(Finding(
            "admission_starved",
            1.0 if outcome == "rejected" else _share(cp, "admission_wait"),
            (f"query shed at admission after {adm_ms:.0f}ms"
             if outcome == "rejected" else
             f"query waited {adm_ms:.0f}ms for a run slot "
             f"({100 * _share(cp, 'admission_wait'):.0f}% of wall)"),
            "raise conf.max_concurrent_queries / "
            "conf.admission_queue_depth, or this tenant's weight in "
            "conf.tenant_priority_spec",
            {"tenant_id": record.get("tenant_id", ""),
             "admission_outcome": outcome,
             "admission_wait_ms": _r(adm_ms)}))

    # queue_contended: dispatch waits in the fair scheduler
    if _term_ms(cp, "sched_queue") >= _MIN_TERM_MS and \
            _share(cp, "sched_queue") >= _MIN_QUEUE_SHARE:
        findings.append(Finding(
            "queue_contended", _share(cp, "sched_queue"),
            f"tasks waited {_term_ms(cp, 'sched_queue'):.0f}ms in the "
            f"fair-scheduler queue",
            "raise conf.max_concurrent_tasks or this tenant's weight in "
            "conf.tenant_priority_spec",
            {"sched_queue_ms": _r(_term_ms(cp, "sched_queue"))}))

    # breaker_degraded: a circuit breaker rerouted an operator
    trips = resil.get("breaker_trip", 0)
    degrades = resil.get("degrade", 0)
    if trips:
        findings.append(Finding(
            "breaker_degraded", 0.25,
            f"circuit breaker tripped {trips} time(s) "
            f"({degrades} degrade event(s)) — operator running on the "
            f"fallback path",
            "inspect faults telemetry; raise "
            "conf.breaker_failure_threshold only after fixing the "
            "underlying fault",
            {"breaker_trips": trips, "degrades": degrades}))

    # network_flaky: the control/shuffle transport misbehaved during the
    # run — reconnects, suspected partitions, dropped shuffle conns or a
    # lease-expired self-fence. Each blip was absorbed (that is the
    # contract), but a recurring pattern means the wire, not the query,
    # is the problem; rank by how noisy it was.
    reconnects = resil.get("control_reconnect", 0)
    partitions = resil.get("partition_suspected", 0)
    conn_drops = resil.get("shuffle_conn_dropped", 0)
    fences = resil.get("lease_expired", 0)
    net_noise = reconnects + partitions + conn_drops + fences
    if net_noise:
        findings.append(Finding(
            "network_flaky", min(0.2 + 0.1 * net_noise, 0.9),
            f"transport flapped {net_noise} time(s): "
            f"{reconnects} control reconnect(s), "
            f"{partitions} suspected partition(s), "
            f"{conn_drops} dropped shuffle conn(s), "
            f"{fences} lease fence(s)",
            "check the host's socket/FD pressure; raise "
            "conf.control_reconnect_backoff_ms / "
            "conf.control_reconnect_max for flakier links, or "
            "conf.executor_death_ms if partitions out-live the lease",
            {"control_reconnects": reconnects,
             "partitions_suspected": partitions,
             "shuffle_conns_dropped": conn_drops,
             "lease_fences": fences}))

    # pipeline_underlap: pool-side production not hidden behind compute
    busy = wait = 0.0
    for e in recs:
        if e.get("type") == "event" and e.get("kind") == "pipeline_stats":
            a = e.get("attrs") or {}
            busy += a.get("producer_busy_ms", 0.0)
            wait += a.get("consumer_wait_ms", 0.0)
    if busy >= _MIN_TERM_MS and wait >= _MIN_TERM_MS and total > 0 \
            and busy / total >= 0.15:
        overlap = int(round(100.0 * max(0.0, 1.0 - wait / busy)))
        if overlap < _UNDERLAP_PCT:
            findings.append(Finding(
                "pipeline_underlap", min(wait / total, 1.0),
                f"pipeline overlap only {overlap}% "
                f"(producers busy {busy:.0f}ms, consumers waited "
                f"{wait:.0f}ms)",
                "raise conf.prefetch_batches or check "
                "conf.enable_pipeline is on for I/O-bound stages",
                {"overlap_pct": overlap, "producer_busy_ms": _r(busy),
                 "consumer_wait_ms": _r(wait)}))

    # fleet_under/overprovisioned: the autoscaler's fleet snapshot
    # (stamped into run records while the policy loop is active) says
    # the seat count, not the query, was the bottleneck. Underprovision
    # needs real pressure (parked arrivals / a non-empty queue / this
    # query's own admission wait) with high per-seat utilization AND
    # the policy pinned at autoscale_max — below the ceiling the
    # autoscaler itself is the fix and needs no operator.
    fleet = record.get("fleet") or {}
    if fleet:
        util = float(fleet.get("utilization", 0.0))
        pressured = (int(fleet.get("parked_delta", 0)) > 0
                     or int(fleet.get("queue_depth", 0)) > 0
                     or adm_ms >= _MIN_ADMISSION_MS)
        if fleet.get("at_max") and util >= 0.75 and pressured:
            findings.append(Finding(
                "fleet_underprovisioned",
                min(0.3 + 0.5 * util, 0.9),
                f"fleet pinned at autoscale_max="
                f"{fleet.get('autoscale_max')} with "
                f"{100 * util:.0f}% busy slots and arrivals still "
                f"parking — the ceiling, not the query, bounds latency",
                "raise conf.autoscale_max (the policy loop is already "
                "asking for more seats)",
                {"serving": fleet.get("serving"),
                 "target_seats": fleet.get("target_seats"),
                 "autoscale_max": fleet.get("autoscale_max"),
                 "utilization": _r(util),
                 "queue_depth": fleet.get("queue_depth", 0),
                 "parked_delta": fleet.get("parked_delta", 0),
                 "admission_wait_ms": _r(adm_ms)}))
        serving = int(fleet.get("serving", 0))
        floor = int(fleet.get("autoscale_min", 1))
        if (serving > floor and util < 0.25
                and int(fleet.get("queue_depth", 0)) == 0
                and int(fleet.get("parked_delta", 0)) == 0):
            findings.append(Finding(
                "fleet_overprovisioned",
                min(0.2 + 0.3 * (1.0 - util), 0.5),
                f"{serving} seats serving at {100 * util:.0f}% busy "
                f"slots with an empty queue — capacity above "
                f"autoscale_min={floor} is idling",
                "lower conf.autoscale_min (or enable "
                "conf.autoscale_enabled so the policy drains idle "
                "seats itself)",
                {"serving": serving, "autoscale_min": floor,
                 "utilization": _r(util),
                 "busy_slots": fleet.get("busy_slots", 0),
                 "target_seats": fleet.get("target_seats")}))

    # stream_lag: this record is a streaming micro-batch (stamped by
    # runtime/streaming.py) whose end-to-end lag is past the stream's
    # objective AND not shrinking — the stream is falling behind its
    # source, sustained, and a knob (not this batch) is the fix.
    stream = record.get("stream") or {}
    if stream:
        lag = float(stream.get("lag_ms", 0.0) or 0.0)
        objective = float(stream.get("max_lag_ms", 0.0) or 0.0)
        sustained = lag >= float(stream.get("prev_lag_ms", 0.0) or 0.0)
        if objective > 0 and lag > objective and sustained:
            findings.append(Finding(
                "stream_lag",
                min(0.3 + 0.15 * (lag / objective), 0.95),
                f"stream {stream.get('stream_id')} lag {lag:.0f}ms "
                f"exceeds its {objective:.0f}ms objective and is still "
                f"growing (epoch {stream.get('epoch')}, "
                f"{stream.get('files', 0)} file(s) this batch)",
                "lower conf.stream_poll_ms so ticks keep up with "
                "arrivals, add seats (conf.autoscale_max) if batches "
                "are compute-bound, or raise conf.stream_max_lag_ms "
                "if the objective is wrong",
                {"stream_id": stream.get("stream_id"),
                 "epoch": stream.get("epoch"),
                 "lag_ms": _r(lag), "max_lag_ms": _r(objective),
                 "prev_lag_ms": _r(float(
                     stream.get("prev_lag_ms", 0.0) or 0.0)),
                 "files": stream.get("files", 0)}))

    # regression_vs_history: stages slower than their fingerprint's past
    if feed is not None:
        for s in record.get("stages") or []:
            fp = s.get("fingerprint")
            ms = float(s.get("ms") or 0.0)
            if not fp or ms <= 0:
                continue
            try:
                cost = feed.observed_stage_cost(fp)
            except Exception:  # noqa: BLE001 — advisory, never fatal
                cost = None
            if not cost or cost.get("n", 0) < 2:
                continue
            p50 = cost.get("ms_p50") or 0.0
            if p50 > 0 and ms > 2.0 * p50 + 100.0:
                findings.append(Finding(
                    "regression_vs_history",
                    min((ms - p50) / total, 1.0) if total else 0.0,
                    f"stage {s.get('stage_id')} ran {ms:.0f}ms vs "
                    f"historical median {p50:.0f}ms "
                    f"(n={cost.get('n')})",
                    "diff recent changes for this fingerprint "
                    "(tools/history_report.py shows the trend); raise "
                    "conf.history_regression_pct only if this magnitude "
                    "is expected",
                    {"stage_id": s.get("stage_id"), "fingerprint": fp,
                     "ms": _r(ms), "ms_p50": _r(p50),
                     "n": cost.get("n")}))

    findings.sort(key=lambda f: (-f.score, f.code))
    return findings


def render_findings(findings: List[Finding]) -> List[str]:
    lines: List[str] = []
    for i, f in enumerate(findings, 1):
        lines.append(f"  [{i}] {f.code} (score {f.score:.2f}): "
                     f"{f.summary}")
        lines.append(f"      -> {f.suggestion}")
    return lines


# -- artifact loading (the CLI path: ledger + trace dir on disk) -------------


def load_ledger(path: str) -> List[dict]:
    """Tolerant JSONL reader: skips torn/old lines (schema_version is
    advisory — older lines without one still load)."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("query_id"):
                    out.append(rec)
    except OSError:
        return []
    return out


def load_trace_records(trace_dir: str, query_id: str) -> List[dict]:
    """Lift an exported Chrome trace (trace_<qid>.json) back into the
    trace-internal record format compute_critical_path/diagnose consume.
    Durations come back in ns (Chrome stores µs)."""
    from blaze_tpu_torch.runtime.trace import ID_KEYS

    path = os.path.join(trace_dir, f"trace_{query_id}.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    out: List[dict] = []
    for ev in doc.get("traceEvents") or []:
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        args = dict(ev.get("args") or {})
        rec: Dict[str, Any] = {
            "type": "span" if ph == "X" else "event",
            "kind": ev.get("name"),
        }
        for k in ID_KEYS:
            if k in args:
                rec[k] = args.pop(k)
        if args.pop("error", None) is not None:
            rec["error"] = True
        rec["ts"] = int(round((ev.get("ts") or 0.0) * 1000.0))
        if ph == "X":
            rec["dur"] = int(round((ev.get("dur") or 0.0) * 1000.0))
        rec["attrs"] = args
        out.append(rec)
    return out


def diagnose_dir(trace_dir: str,
                 history_dir: Optional[str] = None) -> List[dict]:
    """Doctor a whole export dir: for every ledger line, compute (or
    adopt the stamped) critical path, re-hydrate the query's span
    records from trace_<qid>.json when present, and diagnose. Returns
    one entry per ledger line, ledger order (deterministic):
    {"query_id", "tenant_id", "critical_path", "findings": [...]}."""
    feed = None
    if history_dir:
        try:
            from blaze_tpu_torch.runtime import history

            feed = history.StatisticsFeed(
                history.store(history_dir).records())
        except Exception:  # noqa: BLE001 — advisory feed only
            feed = None
    out: List[dict] = []
    for rec in load_ledger(os.path.join(trace_dir, "ledger.jsonl")):
        qid = rec["query_id"]
        recs = load_trace_records(trace_dir, qid)
        cp = rec.get("critical_path") or compute_critical_path(rec, recs)
        findings = diagnose(rec, records=recs, feed=feed,
                            critical_path=cp)
        out.append({"query_id": qid,
                    "tenant_id": rec.get("tenant_id", ""),
                    "schema_version": rec.get("schema_version", 1),
                    "critical_path": cp,
                    "findings": [f.to_dict() for f in findings]})
    return out
