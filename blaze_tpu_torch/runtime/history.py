"""Query history store: persistent plan-fingerprinted statistics.

Port of blaze_tpu/runtime/history.py, whole: the same shard files, run
records and aggregations, so the JAX package's readers
(tools/history_report.py, its StatisticsFeed) read this store as well.

The run ledger (runtime/trace.py) is append-only and unqueried — the
engine forgets every observed statistic the moment a query ends, which
is exactly the feedback signal the cost-based fusion optimizer (ROADMAP
item 3) and the cross-run perf tooling need. This module is the durable
layer on top:

  HistoryStore   bounded, sharded JSONL store under conf.history_dir:
                 one record per query run — per-stage wall time / copy
                 traffic / transport (keyed by the stage's plan
                 fingerprint), per-operator output row counts (keyed by
                 the operator fingerprint, with child fingerprints so
                 selectivity is derivable), dense-vs-fallback groupby
                 cardinality from the whole-stage compiler, and the
                 monitor's spill/compile roll-ups. Shards rotate at
                 conf.history_shard_runs records; retention prunes the
                 oldest shards so the store never exceeds
                 conf.history_retention_runs records.

  taps           begin_query()/observe_rows()/observe_groups() — bounded
                 in-memory accumulators fed from ops/base.count_stream
                 (per-batch row counts; the batch boundary that already
                 hosts the trace/heartbeat hooks) and
                 runtime/stage_compiler.py (dense group cardinality vs
                 streaming fallback). record_run() pops the accumulator
                 and appends the run record — called by the local
                 runner at query close, ledger or no ledger.

  StatisticsFeed observed_cardinality(fingerprint) /
                 observed_stage_cost(fingerprint): the aggregation API
                 the fusion cost model consumes — exact percentiles
                 over the retained runs (the store is bounded, so
                 loading it is O(retention)).

  detector       detect_regressions(): the latest run of each stage
                 fingerprint against its own history — flagged when
                 wall time or copy traffic exceeds the historical
                 median by conf.history_regression_pct (plus an
                 absolute noise grace, so CPU jitter on short stages
                 can't false-positive). tools/history_report.py renders
                 it; `make check-history` gates on it.

Everything is gated on `conf.history_dir`: unset, every call site pays
one truthiness check (the conf.trace_enabled posture).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.plan.fingerprint import (
    fingerprint_operator,
    fingerprint_query,
)
from blaze_tpu_torch.runtime import trace

_SHARD_RE = re.compile(r"^history-(\d{6})\.jsonl$")

# bounds on the per-query accumulators: a pathological plan (or a leak)
# must not grow driver memory without limit — overflow is counted, not
# stored
_MAX_OPS_PER_QUERY = 1024
_MAX_GROUPS_PER_QUERY = 256


# ---------------------------------------------------------------------------
# sharded JSONL store
# ---------------------------------------------------------------------------


class HistoryStore:
    """Bounded sharded-JSONL store: `history-<NNNNNN>.jsonl` files under
    `directory`, appended in order. The active shard rotates at
    `shard_runs` records; after every append, whole oldest shards are
    pruned while the total exceeds `retention` — so the store holds at
    most `retention` records (give or take nothing: the active shard is
    capped at min(shard_runs, retention))."""

    def __init__(self, directory: str, retention: Optional[int] = None,
                 shard_runs: Optional[int] = None) -> None:
        self.dir = directory
        self._retention = retention
        self._shard_runs = shard_runs
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _ret(self) -> int:
        r = (self._retention if self._retention is not None
             else conf.history_retention_runs)
        return max(int(r), 1)

    def _shard_cap(self) -> int:
        s = (self._shard_runs if self._shard_runs is not None
             else conf.history_shard_runs)
        return max(1, min(int(s), self._ret()))

    def shards(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return [os.path.join(self.dir, n)
                for n in sorted(n for n in names if _SHARD_RE.match(n))]

    @staticmethod
    def _count_lines(path: str) -> int:
        try:
            with open(path, "rb") as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    def total_records(self) -> int:
        return sum(self._count_lines(p) for p in self.shards())

    def append(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            shards = self.shards()
            if shards and self._count_lines(shards[-1]) < self._shard_cap():
                active = shards[-1]
            else:
                nxt = 1
                if shards:
                    m = _SHARD_RE.match(os.path.basename(shards[-1]))
                    nxt = int(m.group(1)) + 1
                active = os.path.join(self.dir, f"history-{nxt:06d}.jsonl")
                shards.append(active)
            with open(active, "ab+") as f:
                # heal a torn tail (crash mid-write left no newline) so
                # the new record never concatenates onto garbage
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                f.write(line.encode())
            # retention: drop whole oldest shards (never the active one)
            counts = {p: self._count_lines(p) for p in shards}
            total = sum(counts.values())
            while total > self._ret() and len(shards) > 1:
                oldest = shards.pop(0)
                total -= counts.pop(oldest, 0)
                try:
                    os.remove(oldest)
                except OSError:
                    pass

    def records(self) -> List[Dict[str, Any]]:
        """Every retained run record, oldest first (bounded by
        retention, so this is an O(retention) load)."""
        out: List[Dict[str, Any]] = []
        for path in self.shards():
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            try:
                                out.append(json.loads(line))
                            except ValueError:
                                continue  # torn line: skip, don't die
            except OSError:
                continue
        return out


_stores_lock = threading.Lock()
_stores: Dict[str, HistoryStore] = {}


def store(directory: Optional[str] = None) -> Optional[HistoryStore]:
    d = directory or conf.history_dir
    if not d:
        return None
    with _stores_lock:
        s = _stores.get(d)
        if s is None:
            s = _stores[d] = HistoryStore(d)
        return s


# ---------------------------------------------------------------------------
# per-query in-memory taps
# ---------------------------------------------------------------------------


class _QueryAcc:
    __slots__ = ("qid", "t0", "ops", "groups", "overflow")

    def __init__(self, qid: str) -> None:
        self.qid = qid
        self.t0 = time.time()
        # fp -> {"op", "inputs", "rows", "batches"}
        self.ops: Dict[str, Dict[str, Any]] = {}
        # list of {"fingerprint", "op", "groups", "dense"}
        self.groups: List[Dict[str, Any]] = []
        self.overflow = 0


_acc_lock = threading.Lock()
_accs: Dict[str, _QueryAcc] = {}
_active_qid: Optional[str] = None


def begin_query(qid: str) -> None:
    """Register the query's accumulator (and the active-query fallback
    for taps running outside any trace context). No-op with
    conf.history_dir unset."""
    global _active_qid
    if not conf.history_dir:
        return
    with _acc_lock:
        _accs[qid] = _QueryAcc(qid)
        _active_qid = qid


def _current_acc() -> Optional[_QueryAcc]:
    qid = trace.current_context().get("query_id")
    with _acc_lock:
        if qid is None:
            qid = _active_qid
        if qid is None:
            return None
        return _accs.get(qid)


def op_fingerprint(op) -> str:
    """Cached operator fingerprint (computed once per operator instance
    — count_stream calls this per batch)."""
    fp = getattr(op, "_history_fp", None)
    if fp is None:
        fp = fingerprint_operator(op)
        try:
            op._history_fp = fp
        except AttributeError:
            pass
    return fp


def observe_rows(op, rows: int) -> None:
    """Per-batch output-row tap (ops/base.count_stream): accumulate
    output rows per operator fingerprint. Child fingerprints ride along
    so the feed can derive selectivity (an operator's input rows are its
    children's output rows)."""
    acc = _current_acc()
    if acc is None:
        return
    fp = op_fingerprint(op)
    with _acc_lock:
        ent = acc.ops.get(fp)
        if ent is None:
            if len(acc.ops) >= _MAX_OPS_PER_QUERY:
                acc.overflow += 1
                return
            ent = acc.ops[fp] = {
                "op": op.name(),
                "inputs": [op_fingerprint(c) for c in op.children],
                "rows": 0, "batches": 0,
            }
        ent["rows"] += int(rows)
        ent["batches"] += 1


def observe_groups(fp: str, op_name: str, groups: Optional[int],
                   dense: bool) -> None:
    """Whole-stage-compiler tap: the dense one-hot groupby path knows
    its exact group cardinality in one number; the streaming fallback
    records dense=False (cardinality then comes from the row taps)."""
    acc = _current_acc()
    if acc is None:
        return
    with _acc_lock:
        if len(acc.groups) >= _MAX_GROUPS_PER_QUERY:
            acc.overflow += 1
            return
        acc.groups.append({"fingerprint": fp, "op": op_name,
                           "groups": groups, "dense": bool(dense)})


def _pop_acc(qid: str) -> Optional[_QueryAcc]:
    global _active_qid
    with _acc_lock:
        acc = _accs.pop(qid, None)
        if _active_qid == qid:
            _active_qid = None
    return acc


# ---------------------------------------------------------------------------
# run ingestion
# ---------------------------------------------------------------------------


def record_run(qid: str, run_info: Optional[dict] = None,
               directory: Optional[str] = None) -> Optional[dict]:
    """Build one run record for `qid` and append it to the store. Called
    by the local runner at query close (after the monitor roll-up merged
    into run_info). With tracing on, stage detail comes from the same
    records the ledger line is built from; tracing off, the record still
    carries the query-level counters and the op/group taps."""
    st = store(directory)
    acc = _pop_acc(qid)
    if st is None:
        return None
    stages: List[Dict[str, Any]] = []
    duration_ms: Optional[float] = None
    critical_path: Optional[Dict[str, Any]] = None
    if conf.trace_enabled:
        base = trace.build_run_record(qid, run_info)
        stages = base.get("stages") or []
        duration_ms = base.get("duration_ms")
        critical_path = base.get("critical_path")
    if duration_ms is None and acc is not None:
        duration_ms = round((time.time() - acc.t0) * 1e3, 3)
    stage_fps = [s.get("fingerprint") or "" for s in stages]
    record: Dict[str, Any] = {
        # readers treat a MISSING schema_version as version 1 (records
        # written before the critical-path change)
        "schema_version": trace.SCHEMA_VERSION,
        "query_id": qid,
        "tenant_id": (run_info or {}).get("tenant_id", ""),
        "ts": round(time.time(), 3),
        "plan_fingerprint": (fingerprint_query(stage_fps)
                             if stages else None),
        "duration_ms": duration_ms,
        "stages": stages,
        "ops": ([dict(v, fingerprint=k)
                 for k, v in sorted(acc.ops.items())] if acc else []),
        "groups": (acc.groups if acc else []),
        "counters": {k: v for k, v in (run_info or {}).items()
                     if isinstance(v, (int, float))
                     and not isinstance(v, bool)},
    }
    ap = (run_info or {}).get("autopilot") or {}
    if ap:
        # like-with-like hygiene: StatisticsFeed baselines skip canary
        # runs, detect_regressions priors must share the overlay
        # generation, and the autopilot keys its settled baseline off
        # the pre-AQE query fingerprint it actuates on
        record["overlay_hash"] = ap.get("overlay_hash")
        record["canary"] = bool(ap.get("canary"))
        record["autopilot_fp"] = ap.get("fingerprint", "")
    if critical_path is not None:
        record["critical_path"] = critical_path
    if acc is not None and acc.overflow:
        record["tap_overflow"] = acc.overflow
    st.append(record)
    return record


def reset() -> None:
    """Clear accumulators + store cache (test/bench isolation). On-disk
    shards are untouched — they are the persistence under test."""
    global _active_qid
    with _acc_lock:
        _accs.clear()
        _active_qid = None
    with _stores_lock:
        _stores.clear()


# ---------------------------------------------------------------------------
# statistics feed (the fusion cost model's input)
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Exact nearest-rank percentile over a sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class StatisticsFeed:
    """Aggregated observed statistics per plan fingerprint — the API the
    cost-based fusion optimizer (ROADMAP item 3) consumes. Built from a
    HistoryStore (or a pre-loaded record list); aggregation is exact
    because the store is bounded by retention."""

    def __init__(self, source=None) -> None:
        if source is None:
            source = store()
        if isinstance(source, HistoryStore):
            self._records = source.records()
        else:
            self._records = list(source or [])
        # stage fingerprint -> per-run samples
        self._stage: Dict[str, List[Dict[str, Any]]] = {}
        # op fingerprint -> per-run {"rows", "in_rows"}
        self._ops: Dict[str, List[Dict[str, Any]]] = {}
        self._groups: Dict[str, List[Dict[str, Any]]] = {}
        for rec in self._records:
            if rec.get("canary"):
                # autopilot canary runs never feed baselines — a knob
                # under trial must not shift the costs it is judged by
                continue
            op_rows = {o.get("fingerprint"): o.get("rows", 0)
                       for o in rec.get("ops") or []}
            for s in rec.get("stages") or []:
                fp = s.get("fingerprint")
                if fp:
                    self._stage.setdefault(fp, []).append(s)
            for o in rec.get("ops") or []:
                fp = o.get("fingerprint")
                if not fp:
                    continue
                inputs = o.get("inputs") or []
                in_rows = sum(op_rows.get(i, 0) for i in inputs)
                self._ops.setdefault(fp, []).append(
                    {"rows": o.get("rows", 0), "batches": o.get("batches", 0),
                     "in_rows": in_rows if inputs else None,
                     "op": o.get("op")})
            for g in rec.get("groups") or []:
                fp = g.get("fingerprint")
                if fp:
                    self._groups.setdefault(fp, []).append(g)

    @property
    def records(self) -> List[Dict[str, Any]]:
        return self._records

    def fingerprints(self) -> Dict[str, List[str]]:
        """Known fingerprints by keyspace: "stages" (fingerprint_plan
        over the executed stage subtree) vs "ops" (operator plan_key
        digests from the batch taps / whole-stage compiler). Both are
        opaque keys — consumers pass them back to observed_*()."""
        return {"stages": sorted(self._stage),
                "ops": sorted(set(self._ops) | set(self._groups)),
                "groups": sorted(self._groups)}

    def observed_cardinality(self, fingerprint: str
                             ) -> Optional[Dict[str, Any]]:
        """Observed output cardinality for an operator (or whole-stage
        group count) fingerprint: {"n", "rows_p50", "rows_mean",
        "selectivity_p50"?, "dense_ratio"?, "groups_p50"?} — None when
        the fingerprint was never observed."""
        samples = self._ops.get(fingerprint, [])
        gsamples = self._groups.get(fingerprint, [])
        if not samples and not gsamples:
            return None
        out: Dict[str, Any] = {"n": len(samples) or len(gsamples)}
        if samples:
            rows = sorted(float(s["rows"]) for s in samples)
            out["rows_p50"] = _percentile(rows, 50)
            out["rows_mean"] = round(sum(rows) / len(rows), 3)
            sel = sorted(s["rows"] / s["in_rows"] for s in samples
                         if s.get("in_rows"))
            if sel:
                out["selectivity_p50"] = round(_percentile(sel, 50), 6)
            out["op"] = samples[-1].get("op")
        if gsamples:
            dense = [g for g in gsamples if g.get("dense")]
            out["dense_ratio"] = round(len(dense) / len(gsamples), 3)
            groups = sorted(float(g["groups"]) for g in dense
                            if g.get("groups") is not None)
            if groups:
                out["groups_p50"] = _percentile(groups, 50)
            out.setdefault("op", gsamples[-1].get("op"))
        return out

    def observed_stage_cost(self, fingerprint: str
                            ) -> Optional[Dict[str, Any]]:
        """Observed cost distribution for a stage fingerprint: wall time
        and copy traffic percentiles over the retained runs."""
        samples = self._stage.get(fingerprint, [])
        if not samples:
            return None
        ms = sorted(float(s.get("ms") or 0) for s in samples)
        copied = sorted(float(s.get("copied_bytes") or 0) for s in samples)
        moved = sorted(float(s.get("moved_bytes") or 0) for s in samples)
        return {
            "n": len(samples),
            "ms_p50": _percentile(ms, 50),
            "ms_p95": _percentile(ms, 95),
            "ms_mean": round(sum(ms) / len(ms), 3),
            "copied_p50": _percentile(copied, 50),
            "moved_p50": _percentile(moved, 50),
            "kind": samples[-1].get("kind"),
            "transport": samples[-1].get("transport"),
        }


# ---------------------------------------------------------------------------
# cross-run regression detector
# ---------------------------------------------------------------------------


def detect_regressions(records: Optional[Iterable[dict]] = None,
                       pct: Optional[float] = None,
                       grace_ms: float = 100.0,
                       grace_bytes: int = 64 << 10,
                       min_prior_runs: int = 2) -> List[Dict[str, Any]]:
    """Compare each stage fingerprint's LATEST observation against its
    own history (all earlier runs): flagged when

        latest > median(prior) * (1 + pct/100) + grace

    for wall time (grace_ms absorbs CPU scheduling jitter on short
    stages) or copy traffic (grace_bytes; byte counts are deterministic,
    so the grace is small). Fingerprints with fewer than
    `min_prior_runs` prior observations are skipped — one run is not a
    distribution. Returns findings sorted worst-first."""
    if records is None:
        st = store()
        records = st.records() if st else []
    records = list(records)
    if pct is None:
        pct = conf.history_regression_pct
    # per (record index, fingerprint) aggregate — two same-shaped stages
    # in one run fold into one sample so intra-run repetition doesn't
    # masquerade as history
    series: Dict[str, List[Tuple[int, float, float, dict]]] = {}
    for idx, rec in enumerate(records):
        per_fp: Dict[str, List[dict]] = {}
        for s in rec.get("stages") or []:
            fp = s.get("fingerprint")
            if fp:
                per_fp.setdefault(fp, []).append(s)
        for fp, ss in per_fp.items():
            ms = sum(float(s.get("ms") or 0) for s in ss)
            cp = sum(float(s.get("copied_bytes") or 0) for s in ss)
            series.setdefault(fp, []).append((idx, ms, cp, ss[-1]))
    findings: List[Dict[str, Any]] = []
    factor = 1.0 + float(pct) / 100.0
    for fp, samples in series.items():
        idx, last_ms, last_cp, meta = samples[-1]
        latest_rec = records[idx]
        # like-with-like: canary runs (autopilot explorations) never
        # serve as priors, and priors must share the settled overlay
        # generation the latest run is judged against. Records without
        # the autopilot fields degrade to the legacy all-priors window
        # (canary falsy, overlay_hash None on both sides).
        if latest_rec.get("canary"):
            settled = [s for s in samples[:-1]
                       if not records[s[0]].get("canary")]
            base_hash = (records[settled[-1][0]].get("overlay_hash")
                         if settled else None)
        else:
            base_hash = latest_rec.get("overlay_hash")
        priors = [s for s in samples[:-1]
                  if not records[s[0]].get("canary")
                  and records[s[0]].get("overlay_hash") == base_hash]
        if len(priors) < min_prior_runs:
            continue
        prior_ms = sorted(s[1] for s in priors)
        prior_cp = sorted(s[2] for s in priors)
        qid = latest_rec.get("query_id")
        for metric, latest, prior, grace in (
                ("wall_ms", last_ms, prior_ms, grace_ms),
                ("copied_bytes", last_cp, prior_cp, float(grace_bytes))):
            median = _percentile(prior, 50)
            threshold = median * factor + grace
            if latest > threshold:
                findings.append({
                    "fingerprint": fp,
                    "metric": metric,
                    "latest": round(latest, 3),
                    "median": round(median, 3),
                    "p95": round(_percentile(prior, 95), 3),
                    "threshold": round(threshold, 3),
                    "ratio": round(latest / median, 2) if median else None,
                    "runs": len(priors),
                    "query_id": qid,
                    "stage_kind": meta.get("kind"),
                })
    findings.sort(key=lambda f: (f["latest"] - f["threshold"]),
                  reverse=True)
    return findings
