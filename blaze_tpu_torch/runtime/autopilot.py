"""Self-tuning autopilot: guarded per-fingerprint knob adaptation.

Port of blaze_tpu/runtime/autopilot.py whole (host Python: the
OverlayStore, the explorer and the verdicts); its run_plan hooks sit
where the JAX package's do (spark/local_runner.py).

Closes the loop between the doctor's typed findings (each suggestion
names a declared Knob — blazelint's doctor-knob-sync rule enforces it)
and the conf overlay system (config.resolve_overlay): after each run of
a fingerprinted query, a bounded explorer moves ONE knob ONE step in the
direction the top finding suggests, runs the new value as a canary, and
lets `history.detect_regressions()` judge it:

  propose   top doctor finding names an actuatable knob (ACTUATORS and
            a declared step/min/max schedule); the next value is one
            clamped step from the current settled value, never a value
            this fingerprint has quarantined, and never while
            `autopilot_max_active_canaries` canaries are already live
  canary    runs of the proposed overlay are stamped canary=true in
            history (StatisticsFeed baselines never mix canary and
            settled runs) and verdicted against the SETTLED baseline
  promote   after `autopilot_canary_runs` CONSECUTIVE canary runs beat
            the settled p50 wall time, the value joins the fingerprint's
            settled overlay (fleet-class knobs also publish to base conf
            so the autoscaler's policy loop routes on them)
  rollback  any regression verdict (wall_ms or copied_bytes, the
            detect_regressions contract) reverts the overlay
            immediately, quarantines the value for this fingerprint
            (never re-proposed — no oscillation), and cuts an
            `autopilot_rollback` trace event + flight dossier; a canary
            that can't build its streak within 3x the budget is
            reverted+quarantined as inconclusive

Decisions persist in a crash-atomic `OverlayStore` JSONL under
`conf.autopilot_dir` (the journal append idiom: heal a torn tail, write,
flush+fsync; loaders skip unparseable lines) — settled overlays and
quarantine lists survive driver restart AND standby failover, because
the standby folds the same file on takeover. Everything is gated on
`conf.autopilot_enabled` + `conf.autopilot_dir` + a history store (the
baseline source); off, the run_plan hook sites pay one truthiness check.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch.config import KNOBS, conf

# The knobs the explorer may actuate (the distributed set:
# executor routing via the autoscaler ceiling, telemetry cadence,
# reconnect backoff, macro-batching, pipeline depth, dense-vs-fallback
# groupby). blazelint's doctor-knob-sync rule checks every entry is a
# declared Knob WITH a step/min/max schedule. A doctor suggestion naming
# any other knob is advice for the operator, not the autopilot.
ACTUATORS = (
    "autoscale_max",
    "control_reconnect_backoff_ms",
    "dense_agg_range",
    "dict_encode_strings",
    "prefetch_batches",
    "shuffle_mmap_enabled",
    "target_batch_bytes",
    "telemetry_ship_ms",
)

# Promoted values for fleet-class knobs also publish to the base conf:
# the autoscaler's policy loop reads conf on its own thread, so a
# per-query overlay scope can't route it — promotion (already guarded by
# the canary verdicts) is the publication point.
_PUBLISH_ON_PROMOTE = ("autoscale_max",)

# Suggestion parsing: the verb nearest BEFORE a conf.<knob> mention
# gives the step direction.
_KNOB_RE = re.compile(r"conf\.([a-z0-9_]+)")
_RAISE_RE = re.compile(r"\b(raise|increase|grow)\b")
_LOWER_RE = re.compile(r"\b(lower|reduce|shrink|drop)\b")

# A canary gets 3x its promotion budget in total runs to build the
# consecutive-wins streak; past that it is reverted as inconclusive (and
# quarantined, so the explorer cannot oscillate on a neutral value).
_INCONCLUSIVE_FACTOR = 3


def parse_suggestion(suggestion: str) -> Optional[Tuple[str, int]]:
    """(knob, direction) from a doctor suggestion, or None.

    The knob is the first `conf.<name>` mention that is actuatable
    (ACTUATORS + declared schedule); the direction is the nearest
    raise/lower-class verb before it (+1 raise, -1 lower)."""
    text = suggestion or ""
    for m in _KNOB_RE.finditer(text):
        name = m.group(1)
        knob = KNOBS.get(name)
        if name not in ACTUATORS or knob is None or knob.step is None:
            continue
        head = text[:m.start()]
        raises = [v.end() for v in _RAISE_RE.finditer(head)]
        lowers = [v.end() for v in _LOWER_RE.finditer(head)]
        if not raises and not lowers:
            continue
        direction = 1 if max(raises or [-1]) > max(lowers or [-1]) else -1
        return name, direction
    return None


class _FpState:
    """Folded per-fingerprint autopilot state."""

    __slots__ = ("settled", "canary", "quarantine", "promotions",
                 "rollbacks")

    def __init__(self) -> None:
        self.settled: Dict[str, Any] = {}
        # {"knob", "value", "wins", "runs"} while a canary is live
        self.canary: Optional[Dict[str, Any]] = None
        self.quarantine: Dict[str, List[Any]] = {}
        self.promotions = 0
        self.rollbacks = 0

    def quarantined(self, knob: str, value: Any) -> bool:
        return value in self.quarantine.get(knob, [])


class OverlayStore:
    """Append-only JSONL of autopilot decisions, folded into
    per-fingerprint state on open.

    Record kinds (all carry `fp`, `knob`, `value`, `ts`):
      propose   a new canary overlay value (+ the finding that drove it)
      promote   canary graduated to the settled overlay
      rollback  canary reverted (+ quarantined); `reason` is
                "regression" or "inconclusive"

    Appends use the journal durability idiom (heal torn tail, write one
    line, flush+fsync) and the loader skips unparseable lines, so a
    SIGKILL can tear at most the final record — the fold is what a
    restarted driver (or the standby, at takeover) resumes from. The
    file stays small: one line per DECISION, not per run."""

    def __init__(self, directory: str) -> None:
        self.dir = directory
        self.path = os.path.join(directory, "overlays.jsonl")
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def append(self, kind: str, fp: str, **fields: Any) -> None:
        rec = {"kind": kind, "fp": fp, "ts": time.time()}
        rec.update(fields)
        line = (json.dumps(rec, default=str) + "\n").encode()
        with self._lock:
            with open(self.path, "ab+") as f:
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    def load_records(self) -> List[Dict[str, Any]]:
        records: List[Dict[str, Any]] = []
        try:
            with open(self.path, "rb") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # crash-torn line
                    if isinstance(rec, dict) and rec.get("kind") \
                            and rec.get("fp"):
                        records.append(rec)
        except OSError:
            pass
        return records

    def fold(self) -> Dict[str, _FpState]:
        state: Dict[str, _FpState] = {}
        for rec in self.load_records():
            st = state.setdefault(rec["fp"], _FpState())
            kind, knob, value = rec["kind"], rec.get("knob"), \
                rec.get("value")
            if kind == "propose" and knob:
                st.canary = {"knob": knob, "value": value,
                             "wins": 0, "runs": 0}
            elif kind == "promote" and knob:
                st.settled[knob] = value
                st.canary = None
                st.promotions += 1
            elif kind == "rollback" and knob:
                st.quarantine.setdefault(knob, []).append(value)
                st.canary = None
                st.rollbacks += 1
        return state


class Autopilot:
    """One folded OverlayStore + the explorer/verdict logic."""

    def __init__(self, directory: str) -> None:
        self.store = OverlayStore(directory)
        self._lock = threading.Lock()
        self._state = self.store.fold()

    # -- admission-side ----------------------------------------------------

    def overlay_for(self, fp: str) -> Tuple[Dict[str, Any], str]:
        """The stored overlay for a fingerprint: settled values plus the
        live canary value (if any). Returns (values, canary_knob) —
        canary_knob is "" on a settled-only overlay."""
        with self._lock:
            st = self._state.get(fp)
            if st is None:
                return {}, ""
            values = dict(st.settled)
            if st.canary is not None:
                values[st.canary["knob"]] = st.canary["value"]
                return values, st.canary["knob"]
            return values, ""

    def state_for(self, fp: str) -> _FpState:
        with self._lock:
            return self._state.setdefault(fp, _FpState())

    def active_canaries(self) -> int:
        with self._lock:
            return sum(1 for st in self._state.values()
                       if st.canary is not None)

    def metrics(self) -> Dict[str, Any]:
        """Gauge inputs for monitor.prometheus_text — derived from the
        folded (restart-persistent) state."""
        with self._lock:
            rollbacks: Dict[str, int] = {}
            promotions = 0
            active = 0
            for st in self._state.values():
                if st.settled or st.canary is not None:
                    active += 1
                promotions += st.promotions
                for knob, values in st.quarantine.items():
                    rollbacks[knob] = rollbacks.get(knob, 0) + len(values)
            return {"overlays_active": active,
                    "promotions_total": promotions,
                    "rollbacks_total": rollbacks}

    # -- run-side ----------------------------------------------------------

    def observe(self, qid: str, run_info: dict,
                record: Optional[dict]) -> None:
        """Post-run hook (run_plan's finally, after history.record_run):
        verdict a canary run against the settled baseline, or propose
        the next exploration from the top doctor finding."""
        ap = (run_info or {}).get("autopilot") or {}
        fp = ap.get("fingerprint") or ""
        if not fp or record is None:
            return
        st = self.state_for(fp)
        if ap.get("canary") and st.canary is not None \
                and st.canary["knob"] == ap.get("canary_knob"):
            self._verdict(qid, fp, st, run_info, record)
        elif st.canary is None:
            self._explore(qid, fp, st, record)

    def _baseline(self, fp: str) -> List[dict]:
        """This fingerprint's settled (non-canary) history records under
        the CURRENT settled overlay hash — the like-with-like baseline."""
        from blaze_tpu_torch.config import overlay_hash
        from blaze_tpu_torch.runtime import history

        st = history.store()
        if st is None:
            return []
        with self._lock:
            settled_hash = overlay_hash(self._state[fp].settled) \
                if fp in self._state else None
        return [r for r in st.records()
                if r.get("autopilot_fp") == fp and not r.get("canary")
                and r.get("overlay_hash") == settled_hash]

    def _verdict(self, qid: str, fp: str, st: _FpState, run_info: dict,
                 record: dict) -> None:
        from blaze_tpu_torch.runtime import history, trace

        canary = st.canary
        assert canary is not None
        baseline = self._baseline(fp)
        with self._lock:
            canary["runs"] += 1
        budget = max(int(conf.autopilot_canary_runs), 1)
        # regression verdict: detect_regressions over the settled
        # baseline + this canary run — same pct/grace contract as the
        # check-history gate, on wall time AND copy traffic
        regressions = history.detect_regressions(
            baseline + [record]) if len(baseline) >= 3 else []
        settled_ms = sorted(
            float(r.get("duration_ms") or 0.0) for r in baseline)
        p50 = settled_ms[len(settled_ms) // 2] if settled_ms else 0.0
        this_ms = float(record.get("duration_ms") or 0.0)
        if regressions:
            worst = regressions[0]
            self._rollback(qid, fp, st, run_info, reason="regression",
                           verdict={"metric": worst["metric"],
                                    "latest": worst["latest"],
                                    "threshold": worst["threshold"],
                                    "ratio": worst["ratio"]})
            return
        if p50 > 0 and this_ms < p50:
            with self._lock:
                canary["wins"] += 1
                wins = canary["wins"]
            trace.event("autopilot_explore", fingerprint=fp,
                        knob=canary["knob"], value=canary["value"],
                        phase="canary_win", wins=wins, budget=budget)
            if wins >= budget:
                self._promote(fp, st)
            return
        with self._lock:
            canary["wins"] = 0
            expired = canary["runs"] >= budget * _INCONCLUSIVE_FACTOR
        if expired:
            self._rollback(qid, fp, st, run_info, reason="inconclusive",
                           verdict={"runs": canary["runs"],
                                    "p50_ms": p50, "latest_ms": this_ms})

    def _promote(self, fp: str, st: _FpState) -> None:
        from blaze_tpu_torch.runtime import trace

        with self._lock:
            canary = st.canary
            if canary is None:
                return
            knob, value = canary["knob"], canary["value"]
            st.settled[knob] = value
            st.canary = None
            st.promotions += 1
        self.store.append("promote", fp, knob=knob, value=value)
        if knob in _PUBLISH_ON_PROMOTE:
            # fleet-class knob: the policy loop reads base conf on its
            # own thread, so the promoted bound publishes globally
            conf.update(**{knob: value})
        trace.event("autopilot_promote", fingerprint=fp, knob=knob,
                    value=value,
                    published=knob in _PUBLISH_ON_PROMOTE)

    def _rollback(self, qid: str, fp: str, st: _FpState, run_info: dict,
                  reason: str, verdict: Dict[str, Any]) -> None:
        from blaze_tpu_torch.runtime import flight_recorder, trace

        with self._lock:
            canary = st.canary
            if canary is None:
                return
            knob, value = canary["knob"], canary["value"]
            st.quarantine.setdefault(knob, []).append(value)
            st.canary = None
            st.rollbacks += 1
        self.store.append("rollback", fp, knob=knob, value=value,
                          reason=reason, verdict=verdict)
        trace.event("autopilot_rollback", fingerprint=fp, knob=knob,
                    value=value, reason=reason, **{
                        k: v for k, v in verdict.items()
                        if isinstance(v, (int, float, str))})
        flight_recorder.capture(
            "autopilot_rollback", qid,
            tenant_id=(run_info or {}).get("tenant_id", ""),
            run_info=run_info,
            detail={"fingerprint": fp, "knob": knob, "value": value,
                    "reason": reason, "verdict": verdict,
                    "quarantine": {k: list(v) for k, v
                                   in st.quarantine.items()}})

    def _explore(self, qid: str, fp: str, st: _FpState,
                 record: dict) -> None:
        from blaze_tpu_torch.runtime import doctor, trace

        baseline = self._baseline(fp)
        # a distribution, not a point: never canary against <2 settled
        # runs, and respect the cross-store canary cap
        if len(baseline) < 3 or \
                self.active_canaries() >= \
                max(int(conf.autopilot_max_active_canaries), 1):
            return
        findings = doctor.diagnose(record)
        for finding in findings:
            parsed = parse_suggestion(finding.suggestion)
            if parsed is None:
                continue
            knob, direction = parsed
            current = st.settled.get(
                knob, object.__getattribute__(conf, knob))
            value = KNOBS[knob].propose_step(current, direction)
            # step OVER quarantined values instead of stopping at them:
            # a neutral plateau (the next step changes nothing
            # observable, goes inconclusive, gets quarantined) must not
            # dead-end the walk toward values that do help — quarantine
            # means "never run this value again", not "never pass it"
            while value is not None and st.quarantined(knob, value):
                value = KNOBS[knob].propose_step(value, direction)
            if value is None:
                continue
            with self._lock:
                st.canary = {"knob": knob, "value": value,
                             "wins": 0, "runs": 0}
            self.store.append("propose", fp, knob=knob, value=value,
                              direction=direction, finding=finding.code,
                              current=current)
            trace.event("autopilot_explore", fingerprint=fp, knob=knob,
                        value=value, phase="propose",
                        direction=direction, finding=finding.code)
            return  # ONE knob, one step, per exploration


# ---------------------------------------------------------------------------
# module singleton (the history.store() caching idiom)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_instances: Dict[str, Autopilot] = {}


def active() -> Optional[Autopilot]:
    """The process's Autopilot when enabled (one per autopilot_dir),
    else None — the single truthiness check every hook site pays."""
    if not conf.autopilot_enabled or not conf.autopilot_dir:
        return None
    d = conf.autopilot_dir
    with _lock:
        ap = _instances.get(d)
        if ap is None:
            try:
                ap = Autopilot(d)
            except OSError:
                return None
            _instances[d] = ap
        return ap


def reset() -> None:
    """Drop cached instances (test/restart isolation) — on-disk
    OverlayStore state is untouched; the next active() refolds it,
    which is exactly what a restarted driver or a standby does."""
    with _lock:
        _instances.clear()


def overlay_for(fp: str) -> Tuple[Dict[str, Any], str]:
    ap = active()
    return ap.overlay_for(fp) if ap is not None and fp else ({}, "")


def observe(qid: str, run_info: dict, record: Optional[dict]) -> None:
    ap = active()
    if ap is not None:
        try:
            ap.observe(qid, run_info, record)
        except Exception:  # noqa: BLE001 — advisory, never fails a query
            pass


def metrics() -> Optional[Dict[str, Any]]:
    ap = active()
    return ap.metrics() if ap is not None else None
