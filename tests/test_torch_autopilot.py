"""The port's self-tuning autopilot (runtime/autopilot.py) against the
JAX package's, on the CPU.

Both packages get the same history records and the same decisions:

- parse_suggestion over a table of doctor-style suggestions;
- the OverlayStore's fold of the same appends (a torn tail included);
- the explorer's proposal from the same record and settled baseline,
  stepping over quarantined values and holding the canary cap;
- the canary verdicts: promotion after consecutive wins, a broken streak,
  a regression rolled back with its dossier, an inconclusive expiry, a
  fleet knob published on promotion;
- the gauges;
- run_plan with the autopilot on: the same query fingerprint, the same
  overlay provenance in run_info, the ledger line and the history
  record, and a stored overlay applied on the next run, the answer equal
  to the validator's oracle.

The decision records are compared without their wall-clock stamps ("ts");
everything else is exact.
"""

import glob
import json
import os

import pytest

from blaze_tpu import config as jconfig
from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import autopilot as jautopilot
from blaze_tpu.runtime import flight_recorder as jflight
from blaze_tpu.runtime import history as jhistory
from blaze_tpu.runtime import monitor as jmonitor
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch import config
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import (autopilot, flight_recorder, history,
                                     monitor, trace)
from torch_parity import no_jax_native

FP = "fp-test-0001"

# name -> (autopilot, history, flight_recorder, monitor, trace, config,
# conf)
PKGS = {"port": (autopilot, history, flight_recorder, monitor, trace,
                 config, conf),
        "jax": (jautopilot, jhistory, jflight, jmonitor, jtrace, jconfig,
                jconf)}

KNOBS = ("autopilot_enabled", "autopilot_dir", "autopilot_canary_runs",
         "autopilot_max_active_canaries", "history_dir", "trace_enabled",
         "trace_export_dir", "flight_dir", "flight_triggers",
         "history_regression_pct", "target_batch_bytes", "autoscale_max",
         "prefetch_batches", "telemetry_ship_ms", "spill_dir")


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    for name, (ap, hist, fl, mon, tr, _cfg, c) in PKGS.items():
        for k in KNOBS:
            monkeypatch.setattr(c, k, getattr(c, k))
        c.spill_dir = str(tmp_path / name / "spill")
        for m in (ap, hist, tr, fl):
            m.reset()
    yield
    for ap, hist, fl, mon, tr, _cfg, _c in PKGS.values():
        for m in (ap, hist, tr, fl, mon):
            m.reset()


def _records(store):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in store.load_records()]


def _fold(store):
    return {fp: (st.settled, st.canary, st.quarantine, st.promotions,
                 st.rollbacks)
            for fp, st in sorted(store.fold().items())}


def _both(tmp_path, body):
    return {name: body(name, *mods, tmp_path / name)
            for name, mods in PKGS.items()}


def test_parse_suggestion_matches_jax():
    cases = ("raise conf.target_batch_bytes (fewer, larger frames)",
             "lower conf.telemetry_ship_ms for fresher gauges",
             "check conf.target_batch_bytes",
             "raise conf.memory_budget",
             "raise conf.memory_budget or raise conf.prefetch_batches",
             "shrink conf.dense_agg_range, then grow conf.prefetch_batches",
             "increase conf.autoscale_max; reduce conf.target_batch_bytes",
             "")
    got = [autopilot.parse_suggestion(s) for s in cases]
    assert got == [jautopilot.parse_suggestion(s) for s in cases]
    assert got[:5] == [("target_batch_bytes", 1), ("telemetry_ship_ms", -1),
                       None, None, ("prefetch_batches", 1)]
    assert autopilot.ACTUATORS == jautopilot.ACTUATORS


def test_store_fold_and_torn_tail_match_jax(tmp_path):
    def body(name, ap, *_rest):
        d = tmp_path / name
        st = ap.OverlayStore(str(d))
        st.append("propose", FP, knob="prefetch_batches", value=3)
        st.append("promote", FP, knob="prefetch_batches", value=3)
        st.append("propose", FP, knob="target_batch_bytes", value=1 << 20)
        st.append("rollback", FP, knob="target_batch_bytes", value=1 << 20,
                  reason="regression", verdict={})
        with open(st.path, "ab") as f:  # a kill mid-write
            f.write(b'{"kind": "promote", "fp": "x", "knob": "pre')
        st2 = ap.OverlayStore(str(d))
        st2.append("promote", "fp2", knob="prefetch_batches", value=4)
        restarted = ap.Autopilot(str(d))
        return (_records(st2), _fold(st2), restarted.metrics(),
                restarted.overlay_for(FP), restarted.overlay_for("fp2"))

    out = _both(tmp_path, body)
    assert out["port"] == out["jax"]
    fold = out["port"][1]
    assert fold[FP] == ({"prefetch_batches": 3}, None,
                        {"target_batch_bytes": [1 << 20]}, 1, 1)
    assert out["port"][2] == {"overlays_active": 2, "promotions_total": 2,
                              "rollbacks_total": {"target_batch_bytes": 1}}


def _serde_bound_record(qid="q1", ms=1000.0):
    return {"query_id": qid, "duration_ms": ms, "counters": {},
            "stages": [],
            "critical_path": {"total_ms": ms,
                              "terms": {"serde_encode": 0.6 * ms}}}


def _settled_history(hist, n=3, ms=100.0, fp=FP):
    st = hist.store()
    for i in range(n):
        st.append({"query_id": f"base{i}", "autopilot_fp": fp,
                   "canary": False, "overlay_hash": None,
                   "duration_ms": ms,
                   "stages": [{"fingerprint": "s1", "ms": ms,
                               "copied_bytes": 1000}]})


def test_explorer_proposals_match_jax(tmp_path):
    """A serde-bound record over three settled runs proposes one step of
    target_batch_bytes; a quarantined value is stepped over; two settled
    runs are no baseline; the canary cap holds."""
    def body(name, ap, hist, _fl, _mon, _tr, _cfg, c, d):
        c.history_dir = str(d / "hist")
        c.target_batch_bytes = 1 << 20
        _settled_history(hist)
        out = []
        a = ap.Autopilot(str(d / "ap"))
        a.observe("q1", {"autopilot": {"fingerprint": FP}},
                  _serde_bound_record())
        out.append((a.state_for(FP).canary, a.overlay_for(FP)))
        b = ap.Autopilot(str(d / "ap2"))
        b.store.append("rollback", FP, knob="target_batch_bytes",
                       value=2 << 20, reason="inconclusive", verdict={})
        b = ap.Autopilot(str(d / "ap2"))
        b.observe("q1", {"autopilot": {"fingerprint": FP}},
                  _serde_bound_record())
        out.append(b.state_for(FP).canary)
        c.autopilot_max_active_canaries = 1
        e = ap.Autopilot(str(d / "ap3"))
        e.store.append("propose", "other", knob="prefetch_batches",
                       value=3)
        e = ap.Autopilot(str(d / "ap3"))
        e.observe("q1", {"autopilot": {"fingerprint": FP}},
                  _serde_bound_record())
        out.append(e.state_for(FP).canary)
        hist.reset()
        c.history_dir = str(d / "hist2")
        _settled_history(hist, n=2)
        f = ap.Autopilot(str(d / "ap4"))
        f.observe("q1", {"autopilot": {"fingerprint": FP}},
                  _serde_bound_record())
        out.append(f.state_for(FP).canary)
        return out, _records(a.store), _records(b.store)

    out = _both(tmp_path, body)
    assert out["port"] == out["jax"]
    (first, stepped, capped, no_base), recs, _ = out["port"]
    assert first == ({"knob": "target_batch_bytes", "value": 2 << 20,
                      "wins": 0, "runs": 0},
                     ({"target_batch_bytes": 2 << 20},
                      "target_batch_bytes"))
    assert stepped["value"] == 4 << 20
    assert capped is None and no_base is None
    assert recs[-1]["finding"] and recs[-1]["current"] == 1 << 20


def _canary_run_info(knob="target_batch_bytes"):
    return {"autopilot": {"fingerprint": FP, "canary": True,
                          "canary_knob": knob}}


def _canary_record(qid, ms):
    return {"query_id": qid, "autopilot_fp": FP, "canary": True,
            "overlay_hash": "abc123", "duration_ms": ms, "counters": {},
            "stages": [{"fingerprint": "s1", "ms": ms,
                        "copied_bytes": 1000}]}


def _proposed(ap, d, knob="target_batch_bytes", value=2 << 20):
    a = ap.Autopilot(str(d))
    a.store.append("propose", FP, knob=knob, value=value)
    return ap.Autopilot(str(d))


def test_canary_verdicts_match_jax(tmp_path):
    """The same canary runs give the same verdicts: two wins promote; a
    tie breaks the streak; a 5x stage time rolls back, quarantines and
    writes one dossier; three ties expire inconclusive; a promoted fleet
    knob publishes to the base conf."""
    def body(name, ap, hist, fl, _mon, _tr, _cfg, c, d):
        c.history_dir = str(d / "hist")
        c.flight_dir = str(d / "flight")
        c.history_regression_pct = 25.0
        c.autoscale_max = 4
        _settled_history(hist)
        steps = []
        c.autopilot_canary_runs = 2
        win = _proposed(ap, d / "win")
        for q, ms in (("c1", 50.0), ("c2", 50.0)):
            win.observe(q, _canary_run_info(), _canary_record(q, ms))
            steps.append(win.state_for(FP).canary)
        steps.append((win.state_for(FP).settled, win.overlay_for(FP)))
        streak = _proposed(ap, d / "streak")
        for q, ms in (("c1", 50.0), ("c2", 100.0), ("c3", 50.0)):
            streak.observe(q, _canary_run_info(), _canary_record(q, ms))
            steps.append(dict(streak.state_for(FP).canary))
        bad = _proposed(ap, d / "bad")
        bad.observe("c1", _canary_run_info(), _canary_record("c1", 500.0))
        steps.append((bad.state_for(FP).canary,
                      bad.state_for(FP).quarantine))
        dossiers = glob.glob(os.path.join(c.flight_dir, "dossier_*.json"))
        doc = json.load(open(dossiers[0]))
        steps.append((len(dossiers), doc["trigger"], doc["detail"]["knob"],
                      doc["detail"]["reason"],
                      doc["detail"]["quarantine"]))
        c.autopilot_canary_runs = 1
        neutral = _proposed(ap, d / "neutral")
        for i in range(3):
            neutral.observe(f"n{i}", _canary_run_info(),
                            _canary_record(f"n{i}", 100.0))
        steps.append(neutral.state_for(FP).quarantine)
        fleet = _proposed(ap, d / "fleet", knob="autoscale_max", value=5)
        fleet.observe("f1", _canary_run_info("autoscale_max"),
                      _canary_record("f1", 50.0))
        steps.append((fleet.state_for(FP).settled, c.autoscale_max))
        recs = [_records(x.store) for x in (win, streak, bad, neutral,
                                            fleet)]
        return steps, recs

    out = _both(tmp_path, body)
    assert out["port"] == out["jax"]
    steps, recs = out["port"]
    assert steps[1] is None and steps[2][0] == {"target_batch_bytes":
                                                2 << 20}
    assert [s["wins"] for s in steps[3:6]] == [1, 0, 1]
    assert steps[6] == (None, {"target_batch_bytes": [2 << 20]})
    assert steps[7][:4] == (1, "autopilot_rollback", "target_batch_bytes",
                            "regression")
    assert steps[8] == {"target_batch_bytes": [2 << 20]}
    assert steps[9] == ({"autoscale_max": 5}, 5)
    assert [r["kind"] for r in recs[2]] == ["propose", "rollback"]
    assert recs[2][-1]["verdict"]["metric"] == "wall_ms"
    assert recs[3][-1]["reason"] == "inconclusive"


def test_gauges_match_jax(tmp_path):
    def body(name, ap, hist, fl, mon, _tr, _cfg, c, d):
        c.autopilot_enabled = True
        c.autopilot_dir = str(d / "ap")
        a = ap.active()
        a.store.append("promote", FP, knob="prefetch_batches", value=3)
        a.store.append("rollback", FP, knob="target_batch_bytes",
                       value=1 << 20, reason="regression", verdict={})
        ap.reset()
        return [ln for ln in mon.prometheus_text().splitlines()
                if "blaze_autopilot_" in ln]

    out = _both(tmp_path, body)
    assert out["port"] == out["jax"]
    assert "blaze_autopilot_overlays_active 1" in out["port"]
    assert ('blaze_autopilot_rollbacks_total{knob="target_batch_bytes"} 1'
            in out["port"])


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu_torch.spark import validator

    out = {}
    for name, val in (("port", validator), ("jax", jvalidator)):
        d = str(tmp_path_factory.mktemp(f"ap_{name}"))
        out[name] = val.generate_tables(d, rows=600)
    return out


def _run(name, tables, d, run_info):
    if name == "port":
        from blaze_tpu_torch.spark import validator
        from blaze_tpu_torch.spark.local_runner import run_plan

        extra = {"device": "cpu"}
    else:
        from blaze_tpu.spark import validator
        from blaze_tpu.spark.local_runner import run_plan

        extra = {}
    paths, frames = tables[name]
    plan, oracle = validator.QUERIES["q1_scan_filter_project"](
        paths, frames, "bhj")
    out = run_plan(plan, num_partitions=2, work_dir=str(d / "work"),
                   mesh_exchange="off", run_info=run_info, **extra)
    assert validator._compare(
        validator._to_pandas(out).reset_index(drop=True),
        oracle().reset_index(drop=True)) is None


def test_run_plan_overlays_match_jax(tables, tmp_path, monkeypatch):
    """With the autopilot on, a pinned knob's provenance lands in run_info,
    the ledger line and the history record alike; the query fingerprint
    is the JAX package's; a settled overlay stored for it applies on the
    next run as a "fingerprint" layer."""
    no_jax_native(monkeypatch)

    def body(name, ap, hist, _fl, _mon, _tr, cfg, c, d):
        c.autopilot_enabled = True
        c.autopilot_dir = str(d / "ap")
        c.history_dir = str(d / "hist")
        c.trace_enabled = True
        c.trace_export_dir = str(d / "trace")
        info = {"conf_pins": {"prefetch_batches": 2}}
        _run(name, tables, d, info)
        stamp = info["autopilot"]
        led = [json.loads(ln) for ln in
               open(os.path.join(c.trace_export_dir, "ledger.jsonl"))]
        rec = hist.store().records()[-1]
        ap.active().store.append("promote", stamp["fingerprint"],
                                 knob="prefetch_batches", value=3)
        ap.reset()
        info2 = {}
        _run(name, tables, d, info2)
        return (stamp, led[-1]["autopilot"],
                (rec["autopilot_fp"], rec["canary"], rec["overlay_hash"]),
                info2["autopilot"], cfg.overlay_hash({"prefetch_batches":
                                                      2}))

    out = _both(tmp_path, body)
    assert out["port"] == out["jax"]
    stamp, led, rec, second, pin_hash = out["port"]
    assert stamp["overlay"] == {"prefetch_batches": 2}
    assert stamp["provenance"] == {"prefetch_batches": "pin"}
    assert stamp["canary"] is False and led == stamp
    assert rec == (stamp["fingerprint"], False, pin_hash)
    assert second["overlay"] == {"prefetch_batches": 3}
    assert second["provenance"] == {"prefetch_batches": "fingerprint"}
