"""The port's query doctor (runtime/doctor.py) against the JAX package's,
on the CPU.

Both doctors are pure functions of their records, so the same seeded run
records, span records and history feed must give the same critical path,
the same findings with the same scores, and the same rendered lines. The
records are drawn with numpy from a seed; the draw is wide enough that
across the seeds every rule of the catalogue fires at least once (checked
on the union). The JAX package's `load_ledger`, `load_trace_records` and
`diagnose_dir` read an export directory the port's trace wrote, and give
what the port's give.
"""

import json

import numpy as np
import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import doctor as jdoctor
from blaze_tpu.runtime import history as jhistory
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import doctor, history, trace

SEEDS = list(range(16))

RULES = ("serde_bound", "host_cpu_bound", "skewed_partition",
         "straggler_dominated", "executor_skew", "spill_bound",
         "compile_storm", "admission_starved", "queue_contended",
         "breaker_degraded", "network_flaky", "pipeline_underlap",
         "fleet_underprovisioned", "fleet_overprovisioned", "stream_lag",
         "regression_vs_history")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "doctor_skew_ratio", 4.0)
    for m in (trace, jtrace, history, jhistory):
        m.reset()
    yield
    for m in (trace, jtrace, history, jhistory):
        m.reset()


def _draw(seed):
    """(run record, span/event records, history records) for one seed:
    every input a rule of the catalogue reads, at magnitudes that let
    about half the rules fire per seed."""
    rng = np.random.default_rng(seed)

    def ms(hi):
        return float(round(rng.uniform(0, hi), 3)) if rng.random() < 0.6 \
            else 0.0

    total = float(round(rng.uniform(200, 4000), 3))
    terms = ("sched_queue_ms", "compile_ms", "device_compute_ms",
             "host_compute_ms", "serde_encode_ms", "serde_decode_ms",
             "shuffle_io_ms", "spill_ms", "retry_backoff_ms")
    # one term a seed dominates; the others stay small
    counters = {k: ms(total * 0.1) for k in terms}
    counters[terms[seed % len(terms)]] = float(round(
        rng.uniform(0.6, 0.9) * total, 3))
    counters.update({
        "compile_cache_misses": int(rng.integers(2, 6)),
        "compile_cache_hits": int(rng.integers(0, 4)),
        "spill_bytes": int(rng.integers(0, 1 << 30)),
        "spill_count": int(rng.integers(0, 9)),
        "bytes_copied_serde": int(rng.integers(0, 1 << 28)),
        "bytes_copied_shuffle": int(rng.integers(0, 1 << 28)),
        "bytes_moved_shuffle": int(rng.integers(1, 1 << 28)),
        "shuffle_mmap_hits": int(rng.integers(0, 3)),
        "shuffle_mmap_fallbacks": int(rng.integers(0, 3)),
        "dict_cols_encoded": int(rng.integers(0, 3)),
    })
    nstages = int(rng.integers(1, 4))
    stages = [{"stage_id": s, "fingerprint": f"fp{seed % 3}{s}",
               "kind": ("result" if s == nstages - 1 else "shuffle_map"),
               "transport": "file",
               "ms": float(round(rng.uniform(50, total), 3)),
               "tasks": 4, "bytes": 0, "moved_bytes": 0,
               "copied_bytes": 0} for s in range(nstages)]
    resil = {k: int(rng.integers(0, 3)) for k in (
        "breaker_trip", "degrade", "control_reconnect",
        "partition_suspected", "shuffle_conn_dropped", "lease_expired",
        "retry")}
    outcome = str(rng.choice(["admitted", "admitted", "parked",
                              "rejected"]))
    rec = {"schema_version": 2, "query_id": f"qS{seed}",
           "tenant_id": "t1", "admission_outcome": outcome,
           "admission_wait_ms": ms(total * 0.6),
           "duration_ms": total,
           "stages": stages, "resilience_events": resil,
           "counters": counters}
    if rng.random() < 0.6 or seed % len(terms) == 3:  # host-bound seeds
        rec["profile"] = {"samples": 40, "sample_ms": 25, "hot_frames": [
            {"frame": "serde._encode", "samples": 30, "pct": 75.0},
            {"frame": "agg._update", "samples": 10, "pct": 25.0}]}
    if seed % 4 < 2:  # a pinned, busy fleet, then an idle one
        busy = seed % 4 == 0
        rec["fleet"] = {"utilization": float(rng.uniform(0.75, 1) if busy
                                             else rng.uniform(0, 0.25)),
                        "at_max": busy,
                        "parked_delta": int(busy and rng.integers(0, 2)),
                        "queue_depth": int(busy),
                        "serving": int(rng.integers(2, 5)),
                        "autoscale_min": 1, "autoscale_max": 4,
                        "target_seats": 3, "busy_slots": 2}
    if rng.random() < 0.4:
        rec["stream"] = {"stream_id": "s1", "epoch": 7, "files": 2,
                         "lag_ms": float(rng.uniform(0, 2000)),
                         "max_lag_ms": 500.0,
                         "prev_lag_ms": float(rng.uniform(0, 1000))}
    recs = []
    for s in stages:
        recs.append({"type": "span", "kind": "stage", "stage_id":
                     s["stage_id"], "dur": int(s["ms"] * 1e6),
                     "attrs": {}})
        durs = rng.uniform(5, s["ms"] / 5, 4)
        if rng.random() < 0.6:
            durs[int(rng.integers(0, 4))] = s["ms"] * 0.9
        for t, d in enumerate(durs):
            attrs = {}
            if rng.random() < 0.5:
                attrs["exec"] = f"e{t % 2 if rng.random() < 0.5 else t}"
            if rng.random() < 0.15:
                attrs["kill_reason"] = "hung"
            if rng.random() < 0.15:
                attrs["speculative"] = True
                attrs["won"] = bool(rng.random() < 0.5)
            recs.append({"type": "span", "kind": "task_attempt",
                         "stage_id": s["stage_id"], "task_id": f"m{t}",
                         "dur": int(d * 1e6), "attrs": attrs})
        if rng.random() < 0.3:
            recs.append({"type": "event", "kind": "speculation_launch",
                         "stage_id": s["stage_id"], "attrs": {}})
        recs.append({"type": "event", "kind": "pipeline_stats",
                     "stage_id": s["stage_id"], "attrs": {
                         "producer_busy_ms": ms(total),
                         "consumer_wait_ms": ms(total)}})
    hist = [{"query_id": f"h{i}", "stages": [
        dict(s, ms=float(round(rng.uniform(10, 120), 3)))
        for s in stages]} for i in range(3)]
    return rec, recs, hist


def _both(seed):
    rec, recs, hist = _draw(seed)
    out = []
    for doc, hist_mod in ((doctor, history), (jdoctor, jhistory)):
        cp = doc.compute_critical_path(json.loads(json.dumps(rec)), recs)
        feed = hist_mod.StatisticsFeed(hist)
        findings = doc.diagnose(rec, records=recs, feed=feed)
        out.append((cp, [f.to_dict() for f in findings],
                    doc.render_critical_path(cp),
                    doc.render_findings(findings)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_critical_path_findings_and_rendering_match_jax(seed):
    port, jax = _both(seed)
    assert port == jax
    cp = port[0]
    assert set(cp["terms"]) == set(doctor.TERMS) == set(jdoctor.TERMS)
    assert abs(sum(cp["terms"].values()) - cp["total_ms"]) < 0.01


def test_every_rule_fires_across_the_seeds():
    codes = set()
    for seed in SEEDS:
        port, _ = _both(seed)
        codes |= {f["code"] for f in port[1]}
    assert codes == set(RULES), set(RULES) - codes


def test_compile_term_reads_zero_without_compile_counters():
    """The port has no compile service: a run_info without compile_ms
    gives a 0 compile term and no compile_storm, as the JAX doctor does
    for the same record."""
    rec = {"duration_ms": 500.0, "counters": {"serde_encode_ms": 300.0}}
    cp = doctor.compute_critical_path(rec)
    assert cp == jdoctor.compute_critical_path(rec)
    assert cp["terms"]["compile"] == 0.0
    assert cp["top_term"] == "serde_encode"


def test_jax_loaders_read_the_ports_export_dir(tmp_path, monkeypatch):
    """An export dir the port's trace wrote (ledger line + Chrome trace of
    a scripted query) loads through the JAX package's load_ledger,
    load_trace_records and diagnose_dir exactly as through the port's."""
    import itertools

    monkeypatch.setattr(conf, "trace_enabled", True)
    tick = itertools.count(10 ** 9, 7_000_000)
    monkeypatch.setattr(trace.TRACE, "clock", lambda: next(tick))
    with trace.context(query_id="qX"):
        with trace.span("query", query_id="qX"):
            with trace.span("stage", stage_id=0, stage_kind="result",
                            fingerprint="fpA", tasks=2):
                for t in range(2):
                    with trace.span("task_attempt", stage_id=0,
                                    task_id=f"r{t}", attempt_id=t):
                        trace.event("batch", op="X", rows=3)
            trace.event("retry", n=1)
    d = tmp_path / "export"
    info = {"serde_encode_ms": 120.0, "device_compute_ms": 40.0}
    rec = trace.export_query("qX", info, export_dir=str(d))
    assert rec is not None and (d / "trace_qX.json").exists()
    ledger = str(d / "ledger.jsonl")
    assert jdoctor.load_ledger(ledger) == doctor.load_ledger(ledger) \
        == [json.loads(json.dumps(rec))]
    assert (jdoctor.load_trace_records(str(d), "qX")
            == doctor.load_trace_records(str(d), "qX"))
    assert len(doctor.load_trace_records(str(d), "qX")) == 7
    got = doctor.diagnose_dir(str(d))
    assert got == jdoctor.diagnose_dir(str(d))
    assert [g["query_id"] for g in got] == ["qX"]
    assert got[0]["critical_path"]["top_term"] == "serde_encode"
