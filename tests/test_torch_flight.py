"""The port's flight recorder (runtime/flight_recorder.py) against the
JAX package's, on the CPU.

- Dossiers: the same trace records (injected clocks), run_info and
  incident give dossiers equal on every field that holds no time
  (`captured_at` and the thread stacks, which are this process's live
  frames, are set aside; the file name embeds the capture time, so it is
  compared with the clock patched). A knob whose value another test in
  the process left apart between the two packages' confs before the
  capture is compared by name only. Each trigger the query-end hook
  classifies (failure, deadline, hang, shed, resource_leak) is covered,
  as are the exactly-once rule, the trigger filter, retention and the
  readers (`list_dossiers`, `load`).
- No device call: with torch.cuda's memory, stream and synchronize
  functions patched to raise, as on a context poisoned by a sticky CUDA
  error, a capture still writes its dossier.
- The runtime's taps: a port run_plan stalled past `hang_detect_ms`
  leaves a hang dossier with the stacks stashed at detection (its rows
  still right), a query killed by `query_deadline_ms` a deadline
  dossier, a breaker trip a breaker_trip dossier, and a replayed
  journal a driver_restart dossier.
"""

import itertools
import json
import os
import types

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import faults as jfaults
from blaze_tpu.runtime import flight_recorder as jflight
from blaze_tpu.runtime import history as jhistory
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import faults, flight_recorder, history, trace
from torch_parity import both_tables, no_jax_native

PAIRS = ((flight_recorder, trace, faults, conf),
         (jflight, jtrace, jfaults, jconf))
TIMED = ("captured_at", "thread_stacks")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "trace_enabled", True)
        monkeypatch.setattr(c, "flight_retention", 64)
        monkeypatch.setattr(c, "flight_triggers", "all")
    no_jax_native(monkeypatch)
    saved = [(m, m.TRACE.clock, m.TRACE.wall) for m in (trace, jtrace)]
    for m in (trace, jtrace, flight_recorder, jflight, history, jhistory):
        m.reset()
    yield
    for m, clock, wall in saved:
        m.TRACE.clock, m.TRACE.wall = clock, wall
    for m in (trace, jtrace, flight_recorder, jflight, history, jhistory):
        m.reset()


def _traced(tr, qid, monkeypatch):
    tick = itertools.count(10 ** 9, 3_000_000)
    monkeypatch.setattr(tr.TRACE, "clock", lambda: next(tick))
    wall = itertools.count(10 ** 18, 11)
    monkeypatch.setattr(tr.TRACE, "wall", lambda: next(wall))
    with tr.context(query_id=qid):
        with tr.span("query", query_id=qid):
            with tr.span("stage", stage_id=0, stage_kind="shuffle_map",
                         fingerprint="fpF", tasks=2):
                with tr.span("task_attempt", stage_id=0, task_id="m0",
                             attempt_id=1):
                    tr.event("retry", n=1, category="retryable")
                tr.event("breaker_trip", op_kind="SortExec", failures=3)


def _capture_both(tmp_path, monkeypatch, fn):
    """Run fn(flight, trace, faults) in each package with flight_dir the
    same path (emptied in between) and the clock fixed; returns each
    package's dossiers (name, doc) in name order."""
    d = tmp_path / "flight"
    for c in (conf, jconf):
        monkeypatch.setattr(c, "flight_dir", str(d))
    # knobs another test in this process left apart between the two
    # packages' confs: their values are compared by name only
    jknobs = jflight._knob_overlay()
    apart = {k for k, v in flight_recorder._knob_overlay().items()
             if jknobs.get(k) != v}
    out = []
    for fr, tr, flt, c in PAIRS:
        monkeypatch.setattr(fr, "time", types.SimpleNamespace(
            time=lambda: 1_700_000_123.456))
        fn(fr, tr, flt)
        names = sorted(os.listdir(d)) if d.exists() else []
        out.append([(n, _without(fr.load(str(d / n)), apart))
                    for n in names])
        for n in names:
            os.remove(d / n)
    return out


def _without(doc, apart):
    doc["knobs"] = {k: ("<apart>" if k in apart else v)
                    for k, v in doc["knobs"].items()}
    return doc


def _untimed(dossiers):
    return [(n, {k: v for k, v in doc.items() if k not in TIMED})
            for n, doc in dossiers]


INFO = {"query_id": "qF", "rows": 12, "serde_encode_ms": 4.0,
        "resource_leaks": 0}


@pytest.mark.parametrize("case", ["failure", "deadline", "hang", "shed",
                                  "resource_leak"])
def test_query_end_dossiers_match_jax(tmp_path, monkeypatch, case):
    def run(fr, tr, flt):
        _traced(tr, "qF", monkeypatch)
        info = dict(INFO, resource_leaks=int(case == "resource_leak"))
        exc = {"failure": ValueError("boom"),
               "deadline": flt.DeadlineError("late"),
               "hang": flt.HungError("stuck"),
               "shed": flt.AdmissionRejected("full"),
               "resource_leak": None}[case]
        if case == "hang":
            fr.record_stacks("qF", "hung")
        try:
            if exc is not None:
                raise exc
        except Exception:
            fr.on_query_end("qF", info, started_at=None)
        else:
            fr.on_query_end("qF", info, started_at=None)
        assert fr.last_error() is None

    port, jax = _capture_both(tmp_path, monkeypatch, run)
    assert _untimed(port) == _untimed(jax)
    assert len(port) == 1
    name, doc = port[0]
    assert name == f"dossier_1700000123456_{case}_qF.json"
    assert doc["trigger"] == case and doc["query_id"] == "qF"
    assert doc["executor_pool"] is None and doc["monitor_samples"] == []
    assert doc["ledger"]["stages"][0]["fingerprint"] == "fpF"
    assert abs(sum(doc["critical_path"]["terms"].values())
               - doc["critical_path"]["total_ms"]) < 0.01
    if case in ("deadline", "hang"):
        stacks = doc["thread_stacks"]
        assert stacks["reason"] == ("hung" if case == "hang" else case)
        assert stacks["stacks"]
    else:
        assert doc["thread_stacks"] is None


def test_capture_once_filters_and_retention_match_jax(tmp_path,
                                                      monkeypatch):
    def run(fr, tr, flt):
        _traced(tr, "qR", monkeypatch)
        monkeypatch.setattr({flight_recorder: conf, jflight: jconf}[fr],
                            "flight_retention", 2)
        assert fr.capture("failure", "qR", error=KeyError("k"),
                          run_info=INFO, detail={"x": 1})
        assert fr.capture("failure", "qR") is None  # exactly once
        assert fr.capture("failure", None) is None
        times = iter([1_700_000_200.0, 1_700_000_300.0])
        monkeypatch.setattr(fr, "time", types.SimpleNamespace(
            time=lambda: next(times)))
        assert fr.capture("slo_breach", "qR", tenant_id="t9")
        assert fr.capture("breaker_trip", "qR", detail={"op_kind": "X"})
        monkeypatch.setattr({flight_recorder: conf, jflight: jconf}[fr],
                            "flight_triggers", "hang, shed")
        assert not fr.enabled("failure") and fr.enabled("shed")
        assert fr.capture("executor_death", "qR") is None
        assert fr.counts() == {"failure": 1, "slo_breach": 1,
                               "breaker_trip": 1}
        listed = fr.list_dossiers()
        assert [x["trigger"] for x in listed] == ["breaker_trip",
                                                  "slo_breach"]
        assert listed[1]["tenant_id"] == "t9"

    port, jax = _capture_both(tmp_path, monkeypatch, run)
    assert _untimed(port) == _untimed(jax)
    assert [doc["trigger"] for _, doc in port] == ["slo_breach",
                                                    "breaker_trip"]


def test_capture_makes_no_device_call(tmp_path, monkeypatch):
    """A poisoned CUDA context raises on any device query: the dossier of
    the failure is written all the same, and nothing was swallowed."""
    import torch

    def poisoned(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    for name in ("synchronize", "memory_allocated", "max_memory_allocated",
                 "memory_reserved", "memory_stats", "mem_get_info",
                 "current_stream", "device_count", "get_device_name",
                 "is_available", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, poisoned)
    monkeypatch.setattr(conf, "flight_dir", str(tmp_path / "f"))
    _traced(trace, "qC", monkeypatch)
    try:
        raise faults.FatalError("CUDA error: an illegal memory access")
    except Exception:
        flight_recorder.on_query_end("qC", dict(INFO), started_at=None)
    assert flight_recorder.last_error() is None
    (doc,) = [flight_recorder.load(x["path"])
              for x in flight_recorder.list_dossiers()]
    assert doc["trigger"] == "failure" and doc["error"]["type"] == \
        "FatalError"


# ---- the runtime's taps ----

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=4000)


KNOBS = ("hang_detect_ms", "query_deadline_ms", "breaker_failure_threshold",
         "max_task_retries", "retry_backoff_ms", "fault_injection_spec")


@pytest.fixture
def runtime_conf(tmp_path, monkeypatch):
    for k in KNOBS:
        monkeypatch.setattr(conf, k, getattr(conf, k))
    monkeypatch.setattr(conf, "flight_dir", str(tmp_path / "flight"))
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    yield
    faults.install(None)


def _dossiers():
    return [flight_recorder.load(x["path"])
            for x in reversed(flight_recorder.list_dossiers())]


def test_hang_dossier_from_a_stalled_run(tables, tmp_path, runtime_conf):
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    (paths, frames), _ = tables["core"]
    plan, oracle = validator.QUERIES["q2_q06_core_agg"](paths, frames, "bhj")
    conf.hang_detect_ms = 600
    faults.install({"seed": 21, "points": {"op": {"kind": "stall", "nth": 3,
                                                  "ms": 30_000}}})
    info = {"query_id": "qHang"}
    out = run_plan(plan, num_partitions=4, work_dir=str(tmp_path / "w"),
                   mesh_exchange="off", run_info=info, device="cpu")
    assert validator._compare(validator._to_pandas(out).reset_index(
        drop=True), oracle().reset_index(drop=True)) is None
    assert info["hangs_detected"] >= 1
    # the query survived: on_query_end writes no failure dossier, and the
    # stash from the watchdog is dropped with the query
    assert _dossiers() == [] and flight_recorder._stacks == {}
    # the stash written at detection is what a capture would carry
    faults.install({"seed": 21, "points": {"op": {"kind": "stall", "nth": 3,
                                                  "ms": 30_000}}})
    conf.max_task_retries = 0
    plan, _ = validator.QUERIES["q2_q06_core_agg"](paths, frames, "bhj")
    with pytest.raises(faults.HungError):
        run_plan(plan, num_partitions=4, work_dir=str(tmp_path / "w2"),
                 mesh_exchange="off", run_info={"query_id": "qHang2"},
                 device="cpu")
    (doc,) = _dossiers()
    assert doc["trigger"] == "hang" and doc["query_id"] == "qHang2"
    assert doc["thread_stacks"]["reason"] == "hung"
    assert any("stall" in "".join(s["frames"])
               for s in doc["thread_stacks"]["stacks"])


def test_deadline_dossier(tables, tmp_path, runtime_conf):
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    (paths, frames), _ = tables["core"]
    plan, _ = validator.QUERIES["q1_scan_filter_project"](paths, frames,
                                                          "bhj")
    faults.install({"seed": 23, "points": {"op": {"kind": "stall",
                                                  "nth": 1, "ms": 30_000}}})
    conf.query_deadline_ms = 800
    with pytest.raises(faults.DeadlineError):
        run_plan(plan, num_partitions=4, work_dir=str(tmp_path / "w"),
                 run_info={"query_id": "qDead"}, device="cpu")
    (doc,) = _dossiers()
    assert doc["trigger"] == "deadline" and doc["query_id"] == "qDead"
    assert doc["error"]["type"] == "DeadlineError"
    assert doc["thread_stacks"]["reason"] == "deadline"


def test_breaker_trip_dossier(tmp_path, runtime_conf):
    from blaze_tpu_torch.runtime.supervisor import CircuitBreaker

    conf.breaker_failure_threshold = 2
    br = CircuitBreaker({})
    e = faults.RetryableError("x")
    e.point = "op.SortExec"
    with trace.context(query_id="qBr"):
        br.note_failure(e, "retryable")
        assert _dossiers() == []
        br.note_failure(e, "retryable")
    (doc,) = _dossiers()
    assert doc["trigger"] == "breaker_trip" and doc["query_id"] == "qBr"
    assert doc["detail"] == {"op_kind": "SortExec", "failures": 2}


def test_driver_restart_dossier(tmp_path, runtime_conf, monkeypatch):
    import subprocess
    import sys

    from blaze_tpu_torch.runtime import journal

    monkeypatch.setattr(conf, "journal_dir", str(tmp_path / "journal"))
    monkeypatch.setattr(conf, "recovery_enabled", True)
    journal.reset()
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    jnl = journal.QueryJournal("qCrashed")
    jnl.record("admitted", tenant_id="t0", pid=p.pid)
    jnl.plan(fingerprint="qfp", num_partitions=2, stages=[])
    try:
        assert journal.ensure_recovery_scan(force=True)["scanned"] == 1
    finally:
        journal.reset()
    (doc,) = _dossiers()
    assert doc["trigger"] == "driver_restart"
    assert doc["query_id"] == "qCrashed" and doc["tenant_id"] == "t0"
    assert doc["detail"]["plan_fingerprint"] == "qfp"
    assert json.dumps(doc)
