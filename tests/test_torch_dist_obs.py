"""The port's cross-process telemetry plane and control-plane partition
tolerance (runtime/executor_pool.py with runtime/monitor.py and
runtime/trace.py) on the CPU, held to the JAX package where the two can
be fed the same input.

- Federation primitives: for the same counts, the port's
  `drain_remote_deltas`, `drain_zerocopy` and the roll-up after
  `merge_remote` equal the JAX package's (stage ids surviving the JSON
  wire); `_clamp_offset` equals the JAX package's over a sweep.
- A SIGKILLed worker's sidecar is recovered once, its spans truncated and
  rebased, its counters merged, and the death dossier embeds the slice.
- A zombie's late telemetry frame is dropped, never double-counted.
- The doctor's `executor_skew` over records a real pool federated: both
  packages' doctors give the same findings for them.
- The control plane: a broken connection reconnects and resumes without
  a death; an asymmetric partition ends in one death and the worker's
  self-fence (exit 17); decommission drains without a death and without
  a respawn; SIGTERM drains, then the seat respawns.

Counts are exact; waits are bounded by deadlines.
"""

import json
import os
import signal
import threading
import time

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import doctor as jdoctor
from blaze_tpu.runtime import executor_pool as jep
from blaze_tpu.runtime import monitor as jmonitor
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import doctor, flight_recorder, monitor, trace
from blaze_tpu_torch.runtime import executor_pool as ep


@pytest.fixture
def telemetry_conf(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "executor_death_ms", 600)
        monkeypatch.setattr(c, "executor_heartbeat_ms", 50)
        monkeypatch.setattr(c, "executor_restart_backoff_ms", 50)
        monkeypatch.setattr(c, "trace_enabled", True)
        monkeypatch.setattr(c, "monitor_enabled", True)
    for mod in (trace, monitor, jtrace, jmonitor):
        mod.reset()
    yield
    for mod in (trace, monitor, jtrace, jmonitor):
        mod.reset()


def _run_async(pool, specs):
    box = {}

    def run():
        try:
            box["out"] = pool.run_tasks(specs, timeout=120)
        except Exception as e:  # noqa: BLE001 — asserted by callers
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def _wait(pred, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


# ---- federation primitives against the JAX package ----


def _worker_side(mon, tr, qid):
    mon.ensure_query(qid)
    with tr.context(query_id=qid, stage_id=3):
        mon.count_copy("shuffle", 1000, moved=700)
        mon.count_copy("serde", 40)
        mon.count_time("serde_encode", 2_000_000)
        mon.count_zerocopy("shuffle_mmap_hits", 5)
        mon.count_zerocopy("shuffle_mmap_fallbacks")
    with tr.context(query_id=qid, stage_id=4):
        mon.count_time("shuffle_io", 3_000_000)
    deltas = mon.drain_remote_deltas()
    zc = mon.drain_zerocopy()
    again = (mon.drain_remote_deltas(), mon.drain_zerocopy())
    return json.loads(json.dumps(deltas)), zc, again


def _driver_side(mon, qid, wire, zc):
    mon.reset()
    mon.begin_query(qid)
    mon.merge_remote(wire)
    mon.merge_zerocopy(zc)
    mon.merge_remote({"q-late": wire[qid]})   # a query already rolled up
    attrs = (mon.stage_span_attrs(qid, 3), mon.stage_span_attrs(qid, 4))
    roll = mon.query_end(qid)
    return attrs, roll, mon.copy_totals(), mon.zerocopy_stats()


def test_monitor_federation_docs_equal_jax(telemetry_conf):
    got = _worker_side(monitor, trace, "qfed")
    want = _worker_side(jmonitor, jtrace, "qfed")
    assert got == want
    wire, zc, again = got
    assert "3" in wire["qfed"]["stage_copied"]
    assert zc == {"shuffle_mmap_hits": 5, "shuffle_mmap_fallbacks": 1}
    assert again == ({}, {})
    pa, proll, ptot, pzc = _driver_side(monitor, "qfed", wire, zc)
    ja, jroll, jtot, jzc = _driver_side(jmonitor, "qfed", wire, zc)
    assert pa == ja and ptot == jtot and pzc == jzc
    # each package's compile_* keys count its own compile service's
    # events over the query: compared by key
    compile_keys = {k for k in jroll if k.startswith("compile_")}
    assert compile_keys and set(proll) == set(jroll)
    assert {k: proll[k] for k in proll if k not in compile_keys} == \
        {k: jroll[k] for k in proll if k not in compile_keys}
    assert proll["bytes_copied_shuffle"] == 1000
    assert proll["serde_encode_ms"] == 2.0
    assert pa[0]["copied_bytes"] == 1040


def test_clamp_offset_equals_jax(monkeypatch):
    for bound in (0, 100, 5000):
        monkeypatch.setattr(conf, "clock_skew_bound_ms", bound)
        monkeypatch.setattr(jconf, "clock_skew_bound_ms", bound)
        for off in (0, 5, -5, 10**8, -10**8, 3 * 10**11, -3 * 10**11,
                    10**16):
            assert ep._clamp_offset(off) == jep._clamp_offset(off)
    monkeypatch.setattr(conf, "clock_skew_bound_ms", 100)
    assert ep._clamp_offset(300_000_000) == 100_000_000


def test_counter_and_histogram_merges_equal_jax():
    a = {"q": {"copied": {"shuffle": 3}, "stage_time_ns": {"1": {"x": 2}}}}
    b = {"q": {"copied": {"shuffle": 4, "ffi": 1},
               "stage_time_ns": {"1": {"x": 5, "y": 1}}},
         "r": {"moved": {"spill": 9}}}
    h1 = {"lat": {"counts": [1, 2], "count": 3, "total": 30, "min": 1,
                  "max": 20}}
    h2 = {"lat": {"counts": [0, 1, 4], "count": 5, "total": 70,
                  "min": None, "max": 40}, "new": {"counts": [1],
                                                   "count": 1}}
    out = []
    for mod in (ep, jep):
        dst, hd = {}, {}
        for src in (a, b):
            mod._merge_counter_deltas(dst, json.loads(json.dumps(src)))
        for src in (h1, h2):
            mod._merge_hist_snaps(hd, json.loads(json.dumps(src)))
        out.append((dst, hd))
    assert out[0] == out[1]
    assert out[0][0]["q"]["stage_time_ns"]["1"] == {"x": 7, "y": 1}


# ---- crash recovery of the telemetry plane ----


def test_sigkill_recovers_sidecar_spans_truncated(telemetry_conf,
                                                  tmp_path, monkeypatch):
    monkeypatch.setattr(conf, "flight_dir", str(tmp_path / "flight"))
    flight_recorder.reset()
    pool = ep.ExecutorPool(count=1, slots=1).start()
    try:
        handle = pool.live_handles()[0]
        now_ns = time.monotonic_ns()
        spilled = [
            {"type": "span", "kind": "task_attempt", "ts": now_ns,
             "dur": 5_000_000, "query_id": "qkill", "stage_id": 1,
             "task_id": 0, "attrs": {"what": "shuffle_map[1:0]"}},
            {"type": "event", "kind": "pipeline_stats", "ts": now_ns,
             "attrs": {}},
            {"malformed": "no kind"},
        ]
        sidecar = {"type": "telemetry", "seq": handle.tel_seq + 1,
                   "records": spilled,
                   "counters": {"qkill": {"copied": {"shuffle": 4321},
                                          "moved": {"shuffle": 4321}}},
                   "zerocopy": {"shuffle_mmap_hits": 2},
                   "histograms": {}, "dropped": 0, "mono_ns": now_ns}
        with open(os.path.join(pool._dir,
                               f"{handle.token}.telemetry"), "w") as f:
            json.dump(sidecar, f)
        copied0, _ = monitor.copy_totals()
        hits0 = monitor.zerocopy_stats()["shuffle_mmap_hits"]
        t, box = _run_async(pool, [ep.PoolTaskSpec("k:0", "sleep",
                                                   {"ms": 600})])
        _wait(pool.busy_pids, 10, "a busy executor")
        os.kill(handle.pid, signal.SIGKILL)
        t.join(timeout=120)
        assert "err" not in box and box["out"][0]["ok"]
        recs = trace.TRACE.snapshot()
        rec_spans = [r for r in recs if r.get("truncated")]
        assert len(rec_spans) == 2          # the malformed entry skipped
        assert all(r["exec"] == handle.exec_id for r in rec_spans)
        span = next(r for r in rec_spans if r["kind"] == "task_attempt")
        assert span["query_id"] == "qkill"
        assert span["ts"] == now_ns + handle.clock_offset_ns
        assert "telemetry_recovered" in {r["kind"] for r in recs
                                         if r["type"] == "event"}
        copied1, _ = monitor.copy_totals()
        assert copied1["shuffle"] - copied0["shuffle"] == 4321
        assert monitor.zerocopy_stats()["shuffle_mmap_hits"] - hits0 == 2
        assert pool.stats()["telemetry_records_total"] >= 3
        deaths = [d for d in flight_recorder.list_dossiers(
            str(tmp_path / "flight")) if d.get("trigger") == "executor_death"]
        assert len(deaths) == 1
        detail = flight_recorder.load(deaths[0]["path"])["detail"]
        assert detail["executor_trace"] == spilled
        out = str(tmp_path / "merged.json")
        trace.export_chrome_trace(out, records=recs)
        with open(out) as f:
            doc = json.load(f)
        names = [ev["args"]["name"] for ev in doc["traceEvents"]
                 if ev.get("ph") == "M" and ev.get("name") == "process_name"]
        assert any(f"[{handle.exec_id}]" in n for n in names)
    finally:
        pool.close()


def test_zombie_telemetry_dropped_not_double_counted(telemetry_conf,
                                                     monkeypatch):
    monkeypatch.setattr(conf, "executor_restart_max", 0)
    pool = ep.ExecutorPool(count=2, slots=1).start()
    try:
        specs = [ep.PoolTaskSpec(f"z:{i}", "sleep", {"ms": 400})
                 for i in range(2)]
        t, box = _run_async(pool, specs)
        _wait(lambda: len(pool.busy_pids()) == 2, 10, "two busy seats")
        seat = next(iter(pool.busy_pids()))
        fenced_before = pool.fence.fenced_total
        assert pool.hang_executor(seat, 2500)
        t.join(timeout=120)
        assert "err" not in box and all(r["ok"] for r in box["out"])
        assert pool.stats()["deaths_total"] >= 1
        _wait(lambda: pool.fence.fenced_total > fenced_before, 15,
              "the zombie's late result")
        time.sleep(0.3)
        attempts = [r for r in trace.TRACE.snapshot()
                    if r.get("kind") == "task_attempt" and r.get("exec")]
        per_key = {}
        for r in attempts:
            what = (r.get("attrs") or {}).get("what")
            per_key[what] = per_key.get(what, 0) + 1
        assert sum(per_key.values()) == 3, per_key
        assert sorted(per_key.values()) == [1, 2], per_key
        displaced_key = max(per_key, key=per_key.get)
        displaced = [r for r in attempts
                     if (r.get("attrs") or {}).get("what") == displaced_key]
        assert sorted(bool(r.get("truncated")) for r in displaced) \
            == [False, True]
    finally:
        pool.close()


def test_doctor_executor_skew_over_federated_records(telemetry_conf):
    """Two workers, one task each, one 40x longer: the task_attempt spans
    come back over the wire stamped with their exec ids, and both
    packages' doctors flag the same executor_skew on them."""
    pool = ep.ExecutorPool(count=2, slots=1).start()
    try:
        specs = [ep.PoolTaskSpec(
            f"skew:{i}", "sleep", {"ms": ms, "query_id": "qskew",
                                   "stage_id": 0, "task_id": i,
                                   "what": f"t{i}"})
            for i, ms in enumerate((400, 10))]
        pool.run_tasks(specs, timeout=60)
        recs = [r for r in trace.TRACE.snapshot()
                if r.get("kind") == "task_attempt" and r.get("exec")]
        assert len(recs) == 2
        assert len({r["exec"] for r in recs}) == 2
        assert {r["query_id"] for r in recs} == {"qskew"}
    finally:
        pool.close()
    record = {"query_id": "qskew", "duration_ms": 500.0, "counters": {},
              "stages": []}
    got = doctor.diagnose(record, recs, critical_path={"total_ms": 500.0})
    want = jdoctor.diagnose(record, recs, critical_path={"total_ms": 500.0})
    assert [(f.code, f.evidence) for f in got] == \
        [(f.code, f.evidence) for f in want]
    skew = [f for f in got if f.code == "executor_skew"]
    assert skew and skew[0].evidence["ratio"] >= conf.doctor_skew_ratio
    slow = next(r for r in recs if r["attrs"]["what"] == "t0")
    assert skew[0].evidence["exec_id"] == slow["exec"]


# ---- the control plane ----


@pytest.fixture
def net_conf(monkeypatch):
    monkeypatch.setattr(conf, "executor_death_ms", 900)
    monkeypatch.setattr(conf, "executor_heartbeat_ms", 50)
    monkeypatch.setattr(conf, "executor_restart_backoff_ms", 50)
    monkeypatch.setattr(conf, "control_reconnect_backoff_ms", 25)


def test_conn_break_reconnects_without_death(net_conf, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(conf, "flight_dir", str(tmp_path / "flight"))
    monkeypatch.setattr(conf, "trace_enabled", True)
    trace.reset()
    pool = ep.ExecutorPool(count=2, slots=1).start()
    caps = []
    pool.on_membership(lambda p: caps.append(p.capacity()))
    try:
        specs = [ep.PoolTaskSpec(f"rc:{i}", "sleep", {"ms": 400})
                 for i in range(4)]
        t, box = _run_async(pool, specs)
        _wait(pool.busy_pids, 10, "a busy executor")
        assert pool.break_conn(next(iter(pool.busy_pids())))
        t.join(timeout=120)
        assert "err" not in box and all(r["ok"] for r in box["out"])
        st = pool.stats()
        assert st["deaths_total"] == 0 and st["reconnects_total"] >= 1
        assert st["tasks_done"] == 4
        assert pool.capacity() == 2 and all(c == 2 for c in caps)
        assert flight_recorder.list_dossiers(str(tmp_path / "flight")) == []
        assert "control_reconnect" in {r.get("kind") for r in
                                       trace.TRACE.snapshot()}
    finally:
        pool.close()
        trace.reset()


def test_asymmetric_partition_lease_self_fence(net_conf):
    pool = ep.ExecutorPool(count=2, slots=1).start()
    try:
        specs = [ep.PoolTaskSpec(f"pt:{i}", "sleep", {"ms": 400})
                 for i in range(4)]
        t, box = _run_async(pool, specs)
        _wait(pool.busy_pids, 10, "a busy executor")
        seat = next(iter(pool.busy_pids()))
        with pool._lock:
            proc = pool._seats[seat].proc
        assert pool.partition_executor(seat, 4000)
        t.join(timeout=120)
        assert "err" not in box and all(r["ok"] for r in box["out"])
        assert pool.stats()["deaths_total"] == 1
        _wait(lambda: proc.poll() is not None, 30, "the self-fence")
        assert proc.poll() == ep._Worker._LEASE_EXIT == 17
    finally:
        pool.close()


def test_decommission_drains_seat_without_death(net_conf):
    pool = ep.ExecutorPool(count=2, slots=2).start()
    try:
        seat = sorted(pool.pids())[0]
        assert pool.decommission(seat)
        assert pool.capacity() == 2 and pool.stats()["draining"] == 1
        _wait(lambda: pool.stats()["drains_total"] == 1, 30, "the drain")
        st = pool.stats()
        assert st["deaths_total"] == 0 and st["drain_requeues_total"] == 0
        time.sleep(0.3)  # no respawn may race in after retirement
        assert pool.live_count() == 1 and pool.capacity() == 2
    finally:
        pool.close()


def test_sigterm_drains_then_respawns(net_conf):
    pool = ep.ExecutorPool(count=2, slots=1).start()
    try:
        specs = [ep.PoolTaskSpec(f"dr:{i}", "sleep", {"ms": 300})
                 for i in range(4)]
        t, box = _run_async(pool, specs)
        _wait(pool.busy_pids, 10, "a busy executor")
        seat, pid = next(iter(pool.busy_pids().items()))
        os.kill(pid, signal.SIGTERM)
        t.join(timeout=120)
        assert "err" not in box and all(r["ok"] for r in box["out"])
        st = pool.stats()
        assert st["deaths_total"] == 0 and st["drains_total"] == 1
        assert st["drain_requeues_total"] == 0
        _wait(lambda: pool.live_count() == 2
              and pool.pids().get(seat) != pid, 30, "the respawn")
        assert pool.capacity() == 2
    finally:
        pool.close()


# ---- the exporters over the federation (the JAX package's cases,
# tests/test_dist_obs.py:143 and :163, on both packages) ----


def test_progress_finished_ring_bounds_cardinality(telemetry_conf):
    """blaze_query_progress_ratio prunes stale qid series: finished
    queries linger in a bounded last-N ring, older ones age out of the
    exposition entirely."""
    from blaze_tpu.runtime import progress as jprogress
    from blaze_tpu_torch.runtime import progress

    assert progress.FINISHED_RING == jprogress.FINISHED_RING
    series = []
    for prog, mon in ((progress, monitor), (jprogress, jmonitor)):
        prog.reset()
        try:
            n = prog.FINISHED_RING + 5
            for i in range(n):
                prog.begin_query(f"qcard{i:03d}")
                prog.finish_query(f"qcard{i:03d}")
            rows = prog.finished_queries()
            assert len(rows) == prog.FINISHED_RING
            kept = {r["query_id"] for r in rows}
            assert f"qcard{n - 1:03d}" in kept          # newest kept
            assert "qcard000" not in kept               # oldest pruned
            text = mon.prometheus_text()
            assert 'blaze_query_progress_ratio{qid="qcard000"}' not in text
            assert (f'blaze_query_progress_ratio{{qid="qcard{n - 1:03d}"}}'
                    in text)
            series.append([line for line in text.splitlines()
                           if line.startswith("blaze_query_progress")])
        finally:
            prog.reset()
    assert series[0] == series[1]


def test_prometheus_per_executor_federation_gauges(telemetry_conf):
    """The four executor-pane families render one labeled row per
    executor from the pool's executors() snapshot."""

    class _Stub:
        def capacity(self):
            return 2

        def live_count(self):
            return 1

        def stats(self):
            return {"count": 1, "live": 1, "capacity": 2, "slots": 2,
                    "inflight": 0, "deaths_total": 0, "restarts_total": 0,
                    "fenced_total": 0, "tasks_done": 7}

        def executors(self):
            return [{"exec_id": "exec0", "pid": 1, "generation": 0,
                     "up": True, "inflight": 1, "heartbeat_age_ms": 12,
                     "tasks_done": 7, "telemetry_bytes": 3456,
                     "telemetry_records": 9, "telemetry_dropped": 0}]

    want = ('blaze_executor_heartbeat_age_ms{exec_id="exec0"} 12',
            'blaze_executor_busy_slots{exec_id="exec0"} 1',
            'blaze_executor_tasks_done_total{exec_id="exec0"} 7',
            'blaze_executor_telemetry_bytes_total{exec_id="exec0"} 3456')
    rows = []
    for pool_mod, mon in ((ep, monitor), (jep, jmonitor)):
        stub = _Stub()
        pool_mod.activate(stub)
        try:
            text = mon.prometheus_text()
        finally:
            pool_mod.deactivate(stub)
        assert all(line in text for line in want)
        rows.append([line for line in text.splitlines()
                     if line.startswith("blaze_executor_")])
    assert rows[0] == rows[1]
