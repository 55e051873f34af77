"""The port's resource accounting (runtime/monitor.py) against the JAX
package's, on the CPU.

The same seeded rows go into a batch of each package, and each package's
monitor counts the same operation: a serde round trip, an ffi pull, a
spill write and read, a shuffle writer's pushes. The copied and moved
bytes of every boundary must be equal (the frames are byte-identical:
both packages compress with zstandard here). A disabled monitor counts
nothing; a query's bytes are attributed through the active query; the
leak check reports clean and leaking queries whatever the knob says. End
to end, two catalogue queries run through each package's run_plan (the
mesh exchange off on both sides, the supervisor's pool on) and the
roll-up's byte, spill, zero-copy and leak keys are equal. Both roll-ups
carry the compile_* keys (COMPILE_KEYS); each package counts its own
builds and cache events there, so those are compared by key.

The sampler and the exporters: the same byte traffic and histogram
values give the same Prometheus exposition, family by family (names,
label sets, types and values; families whose values read a clock, a pid
or the compile service are compared by presence), the same sampler ring
keys and /healthz codes, and both MetricsServers answer the same routes
with the same statuses. The port's compile-service series and gauges read
its own compile service's counters.
"""

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from blaze_tpu.columnar import serde as jserde
from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import memory as jmemory
from blaze_tpu.runtime import monitor as jmonitor
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import memory, monitor, trace
from torch_parity import both_tables, no_jax_native

# the roll-up keys of each package's compile service: the port counts its
# library builds and per-plan callables, the JAX package its XLA programs,
# so they are compared by key
COMPILE_KEYS = {"compile_ms", "compile_cache_hits", "compile_cache_misses",
                "compile_compile_count"}


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "spill_dir", str(tmp_path / "spill"))
        monkeypatch.setattr(c, "monitor_enabled", True)
    for m in (monitor, jmonitor, trace, jtrace):
        m.reset()
    yield
    for m in (monitor, jmonitor, trace, jtrace):
        m.reset()


def _schema(mod):
    return mod.Schema([mod.Field("a", mod.INT64), mod.Field("s", mod.STRING),
                       mod.Field("x", mod.FLOAT64)])


def _pair(rows=64, seed=3):
    rng = np.random.default_rng(seed)
    s = np.array([f"row{i:04d}".encode() * int(1 + i % 3)
                  for i in rng.integers(0, 500, rows)], object)
    x = (rng.standard_normal(rows) * 10).astype(object)
    x[::7] = None
    data = {"a": rng.integers(0, 10 ** 6, rows).astype(np.int64), "s": s,
            "x": x}
    return (ColumnBatch.from_numpy(data, _schema(T), device="cpu"),
            JBatch.from_numpy(data, _schema(JT)))


def _totals():
    return monitor.copy_totals(), jmonitor.copy_totals()


def test_serde_round_trip_byte_exact():
    tb, jb = _pair()
    hb, jhb = serde.to_host(tb), jserde.to_host(jb)
    (copied, _), (jcopied, _) = _totals()
    assert copied["ffi"] == jcopied["ffi"] == jserde.host_batch_nbytes(jhb)
    monitor.reset()
    jmonitor.reset()
    frame, jframe = hb.serialize(), jhb.serialize()
    assert frame == jframe
    raw_len = int.from_bytes(frame[4:8], "little")
    (copied, moved), (jcopied, jmoved) = _totals()
    assert copied["serde"] == jcopied["serde"] == raw_len
    assert moved["serde"] == jmoved["serde"] == len(frame)
    out = serde.deserialize_batch(frame, tb.schema, device="cpu")
    jserde.deserialize_batch(jframe, jb.schema)
    assert int(out.num_rows) == 64
    assert _totals()[0] == _totals()[1]
    assert monitor.copy_totals()[0]["serde"] == 2 * raw_len


def test_ffi_pull_and_upload_match_jax():
    from blaze_tpu.ops.host_sort import host_to_device as jh2d
    from blaze_tpu_torch.ops.host_sort import host_to_device

    tb, jb = _pair(200, seed=5)
    hb, jhb = serde.to_host(tb), jserde.to_host(jb)
    host_to_device(hb, device="cpu")
    jh2d(jhb)
    (copied, moved), (jcopied, jmoved) = _totals()
    assert copied == jcopied and moved == jmoved
    assert copied["ffi"] == 2 * serde.host_batch_nbytes(hb) > 0


def test_spill_write_and_read_byte_exact():
    tb, jb = _pair()
    mgr = memory.MemManager(total=1 << 30)
    jmgr = jmemory.MemManager(total=1 << 30)
    sf = memory.SpillFile(tb.schema, manager=mgr)
    jsf = jmemory.SpillFile(jb.schema, dir=conf.spill_dir, manager=jmgr)
    try:
        for _ in range(2):
            sf.write(tb)
            jsf.write(jb)
        (copied, _), (jcopied, _) = _totals()
        assert copied["spill"] == jcopied["spill"] == sf.bytes_written \
            == jsf.bytes_written
        assert sum(int(b.num_rows) for b in sf.read()) == 128
        assert sum(int(b.num_rows) for b in jsf.read()) == 128
        assert _totals()[0] == _totals()[1]
        assert monitor.copy_totals()[0]["spill"] == 2 * sf.bytes_written
    finally:
        sf.close()
        jsf.close()


def test_shuffle_writer_push_byte_exact():
    from blaze_tpu.ops.shuffle import _WriterBuffers as JWriterBuffers
    from blaze_tpu_torch.ops.shuffle import _WriterBuffers

    tb, jb = _pair()
    frames = [serde.to_host(tb).serialize(lo, hi)
              for lo, hi in ((0, 32), (32, 64))]
    mgr = memory.MemManager(total=1 << 30)
    jmgr = jmemory.MemManager(total=1 << 30)
    wb, jwb = _WriterBuffers(2, mgr), JWriterBuffers(2, jmgr)
    monitor.reset()
    try:
        for p, f in enumerate(frames):
            wb.push(p, f)
            jwb.push(p, f)
        (copied, moved), (jcopied, jmoved) = _totals()
        assert copied["shuffle"] == jcopied["shuffle"] == sum(
            len(f) for f in frames)
        assert moved["shuffle"] == jmoved["shuffle"] == copied["shuffle"]
    finally:
        wb.close()
        jwb.close()
        jmgr.unregister(jwb)


def test_disabled_monitor_counts_nothing(monkeypatch):
    monkeypatch.setattr(conf, "monitor_enabled", False)
    tb, _ = _pair()
    frame = serde.to_host(tb).serialize()
    serde.deserialize_batch(frame, tb.schema, device="cpu")
    sf = memory.SpillFile(tb.schema)
    sf.write(tb)
    list(sf.read())
    sf.close()
    monitor.begin_query("qD")
    copied, moved = monitor.copy_totals()
    assert not any(copied.values()) and not any(moved.values())
    assert monitor.query_end("qD") == {}
    assert monitor.zerocopy_stats() == dict.fromkeys(monitor.ZEROCOPY_KEYS,
                                                     0)


def test_query_attribution_via_active_query():
    # no trace context: attribution falls back to the registered query
    tb, jb = _pair()
    monitor.begin_query("qA")
    jmonitor.begin_query("qA")
    serde.to_host(tb).serialize()
    jserde.to_host(jb).serialize()
    roll, jroll = monitor.query_end("qA"), jmonitor.query_end("qA")
    assert set(jroll) == set(roll) and COMPILE_KEYS <= set(roll)

    def counts(r):  # the times are the host's own
        return {k: v for k, v in r.items()
                if not k.endswith("_ms") and k not in COMPILE_KEYS}

    assert counts(roll) == counts(jroll)
    assert roll["bytes_copied_total"] == roll["bytes_copied_ffi"] + roll[
        "bytes_copied_serde"] > 0
    # popped: later copies are process-wide only
    serde.to_host(tb)
    assert monitor.query_end("qA") == {}


def test_stage_attribution_through_the_trace_context():
    tb, _ = _pair()
    monitor.begin_query("qS")
    with trace.context(query_id="qS", stage_id=3):
        hb = serde.to_host(tb)
    attrs = monitor.stage_span_attrs("qS", 3)
    assert attrs["copied_bytes"] == serde.host_batch_nbytes(hb)
    assert monitor.stage_span_attrs("qS", 4) == {}
    monitor.query_end("qS")


@pytest.mark.parametrize("enabled", [True, False])
def test_leak_check_matches_jax(monkeypatch, enabled):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "monitor_enabled", enabled)
        monkeypatch.setattr(c, "trace_enabled", True)
    infos = []
    for mon, mem in ((monitor, memory), (jmonitor, jmemory)):
        clean_info = {}
        mon.finish_query("qC", clean_info, mem.MemManager(total=1 << 30))
        mgr = mem.MemManager(total=1 << 30)
        mgr.reserve_pipeline(4096)
        leaky = {"pipeline_live_streams": 2}
        mon.finish_query("qL", leaky, mgr)
        mgr.release_pipeline(4096)
        infos.append((clean_info, leaky, mon.leaks_total()))
    assert infos[0] == infos[1]
    assert infos[0][0]["resource_leaks"] == 0
    assert infos[0][1]["resource_leaks"] == infos[0][2] == 2
    ev = [r for r in trace.TRACE.snapshot() if r["kind"] == "resource_leak"]
    assert ev and "pipeline_reserved=4096" in ev[0]["attrs"]["leaks"]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, 2000)


ROLLUP_KEYS = tuple(f"bytes_{kind}_{b}" for kind in ("copied", "moved")
                    for b in monitor.BOUNDARIES + ("total",)) + (
    "spill_bytes", "spill_count", "resource_leaks") + monitor.ZEROCOPY_KEYS


@pytest.mark.parametrize("suite,q", [("core", "q4_repartition_sort"),
                                     ("tpcds", "q03")])
def test_query_rollup_matches_jax(tables, monkeypatch, tmp_path, suite, q):
    """Both packages' run_plan at their defaults but for the mesh (off on
    both sides; the port's trace on): the supervisor's pool runs the
    tasks, whose threads take the query and stage from the supervisor's
    replay of the trace context. (Where a
    partial aggregate's groups come out in another order than the JAX
    package's, as in core q2_q06_core_agg, the frames hold the same raw
    bytes but compress to other sizes, so those queries are not used.)"""
    from blaze_tpu.spark import tpcds as jtpcds
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.spark import tpcds, validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    no_jax_native(monkeypatch)
    monkeypatch.setattr(conf, "trace_enabled", True)
    port, jax = {"core": (validator, jvalidator),
                 "tpcds": (tpcds, jtpcds)}[suite]
    (paths, frames), (jpaths, jframes) = tables[suite]
    info, jinfo = {}, {}
    out = run_plan(port.QUERIES[q](paths, frames, "bhj")[0], num_partitions=4,
                   work_dir=str(tmp_path / "port"), mesh_exchange="off",
                   run_info=info, device="cpu")
    jout = jrun_plan(jax.QUERIES[q](jpaths, jframes, "bhj")[0],
                     num_partitions=4, work_dir=str(tmp_path / "jax"),
                     mesh_exchange="off", run_info=jinfo)
    assert int(out.num_rows) == int(jout.num_rows) > 0
    assert {k: info[k] for k in ROLLUP_KEYS} == {k: jinfo[k]
                                                 for k in ROLLUP_KEYS}
    for b in ("serde", "shuffle", "ffi"):
        assert info[f"bytes_copied_{b}"] > 0, b
    assert info["peak_mem_bytes"] > 0 and info["resource_leaks"] == 0
    assert COMPILE_KEYS <= set(jinfo) and COMPILE_KEYS <= set(info)
    assert info["serde_encode_ms"] > 0 and info["serde_decode_ms"] > 0
    # the result stage's tasks ran on pool threads: its bytes carry its
    # stage id, which only the supervisor's replay of the trace context
    # gives them (the active-query fallback names no stage)
    recs = trace.query_records(info["query_id"])
    (result,) = [r for r in recs if r["kind"] == "stage"
                 and r["attrs"]["stage_kind"] == "result"]
    assert result["attrs"]["copied_bytes"] > 0
    assert any(r["kind"] == "task_attempt"
               and r["stage_id"] == result["stage_id"]
               and r["thread"].startswith("blz-task") for r in recs)


# ---- the sampler and the exporters ----

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE = re.compile(
    r"^" + _NAME + r"(\{[^{}]*\})? -?[0-9]+(\.[0-9]+)?([eE][-+]?[0-9]+)?$")

# families whose samples read a clock, the process, what other tests in
# the same process left behind (dossiers, journals, pools, profiles) or
# the JAX package's compile service: compared by name and type
BY_PRESENCE = ("blaze_mem_", "blaze_spill", "blaze_trace_buffer_events",
               "blaze_profile_", "blaze_compile_", "blaze_pipeline_",
               "blaze_faults_", "blaze_hist_", "blaze_queries_running",
               "blaze_supervisor_active_tasks", "blaze_executor_",
               "blaze_flight_", "blaze_recovered_", "blaze_artifact_",
               "blaze_endpoint_", "blaze_tenant_", "blaze_dict_cols",
               "blaze_shuffle_mmap", "blaze_query_progress",
               "blaze_monitor_ring_samples")


def _families(text):
    """{family: (type, [(labels, value)])} of an exposition."""
    fams, cur = {}, None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, cur, mtype = line.split(" ", 3)
            fams[cur] = (mtype, [])
        elif not line.startswith("#"):
            name_labels, value = line.rsplit(" ", 1)
            fams[cur][1].append((name_labels, value))
    return fams


def _shape(fams):
    return {name: mtype if name.startswith(BY_PRESENCE) else (mtype, samples)
            for name, (mtype, samples) in fams.items()}


def _exposition(mon, tr, c, batch, serde_mod):
    c.trace_enabled = True
    serde_mod.to_host(batch).serialize()
    tr.record_value("batch_rows", 64)
    return mon.prometheus_text()


def test_prometheus_text_matches_jax():
    tb, jb = _pair()
    text = _exposition(monitor, trace, conf, tb, serde)
    jtext = _exposition(jmonitor, jtrace, jconf, jb, jserde)
    for t in (text, jtext):
        assert t.endswith("\n")
        typed = set()
        for line in t.splitlines():
            assert line, "blank line in exposition"
            if line.startswith("# TYPE "):
                _, _, name, mtype = line.split(" ", 3)
                assert mtype in ("counter", "gauge", "histogram"), line
                assert name not in typed, f"duplicate TYPE for {name}"
                typed.add(name)
            elif not line.startswith("# HELP "):
                assert _SAMPLE.match(line), line
    # the fixed families are the scrape contract; the dynamic ones
    # (GAUGE_PREFIXES) mint a family a telemetry key, and which keys a
    # process holds depends on what it ran before
    fams, jfams = _families(text), _families(jtext)
    fixed = {n: f for n, f in fams.items()
             if not n.startswith(monitor.GAUGE_PREFIXES)}
    jfixed = {n: f for n, f in jfams.items()
              if not n.startswith(monitor.GAUGE_PREFIXES)}
    assert sorted(fixed) == sorted(jfixed)
    assert _shape(fixed) == _shape(jfixed)

    def helps(t):
        return [ln for ln in t.splitlines() if ln.startswith("# HELP ")
                and not ln.split(" ")[2].startswith(monitor.GAUGE_PREFIXES)]

    assert helps(text) == helps(jtext)
    assert (sorted(n for n in fams if n.startswith("blaze_compile_"))
            == sorted(n for n in jfams if n.startswith("blaze_compile_")))
    assert fams["blaze_hist_batch_rows"][0] == "histogram"
    assert jfams["blaze_hist_batch_rows"][0] == "histogram"
    assert monitor.GAUGE_NAMES == jmonitor.GAUGE_NAMES
    assert monitor.GAUGE_PREFIXES == jmonitor.GAUGE_PREFIXES
    # the registry is the scrape contract: every fixed family is emitted
    assert set(monitor.GAUGE_NAMES) <= set(fams)
    assert re.search(r'^blaze_bytes_copied_total\{boundary="ffi"\} [1-9]',
                     text, re.M)
    assert "blaze_hist_batch_rows_sum 64" in text
    assert "blaze_resource_leaks_total 0" in text
    # the port's compile series read its compile service's counters
    from blaze_tpu_torch.runtime import compile_service

    snap = compile_service.TELEMETRY.snapshot()
    assert {n: float(fams[n][1][0][1]) for n in fams
            if n.startswith("blaze_compile_")} == \
        {f"blaze_compile_{k}": float(v) for k, v in snap.items()}


def test_sampler_ring_matches_jax():
    rings = []
    for mon in (monitor, jmonitor):
        rm = mon.ResourceMonitor(capacity=8)
        for _ in range(20):
            rm.sample_now()
        ring = rm.ring()
        assert len(ring) == 8 and ring[-1]["ts"] >= ring[0]["ts"]
        assert rm.ring_since(ring[-1]["ts"]) == ring[-1:]
        rings.append(ring[-1])
    assert sorted(rings[0]) == sorted(rings[1])
    # the compile gauges read the port's compile service
    from blaze_tpu_torch.runtime import compile_service

    snap = compile_service.TELEMETRY.snapshot()
    assert (rings[0]["compile_cache_hits"], rings[0]["compile_cache_misses"],
            rings[0]["compile_ms"]) == (snap["cache_hits"],
                                        snap["cache_misses"],
                                        round(snap["compile_ns"] / 1e6))
    # the keys that read configuration or an idle service (the others
    # read the process: its memory manager, its resilience telemetry)
    for key in ("io_pool_width", "task_pool_width",
                "admission_queue_depth", "admission_parked",
                "admission_rejected"):
        assert rings[0][key] == rings[1][key], key


def test_sampler_thread_start_stop():
    rm = monitor.ResourceMonitor(capacity=64, sample_ms=5)
    rm.start()
    assert rm.start() is rm  # idempotent while alive
    deadline = time.monotonic() + 5.0
    while len(rm.ring()) < 3:
        assert time.monotonic() < deadline, "the sampler never sampled"
        time.sleep(0.01)
    rm.stop()
    n = len(rm.ring())
    time.sleep(0.05)
    assert len(rm.ring()) == n  # stopped: no further samples
    assert not any(t.name == "blz-monitor" and t.is_alive()
                   for t in threading.enumerate())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_metrics_servers_answer_like_jax(monkeypatch):
    """ensure_started() on conf.metrics_port serves /metrics, /healthz,
    /queries, /queries/<qid> and a 404 in both packages with the same
    statuses and content types; /healthz's snapshot has the same keys;
    shutdown() frees the port and stops the sampler."""
    answers = []
    for mon, c in ((monitor, conf), (jmonitor, jconf)):
        port = _free_port()
        monkeypatch.setattr(c, "metrics_port", port)
        srv = mon.ensure_started()
        try:
            assert srv.port == port and mon.ensure_started() is srv
            assert mon.sampler() is not None
            url = f"http://127.0.0.1:{port}"
            got = {r: _get(url + r) for r in ("/metrics", "/healthz",
                                              "/queries", "/queries/nope",
                                              "/nope")}
            assert b"blaze_bytes_copied_total" in got["/metrics"][2]
            health = json.loads(got["/healthz"][2])
            rows = {r: (st, ct) for r, (st, ct, _b) in got.items()}
            answers.append((rows, sorted(health), health["ok"],
                            health["sampler_alive"]))
            assert "blaze_endpoint_requests_total{route=\"metrics\"} 1" in (
                mon.prometheus_text())
        finally:
            mon.shutdown()
        assert mon.sampler() is None
        with socket.socket() as s:  # no listener holds the port
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
    assert answers[0] == answers[1]
    rows = answers[0][0]
    assert [rows[r][0] for r in ("/metrics", "/healthz", "/queries",
                                 "/queries/nope", "/nope")] == [
        200, 200, 200, 404, 404]
    assert answers[0][2:] == (True, True)
    monkeypatch.setattr(conf, "metrics_port", 0)
    assert monitor.ensure_started() is None


def test_health_snapshot_codes_match_jax():
    rows = []
    for mon in (monitor, jmonitor):
        snap = mon.health_snapshot()
        rows.append((sorted(snap), snap["ok"], snap["role"],
                     snap["autoscaler"], snap["executors_live"],
                     mon.serve_path("/healthz")[0],
                     mon.serve_path("/nope")[:2]))
    assert rows[0] == rows[1]
