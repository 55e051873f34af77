"""The port's trace exporters (runtime/trace.py: explain_analyze,
build_run_record, export_run_ledger, rotate_export_dir, export_query) and
the observability hooks of `run_plan`, against the JAX package's, on the
CPU.

- Whole-stage events: a traced query with a dense stage (tpcds q02) and
  one whose aggregates fall back to the streaming path (tpcds q04) record
  the same whole_stage_attempt / whole_stage_groups / whole_stage_fallback
  events as the JAX package, with equal `op_kind`, `groups`, `dense` and
  `fingerprint`.
- Exporters: the same scripted records (injected clocks) give the same
  ledger line, EXPLAIN ANALYZE text, metric report, ledger file (a torn
  tail healed) and rotation.
- run_plan with trace export, history, progress, the flight recorder and
  the profiler all on, for queries of both catalogues: the same rows, and
  ledger lines and history records with the JAX package's keys, and the
  JAX package's values for the stages (identity, route, logical bytes:
  `_shape`), the operator and group taps, the plan fingerprint, the
  resilience events, the event count and the histogram counts. Set
  aside by name, and nothing else: timings (`TIMED`), what the sampling
  profiler saw (`profile`), each package's `compile_*` trace records in
  `events` (the compile_* counters are compared by key), and the
  run_info counters that
  only the port writes (`PORT_ONLY`, named in run_plan's docstring). The
  JAX package's `load_ledger`, `diagnose_dir` and
  `tools/history_report.py` read the port's files.
- Each of the five freed knobs alone gives the JAX package's rows.
"""

import importlib.util
import itertools
import json
import os

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import doctor as jdoctor
from blaze_tpu.runtime import flight_recorder as jflight
from blaze_tpu.runtime import history as jhistory
from blaze_tpu.runtime import profiler as jprofiler
from blaze_tpu.runtime import progress as jprogress
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu.runtime.metrics import MetricsSet as JMetricsSet
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import (
    doctor, flight_recorder, history, profiler, progress, trace,
)
from blaze_tpu_torch.runtime.metrics import MetricsSet
from test_torch_runner import _same_rows
from torch_parity import both_tables, no_jax_native, run_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = (trace, jtrace, history, jhistory, progress, jprogress,
           flight_recorder, jflight, profiler, jprofiler)

# run_info counters only the port writes (the FFI bridge and host
# crossings, the scan's bytes and time, the whole-stage routes, the
# mesh's pinned bytes, the pool workers' kernel launches): each is named
# in run_plan's docstring
PORT_ONLY = ("bridge_batches", "bridge_card_batches", "bridge_rows",
             "bridge_s", "bytes_scanned", "fallback_exports",
             "host_pulls", "hostfn_crossings", "hostfn_s", "io_time_ns",
             "kernel_launches", "mesh_pinned_bytes", "pool_engine_start_s",
             "pool_kernel_launches", "stage_compiled",
             "stage_fallbacks", "udf_crossings", "udf_s")
# timings: values of these keys hold a duration, a wall-clock stamp, or
# a quantity derived from them (the doctor's terms and longest chains,
# the histograms' sums and percentiles); they are compared by key only
TIMED = ("duration_ms", "wall_ns", "ts", "ms", "critical_path", "min",
         "max", "total", "p50", "p95", "p99")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "trace_enabled", True)
    no_jax_native(monkeypatch)
    saved = [(m, m.TRACE.clock, m.TRACE.wall) for m in (trace, jtrace)]
    for m in (profiler, jprofiler):
        m.stop()
    for m in MODULES:
        m.reset()
    yield
    for m, clock, wall in saved:
        m.TRACE.clock, m.TRACE.wall = clock, wall
    for m in (profiler, jprofiler):
        m.stop()
    for m in MODULES:
        m.reset()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=1 << 14)


# ---- the whole-stage events ----

def _whole_stage(tr, qid):
    return sorted((r["kind"], r["attrs"].get("op_kind"),
                   r["attrs"].get("groups"), r["attrs"].get("dense"),
                   r["attrs"].get("fingerprint"))
                  for r in tr.query_records(qid)
                  if r["kind"].startswith("whole_stage"))


@pytest.mark.parametrize("q,route", [("q02", "dense"), ("q04", "fallback")])
def test_whole_stage_events_match_jax(tables, tmp_path, q, route):
    (rows, info), (jrows, jinfo) = run_both(tables, tmp_path, "tpcds", q,
                                            "bhj")
    _same_rows(rows, jrows)
    ev = _whole_stage(trace, info["query_id"])
    assert ev == _whole_stage(jtrace, jinfo["query_id"])
    kinds = {e[0] for e in ev}
    assert "whole_stage_attempt" in kinds
    assert all(e[4] for e in ev)  # every event carries its fingerprint
    if route == "dense":
        assert any(e[0] == "whole_stage_groups" and e[3] and e[2] > 0
                   for e in ev)
    else:
        assert "whole_stage_fallback" in kinds


# ---- the exporters on scripted records ----

class _Op:
    def __init__(self, ms_cls, kind, vals, *children):
        self.kind, self.children = kind, list(children)
        self.metrics = ms_cls()
        for k, v in vals.items():
            self.metrics.add(k, v)

    def name(self):
        return self.kind


def _tree(ms_cls):
    scan = _Op(ms_cls, "ParquetScanExec", {"output_rows": 4000,
                                          "bytes_scanned": 3 << 20,
                                          "elapsed_compute_ns": 2_000_000})
    return _Op(ms_cls, "AggExec", {"output_rows": 40,
                                   "elapsed_compute_ns": 9_000_000,
                                   "spill_bytes": 1536}, scan)


def _script(tr):
    tick = itertools.count(10 ** 9, 5_000_000)
    tr.TRACE.clock = lambda: next(tick)
    wall = itertools.count(10 ** 18, 11)
    tr.TRACE.wall = lambda: next(wall)
    with tr.context(query_id="qE"):
        with tr.span("query", query_id="qE"):
            for sid, kind in ((0, "shuffle_map"), (1, "result")):
                with tr.context(stage_id=sid), \
                        tr.span("stage", stage_id=sid, stage_kind=kind,
                                fingerprint=f"fp{sid}", tasks=2,
                                transport="file", bytes=4096,
                                moved_bytes=2048, copied_bytes=512):
                    for t in range(2):
                        with tr.span("task_attempt", task_id=f"t{sid}{t}",
                                     attempt_id=t):
                            tr.event("batch", op="X", rows=10)
                    tr.event("retry", n=1, category="retryable")
                    tr.event("ladder_rung", rung=1, action="halve_batch")
                    tr.event("pipeline_stats", producer_busy_ms=10.0,
                             consumer_wait_ms=4.0)
    for v in (3, 70, 900):
        tr.record_value("batch_rows", v)


INFO = {"query_id": "qE", "rows": 40, "serde_encode_ms": 12.5,
        "file_stages": 1, "stage_s": [["result", 0.1]]}


def test_exporters_match_jax(tmp_path, monkeypatch):
    from blaze_tpu.runtime import compile_service
    from blaze_tpu.runtime import faults as jfaults
    from blaze_tpu_torch.runtime import faults

    # each compile service's summary line counts this process's own
    # compiles (XLA programs, the port's library builds): both set aside
    from blaze_tpu_torch.runtime import compile_service as port_cs

    for cs in (compile_service, port_cs):
        monkeypatch.setattr(cs, "telemetry_summary", lambda: "")
    # the resilience summary reads process-wide counters: the same fresh
    # counts in both packages
    for flt, ms_cls in ((faults, MetricsSet), (jfaults, JMetricsSet)):
        tel = ms_cls()
        tel.reset()
        tel.add("retries", 2)
        tel.add("errors.retryable", 2)
        monkeypatch.setattr(flt, "TELEMETRY", tel)
    outs = []
    for tr, ms_cls, c, sub in ((trace, MetricsSet, conf, "p"),
                               (jtrace, JMetricsSet, jconf, "j")):
        _script(tr)
        rec = tr.build_run_record("qE", dict(INFO))
        text = tr.explain_analyze(_tree(ms_cls), dict(INFO),
                                  tr.query_records("qE"))
        report = tr.metric_report(_tree(ms_cls))
        d = tmp_path / sub
        d.mkdir()
        (d / "ledger.jsonl").write_bytes(b'{"query_id": "old"}\n{"torn')
        tr.export_run_ledger(str(d / "ledger.jsonl"), rec)
        for i in range(4):
            (d / f"trace_q{i}.json").write_text("{}")
            os.utime(d / f"trace_q{i}.json", (1000 + i, 1000 + i))
        rot = tr.rotate_export_dir(str(d), keep=2)
        exp = tr.export_query("qE", dict(INFO), export_dir=str(d))
        files = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
        outs.append((rec, text, report, rot, exp, files))
    assert outs[0] == outs[1]
    rec, text, report, rot, exp, files = outs[0]
    assert rec["stages"][1] == {"stage_id": 1, "fingerprint": "fp1",
                                "kind": "result", "transport": "file",
                                "ms": 50.0, "tasks": 2, "bytes": 4096,
                                "moved_bytes": 2048, "copied_bytes": 512}
    assert rec["resilience_events"] == {"retry": 2, "ladder_rung": 2}
    assert "stage_s" not in rec["counters"]
    assert "-- critical path --" in text and "overlap=60%" in text
    assert "rung=halve_batch" in text and "1.5KiB" in report
    assert "resilience: retries=2" in report
    assert rot == {"ledger_trimmed": 1, "traces_pruned": 2}
    assert sorted(files) == ["ledger.jsonl", "trace_q2.json",
                             "trace_q3.json", "trace_qE.json"]
    lines = files["ledger.jsonl"].decode().splitlines()
    assert [json.loads(x)["query_id"] for x in lines if x.startswith(
        '{"schema')] == ["qE", "qE"]
    assert trace.human_bytes(5 << 30) == jtrace.human_bytes(5 << 30)
    assert trace.fmt_metric("a_ns", 2e6) == jtrace.fmt_metric("a_ns", 2e6)


# ---- run_plan with every observability knob on ----

def _knobs(monkeypatch, base):
    for c, tag in ((conf, "p"), (jconf, "j")):
        for knob, value in (("trace_export_dir", f"{base}/{tag}/trace"),
                            ("history_dir", f"{base}/{tag}/history"),
                            ("flight_dir", f"{base}/{tag}/flight"),
                            ("progress_enabled", True),
                            ("profile_enabled", True),
                            ("profile_sample_ms", 5),
                            ("profile_export_dir", f"{base}/{tag}/prof")):
            monkeypatch.setattr(c, knob, value)
    monkeypatch.setattr(conf, "spill_dir", f"{base}/spill")


def _keys(d, pre=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(pre + k)
            out |= _keys(v, pre + k + ".")
    elif isinstance(d, list):
        for x in d:
            out |= _keys(x, pre + "[].")
    return out


def _aside(keys, prefix):
    """Keys minus the named set-asides under `prefix` (the counters)."""
    named = {f"{prefix}{k}" for k in PORT_ONLY}
    return {k for k in keys if k not in named and not k.startswith(
        "profile")}


def _shape(stage):
    """A stage's identity, route and logical bytes. Its moved/copied
    bytes are compressed sizes: where a partial aggregate's groups leave
    in another order than the JAX package's the frames compress to other
    sizes while the raw bytes agree (the monitor's tests pin this), so
    they are held to keys only."""
    return {k: stage[k] for k in ("stage_id", "fingerprint", "kind",
                                  "transport", "tasks", "bytes")}


def _last_line(path):
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])


CELLS = [("tpcds", "q02", "bhj"), ("tpcds", "q04", "smj"),
         ("core", "q3_join_agg_sort", "smj"),
         ("core", "q2_q06_core_agg", "bhj")]


@pytest.mark.parametrize("suite,q,mode", CELLS)
def test_run_plan_with_all_knobs_matches_jax(tables, tmp_path, monkeypatch,
                                             capsys, suite, q, mode):
    base = str(tmp_path / "obs")
    _knobs(monkeypatch, base)
    (rows, info), (jrows, jinfo) = run_both(tables, tmp_path, suite, q,
                                            mode)
    _same_rows(rows, jrows)
    qid, jqid = info["query_id"], jinfo["query_id"]
    led = _last_line(f"{base}/p/trace/ledger.jsonl")
    jled = _last_line(f"{base}/j/trace/ledger.jsonl")
    hist = history.store(f"{base}/p/history").records()[-1]
    jhist = jhistory.store(f"{base}/j/history").records()[-1]
    assert led["query_id"] == hist["query_id"] == qid
    for a, b in ((led, jled), (hist, jhist)):
        assert _aside(_keys(a), "counters.") == _aside(_keys(b),
                                                       "counters.")
        assert [_shape(s) for s in a["stages"]] == \
            [_shape(s) for s in b["stages"]]
        assert set(a["critical_path"]["terms"]) == set(doctor.TERMS)
        assert abs(sum(a["critical_path"]["terms"].values())
                   - a["critical_path"]["total_ms"]) < 0.01
        # every other top-level value but the ids, the counters and the
        # keys compared below: schema_version, tenant_id and admission
        # fields, resilience events, drops; plan fingerprint, op and
        # group taps (the pool's tasks append groups in the order they
        # finish, in either package)
        for key in set(a) - set(TIMED) - {"query_id", "counters", "stages",
                                          "profile", "events",
                                          "histograms"}:
            if key == "groups":
                assert sorted(map(repr, a[key])) == sorted(map(repr, b[key]))
            else:
                assert a[key] == b[key], key
    # each package's compile service records its own builds and cache
    # events (XLA programs in the JAX package, libraries and per-plan
    # callables in the port): the other records are the same
    def compile_recs(tr, query_id):
        return sum(r["kind"].startswith("compile_")
                   for r in tr.query_records(query_id))

    assert led["events"] - compile_recs(trace, qid) == \
        jled["events"] - compile_recs(jtrace, jqid)
    assert {k: v["count"] for k, v in led["histograms"].items()} == \
        {k: v["count"] for k, v in jled["histograms"].items()}
    assert hist["ops"] and hist["plan_fingerprint"]
    # the trace, the profile (when the sampler saw the query) and no
    # dossier for a clean run
    assert os.path.exists(f"{base}/p/trace/trace_{qid}.json")
    prof = f"{base}/p/prof/profile_{qid}.collapsed"
    assert os.path.exists(prof) == ("profile" in led)
    assert not os.path.exists(f"{base}/p/flight")
    assert [f["query_id"] for f in progress.finished_queries()] == [qid]
    # the JAX package's readers on the port's files
    assert jdoctor.load_ledger(f"{base}/p/trace/ledger.jsonl") == [led]
    (diag,) = jdoctor.diagnose_dir(f"{base}/p/trace", f"{base}/p/history")
    assert diag == doctor.diagnose_dir(f"{base}/p/trace",
                                       f"{base}/p/history")[0]
    assert diag["query_id"] == qid
    assert jhistory.StatisticsFeed(jhistory.HistoryStore(
        f"{base}/p/history")).fingerprints() == \
        history.StatisticsFeed(history.store(
            f"{base}/p/history")).fingerprints()
    spec = importlib.util.spec_from_file_location(
        "history_report", os.path.join(REPO, "tools", "history_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    capsys.readouterr()
    assert report.summarize(f"{base}/p/history") == 0
    assert "(1 runs, 1 shards)" in capsys.readouterr().out


@pytest.mark.parametrize("knob", ["trace_export_dir", "history_dir",
                                  "progress_enabled", "flight_dir",
                                  "profile_enabled"])
def test_each_freed_knob_gives_the_jax_rows(tables, tmp_path, monkeypatch,
                                            knob):
    for c, tag in ((conf, "p"), (jconf, "j")):
        monkeypatch.setattr(c, knob, str(tmp_path / tag / knob)
                            if knob.endswith("_dir") else True)
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    (rows, info), (jrows, _) = run_both(tables, tmp_path, "core",
                                        "q3_join_agg_sort", "bhj")
    _same_rows(rows, jrows)
    if knob == "trace_export_dir":
        assert os.path.exists(tmp_path / "p" / knob /
                              f"trace_{info['query_id']}.json")
    if knob == "history_dir":
        assert history.store(str(tmp_path / "p" / knob)).total_records() \
            == 1
