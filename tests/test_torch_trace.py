"""The port's trace (runtime/trace.py) and histograms
(runtime/metrics.Histogram) against the JAX package's, on the CPU.

- Histograms: the same seeded values give the same buckets, snapshot,
  percentiles, summary and merge as the JAX package's Histogram.
- Records: the same calls of `span`, `event`, `context` and `record_value`
  under the same injected clocks give records equal to the JAX package's,
  field for field; the ring is bounded and counts what it drops; off, a
  span is the shared no-op and nothing is recorded.
- Export: the same records give the same Chrome trace JSON.
- A traced `run_plan`: both packages at their defaults with tracing on
  record the same spans for the same query (one "query" span, the same
  stages in order with their kinds, task counts and transports, and the
  same number of "task_attempt" spans), every record of the port's run
  carries its query id, and a task attempt's records carry the task id
  from the pool thread.
"""

import itertools
import json

import numpy as np
import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu.runtime.metrics import Histogram as JHistogram
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import trace
from blaze_tpu_torch.runtime.metrics import Histogram
from torch_parity import both_tables, no_jax_native


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "trace_enabled", True)
    no_jax_native(monkeypatch)
    saved = [(m, m.TRACE.clock, m.TRACE.wall) for m in (trace, jtrace)]
    for m in (trace, jtrace):
        m.reset()
    yield
    for m, clock, wall in saved:
        m.TRACE.clock, m.TRACE.wall = clock, wall
        m.reset()


# ---- histograms ----

def _values(seed):
    rng = np.random.default_rng(seed)
    return ([0, -5, 1, 2, 3, 2 ** 62] + [int(v) for v in
                                         rng.integers(0, 1 << 30, 500)]
            + [int(v) for v in rng.geometric(0.01, 300)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_jax(seed):
    h, jh = Histogram("lat"), JHistogram("lat")
    for v in _values(seed):
        h.record(v)
        jh.record(v)
    assert h.snapshot() == jh.snapshot()
    for p in (0, 1, 50, 90, 95, 99, 100):
        assert h.percentile(p) == jh.percentile(p)
    assert h.summary() == jh.summary()
    for v in (0, 1, 2, 3, 4, 1023, 1024, 2 ** 63):
        assert Histogram.bucket_index(v) == JHistogram.bucket_index(v)
    for i in (0, 1, 5, 63):
        assert (Histogram.bucket_upper_bound(i)
                == JHistogram.bucket_upper_bound(i))


def test_histogram_merge_matches_jax():
    a, b, ja, jb = (Histogram("m"), Histogram("m"), JHistogram("m"),
                    JHistogram("m"))
    for i, v in enumerate(_values(3)):
        (a if i % 2 else b).record(v)
        (ja if i % 2 else jb).record(v)
    assert a.merge(b).snapshot() == ja.merge(jb).snapshot()
    assert Histogram("e").percentile(50) is None
    assert Histogram("e").summary() == ""


# ---- records ----

def _script(m):
    """The same trace calls on package `m`, under counting clocks."""
    tick = itertools.count(1000, 7)
    m.TRACE.clock = lambda: next(tick)
    wall = itertools.count(10 ** 18, 11)
    m.TRACE.wall = lambda: next(wall)
    with m.context(query_id="qT", tenant_id=None):
        with m.span("stage", stage_id=3, stage_kind="shuffle_map") as sp:
            m.event("retry", task_id="map[3:1]", n=1, category="retryable")
            with m.span("task_attempt", task_id="map[3:1]", attempt_id=2,
                        partition=1):
                m.event("batch", op="FilterExec", rows=5)
            sp.set(transport="file", bytes=123)
        try:
            with m.span("query", query_id="qT"):
                raise ValueError("boom")
        except ValueError:
            pass
        m.event("degrade", what="halve_batch")
    for v in (1, 5, 900):
        m.record_value("batch_rows", v)
    return m.TRACE.snapshot(), m.histograms_snapshot()


def test_records_match_jax():
    recs, hists = _script(trace)
    jrecs, jhists = _script(jtrace)
    assert recs == jrecs
    assert hists == jhists
    kinds = [r["kind"] for r in recs]
    assert kinds == ["retry", "batch", "task_attempt", "stage", "query",
                     "degrade"]
    assert recs[1]["task_id"] == "map[3:1]" and recs[1]["stage_id"] == 3
    assert recs[4]["error"] == "ValueError: boom"
    assert recs[3]["attrs"] == {"stage_kind": "shuffle_map",
                                "transport": "file", "bytes": 123}


def test_ring_is_bounded():
    log = trace.TraceLog(capacity=3)
    for i in range(5):
        log.append({"i": i})
    assert [r["i"] for r in log.snapshot()] == [2, 3, 4]
    assert log.dropped == 2
    assert [r["i"] for r in log.drain()] == [2, 3, 4] and len(log) == 0


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(conf, "trace_enabled", False)
    with trace.span("stage", stage_id=1) as sp:
        sp.set(x=1)
        trace.event("retry")
    trace.record_value("batch_rows", 5)
    assert trace.TRACE.snapshot() == [] and trace.histograms_snapshot() == {}
    assert trace.span("stage") is trace._NULL_SPAN


def test_chrome_trace_matches_jax(tmp_path):
    recs, _ = _script(trace)
    doc = trace.export_chrome_trace(str(tmp_path / "p.json"), recs)
    jdoc = jtrace.export_chrome_trace(str(tmp_path / "j.json"), recs)
    assert doc["events"] == jdoc["events"] > 0
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert {e["ph"] for e in got["traceEvents"]} == {"M", "X", "i"}


def test_profiled_span_writes_a_torch_profile(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(conf, "profiler_dir", str(tmp_path / "prof"))
    with trace.profiled_span("q") as sp:
        torch.ones(8).sum()
    assert sp.attrs["profiler_dir"] == str(tmp_path / "prof")
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert [r["kind"] for r in trace.TRACE.snapshot()] == ["profile"]


# ---- a traced run_plan ----

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=2000)


def _spans(recs):
    stages = [(r["stage_id"], r["attrs"].get("stage_kind"),
               r["attrs"].get("tasks"), r["attrs"].get("transport"))
              for r in recs if r["kind"] == "stage"]
    return {"query": sum(r["kind"] == "query" for r in recs),
            "stages": stages,
            "attempts": sum(r["kind"] == "task_attempt" for r in recs)}


@pytest.mark.parametrize("suite,q,mode", [("tpcds", "q02", "smj"),
                                          ("core", "q3_join_agg_sort",
                                           "bhj")])
def test_traced_run_plan_spans_match_jax(tables, tmp_path, suite, q, mode):
    from torch_parity import run_both

    (_, info), (_, jinfo) = run_both(tables, tmp_path, suite, q, mode)
    recs = trace.query_records(info["query_id"])
    jrecs = jtrace.query_records(jinfo["query_id"])
    assert _spans(recs) == _spans(jrecs)
    assert _spans(recs)["query"] == 1 and _spans(recs)["attempts"] > 1
    assert len(recs) == len(trace.TRACE.snapshot())  # all correlated
    pooled = [r for r in recs if r["kind"] == "task_attempt"
              and r["thread"].startswith("blz-task")]
    assert pooled and all("task_id" in r for r in pooled)
    assert trace.histograms_snapshot()["task_latency_us"]["count"] == \
        jtrace.histograms_snapshot()["task_latency_us"]["count"]
