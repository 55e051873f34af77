"""The port's history store (runtime/history.py) and operator fingerprints
(plan/fingerprint.fingerprint_operator) against the JAX package's, on the
CPU.

- Operator fingerprints: every operator of every stage of both
  catalogues (spark/tpcds.py and the validator's core queries, both join
  modes), decoded by each package from the same plan protobuf, has the
  same `plan_key()` repr and so the same fingerprint. No node's key holds
  a library object (a dtype, say) whose repr differs between the
  packages: the keys are kinds, names, enum values and tuples of them.
- The store: the same sequence of queries (operator and group taps, a
  traced query span with stages under injected clocks, run_info
  counters) recorded by each package gives byte-identical shards, with
  the same rotation, retention pruning and torn-tail heal.
- The feed and the detector: `StatisticsFeed` answers every fingerprint
  the same, and `detect_regressions` flags the same stages.
- The JAX package's `tools/history_report.py` reads the port's store and
  prints what it prints for its own.
"""

import importlib.util
import itertools
import json
import os
import types

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.plan import decode_plan as jdecode
from blaze_tpu.plan import fingerprint_operator as jfingerprint_operator
from blaze_tpu.plan import plan_pb2 as jpb
from blaze_tpu.runtime import history as jhistory
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.plan import decode_plan, fingerprint_operator
from blaze_tpu_torch.runtime import history, trace
from blaze_tpu_torch.spark import tpcds, validator
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.stages import plan_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ["store_sales", "store_returns", "date_dim", "store", "item",
          "customer", "customer_address", "customer_demographics",
          "promotion", "web_sales", "catalog_sales"]
PATHS = {t: f"/data/{t}.parquet" for t in TABLES}
PAIRS = ((trace, history, conf), (jtrace, jhistory, jconf))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "trace_enabled", True)
        monkeypatch.setattr(c, "doctor_enabled", True)
    saved = [(m, m.TRACE.clock, m.TRACE.wall) for m in (trace, jtrace)]
    for m in (trace, jtrace, history, jhistory):
        m.reset()
    yield
    for m, clock, wall in saved:
        m.TRACE.clock, m.TRACE.wall = clock, wall
    for m in (trace, jtrace, history, jhistory):
        m.reset()


# ---- operator fingerprints ----

def _ops(op):
    yield op
    for c in op.children:
        yield from _ops(c)


@pytest.mark.parametrize("suite,q", [("tpcds", q) for q in
                                     sorted(tpcds.QUERIES)]
                         + [("core", q) for q in validator.QUERIES])
def test_fingerprint_operator_matches_jax(suite, q):
    module = {"tpcds": tpcds, "core": validator}[suite]
    n = 0
    for mode in ("bhj", "smj"):
        plan, _ = module.QUERIES[q](PATHS, None, mode)
        apply_strategy(plan)
        for stage in plan_stages(plan, default_partitions=4, namespace=""):
            root = decode_plan(stage.plan)
            jroot = jdecode(jpb.PlanNode.FromString(
                stage.plan.SerializeToString()))
            ops, jops = list(_ops(root)), list(_ops(jroot))
            assert [o.name() for o in ops] == [o.name() for o in jops]
            for op, jop in zip(ops, jops):
                assert repr(op.plan_key()) == repr(jop.plan_key())
                assert fingerprint_operator(op) == \
                    jfingerprint_operator(jop)
                assert history.op_fingerprint(op) == \
                    jhistory.op_fingerprint(jop)
                n += 1
    assert n > 0


# ---- the store ----

class _Op:
    """A decoded-operator stand-in: a kind, children and plan_key()."""

    def __init__(self, kind, *children):
        self.kind, self.children = kind, list(children)

    def plan_key(self):
        return (self.kind,) + tuple(c.plan_key() for c in self.children)

    def name(self):
        return self.kind


def _tree():
    scan = _Op("ParquetScanExec")
    filt = _Op("FilterExec", scan)
    return [scan, filt, _Op("AggExec", filt)]


def _query(tr, hist, i, stage_ms, clock):
    """One query through package (tr, hist): the history taps, then a
    traced query span holding one stage span per entry of stage_ms."""
    qid = f"qH-{i}"
    hist.begin_query(qid)
    ops = _tree()
    with tr.context(query_id=qid):
        for b in range(3):
            for op in ops:
                hist.observe_rows(op, 100 * (b + 1) // (ops.index(op) + 1))
        hist.observe_groups(hist.op_fingerprint(ops[-1]), "AggExec",
                            40 + i, dense=True)
        hist.observe_groups(hist.op_fingerprint(ops[1]), "FilterExec",
                            None, dense=False)
        with tr.span("query", query_id=qid):
            for sid, ms in enumerate(stage_ms):
                clock.step = int(ms * 1e6)
                with tr.span("stage", stage_id=sid,
                             stage_kind=("result" if sid else "shuffle_map"),
                             fingerprint=f"fpS{sid}", tasks=2,
                             transport="file",
                             moved_bytes=1000 * (sid + 1),
                             copied_bytes=(500 if i < 7 else 400_000)):
                    pass
                clock.step = 1000
    info = {"query_id": qid, "rows": 7, "serde_encode_ms": 3.5,
            "nested": {"x": 1}, "flag": True}
    return hist.record_run(qid, info)


class _Clock:
    def __init__(self):
        self.now, self.step = 10 ** 9, 1000

    def __call__(self):
        self.now += self.step
        return self.now


def _script(tr, hist, d, monkeypatch):
    """Eight queries, the last two slower in stage 1, the last copying more;
    shards of 3 records, retention 5."""
    clock = _Clock()
    monkeypatch.setattr(tr.TRACE, "clock", clock)
    wall = itertools.count(10 ** 18, 11)
    monkeypatch.setattr(tr.TRACE, "wall", lambda: next(wall))
    fixed = itertools.count(1_700_000_000)
    monkeypatch.setattr(hist, "time",
                        types.SimpleNamespace(time=lambda: next(fixed)))
    st = hist.HistoryStore(str(d), retention=5, shard_runs=3)
    monkeypatch.setitem(hist._stores, str(d), st)
    recs = []
    for i in range(8):
        stage_ms = [20.0 + i, 30.0 if i < 6 else 900.0]
        recs.append(_query(tr, hist, i, stage_ms, clock))
    return st, recs


def _shards(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def test_store_bytes_rotation_and_pruning_match_jax(tmp_path, monkeypatch):
    out = []
    for tr, hist, c in PAIRS:
        d = tmp_path / hist.__name__
        monkeypatch.setattr(c, "history_dir", str(d))
        st, recs = _script(tr, hist, d, monkeypatch)
        out.append((_shards(d), recs, st.total_records()))
    (shards, recs, total), (jshards, jrecs, jtotal) = out
    assert shards == jshards
    assert recs == jrecs
    # 8 records in shards of 3: the first shard pruned, 5 retained
    assert sorted(shards) == ["history-000002.jsonl", "history-000003.jsonl"]
    assert total == jtotal == 5
    rec = recs[-1]
    assert rec["stages"][1]["ms"] == 900.0 and rec["critical_path"]
    assert {o["op"] for o in rec["ops"]} == {"ParquetScanExec",
                                              "FilterExec", "AggExec"}
    assert rec["groups"][0]["groups"] == 47 and not rec["groups"][1]["dense"]
    assert rec["counters"] == {"rows": 7, "serde_encode_ms": 3.5}


def test_torn_tail_heals_like_jax(tmp_path, monkeypatch):
    out = []
    for tr, hist, c in PAIRS:
        d = tmp_path / hist.__name__
        d.mkdir()
        st = hist.HistoryStore(str(d), retention=10, shard_runs=10)
        st.append({"query_id": "a", "n": 1})
        with open(d / "history-000001.jsonl", "ab") as f:
            f.write(b'{"query_id": "torn", "n"')  # a crash mid-write
        st.append({"query_id": "b", "n": 2})
        out.append((_shards(d), st.records()))
    assert out[0] == out[1]
    assert [r["query_id"] for r in out[0][1]] == ["a", "b"]


def test_statistics_feed_and_regressions_match_jax(tmp_path, monkeypatch):
    stores = []
    for tr, hist, c in PAIRS:
        d = tmp_path / hist.__name__
        monkeypatch.setattr(c, "history_dir", str(d))
        monkeypatch.setattr(c, "history_regression_pct", 25.0)
        st, _ = _script(tr, hist, d, monkeypatch)
        stores.append((hist, st))
    (hist, st), (jhist, jst) = stores
    feed, jfeed = hist.StatisticsFeed(st), jhist.StatisticsFeed(jst)
    fps = feed.fingerprints()
    assert fps == jfeed.fingerprints()
    assert fps["stages"] == ["fpS0", "fpS1"] and len(fps["ops"]) == 3
    for fp in fps["stages"]:
        assert feed.observed_stage_cost(fp) == jfeed.observed_stage_cost(fp)
    for fp in fps["ops"] + ["missing"]:
        assert (feed.observed_cardinality(fp)
                == jfeed.observed_cardinality(fp))
    agg = feed.observed_cardinality(fps["groups"][0])
    assert agg["n"] == 5
    found = hist.detect_regressions(st.records())
    assert found == jhist.detect_regressions(jst.records())
    assert {(f["fingerprint"], f["metric"]) for f in found} == {
        ("fpS1", "wall_ms"), ("fpS0", "copied_bytes"),
        ("fpS1", "copied_bytes")}


def test_history_report_reads_the_ports_store(tmp_path, monkeypatch,
                                              capsys):
    dirs = []
    for tr, hist, c in PAIRS:
        d = tmp_path / hist.__name__
        monkeypatch.setattr(c, "history_dir", str(d))
        _script(tr, hist, d, monkeypatch)
        dirs.append(str(d))
    spec = importlib.util.spec_from_file_location(
        "history_report", os.path.join(REPO, "tools", "history_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    texts = []
    for d in dirs:
        assert report.summarize(d) == 0
        texts.append(capsys.readouterr().out.replace(d, "<dir>"))
    assert texts[0] == texts[1]
    assert "5 runs, 2 shards" in texts[0] and "REGRESSIONS (3)" in texts[0]


def test_record_run_without_trace_or_store(tmp_path, monkeypatch):
    """Tracing off, the record still carries the taps and counters; with
    no history_dir, record_run and the taps are no-ops (as in the JAX
    package)."""
    for c in (conf, jconf):
        monkeypatch.setattr(c, "trace_enabled", False)
    out = []
    for tr, hist, c in PAIRS:
        monkeypatch.setattr(c, "history_dir", "")
        hist.begin_query("qn")
        assert hist._current_acc() is None
        assert hist.record_run("qn", {"a": 1}) is None
        d = tmp_path / hist.__name__
        monkeypatch.setattr(c, "history_dir", str(d))
        monkeypatch.setattr(hist, "time",
                            types.SimpleNamespace(time=lambda: 5.0))
        hist.begin_query("qm")
        op = _Op("FilterExec", _Op("ParquetScanExec"))
        hist.observe_rows(op, 9)
        rec = hist.record_run("qm", {"a": 1, "s": "x"})
        out.append(rec)
        assert json.loads((d / "history-000001.jsonl").read_text()) == rec
    assert out[0] == out[1]
    assert out[0]["stages"] == [] and out[0]["plan_fingerprint"] is None
    assert out[0]["ops"][0]["rows"] == 9 and out[0]["duration_ms"] == 0.0
