"""The port's live progress (runtime/progress.py) against the JAX
package's, on the CPU.

The same event sequence (query and stage lifecycles, batch taps under
trace contexts, attempt states, resilience notes, streaming sessions),
under the same injected wall clock, gives equal summary rows, equal
per-stage waterfalls and equal finished rows in both packages, with and
without a history store behind the ETA. A port `run_plan` with
`progress_enabled` is read live from a second thread: its stages advance
and the query lands in `finished_queries`.
"""

import itertools
import threading
import types

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import history as jhistory
from blaze_tpu.runtime import progress as jprogress
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import history, progress, trace

PAIRS = ((progress, trace, history, conf),
         (jprogress, jtrace, jhistory, jconf))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "tenant_slo_spec",
                            {"t1": {"latency_ms": 5000}})
        monkeypatch.setattr(c, "trace_enabled", True)
    for m in (progress, jprogress, trace, jtrace, history, jhistory):
        m.reset()
    yield
    for m in (progress, jprogress, trace, jtrace, history, jhistory):
        m.reset()


class _Op:
    def name(self):
        return "FilterExec"


def _script(prog, tr, monkeypatch, step):
    """One scripted life of two queries and a stream; returns every
    snapshot taken along the way."""
    ticks = itertools.count(0)
    monkeypatch.setattr(prog, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0 + step * next(ticks)))
    snaps = []
    prog.begin_query("qA", tenant_id="t1")
    prog.begin_query("qB")
    prog.begin_query("")  # ignored
    prog.stage_begin("qA", 0, "shuffle_map", fingerprint="fp0", tasks=4)
    prog.stage_begin("qB", 0, "broadcast", fingerprint="fpX", tasks=1)
    op = _Op()
    with tr.context(query_id="qA", stage_id=0, task_id="m0"):
        for rows in (10, 20, 30):
            prog.on_batch(op, rows)
        ctx = tr.current_context()
        prog.attempt_update(ctx, 1, "running")
        prog.note_event("retry", "retryable")
        prog.attempt_update(ctx, 1, "failed")
        prog.attempt_update(ctx, 2, "running")
        prog.attempt_update(dict(ctx, task_id="m1"), 3, "running",
                            speculative=True)
        prog.note_event("ladder_rung", "halve_batch")
        prog.attempt_update(ctx, 2, "ok")
        prog.attempt_update(dict(ctx, task_id="m1"), 3,
                            "killed:speculation_lost", speculative=True)
    snaps.append(prog.snapshot_queries())
    snaps.append(prog.snapshot_query("qA"))
    prog.stage_end("qA", 0)
    prog.stage_begin("qA", 1, "result", fingerprint="fp1", tasks=2)
    with tr.context(query_id="qA"):  # no stage id: the current stage
        prog.on_batch(op, 5)
    snaps.append(prog.snapshot_query("qA"))
    prog.stage_end("qB", 0, error="boom")
    snaps.append(prog.snapshot_query("qB"))
    snaps.append(prog.render_queries())
    snaps.append(prog.render_query("qA"))
    snaps.append(prog.snapshot_query("nope"))
    prog.stage_end("qA", 1)
    prog.finish_query("qA")
    prog.finish_query("qB")
    prog.begin_stream("s1", tenant_id="t1")
    prog.stream_batch("s1", 1, 100, lag_ms=40.0, batch_ms=20.0)
    prog.stream_batch("s1", 2, 50, lag_ms=10.0, batch_ms=30.0,
                      resumed=True)
    prog.stream_lag("s1", 0.0)
    prog.stream_batch("qA", 3, 1, 1.0, 1.0)  # not live: ignored
    snaps.append(prog.snapshot_queries())
    snaps.append(prog.active())
    prog.finish_query("s1")
    snaps.append(prog.finished_queries())
    snaps.append([r["kind"] for r in tr.TRACE.snapshot()])
    return snaps


@pytest.mark.parametrize("step", [0.25, 1.5])
def test_snapshots_match_jax(monkeypatch, step):
    port = _script(progress, trace, monkeypatch, step)
    jax = _script(jprogress, jtrace, monkeypatch, step)
    assert port == jax
    qa = port[1]
    assert qa["stages"][0]["rows"] == 60 and qa["stages"][0]["retries"] == 1
    assert qa["stages"][0]["rungs"] == ["halve_batch"]
    assert qa["stages"][0]["speculations"] == 1
    assert [a["state"] for a in qa["stages"][0]["attempts"]] == [
        "failed", "ok", "killed:speculation_lost"]
    assert port[2]["stages"][1]["rows"] == 5
    assert port[3]["stages"][0]["state"] == "failed"
    fin = port[-2]
    assert [f["query_id"] for f in fin] == ["qA", "qB", "s1"]
    assert fin[0]["phase"] == "finished" and fin[2]["streaming"]
    assert port[-1] == ["progress_snapshot", "progress_snapshot"]


def test_eta_from_history_matches_jax(tmp_path, monkeypatch):
    """With a history store behind it, a stage's expected cost is its
    fingerprint's p50: the ETA and the weighted ratio follow it."""
    out = []
    for prog, tr, hist, c in PAIRS:
        d = tmp_path / hist.__name__
        monkeypatch.setattr(c, "history_dir", str(d))
        st = hist.HistoryStore(str(d))
        for ms in (100.0, 300.0, 200.0):
            st.append({"query_id": "h", "stages": [
                {"fingerprint": "fp0", "ms": ms, "kind": "shuffle_map"},
                {"fingerprint": "fp1", "ms": ms / 2, "kind": "result"}]})
        ticks = itertools.count(0)
        monkeypatch.setattr(prog, "time", types.SimpleNamespace(
            time=lambda: 100.0 + 0.05 * next(ticks)))
        prog.begin_query("qE")
        prog.stage_begin("qE", 0, "shuffle_map", fingerprint="fp0")
        snaps = [prog.snapshot_query("qE")]
        prog.stage_end("qE", 0)
        prog.stage_begin("qE", 1, "result", fingerprint="fp1")
        snaps.append(prog.snapshot_query("qE"))
        snaps.append(prog.snapshot_queries())
        out.append(snaps)
    assert out[0] == out[1]
    assert out[0][0]["stages"][0]["expected_ms"] == 200.0
    assert out[0][0]["eta_ms"] is not None
    assert 0 < out[0][1]["progress_ratio"] < 1


def test_live_progress_of_a_port_run(tmp_path, monkeypatch):
    """A second thread reads snapshot_query while the port's run_plan
    runs a two-stage query: the stages it sees advance, and after the
    run the query is in finished_queries with every stage done."""
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    monkeypatch.setattr(conf, "progress_enabled", True)
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    paths, frames = validator.generate_tables(str(tmp_path), rows=4000)
    plan, _ = validator.QUERIES["q3_join_agg_sort"](paths, frames, "smj")
    info = {"query_id": "qLive"}
    seen, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            snap = progress.snapshot_query("qLive")
            if snap is not None:
                seen.append((snap["stages_total"], snap["stages_done"]))
            stop.wait(0.001)

    t = threading.Thread(target=watch)
    t.start()
    try:
        run_plan(plan, num_partitions=4, work_dir=str(tmp_path / "w"),
                 run_info=info, device="cpu")
    finally:
        stop.set()
        t.join()
    assert seen and max(s[1] for s in seen) >= 1
    assert seen == sorted(seen)  # stages only advance
    fin = [f for f in progress.finished_queries()
           if f["query_id"] == "qLive"]
    assert len(fin) == 1 and fin[0]["phase"] == "finished"
    assert fin[0]["stages_done"] == fin[0]["stages_total"] >= 3
    assert fin[0]["rows"] > 0 and progress.active() == []
