"""The port's sampling profiler (runtime/profiler.py) against the JAX
package's, on the CPU.

- Folding and attribution: the same frames dict (stand-in frames over
  real code objects) and the same `trace._live_ctx` attribution give the
  same table rows, collapsed-stack lines, speedscope document, hot
  frames, incident window and run-record summary.
- Federation: rows drained from one package's table merge into the
  other's as they merge into its own.
- Export: `export_query` writes the same collapsed and speedscope files.
- Live: with conf.profile_enabled the port's sampler thread attributes
  samples of a thread inside `trace.context(query_id=...)` to that query
  (stage and task ids too); off, no thread starts and no context is
  mirrored.
"""

import itertools
import threading
import time
import types

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import profiler as jprofiler
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import profiler, trace

PAIRS = ((profiler, trace, conf), (jprofiler, jtrace, jconf))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for c in (conf, jconf):
        monkeypatch.setattr(c, "profile_enabled", True)
        monkeypatch.setattr(c, "profile_max_frames", 64)
        monkeypatch.setattr(c, "trace_enabled", True)
    for m in (profiler, jprofiler):
        m.stop()  # a sampler another test started would fold into the table
    for m in (profiler, jprofiler, trace, jtrace):
        m.reset()
    yield
    for m in (profiler, jprofiler):
        m.stop()
        m.reset()
    for m in (trace, jtrace):
        m.reset()
        m._live_ctx.clear()


def scan_parquet():
    pass


def decode_frame():
    pass


def run_task():
    pass


def driver_loop():
    pass


def _frame(*funcs):
    """A stand-in frame chain, leaf first in `funcs`."""
    f = None
    for fn in reversed(funcs):
        f = types.SimpleNamespace(f_code=fn.__code__, f_back=f)
    return f


FRAMES = {
    101: _frame(scan_parquet, run_task, driver_loop),
    102: _frame(decode_frame, run_task, driver_loop),
    103: _frame(scan_parquet, run_task, driver_loop),
    104: _frame(driver_loop),
    105: _frame(decode_frame, decode_frame, run_task),
}
CTX = {
    101: {"query_id": "qP", "stage_id": 0, "task_id": "m0"},
    102: {"query_id": "qP", "stage_id": 1, "task_id": "r0",
          "tenant_id": "t1"},
    103: {"query_id": "qQ", "stage_id": 0},
    105: {"query_id": "qP", "stage_id": 1, "task_id": "r1"},
}


def _sample(prof, tr, monkeypatch, passes, max_frames=64):
    ticks = itertools.count(0)
    monkeypatch.setattr(prof, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0 + 0.025 * next(ticks),
        perf_counter=time.perf_counter))
    monkeypatch.setattr(tr, "_live_ctx", dict(CTX, dead=CTX[101]))
    monkeypatch.setattr(
        {profiler: conf, jprofiler: jconf}[prof], "profile_max_frames",
        max_frames)
    n = [prof.sample_once(dict(FRAMES)) for _ in range(passes)]
    assert "dead" not in tr._live_ctx  # pruned: no such thread
    return {"n": n, "rows": prof.rows(), "all": prof.collapsed(),
            "qP": prof.collapsed("qP"), "scope": prof.speedscope("qP"),
            "hot": prof.hot_frames("qP"), "hot_all": prof.hot_frames(None),
            "window": prof.window("qP"),
            "summary": prof.profile_summary("qP"),
            "none": (prof.window("zz"), prof.profile_summary("zz")),
            "stats": {k: v for k, v in prof.stats().items()
                      if not k.startswith(("duty", "fleet"))}}


@pytest.mark.parametrize("passes,max_frames", [(1, 64), (3, 64), (4, 2)])
def test_sample_fold_and_views_match_jax(monkeypatch, passes, max_frames):
    port = _sample(profiler, trace, monkeypatch, passes, max_frames)
    jax = _sample(jprofiler, jtrace, monkeypatch, passes, max_frames)
    assert port == jax
    assert port["n"] == [5] * passes
    if max_frames == 64:
        assert ("query:qP;stage:1;test_torch_profiler.run_task;"
                "test_torch_profiler.decode_frame;"
                f"test_torch_profiler.decode_frame {passes}") in port["qP"]
        assert port["hot"][0] == {"frame": "test_torch_profiler.decode_frame",
                                  "samples": 2 * passes, "pct": 66.7}
    assert port["window"]["samples"] == 3 * passes
    assert port["summary"]["samples"] == 3 * passes


def test_drain_and_merge_match_jax(monkeypatch):
    _sample(profiler, trace, monkeypatch, 2)
    _sample(jprofiler, jtrace, monkeypatch, 2)
    rows, jrows = profiler.drain_remote(), jprofiler.drain_remote()
    assert rows == jrows and profiler.rows() == []
    assert profiler.merge_remote(rows + [["bad"]], exec_id="e1",
                                 recovered=True) == \
        jprofiler.merge_remote(jrows + [["bad"]], exec_id="e1",
                               recovered=True) == 10
    assert profiler.rows() == jprofiler.rows()
    assert profiler.collapsed("qP") == jprofiler.collapsed("qP")
    assert all(";exec:e1;" in line for line in profiler.collapsed("qP"))
    profiler.merge_duty({"cost_s": 0.5, "wall_s": 10.0})
    jprofiler.merge_duty({"cost_s": 0.5, "wall_s": 10.0})
    profiler.merge_duty("torn")

    def counts(st):  # the duty of the drains is each process's own time
        return {k: v for k, v in st.items()
                if k not in ("duty_pct", "duty_cost_s", "fleet_duty_pct")}

    assert counts(profiler.stats()) == counts(jprofiler.stats())
    assert profiler.stats()["recovered_samples"] == 10
    assert [r["kind"] for r in trace.TRACE.snapshot()] == ["profile_merge"]


def test_export_query_matches_jax(tmp_path, monkeypatch):
    docs = []
    for prof, tr, c in PAIRS:
        _sample(prof, tr, monkeypatch, 2)
        d = tmp_path / prof.__name__
        monkeypatch.setattr(c, "profile_export_dir", str(d))
        paths = prof.export_query("qP")
        assert prof.export_query("zz") is None  # nothing sampled
        docs.append({k: open(p).read() for k, p in paths.items()})
        assert sorted(p.name for p in d.iterdir()) == [
            "profile_qP.collapsed", "profile_qP.speedscope.json"]
    assert docs[0] == docs[1]
    assert docs[0]["collapsed"].count("\n") == 3
    assert profiler.stacks_to_speedscope([("a;b", 2)]) == \
        jprofiler.stacks_to_speedscope([("a;b", 2)])


def test_live_sampler_attributes_a_context_thread(monkeypatch):
    monkeypatch.setattr(conf, "profile_sample_ms", 2)
    stop = threading.Event()

    def busy():
        with trace.context(query_id="qLive", stage_id=3, task_id="t9"):
            while not stop.is_set():
                sum(range(2000))

    t = threading.Thread(target=busy, name="blz-task-test")
    t.start()
    try:
        assert profiler.ensure_started() is not None
        assert profiler.running()
        deadline = time.monotonic() + 20
        while not profiler.rows("qLive") and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        t.join()
        profiler.stop()
    rows = profiler.rows("qLive")
    assert rows and all(r[2] == "3" and r[3] == "t9" for r in rows)
    assert any("busy" in r[5] for r in rows)
    st = profiler.stats()
    assert st["samples"] > 0 and not st["running"]
    assert t.ident not in trace._live_ctx  # popped with the context


def test_disabled_profiler_starts_nothing(monkeypatch):
    monkeypatch.setattr(conf, "profile_enabled", False)
    assert profiler.ensure_started() is None and not profiler.running()
    with trace.context(query_id="qOff"):
        assert trace._live_ctx == {}
