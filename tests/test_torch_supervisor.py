"""The port's task supervisor (runtime/supervisor.py) and its resilience
ladder through `run_plan`, against the JAX package's, on the CPU.

- Units, as in tests/test_supervisor.py: the first-commit-wins gate (one
  published pair, the loser's temps swept, a failed publish releases the
  gate), results in spec order under a pool of four with real overlap,
  a sibling's error kills the rest, the watchdog relaunches a hung
  attempt, a task deadline raises DeadlineError (also for an attempt that
  never cooperates), the breaker trips at its threshold and reroutes, a
  speculative twin beats a straggler and publishes the one pair, and the
  supervisor off runs inline.
- End to end: the same fault spec installed in both packages gives the
  same rows and the same run_info resilience counters (`retries`,
  `degradations`, `degraded.<rung>`, `ladder_rung`, `errors.<category>`,
  `breaker_trips`, `task_fallbacks`, `faults_injected`) on three queries
  of the catalogues; both packages run at their defaults (a spec without
  {"concurrent": true} serializes either pool to one worker). A stall
  under `hang_detect_ms` is killed and relaunched, a query deadline ends
  in DeadlineError, and a stalled straggler loses to its twin with one
  pair published for that task.
"""

import os
import threading
import time

import pytest

from blaze_tpu.runtime import faults as jfaults
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops.base import SpeculationLostError
from blaze_tpu_torch.runtime import artifacts, faults
from blaze_tpu_torch.runtime import supervisor as sup_mod
from blaze_tpu_torch.runtime.supervisor import (
    CircuitBreaker, CommitGate, Supervisor, TaskSpec,
)
from torch_parity import both_tables, no_jax_native, resilience, run_both

KNOBS = ("enable_supervisor", "max_concurrent_tasks", "task_deadline_ms",
         "query_deadline_ms", "hang_detect_ms", "speculation_multiplier",
         "breaker_failure_threshold", "max_task_retries", "retry_backoff_ms")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    from blaze_tpu.config import conf as jconf

    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    monkeypatch.setattr(jconf, "spill_dir", str(tmp_path / "jspill"))
    no_jax_native(monkeypatch)
    saved = {k: getattr(conf, k) for k in KNOBS}
    yield
    for k, v in saved.items():
        setattr(conf, k, v)
    for f in (faults, jfaults):
        f.install(None)
        f.reset_telemetry()


# ---- the commit gate ----

def _writer(payload):
    def w(dp, ip):
        open(dp, "wb").write(payload)
        open(ip, "wb").write(b"i")
        return [len(payload)]
    return w


def test_commit_gate_first_claim_wins(tmp_path, monkeypatch):
    monkeypatch.setattr(conf, "artifact_checksums", False)
    g = CommitGate()
    assert g.claim() and not g.claim()
    g.abort()
    assert g.claim()
    data, index = str(tmp_path / "s.data"), str(tmp_path / "s.index")
    gate = CommitGate()
    assert artifacts.commit_shuffle_pair(_writer(b"winner"), data, index,
                                         gate=gate) == [6]
    with pytest.raises(SpeculationLostError):
        artifacts.commit_shuffle_pair(_writer(b"loser!"), data, index,
                                      gate=gate)
    assert open(data, "rb").read() == b"winner"
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith("s.")) == ["s.data", "s.index"]


def test_failed_publish_releases_the_gate(tmp_path, monkeypatch):
    monkeypatch.setattr(conf, "artifact_checksums", False)
    gate = CommitGate()
    with pytest.raises(OSError):
        artifacts.commit_shuffle_pair(
            _writer(b"x"), str(tmp_path / "d" / "s.data"),
            str(tmp_path / "d" / "s.index"), gate=gate)
    assert gate.claim()


# ---- the pool ----

def test_pool_serialized_while_a_nonconcurrent_spec_is_armed():
    conf.max_concurrent_tasks = 4
    faults.install({"points": {"op": {"nth": 10 ** 9}}})
    assert Supervisor()._pool_width() == 1
    faults.install({"concurrent": True, "points": {"op": {"nth": 10 ** 9}}})
    assert Supervisor()._pool_width() == 4


def test_results_in_order_under_a_pool_of_four():
    conf.max_concurrent_tasks = 4
    sup = Supervisor(device="cpu")
    peak, live, lock = [0], [0], threading.Lock()
    devices = []

    def attempt(ctx):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            devices.append(ctx.device)
        time.sleep(0.05)
        with lock:
            live[0] -= 1
        return ctx.partition * 10

    try:
        specs = [TaskSpec(what=f"t{i}", attempt_fn=attempt, partition=i,
                          num_partitions=8) for i in range(8)]
        assert sup.run_tasks("s", specs) == [i * 10 for i in range(8)]
    finally:
        sup.close()
    assert peak[0] > 1 and set(devices) == {"cpu"}


def test_first_error_kills_siblings():
    conf.max_concurrent_tasks = 4
    sup = Supervisor()
    killed = threading.Event()

    def bad(ctx):
        time.sleep(0.02)
        raise ValueError("boom")

    def slow(ctx):
        for _ in range(200):
            if not ctx.is_running():
                killed.set()
                ctx.check_running()
            time.sleep(0.01)
        return "finished"

    try:
        with pytest.raises(ValueError):
            sup.run_tasks("s", [TaskSpec(what="bad", attempt_fn=bad),
                                TaskSpec(what="slow", attempt_fn=slow)])
    finally:
        sup.close()
    assert killed.wait(2.0)


def test_watchdog_relaunches_a_hung_attempt():
    conf.hang_detect_ms = 120
    sup = Supervisor(run_info := {})
    calls = []

    def attempt(ctx):
        calls.append(1)
        if len(calls) == 1:
            ev = sup_mod.current_kill_event()
            if ev.wait(10.0):
                ctx.check_running()
            pytest.fail("the watchdog never killed the attempt")
        return "ok"

    t0 = time.monotonic()
    try:
        assert sup.run_tasks("s", [TaskSpec(what="t",
                                            attempt_fn=attempt)]) == ["ok"]
    finally:
        sup.close()
    assert run_info["hangs_detected"] == 1 and run_info["retries"] == 1
    assert time.monotonic() - t0 < 2.0


@pytest.mark.parametrize("cooperates", [True, False])
def test_task_deadline_raises(cooperates):
    conf.task_deadline_ms = 150
    sup = Supervisor()
    release = threading.Event()

    def attempt(ctx):
        for _ in range(500):
            if cooperates:
                ctx.check_running()
            elif release.wait(0.01):
                break
            time.sleep(0.01)
        return "late"

    t0 = time.monotonic()
    try:
        with pytest.raises(faults.DeadlineError):
            sup.run_tasks("s", [TaskSpec(what="t", attempt_fn=attempt)])
    finally:
        release.set()
        sup.close()
    assert time.monotonic() - t0 < sup._ABANDON_GRACE + 2.0


def test_breaker_trips_and_reroutes():
    conf.breaker_failure_threshold = 2
    br = CircuitBreaker(info := {})

    def err(point):
        e = faults.RetryableError("x")
        e.point = point
        return e

    br.note_failure(err("op.FooExec"), "retryable")
    assert br.tripped() == frozenset()
    br.note_failure(err("op.FooExec"), "retryable")
    assert br.tripped() == frozenset({"FooExec"})
    assert br.should_reroute(frozenset({"FooExec", "SortExec"}))
    br.note_failure(err("spill.write"), "retryable")  # unattributable
    assert info["breaker_trips"] == 1
    conf.max_task_retries = 3
    conf.retry_backoff_ms = 0
    sup = Supervisor(run_info := {})

    def attempt(ctx):
        raise err("op.FooExec")

    try:
        assert sup.run_tasks("s", [TaskSpec(
            what="t", attempt_fn=attempt, fallback_fn=lambda: "fb",
            op_kinds=frozenset({"FooExec"}))]) == ["fb"]
    finally:
        sup.close()
    assert run_info["breaker_trips"] == 1
    assert run_info["breaker_reroutes"] >= 1


def test_speculative_twin_publishes_the_one_pair(tmp_path, monkeypatch):
    monkeypatch.setattr(conf, "artifact_checksums", False)
    conf.speculation_multiplier = 2.0
    conf.max_concurrent_tasks = 2
    sup = Supervisor(run_info := {})
    sup._record_duration("s", 0.02)
    sup._record_duration("s", 0.02)
    data, index = str(tmp_path / "t.data"), str(tmp_path / "t.index")
    attempts = []

    def attempt(ctx):
        attempts.append(ctx)
        if len(attempts) == 1:
            for _ in range(2000):
                ctx.check_running()
                time.sleep(0.005)
            pytest.fail("the primary was never killed")
        artifacts.commit_shuffle_pair(_writer(b"twin"), data, index,
                                      gate=ctx.commit_gate)
        return "twin"

    try:
        assert sup.run_tasks("s", [TaskSpec(what="t",
                                            attempt_fn=attempt)]) == ["twin"]
    finally:
        sup.close()
    assert run_info["speculations_launched"] == 1
    assert run_info["speculations_won"] == 1
    assert open(data, "rb").read() == b"twin"
    assert artifacts.find_orphans([str(tmp_path)]) == []


def test_disabled_runs_inline():
    conf.enable_supervisor = False
    sup = Supervisor()
    main = threading.current_thread()
    seen = []

    def attempt(ctx):
        seen.append(threading.current_thread())
        return ctx.partition

    try:
        assert sup.run_tasks("s", [
            TaskSpec(what="a", attempt_fn=attempt, partition=0),
            TaskSpec(what="b", attempt_fn=attempt, partition=1)]) == [0, 1]
    finally:
        sup.close()
    assert seen == [main, main] and sup._pool is None


# ---- end to end, against the JAX package ----

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return both_tables(tmp_path_factory, rows=3000)


QUERIES = [("core", "q2_q06_core_agg", "bhj"),
           ("core", "q3_join_agg_sort", "smj"),
           ("tpcds", "q02", "smj")]
SPECS = {
    "encode": {"seed": 7, "points": {"serde.encode": {"kind": "io",
                                                      "nth": 2}}},
    "scan_oom": {"seed": 8, "points": {"op.ParquetScanExec": {
        "kind": "oom", "fail_times": 10 ** 9}}},
    "commit": {"seed": 10, "points": {"shuffle.commit": {"kind": "io",
                                                         "nth": 1}}},
}


def _same_rows(got, want):
    from test_torch_runner import _same_rows as same

    same(got, want)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("suite,q,mode", QUERIES)
def test_ladder_counters_and_rows_match_jax(tables, tmp_path, suite, q,
                                            mode, spec):
    (rows, info), (jrows, jinfo) = run_both(tables, tmp_path, suite, q,
                                            mode, SPECS[spec])
    _same_rows(rows, jrows)
    assert resilience(info) == resilience(jinfo)
    assert info["faults_injected"] >= 1
    assert info["pipeline_live_streams"] == 0


def test_scan_oom_walks_the_ladder_to_the_row_interpreter(tables,
                                                          tmp_path):
    (rows, info), (jrows, _) = run_both(tables, tmp_path, "core",
                                        "q2_q06_core_agg", "bhj",
                                        SPECS["scan_oom"])
    _same_rows(rows, jrows)
    assert info["ladder_rung"] == 3
    for rung in ("halve_batch", "force_spill", "fallback"):
        assert info[f"degraded.{rung}"] >= 1, rung
    assert info["task_fallbacks"] >= 1


def test_result_task_fallback_counts_its_export(tables, tmp_path):
    """An oom at every shuffle read ends the result stage's tasks on the
    row interpreter (rung 3, then the breaker's reroutes); each such task
    counts as an export in run_info's fallback_exports, as the bridge's
    exports do. Rows and counters equal the JAX package's. (Both
    interpreters average a group of all-null prices to 0.0 where the
    validator's oracle has null: ROADMAP, Queue 3.)"""
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    spec = {"seed": 9, "points": {"op.IpcReaderExec": {
        "kind": "oom", "fail_times": 10 ** 9}}}
    (paths, frames), (jpaths, jframes) = tables["core"]
    runs = []
    for mod, run, flt, p, f, extra in (
            (validator, run_plan, faults, paths, frames, {"device": "cpu"}),
            (jvalidator, jrun_plan, jfaults, jpaths, jframes,
             {"mesh_exchange": "off"})):
        info = {}
        flt.install(spec)
        try:
            out = run(mod.QUERIES["q2_q06_core_agg"](p, f, "bhj")[0],
                      num_partitions=4, work_dir=str(tmp_path / mod.__name__),
                      run_info=info, **extra)
        finally:
            flt.install(None)
        runs.append((out.to_numpy(), info))
    (rows, info), (jrows, jinfo) = runs
    _same_rows(rows, jrows)
    assert resilience(info) == resilience(jinfo)
    assert info["ladder_rung"] == 3 and info["task_fallbacks"] >= 1
    assert info["fallback_exports"] == (info["task_fallbacks"]
                                        + info.get("breaker_reroutes", 0))


def test_stall_is_killed_and_relaunched(tables, tmp_path):
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    (paths, frames), _ = tables["core"]
    plan, oracle = validator.QUERIES["q2_q06_core_agg"](paths, frames, "bhj")
    conf.hang_detect_ms = 1000
    faults.install({"seed": 21, "points": {"op": {"kind": "stall", "nth": 3,
                                                  "ms": 30_000}}})
    info = {}
    t0 = time.monotonic()
    out = run_plan(plan, num_partitions=4, work_dir=str(tmp_path),
                   run_info=info, device="cpu")
    assert validator._compare(validator._to_pandas(out).reset_index(
        drop=True), oracle().reset_index(drop=True)) is None
    assert info["hangs_detected"] >= 1 and info["retries"] >= 1
    assert info["stalls_injected"] >= 1
    assert time.monotonic() - t0 < 10.0


def test_query_deadline_ends_in_deadline_error(tables, tmp_path):
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    (paths, frames), _ = tables["core"]
    plan, _ = validator.QUERIES["q1_scan_filter_project"](paths, frames,
                                                          "bhj")
    faults.install({"seed": 23, "points": {"op": {"kind": "stall",
                                                  "nth": 1, "ms": 30_000}}})
    conf.query_deadline_ms = 800
    t0 = time.monotonic()
    with pytest.raises(faults.DeadlineError):
        run_plan(plan, num_partitions=4, work_dir=str(tmp_path),
                 run_info={}, device="cpu")
    assert time.monotonic() - t0 < 10.0


def test_straggler_loses_to_its_twin(tables, tmp_path):
    """A map task stalls past speculation_multiplier x the stage's median:
    its twin wins, and the stage's work dir holds exactly one committed
    pair a task (the file route: the mesh exchange runs no supervised map
    task)."""
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan
    from blaze_tpu_torch.spark.shuffle_manager import BlazeShuffleManager

    (paths, frames), _ = tables["core"]
    conf.speculation_multiplier = 3.0
    conf.max_concurrent_tasks = 4
    pairs = []
    real = BlazeShuffleManager._register_map_output

    def register(self, shuffle_id, status):
        pairs.append((shuffle_id, status.map_id,
                      sorted(f for f in os.listdir(self.work_dir)
                             if f.startswith(f"shuffle_{shuffle_id}_"
                                             f"{status.map_id}."))))
        return real(self, shuffle_id, status)

    BlazeShuffleManager._register_map_output = register
    faults.install({"seed": 22, "concurrent": True,
                    "points": {"op": {"kind": "stall", "nth": 6,
                                      "ms": 15_000}}})
    info = {}
    t0 = time.monotonic()
    try:
        plan, oracle = validator.QUERIES["q3_join_agg_sort"](paths, frames,
                                                             "smj")
        out = run_plan(plan, num_partitions=4, work_dir=str(tmp_path),
                       mesh_exchange="off", run_info=info, device="cpu")
    finally:
        BlazeShuffleManager._register_map_output = real
        faults.install(None)
    assert validator._compare(validator._to_pandas(out).reset_index(
        drop=True), oracle().reset_index(drop=True)) is None
    assert info["speculations_launched"] >= 1
    assert info["speculations_won"] >= 1
    assert time.monotonic() - t0 < 12.0
    for sid, mid, names in pairs:
        assert names == [f"shuffle_{sid}_{mid}.data",
                         f"shuffle_{sid}_{mid}.index"], names
    assert artifacts.find_orphans([str(tmp_path)]) == []


def test_counters_exact_under_many_threads():
    """The process-wide counters that pool and I/O threads share lose no
    update: 16 threads (more than this machine's cores), a switch
    interval of a microsecond, and the totals exact."""
    import sys

    import torch

    from blaze_tpu_torch.runtime import metrics
    from blaze_tpu_torch.runtime.metrics import MetricsSet

    ms = MetricsSet()
    before = (metrics.HOST_PULLS, metrics.SERDE_BYTES["raw"],
              metrics.HOST_EVAL["udf"][0])
    t = torch.zeros(1)
    n, per = 16, 2000

    def work():
        for _ in range(per):
            metrics.to_host(t)
            metrics.bump(metrics.SERDE_BYTES, "raw", 3)
            metrics.note_host_eval("udf", 1)
            ms.add("x", 1)
            ms.set_max("m", 5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert metrics.HOST_PULLS - before[0] == n * per
    assert metrics.SERDE_BYTES["raw"] - before[1] == 3 * n * per
    assert metrics.HOST_EVAL["udf"][0] - before[2] == n * per
    assert ms["x"] == n * per and ms["m"] == 5


# ---- durability: a corrupt map output is quarantined and repaired ----

@pytest.mark.parametrize("suite,q,mode", QUERIES)
def test_corrupt_map_output_is_repaired_like_jax(tables, tmp_path, suite, q,
                                                 mode):
    """A byte of the first committed `.data` file flipped after publish:
    the reader's checksum catches it, the pair is quarantined and only
    its map task runs again (one more `map_tasks_run`), in both packages,
    with the same rows."""
    spec = {"seed": 13, "points": {"corrupt.shuffle_data": {
        "kind": "corrupt", "nth": 1}}}
    (rows, info), (jrows, jinfo) = run_both(tables, tmp_path, suite, q,
                                            mode, spec)
    _same_rows(rows, jrows)
    assert resilience(info) == resilience(jinfo)
    assert info["faults_injected"] == 1
    assert info["map_tasks_run"] == jinfo["map_tasks_run"]
    (clean, _), _ = run_both(tables, tmp_path / "clean", suite, q, mode)
    _same_rows(rows, clean)


def test_a_work_dir_reused_after_a_repair(tables, tmp_path):
    """After a repaired query, the next query in the same work dir writes
    the repaired slot's first name again. The port forgets the slot's
    redirect with its shuffle (shuffle_manager.unregister_shuffle), so the
    second query reads its own output. The JAX package keeps the redirect
    and reads the quarantined lineage's name, which is gone
    (FileNotFoundError; ROADMAP Queue 3)."""
    from blaze_tpu.runtime import faults as jf
    from blaze_tpu.spark import validator as jvalidator
    from blaze_tpu.spark.local_runner import run_plan as jrun_plan
    from blaze_tpu_torch.spark import validator
    from blaze_tpu_torch.spark.local_runner import run_plan

    (paths, frames), (jpaths, jframes) = tables["core"]
    spec = {"seed": 13, "points": {"corrupt.shuffle_data": {
        "kind": "corrupt", "nth": 1}}}
    outs = []
    for mod, val, run, flt, p, f, kw in (
            ("port", validator, run_plan, faults, paths, frames,
             {"device": "cpu", "mesh_exchange": "off"}),
            ("jax", jvalidator, jrun_plan, jf, jpaths, jframes,
             {"mesh_exchange": "off"})):
        wd = str(tmp_path / mod)
        flt.install(spec)
        try:
            run(val.QUERIES["q2_q06_core_agg"](p, f, "bhj")[0],
                work_dir=wd, **kw)
        finally:
            flt.install(None)
        try:
            outs.append(run(val.QUERIES["q2_q06_core_agg"](p, f, "bhj")[0],
                            work_dir=wd, **kw).to_numpy())
        except FileNotFoundError:
            outs.append(None)
    assert outs[0] is not None and outs[1] is None
    (clean, _), _ = run_both(tables, tmp_path / "clean", "core",
                             "q2_q06_core_agg", "bhj")
    _same_rows(outs[0], clean)
