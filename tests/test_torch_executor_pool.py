"""The port's process-isolated executor pool (runtime/executor_pool.py),
driver and worker, on the CPU: the JAX package's own pool cases
(tests/test_executor_pool.py, tests/test_network.py) run against the
port's pool, whose workers here run only protocol tasks (echo, sleep,
flaky), so none of them imports torch.

- Dispatch, capacity and stats; a retryable failure re-queued by the
  driver with a new epoch; a fatal one relayed as faults.FatalError.
- SIGKILL of a busy worker: the batch completes, each task counted once,
  the seat respawns, and one executor_death dossier holds the pool's
  stats (the dossier's `executor_pool` is `pool_stats()`).
- The zombie fence: a hung worker's late result is rejected at the fence,
  never double-counted; every seat retired raises PoolUnavailableError.
- The worker's session layer: re-delivered specs dedupe, a finished
  spec's reply replays from the cache; the driver keeps the winner's
  files when a duplicate of its result arrives and sweeps a zombie's.
- A sticky CUDA error poisons a worker's context: it replies, then exits
  with _POISONED_EXIT (a port-only rule).

Waits are bounded by deadlines; counts are exact.
"""

import collections
import os
import signal
import threading
import time

import pytest

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import artifacts, faults, flight_recorder
from blaze_tpu_torch.runtime import executor_pool as ep


@pytest.fixture
def fast_death_conf(monkeypatch):
    monkeypatch.setattr(conf, "executor_death_ms", 600)
    monkeypatch.setattr(conf, "executor_heartbeat_ms", 50)
    monkeypatch.setattr(conf, "executor_restart_backoff_ms", 50)


def _start_pool(count=2, slots=2):
    return ep.ExecutorPool(count=count, slots=slots).start()


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


def test_pool_echo_capacity_and_stats(fast_death_conf):
    pool = _start_pool(count=2, slots=2)
    try:
        assert pool.live_count() == 2 and pool.capacity() == 4
        specs = [ep.PoolTaskSpec(f"echo:{i}", "echo", {"value": i * 10})
                 for i in range(6)]
        out = pool.run_tasks(specs, timeout=60)
        assert [r["value"] for r in out] == [0, 10, 20, 30, 40, 50]
        st = pool.stats()
        assert st["tasks_done"] == 6 and st["deaths_total"] == 0
        assert st["inflight"] == 0 and st["capacity"] == 4
        ep.activate(pool)
        try:
            stats = ep.pool_stats()
            assert stats["live"] == 2
            assert sorted(e["exec_id"] for e in stats["executors"]) == [
                "exec0", "exec1"]
        finally:
            ep.deactivate(pool)
        assert ep.pool_stats() is None
        # an echo-only worker never imports the engine (or torch)
        for err in os.listdir(pool._dir):
            if err.endswith(".err"):
                with open(os.path.join(pool._dir, err)) as f:
                    assert f.read() == ""
    finally:
        pool.close()


def test_pool_retry_then_fatal(fast_death_conf, tmp_path, monkeypatch):
    """A retryable failure is re-queued by the driver (a cross-process
    attempt under a new epoch) and succeeds; a fatal one is relayed as
    faults.FatalError. No executor dies: the case is about task errors,
    so its death bound is one a loaded host's heartbeats meet
    (deaths_total stays 0, exactly)."""
    monkeypatch.setattr(conf, "executor_death_ms", 10_000)
    pool = _start_pool(count=1, slots=1)
    try:
        marker = str(tmp_path / "flaky.n")
        out = pool.run_tasks([ep.PoolTaskSpec(
            "flaky:0", "flaky", {"marker": marker, "times": 1})],
            timeout=60)
        assert out[0]["ok"] and out[0]["attempts_failed"] == 1
        assert pool.stats()["tasks_done"] == 1
        with pytest.raises(faults.FatalError, match="flaky task"):
            pool.run_tasks([ep.PoolTaskSpec(
                "fatal:0", "flaky", {"marker": str(tmp_path / "f.n"),
                                     "times": 99, "category": "fatal"})],
                timeout=60)
        # a fatal task error leaves the worker serving
        assert pool.live_count() == 1
        assert pool.run_tasks([ep.PoolTaskSpec("e", "echo", {"value": 1})],
                              timeout=60)[0]["value"] == 1
        assert pool.stats()["deaths_total"] == 0
    finally:
        pool.close()


def test_batch_waits_out_a_slow_respawn(fast_death_conf, monkeypatch):
    """The one seat dies mid-task and its replacement's process start is
    slow (a loaded host): the batch waits for the replacement and
    completes; it never sees "no live executors and no replacement
    pending" between the respawn's backoff and the new process's
    registration."""
    pool = _start_pool(count=1, slots=1)
    try:
        spawn = pool._spawn

        def slow_spawn(seat, generation):
            time.sleep(0.5)  # several of run_tasks' 0.1 s wake-ups
            spawn(seat, generation)

        monkeypatch.setattr(pool, "_spawn", slow_spawn)
        t, box = _run_async(pool, [ep.PoolTaskSpec("sl", "sleep",
                                                   {"ms": 400})])
        _wait(pool.busy_pids, 10, "a busy executor")
        os.kill(next(iter(pool.busy_pids().values())), signal.SIGKILL)
        t.join(timeout=120)
        assert not t.is_alive()
        assert "err" not in box, box.get("err")
        assert [r["ok"] for r in box["out"]] == [True]
        st = pool.stats()
        assert st["deaths_total"] == 1 and st["restarts_total"] == 1
    finally:
        pool.close()


def test_pool_sigkill_recovery_and_dossier(fast_death_conf, tmp_path,
                                           monkeypatch):
    """SIGKILL a busy executor mid-batch: the batch still completes, the
    seat respawns, capacity dips then recovers, and exactly one
    executor_death dossier is written, holding the pool's stats."""
    monkeypatch.setattr(conf, "flight_dir", str(tmp_path / "flight"))
    flight_recorder.reset()
    caps = []
    pool = _start_pool(count=2, slots=2)
    pool.on_membership(lambda p: caps.append(p.capacity()))
    ep.activate(pool)
    try:
        specs = [ep.PoolTaskSpec(f"sl:{i}", "sleep", {"ms": 600})
                 for i in range(4)]
        t, box = _run_async(pool, specs)
        _wait(pool.busy_pids, 10, "a busy executor")
        seat, pid = next(iter(pool.busy_pids().items()))
        os.kill(pid, signal.SIGKILL)
        t.join(timeout=120)
        assert "err" not in box
        assert len(box["out"]) == 4 and all(r["ok"] for r in box["out"])
        st = pool.stats()
        assert st["deaths_total"] == 1
        assert st["tasks_done"] == 4  # displaced attempts count ONCE
        # the seat joins before its membership callback fires
        _wait(lambda: pool.live_count() == 2 and caps[-1] == 4, 20,
              "the respawn")
        assert pool.capacity() == 4 and pool.pids()[seat] != pid
        assert 2 in caps
        assert pool.restarts_total == 1
        deaths = [d for d in flight_recorder.list_dossiers(
            str(tmp_path / "flight")) if d.get("trigger") == "executor_death"]
        assert len(deaths) == 1
        doc = flight_recorder.load(deaths[0]["path"])
        detail = doc["detail"]
        assert detail["reason"] in ("exit", "heartbeat")
        assert detail["signal"] in (int(signal.SIGKILL), None)
        assert set(detail["recovery"].values()) == {"re-queued"}
        assert "last_heartbeat_age_ms" in detail
        # the dossier's executor_pool is pool_stats() at capture
        assert doc["executor_pool"]["count"] == 2
        assert doc["executor_pool"]["deaths_total"] == 1
        assert len(doc["executor_pool"]["executors"]) == 2
    finally:
        ep.deactivate(pool)
        pool.close()


def test_pool_zombie_epoch_fence_no_double_count(fast_death_conf):
    """Hang an executor mid-task (heartbeats stop, its result send waits,
    the process lives): the driver declares a heartbeat death and
    re-queues the attempt on the other seat; the zombie's late result is
    rejected at the fence, and each key completes once."""
    pool = _start_pool(count=2, slots=1)
    try:
        specs = [ep.PoolTaskSpec(f"z:{i}", "sleep", {"ms": 400})
                 for i in range(2)]
        t, box = _run_async(pool, specs)
        _wait(lambda: len(pool.busy_pids()) == 2, 10, "two busy seats")
        seat = next(iter(pool.busy_pids()))
        fenced_before = pool.fence.fenced_total
        done_before = pool.tasks_done
        assert pool.hang_executor(seat, 2500)
        t.join(timeout=120)
        assert "err" not in box
        assert len(box["out"]) == 2 and all(r["ok"] for r in box["out"])
        assert pool.stats()["deaths_total"] >= 1
        assert pool.tasks_done - done_before == 2
        _wait(lambda: pool.fence.fenced_total > fenced_before, 15,
              "the zombie's late result")
        assert pool.tasks_done - done_before == 2  # still two
    finally:
        pool.close()


def test_pool_unavailable_when_all_seats_retired(fast_death_conf,
                                                 monkeypatch):
    monkeypatch.setattr(conf, "executor_restart_max", 0)
    pool = _start_pool(count=1, slots=1)
    try:
        t, box = _run_async(pool, [ep.PoolTaskSpec("u:0", "sleep",
                                                   {"ms": 5000})])
        _wait(pool.busy_pids, 10, "a busy executor")
        for pid in pool.pids().values():
            os.kill(pid, signal.SIGKILL)
        t.join(timeout=60)
        assert isinstance(box.get("err"), ep.PoolUnavailableError)
    finally:
        pool.close()


# ---- the worker's session layer and the driver's result triage ----


@pytest.fixture
def stub_worker(monkeypatch, tmp_path):
    monkeypatch.setenv(ep._ENV_TOKEN, "wtest")
    monkeypatch.setenv(ep._ENV_CTL, str(tmp_path / "ctl.sock"))
    w = ep._Worker()
    sent = []
    monkeypatch.setattr(w, "_send", lambda h, blob=b"": sent.append(h))
    return w, sent


def test_worker_dedupes_redelivered_running_spec(stub_worker, monkeypatch):
    w, _sent = stub_worker
    runs = []
    monkeypatch.setattr(w, "_run_task",
                        lambda msg, blob: runs.append(msg["task"]))
    w._dispatch_task({"task": "t1", "epoch": 2}, b"")
    _wait(lambda: runs, 5, "the first run")
    w._dispatch_task({"task": "t1", "epoch": 2}, b"")
    time.sleep(0.1)
    assert runs == ["t1"]  # NOT re-executed


def test_worker_replays_cached_reply_for_finished_spec(stub_worker,
                                                       monkeypatch):
    w, sent = stub_worker
    monkeypatch.setattr(
        w, "_run_task",
        lambda msg, blob: pytest.fail("finished task re-executed"))
    reply = {"type": "result", "task": "t9", "epoch": 4, "ok": True}
    with w._task_lock:
        w._task_done[("t9", 4)] = reply
    w._dispatch_task({"task": "t9", "epoch": 4}, b"")
    assert sent == [reply]
    runs = []
    monkeypatch.setattr(w, "_run_task",
                        lambda msg, blob: runs.append(msg["epoch"]))
    w._dispatch_task({"task": "t9", "epoch": 5}, b"")
    _wait(lambda: runs, 5, "the new epoch's run")
    assert runs == [5]


@pytest.mark.parametrize("message,poisoned", [
    ("CUDA error: an illegal memory access was encountered", True),
    ("CUDA error: device-side assert triggered", True),
    ("unspecified launch failure", True),
    ("some other failure", False),
])
def test_poisoned_context_replies_then_exits(stub_worker, monkeypatch,
                                             message, poisoned):
    """A sticky CUDA error is classified fatal; the worker sends that
    reply first and then exits with _POISONED_EXIT, so its seat respawns
    with a fresh context. Any other failure leaves it serving."""
    w, sent = stub_worker

    def boom(payload, blob, epoch):
        raise RuntimeError(message)

    exits, flushes = [], []
    monkeypatch.setattr(w, "_run_plan", boom)
    monkeypatch.setattr(w, "_flush_telemetry",
                        lambda ship=True: flushes.append(ship))
    monkeypatch.setattr(ep.os, "_exit", exits.append)
    w._run_task({"task": "p:0", "epoch": 1, "kind": "plan",
                 "payload": {}}, b"")
    assert len(sent) == 1 and sent[0]["ok"] is False
    assert sent[0]["category"] == ("fatal" if poisoned
                                   else faults.classify(RuntimeError(message)))
    assert exits == ([ep._Worker._POISONED_EXIT] if poisoned else [])
    assert w.stop.is_set() == poisoned
    # the telemetry tail: shipped before the reply, then spilled (not
    # shipped) on the way out of a poisoned process
    assert flushes == ([True, False] if poisoned else [True])


def _pool_shell():
    pool = ep.ExecutorPool.__new__(ep.ExecutorPool)
    pool.fence = artifacts.EpochFence()
    pool._lock = threading.Lock()
    pool._cv = threading.Condition(pool._lock)
    pool._running = {}
    pool._done_epochs = collections.OrderedDict()
    pool.tasks_done = 0
    return pool


def test_duplicate_winner_result_does_not_unlink_artifacts(tmp_path):
    pool = _pool_shell()
    handle = type("H", (), {"inflight": {}, "tasks_done": 0})()
    data = tmp_path / "shuffle_0_0.e1.data"
    index = tmp_path / "shuffle_0_0.e1.index"
    data.write_bytes(b"live")
    index.write_bytes(b"live")
    msg = {"type": "result", "task": "shuffle_0_0", "epoch": 1, "ok": True,
           "data_path": str(data), "index_path": str(index)}
    assert pool.fence.advance("shuffle_0_0") == 1
    pool._running["shuffle_0_0"] = type(
        "T", (), {"epoch": 1, "state": "running", "result": None})()
    pool._on_result(handle, dict(msg))
    assert pool.tasks_done == 1
    pool.fence.forget("shuffle_0_0")
    pool._on_result(handle, dict(msg))
    assert pool.tasks_done == 1
    assert data.exists() and index.exists()
    zdata = tmp_path / "shuffle_0_1.e1.data"
    zdata.write_bytes(b"zombie")
    pool.fence.advance("shuffle_0_1")
    pool.fence.advance("shuffle_0_1")
    pool._on_result(handle, {"type": "result", "task": "shuffle_0_1",
                             "epoch": 1, "ok": True,
                             "data_path": str(zdata)})
    assert not zdata.exists()


def test_worker_conf_snapshot_carries_the_port_knobs(tmp_path, monkeypatch):
    """_spawn's conf snapshot: every knob of the port (spill_dir
    included), the worker overrides on top, and the tracing state."""
    import json
    import subprocess

    seen = {}

    class _Proc:
        pid = 4242

        def poll(self):
            return None

    def popen(cmd, env, **kw):
        seen["cmd"], seen["env"] = cmd, env
        return _Proc()

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(conf, "spill_dir", str(tmp_path / "spill"))
    pool = ep.ExecutorPool(count=1, slots=1)
    try:
        pool._spawn(0, 0)
        snap = json.loads(seen["env"][ep._ENV_CONF])
        assert snap["spill_dir"] == str(tmp_path / "spill")
        for k, v in ep._WORKER_CONF_OVERRIDES.items():
            assert snap[k] == v
        assert snap["trace_buffer_events"] == conf.executor_trace_events
        assert seen["cmd"][1:] == ["-m", "blaze_tpu_torch.runtime."
                                   "executor_pool", "--worker"]
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            ep.__file__)))
        assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == \
            os.path.dirname(root)
    finally:
        import shutil

        shutil.rmtree(pool._dir, ignore_errors=True)


def test_first_plan_task_widens_its_heartbeat_bound(stub_worker,
                                                    monkeypatch):
    """A worker's first plan task (the engine's import and the CUDA
    context hold the GIL for seconds) is framed by "starting"/"started";
    the driver widens that seat's heartbeat bound in between, and only
    the first task pays the start-up."""
    from blaze_tpu_torch.runtime import supervisor

    w, sent = stub_worker
    seen = []

    def loaded(payload, blob, epoch, t_load):
        seen.append(t_load is not None)
        return {}

    monkeypatch.setattr(w, "_run_plan_loaded", loaded)
    w._run_plan({}, b"", 1)
    w._run_plan({}, b"", 2)
    assert seen == [True, False]
    assert [m["type"] for m in sent] == ["starting", "started"]
    pool = _pool_shell()
    peer = supervisor.ProcessPeer("t", 1, lambda *a: None)
    handle = type("H", (), {"peer": peer})()
    pool._on_starting(handle, True)
    assert peer.stale_ms == conf.executor_death_ms * ep._START_GRACE
    pool._on_starting(handle, False)
    assert peer.stale_ms is None


# ---- the service's capacity, /healthz and the pool gauges: the JAX
# package's cases (tests/test_executor_pool.py:388-470), each run against
# both packages over the same stub pool ----


class _StubPool:
    """A pool's capacity surface with no processes: membership changes on
    demand."""

    def __init__(self, live, slots=2):
        self.live, self.slots = live, slots
        self._cbs = []
        self.deaths_total = self.restarts_total = self.tasks_done = 0

    def capacity(self):
        return self.live * self.slots

    def live_count(self):
        return self.live

    def on_membership(self, cb):
        self._cbs.append(cb)

    def set_live(self, n):
        self.live = n
        for cb in list(self._cbs):
            cb(self)

    def stats(self):
        return {"count": 2, "live": self.live,
                "capacity": self.capacity(), "slots": self.slots,
                "inflight": 0, "deaths_total": self.deaths_total,
                "restarts_total": self.restarts_total,
                "fenced_total": 0, "tasks_done": self.tasks_done}

    def executors(self):
        return [{"exec_id": f"exec{i}", "pid": 1000 + i, "generation": 0,
                 "up": i < self.live, "inflight": 0} for i in range(2)]


def _packages():
    """(executor_pool, monitor, service) of the port, then of the JAX
    package."""
    from blaze_tpu.runtime import executor_pool as jep
    from blaze_tpu.runtime import monitor as jmonitor
    from blaze_tpu.runtime import service as jservice
    from blaze_tpu_torch.runtime import monitor, service

    return ((ep, monitor, service), (jep, jmonitor, jservice))


def test_service_capacity_shrinks_and_recovers():
    caps = []
    for _pool_mod, _mon, svc_mod in _packages():
        svc = svc_mod.QueryService(max_concurrent=8)
        stub = _StubPool(live=2, slots=3)
        svc.attach_pool(stub)
        try:
            seen = [svc.capacity()]
            stub.set_live(1)          # death: admission window shrinks
            seen.append(svc.capacity())
            stub.set_live(2)          # rejoin: recovers
            seen += [svc.capacity(), svc.stats()["capacity"]]
        finally:
            svc.close()
        caps.append(seen)
    assert caps[0] == caps[1] == [6, 3, 6, 6]


def test_healthz_503_only_at_zero_executors():
    seen = []
    for pool_mod, mon, _svc in _packages():
        stub = _StubPool(live=1)
        pool_mod.activate(stub)
        try:
            snap = mon.health_snapshot()
            status, _ctype, _body = mon.serve_path("/healthz")
            row = [snap["ok"], snap["executors_live"], status]
            stub.set_live(0)
            snap = mon.health_snapshot()
            status, _ctype, body = mon.serve_path("/healthz")
            row += [snap["ok"], status, bool(body)]
        finally:
            pool_mod.deactivate(stub)
        seen.append(row)
    # 200 while one executor lives; 503 at zero, the body still the
    # snapshot
    assert seen[0] == seen[1] == [True, 1, 200, False, 503, True]


def test_prometheus_executor_gauges():
    want = ('blaze_executor_up{exec_id="exec0"} 1',
            'blaze_executor_up{exec_id="exec1"} 0',
            "blaze_executor_live 1", "blaze_executor_restarts_total 3")
    texts = []
    for pool_mod, mon, _svc in _packages():
        stub = _StubPool(live=1)
        stub.restarts_total = 3
        pool_mod.activate(stub)
        try:
            text = mon.prometheus_text()
        finally:
            pool_mod.deactivate(stub)
        assert all(line in text for line in want)
        assert "blaze_service_capacity" in text
        texts.append([line for line in text.splitlines()
                      if line.startswith(("blaze_executor_",
                                          "blaze_service_capacity"))])
    assert texts[0] == texts[1]
