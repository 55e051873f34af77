"""The port's fleet autoscaler (runtime/autoscaler.py) against the JAX
package's, on the CPU.

- The policy: both packages' Autoscaler tick over the same scripted fleet
  snapshots (parked arrivals, queue depth, SLO burn, busy slots) on fake
  pools, and make the same decisions at the same ticks, on the same
  seats, with the same evidence, state and fleet snapshot; the bounds,
  the cooldown and the streak resets included.
- The registry and the ledger: with an autoscaler active, a ledger line
  carries its "fleet" posture, with the JAX package's keys.
- The real pool (protocol-task workers): a scale-down fired while both
  seats are busy drains the chosen seat without a requeue or a death; a
  scale-up spawns the lowest free seat; the service's parked arrivals
  drive a spawn through the background loop. Membership is awaited
  through the pool's callbacks, with deadlines.
"""

import threading
import time

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import autoscaler as jasc
from blaze_tpu.runtime import trace as jtrace
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import autoscaler as asc
from blaze_tpu_torch.runtime import executor_pool as ep
from blaze_tpu_torch.runtime import trace

PKGS = {"port": (asc, conf, trace), "jax": (jasc, jconf, jtrace)}


@pytest.fixture(autouse=True)
def autoscale_conf(monkeypatch):
    for c in (conf, jconf):
        for k, v in (("autoscale_enabled", True), ("autoscale_min", 1),
                     ("autoscale_max", 4), ("autoscale_cooldown_ms", 0),
                     ("executor_death_ms", 8000),
                     ("executor_heartbeat_ms", 50),
                     ("executor_drain_grace_ms", 30_000)):
            monkeypatch.setattr(c, k, v)
    yield
    asc.deactivate()
    jasc.deactivate()


class FakePool:
    """executors()/spawn()/decommission() with recorded actuations."""

    def __init__(self, seats=1, slots=2, inflight=None):
        self.slots = slots
        self._seats = {i: {"exec_id": f"exec{i}", "up": True,
                           "draining": False,
                           "inflight": (inflight or {}).get(i, 0)}
                       for i in range(seats)}
        self.spawned, self.decommissioned = [], []

    def executors(self):
        return [dict(e) for e in self._seats.values()]

    def set_inflight(self, inflight):
        for i, e in self._seats.items():
            e["inflight"] = inflight.get(i, 0)

    def spawn(self):
        seat = max(self._seats) + 1 if self._seats else 0
        self._seats[seat] = {"exec_id": f"exec{seat}", "up": True,
                             "draining": False, "inflight": 0}
        self.spawned.append(seat)
        return seat

    def decommission(self, seat):
        if seat not in self._seats:
            return False
        del self._seats[seat]
        self.decommissioned.append(seat)
        return True


class FakeService:
    def __init__(self):
        self.queue_depth = 0
        self.parked_total = 0

    def stats(self):
        return {"queue_depth": self.queue_depth,
                "parked": self.parked_total}


# each tick: (parked arrivals since the last tick, queue depth, SLO burn,
# in-flight tasks by seat)
SCRIPT = ([(0, 0, 0.0, {})]
          + [(1, 0, 0.0, {0: 2})] * 2          # sustained parking: up
          + [(0, 3, 0.0, {0: 2, 1: 2})] * 3    # queue: up again
          + [(0, 0, 2.0, {0: 2, 1: 1})] * 2    # SLO burn: up again
          + [(0, 0, 0.0, {0: 1})] * 6          # idle: drain the idlest
          + [(0, 1, 0.0, {})] * 6              # a queue: up, no drain
          + [(0, 0, 0.0, {0: 2, 1: 2, 2: 2})] * 6   # busy: no drain
          + [(0, 0, 0.0, {})] * 12)            # idle: a drain each
                                               # DOWN_TICKS


def _drive(mod, c, script, seats=1, cooldown_ms=0, max_seats=4):
    c.autoscale_cooldown_ms = cooldown_ms
    c.autoscale_max = max_seats
    pool, svc = FakePool(seats=seats), FakeService()
    burn = {"v": 0.0}
    scaler = mod.Autoscaler(
        pool, service=svc,
        slo_stats=lambda: {"t0": {"burn_rate": burn["v"]}})
    rows = []
    for parked, depth, b, inflight in script:
        svc.parked_total += parked
        svc.queue_depth = depth
        burn["v"] = b
        pool.set_inflight(inflight)
        d = scaler.tick()
        ev = dict(scaler.last_decision["evidence"]) if d else None
        rows.append((d, ev, scaler.target_seats, scaler._up_streak,
                     scaler._down_streak))
    st = scaler.state()
    st.pop("last_decision")
    snap = scaler.fleet_snapshot()
    return rows, pool.spawned, pool.decommissioned, st, snap


def test_policy_decisions_match_jax():
    runs = {n: _drive(mod, c, SCRIPT) for n, (mod, c, _t) in PKGS.items()}
    assert runs["port"] == runs["jax"]
    rows, spawned, drained, st, snap = runs["port"]
    decisions = [(i, r[0], r[2]) for i, r in enumerate(rows) if r[0]]
    assert decisions == [(2, "up", 2), (4, "up", 3), (6, "up", 4),
                         (12, "down", 3), (15, "up", 4), (30, "down", 3),
                         (35, "down", 2)]
    assert spawned == [1, 2, 3, 3] and drained == [3, 3, 2]
    assert rows[2][1]["parked_delta"] == 1
    assert rows[6][1]["max_burn"] == 2.0
    assert st["decisions"] == {"up": 4, "down": 3} and st["seats"] == 2
    assert snap["serving"] == 2 and snap["at_max"] is False


@pytest.mark.parametrize("case", ["max", "min", "cooldown"])
def test_bounds_and_cooldown_match_jax(case):
    script, kw = {
        "max": ([(0, 5, 0.0, {})] * 10, {"max_seats": 1}),
        "min": ([(0, 0, 0.0, {})] * 15, {}),
        "cooldown": ([(0, 5, 0.0, {})] * 12, {"cooldown_ms": 60_000}),
    }[case]
    runs = {n: _drive(mod, c, script, **kw)
            for n, (mod, c, _t) in PKGS.items()}
    for r in runs.values():
        r[3].pop("cooldown_remaining_ms")
    assert runs["port"] == runs["jax"]
    rows, spawned, drained, *_ = runs["port"]
    assert drained == []
    assert spawned == ([1] if case == "cooldown" else [])


def test_registry_and_ledger_fleet_key_match_jax():
    recs = []
    for mod, _c, tr in PKGS.values():
        assert mod.active() is None and mod.state() is None
        assert mod.fleet_snapshot() is None
        assert "fleet" not in tr.build_run_record("q-idle", {}, records=[])
        scaler = mod.Autoscaler(FakePool(seats=2), slo_stats=lambda: {})
        mod.activate(scaler)
        try:
            rec = tr.build_run_record("q-fleet", {"tenant_id": "t"},
                                      records=[])
        finally:
            mod.deactivate(scaler)
        assert mod.active() is None
        recs.append(rec["fleet"])
    assert recs[0] == recs[1]
    assert recs[0]["serving"] == 2 and recs[0]["autoscale_max"] == 4


# ---- the real pool ----


def _membership(pool):
    """A condition set on every membership change of `pool`."""
    cond = threading.Condition()
    pool.on_membership(lambda _p: _notify(cond))
    return cond


def _notify(cond):
    with cond:
        cond.notify_all()


def _await(cond, pred, timeout=30.0, what="membership"):
    deadline = time.monotonic() + timeout
    with cond:
        while not pred():
            left = deadline - time.monotonic()
            assert left > 0, f"timed out waiting: {what}"
            cond.wait(min(left, 0.5))


def test_scale_down_drains_busy_seat_without_requeue():
    """A scale-down fired while both seats hold in-flight sleeps lets the
    chosen seat finish (every result delivered, no requeue), then removes
    it: no death, no respawn."""
    pool = ep.ExecutorPool(count=2, slots=2)
    cond = _membership(pool)
    try:
        pool.start()
        scaler = asc.Autoscaler(pool)
        box = {}

        def run():
            specs = [ep.PoolTaskSpec(f"s:{i}", "sleep", {"ms": 1500})
                     for i in range(4)]
            box["out"] = pool.run_tasks(specs, timeout=120)

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 30
        while sum(e["inflight"] for e in pool.executors()) < 4:
            assert time.monotonic() < deadline, "tasks never in flight"
            time.sleep(0.005)
        assert scaler._scale_down(scaler._observe()) == "down"
        t.join(timeout=120)
        assert len(box.get("out", [])) == 4
        _await(cond, lambda: pool.live_count() == 1, what="the drain")
        st = pool.stats()
        assert (st["drains_total"], st["drain_requeues_total"],
                st["deaths_total"]) == (1, 0, 0)
        assert scaler.decisions == {"up": 0, "down": 1}
        assert scaler.target_seats == 1
    finally:
        pool.close()


def test_parked_arrivals_scale_the_pool_up():
    """The service's parked arrivals, sustained over UP_TICKS policy
    ticks of the background loop, spawn the lowest free seat; it joins
    capacity, and the service's capacity follows the pool."""
    from blaze_tpu_torch.runtime import service

    pool = ep.ExecutorPool(count=1, slots=1)
    cond = _membership(pool)
    try:
        pool.start()
        with service.QueryService(max_concurrent=8, queue_depth=8) as svc:
            svc.attach_pool(pool)
            assert svc.capacity() == 1
            hold = svc.admit("acme")
            parked = []
            waiters = [threading.Thread(
                target=lambda: parked.append(svc.admit("globex")))
                for _ in range(2)]
            for w in waiters:
                w.start()
            deadline = time.monotonic() + 10
            while svc.stats()["queue_depth"] < 2:
                assert time.monotonic() < deadline, "never parked"
                time.sleep(0.005)
            scaler = asc.Autoscaler(pool, service=svc,
                                    slo_stats=lambda: {}, tick_s=0.02)
            scaler.start()
            try:
                _await(cond, lambda: pool.live_count() == 2,
                       what="the spawned seat")
                assert asc.active() is scaler
            finally:
                scaler.close()
            assert asc.active() is None
            assert scaler.decisions["up"] >= 1
            assert sorted(e["exec_id"] for e in pool.executors())[:2] == [
                "exec0", "exec1"]
            # the new seat's slot admitted one parked arrival; the held
            # slot's release admits the other
            svc._release(hold)
            deadline = time.monotonic() + 10
            while len(parked) < 2:
                assert time.monotonic() < deadline, "parked never admitted"
                time.sleep(0.005)
            for w in waiters:
                w.join(timeout=5)
            for s in parked:
                svc._release(s)
            assert svc.stats()["parked"] == 2
    finally:
        pool.close()
