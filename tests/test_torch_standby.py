"""The port's warm-standby driver (runtime/standby.py) against the JAX
package's, on the CPU.

- The leader lease: the same acquire/renew/fence script gives the same
  answers and the same lease file (epoch, pid, role) in both packages.
- The fleet manifest: published, read back and republished on
  membership alike; the port's real pool publishes the JAX pool's
  manifest keys.
- The takeover over a dead primary with an unrecoverable journal: the
  same evidence (epoch bump, journals replayed, queries re-billed) and
  exactly one driver_failover dossier in each package.
- The takeover of a live fleet: a primary process with two protocol-task
  workers is SIGKILLed; the standby fences it, rebinds the control plane
  at its socket paths and adopts both workers, which then run tasks.
- /healthz and the driver-role gauge report the role alike.

Waits are bounded by deadlines; counts are exact.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from blaze_tpu.config import conf as jconf
from blaze_tpu.runtime import flight_recorder as jflight
from blaze_tpu.runtime import journal as jjournal
from blaze_tpu.runtime import monitor as jmonitor
from blaze_tpu.runtime import standby as jstandby
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import flight_recorder, journal, monitor, standby

PKGS = {"port": (standby, journal, flight_recorder, monitor, conf),
        "jax": (jstandby, jjournal, jflight, jmonitor, jconf)}

KNOBS = ("journal_dir", "flight_dir", "leader_lease_ms", "standby_enabled",
         "recovery_enabled", "artifact_checksums")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    for name, (sb, jn, fl, _mon, c) in PKGS.items():
        for k in KNOBS:
            monkeypatch.setattr(c, k, getattr(c, k))
        c.journal_dir = str(tmp_path / name / "journal")
        c.flight_dir = str(tmp_path / name / "flight")
        c.leader_lease_ms = 400
        c.recovery_enabled = True
        c.artifact_checksums = True
        jn.reset()
        fl.reset()
        sb.set_role("primary")
    yield
    for sb, jn, fl, _mon, _c in PKGS.values():
        jn.reset()
        fl.reset()
        sb.set_role("primary")


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _write_lease(sb, directory, epoch, pid, age_s=0.0):
    os.makedirs(directory, exist_ok=True)
    now = time.time()
    with open(sb.lease_path(directory), "w") as f:
        json.dump({"epoch": epoch, "pid": pid, "role": "primary",
                   "acquired_at": now - age_s, "renewed_at": now - age_s},
                  f)


def _lease_doc(sb, d):
    doc = sb.read_lease(d)
    return {k: doc[k] for k in ("epoch", "pid", "role")}


def test_lease_protocol_matches_jax():
    dead = _dead_pid()
    rows = []
    for sb, _jn, _fl, _mon, c in PKGS.values():
        d = c.journal_dir
        row = []
        lease = sb.LeaderLease(d)
        row += [lease.acquire(), lease.epoch, lease.acquire(),
                _lease_doc(sb, d)]
        before = sb.read_lease(d)["renewed_at"]
        time.sleep(0.02)
        row += [lease.renew(), sb.read_lease(d)["renewed_at"] > before]
        _write_lease(sb, d, epoch=3, pid=os.getpid())
        other = sb.LeaderLease(d)
        row += [other.acquire(), sb.read_lease(d)["epoch"]]
        _write_lease(sb, d, epoch=3, pid=dead)
        row += [other.acquire(), other.epoch]        # the bump: 4
        _write_lease(sb, d, epoch=5, pid=os.getpid(), age_s=10.0)
        stale = sb.LeaderLease(d)
        row += [stale.acquire(), stale.epoch]        # 6
        _write_lease(sb, d, epoch=9, pid=dead)
        row += [stale.renew(), stale.fenced, stale.renew(),
                _lease_doc(sb, d)]
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0][:3] == [True, 1, True]
    assert rows[0][6:] == [False, 3, True, 4, True, 6, False, True, False,
                           {"epoch": 9, "pid": dead, "role": "primary"}]


class _ManifestPool:
    def __init__(self):
        self.cbs = []

    def manifest(self):
        return {"pool_id": "abc123", "ctl_path": "/tmp/x.sock",
                "shuffle_path": "/tmp/y.sock", "count": 2, "slots": 2,
                "pid": os.getpid(), "seats": []}

    def on_membership(self, cb):
        self.cbs.append(cb)


def test_manifest_publish_and_republish_match_jax():
    docs = []
    for sb, _jn, _fl, _mon, c in PKGS.values():
        pool = _ManifestPool()
        sb.wire_manifest(pool, c.journal_dir)
        first = sb.read_manifest(c.journal_dir)
        assert len(pool.cbs) == 1
        os.unlink(sb.manifest_path(c.journal_dir))
        pool.cbs[0](pool)
        docs.append((first, sb.read_manifest(c.journal_dir),
                     os.path.basename(sb.manifest_path(c.journal_dir)),
                     os.path.basename(sb.lease_path(c.journal_dir))))
    assert docs[0] == docs[1]


def test_real_pool_manifest_has_the_jax_keys():
    from blaze_tpu.runtime import executor_pool as jep
    from blaze_tpu_torch.runtime import executor_pool as ep

    pool = ep.ExecutorPool(count=2, slots=1).start()
    jpool = jep.ExecutorPool(count=2, slots=1)
    try:
        standby.publish_manifest(pool, conf.journal_dir)
        doc = standby.read_manifest(conf.journal_dir)
        assert sorted(doc) == sorted(jpool.manifest())
        assert doc["pid"] == os.getpid() and doc["count"] == 2
        assert sorted(s["seat"] for s in doc["seats"]) == [0, 1]
        assert os.path.exists(doc["ctl_path"])
    finally:
        pool.close()
        jpool.close()


def test_standby_stays_put_while_primary_renews():
    lease = standby.LeaderLease(conf.journal_dir)
    lease.acquire()
    lease.start_renewing()
    sb = standby.StandbyDriver(conf.journal_dir, poll_s=0.02).start()
    try:
        assert standby.role() == "standby"
        assert not sb.wait_takeover(0.5)
        assert sb.took_over is False
    finally:
        sb.close()
        lease.release()
    conf.journal_dir = ""
    with pytest.raises(ValueError):
        standby.StandbyDriver("")


def test_takeover_over_a_dead_primary_matches_jax():
    """A dead lease holder and an incomplete journal with no durable
    stage: both packages bump the epoch, bill the query failed, become
    primary and write exactly one driver_failover dossier."""
    infos = []
    for sb_mod, jn, fl, _mon, c in PKGS.values():
        d = c.journal_dir
        os.makedirs(d, exist_ok=True)
        _write_lease(sb_mod, d, epoch=2, pid=_dead_pid())
        jnl = jn.QueryJournal("0badc0de")
        jnl.record("admitted", tenant_id="t0", pid=_dead_pid())
        jnl.plan(fingerprint="qfp", num_partitions=2,
                 stages=[{"stage_id": 0, "kind": "shuffle_map"}])
        jn.reset()
        sb = sb_mod.StandbyDriver(d, poll_s=0.02).start()
        try:
            assert sb.wait_takeover(15.0)
            info = dict(sb.takeover_info)
            assert sb_mod.role() == "primary"
            fl.capture("driver_failover", f"failover-e{sb.lease.epoch}",
                       detail={"dup": True})   # the second capture no-ops
            dossiers = [x for x in fl.list_dossiers(c.flight_dir)
                        if x.get("trigger") == "driver_failover"]
            doc = fl.load(dossiers[0]["path"])
        finally:
            sb.close()
        assert doc["detail"]["dead_primary_pid"] == info["dead_primary_pid"]
        assert info.pop("dead_primary_pid") > 0
        info.pop("takeover_ms")
        infos.append((info, len(dossiers), sorted(doc["detail"])))
    assert infos[0] == infos[1]
    info, n, _ = infos[0]
    assert n == 1
    assert info["lease_epoch"] == 3 and info["journals_replayed"] == 1
    assert info["queries_rebilled"] == 1 and info["executors_adopted"] == 0


PRIMARY = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from blaze_tpu_torch.config import conf
conf.update(journal_dir=sys.argv[2], executor_heartbeat_ms=50,
            executor_death_ms=20000, control_reconnect_max=8,
            leader_lease_ms=10000)
from blaze_tpu_torch.runtime import executor_pool as ep, standby
lease = standby.LeaderLease(sys.argv[2])
assert lease.acquire()
lease.start_renewing()
pool = ep.ExecutorPool(count=2, slots=1).start()
standby.wire_manifest(pool, sys.argv[2])
print("ready", flush=True)
time.sleep(600)
"""


def test_takeover_adopts_a_dead_primarys_workers(tmp_path):
    """SIGKILL a primary driver process that holds the lease and two
    protocol-task workers: the standby fences it (epoch 2), rebinds the
    control plane at the dead primary's socket paths, and adopts both
    surviving workers (no respawn), which then run tasks for it. The
    lease window is one that a loaded host's renewals meet: the takeover
    must come from the primary's death (pid liveness), not from a late
    renewal of a live primary, whose workers would not re-dial."""
    conf.leader_lease_ms = 10_000
    d = conf.journal_dir
    proc = subprocess.Popen([sys.executable, "-c", PRIMARY, REPO, d],
                            stdout=subprocess.PIPE, text=True)
    sb = None
    try:
        assert proc.stdout.readline().strip() == "ready"
        manifest = standby.read_manifest(d)
        worker_pids = sorted(s["pid"] for s in manifest["seats"])
        assert len(worker_pids) == 2
        sb = standby.StandbyDriver(d, poll_s=0.02).start()
        assert not sb.wait_takeover(0.3)    # the primary still renews
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        assert sb.wait_takeover(30.0)
        info = sb.takeover_info
        assert info["lease_epoch"] == 2
        assert info["dead_primary_pid"] == proc.pid
        assert info["executors_adopted"] == 2
        pool = sb.pool
        assert sorted(e["pid"] for e in pool.executors()) == worker_pids
        from blaze_tpu_torch.runtime import executor_pool as ep

        assert ep.active() is pool
        out = pool.run_tasks([ep.PoolTaskSpec(f"e:{i}", "echo",
                                              {"value": i})
                              for i in range(4)], timeout=60)
        assert [r["value"] for r in out] == [0, 1, 2, 3]
        assert pool.stats()["restarts_total"] == 0
        # the new primary republished the manifest under its own pid
        assert standby.read_manifest(d)["pid"] == os.getpid()
        assert standby.role() == "primary"
    finally:
        if sb is not None:
            from blaze_tpu_torch.runtime import executor_pool as ep

            if sb.pool is not None:
                ep.deactivate(sb.pool)
            sb.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_health_and_role_gauge_match_jax():
    from blaze_tpu.runtime import autoscaler as jasc
    from blaze_tpu_torch.runtime import autoscaler as asc

    class _P:
        slots = 2

        def executors(self):
            return [{"exec_id": "exec0", "up": True, "draining": False,
                     "inflight": 0}]

    rows = []
    for (sb, _jn, _fl, mon, _c), amod in zip(PKGS.values(), (asc, jasc)):
        snap = mon.health_snapshot()
        row = [snap["role"], snap["autoscaler"]]
        scaler = amod.Autoscaler(_P())
        amod.activate(scaler)
        try:
            sb.set_role("standby")
            snap = mon.health_snapshot()
            text = mon.prometheus_text()
        finally:
            amod.deactivate(scaler)
        row += [snap["role"], snap["autoscaler"]["target_seats"],
                sorted(snap["autoscaler"]),
                [ln for ln in text.splitlines()
                 if ln.startswith("blaze_driver_role")]]
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0][:3] == ["primary", None, "standby"]
    assert rows[0][5] == ['blaze_driver_role{role="standby"} 1']
