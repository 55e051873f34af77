"""Warm-standby driver: fenced leader lease + mid-query takeover.

Port of blaze_tpu/runtime/standby.py whole (driver high availability).
The engine already has every MECHANISM of a driverless recovery: the
write-ahead journal replays a dead writer's queries (journal.ensure_recovery_scan), shuffle
artifacts are crash-atomic and checksummed (runtime/artifacts.py), and
executors survive a vanished driver for a bounded lease window, re-
dialing the control socket until it expires (executor_pool._reconnect).
This module connects them into an ONLINE failover path: a second driver
process tails the journal directory, detects primary death by
pid-liveness (the same os.kill(pid, 0) posture journal._writer_alive
uses), fences the dead primary behind an epoch-bumped leader lease, and
takes over the live fleet mid-query.

The lease is one crash-atomic JSON file beside the journals
(artifacts.commit_file — temp + fsync + rename, so no reader ever sees
a torn lease):

    {"epoch": 3, "pid": 12345, "role": "primary",
     "acquired_at": ..., "renewed_at": ...}

Fencing mirrors the executors' epoch posture exactly: acquisition BUMPS the
epoch, and a paused-then-resumed old primary discovers the higher epoch
on its next renew() and stands down (``lease_fenced``) — it can never
split-brain the fleet, for the same reason a zombie executor's stale-
epoch results are rejected at the driver.

Takeover sequence (StandbyDriver._takeover):

  1. acquire the lease (epoch bump — the fence point);
  2. rebind the executor control plane at the dead primary's socket
     paths (ExecutorPool.rebind + start_rebound): dead workers are
     respawned, surviving workers are ADOPTED as their reconnect loop
     re-dials the very same ctl path;
  3. replay dead-writer journals into live resumable queries
     (journal.ensure_recovery_scan(force=True) — the offline
     recovery scan, run online);
  4. capture exactly one ``driver_failover`` dossier (lease epoch, dead
     primary pid, journals replayed, queries resumed vs. re-billed) and
     resume admission via the embedder's on_takeover callback.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from blaze_tpu_torch.config import conf

LEASE_FILE = "leader.lease.json"
MANIFEST_FILE = "fleet.manifest.json"


def lease_path(directory: Optional[str] = None) -> str:
    return os.path.join(directory or conf.journal_dir, LEASE_FILE)


def manifest_path(directory: Optional[str] = None) -> str:
    return os.path.join(directory or conf.journal_dir, MANIFEST_FILE)


def read_lease(directory: Optional[str] = None) -> Optional[dict]:
    try:
        with open(lease_path(directory)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# ---------------------------------------------------------------------------
# Role registry (monitor's blaze_driver_role gauge / /healthz "role")
# ---------------------------------------------------------------------------

_role_lock = threading.Lock()
_role = "primary"


def set_role(role: str) -> None:
    global _role
    with _role_lock:
        _role = role


def role() -> str:
    with _role_lock:
        return _role


# ---------------------------------------------------------------------------
# Fleet manifest
# ---------------------------------------------------------------------------


def publish_manifest(pool, directory: Optional[str] = None) -> str:
    """Commit the pool's socket topology beside the journals so a
    standby can rebind after this process dies. Crash-atomic: a SIGKILL
    mid-publish leaves the previous manifest intact. Re-published on
    every membership change (wire_manifest) so the seat list tracks
    spawns, deaths and drains."""
    from blaze_tpu_torch.runtime import artifacts

    path = manifest_path(directory)
    doc = pool.manifest()

    def write(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    artifacts.commit_file(write, path)
    return path


def read_manifest(directory: Optional[str] = None) -> Optional[dict]:
    try:
        with open(manifest_path(directory)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def wire_manifest(pool, directory: Optional[str] = None) -> None:
    """Publish now and on every membership change."""
    publish_manifest(pool, directory)
    pool.on_membership(
        lambda p, d=directory: _republish_quiet(p, d))


def _republish_quiet(pool, directory: Optional[str]) -> None:
    try:
        publish_manifest(pool, directory)
    except Exception:  # noqa: BLE001 — membership cbs must not wedge
        pass


# ---------------------------------------------------------------------------
# Leader lease
# ---------------------------------------------------------------------------


class LeaderLease:
    """One process's handle on the leader lease file.

    ``acquire()`` takes the lease when it is free, its holder is dead,
    or its holder stopped renewing for conf.leader_lease_ms — always
    bumping the epoch, which IS the fence. ``renew()`` refreshes the
    holder's claim and returns False (setting ``fenced``) the moment a
    higher epoch appears in the file: a paused-then-resumed old primary
    self-fences instead of split-braining the fleet."""

    def __init__(self, directory: Optional[str] = None) -> None:
        self.directory = directory or conf.journal_dir
        self.epoch = 0
        self.fenced = False
        self._renew_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- core protocol -------------------------------------------------

    def acquire(self) -> bool:
        from blaze_tpu_torch.runtime import artifacts

        cur = read_lease(self.directory)
        if cur is not None:
            pid = int(cur.get("pid", -1))
            cur_epoch = int(cur.get("epoch", 0))
            if (pid == os.getpid() and cur_epoch == self.epoch
                    and self.epoch > 0):
                return True  # already ours
            age_ms = (time.time()
                      - float(cur.get("renewed_at", 0.0))) * 1000.0
            fresh = age_ms <= max(int(conf.leader_lease_ms), 1)
            if artifacts._pid_alive(pid) and fresh:
                return False  # a live, renewing leader holds it
            self.epoch = cur_epoch + 1
        else:
            self.epoch = 1
        self.fenced = False
        self._write(acquired=True)
        return True

    def renew(self) -> bool:
        cur = read_lease(self.directory)
        if cur is not None and int(cur.get("epoch", 0)) > self.epoch:
            if not self.fenced:
                self.fenced = True
                from blaze_tpu_torch.runtime import trace

                trace.event("lease_fenced", epoch=self.epoch,
                            observed_epoch=int(cur.get("epoch", 0)),
                            pid=os.getpid())
            return False
        if self.epoch <= 0 or self.fenced:
            return False
        self._write(acquired=False)
        return True

    def release(self) -> None:
        self._stop.set()

    def _write(self, acquired: bool) -> None:
        from blaze_tpu_torch.runtime import artifacts

        now = time.time()
        doc = {"epoch": self.epoch, "pid": os.getpid(),
               "role": "primary", "renewed_at": now}
        if acquired:
            doc["acquired_at"] = now
            self._acquired_at = now
        doc.setdefault("acquired_at",
                       getattr(self, "_acquired_at", now))

        def write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(doc, f)

        os.makedirs(self.directory, exist_ok=True)
        artifacts.commit_file(write, lease_path(self.directory))

    # -- background renewal (the primary's heartbeat) ------------------

    def start_renewing(self,
                       on_fenced: Optional[Callable[[], None]] = None
                       ) -> "LeaderLease":
        period = max(int(conf.leader_lease_ms), 30) / 3000.0

        def loop() -> None:
            while not self._stop.wait(period):
                try:
                    if not self.renew():
                        if on_fenced is not None:
                            on_fenced()
                        return
                except Exception:  # noqa: BLE001 — keep heartbeating
                    pass

        self._renew_thread = threading.Thread(
            target=loop, name="blz-lease-renew", daemon=True)
        self._renew_thread.start()
        return self


# ---------------------------------------------------------------------------
# The standby driver
# ---------------------------------------------------------------------------


class StandbyDriver:
    """Tails the lease + journal dir; takes over when the primary dies.

    The embedder supplies ``on_takeover(standby)`` to resume admission
    (start its QueryService, re-run resumable queries) — everything
    mechanical below that (lease fencing, control-plane rebind, worker
    adoption, journal replay, the driver_failover dossier) is handled
    here. ``takeover_info`` holds the evidence afterwards."""

    def __init__(self, directory: Optional[str] = None,
                 on_takeover: Optional[
                     Callable[["StandbyDriver"], None]] = None,
                 poll_s: float = 0.05) -> None:
        self.directory = directory or conf.journal_dir
        if not self.directory:
            raise ValueError("standby needs a journal_dir to tail")
        self.on_takeover = on_takeover
        self.poll_s = max(float(poll_s), 0.01)
        self.lease = LeaderLease(self.directory)
        self.pool = None
        self.took_over = False
        self.takeover_info: Optional[dict] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dog = None
        self._watched_pid: Optional[int] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "StandbyDriver":
        set_role("standby")
        self._thread = threading.Thread(
            target=self._watch, name="blz-standby", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._dog is not None:
            self._dog.close()
            self._dog = None
        self.lease.release()
        if self.pool is not None:
            self.pool.close()
            self.pool = None

    def wait_takeover(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self.took_over:
            time.sleep(0.02)
        return self.took_over

    # -- primary-death watch -------------------------------------------

    def _primary_down(self) -> bool:
        from blaze_tpu_torch.runtime import artifacts

        cur = read_lease(self.directory)
        if cur is None:
            return True  # no leader at all: the seat is open
        pid = int(cur.get("pid", -1))
        if not artifacts._pid_alive(pid):
            return True  # the journal._writer_alive posture, online
        age_ms = (time.time()
                  - float(cur.get("renewed_at", 0.0))) * 1000.0
        return age_ms > max(int(conf.leader_lease_ms), 1)

    def _track_primary_pid(self) -> None:
        """Register the current lease holder with a ProcessWatchdog as a
        SILENT pid-liveness watch (supervisor stale_ms=0: no heartbeat
        expectation, no executor-death accounting) so a SIGKILLed
        primary wakes the watch loop at watchdog-tick latency instead of
        waiting out the lease staleness window."""
        cur = read_lease(self.directory)
        pid = int(cur.get("pid", -1)) if cur else -1
        if pid == self._watched_pid or pid <= 0:
            return
        from blaze_tpu_torch.runtime import supervisor

        if self._dog is None:
            self._dog = supervisor.ProcessWatchdog()
        if self._watched_pid is not None:
            self._dog.unregister(f"primary:{self._watched_pid}")
        self._watched_pid = pid
        self._dog.register(f"primary:{pid}", pid,
                           lambda _peer, _reason, _rc: self._wake.set(),
                           stale_ms=0)

    def _watch(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._track_primary_pid()
                if not self._primary_down():
                    continue
                if not self.lease.acquire():
                    continue  # lost the race to another standby
            except Exception:  # noqa: BLE001 — keep watching
                continue
            self._takeover()
            return

    # -- the takeover --------------------------------------------------

    def _takeover(self) -> None:
        from blaze_tpu_torch.runtime import (executor_pool, flight_recorder,
                                       journal, trace)

        if self._dog is not None:
            self._dog.close()
            self._dog = None
        dead = read_manifest(self.directory) or {}
        # manifest-less primaries (no pool wired) still leave their pid
        # in the lease the watch loop tracked before acquiring over it
        dead_pid = int(dead.get("pid", -1))
        if dead_pid <= 0 and self._watched_pid:
            dead_pid = self._watched_pid
        set_role("primary")
        self.lease.start_renewing()
        t0 = time.monotonic()
        if dead.get("ctl_path"):
            try:
                self.pool = executor_pool.ExecutorPool.rebind(dead)
                self.pool.start_rebound()
                executor_pool.activate(self.pool)
                wire_manifest(self.pool, self.directory)
            except Exception:  # noqa: BLE001 — degrade to in-process
                if self.pool is not None:
                    self.pool.close()
                self.pool = None
        adopted = getattr(self.pool, "adopted_total", 0) \
            if self.pool is not None else 0
        # the offline recovery scan, run online: dead-writer
        # journals become live resumable queries / failed bills NOW,
        # under the new epoch, before admission resumes
        old_journal_dir = conf.journal_dir
        conf.update(journal_dir=self.directory)
        try:
            scan = journal.ensure_recovery_scan(force=True) or {}
        finally:
            conf.update(journal_dir=old_journal_dir or self.directory)
        self.takeover_info = {
            "lease_epoch": self.lease.epoch,
            "dead_primary_pid": dead_pid,
            "journals_replayed": int(scan.get("scanned", 0)),
            "queries_resumed": int(scan.get("resumable", 0)),
            "queries_rebilled": int(scan.get("billed_failed", 0)),
            "stages_recovered": int(scan.get("stages_recovered", 0)),
            "streams_adoptable": int(scan.get("streams_adoptable", 0)),
            "executors_adopted": adopted,
            "takeover_ms": round((time.monotonic() - t0) * 1000),
        }
        trace.event("driver_failover", **self.takeover_info)
        # exactly once per takeover: the dedup key is the epoch-stamped
        # query id — a second capture attempt for the same takeover
        # no-ops inside the recorder
        flight_recorder.capture(
            "driver_failover", f"failover-e{self.lease.epoch}",
            detail=dict(self.takeover_info))
        self.took_over = True
        if self.on_takeover is not None:
            try:
                self.on_takeover(self)
            except Exception:  # noqa: BLE001 — takeover already durable
                pass
