"""Process-isolated executor pool: crash containment for the runtime.

Port of blaze_tpu/runtime/executor_pool.py, whole. Ref: Spark's executor
model (executors die, the driver detects it, lost partitions are
re-executed from persisted shuffle artifacts). This module is that
driver/executor split for the local runtime: N worker PROCESSES receive
TaskSpecs over a length-prefixed control socket (the framing of
runtime/shuffle_server.py) and read upstream shuffle input from the
driver's ShuffleServer, so one hard fault (OOM kill, segfault, wedged
interpreter) costs ONE process, not the service.

  heartbeat   every worker pushes beats over the control socket; ANY
              inbound frame refreshes liveness (supervisor.ProcessPeer).

  death       supervisor.ProcessWatchdog declares an executor dead on
              reap/exit (exact exit code / killing signal) or heartbeat
              staleness past conf.executor_death_ms; the latter may be a
              ZOMBIE that is still running.

  fencing     every task attempt carries an epoch (artifacts.EpochFence)
              stamped into its TaskSpec, its shuffle artifact names
              (`shuffle_0_1.e2.data`) and the result accounting: a
              re-queue advances the fence, so a zombie's late result is
              rejected at the driver and its late files land on stale
              names that get swept.

  lineage     only the LOST partitions re-execute: completed map outputs
              live in driver-committed .data/.index files served by the
              ShuffleServer. Re-queues are bounded with exponential
              backoff.

  degradation on a death the pool's membership callbacks fire with the
              new capacity (live seats x conf.executor_slots), and the
              replacement process (bounded by conf.executor_restart_max,
              backed off) restores it when it rejoins.

  telemetry   each worker runs its own bounded TraceLog ring
              (conf.executor_trace_events) and monitor counters, stamps
              records with the driver-issued correlation ids of the task
              payload, and ships batched deltas back as "telemetry"
              frames, every conf.telemetry_ship_ms and just before each
              result frame. Before every ship the batch is spilled
              crash-atomically to a per-worker sidecar file
              (<token>.telemetry); on a death the driver recovers the
              unshipped tail from it, once (batch seq watermark), marking
              the records truncated=true. A clock-offset estimate from the
              hello echo (bounded by conf.clock_skew_bound_ms) rebases
              worker timestamps onto the driver's. Frames from a
              declared-dead (zombie) handle are dropped.

Workers are spawned as `python -m blaze_tpu_torch.runtime.executor_pool
--worker` (a fresh interpreter, never a fork of a process that touched
CUDA) with their identity and socket paths in the environment and the
driver's conf snapshot, `spill_dir` included, beside them. Each worker
logs to `<pool dir>/<token>.err`. A worker imports the engine, and with it
torch, at its first `plan` task: an echo-only worker never initialises
CUDA. That import and the CUDA context hold the GIL for seconds at a time
and starve the beat thread, so the worker frames its first plan task with
"starting"/"started" and the driver widens that seat's heartbeat bound in
between (_START_GRACE). A `plan` task's payload names the run's device ("cuda", "cuda:0" or
"cpu"); a payload with none takes the card, and with no CUDA device the
task fails as device.resolve_device does; it never carries on on the
host. The worker loads the kernels the driver built (kernels.build_all
publishes each library with an atomic rename). Its reply carries, beside
the committed pair and the logical bytes, the task's operator metrics
(executor.TASK_METRICS), the kernel launches that task alone made
(metrics.task_tally) and, from a worker's first plan task, the seconds
its engine import and CUDA context took; the driver adds them into
run_info. A worker whose task hit a sticky CUDA error (faults classifies
it fatal) replies and then exits with _POISONED_EXIT: its CUDA context
would fail every later launch, so its seat respawns as after a crash.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from blaze_tpu_torch.config import KNOBS, conf
from blaze_tpu_torch.runtime import shuffle_server as ss

_ENV_TOKEN = "BLAZE_EXEC_TOKEN"
_ENV_SEAT = "BLAZE_EXEC_SEAT"
_ENV_CTL = "BLAZE_EXEC_SOCK"
_ENV_SHUFFLE = "BLAZE_EXEC_SHUFFLE_SOCK"
_ENV_CONF = "BLAZE_TPU_WORKER_CONF"

# knobs a worker must NOT inherit verbatim: a worker never spawns its own
# pool, never serves metrics, and never EXPORTS traces/dossiers/history
# (the driver owns exporting; worker-side trace records buffer in the
# local ring and ship back over the control socket; _spawn also sets
# trace_enabled/trace_buffer_events from the driver's tracing state)
_WORKER_CONF_OVERRIDES = {
    "executor_count": 0,
    "metrics_port": 0,
    "trace_export_dir": "",
    "history_dir": "",
    "flight_dir": "",
    "progress_enabled": False,
    "fault_injection_spec": {},
    # only the driver journals (one journal per query) or replays them
    "journal_dir": "",
    "recovery_enabled": False,
}


# a worker's heartbeat bound while its first plan task starts the engine,
# in multiples of conf.executor_death_ms (60 s at the default 2000 ms)
_START_GRACE = 30


def _clamp_offset(offset_ns: int) -> int:
    """Bound a clock-offset estimate to ±conf.clock_skew_bound_ms: one
    bad echo (a worker descheduled mid-handshake) must not scramble
    merged-trace ordering by seconds."""
    bound = max(int(conf.clock_skew_bound_ms), 0) * 1_000_000
    return max(-bound, min(bound, int(offset_ns)))


class PoolTaskSpec:
    """One schedulable unit for the process pool (the TaskSpec twin for
    the process boundary: everything must be serializable). `key` is the
    fence key — unique per logical task; `payload` is the JSON header the
    worker dispatches on; `blob` carries the plan proto bytes."""

    __slots__ = ("key", "kind", "payload", "blob", "what")

    def __init__(self, key: str, kind: str, payload: Optional[dict] = None,
                 blob: bytes = b"", what: str = "") -> None:
        self.key = key
        self.kind = kind
        self.payload = dict(payload or {})
        self.blob = blob
        self.what = what or key


class _PoolTask:
    """Pool-internal task state: current epoch, retry/death budgets, and
    the terminal outcome."""

    __slots__ = ("spec", "epoch", "state", "result", "error", "tries",
                 "death_requeues", "not_before", "executor")

    def __init__(self, spec: PoolTaskSpec, epoch: int) -> None:
        self.spec = spec
        self.epoch = epoch
        self.state = "queued"  # queued | running | done | error
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.tries = 0
        self.death_requeues = 0
        self.not_before = 0.0
        self.executor: Optional["ExecutorHandle"] = None

    @property
    def finished(self) -> bool:
        return self.state in ("done", "error")


class ExecutorHandle:
    """Driver-side view of one executor process."""

    def __init__(self, seat: int, generation: int, token: str, pid: int,
                 proc: Optional[subprocess.Popen],
                 conn: socket.socket) -> None:
        self.seat = seat
        self.generation = generation
        self.token = token
        self.pid = pid
        self.proc = proc
        self.conn = conn
        self.send_lock = threading.Lock()
        self.inflight: Dict[str, _PoolTask] = {}  # guarded by pool lock
        self.dead = False                         # guarded by pool lock
        self.closing = False
        # partition tolerance (guarded by pool lock): conn_broken marks
        # a transport error on a seat whose PROCESS is still alive — the
        # seat keeps its in-flight tasks and waits for the worker's
        # resume handshake, bounded by the watchdog's heartbeat
        # staleness (executor_death_ms). draining marks a seat finishing
        # in-flight work before a graceful exit; drained marks the drain
        # completed (seat removed without a death).
        self.conn_broken = False
        self.draining = False
        # drain barrier (guarded by send_lock, NOT the pool lock): set
        # just before the drain_ack frame goes on the wire. A dispatch
        # that acquires send_lock and finds it set must NOT send — the
        # worker may sample idle and exit the moment it reads the ack,
        # and the control socket is FIFO, so anything sent after the
        # ack can be lost without a requeue signal.
        self.drain_acked = False
        self.drained = False
        self.decommissioned = False
        self.reconnects = 0
        self.joined_at = time.monotonic()
        self.last_beat = self.joined_at
        # telemetry federation state (guarded by pool lock):
        # clock_offset_ns rebases this worker's monotonic timestamps
        # onto the driver's; tel_seq is the highest batch ingested (the
        # sidecar-recovery dedup watermark)
        self.clock_offset_ns = 0
        self.tel_seq = 0
        self.tel_bytes = 0
        self.tel_records = 0
        self.tel_dropped = 0
        self.tasks_done = 0
        # the watchdog's record of this process (its heartbeat bound is
        # widened while the worker starts its engine: _on_starting)
        self.peer = None

    @property
    def exec_id(self) -> str:
        return f"exec{self.seat}"


class PoolUnavailableError(ConnectionError):
    """No live executor can run a queued task and no replacement is
    pending: callers degrade to the in-process runtime."""


class ExecutorPool:
    """Spawns, supervises, feeds and buries executor processes.

    Lifecycle: `start()` spawns conf.executor_count workers and waits
    for their control-socket handshakes; `run_tasks(specs)` executes a
    batch with epoch-fenced re-queue on executor death; `close()` tears
    everything down. `activate(pool)` publishes the pool process-wide so
    the local runner routes eligible stages here and the service derives
    its admission capacity from membership."""

    _READY_TIMEOUT = 90.0
    _HELLO_TIMEOUT = 30.0

    def __init__(self, count: Optional[int] = None,
                 slots: Optional[int] = None) -> None:
        self.count = int(count if count is not None
                         else conf.executor_count)
        self.slots = max(1, int(slots if slots is not None
                                else conf.executor_slots))
        from blaze_tpu_torch.runtime import artifacts, supervisor

        self.fence = artifacts.EpochFence()
        self.watchdog = supervisor.ProcessWatchdog()
        self._dir = tempfile.mkdtemp(prefix="blzex-")
        # pool-unique token prefix: two pools in one process (tests, a
        # service restart) must not collide in the flight recorder's
        # (query_id, trigger) exactly-once dedup or the watchdog registry
        self._pool_id = os.path.basename(self._dir)[len("blzex-"):]
        self._ctl_path = os.path.join(self._dir, "ctl.sock")
        self.server = ss.ShuffleServer(os.path.join(self._dir, "shf.sock"))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._seats: Dict[int, ExecutorHandle] = {}
        # declared-dead handles: a heartbeat-dead ZOMBIE's socket stays
        # open (its late results must arrive to be fenced) and its
        # process may still run — close() reaps whatever is left here
        self._graveyard: List[ExecutorHandle] = []
        self._awaiting: Dict[str, tuple] = {}  # token -> (seat, gen, proc)
        self._queue: List[_PoolTask] = []
        self._running: Dict[str, _PoolTask] = {}
        # task key -> winning attempt epoch, recorded at completion:
        # lets _on_result tell a re-delivered duplicate of the winner
        # (files are LIVE — keep) from a zombie's stale epoch (sweep)
        self._done_epochs: "OrderedDict[str, int]" = OrderedDict()
        self._seat_restarts: Dict[int, int] = {}
        self._respawns_pending = 0
        # seat indexes with a replacement in flight (the count above
        # can't answer "is THIS seat coming back" — spawn() must not
        # hand an autoscaler a seat the respawn path is about to fill)
        self._respawn_seats: set = set()
        # next free generation per seat: tokens must never repeat (the
        # watchdog registry and the flight recorder's exactly-once
        # dedup key on them), even across decommission + re-spawn
        self._next_gen: Dict[int, int] = {}
        # standby takeover (rebind): manifest seats whose process was
        # alive at takeover — token -> (seat, generation, pid); their
        # resume hello adopts them instead of being refused
        self._adoptable: Dict[str, tuple] = {}
        self.adopted_total = 0
        self._membership_cbs: List[Callable[["ExecutorPool"], None]] = []
        self._closed = False
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self.deaths_total = 0
        self.restarts_total = 0
        self.reconnects_total = 0
        self.drains_total = 0
        # tasks a drain's grace period cut off (requeued, no death
        # budget). The rolling-restart gate demands this stays 0: a
        # graceful drain must FINISH its in-flight work, not shed it.
        self.drain_requeues_total = 0
        self.tasks_done = 0
        self.telemetry_bytes_total = 0
        self.telemetry_records_total = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ExecutorPool":
        with self._lock:
            count = self.count          # spawn() grows it under _lock
        if count <= 0:
            raise ValueError("executor pool needs count >= 1")
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(self._ctl_path)
        listener.listen(count * 2 + 4)
        self._listener = listener
        self.server.start()
        for name, target in (("blz-pool-accept", self._accept_loop),
                             ("blz-pool-dispatch", self._dispatch_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        for seat in range(count):
            self._spawn(seat, 0)
        deadline = time.monotonic() + self._READY_TIMEOUT
        with self._cv:
            while (len([h for h in self._seats.values() if not h.dead])
                   < self.count):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"executor pool: {len(self._seats)}/{self.count} "
                        f"workers joined within {self._READY_TIMEOUT}s")
                self._cv.wait(min(left, 0.25))
        return self

    # -- elastic fleet & driver HA -------------------------------------

    def spawn(self) -> Optional[int]:
        """Scale-up actuator (runtime/autoscaler.py): start one NEW
        worker on the lowest seat index that is neither occupied, nor
        awaiting its hello, nor about to be refilled by a respawn.
        Returns the seat (None when the pool is closed); the seat joins
        capacity when its handshake lands — callers watch membership
        callbacks rather than blocking here."""
        with self._cv:
            if self._closed:
                return None
            taken = set(self._seats)
            taken.update(s for s, _g, _p in self._awaiting.values())
            taken.update(self._respawn_seats)
            seat = 0
            while seat in taken:
                seat += 1
            self.count = max(self.count, seat + 1)
        self._spawn(seat, 0)
        return seat

    def manifest(self) -> dict:
        """Fleet manifest for the warm standby (runtime/standby.py):
        enough topology to rebind the control plane after a driver
        death. The socket DIRECTORY outlives the driver process, and
        surviving workers keep re-dialing ctl_path until their lease
        expires — so a standby that binds the same path inside the
        lease window inherits the fleet."""
        with self._lock:
            seats = [{"seat": h.seat, "generation": h.generation,
                      "token": h.token, "pid": h.pid}
                     for h in self._seats.values() if not h.dead]
            count = self.count
        return {"pool_id": self._pool_id, "dir": self._dir,
                "ctl_path": self._ctl_path,
                "shuffle_path": self.server.sock_path,
                "count": count, "slots": self.slots,
                "pid": os.getpid(), "seats": seats}

    @classmethod
    def rebind(cls, manifest: dict) -> "ExecutorPool":
        """Standby takeover, step 1: construct a pool wired to the DEAD
        primary's socket topology instead of a fresh temp dir. Call
        start_rebound() (not start()) to bind and adopt."""
        pool = cls(count=max(int(manifest.get("count", 1)), 1),
                   slots=int(manifest.get("slots", conf.executor_slots)))
        shutil.rmtree(pool._dir, ignore_errors=True)  # unused fresh dir
        pool._dir = manifest["dir"]
        pool._pool_id = (manifest.get("pool_id")
                         or os.path.basename(pool._dir))
        pool._ctl_path = manifest["ctl_path"]
        pool.server = ss.ShuffleServer(manifest["shuffle_path"])
        for s in manifest.get("seats") or []:
            pool._adoptable[s["token"]] = (int(s["seat"]),
                                           int(s["generation"]),
                                           int(s["pid"]))
            pool._next_gen[int(s["seat"])] = int(s["generation"]) + 1
        return pool

    def start_rebound(self, adopt_window_s: float = 5.0
                      ) -> "ExecutorPool":
        """Standby takeover, step 2: bind listener + shuffle server at
        the dead primary's socket paths (unlinking its stale socket
        FILES — the fds died with it) and re-own the fleet. Manifest
        seats whose pid is already gone are respawned fresh under a
        bumped generation; live ones are adopted as their bounded
        reconnect loop re-dials ctl_path (_resume). Seats still
        unclaimed after the adoption window get fresh workers too — a
        hung or partitioned survivor will self-fence on its own lease
        and must not hold a seat hostage."""
        from blaze_tpu_torch.runtime import artifacts

        with self._lock:
            count = self.count
        if count <= 0:
            raise ValueError("executor pool needs count >= 1")
        for path in (self._ctl_path, self.server.sock_path):
            try:
                os.unlink(path)
            except OSError:
                pass
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(self._ctl_path)
        listener.listen(count * 2 + 4)
        self._listener = listener
        self.server.start()
        for name, target in (("blz-pool-accept", self._accept_loop),
                             ("blz-pool-dispatch", self._dispatch_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        with self._cv:
            adoptable = dict(self._adoptable)
        for token, (seat, generation, pid) in sorted(adoptable.items()):
            if not artifacts._pid_alive(pid):
                with self._cv:
                    self._adoptable.pop(token, None)
                self._spawn(seat, generation + 1)
        deadline = time.monotonic() + max(adopt_window_s, 0.0)
        with self._cv:
            while self._adoptable and time.monotonic() < deadline:
                self._cv.wait(0.1)
            unclaimed, self._adoptable = dict(self._adoptable), {}
        for token, (seat, generation, _pid) in sorted(unclaimed.items()):
            self._spawn(seat, generation + 1)
        deadline = time.monotonic() + self._READY_TIMEOUT
        with self._cv:
            while (len([h for h in self._seats.values() if not h.dead])
                   < self.count):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"rebound pool: {len(self._seats)}/{self.count} "
                        f"workers joined within {self._READY_TIMEOUT}s")
                self._cv.wait(min(left, 0.25))
        return self

    def _spawn(self, seat: int, generation: int) -> None:
        with self._lock:
            generation = max(generation, self._next_gen.get(seat, 0))
            self._next_gen[seat] = generation + 1
        token = f"exec{seat}g{generation}.{self._pool_id}"
        env = dict(os.environ)
        env[_ENV_TOKEN] = token
        env[_ENV_SEAT] = str(seat)
        env[_ENV_CTL] = self._ctl_path
        env[_ENV_SHUFFLE] = self.server.sock_path
        snapshot = {name: getattr(conf, name) for name in KNOBS}
        snapshot.update(_WORKER_CONF_OVERRIDES)
        # the worker traces exactly when the driver does — into its own
        # SMALL bounded ring (the driver-sized ring would let a chatty
        # worker hold megabytes of unshipped records)
        snapshot["trace_enabled"] = bool(conf.trace_enabled)
        snapshot["trace_buffer_events"] = int(conf.executor_trace_events)
        env[_ENV_CONF] = json.dumps(snapshot)
        # the worker resolves blaze_tpu_torch by module name regardless of
        # the driver's cwd (pytest may chdir into a tmp dir)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        err_path = os.path.join(self._dir, f"{token}.err")
        with open(err_path, "ab") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "blaze_tpu_torch.runtime.executor_pool", "--worker"],
                env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=err)
        with self._cv:
            self._awaiting[token] = (seat, generation, proc)
        from blaze_tpu_torch.runtime import trace

        trace.event("executor_spawn", exec_id=f"exec{seat}",
                    generation=generation, pid=proc.pid)

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._handshake, args=(conn,),
                             name="blz-pool-hello", daemon=True).start()

    def _handshake(self, conn: socket.socket) -> None:
        conn.settimeout(self._HELLO_TIMEOUT)
        try:
            msg, _blob = ss.recv_msg(conn)
        except (ConnectionError, OSError):
            conn.close()
            return
        conn.settimeout(None)
        token = msg.get("token", "")
        if msg.get("type") == "hello" and msg.get("resume"):
            self._resume(conn, token, msg)
            return
        with self._cv:
            pending = self._awaiting.pop(token, None)
        if msg.get("type") != "hello" or pending is None:
            conn.close()
            return
        seat, generation, proc = pending
        handle = ExecutorHandle(seat, generation, token,
                                int(msg.get("pid", proc.pid)), proc, conn)
        # clock-offset estimate from the hello echo: the worker stamps
        # its monotonic clock into the hello; (driver_now - worker_then)
        # = true offset + one-way transit, so the estimate is inflated
        # by transit and refined downward by later frames (_on_telemetry
        # keeps the minimum candidate — least transit, closest to truth)
        mono = msg.get("mono_ns")
        if mono is not None:
            handle.clock_offset_ns = _clamp_offset(
                time.monotonic_ns() - int(mono))
        with self._cv:
            if self._closed:
                handle.closing = True
            self._seats[seat] = handle
            self._cv.notify_all()
        if handle.closing:
            conn.close()
            return
        handle.peer = self.watchdog.register(
            token, handle.pid,
            lambda peer, reason, rc, h=handle: self._on_peer_death(
                h, reason, rc),
            poll=proc.poll)
        t = threading.Thread(target=self._reader, args=(handle, conn),
                             name=f"blz-pool-rd-{seat}", daemon=True)
        t.start()
        self._threads.append(t)
        self._notify_membership()

    def _resume(self, conn: socket.socket, token: str, msg: dict) -> None:
        """Session-resume handshake: a worker that survived a control-
        socket transport error reconnects with its token; the driver
        swaps the connection under the SAME handle (generation, epoch
        fence, telemetry watermark all continue) and re-sends every
        in-flight TaskSpec — the worker dedupes re-delivered specs by
        (task_id, epoch) and replies from its result cache for any it
        already finished. A blip costs a retry, not a seat."""
        from blaze_tpu_torch.runtime import trace

        with self._cv:
            handle = next((h for h in self._seats.values()
                           if h.token == token and not h.dead), None)
            if handle is None or self._closed:
                handle = None
            else:
                old = handle.conn
                handle.conn = conn
                handle.conn_broken = False
                handle.last_beat = time.monotonic()
                handle.reconnects += 1
                self.reconnects_total += 1
                inflight = list(handle.inflight.values())
                self._cv.notify_all()
        if handle is None:
            if self._adopt(conn, token, msg):
                return
            # the seat was already declared dead (or the pool closed):
            # refusing the resume makes the worker's lease the authority
            conn.close()
            return
        try:
            old.close()
        except OSError:
            pass
        self.watchdog.beat(token)
        mono = msg.get("mono_ns")
        if mono is not None:
            cand = _clamp_offset(time.monotonic_ns() - int(mono))
            if cand < handle.clock_offset_ns:
                handle.clock_offset_ns = cand
        trace.event("control_reconnect", exec_id=handle.exec_id,
                    generation=handle.generation,
                    reconnects=handle.reconnects,
                    resent_tasks=len(inflight),
                    worker_tel_seq=int(msg.get("tel_seq", 0)))
        for task in inflight:
            header = {"type": "task", "task": task.spec.key,
                      "epoch": task.epoch, "kind": task.spec.kind,
                      "payload": task.spec.payload}
            try:
                ss.send_msg(conn, header, task.spec.blob,
                            lock=handle.send_lock)
            except (ConnectionError, OSError):
                self._conn_broken(handle, conn, "resume_send")
                return
        if handle.draining:
            # a decommission issued while the conn was broken never
            # reached the worker: re-deliver the drain order
            try:
                ss.send_msg(conn, {"type": "drain"},
                            lock=handle.send_lock)
            except (ConnectionError, OSError):
                self._conn_broken(handle, conn, "resume_send")
                return
        t = threading.Thread(target=self._reader, args=(handle, conn),
                             name=f"blz-pool-rd-{handle.seat}", daemon=True)
        t.start()
        self._threads.append(t)

    def _adopt(self, conn: socket.socket, token: str,
               msg: dict) -> bool:
        """Standby takeover: a surviving worker of the DEAD primary
        re-dialed the rebound listener with its resume hello. Its token
        matches no live handle here — but it does match the fleet
        manifest, so instead of refusing (which would self-fence a
        perfectly healthy process mid-task) the rebound pool adopts it:
        a fresh handle with proc=None (no child to reap — the watchdog
        falls back to pid-liveness), the worker's telemetry watermark
        carried over so sidecar recovery stays exactly-once."""
        from blaze_tpu_torch.runtime import trace

        with self._cv:
            pending = self._adoptable.pop(token, None)
            if pending is None or self._closed:
                return False
            seat, generation, pid = pending
            cur = self._seats.get(seat)
            if cur is not None and not cur.dead:
                return False  # seat already refilled; lease buries it
        handle = ExecutorHandle(seat, generation, token,
                                int(msg.get("pid", pid)), None, conn)
        handle.tel_seq = int(msg.get("tel_seq", 0))
        mono = msg.get("mono_ns")
        if mono is not None:
            handle.clock_offset_ns = _clamp_offset(
                time.monotonic_ns() - int(mono))
        with self._cv:
            if self._closed:
                handle.closing = True
            else:
                # counted with the seat, under the lock: start_rebound
                # returns once every seat is filled, and the takeover's
                # evidence reads adopted_total then (the JAX package
                # counts it after the reader starts, so a loaded host
                # could report one adoption short)
                self.adopted_total += 1
            self._seats[seat] = handle
            self._cv.notify_all()
        if handle.closing:
            conn.close()
            return True
        handle.peer = self.watchdog.register(
            token, handle.pid,
            lambda peer, reason, rc, h=handle: self._on_peer_death(
                h, reason, rc))
        t = threading.Thread(target=self._reader, args=(handle, conn),
                             name=f"blz-pool-rd-{seat}", daemon=True)
        t.start()
        self._threads.append(t)
        trace.event("executor_adopted", exec_id=handle.exec_id,
                    token=token, pid=handle.pid,
                    generation=generation,
                    worker_tel_seq=handle.tel_seq)
        self._notify_membership()
        return True

    # -- socket reader -------------------------------------------------

    def _reader(self, handle: ExecutorHandle, conn: socket.socket) -> None:
        """Per-executor inbound loop (one per CONNECTION — a resume
        starts a fresh reader on the new socket). Keeps reading a
        heartbeat-declared zombie's socket so its late results arrive —
        and get fenced — instead of rotting in the kernel buffer."""
        while True:
            rule = ss.net_rule("net.control.recv")
            try:
                msg, _blob = ss.recv_msg(conn, net_fault=rule)
            except (ConnectionError, OSError):
                break
            handle.last_beat = time.monotonic()
            self.watchdog.beat(handle.token)
            # "dup" at the recv point is a delivery property: the frame
            # arrives once, the message is processed twice — result and
            # telemetry dedup (epoch fence / running-map / seq
            # watermark) must absorb the double delivery
            for _ in range(2 if rule and rule.get("kind") == "dup" else 1):
                mtype = msg.get("type")
                if mtype == "result":
                    self._on_result(handle, msg)
                elif mtype == "telemetry":
                    self._on_telemetry(handle, msg)
                elif mtype == "draining":
                    self._on_draining(handle)
                elif mtype == "drained":
                    self._finish_drain(handle, msg)
                elif mtype in ("starting", "started"):
                    self._on_starting(handle, mtype == "starting")
        if not handle.closing:
            self._conn_broken(handle, conn, "recv")

    def _conn_broken(self, handle: ExecutorHandle, conn: socket.socket,
                     why: str) -> None:
        """Transport error triage: distinguish a BROKEN CONNECTION from a
        DEAD PROCESS before burning the seat. A reaped pid (or already-
        stale heartbeat) is a death; a draining seat's EOF is the drain
        completing; otherwise the seat enters conn_broken limbo — tasks
        stay in flight awaiting the worker's resume handshake, and the
        still-registered watchdog turns unresumed limbo into a heartbeat
        death after executor_death_ms."""
        from blaze_tpu_torch.runtime import trace

        with self._cv:
            if handle.dead or self._closed or handle.conn is not conn:
                return  # already buried / resumed onto a newer socket
            draining = handle.draining
        rc = handle.proc.poll() if handle.proc else None
        if draining:
            # a draining worker exits after its "drained" frame; EOF
            # (or a crash mid-drain, caught by rc below) ends the drain
            if rc is None or rc == 0:
                self._finish_drain(handle, {})
            else:
                self._declare_dead(handle, "exit", rc)
            return
        if rc is not None:
            self._declare_dead(handle, "exit", rc)
            return
        stale_ms = (time.monotonic() - handle.last_beat) * 1000.0
        if stale_ms > max(int(conf.executor_death_ms), 1):
            self._declare_dead(handle, "heartbeat", None)
            return
        with self._cv:
            if handle.dead or handle.conn is not conn:
                return
            handle.conn_broken = True
            self._cv.notify_all()
        trace.event("partition_suspected", exec_id=handle.exec_id,
                    why=why, pid=handle.pid,
                    heartbeat_age_ms=round(stale_ms))
        try:
            conn.close()
        except OSError:
            pass

    def _on_peer_death(self, handle: ExecutorHandle, reason: str,
                       rc: Optional[int]) -> None:
        """Watchdog callback: route a clean exit of a DRAINING worker to
        drain completion (no dossier, no death accounting); everything
        else is a real death."""
        if reason == "drained" or (handle.draining and reason == "exit"
                                   and (rc == 0 or rc is None)):
            self._finish_drain(handle, {})
            return
        self._declare_dead(handle, reason, rc, emit_event=False)

    def _on_starting(self, handle: ExecutorHandle, starting: bool) -> None:
        """A worker's first plan task imports the engine and makes its
        CUDA context; both hold the GIL for seconds at a time and starve
        the worker's beat thread (a port-only frame pair: the reference's
        workers import jax at process start, before their hello). The
        seat's heartbeat bound widens to _START_GRACE x executor_death_ms
        until that task is done; an exit is still seen at once."""
        peer = handle.peer
        if peer is not None:
            peer.stale_ms = (max(int(conf.executor_death_ms), 1)
                             * _START_GRACE if starting else None)

    def _on_result(self, handle: ExecutorHandle, msg: dict) -> None:
        from blaze_tpu_torch.runtime import artifacts

        key, epoch = msg.get("task", ""), int(msg.get("epoch", 0))
        if not self.fence.admit(key, epoch):
            # Rejected result: a ZOMBIE's stale-epoch files are losers
            # and must be swept — but a duplicate of the WINNER's reply
            # (the resume handshake re-delivers unacked results, and the
            # fence forgets keys at batch teardown) names the LIVE
            # committed artifacts a downstream read may be consuming.
            # The done-epoch ledger tells them apart.
            with self._cv:
                winner = self._done_epochs.get(key)
            if winner != epoch:
                for p in (msg.get("data_path"), msg.get("index_path")):
                    if p and artifacts.epoch_of(p) == epoch:
                        artifacts._unlink_quiet(p)
            return
        with self._cv:
            task = self._running.get(key)
            if task is None or task.epoch != epoch:
                return
            del self._running[key]
            handle.inflight.pop(key, None)
            if msg.get("ok"):
                task.state, task.result = "done", msg
                self.tasks_done += 1
                handle.tasks_done += 1
                # remember the winning epoch so late duplicates of this
                # very result are not mistaken for zombies (bounded)
                self._done_epochs[key] = epoch
                while len(self._done_epochs) > 4096:
                    self._done_epochs.popitem(last=False)
            else:
                self._handle_task_failure_locked(task, msg)
            self._cv.notify_all()

    # -- telemetry federation ------------------------------------------

    def _on_telemetry(self, handle: ExecutorHandle, msg: dict) -> None:
        """Ingest one batched telemetry frame from a live executor.

        Zombie posture mirrors _on_result: frames from a declared-dead
        handle are DROPPED — its unshipped tail was already recovered
        from the sidecar at death, and accepting the late socket copy
        too would double-count it. The batch seq watermark makes the
        sidecar recovery idempotent in the other direction (a sidecar
        whose batch already arrived over the socket is skipped)."""
        rule = ss.net_rule("net.telemetry")
        if rule:
            kind = rule.get("kind")
            if kind == "delay":
                time.sleep(float(rule.get("ms", 25)) / 1000.0)
            elif kind in ("reset", "blackhole", "torn"):
                # batch lost in transit: the worker's sidecar spill and
                # death-time recovery cover the gap — dropping telemetry
                # must never corrupt answers, only delay observability
                return
            # "dup": ingest twice below — the seq watermark must reject
            # the second copy
        for _ in range(2 if rule and rule.get("kind") == "dup" else 1):
            self._on_telemetry_inner(handle, msg)

    def _on_telemetry_inner(self, handle: ExecutorHandle,
                            msg: dict) -> None:
        with self._cv:
            if handle.dead or self._closed:
                return
            seq = int(msg.get("seq", 0))
            if seq <= handle.tel_seq:
                return  # duplicate / reordered batch
            handle.tel_seq = seq
            # refine the clock offset: every frame carries the worker's
            # send-time monotonic clock; the minimum candidate has the
            # least transit inflation
            mono = msg.get("mono_ns")
            if mono is not None:
                cand = _clamp_offset(time.monotonic_ns() - int(mono))
                if cand < handle.clock_offset_ns:
                    handle.clock_offset_ns = cand
        self._ingest_batch(handle, msg, truncated=False)

    def _ingest_batch(self, handle: ExecutorHandle, msg: dict,
                      truncated: bool) -> None:
        """Federate one telemetry batch (socket frame or recovered
        sidecar) into the driver's observability plane: trace records
        rebased + stamped into the ring, counter deltas merged into the
        per-query roll-ups, histogram deltas folded in."""
        from blaze_tpu_torch.runtime import monitor, trace

        records = msg.get("records") or []
        n = trace.ingest_remote(records, exec_id=handle.exec_id,
                                pid=handle.pid,
                                offset_ns=handle.clock_offset_ns,
                                truncated=truncated)
        monitor.merge_remote(msg.get("counters") or {})
        monitor.merge_zerocopy(msg.get("zerocopy") or {})
        trace.ingest_histograms(msg.get("histograms") or {})
        if conf.profile_enabled and (msg.get("profile")
                                     or msg.get("profile_duty")):
            from blaze_tpu_torch.runtime import profiler

            if msg.get("profile"):
                profiler.merge_remote(msg["profile"],
                                      exec_id=handle.exec_id,
                                      recovered=truncated)
            if msg.get("profile_duty"):
                profiler.merge_duty(msg["profile_duty"])
        nbytes = int(msg.get("nbytes") or 0)
        with self._lock:
            handle.tel_records += len(records)
            handle.tel_bytes += nbytes
            handle.tel_dropped = int(msg.get("dropped") or 0)
            self.telemetry_records_total += len(records)
            self.telemetry_bytes_total += nbytes
        if truncated:
            trace.event("telemetry_recovered", exec_id=handle.exec_id,
                        records=n, seq=int(msg.get("seq", 0)),
                        nbytes=nbytes)
        else:
            trace.event("telemetry_shipped", exec_id=handle.exec_id,
                        records=n, seq=int(msg.get("seq", 0)),
                        nbytes=nbytes)

    def _handle_task_failure_locked(self, task: _PoolTask,
                                    msg: dict) -> None:
        from blaze_tpu_torch.runtime import faults, trace

        category = msg.get("category", "fatal")
        retryable = category in ("retryable", "resource")
        if retryable and task.tries < int(conf.max_task_retries):
            task.tries += 1
            task.epoch = self.fence.advance(task.spec.key)
            task.not_before = (time.monotonic()
                               + conf.retry_backoff_ms
                               * (2 ** (task.tries - 1)) / 1000.0)
            task.state = "queued"
            task.executor = None
            self._queue.append(task)
            trace.event("executor_task_requeued", task=task.spec.key,
                        cause="error", category=category,
                        epoch=task.epoch, tries=task.tries)
            return
        cls = faults.CATEGORY_CLASSES.get(category, faults.FatalError)
        task.state = "error"
        task.error = cls(
            f"{task.spec.what}: executor task failed "
            f"[{msg.get('error', '?')}] {msg.get('message', '')}")

    # -- death & recovery ----------------------------------------------

    def _declare_dead(self, handle: ExecutorHandle, reason: str,
                      rc: Optional[int], emit_event: bool = True) -> None:
        """Idempotent executor-death path: fence + re-queue the in-flight
        tasks, record the dossier, recompute capacity, schedule the
        replacement. Runs from the watchdog, a reader EOF, or a failed
        send — first caller wins."""
        from blaze_tpu_torch.runtime import faults, trace

        now = time.monotonic()
        with self._cv:
            if handle.dead or self._closed:
                return
            handle.dead = True
            displaced = list(handle.inflight.values())
            handle.inflight.clear()
            self.deaths_total += 1
            recovery: Dict[str, str] = {}
            for task in displaced:
                self._running.pop(task.spec.key, None)
                if (task.death_requeues
                        < max(1, int(conf.executor_restart_max))):
                    task.death_requeues += 1
                    task.epoch = self.fence.advance(task.spec.key)
                    task.not_before = (
                        now + conf.retry_backoff_ms
                        * (2 ** (task.death_requeues - 1)) / 1000.0)
                    task.state = "queued"
                    task.executor = None
                    self._queue.append(task)
                    recovery[task.spec.key] = "re-queued"
                else:
                    task.state = "error"
                    task.error = faults.FatalError(
                        f"{task.spec.what}: lost to repeated executor "
                        f"deaths ({task.death_requeues} re-queues)")
                    recovery[task.spec.key] = "shed"
            self._graveyard.append(handle)
            restarts = self._seat_restarts.get(handle.seat, 0)
            will_respawn = restarts < int(conf.executor_restart_max)
            if will_respawn:
                self._seat_restarts[handle.seat] = restarts + 1
                self._respawns_pending += 1
                self._respawn_seats.add(handle.seat)
            self._cv.notify_all()
        self.watchdog.unregister(handle.token)
        if emit_event:
            # the watchdog path already emitted its executor_death event
            trace.event("executor_death", exec_id=handle.token,
                        pid=handle.pid, reason=reason, exit_code=rc)
        for task in displaced:
            if recovery.get(task.spec.key) == "re-queued":
                trace.event("executor_task_requeued", task=task.spec.key,
                            cause="executor_death", epoch=task.epoch)
        recovered = self._recover_sidecar(handle)
        self._capture_death_dossier(handle, reason, rc, displaced,
                                    recovery, now, recovered)
        self._notify_membership()
        if will_respawn:
            threading.Thread(
                target=self._respawn, args=(handle.seat, restarts,
                                            handle.generation + 1),
                name="blz-pool-respawn", daemon=True).start()
        else:
            trace.event("degrade", what="executor_retired",
                        exec_id=handle.exec_id, restarts=restarts)

    def _recover_sidecar(self, handle: ExecutorHandle) -> List[dict]:
        """Crash recovery for the telemetry plane: a SIGKILL'd worker's
        unshipped ring tail survives in its crash-atomic sidecar spill
        (written tmp+rename BEFORE every ship). Ingest it exactly once —
        the batch seq watermark skips a sidecar whose batch DID arrive
        over the socket before death — marking every recovered record
        truncated=true (the span stream ended mid-flight). Returns the
        recovered records for the death dossier."""
        path = os.path.join(self._dir, f"{handle.token}.telemetry")
        try:
            nbytes = os.path.getsize(path)
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return []
        if not isinstance(doc, dict):
            return []
        if int(doc.get("seq", 0)) <= handle.tel_seq:
            return []  # tail already shipped over the socket
        handle.tel_seq = int(doc.get("seq", 0))
        doc.setdefault("nbytes", nbytes)
        self._ingest_batch(handle, doc, truncated=True)
        return list(doc.get("records") or [])

    def _capture_death_dossier(self, handle: ExecutorHandle, reason: str,
                               rc: Optional[int], displaced, recovery,
                               now: float,
                               recovered: Optional[List[dict]] = None
                               ) -> None:
        if not conf.flight_dir:
            return
        from blaze_tpu_torch.runtime import flight_recorder

        signal_no = -rc if (rc is not None and rc < 0) else None
        # one dossier per kill: keyed on the executor GENERATION token,
        # so a seat's successive deaths each capture exactly once
        flight_recorder.capture(
            "executor_death", handle.token, detail={
                "exec_id": handle.exec_id,
                "seat": handle.seat,
                "generation": handle.generation,
                "pid": handle.pid,
                "reason": reason,
                "exit_code": rc,
                "signal": signal_no,
                "last_heartbeat_age_ms": round(
                    (now - handle.last_beat) * 1000),
                "tasks_in_flight": [t.spec.what for t in displaced],
                "recovery": recovery,
                "live_executors": self.live_count(),
                "capacity": self.capacity(),
                # the dead worker's own last spans as spilled (raw
                # worker-clock ts; clock_offset_ms above rebases them;
                # the driver ring holds the rebased truncated copies) —
                # bounded: a dossier is a summary, not a trace export
                "clock_offset_ms": round(
                    handle.clock_offset_ns / 1e6, 3),
                "executor_trace": list(recovered or [])[-200:],
            })


    def _respawn(self, seat: int, restarts: int, generation: int) -> None:
        backoff = (conf.executor_restart_backoff_ms
                   * (2 ** restarts) / 1000.0)
        time.sleep(backoff)
        with self._cv:
            if self._closed:
                self._respawns_pending -= 1
                self._respawn_seats.discard(seat)
                return
        self.restarts_total += 1
        self._spawn_pending(seat, generation)

    def _spawn_pending(self, seat: int, generation: int) -> None:
        """Start a scheduled replacement, then retire its pending count.
        The count drops only once `_spawn` has put the new process in
        `_awaiting`: a batch waiting in run_tasks with no live seat must
        always see the replacement as pending or awaiting its hello,
        never in between (the JAX package drops the count before the
        Popen, and on a loaded host run_tasks raised
        PoolUnavailableError in that window)."""
        try:
            self._spawn(seat, generation)
        finally:
            with self._cv:
                self._respawns_pending -= 1
                self._respawn_seats.discard(seat)
                self._cv.notify_all()

    # -- graceful decommission -----------------------------------------

    def decommission(self, seat: int) -> bool:
        """Driver-initiated graceful drain of one seat: the worker
        finishes its in-flight tasks (bounded by
        conf.executor_drain_grace_ms), flushes its telemetry sidecar and
        exits; the seat leaves capacity immediately but fires no
        executor_death. The seat is NOT respawned — decommission removes
        it (SIGTERM-initiated drains respawn, for rolling restarts)."""
        from blaze_tpu_torch.runtime import trace

        with self._cv:
            handle = self._seats.get(seat)
            if (handle is None or handle.dead or handle.draining
                    or self._closed):
                return False
            handle.draining = True
            handle.decommissioned = True
            self._cv.notify_all()
        self.watchdog.mark_draining(handle.token)
        trace.event("executor_drain", exec_id=handle.exec_id,
                    phase="begin", initiator="decommission",
                    inflight=len(handle.inflight))
        self._notify_membership()  # draining seats leave capacity now
        try:
            ss.send_msg(handle.conn, {"type": "drain"},
                        lock=handle.send_lock)
        except (ConnectionError, OSError):
            self._conn_broken(handle, handle.conn, "drain_send")
        return True

    def _on_draining(self, handle: ExecutorHandle) -> None:
        """Worker announced drain mode (SIGTERM delivered out-of-band,
        or echoing the driver's own drain order): mirror the
        decommission bookkeeping so the seat leaves capacity without a
        death — but respawn it once drained (a rolling restart wants
        the seat back). Then ack on the FIFO control socket: the ack
        is the drain BARRIER. A dispatch already holding send_lock
        lands its spec BEFORE the ack; once the flag is up no further
        spec may follow it, and the worker only samples idleness after
        reading the ack — so no spec can slip into a seat that is
        about to exit and get silently requeued."""
        from blaze_tpu_torch.runtime import trace

        with self._cv:
            if handle.dead or self._closed:
                return
            first = not handle.draining
            handle.draining = True
            self._cv.notify_all()
        if first:
            self.watchdog.mark_draining(handle.token)
            trace.event("executor_drain", exec_id=handle.exec_id,
                        phase="begin", initiator="sigterm",
                        inflight=len(handle.inflight))
        with handle.send_lock:
            acked, handle.drain_acked = handle.drain_acked, True
            if not acked:
                try:
                    ss.send_msg(handle.conn, {"type": "drain_ack"})
                except (ConnectionError, OSError):
                    pass  # broken conn: drain completes via EOF triage
        if first:
            self._notify_membership()

    def _finish_drain(self, handle: ExecutorHandle, msg: dict) -> None:
        """Drain completed (the worker's "drained" frame, its clean exit
        or its EOF): retire the seat with NO dossier and NO death
        accounting; re-queue any in-flight leftovers the grace period
        cut off (cause executor_drain — they consume no death budget)."""
        from blaze_tpu_torch.runtime import trace

        now = time.monotonic()
        with self._cv:
            if handle.dead or self._closed:
                return
            handle.dead = True
            handle.drained = True
            self.drains_total += 1
            self.drain_requeues_total += len(handle.inflight)
            leftovers = list(handle.inflight.values())
            handle.inflight.clear()
            for task in leftovers:
                self._running.pop(task.spec.key, None)
                task.epoch = self.fence.advance(task.spec.key)
                task.not_before = now
                task.state = "queued"
                task.executor = None
                self._queue.append(task)
            if self._seats.get(handle.seat) is handle:
                del self._seats[handle.seat]
            self._graveyard.append(handle)
            respawn = not handle.decommissioned
            if respawn:
                self._respawns_pending += 1
                self._respawn_seats.add(handle.seat)
            self._cv.notify_all()
        self.watchdog.unregister(handle.token)
        for task in leftovers:
            trace.event("executor_task_requeued", task=task.spec.key,
                        cause="executor_drain", epoch=task.epoch)
        self._recover_sidecar(handle)
        trace.event("executor_drain", exec_id=handle.exec_id,
                    phase="complete", initiator=("decommission"
                                                 if handle.decommissioned
                                                 else "sigterm"),
                    requeued=len(leftovers),
                    rids_returned=len(msg.get("rids") or []))
        self._notify_membership()
        if respawn:
            threading.Thread(
                target=self._respawn_drained,
                args=(handle.seat, handle.generation + 1),
                name="blz-pool-redrain", daemon=True).start()

    def _respawn_drained(self, seat: int, generation: int) -> None:
        """Replace a SIGTERM-drained seat (rolling restart): no backoff,
        no restart-budget charge — the drain was orderly, not a death."""
        with self._cv:
            if self._closed:
                self._respawns_pending -= 1
                self._respawn_seats.discard(seat)
                return
        self._spawn_pending(seat, generation)

    # -- membership / capacity -----------------------------------------

    def on_membership(self, cb: Callable[["ExecutorPool"], None]) -> None:
        with self._lock:
            self._membership_cbs.append(cb)

    def _notify_membership(self) -> None:
        with self._lock:
            cbs = list(self._membership_cbs)
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — listeners must not wedge us
                pass

    def live_handles(self) -> List[ExecutorHandle]:
        with self._lock:
            return [h for h in self._seats.values() if not h.dead]

    def live_count(self) -> int:
        return len(self.live_handles())

    def capacity(self) -> int:
        """Admission capacity: serving (live, non-draining) seats x
        slots. A draining seat finishes its in-flight work but accepts
        no new dispatch, so it leaves capacity the moment the drain
        begins — without firing executor_death."""
        with self._lock:
            serving = sum(1 for h in self._seats.values()
                          if not h.dead and not h.draining)
        return serving * self.slots

    def executors(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            return [{"exec_id": h.exec_id, "pid": h.pid,
                     "generation": h.generation, "up": not h.dead,
                     "draining": h.draining,
                     "conn_broken": h.conn_broken,
                     "reconnects": h.reconnects,
                     "inflight": len(h.inflight),
                     "heartbeat_age_ms": round(
                         (now - h.last_beat) * 1000),
                     "tasks_done": h.tasks_done,
                     "telemetry_bytes": h.tel_bytes,
                     "telemetry_records": h.tel_records,
                     "telemetry_dropped": h.tel_dropped,
                     "clock_offset_ms": round(h.clock_offset_ns / 1e6, 3)}
                    for h in self._seats.values()]

    def stats(self) -> dict:
        with self._lock:
            live = sum(1 for h in self._seats.values() if not h.dead)
            draining = sum(1 for h in self._seats.values()
                           if not h.dead and h.draining)
            inflight = sum(len(h.inflight) for h in self._seats.values())
            deaths, restarts = self.deaths_total, self.restarts_total
            reconnects, drains = self.reconnects_total, self.drains_total
            drain_requeues = self.drain_requeues_total
            done = self.tasks_done
            tel_bytes = self.telemetry_bytes_total
            tel_records = self.telemetry_records_total
            shuffle_dropped = self.server.conns_dropped
            count = self.count
        return {"count": count, "live": live,
                "draining": draining,
                "capacity": (live - draining) * self.slots,
                "slots": self.slots,
                "inflight": inflight, "deaths_total": deaths,
                "restarts_total": restarts,
                "reconnects_total": reconnects,
                "drains_total": drains,
                "drain_requeues_total": drain_requeues,
                "shuffle_conns_dropped": shuffle_dropped,
                "fenced_total": self.fence.fenced_total,
                "tasks_done": done,
                "telemetry_bytes_total": tel_bytes,
                "telemetry_records_total": tel_records}

    # -- dispatch ------------------------------------------------------

    def _pick_locked(self) -> Optional[tuple]:
        now = time.monotonic()
        # conn_broken seats keep their in-flight tasks (awaiting resume)
        # but take no NEW work; draining seats reject all new dispatch
        handles = [h for h in self._seats.values()
                   if not h.dead and not h.conn_broken and not h.draining
                   and len(h.inflight) < self.slots]
        if not handles:
            return None
        for i, task in enumerate(self._queue):
            if task.not_before <= now:
                handle = min(handles, key=lambda h: (len(h.inflight),
                                                     h.seat))
                self._queue.pop(i)
                task.state = "running"
                task.executor = handle
                handle.inflight[task.spec.key] = task
                self._running[task.spec.key] = task
                return task, handle
        return None

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                picked = self._pick_locked()
                while picked is None and not self._closed:
                    timeout = 0.05 if self._queue else None
                    self._cv.wait(timeout)
                    picked = self._pick_locked()
                if picked is None:
                    return  # closed
            task, handle = picked
            header = {"type": "task", "task": task.spec.key,
                      "epoch": task.epoch, "kind": task.spec.kind,
                      "payload": task.spec.payload}
            conn = handle.conn
            try:
                with handle.send_lock:
                    if handle.drain_acked:
                        # the drain barrier closed between pick and
                        # send: the ack is already on the wire, so this
                        # spec must not follow it (the worker may
                        # sample idle and exit any moment). Un-assign
                        # silently — the spec was never sent, so no
                        # epoch advance and no drain-requeue count.
                        with self._cv:
                            handle.inflight.pop(task.spec.key, None)
                            self._running.pop(task.spec.key, None)
                            task.state = "queued"
                            task.executor = None
                            self._queue.insert(0, task)
                            self._cv.notify_all()
                        continue
                    ss.send_msg(conn, header, task.spec.blob,
                                net_fault=ss.net_rule(
                                    "net.control.send"))
            except (ConnectionError, OSError):
                # broken pipe: triage connection-broken vs process-dead.
                # Either way the task is safe — it sits in
                # handle.inflight, re-sent on resume or re-queued on
                # death. (If the conn was swapped by a concurrent
                # resume, the resume already re-sent the inflight set,
                # this task included.)
                self._conn_broken(handle, conn, "send")

    # -- public task API -----------------------------------------------

    def run_tasks(self, specs: List[PoolTaskSpec],
                  timeout: Optional[float] = None) -> List[dict]:
        """Run a batch of tasks, returning their result messages in spec
        order. Raises the first task error (classified), or
        PoolUnavailableError when every executor seat is retired —
        callers degrade to the in-process runtime."""
        if not specs:
            return []
        from blaze_tpu_torch.runtime import faults

        tasks = [_PoolTask(spec, self.fence.advance(spec.key))
                 for spec in specs]
        deadline = (time.monotonic() + timeout) if timeout else None
        try:
            with self._cv:
                if self._closed:
                    raise RuntimeError("executor pool is closed")
                self._queue.extend(tasks)
                self._cv.notify_all()
                while True:
                    if all(t.finished for t in tasks):
                        break
                    if self._closed:
                        raise RuntimeError(
                            "executor pool closed mid-stage")
                    alive = any(not h.dead
                                for h in self._seats.values())
                    if (not alive and self._respawns_pending == 0
                            and not self._awaiting):
                        self._abandon_locked(tasks)
                        raise PoolUnavailableError(
                            "no live executors and no replacement "
                            "pending")
                    if (deadline is not None
                            and time.monotonic() > deadline):
                        self._abandon_locked(tasks)
                        raise faults.DeadlineError(
                            "executor pool stage timed out")
                    self._cv.wait(0.1)
            errs = [t for t in tasks if t.state == "error"]
            if errs:
                raise errs[0].error
            return [t.result for t in tasks]
        finally:
            # a straggler result after this point finds no fence entry
            # (missing key == epoch 0) and is rejected like any stale
            # attempt, so forgetting keeps the fence bounded per batch
            for spec in specs:
                self.fence.forget(spec.key)

    def _abandon_locked(self, tasks: List[_PoolTask]) -> None:
        """Drop a failed batch: unqueue its pending tasks and fence its
        running ones so straggler results are rejected."""
        for t in tasks:
            if t.state == "queued":
                try:
                    self._queue.remove(t)
                except ValueError:
                    pass
                t.state = "error"
                if t.error is None:
                    from blaze_tpu_torch.runtime import faults

                    t.error = faults.FaultError("sibling task failed")
            elif t.state == "running":
                self._running.pop(t.spec.key, None)
                if t.executor is not None:
                    t.executor.inflight.pop(t.spec.key, None)
                self.fence.advance(t.spec.key)  # fence the straggler

    # -- chaos / test hooks --------------------------------------------

    def hang_executor(self, seat: int, ms: int) -> bool:
        """Ask a worker to stop heartbeating (and defer sends) for `ms`
        without dying — the hung/zombie fault for the chaos soak."""
        with self._lock:
            handle = self._seats.get(seat)
        if handle is None or handle.dead:
            return False
        try:
            ss.send_msg(handle.conn, {"type": "hang", "ms": int(ms)},
                        lock=handle.send_lock)
            return True
        except (ConnectionError, OSError):
            return False

    def partition_executor(self, seat: int, ms: int) -> bool:
        """Simulate an ASYMMETRIC partition for `ms`: the worker keeps
        running but every worker->driver send fails (beats, results,
        telemetry, reconnect attempts) while driver->worker delivery
        still works. Past executor_death_ms the driver declares a
        heartbeat death (fencing the epoch) and the worker's lease
        expires (self-fence, exit code 17) — the two ends of the
        partition-tolerance contract, exercised deterministically."""
        with self._lock:
            handle = self._seats.get(seat)
        if handle is None or handle.dead:
            return False
        try:
            ss.send_msg(handle.conn, {"type": "partition",
                                      "ms": int(ms)},
                        lock=handle.send_lock)
            return True
        except (ConnectionError, OSError):
            return False

    def break_conn(self, seat: int) -> bool:
        """Sever one seat's control connection driver-side (transport
        blip, process untouched): the reader's EOF routes through
        _conn_broken and the worker's bounded reconnect + resume
        handshake must restore the seat without a death."""
        with self._lock:
            handle = self._seats.get(seat)
        if handle is None or handle.dead:
            return False
        try:
            # shutdown wakes BOTH ends' blocked reads immediately (a
            # bare close only errors future calls on this fd)
            handle.conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            handle.conn.close()
        except OSError:
            return False
        return True

    def pids(self) -> Dict[int, int]:
        with self._lock:
            return {h.seat: h.pid for h in self._seats.values()
                    if not h.dead}

    def busy_pids(self) -> Dict[int, int]:
        with self._lock:
            return {h.seat: h.pid for h in self._seats.values()
                    if not h.dead and h.inflight}

    # -- teardown ------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            handles = list(self._seats.values())
            graveyard = list(self._graveyard)
            for h in handles + graveyard:
                h.closing = True
            self._cv.notify_all()
        for h in handles:
            try:
                ss.send_msg(h.conn, {"type": "shutdown"},
                            lock=h.send_lock)
            except (ConnectionError, OSError):
                pass
        for h in handles:
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                try:
                    h.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    pass
        for h in graveyard:
            # a heartbeat-dead zombie may STILL be running: reap it now
            if h.proc is not None and h.proc.poll() is None:
                h.proc.kill()
                try:
                    h.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    pass
        for h in handles + graveyard:
            try:
                h.conn.close()
            except OSError:
                pass
        self.watchdog.close()
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        self.server.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        deactivate(self)


# ---------------------------------------------------------------------------
# Process-wide active pool (the local runner / service / monitor hook)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active_pool: Optional[ExecutorPool] = None


def activate(pool: ExecutorPool) -> ExecutorPool:
    global _active_pool
    with _active_lock:
        _active_pool = pool
    return pool


def deactivate(pool: Optional[ExecutorPool] = None) -> None:
    global _active_pool
    with _active_lock:
        if pool is None or _active_pool is pool:
            _active_pool = None


def active() -> Optional[ExecutorPool]:
    with _active_lock:
        return _active_pool


def pool_stats() -> Optional[dict]:
    """Monitor-facing snapshot: None when no pool is active (gauges are
    omitted entirely in that mode — the in-process runtime has no
    executor topology to report)."""
    pool = active()
    if pool is None:
        return None
    stats = pool.stats()
    stats["executors"] = pool.executors()
    return stats


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def _merge_counter_deltas(dst: Dict[str, dict],
                          src: Dict[str, dict]) -> None:
    """Fold freshly-drained monitor deltas into the worker's pending
    (unshipped) counters — a ship failure keeps pending populated, so
    successive drains must accumulate, not replace."""
    for qid, d in src.items():
        qd = dst.setdefault(qid, {})
        for sect, vals in d.items():
            s = qd.setdefault(sect, {})
            if sect == "stage_time_ns":
                for sk, cats in vals.items():
                    sc = s.setdefault(sk, {})
                    for cat, n in cats.items():
                        sc[cat] = sc.get(cat, 0) + n
            else:
                for k, n in vals.items():
                    s[k] = s.get(k, 0) + n


def _merge_hist_snaps(dst: Dict[str, dict], src: Dict[str, dict]) -> None:
    """Fold histogram snapshot deltas (bucket-count sums) into pending."""
    for name, s in src.items():
        cur = dst.get(name)
        if cur is None:
            dst[name] = dict(s)
            continue
        counts = list(cur.get("counts") or ())
        for i, n in enumerate(s.get("counts") or ()):
            if i < len(counts):
                counts[i] += n
            else:
                counts.append(n)
        cur["counts"] = counts
        cur["count"] = int(cur.get("count") or 0) + int(s.get("count") or 0)
        cur["total"] = int(cur.get("total") or 0) + int(s.get("total") or 0)
        for key, pick in (("min", min), ("max", max)):
            a, b = cur.get(key), s.get(key)
            cur[key] = b if a is None else (a if b is None else pick(a, b))


class _Worker:
    """Executor-process main object: control-socket loop + beat thread.
    Task handlers run on their own threads (the driver bounds concurrency
    at conf.executor_slots); heavy engine imports are deferred to the
    first plan task so protocol-only workers stay cheap."""

    # self-fence exit code: dossiers/logs distinguish "lease expired,
    # aborted my own work" from crashes and clean exits
    _LEASE_EXIT = 17
    # a sticky CUDA error poisoned this process's context: reply, then
    # exit so the seat respawns with a fresh one
    _POISONED_EXIT = 18

    def __init__(self) -> None:
        self.token = os.environ[_ENV_TOKEN]
        self.ctl_path = os.environ[_ENV_CTL]
        self.shuffle_path = os.environ.get(_ENV_SHUFFLE, "")
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.stop = threading.Event()
        # hang fault (chaos): beats stop and outbound sends stall until
        # this monotonic instant — the process neither exits nor beats
        self.hang_until = 0.0
        # asymmetric-partition fault (chaos): every outbound send raises
        # until this instant, while inbound delivery still works — the
        # deterministic trigger for lease-expiry self-fencing
        self.partition_until = 0.0
        # the lease: monotonic time of the last send that REACHED the
        # driver. No successful send for executor_death_ms means the
        # driver has (or will have) declared us dead and fenced our
        # epoch — commit nothing more, serve nothing stale, exit.
        self._lease_at = time.monotonic()
        # reentrant: _reconnect holds it across the retry ladder and
        # re-enters for _lease_deadline; it also guards sock/_lease_at
        # swaps so senders always read the freshest connection
        self._reconn_lock = threading.RLock()
        # resume-handshake dedupe: (task, epoch) currently executing,
        # plus a bounded cache of finished replies so a re-delivered
        # TaskSpec is answered from cache instead of re-executed
        self._task_lock = threading.Lock()
        self._task_running: set = set()
        self._task_done: "OrderedDict" = OrderedDict()
        self._draining = False
        self._engine_loaded = False
        # drain barrier: set when the driver's drain_ack frame arrives.
        # The control socket is FIFO, so once the reader has processed
        # the ack, every spec dispatched before the driver marked this
        # seat draining is already in _task_running — only then may
        # the drain sample idleness and exit.
        self._drain_ack = threading.Event()
        self._client: Optional[ss.ShuffleClient] = None
        self._client_lock = threading.Lock()
        self._rid_refs: Dict[str, int] = {}
        self._rid_lock = threading.Lock()
        # telemetry shipping state: pending holds drained-but-unshipped
        # records/counters (a failed send keeps them; the sidecar spill
        # already covers them on disk), seq is the batch watermark the
        # driver dedups sidecar recovery against
        self._tel_lock = threading.Lock()
        self._tel_seq = 0
        self._tel_pending: List[dict] = []
        self._tel_counters: Dict[str, dict] = {}
        self._tel_zerocopy: Dict[str, int] = {}
        self._tel_hists: Dict[str, dict] = {}
        self._tel_profile: List[list] = []
        self._tel_profile_last = 0.0  # last profiler drain (monotonic)
        self._tel_duty_mark = (0.0, 0.0)  # duty (cost, wall) shipped so far
        self._sidecar = os.path.join(os.path.dirname(self.ctl_path),
                                     f"{self.token}.telemetry")

    # -- plumbing ------------------------------------------------------

    def _send(self, header: dict, blob: bytes = b"") -> None:
        wait = self.hang_until - time.monotonic()
        if wait > 0:
            # a hung executor's results arrive LATE — after the driver
            # declared it dead and fenced its epoch
            time.sleep(wait)
        if time.monotonic() < self.partition_until:
            raise ConnectionError("partitioned (injected): driver "
                                  "unreachable")
        with self._reconn_lock:
            cur = self.sock
        ss.send_msg(cur, header, blob, lock=self.send_lock)
        with self._reconn_lock:
            self._lease_at = time.monotonic()

    # -- lease / reconnect / self-fence --------------------------------

    def _lease_deadline(self) -> float:
        """The lease expires executor_death_ms after the last send that
        reached the driver — mirroring the driver's heartbeat-staleness
        clock, so both ends give up on the SAME schedule. A hang (chaos)
        extends the lease to hang end: a truly wedged process could not
        run lease logic either, and the late-result zombie path must
        stay reachable for the driver-side fence to be tested."""
        death_s = max(int(conf.executor_death_ms), 1) / 1000.0
        with self._reconn_lock:
            lease_at = self._lease_at
        return max(lease_at, self.hang_until) + death_s

    def _self_fence(self, why: str) -> None:
        """Lease expired (or the control channel is unrecoverable):
        abort in-flight attempts, stop committing/serving, and exit with
        the fence code. The driver has fenced our epoch by now — any
        work we finished would be rejected anyway; dying fast wastes no
        compute and can never serve a stale read. The unshipped
        telemetry tail is spilled (not shipped — the driver is
        unreachable) so the death dossier recovers it."""
        from blaze_tpu_torch.runtime import trace

        with self._reconn_lock:
            lease_at = self._lease_at
        try:
            trace.event("lease_expired", exec_id=self.token, why=why,
                        lease_age_ms=round(
                            (time.monotonic() - lease_at) * 1000))
        except Exception:  # noqa: BLE001 — fencing must not fail
            pass
        try:
            self._flush_telemetry(ship=False)
        except Exception:  # noqa: BLE001
            pass
        self.stop.set()
        os._exit(self._LEASE_EXIT)

    def _reconnect(self, broken: Optional[socket.socket]) -> bool:
        """Bounded reconnect-and-resume after a transport error: a fast
        exponential ladder (conf.control_reconnect_max attempts, base
        conf.control_reconnect_backoff_ms), then slow probes until the
        LEASE decides. Returns True with self.sock swapped to the
        resumed connection, False when the lease expired first (the
        caller self-fences). The resume hello carries the token, pid and
        telemetry watermark; the driver re-sends our in-flight TaskSpecs
        which the dedupe cache absorbs."""
        with self._reconn_lock:
            if self.sock is not broken:
                return True  # another thread already resumed
            if self.stop.is_set():
                return False
            base = max(int(conf.control_reconnect_backoff_ms), 1) / 1000.0
            max_att = max(int(conf.control_reconnect_max), 1)
            attempt = 0
            while not self.stop.is_set():
                left = self._lease_deadline() - time.monotonic()
                if left <= 0:
                    return False
                delay = base * (2 ** min(attempt, max_att))
                time.sleep(min(delay, max(left, 0.001), 0.5))
                attempt += 1
                if time.monotonic() < self.partition_until:
                    continue  # injected partition: stay unreachable
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    s.connect(self.ctl_path)
                    ss.send_msg(s, {"type": "hello", "resume": True,
                                    "token": self.token,
                                    "pid": os.getpid(),
                                    "tel_seq": self._tel_seq,
                                    "mono_ns": time.monotonic_ns()})
                except OSError:
                    try:
                        s.close()
                    except OSError:
                        pass
                    continue
                old, self.sock = self.sock, s
                try:
                    old.close()
                except OSError:
                    pass
                self._lease_at = time.monotonic()
                return True
            return False

    def _beat_loop(self) -> None:
        period = max(int(conf.executor_heartbeat_ms), 10) / 1000.0
        while not self.stop.wait(period):
            now = time.monotonic()
            if now < self.hang_until:
                continue  # hung: silence, but stay alive
            if now < self.partition_until:
                # asymmetric partition: outbound is gone, the lease is
                # the only authority left on this side
                if now > self._lease_deadline():
                    self._self_fence("partition")
                continue
            with self._reconn_lock:
                cur = self.sock
            try:
                ss.send_msg(cur, {"type": "beat"}, lock=self.send_lock)
                with self._reconn_lock:
                    self._lease_at = time.monotonic()
            except (ConnectionError, OSError):
                if not self._reconnect(cur):
                    self._self_fence("beat send failed, lease expired")

    # -- telemetry shipping --------------------------------------------

    def _flush_telemetry(self, ship: bool = True) -> None:
        """Stage the unshipped ring tail + counter/histogram deltas,
        spill them crash-atomically to the sidecar, then ship ONE
        batched "telemetry" frame. Ordering matters twice: the spill
        lands BEFORE the send (a SIGKILL between the two loses nothing
        the driver can't recover), and _run_task flushes BEFORE each
        result send on the same socket (frames are processed in order,
        so the driver merges this batch's counters before the stage
        span that reads them closes). A failed send keeps the batch
        pending — same seq, retried next tick — so the driver's seq
        watermark stays exactly-once. ship=False spills WITHOUT
        sending (the self-fence path: the driver is unreachable, but
        the death dossier recovers the sidecar)."""
        from blaze_tpu_torch.runtime import monitor, profiler, trace

        if not (conf.trace_enabled or conf.monitor_enabled
                or conf.profile_enabled):
            return
        with self._tel_lock:
            self._tel_pending.extend(trace.TRACE.drain())
            _merge_counter_deltas(self._tel_counters,
                                  monitor.drain_remote_deltas())
            for k, v in monitor.drain_zerocopy().items():
                self._tel_zerocopy[k] = self._tel_zerocopy.get(k, 0) + v
            _merge_hist_snaps(self._tel_hists,
                              trace.histograms_snapshot(reset=True))
            if conf.profile_enabled:
                # profiler rows have no before-the-span-closes ordering
                # requirement (they merge by query id whenever), so only
                # the timer-paced ships and the fence/exit flush drain
                # them — NOT the flush that runs before every task
                # result, which must stay a no-op when trace/monitor
                # are off or profiling would tax each task with a
                # spill+ship
                now = time.monotonic()
                period_s = max(int(conf.telemetry_ship_ms), 10) / 1000.0
                if not ship or now - self._tel_profile_last >= period_s:
                    self._tel_profile.extend(profiler.drain_remote())
                    self._tel_profile_last = now
            if not (self._tel_pending or self._tel_counters
                    or self._tel_zerocopy or self._tel_hists
                    or self._tel_profile):
                return
            seq = self._tel_seq + 1
            doc = {"type": "telemetry", "seq": seq,
                   "records": self._tel_pending,
                   "counters": self._tel_counters,
                   "zerocopy": self._tel_zerocopy,
                   "histograms": self._tel_hists,
                   "profile": self._tel_profile,
                   "dropped": trace.TRACE.dropped,
                   "mono_ns": time.monotonic_ns()}
            if conf.profile_enabled:
                # duty ledger rides the frame as a watermarked delta so
                # the driver can prove the fleet-wide sampling overhead
                cost, wall = profiler.duty_snapshot()
                c0, w0 = self._tel_duty_mark
                if cost > c0 or wall > w0:
                    doc["profile_duty"] = {"cost_s": cost - c0,
                                           "wall_s": wall - w0}
                    self._tel_duty_mark = (cost, wall)
            payload = json.dumps(doc, default=str)
            doc["nbytes"] = len(payload)
            tmp = self._sidecar + ".tmp"
            try:
                with open(tmp, "w") as f:
                    f.write(payload)
                os.replace(tmp, self._sidecar)
            except OSError:
                pass  # spill is best-effort; the socket ship still runs
            if not ship:
                return  # fence path: the spill is the delivery
            try:
                self._send(doc)
            except (ConnectionError, OSError):
                return  # keep pending; beat loop notices a dead driver
            self._tel_seq = seq
            self._tel_pending = []
            self._tel_counters = {}
            self._tel_zerocopy = {}
            self._tel_hists = {}
            self._tel_profile = []

    def _ship_loop(self) -> None:
        period_ms = int(conf.telemetry_ship_ms)
        if period_ms <= 0:
            return  # timer disabled; results still carry their flush
        period = max(period_ms, 10) / 1000.0
        while not self.stop.wait(period):
            if time.monotonic() < self.hang_until:
                continue  # hung: the telemetry plane stalls with beats
            try:
                self._flush_telemetry()
            except Exception:  # noqa: BLE001 — never kill the worker
                pass

    def shuffle_client(self) -> ss.ShuffleClient:
        with self._client_lock:
            if self._client is None:
                self._client = ss.ShuffleClient(self.shuffle_path)
            return self._client

    # -- task handlers -------------------------------------------------

    def _acquire_rid(self, rid: str, provider) -> None:
        from blaze_tpu_torch.runtime import resources

        with self._rid_lock:
            n = self._rid_refs.get(rid, 0)
            self._rid_refs[rid] = n + 1
            if n == 0:
                resources.put(rid, provider)

    def _release_rid(self, rid: str) -> None:
        from blaze_tpu_torch.runtime import resources

        with self._rid_lock:
            n = self._rid_refs.get(rid, 1) - 1
            if n <= 0:
                self._rid_refs.pop(rid, None)
                resources.pop(rid)
            else:
                self._rid_refs[rid] = n

    def _run_plan(self, payload: dict, blob: bytes, epoch: int) -> dict:
        with self._task_lock:
            first, self._engine_loaded = not self._engine_loaded, True
        if not first:
            return self._run_plan_loaded(payload, blob, epoch, None)
        # the engine's import and the CUDA context hold the GIL for
        # seconds at a time: the driver widens this seat's heartbeat bound
        # until the first plan task is done (ExecutorPool._on_starting)
        self._send_quiet({"type": "starting"})
        try:
            return self._run_plan_loaded(payload, blob, epoch,
                                         time.perf_counter())
        finally:
            self._send_quiet({"type": "started"})

    def _send_quiet(self, header: dict) -> None:
        try:
            self._send(header)
        except (ConnectionError, OSError):
            pass  # a lost frame only narrows the heartbeat bound back

    def _run_plan_loaded(self, payload: dict, blob: bytes, epoch: int,
                         t_load) -> dict:
        """One plan task; `t_load` is the first plan task's start (its
        engine import and CUDA context are timed from it), else None."""
        from blaze_tpu_torch.device import resolve_device
        from blaze_tpu_torch.ops.base import ExecContext
        from blaze_tpu_torch.plan import plan_pb2 as pb
        from blaze_tpu_torch.runtime import artifacts, metrics
        from blaze_tpu_torch.runtime.executor import (
            run_pool_plan, task_metrics,
        )

        # the run's device rides the payload (the plan bytes carry none);
        # none named means the card, and no card raises here
        device = resolve_device(payload.get("device"))
        # the first plan task pays the engine's import and the CUDA
        # context; its reply reports that start-up once
        engine_start_s = None
        if t_load is not None:
            if device.type == "cuda":
                import torch

                torch.cuda.init()
            engine_start_s = time.perf_counter() - t_load

        node = pb.PlanNode()
        node.ParseFromString(blob)
        # the fence stamp: this attempt's artifacts land on epoch-named
        # files, so even a zombie's completed write can't collide with a
        # retried attempt's output
        data_path = artifacts.stamp_epoch(node.shuffle_writer.data_file,
                                          epoch)
        index_path = artifacts.stamp_epoch(node.shuffle_writer.index_file,
                                           epoch)
        node.shuffle_writer.data_file = data_path
        node.shuffle_writer.index_file = index_path
        client = self.shuffle_client()
        rids = list(payload.get("rids") or [])
        rid_parts = dict(payload.get("rid_parts") or {})
        rid_schemas = {rid: _decode_schema(s) for rid, s in
                       (payload.get("rid_schemas") or {}).items()}

        def frames_of(rid, fetched):
            # a shuffle's frames decode on the host with the schema its
            # map outputs were written with (the driver ships it), as the
            # in-process provider's do; broadcast frames go to the
            # reader as they are
            schema = rid_schemas.get(rid)
            if schema is None:
                return iter(fetched)
            from blaze_tpu_torch.columnar import serde

            return (serde.deserialize_batch_host(f, schema)
                    for f in fetched)

        def make_provider(rid):
            # exactly one positional param: _call_provider passes the
            # task partition to 1-arg providers (a default-arg closure
            # would be miscounted as 2-arg and handed num_partitions)
            if rid.endswith(":all"):
                # build-side whole-relation read: chain every partition
                # of the base rid (count shipped in the payload: the
                # server registers outputs under the base rid only)
                base = rid[:-len(":all")]
                nparts = int(rid_parts.get(rid, 0))

                def provider(partition):
                    for p in range(nparts):
                        yield from frames_of(rid,
                                             client.fetch_frames(base, p))
                return provider

            def provider(partition):
                # fetch_frames prefers the same-host zero-copy mmap path
                # (memoryview slices of the committed .data file) and
                # falls back to the socket stream transparently
                return frames_of(rid, client.fetch_frames(rid, partition))
            return provider

        for rid in rids:
            self._acquire_rid(rid, make_provider(rid))
        try:
            ctx = ExecContext(partition=int(payload.get("partition", 0)),
                              num_partitions=int(
                                  payload.get("num_partitions", 1)),
                              device=device)
            # the in-process resilience ladder runs INSIDE the worker:
            # transient faults retry here before costing the driver a
            # cross-process re-queue (runtime/executor.run_pool_plan);
            # the tally counts this task's kernel launches alone, on
            # whichever thread they run
            with metrics.task_tally() as tally:
                op = run_pool_plan(node, ctx,
                                   what=payload.get("what", "pool_plan"))
            logical = int(op.metrics.values.get("shuffle_logical_bytes",
                                                0))
            out = {"data_path": data_path, "index_path": index_path,
                   "logical_bytes": logical,
                   "task_metrics": task_metrics(op),
                   "kernel_launches": int(tally.get("kernel_launches", 0))}
            if engine_start_s is not None:
                out["engine_start_s"] = engine_start_s
            return out
        finally:
            for rid in rids:
                self._release_rid(rid)

    def _run_flaky(self, payload: dict) -> dict:
        """Test handler: fail the first `times` attempts (counted in a
        driver-provided file so the count survives this process dying),
        then succeed."""
        from blaze_tpu_torch.runtime import faults

        marker = payload["marker"]
        n = 0
        try:
            with open(marker, "r") as f:
                n = int(f.read().strip() or 0)
        except (OSError, ValueError):
            n = 0
        if n < int(payload.get("times", 1)):
            with open(marker, "w") as f:
                f.write(str(n + 1))
            cls = faults.CATEGORY_CLASSES.get(
                payload.get("category", "retryable"), faults.FatalError)
            raise cls(f"flaky task (attempt {n + 1})")
        return {"attempts_failed": n}

    def _run_task(self, msg: dict, blob: bytes) -> None:
        from blaze_tpu_torch.runtime import monitor, trace

        key, epoch = msg.get("task", ""), int(msg.get("epoch", 0))
        kind = msg.get("kind", "")
        payload = msg.get("payload") or {}
        # replay the driver-issued correlation ids: every worker-side
        # record (the task_attempt span, nested events, counter
        # attribution) then carries the same query/stage/task ids the
        # driver's records do — the federation join key
        ids = {k: payload.get(k) for k in trace.ID_KEYS
               if payload.get(k) is not None}
        if ids.get("query_id"):
            monitor.ensure_query(ids["query_id"])
        try:
            with trace.context(**ids):
                with trace.span("task_attempt",
                                attempt_id=f"{key}#e{epoch}",
                                pool_kind=kind,
                                what=payload.get("what", key)):
                    if kind == "plan":
                        result = self._run_plan(payload, blob, epoch)
                    elif kind == "echo":
                        result = {"value": payload.get("value")}
                    elif kind == "sleep":
                        end = (time.monotonic()
                               + float(payload.get("ms", 0)) / 1e3)
                        while (time.monotonic() < end
                               and not self.stop.is_set()):
                            time.sleep(0.01)
                        result = {}
                    elif kind == "flaky":
                        result = self._run_flaky(payload)
                    else:
                        raise ValueError(f"unknown task kind: {kind}")
        except BaseException as e:  # noqa: BLE001 — classified + relayed
            from blaze_tpu_torch.runtime import faults

            reply = {"type": "result", "task": key, "epoch": epoch,
                     "ok": False, "category": faults.classify(e),
                     "error": type(e).__name__,
                     "message": str(e)[:500]}
            self._finish_task(key, epoch, reply)
            if _poisons_context(e):
                self._exit_poisoned(e)
            return
        reply = {"type": "result", "task": key, "epoch": epoch,
                 "ok": True}
        reply.update(result)
        self._finish_task(key, epoch, reply)

    def _finish_task(self, key: str, epoch: int, reply: dict) -> None:
        """Cache the reply (resume-handshake dedupe: a re-delivered spec
        is answered from here instead of re-executed), flush telemetry
        BEFORE the result — same socket, in-order processing, so the
        driver has this task's spans/counters federated before the
        stage span that reads them closes — then send. A send that
        fails is NOT a loss: the reply stays cached, and the driver's
        resume handshake re-delivers the spec, which replays it."""
        with self._task_lock:
            self._task_running.discard((key, epoch))
            self._task_done[(key, epoch)] = reply
            while len(self._task_done) > 64:
                self._task_done.popitem(last=False)
        self._flush_telemetry()
        try:
            self._send(reply)
        except (ConnectionError, OSError):
            pass

    def _exit_poisoned(self, exc: BaseException) -> None:
        """Leave after a sticky CUDA error (port only: XLA on a TPU has no
        context a failed launch can poison). Every later launch in this
        process would fail, so it serves no further task: the reply is
        sent, the telemetry tail spilled, and the process exits nonzero;
        the driver's watchdog sees the exit and respawns the seat."""
        import sys as _sys

        try:
            _sys.stderr.write(f"executor {self.token}: CUDA context "
                              f"poisoned ({type(exc).__name__}: {exc}); "
                              "exiting\n")
            _sys.stderr.flush()
            self._flush_telemetry(ship=False)
        except Exception:  # noqa: BLE001 — the exit must happen
            pass
        self.stop.set()
        os._exit(self._POISONED_EXIT)

    def _dispatch_task(self, msg: dict, blob: bytes) -> None:
        """Dedupe-by-(task_id, epoch) in front of execution: a spec
        re-delivered by the resume handshake (or a dup-delivery wire
        fault) executes ONCE — finished work replies from the result
        cache, running work stays single-flight."""
        key = (msg.get("task", ""), int(msg.get("epoch", 0)))
        with self._task_lock:
            cached = self._task_done.get(key)
            if cached is None and key in self._task_running:
                return  # already executing: its reply will cover this
            if cached is None:
                self._task_running.add(key)
        if cached is not None:
            try:
                self._send(cached)
            except (ConnectionError, OSError):
                pass  # stays cached; the next re-delivery replays it
            return
        threading.Thread(target=self._run_task, args=(msg, blob),
                         name="blz-wk-task", daemon=True).start()

    def _begin_drain(self, initiator: str) -> None:
        """Enter drain mode (driver's drain order or SIGTERM): announce
        "draining" (so the driver reassigns capacity without a death),
        finish in-flight tasks bounded by conf.executor_drain_grace_ms,
        flush the telemetry sidecar, hand the registered shuffle rids
        back, send "drained", exit 0."""
        with self._task_lock:
            if self._draining:
                return
            self._draining = True
        try:
            self._send({"type": "draining", "initiator": initiator})
        except (ConnectionError, OSError):
            pass  # the driver learns from our exit instead
        threading.Thread(target=self._drain_and_exit,
                         name="blz-wk-drain", daemon=True).start()

    def _drain_and_exit(self) -> None:
        grace = max(int(conf.executor_drain_grace_ms), 0) / 1000.0
        # drain barrier: wait for the driver's ack before sampling
        # idleness, so a spec the driver sent just before it marked us
        # draining cannot land after the idle check and die with the
        # process. Bounded: a broken conn (or a driver that never
        # acks) must not wedge the drain.
        self._drain_ack.wait(min(grace, 2.0))
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            with self._task_lock:
                idle = not self._task_running
            if idle:
                break
            time.sleep(0.01)
        try:
            self._flush_telemetry()
        except Exception:  # noqa: BLE001 — the drain must complete
            pass
        with self._rid_lock:
            rids = sorted(self._rid_refs)
        try:
            self._send({"type": "drained", "rids": rids})
        except (ConnectionError, OSError):
            pass  # EOF tells the driver the same thing
        self.stop.set()
        os._exit(0)

    # -- main loop -----------------------------------------------------

    def run(self) -> int:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(self.ctl_path)
        with self._reconn_lock:
            self.sock = sock
        ss.send_msg(sock, {"type": "hello", "token": self.token,
                           "pid": os.getpid(),
                           # clock echo: the driver estimates this
                           # worker's monotonic offset from it
                           "mono_ns": time.monotonic_ns()},
                    lock=self.send_lock)
        beat = threading.Thread(target=self._beat_loop, name="blz-wk-beat",
                                daemon=True)
        beat.start()
        ship = threading.Thread(target=self._ship_loop, name="blz-wk-ship",
                                daemon=True)
        ship.start()
        try:
            while not self.stop.is_set():
                with self._reconn_lock:
                    cur = self.sock
                try:
                    msg, blob = ss.recv_msg(cur)
                except (ConnectionError, OSError):
                    # transport error, not an order to die: bounded
                    # reconnect + resume, self-fence once the lease says
                    # the driver side has already buried us
                    if self._reconnect(cur):
                        continue
                    self._self_fence("control recv failed, lease "
                                     "expired")
                    break
                mtype = msg.get("type")
                if mtype == "task":
                    self._dispatch_task(msg, blob)
                elif mtype == "ping":
                    self._send({"type": "pong"})
                elif mtype == "hang":
                    self.hang_until = (time.monotonic()
                                       + int(msg.get("ms", 0)) / 1000.0)
                elif mtype == "partition":
                    self.partition_until = (
                        time.monotonic() + int(msg.get("ms", 0)) / 1000.0)
                elif mtype == "drain":
                    self._begin_drain("drain_msg")
                elif mtype == "drain_ack":
                    self._drain_ack.set()
                elif mtype == "shutdown":
                    break
        finally:
            try:
                # last chance to ship buffered telemetry on a clean
                # shutdown (send errors are swallowed inside)
                self._flush_telemetry()
            except Exception:  # noqa: BLE001 — teardown must proceed
                pass
            self.stop.set()
            with self._client_lock:
                client, self._client = self._client, None
            if client is not None:
                client.close()
            with self._reconn_lock:
                cur = self.sock
            try:
                cur.close()
            except OSError:
                pass
        return 0


def _decode_schema(b64: str):
    """A schema shipped in a payload (base64 of its plan.proto bytes)."""
    import base64

    from blaze_tpu_torch.plan import plan_pb2 as pb
    from blaze_tpu_torch.plan.from_proto import decode_schema

    msg = pb.Schema()
    msg.ParseFromString(base64.b64decode(b64))
    return decode_schema(msg)


def _poisons_context(exc: BaseException) -> bool:
    """A sticky CUDA error (illegal address, launch failure, device-side
    assert, ...): faults.classify calls it fatal by the same markers."""
    from blaze_tpu_torch.runtime import faults

    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in faults._CUDA_FATAL_MARKERS)


def _worker_main() -> int:
    overrides = os.environ.get(_ENV_CONF, "")
    if overrides:
        for name, value in json.loads(overrides).items():
            if name in KNOBS:
                setattr(conf, name, value)
    if conf.profile_enabled:
        # the worker samples its own threads; folded-stack deltas ship
        # driver-ward with _flush_telemetry (sidecar-recoverable)
        from blaze_tpu_torch.runtime import profiler

        profiler.ensure_started()
    worker = _Worker()
    # SIGTERM is a decommission order, not a kill: drain in-flight work,
    # flush telemetry, hand shuffle rids back, then exit 0.
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: worker._begin_drain("sigterm"))
    return worker.run()


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(_worker_main())
    sys.exit("executor_pool is a library; run with --worker as a pool "
             "child process")
