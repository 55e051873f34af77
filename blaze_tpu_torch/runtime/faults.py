"""Fault injection, the error taxonomy and resilience telemetry.

Port of blaze_tpu/runtime/faults.py, whole. Failure is a relayed,
retried, ordinary event: every error is classified, and the supervisor's
ladder (runtime/executor.run_task_with_resilience) retries, degrades or
reroutes by category. The module has three parts:

  taxonomy   RetryableError / ResourceExhaustedError / PlanError /
             FatalError, with `classify()` mapping raw errors onto it.
             The card's errors map the way the JAX package maps XLA's:
             `torch.cuda.OutOfMemoryError` (and any "out of memory"
             message) is "resource", so the degradation ladder sheds
             load; a CUDA launch failure, an illegal address or a
             device-side assert is "fatal", because such an error is
             sticky and poisons the CUDA context for every thread, so a
             fresh attempt on it cannot succeed.

  injection  named points at operator batch boundaries, serde
             encode/decode, spill write/read, device put/get, the pipeline
             hand-off and the shuffle commit. Enabled ONLY through
             `conf.fault_injection_spec`; with the spec empty a point costs
             one attribute load and a truthiness check. Per point: fire on
             the nth call, fail the first N calls, or fire with
             probability p from a per-point rng seeded by (spec seed,
             point), so a schedule replays bit-identically for one seed
             however points interleave; the seeds and schedule are the JAX
             package's, bit for bit. The kind "stall" HANGS at the point
             (a kill-interruptible sleep bounded by rule "ms") instead of
             raising: the trigger of the supervisor's hang detection and
             speculation. While a spec without {"concurrent": true} is
             armed, the supervisor runs one task at a time and the
             pipeline runs inline, so thread timing cannot reorder the
             schedule.

  telemetry  process-global counters (faults injected, retries,
             degradations, fallbacks, errors by category), with per-run
             deltas copied into the local runner's run_info.

Spec shape:

    conf.fault_injection_spec = {
        "seed": 7,
        "points": {
            "serde.encode":  {"kind": "io",  "nth": 3},
            "spill.write":   {"kind": "oom", "prob": 0.2},
            "op.FilterExec": {"kind": "retryable", "fail_times": 2},
            "op":            {"kind": "oom", "nth": 5},   # any operator
        },
    }

Install specs through `install()`, which resets the schedule. Point names
are hierarchical: a rule for "op" matches "op.FilterExec". The wire-level
`net.*` points act at the socket operations of runtime/shuffle_server.py
and runtime/executor_pool.py, through shuffle_server.NET_HOOK.
"""

from __future__ import annotations

import errno
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import trace
from blaze_tpu_torch.runtime.metrics import MetricNode, MetricsSet

# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of the engine's classified errors. `category` drives the
    executor's resilience ladder; `injected` marks chaos-harness faults."""

    category = "fatal"
    injected = False
    point: Optional[str] = None


class RetryableError(FaultError):
    """Transient: a bounded retry with backoff is expected to succeed
    (lost device tunnel round trip, interrupted I/O, flaky fetch)."""

    category = "retryable"


class ResourceExhaustedError(RetryableError):
    """Device/host memory pressure: retryable only after shedding load —
    the degradation ladder (halve batch -> force spill -> CPU fallback)
    applies, not a plain retry."""

    category = "resource"


class HungError(RetryableError):
    """A supervisor watchdog kill-on-suspicion: the attempt's heartbeat
    went stale past conf.hang_detect_ms. Retryable, but budgeted
    SEPARATELY from error retries in the ladder — the attempt did not
    fail, it was killed, and a false positive (a long jit compile
    between batch boundaries) must not consume the task's real retry
    budget. Relaunches skip the backoff sleep for the same reason."""


class CorruptArtifactError(RetryableError):
    """A committed artifact failed checksum verification (bit flip, torn
    write that survived fsync, truncation). Retryable by taxonomy — the
    artifact layer quarantines the file and re-executes the producing
    map task under a fresh epoch (runtime/artifacts.handle_corruption),
    so a retry reads the repaired lineage, not the poison."""


class PlanError(FaultError, NotImplementedError):
    """Deterministic plan-shape failure (unsupported operator/expression,
    malformed plan): retrying is pointless, rerouting to the fallback
    interpreter may not be. Subclasses NotImplementedError so existing
    callers that probe for unsupported-feature errors keep working."""

    category = "plan"


class FatalError(FaultError):
    """Non-retryable engine/runtime failure; relayed upward unchanged."""

    category = "fatal"


class DeadlineError(FatalError):
    """A task/query wall-clock budget (conf.task_deadline_ms /
    conf.query_deadline_ms) was exhausted. Fatal by construction: there
    is no time left to retry in — a retryable failure that runs out of
    budget is RECLASSIFIED to this (the executor's deadline-clamped
    backoff), so callers see "deadline", not a half-slept retry."""


class AdmissionRejected(FatalError):
    """Load shed at the QueryService front door: the admission queue was
    full (or the query's deadline expired while parked). The query never
    ran — no partial state to clean up, nothing to retry locally; callers
    should back off and resubmit. Carries the tenant id and the wall time
    the query spent parked so SLO accounting can bill the shed."""

    def __init__(self, msg: str, *, tenant_id: str = "",
                 wait_ms: float = 0.0) -> None:
        super().__init__(msg)
        self.tenant_id = tenant_id
        self.wait_ms = wait_ms


class StaleAttemptError(FaultError):
    """An epoch-fenced attempt lost: a newer attempt of the same task was
    dispatched (its executor was declared dead) and the fence advanced
    past this attempt's epoch. Classified "killed" — like losing the
    first-commit-wins speculation race, the attempt did not fail and must
    not be retried or counted against any budget; its output is simply
    discarded (runtime/artifacts.EpochFence)."""

    category = "killed"


CATEGORY_CLASSES = {
    "retryable": RetryableError,
    "resource": ResourceExhaustedError,
    "plan": PlanError,
    "fatal": FatalError,
}

# wire codes shared with the C ABI (bn_last_error_category); keep in sync
# with the JAX package's native/include/blaze_native.h
NATIVE_CATEGORY_CODES = {
    "none": 0, "retryable": 1, "resource": 2, "plan": 3, "fatal": 4,
    "killed": 5,
}
NATIVE_CODE_CATEGORIES = {v: k for k, v in NATIVE_CATEGORY_CODES.items()}

_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM",
    "Resource exhausted", "failed to allocate", "Allocation failure",
    "Attempting to allocate",
)
_TRANSIENT_MARKERS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "Connection reset",
    "Socket closed", "connection closed", "transient",
    "temporarily unavailable",
)
# sticky CUDA errors (cudaErrorIllegalAddress, cudaErrorLaunchFailure,
# cudaErrorAssert, misaligned or illegal instructions) and the accumulate
# chain's own launch failure: after one the context is poisoned, so they
# are fatal, never retried as a fresh attempt
_CUDA_FATAL_MARKERS = (
    "illegal memory access", "unspecified launch failure",
    "device-side assert", "misaligned address", "illegal instruction",
    "launch failed", "CUDA error: an illegal",
)
_TRANSIENT_ERRNOS = {errno.EINTR, errno.EAGAIN, errno.EIO, errno.ETIMEDOUT,
                     errno.ECONNRESET, errno.EPIPE, errno.ENETRESET,
                     errno.ECONNABORTED}


def classify(exc: BaseException) -> str:
    """Map any exception onto a taxonomy category name.

    "killed" (task-kill cooperation) is its own category: never retried,
    never wrapped — the embedding layer asked for the interruption."""
    from blaze_tpu_torch.ops.base import TaskKilledError

    if isinstance(exc, TaskKilledError):
        return "killed"
    if isinstance(exc, FaultError):
        return exc.category
    if isinstance(exc, MemoryError) or _is_device_oom(exc):
        return "resource"
    msg = str(exc)
    if any(m in msg for m in _CUDA_FATAL_MARKERS):
        # sticky: the CUDA context is poisoned for every thread
        return "fatal"
    if any(m in msg for m in _OOM_MARKERS):
        return "resource"
    if isinstance(exc, OSError):
        if exc.errno in _TRANSIENT_ERRNOS:
            return "retryable"
        return "fatal"
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return "retryable"
    if isinstance(exc, NotImplementedError):
        return "plan"
    return "fatal"


def _is_device_oom(exc: BaseException) -> bool:
    """A torch device OOM, tested by type (`torch.cuda.OutOfMemoryError`,
    a RuntimeError whose message is the caching allocator's)."""
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def ensure_classified(exc: BaseException) -> BaseException:
    """Wrap an exhausted-recovery error into its taxonomy class.

    Fatal stays UNWRAPPED: a ValueError a test (or an embedder) matches on
    must keep its type — classification there is observational (counters,
    bn_last_error_category), not a type change."""
    if isinstance(exc, FaultError):
        return exc
    cat = classify(exc)
    cls = CATEGORY_CLASSES.get(cat)
    if cls is None or cat == "fatal":
        return exc
    wrapped = cls(f"{type(exc).__name__}: {exc}")
    wrapped.__cause__ = exc
    return wrapped


# ---------------------------------------------------------------------------
# Injection registry
# ---------------------------------------------------------------------------

# every instrumented point (prefixes; "op" covers "op.<OperatorName>").
# tools/chaos_soak.py sweeps this list.
KNOWN_POINTS = (
    "op",
    "serde.encode",
    "serde.decode",
    "spill.write",
    "spill.read",
    "jit.compile",
    "device.put",
    "device.get",
    "exchange.stage",
    "shuffle.commit",
    # pipeline queue hand-off (runtime/pipeline.py): fires on the I/O
    # pool thread right before a produced item crosses to the consumer,
    # so chaos proves pool-thread errors relay classified across the
    # queue. Serial (pipelining gated off) it fires inline instead —
    # armed specs without {"concurrent": true} disable the pipeline.
    "io.prefetch",
    # network fault points (wire-level, fired through net_rule() at the
    # socket boundary in runtime/shuffle_server.send_msg/recv_msg and
    # the executor control channel — NOT through inject(), so the
    # generic io/oom sweeps arm them to no effect; tools/chaos_soak.py
    # --network sweeps them with the NET_KINDS below):
    "net.control.send",    # driver -> executor control-socket sends
    "net.control.recv",    # driver <- executor control-socket reads
    "net.shuffle.fetch",   # shuffle server segment-reply path
    "net.telemetry",       # executor telemetry-batch ingest
)

# wire-level fault kinds (net.* points only): applied AT the socket
# operation instead of raising a taxonomy error — the transport layer
# must absorb them (reconnect/resume, retry ladders, CRC detection).
NET_KINDS = (
    "delay",       # sleep rule "ms" (default 25) before the op
    "reset",       # ConnectionResetError at the op
    "blackhole",   # stall rule "ms" (default 2000), then drop the conn
    "torn",        # partial write then reset / WireError on read
    "dup",         # duplicate delivery of the frame/message
)

# corruption points (kind "corrupt" ONLY, fired through maybe_corrupt):
# each bit-flips one byte of an already-COMMITTED artifact, modelling a
# latent media error rather than a failing call — so they live outside
# KNOWN_POINTS (the io/oom/stall sweeps would arm them to no effect).
# tools/chaos_soak.py --durability sweeps this list.
CORRUPT_POINTS = (
    "corrupt.shuffle_data",
    "corrupt.shuffle_index",
    "corrupt.spill",
)

_counters: Dict[str, int] = {}
_rngs: Dict[str, random.Random] = {}
injection_log: List[Tuple[str, int]] = []  # (point, per-rule call index)
_default_jitter = random.Random()
_sleep = time.sleep  # patchable in tests
# schedule state is shared by every task thread under the supervisor's
# pool: the lock keeps per-rule call counts exact (a lost increment would
# silently shift an nth/fail_times schedule)
_sched_lock = threading.Lock()

TELEMETRY = MetricsSet()
TELEMETRY.reset()  # drop the operator-stream defaults; counters only


def install(spec: Optional[dict]) -> None:
    """Set `conf.fault_injection_spec` and reset the deterministic
    schedule state (per-point counters, rngs, the injection log)."""
    conf.fault_injection_spec = spec or {}
    reset()


def reset() -> None:
    """Restart the injection schedule (counters/rngs/log) for the current
    spec; same seed => bit-identical schedule on replay. Also (un)arms
    the wire-fault seam: shuffle_server.NET_HOOK points at net_rule only
    while the spec arms a net.* point, so the disabled-path cost at the
    socket layer is one module-global load."""
    with _sched_lock:
        _counters.clear()
        _rngs.clear()
        injection_log.clear()
        spec = conf.fault_injection_spec or {}
        seed = spec.get("seed")
        if seed is not None:
            _rngs["__jitter__"] = random.Random(_mix(seed, "__jitter__"))
    from blaze_tpu_torch.runtime import shuffle_server

    armed = any(p.startswith("net.")
                for p in (spec.get("points") or {}))
    shuffle_server.NET_HOOK = net_rule if armed else None


def reset_telemetry() -> None:
    # MetricsSet.reset() clears under the adders' lock: a bare
    # values.clear() racing a pool-thread add() could resurrect a stale
    # key mid-clear (the add's read-modify-write straddling the clear)
    TELEMETRY.reset()


def _mix(seed, key: str) -> int:
    h = 1469598103934665603  # FNV-1a over the key, folded with the seed
    for b in key.encode():
        h = ((h ^ b) * 1099511628211) & ((1 << 64) - 1)
    return (h ^ (int(seed) * 0x9E3779B97F4A7C15)) & ((1 << 64) - 1)


def _rule_for(points: dict, point: str):
    """Longest-prefix rule lookup over dot-separated point names."""
    p = point
    while True:
        rule = points.get(p)
        if rule is not None:
            return p, rule
        i = p.rfind(".")
        if i < 0:
            return None, None
        p = p[:i]


def _schedule_fire(spec: dict, point: str, key: str, rule: dict
                   ) -> Tuple[bool, int]:
    """Advance `key`'s deterministic schedule one call and decide whether
    the rule fires; appends fired calls to the injection log. Shared by
    inject() and maybe_corrupt() so both kinds replay bit-identically."""
    with _sched_lock:
        n = _counters[key] = _counters.get(key, 0) + 1
        if "nth" in rule:
            fire = n == int(rule["nth"])
        elif "fail_times" in rule:
            fire = n <= int(rule["fail_times"])
        elif "prob" in rule:
            rng = _rngs.get(key)
            if rng is None:
                rng = _rngs[key] = random.Random(
                    _mix(spec.get("seed", 0), key))
            fire = rng.random() < float(rule["prob"])
        else:
            fire = True
        if fire:
            injection_log.append((point, n))
    return fire, n


def inject(point: str) -> None:
    """Raise a classified fault at `point` if the active spec says so.

    Disabled path (empty spec — production): one truthiness check."""
    spec = conf.fault_injection_spec
    if not spec:
        return
    points = spec.get("points")
    if not points:
        return
    key, rule = _rule_for(points, point)
    if rule is None or rule.get("kind") == "corrupt":
        return  # "corrupt" rules only act through maybe_corrupt()
    fire, n = _schedule_fire(spec, point, key, rule)
    if not fire:
        return
    TELEMETRY.add("faults_injected", 1)
    TELEMETRY.add(f"injected.{key}", 1)
    kind = rule.get("kind", "retryable")
    trace.event("fault_injected", point=point, call=n, fault_kind=kind)
    if kind == "stall":
        _stall(point, n, rule)
        return
    cls = {"io": RetryableError, "oom": ResourceExhaustedError}.get(
        kind) or CATEGORY_CLASSES.get(kind, RetryableError)
    exc = cls(f"injected fault at {point} (call #{n}, kind={kind})")
    exc.injected = True
    exc.point = point
    raise exc


def net_rule(point: str) -> Optional[dict]:
    """Decide whether a wire-level fault fires at net.* `point`; returns
    the armed rule dict (kind/ms/...) for the transport layer to apply
    at the exact socket operation, else None. Shares inject()'s
    deterministic schedule (same seed => same wire chaos) but never
    raises itself — delay/reset/blackhole/torn/dup are properties of
    the wire, not taxonomy errors, so the socket layer enacts them.
    Reaches the socket call sites through shuffle_server.NET_HOOK,
    which reset() arms only while a spec targets a net.* point."""
    spec = conf.fault_injection_spec
    if not spec:
        return None
    points = spec.get("points")
    if not points:
        return None
    key, rule = _rule_for(points, point)
    if rule is None or rule.get("kind") not in NET_KINDS:
        return None
    fire, n = _schedule_fire(spec, point, key, rule)
    if not fire:
        return None
    TELEMETRY.add("faults_injected", 1)
    TELEMETRY.add(f"injected.{key}", 1)
    trace.event("fault_injected", point=point, call=n,
                fault_kind=rule.get("kind"))
    return dict(rule)


def _stall(point: str, n: int, rule: dict) -> None:
    """The "stall" injection kind: HANG at the armed point instead of
    raising — the deterministic stand-in for a stuck native call or a
    wedged JIT compile that the supervisor's hang detection / straggler
    speculation must absorb. The sleep is cooperative: it
    polls the supervising attempt's kill flag every few ms, so a
    watchdog cancel interrupts the stall as TaskKilledError exactly the
    way a batch-boundary check would; with no supervisor the stall ends
    after rule "ms" (default 30s) and execution continues unharmed — a
    stall is a delay, not an error."""
    from blaze_tpu_torch.ops.base import TaskKilledError

    TELEMETRY.add("stalls_injected", 1)
    ms = float(rule.get("ms", 30_000.0))
    deadline = time.monotonic() + ms / 1000.0
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        step = min(0.005, remaining)
        ev = None
        try:  # lazy: supervisor imports faults
            from blaze_tpu_torch.runtime import supervisor

            ev = supervisor.current_kill_event()
        except Exception:  # noqa: BLE001 — stall must never crash a task
            pass
        if ev is None:
            _sleep(step)
        elif ev.wait(step):
            raise TaskKilledError(
                f"stalled attempt killed at {point} (call #{n})")


def maybe_corrupt(point: str, path: str) -> bool:
    """Bit-flip one byte of the COMMITTED artifact at `path` when the
    active spec arms `point` with kind "corrupt"; returns True when the
    file was mutated. Unlike inject() this fires AFTER publish — the
    flip lands in the durable artifact exactly like a latent media
    error, so the read-path checksum verification (not the commit
    protocol) must catch it. The flipped offset derives from the spec
    seed, point and call index: same seed, same poisoned byte."""
    spec = conf.fault_injection_spec
    if not spec:
        return False
    points = spec.get("points")
    if not points:
        return False
    key, rule = _rule_for(points, point)
    if rule is None or rule.get("kind") != "corrupt":
        return False
    fire, n = _schedule_fire(spec, point, key, rule)
    if not fire:
        return False
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size <= 0:
        return False
    off = _mix(spec.get("seed", 0), f"{point}#{n}") % size
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0x40]))
    TELEMETRY.add("faults_injected", 1)
    TELEMETRY.add(f"injected.{key}", 1)
    trace.event("fault_injected", point=point, call=n,
                fault_kind="corrupt")
    return True


def stats() -> Dict[str, int]:
    return TELEMETRY.snapshot()


# ---------------------------------------------------------------------------
# Retry backoff
# ---------------------------------------------------------------------------


def backoff_ms(attempt: int) -> float:
    """Exponential backoff with +-25% jitter: base * 2^attempt * U[.75,1.25].
    The jitter rng is seeded from the fault spec's seed when one is
    installed, so chaos replays sleep identically."""
    base = max(float(conf.retry_backoff_ms), 0.0)
    with _sched_lock:
        rng = _rngs.get("__jitter__", _default_jitter)
    return base * (2.0 ** attempt) * (0.75 + 0.5 * rng.random())


# ---------------------------------------------------------------------------
# Telemetry plumbing (metric_tree node + run_info deltas)
# ---------------------------------------------------------------------------


def note_error(category: str, run_info: Optional[dict] = None) -> None:
    TELEMETRY.add(f"errors.{category}", 1)
    if run_info is not None:
        k = f"errors.{category}"
        run_info[k] = run_info.get(k, 0) + 1


def note_retry(run_info: Optional[dict] = None) -> None:
    TELEMETRY.add("retries", 1)
    if run_info is not None:
        run_info["retries"] = run_info.get("retries", 0) + 1


def note_degradation(rung: str, run_info: Optional[dict] = None) -> None:
    TELEMETRY.add("degradations", 1)
    TELEMETRY.add(f"degraded.{rung}", 1)
    if run_info is not None:
        run_info["degradations"] = run_info.get("degradations", 0) + 1
        k = f"degraded.{rung}"
        run_info[k] = run_info.get(k, 0) + 1
        if rung == "fallback":
            run_info["task_fallbacks"] = run_info.get("task_fallbacks",
                                                      0) + 1
            TELEMETRY.add("task_fallbacks", 1)


def run_info_delta(before: Dict[str, int],
                   run_info: Optional[dict]) -> None:
    """Copy global-counter deltas since `before` (a TELEMETRY.snapshot())
    into a run_info dict — counters the injection sites can't reach
    directly (faults_injected fires deep inside serde/spill/jit)."""
    if run_info is None:
        return
    after = TELEMETRY.snapshot()
    for k in ("faults_injected", "orphans_swept", "stalls_injected"):
        d = after.get(k, 0) - before.get(k, 0)
        if d:
            run_info[k] = run_info.get(k, 0) + d


def telemetry_node() -> MetricNode:
    """Resilience counters as a MetricNode child (handler None), for an
    embedder's metric tree."""
    return MetricNode(TELEMETRY, [])


def telemetry_summary() -> str:
    """One-line summary of the resilience counters ('' when idle),
    including the per-category error counts ([plan=1 retryable=2 ...])
    next to the totals. Reads a locked snapshot — pool threads keep
    adding while reports render."""
    v = TELEMETRY.snapshot()
    keys = ("retries", "degradations", "task_fallbacks", "faults_injected")
    if not any(v.get(k) for k in keys):
        return ""
    cats = " ".join(f"{k.split('.', 1)[1]}={n}"
                    for k, n in sorted(v.items())
                    if k.startswith("errors.") and n)
    return ("resilience: retries={retries} degradations={degradations} "
            "fallbacks={task_fallbacks} faults_injected={faults_injected}"
            .format(**{k: v.get(k, 0) for k in keys})
            + (f" [{cats}]" if cats else ""))
