"""Config/flag system — a copy of blaze_tpu/config.py for the PyTorch port.

The knob names and defaults are the JAX package's, so a knob such as
``dense_agg_range`` or ``float_sum_digit_planes`` reads the same in both
packages. The port keeps its own copy because importing anything under
``blaze_tpu`` runs that package's ``__init__`` (which imports jax).

Three tiers like the reference (SURVEY.md §5.6).

Ref: spark-extension BlazeConf.java (batchSize/memoryFraction/... read lazily
from native over JNI). Here the native side IS this process, so the conf is a
plain singleton the JVM bridge (or tests) can populate; defaults mirror the
reference's (BlazeConf.java:23-70) where semantics carry over, with
TPU-specific knobs added.

The ``KNOBS`` registry below is the SINGLE SOURCE OF TRUTH for every knob:
name, default, type, doc string, and env-var override live in one ``Knob``
declaration, and everything else derives from it — ``BlazeConf`` instances
are built from the registry, ``tools/blazelint``'s knob-registry checker
validates every ``conf.<name>`` access (and the README catalog) against it,
and ``knob_catalog_md()`` renders the README table. To add a knob: add one
``Knob(...)`` entry here, read it somewhere in the runtime, and document it
in README.md ("Configuration knobs") — `make check-lint` fails until all
three agree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared configuration knob.

    ``default_factory`` (mutable defaults: dicts) wins over ``default``;
    ``env`` names an environment variable consulted once at BlazeConf
    construction (the value is cast through ``type``).

    ``step``/``min``/``max`` are the autopilot actuation schedule: a knob
    that declares all three may be moved one bounded step at a time by
    runtime/autopilot.py (``geometric=True`` multiplies/divides by
    ``step`` instead of adding/subtracting it). Knobs without the triple
    are never actuated — blazelint's doctor-knob-sync rule enforces that
    every knob in autopilot.ACTUATORS declares it."""

    name: str
    default: Any = None
    doc: str = ""
    env: str = ""
    default_factory: Optional[Callable[[], Any]] = None
    step: Optional[float] = None
    min: Optional[float] = None
    max: Optional[float] = None
    geometric: bool = False

    @property
    def type(self) -> type:
        if self.default_factory is not None:
            return type(self.default_factory())
        return type(self.default)

    def resolve(self) -> Any:
        if self.env:
            raw = os.environ.get(self.env)
            if raw is not None:
                t = self.type
                if t is bool:
                    return raw.lower() in ("1", "true", "yes", "on")
                return t(raw)
        if self.default_factory is not None:
            return self.default_factory()
        return self.default

    def propose_step(self, current: Any, direction: int) -> Optional[Any]:
        """One bounded step from ``current`` in ``direction`` (+1/-1).

        Returns the clamped next value, or None when the knob declares
        no schedule or the clamp leaves the value unchanged (already
        pinned at the min/max rail)."""
        if self.step is None or self.min is None or self.max is None:
            return None
        if self.geometric:
            nxt = current * self.step if direction > 0 else current / self.step
        else:
            nxt = current + self.step * direction
        nxt = sorted((self.min, nxt, self.max))[1]
        if self.type is bool:
            # validate_overlay is strict on bool knobs — a proposed 0/1
            # int would be rejected at apply time
            nxt = bool(round(nxt))
        elif self.type is int:
            nxt = int(round(nxt))
        return None if nxt == current else nxt


_DECLARATIONS: Tuple[Knob, ...] = (
    # -- reference-equivalent knobs (BlazeConf.java) --
    Knob("batch_size", 8192,
         doc="Rows per batch; ref default 10000 — 8192 is TPU/XLA tile "
             "friendly."),
    Knob("enable_smj_inequality_join", False,
         doc="Allow sort-merge joins with inequality conditions."),
    Knob("enable_bhj_fallbacks_to_smj", True,
         doc="Fall back from broadcast-hash join to sort-merge join when "
             "the build side exceeds the thresholds below."),
    Knob("bhj_fallback_rows_threshold", 1_000_000,
         doc="Build-side row count above which BHJ falls back to SMJ."),
    Knob("bhj_fallback_mem_threshold", 128 << 20,
         doc="Build-side byte size above which BHJ falls back to SMJ."),
    Knob("enable_input_batch_statistics", False,
         doc="Per-operator input-batch byte/row statistics at every "
             "stream boundary (ref batch_statisitcs module)."),
    Knob("ignore_corrupt_files", False,
         doc="Skip unreadable/corrupt input files instead of failing the "
             "task."),

    # -- TPU-native knobs --
    Knob("min_capacity", 1024,
         doc="Smallest power-of-two capacity bucket: the jit cache is "
             "keyed on (plan, capacity, string-width), so padding to "
             "buckets bounds the number of compilations."),
    Knob("min_string_width", 4,
         doc="Smallest fixed string width (string columns are fixed-width "
             "uint8 matrices; width is bucketed like capacity)."),
    Knob("max_string_width", 4096,
         doc="Cap on the bucketed fixed string width."),
    Knob("memory_budget", 0,
         doc="HBM budget for MemManager in bytes; 0 = derive from device "
             "memory stats."),
    Knob("spill_dir", os.path.join(tempfile.gettempdir(), "blaze_tpu_spill"),
         env="BLAZE_TPU_SPILL_DIR",
         doc="Directory for host spill files (MemManager/SpillFile); by "
             "default under the process's temp dir ($TMPDIR)."),
    Knob("zstd_level", 1,
         doc="Compression level for shuffle/spill/broadcast frames (ref "
             "uses zstd level 1; this build's frame codec is zlib at the "
             "same level knob)."),
    Knob("enable_stage_compiler", True,
         doc="Whole-stage single-dispatch compiler "
             "(runtime/stage_compiler.py): one probe pass and one "
             "accumulation pass per stage, with one host pull each."),
    Knob("dense_agg_range", 1 << 16,
         doc="Dense grouped-agg key range for the MXU one-hot path "
             "(<= 2^16: 256x256 byte decomposition); stages whose keys "
             "exceed it fall back.",
         step=2.0, min=1 << 12, max=1 << 22, geometric=True),
    Knob("float_sum_digit_planes", 6,
         doc="Precision policy for FLOAT sums on the MXU digit-plane "
             "path: 6 planes digitize to 46 bits of the per-stage max. "
             "5 is a perf opt-in (one plane fewer, ~2^-38 relative "
             "error); 7 is stricter. Int sums always use the exact "
             "8-chunk int64 path."),
    Knob("spill_frame_rows", 1 << 16,
         doc="External-sort spill frame rows: merge cost is one dispatch "
             "trio per pooled frame, so bigger frames amortize the fixed "
             "per-dispatch overhead."),
    Knob("target_batch_bytes", 128 << 20,
         doc="Adaptive macro-batching target: batch sources size batches "
             "toward this many bytes, clamped by the memory budget "
             "(ops/common.adaptive_batch_rows).",
         step=2.0, min=16 << 10, max=1 << 30, geometric=True),
    Knob("max_batch_rows", 1 << 21,
         doc="Hard row cap on adaptive macro-batches."),
    Knob("aqe_broadcast_threshold", 10 << 20,
         doc="AQE dynamic join selection: a planned SMJ whose shuffled "
             "input came in under this many bytes becomes a broadcast "
             "join (Spark autoBroadcastJoinThreshold analog; 0 "
             "disables)."),
    Knob("enable_compile_canonicalization", True,
         doc="Compile-service shape canonicalization: above "
             "canonical_pow2_limit, power-of-two capacity buckets "
             "collapse onto power-of-four rungs, halving the large end "
             "of the compiled-program shape space."),
    Knob("canonical_pow2_limit", 1 << 14,
         doc="Capacity above which canonicalization switches to "
             "power-of-four rungs."),
    Knob("profiler_dir", "", env="BLAZE_TPU_PROFILE_DIR",
         doc="JAX profiler trace output dir ('' disables) — consumed by "
             "trace.profiled_span (jax.profiler TensorBoard captures "
             "recorded as 'profile' spans in the engine trace)."),

    # -- continuous sampling profiler (runtime/profiler.py) --
    Knob("profile_enabled", False, env="BLAZE_TPU_PROFILE",
         doc="Always-on wall-clock sampling profiler: a daemon thread "
             "samples every live thread's stack (sys._current_frames) "
             "each profile_sample_ms and folds it into a bounded "
             "aggregated table attributed to (query, stage, task, "
             "tenant) via the thread-local trace context; pooled "
             "executors ship folded-stack deltas driver-ward on the "
             "telemetry frames (sidecar-recoverable). Off (default) "
             "every profiler hook is one truthiness check and no "
             "sampler thread exists."),
    Knob("profile_sample_ms", 25,
         doc="Sampling period of the profiler daemon thread. 25ms "
             "(40Hz) keeps measured overhead under the 2% chaos gate "
             "while resolving stage-scale hot spots; the sampler also "
             "self-limits to a ~1% duty cycle when a pass runs long."),
    Knob("profile_max_frames", 64,
         doc="Per-sample stack-depth bound: frames beyond this many "
             "(leaf-ward from the root) are truncated before folding, "
             "bounding both fold cost and table key size."),
    Knob("profile_export_dir", "", env="BLAZE_TPU_PROFILE_EXPORT_DIR",
         doc="Per-query profile export dir ('' disables): "
             "profile_<query_id>.collapsed (flamegraph.pl collapsed-"
             "stack text) plus profile_<query_id>.speedscope.json, "
             "written at query end; render/convert with "
             "tools/blaze_prof.py."),

    # -- structured query tracing (runtime/trace.py) --
    Knob("trace_enabled", False,
         doc="Record correlated span/event records (query/stage/task/"
             "attempt ids) for every runtime decision. Off (default) "
             "every trace call site is one truthiness check."),
    Knob("trace_buffer_events", 1 << 17,
         doc="Bounded ring capacity of the process-global TraceLog; "
             "overflow drops the OLDEST record and counts it "
             "(TraceLog.dropped)."),
    Knob("trace_export_dir", "", env="BLAZE_TPU_TRACE_DIR",
         doc="Per-query export dir ('' disables): trace_<query_id>.json "
             "(Chrome/Perfetto) plus one ledger.jsonl line per query."),

    # -- execution resilience (runtime/faults.py, runtime/executor.py) --
    Knob("fault_injection_spec", default_factory=dict,
         doc="Fault-injection spec ({} disables; see faults.py docstring "
             "for the {'seed':..., 'points':...} shape). Install via "
             "faults.install() so the deterministic schedule state "
             "resets with the spec."),
    Knob("max_task_retries", 2,
         doc="Bounded per-task retries for RetryableError-classified "
             "failures."),
    Knob("retry_backoff_ms", 10,
         doc="Base backoff before retry i is ~retry_backoff_ms * 2^i "
             "(+-25% jitter)."),
    Knob("enable_degradation_ladder", True,
         doc="Resource-exhaustion degradation ladder: halve macro-batch "
             "-> force MemManager spill -> CPU fallback interpreter. "
             "Off = resource errors get plain bounded retries."),

    # -- task supervisor (runtime/supervisor.py) --
    Knob("enable_supervisor", True,
         doc="Off = the sequential runner: tasks run inline on the "
             "driver thread with retries/ladder only (no pool, watchdog, "
             "speculation)."),
    Knob("max_concurrent_tasks", 4,
         doc="Bounded worker pool for shuffle-map/broadcast/result "
             "tasks. Deterministic chaos replay forces 1 while a fault "
             "spec without {'concurrent': true} is armed."),
    Knob("task_deadline_ms", 0,
         doc="Wall-clock budget per task (all attempts incl. retries/"
             "backoff); 0 = unlimited. Exhaustion raises "
             "faults.DeadlineError."),
    Knob("query_deadline_ms", 0,
         doc="Wall-clock budget per query; 0 = unlimited."),
    Knob("hang_detect_ms", 0,
         doc="Watchdog hang detection: an attempt whose heartbeat stalls "
             "past this is cancelled and relaunched under the resilience "
             "ladder. 0 disables."),
    Knob("speculation_multiplier", 0.0,
         doc="Straggler speculation: a running attempt exceeding "
             "multiplier x the median completed-attempt duration of its "
             "stage gets a speculative twin; first commit wins. 0 "
             "disables."),
    Knob("breaker_failure_threshold", 4,
         doc="Per-operator circuit breaker: after this many classified "
             "failures attributed to one operator kind within a query, "
             "that operator trips to the row-interpreter fallback. 0 "
             "disables."),

    # -- multi-tenant query service (runtime/service.py) --
    Knob("max_concurrent_queries", 4,
         doc="QueryService admission control: queries running at once. "
             "Arrivals beyond this park in the bounded admission queue "
             "(wait counts against query_deadline_ms)."),
    Knob("admission_queue_depth", 16,
         doc="Bounded admission queue: parked queries waiting for a run "
             "slot. A full queue load-sheds new arrivals with a typed "
             "faults.AdmissionRejected (and a run-ledger line)."),
    Knob("tenant_quota_spec", default_factory=dict,
         doc="Per-tenant MemManager quota ({'tenant': bytes} or a 0-1 "
             "float fraction of the budget; {} = no quotas). An "
             "over-quota tenant spills/parks its OWN consumers; it "
             "cannot evict another tenant's working set."),
    Knob("tenant_priority_spec", default_factory=dict,
         doc="Per-tenant scheduling weight ({'tenant': weight}, default "
             "1.0): the service pool dispatches TaskSpecs deficit-"
             "weighted round robin across live sessions, not FIFO."),
    Knob("tenant_slo_spec", default_factory=dict,
         doc="Per-tenant latency objective ({'tenant': {'latency_ms': "
             "500, 'target': 0.99}}; {} disables): the service tracks "
             "rolling attainment + burn rate over the last "
             "slo_window_queries arrivals (shed queries count as "
             "misses), exports blaze_slo_* gauges and emits a "
             "'slo_burn' trace event when the error budget burns past "
             "slo_burn_alert_rate."),
    Knob("slo_window_queries", 128,
         doc="Rolling window (per tenant, in completed arrivals) over "
             "which SLO attainment and burn rate are computed."),
    Knob("slo_burn_alert_rate", 2.0,
         doc="Burn-rate alert threshold: miss_rate / error_budget above "
             "this emits the 'slo_burn' trace event (1.0 = burning "
             "exactly at budget; 2.0 = budget gone in half the window)."),

    # -- query doctor (runtime/doctor.py, tools/blaze_doctor.py) --
    Knob("doctor_enabled", True,
         doc="Stamp the additive critical-path breakdown into run-ledger "
             "lines / history records and render the doctor section "
             "(breakdown + ranked findings) in explain_analyze. The "
             "stamp is computed from already-recorded spans at export "
             "time — no hot-path cost."),
    Knob("doctor_skew_ratio", 4.0,
         doc="Skew/straggler rule threshold: a stage's worst clean task "
             "must exceed the stage's median task duration by this "
             "factor (and the stage must be a significant share of the "
             "query) before the doctor flags it."),

    # -- pipelined async execution (runtime/pipeline.py) --
    Knob("enable_pipeline", True,
         doc="Overlap host-side stages (parquet read+decode, serde, "
             "shuffle frame I/O, spill I/O) with device compute via a "
             "shared I/O pool behind bounded queues. False restores the "
             "serial streams; an armed fault spec without "
             "{'concurrent': true} also forces serial."),
    Knob("io_threads", 4,
         doc="Shared I/O pool width (pipeline.io_pool). Host stages "
             "release the GIL (zlib + numpy + file I/O), so a few "
             "threads overlap well even under CPython."),
    Knob("prefetch_batches", 2,
         doc="Bounded queue depth per pipelined stream; in-flight bytes "
             "are reserved against the MemManager budget (backpressure, "
             "not OOM).",
         step=1, min=1, max=8),

    # -- resource accounting & live metrics (runtime/monitor.py) --
    Knob("monitor_enabled", True,
         doc="Byte accounting at every copy boundary with per-query/"
             "stage attribution. Off, every boundary call site is one "
             "truthiness check and all counters read 0; the always-on "
             "leak telemetry is independent of this flag."),
    Knob("metrics_port", 0,
         doc="Metrics + debug-endpoint HTTP server (stdlib http.server "
             "daemon thread) serving GET /metrics, /healthz, /queries "
             "and /queries/<qid>; 0 disables."),
    Knob("metrics_host", "127.0.0.1", env="BLAZE_TPU_METRICS_HOST",
         doc="Bind address for the metrics/debug HTTP server. Loopback "
             "by default — set 0.0.0.0 only when the endpoints should "
             "be reachable off-host (they expose query metadata)."),
    Knob("monitor_sample_ms", 200,
         doc="Background ResourceMonitor sampling period (MemManager "
             "usage, spill pages, pool occupancy, queue depths, "
             "compile-cache stats); <= 0 disables the sampler thread."),
    Knob("monitor_ring_samples", 2048,
         doc="Bounded sample-ring capacity (deque maxlen; 2048 x 200ms "
             "is about the last ~7 minutes)."),

    # -- query history store (runtime/history.py) --
    Knob("history_dir", "", env="BLAZE_TPU_HISTORY_DIR",
         doc="Persistent per-run statistics keyed by plan fingerprint: "
             "sharded JSONL under this directory. '' disables (every "
             "history call site is one truthiness check)."),
    Knob("history_retention_runs", 512,
         doc="Total run records retained across shards; also bounds the "
             "trace_export_dir rotation applied on driver start."),
    Knob("history_shard_runs", 128,
         doc="Records per JSONL shard before rotating to a new shard "
             "file (retention prunes whole oldest shards)."),
    Knob("history_regression_pct", 25.0,
         doc="Cross-run regression threshold: latest per-stage wall time "
             "/ copy traffic flagged when it exceeds the fingerprint's "
             "historical median by more than this percentage (plus an "
             "absolute noise grace — history.detect_regressions)."),

    # -- flight recorder & live introspection (runtime/flight_recorder,
    # -- runtime/progress.py) --
    Knob("flight_dir", "", env="BLAZE_TPU_FLIGHT_DIR",
         doc="Incident dossier directory ('' disables): when a query "
             "fails / is shed / exceeds its deadline / hangs / breaches "
             "its tenant SLO / trips a breaker / leaks resources, a "
             "self-contained JSON dossier (trace slice, monitor samples, "
             "doctor breakdown + findings, resolved knobs, ledger line) "
             "is committed crash-atomically under this directory."),
    Knob("flight_retention", 64,
         doc="Bounded dossier retention: the newest N dossiers are kept, "
             "older ones pruned after each capture."),
    Knob("flight_triggers", "all",
         doc="Comma list selecting which incident classes capture "
             "(failure, shed, deadline, hang, slo_breach, breaker_trip, "
             "resource_leak, driver_restart, driver_failover, "
             "stream_stall); 'all' arms every class."),
    Knob("progress_enabled", False,
         doc="Live per-query progress tracking (runtime/progress.py): "
             "per-stage rows/attempts/ETA served at /queries and "
             "/queries/<qid>. Off (default) every hook site is one "
             "truthiness check — same posture as trace/monitor."),

    # -- process-isolated executors (runtime/executor_pool.py) --
    Knob("executor_count", 0,
         doc="Process-isolated executor pool width: N worker processes "
             "each owning a virtual device slice, fed TaskSpecs over a "
             "length-prefixed control socket. 0 (default) keeps the "
             "single-process thread runtime."),
    Knob("executor_slots", 2,
         doc="Concurrent task slots per executor process; the service's "
             "admission capacity degrades to live_executors x slots when "
             "a pool is attached."),
    Knob("executor_heartbeat_ms", 100,
         doc="Executor -> driver heartbeat period over the control "
             "socket (a worker thread pushes beats; any inbound frame "
             "also refreshes liveness)."),
    Knob("executor_death_ms", 2000,
         doc="Heartbeat staleness past which the driver declares an "
             "executor dead (fences its epoch, re-queues its in-flight "
             "tasks, recomputes capacity). A reaped PID is declared "
             "dead immediately regardless of this threshold."),
    Knob("executor_restart_max", 3,
         doc="Replacement spawns per executor seat after a death; "
             "exhausting it retires the seat (capacity stays degraded)."),
    Knob("executor_restart_backoff_ms", 100,
         doc="Base backoff before replacement spawn i of a seat is "
             "~backoff * 2^i."),
    Knob("telemetry_ship_ms", 250,
         doc="Executor -> driver telemetry ship period: buffered span/"
             "event records and monitor counter deltas are batched into "
             "a 'telemetry' frame on the control socket at this cadence "
             "(a flush also rides every task result). <= 0 disables "
             "the timer; results still carry their flush.",
         step=2.0, min=50, max=2000, geometric=True),
    Knob("executor_trace_events", 4096,
         doc="Bounded ring capacity of each executor process's local "
             "TraceLog (worker-side spans buffer here between ships; "
             "overflow drops the OLDEST record and counts it). The "
             "unshipped tail is also spilled crash-atomically to a "
             "per-worker sidecar file so a SIGKILL loses nothing the "
             "driver can't recover."),
    Knob("clock_skew_bound_ms", 5000,
         doc="Bound on the per-executor clock offset estimated from the "
             "hello handshake echo (executor monotonic clocks are "
             "rebased onto the driver's before trace federation). An "
             "estimate outside +-bound is clamped so one bad echo "
             "cannot scramble merged-trace ordering."),
    Knob("control_reconnect_max", 4,
         doc="Bounded reconnect attempts a worker makes after a control-"
             "socket transport error before treating the driver as "
             "unreachable (the lease then governs self-fencing). The "
             "driver keeps a broken-but-alive seat's tasks in flight "
             "while it waits for the resume handshake, bounded by "
             "executor_death_ms."),
    Knob("control_reconnect_backoff_ms", 50,
         doc="Base backoff before worker reconnect attempt i "
             "(~backoff * 2^i, jittered) after a control-socket error; "
             "the resume handshake re-delivers unacked TaskSpecs and "
             "results, deduped by (task_id, attempt, epoch).",
         step=2.0, min=10, max=1600, geometric=True),
    Knob("executor_drain_grace_ms", 5000,
         doc="Graceful-decommission budget: a draining executor "
             "(ExecutorPool.decommission or SIGTERM) finishes in-flight "
             "tasks for up to this long, flushes its telemetry sidecar, "
             "hands registered shuffle rids back, then exits. In-flight "
             "work still unfinished at expiry is requeued without an "
             "executor_death dossier."),

    # -- durable execution (runtime/artifacts.py, runtime/journal.py) --
    Knob("artifact_checksums", True,
         doc="Per-frame CRC32 + whole-file digests stamped into shuffle "
             ".index files at commit time and verified on every read "
             "path (server segment fetch, local shuffle reads, spill "
             "re-read). A mismatch, or an index without its footer, "
             "quarantines the artifact and triggers lineage re-execution "
             "of the producing map task under a fresh epoch. Off = "
             "nothing is stamped or checked, and footer-less indexes are "
             "accepted."),
    Knob("journal_dir", "", env="BLAZE_TPU_JOURNAL_DIR",
         doc="Write-ahead query journal directory ('' disables): one "
             "crash-atomic JSONL per query recording admission, plan "
             "fingerprints, each stage commit (artifact paths, epochs, "
             "checksums) and completion — the recovery scan replays "
             "incomplete journals after a driver crash."),
    Knob("journal_retention", 256,
         doc="Journal files retained (newest N complete journals; "
             "incomplete ones are never pruned until recovered)."),
    Knob("recovery_enabled", True,
         doc="Driver-crash recovery scan at driver start (beside the "
             "orphan sweep): incomplete journals are replayed — verified "
             "committed stages become resumable, unverifiable queries "
             "are billed failed with a driver_restart dossier. Needs "
             "journal_dir."),
    Knob("shuffle_connect_timeout_ms", 5000,
         doc="ShuffleClient socket connect/read timeout and total retry "
             "budget: fetches retry with exponential backoff within this "
             "window instead of blocking forever on a hung shuffle "
             "server. 0 = legacy blocking socket with one reconnect."),

    # -- zero-copy data plane (shuffle mmap + dictionary strings) --
    Knob("shuffle_mmap_enabled", True,
         doc="Same-host shuffle fast path: when the committed "
             ".data/.index pair for a fetched rid is host-local, the "
             "ShuffleClient mmaps the .data file read-only and slices "
             "partition segments as zero-copy memoryviews (booked as "
             "bytes_moved only), verifying per-frame CRC32 lazily on "
             "first touch; a mismatch falls back to the BCS2 socket "
             "fetch whose server-side read quarantines + lineage-"
             "repairs. Off = every pooled fetch streams over the "
             "socket.",
         step=1, min=0, max=1),
    Knob("dict_encode_strings", True,
         doc="Dictionary-encode string columns in serde frames: ship "
             "(dict, codes) once and keep filter/join/groupby on i32 "
             "codes, decoding only at the result-merge edge. Columns "
             "whose slice cardinality exceeds dict_max_cardinality (or "
             "where the dict form is not smaller) fall back to plain "
             "length-prefixed encoding per column.",
         step=1, min=0, max=1),
    Knob("dict_max_cardinality", 64 << 10,
         doc="Distinct-value ceiling for dictionary-encoded string "
             "columns: a serde slice with more unique strings than this "
             "is written in plain form (the dict no longer pays for "
             "itself and the code gather stops being cache-friendly).",
         step=2.0, min=256, max=1 << 20, geometric=True),

    # -- elastic fleet & driver HA (runtime/autoscaler.py,
    # -- runtime/standby.py) --
    Knob("autoscale_enabled", False,
         doc="SLO-driven fleet autoscaler: a driver-side policy loop "
             "reads admission parked arrivals, SLO burn rate and per-"
             "seat busy-slot utilization, then actuates pool.spawn() / "
             "pool.decommission() within [autoscale_min, autoscale_max] "
             "seats. Scale-down drains the idlest seat through the "
             "drain-ack barrier so in-flight queries never notice."),
    Knob("autoscale_min", 1,
         doc="Autoscaler floor: the fleet never drains below this many "
             "serving seats, regardless of how idle they are."),
    Knob("autoscale_max", 4,
         doc="Autoscaler ceiling: scale-up stops here even while parked "
             "arrivals persist (doctor's fleet_underprovisioned finding "
             "suggests raising it when the policy pins at the ceiling).",
         step=1, min=1, max=8),
    Knob("autoscale_cooldown_ms", 5000,
         doc="Hysteresis between autoscaler actuations: after a "
             "scale_up/scale_down decision the policy observes without "
             "acting for this long, so a burst cannot thrash spawn/"
             "drain cycles."),
    Knob("standby_enabled", False,
         doc="Warm-standby driver (runtime/standby.py): a second "
             "process tails journal_dir + the leader lease, detects "
             "primary death by pid-liveness and takes over — rebinding "
             "the executor control socket, replaying dead-writer "
             "journals into resumable queries and resuming admission."),
    Knob("leader_lease_ms", 2000,
         doc="Leader lease freshness window: a lease whose holder pid "
             "is dead, or unrenewed for longer than this, is up for "
             "grabs. Takeover bumps the lease epoch so a paused-then-"
             "resumed old primary self-fences on its next renew — the "
             "same epoch fencing that executors use."),

    # -- durable micro-batch streaming (runtime/streaming.py) --
    Knob("stream_poll_ms", 200,
         doc="Micro-batch tick cadence: a StreamingQuery sleeps this "
             "long between TailSource discovery passes when the source "
             "is caught up (a tick that found new files immediately "
             "polls again, so a backlog drains at full speed)."),
    Knob("stream_checkpoint_interval", 1,
         doc="Micro-batches between durable checkpoints. 1 (default) "
             "checkpoints after every committed batch — exactly-once "
             "resume never re-processes more than the in-flight batch. "
             "N>1 amortizes the fsync over N batches; a crash then "
             "re-processes up to N batches into the last checkpointed "
             "state (still exactly-once externally: offsets and state "
             "travel in the same atomic record)."),
    Knob("stream_max_lag_ms", 10000,
         doc="End-to-end lag objective for a stream (oldest undiscovered-"
             "or-unprocessed input age). Sustained lag past this cuts a "
             "stream_stall flight dossier (once per stream) and a doctor "
             "stream_lag finding suggesting the knob to turn."),

    # -- self-tuning autopilot (runtime/autopilot.py) --
    Knob("autopilot_enabled", False, env="BLAZE_AUTOPILOT",
         doc="Guarded per-fingerprint knob adaptation: each run's top "
             "doctor finding proposes ONE bounded knob step (the knob's "
             "declared step/min/max schedule), canary runs are verdicted "
             "against the settled baseline by detect_regressions(), and "
             "a regression rolls the overlay back immediately and "
             "quarantines the value. Needs autopilot_dir."),
    Knob("autopilot_dir", "", env="BLAZE_AUTOPILOT_DIR",
         doc="Crash-atomic OverlayStore directory ('' disables): one "
             "journal-style JSONL of propose/promote/rollback/quarantine "
             "events, folded into per-fingerprint state on open — "
             "settled overlays and quarantine lists survive driver "
             "restart and standby failover."),
    Knob("autopilot_canary_runs", 3,
         doc="Consecutive canary runs that must beat the settled p50 "
             "before a proposed overlay value is promoted to settled; a "
             "canary that can't produce this streak within 3x the budget "
             "is reverted as inconclusive (and quarantined, so the "
             "explorer never oscillates on it)."),
    Knob("autopilot_max_active_canaries", 4,
         doc="Cap on concurrently-canarying fingerprints across the "
             "store; proposals beyond it are deferred until a canary "
             "promotes or rolls back."),

    # -- per-operator enable flags (tier b, spark.blaze.enable.<op>) --
    Knob("enable_ops", default_factory=dict,
         doc="Per-operator enable flags ({'filter': False} routes that "
             "operator to the fallback path); read through "
             "conf.op_enabled(op)."),
)

KNOBS: Dict[str, Knob] = {k.name: k for k in _DECLARATIONS}

# Overlay layers in precedence order (later wins). ``base`` is the
# BlazeConf singleton itself; the other three are plain dicts validated
# against KNOBS and composed per query by resolve_overlay().
OVERLAY_LAYERS: Tuple[str, ...] = ("base", "tenant", "fingerprint", "pin")

# Thread-scoped overlay application: a query thread enters
# overlay_scope(...) and every conf.<knob> read on THAT thread sees the
# overlaid value; concurrent queries on other threads keep reading base
# (or their own overlay) — one query's canary can never leak into
# another tenant's resolved conf.
_overlay_tls = threading.local()


class BlazeConf:
    """The process-wide knob singleton, built from ``KNOBS``.

    Attribute surface is exactly the registry: reading/writing an
    undeclared name is an AttributeError/blazelint finding, and
    ``update()`` keeps the historical KeyError contract for the JVM
    bridge's property plumbing. Reads are overlay-aware: inside an
    overlay_scope() the calling thread sees the scoped values."""

    __slots__ = tuple(KNOBS)

    def __init__(self) -> None:
        for knob in KNOBS.values():
            setattr(self, knob.name, knob.resolve())

    def __getattribute__(self, name: str) -> Any:
        ov = _overlay_tls.__dict__.get("values")
        if ov is not None and name in ov:
            return ov[name]
        return object.__getattribute__(self, name)

    def op_enabled(self, op: str) -> bool:
        return self.enable_ops.get(op, True)

    def update(self, **kwargs: Any) -> "BlazeConf":
        for k, v in kwargs.items():
            if k not in KNOBS:
                raise KeyError(f"unknown conf key: {k}")
            setattr(self, k, v)
        return self


def validate_overlay(mapping: Dict[str, Any],
                     layer: str = "overlay") -> Dict[str, Any]:
    """Validate one overlay layer against the Knob registry.

    Unknown knob names raise KeyError (the conf.update contract);
    type-incompatible values raise TypeError. int/float coerce to the
    declared type; bool is strict (it IS an int to isinstance)."""
    out: Dict[str, Any] = {}
    for name, value in dict(mapping).items():
        knob = KNOBS.get(name)
        if knob is None:
            raise KeyError(f"unknown conf key in {layer} overlay: {name}")
        t = knob.type
        if t is bool:
            if not isinstance(value, bool):
                raise TypeError(
                    f"{layer} overlay {name}: expected bool, "
                    f"got {type(value).__name__}")
        elif isinstance(value, bool):
            raise TypeError(
                f"{layer} overlay {name}: expected {t.__name__}, got bool")
        elif t in (int, float) and isinstance(value, (int, float)):
            value = t(value)
        elif not isinstance(value, t):
            raise TypeError(
                f"{layer} overlay {name}: expected {t.__name__}, "
                f"got {type(value).__name__}")
        out[name] = value
    return out


_tenant_overlays: Dict[str, Dict[str, Any]] = {}


def set_tenant_overlay(tenant: str,
                       mapping: Optional[Dict[str, Any]]) -> None:
    """Install (or clear, with a falsy mapping) a tenant's overlay."""
    if not mapping:
        _tenant_overlays.pop(tenant, None)
    else:
        _tenant_overlays[tenant] = validate_overlay(mapping, layer="tenant")


def tenant_overlay(tenant: Optional[str]) -> Dict[str, Any]:
    return dict(_tenant_overlays.get(tenant) or {}) if tenant else {}


def overlay_hash(values: Dict[str, Any]) -> Optional[str]:
    """Stable short hash of a resolved overlay (None when empty) —
    stamped into history records so StatisticsFeed/detect_regressions
    compare like-with-like across overlay generations."""
    if not values:
        return None
    blob = json.dumps(values, sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


@dataclasses.dataclass
class ResolvedOverlay:
    """The composed non-base layers for one query: what differs from
    base, which layer each value came from, and the stable hash."""

    values: Dict[str, Any] = dataclasses.field(default_factory=dict)
    provenance: Dict[str, str] = dataclasses.field(default_factory=dict)
    canary: bool = False
    canary_knob: str = ""

    @property
    def hash(self) -> Optional[str]:
        return overlay_hash(self.values)

    def as_record(self) -> Dict[str, Any]:
        """JSON-safe stamp for ledger lines / dossiers / run_info."""
        return {"overlay": dict(self.values),
                "provenance": dict(self.provenance),
                "overlay_hash": self.hash,
                "canary": self.canary,
                "canary_knob": self.canary_knob}


def resolve_overlay(tenant: Optional[str] = None,
                    fingerprint_overlay: Optional[Dict[str, Any]] = None,
                    pin: Optional[Dict[str, Any]] = None) -> ResolvedOverlay:
    """Compose base -> tenant -> per-fingerprint -> per-query pin.

    Each layer is validated against KNOBS; later layers win and the
    winning layer is recorded per knob in ``provenance`` (knobs absent
    from every layer stay 'base' and are not listed)."""
    resolved = ResolvedOverlay()
    for layer, mapping in (("tenant", tenant_overlay(tenant)),
                           ("fingerprint", fingerprint_overlay),
                           ("pin", pin)):
        if not mapping:
            continue
        for name, value in validate_overlay(mapping, layer=layer).items():
            resolved.values[name] = value
            resolved.provenance[name] = layer
    return resolved


@contextlib.contextmanager
def overlay_scope(values: Optional[Dict[str, Any]],
                  provenance: Optional[Dict[str, str]] = None
                  ) -> Iterator[None]:
    """Apply an overlay to every conf read on the calling thread.

    Nests: an inner scope merges over (and restores) the outer one.
    supervisor/pipeline task threads inherit the submitting thread's
    scope via current_overlay() capture."""
    tls = _overlay_tls.__dict__
    prev = (tls.get("values"), tls.get("provenance"))
    merged = dict(prev[0] or {})
    merged.update(values or {})
    merged_prov = dict(prev[1] or {})
    merged_prov.update(provenance or {})
    tls["values"] = merged or None
    tls["provenance"] = merged_prov or None
    try:
        yield
    finally:
        tls["values"], tls["provenance"] = prev


def current_overlay() -> Dict[str, Any]:
    """The calling thread's active overlay values ({} outside a scope)."""
    return dict(_overlay_tls.__dict__.get("values") or {})


def current_provenance() -> Dict[str, str]:
    return dict(_overlay_tls.__dict__.get("provenance") or {})


def knob_catalog_md() -> str:
    """Render the README 'Configuration knobs' table from the registry
    (python -c "from blaze_tpu_torch.config import knob_catalog_md; ..." — or
    regenerate via tools/blazelint's docs helper)."""
    lines = ["| knob | default | env | purpose |",
             "|---|---|---|---|"]
    for k in _DECLARATIONS:
        default = "`{}`".format(
            "{}" if k.default_factory is not None else repr(k.default))
        env = f"`{k.env}`" if k.env else ""
        doc = " ".join(k.doc.split())
        lines.append(f"| `{k.name}` | {default} | {env} | {doc} |")
    return "\n".join(lines)


conf = BlazeConf()
