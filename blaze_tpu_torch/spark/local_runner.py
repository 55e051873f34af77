"""Local multi-stage execution: the test/standalone stand-in for Spark.

Port of blaze_tpu/spark/local_runner.py. Ref topology: SURVEY.md §3.3 —
in deployment, Spark schedules stages and moves shuffle blocks; this
runner executes the same per-task native plans (stages.plan_stages
output) in dependency order in one process, wiring the resource registry
exactly the way the JVM shim would:

  map stage    : one task per upstream partition; each commits
                 <dir>/shuffle_<S>_<M>.data/.index through the
                 shuffle-manager drop-in (spark/shuffle_manager.py)
  reduce reads : "shuffle:<S>" resolves to a per-partition iterator over
                 all map outputs' partition-p segments (the MapStatus fetch)
  broadcast    : one collect task; "broadcast:<S>" replays its frames

Every stage's tasks run under a per-query `Supervisor`
(runtime/supervisor.py): a pool of conf.max_concurrent_tasks threads, the
retry / degrade / row-interpreter ladder of
executor.run_task_with_resilience, the watchdog, speculation and the
per-operator circuit breaker. Off (conf.enable_supervisor False), tasks
run inline on the driver thread under the same ladder. Scans, shuffle
writes and reads and spill reads pipeline through runtime/pipeline.py.
Each query is a "query" span in the trace (runtime/trace.py), and with
conf.journal_dir set a write-ahead journal (runtime/journal.py) records
its admission, plan, stage commits and completion; a restarted driver
reuses a crashed query's verified stage commits. Tasks run on `device`
(None: the CUDA card). Every NeverConvert subtree runs on the row
interpreter (spark/fallback.py) on the host, and its rows enter the
native pipeline through the FFI bridge (FfiReaderExec).

With a process pool active (runtime/executor_pool.activate), a shuffle
map stage whose every input is servable over the pool's shuffle server
(`_pool_stage_rids`: committed shuffle partitions, `:all` reads included,
and broadcast frame lists) runs its tasks in the pool's worker processes
(`_run_shuffle_stage_pooled`), each on the run's device; a pool that
cannot run it degrades the stage to the in-process route
("pool_to_thread"). With mesh_exchange="auto" (the default, as in the
JAX package) a hash-partitioned shuffle map stage on plain column keys
next tries the device-mesh exchange (parallel/stage_exchange.py): its
partitions stay in device memory and no file is written; a stage the
mesh declines, or whose mesh attempt fails with a transient or resource
error, takes the file path. runtime/monitor.py accounts the query's
bytes at every copy boundary and merges its roll-up into run_info
(conf.monitor_enabled, on by default), and its leak check runs on every
query.

The observability layer hangs off the same hooks as in the JAX package:
the history store's taps (conf.history_dir, runtime/history.py), live
progress (conf.progress_enabled, runtime/progress.py), the per-query
trace and ledger export (conf.trace_export_dir, trace.export_query), the
sampling profiler's export (conf.profile_enabled with
conf.profile_export_dir, runtime/profiler.py) and the flight recorder's
dossiers (conf.flight_dir, runtime/flight_recorder.py).

The service and control layer hangs off it too, as in the JAX package:
a `session` (runtime/service.QuerySession) names the query's id, tenant
and admission-stamped deadline and routes its tasks through the
service's shared FairScheduler; the conf overlays (tenant, autopilot
fingerprint, per-query pins: config.resolve_overlay) scope the stage
loop; the autopilot (conf.autopilot_enabled, runtime/autopilot.py) reads
its overlay before the stages and observes the run after; and
conf.metrics_port starts the monitor's endpoint and sampler. As in the
JAX package, `run_plan` reads the active pool, not conf.executor_count.
"""

from __future__ import annotations

import base64
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from blaze_tpu_torch import config
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike, resolve_device
from blaze_tpu_torch.ops.base import ExecContext, Operator
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.plan import decode_plan, fingerprint_plan
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.fingerprint import fingerprint_query
from blaze_tpu_torch.plan.to_proto import encode_schema
from blaze_tpu_torch.runtime import (
    artifacts, executor_pool, faults, history, journal, memory, metrics,
    monitor, pipeline, resources, trace,
)
from blaze_tpu_torch.runtime import supervisor as supervisor_mod
from blaze_tpu_torch.runtime.executor import (
    TASK_METRICS, execute_plan, run_task_with_resilience, task_metrics,
)
from blaze_tpu_torch.runtime.supervisor import Supervisor, TaskSpec
from blaze_tpu_torch.spark import converters
from blaze_tpu_torch.spark.aqe import (
    _all_partitions_resource, apply_dynamic_join_selection,
)
from blaze_tpu_torch.spark.convert_strategy import apply_strategy
from blaze_tpu_torch.spark.plan_model import SparkPlan
from blaze_tpu_torch.spark.shuffle_manager import BlazeShuffleManager
from blaze_tpu_torch.spark.stages import Stage, local_resource_id, plan_stages

# Conversion critical section: converters._pending_exports is a process
# global, so [discard stale, convert, drain] must be atomic per query.
_convert_lock = threading.Lock()

def run_plan(root: SparkPlan, num_partitions: int = 4,
             work_dir: Optional[str] = None,
             mesh_exchange: str = "auto",
             mesh_quota: Optional[int] = None,
             run_info: Optional[Dict[str, int]] = None,
             session=None, device: DeviceLike = None) -> ColumnBatch:
    """Convert + execute a Spark plan tree locally; returns the collected
    result batch, on `device` (None: the CUDA card).

    mesh_exchange: "auto" runs each shuffle stage's exchange in device
    memory over the device mesh (parallel/stage_exchange.py), falling
    back to the file path on quota overflow or unsupported shapes; "off"
    always uses .data/.index files. mesh_quota caps the staging rows a
    device sends one device (None: no overflow possible).

    run_info: optional dict populated with execution-path counters
    ("pool_stages", "mesh_stages", "file_stages", "broadcast_stages",
    "map_tasks_run", "recovered_stages", and executor.TASK_METRICS
    summed over every task, pooled ones included), the accumulate
    kernel's launches that pool workers reported ("pool_kernel_launches")
    and the seconds their first plan tasks spent importing the engine and
    making a CUDA context ("pool_engine_start_s"), the device bytes the
    mesh stages kept on the device ("mesh_pinned_bytes", each stage's
    count of the half-budget rule, summed), each
    stage's kind and host wall time ("stage_s"), the query's "query_id",
    the resilience counters of the ladder and the supervisor ("retries",
    "degradations", "degraded.<rung>", "ladder_rung", "errors.<category>",
    "task_fallbacks", "breaker_trips", "hangs_detected",
    "speculations_launched", "speculations_won", "faults_injected", ...),
    the pipeline's ("pipeline_streams", "pipeline_live_streams"), and its
    host crossings: the FFI bridge's row-interpreter exports, their rows
    and host seconds ("fallback_exports", "bridge_rows", "bridge_s"), the
    batches FfiReaderExec handed on and those of them on the card
    ("bridge_batches", "bridge_card_batches"), and the host-evaluated
    functions' and UDF wrappers' crossings and host seconds
    ("hostfn_crossings", "hostfn_s", "udf_crossings", "udf_s"), this
    query's own accumulate-kernel launches, in this process and its pool
    workers, and its own host pulls ("kernel_launches", "host_pulls": a
    per-query metrics.task_tally that the supervisor's and the pipeline's
    threads rejoin, so concurrent sessions count apart), and with
    conf.monitor_enabled the monitor's roll-up ("bytes_copied_<boundary>",
    "bytes_moved_<boundary>" and their "_total"s, "peak_mem_bytes",
    "spill_bytes", "spill_count", the zero-copy counts and one
    "<category>_ms" a time category seen). "resource_leaks" is there
    whatever the knob says.

    With conf.trace_enabled the whole run is a "query" span in the trace
    (runtime/trace.py), and every stage and task below inherits its
    query_id.

    session: the QuerySession (runtime/service.py) when running under
    the multi-tenant service: it carries the tenant id, priority, the
    shared fair scheduler, the admission-stamped deadline, and the
    per-session batch-target override. None: a standalone query."""
    if run_info is None:
        run_info = {}
    dev = resolve_device(device)
    qid = (session.query_id if session is not None
           else run_info.get("query_id")) or trace.new_query_id()
    run_info["query_id"] = qid
    tenant = (session.tenant_id if session is not None
              else run_info.get("tenant_id", "")) or ""
    if tenant:
        run_info["tenant_id"] = tenant
    for key in (("pool_stages", "pool_kernel_launches",
                 "pool_engine_start_s", "mesh_stages",
                 "mesh_pinned_bytes", "file_stages", "broadcast_stages",
                 "map_tasks_run", "recovered_stages")
                + TASK_METRICS):
        run_info.setdefault(key, 0)
    run_info.setdefault("stage_s", [])
    mgr = memory.get_manager()
    # resource accounting: register the active query (the attribution
    # fallback of a thread with no query in its context), reset the
    # memory high-water mark, and lazily start the metrics endpoint and
    # sampler when conf.metrics_port is set
    monitor.begin_query(qid, mgr)
    # query-history taps: per-op row counts and whole-stage group
    # cardinality accumulate under this qid until record_run pops them
    # at close (no-op with conf.history_dir unset)
    history.begin_query(qid)
    # write-ahead journal: the admission record opens this query's
    # crash-recovery log (no-op with journal_dir unset); the terminal
    # record in the finally below settles it. Stream micro-batches
    # (run_info["stream"], runtime/streaming.py) skip per-batch
    # journals: the stream's checkpoint record is the durability unit
    jnl = (None if run_info.get("stream") else journal.journal_for(qid))
    if jnl is not None:
        jnl.admitted(tenant_id=tenant)
    if conf.progress_enabled:
        from blaze_tpu_torch.runtime import progress

        progress.begin_query(qid, tenant_id=tenant or None)
    # the query's driver thread advertises its session for ladder/batch
    # scoping (supervisor.current_session); pool workers inherit it
    # through their _Task instead
    prev_session = getattr(supervisor_mod._current, "session", None)
    supervisor_mod._current.session = session
    # this query's kernel launches and host pulls, apart from any other
    # query's running at the same time (the process-wide counters mix
    # them): the supervisor's and the pipeline's threads rejoin the tally
    outer_tally = metrics.current_tally()
    try:
        # correlation ids pushed whether or not tracing is on (a cheap
        # stack push): pool threads replay them per task
        with trace.context(query_id=qid, tenant_id=tenant or None), \
                metrics.task_tally() as tally:
            try:
                with trace.profiled_span("run_plan"):
                    with trace.span("query", query_id=qid,
                                    num_partitions=num_partitions,
                                    mesh_exchange=mesh_exchange):
                        return _run_plan_inner(
                            root, num_partitions, work_dir, mesh_exchange,
                            mesh_quota, run_info, dev, jnl, session)
            finally:
                _note_tally(tally, outer_tally, run_info)
    finally:
        supervisor_mod._current.session = prev_session
        # the flight recorder needs the query's wall-clock start for its
        # monitor-ring slice; finish_query pops the acct holding it
        t0 = monitor.query_t0(qid) if conf.flight_dir else None
        # the roll-up (bytes by boundary, peak memory, spill) merged into
        # run_info before the ledger export, and the always-on leak check
        monitor.finish_query(qid, run_info, mgr)
        # export even on failure: a failed query's trace is the one you
        # most want to read
        if conf.trace_enabled and conf.trace_export_dir:
            trace.export_query(qid, run_info)
        # per-query profile (collapsed stacks + speedscope), the same
        # export-even-on-failure rule
        if conf.profile_enabled and conf.profile_export_dir:
            from blaze_tpu_torch.runtime import profiler

            profiler.export_query(qid)
        # the run's fingerprinted statistics, after the monitor roll-up
        # so the record carries the byte and spill counters
        rec = (history.record_run(qid, run_info)
               if conf.history_dir else None)
        if conf.autopilot_enabled and conf.autopilot_dir:
            # autopilot post-run hook: verdict a canary against the
            # settled baseline, or propose the next one-knob exploration,
            # off the record just persisted
            from blaze_tpu_torch.runtime import autopilot

            autopilot.observe(qid, run_info, rec)
        if jnl is not None:
            # a journal with a complete line never enters a replay
            exc = sys.exc_info()[1]
            jnl.complete("failed" if exc is not None else "ok",
                         error=type(exc).__name__ if exc is not None
                         else "")
        if conf.flight_dir:
            # black-box dossier on failure / deadline / hang / leak: it
            # classifies the in-flight exception via sys.exc_info (this
            # finally runs while it propagates)
            from blaze_tpu_torch.runtime import flight_recorder

            flight_recorder.on_query_end(qid, run_info, started_at=t0)
        if conf.progress_enabled:
            from blaze_tpu_torch.runtime import progress

            progress.finish_query(qid)


def _note_tally(tally: Dict[str, int], outer: Optional[Dict[str, int]],
                run_info: Dict) -> None:
    """The query's tally into run_info: its in-process kernel launches
    plus its pool workers' (pool_kernel_launches), and its host pulls;
    then into the caller's tally, if one was open."""
    launches = tally.get("kernel_launches", 0)
    pulls = tally.get("host_pulls", 0)
    run_info["kernel_launches"] = (launches
                                   + run_info.get("pool_kernel_launches", 0))
    run_info["host_pulls"] = pulls
    if outer is not None:
        metrics.tally_add("kernel_launches", launches)
        metrics.tally_add("host_pulls", pulls)


def _run_plan_inner(root: SparkPlan, num_partitions: int,
                    work_dir: Optional[str], mesh_exchange: str,
                    mesh_quota: Optional[int], run_info: Dict,
                    device, jnl, session=None) -> ColumnBatch:
    # task setup reclaims dead writers' leftover spill files
    artifacts.sweep_orphans([conf.spill_dir])
    # driver-crash recovery: replay incomplete journals once per process;
    # verified stage commits land in the resume map each shuffle-map
    # stage consults below
    journal.ensure_recovery_scan()
    # the trace export dir is bounded to conf.history_retention_runs
    # (ledger.jsonl lines + trace_<qid>.json files)
    if conf.trace_export_dir:
        trace.rotate_export_dir()
    telemetry_before = faults.TELEMETRY.snapshot()
    pipeline_before = pipeline.TELEMETRY.snapshot()
    qid = run_info["query_id"]
    ns = f"{qid}/"
    with _convert_lock:
        apply_strategy(root)
        converters.drain_exports()  # discard stale prior conversions
        stages = plan_stages(root, default_partitions=num_partitions,
                             namespace=qid)
        exports = converters.drain_exports()
    if exports:
        # the ConvertToNativeBase.scala:59-98 handshake: each NeverConvert
        # subtree runs on the row interpreter and feeds FfiReaderExec
        from blaze_tpu_torch.spark import fallback

        for rid, subtree in exports.items():
            def provider(partition, nparts, _p=subtree):
                return fallback.export_iterator(_p, partition, nparts)
            resources.put(rid, provider)
    crossings = _crossings()
    # pre-AQE query fingerprint: pins the journal's plan record AND keys
    # the autopilot's persisted overlay (stable across runs of the same
    # plan and known before execution)
    query_fp = fingerprint_query([fingerprint_plan(s.plan)
                                  for s in stages])
    if jnl is not None:
        # the plan record pins what this journal is a log OF: the
        # pre-AQE query fingerprint and the stage skeleton (per-stage
        # fingerprints, the resume keys, ride each stage_commit)
        jnl.plan(fingerprint=query_fp,
                 num_partitions=num_partitions,
                 stages=[{"stage_id": s.stage_id, "kind": s.kind,
                          "num_partitions": s.num_partitions,
                          "plan_proto": base64.b64encode(
                              s.plan.SerializeToString()).decode()}
                         for s in stages])
    # conf overlays + the self-tuning autopilot: resolve base -> tenant
    # -> per-fingerprint -> per-query pin (config.resolve_overlay
    # validates each layer against KNOBS); the values ride a thread-local
    # scope around the stage loop below (supervisor tasks replay it
    # around every attempt), and the record with per-value provenance is
    # stamped into run_info for the ledger, history and flight dossiers
    fp_overlay: Dict[str, object] = {}
    canary_knob = ""
    if conf.autopilot_enabled and conf.autopilot_dir:
        from blaze_tpu_torch.runtime import autopilot

        fp_overlay, canary_knob = autopilot.overlay_for(query_fp)
    resolved = config.resolve_overlay(
        tenant=run_info.get("tenant_id") or None,
        fingerprint_overlay=fp_overlay or None,
        pin=run_info.get("conf_pins") or None)
    if canary_knob:
        resolved.canary = True
        resolved.canary_knob = canary_knob
    if resolved.values or (conf.autopilot_enabled and conf.autopilot_dir):
        run_info["autopilot"] = dict(resolved.as_record(),
                                     fingerprint=query_fp)
    if fp_overlay:
        trace.event("autopilot_apply", fingerprint=query_fp,
                    overlay_hash=resolved.hash or "",
                    canary=bool(canary_knob), canary_knob=canary_knob,
                    knobs=",".join(sorted(fp_overlay)))
    work_dir = work_dir or tempfile.mkdtemp(prefix="blaze_tpu_torch_stages_")
    os.makedirs(work_dir, exist_ok=True)

    shuffle_mgr = BlazeShuffleManager(work_dir)
    # AQE statistics: completed shuffles' total bytes + partition counts
    shuffle_bytes: Dict[int, int] = {}
    shuffle_parts: Dict[int, int] = {}
    # the query's worker pool, watchdog, speculation and circuit breaker;
    # off, each stage runs inline on this thread
    # under the service the session routes tasks through the SHARED fair
    # scheduler and carries the admission-stamped query deadline; breaker
    # state stays per query (one Supervisor per run_plan)
    sup = Supervisor(run_info, session=session, device=device)
    # process-isolated executors (runtime/executor_pool.py): when a pool
    # is active, eligible shuffle-map stages ship their task plans to
    # worker PROCESSES (crash containment) instead of the thread pool;
    # the pool failing degrades back to the in-process path below
    pool = executor_pool.active()
    # live-progress taps: one is-None check per stage when off
    if conf.progress_enabled:
        from blaze_tpu_torch.runtime import progress
    else:
        progress = None
    _ov = None
    try:
        if resolved.values:
            # overlay scope entered INSIDE the try so the finally is its
            # only exit path: conf reads on this thread (and, via the
            # supervisor's per-task replay, on worker threads) see the
            # resolved values for exactly the stage loop's duration
            _ov = config.overlay_scope(resolved.values, resolved.provenance)
            _ov.__enter__()
        for stage in stages:
            t0 = time.perf_counter()
            # re-optimize THIS stage with the statistics of completed
            # shuffles before running it (ref: AQE per-stage re-entry)
            if shuffle_bytes:
                apply_dynamic_join_selection(stage.plan, shuffle_bytes,
                                             shuffle_parts)
            # the executed (post-AQE) shape's fingerprint: the journal's
            # resume key, the stage span's attribute and the history
            # store's stage key
            fp = (fingerprint_plan(stage.plan)
                  if conf.trace_enabled or conf.history_dir
                  or jnl is not None else None)
            if progress is not None:
                progress.stage_begin(
                    qid, stage.stage_id, stage.kind, fingerprint=fp,
                    tasks=(1 if stage.kind == "broadcast"
                           else _input_tasks(stage, stages,
                                             fallback=num_partitions)))
            if stage.kind == "shuffle_map":
                shuffle_parts[stage.stage_id] = stage.num_partitions
                with trace.context(stage_id=stage.stage_id), \
                        trace.span("stage", stage_id=stage.stage_id,
                                   stage_kind="shuffle_map",
                                   fingerprint=fp,
                                   tasks=_input_tasks(stage, stages)) as sp:
                    logical, transport = None, "journal"
                    if jnl is not None and fp:
                        # a crashed driver's verified stage commit for
                        # this fingerprint: reuse it, no map task runs
                        logical = _resume_shuffle_stage(
                            stage, stages, shuffle_mgr, fp, jnl, run_info,
                            ns, device)
                    prids = (_pool_stage_rids(stage)
                             if logical is None and pool is not None
                             else None)
                    if prids is not None and _served(pool, prids):
                        logical, transport = _pooled_or_none(
                            stage, stages, shuffle_mgr, pool, run_info, ns,
                            prids, device, jnl, fp), "pool"
                    if logical is None and mesh_exchange == "auto":
                        logical, transport = _run_mesh_stage(
                            stage, stages, mesh_quota, work_dir, run_info,
                            ns, device), "mesh"
                    if logical is None:
                        logical, transport = _run_shuffle_stage(
                            stage, stages, shuffle_mgr, sup, run_info, ns,
                            device, jnl=jnl, fp=fp), "file"
                        run_info["file_stages"] += 1
                    sp.set(transport=transport, bytes=logical,
                           **monitor.stage_span_attrs(qid, stage.stage_id))
                    shuffle_bytes[stage.stage_id] = logical
            elif stage.kind == "broadcast":
                with trace.context(stage_id=stage.stage_id), \
                        trace.span("stage", stage_id=stage.stage_id,
                                   stage_kind="broadcast",
                                   fingerprint=fp, tasks=1) as sp:
                    frames = _run_broadcast_stage(stage, stages, sup,
                                                  run_info, ns, device)
                    if pool is not None:
                        # executors read broadcasts from the driver's
                        # shuffle server, the frames the local provider
                        # replays
                        pool.server.register_frames(
                            f"{ns}broadcast:{stage.stage_id}", frames)
                    sp.set(**monitor.stage_span_attrs(qid, stage.stage_id))
                run_info["broadcast_stages"] += 1
            else:
                parts = _input_tasks(stage, stages, fallback=num_partitions)
                with trace.context(stage_id=stage.stage_id), \
                        trace.span("stage", stage_id=stage.stage_id,
                                   stage_kind="result",
                                   fingerprint=fp, tasks=parts) as sp:
                    out = _run_result_stage(stage, parts, sup, run_info,
                                            device)
                    sp.set(**monitor.stage_span_attrs(qid, stage.stage_id))
            if progress is not None:
                progress.stage_end(qid, stage.stage_id)
            # a stage ends in host reads (commits, frames, the collect),
            # so the host clock covers its device work
            run_info["stage_s"].append(
                [stage.kind, time.perf_counter() - t0])
            if stage.kind == "result":
                return _merge_fallback_root_sort(root, out, parts)
        raise AssertionError("no result stage produced")
    finally:
        if _ov is not None:
            _ov.__exit__(None, None, None)
        sup.close()
        faults.run_info_delta(telemetry_before, run_info)
        # the query's pipelined streams and sinks, and the ones still
        # open (0 once every task stream is torn down)
        after = pipeline.TELEMETRY.snapshot()
        run_info["pipeline_streams"] = (
            after.get("streams_opened", 0) + after.get("sinks_opened", 0)
            - pipeline_before.get("streams_opened", 0)
            - pipeline_before.get("sinks_opened", 0))
        run_info["pipeline_live_streams"] = pipeline.live_streams()
        for key, value in _crossings().items():
            run_info[key] = run_info.get(key, 0) + value - crossings[key]
        # release the query's registry entries and shuffle files
        for rid in exports:
            resources.pop(rid)
        for stage in stages:
            for key in (f"{ns}shuffle:{stage.stage_id}",
                        f"{ns}shuffle:{stage.stage_id}:all",
                        f"{ns}broadcast:{stage.stage_id}",
                        f"{ns}broadcast_sink:{stage.stage_id}"):
                resources.pop(key)
            if pool is not None:
                pool.server.unregister(f"{ns}shuffle:{stage.stage_id}")
                pool.server.unregister(f"{ns}broadcast:{stage.stage_id}")
            shuffle_mgr.unregister_shuffle(stage.stage_id)


def _run_mesh_stage(stage: Stage, stages: List[Stage],
                    mesh_quota: Optional[int], work_dir: str, run_info: Dict,
                    ns: str, device) -> Optional[int]:
    """The stage's exchange over the device mesh; its logical bytes, or
    None when the mesh declines the stage or its attempt fails with an
    error another transport may not meet (then the file path runs it: the
    same row multisets). A plan, fatal or killed error relays: another
    transport won't fix a broken plan."""
    from blaze_tpu_torch.parallel.stage_exchange import (
        run_mesh_shuffle_stage,
    )

    stats: Dict = {}
    try:
        ok = run_mesh_shuffle_stage(
            stage.plan, stage.stage_id, _input_tasks(stage, stages),
            quota=mesh_quota, work_dir=work_dir, stats=stats, namespace=ns,
            device=device)
    except Exception as e:  # noqa: BLE001 — classified
        cat = faults.classify(e)
        if cat in ("killed", "fatal", "plan"):
            raise
        faults.note_error(cat, run_info)
        faults.note_degradation("mesh_to_file", run_info)
        trace.event("degrade", what="mesh_to_file", category=cat,
                    error=type(e).__name__)
        return None
    if not ok:
        return None
    for op in stats["ops"]:
        _note_metrics(op, run_info)
    run_info["mesh_stages"] += 1
    run_info["mesh_pinned_bytes"] += stats["pinned"]
    return stats.get("bytes", 0)


def _pooled_or_none(stage: Stage, stages: List[Stage], shuffle_mgr, pool,
                    run_info: Dict, ns: str, rids: List[str], device, jnl,
                    fp) -> Optional[int]:
    """The stage on the process pool; its logical bytes, or None when the
    pool cannot run it (no live executor, exhausted retries): then the
    in-process transports run it, the same row multisets either way. A
    fatal or plan error relays. Two departures from the JAX package,
    whose degradation these block: a pool with no live executor
    (PoolUnavailableError, a ConnectionError that faults.classify calls
    fatal) counts as a resource error and degrades; and the degraded
    stage's registration is dropped so the file path can register it
    again."""
    try:
        logical = _run_shuffle_stage_pooled(
            stage, stages, shuffle_mgr, pool, run_info, ns, rids, device,
            jnl=jnl, fp=fp)
    except Exception as e:  # noqa: BLE001 — classified
        cat = ("resource" if isinstance(e, executor_pool.PoolUnavailableError)
               else faults.classify(e))
        if cat in ("fatal", "plan"):
            raise
        shuffle_mgr.unregister_shuffle(stage.stage_id, delete_files=False)
        faults.note_error(cat, run_info)
        faults.note_degradation("pool_to_thread", run_info)
        trace.event("degrade", what="pool_to_thread", category=cat,
                    error=type(e).__name__)
        return None
    run_info["pool_stages"] += 1
    return logical


def _crossings() -> Dict[str, float]:
    """The process's host-crossing counters under their run_info names."""
    from blaze_tpu_torch.runtime import metrics

    ev, br = metrics.HOST_EVAL, metrics.BRIDGE
    return {"fallback_exports": br["exports"], "bridge_rows": br["rows"],
            "bridge_s": br["ns"] / 1e9, "bridge_batches": br["batches"],
            "bridge_card_batches": br["card_batches"],
            "hostfn_crossings": ev["hostfn"][0],
            "hostfn_s": ev["hostfn"][1] / 1e9,
            "udf_crossings": ev["udf"][0], "udf_s": ev["udf"][1] / 1e9}


def _merge_fallback_root_sort(root: SparkPlan, out: ColumnBatch,
                              parts: int) -> ColumnBatch:
    """Ordered collect for a NeverConvert root sort or limit: a native
    root merges in _run_result_stage, but a fallback root ordered and
    limited each partition only, so merge on the row engine: sort the
    partitions' rows again (the sort under a root limit, if any) and
    apply the root limit."""
    lim = None
    srt = root
    if root.kind in ("GlobalLimitExec", "LocalLimitExec"):
        lim = root.attrs["limit"]
        srt = root.children[0]
        while srt.kind == "LocalLimitExec":
            lim = min(lim, srt.attrs["limit"])
            srt = srt.children[0]
    if parts <= 1 or root.strategy != "NeverConvert" or (
            lim is None and root.kind != "SortExec"):
        return out
    import pandas as pd

    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow
    from blaze_tpu_torch.spark import fallback

    df = pd.DataFrame(out.to_numpy())
    if srt.kind == "SortExec":
        df = fallback._op_sort_frame(
            SparkPlan("SortExec", root.schema, [], dict(srt.attrs)), df)
    if lim is not None:
        df = df.head(lim).reset_index(drop=True)
    return batch_from_arrow(fallback._to_arrow(df, root.schema),
                            schema=root.schema, device=out.device)


def _input_tasks(stage: Stage, stages: List[Stage],
                 fallback: int = 1) -> int:
    """Task count for a stage = its upstream shuffle partition count;
    `fallback` when it has dependencies but none are shuffles (scans -> 1)."""
    if not stage.depends_on:
        return 1
    upstream = [stages[d].num_partitions for d in stage.depends_on
                if stages[d].kind == "shuffle_map"]
    return max(upstream) if upstream else fallback


def _note_metrics(op: Operator, run_info: Dict) -> None:
    """Add a finished task's TASK_METRICS to run_info."""
    for key, value in task_metrics(op).items():
        run_info[key] += value


def _run_shuffle_stage(stage: Stage, stages: List[Stage], shuffle_mgr,
                       sup: Supervisor, run_info: Dict, ns: str, device,
                       jnl=None, fp=None) -> int:
    """Runs the map tasks through the shuffle manager (register ->
    per-task writer slot -> commit MapStatus -> reduce-side reader
    resource); returns the stage's total LOGICAL output bytes
    (uncompressed, live rows only — the AQE statistic).

    Each map task is a re-runnable resilience unit: the writer's
    crash-atomic commit means a failed attempt left no final files, so a
    retry runs again. A speculative twin and its primary arbitrate the
    publish through the context's commit gate. The ladder's last rung
    re-runs the task's map subtree (stage.source) on the row interpreter,
    feeding the native shuffle writer through an ipc_reader: the
    committed files have the same format either way."""
    ntasks = _input_tasks(stage, stages)
    # the reader schema is the writer's input schema
    reader_schema = decode_plan(stage.plan.shuffle_writer.input).schema
    handle = shuffle_mgr.register_shuffle(
        stage.stage_id, stage.num_partitions, reader_schema)
    op_kinds = stage.op_kinds()
    specs: List[TaskSpec] = []
    slots = []
    for task in range(ntasks):
        node = pb.PlanNode()
        node.CopyFrom(stage.plan)
        slot = shuffle_mgr.get_writer(handle, task)
        node.shuffle_writer.data_file = slot.data_path
        node.shuffle_writer.index_file = slot.index_path

        def attempt(ctx, node=node):
            op = decode_plan(node)  # fresh operator state per attempt
            list(execute_plan(op, ctx))
            return op

        fb = (None if stage.source is None else
              lambda node=node, task=task: _fallback_shuffle_task(
                  stage, node, task, ntasks, device))
        specs.append(TaskSpec(
            what=f"shuffle_map[{stage.stage_id}:{task}]",
            attempt_fn=attempt, partition=task, num_partitions=ntasks,
            fallback_fn=fb, op_kinds=op_kinds))
        slots.append(slot)
    ops = sup.run_tasks(("shuffle", stage.stage_id), specs)
    logical = 0
    for task, (op, slot) in enumerate(zip(ops, slots)):
        _note_metrics(op, run_info)
        written = op.metrics["shuffle_logical_bytes"]
        trace.record_value("shuffle_write_bytes", written)
        logical += written
        _register_slot_repair(stage, slot, task, ntasks, run_info, device)
        slot.commit()
    run_info["map_tasks_run"] += ntasks
    if jnl is not None and fp:
        jnl.stage_commit(stage.stage_id, fp, logical,
                         _journal_outputs(slots))
    resources.put(f"{ns}shuffle:{stage.stage_id}",
                  lambda partition: shuffle_mgr.get_reader_host(handle,
                                                                partition))
    return logical


def _pool_stage_rids(stage: Stage) -> Optional[List[str]]:
    """Reader resource ids of a shuffle-map stage when EVERY one is
    servable to executor processes over the driver's shuffle server
    (committed shuffle partitions, including `:all` build-side reads,
    which workers reassemble by fetching every partition of the base
    rid, mmap-first, and broadcast frame lists). None marks the stage
    pool-ineligible: it needs driver-local state a worker process cannot
    reach (FFI export iterators, UDF eval callbacks, RSS/sink consumers,
    fs providers), and it runs in-process instead."""
    rids: List[str] = []
    servable = True

    def walk(msg) -> None:
        nonlocal servable
        for fd, val in msg.ListFields():
            if fd.type == fd.TYPE_MESSAGE:
                vals = val if _is_repeated_field(fd) else (val,)
                for v in vals:
                    walk(v)
            elif fd.name == "provider_resource_id":
                local = local_resource_id(val)
                if (local.startswith("shuffle:")
                        or local.startswith("broadcast:")):
                    rids.append(val)
                else:
                    servable = False
            elif fd.name.endswith("resource_id") and val:
                servable = False

    walk(stage.plan)
    return rids if servable else None


def _served(pool, rids: List[str]) -> bool:
    """Every rid the stage reads is registered on the pool's shuffle
    server (a port-only check: an upstream stage the mesh exchanged, or
    one that degraded, left no files there, and the JAX package would
    send the stage to workers that cannot fetch it)."""
    registered = set(pool.server.registered())
    return all((r[:-len(":all")] if r.endswith(":all") else r)
               in registered for r in rids)


def _is_repeated_field(fd) -> bool:
    # protobuf >= 5.x deprecates FieldDescriptor.label (plan/fingerprint)
    rep = getattr(fd, "is_repeated", None)
    if rep is not None and not callable(rep):
        return bool(rep)
    return fd.label == fd.LABEL_REPEATED


def _run_shuffle_stage_pooled(stage: Stage, stages: List[Stage],
                              shuffle_mgr, pool, run_info: Dict, ns: str,
                              rids: List[str], device, jnl=None,
                              fp=None) -> int:
    """The map stage on the PROCESS pool: each task's plan proto ships to
    an executor over the control socket, with the run's device in its
    payload; the worker epoch-stamps the writer paths, reads upstream
    input from the driver's shuffle server, and commits crash-atomically
    in its own process. The driver admits each result through the epoch
    fence, points the writer slot at the accepted attempt's files,
    commits the MapStatus, sweeps stale-epoch twins, adds the task's
    metrics and kernel launches to run_info, and publishes the outputs
    to BOTH registries: the in-process resource registry (downstream
    result and broadcast stages run locally) and the shuffle server
    (downstream POOLED stages fetch from workers)."""
    ntasks = _input_tasks(stage, stages)
    reader_schema = decode_plan(stage.plan.shuffle_writer.input).schema
    handle = shuffle_mgr.register_shuffle(
        stage.stage_id, stage.num_partitions, reader_schema)
    # driver-issued correlation ids ride the task payload: the worker
    # replays them into its trace context, so executor-side spans and
    # counter attribution share the driver's query/stage/task ids (the
    # telemetry-federation join key)
    ctx = trace.current_context()
    # `:all` build-side reads: the worker reassembles the whole relation
    # by fetching every partition of the base rid (mmap-first), so ship
    # each one's partition count, the only driver-local fact it needs
    rid_parts = {}
    # each upstream shuffle's WRITE schema (a final aggregate's reader
    # node may name fewer columns than the partial state holds): the
    # worker decodes fetched frames with it, as the in-process provider
    # (get_reader_host) does; the JAX package decodes with the reader
    # node's schema and fails there (tpcds q04, SMJ)
    rid_schemas = {}
    for rid in rids:
        local = local_resource_id(rid)
        if local.startswith("shuffle:"):
            sid = int(local.split(":")[1])
            if local.endswith(":all"):
                rid_parts[rid] = stages[sid].num_partitions
            rid_schemas[rid] = base64.b64encode(encode_schema(
                shuffle_mgr.handle(sid).schema).SerializeToString()
            ).decode()
    specs: List[executor_pool.PoolTaskSpec] = []
    slots = []
    for task in range(ntasks):
        node = pb.PlanNode()
        node.CopyFrom(stage.plan)
        slot = shuffle_mgr.get_writer(handle, task)
        node.shuffle_writer.data_file = slot.data_path
        node.shuffle_writer.index_file = slot.index_path
        specs.append(executor_pool.PoolTaskSpec(
            key=f"{ns}shuffle:{stage.stage_id}:{task}",
            kind="plan",
            payload={"partition": task, "num_partitions": ntasks,
                     "rids": rids, "rid_parts": rid_parts,
                     "rid_schemas": rid_schemas,
                     "device": str(device),
                     "query_id": ctx.get("query_id"),
                     "tenant_id": ctx.get("tenant_id"),
                     "stage_id": stage.stage_id,
                     "task_id": task,
                     "what": f"shuffle_map[{stage.stage_id}:{task}]"},
            blob=node.SerializeToString(),
            what=f"shuffle_map[{stage.stage_id}:{task}]"))
        slots.append(slot)
    results = pool.run_tasks(specs)
    logical = 0
    for task, (res, slot) in enumerate(zip(results, slots)):
        base_data, base_index = slot.data_path, slot.index_path
        # the accepted attempt's epoch-stamped pair becomes the slot's
        # committed artifact; every fenced twin is swept
        slot.data_path = res["data_path"]
        slot.index_path = res["index_path"]
        written = int(res.get("logical_bytes", 0))
        trace.record_value("shuffle_write_bytes", written)
        logical += written
        for key, value in (res.get("task_metrics") or {}).items():
            run_info[key] += value
        run_info["pool_kernel_launches"] += int(
            res.get("kernel_launches", 0))
        run_info["pool_engine_start_s"] += float(
            res.get("engine_start_s", 0.0))
        # repairs re-run in-process even for pool-committed outputs: the
        # reader resources the map subtree needs are in BOTH registries
        _register_slot_repair(stage, slot, task, ntasks, run_info, device)
        slot.commit()
        artifacts.sweep_stale_epochs(
            base_data, base_index, artifacts.epoch_of(res["data_path"]))
    run_info["map_tasks_run"] += ntasks
    if jnl is not None and fp:
        jnl.stage_commit(stage.stage_id, fp, logical,
                         _journal_outputs(slots))
    resources.put(f"{ns}shuffle:{stage.stage_id}",
                  lambda partition: shuffle_mgr.get_reader_host(handle,
                                                                partition))
    pool.server.register_shuffle(
        f"{ns}shuffle:{stage.stage_id}",
        [(slot.data_path, slot.index_path) for slot in slots])
    return logical


# repair attempts are epoch-stamped off this fence, so a re-run map output
# never collides with its quarantined predecessor's name
_repair_fence = artifacts.EpochFence()


def _journal_outputs(slots) -> List[dict]:
    """stage_commit payload: each map output's committed paths, epoch
    and whole-file digest (the recovery scan's cross-check)."""
    outs = []
    for slot in slots:
        crc = None
        try:
            _raw, meta = artifacts.read_index(slot.index_path)
            if meta is not None:
                crc = meta["data_crc"]
        except (OSError, faults.CorruptArtifactError):
            pass
        outs.append({"map_id": slot.map_id,
                     "data_path": slot.data_path,
                     "index_path": slot.index_path,
                     "epoch": artifacts.epoch_of(slot.data_path),
                     "data_crc": crc})
    return outs


def _register_stage_repairs(stage: Stage, slots, ntasks: int,
                            run_info=None, device=None) -> None:
    for task, slot in enumerate(slots):
        _register_slot_repair(stage, slot, task, ntasks, run_info, device)


def _register_slot_repair(stage: Stage, slot, task: int, ntasks: int,
                          run_info=None, device=None) -> None:
    """Arm lineage repair for one committed map output: on read-path
    corruption (artifacts.handle_corruption) ONLY the producing map task
    re-runs, in-process, under a fresh repair epoch so the new pair never
    collides with the quarantined names; it recommits and replaces its
    MapStatus (shuffle_manager replaces by map_id). Armed BEFORE the
    slot's own commit: the MapStatus parse is itself a verifying read.
    unregister_shuffle forgets the registration with the files."""
    node = pb.PlanNode()
    node.CopyFrom(stage.plan)

    def repair(task=task, slot=slot, node=node):
        epoch = _repair_fence.advance(slot.data_path)
        new_data = artifacts.stamp_epoch(slot.data_path, epoch)
        new_index = artifacts.stamp_epoch(slot.index_path, epoch)
        node.shuffle_writer.data_file = new_data
        node.shuffle_writer.index_file = new_index
        op = decode_plan(node)
        list(execute_plan(op, ExecContext(partition=task,
                                          num_partitions=ntasks,
                                          device=device)))
        slot.data_path, slot.index_path = new_data, new_index
        slot.commit()
        if run_info is not None:
            run_info["map_tasks_run"] = (
                run_info.get("map_tasks_run", 0) + 1)
        # the repaired pair is itself repairable; the registration under
        # the OLD name stays to serve its redirect
        artifacts.register_repair(new_data, repair)
        return new_data, new_index

    artifacts.register_repair(slot.data_path, repair)


def _resume_shuffle_stage(stage: Stage, stages: List[Stage], shuffle_mgr,
                          fp: str, jnl, run_info, ns: str = "",
                          device=None) -> Optional[int]:
    """Reuse a crashed driver's committed stage: when the recovery scan
    harvested a VERIFIED stage_commit for this stage's fingerprint, the
    journaled pairs become this run's map outputs and no map task runs
    (`map_tasks_run` shows it). Returns the stage's logical bytes, or
    None to run it normally."""
    rec = journal.take_resume(fp)
    if rec is None:
        return None
    ntasks = _input_tasks(stage, stages)
    outputs = sorted(rec.get("outputs") or [],
                     key=lambda o: int(o.get("map_id", 0)))
    if len(outputs) != ntasks:
        return None  # partitioning changed since the crash: recompute
    reader_schema = decode_plan(stage.plan.shuffle_writer.input).schema
    handle = shuffle_mgr.register_shuffle(
        stage.stage_id, stage.num_partitions, reader_schema)
    try:
        for task, out in enumerate(outputs):
            slot = shuffle_mgr.get_writer(handle, task)
            slot.data_path = str(out["data_path"])
            slot.index_path = str(out["index_path"])
            _register_slot_repair(stage, slot, task, ntasks, run_info,
                                  device)
            slot.commit()
    except (OSError, ValueError, KeyError, faults.CorruptArtifactError):
        # artifacts vanished between scan and resume: run the stage
        shuffle_mgr.unregister_shuffle(stage.stage_id, delete_files=False)
        return None
    logical = int(rec.get("logical_bytes", 0))
    trace.event("journal_replay", stage_id=stage.stage_id,
                fingerprint=fp, tasks=ntasks)
    run_info["recovered_stages"] = run_info.get("recovered_stages", 0) + 1
    journal.note_query_recovered(run_info.get("query_id", ""))
    # re-journal under THIS query's id: a second crash resumes the same
    jnl.stage_commit(stage.stage_id, fp, logical, outputs)
    resources.put(f"{ns}shuffle:{stage.stage_id}",
                  lambda partition: shuffle_mgr.get_reader_host(handle,
                                                                partition))
    return logical


def _fallback_shuffle_task(stage: Stage, node: pb.PlanNode, task: int,
                           ntasks: int, device=None):
    """Ladder rung 3 for a map task: run the map subtree on the row
    interpreter and pipe its Arrow batches into the NATIVE shuffle writer
    through an ipc_reader: repartitioning, serde and the atomic commit
    stay on the engine path, so readers cannot tell a degraded map output
    from a healthy one."""
    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow
    from blaze_tpu_torch.plan.to_proto import encode_schema
    from blaze_tpu_torch.spark import fallback
    from blaze_tpu_torch.spark.converters import bridge_schema

    sch = bridge_schema(stage.source)
    # qid-prefixed: concurrent queries run fallback tasks with the same
    # (sid, task) pair; the worker thread's trace context names the query
    qid = trace.current_context().get("query_id", "")
    rid = f"{qid}/__fallback_src:{stage.stage_id}:{task}"

    def provider(partition=task, nparts=ntasks):
        for rb in fallback.export_iterator(stage.source, partition, nparts):
            yield batch_from_arrow(rb, schema=sch, device=device)

    resources.put(rid, provider)
    try:
        node2 = pb.PlanNode()
        node2.CopyFrom(node)
        reader = pb.PlanNode()
        reader.ipc_reader.schema.CopyFrom(encode_schema(sch))
        reader.ipc_reader.provider_resource_id = rid
        reader.ipc_reader.num_partitions = ntasks
        node2.shuffle_writer.input.CopyFrom(reader)
        op = decode_plan(node2)
        # inherit the supervised task's commit gate (if any): a fallback
        # racing a speculative twin must still arbitrate the publish
        ctx = ExecContext(partition=task, num_partitions=ntasks,
                          device=device,
                          commit_gate=supervisor_mod.current_commit_gate())
        list(execute_plan(op, ctx))
        return op
    finally:
        resources.pop(rid)


def _run_broadcast_stage(stage: Stage, stages: List[Stage],
                         sup: Supervisor, run_info: Dict, ns: str,
                         device) -> List[bytes]:
    # a broadcast stage runs ONE task but must see its upstream shuffles'
    # WHOLE output — a plan like broadcast(final_agg(exchange(...)))
    # would otherwise read only partition 0 and broadcast a quarter of
    # the relation (caught by the tpcds q01 catalogue cell)
    _rewrite_shuffle_readers_all(stage.plan, stages)
    frames: List[bytes] = []
    resources.put(f"{ns}broadcast_sink:{stage.stage_id}", frames.append)

    def attempt(ctx):
        del frames[:]  # a half-pushed earlier attempt must not leak frames
        op = decode_plan(stage.plan)
        list(execute_plan(op, ctx))
        return op

    fb = (None if stage.source is None else
          lambda: _fallback_broadcast_task(stage, stages, frames, device))
    # speculatable=False: both twins would push into the ONE frames sink
    (op,) = sup.run_tasks(("broadcast", stage.stage_id), [TaskSpec(
        what=f"broadcast[{stage.stage_id}]", attempt_fn=attempt,
        partition=0, num_partitions=1, fallback_fn=fb,
        op_kinds=stage.op_kinds(), speculatable=False)])
    if op is not None:
        _note_metrics(op, run_info)
    resources.put(f"{ns}broadcast:{stage.stage_id}",
                  lambda partition=0: iter(list(frames)))
    return frames


def _fallback_broadcast_task(stage: Stage, stages: List[Stage],
                             frames: List[bytes], device=None) -> None:
    """Ladder rung 3 for a broadcast stage: the collect subtree runs on
    the row interpreter (reading ALL upstream shuffle partitions, like the
    native rewrite) and its batches are serialized into the frame format
    the sink's consumers replay."""
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow
    from blaze_tpu_torch.spark import fallback
    from blaze_tpu_torch.spark.converters import bridge_schema

    del frames[:]
    src = _copy_tree_readers_all(stage.source, stages)
    sch = bridge_schema(src)
    for rb in fallback.export_iterator(src, 0, 1):
        frames.append(serde.serialize_batch(
            batch_from_arrow(rb, schema=sch, device=device)))


def _copy_tree_readers_all(plan: SparkPlan, stages: List[Stage]) -> SparkPlan:
    """Copy a SparkPlan tree, pointing shuffle __IpcReaders at the
    all-partitions resource (the SparkPlan twin of
    _rewrite_shuffle_readers_all; copies because stage.source is shared
    with future retries)."""
    attrs = dict(plan.attrs)
    if plan.kind == "__IpcReader":
        rid = attrs.get("resource_id", "")
        local = local_resource_id(rid)
        if local.startswith("shuffle:") and not local.endswith(":all"):
            sid = int(local.split(":")[1])
            attrs["resource_id"] = _all_partitions_resource(
                rid, stages[sid].num_partitions)
            attrs["num_partitions"] = 1
    return SparkPlan(plan.kind, plan.schema,
                     [_copy_tree_readers_all(c, stages)
                      for c in plan.children], attrs)


def _rewrite_shuffle_readers_all(node: pb.PlanNode,
                                 stages: List[Stage]) -> None:
    """Point every shuffle ipc_reader under `node` at the chained
    all-partitions resource (spark/aqe.py registers it on demand)."""
    which = node.WhichOneof("node")
    if which is None:
        return
    if which == "ipc_reader":
        rid = node.ipc_reader.provider_resource_id
        local = local_resource_id(rid)
        if local.startswith("shuffle:") and not local.endswith(":all"):
            sid = int(local.split(":", 1)[1])
            node.ipc_reader.provider_resource_id = \
                _all_partitions_resource(rid, stages[sid].num_partitions)
        return
    inner = getattr(node, which)
    for fd, val in inner.ListFields():
        if fd.message_type is not None and \
                fd.message_type.name == "PlanNode":
            if fd.is_repeated:
                for child in val:
                    _rewrite_shuffle_readers_all(child, stages)
            else:
                _rewrite_shuffle_readers_all(val, stages)


def _fallback_result_task(stage: Stage, p: int, parts: int, schema,
                          device=None) -> List[ColumnBatch]:
    """Ladder rung 3 for one result-stage task: the full result subtree
    (including any root sort the native path strips for the host-ordered
    collect; re-sorting sorted rows changes nothing) runs on the row
    interpreter and comes back as one batch on `device`, counted as an
    export in `metrics.BRIDGE` (run_info's "fallback_exports")."""
    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow
    from blaze_tpu_torch.spark import fallback

    rb = fallback.export_batch(stage.source, p, parts, schema)
    return [batch_from_arrow(rb, schema=schema, device=device)]


def _root_sort_split(op):
    """(specs, limit, strip_depth) for a host-ordered collect, or None.

    A root ORDER BY orders the driver COLLECT: the result is pulled to
    host anyway, so the ordering happens host-side during materialization
    (ops/host_sort.py) instead of a full-input device sort. Shapes: a
    fetch-less root SortExec, or a GlobalLimit over (LocalLimit*) over a
    fetch-less SortExec. TakeOrdered (SortExec with fetch) keeps its
    device top-k fold — it bounds the pull — and merges after the
    collect."""
    from blaze_tpu_torch.ops.basic import GlobalLimitExec, LocalLimitExec
    from blaze_tpu_torch.ops.sort import SortExec

    if isinstance(op, SortExec) and op.fetch is None:
        return list(op.specs), None, 1
    if isinstance(op, GlobalLimitExec):
        child = op.children[0]
        depth = 2
        while (isinstance(child, LocalLimitExec)
               and not isinstance(child, GlobalLimitExec)):
            child = child.children[0]
            depth += 1
        if isinstance(child, SortExec) and child.fetch is None:
            return list(child.specs), op.limit, depth
    return None


def _run_result_stage(stage: Stage, parts: int, sup: Supervisor,
                      run_info: Dict, device) -> ColumnBatch:
    """`parts` is the upstream exchange's partition count (_input_tasks) —
    NOT the global default: an 8-way repartition read with 4 tasks would
    silently drop half the shuffle partitions."""
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.ops import host_sort
    from blaze_tpu_torch.ops.basic import GlobalLimitExec, LocalLimitExec
    from blaze_tpu_torch.ops.parquet import ParquetSinkExec
    from blaze_tpu_torch.ops.sort import SortExec, truncate
    from blaze_tpu_torch.ops.sort_keys import sort_batch
    from blaze_tpu_torch.runtime.stage_compiler import try_run_stage

    op = decode_plan(stage.plan)
    split = (_root_sort_split(op)
             if host_sort.host_supported(op.schema) else None)
    strip = split[2] if split else 0
    if (isinstance(op, ParquetSinkExec) and not op.is_remote()
            and (parts > 1 or os.path.isdir(op.path))):
        # stale-part overwrite semantics are a driver-side step before
        # any task runs
        ParquetSinkExec.clear_stale_parts(op.path)

    op_kinds = stage.op_kinds()
    specs: List[TaskSpec] = []
    for p in range(parts):
        def attempt(task_ctx):
            op_p = decode_plan(stage.plan)  # fresh operator state per task
            for _ in range(strip):
                op_p = op_p.children[0]
            staged = try_run_stage(op_p, task_ctx)
            out = ([staged] if staged is not None
                   else list(execute_plan(op_p, task_ctx)))
            return out, op_p

        fb = (None if stage.source is None else
              lambda p=p: (_fallback_result_task(stage, p, parts, op.schema,
                                                 device), None))
        specs.append(TaskSpec(
            what=f"result[{stage.stage_id}:{p}]", attempt_fn=attempt,
            partition=p, num_partitions=parts, fallback_fn=fb,
            op_kinds=op_kinds))
    batches: List[ColumnBatch] = []
    for out, op_p in sup.run_tasks(("result", stage.stage_id), specs):
        batches.extend(out)
        if op_p is not None:
            _note_metrics(op_p, run_info)

    if split is not None:
        specs_, limit, _ = split
        if not batches:
            return ColumnBatch.empty(op.schema, device=device)

        def merge():
            # ordered collect: ONE pull per partition result, order and
            # truncate on the host, and hand the driver the host view (no
            # second pull). A pure function of `batches`, so a failed
            # pull or upload mid-merge simply runs again
            hbs = [serde.to_host(b) for b in batches if int(b.num_rows) > 0]
            if not hbs:
                return ColumnBatch.empty(op.schema, device=device)
            hb = host_sort.host_concat(hbs)
            perm = host_sort.sort_perm(hb, specs_)
            if limit is not None:
                perm = perm[:limit]
            hb = host_sort.host_take(hb, perm)
            out = host_sort.host_to_device(hb, device=device)
            out._host_numpy = host_sort.host_to_pylike(hb)
            return out

        # the merge runs inline on the driver (it needs every partition's
        # batches) but still honours the deadlines and the breaker
        return run_task_with_resilience(
            merge, what=f"result_merge[{stage.stage_id}]",
            run_info=run_info, deadline=sup.deadline(),
            on_error=sup.breaker.note_failure, session=sup.session)

    if not batches:
        return ColumnBatch.empty(op.schema, device=device)
    out = concat_batches(batches, op.schema)
    # Ordered collect for the remaining shapes (device path): a root
    # TakeOrdered (SortExec with fetch) sorted each partition with a
    # bounded top-k; merging the sorted partitions gives the total order.
    # A GlobalLimit above a Project (no sort below) is an UNORDERED limit.
    if parts > 1:
        if isinstance(op, SortExec):
            out = sort_batch(out, op.specs)
            if op.fetch:
                out = truncate(out, op.fetch)
        elif isinstance(op, GlobalLimitExec):
            child = op.children[0]
            while (isinstance(child, LocalLimitExec)
                   and not isinstance(child, GlobalLimitExec)):
                child = child.children[0]
            if isinstance(child, SortExec):
                out = sort_batch(out, child.specs)
            out = truncate(out, op.limit)
    return out
