"""Local multi-stage execution: the test/standalone stand-in for Spark.

Port of blaze_tpu/spark/local_runner.py without the service layer. Ref
topology: SURVEY.md §3.3 — in deployment, Spark schedules stages and
moves shuffle blocks; this runner executes the same per-task native plans
(stages.plan_stages output) in dependency order in one process, wiring
the resource registry exactly the way the JVM shim would:

  map stage    : one task per upstream partition; each commits
                 <dir>/shuffle_<S>_<M>.data/.index through the
                 shuffle-manager drop-in (spark/shuffle_manager.py)
  reduce reads : "shuffle:<S>" resolves to a per-partition iterator over
                 all map outputs' partition-p segments (the MapStatus fetch)
  broadcast    : one collect task; "broadcast:<S>" replays its frames

Tasks run one after another on the driver's thread, each from a fresh
decode of its plan, on `device` (None: the CUDA card). That is the JAX
package's path with `enable_supervisor` off. What the JAX package hangs
around it is not ported, and each part that a caller could switch on
raises, naming its module, rather than being skipped: the supervisor with
its retries and resilience ladder, fault injection, the journal, history,
monitor, trace spans, progress, the autopilot and conf overlays, the
executor pool and the device-mesh exchange (`mesh_exchange` other than
"off"). Every NeverConvert subtree runs on the row interpreter
(spark/fallback.py) on the host, and its rows enter the native pipeline
through the FFI bridge (FfiReaderExec), uploaded to the task's device.
Query ids are a plain counter, used only as the resource namespace.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike, resolve_device
from blaze_tpu_torch.ops.base import ExecContext, Operator
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.plan import decode_plan
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.runtime import artifacts, resources
from blaze_tpu_torch.runtime.executor import execute_plan
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
_query_ids = itertools.count()

# conf knobs that would switch on a module the port does not have
_LEFT_OUT = (
    ("enable_supervisor", "runtime/supervisor.py"),
    ("enable_pipeline", "runtime/pipeline.py"),
    ("trace_enabled", "runtime/trace.py"),
    ("history_dir", "runtime/history.py"),
    ("journal_dir", "runtime/journal.py"),
    ("progress_enabled", "runtime/progress.py"),
    ("autopilot_enabled", "runtime/autopilot.py"),
    ("flight_dir", "runtime/flight_recorder.py"),
    ("profile_enabled", "runtime/profiler.py"),
    ("executor_count", "runtime/executor_pool.py"),
    ("monitor_enabled", "runtime/monitor.py"),
)

# per-task operator metrics summed into run_info: the whole-stage routes
# of runtime/stage_compiler.py and the Parquet scan's bytes and
# Arrow-to-device time
_TASK_METRICS = ("stage_compiled", "stage_fallbacks", "bytes_scanned",
                 "io_time_ns")


def _refuse_left_out(mesh_exchange: str) -> None:
    if mesh_exchange != "off":
        raise NotImplementedError(
            f"mesh_exchange={mesh_exchange!r}: the device-mesh exchange "
            "(parallel/stage_exchange.py) is not yet ported; pass 'off'")
    for knob, module in _LEFT_OUT:
        if getattr(conf, knob):
            raise NotImplementedError(
                f"conf.{knob} switches on {module}, not yet ported")


def run_plan(root: SparkPlan, num_partitions: int = 4,
             work_dir: Optional[str] = None,
             mesh_exchange: str = "off",
             run_info: Optional[Dict[str, int]] = None,
             device: DeviceLike = None) -> ColumnBatch:
    """Convert + execute a Spark plan tree locally; returns the collected
    result batch, on `device` (None: the CUDA card).

    run_info: optional dict populated with execution-path counters
    ("file_stages", "broadcast_stages", "map_tasks_run", and
    `_TASK_METRICS` summed over every task), each stage's kind and host
    wall time ("stage_s"), the query's "query_id", and its host
    crossings: the FFI bridge's row-interpreter exports, their rows and
    host seconds ("fallback_exports", "bridge_rows", "bridge_s"), the
    batches FfiReaderExec handed on and those of them on the card
    ("bridge_batches", "bridge_card_batches"), and the
    host-evaluated functions' and UDF wrappers' crossings and host
    seconds ("hostfn_crossings", "hostfn_s", "udf_crossings", "udf_s")."""
    if run_info is None:
        run_info = {}
    _refuse_left_out(mesh_exchange)
    dev = resolve_device(device)
    run_info["query_id"] = (run_info.get("query_id")
                            or f"q{os.getpid()}-{next(_query_ids)}")
    for key in (("file_stages", "broadcast_stages", "map_tasks_run")
                + _TASK_METRICS):
        run_info.setdefault(key, 0)
    run_info.setdefault("stage_s", [])
    return _run_plan_inner(root, num_partitions, work_dir, run_info, dev)


def _run_plan_inner(root: SparkPlan, num_partitions: int,
                    work_dir: Optional[str], run_info: Dict,
                    device) -> ColumnBatch:
    # task setup reclaims dead writers' leftover spill files
    artifacts.sweep_orphans([conf.spill_dir])
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
    work_dir = work_dir or tempfile.mkdtemp(prefix="blaze_tpu_torch_stages_")
    os.makedirs(work_dir, exist_ok=True)

    shuffle_mgr = BlazeShuffleManager(work_dir)
    # AQE statistics: completed shuffles' total bytes + partition counts
    shuffle_bytes: Dict[int, int] = {}
    shuffle_parts: Dict[int, int] = {}
    try:
        for stage in stages:
            t0 = time.perf_counter()
            # re-optimize THIS stage with the statistics of completed
            # shuffles before running it (ref: AQE per-stage re-entry)
            if shuffle_bytes:
                apply_dynamic_join_selection(stage.plan, shuffle_bytes,
                                             shuffle_parts)
            if stage.kind == "shuffle_map":
                shuffle_parts[stage.stage_id] = stage.num_partitions
                shuffle_bytes[stage.stage_id] = _run_shuffle_stage(
                    stage, stages, shuffle_mgr, run_info, ns, device)
                run_info["file_stages"] += 1
            elif stage.kind == "broadcast":
                _run_broadcast_stage(stage, stages, run_info, ns, device)
                run_info["broadcast_stages"] += 1
            else:
                parts = _input_tasks(stage, stages, fallback=num_partitions)
                out = _run_result_stage(stage, parts, run_info, device)
            # a stage ends in host reads (commits, frames, the collect),
            # so the host clock covers its device work
            run_info["stage_s"].append(
                [stage.kind, time.perf_counter() - t0])
            if stage.kind == "result":
                return _merge_fallback_root_sort(root, out, parts)
        raise AssertionError("no result stage produced")
    finally:
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
            shuffle_mgr.unregister_shuffle(stage.stage_id)


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
    """Ordered collect for a NeverConvert root sort: a native root sort
    merges in _run_result_stage, but a fallback root sort ordered each
    partition only, so merge on the row engine."""
    if (root.kind != "SortExec" or parts <= 1
            or root.strategy != "NeverConvert"):
        return out
    import pandas as pd

    from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow
    from blaze_tpu_torch.spark import fallback

    df = pd.DataFrame(out.to_numpy())
    srt = SparkPlan("SortExec", root.schema, [], dict(root.attrs))
    merged = fallback._op_sort_frame(srt, df)
    return batch_from_arrow(fallback._to_arrow(merged, root.schema),
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
    """Add a finished task's `_TASK_METRICS` to run_info."""
    stack = [op]
    while stack:
        o = stack.pop()
        for key in _TASK_METRICS:
            run_info[key] += o.metrics[key]
        stack.extend(o.children)


def _run_shuffle_stage(stage: Stage, stages: List[Stage], shuffle_mgr,
                       run_info: Dict, ns: str, device) -> int:
    """Runs the map tasks through the shuffle manager (register ->
    per-task writer slot -> commit MapStatus -> reduce-side reader
    resource); returns the stage's total LOGICAL output bytes
    (uncompressed, live rows only — the AQE statistic)."""
    ntasks = _input_tasks(stage, stages)
    # the reader schema is the writer's input schema
    reader_schema = decode_plan(stage.plan.shuffle_writer.input).schema
    handle = shuffle_mgr.register_shuffle(
        stage.stage_id, stage.num_partitions, reader_schema)
    logical = 0
    for task in range(ntasks):
        node = pb.PlanNode()
        node.CopyFrom(stage.plan)
        slot = shuffle_mgr.get_writer(handle, task)
        node.shuffle_writer.data_file = slot.data_path
        node.shuffle_writer.index_file = slot.index_path
        op = decode_plan(node)  # fresh operator state per task
        list(execute_plan(op, ExecContext(partition=task,
                                          num_partitions=ntasks,
                                          device=device)))
        _note_metrics(op, run_info)
        logical += op.metrics["shuffle_logical_bytes"]
        slot.commit()
    run_info["map_tasks_run"] += ntasks
    resources.put(f"{ns}shuffle:{stage.stage_id}",
                  lambda partition: shuffle_mgr.get_reader_host(handle,
                                                                partition))
    return logical


def _run_broadcast_stage(stage: Stage, stages: List[Stage], run_info: Dict,
                         ns: str, device) -> List[bytes]:
    # a broadcast stage runs ONE task but must see its upstream shuffles'
    # WHOLE output — a plan like broadcast(final_agg(exchange(...)))
    # would otherwise read only partition 0 and broadcast a quarter of
    # the relation (caught by the tpcds q01 catalogue cell)
    _rewrite_shuffle_readers_all(stage.plan, stages)
    frames: List[bytes] = []
    resources.put(f"{ns}broadcast_sink:{stage.stage_id}", frames.append)
    op = decode_plan(stage.plan)
    list(execute_plan(op, ExecContext(partition=0, num_partitions=1,
                                      device=device)))
    _note_metrics(op, run_info)
    resources.put(f"{ns}broadcast:{stage.stage_id}",
                  lambda partition=0: iter(list(frames)))
    return frames


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


def _run_result_stage(stage: Stage, parts: int, run_info: Dict,
                      device) -> ColumnBatch:
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

    batches: List[ColumnBatch] = []
    for p in range(parts):
        op_p = decode_plan(stage.plan)  # fresh operator state per task
        for _ in range(strip):
            op_p = op_p.children[0]
        ctx = ExecContext(partition=p, num_partitions=parts, device=device)
        staged = try_run_stage(op_p, ctx)
        batches.extend([staged] if staged is not None
                       else execute_plan(op_p, ctx))
        _note_metrics(op_p, run_info)

    if split is not None:
        # ordered collect: ONE pull per partition result, order + truncate
        # on the host, and hand the driver the host view (no second pull)
        specs, limit, _ = split
        hbs = [serde.to_host(b) for b in batches if int(b.num_rows) > 0]
        if not hbs:
            return ColumnBatch.empty(op.schema, device=device)
        hb = host_sort.host_concat(hbs)
        perm = host_sort.sort_perm(hb, specs)
        if limit is not None:
            perm = perm[:limit]
        hb = host_sort.host_take(hb, perm)
        out = host_sort.host_to_device(hb, device=device)
        out._host_numpy = host_sort.host_to_pylike(hb)
        return out

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
