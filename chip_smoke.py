"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs a CUDA card + nvcc

Drives `blaze_tpu_torch` only (no jax, nothing of `blaze_tpu`), on `cuda`:

  1. card       nvidia-smi name + power limit, torch and CUDA versions
  2. build      compiles every kernel of the path from blaze_tpu_torch/csrc/
  3. kernel     the digit-plane accumulate kernel chain at the main path's
                shape (2^21 rows, 2^16 groups, 7 planes, 3 words), adding
                into an int64 carry, held to its plain torch version with
                torch.equal on uniform keys, on two skews (90% of rows on
                8 keys in 8 slices of the chain, or in one), on one key,
                and on ragged, all-masked and 32-plane inputs. For each
                key distribution: kernel-only device time from the
                profiler's kernel durations (and CUDA events around a
                stretch of prepared launches) and the wrapper's wall time
                a call; the plain version and `index_add_` (yardstick
                only) beside the byte bound
  4. main_path  bench.py's q06 plan (ffi_reader -> filter -> project ->
                partial/final agg) over 64 x 2^21 rows and 2^16 groups, as
                TaskDefinition bytes through decode_task_definition ->
                collect_fetch; checked against a numpy oracle (keys and
                counts exact, sums rtol 1e-9); the chain's launch count,
                and the launches of each of its kernels as the C entry
                reports them, must rise by one per batch; warm reps timed
  5. profile    one more rep under torch.profiler: device time by kernel,
                the device's idle share of a rep, and each chain kernel
                seen on the device once per batch
  6. dense_minmax  the same rows and plan with min(ss_sales_price) and
                max(amount) beside sum and count: the dense path with its
                min/max carriers, one chain launch a batch; keys, counts,
                min and max exact against numpy, sums rtol 1e-9
  7. general_agg   the same rows with a nullable ss_customer_sk, uniform
                on [1, 2,000,000] (TPC-DS SF100's customers) with 5% nulls,
                grouped by it: the dense path declines and the batches
                stream through the sort-based AggExec; the whole output
                against numpy (keys, counts, min, max exact; sums and
                averages rtol 1e-9), then the plan under a top-100 sort
                (cnt desc, key asc nulls first). Rep time, collapses and
                host pulls a rep, the memory manager's peak and one
                profiled rep's device busy time, idle share and top
                operations
  8. chain_stage   the agg-less scan -> filter -> project over 16 batches,
                compacted into one batch and checked exactly
  9. shuffle_q06   q06 as Spark runs it: 8 map tasks of 8 batches, each
                ffi_reader -> filter -> project -> Agg PARTIAL ->
                ShuffleWriter(hash(ss_item_sk), 200) on the dense path (one
                chain launch a batch, 64 a rep), committing a .data/.index
                pair; then 200 reduce tasks, ipc_reader(partition p of the 8
                outputs) -> Agg FINAL. Every pair's checksums verify and the
                union of the reduce outputs equals the item oracle. Map and
                reduce stage times, shuffle bytes, frames and host pulls a
                rep, serde encode/decode host time, one map task and one
                reduce task profiled
 10. shuffle_general  the general_agg rows grouped by ss_customer_sk
                across the same 8 x 200 shuffle: the map tasks fall back to
                the streaming AggExec (no launch); about 15.6 M partial state
                rows cross the serde; checked against the customer oracle
 11. spill      (a) map task 0 of shuffle_general under a 64 MiB budget:
                its agg state spills to host files and merges back, the
                reduce stage over its output against numpy; (b) the chain
                stage's 16 batches under Sort(amount DESC, ss_item_sk ASC)
                with a 64 MiB budget: sorted runs spill and merge on the
                host; every row in order against numpy's stable sort
 12. tpcds_data  TPC-DS tables as Parquet files written from --seed:
                date_dim in full (73,049 rows) and 16 web_sales, 32
                catalog_sales and 8 store_sales files of 2^21 rows, one
                row group each (SF100's row counts cut 2.1x, 2.1x, 17x;
                widths and key domains kept: 2 M customers, 5% null date
                and customer keys; store_sales at spark/tpcds.py's full
                width of 12 columns), phase 16's dimension tables and
                one store_returns file of 2^21 rows (SF100's 28.8 M cut
                13.7x); and from the same draws the decimal copies of
                the three fact tables (web_sales_dec, catalog_sales_dec,
                store_sales_dec): the same rows and columns, every price
                or amount column an Arrow decimal128(7,2), TPC-DS v2's
                type, of the cents drawn
 13. tpcds_q02  q02 (spark/tpcds.py:367, BHJ mode): a broadcast stage of
                date_dim, 16 map tasks of Union(scan ws, scan cs) ->
                BroadcastJoin -> the dense partial agg by (d_year, d_qoy)
                -> ShuffleWriter(200), 200 reduce tasks and a final sort;
                against numpy (counts exact, sums rtol 1e-9); stage times,
                scan bytes and pruning, join rows and time, host pulls,
                the map tasks' route and launches, one map task profiled
 14. tpcds_q04  q04 (spark/tpcds.py:466): four year-total arms, each a
                broadcast of date_dim filtered to its year and map tasks
                of scan -> BroadcastJoin -> partial agg by customer ->
                ShuffleWriter(200); 200 reduce tasks joining the arms'
                partition with three sort-merge joins, the growth filter
                and a top 100; then the final top 100, exact against
                numpy; stage times, serde time, arm state rows, join rows
                a level, host pulls, one reduce task's host profile
 15. runner_tpcds  spark/tpcds.py's own q02, q04 and q09 plans (BHJ
                mode), made by its query functions with each scan listing
                all of its table's files, through the driver path
                spark/local_runner.run_plan: tagging, conversion, stage
                splitting, AQE, and the stages in order (a scan stage is
                one task over all of its files). Each once, checked (q02
                and q04 against numpy and against phases 13 and 14's
                rows, q09's four bucket averages against numpy, rtol
                1e-9) and timed; run_info's stage counts, routes,
                launches and host pulls, and peak device memory (every
                runner query of phases 15-20 reports its peak)
 16. runner_strings  spark/tpcds.py's q03, q06, q07 and q08 (BHJ) the same
                way, over phase 12's store_sales files and the dimension
                tables it also writes at SF100's row counts (item 204,000,
                customer 2,000,000, customer_address 1,000,000,
                customer_demographics 1,920,800, store 402, promotion
                1,000; string ids, brands, categories, states and zips):
                string literals, comparisons, group, sort and join keys,
                substring and string broadcasts through the serde. Each
                against numpy (strings and counts exact, sums and
                averages rtol 1e-9) and timed, and one q07 map task
                profiled (device busy, idle share, top operations)
 17. runner_nested  tpcds.py's q05 (a ROLLUP: ExpandExec) and q01 over
                phase 12's store_sales files and its store_returns file
                (2^21 rows), then this script's NESTED_QUERIES: q51_store
                (TPC-DS q51's store arm, a WindowExec of running sums and
                ranks over 3.1 M daily item totals), basket_items
                (collect_list, posexplode) and basket_stores (collect_set,
                explode), all BHJ through run_plan; each against numpy
                (names, ids, ranks and counts exact, sums rtol 1e-9; the
                window's row count and rank sums exact) and timed, and
                q51_store's window stage profiled
 18. runner_decimal  this script's DECIMAL_QUERIES over the decimal
                copies, in the form Spark 3.3's optimizer gives them
                (DecimalAggregates, DecimalPrecision), BHJ through
                run_plan: q02_dec (tpcds.py's q02 summing
                UnscaledValue(price) on the dense path, as many launches
                as runner_tpcds q02), q04_dec (q04 with decimal(17,2)
                year totals and the growth test t_w2 / t_w1 > t_s2 / t_s1
                in decimal(37,20), a wide division) and q03_rev (q03 as a
                revenue report: sum of quantity x price as decimal(28,2),
                wide agg state and sort key, and avg(price) as Spark
                plans it); each exact against numpy's integers (q03_rev's
                average within one unit of its sixth place) and timed,
                and q04_dec's result stage profiled with its 128-step
                divisions counted
 19. runner_spark_json  Spark's entry: JSON_QUERIES as the TreeNode JSON
                Spark 3.3's executedPlan.toJSON() gives (an
                AdaptiveSparkPlanExec root with isFinalPlan, codegen and
                columnar shells, #exprId attributes), decoded by
                spark/plan_json.py and run through run_plan (BHJ):
                json_q02 (tpcds.py's q02: rows equal to phase 15's q02,
                as many accumulate launches), json_report (a brand-revenue
                report over store_sales, item and date_dim with string,
                date, rounding and hash functions on the card, md5 and
                crc32 on the host) and json_udf (a string Hive UDF on the
                row interpreter feeding the broadcast join through the FFI
                bridge onto the card, a numeric Scala UDF crossing to the
                host a batch, a root sort on the row interpreter); each
                against numpy, hashlib and zlib, and timed; the bridge's
                rows and host seconds and the host crossings reported
 20. runner_resilience  the task runtime at its defaults (phases 1-19 run
                with conf.enable_supervisor and conf.enable_pipeline off,
                the inline route their earlier numbers were taken on):
                tpcds.py's q02 and q04 (BHJ) through run_plan with the
                runtime's knobs at config.py's defaults: the supervisor's
                pool of 4 tasks, the threaded pipeline (4 I/O threads, 2
                batches ahead), the trace off; each against numpy and
                phase 15's rows, q02 with phase 15's launch count, no
                task retried, degraded or rerouted; each stage's time
                beside phase 15's inline route, the pipeline's streams
                (none left open) and peak device memory. Then both once
                more with the trace on, labelled "traced" (its on_batch
                reads every batch's row count to the host). Then the
                resilience ladder, its faults seeded
                from --seed, on q09 (and q02 over one file a fact table,
                SMJ): a retryable fault at serde.encode is retried; an
                oom at every IpcReaderExec batch walks the ladder's three
                rungs and ends on the row interpreter; a stall past
                hang_detect_ms is killed and relaunched; and a stalled
                join task past speculation_multiplier loses to its twin,
                every map output published exactly once. Each case's rows
                against numpy and its run_info counters printed
 21. runner_mesh  the device-mesh exchange and the monitor at config.py's
                defaults (phases 1-20 run with both off, the route of
                their earlier numbers): first a logical-device check,
                shuffle_q06's map stage over 4 of the main path's batches
                through parallel/stage_exchange.run_mesh_shuffle_stage on
                4 logical devices, all this card, each of its 200
                partitions holding the file path's rows (no multi-card
                claim); a mixed-provider check, 3 of those batches not
                aggregated through the exchange on this card with the
                memory budget cut to two batches' bytes, so that two
                stay on the card and one goes to files, every partition
                the file path's rows; then q02, q04, q03, q03_rev and
                basket_items through run_plan at the defaults (mesh
                "auto": each hash shuffle of plain column keys kept in
                device memory, files past half the memory budget), every
                run against numpy (their mesh_exchange="off" twins
                are cut for the time limit):
                q02 with one launch a probe batch (48), basket_items (list
                state) with no mesh stage, no leak; each run's stage
                times, stage counts, host pulls, serde seconds, peak
                device memory and the monitor's bytes by boundary
 22. runner_observability  the observability layer on top of phase 21's
                defaults: trace export, the history store, live
                progress, the flight recorder and the sampling profiler
                (with its export) all on, their files under the work
                dir. q02 and q04 twice each, every run against numpy and
                runner_tpcds's rows, q02 with its 48 launches; each
                run's time beside runner_mesh's "auto" run, its host
                pulls, trace records and the profiler's duty. The files
                must load back: 4 ledger lines whose critical paths add
                up to their durations, a trace per query, 4 history
                records whose second runs repeat the first runs' stage
                fingerprints, detect_regressions, the doctor's findings
                over the export dir (printed), and each query's
                collapsed and speedscope profiles attributed to it. q04
                is read live from a second thread (snapshot_query): its
                stages advance, and it ends in finished_queries. Then
                q09 over the 8 store_sales files: a stall past
                hang_detect_ms is killed and relaunched (the stacks are
                stashed, the query equals numpy, and, as in the JAX
                package, a query that survives writes no dossier); with
                no relaunch budget the same stall ends the query in a
                hang dossier holding those stacks; and a query killed
                by query_deadline_ms writes a deadline dossier. Each
                dossier loads and names its trigger and query
 23. runner_pool  the process-isolated executor pool at phase 21's
                defaults: ExecutorPool(count=2, slots=2) started and
                activated, each worker a fresh interpreter with its own
                CUDA context (made at its first plan task, whose seconds
                it reports), loading the kernel library phase 2 built.
                tpcds.py's q02 (its map stage and its 48 launches of the
                kernel in a worker, 0 in the driver, the worker's own
                count; no warm rerun, for the time limit), and q04 (its
                four arm map stages in workers), each against numpy and
                runner_tpcds's rows, beside runner_mesh's "auto" times,
                with the sampling profiler on in the workers to show
                where the first plan task went; while the pool lives the card's used memory
                (nvidia-smi memory.used; its per-process list names pids
                of another namespace in a container, and is printed) holds
                the workers' contexts and blocks. Then q09 with its map
                task's worker SIGKILLed once busy_pids() names it: one
                death, the task re-queued under a new epoch, the seat
                respawned, no stale-epoch file left, the answer equal to
                numpy's. After close() the card's used memory is back to
                what it was before the workers ran. Telemetry frames and
                bytes, the mmap hits and fallbacks, and the workers'
                memory are printed
 24. runner_service  the service and control layer at phase 21's
                defaults with the trace on: a QueryService with two run
                slots, two parked seats and tenants weighted 3:1 takes
                five arrivals (q02, q09, q02, q09, q02), each from a
                thread of its own: two run, two park and the fifth is
                shed; every answer against numpy, each q02 session's own
                run_info counting its 48 launches, their sum the phase's
                count, the ledger a line an arrival, /metrics and
                /healthz scraped from conf.metrics_port while two park,
                the port free after shutdown(); the card's peak memory
                with two sessions. Then a StreamingQuery through the
                service over the 8 store_sales files, published by rename
                in ticks of 3, 3 and 2, grouped by store; stopped
                without settling after the second batch and resumed from
                its journal, its state equal to numpy, each batch's route,
                launches and time printed. Then q02 twice with the
                autopilot on, the second under a stored overlay

Phases 4-14 build every TaskDefinition as bytes and decode it with
decode_task_definition; phases 15-24 have run_plan convert and decode
them.
Counts (kernel launches, host pulls) are set to 0 just before each path
runs and read just after. Every phase prints one JSON line. Then come the
kernels line, the card's `nvidia-smi` line, and last
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero
before the last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from blaze_tpu_torch import kernels
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import Column, ColumnBatch
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.ops import mxu_agg
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.host_sort import host_concat, host_to_pylike
from blaze_tpu_torch.ops.shuffle import read_shuffle_partition_host
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.plan.from_proto import _KIND_MAP as _PB_KIND_MAP
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime import artifacts, memory, metrics, resources
from blaze_tpu_torch.runtime.executor import (
    collect, collect_fetch, execute_plan,
)

ROWS = 1 << 21       # rows per batch (bench.py)
N_BATCHES = 64       # 134M rows, ~3.2 GB input
GROUPS = 1 << 16
REPS = 5
WARM_REPS = 2
PATH_REPS = 3        # timed reps of each later path, after WARM_REPS
GENERAL_BATCHES = N_BATCHES
CHAIN_BATCHES = 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_S = 67e12        # data-sheet rate outside the tensor cores

SCHEMA = T.Schema([
    T.Field("ss_item_sk", T.INT32),
    T.Field("ss_quantity", T.INT32),
    T.Field("ss_sales_price", T.FLOAT64),
    T.Field("ss_ext_sales_price", T.FLOAT64),
])
SCHEMA_PB = [("ss_item_sk", pb.TK_INT32), ("ss_quantity", pb.TK_INT32),
             ("ss_sales_price", pb.TK_FLOAT64),
             ("ss_ext_sales_price", pb.TK_FLOAT64)]

# the general path: q06's rows with a nullable customer key, grouped by it
CUSTOMERS = 2_000_000    # TPC-DS SF100's customer count
NULL_SHARE = 0.05
GENERAL_SCHEMA = T.Schema([T.Field("ss_customer_sk", T.INT32)]
                          + list(SCHEMA.fields))
GENERAL_SCHEMA_PB = [("ss_customer_sk", pb.TK_INT32)] + SCHEMA_PB
# (fn, argument, result kind, name); None is the literal 1
GENERAL_AGGS = [("sum", "amount", "f64", "sum_amount"),
                ("count", None, "i64", "cnt"),
                ("avg", "ss_sales_price", "f64", "avg_price"),
                ("min", "ss_sales_price", "f64", "min_price"),
                ("max", "amount", "f64", "max_amount")]
# dense_minmax: q06 by item with min and max beside the sum and count
MINMAX_AGGS = [("sum", "amount", "f64", "sum_amount"),
               ("count", None, "i64", "cnt"),
               ("min", "ss_sales_price", "f64", "min_price"),
               ("max", "amount", "f64", "max_amount")]
TOP_SORT = [("cnt", False, True), ("ss_customer_sk", True, True)]
TOP_N = 100
# the shuffle phases: a map stage of MAP_TASKS tasks over consecutive
# slices of the batches, each writing a hash shuffle into
# SHUFFLE_PARTITIONS partitions (spark.sql.shuffle.partitions' default),
# then a reduce stage of one task a partition
MAP_TASKS = 8
SHUFFLE_PARTITIONS = 200
SHUFFLE_REPS = 2     # timed reps of each shuffle phase after its checked run
# shuffle_general's, cut to one so that the script keeps its time with
# runner_decimal (PERF.md section 4)
SHUFFLE_GENERAL_REPS = 1
# the spill phase: budgets that force the agg state of one map task of the
# general shuffle, and the sort input of the chain stage's rows, to spill
SPILL_AGG_BUDGET = 64 << 20
SPILL_SORT_BUDGET = 64 << 20
SPILL_SORT = [("amount", False, False), ("ss_item_sk", True, True)]


# ---------------------------------------------------------------------------
# workload: copies of bench.py's data, oracle and plan construction
# ---------------------------------------------------------------------------

def _make_data(seed):
    rng = np.random.default_rng(seed)
    return {
        "ss_item_sk": rng.integers(0, GROUPS, size=ROWS).astype(np.int32),
        "ss_quantity": rng.integers(1, 100, size=ROWS).astype(np.int32),
        "ss_sales_price": rng.random(ROWS) * 100,
        "ss_ext_sales_price": rng.random(ROWS) * 500,
    }


def _make_customers(seed):
    """ss_customer_sk of one batch: uniform on [1, CUSTOMERS], NULL_SHARE
    of the rows null. Returns (keys, valid)."""
    rng = np.random.default_rng(10_000 + seed)
    return (rng.integers(1, CUSTOMERS + 1, size=ROWS).astype(np.int32),
            rng.random(ROWS) >= NULL_SHARE)


def _kept(data):
    keep = (data["ss_quantity"] <= 50) & (data["ss_sales_price"] > 10.0)
    return keep, data["ss_quantity"][keep].astype(np.float64) * \
        data["ss_sales_price"][keep]


def _numpy_grouped(datas, keys_of, size):
    """GENERAL_AGGS per group slot (keys_of(i, keep) -> int slots in
    [0, size)): {"cnt", "sum_amount", "avg_price", "min_price",
    "max_amount"} arrays of `size`."""
    cnt = np.zeros(size, np.int64)
    amt = np.zeros(size, np.float64)
    price = np.zeros(size, np.float64)
    mn = np.full(size, np.inf)
    mx = np.full(size, -np.inf)
    for i, data in enumerate(datas):
        keep, amount = _kept(data)
        k = keys_of(i, keep)
        p = data["ss_sales_price"][keep]
        cnt += np.bincount(k, minlength=size)
        amt += np.bincount(k, weights=amount, minlength=size)
        price += np.bincount(k, weights=p, minlength=size)
        np.minimum.at(mn, k, p)
        np.maximum.at(mx, k, amount)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = price / cnt
    return {"cnt": cnt, "sum_amount": amt, "avg_price": avg,
            "min_price": mn, "max_amount": mx}


def _item_oracle(datas):
    """bench.py's q06 answer per item slot in [0, GROUPS)."""
    return _numpy_grouped(
        datas, lambda i, keep: datas[i]["ss_item_sk"][keep], GROUPS)


def _general_oracle(datas, customers):
    """The general plan's answer in the port's row order: the null group
    first, then customers ascending. Returns (keys with -1 for null,
    columns) over the groups that have rows."""
    def slots(i, keep):
        keys, valid = customers[i]
        return np.where(valid[keep], keys[keep], 0)

    cols = _numpy_grouped(datas, slots, CUSTOMERS + 1)
    nz = cols["cnt"] > 0
    keys = np.nonzero(nz)[0].astype(np.int64)
    keys[keys == 0] = -1
    return keys, {k: v[nz] for k, v in cols.items()}


def _top_oracle(keys, cols):
    """Rows of the TOP_SORT order (cnt desc, key asc, null first), cut to
    TOP_N."""
    order = np.lexsort((keys, -cols["cnt"]))[:TOP_N]
    return keys[order], {k: v[order] for k, v in cols.items()}


_AGG_CODES = {"sum": pb.AGG_SUM, "count": pb.AGG_COUNT, "avg": pb.AGG_AVG,
              "min": pb.AGG_MIN, "max": pb.AGG_MAX, "first": pb.AGG_FIRST,
              "first_ignores_null": pb.AGG_FIRST_IGNORES_NULL}
_KINDS = {"f64": pb.TK_FLOAT64, "i64": pb.TK_INT64}
# bench.py's aggregates, all of `amount`: fn -> (result kind, name)
_AMOUNT_AGGS = {"sum": ("f64", "sum_amount"), "count": ("i64", "cnt"),
                "avg": ("f64", "avg_amount")}


def _col(name):
    e = pb.ExprNode()
    e.column.name = name
    return e


def _lit(kind, field, v):
    e = pb.ExprNode()
    e.literal.dtype.kind = kind
    setattr(e.literal, field, v)
    return e


def _agg_node(inp, mode, key, aggs):
    """An agg plan node over `inp` grouped by `key` (a column name, or a
    list of (column, output name)); aggs as _build_task's."""
    n = pb.PlanNode()
    n.agg.input.CopyFrom(inp)
    n.agg.mode = mode
    for col, name in ([(key, key)] if isinstance(key, str) else key):
        n.agg.grouping.add().CopyFrom(_col(col))
        n.agg.grouping_names.append(name)
    for fn, arg, kind, name in aggs:
        a = n.agg.aggs.add()
        a.fn = _AGG_CODES[fn]
        a.args.add().CopyFrom(_col(arg) if arg is not None
                              else _lit(pb.TK_INT32, "int_value", 1))
        a.result_type.kind = _KINDS[kind]
        a.name = name
    return n


def _build_task(schema_fields, resource_id, agg_fns=("sum", "count"),
                final=True, key="ss_item_sk", aggs=None, sort=None,
                fetch=0, agg=True):
    """TaskDefinition bytes of bench.py's plan: ffi_reader -> filter
    (qty <= 50, price > 10) -> project (key, amount = qty * price, and any
    other column an aggregate reads) -> partial agg [-> final agg]
    [-> sort]. agg_fns picks the aggregates of `amount` (bench.py's);
    `aggs` lists (fn, argument column or None for the literal 1, result
    kind, name) instead. final=False stops at the partial aggregate,
    agg=False at the projection. `sort` is a list of (column, ascending,
    nulls_first) with a `fetch` limit (0: none)."""
    if aggs is None:
        aggs = [(fn, "amount") + _AMOUNT_AGGS[fn] for fn in agg_fns]
    src = pb.PlanNode()
    for name, kind in schema_fields:
        f = src.ffi_reader.schema.fields.add()
        f.name = name
        f.dtype.kind = kind
    src.ffi_reader.export_iter_resource_id = resource_id

    flt = pb.PlanNode()
    flt.filter.input.CopyFrom(src)
    p1 = flt.filter.predicates.add()
    p1.binary.op = pb.OP_LE
    p1.binary.left.CopyFrom(_col("ss_quantity"))
    p1.binary.right.CopyFrom(_lit(pb.TK_INT32, "int_value", 50))
    p2 = flt.filter.predicates.add()
    p2.binary.op = pb.OP_GT
    p2.binary.left.CopyFrom(_col("ss_sales_price"))
    p2.binary.right.CopyFrom(_lit(pb.TK_FLOAT64, "float_value", 10.0))

    proj = pb.PlanNode()
    proj.projection.input.CopyFrom(flt)
    proj.projection.exprs.add().CopyFrom(_col(key))
    amount = pb.ExprNode()
    amount.binary.op = pb.OP_MUL
    cast_q = pb.ExprNode()
    cast_q.cast.child.CopyFrom(_col("ss_quantity"))
    cast_q.cast.dtype.kind = pb.TK_FLOAT64
    amount.binary.left.CopyFrom(cast_q)
    amount.binary.right.CopyFrom(_col("ss_sales_price"))
    proj.projection.exprs.add().CopyFrom(amount)
    names = [key, "amount"]
    for _, arg, _, _ in aggs:
        if arg is not None and arg not in names:
            proj.projection.exprs.add().CopyFrom(_col(arg))
            names.append(arg)
    proj.projection.names.extend(names)

    root = proj
    if agg:
        root = _agg_node(proj, pb.AGG_PARTIAL, key, aggs)
        if final:
            root = _agg_node(root, pb.AGG_FINAL, key, aggs)
    if sort:
        top = pb.PlanNode()
        top.sort.input.CopyFrom(root)
        for name, asc, nulls_first in sort:
            t = top.sort.terms.add()
            t.expr.CopyFrom(_col(name))
            t.ascending = asc
            t.nulls_first = nulls_first
        top.sort.fetch_limit = fetch
        root = top
    td = pb.TaskDefinition()
    td.partition_id = 0
    td.plan.CopyFrom(root)
    return td.SerializeToString()


def _shuffle_map_task(schema_fields, resource_id, task, data_file,
                      index_file, key="ss_item_sk", aggs=None,
                      partitions=SHUFFLE_PARTITIONS):
    """TaskDefinition bytes of map task `task` of a two-stage query:
    _build_task's plan up to the partial aggregate, under a shuffle writer
    that hash-partitions its rows on `key` (Spark's murmur3, seed 42, then
    pmod) into `partitions` and commits data_file and index_file."""
    td = pb.TaskDefinition.FromString(_build_task(
        schema_fields, resource_id, final=False, key=key, aggs=aggs))
    node = pb.PlanNode()
    w = node.shuffle_writer
    w.input.CopyFrom(td.plan)
    w.partitioning.kind = pb.HashRepartition.HASH
    w.partitioning.num_partitions = partitions
    w.partitioning.keys.add().CopyFrom(_col(key))
    w.data_file = data_file
    w.index_file = index_file
    td.plan.CopyFrom(node)
    td.stage_id = 0
    td.partition_id = task
    return td.SerializeToString()


_PB_KIND = {v: k for k, v in _PB_KIND_MAP.items()}


def _shuffle_reduce_task(state_schema, resource_id, partition,
                         key="ss_item_sk", aggs=None,
                         partitions=SHUFFLE_PARTITIONS):
    """TaskDefinition bytes of reduce task `partition`: an ipc_reader of the
    partial state (`state_schema`, the map side's partial aggregate output)
    from the provider under resource_id, then the final aggregate."""
    if aggs is None:
        aggs = [(fn, "amount") + _AMOUNT_AGGS[fn] for fn in ("sum", "count")]
    src = pb.PlanNode()
    for f in state_schema:
        sf = src.ipc_reader.schema.fields.add()
        sf.name = f.name
        sf.dtype.kind = _PB_KIND[f.dtype.kind]
        sf.nullable = f.nullable
    src.ipc_reader.provider_resource_id = resource_id
    src.ipc_reader.num_partitions = partitions
    td = pb.TaskDefinition()
    td.stage_id = 1
    td.partition_id = partition
    td.plan.CopyFrom(_agg_node(src, pb.AGG_FINAL, key, aggs))
    return td.SerializeToString()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_EMITTED = []   # (phase, perf_counter) of each phase line, for the wall line


def _emit(obj) -> None:
    if "phase" in obj:
        _EMITTED.append((obj["phase"], time.perf_counter()))
    print(json.dumps(obj), flush=True)


def phase_wall(t0) -> None:
    """The wall time of each phase (from the previous phase line to its
    own) and of the whole script so far."""
    seconds, prev = {}, t0
    for name, t in _EMITTED:
        seconds[name] = t - prev
        prev = t
    _emit({"phase": "wall", "seconds": seconds,
           "total_s": time.perf_counter() - t0})


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _stretch_ms(fn, iters: int = 20, stretches: int = 5,
                warmup: int = 3) -> float:
    """Device time of one call (ms): CUDA events around a stretch of
    `iters` back-to-back calls, median over `stretches`. Whatever host work
    a call does is queued behind the device, so a call that the host
    issues faster than the device runs it reads as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(stretches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def _wall_ms(fn, iters: int = 20, stretches: int = 5) -> float:
    """Host wall time of one call (ms), with the device drained at the end
    of each stretch: median over `stretches` of `iters` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(stretches):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(times))


def _profiled_ms(fn, iters: int = 20):
    """Kernel-only device time of one call (ms) from torch.profiler's
    kernel durations, and the per-kernel split {name: (ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, calls = split.get(e.key[:80], (0.0, 0.0))
        split[e.key[:80]] = (ms + float(us) / 1e3 / iters,
                             calls + int(e.count) / iters)
    total = sum(ms for ms, _ in split.values())
    return total, split


def _kernel_inputs(gen: torch.Generator, n: int, keys: torch.Tensor,
                   valid: torch.Tensor):
    """Main-path-shaped accumulate inputs: the presence count plane plus
    the 6 float-sum digit planes of amount = qty * price at a fixed probed
    scale, exactly as runtime/stage_compiler.py builds them."""
    dev = keys.device
    qty = torch.randint(1, 100, (n,), generator=gen, device=dev)
    price = torch.rand((n,), generator=gen, device=dev,
                       dtype=torch.float64) * 100
    amount = qty.to(torch.float64) * price
    ones = torch.ones_like(valid)
    cap_bits = 8.0 * mxu_agg.f64_chunks() - 4.0
    scale = cap_bits - (np.floor(np.log2(float(amount.abs().max()))) + 1.0)
    words, recipe, _, _, bad = mxu_agg.digitize(
        valid, [("count", ones), ("sum", amount, ones)],
        fixed_scales={1: scale})
    _require(not bool(bad), "kernel inputs digitized as bad")
    return keys.to(torch.int32).contiguous(), valid, words, recipe


def _check_equal(name, keys, valid, words, recipe, rng) -> int:
    """The chain against its plain version, both adding into one carry of
    random int64 values; returns max |diff| (0, or it raises)."""
    gh = (rng + 127) // 128
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(len(name))
    start = torch.randint(-2**62, 2**62, (gh, len(recipe), 128),
                          generator=gen, device=keys.device)
    got, want = start.clone(), start.clone()
    mxu_agg.accumulate_into(got, keys, valid, words, recipe, rng)
    mxu_agg._accumulate_into_ref(want, keys, valid, words, recipe, rng)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"mxu_accumulate != plain version on {name} "
                             f"input (max |diff| {err})")
    return err


def _full(out):
    """num_rows, then every column as f64, nulls as -1."""
    return torch.cat([out.num_rows.to(torch.float64)[None]] + [
        torch.where(c.valid_mask(), c.data.to(torch.float64),
                    torch.full_like(c.data, -1, dtype=torch.float64))
        for c in out.columns])


def _digest(out):
    """_full's columns as weighted checksums (one small pull; bench.py's
    digest)."""
    cap = out.columns[0].data.shape[0]
    packed = _full(out)[1:].reshape(len(out.columns), cap)
    w = (torch.arange(cap, dtype=torch.float64, device=out.device)
         % 8191.0) + 1.0
    live = torch.arange(cap, device=out.device) < out.num_rows
    wl = torch.where(live, w, torch.zeros_like(w))
    return torch.cat([out.num_rows.to(torch.float64)[None], packed @ wl])


def _unpack(packed, ncols):
    """(n, [column arrays of the n live rows]) of a _full result."""
    n = int(packed[0])
    cols = packed[1:].reshape(ncols, -1)
    return n, [c[:n] for c in cols]


def _host_digest(packed, ncols):
    cols = packed[1:].reshape(ncols, -1)
    cap = cols.shape[1]
    w = (np.arange(cap, dtype=np.float64) % 8191.0) + 1.0
    wl = np.where(np.arange(cap) < packed[0], w, 0.0)
    return np.concatenate([packed[:1], cols @ wl])


def _reset_counts() -> None:
    """Counts of the path about to run: kernel launches, host pulls, serde
    host time."""
    mxu_agg.KERNEL_LAUNCHES = 0
    for name in mxu_agg.CHAIN_LAUNCHES:
        mxu_agg.CHAIN_LAUNCHES[name] = 0
    metrics.HOST_PULLS = 0
    for k in metrics.SERDE_NS:
        metrics.SERDE_NS[k] = 0
    for k in metrics.SERDE_BYTES:
        metrics.SERDE_BYTES[k] = 0


def _timed_reps(plan, packed, ncols, reps=PATH_REPS):
    """WARM_REPS untimed reps (allocator and launch caches settle), then
    `reps` timed reps of collect_fetch(plan), each held to the checked
    first run's digest (rtol 1e-9: float sums add in an order that is not
    fixed on the card). Returns the rep times (s)."""
    want = _host_digest(packed, ncols)
    for _ in range(WARM_REPS):
        collect_fetch(plan, _digest)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        d = collect_fetch(plan, _digest)
        times.append(time.perf_counter() - t0)
        np.testing.assert_allclose(d, want, rtol=1e-9)
    return times


def _device_profile(fn, cpu=True):
    """One call of fn under torch.profiler: (rows, busy_ms), rows being
    (device us, name, launches) by kernel, most time first. cpu=False
    traces the device alone: the same kernel rows at about a third of the
    profiler's cost over a stage of 10^5 launches."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((float(us), e.key, int(e.count)))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) / 1e3


def _top(rows, k=12):
    return [{"kernel": name[:100], "ms": us / 1e3, "calls": c}
            for us, name, c in rows[:k]]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _emit({"phase": "card", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.build_all(sorted(kernels.SIGNATURES))
    for name in sorted(kernels.SIGNATURES):
        kernels.load(name)
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": kernels.BUILD_INFO})


def _time_case(keys, valid, words, recipe, rng) -> dict:
    """Kernel-only (profiler and event stretch) and wrapper times of the
    chain on one input. Launches made here count; the main path resets the
    counters before its run."""
    gh = (rng + 127) // 128
    acc = torch.zeros((gh, len(recipe), 128), dtype=torch.int64,
                      device=keys.device)
    launch = mxu_agg._chain_call(acc, keys, valid, words, recipe, rng)
    ms, split = _profiled_ms(launch)
    return {"ms": ms, "chain": split,
            "stretch_ms": _stretch_ms(launch),
            "wrapper_ms": _wall_ms(lambda: mxu_agg.accumulate_into(
                acc, keys, valid, words, recipe, rng))}


CHAIN_KERNELS = ("mxu_count_kernel", "mxu_scan_kernel", "mxu_scatter_kernel",
                 "mxu_accumulate_kernel")


def main_path_inputs():
    """The accumulate inputs of one main-path batch, made on the card from
    seed 0, under four key distributions: uniform; 90% of rows on 8 hot
    keys 4099 apart (in 8 key slices of the chain); 90% on keys 0..7 (all
    in one slice); every row on key 4099. Each is (keys, valid, words,
    recipe); only the keys differ."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = ROWS
    keys = torch.randint(0, GROUPS, (n,), generator=gen, device=dev)
    # the main path's filter keeps ~45% of rows (qty <= 50, price > 10)
    valid = torch.rand((n,), generator=gen, device=dev) < 0.45
    k, v, words, recipe = _kernel_inputs(gen, n, keys, valid)
    hot = torch.randint(0, 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    on_hot = torch.rand((n,), generator=gen, device=dev) < 0.9

    def case(keys):
        return keys.contiguous(), v, words, recipe

    return {"uniform": case(k),
            "skewed": case(torch.where(on_hot, hot * 4099, k)),
            "skewed-one-slice": case(torch.where(on_hot, hot, k)),
            "one-key": case(torch.full_like(k, 4099))}


def phase_kernel() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n, rng = ROWS, GROUPS
    gh = rng // 128
    cases = main_path_inputs()
    k, v, words, recipe = cases["uniform"]
    P, W = len(recipe), len(words)
    max_err = max(_check_equal(name, *case, rng)
                  for name, case in cases.items())

    # ragged length, masked rows, 32 planes
    m = n - 12345
    max_err = max(max_err, _check_equal(
        "ragged", k[:m].contiguous(), v[:m].contiguous(),
        [w[:m].contiguous() for w in words], recipe, rng))
    max_err = max(max_err, _check_equal(
        "all-masked", k, torch.zeros_like(v), words, recipe, rng))
    wide = [torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(8)]
    wide_recipe = tuple(("digit", w, sh) for w in range(8)
                        for sh in (0, 8, 16, 24))
    max_err = max(max_err, _check_equal("P=32", k, v, wide, wide_recipe,
                                        rng))

    # times at the main-path shape, for each key distribution
    t = {name: _time_case(*case, rng) for name, case in cases.items()}
    uni = t["uniform"]
    plain_acc = torch.zeros((gh, P, 128), dtype=torch.int64, device=dev)
    plain_ms = _stretch_ms(lambda: mxu_agg._accumulate_into_ref(
        plain_acc, k, v, words, recipe, rng))
    # yardstick: one index_add_ into the carry, indices and masked digits
    # computed beforehand
    idx = mxu_agg._plane_index(k, P).reshape(-1)
    vals = (mxu_agg._expand_words(words, recipe).to(torch.int64)
            * v[:, None]).reshape(-1)
    lib_acc = torch.zeros((gh * P * 128,), dtype=torch.int64, device=dev)
    lib_ms = _stretch_ms(lambda: lib_acc.index_add_(0, idx, vals))
    n_ok = int(v.sum())
    # each input read once, the carry read and written once
    nbytes = (4 + 1 + 4 * W) * n + 2 * gh * P * 128 * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ok * P / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    res = {"phase": "kernel", "name": "mxu_accumulate", "n": n, "gh": gh,
           "planes": P, "words": W, "rows_ok": n_ok,
           "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "ms": uni["ms"], "stretch_ms": uni["stretch_ms"],
           "wrapper_ms": uni["wrapper_ms"],
           "skewed_ms": t["skewed"]["ms"],
           "skewed_one_slice_ms": t["skewed-one-slice"]["ms"],
           "one_key_ms": t["one-key"]["ms"],
           "skewed_wrapper_ms": t["skewed"]["wrapper_ms"],
           "bound_fraction": bound_ms / uni["ms"],
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "ms_over_library": uni["ms"] / lib_ms,
           "wrapper_over_library": uni["wrapper_ms"] / lib_ms,
           "cases": t, "max_abs_err": max_err,
           "checked": list(cases) + ["ragged", "all-masked", "P=32"]}
    _emit(res)
    return res


def phase_main_path(kernel: dict) -> dict:
    t0 = time.perf_counter()
    datas = [_make_data(seed) for seed in range(N_BATCHES)]
    input_bytes = sum(sum(a.nbytes for a in d.values()) for d in datas)
    batches = [ColumnBatch.from_numpy(d, SCHEMA, capacity=ROWS)
               for d in datas]
    torch.cuda.synchronize()
    _require(batches[0].device.type == "cuda", "batches not on cuda")
    ref = _item_oracle(datas)
    setup_s = time.perf_counter() - t0

    rid = resources.register(lambda: iter(batches))
    plan, _ = decode_task_definition(_build_task(SCHEMA_PB, rid))

    # the run whose launches count and whose result is checked in full
    _reset_counts()
    t1 = time.perf_counter()
    packed = collect_fetch(plan, _full)
    first_s = time.perf_counter() - t1
    launches = mxu_agg.KERNEL_LAUNCHES
    chain = dict(mxu_agg.CHAIN_LAUNCHES)
    if launches != N_BATCHES or set(chain.values()) != {N_BATCHES}:
        raise AssertionError(f"main path launched mxu_accumulate {launches} "
                             f"times ({chain}) for {N_BATCHES} batches")
    n, (keys, sums, cnts) = _unpack(packed, 3)
    order = np.argsort(keys, kind="stable")
    keys, sums, cnts = keys[order], sums[order], cnts[order]
    nz = ref["cnt"] > 0
    np.testing.assert_array_equal(keys, np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts, ref["cnt"][nz])
    np.testing.assert_allclose(sums, ref["sum_amount"][nz], rtol=1e-9)
    _require(bool(np.all(np.isfinite(sums))), "non-finite sums")

    times = _timed_reps(plan, packed, 3, REPS)
    best, med = min(times), float(np.median(times))
    total_rows = N_BATCHES * ROWS
    _emit({"phase": "main_path", "batches": N_BATCHES, "rows": total_rows,
           "groups": n, "input_bytes": input_bytes, "setup_s": setup_s,
           "first_run_s": first_s, "launches": launches,
           "chain_launches": chain,
           "rep_s": times, "best_rep_s": best, "median_rep_s": med,
           "rows_per_s": total_rows / med,
           "input_GB_per_s": input_bytes / med / 1e9,
           "kernel_share": kernel["ms"] * N_BATCHES / 1e3 / med,
           "max_abs_err_sum": float(np.max(np.abs(
               sums - ref["sum_amount"][nz])))})
    return {"launches": launches, "chain": chain, "plan": plan,
            "rep_s": med, "datas": datas, "batches": batches}


def phase_profile(plan, rep_s: float) -> None:
    """One warm rep of the main path under torch.profiler: device time by
    kernel name and the device's idle share against an unprofiled rep."""
    rows, busy_ms = _device_profile(lambda: collect_fetch(plan, _digest))
    # the chain's kernels as the device ran them: once per batch each
    chain = {name: sum(c for _, key, c in rows if name in key)
             for name in CHAIN_KERNELS}
    if set(chain.values()) != {N_BATCHES}:
        raise AssertionError(f"profiled rep ran the chain's kernels {chain} "
                             f"times for {N_BATCHES} batches")
    _emit({"phase": "profile", "rep_ms": rep_s * 1e3,
           "device_busy_ms": busy_ms,
           "device_launches": sum(r[2] for r in rows),
           "idle_share": 1.0 - busy_ms / (rep_s * 1e3),
           "chain_kernel_calls": chain, "top": _top(rows)})


# ---------------------------------------------------------------------------
# the later paths: dense min/max, the general aggregation, the chain stage
# ---------------------------------------------------------------------------

def phase_dense_minmax(datas, batches) -> dict:
    """q06 with min(price) and max(amount) beside sum and count: the dense
    path with its min/max carriers, one chain launch a batch."""
    rid = resources.register(lambda: iter(batches))
    plan, _ = decode_task_definition(_build_task(SCHEMA_PB, rid,
                                                 aggs=MINMAX_AGGS))
    _reset_counts()
    packed = collect_fetch(plan, _full)
    launches, chain = mxu_agg.KERNEL_LAUNCHES, dict(mxu_agg.CHAIN_LAUNCHES)
    pulls = metrics.HOST_PULLS
    compiled = plan.metrics["stage_compiled"]
    _require(compiled == 1,
             "dense_minmax did not take the dense path")
    if launches != N_BATCHES or set(chain.values()) != {N_BATCHES}:
        raise AssertionError(f"dense_minmax launched mxu_accumulate "
                             f"{launches} times ({chain}) for {N_BATCHES} "
                             "batches")
    n, (keys, sums, cnts, mins, maxs) = _unpack(packed, 5)
    order = np.argsort(keys, kind="stable")
    ref = _numpy_grouped(datas, lambda i, keep: datas[i]["ss_item_sk"][keep],
                         GROUPS)
    nz = ref["cnt"] > 0
    np.testing.assert_array_equal(keys[order], np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts[order], ref["cnt"][nz])
    np.testing.assert_array_equal(mins[order], ref["min_price"][nz])
    np.testing.assert_array_equal(maxs[order], ref["max_amount"][nz])
    np.testing.assert_allclose(sums[order], ref["sum_amount"][nz],
                               rtol=1e-9)
    times = _timed_reps(plan, packed, 5)
    med = float(np.median(times))
    rows, busy_ms = _device_profile(lambda: collect_fetch(plan, _digest))
    res = {"phase": "dense_minmax", "batches": N_BATCHES,
           "rows": N_BATCHES * ROWS, "groups": n, "launches": launches,
           "chain_launches": chain, "host_pulls": pulls,
           "stage_compiled": compiled,
           "rep_s": times, "median_rep_s": med, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (med * 1e3),
           "device_launches": sum(r[2] for r in rows),
           "top": _top(rows)}
    _emit(res)
    return res


def _general_batches(batches, customers):
    """q06's batches on the card with ss_customer_sk in front."""
    out = []
    for b, (keys, valid) in zip(batches, customers):
        k = torch.from_numpy(np.where(valid, keys, 0)).to(b.device)
        v = torch.from_numpy(valid).to(b.device)
        out.append(ColumnBatch(GENERAL_SCHEMA,
                               [Column(T.INT32, k, v)] + b.columns,
                               b.num_rows, b.capacity))
    return out


def _check_general(packed, keys, cols):
    """A packed GENERAL_AGGS result against the numpy oracle: keys,
    counts, min and max exact, sums and averages rtol 1e-9."""
    names = [name for _, _, _, name in GENERAL_AGGS]
    n, got = _unpack(packed, 1 + len(names))
    _require(n == len(keys), f"{n} groups, the oracle has {len(keys)}")
    np.testing.assert_array_equal(got[0], keys)
    for name, col in zip(names, got[1:]):
        if name in ("sum_amount", "avg_price"):
            np.testing.assert_allclose(col, cols[name], rtol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(col, cols[name], err_msg=name)
    _require(bool(np.all(np.isfinite(np.stack(got[1:])))),
             "non-finite aggregates")


def phase_general_agg(datas, batches) -> dict:
    """bench.py's q06 rows grouped by a nullable ss_customer_sk of 2 M
    values (TPC-DS SF100): the dense path declines (null keys, a range
    past dense_agg_range) and the captured batches stream through the
    sort-based AggExec; then the same plan under a top-100 sort."""
    t0 = time.perf_counter()
    datas, batches = datas[:GENERAL_BATCHES], batches[:GENERAL_BATCHES]
    customers = [_make_customers(s) for s in range(len(datas))]
    gbatches = _general_batches(batches, customers)
    okeys, ocols = _general_oracle(datas, customers)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rid = resources.register(lambda: iter(gbatches))
    task = _build_task(GENERAL_SCHEMA_PB, rid, key="ss_customer_sk",
                       aggs=GENERAL_AGGS)
    plan, _ = decode_task_definition(task)
    ncols = 1 + len(GENERAL_AGGS)

    mgr = memory.get_manager()
    mgr.reset_peak()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t1 = time.perf_counter()
    packed = collect_fetch(plan, _full)
    first_s = time.perf_counter() - t1
    launches, pulls = mxu_agg.KERNEL_LAUNCHES, metrics.HOST_PULLS

    def collapses():
        return plan.metrics["collapses"] + plan.children[0].metrics[
            "collapses"]

    first_collapses = collapses()
    compiled, fallbacks = (plan.metrics["stage_compiled"],
                           plan.metrics["stage_fallbacks"])
    _require(compiled == 0, "general_agg took the dense path")
    _require(fallbacks == 1,
             "general_agg did not fall back to the streaming AggExec")
    _require(first_collapses >= 1, "general_agg made no collapse")
    _check_general(packed, okeys, ocols)
    mem_peak = mgr.peak_used
    dev_peak = torch.cuda.max_memory_allocated()
    _require(mgr.mem_used() == 0, "agg state still registered")

    c0 = collapses()
    metrics.HOST_PULLS = 0
    times = _timed_reps(plan, packed, ncols)
    per_rep = PATH_REPS + WARM_REPS
    rep_pulls = metrics.HOST_PULLS / per_rep
    rep_collapses = (collapses() - c0) / per_rep
    med = float(np.median(times))
    rows, busy_ms = _device_profile(lambda: collect_fetch(plan, _digest))

    # the same plan under Sort(cnt DESC, ss_customer_sk ASC NULLS FIRST)
    # with a fetch limit of 100; integer keys decide every tie
    top_plan, _ = decode_task_definition(_build_task(
        GENERAL_SCHEMA_PB, rid, key="ss_customer_sk", aggs=GENERAL_AGGS,
        sort=TOP_SORT, fetch=TOP_N))
    top_packed = collect_fetch(top_plan, _full)
    _check_general(top_packed, *_top_oracle(okeys, ocols))
    top_times = _timed_reps(top_plan, top_packed, ncols)
    res = {"phase": "general_agg", "batches": len(gbatches),
           "rows": len(gbatches) * ROWS, "customers": CUSTOMERS,
           "null_share": NULL_SHARE, "groups": len(okeys),
           "setup_s": setup_s, "first_run_s": first_s,
           "stage_compiled": compiled, "stage_fallbacks": fallbacks,
           "mxu_accumulate_launches": launches,
           "first_run_host_pulls": pulls,
           "first_run_collapses": first_collapses,
           "host_pulls_per_rep": rep_pulls,
           "collapses_per_rep": rep_collapses,
           "mem_manager_peak_bytes": mem_peak,
           "mem_budget_bytes": mgr.total,
           "cuda_max_allocated_bytes": dev_peak,
           "rep_s": times, "median_rep_s": med,
           "rows_per_s": len(gbatches) * ROWS / med,
           "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (med * 1e3),
           "device_launches": sum(r[2] for r in rows),
           "top": _top(rows),
           "top100_rep_s": top_times,
           "top100_median_rep_s": float(np.median(top_times))}
    _emit(res)
    return res, {"datas": datas, "customers": customers,
                 "batches": gbatches, "oracle": (okeys, ocols)}


def phase_chain_stage(datas, batches) -> dict:
    """BASELINE config 1: q06's scan -> filter -> project with no
    aggregate over CHAIN_BATCHES batches, as one chain stage: one
    compacted batch, rows checked exactly against numpy."""
    datas, batches = datas[:CHAIN_BATCHES], batches[:CHAIN_BATCHES]
    rid = resources.register(lambda: iter(batches))
    plan, _ = decode_task_definition(_build_task(SCHEMA_PB, rid, agg=False))
    _reset_counts()
    out = collect(plan)
    pulls = metrics.HOST_PULLS
    compiled = plan.metrics["stage_compiled"]
    _require(compiled == 1, "chain_stage did not take the chain stage")
    _require(out.capacity == CHAIN_BATCHES * ROWS,
             f"chain stage capacity {out.capacity}")
    packed = _full(out).cpu().numpy()
    n, (keys, amount) = _unpack(packed, 2)
    kept = [_kept(d) for d in datas]
    np.testing.assert_array_equal(keys, np.concatenate(
        [d["ss_item_sk"][keep] for d, (keep, _) in zip(datas, kept)]))
    np.testing.assert_array_equal(amount, np.concatenate(
        [a for _, a in kept]))
    times = _timed_reps(plan, packed, 2)
    med = float(np.median(times))
    rows, busy_ms = _device_profile(lambda: collect_fetch(plan, _digest))
    res = {"phase": "chain_stage", "batches": CHAIN_BATCHES,
           "rows": CHAIN_BATCHES * ROWS, "rows_out": n, "host_pulls": pulls,
           "stage_compiled": compiled,
           "rep_s": times, "median_rep_s": med, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (med * 1e3), "top": _top(rows, 6)}
    _emit(res)
    return res


# ---------------------------------------------------------------------------
# the shuffle and spill paths: two-stage queries, work past the budget
# ---------------------------------------------------------------------------

def _shuffle_query(batches, schema_pb, work_dir, tag, key="ss_item_sk",
                   aggs=None, tasks=MAP_TASKS):
    """The task bytes of a two-stage query: `tasks` map tasks over
    consecutive slices of `batches`, each committing a .data/.index pair
    under work_dir, and SHUFFLE_PARTITIONS reduce tasks, whose ipc_reader
    provider reads its partition from every map output. Returns (map
    tasks, reduce tasks, [(data, index)] of the map tasks)."""
    per = len(batches) // tasks
    src = resources.register(
        lambda task: iter(batches[task * per:(task + 1) * per]))
    outputs = [(os.path.join(work_dir, f"{tag}_{t}.data"),
                os.path.join(work_dir, f"{tag}_{t}.index"))
               for t in range(tasks)]
    maps = [_shuffle_map_task(schema_pb, src, t, d, i, key=key, aggs=aggs,
                              partitions=SHUFFLE_PARTITIONS)
            for t, (d, i) in enumerate(outputs)]
    state_schema = decode_task_definition(maps[0])[0].children[0].schema

    def provide(partition):
        for d, i in outputs:
            yield from read_shuffle_partition_host(d, i, partition,
                                                   state_schema)

    rid = resources.register(provide)
    reduces = [_shuffle_reduce_task(state_schema, rid, p, key=key,
                                    aggs=aggs, partitions=SHUFFLE_PARTITIONS)
               for p in range(SHUFFLE_PARTITIONS)]
    return maps, reduces, outputs


def _run_map_stage(maps, mem_manager=None):
    """Every map task decoded from its bytes and run to its commit; returns
    the writer plans and each task's wall time (s)."""
    plans, secs = [], []
    for task in maps:
        t0 = time.perf_counter()
        plan, td = decode_task_definition(task)
        list(execute_plan(plan, ExecContext(
            partition=td.partition_id, num_partitions=len(maps),
            mem_manager=mem_manager)))
        secs.append(time.perf_counter() - t0)
        plans.append(plan)
    return plans, secs


def _run_reduce_stage(reduces, ncols, device=None):
    """Every reduce task decoded and collected onto `device` (None: the
    card), its rows pulled once; the union of their rows in _full's layout,
    ordered by key (null as -1 first)."""
    cols = []
    for task in reduces:
        plan, td = decode_task_definition(task)
        packed = collect_fetch(plan, _full, ExecContext(
            partition=td.partition_id, num_partitions=len(reduces),
            device=device))
        cols.append(_unpack(packed, ncols)[1])
    cols = [np.concatenate(c) for c in zip(*cols)]
    order = np.argsort(cols[0], kind="stable")
    return np.concatenate([[len(order)]] + [c[order] for c in cols])


def _shuffle_counts(plans, outputs) -> dict:
    """What the map stage wrote: bytes, frames (from the index footers),
    the frames' payload bytes before compression (their headers' raw_len),
    and whether every committed pair verifies."""
    frames = raw = 0
    for data, index in outputs:
        frames += artifacts.read_index(index)[1]["n_frames"]
        with open(data, "rb") as f:
            raw += sum(r for r, _ in serde.frame_headers(f))
    return {"shuffle_bytes": sum(p.metrics["shuffle_bytes_written"]
                                 for p in plans),
            "shuffle_raw_bytes": raw, "frames": frames,
            "verified": all(artifacts.verify_pair(d, i)
                            for d, i in outputs)}


def _shuffle_rep(maps, reduces, outputs, ncols, want) -> dict:
    """One timed rep of a two-stage query, its union held to the checked
    run's (keys and counts exact, float columns rtol 1e-9)."""
    _reset_counts()
    t0 = time.perf_counter()
    plans, task_s = _run_map_stage(maps)
    t1 = time.perf_counter()
    got = _run_reduce_stage(reduces, ncols)
    t2 = time.perf_counter()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    return dict(_shuffle_counts(plans, outputs), map_s=t1 - t0,
                reduce_s=t2 - t1, map_task_s=task_s,
                host_pulls=metrics.HOST_PULLS,
                serde_encode_s=metrics.SERDE_NS["encode"] / 1e9,
                serde_decode_s=metrics.SERDE_NS["decode"] / 1e9,
                launches=mxu_agg.KERNEL_LAUNCHES)


def _host_profile(fn, k=8):
    """One call of fn under cProfile: the k functions with the most own
    host time, heaviest first."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:k]
    return [{"fn": f"{os.path.basename(f)}:{line}({fname})", "calls": nc,
             "own_s": tt, "cum_s": ct}
            for (f, line, fname), (_, nc, tt, ct, _) in rows]


def _shuffle_summary(name, checked, reps, maps, reduces) -> dict:
    """The phase line: the checked run's counts, the medians of the timed
    reps, one map task profiled on the device (busy time, idle share
    against the reps' median task time), and one reduce task timed alone,
    profiled on the device and on the host (cProfile)."""
    def med(k):
        return float(np.median([r[k] for r in reps]))

    task_s = float(np.median([s for r in reps for s in r["map_task_s"]]))

    def one_map_task():
        plan, td = decode_task_definition(maps[0])
        list(execute_plan(plan, ExecContext(partition=td.partition_id,
                                            num_partitions=len(maps))))

    def one_reduce_task():
        plan, td = decode_task_definition(reduces[0])
        collect_fetch(plan, _full, ExecContext(
            partition=td.partition_id, num_partitions=len(reduces)))

    rows, busy_ms = _device_profile(one_map_task)
    one_reduce_task()
    t0 = time.perf_counter()
    one_reduce_task()
    reduce_task_s = time.perf_counter() - t0
    rrows, rbusy_ms = _device_profile(one_reduce_task)
    return dict(checked, phase=name, map_tasks=len(maps),
                reduce_task_s=reduce_task_s,
                reduce_task_device_busy_ms=rbusy_ms,
                reduce_task_device_launches=sum(r[2] for r in rrows),
                reduce_task_idle_share=1.0 - rbusy_ms / (reduce_task_s * 1e3),
                reduce_task_top=_top(rrows, 5),
                reduce_task_host_top=_host_profile(one_reduce_task),
                reduce_tasks=SHUFFLE_PARTITIONS,
                map_s=[r["map_s"] for r in reps],
                reduce_s=[r["reduce_s"] for r in reps],
                median_map_s=med("map_s"), median_reduce_s=med("reduce_s"),
                median_map_task_s=task_s,
                host_pulls_per_rep=med("host_pulls"),
                frames_per_rep=med("frames"),
                shuffle_bytes_per_rep=med("shuffle_bytes"),
                shuffle_raw_bytes_per_rep=med("shuffle_raw_bytes"),
                serde_encode_s=med("serde_encode_s"),
                serde_decode_s=med("serde_decode_s"),
                map_task_device_busy_ms=busy_ms,
                map_task_idle_share=1.0 - busy_ms / (task_s * 1e3),
                map_task_top=_top(rows, 8))


def _checked_shuffle(maps, reduces, outputs, ncols) -> tuple:
    """The checked first run: counts reset before it, read after; returns
    (the reduce stage's union, the counts, the writer plans)."""
    _reset_counts()
    t0 = time.perf_counter()
    plans, _ = _run_map_stage(maps)
    map_s = time.perf_counter() - t0
    launches, chain = mxu_agg.KERNEL_LAUNCHES, dict(mxu_agg.CHAIN_LAUNCHES)
    counts = _shuffle_counts(plans, outputs)
    _require(counts["verified"], "a map output's checksums do not verify")
    got = _run_reduce_stage(reduces, ncols)
    return got, dict(counts, first_map_s=map_s, launches=launches,
                     chain_launches=chain,
                     first_run_host_pulls=metrics.HOST_PULLS,
                     stage_compiled=[p.children[0].metrics["stage_compiled"]
                                     for p in plans],
                     stage_fallbacks=[p.children[0].metrics["stage_fallbacks"]
                                      for p in plans]), plans


def phase_shuffle_q06(datas, batches, work_dir) -> dict:
    """q06 the way Spark plans it: HashAggregate(partial) -> Exchange
    hashpartitioning(ss_item_sk, 200) -> HashAggregate(final). Each map
    task runs the dense stage (one accumulate chain launch a batch) and
    commits its pair; each reduce task reads its partition of the 8 map
    outputs and finalizes it."""
    maps, reduces, outputs = _shuffle_query(batches, SCHEMA_PB, work_dir,
                                            "q06")
    got, checked, _ = _checked_shuffle(maps, reduces, outputs, 3)
    _require(checked["stage_compiled"] == [1] * MAP_TASKS,
             f"a q06 map task left the dense path: {checked}")
    launches, chain = checked["launches"], checked["chain_launches"]
    if launches != N_BATCHES or set(chain.values()) != {N_BATCHES}:
        raise AssertionError(f"shuffle_q06 launched mxu_accumulate "
                             f"{launches} times ({chain}) for {N_BATCHES} "
                             "batches")
    n, (keys, sums, cnts) = _unpack(got, 3)
    ref = _item_oracle(datas)
    nz = ref["cnt"] > 0
    np.testing.assert_array_equal(keys, np.nonzero(nz)[0])
    np.testing.assert_array_equal(cnts, ref["cnt"][nz])
    np.testing.assert_allclose(sums, ref["sum_amount"][nz], rtol=1e-9)
    reps = [_shuffle_rep(maps, reduces, outputs, 3, got)
            for _ in range(SHUFFLE_REPS)]
    _require(all(r["launches"] == N_BATCHES for r in reps),
             "a timed shuffle_q06 rep did not launch once a batch")
    res = _shuffle_summary("shuffle_q06", checked, reps, maps, reduces)
    res.update(groups=n, batches=N_BATCHES, rows=N_BATCHES * ROWS)
    _emit(res)
    return res


def phase_shuffle_general(general, work_dir) -> dict:
    """GROUP BY a nullable ss_customer_sk (2 M values) across the same
    8 x 200 shuffle: the map tasks fall back to the streaming AggExec and
    launch no kernel; about 15 M partial state rows cross the serde."""
    maps, reduces, outputs = _shuffle_query(
        general["batches"], GENERAL_SCHEMA_PB, work_dir, "general",
        key="ss_customer_sk", aggs=GENERAL_AGGS)
    ncols = 1 + len(GENERAL_AGGS)
    got, checked, plans = _checked_shuffle(maps, reduces, outputs, ncols)
    _require(checked["stage_compiled"] == [0] * MAP_TASKS
             and checked["stage_fallbacks"] == [1] * MAP_TASKS,
             f"a general map task did not fall back: {checked}")
    _require(checked["launches"] == 0, "shuffle_general launched a kernel")
    _check_general(got, *general["oracle"])
    state_rows = sum(p.children[0].metrics["output_rows"] for p in plans)
    reps = [_shuffle_rep(maps, reduces, outputs, ncols, got)
            for _ in range(SHUFFLE_GENERAL_REPS)]
    res = _shuffle_summary("shuffle_general", checked, reps, maps,
                           reduces)
    res.update(groups=int(got[0]), partial_state_rows=state_rows,
               batches=len(general["batches"]),
               rows=len(general["batches"]) * ROWS)
    _emit(res)
    return res


def phase_spill(datas, batches, general, work_dir) -> dict:
    """(a) map task 0 of the general shuffle under SPILL_AGG_BUDGET: its
    agg state spills to host files and merges back; the reduce stage over
    that one output against numpy. (b) the chain stage's rows under
    Sort(amount DESC, ss_item_sk ASC) with no fetch, under
    SPILL_SORT_BUDGET: sorted runs spill and merge on the host; every row,
    in order, against numpy's stable sort."""
    per = len(general["batches"]) // MAP_TASKS
    gdatas = general["datas"][:per]
    maps, reduces, outputs = _shuffle_query(
        general["batches"][:per], GENERAL_SCHEMA_PB, work_dir, "spill",
        key="ss_customer_sk", aggs=GENERAL_AGGS, tasks=1)
    ncols = 1 + len(GENERAL_AGGS)
    mgr = memory.MemManager(SPILL_AGG_BUDGET)
    t0 = time.perf_counter()
    plans, _ = _run_map_stage(maps, mgr)
    agg_s = time.perf_counter() - t0
    agg = plans[0].children[0]
    agg_spills = agg.metrics["spill_count"]
    _require(agg_spills >= 2, f"agg state spilled {agg_spills} times")
    got = _run_reduce_stage(reduces, ncols)
    _check_general(got, *_general_oracle(gdatas,
                                         general["customers"][:per]))

    sort_batches = batches[:CHAIN_BATCHES]
    rid = resources.register(lambda: iter(sort_batches))
    plan, _ = decode_task_definition(_build_task(
        SCHEMA_PB, rid, agg=False, sort=SPILL_SORT))
    smgr = memory.MemManager(SPILL_SORT_BUDGET)
    t1 = time.perf_counter()
    out = collect(plan, ExecContext(mem_manager=smgr))
    n, (keys, amount) = _unpack(_full(out).cpu().numpy(), 2)
    sort_s = time.perf_counter() - t1
    runs = plan.metrics["spill_count"]
    _require(runs >= 4, f"the sort spilled {runs} runs")
    kept = [_kept(d) for d in datas[:CHAIN_BATCHES]]
    want_k = np.concatenate([d["ss_item_sk"][keep]
                             for d, (keep, _) in zip(datas, kept)])
    want_a = np.concatenate([a for _, a in kept])
    order = np.lexsort((want_k, -want_a))
    np.testing.assert_array_equal(keys, want_k[order])
    np.testing.assert_array_equal(amount, want_a[order])
    res = {"phase": "spill",
           "agg_budget_bytes": SPILL_AGG_BUDGET,
           "agg_spill_count": agg_spills,
           "agg_spilled_bytes": mgr.host_spill_bytes,
           "agg_spill_files": mgr.host_spill_files,
           "agg_peak_bytes": mgr.peak_used,
           "agg_map_task_s": agg_s, "agg_rows": per * ROWS,
           "sort_budget_bytes": SPILL_SORT_BUDGET,
           "sort_rows": n, "sort_runs": runs,
           "sort_spilled_bytes": plan.metrics["spilled_bytes"],
           "sort_merge_s": plan.metrics["spill_merge_ns"] / 1e9,
           "sort_s": sort_s, "sort_peak_bytes": smgr.peak_used}
    _emit(res)
    return res


# ---------------------------------------------------------------------------
# the TPC-DS phases: broadcast joins and a sort-merge join lattice over
# Parquet files
# ---------------------------------------------------------------------------

# date_dim: every TPC-DS scale holds the calendar 1900-01-02 .. 2100-01-01,
# d_date_sk counting days from 2,415,022
DATE_SK0 = 2_415_022
DATE_DIM_ROWS = 73_049
# the sales window of the fact tables' date keys (1998-01-02 .. 2003-01-02)
SALES_SK = (2_450_816, 2_452_642)
# fact tables: files of FACT_FILE_ROWS rows, one row group each (SF100
# holds 72,001,237 web_sales, 143,997,065 catalog_sales and 287,997,024
# store_sales rows; these are cut 2.1x, 2.1x and 17x)
FACT_FILE_ROWS = 1 << 21
TPCDS_FILES = {"web_sales": 16, "catalog_sales": 32, "store_sales": 8}
TPCDS_NULL_SHARE = 0.05
TPCDS_REPS = 1       # timed reps of each TPC-DS phase after its checked run
TPCDS_SEED = 20_260_000

DD_PB = [("d_date_sk", pb.TK_INT64), ("d_year", pb.TK_INT32),
         ("d_moy", pb.TK_INT32), ("d_qoy", pb.TK_INT32)]
# (date key, customer key, price) of each fact table, as tpcds.py names them
FACT_COLS = {
    "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk",
                  "ws_ext_sales_price"),
    "catalog_sales": ("cs_sold_date_sk", "cs_ship_customer_sk",
                      "cs_ext_sales_price"),
    "store_sales": ("ss_sold_date_sk", "ss_customer_sk",
                    "ss_ext_sales_price"),
}
Q02_AGGS = [("sum", "price", "f64", "total"), ("count", "price", "i64", "n")]
# q04's year_total arms: (name, fact table, year, key name, total name)
Q04_ARMS = [("s1", "store_sales", 1999, "c1", "t_s1"),
            ("s2", "store_sales", 2000, "c2", "t_s2"),
            ("w1", "web_sales", 1999, "c3", "t_w1"),
            ("w2", "web_sales", 2000, "c4", "t_w2")]
Q04_TOP = 100
# store_sales at spark/tpcds.py's full width (SS, tpcds.py:38-51): its
# columns in order, and the four dimension keys beyond date and customer
# with SF100's dimension sizes (items, customer demographics, stores,
# promotions)
SS_COLUMNS = ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
              "ss_cdemo_sk", "ss_store_sk", "ss_promo_sk", "ss_quantity",
              "ss_list_price", "ss_sales_price", "ss_coupon_amt",
              "ss_ext_sales_price", "ss_net_profit")
SS_DIMS = (("item", 204_000), ("cdemo", 1_920_800), ("store", 402),
           ("promo", 1_000))
# q09's quantity buckets (tpcds.py:817)
Q09_BUCKETS = ((1, 20), (21, 40), (41, 60), (61, 80), (81, 100))


def _date_dim():
    """date_dim's columns (numpy), derived from the calendar."""
    days = np.datetime64("1900-01-02") + np.arange(DATE_DIM_ROWS)
    months = days.astype("datetime64[M]").astype(np.int64)
    moy = (months % 12 + 1).astype(np.int32)
    return {"d_date_sk": DATE_SK0 + np.arange(DATE_DIM_ROWS, dtype=np.int64),
            "d_year": (months // 12 + 1970).astype(np.int32),
            "d_moy": moy, "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32)}


# the decimal copies of the fact tables (runner_decimal): the same rows,
# every price or amount column a decimal(7,2), TPC-DS v2's type for them
DEC_TABLES = {t: t + "_dec" for t in ("web_sales", "catalog_sales",
                                      "store_sales")}
DEC_PRICE = (7, 2)
DEC_COLS = {"ss_list_price": "lp", "ss_sales_price": "sp",
            "ss_coupon_amt": "ca", "ss_net_profit": "np"}


def _dec_array(cents, valid=None):
    """An Arrow decimal128(7,2) array of these unscaled cents (nulls where
    `valid` is False), built from its 16-byte little-endian words."""
    import pyarrow as pa

    cents = np.where(valid, cents, 0) if valid is not None else cents
    words = np.stack([cents, cents >> 63], axis=1).astype(np.int64)
    bitmap = None
    if valid is not None and not valid.all():
        bitmap = pa.py_buffer(np.packbits(valid, bitorder="little"))
    return pa.Array.from_buffers(
        pa.decimal128(*DEC_PRICE), len(cents),
        [bitmap, pa.py_buffer(words.tobytes())],
        null_count=0 if bitmap is None else int((~valid).sum()))


def _store_sales_rest(rng, n, price):
    """The store_sales columns beyond date, customer and price, drawn after
    them from the same generator with spark/tpcds.py's distributions
    (generate_tables) on SF100's dimension sizes. Returns {column: Arrow
    array} and what q09's oracle needs: each quantity bucket's row count
    and the sum and count of its non-null ss_ext_sales_price, and the
    host columns the string queries' oracles read."""
    import pyarrow as pa

    host = {}  # name -> (values, valid) for the string queries' oracles

    def cents(name, hi, lo=0.0):  # tpcds.py's rounded prices, 4% null
        v = np.round(rng.random(n) * (hi - lo) + lo, 2)
        valid = rng.random(n) >= 0.04
        host[name] = (v, valid)
        return pa.array(v, mask=~valid)

    keys = {name: rng.integers(1, size + 1, n) for name, size in SS_DIMS}
    cols = {f"ss_{name}_sk": pa.array(v) for name, v in keys.items()}
    qty = rng.integers(1, 101, n).astype(np.int32)
    qvalid = rng.random(n) >= 0.04
    cols["ss_quantity"] = pa.array(qty, mask=~qvalid)
    host["qty"] = (qty, qvalid)
    cols.update(ss_list_price=cents("lp", 250), ss_sales_price=cents("sp", 200),
                ss_coupon_amt=cents("ca", 40),
                ss_net_profit=cents("np", 300, -100))
    q09 = np.array([(inb.sum(), price[inb].sum(), inb.sum()) for inb in
                    (qvalid & (qty >= lo) & (qty <= hi)
                     for lo, hi in Q09_BUCKETS)])
    host.update(keys, q=(qty.astype(np.float64), qvalid))
    return cols, q09, host


def _fact_file(seed, table, i, path, dd, dims, dec_path):
    """Write file i of a fact table and, at `dec_path`, its decimal copy
    (the same rows, each price or amount column a decimal(7,2) of the
    cents drawn here); returns what the oracles need of it: q02's (year,
    quarter) sums (in dollars and in exact cents) and counts for web and
    catalog sales, for web and store sales the (customer, price, cents)
    rows of 1999 and 2000, and for store sales q09's bucket counts and
    sums, the string queries' partial aggregates (`_string_partials`) and
    q03_rev's (`_decimal_partials`). store_sales is written at
    spark/tpcds.py's full width (SS), the other tables with the three
    columns the queries read."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng([seed, list(TPCDS_FILES).index(table), i])
    n = FACT_FILE_ROWS
    date = rng.integers(SALES_SK[0], SALES_SK[1] + 1, n)
    dvalid = rng.random(n) >= TPCDS_NULL_SHARE
    cust = rng.integers(1, CUSTOMERS + 1, n)
    cvalid = rng.random(n) >= TPCDS_NULL_SHARE
    cents = rng.integers(0, 30_000, n)
    price = cents / 100.0
    dcol, ccol, pcol = FACT_COLS[table]
    cols = {dcol: pa.array(date, mask=~dvalid),
            ccol: pa.array(cust, mask=~cvalid), pcol: pa.array(price)}
    dec = {pcol: _dec_array(cents)}
    out = {}
    if table == "store_sales":
        rest, out["q09"], host = _store_sales_rest(rng, n, price)
        cols.update(rest)
        cols = {name: cols[name] for name in SS_COLUMNS}
        for name, key in DEC_COLS.items():
            v, ok = host[key]
            dec[name] = _dec_array(np.rint(v * 100).astype(np.int64), ok)
        out.update(_string_partials(date, dvalid, cust, cvalid, price, host,
                                    dd, dims))
        out["q03_rev"] = _decimal_partials(date, dvalid, host, dd, dims)
        t0 = time.perf_counter()
        out.update(_nested_partials(date, dvalid, cust, cvalid, price, host,
                                    dd))
        out["nested_s"] = time.perf_counter() - t0
    pq.write_table(pa.table(cols), path, row_group_size=n,
                   compression="snappy")
    # a decimal of precision <= 9 as INT32, as Spark's Parquet writer
    # stores it (pyarrow's default is a 16-byte FIXED_LEN_BYTE_ARRAY)
    pq.write_table(pa.table({k: dec.get(k, v) for k, v in cols.items()}),
                   dec_path, row_group_size=n, compression="snappy",
                   store_decimal_as_integer=True)
    idx = date[dvalid] - DATE_SK0
    year, p, pc = dd["d_year"][idx], price[dvalid], cents[dvalid]
    if table != "store_sales":
        slot = year.astype(np.int64) * 4 + dd["d_qoy"][idx] - 1
        out["q02"] = (np.bincount(slot, weights=p, minlength=2101 * 4),
                      np.bincount(slot, minlength=2101 * 4))
        # float64 weights add integer cents exactly below 2^53
        out["q02_cents"] = np.bincount(slot, weights=pc,
                                       minlength=2101 * 4)
    if table != "catalog_sales":
        c = cust[dvalid]
        ok = cvalid[dvalid]
        out["q04"] = {y: (c[ok & (year == y)], p[ok & (year == y)],
                          pc[ok & (year == y)]) for y in (1999, 2000)}
    return out


def _decimal_partials(date, dvalid, host, dd, dims):
    """One store_sales file's share of q03_rev's answer, per year (d_moy =
    11, i_manufact_id = 28): the revenue sum(quantity * sales price) in
    cents over rows where both are set, its row count, and the sum and
    count of the sales price in cents (the average's)."""
    day = np.where(dvalid, date - DATE_SK0, 0)
    m = dvalid & (dd["d_moy"][day] == 11) & dims["manufact28"][host["item"]]
    yr = dd["d_year"][day][m] - 1900
    qty, qok = host["qty"]
    sp, sok = host["sp"]
    spc = np.rint(sp * 100).astype(np.int64)[m]
    both = qok[m] & sok[m]
    rev = np.zeros(202, np.int64)
    np.add.at(rev, yr[both], qty[m][both].astype(np.int64) * spc[both])
    ok = sok[m]
    return [rev, np.bincount(yr[both], minlength=202),
            np.bincount(yr[ok], weights=spc[ok], minlength=202),
            np.bincount(yr[ok], minlength=202)]


# the dimension tables the string queries read (runner_strings), at
# SF100's row counts: spark/tpcds.py's schemas and value formats
# (generate_tables), one file each
DIM_ROWS = {"item": dict(SS_DIMS)["item"], "customer": CUSTOMERS,
            "customer_address": 1_000_000,
            "customer_demographics": dict(SS_DIMS)["cdemo"],
            "store": dict(SS_DIMS)["store"],
            "promotion": dict(SS_DIMS)["promo"]}
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree"]


def _dim_tables(seed):
    """{table: {column: numpy or list of str}} in spark/tpcds.py's formats,
    and the arrays the oracles index by surrogate key. One departure:
    tpcds.py ties cd_gender, cd_marital_status and cd_education_status to
    i % 2, i % 5 and i % 6, so no row is ('M', 'S', 'College') and q07
    selects nothing; here they vary as a cross product (i % 2, i // 2 % 5,
    i // 10 % 6), as TPC-DS's customer_demographics does."""
    from blaze_tpu_torch.spark.tpcds import _CATS, _STATES

    rng = np.random.default_rng([seed, 99])
    n_it, n_c = DIM_ROWS["item"], DIM_ROWS["customer"]
    n_ca, n_cd = DIM_ROWS["customer_address"], DIM_ROWS[
        "customer_demographics"]
    n_st, n_pr = DIM_ROWS["store"], DIM_ROWS["promotion"]
    i_it = np.arange(n_it)
    price = np.round(rng.random(n_it) * 95 + 5, 2)
    addr = rng.integers(1, n_ca + 1, n_c)
    i_cd = np.arange(n_cd)
    i_pr = np.arange(n_pr)
    tables = {
        "item": {"i_item_sk": i_it + 1,
                 "i_item_id": [f"ITEM{i:08d}" for i in range(1, n_it + 1)],
                 "i_brand_id": (i_it % 50 + 1).astype(np.int32),
                 "i_brand": [f"Brand#{i % 50 + 1}" for i in range(n_it)],
                 "i_manufact_id": (i_it % 100 + 1).astype(np.int32),
                 "i_category": [_CATS[i % len(_CATS)] for i in range(n_it)],
                 "i_current_price": price},
        "customer": {"c_customer_sk": np.arange(1, n_c + 1),
                     "c_customer_id": [f"AAAA{i:012d}"
                                       for i in range(1, n_c + 1)],
                     "c_current_addr_sk": addr,
                     "c_current_cdemo_sk": rng.integers(1, n_cd + 1, n_c)},
        "customer_address": {
            "ca_address_sk": np.arange(1, n_ca + 1),
            "ca_state": [_STATES[i % len(_STATES)] for i in range(n_ca)],
            "ca_zip": [f"{35000 + 61 * i % 65000:05d}"
                       for i in range(n_ca)]},
        "customer_demographics": {
            "cd_demo_sk": i_cd + 1,
            "cd_gender": [("M" if i % 2 else "F") for i in range(n_cd)],
            "cd_marital_status": ["SMDWU"[i // 2 % 5] for i in range(n_cd)],
            "cd_education_status": [_EDUCATION[i // 10 % 6]
                                    for i in range(n_cd)]},
        "store": {"s_store_sk": np.arange(1, n_st + 1),
                  "s_store_name": [f"Store#{i}" for i in range(1, n_st + 1)],
                  "s_state": [_STATES[i % 4] for i in range(n_st)],
                  "s_zip": [f"{35000 + 137 * i % 65000:05d}"
                            for i in range(n_st)]},
        "promotion": {"p_promo_sk": i_pr + 1,
                      "p_channel_email": [("N" if i % 3 else "Y")
                                          for i in i_pr],
                      "p_channel_event": [("N" if i % 2 else "Y")
                                          for i in i_pr]},
    }
    cat = i_it % len(_CATS)
    cat_avg = np.bincount(cat, weights=price) / np.bincount(cat)
    pad = np.zeros(1, bool)  # index 0: no surrogate key is 0
    zips = {35000 + 61 * i % 65000 for i in range(min(n_ca, 65000))}
    dims = {
        "hot": np.concatenate([pad, price > cat_avg[cat] * 1.2]),
        "manufact28": np.concatenate([pad, i_it % 100 + 1 == 28]),
        "cust_addr": np.concatenate([[0], addr]),
        "ca_state": np.concatenate([[0], np.arange(n_ca) % len(_STATES)]),
        "cd_ok": np.concatenate([pad, (i_cd % 2 == 1) & (i_cd // 2 % 5 == 0)
                                 & (i_cd // 10 % 6 == 2)]),
        "promo_ok": np.concatenate([pad, (i_pr % 3 != 0) | (i_pr % 2 != 0)]),
        "store_ok": np.concatenate([pad, [35000 + 137 * i % 65000 in zips
                                          for i in range(n_st)]]),
    }
    return tables, dims


def _write_dims(tables, work_dir, paths):
    """One snappy Parquet file a dimension table, typed as spark/tpcds.py's
    schema of it."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from blaze_tpu_torch.columnar.arrow_io import schema_to_arrow
    from blaze_tpu_torch.spark import tpcds

    schemas = {"item": tpcds.ITEM, "customer": tpcds.CUST,
               "customer_address": tpcds.CA,
               "customer_demographics": tpcds.CD, "store": tpcds.STORE,
               "promotion": tpcds.PROMO}
    for name, cols in tables.items():
        schema = schema_to_arrow(schemas[name])
        t = pa.table([pa.array(cols[f.name], f.type) for f in schema],
                     schema=schema)
        paths[name] = os.path.join(work_dir, f"{name}.parquet")
        pq.write_table(t, paths[name], compression="snappy")


def _string_partials(date, dvalid, cust, cvalid, price, host, dd, dims):
    """One store_sales file's share of the string queries' answers:
    q03's per-year sums and counts (d_moy = 11, i_manufact_id = 28), q06's
    per-state counts (2000-01, hot items, through customer and address),
    q07's per-item row counts and sums and counts of its four measures
    (2000, the demographic and the promotion), q08's per-store row counts
    and net-profit sums and counts (2000 Q2, stores whose zip has
    customers)."""
    day = np.where(dvalid, date - DATE_SK0, 0)
    year, moy, qoy = dd["d_year"][day], dd["d_moy"][day], dd["d_qoy"][day]
    item, store = host["item"], host["store"]
    out = {}
    m = dvalid & (moy == 11) & dims["manufact28"][item]
    out["q03"] = (np.bincount(year[m] - 1900, weights=price[m],
                              minlength=202),
                  np.bincount(year[m] - 1900, minlength=202))
    m = dvalid & (year == 2000) & (moy == 1) & cvalid & dims["hot"][item]
    state = dims["ca_state"][dims["cust_addr"][cust[m]]]
    out["q06"] = np.bincount(state, minlength=8)
    m = dvalid & (year == 2000) & dims["cd_ok"][host["cdemo"]] & \
        dims["promo_ok"][host["promo"]]
    it, n_it = item[m], DIM_ROWS["item"] + 1
    q07 = [np.bincount(it, minlength=n_it)]
    for name in ("q", "lp", "ca", "sp"):
        v, ok = host[name]
        ok = ok[m]
        q07 += [np.bincount(it[ok], weights=v[m][ok], minlength=n_it),
                np.bincount(it[ok], minlength=n_it)]
    out["q07"] = q07
    m = dvalid & (year == 2000) & (qoy == 2) & dims["store_ok"][store]
    v, ok = host["np"]
    st, n_st = store[m], DIM_ROWS["store"] + 1
    ok = ok[m]
    out["q08"] = [np.bincount(st, minlength=n_st),
                  np.bincount(st[ok], weights=v[m][ok], minlength=n_st),
                  np.bincount(st[ok], minlength=n_st)]
    return out


# store_returns (spark/tpcds.py's SR): one file of 2^21 rows (SF100 holds
# 28,795,080, a 13.7x cut), values drawn as tpcds.py's generate_tables
# draws them: return dates on the sales window, customers on
# [1, 2,000,000], stores on SF100's 402, amounts in cents on [0, 300),
# 4% null
SR_ROWS = 1 << 21
STORES = dict(SS_DIMS)["store"]
Q01_STATE_TN = 0       # store i (0-based) is in _STATES[i % 4]; "TN" is 0
Q51_YEAR = 2000
NESTED_TOP = 100


def _distinct(a: np.ndarray) -> np.ndarray:
    """The sorted distinct values of an integer array, by a sort. numpy
    2.3's `np.unique` hashes integers, and on the card's host it made the
    oracles of `tpcds_data` take 18.3 s where this takes 2.7 s (the
    phase's `nested_oracle_s`)."""
    s = np.sort(a)
    return s[np.r_[True, s[1:] != s[:-1]]] if len(s) else s


def _nested_partials(date, dvalid, cust, cvalid, price, host, dd):
    """One store_sales file's share of runner_nested's answers: q05's
    per-store ss_ext_sales_price sums; q51's (item, day of 2000) keys with
    ss_sales_price in integer cents and its validity; basket_items' per
    customer row counts and ss_item_sk sums (index 0: the null customer);
    basket_stores' distinct (customer, store) pair keys (customer 0: the
    null customer)."""
    item, store = host["item"], host["store"]
    day = np.where(dvalid, date - DATE_SK0, 0)
    m = dvalid & (dd["d_year"][day] == Q51_YEAR)
    first = np.searchsorted(dd["d_year"], Q51_YEAR)
    sp, sp_ok = host["sp"]
    c0 = np.where(cvalid, cust, 0)
    return {
        "q05_sales": np.bincount(store, weights=price,
                                 minlength=STORES + 1),
        "q51": (item[m] * 366 + (day[m] - first),
                np.rint(sp[m] * 100).astype(np.int64), sp_ok[m]),
        "items": (np.bincount(c0, minlength=CUSTOMERS + 1),
                  np.bincount(c0, weights=item, minlength=CUSTOMERS + 1)),
        "pairs": _distinct(c0 * (STORES + 1) + store),
    }


def _store_returns(seed, path, dd) -> dict:
    """Write store_returns; returns q05's per-store sr_return_amt sums and
    q01's answer: the customer keys of the first NESTED_TOP rows by
    c_customer_id (customers whose 2000 returns at a store exceed 1.2x
    that store's average customer total, at stores in TN)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng([seed, 77])
    n = SR_ROWS
    date = rng.integers(SALES_SK[0], SALES_SK[1] + 1, n)
    cust = rng.integers(1, CUSTOMERS + 1, n)
    store = rng.integers(1, STORES + 1, n)
    amt = np.round(rng.random(n) * 300, 2)
    ok = rng.random(n) >= 0.04
    pq.write_table(pa.table({
        "sr_returned_date_sk": pa.array(date),
        "sr_customer_sk": pa.array(cust), "sr_store_sk": pa.array(store),
        "sr_return_amt": pa.array(amt, mask=~ok)}), path,
        row_group_size=n, compression="snappy")
    m = dd["d_year"][date - DATE_SK0] == 2000
    key = cust[m] * (STORES + 1) + store[m]
    keys, inv = np.unique(key, return_inverse=True)
    tot = np.bincount(inv, weights=np.where(ok[m], amt[m], 0.0))
    has = np.bincount(inv, weights=ok[m]) > 0   # sum is null otherwise
    kst = keys % (STORES + 1)
    avg = (np.bincount(kst[has], weights=tot[has], minlength=STORES + 1)
           / np.maximum(np.bincount(kst[has], minlength=STORES + 1), 1))
    hit = has & (tot > avg[kst] * 1.2) & ((kst - 1) % 4 == Q01_STATE_TN)
    q01 = np.sort(keys[hit] // (STORES + 1))[:NESTED_TOP]
    return {"q05_returns": np.bincount(store[ok], weights=amt[ok],
                                       minlength=STORES + 1),
            "q01": q01}


def _nested_oracles(parts: dict) -> dict:
    """The nested queries' answers from the files' partials. q51: each
    (item, day) group's sales sum in cents (null where every price is),
    the running sum per item by day, the top NESTED_TOP rows by (running
    sum desc nulls last, item, day) as (item, date key, cents), and the
    window's row count and sums of row_number and dense_rank over every
    row (the keys are unique, so rank = dense_rank = row_number)."""
    keys = np.concatenate([k for k, _, _ in parts["q51"]])
    cents = np.concatenate([c for _, c, _ in parts["q51"]])
    ok = np.concatenate([v for _, _, v in parts["q51"]])
    groups, inv = np.unique(keys, return_inverse=True)
    gsum = np.bincount(inv, weights=np.where(ok, cents, 0)).astype(np.int64)
    gok = np.bincount(inv, weights=ok) > 0
    item = groups // 366
    start = np.r_[True, item[1:] != item[:-1]]
    seg = np.cumsum(start) - 1
    first = np.nonzero(start)[0]
    run = np.cumsum(np.where(gok, gsum, 0))
    base = np.r_[0, run][first]
    cume = run - base[seg]
    nvalid = np.cumsum(gok)
    cume_ok = (nvalid - np.r_[0, nvalid][first][seg]) > 0
    rn = np.arange(len(groups)) - first[seg] + 1
    order = np.lexsort((groups % 366, item, -cume, ~cume_ok))[:NESTED_TOP]
    dd0 = DATE_SK0 + np.searchsorted(_date_dim()["d_year"], Q51_YEAR)
    return {
        "q51": {"item": item[order], "date": groups[order] % 366 + dd0,
                "cents": cume[order], "rows": len(groups),
                "sum_rn": int(rn.sum()), "sum_dr": int(rn.sum())},
        "basket_items": parts["items"],
        "basket_stores": np.bincount(
            _distinct(np.concatenate(parts["pairs"])) % (STORES + 1),
            minlength=STORES + 1),
    }


def write_tpcds(work_dir, seed=TPCDS_SEED):
    """date_dim, the dimension tables of the string queries and the fact
    files under work_dir (threads write the fact files in parallel);
    returns (paths, oracle inputs)."""
    import concurrent.futures as cf

    import pyarrow as pa
    import pyarrow.parquet as pq

    dd = _date_dim()
    os.makedirs(work_dir, exist_ok=True)
    paths = {"date_dim": os.path.join(work_dir, "date_dim.parquet")}
    pq.write_table(pa.table(dd), paths["date_dim"], compression="snappy")
    tables, dims = _dim_tables(seed)
    _write_dims(tables, work_dir, paths)
    del tables
    paths["store_returns"] = os.path.join(work_dir, "store_returns.parquet")
    t0 = time.perf_counter()
    nested = _store_returns(seed, paths["store_returns"], dd)
    nested["store_returns_s"] = time.perf_counter() - t0
    nested["nested_partials_s"] = 0.0
    parts = {"q51": [], "pairs": [],
             "items": [np.zeros(CUSTOMERS + 1, np.int64),
                       np.zeros(CUSTOMERS + 1)]}
    q05_sales = np.zeros(STORES + 1)
    jobs = []
    for table, nfiles in TPCDS_FILES.items():
        for t in (table, DEC_TABLES[table]):
            paths[t] = [os.path.join(work_dir, f"{t}_{i:03d}.parquet")
                        for i in range(nfiles)]
        jobs += [(table, i, p, paths[DEC_TABLES[table]][i])
                 for i, p in enumerate(paths[table])]
    q02 = [np.zeros(2101 * 4), np.zeros(2101 * 4, np.int64),
           np.zeros(2101 * 4)]
    # q02 over the first file of each fact table (runner_resilience's
    # speculation case)
    q02_first = [np.zeros(2101 * 4), np.zeros(2101 * 4, np.int64)]
    q04 = {(t, y): [np.zeros(CUSTOMERS + 1),
                    np.zeros(CUSTOMERS + 1, np.int64),
                    np.zeros(CUSTOMERS + 1)]
           for t in ("store_sales", "web_sales") for y in (1999, 2000)}
    q03_rev = [np.zeros(202, np.int64), np.zeros(202, np.int64),
               np.zeros(202), np.zeros(202, np.int64)]
    q09 = np.zeros((len(Q09_BUCKETS), 3))
    strings = {}
    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        for (table, i, _, _), part in zip(jobs, ex.map(
                lambda j: _fact_file(seed, j[0], j[1], j[2], dd, dims, j[3]),
                jobs)):
            q09 += part.get("q09", 0)
            for acc, add in zip(q03_rev, part.get("q03_rev", ())):
                acc += add
            if "q51" in part:
                nested["nested_partials_s"] += part["nested_s"]
                q05_sales += part["q05_sales"]
                parts["q51"].append(part["q51"])
                parts["pairs"].append(part["pairs"])
                parts["items"][0] += part["items"][0]
                parts["items"][1] += part["items"][1]
            for q in ("q03", "q06", "q07", "q08"):
                if q in part:
                    acc = strings.get(q)
                    strings[q] = part[q] if acc is None else (
                        [a + b for a, b in zip(acc, part[q])]
                        if isinstance(acc, (list, tuple)) else acc + part[q])
            if "q02" in part:
                q02[0] += part["q02"][0]
                q02[1] += part["q02"][1]
                q02[2] += part["q02_cents"]
                if i == 0:
                    q02_first[0] += part["q02"][0]
                    q02_first[1] += part["q02"][1]
            for y, (c, p, pc) in part.get("q04", {}).items():
                acc = q04[(table, y)]
                acc[0] += np.bincount(c, weights=p, minlength=CUSTOMERS + 1)
                acc[1] += np.bincount(c, minlength=CUSTOMERS + 1)
                acc[2] += np.bincount(c, weights=pc, minlength=CUSTOMERS + 1)
    t0 = time.perf_counter()
    nested.update(_nested_oracles(parts), q05_sales=q05_sales,
                  nested_oracle_s=time.perf_counter() - t0)
    return paths, dict(strings, q02=q02, q02_first=q02_first, q04=q04,
                       q09=q09, q03_rev=q03_rev, **nested)


def _q02_oracle(orc):
    """(d_year, d_qoy, total, n) of every quarter with sales, ordered."""
    sums, cnts = orc["q02"][:2]
    slots = np.nonzero(cnts)[0]
    return slots // 4, slots % 4 + 1, sums[slots], cnts[slots]


def _q04_oracle(orc):
    """The first Q04_TOP customers whose web growth beats their store
    growth, from the four year totals."""
    tot = {name: orc["q04"][(table, year)]
           for name, table, year, _, _ in Q04_ARMS}
    both = np.ones(CUSTOMERS + 1, bool)
    both[0] = False
    for _, cnt, _ in tot.values():
        both &= cnt > 0
    s1, s2, w1, w2 = (tot[a][0] for a in ("s1", "s2", "w1", "w2"))
    keep = both & (s1 > 0) & (w1 > 0) & (w2 * s1 > s2 * w1)
    return np.nonzero(keep)[0][:Q04_TOP]


def _fields_into(schema, fields):
    for name, kind in fields:
        f = schema.fields.add()
        f.name = name
        f.dtype.kind = kind
        f.nullable = True


def _scan_node(paths, fields, projection):
    n = pb.PlanNode()
    for p in paths:
        n.parquet_scan.file_group.files.add().path = p
    _fields_into(n.parquet_scan.file_schema, fields)
    n.parquet_scan.projection.extend(projection)
    return n


def _project_node(inp, pairs):
    """Project (input column, output name) pairs."""
    n = pb.PlanNode()
    n.projection.input.CopyFrom(inp)
    for col, name in pairs:
        n.projection.exprs.add().CopyFrom(_col(col))
        n.projection.names.append(name)
    return n


def _binary(op, left, right):
    e = pb.ExprNode()
    e.binary.op = op
    e.binary.left.CopyFrom(left)
    e.binary.right.CopyFrom(right)
    return e


def _filter_node(inp, pred):
    n = pb.PlanNode()
    n.filter.input.CopyFrom(inp)
    n.filter.predicates.add().CopyFrom(pred)
    return n


def _join_node(kind, left, right, lkey, rkey):
    """An inner join on lkey = rkey: `broadcast_join` (build on the right)
    or `sort_merge_join`."""
    n = pb.PlanNode()
    j = getattr(n, kind)
    j.left.CopyFrom(left)
    j.right.CopyFrom(right)
    on = j.on.add()
    on.left.CopyFrom(_col(lkey))
    on.right.CopyFrom(_col(rkey))
    j.join_type = pb.JOIN_INNER
    return n


def _reader_node(fields, resource_id, partitions=1, kind="ipc_reader"):
    """An ipc_reader (or, kind="ffi_reader", an ffi_reader) of `fields`:
    (name, pb kind) pairs, or a decoded Schema."""
    n = pb.PlanNode()
    node = getattr(n, kind)
    if isinstance(fields, T.Schema):
        fields = [(f.name, _PB_KIND[f.dtype.kind]) for f in fields]
    _fields_into(node.schema, fields)
    if kind == "ipc_reader":
        node.provider_resource_id = resource_id
        node.num_partitions = partitions
    else:
        node.export_iter_resource_id = resource_id
    return n


def _sort_node(inp, names, fetch=0):
    n = pb.PlanNode()
    n.sort.input.CopyFrom(inp)
    for name in names:
        t = n.sort.terms.add()
        t.expr.CopyFrom(_col(name))
        t.ascending = True
        t.nulls_first = True
    n.sort.fetch_limit = fetch
    return n


def _writer_node(inp, keys, partitions, data_file, index_file):
    n = pb.PlanNode()
    w = n.shuffle_writer
    w.input.CopyFrom(inp)
    w.partitioning.kind = pb.HashRepartition.HASH
    w.partitioning.num_partitions = partitions
    for k in keys:
        w.partitioning.keys.add().CopyFrom(_col(k))
    w.data_file = data_file
    w.index_file = index_file
    return n


def _task_bytes(plan, stage, partition):
    td = pb.TaskDefinition()
    td.stage_id = stage
    td.partition_id = partition
    td.plan.CopyFrom(plan)
    return td.SerializeToString()


def _broadcast(date_dim, projection, year=None):
    """A broadcast stage of date_dim (filtered to `year` if given): (task
    bytes, the id its ipc_writer sends frames to, the id the joins'
    ipc_reader reads them from, the build side's fields)."""
    sink, build = resources.register(None), resources.register(None)
    node = _scan_node([date_dim], DD_PB, projection)
    if year is not None:
        node = _filter_node(node, _binary(
            pb.OP_EQ, _col("d_year"), _lit(pb.TK_INT32, "int_value", year)))
    w = pb.PlanNode()
    w.ipc_writer.input.CopyFrom(node)
    w.ipc_writer.consumer_resource_id = sink
    return (_task_bytes(w, 0, 0), sink, build,
            [DD_PB[i] for i in projection])


def _shuffle_reader(outputs, state_schema):
    """The provider of a reduce task's ipc_reader: partition p of every
    map output."""
    def provide(partition):
        for d, i in outputs:
            yield from read_shuffle_partition_host(d, i, partition,
                                                   state_schema)

    return provide


def tpcds_q02(paths, work_dir, partitions=None):
    """The task bytes of q02 (tpcds.py:367, BHJ mode) over the files in
    `paths`: one broadcast task of date_dim, one map task per web_sales
    file (with its share of the catalog_sales files) running
    Union(ws, cs) -> BroadcastJoin(date_dim) -> Agg PARTIAL(d_year, d_qoy)
    -> ShuffleWriter(hash(d_year, d_qoy)), `partitions` reduce tasks of
    Agg FINAL, and a final Sort(d_year, d_qoy) over their outputs.
    Returns the tasks of each stage by name, with the resource ids they
    name: "bcasts" (task, frame sink, build-side source), "shuffles"
    (reduce-side source, the map outputs it reads, a map task whose
    output schema they hold) and "final_src"."""
    partitions = partitions or SHUFFLE_PARTITIONS
    bcast = _broadcast(paths["date_dim"], [0, 1, 3])
    ws, cs = paths["web_sales"], paths["catalog_sales"]
    per = len(cs) // len(ws)
    keys = [("d_year", "d_year"), ("d_qoy", "d_qoy")]
    maps, outputs = [], []
    for t, wpath in enumerate(ws):
        arms = []
        for table, files in (("web_sales", [wpath]),
                             ("catalog_sales", cs[t * per:(t + 1) * per])):
            dcol, ccol, pcol = FACT_COLS[table]
            fields = [(c, pb.TK_INT64) for c in (dcol, ccol)] + \
                [(pcol, pb.TK_FLOAT64)]
            arms.append(_project_node(_scan_node(files, fields, [0, 2]),
                                      [(dcol, "sold_date_sk"),
                                       (pcol, "price")]))
        union = pb.PlanNode()
        for a in arms:
            union.union.inputs.add().CopyFrom(a)
        join = _join_node("broadcast_join", union,
                          _reader_node(bcast[3], bcast[2]),
                          "sold_date_sk", "d_date_sk")
        out = (os.path.join(work_dir, f"q02_{t}.data"),
               os.path.join(work_dir, f"q02_{t}.index"))
        outputs.append(out)
        maps.append(_task_bytes(_writer_node(
            _agg_node(join, pb.AGG_PARTIAL, keys, Q02_AGGS),
            ["d_year", "d_qoy"], partitions, *out), 1, t))
    state = decode_task_definition(maps[0])[0].children[0].schema
    src = resources.register(_shuffle_reader(outputs, state))
    reduces = [_task_bytes(_agg_node(_reader_node(state, src, partitions),
                                     pb.AGG_FINAL, keys, Q02_AGGS), 2, p)
               for p in range(partitions)]
    final_src = resources.register(None)
    out_schema = decode_task_definition(reduces[0])[0].schema
    final = _task_bytes(_sort_node(_reader_node(
        out_schema, final_src, kind="ffi_reader"), ["d_year", "d_qoy"]),
        3, 0)
    return {"bcasts": [bcast[:3]], "maps": maps, "outputs": outputs,
            "reduces": reduces, "shuffles": [(src, outputs, 0)],
            "final": final, "final_src": final_src}


def tpcds_q04(paths, work_dir, partitions=None):
    """The task bytes of q04 (tpcds.py:466) as Spark runs it at SF100: per
    year_total arm a broadcast task of date_dim filtered to its year and
    one map task per fact file, scan -> BroadcastJoin -> Agg PARTIAL(
    customer; sum(price)) -> ShuffleWriter(hash(customer)); then
    `partitions` reduce tasks that join partition p of the four arms with
    three sort-merge joins, filter on the growth condition, project the
    customer and keep the first Q04_TOP; and a final task over theirs."""
    partitions = partitions or SHUFFLE_PARTITIONS
    bcasts, maps, outputs, finals, shuffles = [], [], [], [], []
    for name, table, year, cname, tname in Q04_ARMS:
        bcast = _broadcast(paths["date_dim"], [0, 1], year)
        bcasts.append(bcast[:3])
        dcol, ccol, pcol = FACT_COLS[table]
        fields = [(c, pb.TK_INT64) for c in (dcol, ccol)] + \
            [(pcol, pb.TK_FLOAT64)]
        aggs = [("sum", pcol, "f64", tname)]
        arm_out = []
        for i, path in enumerate(paths[table]):
            join = _join_node("broadcast_join",
                              _scan_node([path], fields, [0, 1, 2]),
                              _reader_node(bcast[3], bcast[2]),
                              dcol, "d_date_sk")
            out = (os.path.join(work_dir, f"q04_{name}_{i}.data"),
                   os.path.join(work_dir, f"q04_{name}_{i}.index"))
            arm_out.append(out)
            maps.append(_task_bytes(_writer_node(
                _agg_node(join, pb.AGG_PARTIAL, [(ccol, cname)], aggs),
                [cname], partitions, *out), 1, len(maps)))
        state = decode_task_definition(maps[-1])[0].children[0].schema
        src = resources.register(_shuffle_reader(arm_out, state))
        shuffles.append((src, arm_out, len(maps) - 1))
        outputs += arm_out
        finals.append(_agg_node(_reader_node(state, src, partitions),
                                pb.AGG_FINAL, [(cname, cname)], aggs))
    join = finals[0]
    for arm, node in zip(Q04_ARMS[1:], finals[1:]):
        join = _join_node("sort_merge_join", join, node, "c1", arm[3])

    def gt(a, b):
        return _binary(pb.OP_GT, a, b)

    zero = _lit(pb.TK_FLOAT64, "float_value", 0.0)
    pred = _binary(pb.OP_AND,
                   _binary(pb.OP_AND, gt(_col("t_s1"), zero),
                           gt(_col("t_w1"), zero)),
                   gt(_binary(pb.OP_MUL, _col("t_w2"), _col("t_s1")),
                      _binary(pb.OP_MUL, _col("t_s2"), _col("t_w1"))))
    top = _sort_node(_project_node(_filter_node(join, pred),
                                   [("c1", "customer_sk")]),
                     ["customer_sk"], Q04_TOP)
    reduces = [_task_bytes(top, 2, p) for p in range(partitions)]
    final_src = resources.register(None)
    final = _task_bytes(_sort_node(_reader_node(
        [("customer_sk", pb.TK_INT64)], final_src, kind="ffi_reader"),
        ["customer_sk"], Q04_TOP), 3, 0)
    return {"bcasts": bcasts, "maps": maps, "outputs": outputs,
            "reduces": reduces, "shuffles": shuffles, "final": final,
            "final_src": final_src}


def _sync(device):
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _replay(items):
    """A provider of no arguments that yields `items` each call."""
    return lambda: iter(items)


def run_tpcds(q, device=None) -> dict:
    """One run of a TPC-DS query's stages, in order, on `device` (None:
    the card): the broadcast tasks (their frames become the build sides'
    providers), the map tasks, the reduce tasks, then the final task over
    the reduce outputs. Returns the final batch, each stage's wall time
    and the decoded plans."""
    t0 = time.perf_counter()
    bplans = []
    for task, sink, build in q["bcasts"]:
        frames = []
        resources.put(sink, frames.append)
        plan, _ = decode_task_definition(task)
        list(execute_plan(plan, ExecContext(device=device)))
        resources.put(build, _replay(frames))
        bplans.append(plan)
    t1 = time.perf_counter()
    mplans = []
    for task in q["maps"]:
        plan, td = decode_task_definition(task)
        list(execute_plan(plan, ExecContext(
            partition=td.partition_id, num_partitions=len(q["maps"]),
            device=device)))
        mplans.append(plan)
    t2 = time.perf_counter()
    rplans, outs = [], []
    for task in q["reduces"]:
        plan, td = decode_task_definition(task)
        outs.append(collect(plan, ExecContext(
            partition=td.partition_id, num_partitions=len(q["reduces"]),
            device=device)))
        rplans.append(plan)
    _sync(device)
    t3 = time.perf_counter()
    resources.put(q["final_src"], _replay(outs))
    plan, _ = decode_task_definition(q["final"])
    out = collect(plan, ExecContext(device=device))
    n = int(metrics.to_host(out.num_rows))
    t4 = time.perf_counter()
    return {"out": out, "rows": n, "broadcast_s": t1 - t0,
            "map_s": t2 - t1, "reduce_s": t3 - t2, "final_s": t4 - t3,
            "bcast_plans": bplans, "map_plans": mplans,
            "reduce_plans": rplans, "final_plan": plan}


def _walk(op, cls):
    """Every operator of type cls in the tree below op, top down."""
    if isinstance(op, cls):
        yield op
    for c in op.children:
        yield from _walk(c, cls)


def _metric(plans, cls, name):
    return sum(op.metrics[name] for p in plans for op in _walk(p, cls))


def _tpcds_rep(q, check) -> dict:
    """One rep with its counts reset before it; `check` holds its output."""
    from blaze_tpu_torch.ops.join import HashJoinLikeExec
    from blaze_tpu_torch.ops.parquet import ParquetScanExec

    _reset_counts()
    r = run_tpcds(q)
    check(r["out"])
    mp = r["map_plans"]
    partial = [p.children[0] for p in mp]
    return dict(
        broadcast_s=r["broadcast_s"], map_s=r["map_s"],
        reduce_s=r["reduce_s"], final_s=r["final_s"],
        host_pulls=metrics.HOST_PULLS,
        serde_encode_s=metrics.SERDE_NS["encode"] / 1e9,
        serde_decode_s=metrics.SERDE_NS["decode"] / 1e9,
        launches=mxu_agg.KERNEL_LAUNCHES,
        stage_compiled=[op.metrics["stage_compiled"] for op in partial],
        stage_fallbacks=[op.metrics["stage_fallbacks"] for op in partial],
        scan_bytes=_metric(mp, ParquetScanExec, "bytes_scanned"),
        # io_time_ns: Arrow to device, host conversion plus copies
        scan_to_device_s=_metric(mp, ParquetScanExec, "io_time_ns") / 1e9,
        row_groups_pruned=_metric(mp, ParquetScanExec, "row_groups_pruned"),
        bhj_rows_out=_metric(mp, HashJoinLikeExec, "output_rows"),
        bhj_join_s=_metric(mp, HashJoinLikeExec, "join_time_ns") / 1e9,
        state_rows=sum(op.metrics["output_rows"] for op in partial),
        shuffle_bytes=sum(p.metrics["shuffle_bytes_written"] for p in mp),
        plans=r)


def _tpcds_summary(name, first, reps) -> dict:
    def med(k):
        return float(np.median([r[k] for r in reps]))

    keys = ("broadcast_s", "map_s", "reduce_s", "final_s")
    res = {"phase": name, "first_run": {k: first[k] for k in keys}}
    for k in keys:
        res[k] = [r[k] for r in reps]
        res["median_" + k] = med(k)
    for k in ("host_pulls", "serde_encode_s", "serde_decode_s", "launches",
              "scan_bytes", "scan_to_device_s", "row_groups_pruned",
              "bhj_rows_out", "bhj_join_s", "state_rows", "shuffle_bytes"):
        res[k + "_per_rep"] = med(k)
    res.update(stage_compiled=first["stage_compiled"],
               stage_fallbacks=first["stage_fallbacks"],
               map_tasks=len(first["plans"]["map_plans"]),
               reduce_tasks=len(first["plans"]["reduce_plans"]))
    return res


def check_q02(out, orc):
    """q02's rows against the oracle: keys and counts exact, sums rtol
    1e-9, in (d_year, d_qoy) order."""
    years, qoys, sums, cnts = _q02_oracle(orc)
    d = out.to_numpy()
    _require(len(d["d_year"]) == len(years),
             f"q02 gave {len(d['d_year'])} rows, the oracle {len(years)}")
    np.testing.assert_array_equal(d["d_year"], years)
    np.testing.assert_array_equal(d["d_qoy"], qoys)
    np.testing.assert_array_equal(d["n"], cnts)
    np.testing.assert_allclose(d["total"].astype(np.float64), sums,
                               rtol=1e-9)


def check_q04(out, orc):
    """q04's customers against the oracle, exact and in order."""
    np.testing.assert_array_equal(out.to_numpy()["customer_sk"],
                                  _q04_oracle(orc))


def phase_tpcds_q02(paths, orc, work_dir) -> dict:
    """TPC-DS q02 from Parquet files: the date_dim broadcast, 16 map tasks
    (48 probe batches of 2^21 rows through the broadcast hash join into
    the dense partial aggregate), 200 reduce tasks and the final sort;
    checked against numpy, then timed reps and one map task profiled."""
    os.makedirs(os.path.join(work_dir, "q02"), exist_ok=True)
    q = tpcds_q02(paths, os.path.join(work_dir, "q02"))
    first = _tpcds_rep(q, lambda out: check_q02(out, orc))
    _require(first["stage_compiled"] == [1] * len(q["maps"]),
             f"a q02 map task left the dense path: {first['stage_compiled']}")
    _require(first["launches"] > 0, "q02 launched no accumulate kernel")
    reps = [_tpcds_rep(q, lambda out: check_q02(out, orc))
            for _ in range(TPCDS_REPS)]

    def one_map_task():
        plan, td = decode_task_definition(q["maps"][0])
        list(execute_plan(plan, ExecContext(partition=td.partition_id,
                                            num_partitions=len(q["maps"]))))

    # the warm-up task hands its first join-output batch's accumulate
    # inputs to the check against the plain version, at q02's own key
    # range and planes
    captured, launch = [], mxu_agg.accumulate_into

    def capture(acc, keys, valid, words, recipe, rng):
        if not captured:
            captured.append((keys.clone(), valid.clone(),
                             [w.clone() for w in words], recipe, rng))
        launch(acc, keys, valid, words, recipe, rng)

    mxu_agg.accumulate_into = capture
    try:
        one_map_task()
    finally:
        mxu_agg.accumulate_into = launch
    _require(bool(captured), "a q02 map task launched no accumulate kernel")
    keys, valid, words, recipe, rng = captured[0]
    kernel_check = {"n": int(keys.shape[0]), "rows_ok": int(valid.sum()),
                    "planes": len(recipe), "words": len(words), "rng": rng,
                    "max_abs_err": _check_equal("q02", *captured[0])}
    t0 = time.perf_counter()
    one_map_task()
    task_s = time.perf_counter() - t0
    rows, busy_ms = _device_profile(one_map_task)
    res = _tpcds_summary("tpcds_q02", first, reps)
    res["kernel_check"] = kernel_check
    res.update(rows_out=first["plans"]["rows"],
               probe_rows=FACT_FILE_ROWS * (len(paths["web_sales"])
                                            + len(paths["catalog_sales"])),
               build_rows=DATE_DIM_ROWS,
               map_task_s=task_s, map_task_device_busy_ms=busy_ms,
               map_task_idle_share=1.0 - busy_ms / (task_s * 1e3),
               map_task_device_launches=sum(r[2] for r in rows),
               map_task_top=_top(rows, 8))
    _emit(res)
    res["rows"] = first["plans"]["out"].to_numpy()
    return res


def phase_tpcds_q04(paths, orc, work_dir) -> dict:
    """TPC-DS q04 from Parquet files: four broadcast stages, 48 map tasks
    (broadcast hash join into the streaming partial aggregate by
    customer), 200 reduce tasks joining the four arms' partition with
    three sort-merge joins, and the final top 100; checked against numpy,
    then timed reps and one reduce task profiled on the host."""
    from blaze_tpu_torch.ops.join import SortMergeJoinExec

    os.makedirs(os.path.join(work_dir, "q04"), exist_ok=True)
    q = tpcds_q04(paths, os.path.join(work_dir, "q04"))
    first = _tpcds_rep(q, lambda out: check_q04(out, orc))
    _require(first["launches"] == 0, "q04 launched an accumulate kernel")
    reps = [_tpcds_rep(q, lambda out: check_q04(out, orc))
            for _ in range(TPCDS_REPS)]
    res = _tpcds_summary("tpcds_q04", first, reps)
    mp = first["plans"]["map_plans"]
    arm_rows, start = {}, 0
    for name, table, _, _, _ in Q04_ARMS:
        n = len(paths[table])
        arm_rows[name] = sum(p.children[0].metrics["output_rows"]
                             for p in mp[start:start + n])
        start += n
    levels = []
    for p in first["plans"]["reduce_plans"]:
        for lvl, j in enumerate(_walk(p, SortMergeJoinExec)):
            if len(levels) <= lvl:
                levels.append({"rows_in": 0, "rows_out": 0})
            levels[lvl]["rows_in"] += sum(c.metrics["output_rows"]
                                          for c in j.children)
            levels[lvl]["rows_out"] += j.metrics["output_rows"]

    def one_reduce_task():
        plan, td = decode_task_definition(q["reduces"][0])
        collect(plan, ExecContext(partition=td.partition_id,
                                  num_partitions=len(q["reduces"])))
        torch.cuda.synchronize()

    res.update(rows_out=first["plans"]["rows"], arm_state_rows=arm_rows,
               smj_levels_top_down=levels,
               reduce_task_host_top=_host_profile(one_reduce_task))
    _emit(res)
    res["rows"] = first["plans"]["out"].to_numpy()
    return res


def _q09_oracle(orc):
    """q09's four bucket values: bucket i's average ss_ext_sales_price
    where bucket i holds rows, else bucket i+1's."""
    cnt, psum, pcnt = orc["q09"].T
    avg = psum / np.maximum(pcnt, 1)
    return np.array([avg[i] if cnt[i] > 0 else avg[i + 1]
                     for i in range(len(Q09_BUCKETS) - 1)])


def check_q09(out, orc):
    """q09's one row against the oracle, rtol 1e-9."""
    d = out.to_numpy()
    want = _q09_oracle(orc)
    got = [d[f"bucket{i + 1}"] for i in range(len(want))]
    _require(all(len(g) == 1 for g in got), f"q09 gave {len(got[0])} rows")
    np.testing.assert_allclose([float(g[0]) for g in got], want, rtol=1e-9)


RUNNER_INFO = ("file_stages", "broadcast_stages", "map_tasks_run",
               "stage_compiled", "stage_fallbacks", "stage_s",
               "bytes_scanned", "fallback_exports", "bridge_rows")
# the ladder's run_info counters that a run with no fault armed leaves at
# 0 (or unset): any other value means a task left its route (retried,
# degraded, moved to the row interpreter, rerouted by the breaker or
# killed as hung)
ROUTE_KEPT = ("retries", "degradations", "task_fallbacks",
              "breaker_reroutes", "hangs_detected")


def _runner_plan(q, paths, mode="bhj", tpcds=None):
    """spark/tpcds.py's own plan of q (or this script's NESTED_QUERIES or
    DECIMAL_QUERIES plan) over the Parquet files. Its query function
    names one file a table; each scan then lists every file of its table,
    as Spark's scan does. Operators and expressions stay the query
    function's. `tpcds` is the spark/tpcds.py module that builds the
    plan (the port's unless given: a test passes the JAX package's)."""
    if tpcds is None:
        from blaze_tpu_torch.spark import tpcds

    files = {t: v if isinstance(v, list) else [v] for t, v in paths.items()}
    first = {t: v[0] for t, v in files.items()}
    owner = {v: t for t, v in first.items()}
    if q in NESTED_QUERIES:
        plan = NESTED_QUERIES[q](tpcds, first, mode)
    elif q in DECIMAL_QUERIES:
        plan = DECIMAL_QUERIES[q](tpcds, first, mode)
    else:
        plan, _ = tpcds.QUERIES[q](first, None, mode)

    def widen(p):
        if p.kind == "FileSourceScanExec":
            table = owner[p.attrs["files"][0][0]]
            p.attrs["files"] = [(f, []) for f in files[table]]
        for c in p.children:
            widen(c)

    widen(plan)
    return plan


def _runner_stages(q, paths):
    """(kind, partitions) of each stage plan_stages makes of q."""
    from blaze_tpu_torch.spark.convert_strategy import apply_strategy
    from blaze_tpu_torch.spark.stages import plan_stages

    plan = _runner_plan(q, paths)
    apply_strategy(plan)
    return [(st.kind, st.num_partitions)
            for st in plan_stages(plan, default_partitions=4)]


def _runner_run(q, paths, work_dir, check, plan=None, info_keys=RUNNER_INFO,
                exports=False, mesh="off", query_id=None) -> dict:
    """One run of q through run_plan on the card, with the counts reset
    before it, timed to its rows on the host; `check` holds the result.
    `plan` is _runner_plan's unless given (plans are single-use). Unless
    `exports` is set, q must run wholly native: no subtree of it may run
    on the host row interpreter and come back through the FFI bridge.
    `mesh` is run_plan's mesh_exchange: "off" (the file route of phases
    15-20's numbers) unless runner_mesh asks for its default, "auto".
    `query_id` names the run (run_plan makes one up otherwise)."""
    from blaze_tpu_torch.spark.local_runner import run_plan

    plan = _runner_plan(q, paths) if plan is None else plan
    info = {} if query_id is None else {"query_id": query_id}
    _reset_counts()
    spills = memory.get_manager().spill_count
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_plan(plan, work_dir=os.path.join(work_dir, "runner", q),
                   mesh_exchange=mesh, run_info=info)
    rows = out.to_numpy()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _require(exports or info["fallback_exports"] == 0,
             f"{q}: {info['fallback_exports']} subtrees ran on the host row "
             f"interpreter")
    ladder = dict({k: info.get(k, 0) for k in ROUTE_KEPT}, **{
        k: v for k, v in info.items()
        if k.startswith(("errors.", "degraded."))})
    _require(not any(ladder.values()),
             f"{q}: a task left its route with no fault armed: {ladder}")
    check(out)
    return dict({k: info[k] for k in info_keys}, wall_s=wall, rows=rows,
                ladder=ladder,
                spills=memory.get_manager().spill_count - spills,
                peak_device_bytes=peak,
                launches=mxu_agg.KERNEL_LAUNCHES,
                host_pulls=metrics.HOST_PULLS,
                # io_time_ns: Arrow to device, host conversion plus copies
                scan_to_device_s=info["io_time_ns"] / 1e9,
                serde_encode_s=metrics.SERDE_NS["encode"] / 1e9,
                serde_decode_s=metrics.SERDE_NS["decode"] / 1e9,
                serde_raw_bytes=metrics.SERDE_BYTES["raw"],
                serde_frame_bytes=metrics.SERDE_BYTES["frames"])


def _same_rows(got, want, what):
    """Rows in order: keys and counts exact, floats rtol 1e-9 (the two
    runs add partial sums in different task splits)."""
    _require(list(got) == list(want), f"{what}: columns differ")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        _require(len(g) == len(w), f"{what}: {len(g)} rows != {len(w)}")
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


def phase_runner_tpcds(paths, orc, work_dir, hand_q02, hand_q04) -> dict:
    """spark/tpcds.py's own q02, q04 and q09 (BHJ mode) through the
    port's driver path, run_plan: tagging, conversion, stage splitting,
    AQE and the stages in order, each scan stage one task over all of its
    table's files. Each query once, checked against numpy and timed (its
    checked_s); q02 and q04 must also equal the hand-built phases'
    rows."""
    checks = {"q02": lambda out: check_q02(out, orc),
              "q04": lambda out: check_q04(out, orc),
              "q09": lambda out: check_q09(out, orc)}
    res = {"phase": "runner_tpcds", "mode": "bhj"}
    rows = {}
    for q in ("q02", "q04", "q09"):
        first = _runner_run(q, paths, work_dir, checks[q])
        rows[q] = first.pop("rows")
        first["checked_s"] = first.pop("wall_s")
        res[q] = dict(first, stages=_runner_stages(q, paths))
    _same_rows(rows["q02"], hand_q02["rows"], "q02 against tpcds_q02")
    _same_rows(rows["q04"], hand_q04["rows"], "q04 against tpcds_q04")
    q02 = res["q02"]
    _require(q02["launches"] > 0 and q02["stage_fallbacks"] == 0,
             f"q02's map stage left the dense path: {q02}")
    q02["hand_built_map_plus_reduce_s"] = (hand_q02["median_map_s"]
                                           + hand_q02["median_reduce_s"])
    _emit(res)
    # for runner_spark_json and runner_resilience; not printed
    res["q02_rows"], res["q04_rows"] = rows["q02"], rows["q04"]
    return res


def _check_rows(d, want, what, float_cols=()):
    """Columns in order: strings, keys and counts exact, `float_cols`
    rtol 1e-9 with nulls in the same rows."""
    _require(list(d) == list(want), f"{what}: columns {list(d)}")
    for k, w in want.items():
        g = list(d[k])
        _require(len(g) == len(w), f"{what}: {len(g)} rows != {len(w)}")
        _require([x is None for x in g] == [x is None for x in w],
                 f"{what}: nulls of {k} differ")
        gv = [x for x in g if x is not None]
        wv = [x for x in w if x is not None]
        if k in float_cols:
            np.testing.assert_allclose(np.array(gv, np.float64),
                                       np.array(wv, np.float64), rtol=1e-9,
                                       err_msg=f"{what}: {k}")
        else:
            _require([x.item() if hasattr(x, "item") else x for x in gv]
                     == [x.item() if hasattr(x, "item") else x for x in wv],
                     f"{what}: {k} differs")


def check_q03(out, orc):
    """q03: one brand a year (i_manufact_id 28 is brand 28), by year."""
    sums, cnts = orc["q03"]
    years = np.nonzero(cnts)[0]
    _check_rows(out.to_numpy(), {
        "d_year": list(years + 1900), "brand_id": [28] * len(years),
        "brand": [b"Brand#28"] * len(years), "sum_agg": list(sums[years])},
        "q03", ("sum_agg",))


def check_q06(out, orc):
    """q06: states with at least 10 rows, by (cnt, state)."""
    from blaze_tpu_torch.spark.tpcds import _STATES

    rows = sorted((int(c), _STATES[i].encode())
                  for i, c in enumerate(orc["q06"]) if c >= 10)
    _check_rows(out.to_numpy(), {"state": [s for _, s in rows],
                                 "cnt": [c for c, _ in rows]}, "q06")


def check_q07(out, orc):
    """q07: the first 100 items by i_item_id, each measure's average over
    its non-null rows (null where there are none)."""
    rows, *measures = orc["q07"]
    items = np.nonzero(rows)[0][:100]
    want = {"i_item_id": [f"ITEM{i:08d}".encode() for i in items]}
    for k, (sums, cnts) in enumerate(zip(measures[0::2], measures[1::2])):
        want[f"agg{k + 1}"] = [sums[i] / cnts[i] if cnts[i] else None
                               for i in items]
    _check_rows(out.to_numpy(), want, "q07",
                ("agg1", "agg2", "agg3", "agg4"))


def check_q08(out, orc):
    """q08: the first 100 store names in byte order, each store's net
    profit (null where every value is null)."""
    rows, sums, cnts = orc["q08"]
    stores = sorted((f"Store#{i}".encode(), i) for i in np.nonzero(rows)[0])
    stores = stores[:100]
    _check_rows(out.to_numpy(), {
        "s_store_name": [name for name, _ in stores],
        "net_profit": [sums[i] if cnts[i] else None for _, i in stores]},
        "q08", ("net_profit",))


STRING_QUERIES = {"q03": check_q03, "q06": check_q06, "q07": check_q07,
                  "q08": check_q08}


def _profiled_map_stage(q, paths, work_dir) -> dict:
    """One more run of q with its map stage (one task over all store_sales
    files) under torch.profiler: the task's wall time, device busy time,
    idle share and top device operations."""
    from blaze_tpu_torch.spark import local_runner
    from blaze_tpu_torch.spark.local_runner import run_plan

    real = local_runner._run_shuffle_stage
    prof = {}

    def profiled(stage, *args, **kwargs):
        if prof:  # only the first map stage
            return real(stage, *args, **kwargs)
        t0 = time.perf_counter()
        rows, busy_ms = _device_profile(lambda: prof.setdefault(
            "ret", real(stage, *args, **kwargs)))
        wall = time.perf_counter() - t0
        prof.update(task_wall_s=wall, device_busy_ms=busy_ms,
                    idle_share=1.0 - busy_ms / (wall * 1e3),
                    device_ops=sum(r[2] for r in rows), top=_top(rows, 15))
        return prof["ret"]

    local_runner._run_shuffle_stage = profiled
    try:
        run_plan(_runner_plan(q, paths), mesh_exchange="off",
                 work_dir=os.path.join(work_dir, "runner", q + "_prof"))
    finally:
        local_runner._run_shuffle_stage = real
    prof.pop("ret", None)
    return prof


def phase_runner_strings(paths, orc, work_dir) -> dict:
    """spark/tpcds.py's q03, q06, q07 and q08 (BHJ mode) through run_plan
    over the dimension tables at SF100's row counts and all 8 store_sales
    files: string literals and equality (q07), string group and sort keys
    (q03's brand, q06's state, q07's item id, q08's store name), string
    join keys (q06's category), substring and a string semi-join key
    (q08), string columns through the broadcasts' serde (customer's 2 M
    ids in q06, customer_address's 1 M zips in q08). Each query once
    checked against numpy and timed; one q07 map task profiled.

    q10 (its BHJ plan broadcasts whole web_sales and catalog_sales
    relations through zlib) is left to tests/test_torch_runner.py on the
    CPU; q01 runs in runner_nested."""
    res = {"phase": "runner_strings", "mode": "bhj"}
    for q, check in STRING_QUERIES.items():
        first = _runner_run(q, paths, work_dir, lambda out: check(out, orc))
        first["result_rows"] = len(next(iter(first.pop("rows").values())))
        first["checked_s"] = first.pop("wall_s")
        res[q] = dict(first, stages=_runner_stages(q, paths))
    res["q07_map_task_profile"] = _profiled_map_stage("q07", paths,
                                                      work_dir)
    _emit(res)
    return res


def q51_store_plan(tp, paths, mode="bhj"):
    """TPC-DS q51's store arm (TPC-DS v2 specification, query 51): the
    daily store sales of each item in 2000 and their running total.
    store_sales joins date_dim (d_year = 2000, broadcast in BHJ mode); a
    partial aggregate of sum(ss_sales_price) by (ss_item_sk,
    ss_sold_date_sk); an exchange on ss_item_sk (4 partitions) and the
    final aggregate; a WindowExec partitioned by ss_item_sk and ordered by
    ss_sold_date_sk with sum(sales) as cume_sales, row_number, rank and
    dense_rank; a top NESTED_TOP by (cume_sales DESC, item, date). q51's
    frame is ROWS UNBOUNDED PRECEDING and the port has the RANGE frame to
    the current peer group: they agree here, because (item, date) is
    unique after the aggregate. The window sorts its own input, so the
    plan carries no SortExec below it. `tp` is a spark/tpcds.py module
    (either package's), whose helpers and schemas build the plan."""
    P, T, ir, col = tp.P, tp.T, tp.ir, tp.col
    ss = P.scan(tp.SS, [(paths["store_sales"], [])])
    dd = P.filter_(P.scan(tp.DD, [(paths["date_dim"], [])]),
                   ir.Binary(ir.BinOp.EQ, col("d_year"),
                             tp.lit(Q51_YEAR)))
    j = tp._join(ss, dd, [col("ss_sold_date_sk")], [col("d_date_sk")],
                 "inner", T.Schema(tp._fields(tp.SS, tp.DD)), mode)
    names = ["ss_item_sk", "ss_sold_date_sk"]
    keys = [T.Field(n, T.INT64) for n in names]
    aggs = [tp._sum("ss_sales_price", "sales")]
    partial = P.hash_agg(j, "partial", [col(n) for n in names], names,
                         aggs, T.Schema(keys))
    x = P.shuffle_exchange(partial, [col("ss_item_sk")], 4)
    final = P.hash_agg(x, "final", [col(n) for n in names], names, aggs,
                       T.Schema(keys + [T.Field("sales", T.FLOAT64)]))
    calls = [tp._sum("sales", "cume_sales")] + [
        {"fn": fn, "args": [], "dtype": T.INT32, "name": fn}
        for fn in ("row_number", "rank", "dense_rank")]
    win = P.window(final, calls, [col("ss_item_sk")],
                   [(col("ss_sold_date_sk"), True, True)],
                   T.Schema(list(final.schema.fields) + [
                       T.Field("cume_sales", T.FLOAT64)] + [
                       T.Field(c["name"], T.INT32, False)
                       for c in calls[1:]]))
    srt = P.sort(win, [(col("cume_sales"), False, False),
                       (col("ss_item_sk"), True, True),
                       (col("ss_sold_date_sk"), True, True)])
    return P.limit(srt, NESTED_TOP, True)


def basket_plan(tp, paths, mode="bhj", kind="items"):
    """A customer-basket query (the market-basket and sessionization
    pattern of Spark SQL): store_sales grouped by ss_customer_sk into a
    list of its items (`kind` "items": collect_list(ss_item_sk), partial
    -> exchange on the customer (4) -> final, so the list state crosses
    the serde), exploded with its positions (posexplode, the customer
    kept) and counted back per customer: count(pos), sum(item), max(pos).
    `kind` "stores": the set of each customer's stores
    (collect_set(ss_store_sk)), exploded, and count(1) per store through
    a second exchange. The null customer is a group of its own."""
    P, T, ir, col = tp.P, tp.T, tp.ir, tp.col
    ss = P.scan(tp.SS, [(paths["store_sales"], [])])
    items = kind == "items"
    lst = T.list_of(T.INT64)
    cust = [T.Field("ss_customer_sk", T.INT64)]
    agg = [{"fn": "collect_list" if items else "collect_set",
            "args": [col("ss_item_sk" if items else "ss_store_sk")],
            "dtype": lst, "name": "basket"}]
    partial = P.hash_agg(ss, "partial", [col("ss_customer_sk")],
                         ["ss_customer_sk"], agg, T.Schema(cust))
    x = P.shuffle_exchange(partial, [col("ss_customer_sk")], 4)
    baskets = P.hash_agg(x, "final", [col("ss_customer_sk")],
                         ["ss_customer_sk"], agg,
                         T.Schema(cust + [T.Field("basket", lst)]))
    if not items:
        gen = P.generate(baskets, col("basket"), [], ["store"], False,
                         False, T.Schema([T.Field("store", T.INT64)]))
        one = [{"fn": "count", "args": [ir.Literal(T.INT32, 1)],
                "dtype": T.INT64, "name": "customers"}]
        out = tp._two_phase_agg(gen, [col("store")], ["store"], one,
                                [T.Field("store", T.INT64)])
        return P.sort(out, [(col("store"), True, True)])
    gen = P.generate(baskets, col("basket"), [0], ["pos", "item"], True,
                     False, T.Schema(cust + [T.Field("pos", T.INT32, False),
                                             T.Field("item", T.INT64)]))
    counts = [{"fn": "count", "args": [col("pos")], "dtype": T.INT64,
               "name": "n"},
              {"fn": "sum", "args": [col("item")], "dtype": T.INT64,
               "name": "item_sum"},
              {"fn": "max", "args": [col("pos")], "dtype": T.INT32,
               "name": "max_pos"}]
    # the explode keeps the customer partitioning: no second exchange
    p2 = P.hash_agg(gen, "partial", [col("ss_customer_sk")],
                    ["ss_customer_sk"], counts, T.Schema(cust))
    return P.hash_agg(p2, "final", [col("ss_customer_sk")],
                      ["ss_customer_sk"], counts, T.Schema(cust + [
                          T.Field("n", T.INT64), T.Field("item_sum", T.INT64),
                          T.Field("max_pos", T.INT32)]))


NESTED_QUERIES = {
    "q51_store": q51_store_plan,
    "basket_items": basket_plan,
    "basket_stores": lambda tp, paths, mode="bhj": basket_plan(
        tp, paths, mode, "stores"),
}


def _dec_schema(tp, schema):
    """A spark/tpcds.py fact schema as the decimal copies type it: every
    price or amount column decimal(7,2)."""
    T = tp.T
    money = {"ws_ext_sales_price", "cs_ext_sales_price",
             "ss_ext_sales_price"} | set(DEC_COLS)
    return T.Schema([T.Field(f.name, T.decimal(*DEC_PRICE), f.nullable)
                     if f.name in money else f for f in schema.fields])


def q02_dec_plan(tp, paths, mode="bhj"):
    """tpcds.py's q02 over web_sales_dec and catalog_sales_dec, typed as
    Spark 3.3 plans it (DecimalAggregates): the partial aggregate by
    (d_year, d_qoy) of sum(UnscaledValue(price)) and count(price), the
    final aggregate, MakeDecimal(total, 17, 2) (the final aggregate's
    result expression, a ProjectExec here), then the sort. The sum is an int64, so the
    map stage keeps the dense path."""
    P, T, ir, col = tp.P, tp.T, tp.ir, tp.col
    dec = T.decimal(*DEC_PRICE)
    u_schema = T.Schema([T.Field("sold_date_sk", T.INT64),
                         T.Field("price", dec)])
    arms = []
    for table, schema in (("web_sales", tp.WS), ("catalog_sales", tp.CS)):
        date, _, price = FACT_COLS[table]
        scan = P.scan(_dec_schema(tp, schema),
                      [(paths[DEC_TABLES[table]], [])])
        arms.append(P.project(scan, [col(date), col(price)],
                              ["sold_date_sk", "price"], u_schema))
    dd = P.scan(tp.DD, [(paths["date_dim"], [])])
    j = tp._join(P.union(arms), dd, [col("sold_date_sk")],
                 [col("d_date_sk")], "inner",
                 T.Schema(tp._fields(u_schema, tp.DD)), mode)
    keys = [T.Field("d_year", T.INT32), T.Field("d_qoy", T.INT32)]
    aggs = [{"fn": "sum", "args": [ir.UnscaledValue(col("price"))],
             "dtype": T.INT64, "name": "total_u"},
            {"fn": "count", "args": [col("price")], "dtype": T.INT64,
             "name": "n"}]
    agg = tp._two_phase_agg(j, [col("d_year"), col("d_qoy")],
                            ["d_year", "d_qoy"], aggs, keys)
    out = P.project(agg, [col("d_year"), col("d_qoy"),
                          ir.MakeDecimal(col("total_u"), 17, 2), col("n")],
                    ["d_year", "d_qoy", "total", "n"],
                    T.Schema(keys + [T.Field("total", T.decimal(17, 2)),
                                     T.Field("n", T.INT64)]))
    return P.sort(out, [(col("d_year"), True, True),
                        (col("d_qoy"), True, True)])


def _dec_year_total(tp, paths, mode, table, year, cname, tname,
                    positive=False):
    """One q04 arm: the year's sum per customer as decimal(17,2)
    (MakeDecimal over sum(UnscaledValue(price))); `positive` keeps the
    filter `total > 0` that Spark pushes below the joins onto the
    first-year arms."""
    P, T, ir, col = tp.P, tp.T, tp.ir, tp.col
    date, cust, price = FACT_COLS[table]
    schema = _dec_schema(tp, tp.SS if table == "store_sales" else tp.WS)
    s = P.scan(schema, [(paths[DEC_TABLES[table]], [])])
    dd = P.filter_(P.scan(tp.DD, [(paths["date_dim"], [])]),
                   ir.Binary(ir.BinOp.EQ, col("d_year"), tp.lit(year)))
    j = tp._join(s, dd, [col(date)], [col("d_date_sk")], "inner",
                 T.Schema(tp._fields(schema, tp.DD)), mode)
    tu = tname + "_u"
    agg = tp._two_phase_agg(j, [col(cust)], [cname], [
        {"fn": "sum", "args": [ir.UnscaledValue(col(price))],
         "dtype": T.INT64, "name": tu}], [T.Field(cname, T.INT64)])
    dt = T.decimal(17, 2)
    out = P.project(agg, [col(cname), ir.MakeDecimal(col(tu), 17, 2)],
                    [cname, tname], T.Schema([T.Field(cname, T.INT64),
                                              T.Field(tname, dt)]))
    if positive:
        out = P.filter_(out, ir.Binary(ir.BinOp.GT, col(tname),
                                       ir.Literal(dt, 0)))
    return out


def q04_dec_plan(tp, paths, mode="bhj"):
    """tpcds.py's q04 over store_sales_dec and web_sales_dec in TPC-DS
    q04's ratio form as Spark types it: year totals are decimal(17,2),
    `t_s1 > 0` and `t_w1 > 0` (the literal a decimal(17,2)) are pushed
    onto their arms, and the growth test over the joined totals is
    t_w2 / t_w1 > t_s2 / t_s1, each quotient a decimal(37,20): a wide
    division with HALF_UP (int128.divmod_full). The JAX package's
    wide-decimal walk takes it (delta 20, 17 + 20 <= 38)."""
    P, T, ir, col = tp.P, tp.T, tp.ir, tp.col
    arms = [_dec_year_total(tp, paths, mode, table, year, cname, tname,
                            positive=year == 1999)
            for _, table, year, cname, tname in Q04_ARMS]

    def joined(a, b):
        return T.Schema(list(a.schema.fields) + list(b.schema.fields))

    j = arms[0]
    for arm, (_, _, _, cname, _) in zip(arms[1:], Q04_ARMS[1:]):
        j = tp._join(j, arm, [col("c1")], [col(cname)], "inner",
                     joined(j, arm), mode)
    q = T.decimal(37, 20)

    def ratio(a, b):
        return ir.Binary(ir.BinOp.DIV, col(a), col(b), result_type=q)

    f = P.filter_(j, ir.Binary(ir.BinOp.GT, ratio("t_w2", "t_w1"),
                               ratio("t_s2", "t_s1")))
    proj = P.project(f, [col("c1")], ["customer_sk"],
                     T.Schema([T.Field("customer_sk", T.INT64)]))
    return P.limit(P.sort(proj, [(col("customer_sk"), True, True)]),
                   Q04_TOP, True)


def q03_rev_plan(tp, paths, mode="bhj"):
    """A revenue report on tpcds.py's q03 (store_sales_dec joined to
    date_dim (d_moy = 11) and item (i_manufact_id = 28), by (d_year,
    i_brand_id, i_brand)) when no extended price is stored: the line
    revenue sum(CheckOverflow(CAST(ss_quantity AS decimal(10,0)) *
    ss_sales_price, 18, 2)), which Spark types decimal(28,2) so that its
    state is wide (limb planes through the partial and final aggregates
    and the shuffle's serde), count(ss_sales_price), and
    avg(ss_sales_price) as Spark 3.3 plans it, CAST(avg(UnscaledValue(
    ss_sales_price)) / 100.0 AS decimal(11,6)); ordered by (d_year,
    revenue DESC, brand_id), a wide sort key, and cut to a top 100."""
    P, T, ir, col = tp.P, tp.T, tp.ir, tp.col
    ss_schema = _dec_schema(tp, tp.SS)
    ss = P.scan(ss_schema, [(paths["store_sales_dec"], [])])
    dd = P.filter_(P.scan(tp.DD, [(paths["date_dim"], [])]),
                   ir.Binary(ir.BinOp.EQ, col("d_moy"), tp.lit(11)))
    it = P.filter_(P.scan(tp.ITEM, [(paths["item"], [])]),
                   ir.Binary(ir.BinOp.EQ, col("i_manufact_id"), tp.lit(28)))
    j1 = tp._join(ss, dd, [col("ss_sold_date_sk")], [col("d_date_sk")],
                  "inner", T.Schema(tp._fields(ss_schema, tp.DD)), mode)
    j2 = tp._join(j1, it, [col("ss_item_sk")], [col("i_item_sk")], "inner",
                  T.Schema(tp._fields(ss_schema, tp.DD, tp.ITEM)), mode)
    line = ir.CheckOverflow(ir.Binary(
        ir.BinOp.MUL, ir.Cast(col("ss_quantity"), T.decimal(10, 0)),
        col("ss_sales_price"), result_type=T.decimal(18, 2)), 18, 2)
    rev = T.decimal(28, 2)
    aggs = [{"fn": "sum", "args": [line], "dtype": rev, "name": "revenue"},
            {"fn": "count", "args": [col("ss_sales_price")],
             "dtype": T.INT64, "name": "n"},
            {"fn": "avg", "args": [ir.UnscaledValue(col("ss_sales_price"))],
             "dtype": T.FLOAT64, "name": "avg_u"}]
    keys = [T.Field("d_year", T.INT32), T.Field("brand_id", T.INT32),
            T.Field("brand", T.STRING)]
    agg = tp._two_phase_agg(j2, [col("d_year"), col("i_brand_id"),
                                 col("i_brand")],
                            ["d_year", "brand_id", "brand"], aggs, keys)
    avg = ir.Cast(ir.Binary(ir.BinOp.DIV, col("avg_u"),
                            ir.Literal(T.FLOAT64, 100.0),
                            result_type=T.FLOAT64), T.decimal(11, 6))
    out = P.project(agg, [col("d_year"), col("brand_id"), col("brand"),
                          col("revenue"), col("n"), avg],
                    ["d_year", "brand_id", "brand", "revenue", "n",
                     "avg_price"],
                    T.Schema(keys + [T.Field("revenue", rev),
                                     T.Field("n", T.INT64),
                                     T.Field("avg_price", T.decimal(11, 6))]))
    srt = P.sort(out, [(col("d_year"), True, True),
                       (col("revenue"), False, True),
                       (col("brand_id"), True, True)])
    return P.limit(srt, 100, True)


DECIMAL_QUERIES = {"q02_dec": q02_dec_plan, "q04_dec": q04_dec_plan,
                   "q03_rev": q03_rev_plan}


def check_q02_dec(out, orc):
    """q02_dec: every (year, quarter) with sales, in order; totals exact
    in cents, counts exact."""
    cnts, cents = orc["q02"][1], orc["q02"][2]
    slots = np.nonzero(cnts)[0]
    _check_rows(out.to_numpy(), {
        "d_year": list(slots // 4), "d_qoy": list(slots % 4 + 1),
        "total": [int(c) for c in cents[slots]],
        "n": list(cnts[slots])}, "q02_dec")


def _half_up_ratio(a: int, b: int, scale: int = 20) -> int:
    """a / b at `scale` places, HALF_UP on the magnitude (a, b > 0)."""
    q, r = divmod(a * 10 ** scale, b)
    return q + (2 * r >= b)


def _q04_dec_oracle(orc):
    """The first Q04_TOP customers, ascending, whose four year totals
    exist with t_s1 > 0 and t_w1 > 0, and whose rounded quotient t_w2 /
    t_w1 beats t_s2 / t_s1 (Python ints, HALF_UP at 20 places)."""
    tot = {name: orc["q04"][(table, year)]
           for name, table, year, _, _ in Q04_ARMS}
    both = np.ones(CUSTOMERS + 1, bool)
    both[0] = False
    for _, cnt, _ in tot.values():
        both &= cnt > 0
    s1, s2, w1, w2 = (tot[a][2].astype(np.int64)
                      for a in ("s1", "s2", "w1", "w2"))
    out = []
    for c in np.nonzero(both & (s1 > 0) & (w1 > 0))[0]:
        if _half_up_ratio(int(w2[c]), int(w1[c])) > _half_up_ratio(
                int(s2[c]), int(s1[c])):
            out.append(int(c))
            if len(out) == Q04_TOP:
                break
    return out


def check_q04_dec(out, orc):
    """q04_dec: the customer ids exact and in order."""
    _check_rows(out.to_numpy(), {"customer_sk": _q04_dec_oracle(orc)},
                "q04_dec")


def check_q03_rev(out, orc):
    """q03_rev: one brand a year, by year; revenue exact in cents and
    counts exact; the average within 1e-6 (one unit of its last place) of
    Spark's double steps: sum / count, / 100.0, then HALF_UP at 6
    places."""
    rev, _, sp_sum, sp_cnt = orc["q03_rev"]
    years = np.nonzero(sp_cnt)[0]
    d = out.to_numpy()
    _check_rows({k: d[k] for k in ("d_year", "brand_id", "brand", "revenue",
                                   "n")}, {
        "d_year": list(years + 1900), "brand_id": [28] * len(years),
        "brand": [b"Brand#28"] * len(years),
        "revenue": [int(r) for r in rev[years]],
        "n": list(sp_cnt[years])}, "q03_rev")
    avg = sp_sum[years] / sp_cnt[years] / 100.0
    want = np.floor(avg * 1e6 + 0.5)
    got = np.array([int(v) for v in d["avg_price"]], np.float64)
    _require(np.abs(got - want).max() <= 1,
             f"q03_rev: avg_price {got} against {want}")


def check_q05(out, orc):
    """q05: every store's sales and returns, then the ROLLUP's grand
    total (a null name, grouping id 1): names and ids exact, sums rtol
    1e-9."""
    names = sorted(f"Store#{i}".encode() for i in range(1, STORES + 1))
    idx = [int(n[6:]) for n in names]
    sales, rets = orc["q05_sales"], orc["q05_returns"]
    _check_rows(out.to_numpy(), {
        "s_store_name": names + [None],
        "spark_grouping_id": [0] * STORES + [1],
        "total_sales": list(sales[idx]) + [sales.sum()],
        "total_returns": list(rets[idx]) + [rets.sum()]}, "q05",
        ("total_sales", "total_returns"))


def check_q01(out, orc):
    """q01: the first 100 customer ids, in order, exact."""
    _check_rows(out.to_numpy(), {"c_customer_id": [
        f"AAAA{int(c):012d}".encode() for c in orc["q01"]]}, "q01")


def check_q51(out, orc, window=None):
    """q51_store: the top rows' items, dates and ranks exact (the keys are
    unique, so rank and dense_rank are the row number), running sums rtol
    1e-9 against the exact sums in cents; with `window` (the window's own
    counts), its row count and sums of row_number and dense_rank exact."""
    w = orc["q51"]
    d = out.to_numpy()
    _require(len(d["ss_item_sk"]) == NESTED_TOP,
             f"q51_store: {len(d['ss_item_sk'])} rows")
    _require(list(d["ss_item_sk"]) == list(w["item"])
             and list(d["ss_sold_date_sk"]) == list(w["date"]),
             "q51_store: the top rows' keys differ")
    np.testing.assert_allclose(np.asarray(d["cume_sales"], np.float64),
                               w["cents"] / 100.0, rtol=1e-9,
                               err_msg="q51_store: cume_sales")
    _require(list(d["rank"]) == list(d["row_number"]) == list(
        d["dense_rank"]), "q51_store: ranks differ from row numbers")
    if window is not None:
        got = (window["rows"], window["sum_rn"], window["sum_dr"])
        _require(got == (w["rows"], w["sum_rn"], w["sum_dr"]),
                 f"q51_store: window counts {got}")


def check_basket_items(out, orc):
    """basket_items: per customer (the null customer too), count(pos) and
    sum(item) equal numpy's row count and item sum, and max(pos) is the
    count less one."""
    cnt, sums = orc["basket_items"]
    d = out.to_numpy()
    keys = np.array([0 if k is None else k for k in d["ss_customer_sk"]],
                    np.int64)
    want = np.nonzero(cnt)[0]
    order = np.argsort(keys)
    _require(np.array_equal(keys[order], want),
             f"basket_items: {len(keys)} customers, want {len(want)}")
    n = np.asarray(d["n"], np.int64)[order]
    _require(np.array_equal(n, cnt[want]), "basket_items: counts")
    _require(np.array_equal(np.asarray(d["item_sum"], np.int64)[order],
                            sums[want].astype(np.int64)),
             "basket_items: item sums")
    _require(np.array_equal(np.asarray(d["max_pos"], np.int64)[order],
                            n - 1), "basket_items: max(pos)")


def check_basket_stores(out, orc):
    """basket_stores: each store's distinct customers (the null customer
    one of them), exact, by store."""
    want = orc["basket_stores"]
    stores = np.nonzero(want)[0]
    _check_rows(out.to_numpy(), {"store": list(stores),
                                 "customers": list(want[stores])},
                "basket_stores")


class _WindowCounts:
    """Around one run: every WindowExec's output rows and its sums of
    row_number and dense_rank (device sums, pulled once at the end), and
    the window operators' spill counts."""

    def __enter__(self):
        from blaze_tpu_torch.ops.window import WindowExec

        self.cls, self.real = WindowExec, WindowExec._compute
        self.ops, self.parts = set(), []
        real, ops, parts = self.real, self.ops, self.parts

        def compute(op, sb):
            out = real(op, sb)
            ops.add(op)
            live = out.row_mask()
            names = out.schema.names()
            parts.append(torch.stack([live.sum()] + [
                torch.where(live, out.columns[names.index(c)].data, 0).sum()
                .to(torch.int64) for c in ("row_number", "dense_rank")]))
            return out

        WindowExec._compute = compute
        return self

    def __exit__(self, *exc):
        self.cls._compute = self.real

    def result(self) -> dict:
        tot = (torch.stack(self.parts).sum(0).cpu().tolist()
               if self.parts else [0, 0, 0])
        return {"rows": tot[0], "sum_rn": tot[1], "sum_dr": tot[2],
                "spill_count": sum(op.metrics["spill_count"]
                                   for op in self.ops)}


def _profiled_result_stage(q, paths, work_dir, cpu=True) -> dict:
    """One more run of q with its result stage (the one that runs the
    window) under torch.profiler: the stage's wall time, device busy time,
    idle share and top device operations."""
    from blaze_tpu_torch.spark import local_runner
    from blaze_tpu_torch.spark.local_runner import run_plan

    real = local_runner._run_result_stage
    prof = {}

    def profiled(*args):
        t0 = time.perf_counter()
        rows, busy_ms = _device_profile(lambda: prof.setdefault(
            "ret", real(*args)), cpu)
        wall = time.perf_counter() - t0
        prof.update(stage_wall_s=wall, device_busy_ms=busy_ms,
                    idle_share=1.0 - busy_ms / (wall * 1e3),
                    device_ops=sum(r[2] for r in rows), top=_top(rows, 15))
        return prof["ret"]

    local_runner._run_result_stage = profiled
    try:
        run_plan(_runner_plan(q, paths), mesh_exchange="off",
                 work_dir=os.path.join(work_dir, "runner", q + "_prof"))
    finally:
        local_runner._run_result_stage = real
    prof.pop("ret", None)
    return prof


class _Out:
    """A result already on the host, as `check_*` reads it."""

    def __init__(self, rows: dict) -> None:
        self._rows = rows

    def to_numpy(self) -> dict:
        return self._rows


NESTED_CHECKS = {"q05": check_q05, "q01": check_q01,
                 "q51_store": check_q51, "basket_items": check_basket_items,
                 "basket_stores": check_basket_stores}


def phase_runner_nested(paths, orc, work_dir) -> dict:
    """The slice of nested columns and the last three plan nodes, through
    run_plan in BHJ mode as runner_tpcds runs its queries: tpcds.py's q05
    (its ROLLUP is an ExpandExec over store_sales and store_returns joined
    to store) and q01 (store_returns, the per-store average self-join, the
    customer join and a top 100), then this script's q51_store (a
    WindowExec over 3.1 M daily item totals), basket_items (collect_list,
    posexplode) and basket_stores (collect_set, explode). Each once
    checked against numpy (q51_store's window also by its own row count
    and rank sums) and timed; the result stage of q51_store, which runs
    the window, profiled."""
    res = {"phase": "runner_nested", "mode": "bhj"}
    for q, check in NESTED_CHECKS.items():
        counts = _WindowCounts()
        with counts:
            first = _runner_run(q, paths, work_dir,
                                lambda out: check(out, orc))
        if q == "q51_store":
            first["window"] = counts.result()
            check_q51(_Out(first["rows"]), orc, first["window"])
        first["result_rows"] = len(next(iter(first.pop("rows").values())))
        first["checked_s"] = first.pop("wall_s")
        res[q] = dict(first, stages=_runner_stages(q, paths))
    res["q51_store"]["window_stage_profile"] = _profiled_result_stage(
        "q51_store", paths, work_dir)
    _emit(res)
    return res


DECIMAL_CHECKS = {"q02_dec": check_q02_dec, "q04_dec": check_q04_dec,
                  "q03_rev": check_q03_rev}


def _division_profile(paths, work_dir) -> dict:
    """q04_dec's result stage (the joins of the year totals and the growth
    filter's two decimal(37,20) divisions) under torch.profiler, device
    activity only, as `_profiled_result_stage` gives it (its wall time
    includes the profiler's), with the calls of the 128-step long
    division (int128.divmod_full) and their rows counted; then one
    division of 1024 rows alone under the profiler, whose device
    operations are the launches of every call."""
    from blaze_tpu_torch.columnar import int128 as i128

    real = i128.divmod_full
    seen = {"divisions": 0, "division_rows": 0}

    def counted(h, *args):
        seen["divisions"] += 1
        seen["division_rows"] += int(h.shape[0])
        return real(h, *args)

    i128.divmod_full = counted
    try:
        prof = _profiled_result_stage("q04_dec", paths, work_dir, cpu=False)
    finally:
        i128.divmod_full = real
    a = torch.arange(1, 1025, dtype=torch.int64, device="cuda")
    real(a, a * 7, a * 0, a)  # warm
    torch.cuda.synchronize()
    rows, busy_ms = _device_profile(lambda: real(a, a * 7, a * 0, a), False)
    per_call = sum(r[2] for r in rows)
    return dict(prof, **seen, launches_per_division=per_call,
                one_division_device_ms=busy_ms,
                division_launches=seen["divisions"] * per_call)


def phase_runner_decimal(paths, orc, work_dir, runner) -> dict:
    """The decimal slice, through run_plan in BHJ mode as runner_tpcds
    runs its queries, over the decimal copies of the fact tables
    (DECIMAL_QUERIES): q02_dec (sum(UnscaledValue(price)) on the dense
    path; its launches must equal runner_tpcds q02's), q04_dec (decimal
    year totals and the wide-division growth test) and q03_rev (a
    decimal(28,2) sum of quantity x price: wide agg state through the
    serde, and a wide sort key). Each once checked against numpy's exact
    integers and timed; q04_dec's result stage profiled with its
    divisions counted."""
    res = {"phase": "runner_decimal", "mode": "bhj"}
    for q, check in DECIMAL_CHECKS.items():
        first = _runner_run(q, paths, work_dir, lambda out: check(out, orc))
        first["result_rows"] = len(next(iter(first.pop("rows").values())))
        first["checked_s"] = first.pop("wall_s")
        res[q] = dict(first, stages=_runner_stages(q, paths))
    q02 = res["q02_dec"]
    _require(q02["stage_fallbacks"] == 0
             and q02["launches"] == runner["q02"]["launches"] > 0,
             f"q02_dec left the dense path: {q02}")
    res["q04_dec"]["result_stage_profile"] = _division_profile(paths,
                                                               work_dir)
    _emit(res)
    return res


# ---- runner_spark_json: Spark 3.3 executedPlan.toJSON() through run_plan --

_SQL = "org.apache.spark.sql"
_JVM_ID = "6b1c8a3e-2f4d-4e5a-9b7c-0d1e2f3a4b5c"
JSON_VERSION = "3.3.3"
JSON_PARTITIONS = 4     # spark.sql.shuffle.partitions of the captured plans


def _jx(cls, *children, **fields):
    """A Catalyst expression tree as TreeNode JSON embeds it: its pre-order
    node array. `cls` is relative to catalyst.expressions."""
    node = {"class": f"{_SQL}.catalyst.expressions.{cls}",
            "num-children": len(children), **fields}
    return [node] + [n for c in children for n in c]


def _jexpr_id(eid):
    return {"product-class": f"{_SQL}.catalyst.expressions.ExprId",
            "id": eid, "jvmId": _JVM_ID}


def _ja(name, dtype, eid, nullable=True):
    """AttributeReference `name#eid`."""
    return _jx("AttributeReference", name=name, dataType=dtype,
               nullable=nullable, metadata={}, exprId=_jexpr_id(eid),
               qualifier=[])


def _jl(value, dtype):
    return _jx("Literal", value=str(value), dataType=dtype)


def _jalias(child, name, eid, dtype=None):
    fields = {"name": name, "exprId": _jexpr_id(eid), "qualifier": []}
    if dtype is not None:
        fields["dataType"] = dtype
    return _jx("Alias", child, child=0, **fields)


def _jbin(cls, left, right, dtype=None):
    fields = {"left": 0, "right": 1}
    if dtype is not None:
        fields["dataType"] = dtype
    return _jx(cls, left, right, **fields)


def _jcast(child, dtype):
    return _jx("Cast", child, child=0, dataType=dtype, ansiEnabled=False,
               timeZoneId=["UTC"])


def _jagg(fn, arg, mode, rid, dtype):
    """AggregateExpression(fn(arg)) in `mode` ("Partial" or "Final")."""
    f = _jx(f"aggregate.{fn}", arg, child=0, dataType=dtype)
    return _jx("aggregate.AggregateExpression", f, aggregateFunction=0,
               mode=mode, isDistinct=False, resultId=_jexpr_id(rid))


def _jsort_order(child, ascending=True):
    return _jx("SortOrder", child, child=0,
               direction="Ascending" if ascending else "Descending",
               nullOrdering="NullsFirst" if ascending else "NullsLast",
               sameOrderExpressions=[])


def _jp(cls, *children, **fields):
    """A plan node and its subtrees (pre-order); `cls` relative to
    sql.execution."""
    node = {"class": f"{_SQL}.execution.{cls}",
            "num-children": len(children), **fields}
    if len(children) == 1:
        node["child"] = 0
    elif len(children) == 2:
        node.update(left=0, right=1)
    return [node] + [n for c in children for n in c]


def _jscan(files, attrs):
    """ColumnarToRow over a Parquet FileSourceScanExec of `files`, as a
    codegen stage's input."""
    scan = _jp("FileSourceScanExec", relation={
        "location": {"rootPaths": [f"file:{p}" for p in files]},
        "fileFormat": {"object": f"{_SQL}.execution.datasources.parquet."
                       "ParquetFileFormat"}},
        output=attrs, requiredSchema={"type": "struct", "fields": []},
        partitionFilters=[], dataFilters=[], disableBucketedScan=False)
    return _jp("InputAdapter", _jp("ColumnarToRowExec", scan))


def _jcodegen(stage_id, child):
    return _jp("WholeStageCodegenExec", child, codegenStageId=stage_id)


def _jshuffle(child, keys, stage_id, partitioning="HashPartitioning"):
    """The final plan's view of an exchange under AQE: a coalescing
    shuffle read of a materialized shuffle query stage."""
    part = _jx(f"plans.physical.{partitioning}", *keys,
               numPartitions=JSON_PARTITIONS,
               expressions=list(range(len(keys))))
    ex = _jp("exchange.ShuffleExchangeExec", child,
             outputPartitioning=part, shuffleOrigin={
                 "object": f"{_SQL}.execution.exchange.ENSURE_REQUIREMENTS$"})
    stage = _jp("adaptive.ShuffleQueryStageExec", ex, id=stage_id,
                _canonicalized=None)
    return _jp("InputAdapter", _jp("adaptive.AQEShuffleReadExec", stage,
                                   partitionSpecs=[]))


def _jbroadcast(child, stage_id):
    ex = _jp("exchange.BroadcastExchangeExec", child, mode={
        "product-class": f"{_SQL}.execution.joins.HashedRelationBroadcastMode"})
    return _jp("InputAdapter", _jp("adaptive.BroadcastQueryStageExec", ex,
                                   id=stage_id))


def _jbhj(left, right, lkeys, rkeys):
    return _jp("joins.BroadcastHashJoinExec", left, right, leftKeys=lkeys,
               rightKeys=rkeys, joinType="Inner",
               buildSide={"object": f"{_SQL}.catalyst.optimizer.BuildRight$"},
               condition=None, isNullAwareAntiJoin=False)


def _jhash_agg(child, keys, aggs):
    return _jp("aggregate.HashAggregateExec", child,
               requiredChildDistributionExpressions=None,
               groupingExpressions=keys, aggregateExpressions=aggs,
               aggregateAttributes=[], initialInputBufferOffset=0,
               resultExpressions=[])


def _jroot(child):
    """AQE's root: the final plan."""
    return json.dumps(_jp("adaptive.AdaptiveSparkPlanExec", child,
                          isFinalPlan=True, isSubquery=False))


# q02 (spark/tpcds.py:367): exprIds of the attributes the plan carries
_Q02 = {"ws_date": 1, "ws_price": 2, "cs_date": 3, "cs_price": 4,
        "d_date_sk": 5, "d_year": 6, "d_qoy": 7, "total": 20, "n": 21}


def json_q02(paths) -> str:
    """tpcds.py's q02 as Spark 3.3's final AQE plan gives it: the union of
    web and catalog sales (each scan pruned to its date and price
    columns), broadcast-joined with date_dim, aggregated by (d_year,
    d_qoy) in two phases across a hash exchange, and sorted."""
    e = _Q02

    def side(table, date, price, eid_d, eid_p):
        attrs = [_ja(date, "long", eid_d), _ja(price, "double", eid_p)]
        return _jcodegen(1, _jp("ProjectExec", _jscan(paths[table], attrs),
                                projectList=attrs))

    union = _jp("UnionExec",
                side("web_sales", "ws_sold_date_sk", "ws_ext_sales_price",
                     e["ws_date"], e["ws_price"]),
                side("catalog_sales", "cs_sold_date_sk",
                     "cs_ext_sales_price", e["cs_date"], e["cs_price"]))
    dd_attrs = [_ja("d_date_sk", "long", e["d_date_sk"]),
                _ja("d_year", "integer", e["d_year"]),
                _ja("d_qoy", "integer", e["d_qoy"])]
    dd = _jbroadcast(_jcodegen(2, _jp(
        "FilterExec", _jscan([paths["date_dim"]], dd_attrs),
        condition=_jx("IsNotNull", dd_attrs[0], child=0))), 0)
    keys = [_ja("d_year", "integer", e["d_year"]),
            _ja("d_qoy", "integer", e["d_qoy"])]
    price = _ja("ws_ext_sales_price", "double", e["ws_price"])
    join = _jbhj(_jp("InputAdapter", union), dd,
                 [_ja("ws_sold_date_sk", "long", e["ws_date"])],
                 [dd_attrs[0]])
    proj = _jp("ProjectExec", join, projectList=[price] + keys)

    def aggs(mode):
        return [_jagg("Sum", price, mode, e["total"], "double"),
                _jagg("Count", price, mode, e["n"], "long")]

    partial = _jcodegen(3, _jhash_agg(proj, keys, aggs("Partial")))
    final = _jhash_agg(_jshuffle(partial, keys, 1), keys, aggs("Final"))
    srt = _jp("SortExec", final, testSpillFrequency=0, **{"global": True},
              sortOrder=[_jsort_order(k) for k in keys])
    return _jroot(_jcodegen(4, srt))


# the brand-revenue report (TPC-DS q03/q42-shaped): exprIds
_REP = {"ss_date": 301, "ss_item": 302, "ss_list": 303, "ss_sales": 304,
        "amt": 305, "i_item_sk": 300, "i_brand": 350, "i_brand_id": 351,
        "i_item_id": 352, "brand_key": 310, "bucket": 311,
        "d_date_sk": 340, "yr": 320, "rev": 330, "cnt": 331}
REPORT_RATE = "1.07"    # the report's surcharge, as a SQL literal
REPORT_CRC_SKIP = 1     # items whose crc32(i_item_id) % 3 is this are left out


def json_report(paths, dayofweek=True) -> str:
    """A brand-revenue report as Spark SQL users write it when they format
    keys and money: store_sales ⋈ date_dim ⋈ item, November weekends only
    (by dayofweek of the date, or with `dayofweek` False by the same day
    computed from the key, (d_date_sk + 1) % 7 + 1, a plan the JAX
    package's decoder also takes),
    revenue = round(coalesce(ss_sales_price, ss_list_price, 0.0) * 1.07,
    2) a row, grouped by brand key upper(concat_ws('-', i_brand,
    lpad(CAST(i_brand_id AS STRING), 4, '0'))), the first hex digit of
    md5(i_item_id) and the year of date_add(DATE '1900-01-02', d_date_sk -
    2415022); items with crc32(i_item_id) % 3 = 1 and rows with
    (hash(ss_item_sk, ss_sold_date_sk) & 3) = 0 left out."""
    e = _REP
    s_date = _ja("ss_sold_date_sk", "long", e["ss_date"])
    s_item = _ja("ss_item_sk", "long", e["ss_item"])
    s_list = _ja("ss_list_price", "double", e["ss_list"])
    s_sales = _ja("ss_sales_price", "double", e["ss_sales"])
    keep = _jx("Not", _jbin("EqualTo", _jbin(
        "BitwiseAnd", _jx("Murmur3Hash", s_item, s_date, children=[0, 1],
                          seed=42), _jl(3, "integer")), _jl(0, "integer")),
        child=0)
    amt = _jalias(_jx("Round", _jbin("Multiply", _jx(
        "Coalesce", s_sales, s_list, _jl("0.0", "double"),
        children=[0, 1, 2]), _jl(REPORT_RATE, "double"), "double"),
        _jl(2, "integer"), child=0, scale=1), "amt", e["amt"], "double")
    facts = _jp("ProjectExec", _jp("FilterExec", _jscan(
        paths["store_sales"], [s_date, s_item, s_list, s_sales]),
        condition=keep), projectList=[s_date, s_item, amt])

    d_sk = _ja("d_date_sk", "long", e["d_date_sk"])
    day = _jx("DateAdd", _jl(-25566, "date"), _jcast(_jbin(
        "Subtract", d_sk, _jl(DATE_SK0, "long"), "long"), "integer"),
        startDate=0, days=1)
    if dayofweek:
        dow = _jx("DayOfWeek", day, child=0)
    else:
        dow = _jcast(_jbin("Add", _jbin("Remainder", _jbin(
            "Add", d_sk, _jl(1, "long"), "long"), _jl(7, "long"), "long"),
            _jl(1, "long"), "long"), "integer")
    weekend_nov = _jbin("And", _jbin("EqualTo", _jx("Month", day, child=0),
                                     _jl(11, "integer")),
                        _jx("In", dow, _jl(1, "integer"), _jl(7, "integer"),
                            value=0, list=[1, 2]))
    yr = _jalias(_jx("Year", day, child=0), "yr", e["yr"], "integer")
    dates = _jbroadcast(_jcodegen(2, _jp("ProjectExec", _jp(
        "FilterExec", _jscan([paths["date_dim"]], [d_sk]),
        condition=weekend_nov), projectList=[d_sk, yr])), 0)

    i_sk = _ja("i_item_sk", "long", e["i_item_sk"])
    i_brand = _ja("i_brand", "string", e["i_brand"])
    i_bid = _ja("i_brand_id", "integer", e["i_brand_id"])
    i_id = _ja("i_item_id", "string", e["i_item_id"])
    brand_key = _jalias(_jx("Upper", _jx(
        "ConcatWs", _jl("-", "string"), i_brand, _jx(
            "StringLPad", _jcast(i_bid, "string"), _jl(4, "integer"),
            _jl("0", "string"), str=0, len=1, pad=2),
        children=[0, 1, 2]), child=0), "brand_key", e["brand_key"],
        "string")
    bucket = _jalias(_jx("Substring", _jx("Md5", _jcast(i_id, "binary"),
                                          child=0),
                         _jl(1, "integer"), _jl(1, "integer"),
                         str=0, pos=1, len=2), "bucket", e["bucket"],
                     "string")
    crc_ok = _jx("Not", _jbin("EqualTo", _jbin("Remainder", _jx(
        "Crc32", _jcast(i_id, "binary"), child=0), _jl(3, "long"), "long"),
        _jl(REPORT_CRC_SKIP, "long")), child=0)
    items = _jbroadcast(_jcodegen(3, _jp("ProjectExec", _jp(
        "FilterExec", _jscan([paths["item"]], [i_sk, i_id, i_bid, i_brand]),
        condition=crc_ok), projectList=[i_sk, brand_key, bucket])), 1)

    a_amt = _ja("amt", "double", e["amt"])
    keys = [_ja("brand_key", "string", e["brand_key"]),
            _ja("bucket", "string", e["bucket"]),
            _ja("yr", "integer", e["yr"])]
    j1 = _jbhj(facts, dates, [s_date], [d_sk])
    j2 = _jbhj(j1, items, [s_item], [i_sk])
    proj = _jp("ProjectExec", j2, projectList=keys + [a_amt])

    def aggs(mode):
        return [_jagg("Sum", a_amt, mode, e["rev"], "double"),
                _jagg("Count", _jl(1, "integer"), mode, e["cnt"],
                      "long")]

    partial = _jcodegen(4, _jhash_agg(proj, keys, aggs("Partial")))
    final = _jhash_agg(_jshuffle(partial, keys, 2), keys, aggs("Final"))
    srt = _jp("SortExec", final, testSpillFrequency=0, **{"global": True},
              sortOrder=[_jsort_order(k) for k in keys])
    return _jroot(_jcodegen(5, srt))


# the UDF query: exprIds, and the registered UDFs' names
_UDF = {"i_item_sk": 400, "i_item_id": 401, "label": 410, "ss_item": 402,
        "ss_profit": 403, "band": 405, "band_sum": 430, "cnt": 431}
UDF_LABELS = 97          # item_label(i_item_id) = "L%02d" of the id % 97
UDF_BAND = 50.0          # profit_band(p) = floor(p / 50)


def _item_label(ids):
    """Hive UDF item_label(i_item_id): 'L%02d' of the id's number % 97."""
    return np.asarray([None if s is None else
                       f"L{int(s[4:]) % UDF_LABELS:02d}" for s in ids],
                      object)


def _profit_band(profits):
    """Scala UDF profit_band(ss_net_profit): floor(profit / 50), null for
    null."""
    band = np.floor(np.array(profits, np.float64) / UDF_BAND)  # None: NaN
    return np.where(np.isnan(band), None, band)


def _sort_key(labels):
    """Hive UDF sort_key(label): the label's digits reversed."""
    return np.asarray([None if s is None else s[::-1] for s in labels],
                      object)


def register_json_udfs() -> None:
    from blaze_tpu_torch.spark import hive_udf

    hive_udf.register_udf("item_label", _item_label, T.STRING)
    hive_udf.register_udf("profit_band", _profit_band, T.INT64)
    hive_udf.register_udf("sort_key", _sort_key, T.STRING)


def json_udf(paths) -> str:
    """Registered UDFs in a Spark plan: item_label, a HiveSimpleUDF that
    returns a string, labels the item rows (its Project runs on the row
    interpreter and enters the broadcast join through the FFI bridge);
    profit_band, a ScalaUDF returning a bigint, bands ss_net_profit (it
    stays native, crossing to the host once a batch); the labels' band
    sums and row counts are then ordered by sort_key(label), another
    string UDF, behind a range exchange, so the root sort runs on the row
    interpreter and its partitions merge on the driver."""
    e = _UDF
    i_sk = _ja("i_item_sk", "long", e["i_item_sk"])
    i_id = _ja("i_item_id", "string", e["i_item_id"])
    label = _jalias(_jx("hive.HiveSimpleUDF", i_id,
                        name="default.item_label", children=[0]),
                    "label", e["label"], "string")
    items = _jbroadcast(_jp("ProjectExec", _jscan([paths["item"]],
                                                  [i_sk, i_id]),
                            projectList=[i_sk, label]), 0)
    s_item = _ja("ss_item_sk", "long", e["ss_item"])
    s_profit = _ja("ss_net_profit", "double", e["ss_profit"])
    band = _jalias(_jx("ScalaUDF", s_profit, function=None,
                       dataType="long", children=[0],
                       udfName=["profit_band"], nullable=True),
                   "band", e["band"], "long")
    facts = _jp("ProjectExec", _jscan(paths["store_sales"],
                                      [s_item, s_profit]),
                projectList=[s_item, band])
    a_label = _ja("label", "string", e["label"])
    a_band = _ja("band", "long", e["band"])
    join = _jbhj(facts, items, [s_item], [i_sk])
    proj = _jp("ProjectExec", join, projectList=[a_label, a_band])

    def aggs(mode):
        return [_jagg("Sum", a_band, mode, e["band_sum"], "long"),
                _jagg("Count", _jl(1, "integer"), mode, e["cnt"],
                      "long")]

    partial = _jcodegen(1, _jhash_agg(proj, [a_label], aggs("Partial")))
    final = _jcodegen(2, _jhash_agg(_jshuffle(partial, [a_label], 1),
                                    [a_label], aggs("Final")))
    key = _jx("hive.HiveSimpleUDF", a_label, name="default.sort_key",
              children=[0])
    ranged = _jshuffle(final, [_jsort_order(key)], 2, "RangePartitioning")
    srt = _jp("SortExec", ranged, testSpillFrequency=0, **{"global": True},
              sortOrder=[_jsort_order(key)])
    return _jroot(srt)


def _read_columns(files, names):
    """{name: (values, valid)} of Parquet columns, read back on the host
    for the oracles."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(f, columns=list(names))
                          for f in files])
    out = {}
    for n in names:
        c = t.column(n)
        valid = ~np.asarray(c.is_null())
        out[n] = (np.asarray(c.fill_null(0 if pa.types.is_integer(c.type)
                                         else 0.0)
                             if not pa.types.is_string(c.type)
                             else c.to_pylist()), valid)
    return out


def _mm3_long(v: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Spark's Murmur3 hashLong over int64 arrays with per-row uint32
    seeds, in numpy (the oracle's own; Murmur3_x86_32.hashLong)."""
    m = np.uint64(0xFFFFFFFF)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & m

    def mix_k(k):
        k = (k * np.uint64(0xCC9E2D51)) & m
        return (rotl(k, 15) * np.uint64(0x1B873593)) & m

    def mix_h(h, k):
        h = rotl(h ^ k, 13)
        return (h * np.uint64(5) + np.uint64(0xE6546B64)) & m

    u = v.astype(np.int64).view(np.uint64)
    h = mix_h(seed.astype(np.uint64), mix_k(u & m))
    h = mix_h(h, mix_k(u >> np.uint64(32)))
    h ^= np.uint64(8)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & m
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & m
    return h ^ (h >> np.uint64(16))


def _half_up2(x: np.ndarray) -> np.ndarray:
    """round(x, 2) HALF_UP on doubles, in the port's float steps."""
    y = x * 100.0
    return np.where(y >= 0, np.floor(y + 0.5), np.ceil(y - 0.5)) / 100.0


def json_oracles(paths) -> dict:
    """numpy, hashlib and zlib answers of json_report and json_udf, from
    the Parquet files read back."""
    import hashlib
    import zlib

    items = _read_columns([paths["item"]], ("i_item_sk", "i_item_id",
                                            "i_brand_id", "i_brand"))
    sk = items["i_item_sk"][0]
    n_it = int(sk.max()) + 1
    ids = items["i_item_id"][0]
    key = np.empty(n_it, object)
    bucket = np.empty(n_it, object)
    ok = np.zeros(n_it, bool)
    for s, i, b, br in zip(sk, ids, items["i_brand_id"][0],
                           items["i_brand"][0]):
        raw = i.encode()
        ok[s] = zlib.crc32(raw) % 3 != REPORT_CRC_SKIP
        bucket[s] = hashlib.md5(raw).hexdigest()[:1].encode()
        key[s] = f"{br}-{str(int(b)).rjust(4, '0')[:4]}".upper().encode()
    ss = _read_columns(paths["store_sales"], (
        "ss_sold_date_sk", "ss_item_sk", "ss_list_price", "ss_sales_price",
        "ss_net_profit"))
    date, dvalid = ss["ss_sold_date_sk"]
    item = ss["ss_item_sk"][0]
    day = np.where(dvalid, date - DATE_SK0, 0)
    when = np.datetime64("1900-01-02") + day
    epoch = (when - np.datetime64("1970-01-01")).astype(np.int64)
    month = when.astype("datetime64[M]").astype(np.int64) % 12 + 1
    year = when.astype("datetime64[Y]").astype(np.int64) + 1970
    dow = (epoch + 4) % 7 + 1            # Spark: 1 = Sunday
    h = _mm3_long(date, _mm3_long(item, np.full(len(item), 42, np.uint64)))
    keep = (dvalid & (month == 11) & ((dow == 1) | (dow == 7))
            & ((h & np.uint64(3)) != 0) & ok[item])
    sp, spv = ss["ss_sales_price"]
    lp, lpv = ss["ss_list_price"]
    amt = _half_up2(np.where(spv, sp, np.where(lpv, lp, 0.0))
                    * float(REPORT_RATE))
    groups = {}
    for k, b, y, a in zip(key[item[keep]], bucket[item[keep]], year[keep],
                          amt[keep]):
        g = groups.setdefault((k, b, int(y)), [0.0, 0])
        g[0] += a
        g[1] += 1
    report = sorted(groups.items())
    npf, npv = ss["ss_net_profit"]
    label = item % UDF_LABELS
    band = np.floor(npf / UDF_BAND).astype(np.int64)
    # the band sums are far below 2^53, so the float sums are exact
    exact = np.rint(np.bincount(label[npv], weights=band[npv],
                                minlength=UDF_LABELS)).astype(np.int64)
    cnts = np.bincount(label, minlength=UDF_LABELS)
    labels = [f"L{i:02d}".encode() for i in range(UDF_LABELS)]
    order = sorted(range(UDF_LABELS), key=lambda i: labels[i][::-1])
    order = [i for i in order if cnts[i]]
    return {"report": report, "udf": [(labels[i], int(exact[i]),
                                       int(cnts[i])) for i in order],
            "udf_items": int(len(sk))}


def check_json_report(out, orc):
    """Keys and counts exact, revenue rtol 1e-9, in (brand_key, bucket,
    year) order."""
    d = out.to_numpy()
    e = _REP
    want = orc["report"]
    cols = [f"#{e[k]}" for k in ("brand_key", "bucket", "yr", "rev", "cnt")]
    _require(list(d) == cols, f"json_report columns {list(d)}")
    _require(len(d[cols[0]]) == len(want) > 0,
             f"json_report gave {len(d[cols[0]])} rows, the oracle "
             f"{len(want)}")
    _require(list(d[cols[0]]) == [k for (k, _, _), _ in want]
             and list(d[cols[1]]) == [b for (_, b, _), _ in want],
             "json_report: brand keys or buckets differ")
    np.testing.assert_array_equal(d[cols[2]], [y for (_, _, y), _ in want])
    np.testing.assert_array_equal(d[cols[4]], [c for _, (_, c) in want])
    np.testing.assert_allclose(np.asarray(d[cols[3]], np.float64),
                               [s for _, (s, _) in want], rtol=1e-9)


def check_json_udf(out, orc):
    """Labels, band sums and counts exact, in sort_key(label) order."""
    d = out.to_numpy()
    e = _UDF
    want = orc["udf"]
    cols = [f"#{e[k]}" for k in ("label", "band_sum", "cnt")]
    _require(list(d) == cols, f"json_udf columns {list(d)}")
    _require(list(d[cols[0]]) == [w[0] for w in want],
             "json_udf: labels or their order differ")
    np.testing.assert_array_equal(np.asarray(d[cols[1]], np.int64),
                                  [w[1] for w in want])
    np.testing.assert_array_equal(np.asarray(d[cols[2]], np.int64),
                                  [w[2] for w in want])


def check_json_q02(out, orc, runner_rows):
    """q02 by position (the JSON plan names columns by exprId): equal to
    runner_tpcds q02's rows and to numpy."""
    d = out.to_numpy()
    e = _Q02
    got = {k: d[f"#{e[k]}"] for k in ("d_year", "d_qoy", "total", "n")}
    years, qoys, sums, cnts = _q02_oracle(orc)
    np.testing.assert_array_equal(got["d_year"], years)
    np.testing.assert_array_equal(got["d_qoy"], qoys)
    np.testing.assert_array_equal(got["n"], cnts)
    np.testing.assert_allclose(got["total"].astype(np.float64), sums,
                               rtol=1e-9)
    _same_rows(got, runner_rows, "json_q02 against runner_tpcds q02")


JSON_QUERIES = {"json_q02": json_q02, "json_report": json_report,
                "json_udf": json_udf}
JSON_INFO = RUNNER_INFO + ("bridge_s", "bridge_batches", "bridge_card_batches",
                           "hostfn_crossings", "hostfn_s", "udf_crossings",
                           "udf_s")


def _json_plan(q, paths):
    from blaze_tpu_torch.spark.plan_json import decode_plan_json

    return decode_plan_json(JSON_QUERIES[q](paths), JSON_VERSION)


def _json_stages(q, paths):
    from blaze_tpu_torch.spark.convert_strategy import apply_strategy
    from blaze_tpu_torch.spark.stages import plan_stages

    plan = _json_plan(q, paths)
    apply_strategy(plan)
    return [(st.kind, st.num_partitions)
            for st in plan_stages(plan, default_partitions=4)]


def phase_runner_spark_json(paths, orc, work_dir, runner) -> dict:
    """Spark's entry: each plan is the TreeNode JSON that Spark 3.3's
    executedPlan.toJSON() gives (an AdaptiveSparkPlanExec root with
    isFinalPlan, codegen and columnar shells, #exprId attributes), decoded
    by spark/plan_json.decode_plan_json and run through run_plan on the
    card, BHJ as Spark plans these joins at SF100: json_q02 (tpcds.py's
    q02; its rows must equal runner_tpcds q02's and it must launch the
    accumulate kernel as often), json_report (a brand-revenue report over
    store_sales, item and date_dim with upper, concat_ws, lpad, coalesce,
    round, year, month, dayofweek, date_add and hash on the card and md5
    and crc32 on the host) and json_udf (registered UDFs: a string Hive
    UDF on the row interpreter through the FFI bridge, a numeric Scala UDF
    native with one host crossing a batch, a root sort on the row
    interpreter merged on the driver). Each once, checked against numpy
    (hashlib and zlib for the host functions) and timed."""
    register_json_udfs()
    t0 = time.perf_counter()
    jorc = json_oracles(paths)
    res = {"phase": "runner_spark_json", "mode": "bhj",
           "spark_version": JSON_VERSION,
           "oracle_s": time.perf_counter() - t0}
    checks = {"json_q02": lambda out: check_json_q02(
                  out, orc, runner["q02_rows"]),
              "json_report": lambda out: check_json_report(out, jorc),
              "json_udf": lambda out: check_json_udf(out, jorc)}
    for q, check in checks.items():
        kw = dict(info_keys=JSON_INFO, exports=q == "json_udf")
        first = _runner_run(q, paths, work_dir, check,
                            _json_plan(q, paths), **kw)
        first.pop("rows")
        first["checked_s"] = first.pop("wall_s")
        res[q] = dict(first, stages=_json_stages(q, paths))
    q02 = res["json_q02"]
    _require(q02["launches"] == runner["q02"]["launches"] > 0
             and q02["stage_fallbacks"] == 0,
             f"json_q02 left the dense path: {q02}")
    rep = res["json_report"]
    _require(rep["hostfn_crossings"] > 0,
             f"json_report: host functions did not cross natively: {rep}")
    udf = res["json_udf"]
    _require(udf["fallback_exports"] >= 1
             and udf["bridge_rows"] >= jorc["udf_items"]
             and udf["bridge_card_batches"] == udf["bridge_batches"] > 0
             and udf["udf_crossings"] > 0,
             f"json_udf: the bridge or the UDF crossing did not run on the "
             f"card: {udf}")
    _emit(res)
    return res


RESILIENCE_INFO = RUNNER_INFO + ("pipeline_streams",
                                  "pipeline_live_streams")
# the task runtime's knobs; runner_resilience sets each to its default in
# config.py's KNOBS
RUNTIME_KNOBS = ("enable_supervisor", "enable_pipeline",
                 "max_concurrent_tasks", "io_threads", "prefetch_batches",
                 "trace_enabled")
# the run_info counters of the ladder and the supervisor
LADDER_INFO = ("retries", "degradations", "ladder_rung", "task_fallbacks",
               "faults_injected", "stalls_injected", "hangs_detected",
               "breaker_trips", "breaker_reroutes", "speculations_launched",
               "speculations_won")


class _knobs:
    """conf knobs set for a block, restored after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: getattr(conf, k) for k in self.values}
        for k, v in self.values.items():
            setattr(conf, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(conf, k, v)
        return False


def _ladder_case(q, paths, work_dir, check, spec, mode="bhj", **knobs):
    """One run of q under the fault spec (and knobs), checked against
    numpy: (run_info's ladder counters, wall seconds)."""
    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.spark.local_runner import run_plan

    info = {}
    plan = _runner_plan(q, paths, mode)
    faults.install(spec)
    t0 = time.perf_counter()
    try:
        with _knobs(**knobs):
            out = run_plan(plan, work_dir=os.path.join(
                work_dir, "resilience", q), mesh_exchange="off",
                run_info=info)
    finally:
        faults.install(None)
    wall = time.perf_counter() - t0
    check(out)
    counts = {k: v for k, v in info.items()
              if k in LADDER_INFO or k.startswith(("errors.", "degraded."))}
    # every task the ladder moved to the row interpreter counts its export
    counts["fallback_exports"] = info["fallback_exports"]
    _require(counts["fallback_exports"] >= counts.get("task_fallbacks", 0),
             f"{q}: a fallback task went uncounted: {counts}")
    _require(info["pipeline_live_streams"] == 0,
             f"{q}: {info['pipeline_live_streams']} streams left open")
    return counts, wall


def _speculation_case(paths, orc, work_dir, seed) -> dict:
    """q02 in SMJ mode over the first file of each fact table, so that its
    join stage is a map stage of 4 tasks reading two shuffles. The first
    task to reach its second join batch stalls (60 s, kill-interruptible)
    past speculation_multiplier x the stage's median: its twin must win,
    and every map output of the run is published exactly once."""
    import collections

    from blaze_tpu_torch.runtime import faults
    from blaze_tpu_torch.spark.local_runner import run_plan

    cut = {t: (v[:1] if isinstance(v, list) else v)
           for t, v in paths.items()}
    published = collections.Counter()
    real = artifacts.commit_shuffle_pair

    def commit(write_fn, data_path, index_path, gate=None):
        out = real(write_fn, data_path, index_path, gate=gate)
        published[data_path] += 1
        return out

    info = {}
    plan = _runner_plan("q02", cut, "smj")
    spec = {"seed": seed, "concurrent": True,
            "points": {"op.SortMergeJoinExec": {"kind": "stall", "nth": 2,
                                                "ms": 60_000}}}
    wd = os.path.join(work_dir, "resilience", "q02_speculation")
    artifacts.commit_shuffle_pair = commit
    faults.install(spec)
    t0 = time.perf_counter()
    try:
        # AQE off for this run: the join stays a sort-merge join
        with _knobs(speculation_multiplier=2.0, aqe_broadcast_threshold=0):
            out = run_plan(plan, work_dir=wd, mesh_exchange="off",
                           run_info=info)
    finally:
        faults.install(None)
        artifacts.commit_shuffle_pair = real
    wall = time.perf_counter() - t0
    # numpy's q02 over the first web_sales and catalog_sales files
    check_q02(out, {"q02": orc["q02_first"]})
    d = out.to_numpy()
    counts = {k: v for k, v in info.items()
              if k in LADDER_INFO or k.startswith(("errors.", "degraded."))}
    _require(info.get("speculations_won", 0) >= 1,
             f"speculation: no twin won: {counts}")
    _require(wall < 50, f"speculation: the run waited out the stall "
             f"({wall:.1f} s)")
    _require(published and max(published.values()) == 1,
             f"speculation: a map output was published twice: "
             f"{published.most_common(2)}")
    _require(artifacts.find_orphans([wd]) == [],
             "speculation: temps left behind")
    return dict(counts, wall_s=wall, map_outputs_published=len(published),
                most_publishes_of_one_output=max(published.values()),
                rows=len(d["d_year"]))


def _resilience_runs(paths, orc, work_dir, runner, checks) -> dict:
    """q02 and q04 through run_plan under the knobs in force, each checked
    against numpy and runner_tpcds's rows, q02 with its launch count."""
    from blaze_tpu_torch.runtime import trace

    res = {}
    for q in ("q02", "q04"):
        trace.reset()
        run = _runner_run(q, paths, work_dir, checks[q],
                          info_keys=RESILIENCE_INFO)
        _same_rows(run.pop("rows"), runner[f"{q}_rows"],
                   f"{q} against runner_tpcds")
        _require(run["pipeline_streams"] > 0
                 and run["pipeline_live_streams"] == 0,
                 f"{q}: pipeline streams {run['pipeline_streams']}, "
                 f"{run['pipeline_live_streams']} left open")
        run["trace_records"] = len(trace.TRACE.snapshot())
        run["trace_dropped"] = trace.TRACE.dropped
        res[q] = run
    _require(res["q02"]["launches"] == runner["q02"]["launches"] > 0,
             f"q02 under the pool launched the kernel "
             f"{res['q02']['launches']} times, the inline route "
             f"{runner['q02']['launches']}")
    return res


def phase_runner_resilience(paths, orc, work_dir, runner, seed) -> dict:
    """The task runtime at its defaults (see the module docstring, phase
    20): q02 and q04 through run_plan under the supervisor and the
    pipeline, then once more with the trace on, then the resilience
    ladder's cases."""
    from blaze_tpu_torch.config import KNOBS
    from blaze_tpu_torch.runtime import trace

    checks = {"q02": lambda out: check_q02(out, orc),
              "q04": lambda out: check_q04(out, orc),
              "q09": lambda out: check_q09(out, orc)}
    defaults = {k: KNOBS[k].default for k in RUNTIME_KNOBS}
    _require(defaults["enable_supervisor"] and defaults["enable_pipeline"],
             f"the task runtime is off by default: {defaults}")
    res = {"phase": "runner_resilience", "mode": "bhj",
           "runtime": defaults}
    t_phase = time.perf_counter()
    with _knobs(**defaults):
        res.update(_resilience_runs(paths, orc, work_dir, runner, checks))
        for q in ("q02", "q04"):
            res[q]["inline_stage_s"] = runner[q]["stage_s"]
            res[q]["inline_launches"] = runner[q]["launches"]
            res[q]["inline_peak_device_bytes"] = runner[q][
                "peak_device_bytes"]
            res[q]["inline_host_pulls"] = runner[q]["host_pulls"]
        # the same runs with the trace on: on_batch counts every batch's
        # rows at every operator boundary, one host read each
        with _knobs(trace_enabled=True):
            traced = _resilience_runs(paths, orc, work_dir, runner, checks)
        _require(all(run["trace_records"] > 0 for run in traced.values()),
                 "the traced runs recorded nothing")
        res["traced"] = {q: {k: run[k] for k in (
            "stage_s", "wall_s", "launches", "host_pulls",
            "peak_device_bytes", "trace_records", "trace_dropped")}
            for q, run in traced.items()}
        trace.reset()
        ladder = {}
        ladder["retry_serde_encode"] = _ladder_case(
            "q09", paths, work_dir, checks["q09"],
            {"seed": seed, "points": {"serde.encode": {"kind": "io",
                                                       "nth": 1}}})
        ladder["oom_to_row_interpreter"] = _ladder_case(
            "q09", paths, work_dir, checks["q09"],
            {"seed": seed, "points": {"op.IpcReaderExec": {
                "kind": "oom", "fail_times": 10 ** 9}}})
        ladder["stall_relaunch"] = _ladder_case(
            "q09", paths, work_dir, checks["q09"],
            {"seed": seed, "points": {"op": {"kind": "stall", "nth": 3,
                                             "ms": 60_000}}},
            hang_detect_ms=3000)
        res["ladder"] = {k: dict(c, wall_s=w) for k, (c, w) in
                         ladder.items()}
        res["ladder"]["speculation"] = _speculation_case(
            paths, orc, work_dir, seed)
    lad = res["ladder"]
    _require(lad["retry_serde_encode"].get("retries", 0) >= 1,
             f"serde.encode fault not retried: {lad['retry_serde_encode']}")
    oom = lad["oom_to_row_interpreter"]
    _require(oom.get("ladder_rung") == 3 and oom.get("task_fallbacks", 0)
             >= 1 and all(oom.get(f"degraded.{r}", 0) >= 1 for r in
                          ("halve_batch", "force_spill", "fallback")),
             f"the oom did not walk rungs 1-3 to the row interpreter: {oom}")
    stall = lad["stall_relaunch"]
    _require(stall.get("hangs_detected", 0) >= 1
             and stall.get("retries", 0) >= 1
             and stall["wall_s"] < 50,
             f"the stall was not killed and relaunched: {stall}")
    res["seconds"] = time.perf_counter() - t_phase
    _emit(res)
    return res

# ---- runner_mesh: the device-mesh exchange and the monitor at defaults ----

MESH_QUERIES = ("q02", "q04", "q03", "q03_rev", "basket_items")
# list state, which the mesh declines: every shuffle stage takes the files
MESH_DECLINED = ("basket_items",)
MONITOR_BYTES = tuple(f"bytes_{kind}_{b}" for kind in ("copied", "moved")
                      for b in ("serde", "ffi", "shuffle", "spill",
                                "fallback", "total"))
MESH_INFO = RUNNER_INFO + ("mesh_stages", "mesh_pinned_bytes",
                           "pipeline_streams",
                           "pipeline_live_streams", "resource_leaks",
                           "peak_mem_bytes", "spill_bytes",
                           "spill_count") + MONITOR_BYTES
LOGICAL_DEVICES = 4
LOGICAL_BATCHES = 4
# the mixed-provider check: batches, and the budget in batches' bytes
# (half of it pins two batches on the card; the third goes to files)
MIXED_BATCHES = 3
MIXED_BUDGET = 2


def _sorted_rows(d: dict, key: str) -> dict:
    order = np.argsort(np.asarray(d[key]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _logical_device_check(batches, work_dir) -> dict:
    """shuffle_q06's map stage (LOGICAL_BATCHES of the main path's batches
    -> the dense partial aggregate -> hash(ss_item_sk) into 200) through
    run_mesh_shuffle_stage with the mesh on LOGICAL_DEVICES logical
    devices, every one this card (parallel/stage_exchange.mesh_devices
    patched), then through the file path (the same plan's shuffle writer
    and reader). Each partition's rows must be the file path's."""
    from blaze_tpu_torch.parallel import stage_exchange

    rid = resources.register(lambda: iter(batches[:LOGICAL_BATCHES]))
    data = os.path.join(work_dir, "logical.data")
    index = os.path.join(work_dir, "logical.index")
    td = pb.TaskDefinition.FromString(_shuffle_map_task(
        SCHEMA_PB, rid, 0, data, index))
    schema = decode_task_definition(td.SerializeToString())[0].schema
    real = stage_exchange.mesh_devices
    stage_exchange.mesh_devices = lambda dev: [
        batches[0].device] * LOGICAL_DEVICES
    try:
        t0 = time.perf_counter()
        _require(stage_exchange.run_mesh_shuffle_stage(
            td.plan, 990, 1, work_dir=work_dir), "the mesh declined q06")
        provider = resources.get("shuffle:990")
        mesh = [[b.to_numpy() for b in provider(p)]
                for p in range(SHUFFLE_PARTITIONS)]
        mesh_s = time.perf_counter() - t0
    finally:
        stage_exchange.mesh_devices = real
        resources.pop("shuffle:990")
    t0 = time.perf_counter()
    _run_map_stage([td.SerializeToString()])
    file_s = time.perf_counter() - t0
    resources.pop(rid)
    rows = 0
    for p in range(SHUFFLE_PARTITIONS):
        want = list(read_shuffle_partition_host(data, index, p, schema))
        w = host_to_pylike(host_concat(want)) if want else None
        g = {k: np.concatenate([d[k] for d in mesh[p]])
             for k in schema.names()} if mesh[p] else None
        _require((w is None) == (g is None),
                 f"partition {p}: mesh {g is not None}, file {w is not None}")
        if w is None:
            continue
        w, g = _sorted_rows(w, "ss_item_sk"), _sorted_rows(g, "ss_item_sk")
        for k in schema.names():
            _require(np.array_equal(np.asarray(g[k]), np.asarray(w[k])),
                     f"partition {p}: column {k} differs from the file path")
        rows += len(w["ss_item_sk"])
    return {"logical_devices": LOGICAL_DEVICES, "cards": 1,
            "partitions": SHUFFLE_PARTITIONS, "state_rows": rows,
            "equal_to_file_path": True, "mesh_s": mesh_s, "file_s": file_s}


def _partition_rows(rows: list, names: list) -> dict:
    """Host rows of one partition (a list of column dicts) in one order:
    sorted by every column, so two routes' multisets compare."""
    cols = {k: np.concatenate([np.asarray(r[k]) for r in rows])
            for k in names}
    order = np.lexsort([cols[k] for k in reversed(names)])
    return {k: v[order] for k, v in cols.items()}


def _mixed_provider_check(batches, work_dir) -> dict:
    """The half-budget rule on the card: MIXED_BATCHES of the main path's
    batches, not aggregated (ffi_reader -> hash(ss_item_sk) into 200),
    through run_mesh_shuffle_stage on this one card (exchange_local) with
    the memory budget cut to MIXED_BUDGET batches' device bytes, so the
    first two stay on the card and the rest go to files; each partition
    (mesh slices, then file segments) must hold the rows the file path
    writes for the same batches."""
    from blaze_tpu_torch.parallel import stage_exchange

    mgr = memory.get_manager()
    budget = mgr.total
    rid = resources.register(lambda: iter(batches[:MIXED_BATCHES]))
    src = _reader_node(SCHEMA_PB, rid, kind="ffi_reader")
    data = os.path.join(work_dir, "mixed.data")
    index = os.path.join(work_dir, "mixed.index")
    node = _writer_node(src, ["ss_item_sk"], SHUFFLE_PARTITIONS, data, index)
    names = [n for n, _ in SCHEMA_PB]
    mesh_dir = os.path.join(work_dir, "mixed_mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    mgr.total = MIXED_BUDGET * memory.batch_nbytes(batches[0])
    try:
        t0 = time.perf_counter()
        _require(stage_exchange.run_mesh_shuffle_stage(
            node, 989, 1, work_dir=mesh_dir), "the mesh declined the stage")
        provider = resources.get("shuffle:989")
        mesh = []
        for p in range(SHUFFLE_PARTITIONS):
            mesh.append([host_to_pylike(b) if isinstance(b, serde.HostBatch)
                         else b.to_numpy() for b in provider(p)])
        mesh_s = time.perf_counter() - t0
    finally:
        mgr.total = budget
        resources.pop("shuffle:989")
    to_files = len([f for f in os.listdir(mesh_dir) if f.endswith(".data")])
    _require(0 < to_files < MIXED_BATCHES,
             f"{to_files} of {MIXED_BATCHES} batches went to files")
    t0 = time.perf_counter()
    _run_map_stage([_task_bytes(node, 0, 0)])
    file_s = time.perf_counter() - t0
    resources.pop(rid)
    rows = 0
    for p in range(SHUFFLE_PARTITIONS):
        want = [host_to_pylike(hb) for hb in read_shuffle_partition_host(
            data, index, p, SCHEMA)]
        _require(bool(want) == bool(mesh[p]), f"partition {p}: empty on "
                 f"one route")
        if not want:
            continue
        g, w = _partition_rows(mesh[p], names), _partition_rows(want, names)
        for k in names:
            _require(np.array_equal(g[k], w[k]),
                     f"partition {p}: column {k} differs from the file path")
        rows += len(w[names[0]])
    _require(rows == MIXED_BATCHES * ROWS, f"{rows} rows came back")
    return {"batches": MIXED_BATCHES, "batches_to_files": to_files,
            "budget_bytes": MIXED_BUDGET * memory.batch_nbytes(batches[0]),
            "partitions": SHUFFLE_PARTITIONS, "rows": rows,
            "equal_to_file_path": True, "mesh_s": mesh_s, "file_s": file_s}


def phase_runner_mesh(paths, orc, batches, work_dir) -> dict:
    """The device-mesh exchange and the monitor at their defaults (phases
    1-20 run with both off, the route of their earlier numbers): MESH_QUERIES
    through run_plan with config.py's defaults (the mesh "auto", the
    monitor, the supervisor's pool, the pipeline), each but the declined
    ones beside the same query with mesh_exchange="off" in the same call,
    each run checked against numpy. On one card each hash shuffle of plain column keys is
    exchanged in device memory (stage_exchange.exchange_local); past half
    the memory budget a batch goes to the files. q02 must launch the
    kernel once a probe batch on the mesh route, basket_items (list
    state) must take no mesh stage, and no run may leak a stream, a
    reservation or a consumer. First, the logical-device check and the
    mixed-provider check."""
    from blaze_tpu_torch.config import KNOBS

    checks = {"q02": lambda out: check_q02(out, orc),
              "q04": lambda out: check_q04(out, orc),
              "q03": lambda out: check_q03(out, orc),
              "q03_rev": lambda out: check_q03_rev(out, orc),
              "basket_items": lambda out: check_basket_items(out, orc)}
    defaults = {k: KNOBS[k].default
                for k in RUNTIME_KNOBS + ("monitor_enabled",)}
    _require(defaults["monitor_enabled"], "the monitor is off by default")
    res = {"phase": "runner_mesh", "mode": "bhj", "runtime": defaults}
    t_phase = time.perf_counter()
    with _knobs(**defaults):
        res["logical_device_check"] = _logical_device_check(batches,
                                                            work_dir)
        res["mixed_provider_check"] = _mixed_provider_check(batches,
                                                            work_dir)
        # each query on the mesh route only: its "off" twin (the file
        # route of runner_tpcds and the later runner phases) is cut for
        # the script's time limit; the CPU tests hold the routes' stage
        # counts (tests/torch_parity.assert_same_stages)
        for q in MESH_QUERIES:
            run = _runner_run(q, paths, work_dir, checks[q],
                              info_keys=MESH_INFO, mesh="auto")
            run["result_rows"] = len(next(iter(run.pop("rows").values())))
            res[q] = {"auto": run}
    probe_batches = TPCDS_FILES["web_sales"] + TPCDS_FILES["catalog_sales"]
    _require(res["q02"]["auto"]["launches"] == probe_batches,
             f"q02 on the mesh route launched the kernel "
             f"{res['q02']['auto']['launches']} times, not {probe_batches}")
    for q in MESH_QUERIES:
        auto = res[q]["auto"]
        _require((auto["mesh_stages"] == 0) == (q in MESH_DECLINED),
                 f"{q}: {auto['mesh_stages']} mesh stages")
        _require(auto["resource_leaks"] == 0
                 and auto["pipeline_live_streams"] == 0,
                 f"{q}: {auto['resource_leaks']} leaks, "
                 f"{auto['pipeline_live_streams']} streams left open")
    res["seconds"] = time.perf_counter() - t_phase
    _emit(res)
    return res


# ---- runner_observability: exports, history, progress, dossiers, profiles ----

OBS_QUERIES = ("q02", "q04")
OBS_RUNS = 2
OBS_INFO = MESH_INFO + ("query_id",)
OBS_HANG_MS = 3000           # hang_detect_ms of the stall cases
OBS_DEADLINE_MS = 2000       # query_deadline_ms of the deadline case
# the doctor's rounding: each of its 13 terms is rounded to 1 µs
OBS_TERM_ROUNDING_MS = 13 * 0.0005


def _obs_dirs(work_dir) -> dict:
    base = os.path.join(work_dir, "observability")
    return {"trace_export_dir": os.path.join(base, "trace"),
            "history_dir": os.path.join(base, "history"),
            "flight_dir": os.path.join(base, "flight"),
            "profile_export_dir": os.path.join(base, "profile")}


def _watch_progress(qid, seen, stop) -> None:
    """Second-thread reader of the live progress registry: every change
    of (stages seen, stages done) while `qid` runs."""
    from blaze_tpu_torch.runtime import progress

    while not stop.is_set():
        snap = progress.snapshot_query(qid)
        if snap is not None:
            cur = (snap["stages_total"], snap["stages_done"])
            if not seen or seen[-1] != cur:
                seen.append(cur)
        stop.wait(0.005)


def _obs_runs(paths, work_dir, runner, mesh, checks) -> dict:
    """q02 and q04, OBS_RUNS each, under the knobs in force; q04's runs
    read live from a second thread."""
    import threading

    from blaze_tpu_torch.runtime import profiler, progress, trace

    res = {}
    for q in OBS_QUERIES:
        for i in range(OBS_RUNS):
            qid = f"obs_{q}_{i}"
            seen, stop = [], threading.Event()
            watcher = threading.Thread(target=_watch_progress,
                                       args=(qid, seen, stop))
            if q == "q04":
                watcher.start()
            try:
                run = _runner_run(q, paths, work_dir, checks[q],
                                  info_keys=OBS_INFO, mesh="auto",
                                  query_id=qid)
            finally:
                stop.set()
                if q == "q04":
                    watcher.join()
            _same_rows(run.pop("rows"), runner[f"{q}_rows"],
                       f"{qid} against runner_tpcds")
            run["trace_records"] = len(trace.query_records(qid))
            run["profiler_duty_pct"] = profiler.stats()["duty_pct"]
            run["mesh_auto_wall_s"] = mesh[q]["auto"]["wall_s"]
            if q == "q04":
                _require(len(seen) >= 2 and seen == sorted(seen)
                         and seen[-1][1] >= 1,
                         f"{qid}: progress read live {seen}")
                fin = [f for f in progress.finished_queries()
                       if f["query_id"] == qid]
                _require(len(fin) == 1 and fin[0]["phase"] == "finished",
                         f"{qid}: not in finished_queries: {fin}")
                run["progress_seen"] = seen
                run["progress_final"] = {k: fin[0][k] for k in (
                    "stages_total", "stages_done", "rows", "elapsed_ms")}
            res[qid] = run
    return res


def _obs_files(dirs, runs) -> dict:
    """The ledger, traces, history, doctor and profiles the runs wrote,
    loaded back and checked."""
    from blaze_tpu_torch.runtime import doctor, history

    out = {}
    ledger = doctor.load_ledger(os.path.join(dirs["trace_export_dir"],
                                             "ledger.jsonl"))
    _require([r["query_id"] for r in ledger] == list(runs),
             f"ledger lines {[r['query_id'] for r in ledger]}")
    for rec in ledger:
        cp = rec.get("critical_path") or {}
        total = sum(cp.get("terms", {}).values())
        _require(rec.get("schema_version") and rec.get("stages")
                 and abs(total - rec["duration_ms"]) <= OBS_TERM_ROUNDING_MS,
                 f"{rec['query_id']}: critical path {total} ms against "
                 f"{rec.get('duration_ms')} ms")
        _require(os.path.exists(os.path.join(
            dirs["trace_export_dir"], f"trace_{rec['query_id']}.json")),
            f"no trace file for {rec['query_id']}")
    st = history.HistoryStore(dirs["history_dir"])
    recs = st.records()
    _require([r["query_id"] for r in recs] == list(runs),
             f"history records {[r['query_id'] for r in recs]}")
    for q in OBS_QUERIES:
        fps = [[s["fingerprint"] for s in r["stages"]] for r in recs
               if r["query_id"].startswith(f"obs_{q}_")]
        _require(len(fps) == OBS_RUNS and all(f == fps[0] for f in fps)
                 and all(fps[0]),
                 f"{q}: stage fingerprints differ between runs: {fps}")
    regressions = history.detect_regressions(recs)
    feed = history.StatisticsFeed(recs)
    diag = doctor.diagnose_dir(dirs["trace_export_dir"],
                               dirs["history_dir"])
    for d in diag:
        cp = d["critical_path"]
        out[d["query_id"]] = {
            "duration_ms": next(r["duration_ms"] for r in ledger
                                if r["query_id"] == d["query_id"]),
            "top_term": cp["top_term"],
            "terms_ms": {k: v for k, v in cp["terms"].items() if v},
            "parallel_scale": cp["parallel_scale"],
            "findings": [(f["code"], f["score"]) for f in
                         d["findings"][:3]]}
    for qid in runs:
        folded = os.path.join(dirs["profile_export_dir"],
                              f"profile_{qid}.collapsed")
        scope = os.path.join(dirs["profile_export_dir"],
                             f"profile_{qid}.speedscope.json")
        _require(os.path.exists(folded) and os.path.exists(scope),
                 f"{qid}: no profile files")
        with open(folded) as f:
            lines = [ln for ln in f.read().splitlines() if ln]
        with open(scope) as f:
            doc = json.load(f)
        samples = sum(int(ln.rsplit(" ", 1)[1]) for ln in lines)
        _require(lines and all(ln.startswith(f"query:{qid};")
                               for ln in lines) and samples > 0
                 and doc["profiles"][0]["endValue"] == samples,
                 f"{qid}: profile not attributed to the query")
        out[qid]["profile_samples"] = samples
        out[qid]["hot_frames"] = [
            (h["frame"], h["pct"]) for h in next(
                r for r in ledger if r["query_id"] == qid).get(
                    "profile", {}).get("hot_frames", [])[:3]]
    return {"ledger_lines": len(ledger), "history_records": len(recs),
            "history_shards": len(st.shards()),
            "stage_fingerprints": len(feed.fingerprints()["stages"]),
            "op_fingerprints": len(feed.fingerprints()["ops"]),
            "regressions": len(regressions), "doctor": out}


def _obs_dossiers(paths, orc, work_dir, seed, dirs) -> dict:
    """q09's incidents: a survived stall (stacks stashed, no dossier), the
    same stall with no relaunch budget (a hang dossier), and a query
    deadline (a deadline dossier)."""
    from blaze_tpu_torch.runtime import faults, flight_recorder
    from blaze_tpu_torch.spark.local_runner import run_plan

    stashed = []
    real = flight_recorder.record_stacks

    def record_stacks(qid, reason):
        stashed.append((qid, reason))
        real(qid, reason)

    stall = {"seed": seed, "points": {"op": {"kind": "stall", "nth": 3,
                                             "ms": 60_000}}}
    out = {}
    flight_recorder.record_stacks = record_stacks
    try:
        counts, wall = _ladder_case("q09", paths, work_dir,
                                    lambda o: check_q09(o, orc), stall,
                                    hang_detect_ms=OBS_HANG_MS)
        _require(counts.get("hangs_detected", 0) >= 1 and stashed
                 and stashed[0][1] == "hung",
                 f"the stall was not detected: {counts}, {stashed}")
        _require(flight_recorder.list_dossiers() == [],
                 "a query that survived its stall wrote a dossier")
        out["stall_relaunched"] = dict(counts, wall_s=wall,
                                       stacks_stashed=len(stashed))
        for case, spec, knobs, err in (
                ("hang", stall, {"hang_detect_ms": OBS_HANG_MS,
                                 "max_task_retries": 0}, faults.HungError),
                ("deadline", {"seed": seed, "points": {"op": {
                    "kind": "stall", "nth": 1, "ms": 60_000}}},
                 {"query_deadline_ms": OBS_DEADLINE_MS},
                 faults.DeadlineError)):
            qid = f"obs_q09_{case}"
            faults.install(spec)
            t0 = time.perf_counter()
            try:
                with _knobs(**knobs):
                    run_plan(_runner_plan("q09", paths),
                             work_dir=os.path.join(work_dir, "obs", case),
                             mesh_exchange="off",
                             run_info={"query_id": qid})
                raise AssertionError(f"q09 {case}: the query did not fail")
            except err:
                pass
            finally:
                faults.install(None)
            wall = time.perf_counter() - t0
            found = [d for d in flight_recorder.list_dossiers(
                dirs["flight_dir"]) if d["query_id"] == qid]
            _require(len(found) == 1 and found[0]["trigger"] == case,
                     f"q09 {case}: dossiers {found}")
            doc = flight_recorder.load(found[0]["path"])
            _require(doc["trigger"] == case and doc["query_id"] == qid
                     and doc["thread_stacks"]
                     and doc["thread_stacks"]["stacks"],
                     f"q09 {case}: dossier without its stacks")
            out[case] = {"wall_s": wall, "error": doc["error"]["type"],
                         "stacks_reason": doc["thread_stacks"]["reason"],
                         "threads": len(doc["thread_stacks"]["stacks"]),
                         "trace_events": len(doc["trace_events"]),
                         "top_finding": found[0]["top_finding"],
                         "bytes": os.path.getsize(found[0]["path"])}
    finally:
        flight_recorder.record_stacks = real
    _require(flight_recorder.last_error() is None,
             f"a capture failed: {flight_recorder.last_error()}")
    return out


def phase_runner_observability(paths, orc, work_dir, runner, mesh,
                               seed) -> dict:
    """The observability layer on top of runner_mesh's defaults (see the
    module docstring, phase 22)."""
    from blaze_tpu_torch.config import KNOBS
    from blaze_tpu_torch.runtime import (
        flight_recorder, history, profiler, progress, trace,
    )

    checks = {"q02": lambda out: check_q02(out, orc),
              "q04": lambda out: check_q04(out, orc)}
    dirs = _obs_dirs(work_dir)
    knobs = dict({k: KNOBS[k].default
                  for k in RUNTIME_KNOBS + ("monitor_enabled",)},
                 trace_enabled=True, progress_enabled=True,
                 profile_enabled=True, **dirs)
    for m in (trace, history, progress, flight_recorder, profiler):
        m.reset()
    res = {"phase": "runner_observability", "mode": "bhj",
           "runtime": knobs}
    t_phase = time.perf_counter()
    try:
        with _knobs(**knobs):
            res["runs"] = _obs_runs(paths, work_dir, runner, mesh, checks)
            res["profiler"] = profiler.stats()
            res["files"] = _obs_files(dirs, res["runs"])
            res["dossiers"] = _obs_dossiers(paths, orc, work_dir, seed,
                                            dirs)
    finally:
        profiler.stop()
    for qid, run in res["runs"].items():
        if qid.startswith("obs_q02"):
            _require(run["launches"] == runner["q02"]["launches"] > 0,
                     f"{qid} launched the kernel {run['launches']} times, "
                     f"runner_tpcds's q02 {runner['q02']['launches']}")
        _require(run["resource_leaks"] == 0
                 and run["pipeline_live_streams"] == 0,
                 f"{qid}: {run['resource_leaks']} leaks, "
                 f"{run['pipeline_live_streams']} streams left open")
    res["seconds"] = time.perf_counter() - t_phase
    _emit(res)
    return res


# ---- runner_pool: the process-isolated executor pool ----

POOL_COUNT = 2          # executor processes
POOL_SLOTS = 2          # tasks a process at once: config.py's default
POOL_INFO = MESH_INFO + ("pool_stages", "pool_kernel_launches",
                         "pool_engine_start_s")
POOL_KILL_WAIT_S = 30.0  # for q09's map task to reach a worker


def _compute_apps() -> str:
    """nvidia-smi's list of the processes on the card (pid, MiB). In a
    container it names pids of the host's namespace, not this one's, so
    the checks read the card's total (_card_used_mib) instead."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _card_used_mib() -> float:
    """The card's used memory in MiB, every process together (nvidia-smi
    memory.used), after this process hands its cached blocks back."""
    torch.cuda.empty_cache()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return float(out.split()[0])


def _stale_epoch_files(root) -> list:
    """Epoch-stamped map outputs (`*.e<N>.data`/`.index`, and their
    temps) left under root."""
    import re

    pat = re.compile(r"\.e\d+\.(data|index)")
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs if pat.search(f))


def _pool_kill_run(pool, paths, work_dir, check) -> dict:
    """q09 with its map task's worker SIGKILLed once busy_pids() names
    it: the driver re-queues the task under a new epoch, the seat
    respawns, and the answer must still equal numpy's."""
    import signal
    import threading

    from blaze_tpu_torch.runtime import artifacts

    epochs, killed, stop = [], {}, threading.Event()
    real = pool.run_tasks

    def run_tasks(specs, timeout=None):
        out = real(specs, timeout)
        epochs.extend(artifacts.epoch_of(r["data_path"]) for r in out)
        return out

    def killer():
        deadline = time.monotonic() + POOL_KILL_WAIT_S
        while not stop.is_set() and time.monotonic() < deadline:
            busy = pool.busy_pids()
            if busy:
                seat, pid = sorted(busy.items())[0]
                os.kill(pid, signal.SIGKILL)
                killed.update(seat=seat, pid=pid,
                              at_s=time.perf_counter() - t0)
                return
            time.sleep(0.005)

    before = pool.stats()
    pool.run_tasks = run_tasks
    t0 = time.perf_counter()
    thread = threading.Thread(target=killer)
    thread.start()
    try:
        run = _runner_run("q09", paths, work_dir, check, info_keys=POOL_INFO,
                          mesh="auto", query_id="pool_q09_kill")
    finally:
        stop.set()
        thread.join()
        pool.run_tasks = real
    _require(bool(killed), "q09: no worker was busy to kill")
    deadline = time.monotonic() + 60
    while pool.live_count() < POOL_COUNT and time.monotonic() < deadline:
        time.sleep(0.05)
    after = pool.stats()
    run.pop("rows")
    run.update(killed=killed, map_epochs=epochs,
               deaths=after["deaths_total"] - before["deaths_total"],
               restarts=after["restarts_total"] - before["restarts_total"],
               live_after=pool.live_count(),
               rejoined_pid=pool.pids().get(killed["seat"]),
               stale_epoch_files=_stale_epoch_files(
                   os.path.join(work_dir, "runner", "q09")))
    _require(run["deaths"] == 1 and run["restarts"] == 1
             and run["live_after"] == POOL_COUNT
             and run["rejoined_pid"] not in (None, killed["pid"]),
             f"q09: the killed seat did not recover: {run}")
    _require(max(epochs) >= 2, f"q09: no task re-queued: epochs {epochs}")
    _require(not run["stale_epoch_files"],
             f"q09: stale-epoch files left: {run['stale_epoch_files']}")
    return run


def _worker_profile(qid, top=8) -> dict:
    """What the sampling profiler saw in the workers during one query:
    samples by executor, the share under an import, the hottest leaf
    frames and the hottest three-frame stack tails."""
    from blaze_tpu_torch.runtime import profiler

    rows = [r for r in profiler.rows(qid) if r[4]]
    by_exec, leaf, tail = {}, {}, {}
    imports = 0
    for _q, _t, _s, _k, ex, stack, n in rows:
        by_exec[ex] = by_exec.get(ex, 0) + n
        frames = stack.split(";")
        leaf[frames[-1]] = leaf.get(frames[-1], 0) + n
        key = ";".join(frames[-3:])
        tail[key] = tail.get(key, 0) + n
        imports += n if "frozen importlib" in stack else 0
    total = sum(by_exec.values())
    rank = lambda d: [[k, n] for k, n in sorted(  # noqa: E731
        d.items(), key=lambda kv: (-kv[1], kv[0]))[:top]]
    return {"samples": total, "by_exec": by_exec,
            "import_share": imports / total if total else None,
            "top_leaf": rank(leaf), "top_tails": rank(tail)}


def phase_runner_pool(paths, orc, work_dir, runner, mesh) -> dict:
    """The process-isolated executor pool at runner_mesh's defaults (see
    the module docstring, phase 23)."""
    from blaze_tpu_torch.config import KNOBS
    from blaze_tpu_torch.runtime import executor_pool, monitor, profiler

    checks = {"q02": lambda out: check_q02(out, orc),
              "q04": lambda out: check_q04(out, orc),
              "q09": lambda out: check_q09(out, orc)}
    defaults = {k: KNOBS[k].default
                for k in RUNTIME_KNOBS + ("monitor_enabled",)}
    res = {"phase": "runner_pool", "mode": "bhj", "count": POOL_COUNT,
           "slots": POOL_SLOTS, "runtime": defaults}
    # the sampling profiler runs in the workers (its governor holds it to
    # 1% of a thread) to show where a worker's first plan task goes
    profiler.reset()
    t_phase = time.perf_counter()
    driver_pid = os.getpid()
    zc0 = monitor.zerocopy_stats()
    with _knobs(profile_enabled=True, **defaults):
        t0 = time.perf_counter()
        pool = executor_pool.ExecutorPool(count=POOL_COUNT,
                                          slots=POOL_SLOTS).start()
        res["start_s"] = time.perf_counter() - t0
        # no worker has a CUDA context before its first plan task
        used0 = _card_used_mib()
        executor_pool.activate(pool)
        try:
            for q in ("q02", "q04"):
                run = _runner_run(q, paths, work_dir, checks[q],
                                  info_keys=POOL_INFO, mesh="auto",
                                  query_id=f"pool_{q}")
                _same_rows(run.pop("rows"), runner[f"{q}_rows"],
                           f"pooled {q} against runner_tpcds")
                run["mesh_auto_wall_s"] = mesh[q]["auto"]["wall_s"]
                res[q] = run
                if q == "q02":
                    # where the worker's first plan task went (no warm
                    # rerun: the script's time limit)
                    run["worker_profile"] = _worker_profile("pool_q02")
            res["compute_apps"] = _compute_apps()
            res["worker_pids"] = sorted(pool.pids().values())
            res["driver_pid"] = driver_pid
            used_live = _card_used_mib()
            res["card_used_mib"] = {"pool_started": used0,
                                    "workers_live": used_live}
            res["workers_mib"] = used_live - used0
            _require(res["workers_mib"] >= 256,
                     f"the workers hold {res['workers_mib']} MiB of the "
                     f"card after q02 and q04")
            res["q09_kill"] = _pool_kill_run(pool, paths, work_dir,
                                             checks["q09"])
            res["q09_kill"]["inline_checked_s"] = \
                runner["q09"]["checked_s"]
            st = pool.stats()
            res["pool"] = {k: st[k] for k in (
                "deaths_total", "restarts_total", "tasks_done",
                "fenced_total", "telemetry_bytes_total",
                "telemetry_records_total", "shuffle_conns_dropped")}
            with pool._lock:
                handles = list(pool._seats.values()) + list(pool._graveyard)
            res["pool"]["telemetry_frames"] = sum(h.tel_seq
                                                  for h in handles)
            res["zerocopy"] = {k: v - zc0[k] for k, v in
                               monitor.zerocopy_stats().items()
                               if k.startswith("shuffle_mmap")}
        finally:
            executor_pool.deactivate(pool)
            pool.close()
            profiler.stop()
    # the card's memory comes back with the processes
    deadline = time.monotonic() + 30
    used_after = _card_used_mib()
    while used_after > used0 + 256 and time.monotonic() < deadline:
        time.sleep(0.5)
        used_after = _card_used_mib()
    res["card_used_mib"]["after_close"] = used_after
    res["compute_apps_after_close"] = _compute_apps()
    _require(used_after <= used0 + 256,
             f"the card holds {used_after} MiB after close(), "
             f"{used0} before the workers ran")
    q02, q04 = res["q02"], res["q04"]
    probe_batches = TPCDS_FILES["web_sales"] + TPCDS_FILES["catalog_sales"]
    _require(q02["pool_stages"] >= 1 and q02["launches"] == 0
             and q02["pool_kernel_launches"] == probe_batches,
             f"pooled q02: {q02['pool_kernel_launches']} launches in the "
             f"workers and {q02['launches']} in the driver, not "
             f"{probe_batches} and 0")
    _require(q04["pool_stages"] >= 4,
             f"pooled q04 ran {q04['pool_stages']} stages in workers")
    for q in ("q02", "q04"):
        _require(res[q]["resource_leaks"] == 0
                 and res[q]["pipeline_live_streams"] == 0,
                 f"pooled {q}: leaks or open streams: {res[q]}")
    res["seconds"] = time.perf_counter() - t_phase
    _emit(res)
    return res


# runner_service: five arrivals in this order against two run slots and
# two parked seats (two tenants weighted 3:1), so two run, two park and the
# fifth is shed
SERVICE_JOBS = (("q02", "gold"), ("q09", "silver"), ("q02", "gold"),
                ("q09", "silver"), ("q02", "gold"))
SERVICE_TENANTS = {"gold": 3.0, "silver": 1.0}
SERVICE_INFO = RUNNER_INFO + ("query_id", "tenant_id", "admission_outcome",
                              "admission_wait_ms", "kernel_launches",
                              "host_pulls", "peak_mem_bytes")
SERVICE_WAIT_S = 60.0   # for an arrival to run or park
# the stream: store_sales files published a tick, grouped by store
STREAM_TICKS = (3, 3, 2)
STREAM_FIELDS = (("ss_store_sk", "int64"), ("ss_quantity", "int32"),
                 ("ss_sales_price", "float64"))
STREAM_AGGS = (("sum", "ss_quantity", "qty_sum"),
               ("count", "ss_quantity", "qty_n"),
               ("min", "ss_sales_price", "price_min"),
               ("max", "ss_sales_price", "price_max"))
STREAM_WAIT_S = 600.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_free(port) -> bool:
    """No listener holds the port (TIME_WAIT entries of closed scrapes
    aside)."""
    import socket

    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def _http_get(port, route):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _gauge(text, name) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split(" ", 1)[1])
    raise RuntimeError(f"chip_smoke: no {name} in /metrics")


def _service_admission(svc, paths, orc, work_dir, runner, port) -> dict:
    """The five arrivals of SERVICE_JOBS through QueryService.submit, each
    from a thread of its own: submit() admits on the calling thread, so a
    parked arrival holds its thread until a slot frees. Each thread starts
    once the previous arrival runs or parks. The metrics endpoint is
    scraped while two run and two are parked."""
    import threading

    from blaze_tpu_torch.runtime import faults

    checks = {"q02": lambda out: check_q02(out, orc),
              "q09": lambda out: check_q09(out, orc)}
    plans = [_runner_plan(q, paths) for q, _t in SERVICE_JOBS]
    infos = [{} for _ in SERVICE_JOBS]
    futs, errs, t_sub, t_done = {}, {}, {}, {}

    def arrive(i):
        q, tenant = SERVICE_JOBS[i]
        t_sub[i] = time.perf_counter()
        try:
            fut = svc.submit(plans[i], tenant, run_info=infos[i],
                             work_dir=os.path.join(work_dir, "service",
                                                   f"{i}_{q}"))
        except faults.AdmissionRejected as e:
            t_done[i] = time.perf_counter()
            errs[i] = e
            return
        fut.add_done_callback(
            lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
        futs[i] = fut

    def wait_for(pred, what):
        deadline = time.monotonic() + SERVICE_WAIT_S
        while not pred():
            _require(time.monotonic() < deadline, f"service: {what}")
            time.sleep(0.002)

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    threads = []
    scrape = {}
    for i in range(len(SERVICE_JOBS)):
        th = threading.Thread(target=arrive, args=(i,),
                              name=f"service-arrival-{i}")
        threads.append(th)
        th.start()
        if i < 2:
            wait_for(lambda i=i: i in futs or i in errs,
                     f"arrival {i} was not admitted")
        elif i < 4:
            wait_for(lambda i=i: svc.stats()["queue_depth"] == i - 1
                     or i in futs, f"arrival {i} did not park")
            _require(i not in futs, f"arrival {i} ran without parking: a "
                     "running query ended before it arrived")
        else:
            th.join(SERVICE_WAIT_S)
        if i == 3:
            # two running, two parked: the endpoint shows it
            status, body = _http_get(port, "/metrics")
            text = body.decode()
            hstatus, hbody = _http_get(port, "/healthz")
            scrape = {"metrics_status": status, "healthz_status": hstatus,
                      "healthz": json.loads(hbody),
                      "admission_queue_depth": _gauge(
                          text, "blaze_admission_queue_depth"),
                      "queries_running": _gauge(text,
                                                "blaze_queries_running"),
                      "service_capacity": _gauge(text,
                                                 "blaze_service_capacity"),
                      "metrics_bytes": len(body)}
    # a parked arrival's thread returns from submit() once it is
    # admitted: only then does its future exist
    for th in threads:
        th.join(STREAM_WAIT_S)
        _require(not th.is_alive(), f"service: {th.name} still waits")
    _require(list(errs) == [4] and isinstance(errs[4],
                                              faults.AdmissionRejected),
             f"service: shed arrivals {sorted(errs)}, not the fifth alone")
    _require(sorted(futs) == [0, 1, 2, 3],
             f"service: futures for arrivals {sorted(futs)}")
    rows = {}
    for i, fut in sorted(futs.items()):
        q = SERVICE_JOBS[i][0]
        out = fut.result(timeout=STREAM_WAIT_S)
        checks[q](out)
        rows[i] = out.to_numpy()
        if q == "q02":
            _same_rows(rows[i], runner["q02_rows"],
                       f"service q02 #{i} against runner_tpcds")
    wall = time.perf_counter() - t0
    launches = mxu_agg.KERNEL_LAUNCHES
    st = svc.stats()
    res = {"scrape": scrape, "stats": st, "wall_s": wall,
           "launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "single_q02_peak_device_bytes": runner["q02"]["peak_device_bytes"],
           "shed": {"tenant_id": errs[4].tenant_id,
                    "wait_ms": errs[4].wait_ms,
                    "seconds": t_done[4] - t_sub[4]}}
    for i, info in enumerate(infos):
        if i in futs:
            res[f"{i}_{SERVICE_JOBS[i][0]}"] = dict(
                {k: info[k] for k in SERVICE_INFO},
                wall_s=t_done[i] - t_sub[i])
    runs = [res[f"{i}_{SERVICE_JOBS[i][0]}"] for i in sorted(futs)]
    _require([r["admission_outcome"] for r in runs]
             == ["admitted", "admitted", "parked", "parked"],
             f"service outcomes {[r['admission_outcome'] for r in runs]}")
    _require(st["admitted"] == 4 and st["parked"] == 2
             and st["rejected"] == 1 and st["running"] == 0,
             f"service stats {st}")
    for i, r in zip(sorted(futs), runs):
        if SERVICE_JOBS[i][0] == "q02":
            _require(r["kernel_launches"] == runner["q02"]["launches"],
                     f"service q02 #{i}: {r['kernel_launches']} launches, "
                     f"not {runner['q02']['launches']}")
    _require(launches == sum(r["kernel_launches"] for r in runs),
             f"service: {launches} launches in the phase, "
             f"{[r['kernel_launches'] for r in runs]} in its queries")
    _require(scrape["metrics_status"] == 200
             and scrape["healthz_status"] == 200
             and scrape["healthz"]["ok"]
             and scrape["admission_queue_depth"] == 2,
             f"service: the endpoint showed {scrape}")
    return res


def _ledger_check(trace_dir, adm) -> dict:
    """The run ledger: a line for each admitted query with its tenant,
    outcome and wait, and one for the shed arrival."""
    with open(os.path.join(trace_dir, "ledger.jsonl")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    by_qid = {rec["query_id"]: rec for rec in lines}
    runs = [v for k, v in adm.items() if k[:1].isdigit()]
    for r in runs:
        rec = by_qid.get(r["query_id"])
        _require(rec is not None, f"no ledger line for {r['query_id']}")
        _require((rec["tenant_id"], rec["admission_outcome"])
                 == (r["tenant_id"], r["admission_outcome"])
                 and rec["admission_wait_ms"] == r["admission_wait_ms"],
                 f"ledger line of {r['query_id']}: {rec['tenant_id']}, "
                 f"{rec['admission_outcome']}")
    shed = [rec for rec in lines if rec["admission_outcome"] == "rejected"]
    _require(len(shed) == 1 and shed[0]["tenant_id"] == "gold"
             and shed[0]["counters"]["admission_reject_reason"]
             == "queue_full", f"ledger shed lines {shed}")
    return {"lines": len(lines), "shed_query_id": shed[0]["query_id"],
            "outcomes": sorted(rec["admission_outcome"] for rec in lines)}


def _publish_tick(live, gen_dir, names) -> None:
    """Publish by rename: the tick's directory (every file published so
    far plus `names`, hard links of the data files) is made aside, then
    the stream's directory link is renamed onto it, so a poll sees a whole
    tick or none of it."""
    prev = os.path.realpath(live) if os.path.islink(live) else None
    os.makedirs(gen_dir)
    if prev is not None:
        for n in os.listdir(prev):
            os.link(os.path.join(prev, n), os.path.join(gen_dir, n))
    for src in names:
        os.link(src, os.path.join(gen_dir, os.path.basename(src)))
    tmp = live + ".next"
    os.symlink(gen_dir, tmp)
    os.replace(tmp, live)


def _stream_oracle(files) -> dict:
    """{store: (qty sum, qty count, price min, price max)} over the files,
    nulls skipped."""
    cols = _read_columns(files, [n for n, _t in STREAM_FIELDS])
    store = cols["ss_store_sk"][0]
    qty, qok = cols["ss_quantity"]
    price, pok = cols["ss_sales_price"]
    out = {}
    order = np.argsort(store, kind="stable")
    s = store[order]
    bounds = np.flatnonzero(np.r_[True, s[1:] != s[:-1], True])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        idx = order[lo:hi]
        q, qv = qty[idx].astype(np.int64), qok[idx]
        p, pv = price[idx], pok[idx]
        out[int(s[lo])] = (int(q[qv].sum()) if qv.any() else None,
                           int(qv.sum()),
                           float(p[pv].min()) if pv.any() else None,
                           float(p[pv].max()) if pv.any() else None)
    return out


def _service_stream(svc, paths, work_dir) -> dict:
    """A StreamingQuery through the service over the store_sales files,
    published in ticks of STREAM_TICKS; after the second batch it stops
    without settling its journal (a crash) and resume_stream takes it
    from its last checkpoint."""
    from blaze_tpu_torch.columnar import types as CT
    from blaze_tpu_torch.runtime import streaming

    files = paths["store_sales"]
    _require(sum(STREAM_TICKS) == len(files),
             f"stream ticks {STREAM_TICKS} over {len(files)} files")
    types = {"int64": CT.INT64, "int32": CT.INT32, "float64": CT.FLOAT64}
    spec = streaming.StreamSpec(
        CT.Schema([CT.Field(n, types[t]) for n, t in STREAM_FIELDS]),
        keys=[{"col": "ss_store_sk", "name": "ss_store_sk"}],
        aggs=[{"fn": fn, "col": c, "name": name}
              for fn, c, name in STREAM_AGGS])
    root = os.path.join(work_dir, "stream")
    os.makedirs(root)
    live = os.path.join(root, "live")
    ticks = np.cumsum((0,) + STREAM_TICKS)
    _reset_counts()
    t0 = time.perf_counter()
    _publish_tick(live, os.path.join(root, "tick0"),
                  files[ticks[0]:ticks[1]])
    sq = svc.open_stream(streaming.TailSource(live), spec, tenant_id="gold",
                         stream_id="service_stream",
                         work_dir=os.path.join(root, "work"))
    _require(sq.wait_consumed(int(ticks[1]), STREAM_WAIT_S),
             f"stream: tick 1 not consumed ({sq.stats()}, {sq.error})")
    _publish_tick(live, os.path.join(root, "tick1"),
                  files[ticks[1]:ticks[2]])
    _require(sq.wait_consumed(int(ticks[2]), STREAM_WAIT_S),
             f"stream: tick 2 not consumed ({sq.stats()}, {sq.error})")
    sq.stop(graceful=False)   # the crash posture: journal left unsettled
    first, first_log = sq.stats(), list(sq.batch_log)
    _publish_tick(live, os.path.join(root, "tick2"),
                  files[ticks[2]:ticks[3]])
    sq2 = svc.resume_stream("service_stream",
                            work_dir=os.path.join(root, "work2"))
    try:
        _require(sq2.wait_consumed(int(ticks[3]), STREAM_WAIT_S),
                 f"stream: tick 3 not consumed ({sq2.stats()}, "
                 f"{sq2.error})")
        wall = time.perf_counter() - t0
        second, second_log = sq2.stats(), list(sq2.batch_log)
        rows = sq2.result_rows()
    finally:
        sq2.stop(graceful=True)
    launches = mxu_agg.KERNEL_LAUNCHES
    log = first_log + second_log
    got = {r["ss_store_sk"]: tuple(r[name] for _f, _c, name in STREAM_AGGS)
           for r in rows}
    want = _stream_oracle(files)
    _require(got == want, f"stream: {len(got)} stores against numpy's "
             f"{len(want)}; first differences "
             f"{[(k, got.get(k), v) for k, v in want.items() if got.get(k) != v][:3]}")
    _require([b["files"] for b in log] == list(STREAM_TICKS),
             f"stream batches of {[b['files'] for b in log]} files")
    _require(first["batches_total"] == 2 and second["batches_total"] == 1
             and second["resumed_from_epoch"] == 2
             and second["resumed_batches"] == 1 and second["epoch"] == 3
             and second["files_consumed"] == len(files)
             and second["rows_total"] == len(files) * FACT_FILE_ROWS,
             f"stream: {first} then {second}")
    _require(launches == sum(b["kernel_launches"] for b in log),
             f"stream: {launches} launches, "
             f"{[b['kernel_launches'] for b in log]} in its batches")
    return {"batches": [dict(b, route="dense" if b["stage_compiled"]
                             else "streaming_agg") for b in log],
            "batches_total": first["batches_total"]
            + second["batches_total"],
            "resumed_from_epoch": second["resumed_from_epoch"],
            "checkpoint_bytes": second["checkpoint_bytes"],
            "groups": len(got), "rows_total": second["rows_total"],
            "launches": launches, "wall_s": wall}


def _service_autopilot(paths, orc, work_dir, runner) -> dict:
    """q02 twice with the autopilot on: the first run stamps its query
    fingerprint and an empty overlay; a settled overlay stored for that
    fingerprint (as a prior run's promotion would) applies on the
    second."""
    from blaze_tpu_torch.runtime import autopilot

    keys = RUNNER_INFO + ("autopilot", "kernel_launches")
    res = {}
    with _knobs(autopilot_enabled=True,
                autopilot_dir=os.path.join(work_dir, "autopilot"),
                history_dir=os.path.join(work_dir, "autopilot_history")):
        autopilot.reset()
        for n in (1, 2):
            run = _runner_run("q02", paths, work_dir,
                              lambda out: check_q02(out, orc),
                              info_keys=keys, mesh="auto",
                              query_id=f"autopilot_q02_{n}")
            _same_rows(run.pop("rows"), runner["q02_rows"],
                       f"autopilot q02 #{n} against runner_tpcds")
            _require(run["launches"] == run["kernel_launches"]
                     == runner["q02"]["launches"],
                     f"autopilot q02 #{n}: {run['launches']} launches")
            res[f"run{n}"] = run
            if n == 1:
                fp = run["autopilot"]["fingerprint"]
                autopilot.active().store.append(
                    "promote", fp, knob="prefetch_batches",
                    value=conf.prefetch_batches + 1)
                autopilot.reset()
        autopilot.reset()
    first, second = res["run1"]["autopilot"], res["run2"]["autopilot"]
    _require(first["overlay"] == {} and second["overlay"] == {
        "prefetch_batches": conf.prefetch_batches + 1}
        and second["provenance"] == {"prefetch_batches": "fingerprint"}
        and second["fingerprint"] == first["fingerprint"],
        f"autopilot overlays {first} then {second}")
    return res


def phase_runner_service(paths, orc, work_dir, runner) -> dict:
    """The service and control layer on the card (see the module
    docstring, phase 24)."""
    from blaze_tpu_torch.config import KNOBS
    from blaze_tpu_torch.runtime import monitor, service

    defaults = {k: KNOBS[k].default
                for k in RUNTIME_KNOBS + ("monitor_enabled",)}
    res = {"phase": "runner_service", "mode": "bhj",
           "max_concurrent_queries": 2, "admission_queue_depth": 2,
           "tenant_priority_spec": SERVICE_TENANTS,
           "stream_default_stream": "kernels of concurrent sessions queue "
                                    "on the device's default stream"}
    t_phase = time.perf_counter()
    trace_dir = os.path.join(work_dir, "service_trace")
    port = _free_port()
    with _knobs(**dict(defaults, trace_enabled=True,
                       trace_export_dir=trace_dir, metrics_port=port,
                       max_concurrent_queries=2, admission_queue_depth=2,
                       tenant_priority_spec=dict(SERVICE_TENANTS),
                       journal_dir=os.path.join(work_dir, "journal"),
                       stream_checkpoint_interval=1, stream_poll_ms=50)):
        srv = monitor.ensure_started()
        _require(srv is not None and srv.port == port,
                 "the metrics endpoint did not start")
        try:
            with service.QueryService() as svc:
                adm = _service_admission(svc, paths, orc, work_dir, runner,
                                         port)
                res["admission"] = adm
                res["ledger"] = _ledger_check(trace_dir, adm)
                with _knobs(trace_enabled=False):
                    res["stream"] = _service_stream(svc, paths, work_dir)
            res["sampler_ring_samples"] = len(monitor.sampler().ring())
        finally:
            monitor.shutdown()
        _require(_port_free(port), f"port {port} still held after "
                 "shutdown()")
        res["autopilot"] = _service_autopilot(paths, orc, work_dir, runner)
    res["seconds"] = time.perf_counter() - t_phase
    _emit(res)
    return res


def phase_tpcds_data(work_dir, seed) -> tuple:
    """Write the TPC-DS Parquet files from `seed`: (paths, oracle inputs)."""
    t0 = time.perf_counter()
    paths, orc = write_tpcds(work_dir, seed)
    files = [paths["date_dim"], paths["store_returns"]] + [
        paths[t] for t in DIM_ROWS] + [p for t in TPCDS_FILES
                                       for p in paths[t]]
    dec_files = [p for t in TPCDS_FILES for p in paths[DEC_TABLES[t]]]
    _emit({"phase": "tpcds_data", "seconds": time.perf_counter() - t0,
           "seed": seed, "date_dim_rows": DATE_DIM_ROWS,
           "dim_rows": DIM_ROWS,
           "fact_rows": dict({t: n * FACT_FILE_ROWS
                              for t, n in TPCDS_FILES.items()},
                             store_returns=SR_ROWS),
           "files": len(files),
           "bytes": sum(os.path.getsize(p) for p in files),
           "decimal_files": len(dec_files),
           "decimal_bytes": sum(os.path.getsize(p) for p in dec_files),
           # host time of runner_nested's oracles (the partials summed
           # over the writer threads)
           "nested_oracle_s": {k: orc[k] for k in (
               "store_returns_s", "nested_partials_s", "nested_oracle_s")}})
    return paths, orc


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=TPCDS_SEED,
                    help="seed of the TPC-DS Parquet data")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    smi = phase_card()
    # phases 1-19 take the inline route their earlier numbers were taken
    # on; phase 20 runs the task runtime at its defaults. Phases 1-20 run
    # with the monitor and the mesh exchange off (their earlier route);
    # phase 21 runs both at their defaults
    conf.enable_supervisor = False
    conf.enable_pipeline = False
    conf.monitor_enabled = False
    phase_build()
    kern = phase_kernel()
    main_path = phase_main_path(kern)
    phase_profile(main_path["plan"], main_path["rep_s"])
    datas, batches = main_path["datas"], main_path["batches"]
    minmax = phase_dense_minmax(datas, batches)
    _, general = phase_general_agg(datas, batches)
    phase_chain_stage(datas, batches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        conf.spill_dir = os.path.join(work_dir, "spill")
        shuffle = phase_shuffle_q06(datas, batches, work_dir)
        phase_shuffle_general(general, work_dir)
        phase_spill(datas, batches, general, work_dir)
        paths, orc = phase_tpcds_data(os.path.join(work_dir, "tpcds"),
                                      args.seed)
        q02 = phase_tpcds_q02(paths, orc, work_dir)
        q04 = phase_tpcds_q04(paths, orc, work_dir)
        runner = phase_runner_tpcds(paths, orc, work_dir, q02, q04)
        phase_runner_strings(paths, orc, work_dir)
        nested = phase_runner_nested(paths, orc, work_dir)
        decimal = phase_runner_decimal(paths, orc, work_dir, runner)
        spark_json = phase_runner_spark_json(paths, orc, work_dir, runner)
        resilient = phase_runner_resilience(paths, orc, work_dir, runner,
                                            args.seed)
        mesh = phase_runner_mesh(paths, orc, batches, work_dir)
        observed = phase_runner_observability(paths, orc, work_dir, runner,
                                              mesh, args.seed)
        pooled = phase_runner_pool(paths, orc, work_dir, runner, mesh)
        served = phase_runner_service(paths, orc, work_dir, runner)
    phase_wall(t0)
    _emit({"kernels": [{
        "name": "mxu_accumulate", "route": "cuda",
        "source": "blaze_tpu_torch/csrc/mxu_accumulate.cu",
        "replaces": "blaze_tpu/ops/mxu_agg.py:135",
        "launches": main_path["launches"],
        "max_abs_err": max(kern["max_abs_err"],
                           q02["kernel_check"]["max_abs_err"]),
        "chain_launches": main_path["chain"],
        "dense_minmax_launches": minmax["launches"],
        "shuffle_q06_launches": shuffle["launches"],
        "tpcds_q02_launches": q02["launches_per_rep"],
        "runner_q02_launches": runner["q02"]["launches"],
        "runner_nested_launches": {q: nested[q]["launches"]
                                   for q in NESTED_CHECKS},
        "runner_decimal_launches": {q: decimal[q]["launches"]
                                    for q in DECIMAL_CHECKS},
        "runner_json_launches": {q: spark_json[q]["launches"]
                                 for q in JSON_QUERIES},
        "runner_resilience_q02_launches": resilient["q02"]["launches"],
        "runner_mesh_q02_launches": mesh["q02"]["auto"]["launches"],
        "runner_pool_q02_launches": pooled["q02"]["pool_kernel_launches"],
        "runner_observability_q02_launches": [
            run["launches"] for qid, run in observed["runs"].items()
            if qid.startswith("obs_q02")],
        "runner_service_q02_launches": [
            run["kernel_launches"] for key, run in
            served["admission"].items() if key.endswith("_q02")],
        "runner_stream_launches": [
            b["kernel_launches"] for b in served["stream"]["batches"]],
        "runner_autopilot_q02_launches": [
            served["autopilot"][r]["kernel_launches"]
            for r in ("run1", "run2")],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "skewed_ms": kern["skewed_ms"],
        "skewed_one_slice_ms": kern["skewed_one_slice_ms"],
        "one_key_ms": kern["one_key_ms"],
        "bound_fraction": kern["bound_fraction"],
        "wrapper_ms": kern["wrapper_ms"],
        "skewed_wrapper_ms": kern["skewed_wrapper_ms"],
        "ms_over_library": kern["ms_over_library"],
        "wrapper_over_library": kern["wrapper_over_library"]}]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
