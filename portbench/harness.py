"""One run of one cell: set-up, the measured window, the check, the result.

The traffic file gives the task's plan as steps (plan.py) and its loop
(loops/<kind>.py); the configuration gives the tables (table.py). Set-up
makes the tables on the device from the seed, builds every task's
`TaskDefinition` bytes and warms the loop up; the window runs the loop
(task.py: decode, `collect_fetch_async`, every output column pulled to the
host); after it, the plain reference works out a sample of the completed
tasks again and decides `correct`.
"""

from __future__ import annotations

import gc
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from blaze_tpu_torch.runtime import memory, metrics, resources
from portbench import plan, spec, trace
from portbench import task as T
from portbench.reference import numpy_ref
from portbench.table import Table, tables as make_tables

FORBIDDEN = ("jax", "jaxlib", "flax", "blaze_tpu")
WARM_TASKS = 2


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`blaze_tpu_torch` is not `blaze_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def check(prep: "Prepared", sample: List[tuple],
          control: bool = False) -> Dict[str, float]:
    """The compared numbers over the sampled (task, columns), each the
    worst over them, and under "failed" the count of sampled tasks that
    break a limit. The reference runs one partition at a time on the host.
    With `control` the reference computed in float32 stands in the
    program's place."""
    limits = prep.cell.limits
    worst = {name: 0.0 for name in limits}
    failed = 0
    refs: Dict[int, tuple] = {}
    steps = prep.cell.traffic["plan"]
    for t, got in sample:
        if t.partition not in refs:
            def columns(table, names, p=t.partition):
                tb = prep.tables[table]
                return tb.host_columns(p % tb.partitions, names)
            refs[t.partition] = (
                numpy_ref.evaluate(steps, columns),
                numpy_ref.evaluate(steps, columns, "float32")
                if control else None)
        want, low = refs[t.partition]
        if control:
            got = low.cols
        nums = numpy_ref.compare(got, want)
        failed += any(nums[k] > limits[k] for k in limits)
        for k in worst:
            worst[k] = max(worst[k], nums[k])
    worst["failed"] = failed
    return worst


@dataclass
class Prepared:
    cell: spec.Cell
    tables: Dict[str, Table]
    tasks: List[bytes]
    resource_ids: List[str]
    device: torch.device
    marks: Dict[str, float]

    @property
    def first(self) -> Table:
        """The plan's first table: its partitions are the tasks'."""
        return next(iter(self.tables.values()))

    @property
    def partitions(self) -> int:
        return self.first.partitions

    @property
    def loop(self) -> dict:
        return self.cell.traffic["loop"]

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def window(self, seconds: float, sample_k: int, rng: random.Random,
               count: Optional[int] = None) -> T.Window:
        """The traffic's loop for `seconds` (or `count` tasks)."""
        loop = spec.part("loops", self.loop["kind"])
        return loop.run(self, seconds, T.Window(rng, sample_k), count)

    def close(self) -> None:
        for rid in self.resource_ids:
            resources.pop(rid)
        self.tables = {}
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


def prepare(cell: spec.Cell, seed: int, device: torch.device,
            shrink: Optional[dict] = None) -> Prepared:
    """Set-up after the imports: the CUDA context, the tables made on the
    device from the seed, the tasks' bytes, and the warm-up. `marks` holds
    the perf_counter at the end of each step."""
    marks = {}
    spec.part("loops", cell.traffic["loop"]["kind"]).validate(
        cell.traffic["loop"])
    torch.empty(1, device=device).sum().item()
    marks["context"] = time.perf_counter()
    steps = cell.traffic["plan"]
    tables = make_tables(cell.config, steps, seed, device, shrink)
    rids: List[str] = []

    def register(key, provider):
        rids.append(resources.put(f"portbench:{cell.name}:{key}", provider))
        return rids[-1]

    root = plan.PlanContext(tables, register).pipeline(steps)
    first = next(iter(tables.values()))
    tasks = [plan.task_bytes(root, cell.traffic["name"], p)
             for p in range(first.partitions)]
    prep = Prepared(cell, tables, tasks, rids, device, marks)
    prep.sync()
    marks["table"] = time.perf_counter()
    # warm-up: every shape of the loop, the kernels' build and load, the
    # stage's memo and the allocator's blocks for the tasks in flight
    for _ in range(WARM_TASKS):
        prep.window(0, 0, random.Random(0), count=1)
        prep.sync()
        marks.setdefault("warm_first", time.perf_counter())
    gc.collect()
    marks["warm"] = time.perf_counter()
    return prep


def card_or_none(cell: spec.Cell) -> Optional[torch.device]:
    """The card, or None (with the reason on standard error) where the
    machine lacks the CUDA devices the cell asks for."""
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return None
    return torch.device("cuda")


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t_process: float, t_imported: float, device: Optional[str] = None,
        shrink: Optional[dict] = None, out=None) -> int:
    """One run; prints the result line last on `out`. `device` and
    `shrink` ({"partitions", "batch_rows", "batches_per_partition"}) are
    for the CPU tests alone: a measured run takes the card and the
    configuration's sizes."""
    out = out or sys.stdout
    cell = spec.cell(workload)
    dev = torch.device(device) if device is not None else card_or_none(cell)
    if dev is None:
        return 2
    prep = prepare(cell, seed, dev, shrink)
    table, traffic = prep.first, cell.traffic
    on_card = prep.on_card
    sync = prep.sync
    rng = random.Random(seed)

    window_s = float(seconds)
    if traced:
        window_s = min(window_s, float(traffic.get("trace_seconds",
                                                   window_s)))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    spills0 = (memory.get_manager().spill_count,
               memory.get_manager().spilled_bytes)
    pulls0 = metrics.HOST_PULLS
    prof = sampler = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA] if on_card
                       else [ProfilerActivity.CPU])
        prof.__enter__()
        sampler = trace.HostSampler()
        sampler.start()
    t_setup = time.perf_counter()
    t0_ns = time.time_ns()
    win = prep.window(window_s, int(traffic.get("sample_tasks", 3)), rng)
    sync()
    t1_ns = time.time_ns()
    dtrace = None
    if traced:
        sampler.stop()
        prof.__exit__(None, None, None)
        dtrace = trace.reduce(prof, t0_ns, t1_ns, sampler.samples)
        del prof
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    work = (peak - base) if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    spills = (memory.get_manager().spill_count - spills0[0],
              memory.get_manager().spilled_bytes - spills0[1])
    program_pulls = metrics.HOST_PULLS - pulls0
    sample, win.sample = win.answers(), []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    n_tasks = len(win.tasks)
    lat_ms = np.array([(t.t_done - t.t0) * 1e3 for t in win.tasks])
    span_s = win.t_end - win.t_start
    rows = n_tasks * table.rows_per_partition
    batches = n_tasks * table.batches
    launches = sorted({t.launches / table.batches for t in win.tasks})
    t_check = time.perf_counter()
    nums = check(prep, sample)
    check_s = time.perf_counter() - t_check
    print(json.dumps({
        "workload": workload, "seed": seed, "card": _smi() if on_card
        else "cpu", "tasks": n_tasks, "window_s": span_s,
        "task_p50_ms": float(np.percentile(lat_ms, 50)) if n_tasks else None,
        "task_p95_ms": float(np.percentile(lat_ms, 95)) if n_tasks else None,
        "route": {"kernel_launches_per_batch": launches,
                  "expected": traffic.get("expect_route"),
                  "program_host_pulls_per_task":
                      program_pulls / max(n_tasks, 1),
                  "spill_count": spills[0], "spilled_bytes": spills[1]},
        "groups_per_task": sorted({t.groups for t in win.tasks})[:4],
        "resident_bytes": sum(t.resident_bytes()
                              for t in prep.tables.values()),
        "setup_steps_s": {
            "imports": t_imported - t_process,
            "context": prep.marks["context"] - t_imported,
            "table": prep.marks["table"] - prep.marks["context"],
            "warm_first": prep.marks["warm_first"] - prep.marks["table"],
            "warm": prep.marks["warm"] - prep.marks["table"],
            "window_start": t_setup - prep.marks["warm"]},
        "sampled_partitions": [t.partition for t, _ in sample],
        "check_s": check_s}),
        file=out, flush=True)

    values = {
        "rows_per_s": rows / span_s,
        "task_p95_ms": float(np.percentile(lat_ms, 95)),
        "work_mem_gb": work / 1e9,
        "setup_s": t_setup - t_process,
    }
    result_metrics = {}
    if traced:
        view = SimpleNamespace(
            trace=dtrace, tasks=n_tasks, batches=batches,
            decode_s=[t.decode_s for t in win.tasks])
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(view)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            result_metrics[m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}

    correct = n_tasks > 0 and all(nums[k] <= cell.limits[k]
                                  for k in cell.limits)
    compared = {k: {"value": nums[k], "limit": cell.limits[k]}
                for k in cell.limits}
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": n_tasks,
              "failed": int(nums["failed"]), "metrics": result_metrics,
              "device": device_info}
    if traced:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": trace.top(dtrace.by_name),
                               "idle_gaps": trace.top(dtrace.idle_gaps)}
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    prep.close()
    return 0
