"""Finds a cell's parts by name.

`BENCHMARK.json` at the root of the checkout names each cell (a traffic mix
over a configuration). Everything that belongs to one configuration, one
traffic mix, one kind of plan step, one column draw, one loop or one
per-layer metric sits in a file of its own under this folder, found by its
name:

    configs/<config>.json         the configuration: its tables and sizes
    traffic/<traffic>.json        the traffic mix: the task's plan as steps,
                                  and its loop
    limits/<workload>.json        the limits of the numbers `correct` compares
    operators/<op>.py             a plan step as the port's protobuf:
                                  build(step, inputs, ctx) -> PlanNode
    reference/operators/<op>.py   the same step in NumPy:
                                  evaluate(step, inputs, ctx) -> Relation
    exprs/<fn>, reference/exprs/<fn>
                                  an expression {"fn": <fn>, ...} beyond the
                                  built-in ones, on each side
    draws/<dist>.py               a column's draw on the device:
                                  draw(col, n, generator, device, dtype)
    loops/<kind>.py               how tasks are issued:
                                  validate(loop) and run(prep, seconds,
                                  window, count) -> Window
    metrics/<metric>.py           a per-layer reader: read(run) -> float|None

So a later cell, configuration, plan step, draw, loop or metric is added
by adding files and `BENCHMARK.json` entries, without editing a file that
is here. This module imports nothing of the program, so the reference may
use it.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def part(kind: str, name: str) -> ModuleType:
    """The module `<kind>/<name>.py` under this folder, loaded once."""
    path = HERE / kind / f"{name}.py"
    if not _NAME.fullmatch(name) or not path.is_file():
        raise KeyError(f"no {kind} {name!r}: expected "
                       f"{path.relative_to(ROOT)}")
    mod_name = "portbench_part_" + re.sub(r"\W", "_", f"{kind}/{name}")
    module = sys.modules.get(mod_name)
    if module is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[mod_name]
            raise
    return module


def leaves(steps: List[dict]) -> Iterator[dict]:
    """Every step that reads a table (it has a "table" key), in the order
    of the plan: the main pipeline's first step first, then any pipelines
    that steps hold as their other inputs."""
    for step in steps:
        if "table" in step:
            yield step
        for value in step.values():
            if isinstance(value, list) and value and all(
                    isinstance(v, dict) and "op" in v for v in value):
                yield from leaves(value)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `workload` of BENCHMARK.json with its configuration, traffic
    mix, limits and the metrics it reports."""
    bench = _load(benchmark)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    return Cell(
        name=workload,
        config=_load(ROOT / conf_entry["file"]),
        traffic=_load(HERE / "traffic" / f"{entry['traffic']}.json"),
        chips=int(entry["chips"]),
        limits=_load(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    """`read` of metrics/<name>.py (a name may hold dots)."""
    return part("metrics", name).read
