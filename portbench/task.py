"""One task of the timed path, from its bytes to its rows on the host, and
the window that collects the completed tasks.

A task is its `TaskDefinition` bytes, decoded by `plan/from_proto.py` and
run by `runtime/executor.collect_fetch_async` at the runtime's defaults
over the partition's batches, which the plan's `ffi_reader` providers
yield from HBM. It ends in the pull of every output column, values and
validity, to the host. Its latency runs from its dispatch to its rows on
the host. A loop (loops/<kind>.py) decides when tasks are dispatched and
completed.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from blaze_tpu_torch.ops import mxu_agg
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.plan.from_proto import decode_task_definition
from blaze_tpu_torch.runtime.executor import collect_fetch_async

_NP = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
       torch.int64: np.int64, torch.float64: np.float64,
       torch.float32: np.float32, torch.bool: np.bool_}


class Packer:
    """The task's last step: every output column's live values and
    validity, as bytes in one device tensor, pulled in one copy. It reads
    the row count first, as an Arrow export does."""

    def __init__(self) -> None:
        self.n = 0
        self.layout: List[tuple] = []

    def __call__(self, out) -> torch.Tensor:
        n = self.n = int(out.num_rows)
        self.layout = []
        parts = []
        for f, c in zip(out.schema, out.columns):
            if not isinstance(c.data, torch.Tensor):
                raise TypeError(f"column {f.name}: not a flat column")
            self.layout.append((f.name, _NP[c.data.dtype]))
            parts.append(c.data[:n].contiguous().view(torch.uint8))
            parts.append(c.valid_mask()[:n].contiguous().view(torch.uint8))
        return torch.cat(parts)


def parse(raw: np.ndarray, n: int, layout: List[tuple]) -> Dict[str, tuple]:
    """A packed result on the host: name -> (values, valid)."""
    cols, off = {}, 0
    for name, dtype in layout:
        w = np.dtype(dtype).itemsize * n
        values = raw[off:off + w].view(dtype)
        off += w
        cols[name] = (values, raw[off:off + n].view(np.bool_))
        off += n
    return cols


@dataclass
class Task:
    partition: int
    t0: float
    decode_s: float
    launches: int
    finish: object = None
    packer: Optional[Packer] = None
    t_done: float = 0.0
    groups: int = 0


@dataclass
class Window:
    """The completed tasks, and a reservoir sample, drawn from `rng`, of
    `sample_k` of their answers for the check."""
    rng: random.Random
    sample_k: int
    tasks: List[Task] = field(default_factory=list)
    sample: List[tuple] = field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0

    def keep(self, task: Task, raw) -> None:
        self.tasks.append(task)
        item = (task, raw, task.packer)
        if len(self.sample) < self.sample_k:
            self.sample.append(item)
            return
        j = self.rng.randrange(len(self.tasks))
        if j < self.sample_k:
            self.sample[j] = item

    def answers(self) -> List[tuple]:
        """The sampled tasks with their answers parsed: (task, columns)."""
        return [(t, parse(raw.view(np.uint8), pk.n, pk.layout))
                for t, raw, pk in self.sample]


def dispatch(tasks: List[bytes], p: int, partitions: int,
             device: torch.device) -> Task:
    """Decode task p's bytes and start it; its rows are not pulled yet."""
    t0 = time.perf_counter()
    plan, _ = decode_task_definition(tasks[p])
    decode_s = time.perf_counter() - t0
    launches = mxu_agg.KERNEL_LAUNCHES
    packer = Packer()
    finish = collect_fetch_async(
        plan, packer, ExecContext(partition=p, num_partitions=partitions,
                                  device=device))
    return Task(p, t0, decode_s, mxu_agg.KERNEL_LAUNCHES - launches,
                finish, packer)


def complete(win: Window, task: Task) -> None:
    """Pull task's rows to the host and keep it in the window."""
    raw = task.finish()
    task.t_done = time.perf_counter()
    task.groups = task.packer.n
    task.finish = None
    win.keep(task, raw)
