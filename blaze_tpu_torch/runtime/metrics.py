"""Per-operator metrics tree.

Port of blaze_tpu/runtime/metrics.py (MetricsSet, MetricNode): every
operator owns a `MetricsSet`; `MetricNode` mirrors the plan tree and
carries an optional value handler so an embedding layer can remap values
into Spark's metric system.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

# device -> host reads made through `to_host` since import. On the card each
# one waits for the device to drain its queue; chip_smoke.py resets and
# reads it around a rep
HOST_PULLS = 0
# host time (ns) in frame encode (pack, compress) and decode (decompress,
# unpack) of columnar/serde.py since import; the JAX package's monitor
# counts the same windows as serde_encode / serde_decode
SERDE_NS = {"encode": 0, "decode": 0}
# bytes of the frames encoded since import: the payload before compression
# ("raw") and the frames as written ("frames"); the JAX package's monitor
# counts the same pair as serde copied / moved
SERDE_BYTES = {"raw": 0, "frames": 0}


# host crossings of expression evaluation since import, by kind: "hostfn"
# (digests, CRC32, JSON: exprs/hostfns.py) and "udf" (the UDF wrapper of
# exprs/compiler.py); each a [crossings, host ns] pair
HOST_EVAL = {"hostfn": [0, 0], "udf": [0, 0]}
# the FFI bridge since import: row-interpreter exports run
# (spark/fallback.py export_iterator), rows they handed the native
# pipeline, and host ns spent producing them; and the batches FfiReaderExec
# handed on, with those of them that lie on the card
BRIDGE = {"exports": 0, "rows": 0, "ns": 0, "batches": 0, "card_batches": 0}


def note_host_eval(kind: str, ns: int) -> None:
    HOST_EVAL[kind][0] += 1
    HOST_EVAL[kind][1] += ns


def to_host(t):
    """`t` on the host (a CPU tensor), counted in HOST_PULLS. The port's
    reads of device values (row counts, stage flags, probe ranges) all go
    through here."""
    global HOST_PULLS
    HOST_PULLS += 1
    return t.cpu()


class MetricsSet:
    def __init__(self) -> None:
        self.values: Dict[str, int] = {
            "output_rows": 0,
            "output_batches": 0,
            "elapsed_compute_ns": 0,
        }
        self._lock = threading.Lock()

    def add(self, name: str, delta: int) -> None:
        with self._lock:
            self.values[name] = self.values.get(name, 0) + int(delta)

    def timer(self, name: str = "elapsed_compute_ns"):
        return _Timer(self, name)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.values)

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self.values.get(name, 0)


class _Timer:
    """Host wall time around a block. Kernels launch asynchronously, so
    on the card this measures enqueue time unless the block synchronises."""

    def __init__(self, ms: MetricsSet, name: str) -> None:
        self.ms, self.name = ms, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ms.add(self.name, time.perf_counter_ns() - self.t0)
        return False


class MetricNode:
    """Mirror of the plan tree for metric export (ref MetricNode.scala)."""

    def __init__(self, metrics: MetricsSet, children: List["MetricNode"],
                 handler: Optional[Callable[[str, int], None]] = None) -> None:
        self.metrics = metrics
        self.children = children
        self.handler = handler

    def push(self) -> None:
        """Walk the tree pushing values through handlers (task finalize)."""
        if self.handler is not None:
            for k, v in self.metrics.snapshot().items():
                self.handler(k, v)
        for c in self.children:
            c.push()

    @staticmethod
    def from_operator(op) -> "MetricNode":
        return MetricNode(op.metrics,
                          [MetricNode.from_operator(c) for c in op.children])
