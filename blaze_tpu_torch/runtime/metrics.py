"""Per-operator metrics tree.

Port of blaze_tpu/runtime/metrics.py (MetricsSet, MetricNode, Histogram):
every operator owns a `MetricsSet`; `MetricNode` mirrors the plan tree and
carries an optional value handler so an embedding layer can remap values
into Spark's metric system.

Every counter here is updated under a lock: the supervisor's pool threads
and the pipeline's I/O threads (runtime/supervisor.py, runtime/pipeline.py)
update them at once, and an unlocked read-modify-write loses counts. The
process-wide counters below share `COUNTER_LOCK`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# guards the process-wide counters of this module (and the kernel launch
# counts of ops/mxu_agg.py): pool and I/O threads add to them at once
COUNTER_LOCK = threading.Lock()

# device -> host reads made through `to_host` since import. On the card each
# one waits for the device to drain its queue; chip_smoke.py resets and
# reads it around a rep
HOST_PULLS = 0
# host time (ns) in frame encode (pack, compress) and decode (read,
# decompress, unpack) of columnar/serde.py since import; runtime/monitor.py
# counts the same windows per query as serde_encode / serde_decode
SERDE_NS = {"encode": 0, "decode": 0}
# bytes of the frames encoded since import: the payload before compression
# ("raw") and the frames as written ("frames"); runtime/monitor.py counts
# the same pair per query as serde copied / moved
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


# per-task tallies beside the process-wide counts: `task_tally` opens a
# dict on its thread, the pipeline's threads replay it
# (runtime/pipeline._CtxSnapshot), and `tally_add` counts into it, so an
# executor process that runs several tasks at once (runtime/executor_pool.py)
# reports each task's own kernel launches
_tally = threading.local()


@contextlib.contextmanager
def task_tally(box: Optional[Dict[str, int]] = None):
    """Scope a per-task tally on this thread (a fresh dict, or `box` to
    rejoin a tally opened on another thread); yields the dict."""
    prev = getattr(_tally, "box", None)
    _tally.box = {} if box is None else box
    try:
        yield _tally.box
    finally:
        _tally.box = prev


def current_tally() -> Optional[Dict[str, int]]:
    return getattr(_tally, "box", None)


def tally_add(key: str, n: int = 1) -> None:
    """Count `n` into this thread's task tally, if one is open."""
    box = getattr(_tally, "box", None)
    if box is not None:
        with COUNTER_LOCK:
            box[key] = box.get(key, 0) + n


def note_host_eval(kind: str, ns: int) -> None:
    with COUNTER_LOCK:
        HOST_EVAL[kind][0] += 1
        HOST_EVAL[kind][1] += ns


def bump(counters: Dict[str, int], key: str, delta: int) -> None:
    """`counters[key] += delta` under COUNTER_LOCK (SERDE_NS, SERDE_BYTES,
    BRIDGE)."""
    with COUNTER_LOCK:
        counters[key] += delta


def to_host(t):
    """`t` on the host (a CPU tensor), counted in HOST_PULLS and in this
    thread's task tally. The port's reads of device values (row counts,
    stage flags, probe ranges) all go through here."""
    global HOST_PULLS
    box = getattr(_tally, "box", None)
    with COUNTER_LOCK:
        HOST_PULLS += 1
        if box is not None:
            box["host_pulls"] = box.get("host_pulls", 0) + 1
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

    def set_max(self, name: str, value: int) -> None:
        """Max-semantics update, under the same lock as `add`."""
        with self._lock:
            if int(value) > self.values.get(name, 0):
                self.values[name] = int(value)

    def timer(self, name: str = "elapsed_compute_ns"):
        return _Timer(self, name)

    def snapshot(self) -> Dict[str, int]:
        """Point-in-time copy, taken under the lock: readers iterate it
        while pool threads go on adding."""
        with self._lock:
            return dict(self.values)

    def reset(self) -> None:
        """Clear every counter under the adders' lock."""
        with self._lock:
            self.values.clear()

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
        """Walk the tree pushing values through handlers (task finalize);
        each node's values from a locked snapshot."""
        if self.handler is not None:
            for k, v in self.metrics.snapshot().items():
                self.handler(k, v)
        for c in self.children:
            c.push()

    @staticmethod
    def from_operator(op) -> "MetricNode":
        return MetricNode(op.metrics,
                          [MetricNode.from_operator(c) for c in op.children])


class Histogram:
    """Fixed-bucket log2 histogram (locked, mergeable).

    Bucket i counts values v with 2^(i-1) <= v < 2^i (bucket 0 takes
    v <= 0, bucket 1 takes v == 1); 64 buckets cover every non-negative
    int64, so recording never allocates and two histograms merge by
    summing counts. `percentile(p)` is the upper bound of the bucket that
    holds the p-th value, clamped to the observed max: exact within a
    factor of 2 (runtime/trace.py reads p50/p95/p99 from it)."""

    N_BUCKETS = 64

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self.counts = [0] * self.N_BUCKETS
        self.count = 0
        self.total = 0
        self.vmin: Optional[int] = None
        self.vmax: Optional[int] = None

    @staticmethod
    def bucket_index(value: int) -> int:
        v = int(value)
        if v <= 0:
            return 0
        return min(v.bit_length(), Histogram.N_BUCKETS - 1)

    @staticmethod
    def bucket_upper_bound(index: int) -> int:
        """Exclusive upper bound of bucket `index` (1 for bucket 0)."""
        return 1 << max(index, 0)

    def record(self, value: int) -> None:
        v = int(value)
        i = self.bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += v
            if self.vmin is None or v < self.vmin:
                self.vmin = v
            if self.vmax is None or v > self.vmax:
                self.vmax = v

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other` into self (the same layout, so a plain sum)."""
        o = other.snapshot()
        with self._lock:
            for i, n in enumerate(o["counts"]):
                self.counts[i] += n
            self.count += o["count"]
            self.total += o["total"]
            if o["min"] is not None:
                self.vmin = (o["min"] if self.vmin is None
                             else min(self.vmin, o["min"]))
            if o["max"] is not None:
                self.vmax = (o["max"] if self.vmax is None
                             else max(self.vmax, o["max"]))
        return self

    def percentile(self, p: float) -> Optional[int]:
        """Upper bound of the bucket holding the p-th percentile value,
        clamped to the observed max (None when empty)."""
        with self._lock:
            if not self.count:
                return None
            rank = max(1, -(-int(self.count * p) // 100))  # ceil
            seen = 0
            for i, n in enumerate(self.counts):
                seen += n
                if seen >= rank:
                    return min(self.bucket_upper_bound(i), self.vmax)
            return self.vmax

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            nonzero: List[Tuple[int, int]] = [
                (i, n) for i, n in enumerate(self.counts) if n]
            return {
                "name": self.name, "count": self.count, "total": self.total,
                "min": self.vmin, "max": self.vmax,
                "mean": (self.total / self.count) if self.count else None,
                "counts": list(self.counts),
                "buckets": {f"<{self.bucket_upper_bound(i)}": n
                            for i, n in nonzero},
            }

    def summary(self) -> str:
        """One line 'name: n= p50= p95= p99= max=' ('' when empty)."""
        snap = self.snapshot()
        if not snap["count"]:
            return ""
        return (f"{self.name}: n={snap['count']} p50={self.percentile(50)} "
                f"p95={self.percentile(95)} p99={self.percentile(99)} "
                f"max={snap['max']}")
