"""Compile service: build telemetry, the shape registry, manifest, pre-warm.

Port of blaze_tpu/runtime/compile_service.py, with its names. What a
compile is differs. The JAX module counts XLA compiles of jitted programs;
PyTorch runs eagerly and compiles nothing per shape, so here a compile is
one of the port's real builds, each reported through `note_build`:

* **Builds** — the `nvcc` build of each CUDA kernel library
  (`kernels.build_all`) and the `g++` build of the native library
  (`native`). A build is key ("kernel_build", name): a "miss" then a
  "compiled" event with its wall ns (compile_count, compile_ns); a library
  already on disk under its source hash is a "hit". cache_hits and
  cache_misses also sum runtime/jit_cache.py's events (the per-plan
  callables the executor and the stage compiler reuse across tasks).

* **Whole-stage coverage** — stage_attempts and stage_compiled count the
  stage compiler's attempts and its completed dense and chain stages
  (runtime/stage_compiler.try_run_stage), whole_stage_coverage_pct their
  ratio, as in the JAX module.

* **Canonicalization is inert.** `canonical_capacity` and
  `canonical_batch_count` are the JAX module's pure functions, but
  `canonical_batch` and `pad_batch_list` return their input unchanged and
  add no canonicalization_waste_rows: padding exists to share one XLA
  program between shapes, an eager program has no per-shape compile, and
  padding q02's dense stage from 48 batches to canonical_batch_count(48)
  == 64 would cost 16 empty kernel launches for nothing. The knobs stay
  registered (config.py).

* **Shape registry + manifest** — every observed key (hits, misses, build
  ns, a replay payload for sort shapes) in the JAX module's manifest
  format, versioned by an engine fingerprint, kept in the port's build
  directory next to the libraries.

* **Pre-warm driver** — ``python -m blaze_tpu_torch.runtime.compile_service
  --warm`` builds every library first (the only state that persists across
  processes), then replays the manifest's sort shapes and runs the TPC-DS
  catalogue's (query, join-mode) cells on the card, which warms only this
  process.

* **Telemetry** — a process-global `MetricsSet` exported as an extra
  `MetricNode` child by `executor.metric_tree`, as a summary line by the
  trace reports, as runtime/monitor.py's compile_* roll-up keys and
  sampler gauges and as the blaze_compile_* series on /metrics.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch.config import conf
from blaze_tpu_torch.runtime import jit_cache, trace
from blaze_tpu_torch.runtime.metrics import MetricNode, MetricsSet

# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

TELEMETRY = MetricsSet()
# MetricsSet seeds operator-centric counters; the service's set is its own
# namespace, so start clean
TELEMETRY.reset()

_COUNTERS = (
    "compile_count", "compile_ns", "cache_hits", "cache_misses",
    "canonicalization_waste_rows", "stage_attempts", "stage_compiled",
)
for _c in _COUNTERS:
    TELEMETRY.values[_c] = 0
TELEMETRY.values["whole_stage_coverage_pct"] = 0


def telemetry_node() -> MetricNode:
    """The service metrics as a MetricNode (appended by metric_tree); no
    handler of its own."""
    return MetricNode(TELEMETRY, [])


def _coverage_update() -> None:
    # read-modify-write of two counters under the set's lock, so a
    # concurrent add() cannot interleave
    with TELEMETRY._lock:
        att = TELEMETRY.values.get("stage_attempts", 0)
        if att:
            TELEMETRY.values["whole_stage_coverage_pct"] = round(
                100 * TELEMETRY.values.get("stage_compiled", 0) / att)


def note_stage_attempt() -> None:
    TELEMETRY.add("stage_attempts", 1)
    _coverage_update()


def note_stage_compiled() -> None:
    TELEMETRY.add("stage_compiled", 1)
    _coverage_update()


def telemetry_summary() -> str:
    """One-line counter summary for the trace reports ('' when idle)."""
    v = TELEMETRY.snapshot()
    if not (v.get("compile_count") or v.get("cache_hits")
            or v.get("cache_misses")):
        return ""
    return ("compile_service: compiles={compile_count} "
            "compile_ms={ms:.1f} hits={cache_hits} misses={cache_misses} "
            "waste_rows={canonicalization_waste_rows} "
            "stage_coverage={whole_stage_coverage_pct}%".format(
                ms=v.get("compile_ns", 0) / 1e6,
                **{c: v.get(c, 0) for c in
                   _COUNTERS + ("whole_stage_coverage_pct",)}))


@contextlib.contextmanager
def task_scope(metrics: MetricsSet):
    """Attribute service-counter deltas inside the scope to `metrics`
    under the same names."""
    before = TELEMETRY.snapshot()
    try:
        yield metrics
    finally:
        after = TELEMETRY.snapshot()
        for k in _COUNTERS:
            d = after.get(k, 0) - before.get(k, 0)
            if d:
                metrics.add(k, d)


def note_build(name: str, ns: Optional[int]) -> None:
    """Report one library of the port to the registry: built now in `ns`
    wall nanoseconds (a miss, then its compile), or found on disk under its
    source hash (`ns` None: a hit)."""
    key = ("kernel_build", name)
    if ns is None:
        _observer("hit", key, 0)
        return
    _observer("miss", key, 0)
    _observer("compiled", key, int(ns))


# --------------------------------------------------------------------------
# canonicalization policy (inert in the port: see the module docstring)
# --------------------------------------------------------------------------

def canonical_capacity(n: int) -> int:
    """The JAX module's canonical capacity bucket for `n` rows: the plain
    power-of-two bucket up to conf.canonical_pow2_limit, power-of-four
    rungs anchored at the limit above it."""
    from blaze_tpu_torch.columnar.batch import bucket_capacity

    cap = bucket_capacity(n)
    limit = int(conf.canonical_pow2_limit)
    if not conf.enable_compile_canonicalization or cap <= limit or limit <= 0:
        return cap
    base_exp = limit.bit_length() - 1
    exp = cap.bit_length() - 1
    if (exp - base_exp) % 2:
        exp += 1
    return 1 << exp


def canonical_batch_count(n: int) -> int:
    """The JAX module's rung for a whole-stage batch count: exact up to 2,
    power-of-two above."""
    if not conf.enable_compile_canonicalization or n <= 2:
        return n
    r = 4
    while r < n:
        r <<= 1
    return r


def canonical_batch(batch, kind: str, raw_rows: Optional[int] = None):
    """`batch` unchanged: the port pads no batch to a canonical rung."""
    return batch


def pad_batch_list(batches: tuple, kind: str = "stage") -> tuple:
    """`batches` unchanged: the port adds no zero-row batches."""
    return batches


# --------------------------------------------------------------------------
# shape registry + manifest
# --------------------------------------------------------------------------

_REPLAYABLE_KINDS = frozenset((
    "BOOLEAN", "INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
    "STRING", "BINARY", "DATE", "TIMESTAMP", "DECIMAL",
))

MANIFEST_VERSION = 1
_RAW_SHAPE_CAP = 4096  # bound per-kind raw-shape sets in the manifest


def fingerprint() -> str:
    """Engine/config fingerprint versioning the manifest: entries recorded
    under one engine version, torch build or shape-relevant config do not
    warm another."""
    import hashlib

    import torch

    import blaze_tpu_torch

    payload = {
        "engine": blaze_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "min_capacity": conf.min_capacity,
        "min_string_width": conf.min_string_width,
        "batch_size": conf.batch_size,
        "dense_agg_range": conf.dense_agg_range,
        "float_sum_digit_planes": conf.float_sum_digit_planes,
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def default_manifest_path() -> Optional[str]:
    """BLAZE_TPU_COMPILE_MANIFEST ("off" disables), else
    `compile_manifest.json` in the port's build directory."""
    env = os.environ.get("BLAZE_TPU_COMPILE_MANIFEST", "")
    if env == "off":
        return None
    if env:
        return env
    from blaze_tpu_torch import kernels

    return str(kernels.BUILD_DIR / "compile_manifest.json")


def _kind_of(key) -> str:
    return key[0] if (isinstance(key, tuple) and key
                      and isinstance(key[0], str)) else "other"


class ShapeRegistry:
    """In-process record of every key seen: kind, hit/miss counts, build
    time, source, and (for sort shapes) a host-reconstructible replay
    payload. Thread-safe; serializes to the manifest JSON."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.entries: Dict[str, Dict[str, Any]] = {}
        # kind -> {"raw": set(caps), "canonical": set(caps), "raw_rows": set}
        self.canonical: Dict[str, Dict[str, set]] = {}
        self.dirty = False

    # -- jit_cache observer protocol -----------------------------------
    def observe(self, event: str, key, ns: int) -> None:
        kind = _kind_of(key)
        kid = repr(key)
        with self._lock:
            e = self.entries.get(kid)
            if e is None:
                e = self.entries[kid] = {
                    "kind": kind, "source": kind, "hits": 0, "misses": 0,
                    "compile_ns": 0, "replay": None,
                }
            if event == "hit":
                e["hits"] += 1
                TELEMETRY.add("cache_hits", 1)
            elif event == "miss":
                e["misses"] += 1
                TELEMETRY.add("cache_misses", 1)
            elif event == "compiled":
                e["compile_ns"] += int(ns)
                TELEMETRY.add("compile_count", 1)
                TELEMETRY.add("compile_ns", int(ns))
            self.dirty = True
        # after the registry lock: the trace log has its own lock and
        # events inherit the calling thread's query/stage/task context
        if event == "compiled":
            trace.event("compile_compiled", op_kind=kind,
                        compile_ns=int(ns))
        elif event in ("hit", "miss"):
            trace.event(f"compile_{event}", op_kind=kind)

    def attach_replay(self, key, payload: Dict[str, Any],
                      source: str) -> None:
        kid = repr(key)
        with self._lock:
            e = self.entries.setdefault(kid, {
                "kind": _kind_of(key), "source": source,
                "hits": 0, "misses": 0, "compile_ns": 0, "replay": None,
            })
            e["source"] = source
            if e["replay"] is None:
                e["replay"] = payload
            self.dirty = True

    # -- stats ----------------------------------------------------------
    def shape_reduction(self) -> Dict[str, Dict[str, int]]:
        """Per-kind distinct raw vs canonical shape counts (empty in the
        port, which canonicalizes nothing)."""
        out = {}
        with self._lock:
            for kind, c in self.canonical.items():
                out[kind] = {
                    "raw_capacities": len(c["raw"]),
                    "raw_rowcounts": len(c["raw_rows"]),
                    "canonical_capacities": len(c["canonical"]),
                }
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            per_kind: Dict[str, Dict[str, int]] = {}
            for e in self.entries.values():
                k = per_kind.setdefault(
                    e["kind"], {"programs": 0, "compile_ns": 0,
                                "hits": 0, "misses": 0})
                k["programs"] += 1
                k["compile_ns"] += e["compile_ns"]
                k["hits"] += e["hits"]
                k["misses"] += e["misses"]
        return {"programs": sum(v["programs"] for v in per_kind.values()),
                "per_kind": per_kind,
                "shape_reduction": self.shape_reduction()}

    # -- persistence -----------------------------------------------------
    def to_manifest(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "version": MANIFEST_VERSION,
                "fingerprint": fingerprint(),
                "entries": {k: dict(v) for k, v in self.entries.items()},
                "canonical": {
                    kind: {ax: sorted(vals) for ax, vals in c.items()}
                    for kind, c in self.canonical.items()},
            }

    def merge_manifest(self, doc: Dict[str, Any]) -> int:
        """Merge a loaded manifest; returns entries merged (0 on a version
        or fingerprint mismatch)."""
        if not isinstance(doc, dict) or doc.get("version") != MANIFEST_VERSION:
            return 0
        if doc.get("fingerprint") != fingerprint():
            return 0
        n = 0
        with self._lock:
            for kid, e in (doc.get("entries") or {}).items():
                cur = self.entries.get(kid)
                if cur is None:
                    self.entries[kid] = dict(e)
                else:
                    cur["hits"] += e.get("hits", 0)
                    cur["misses"] += e.get("misses", 0)
                    cur["compile_ns"] = max(cur["compile_ns"],
                                            e.get("compile_ns", 0))
                    if cur["replay"] is None:
                        cur["replay"] = e.get("replay")
                n += 1
            for kind, c in (doc.get("canonical") or {}).items():
                mine = self.canonical.setdefault(
                    kind,
                    {"raw": set(), "canonical": set(), "raw_rows": set()})
                for ax in ("raw", "canonical", "raw_rows"):
                    mine[ax].update(c.get(ax, ()))
        return n

    def load(self, path: Optional[str] = None) -> int:
        path = path or default_manifest_path()
        if not path or not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0
        return self.merge_manifest(doc)

    def persist(self, path: Optional[str] = None) -> Optional[str]:
        path = path or default_manifest_path()
        if not path:
            return None
        doc = self.to_manifest()
        if not doc["entries"] and not doc["canonical"]:
            return None
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp.%d" % os.getpid()
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self.dirty = False
        return path


_REGISTRY = ShapeRegistry()


def registry() -> ShapeRegistry:
    return _REGISTRY


def _observer(event: str, key, ns: int) -> None:
    try:
        _REGISTRY.observe(event, key, ns)
    except Exception:
        pass  # telemetry must never break a build or a cache lookup


jit_cache.set_observer(_observer)


# --------------------------------------------------------------------------
# sort-shape recording + replay
# --------------------------------------------------------------------------

def record_sort_shape(key, batch, specs) -> None:
    """Record a host-reconstructible payload for a sort shape (the JAX
    module's manifest format), so `warm` can rebuild an equivalent batch
    in a fresh process and replay the sort."""
    try:
        cols = []
        for f, c in zip(batch.schema, batch.columns):
            k = f.dtype.kind.name
            if k not in _REPLAYABLE_KINDS or f.dtype.wide_decimal:
                return  # nested and wide shapes are not replayable
            col = {"name": f.name, "kind": k, "nullable": bool(f.nullable),
                   "valid": c.validity is not None}
            if k == "DECIMAL":
                col["precision"] = f.dtype.precision
                col["scale"] = f.dtype.scale
            if k in ("STRING", "BINARY"):
                col["width"] = int(c.data.width)
            cols.append(col)
        payload = {
            "type": "sort", "capacity": int(batch.capacity),
            "specs": [[int(s.col), bool(s.asc), bool(s.nulls_first)]
                      for s in specs],
            "cols": cols,
        }
        _REGISTRY.attach_replay(key, payload, "ops/sort_keys.sort_batch")
    except Exception:
        pass


def _rebuild_sort_batch(payload: Dict[str, Any], device=None):
    import numpy as np

    from blaze_tpu_torch.columnar import types as T
    from blaze_tpu_torch.columnar.batch import ColumnBatch

    cap = int(payload["capacity"])
    fields, data, validity = [], {}, {}
    for i, col in enumerate(payload["cols"]):
        kind = T.TypeKind[col["kind"]]
        if kind == T.TypeKind.DECIMAL:
            dt = T.decimal(col.get("precision", 18), col.get("scale", 0))
        else:
            dt = T.DataType(kind)
        name = col.get("name") or f"c{i}"
        fields.append(T.Field(name, dt, col.get("nullable", True)))
        if kind in (T.TypeKind.STRING, T.TypeKind.BINARY):
            w = int(col.get("width", conf.min_string_width))
            # one max-width value pins the width bucket; vary the rest so
            # the sort is not degenerate
            data[name] = ["x" * w] + ["k%04d" % (j % 97)
                                     for j in range(1, cap)]
        elif kind == T.TypeKind.BOOLEAN:
            data[name] = (np.arange(cap) % 2).astype(bool)
        else:
            data[name] = (np.arange(cap) % 251).astype(dt.np_dtype())
        if col.get("valid"):
            validity[name] = (np.arange(cap) % 5 != 0)
    return ColumnBatch.from_numpy(data, T.Schema(fields), capacity=cap,
                                  validity=validity or None, device=device)


def replay_entry(entry: Dict[str, Any], device=None) -> bool:
    """Re-run the sort recorded in a manifest entry on `device` (None:
    the card). Returns True when a replay ran."""
    payload = entry.get("replay")
    if not payload or payload.get("type") != "sort":
        return False
    from blaze_tpu_torch.ops.sort_keys import SortSpec, sort_batch
    from blaze_tpu_torch.runtime.metrics import to_host

    batch = _rebuild_sort_batch(payload, device)
    specs = [SortSpec(c, a, nf) for c, a, nf in payload["specs"]]
    to_host(sort_batch(batch, specs).num_rows)  # the sort has run
    return True


# --------------------------------------------------------------------------
# pre-warm driver
# --------------------------------------------------------------------------

class _Budget:
    def __init__(self, seconds: Optional[float]) -> None:
        self.t0 = time.monotonic()
        self.seconds = seconds

    def spent(self) -> float:
        return time.monotonic() - self.t0

    def exhausted(self) -> bool:
        return self.seconds is not None and self.spent() >= self.seconds


def _build_libraries(device, progress) -> Dict[str, Any]:
    """Build (or find on disk) every library of the port: the CUDA kernels
    when running on the card, and the native library. A native build that
    fails is reported, not raised: the engine runs without it."""
    from blaze_tpu_torch import kernels, native
    from blaze_tpu_torch.device import resolve_device

    out: Dict[str, Any] = {}
    if resolve_device(device).type == "cuda":
        names = sorted(kernels.SIGNATURES)
        kernels.build_all(names)
        for name in names:
            kernels.load(name)
        out["kernels"] = names
    out["native"] = native.available()
    progress(f"[warm] libraries: kernels={out.get('kernels', [])} "
             f"native={'built' if out['native'] else native.build_error()}")
    return out


def warm(manifest_path: Optional[str] = None,
         queries: Optional[List[str]] = None,
         rows: int = 20_000,
         modes: Tuple[str, ...] = ("bhj", "smj"),
         budget_seconds: Optional[float] = None,
         skip_catalogue: bool = False,
         num_partitions: int = 4,
         progress=print,
         device=None) -> Dict[str, Any]:
    """Build every library, then replay the manifest's sort shapes and run
    the TPC-DS catalogue's (query, mode) cells on `device` (None: the
    card). Honors `budget_seconds` between items."""
    import tempfile

    budget = _Budget(budget_seconds)
    stats = {"replayed_shapes": 0, "skipped_shapes": 0, "cells_run": 0,
             "cells_failed": 0, "stopped_early": False, "seconds": 0.0}
    stats["libraries"] = _build_libraries(device, progress)

    manifest_path = manifest_path or default_manifest_path()
    merged = _REGISTRY.load(manifest_path)
    progress(f"[warm] manifest: {manifest_path or '(disabled)'} "
             f"({merged} entries)")

    for kid, entry in sorted(_REGISTRY.entries.items()):
        if budget.exhausted():
            stats["stopped_early"] = True
            break
        try:
            if replay_entry(entry, device):
                stats["replayed_shapes"] += 1
                progress(f"[warm] shape {entry['kind']} "
                         f"cap={entry['replay']['capacity']} "
                         f"({budget.spent():.1f}s)")
            else:
                stats["skipped_shapes"] += 1
        except Exception as e:  # a stale shape must not kill the warm run
            stats["skipped_shapes"] += 1
            progress(f"[warm] shape replay failed ({e!r})")

    if not skip_catalogue and not stats["stopped_early"]:
        from blaze_tpu_torch.spark import tpcds
        from blaze_tpu_torch.spark.local_runner import run_plan

        with tempfile.TemporaryDirectory(prefix="blaze_warm_") as td:
            paths, frames = tpcds.generate_tables(td, rows=rows)
            for name, mode in tpcds.warm_cells(queries, modes):
                if budget.exhausted():
                    stats["stopped_early"] = True
                    break
                t0 = time.monotonic()
                try:
                    plan, _oracle = tpcds.QUERIES[name](paths, frames, mode)
                    run_plan(plan, num_partitions=num_partitions,
                             device=device)
                    stats["cells_run"] += 1
                    progress(f"[warm] {name}/{mode} rows={rows} "
                             f"{time.monotonic() - t0:.1f}s "
                             f"(total {budget.spent():.1f}s)")
                except Exception as e:
                    stats["cells_failed"] += 1
                    progress(f"[warm] {name}/{mode} FAILED: {e!r}")

    saved = _REGISTRY.persist(manifest_path)
    stats["seconds"] = round(budget.spent(), 2)
    stats["manifest"] = saved or manifest_path
    stats["telemetry"] = TELEMETRY.snapshot()
    stats["shape_reduction"] = _REGISTRY.shape_reduction()
    progress(f"[warm] done: {stats['replayed_shapes']} shapes, "
             f"{stats['cells_run']} cells in {stats['seconds']}s"
             + (" (budget hit)" if stats["stopped_early"] else ""))
    return stats


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="blaze_tpu_torch.runtime.compile_service",
        description="Build the port's libraries and pre-warm this process "
                    "from the shape manifest and the TPC-DS catalogue.")
    p.add_argument("--warm", action="store_true",
                   help="run the pre-warm driver (the only verb for now)")
    p.add_argument("--manifest", default=None,
                   help="manifest path (default: in the build directory)")
    p.add_argument("--queries", default=None,
                   help="comma-separated catalogue queries (default: all)")
    p.add_argument("--rows", type=int, default=20_000,
                   help="catalogue scale in rows per table (default 20000)")
    p.add_argument("--modes", default="bhj,smj",
                   help="join modes to enumerate (default bhj,smj)")
    p.add_argument("--budget-seconds", type=float, default=None,
                   help="stop starting new items past this many seconds")
    p.add_argument("--skip-catalogue", action="store_true",
                   help="build the libraries and replay manifest shapes "
                        "only")
    p.add_argument("--num-partitions", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device to warm on (default: the CUDA card)")
    p.add_argument("--json-out", default=None,
                   help="write the warm stats JSON here")
    args = p.parse_args(argv)

    if not args.warm:
        p.error("nothing to do: pass --warm")
    queries = args.queries.split(",") if args.queries else None
    stats = warm(manifest_path=args.manifest, queries=queries,
                 rows=args.rows,
                 modes=tuple(m for m in args.modes.split(",") if m),
                 budget_seconds=args.budget_seconds,
                 skip_catalogue=args.skip_catalogue,
                 num_partitions=args.num_partitions,
                 device=args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True, default=str)
    return 0


if __name__ == "__main__":  # pragma: no cover - thin shim
    import sys

    # re-import under the canonical module name so the registry and the
    # observer the engine uses are the same objects this CLI reads
    from blaze_tpu_torch.runtime import compile_service as _cs

    sys.exit(_cs.main())
