"""Durable exactly-once micro-batch streaming.

Port of blaze_tpu/runtime/streaming.py whole. A stream's micro-batches
run the port's run_plan on `device` (None: the CUDA card; the tests pass
"cpu"), through the service when one is attached. The partial
aggregate of each batch takes the whole-stage dense route, and so the
accumulate kernel, where the stage compiler accepts its keys; else the
streaming AggExec. Each result batch leaves the device in one pull
(serde.to_host, counted by metrics.to_host) and merges into the state as
Python scalars, so the state holds no device tensor. The device is not
journaled: `resume_stream` takes it again.

A `StreamingQuery` turns the batch engine into a long-lived incremental
aggregation: a `TailSource` tails a growing parquet directory (new
immutable files published by rename, the classic micro-batch file-source
contract), each tick's unconsumed files become one micro-batch plan —
scan -> partial hash agg -> shuffle -> final hash agg — run through the
EXISTING driver path (pipeline, supervisor, executor pool, service
admission), and the per-batch partial aggregates are merged into the
stream's in-memory state with associative merge functions (sum / count /
min / max), so the state after N batches equals one batch over the full
input.

The robustness headline is the checkpoint protocol. After a micro-batch
commits, `(consumed source offsets, serialized aggregation state, batch
epoch)` travel together in ONE `stream_checkpoint` record appended
crash-atomically through runtime/journal.py (heal torn tail -> write ->
flush -> fsync). Because offsets and state are atomic, every crash —
executor SIGKILL mid-batch, driver SIGKILL mid-checkpoint, standby
takeover — resumes EXACTLY-ONCE by construction:

  * a crash BEFORE the checkpoint re-processes the in-flight batch from
    the previous checkpoint's offsets INTO the previous checkpoint's
    state — nothing was merged twice, nothing dropped;
  * a crash MID-checkpoint leaves a torn tail that `load_records` skips
    and the next append heals — recovery falls back to the last
    parseable checkpoint, same story;
  * a crash AFTER the checkpoint resumes past the committed batch — no
    batch is ever re-emitted (checkpoint epochs are strictly monotone).

Stream journals are never billed `driver_restart` by the recovery scan
and never pruned by retention until a GRACEFUL stop settles them
(journal.is_stream / _stream_settled): they are ADOPTED — the scan
registers dead-writer stream journals, standby takeover reports them,
and `resume_stream()` reconstructs the TailSource + StreamSpec from the
journal's `stream_open` record and picks up at the last checkpoint.

Knobs: `stream_poll_ms` (tick cadence when caught up),
`stream_checkpoint_interval` (batches per fsync),
`stream_max_lag_ms` (lag objective: sustained lag past it cuts a
`stream_stall` flight dossier once per stream and a doctor `stream_lag`
finding).
"""

from __future__ import annotations

import json
import fnmatch
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs.ir import col
from blaze_tpu_torch.runtime import faults, journal, trace
from blaze_tpu_torch.spark import plan_model as P

__all__ = ["TailSource", "StreamSpec", "StreamingQuery", "open_stream",
           "resume_stream", "adoptable_streams", "stream_stats",
           "live_streams", "reset"]

_DTYPES = {"int32": T.INT32, "int64": T.INT64,
           "float64": T.FLOAT64, "string": T.STRING}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}

_registry_lock = threading.Lock()
_streams: Dict[str, "StreamingQuery"] = {}


def _is_missing(v: Any) -> bool:
    """None / NaN — parquet nulls surface as either depending on the
    column's numpy dtype."""
    if v is None:
        return True
    try:
        return math.isnan(v)
    except TypeError:
        return False


def _scalar(v: Any) -> Any:
    """JSON-able python scalar from a numpy/arrow cell value."""
    if _is_missing(v):
        return None
    if isinstance(v, bytes):
        return v.decode()
    if hasattr(v, "item"):
        return v.item()
    return v


# merge(state_value, batch_value) -> state_value; batch_value is the
# partial aggregate over THIS batch's new rows only, so merging is exact
# for any associative fn. A missing batch value (all-null group) leaves
# the state untouched; a missing state value adopts the batch value —
# this reproduces pandas sum(min_count=1) semantics at the stream level.
_MERGE = {
    "sum": lambda s, b: b if s is None else (s if b is None else s + b),
    "count": lambda s, b: (s or 0) + (b or 0),
    "min": lambda s, b: b if s is None else (s if b is None else min(s, b)),
    "max": lambda s, b: b if s is None else (s if b is None else max(s, b)),
}


def _host_rows(batch) -> Dict[str, Any]:
    """A result batch's rows on the host, as ColumnBatch.to_numpy gives
    them, in one device->host pull (the ordered collect's cached rows
    when it already pulled them)."""
    cached = getattr(batch, "_host_numpy", None)
    if cached is not None:
        return cached
    from blaze_tpu_torch.columnar import serde
    from blaze_tpu_torch.ops import host_sort

    return host_sort.host_to_pylike(serde.to_host(batch))


class StreamSpec:
    """Serializable incremental group-by aggregation spec.

    keys: [{"col": input column, "name": output name}]
    aggs: [{"fn": sum|count|min|max, "col": input column,
            "name": output name}] — mergeable fns only (derive avg from
    sum/count downstream; a non-associative fn cannot be checkpointed as
    per-group scalars).

    The spec round-trips through JSON (`to_doc`/`from_doc`) so a stream
    can be reconstructed from its journal's `stream_open` record at
    adoption time, by a process that never saw the original plan."""

    def __init__(self, schema: T.Schema, keys: List[Dict[str, str]],
                 aggs: List[Dict[str, str]]) -> None:
        if not keys or not aggs:
            raise ValueError("StreamSpec needs >= 1 key and >= 1 agg")
        for a in aggs:
            if a["fn"] not in _MERGE:
                raise ValueError(
                    f"agg fn {a['fn']!r} is not mergeable "
                    f"(have: {sorted(_MERGE)})")
        self.schema = schema
        self.keys = [dict(k) for k in keys]
        self.aggs = [dict(a) for a in aggs]

    # -- serialization ---------------------------------------------------

    def to_doc(self) -> Dict[str, Any]:
        return {
            "fields": [{"name": f.name, "dtype": _DTYPE_NAMES[f.dtype]}
                       for f in self.schema.fields],
            "keys": [dict(k) for k in self.keys],
            "aggs": [dict(a) for a in self.aggs],
        }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "StreamSpec":
        schema = T.Schema([T.Field(f["name"], _DTYPES[f["dtype"]])
                           for f in doc["fields"]])
        return cls(schema, doc["keys"], doc["aggs"])

    # -- plan construction ----------------------------------------------

    def _dtype_of(self, name: str) -> T.DataType:
        return self.schema.fields[self.schema.index_of(name)].dtype

    def _agg_dtype(self, a: Dict[str, str]) -> T.DataType:
        return T.INT64 if a["fn"] == "count" else self._dtype_of(a["col"])

    def key_names(self) -> List[str]:
        return [k["name"] for k in self.keys]

    def agg_names(self) -> List[str]:
        return [a["name"] for a in self.aggs]

    def build_plan(self, files: List[str], shuffle_parts: int):
        """The per-batch plan over exactly `files`: two-phase hash agg
        with a shuffle on the first key (the q2 shape, validator.py)."""
        sc = P.scan(self.schema, [(p, []) for p in files])
        group = [col(k["col"]) for k in self.keys]
        names = self.key_names()
        key_fields = [T.Field(k["name"], self._dtype_of(k["col"]))
                      for k in self.keys]
        aggs = [{"fn": a["fn"], "args": [col(a["col"])],
                 "dtype": self._agg_dtype(a), "name": a["name"]}
                for a in self.aggs]
        partial = P.hash_agg(sc, "partial", group, names, aggs,
                             T.Schema(key_fields))
        x = P.shuffle_exchange(partial, [col(names[0])], shuffle_parts)
        final_fields = key_fields + [T.Field(a["name"], self._agg_dtype(a))
                                     for a in self.aggs]
        return P.hash_agg(x, "final", group, names, aggs,
                          T.Schema(final_fields))


class TailSource:
    """Tails a growing directory of immutable parquet files.

    Contract (Spark FileStreamSource posture): writers publish each file
    ATOMICALLY (write a temp name, os.rename into place) and never
    append to a published file — so a file name is a complete, immutable
    unit of input and `{file name: row count}` is a complete offset.
    `publish()` wraps that idiom for producers."""

    def __init__(self, directory: str, pattern: str = "*.parquet") -> None:
        self.directory = directory
        self.pattern = pattern

    def _matched(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(n for n in names if fnmatch.fnmatch(n, self.pattern))

    def discover(self, consumed: Dict[str, int]) -> List[str]:
        """Basenames of published-but-unconsumed files, oldest-first
        (name order — producers number their files)."""
        return [n for n in self._matched() if n not in consumed]

    def lag_ms(self, consumed: Dict[str, int],
               now: Optional[float] = None) -> float:
        """End-to-end lag: age of the OLDEST unconsumed file (0 when
        caught up) — the stream's watermark distance."""
        pending = self.discover(consumed)
        if not pending:
            return 0.0
        now = time.time() if now is None else now
        oldest = min(self._mtime(n) for n in pending)
        return max(now - oldest, 0.0) * 1000.0

    def _mtime(self, name: str) -> float:
        try:
            return os.path.getmtime(os.path.join(self.directory, name))
        except OSError:
            return time.time()

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def rows_in(self, name: str) -> int:
        import pyarrow.parquet as pq

        return int(pq.ParquetFile(self.path(name)).metadata.num_rows)

    def publish(self, name: str, table) -> str:
        """Producer helper: write `table` (pyarrow Table) under a temp
        name, fsync-rename into `name` — readers never see a torn file."""
        import pyarrow.parquet as pq

        os.makedirs(self.directory, exist_ok=True)
        final = self.path(name)
        tmp = final + ".inprogress"
        pq.write_table(table, tmp)
        os.rename(tmp, final)
        return final

    def to_doc(self) -> Dict[str, str]:
        return {"directory": self.directory, "pattern": self.pattern}

    @classmethod
    def from_doc(cls, doc: Dict[str, str]) -> "TailSource":
        return cls(doc["directory"], doc.get("pattern", "*.parquet"))


class StreamingQuery:
    """One long-lived micro-batch aggregation with durable checkpoints.

    Construct (or `service.open_stream(...)` / `resume_stream(...)`),
    then `.start()`. Each micro-batch runs through `service.run()` when
    a QueryService is attached — admission weight, per-tenant quota,
    fair scheduling and per-batch SLO scoring all apply to every batch —
    else directly through local_runner.run_plan. `result_rows()` is the
    current aggregation state; `stop()` ends the loop (graceful=True
    settles the journal so retention may prune it; graceful=False leaves
    it adoptable)."""

    def __init__(self, stream_id: str, source: TailSource, spec: StreamSpec,
                 tenant_id: str = "", service=None, num_partitions: int = 2,
                 shuffle_parts: int = 2, work_dir: Optional[str] = None,
                 mesh_exchange: str = "off",
                 journal_dir: Optional[str] = None,
                 device=None) -> None:
        self.stream_id = stream_id
        self.device = device
        self.source = source
        self.spec = spec
        self.tenant_id = tenant_id
        self.service = service
        self.num_partitions = num_partitions
        self.shuffle_parts = shuffle_parts
        self.work_dir = work_dir
        self.mesh_exchange = mesh_exchange
        self._journal_dir = journal_dir or conf.journal_dir
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # exactly-once core: offsets + state + epoch move together, in
        # memory here and on disk in one checkpoint record
        self.offsets: Dict[str, int] = {}
        self.state: Dict[Tuple, Dict[str, Any]] = {}
        self.epoch = 0
        self.rows_total = 0
        self.batches_total = 0
        self.batch_failures = 0
        self.resumed_batches = 0
        self.resumed_from_epoch: Optional[int] = None
        self.checkpoint_bytes = 0
        self.last_checkpoint_epoch = 0
        self.lag_ms = 0.0
        self._prev_lag_ms = 0.0
        self._resumed = False
        self._journal: Optional[journal.QueryJournal] = None
        self.error: Optional[str] = None
        # one entry a committed micro-batch (port-only): its epoch,
        # files, the stage compiler's routes, kernel launches and wall ms
        self.batch_log: List[Dict[str, Any]] = []

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "StreamingQuery":
        if self._journal_dir:
            jnl = journal.QueryJournal(self.stream_id, self._journal_dir)
            resumed = self._restore_from_checkpoint(jnl)
            # pid re-stamp: the LAST admitted record is the liveness tag
            # the recovery scan keys on, so an adopter owns the journal
            jnl.admitted(tenant_id=self.tenant_id)
            jnl.record(
                "stream_open", pid=os.getpid(), tenant_id=self.tenant_id,
                spec=self.spec.to_doc(), source=self.source.to_doc(),
                num_partitions=self.num_partitions,
                shuffle_parts=self.shuffle_parts,
                mesh_exchange=self.mesh_exchange,
                resumed_from_epoch=resumed)
        with _registry_lock:
            _streams[self.stream_id] = self
        if conf.progress_enabled:
            from blaze_tpu_torch.runtime import progress

            progress.begin_stream(self.stream_id, self.tenant_id)
        self._thread = threading.Thread(
            target=self._loop, name=f"blz-stream-{self.stream_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, graceful: bool = True, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)
        if graceful:
            with self._lock:
                if self._journal is not None:
                    if self.epoch > self.last_checkpoint_epoch:
                        self._checkpoint_locked()
                    self._journal.complete("ok")
                    self._journal = None
        with _registry_lock:
            if _streams.get(self.stream_id) is self:
                del _streams[self.stream_id]
        if conf.progress_enabled:
            from blaze_tpu_torch.runtime import progress

            progress.finish_query(self.stream_id)

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- resume ----------------------------------------------------------

    def _restore_from_checkpoint(
            self, jnl: journal.QueryJournal) -> Optional[int]:
        """Adopt the last parseable checkpoint (torn tails were already
        skipped by load_records — the mid-checkpoint-SIGKILL fallback).
        Returns the restored epoch, or None if nothing was durable."""
        records = journal.load_records(jnl.path)
        ckpt = None
        for r in records:
            if r.get("kind") == "stream_checkpoint":
                ckpt = r
        with self._lock:
            self._journal = jnl
            if ckpt is None:
                return None
            self.offsets = {str(k): int(v)
                            for k, v in (ckpt.get("offsets") or {}).items()}
            self.state = {tuple(k): dict(v)
                          for k, v in (ckpt.get("state") or [])}
            self.epoch = int(ckpt.get("epoch", 0))
            self.last_checkpoint_epoch = self.epoch
            self.rows_total = int(ckpt.get("rows_total", 0))
            self.resumed_from_epoch = self.epoch
            self._resumed = True
            epoch, files = self.epoch, len(self.offsets)
            rows, groups = self.rows_total, len(self.state)
        trace.event("stream_resume", query_id=self.stream_id,
                    epoch=epoch, files_consumed=files,
                    rows_total=rows, groups=groups)
        return epoch

    # -- the micro-batch loop --------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                consumed = dict(self.offsets)
            new = self.source.discover(consumed)
            lag = self.source.lag_ms(consumed)
            with self._lock:
                self._prev_lag_ms, self.lag_ms = self.lag_ms, lag
            if conf.progress_enabled:
                from blaze_tpu_torch.runtime import progress

                progress.stream_lag(self.stream_id, lag)
            self._maybe_stall(lag, pending=len(new))
            if not new:
                self._stop.wait(max(conf.stream_poll_ms, 1) / 1000.0)
                continue
            try:
                self._run_batch(new, lag)
            except faults.AdmissionRejected:
                # shed batch: input stays unconsumed; lag grows until
                # admission relents (the stall dossier tells the story)
                self._stop.wait(max(conf.stream_poll_ms, 1) / 1000.0)
            except Exception as e:  # noqa: BLE001 — retry next tick
                with self._lock:
                    self.batch_failures += 1
                    self.error = f"{type(e).__name__}: {e}"
                self._stop.wait(max(conf.stream_poll_ms, 1) / 1000.0)
            # a successful batch loops straight back to discover so a
            # backlog drains at full speed, not one file per poll tick

    def _run_batch(self, names: List[str], lag: float) -> None:
        t0 = time.time()
        batch_rows = {n: self.source.rows_in(n) for n in names}
        plan = self.spec.build_plan([self.source.path(n) for n in names],
                                    self.shuffle_parts)
        with self._lock:
            epoch = self.epoch + 1
            prev_lag = self._prev_lag_ms
        run_info: Dict[str, Any] = {"stream": {
            "stream_id": self.stream_id, "epoch": epoch,
            "lag_ms": round(lag, 1),
            "prev_lag_ms": round(prev_lag, 1),
            "max_lag_ms": conf.stream_max_lag_ms,
            "files": len(names)}}
        if self.service is not None:
            out = self.service.run(
                plan, self.tenant_id, run_info=run_info,
                num_partitions=self.num_partitions,
                work_dir=self.work_dir, mesh_exchange=self.mesh_exchange,
                device=self.device)
        else:
            from blaze_tpu_torch.spark.local_runner import run_plan

            out = run_plan(plan, num_partitions=self.num_partitions,
                           work_dir=self.work_dir,
                           mesh_exchange=self.mesh_exchange,
                           run_info=run_info, device=self.device)
        rows = sum(batch_rows.values())
        batch_ms = (time.time() - t0) * 1000.0
        with self._lock:
            self._merge_locked(out)
            self.offsets.update(batch_rows)
            self.epoch = epoch
            self.rows_total += rows
            self.batches_total += 1
            self.batch_log.append({
                "epoch": epoch, "files": len(names), "rows": rows,
                "stage_compiled": run_info.get("stage_compiled", 0),
                "stage_fallbacks": run_info.get("stage_fallbacks", 0),
                "kernel_launches": run_info.get("kernel_launches", 0),
                "batch_ms": batch_ms})
            if self._resumed:
                self.resumed_batches += 1
            self.lag_ms = self.source.lag_ms(self.offsets)
            lag_now = self.lag_ms
            resumed = self._resumed
            due = (epoch - self.last_checkpoint_epoch
                   >= max(int(conf.stream_checkpoint_interval), 1))
            if due and self._journal is not None:
                self._checkpoint_locked()
        trace.event("stream_batch", query_id=self.stream_id, epoch=epoch,
                    rows=rows, files=len(names),
                    batch_ms=round(batch_ms, 1), lag_ms=round(lag, 1),
                    resumed=resumed)
        if conf.progress_enabled:
            from blaze_tpu_torch.runtime import progress

            progress.stream_batch(self.stream_id, epoch, rows, lag_now,
                                  batch_ms, resumed=resumed)

    def _merge_locked(self, batch) -> None:
        d = _host_rows(batch)
        keys = self.spec.key_names()
        n = len(next(iter(d.values()))) if d else 0
        for i in range(n):
            k = tuple(_scalar(d[name][i]) for name in keys)
            slot = self.state.setdefault(
                k, {a: None for a in self.spec.agg_names()})
            for a in self.spec.aggs:
                name = a["name"]
                slot[name] = _MERGE[a["fn"]](slot[name],
                                             _scalar(d[name][i]))

    # -- durability ------------------------------------------------------

    def _checkpoint_locked(self) -> None:
        """ONE crash-atomic record carrying offsets + state + epoch: the
        exactly-once invariant is that these three never part ways."""
        state_doc = [[list(k), v] for k, v in
                     sorted(self.state.items(),
                            key=lambda kv: json.dumps(kv[0], default=str))]
        fields = {"epoch": self.epoch, "offsets": dict(self.offsets),
                  "state": state_doc, "rows_total": self.rows_total}
        self.checkpoint_bytes = len(json.dumps(fields, default=str))
        self._journal.record("stream_checkpoint",
                             state_bytes=self.checkpoint_bytes, **fields)
        self.last_checkpoint_epoch = self.epoch
        trace.event("stream_checkpoint", query_id=self.stream_id,
                    epoch=self.epoch, state_bytes=self.checkpoint_bytes,
                    files_consumed=len(self.offsets),
                    groups=len(self.state))

    def _maybe_stall(self, lag: float, pending: int) -> None:
        """Sustained lag past the objective with work pending — cut ONE
        stream_stall dossier per stream (flight_recorder dedups on
        (query_id, trigger))."""
        if not pending or lag <= max(float(conf.stream_max_lag_ms), 0.0):
            return
        from blaze_tpu_torch.runtime import flight_recorder

        if not flight_recorder.enabled("stream_stall"):
            return
        with self._lock:
            epoch, failures = self.epoch, self.batch_failures
            last_error = self.error
        flight_recorder.capture(
            "stream_stall", self.stream_id, tenant_id=self.tenant_id or None,
            detail={"lag_ms": round(lag, 1),
                    "max_lag_ms": conf.stream_max_lag_ms,
                    "pending_files": pending, "epoch": epoch,
                    "batch_failures": failures,
                    "last_error": last_error})

    # -- introspection ---------------------------------------------------

    def result_rows(self) -> List[Dict[str, Any]]:
        """Current state as sorted rows (key cols + agg cols) — the
        stream-level answer a pandas replay of the full input must
        equal."""
        keys = self.spec.key_names()
        with self._lock:
            items = list(self.state.items())
        items.sort(key=lambda kv: json.dumps(kv[0], default=str))
        return [dict(zip(keys, k), **v) for k, v in items]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stream_id": self.stream_id,
                "tenant_id": self.tenant_id,
                "epoch": self.epoch,
                "lag_ms": round(self.lag_ms, 3),
                "batches_total": self.batches_total,
                "batch_failures": self.batch_failures,
                "rows_total": self.rows_total,
                "checkpoint_bytes": self.checkpoint_bytes,
                "resumed_batches": self.resumed_batches,
                "resumed_from_epoch": self.resumed_from_epoch,
                "files_consumed": len(self.offsets),
                "groups": len(self.state),
            }

    def wait_consumed(self, files: int, timeout: float = 60.0) -> bool:
        """Block until >= `files` source files are consumed AND
        checkpointed (or timeout) — the test/chaos synchronization
        point."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if (len(self.offsets) >= files
                        and self.last_checkpoint_epoch >= self.epoch):
                    return True
            if not self.alive():
                return False
            time.sleep(0.02)
        return False


# -- module-level registry / adoption ----------------------------------------


def live_streams() -> List[str]:
    with _registry_lock:
        return sorted(_streams)


def get(stream_id: str) -> Optional[StreamingQuery]:
    with _registry_lock:
        return _streams.get(stream_id)


def stream_stats() -> Dict[str, Dict[str, Any]]:
    """Per-live-stream counters for the monitor gauges
    (blaze_stream_lag_ms / _batches_total / _checkpoint_bytes) and the
    blaze_top streams rows."""
    with _registry_lock:
        streams = list(_streams.values())
    return {s.stream_id: s.stats() for s in streams}


def open_stream(source: TailSource, spec: StreamSpec, *,
                stream_id: Optional[str] = None, tenant_id: str = "",
                service=None, **kwargs: Any) -> StreamingQuery:
    """Construct + start a stream (the QueryService wiring calls this)."""
    sid = stream_id or f"stream-{trace.new_query_id()}"
    return StreamingQuery(sid, source, spec, tenant_id=tenant_id,
                          service=service, **kwargs).start()


def adoptable_streams() -> Dict[str, str]:
    """{stream_id: journal path} registered by the recovery scan —
    dead-writer stream journals waiting for an adopter."""
    return journal.adoptable_streams()


def resume_stream(stream_id: str, *, journal_dir: Optional[str] = None,
                  service=None, work_dir: Optional[str] = None,
                  tenant_id: Optional[str] = None,
                  device=None) -> StreamingQuery:
    """Adopt a dead writer's stream: reconstruct the TailSource +
    StreamSpec from the journal's stream_open record, restore the last
    checkpoint, re-stamp the writer pid, and resume ticking. Used by the
    standby driver after takeover and by a restarted embedder."""
    d = journal_dir or conf.journal_dir
    if not d:
        raise ValueError("resume_stream needs a journal directory")
    journal.claim_adoptable_stream(stream_id)  # consume the registration
    records = journal.load_records(journal.journal_path(stream_id, d))
    opened = None
    for r in records:
        if r.get("kind") == "stream_open":
            opened = r
    if opened is None:
        raise ValueError(f"no stream_open record for {stream_id!r} in {d}")
    sq = StreamingQuery(
        stream_id,
        TailSource.from_doc(opened["source"]),
        StreamSpec.from_doc(opened["spec"]),
        tenant_id=(tenant_id if tenant_id is not None
                   else opened.get("tenant_id", "")),
        service=service,
        num_partitions=int(opened.get("num_partitions", 2)),
        shuffle_parts=int(opened.get("shuffle_parts", 2)),
        work_dir=work_dir,
        mesh_exchange=opened.get("mesh_exchange", "off"),
        journal_dir=d, device=device)
    return sq.start()


def reset() -> None:
    """Stop + drop every live stream (test isolation); journals are left
    alone (adoptable, like the rest of the durability layer)."""
    with _registry_lock:
        streams = list(_streams.values())
        _streams.clear()
    for s in streams:
        s._stop.set()
    for s in streams:
        t = s._thread
        if t is not None:
            t.join(timeout=5.0)
