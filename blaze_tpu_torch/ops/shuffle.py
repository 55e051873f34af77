"""Shuffle write/read operators: Spark-format .data/.index files, IPC
streams, RSS hooks, and batch ingestion from export iterators.

Port of blaze_tpu/ops/shuffle.py (ref: datafusion-ext-plans
shuffle_writer_exec.rs / rss_shuffle_writer_exec.rs and the
sort/bucket/single repartitioners on the write side, ipc_reader_exec.rs /
ipc_writer_exec.rs and ffi_reader_exec.rs on the read side). The file
formats are the JAX package's, byte for byte: one `.data` file of
concatenated per-partition serde frames (columnar/serde.py) and a
little-endian u64 offsets `.index` file with the checksum footer of
runtime/artifacts.py, committed crash-atomically.

The repartitioner: partition ids come from the bit-exact Spark murmur3
(exprs/hash.py), the rows are grouped by partition with ONE stable sort on
the id (ops/sort_keys.permute_by_keys; padding rows last, row order kept
inside a partition), and the sorted batch comes to the host in one pull
together with the per-partition counts, to be cut into per-partition
frames.

The writer hands each pulled batch to a `pipeline.Sink`, whose one I/O
worker cuts and compresses the frames while the device partitions the
next batch; the reader decodes frames ahead through `pipeline.prefetch`
(runtime/pipeline.py). Both run inline with conf.enable_pipeline off, and
the bytes are the same either way. Where the native library loads
(blaze_tpu_torch/native), the map output goes through its C++ writer
(bn_shuffle_*), as in the JAX package, which writes the same bytes; the
writer's metric `shuffle_writer_native` says which ran. FfiReaderExec
takes pyarrow RecordBatches through columnar/arrow_io.py.
"""

from __future__ import annotations

import dataclasses
import inspect
import io
import os
import tempfile
import time
from typing import Callable, Iterator, List

import numpy as np
import torch

from blaze_tpu_torch import native
from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.exprs.hash import (
    SPARK_SHUFFLE_SEED, hash_columns, hash_int32, pmod,
)
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.sort_keys import permute_by_keys
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime import monitor, resources
from blaze_tpu_torch.runtime.metrics import BRIDGE, bump


def _call_provider(provider, ctx: ExecContext):
    """Invoke a registered resource provider with as much task context as
    its signature accepts: (partition, num_partitions) | (partition) | ().
    Arity is decided from the signature, not by retrying on TypeError —
    retries would mask genuine TypeErrors raised inside the provider."""
    if not callable(provider):
        return provider
    try:
        params = [p for p in inspect.signature(provider).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                                p.VAR_POSITIONAL)]
        if any(p.kind == p.VAR_POSITIONAL for p in params):
            nargs = 2
        else:
            nargs = min(2, len(params))
    except (TypeError, ValueError):  # builtins without signatures
        nargs = 1
    if nargs == 2:
        return provider(ctx.partition, ctx.num_partitions)
    if nargs == 1:
        return provider(ctx.partition)
    return provider()


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """Ref: pb.PhysicalHashRepartition (blaze.proto) — hash | single |
    round_robin over `num_partitions`."""
    kind: str                       # "hash" | "single" | "round_robin"
    num_partitions: int
    key_exprs: tuple = ()           # hash only: ir.Expr tuple

    def key(self) -> tuple:
        return (self.kind, self.num_partitions,
                tuple(e.key() for e in self.key_exprs))


def round_robin_start(task_partition: int, num_partitions: int) -> int:
    """Per-task starting position, restart-stable: Spark seeds a Random with
    the task's partitionId so that a retry lands every row identically;
    this is spark-murmur3 of the partition id, as in the JAX package
    (deterministic and well spread, not java.util.Random's value)."""
    h = hash_int32(torch.tensor([task_partition], dtype=torch.int32),
                   SPARK_SHUFFLE_SEED)
    return int(h[0]) % num_partitions


def partition_ids(batch: ColumnBatch, part: Partitioning, key_fns,
                  row_offset: int = 0, rr_start: int = 0) -> torch.Tensor:
    """int32 partition id of every row, P (= num_partitions) for padding.
    Round-robin rows get (rr_start + row_offset + i) % P, row_offset being
    the task's running row count, so a retried task assigns every row the
    same partition."""
    P = part.num_partitions
    mask = batch.row_mask()
    if part.kind == "hash":
        keys = [fn(batch) for fn in key_fns]
        pid = pmod(hash_columns(keys, SPARK_SHUFFLE_SEED, row_mask=mask), P)
    elif part.kind == "single":
        pid = torch.zeros((batch.capacity,), dtype=torch.int32,
                          device=batch.device)
    elif part.kind == "round_robin":
        pos = torch.arange(batch.capacity, dtype=torch.int64,
                           device=batch.device) + (row_offset + rr_start)
        pid = (pos % P).to(torch.int32)
    else:
        raise ValueError(part.kind)
    return torch.where(mask, pid, torch.full_like(pid, P))


def partition_and_sort(batch: ColumnBatch, part: Partitioning, key_fns,
                       row_offset: int = 0, rr_start: int = 0) -> tuple:
    """(batch grouped by partition id, int64 per-partition counts). One
    stable sort on the id: padding rows (id P) go last and rows keep their
    order inside a partition."""
    pid = partition_ids(batch, part, key_fns, row_offset, rr_start)
    counts = torch.bincount(pid.to(torch.int64),
                            minlength=part.num_partitions + 1)
    return permute_by_keys(batch, [pid]), counts[:part.num_partitions]


class _Repartitioner:
    """What both shuffle writers share: the compiled key expressions and
    the task-seeded round-robin start, and one call per batch that returns
    the partition-sorted rows on the host with their frame bounds."""

    def __init__(self, part: Partitioning, schema: Schema,
                 ctx: ExecContext) -> None:
        self.part = part
        self.key_fns = ([compile_expr(e, schema) for e in part.key_exprs]
                        if part.kind == "hash" else [])
        self.rr = (round_robin_start(ctx.partition, part.num_partitions)
                   if part.kind == "round_robin" else 0)
        self.row_offset = 0

    def split(self, batch: ColumnBatch):
        """(host batch, offsets (P+1,)): rows [offsets[p], offsets[p+1])
        of the host batch are partition p's. One device->host pull."""
        sb, counts = partition_and_sort(batch, self.part, self.key_fns,
                                        self.row_offset, self.rr)
        hb, (counts_h,) = serde.to_host_with(sb, [counts])
        self.row_offset += hb.num_rows
        return hb, np.concatenate([[0], np.cumsum(counts_h)])


class ShuffleWriterExec(Operator):
    """Writes the Spark shuffle map output of this task's partition.

    Ref: shuffle_writer_exec.rs — consumes the child stream, produces an
    empty output stream; the side effect is the committed .data/.index
    pair (parsed by BlazeShuffleWriterBase.scala:84-96 into
    partitionLengths). As in the JAX package, `execute` runs the whole map
    task before it returns."""

    def __init__(self, child: Operator, partitioning: Partitioning,
                 data_path: str, index_path: str) -> None:
        super().__init__([child])
        self.partitioning = partitioning
        self.data_path = data_path
        self.index_path = index_path

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def plan_key(self) -> tuple:
        return ("shuffle_write", self.partitioning.key(),
                self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        from blaze_tpu_torch.runtime import artifacts
        from blaze_tpu_torch.runtime.executor import execute_stage_or_plan

        out_dir = os.path.dirname(self.data_path) or "."
        os.makedirs(out_dir, exist_ok=True)
        # reclaim dead writers' .inprogress. temps before producing our own
        artifacts.sweep_orphans([out_dir])
        from blaze_tpu_torch.ops.host_sort import host_nbytes
        from blaze_tpu_torch.runtime import pipeline

        P = self.partitioning.num_partitions
        rep = _Repartitioner(self.partitioning, self.schema, ctx)
        state = _make_writer_state(P, M.get_manager(ctx))
        self.metrics.add("shuffle_writer_native",
                         int(isinstance(state, _NativeWriterState)))

        def write_out(job):
            # the pool-side half of the map task: cut the partition-sorted
            # host batch into per-partition frames (compress) and push
            # them. The sink has one worker, so push order is submit order
            hb, offs = job
            for p in range(P):
                if offs[p + 1] > offs[p]:
                    state.push(p, serde.serialize_slice(
                        hb, int(offs[p]), int(offs[p + 1])))

        # batch i's compress and write overlap batch i+1's partitioning;
        # inline (serial) with pipelining off
        sink = pipeline.Sink(write_out, ctx=ctx, manager=M.get_manager(ctx),
                             name="shuffle_write")
        committed = False
        try:
            for batch in execute_stage_or_plan(self.children[0], ctx):
                ctx.check_running()
                with self.metrics.timer():
                    hb, offs = rep.split(batch)
                    if hb.num_rows == 0:
                        continue
                    self.metrics.add(
                        "shuffle_logical_bytes",
                        M.batch_nbytes(batch) * hb.num_rows
                        // max(batch.capacity, 1))
                    sink.submit((hb, offs), host_nbytes(hb))
            # drain every pending frame (re-raising a pool-side error)
            # before the commit reads the buffers
            sink.close()
            t0 = time.perf_counter_ns()
            with self.metrics.timer():
                # crash-atomic: stage temps, fsync, rename data-then-index
                lengths = artifacts.commit_shuffle_pair(
                    state.commit, self.data_path, self.index_path,
                    gate=ctx.commit_gate)
            if conf.monitor_enabled:
                # the map-output commit is the write half of shuffle_io;
                # the read half lands in serde_decode
                monitor.count_time("shuffle_io",
                                   time.perf_counter_ns() - t0)
            self.metrics.add("shuffle_bytes_written", int(sum(lengths)))
            self.metrics.add("spill_count", state.spill_chunks)
            committed = True
        finally:
            if not committed:
                sink.abort()
            state.close()
        return iter(())


def _make_writer_state(num_partitions: int, manager: M.MemManager):
    """The map-output writer: the C++ bn_shuffle_* writer when the native
    library loads, else the Python buffers. Both are MemConsumers and write
    byte-identical files. Unlike the JAX package, a native writer that
    fails to start raises instead of quietly falling back."""
    if native.available():
        return _NativeWriterState(num_partitions, manager)
    return _WriterBuffers(num_partitions, manager)


class _NativeWriterState(M.MemConsumer):
    """MemConsumer adapter over native.NativeShuffleWriter. Its mem_used
    after close is 0 (the binding's lock orders it against the free), so a
    MemManager summing consumers from another thread is safe."""

    name = "shuffle_writer"

    def __init__(self, num_partitions: int, manager: M.MemManager) -> None:
        os.makedirs(conf.spill_dir, exist_ok=True)
        self._w = native.NativeShuffleWriter(
            num_partitions, spill_dir=conf.spill_dir,
            mem_budget=1 << 62)  # the MemManager drives spilling, not C++
        self.manager = manager
        self.spill_chunks = 0
        manager.register(self)

    def mem_used(self) -> int:
        return self._w.mem_used()

    def spill(self) -> int:
        before = self.mem_used()
        if before == 0:
            return 0
        self._w.spill()
        self.spill_chunks += 1
        return before - self.mem_used()

    def push(self, p: int, frame: bytes) -> None:
        if conf.monitor_enabled:
            monitor.count_copy("shuffle", len(frame))
        # op_lock: serialize against a host-driven release()
        with self.manager.op_lock:
            self._w.push(p, frame)
            self.manager.update_mem_used(self)

    def commit(self, data_path: str, index_path: str) -> List[int]:
        return self._w.commit(data_path, index_path)

    def close(self) -> None:
        self.manager.unregister(self)
        self._w.close()


class _WriterBuffers(M.MemConsumer):
    """Per-partition frame buffers with host-file spill (ref the
    repartitioners' MemConsumer spill, sort_repartitioner.rs:199-213):
    frames are serialized host bytes already, so a spill appends them to a
    tempfile and the commit replays them in partition order."""

    name = "shuffle_writer"

    def __init__(self, num_partitions: int, manager: M.MemManager) -> None:
        self.P = num_partitions
        self.buffers: List[List[bytes]] = [[] for _ in range(num_partitions)]
        self.bytes = 0
        self.manager = manager
        self._spill_fp = None
        self._spill_segs: List[List[tuple]] = [[] for _ in
                                               range(num_partitions)]
        self.spill_chunks = 0
        manager.register(self)

    def mem_used(self) -> int:
        return self.bytes

    def spill(self) -> int:
        if self.bytes == 0:
            return 0
        if self._spill_fp is None:
            os.makedirs(conf.spill_dir, exist_ok=True)
            self._spill_fp = tempfile.TemporaryFile(dir=conf.spill_dir)
        freed = self.bytes
        for p in range(self.P):
            for chunk in self.buffers[p]:
                off = self._spill_fp.tell()
                self._spill_fp.write(chunk)
                self._spill_segs[p].append((off, len(chunk)))
                self.spill_chunks += 1
            self.buffers[p] = []
        self.bytes = 0
        return freed

    def push(self, p: int, frame: bytes) -> None:
        if conf.monitor_enabled:
            monitor.count_copy("shuffle", len(frame))
        # op_lock: serialize against a host-driven release()
        with self.manager.op_lock:
            self.buffers[p].append(frame)
            self.bytes += len(frame)
            self.manager.update_mem_used(self)

    def drain(self, p: int):
        for off, ln in self._spill_segs[p]:
            self._spill_fp.seek(off)
            yield self._spill_fp.read(ln)
        yield from self.buffers[p]

    def commit(self, data_path: str, index_path: str) -> List[int]:
        lengths = []
        with open(data_path, "wb") as f:
            for p in range(self.P):
                start = f.tell()
                for chunk in self.drain(p):
                    f.write(chunk)
                lengths.append(f.tell() - start)
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype("<u8")
        with open(index_path, "wb") as f:
            f.write(offsets.tobytes())
        return lengths

    def close(self) -> None:
        self.manager.unregister(self)
        self.buffers = [[] for _ in range(self.P)]
        self.bytes = 0
        if self._spill_fp is not None:
            self._spill_fp.close()
            self._spill_fp = None


class RssPartitionWriterBase:
    """Ref: Shims.scala:204-208 RssPartitionWriterBase — push interface for
    remote shuffle services."""

    def write(self, partition_id: int, payload: bytes) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass


class RssShuffleWriterExec(ShuffleWriterExec):
    """Ref: rss_shuffle_writer_exec.rs — the same repartitioning, pushing
    frames to an RSS writer resource instead of committing local files."""

    def __init__(self, child: Operator, partitioning: Partitioning,
                 rss_resource_id: str) -> None:
        super().__init__(child, partitioning, data_path="", index_path="")
        self.rss_resource_id = rss_resource_id

    def plan_key(self) -> tuple:
        return ("rss_shuffle_write", self.partitioning.key(),
                self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        writer: RssPartitionWriterBase = resources.get(self.rss_resource_id)
        rep = _Repartitioner(self.partitioning, self.schema, ctx)
        for batch in self.children[0].execute(ctx):
            ctx.check_running()
            with self.metrics.timer():
                hb, offs = rep.split(batch)
                for p in range(self.partitioning.num_partitions):
                    if offs[p + 1] > offs[p]:
                        frame = serde.serialize_slice(
                            hb, int(offs[p]), int(offs[p + 1]))
                        if conf.monitor_enabled:
                            monitor.count_copy("shuffle", len(frame))
                        writer.write(p, frame)
        writer.flush()
        return iter(())


def _segment_frames(data_path: str, index_path: str,
                    partition: int) -> io.BytesIO:
    """One partition's segment, fetched and checksum-verified by
    artifacts.fetch_segment before a single frame decodes."""
    from blaze_tpu_torch.runtime import artifacts

    return io.BytesIO(artifacts.fetch_segment(data_path, index_path,
                                              partition))


def read_shuffle_partition(data_path: str, index_path: str, partition: int,
                           schema: Schema, device: DeviceLike = None
                           ) -> Iterator[ColumnBatch]:
    """Reduce-side local read of one partition's frames, each decoded onto
    `device` (None: the CUDA card)."""
    return serde.read_batches(_segment_frames(data_path, index_path,
                                              partition), schema,
                              device=device)


def read_shuffle_partition_host(data_path: str, index_path: str,
                                partition: int, schema: Schema
                                ) -> Iterator[serde.HostBatch]:
    """The same fetch, decoded only to host frames (serde.HostBatch):
    IpcReaderExec coalesces them into one upload a macro-batch."""
    return serde.read_batches_host(_segment_frames(data_path, index_path,
                                                   partition), schema)


class IpcReaderExec(Operator):
    """Ref: ipc_reader_exec.rs — pulls serialized segments from a registered
    provider (shuffle reader, broadcast) and decodes them to batches.

    The provider yields ColumnBatches (passed through), HostBatches, frame
    bytes, or file-like frame streams. Frames decode on the host and
    accumulate toward `adaptive_target_bytes`, then go to the context's
    device in ONE upload: a per-frame upload would pay a copy and its
    launches per frame."""

    def __init__(self, schema: Schema, resource_id: str,
                 num_partitions: int = 1) -> None:
        super().__init__([])
        self._schema = schema
        self.resource_id = resource_id
        self.num_partitions = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("ipc_reader", tuple(self._schema.names()))

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            from blaze_tpu_torch.ops import host_sort
            from blaze_tpu_torch.ops.common import adaptive_target_bytes

            # the node's num_partitions is authoritative: it is the count
            # the stream was WRITTEN with
            eff_ctx = ctx
            if self.num_partitions and \
                    self.num_partitions != ctx.num_partitions:
                eff_ctx = dataclasses.replace(
                    ctx, num_partitions=self.num_partitions)
            from blaze_tpu_torch.runtime import pipeline

            source = _call_provider(resources.get(self.resource_id),
                                    eff_ctx)
            # read-side readahead: the provider's fetch and decompress
            # (shuffle_manager.get_reader_host decoding frames) run ahead
            # on the I/O pool, charged against the budget, while this
            # thread coalesces and uploads the current macro-batch
            source = pipeline.prefetch(source, ctx=ctx,
                                       manager=M.get_manager(ctx),
                                       name="shuffle_read")
            target = adaptive_target_bytes(M.get_manager(ctx))
            pending: list = []
            pending_bytes = 0

            def flush():
                nonlocal pending, pending_bytes
                if pending:
                    hb = host_sort.host_concat(pending)
                    pending, pending_bytes = [], 0
                    yield host_sort.host_to_device(hb, device=ctx.device)

            def absorb(hb):
                nonlocal pending_bytes
                pending.append(hb)
                pending_bytes += host_sort.host_nbytes(hb)

            # every dense and string schema has a host form; nested
            # columns raise in the frame decode, naming their module
            try:
                for seg in source:
                    ctx.check_running()
                    if isinstance(seg, ColumnBatch):
                        yield from flush()
                        yield seg
                    elif isinstance(seg, serde.HostBatch):
                        absorb(seg)
                    elif isinstance(seg, (bytes, bytearray, memoryview)):
                        absorb(serde.deserialize_batch_host(seg,
                                                            self._schema))
                    else:  # file-like
                        for hb in serde.read_batches_host(seg, self._schema):
                            absorb(hb)
                            if pending_bytes >= target:
                                yield from flush()
                    if pending_bytes >= target:
                        yield from flush()
                yield from flush()
            finally:
                close = getattr(source, "close", None)
                if close is not None:
                    close()

        return count_stream(self, gen())


class IpcWriterExec(Operator):
    """Ref: ipc_writer_exec.rs — serializes the child stream into frames
    pushed to a registered consumer (the broadcast collect path,
    NativeBroadcastExchangeBase.scala:175-184). One device->host pull a
    batch; empty batches send nothing."""

    def __init__(self, child: Operator, consumer_resource_id: str) -> None:
        super().__init__([child])
        self.consumer_resource_id = consumer_resource_id

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def plan_key(self) -> tuple:
        return ("ipc_writer", self.children[0].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        consumer: Callable[[bytes], None] = resources.get(
            self.consumer_resource_id)
        total = 0
        for batch in self.children[0].execute(ctx):
            ctx.check_running()
            with self.metrics.timer():
                hb = serde.to_host(batch)
                if hb.num_rows == 0:
                    continue
                buf = hb.serialize()
            consumer(buf)
            total += len(buf)
        self.metrics.add("ipc_bytes_written", total)
        return iter(())


class FfiReaderExec(Operator):
    """Ref: ffi_reader_exec.rs — pulls Arrow arrays from a registered
    export iterator (the ConvertToNative row->columnar ingestion path,
    ConvertToNativeBase.scala:59-98). The provider yields pyarrow
    RecordBatches (the C-data crossing is pyarrow's), uploaded to the
    task's device by columnar/arrow_io.py, or ready ColumnBatches."""

    def __init__(self, schema: Schema, export_resource_id: str) -> None:
        super().__init__([])
        self._schema = schema
        self.export_resource_id = export_resource_id

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("ffi_reader", tuple(self._schema.names()))

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            from blaze_tpu_torch.columnar.arrow_io import batch_from_arrow

            source = _call_provider(resources.get(self.export_resource_id),
                                    ctx)
            for item in source:
                ctx.check_running()
                if not isinstance(item, ColumnBatch):
                    item = batch_from_arrow(item, schema=self._schema,
                                            device=ctx.device)
                bump(BRIDGE, "batches", 1)
                bump(BRIDGE, "card_batches", int(item.device.type == "cuda"))
                yield item

        return count_stream(self, gen())
