"""Stage-boundary exchange over the device mesh (the in-device-memory
shuffle path).

Port of blaze_tpu/parallel/stage_exchange.py. When a shuffle stage is
hash-partitioned on plain column keys, the exchange runs over the host's
devices (parallel/shuffle.py) and the reduce side consumes partitions
straight from device memory: no `.data`/`.index` files, no serde, no host
round trip. The file path (ops/shuffle.py) stays both the transport of the
stages the mesh declines and the fallback of a batch whose staging quota
overflows or that comes past half the memory budget (the reference's
analog is the sort-repartitioner's spill path,
shuffle/sort_repartitioner.rs:199-213).

The partition function is the file path's (exprs/hash.py), so a
partition's row multiset is the same on either path and readers cannot
tell them apart. On one device (one H100, or the CPU) the exchange is
`exchange_local`: a stable sort of each map-output batch by partition id
and one host pull of the P+1 bounds, each partition's rows kept on the
device as a slice.

The devices come from `mesh_devices`, the one hook tests patch (to D
logical CPU devices, or D logical devices on one card). The functions run
eagerly: the JAX module's jit cache has no counterpart here.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import torch

from blaze_tpu_torch.columnar.batch import (
    ColumnBatch, bucket_capacity, map_tensors,
)
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike, resolve_device
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.plan import plan_pb2 as pb
from blaze_tpu_torch.runtime import resources
from blaze_tpu_torch.runtime.metrics import to_host


def mesh_devices(dev: torch.device) -> List[torch.device]:
    """The devices a stage's exchange spreads over: every visible CUDA
    device when the run's device is CUDA, else the run's device alone."""
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def mesh_key_indices(writer: pb.ShuffleWriterNode,
                     schema: Schema) -> Optional[List[int]]:
    """Key column indices for the mesh partition function, or None when
    the stage can't ride the mesh (computed keys need the file path's
    expression evaluation; non-hash partitionings don't gain from it)."""
    from blaze_tpu_torch.plan.from_proto import decode_expr

    if writer.partitioning.kind != pb.HashRepartition.HASH:
        return None
    idx: List[int] = []
    for ke in writer.partitioning.keys:
        e = decode_expr(ke)
        if isinstance(e, ir.Col):
            idx.append(schema.index_of(e.name))
        elif isinstance(e, ir.BoundRef):
            idx.append(e.index)
        else:
            return None
    return idx


def _on(batch: ColumnBatch, dev: torch.device) -> ColumnBatch:
    """`batch` with every tensor on `dev` (no copy where it is already)."""
    return ColumnBatch(batch.schema,
                       [map_tensors(c, lambda t: t.to(dev))
                        for c in batch.columns],
                       batch.num_rows.to(dev), batch.capacity)


def run_mesh_shuffle_stage(stage_plan: pb.PlanNode, stage_id: int,
                           ntasks: int, quota: Optional[int] = None,
                           work_dir: Optional[str] = None,
                           stats: Optional[dict] = None,
                           namespace: str = "",
                           device: DeviceLike = None) -> bool:
    """Execute one shuffle_map stage's exchange over the device mesh, its
    map tasks on `device` (None: the CUDA card), one after another.

    STREAMS: each map-output batch is exchanged as it is produced, so
    staging holds one batch's rows at a time, never the whole stage. A
    batch whose skew overflows the per-partition staging quota goes to
    the FILE path at once: batches already exchanged are kept and map
    subplans never re-run; the reduce side's provider serves mesh slices
    first, then file segments.

    `stats`, when given, gets the stage's logical bytes ("bytes", the AQE
    statistic: live-row-scaled device bytes of the slices plus the
    files' sizes), the device bytes of the batches kept on the device
    ("pinned", the count the half-budget rule reads) and the map tasks'
    operator roots ("ops", whose metrics the runner sums). Returns False, with nothing registered and
    nothing run, only when the stage can't ride the mesh at all (fewer
    than 2 partitions, computed or no keys, another partitioning, a
    nested column)."""
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.ops.host_sort import host_supported
    from blaze_tpu_torch.ops.shuffle import (
        ShuffleWriterExec, read_shuffle_partition,
        read_shuffle_partition_host,
    )
    from blaze_tpu_torch.ops.sort_keys import permute_by_keys
    from blaze_tpu_torch.parallel.shuffle import (
        mesh_shuffle_batch_grouped, partition_ids,
    )
    from blaze_tpu_torch.plan import decode_plan
    from blaze_tpu_torch.plan.from_proto import _partitioning
    from blaze_tpu_torch.runtime.executor import (
        execute_plan, execute_stage_or_plan,
    )
    from blaze_tpu_torch.runtime.memory import batch_nbytes, get_manager

    writer = stage_plan.shuffle_writer
    Pn = writer.partitioning.num_partitions
    if Pn < 2:
        return False
    if conf.fault_injection_spec:
        from blaze_tpu_torch.runtime import faults

        faults.inject("exchange.stage")
    dev = resolve_device(device)
    devices = mesh_devices(dev)
    input_op = decode_plan(writer.input)
    schema = input_op.schema
    key_idx = mesh_key_indices(writer, schema)
    if not key_idx:
        return False
    if any(f.dtype.is_nested for f in schema.fields):
        return False  # list elements are not row-aligned

    # P > D: device d OWNS the contiguous partition block [d*k, (d+1)*k),
    # k = ceil(P/D). With one device the exchange is a local grouping:
    # partitions stay in device memory, no copy between devices
    use_d = min(len(devices), Pn)
    kpd = -(-Pn // use_d)
    use_d = -(-Pn // kpd)  # drop devices left with no partitions
    # (slice, live rows) of each partition, on the device it landed on
    recv_parts: List[List[tuple]] = [[] for _ in range(Pn)]
    file_outputs: List[tuple] = []

    def exchange_local(batch: ColumnBatch) -> int:
        """Single-device exchange: group by partition id on the device
        and slice per partition; one host pull (the bounds) a batch.
        Returns the batch's live rows."""
        from blaze_tpu_torch.ops.common import slice_batch

        pid = partition_ids(batch, key_idx, Pn)
        sb = permute_by_keys(batch, [pid])  # stable: padding rows last
        counts = torch.bincount(pid.to(torch.int64), minlength=Pn + 1)
        bounds = to_host(torch.cat([counts.new_zeros(1),
                                    counts[:Pn].cumsum(0)])).tolist()
        for p in range(Pn):
            n = bounds[p + 1] - bounds[p]
            if n:
                recv_parts[p].append((slice_batch(sb, bounds[p], n), n))
        return bounds[Pn]

    def exchange_batch(batch: ColumnBatch) -> Optional[int]:
        """Exchange one batch over the mesh: its live rows, or None on
        quota overflow (nothing kept)."""
        if use_d == 1:
            return exchange_local(batch)
        n = int(to_host(batch.num_rows))
        per = max(1, -(-n // use_d))
        cap = bucket_capacity(per)
        # quota: rows one device may send one OWNER device (k partitions)
        q = min(quota * kpd, cap) if quota else cap
        slices = [
            _on(batch.take(torch.arange(cap, dtype=torch.int64,
                                        device=batch.device) + i * per,
                           min(max(n - i * per, 0), per)), devices[i])
            for i in range(use_d)]
        outs, counts, overflow = mesh_shuffle_batch_grouped(
            slices, key_idx, devices[:use_d], Pn, kpd, q)
        # the overflow and every owned partition's rows in one pull
        flat = to_host(torch.cat([overflow.reshape(1).to(torch.int64)] + [
            c.to(devices[0], torch.int64) for c in counts])).tolist()
        if flat[0] > 0:
            return None
        for d in range(use_d):
            off = 0
            for j in range(kpd):
                p = d * kpd + j
                nrows = flat[1 + d * kpd + j]
                if p < Pn and nrows:
                    # compact to the rows' own capacity bucket: keeping
                    # the staging capacity would pin batches x D^2 x q
                    # padded rows in device memory across the stage
                    idx = torch.arange(bucket_capacity(nrows),
                                       dtype=torch.int64,
                                       device=devices[d]) + off
                    recv_parts[p].append((outs[d].take(idx, nrows), nrows))
                off += nrows
        return n

    def spill_batch_to_file(batch: ColumnBatch) -> None:
        nonlocal work_dir
        if work_dir is None:
            work_dir = tempfile.mkdtemp(prefix="blaze_tpu_torch_mesh_ovf_")
        i = len(file_outputs)
        data = os.path.join(work_dir, f"stage{stage_id}_meshovf{i}.data")
        index = os.path.join(work_dir, f"stage{stage_id}_meshovf{i}.index")
        op = ShuffleWriterExec(MemorySourceExec([batch], schema),
                               _partitioning(writer.partitioning),
                               data, index)
        list(execute_plan(op, ExecContext(partition=0, num_partitions=1,
                                          device=dev)))
        file_outputs.append((data, index))

    # map side: every task's batches stream straight into the exchange
    # (the whole-stage path where the subtree matches). Exchanged
    # partitions stay PINNED in device memory until the consuming stage
    # ends, so once pinned bytes pass half the memory budget the remaining
    # batches take the file path (the reduce side reads both)
    budget = get_manager().total // 2
    pinned = 0
    ops = []
    for task in range(ntasks):
        op = decode_plan(writer.input)  # fresh operator state per task
        ops.append(op)
        for batch in execute_stage_or_plan(
                op, ExecContext(partition=task, num_partitions=ntasks,
                                device=dev)):
            if pinned <= budget:
                live = exchange_batch(batch)
                if live is not None:
                    if live:
                        pinned += batch_nbytes(batch)
                    continue
            elif int(to_host(batch.num_rows)) == 0:
                continue
            spill_batch_to_file(batch)

    def provider(partition: int):
        # one parameter: ops/shuffle._call_provider passes as many task
        # arguments as the provider names, so state is closed over
        for b, _ in recv_parts[partition]:
            yield _on(b, dev)
        for data, index in file_outputs:
            if host_supported(schema):
                yield from read_shuffle_partition_host(data, index,
                                                       partition, schema)
            else:
                yield from read_shuffle_partition(data, index, partition,
                                                  schema, device=dev)

    if stats is not None:
        # live-row-scaled logical bytes: batch_nbytes counts the padded
        # capacity bucket, which would bias the AQE threshold against the
        # file path's measure
        total = sum(batch_nbytes(b) * n // max(b.capacity, 1)
                    for parts in recv_parts for b, n in parts)
        total += sum(os.path.getsize(d) for d, _ in file_outputs)
        stats["bytes"] = int(total)
        stats["pinned"] = pinned
        stats["ops"] = ops
    resources.put(f"{namespace}shuffle:{stage_id}", provider)
    return True
