"""On-mesh shuffle: murmur3 partitioning and a block exchange between devices.

Port of blaze_tpu/parallel/shuffle.py. The reference's shuffle
repartitions rows by Spark-murmur3 and moves the buckets between executors
as zstd-IPC files over netty (SURVEY.md §3.3). When a stage's partitions
map onto the devices of one host, the exchange stays in device memory:
each device groups its rows by destination into a fixed-quota staging
buffer, and one all_to_all delivers every bucket. The partition function
is the file path's (exprs/hash.py: murmur3 with seed 42, then pmod; ref
datafusion-ext-plans shuffle/mod.rs:94-119).

The JAX module runs inside `shard_map` over a `jax.sharding.Mesh`, in one
process over `jax.devices()`. So does this one, over a list of
`torch.device`s: a "mesh" here is that list, and each function takes one
batch a device (all of one shape, as shard_map's stacked input has). The
all_to_all is block (src -> dst) of each source's staged buffer, copied
onto devices[dst] with `tensor.to`; there is no torch.distributed process
group, since one process drives every device. String columns exchange
their bytes and lengths (a `DictData` expands first: per-device
dictionaries cannot be exchanged), a wide decimal each int64 plane; list
storage is not row-aligned and is declined before it gets here
(parallel/stage_exchange.py).

The only lossy edge is quota overflow (more than `quota` rows bound for
one destination from one device). It is reported, never dropped silently:
callers fall back to the file path when the overflow is above 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, StringData, StructData, map_tensors,
)
from blaze_tpu_torch.exprs.hash import (
    SPARK_SHUFFLE_SEED, hash_columns, pmod,
)


def partition_ids(batch: ColumnBatch, key_indices: Sequence[int],
                  num_partitions: int,
                  seed: int = SPARK_SHUFFLE_SEED) -> torch.Tensor:
    """int32 destination partition per row; padding rows get sentinel P.

    Spark-compatible: murmur3(seed 42) over the key columns, then pmod
    (shuffle/mod.rs:94-119). The sentinel sorts padding after every real
    partition. With no keys, row index mod P (the exact start does not
    matter to the exchange)."""
    keys = [batch.columns[i] for i in key_indices]
    mask = batch.row_mask()
    if not keys:
        pid = (torch.arange(batch.capacity, dtype=torch.int32,
                            device=batch.device) % num_partitions)
    else:
        pid = pmod(hash_columns(keys, seed, row_mask=mask), num_partitions)
    return torch.where(mask, pid, torch.full_like(pid, num_partitions))


def _stage_by_partition(batch: ColumnBatch, pid: torch.Tensor,
                        num_partitions: int, quota: int
                        ) -> Tuple[ColumnBatch, torch.Tensor, torch.Tensor]:
    """Group rows into a (P*quota)-capacity staged batch, bucket-major.

    Returns (staged batch, per-partition counts (P,) clamped to `quota`,
    overflow count). Slot j of bucket p holds the j-th row bound for p
    (input order kept: a stable sort); slots >= count_p are garbage."""
    P = num_partitions
    pid_sorted, order = torch.sort(pid, stable=True)
    bounds = torch.searchsorted(
        pid_sorted, torch.arange(P + 1, dtype=pid.dtype, device=pid.device))
    starts, ends = bounds[:-1], bounds[1:]
    counts = (ends - starts).to(torch.int32)
    overflow = (counts - quota).clamp(min=0).sum()
    j = torch.arange(quota, dtype=torch.int64, device=pid.device)
    idx = (starts[:, None] + j[None, :]).clamp(0, batch.capacity - 1)
    staged = batch.take(order[idx].reshape(-1), 0)
    return staged, counts.clamp(max=quota), overflow


def _row_aligned(c: Column) -> Column:
    """`c` with every dictionary expanded to plain strings, so that each
    of its tensors is row-aligned and can be cut into blocks."""
    if c.is_dict:
        return Column(c.dtype, StringData(c.data.bytes, c.data.lengths),
                      c.validity)
    if c.is_struct:
        return Column(c.dtype, StructData(
            [_row_aligned(ch) for ch in c.data.children]), c.validity)
    return c


def _leaves(c: Column) -> List[torch.Tensor]:
    """A column's tensors in `map_tensors`' order."""
    out: List[torch.Tensor] = []
    map_tensors(c, lambda t: out.append(t) or t)
    return out


def _with_leaves(c: Column, leaves: Sequence[torch.Tensor]) -> Column:
    """`c`'s structure over `leaves` (in `map_tensors`' order)."""
    it = iter(leaves)
    return map_tensors(c, lambda _t: next(it))


def staged_all_to_all(batches: Sequence[ColumnBatch],
                      pids: Sequence[torch.Tensor],
                      devices: Sequence[torch.device], num_partitions: int,
                      quota: int) -> Tuple[List[ColumnBatch], torch.Tensor]:
    """Exchange rows to their destination devices: batches[s] (on
    devices[s]) sends each row to devices[pids[s][row]].

    Needs exactly `num_partitions` devices. Returns (one received batch a
    device, live rows compacted to the front in source order, capacity
    P*quota; the total overflow count, on devices[0])."""
    P = num_partitions
    if len(devices) != P or len(batches) != P:
        raise ValueError(f"{len(batches)} batches on {len(devices)} "
                         f"devices for {P} partitions")
    if len({b.shape_key() for b in batches}) != 1:
        raise ValueError("the exchange needs one batch shape on every "
                         "device")
    staged, counts, overflows = [], [], []
    for b, pid in zip(batches, pids):
        s, c, o = _stage_by_partition(b, pid, P, quota)
        aligned = [_row_aligned(col) for col in s.columns]
        staged.append([_leaves(col) for col in aligned])
        counts.append(c)
        overflows.append(o)
    template = aligned  # every source's columns have this structure
    slot = torch.arange(quota, dtype=torch.int32)
    out = []
    for d, dev in enumerate(devices):
        lo, hi = d * quota, (d + 1) * quota
        cols = []
        for i, col in enumerate(template):
            leaves = [torch.cat([src[i][k][lo:hi].to(dev) for src in staged])
                      for k in range(len(staged[0][i]))]
            cols.append(_with_leaves(col, leaves))
        # how many rows each source sent this device
        recv_counts = torch.stack([c[d].to(dev) for c in counts])
        live = (slot.to(dev)[None, :] < recv_counts[:, None]).reshape(-1)
        n = live.sum(dtype=torch.int32)
        # live rows first, in source order (a stable sort on the flag)
        idx = torch.sort((~live).to(torch.uint8), stable=True).indices
        received = ColumnBatch(batches[0].schema, cols, n, P * quota)
        out.append(received.take(idx, n))
    overflow = torch.stack([o.to(devices[0]) for o in overflows]).sum()
    return out, overflow


def mesh_shuffle_batch(batches: Sequence[ColumnBatch],
                       key_indices: Sequence[int],
                       devices: Sequence[torch.device], num_partitions: int,
                       quota: Optional[int] = None,
                       ) -> Tuple[List[ColumnBatch], torch.Tensor]:
    """Hash-repartition per-device batches across the devices, one
    partition a device: the single-call equivalent of the reference's
    ShuffleWriter + IpcReader pair for the on-host case."""
    quota = quota or batches[0].capacity
    pids = [partition_ids(b, key_indices, num_partitions) for b in batches]
    return staged_all_to_all(batches, pids, devices, num_partitions, quota)


def mesh_shuffle_batch_grouped(batches: Sequence[ColumnBatch],
                               key_indices: Sequence[int],
                               devices: Sequence[torch.device],
                               num_partitions: int, parts_per_device: int,
                               quota: int,
                               ) -> Tuple[List[ColumnBatch],
                                          List[torch.Tensor], torch.Tensor]:
    """P = D * parts_per_device logical partitions over D devices. Device
    d OWNS partitions [d*k, (d+1)*k): rows go to their owner in one
    exchange (`quota` rows a destination device a source device), then
    each device groups what it received by logical partition.

    Returns (a batch a device, sorted by logical partition with live rows
    first; a (k,) row count of each owned partition a device; the total
    overflow)."""
    P, k, D = num_partitions, parts_per_device, len(devices)
    owners = []
    for b in batches:
        pid = partition_ids(b, key_indices, P)
        # padding rows carry the sentinel group D
        owners.append(torch.where(pid >= P, torch.full_like(pid, D),
                                  pid // k))
    received, overflow = staged_all_to_all(batches, owners, devices, D,
                                           quota)
    grouped, counts = [], []
    for d, rb in enumerate(received):
        # the local grouping: received rows by logical partition (live
        # rows first, input order kept)
        rpid = partition_ids(rb, key_indices, P)
        spid, order = torch.sort(rpid, stable=True)
        grouped.append(rb.take(order, rb.num_rows))
        bounds = torch.searchsorted(spid, torch.arange(
            d * k, d * k + k + 1, dtype=spid.dtype, device=spid.device))
        counts.append((bounds[1:] - bounds[:-1]).to(torch.int32))
    return grouped, counts, overflow
