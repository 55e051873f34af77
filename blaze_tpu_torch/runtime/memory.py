"""Memory manager: budgeted consumers with fair-share spilling.

Port of blaze_tpu/runtime/memory.py, whole (ref: datafusion-ext-plans
common/memory_manager.rs). Operator state that
lives on the device (sort buffers, aggregation state) registers as a
`MemConsumer`; a consumer that grows calls `update_mem_used`, and over the
budget the grower, or else the largest other consumer, is asked to
`spill()`.

The budget models device memory: `conf.memory_budget`, or 1 GiB as in the
JAX package. A consumer spills to the host through `SpillFile`: serde
frames in a pid-tagged tempfile under `conf.spill_dir`, each frame's crc
checked before any frame decodes. Frames written but not yet synced to
disk are host pages that count against the budget until the manager
flushes them. Batches in flight between a pipeline's I/O thread and its
consumer (runtime/pipeline.py) are reserved against the budget too
(`reserve_pipeline`), as are per-tenant quotas (`set_tenant_quotas`).
Spill reads run ahead on the I/O pool (`pipeline.prefetch`). The fault
points `spill.write`, `spill.read` and `corrupt.spill` are the JAX
module's; a corrupt spill file is quarantined and the task's retry
rebuilds it.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
import weakref
import zlib
from typing import BinaryIO, Iterator, List, Optional

from blaze_tpu_torch.columnar import serde
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import DeviceLike
from blaze_tpu_torch.runtime import monitor, trace


class MemConsumer:
    """Spillable operator state (ref MemConsumer trait)."""

    name: str = "consumer"

    def mem_used(self) -> int:
        return 0

    def spill(self) -> int:
        """Release memory; returns bytes freed."""
        return 0


class MemManager:
    def __init__(self, total: Optional[int] = None) -> None:
        self.total = total or conf.memory_budget or (1 << 30)
        self._consumers: List[MemConsumer] = []
        self._lock = threading.Lock()
        # serializes consumer-state mutation against host-driven release():
        # consumers hold it while adding state, release() while spilling.
        # RLock so a consumer's add -> update_mem_used -> spill re-enters
        self.op_lock = threading.RLock()
        self.spill_count = 0
        self.spilled_bytes = 0
        # host spill pages (SpillFile frames written but not yet synced to
        # disk) count toward the budget but are not consumers: a spill
        # file is a sink, not spillable state, and must not join the
        # fair_share() denominator. Weak refs, so tracking never keeps a
        # dropped file (and its tempfile) alive.
        self._spill_files: List[weakref.ref] = []
        self.host_spill_bytes = 0
        self.host_spill_files = 0
        # bytes held by in-flight pipelined batches (runtime/pipeline.py)
        # between production on an I/O thread and consumption: on the
        # budget, but not a consumer (they cannot be spilled; an
        # over-budget pipeline stops producing instead)
        self.pipeline_reserved = 0
        # high-water mark of mem_used(), observed at every consumer growth
        self.peak_used = 0
        # per-tenant ceilings (conf.tenant_quota_spec): consumers and
        # pipeline reservations carry the registering thread's tenant
        # (trace context). Empty: the single-tenant fast path
        self._quotas: dict = {}
        self._tenant_of: dict = {}          # id(consumer) -> tenant id
        self._tenant_pipeline: dict = {}    # tenant id -> reserved bytes

    # -- registry --
    def register(self, consumer: MemConsumer) -> None:
        tid = trace.current_context().get("tenant_id", "")
        with self._lock:
            self._consumers.append(consumer)
            if tid:
                self._tenant_of[id(consumer)] = tid

    def unregister(self, consumer: MemConsumer) -> None:
        with self._lock:
            if consumer in self._consumers:
                self._consumers.remove(consumer)
            self._tenant_of.pop(id(consumer), None)

    def track_spill(self, sf: "SpillFile") -> None:
        with self._lock:
            self._spill_files.append(weakref.ref(sf))
            self.host_spill_files += 1

    def untrack_spill(self, sf: "SpillFile") -> None:
        with self._lock:
            self._spill_files = [r for r in self._spill_files
                                 if r() is not None and r() is not sf]

    def _live_spill_files(self) -> List["SpillFile"]:
        with self._lock:
            live = [(r, r()) for r in self._spill_files]
            self._spill_files = [r for r, sf in live if sf is not None]
            return [sf for _, sf in live if sf is not None]

    def _consumers_snapshot(self) -> List[MemConsumer]:
        with self._lock:
            return list(self._consumers)

    # -- accounting --
    def mem_used(self) -> int:
        consumed = sum(c.mem_used() for c in self._consumers_snapshot())
        with self._lock:
            reserved = self.pipeline_reserved
        return consumed + self.spill_pages_pending() + reserved

    def reserve_pipeline(self, nbytes: int) -> None:
        """Charge an in-flight pipelined batch against the budget (and the
        reserving thread's tenant when quotas are set)."""
        with self._lock:
            self.pipeline_reserved += int(nbytes)
            if self._quotas:
                tid = trace.current_context().get("tenant_id", "")
                if tid:
                    self._tenant_pipeline[tid] = \
                        self._tenant_pipeline.get(tid, 0) + int(nbytes)

    def release_pipeline(self, nbytes: int) -> None:
        with self._lock:
            self.pipeline_reserved -= int(nbytes)
            if self._quotas:
                tid = trace.current_context().get("tenant_id", "")
                if tid and tid in self._tenant_pipeline:
                    self._tenant_pipeline[tid] -= int(nbytes)

    def spill_pages_pending(self) -> int:
        """Bytes written to tracked spill files and not yet synced."""
        return sum(sf.pending_bytes for sf in self._live_spill_files())

    def flush_spill_pages(self) -> int:
        """Sync every tracked spill file's buffered frames to disk; returns
        the pending bytes given back to the budget."""
        freed = sum(sf.flush_pages() for sf in self._live_spill_files())
        if freed > 0:
            trace.event("spill_pages_flush", freed_bytes=freed)
        return freed

    def observe_peak(self) -> int:
        used = self.mem_used()
        if used > self.peak_used:
            self.peak_used = used
        return used

    def reset_peak(self) -> None:
        self.peak_used = 0

    def fair_share(self) -> int:
        with self._lock:
            n = max(len(self._consumers), 1)
        return self.total // n

    # -- tenant quotas --
    def set_tenant_quotas(self, spec: Optional[dict]) -> None:
        """Install per-tenant ceilings from conf.tenant_quota_spec: int
        values are bytes, floats in (0, 1] fractions of the budget.
        None or {} clears them."""
        quotas: dict = {}
        for tid, v in (spec or {}).items():
            if isinstance(v, float) and 0 < v <= 1:
                quotas[tid] = int(self.total * v)
            else:
                quotas[tid] = int(v)
        with self._lock:
            self._quotas = quotas
            self._tenant_pipeline = {}

    def tenant_quota(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._quotas.get(tenant)

    def _tenant_consumers(self, tenant: str) -> List[MemConsumer]:
        with self._lock:
            return [c for c in self._consumers
                    if self._tenant_of.get(id(c), "") == tenant]

    def tenant_used(self, tenant: str) -> int:
        used = sum(c.mem_used() for c in self._tenant_consumers(tenant))
        with self._lock:
            return used + self._tenant_pipeline.get(tenant, 0)

    def tenant_usage(self) -> dict:
        """{tenant: bytes in use} over every tenant with tagged state or
        a declared quota."""
        with self._lock:
            tids = (set(self._quotas) | set(self._tenant_of.values())
                    | set(self._tenant_pipeline))
        return {tid: self.tenant_used(tid) for tid in sorted(tids)}

    def update_mem_used(self, updater: MemConsumer) -> None:
        """Called by a consumer after growing; spills if over budget.

        As memory_manager.rs:236-323: a grower holding more than 1/8 of
        its fair share spills itself, otherwise the largest other
        consumer is asked first. An over-quota tenant first sheds its own
        state (the grower, then its largest sibling), and with quotas set
        the global spill pressure stays inside the grower's tenant while
        it has spillable state."""
        used = self.observe_peak()
        with self._lock:
            tenant = (self._tenant_of.get(id(updater), "")
                      if self._quotas else "")
            quota = self._quotas.get(tenant)
        if quota:
            t_over = self.tenant_used(tenant) - quota
            if t_over > 0:
                trace.event("tenant_over_quota", tenant_id=tenant,
                            over_bytes=t_over, quota_bytes=quota)
                freed = updater.spill()
                self._note_spill(freed)
                t_over -= freed
                while t_over > 0:
                    sibs = sorted(
                        (c for c in self._tenant_consumers(tenant)
                         if c is not updater and c.mem_used() > 0),
                        key=lambda c: -c.mem_used())
                    if not sibs:
                        break
                    freed = sibs[0].spill()
                    self._note_spill(freed)
                    if freed <= 0:
                        break
                    t_over -= freed
                used = self.mem_used()
        if used <= self.total:
            return
        # cheapest reclaim first: sync buffered spill pages to disk
        used -= self.flush_spill_pages()
        if used <= self.total:
            return
        over = used - self.total
        if updater.mem_used() > self.fair_share() // 8:
            freed = updater.spill()
            self._note_spill(freed)
            over -= freed
        while over > 0:
            others = sorted((c for c in self._consumers_snapshot()
                             if c is not updater and c.mem_used() > 0),
                            key=lambda c: -c.mem_used())
            if tenant:
                with self._lock:
                    same = [c for c in others
                            if self._tenant_of.get(id(c), "") == tenant]
                if same:
                    others = same
            victim = others[0] if others else (
                updater if updater.mem_used() > 0 else None)
            if victim is None:
                break
            freed = victim.spill()
            self._note_spill(freed)
            if freed <= 0:
                break
            over -= freed

    def _note_spill(self, freed: int) -> None:
        if freed > 0:
            self.spill_count += 1
            self.spilled_bytes += freed
            trace.event("spill", spill_bytes=freed)

    def release(self, bytes_needed: int,
                tenant: Optional[str] = None) -> int:
        """Host-driven reclamation (ref OnHeapSpillManager.scala:61-144):
        spill the largest consumers first until `bytes_needed` is freed; a
        consumer that frees nothing is skipped. `tenant` scopes the sweep
        to one tenant's consumers (the degradation ladder's force-spill
        rung). Returns bytes freed."""
        freed = 0
        with self.op_lock:
            with self._lock:
                candidates = sorted(
                    (c for c in self._consumers
                     if not tenant
                     or self._tenant_of.get(id(c), "") == tenant),
                    key=lambda c: -c.mem_used())
            for c in candidates:
                if freed >= bytes_needed:
                    break
                if c.mem_used() <= 0:
                    continue
                got = c.spill()
                self._note_spill(got)
                freed += max(got, 0)
            if freed < bytes_needed:
                freed += self.flush_spill_pages()
        trace.event("mem_release", requested_bytes=bytes_needed,
                    freed_bytes=freed)
        return freed


_global = MemManager()


def get_manager(ctx=None) -> MemManager:
    if ctx is not None and getattr(ctx, "mem_manager", None) is not None:
        return ctx.mem_manager
    return _global


def init(total: int) -> MemManager:
    """Ref: MemManager::init(overhead x memoryFraction), exec.rs:68-71."""
    global _global
    _global = MemManager(total)
    return _global


def close_all_quietly(closeables, what: str) -> None:
    """Close every item best-effort. Cleanup runs during exception
    unwinding: one failing close must neither mask the original error nor
    stop the remaining closes, so failures are logged and swallowed."""
    for c in closeables:
        try:
            c.close()
        except Exception:  # noqa: BLE001 - cleanup boundary, logged
            logging.getLogger(__name__).warning(
                "closing %s failed", what, exc_info=True)


class SpillFile:
    """A sequence of serialized batches in a host tempfile (ref FileSpill,
    onheap_spill.rs:26-75; format: the serde frames)."""

    def __init__(self, schema: Schema,
                 manager: Optional[MemManager] = None) -> None:
        self.schema = schema
        d = conf.spill_dir
        os.makedirs(d, exist_ok=True)
        # pid-tagged name: runtime/artifacts.sweep_orphans reclaims spill
        # files whose owning process died mid-task
        fd, self.path = tempfile.mkstemp(
            prefix=f"blz{os.getpid()}-", suffix=".spill", dir=d)
        self._fp: Optional[BinaryIO] = os.fdopen(fd, "w+b")
        self.bytes_written = 0
        self.num_batches = 0
        # frames written but not yet synced: host pages on the budget
        self.pending_bytes = 0
        # (offset, crc32) of each frame, recorded at write time: a spill
        # never outlives its process, so the checksums live here rather
        # than in a footer, and reads verify the file against them first
        self._frame_crcs: list = []
        self._quarantined: list = []
        # where the spilled batches lived; reads decode back onto it
        self.device: DeviceLike = None
        self._manager = manager
        if manager is not None:
            manager.track_spill(self)

    def write(self, batch: ColumnBatch) -> int:
        """Append the batch's live rows as one frame (one device->host
        pull)."""
        if self.device is None:
            self.device = batch.device
        return self._append(serde.serialize_batch(batch))

    def write_host(self, hb: serde.HostBatch, lo: int, hi: int) -> int:
        """Append rows [lo, hi) of a batch already on the host as one
        frame: a sorted run pulled once is cut into many frames."""
        return self._append(hb.serialize(lo, hi))

    def _append(self, buf: bytes) -> int:
        # the frame is already serialized (that bills serde_encode): the
        # spill term is the injected stall and the file write
        t0 = time.perf_counter_ns()
        if conf.fault_injection_spec:
            from blaze_tpu_torch.runtime import faults

            faults.inject("spill.write")
        if conf.artifact_checksums:
            self._frame_crcs.append((self.bytes_written, zlib.crc32(buf)))
        self._fp.write(buf)
        n = len(buf)
        self.bytes_written += n
        self.num_batches += 1
        self.pending_bytes += n
        if self._manager is not None:
            self._manager.host_spill_bytes += n
        if conf.monitor_enabled:
            monitor.count_copy("spill", n)
            monitor.count_time("spill", time.perf_counter_ns() - t0)
        return n

    def flush_pages(self) -> int:
        """Sync buffered frames to disk; returns the pending bytes freed."""
        freed = self.pending_bytes
        if self._fp is not None and freed:
            self._fp.flush()
            os.fsync(self._fp.fileno())
        self.pending_bytes = 0
        return freed

    def _verify_frames(self) -> None:
        """Check the file against the write-time frame crcs before any
        frame decodes. A mismatch quarantines the file and raises
        CorruptArtifactError, which is retryable: the task's retry
        rebuilds its spill from the input stream."""
        from blaze_tpu_torch.runtime import artifacts, faults

        if not conf.artifact_checksums:
            return
        faults.maybe_corrupt("corrupt.spill", self.path)
        self._fp.seek(0)
        try:
            frames, _crc = artifacts.walk_frames(self._fp)
            ok = frames == self._frame_crcs
        except ValueError:
            ok = False
        if not ok:
            qpath = artifacts.note_corruption(
                self.path, "spill frame checksum mismatch")
            if qpath:
                self._quarantined.append(qpath)
            raise faults.CorruptArtifactError(
                f"spill checksum mismatch in {self.path} (quarantined)")

    def _rewind(self) -> None:
        t0 = time.perf_counter_ns()
        if conf.fault_injection_spec:
            from blaze_tpu_torch.runtime import faults

            faults.inject("spill.read")
        self.flush_pages()
        self._verify_frames()
        self._fp.seek(0)
        if conf.monitor_enabled:
            # the whole file is about to be re-read, counted up front; the
            # frame reads bill serde_decode, the spill term the fsync
            monitor.count_copy("spill", self.bytes_written)
            monitor.count_time("spill", time.perf_counter_ns() - t0)

    def read(self, device: DeviceLike = None) -> Iterator[ColumnBatch]:
        """The spilled batches, decoded onto `device` (default: the device
        they were spilled from). Frames are read and decoded ahead on the
        I/O pool, the readahead charged against the budget, so a merge
        cannot re-inflate the memory the spill shed."""
        from blaze_tpu_torch.runtime import pipeline

        self._rewind()
        return pipeline.prefetch(
            serde.read_batches(self._fp, self.schema,
                               device=device or self.device),
            manager=self._manager, name="spill_read")

    def read_host(self) -> Iterator[serde.HostBatch]:
        """The frames as host batches: the spill merge consumes runs on the
        host (ops/host_sort.py). Read ahead on the I/O pool like `read`."""
        from blaze_tpu_torch.runtime import pipeline

        self._rewind()
        return pipeline.prefetch(
            serde.read_batches_host(self._fp, self.schema),
            manager=self._manager, name="spill_read")

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
            self.pending_bytes = 0
            if self._manager is not None:
                self._manager.untrack_spill(self)
            try:
                os.unlink(self.path)
            except OSError:
                pass
            # a quarantined spill is evidence only: the retry rebuilds
            # the data, so closing reclaims it
            for q in self._quarantined:
                try:
                    os.unlink(q)
                except OSError:
                    pass
            self._quarantined = []

    def __del__(self):
        self.close()


def batch_nbytes(batch: ColumnBatch) -> int:
    """Device bytes of a batch (capacity-based, validity included); reads
    shapes only, never the device."""
    return sum(_col_nbytes(c) for c in batch.columns)


def _col_nbytes(c) -> int:
    """A list column counts its offsets and its element storage at the
    element capacity, so collect state is charged against the budget."""
    d = c.data
    if c.is_dict:
        # the encoded form: codes and the small dictionary, not the
        # expanded (capacity, width) matrix
        total = (4 * d.codes.shape[0] + d.dict_bytes.numel()
                 + 4 * d.dict_lengths.shape[0])
    elif c.is_string:
        total = d.bytes.numel() + 4 * d.lengths.shape[0]
    elif c.is_list:
        total = 4 * d.offsets.shape[0] + _col_nbytes(d.elements)
    elif c.is_struct:
        total = sum(_col_nbytes(ch) for ch in d.children)
    else:
        total = d.numel() * d.element_size()
    if c.validity is not None:
        total += c.validity.numel()
    return total
