"""Memory manager: budgeted consumers with fair-share spilling.

Port of the consumer registry and accounting of blaze_tpu/runtime/memory.py
(ref: datafusion-ext-plans common/memory_manager.rs). Operator state that
lives on the device (sort buffers, aggregation state) registers as a
`MemConsumer`; a consumer that grows calls `update_mem_used`, and over the
budget the grower, or else the largest other consumer, is asked to
`spill()`.

The budget models device memory: `conf.memory_budget`, or 1 GiB as in the
JAX package. Spilling to host files needs `SpillFile`, which rides the
frame format of columnar/serde.py, not yet ported: a consumer that still
holds too much after its in-device collapse raises NotImplementedError
naming columnar/serde.py. It never drops state or carries on over budget.
The tenant quotas, pipeline reservations and monitor hooks of the JAX
module wait for the service slice.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.config import conf

SPILL_MISSING = (
    "spilling device state to the host needs SpillFile over the frame "
    "format of columnar/serde.py, not yet ported")


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
        # high-water mark of mem_used(), observed at every consumer growth
        self.peak_used = 0

    # -- registry --
    def register(self, consumer: MemConsumer) -> None:
        with self._lock:
            self._consumers.append(consumer)

    def unregister(self, consumer: MemConsumer) -> None:
        with self._lock:
            if consumer in self._consumers:
                self._consumers.remove(consumer)

    def _consumers_snapshot(self) -> List[MemConsumer]:
        with self._lock:
            return list(self._consumers)

    # -- accounting --
    def mem_used(self) -> int:
        return sum(c.mem_used() for c in self._consumers_snapshot())

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

    def update_mem_used(self, updater: MemConsumer) -> None:
        """Called by a consumer after growing; spills if over budget.

        As memory_manager.rs:236-323: a grower holding more than 1/8 of
        its fair share spills itself, otherwise the largest other
        consumer is asked first."""
        used = self.observe_peak()
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

    def release(self, bytes_needed: int) -> int:
        """Host-driven reclamation (ref OnHeapSpillManager.scala:61-144):
        spill the largest consumers first until `bytes_needed` is freed; a
        consumer that frees nothing is skipped. Returns bytes freed."""
        freed = 0
        with self.op_lock:
            for c in sorted(self._consumers_snapshot(),
                            key=lambda c: -c.mem_used()):
                if freed >= bytes_needed:
                    break
                if c.mem_used() <= 0:
                    continue
                got = c.spill()
                self._note_spill(got)
                freed += max(got, 0)
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


def batch_nbytes(batch: ColumnBatch) -> int:
    """Device bytes of a batch (capacity-based, validity included); reads
    shapes only, never the device."""
    total = 0
    for c in batch.columns:
        total += c.data.numel() * c.data.element_size()
        if c.validity is not None:
            total += c.validity.numel()
    return total
