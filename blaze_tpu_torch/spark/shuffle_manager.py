"""Drop-in shuffle-manager surface over the engine's .data/.index format.

Port of blaze_tpu/spark/shuffle_manager.py. Ref: the reference ships
`BlazeShuffleManager` as a `spark.shuffle.manager` drop-in (shims
`shuffle/*.scala`): `registerShuffle` returns a handle, `getWriter` gives
a map task a writer that commits Spark-format shuffle files through
`IndexShuffleBlockResolver`, `getReader` gives a reduce task an iterator
over the fetched blocks, and MapStatus (the per-partition lengths parsed
from the `.index` file, BlazeShuffleWriterBase.scala:84-96) is what the
driver tracks for fetch planning.

This module is that API over the engine's file format (ops/shuffle.py
writes concatenated per-partition frame streams + a little-endian u64
offsets index with a checksum footer). The local runner drives it for
every file-path exchange. A corrupt index found at commit is quarantined
and repaired through the map task's lineage (runtime/artifacts.py), and
the commit goes on with the repaired pair.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.device import DeviceLike
from blaze_tpu_torch.ops.shuffle import read_shuffle_partition


@dataclass(frozen=True)
class ShuffleHandle:
    """What registerShuffle hands back (ref: BaseShuffleHandle)."""
    shuffle_id: int
    num_partitions: int
    schema: Schema


@dataclass(frozen=True)
class MapStatus:
    """One map task's committed output (ref: Spark MapStatus — location +
    per-reduce-partition lengths, parsed from the .index file)."""
    map_id: int
    data_path: str
    index_path: str
    partition_lengths: tuple

    @property
    def total_bytes(self) -> int:
        return int(sum(self.partition_lengths))


class ShuffleWriteSlot:
    """getWriter result: where a map task must commit, plus the commit
    handshake (parse .index -> MapStatus -> register with the manager),
    mirroring BlazeShuffleWriterBase.nativeShuffleWrite + Shims.commit."""

    def __init__(self, manager: "BlazeShuffleManager",
                 handle: ShuffleHandle, map_id: int) -> None:
        self._manager = manager
        self.handle = handle
        self.map_id = map_id
        base = os.path.join(manager.work_dir,
                            f"shuffle_{handle.shuffle_id}_{map_id}")
        self.data_path = base + ".data"
        self.index_path = base + ".index"

    def commit(self) -> MapStatus:
        """Parse the committed .index into partition lengths and register
        the MapStatus (ref: BlazeShuffleWriterBase.scala:84-109).
        artifacts.read_index strips (and verifies) the checksum footer
        before the offsets are interpreted; a corrupt index is
        quarantined and repaired through the registered lineage closure
        before the commit goes on with the repaired pair."""
        from blaze_tpu_torch.runtime import artifacts

        try:
            raw, _meta = artifacts.read_index(self.index_path)
        except artifacts.CorruptArtifactError as e:
            self.data_path, self.index_path = artifacts.handle_corruption(
                self.data_path, self.index_path, str(e))
            raw, _meta = artifacts.read_index(self.index_path)
        offsets = np.frombuffer(raw, "<u8")
        expected = self.handle.num_partitions + 1
        if len(offsets) != expected:
            raise ValueError(
                f".index has {len(offsets)} offsets, expected {expected}")
        lengths = tuple(int(offsets[i + 1] - offsets[i])
                        for i in range(self.handle.num_partitions))
        status = MapStatus(self.map_id, self.data_path, self.index_path,
                           lengths)
        self._manager._register_map_output(self.handle.shuffle_id, status)
        return status


class BlazeShuffleManager:
    """registerShuffle / getWriter / getReader / unregisterShuffle over
    .data/.index files (ref: BlazeShuffleManager in the shims)."""

    def __init__(self, work_dir: str) -> None:
        from blaze_tpu_torch.runtime import artifacts

        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        # a previous executor killed mid-commit leaves .inprogress. temps
        # (never final names) in the shared work dir — reclaim them now
        artifacts.sweep_orphans([work_dir])
        self._handles: Dict[int, ShuffleHandle] = {}
        self._map_outputs: Dict[int, List[MapStatus]] = {}

    # -- driver side --------------------------------------------------

    def register_shuffle(self, shuffle_id: int, num_partitions: int,
                         schema: Schema) -> ShuffleHandle:
        if shuffle_id in self._handles:
            raise ValueError(f"shuffle {shuffle_id} already registered")
        handle = ShuffleHandle(shuffle_id, num_partitions, schema)
        self._handles[shuffle_id] = handle
        self._map_outputs[shuffle_id] = []
        return handle

    def handle(self, shuffle_id: int) -> ShuffleHandle:
        """The registered handle of `shuffle_id` (its partition count and
        the schema its map outputs were written with)."""
        return self._handles[shuffle_id]

    def unregister_shuffle(self, shuffle_id: int,
                           delete_files: bool = True) -> None:
        from blaze_tpu_torch.runtime import artifacts

        self._handles.pop(shuffle_id, None)
        for st in self._map_outputs.pop(shuffle_id, []):
            # the lineage-repair registration dies with its output, and so
            # does the redirect from the slot's first name to a repaired
            # pair: a later query reusing the work dir writes that name
            # again and must not be sent to the quarantined lineage
            artifacts.forget_repair(st.data_path)
            artifacts.forget_repair(os.path.join(
                self.work_dir, f"shuffle_{shuffle_id}_{st.map_id}.data"))
            if delete_files:
                for p in (st.data_path, st.index_path):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    # -- map side -----------------------------------------------------

    def get_writer(self, handle: ShuffleHandle, map_id: int
                   ) -> ShuffleWriteSlot:
        return ShuffleWriteSlot(self, handle, map_id)

    def _register_map_output(self, shuffle_id: int,
                             status: MapStatus) -> None:
        # replace-by-map_id, not append: a re-committed map output must
        # not be read twice
        outputs = self._map_outputs[shuffle_id]
        for i, st in enumerate(outputs):
            if st.map_id == status.map_id:
                outputs[i] = status
                return
        outputs.append(status)

    # -- reduce side ----------------------------------------------------

    def map_statuses(self, shuffle_id: int) -> List[MapStatus]:
        return list(self._map_outputs.get(shuffle_id, []))

    def total_bytes(self, shuffle_id: int) -> int:
        return sum(st.total_bytes for st in self.map_statuses(shuffle_id))

    def get_reader(self, handle: ShuffleHandle, partition: int,
                   device: DeviceLike = None) -> Iterator[ColumnBatch]:
        """All map outputs' segment `partition` (the MapStatus-tracked
        fetch; local FileSegment zero-copy path of
        BlazeBlockStoreShuffleReaderBase.readIpc), decoded onto `device`
        (None: the CUDA card)."""
        statuses = self._map_outputs.get(handle.shuffle_id)
        if statuses is None:
            raise KeyError(f"shuffle {handle.shuffle_id} not registered")

        def gen():
            for st in statuses:
                if st.partition_lengths[partition] == 0:
                    continue  # MapStatus says empty: skip the fetch
                yield from read_shuffle_partition(
                    st.data_path, st.index_path, partition, handle.schema,
                    device=device)
        return gen()

    def get_all_partitions_reader(self, handle: ShuffleHandle,
                                  device: DeviceLike = None
                                  ) -> Iterator[ColumnBatch]:
        """Every partition of every map output: Spark's local-shuffle-
        reader shape that AQE's SMJ->BHJ conversion reads build sides
        with (spark/aqe.py)."""
        def gen():
            for p in range(handle.num_partitions):
                yield from self.get_reader(handle, p, device=device)
        return gen()

    def get_reader_host(self, handle: ShuffleHandle, partition: int):
        """Host-frame variant of get_reader: yields serde.HostBatch so
        IpcReaderExec can coalesce all of a partition's frames into one
        macro-batch device upload (ops/shuffle.py host coalescing)."""
        from blaze_tpu_torch.ops.shuffle import read_shuffle_partition_host

        statuses = self._map_outputs.get(handle.shuffle_id)
        if statuses is None:
            raise KeyError(f"shuffle {handle.shuffle_id} not registered")

        def gen():
            for st in statuses:
                if st.partition_lengths[partition] == 0:
                    continue
                yield from read_shuffle_partition_host(
                    st.data_path, st.index_path, partition, handle.schema)
        # readahead happens in the consumer (IpcReaderExec wraps every
        # provider stream in pipeline.prefetch with the task's kill scope
        # and memory budget); this stays a plain generator
        return gen()
