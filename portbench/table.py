"""The configuration's tables, made on the device from `--seed`.

A configuration lists its tables (`"tables": [{"name", "columns"}]`), each
with `<name>_rows` rows at its top level, cut into task partitions of
`batches_per_partition` batches of `batch_rows` rows. Each column of each
task partition is drawn by a `torch.Generator` on the device, seeded from
(seed, configuration, column, partition), in one call for the partition's
rows, by the draw that its `dist` names (draws/<dist>.py): the same seed
gives the same table, and a partition's rows do not depend on how many
partitions are held. Only the columns that the plan's steps read are made,
as Spark's column pruning hands a stage only those. A null slot holds 0
(the port's canonical form).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import Column, ColumnBatch
from portbench import spec

_TYPES = {"bool": (T.BOOLEAN, torch.bool), "int8": (T.INT8, torch.int8),
          "int16": (T.INT16, torch.int16), "int32": (T.INT32, torch.int32),
          "int64": (T.INT64, torch.int64),
          "float32": (T.FLOAT32, torch.float32),
          "float64": (T.FLOAT64, torch.float64)}


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one stream of the table."""
    h = hashlib.sha256("|".join(map(str, (seed,) + parts)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class Table:
    """One table's task partitions, resident on `device`: the columns
    `names`, in that order."""

    def __init__(self, config: dict, name: str, names: List[str], seed: int,
                 device: torch.device, partitions: Optional[int] = None,
                 batch_rows: Optional[int] = None,
                 batches_per_partition: Optional[int] = None) -> None:
        entry = next(t for t in config["tables"] if t["name"] == name)
        cols = {c["name"]: c for c in entry["columns"]}
        self.config = config
        self.name = name
        self.names = list(names)
        self.batch_rows = int(batch_rows or config["batch_rows"])
        self.batches = int(batches_per_partition
                           or config["batches_per_partition"])
        self.partitions = int(partitions or
                              config[f"{name}_rows"]
                              // self.rows_per_partition)
        self._cols = [cols[n] for n in self.names]
        self.types = {c["name"]: c["type"] for c in self._cols}
        self.schema = T.Schema([
            T.Field(c["name"], _TYPES[c["type"]][0], c["null_share"] > 0)
            for c in self._cols])
        self.device = device
        self.seed = seed
        self.parts: List[List[ColumnBatch]] = [
            self._partition(p) for p in range(self.partitions)]

    @property
    def rows_per_partition(self) -> int:
        return self.batch_rows * self.batches

    def _partition(self, p: int) -> List[ColumnBatch]:
        n, r = self.rows_per_partition, self.batch_rows
        name = self.config["name"]
        datas, valids = [], []
        for col in self._cols:
            g = _generator(self.device,
                           stream_seed(self.seed, name, col["name"], p))
            data = spec.part("draws", col["dist"]).draw(
                col, n, g, self.device, _TYPES[col["type"]][1])
            valid = None
            if col["null_share"] > 0:
                gv = _generator(self.device, stream_seed(
                    self.seed, name, col["name"], "valid", p))
                valid = torch.rand((n,), generator=gv, device=self.device,
                                   dtype=torch.float32) >= col["null_share"]
                data.masked_fill_(~valid, 0)
                valid = valid.view(self.batches, r)
            datas.append(data.view(self.batches, r))
            valids.append(valid)
        batches = []
        for b in range(self.batches):
            columns = [Column(f.dtype, d[b], None if v is None else v[b])
                       for f, d, v in zip(self.schema, datas, valids)]
            batches.append(ColumnBatch(
                self.schema, columns,
                torch.tensor(r, dtype=torch.int32, device=self.device), r))
        return batches

    def batches_of(self, p: int, names: List[str]) -> List[ColumnBatch]:
        """Partition p's batches holding the columns `names`, sharing the
        table's tensors."""
        if names == self.names:
            return self.parts[p]
        idx = [self.names.index(n) for n in names]
        schema = T.Schema([self.schema.fields[i] for i in idx])
        return [ColumnBatch(schema, [b.columns[i] for i in idx],
                            b.num_rows, b.capacity) for b in self.parts[p]]

    def resident_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for part in self.parts for b in part for c in b.columns
                   for t in (c.data, c.validity) if t is not None)

    def host_columns(self, p: int, names: List[str]) -> Dict[
            str, Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Partition p's columns `names` on the host, for the reference:
        the same values that the program is handed."""
        out = {}
        for name in names:
            i = self.names.index(name)
            cols = [b.columns[i] for b in self.parts[p]]
            data = torch.cat([c.data for c in cols]).cpu().numpy()
            valid = None
            if cols[0].validity is not None:
                valid = torch.cat([c.validity for c in cols]).cpu().numpy()
            out[name] = (data, valid)
        return out


def tables(config: dict, plan: List[dict], seed: int, device: torch.device,
           shrink: Optional[dict] = None) -> Dict[str, Table]:
    """Every table that the plan's steps read, with the columns they read,
    made on the device; the plan's first table first."""
    needs: Dict[str, List[str]] = {}
    for leaf in spec.leaves(plan):
        cols = needs.setdefault(leaf["table"], [])
        cols += [c for c in leaf["columns"] if c not in cols]
    return {name: Table(config, name, cols, seed, device, **(shrink or {}))
            for name, cols in needs.items()}
