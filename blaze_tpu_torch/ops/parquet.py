"""ParquetScanExec / ParquetSinkExec — columnar file IO.

Port of blaze_tpu/ops/parquet.py (ref: datafusion-ext-plans
parquet_exec.rs — the scan with row-group pruning via pushed predicates,
all file IO through a JVM Hadoop FileSystem resource, ignoreCorruptFiles
— and parquet_sink_exec.rs, Arrow->parquet into Hive-compatible part
files).

pyarrow decodes the pages on the host, as arrow-rs does on the CPU in the
reference; each decoded Arrow batch goes to `ctx.device` in one copy a
column (columnar/arrow_io.py). Row groups whose min/max statistics prove
a pushed predicate false are skipped before any data page is read
(`row_groups_pruned`). The scan runs under runtime/pipeline.prefetch: the
next batch is read, decoded and uploaded on an I/O thread while the
device works on this one (inline with conf.enable_pipeline off).

The sink writes the same files as the JAX package's sink: the same rows,
the same row groups, under the same names, and yields the same one stats
row (path, num_rows, num_bytes).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.arrow_io import (
    batch_from_arrow, batch_to_arrow, schema_to_arrow,
)
from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import Field, Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.runtime import filesystem, resources

logger = logging.getLogger(__name__)

_FLIP = {ir.BinOp.LT: ir.BinOp.GT, ir.BinOp.LE: ir.BinOp.GE,
         ir.BinOp.GT: ir.BinOp.LT, ir.BinOp.GE: ir.BinOp.LE,
         ir.BinOp.EQ: ir.BinOp.EQ}


def _stat_prune(expr: ir.Expr, stats: Dict[str, Tuple]) -> bool:
    """True if the row group can be SKIPPED based on min/max stats.

    Conservative: only simple `col <op> literal` comparisons (and ANDs of
    them) prune; everything else keeps the group (ref: row-group pruning
    via pushed predicates, parquet_exec.rs:218-239)."""
    if not isinstance(expr, ir.Binary):
        return False
    if expr.op == ir.BinOp.AND:
        return _stat_prune(expr.left, stats) or _stat_prune(expr.right,
                                                            stats)
    left, right = expr.left, expr.right
    if isinstance(left, ir.Literal) and isinstance(right, ir.Col):
        if expr.op not in _FLIP:
            return False
        return _stat_prune(ir.Binary(_FLIP[expr.op], right, left), stats)
    if not (isinstance(left, ir.Col) and isinstance(right, ir.Literal)):
        return False
    st = stats.get(left.name)
    if st is None or st[0] is None or st[1] is None or right.value is None:
        return False
    mn, mx = st
    v = right.value
    try:
        if expr.op == ir.BinOp.EQ:
            return v < mn or v > mx
        if expr.op == ir.BinOp.LT:
            return mn >= v
        if expr.op == ir.BinOp.LE:
            return mn > v
        if expr.op == ir.BinOp.GT:
            return mx <= v
        if expr.op == ir.BinOp.GE:
            return mx < v
    except TypeError:
        return False
    return False


class ParquetScanExec(Operator):
    """One task partition's parquet files -> batches on `ctx.device`."""

    def __init__(self, files: Sequence[Tuple[str, list]],
                 file_schema: Schema,
                 projection: Sequence[int],
                 partition_schema: Optional[Schema] = None,
                 pruning_predicates: Sequence[ir.Expr] = (),
                 fs_resource_id: Optional[str] = None,
                 batch_rows: Optional[int] = None) -> None:
        super().__init__([])
        self.files = list(files)
        self.file_schema = file_schema
        self.projection = list(projection) or list(
            range(len(file_schema.fields)))
        self.partition_schema = partition_schema or Schema([])
        self.pruning_predicates = list(pruning_predicates)
        self.fs_resource_id = fs_resource_id
        self.batch_rows = batch_rows  # None -> adaptive (execute time)

        read_fields = [file_schema.fields[i] for i in self.projection]
        self._read_schema = Schema(read_fields)
        self._schema = Schema(read_fields +
                              list(self.partition_schema.fields))

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("parquet_scan", tuple(self._schema.names()))

    def _open(self, path: str):
        if self.fs_resource_id:
            fs = resources.get(self.fs_resource_id)
            return fs(path) if callable(fs) else fs.open(path)
        # default resolver: scheme:// URIs route through fsspec, local
        # paths pass through for pyarrow to open directly
        return filesystem.open_input(path)

    def execute(self, ctx: ExecContext) -> BatchStream:
        from blaze_tpu_torch.ops.common import adaptive_batch_rows

        def gen():
            batch_rows = self.batch_rows or adaptive_batch_rows(
                self._schema, ctx.mem_manager)
            names = self._read_schema.names()
            for path, part_values in self.files:
                ctx.check_running()
                try:
                    pf = pq.ParquetFile(self._open(path))
                except Exception:
                    if conf.ignore_corrupt_files:
                        logger.warning("ignoring corrupt file %s", path)
                        continue
                    raise
                with pf:  # closes the underlying (fs-provided) handle
                    groups = self._select_row_groups(pf)
                    self.metrics.add("row_groups_pruned",
                                     pf.num_row_groups - len(groups))
                    if not groups:
                        continue
                    for rb in pf.iter_batches(batch_size=batch_rows,
                                              row_groups=groups,
                                              columns=names):
                        ctx.check_running()
                        with self.metrics.timer("io_time_ns"):
                            batch = self._to_device(rb, part_values,
                                                    ctx.device)
                        self.metrics.add("bytes_scanned", rb.nbytes)
                        yield batch

        from blaze_tpu_torch.runtime import memory as M, pipeline

        # the next macro-batch's read, decode and upload run on the I/O
        # pool while downstream computes on this one
        return count_stream(self, pipeline.prefetch(
            gen(), ctx=ctx, manager=M.get_manager(ctx), name="parquet_scan"))

    def _select_row_groups(self, pf) -> List[int]:
        if not self.pruning_predicates:
            return list(range(pf.num_row_groups))
        keep = []
        meta = pf.metadata
        for g in range(pf.num_row_groups):
            rg = meta.row_group(g)
            stats: Dict[str, Tuple] = {}
            for c in range(rg.num_columns):
                col = rg.column(c)
                st = col.statistics
                if st is not None and st.has_min_max:
                    stats[col.path_in_schema] = (st.min, st.max)
            if not any(_stat_prune(p, stats)
                       for p in self.pruning_predicates):
                keep.append(g)
        return keep

    def _to_device(self, rb: pa.RecordBatch, part_values: list,
                   device) -> ColumnBatch:
        base = batch_from_arrow(rb, schema=self._read_schema, device=device)
        if not self.partition_schema.fields:
            return base
        # hive partition columns: per-file constant literals (ref
        # NativeParquetScanBase partition values as literals)
        from blaze_tpu_torch.exprs.compiler import compile_expr

        cols = list(base.columns)
        for f, v in zip(self.partition_schema.fields, part_values):
            lit = v if isinstance(v, ir.Literal) else _scalar_to_literal(v, f)
            cols.append(compile_expr(lit, base.schema)(base))
        return base.with_columns(self._schema, cols)


def _scalar_to_literal(v, f: Field) -> ir.Literal:
    from blaze_tpu_torch.plan.from_proto import decode_scalar

    if hasattr(v, "dtype"):  # pb.ScalarValue
        return decode_scalar(v)
    return ir.Literal(f.dtype, v)


class ParquetSinkExec(Operator):
    """Arrow->parquet writer (ref parquet_sink_exec.rs; used by the
    NativeParquetInsertIntoHiveTable path). Writes one part file a task
    and yields one stats row (path, num_rows, num_bytes)."""

    STATS_SCHEMA = Schema([Field("path", T.STRING, nullable=False),
                           Field("num_rows", T.INT64, nullable=False),
                           Field("num_bytes", T.INT64, nullable=False)])

    def __init__(self, child: Operator, path: str,
                 fs_resource_id: Optional[str] = None,
                 row_group_rows: Optional[int] = None,
                 props: Optional[Dict[str, str]] = None) -> None:
        super().__init__([child])
        self.path = path
        self.fs_resource_id = fs_resource_id
        self.row_group_rows = row_group_rows or 1 << 20
        self.props = props or {}

    @property
    def schema(self) -> Schema:
        return self.STATS_SCHEMA

    def plan_key(self) -> tuple:
        return ("parquet_sink", self.path, self.children[0].plan_key())

    def is_remote(self) -> bool:
        return bool(self.fs_resource_id) or (
            filesystem.path_scheme(self.path) is not None)

    @staticmethod
    def clear_stale_parts(path: str) -> None:
        """Overwrite semantics for a local multi-task write: re-running
        into the same path must not leave a previous run's higher-numbered
        parts behind. Call it before any task of the new run is
        dispatched: clearing from inside a task races task scheduling and
        can delete parts the current run already committed. In deployment
        the embedding layer's output-commit protocol owns this (ref: Hive
        temp+move semantics, NativeParquetInsertIntoHiveTableBase)."""
        os.makedirs(path, exist_ok=True)
        for stale in glob.glob(os.path.join(path, "part-*.parquet")):
            os.remove(stale)

    def _task_path(self, ctx: ExecContext) -> str:
        """Per-task part file (ref: Hive-compatible part files,
        parquet_sink_exec.rs): a multi-task stage writing ONE path would
        have every task truncate the previous tasks' rows. With one task
        the path is used as-is unless it already IS a part directory."""
        remote = self.is_remote()
        if ctx.num_partitions <= 1 and not (
                not remote and os.path.isdir(self.path)):
            return self.path
        if not remote:
            os.makedirs(self.path, exist_ok=True)
        return os.path.join(self.path, f"part-{ctx.partition:05d}.parquet")

    def execute(self, ctx: ExecContext) -> BatchStream:
        def gen():
            child = self.children[0]
            arrow_schema = schema_to_arrow(child.schema)
            out_path = self._task_path(ctx)
            if self.fs_resource_id:
                fs = resources.get(self.fs_resource_id)
                sink = fs(out_path) if callable(fs) else fs.open(out_path,
                                                                 "wb")
            else:
                sink = filesystem.open_output(out_path)
            compression = self.props.get("compression", "zstd")
            writer = pq.ParquetWriter(sink, arrow_schema,
                                      compression=compression)
            rows = 0
            try:
                for batch in child.execute(ctx):
                    ctx.check_running()
                    rb = batch_to_arrow(batch)
                    if rb.num_rows == 0:
                        continue
                    with self.metrics.timer("io_time_ns"):
                        writer.write_batch(rb,
                                           row_group_size=self.row_group_rows)
                    rows += rb.num_rows
            finally:
                writer.close()
                if not isinstance(sink, str) and hasattr(sink, "close"):
                    sink.close()
            nbytes = 0 if self.fs_resource_id else filesystem.size(out_path)
            self.metrics.add("output_rows_written", rows)
            yield ColumnBatch.from_numpy(
                {"path": [out_path], "num_rows": np.array([rows], np.int64),
                 "num_bytes": np.array([nbytes], np.int64)},
                self.STATS_SCHEMA, device=ctx.device)

        return count_stream(self, gen())

