"""Batch ingestion from registered export iterators.

Port of `FfiReaderExec` and `_call_provider` from blaze_tpu/ops/shuffle.py
(ref: ffi_reader_exec.rs). The shuffle writers and IPC readers/writers of
that module are not ported yet.
"""

from __future__ import annotations

import inspect

from blaze_tpu_torch.columnar.batch import ColumnBatch
from blaze_tpu_torch.columnar.types import Schema
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.runtime import resources


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


class FfiReaderExec(Operator):
    """Ref: ffi_reader_exec.rs — pulls batches from a registered export
    iterator. The provider yields ready `ColumnBatch`es; pyarrow
    RecordBatches need columnar/arrow_io.py, which comes with the serde
    slice (columnar/serde.py)."""

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
            source = _call_provider(resources.get(self.export_resource_id),
                                    ctx)
            for item in source:
                ctx.check_running()
                if not isinstance(item, ColumnBatch):
                    raise NotImplementedError(
                        f"FfiReaderExec input {type(item).__name__}: "
                        "pyarrow ingestion (columnar/arrow_io.py) not yet "
                        "ported")
                yield item

        return count_stream(self, gen())
