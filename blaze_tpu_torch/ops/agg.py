"""AggExec — grouped aggregation, sort-based, partial/merge/final modes.

Port of blaze_tpu/ops/agg.py (ref: datafusion-ext-plans agg_exec.rs +
agg/): `AggMode`, `AggCall`, the typed state layout (`state_fields`),
result fields, and `AggExec`'s streaming execution. There are no hash
tables: rows are sorted by the grouping key (ops/sort_keys.py) and every
accumulator update is a segmented reduction (ops/segment.py). Input
batches fold into a pending set; when the pending rows reach
`collapse_threshold` they collapse into one state batch, and state batches
collapse into one. The whole-stage dense path (runtime/stage_compiler.py)
runs matching partial(+final) pairs without any of this.

The functions sum, count, avg, min, max, first and first_ignores_null run
over the dense column kinds in the modes PARTIAL, PARTIAL_MERGE and FINAL;
group keys, min, max, first and first_ignores_null also take strings.
collect_list and collect_set keep their state as a list column
(columnar/batch.py ListData) over dense and string values; a group whose
values are all null collects an empty list, not null. Sum, avg, min and
max over wide decimals (precision > 18) keep limb-plane state
(exprs/wide_decimal.py): an input rescaled into the state's scale with
`rescale_checked`, then segmented limb sums or min/max; a sum that
overflows is null, as in Spark non-ANSI. Over the memory budget,
collapsed state spills to host files (runtime/memory.SpillFile) and
merges back at the end. The JAX
module's jit cache and compile-service shape rungs have no counterpart:
PyTorch runs each step eagerly.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.columnar import int128 as i128
from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, ListData, bucket_capacity,
)
from blaze_tpu_torch.columnar.types import DataType, Field, Schema, TypeKind
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.device import resolve_device
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs import wide_decimal as W
from blaze_tpu_torch.exprs.compiler import compile_expr, cse_scope
from blaze_tpu_torch.ops import segment as seg
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.basic import infer_dtype
from blaze_tpu_torch.ops.common import concat_batches
from blaze_tpu_torch.ops.sort import truncate
from blaze_tpu_torch.ops.sort_keys import (
    SortSpec, encode_column, pack_keys, sort_batch, sort_permutation,
    string_words,
)
from blaze_tpu_torch.runtime import memory as M
from blaze_tpu_torch.runtime.metrics import to_host

AGG_BUF_PREFIX = "#9223372036854775807"  # ref agg/mod.rs:38


class AggMode(enum.Enum):
    PARTIAL = "partial"
    PARTIAL_MERGE = "partial_merge"
    FINAL = "final"


@dataclasses.dataclass(frozen=True)
class AggCall:
    """One aggregate expression (ref pb.AggFunction, blaze.proto:123-133)."""
    fn: str  # sum|avg|count|min|max|first|first_ignores_null|collect_*
    inputs: Tuple[ir.Expr, ...]
    dtype: DataType          # Spark result dtype (planner-provided)
    name: str

    def key(self) -> tuple:
        return (self.fn, tuple(e.key() for e in self.inputs),
                repr(self.dtype), self.name)


def _sum_state_dtype(d: DataType) -> DataType:
    # Spark sum: int family -> long, float family -> double, decimal widens
    if d.kind == TypeKind.DECIMAL:
        return d
    if d.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        return T.FLOAT64
    return T.INT64


def collect_state_dtype(call: AggCall) -> DataType:
    """List dtype of a collect_list/collect_set state/result column."""
    return (call.dtype if call.dtype.kind == TypeKind.LIST
            else T.list_of(call.dtype))


def state_fields(call: AggCall, i: int) -> List[Field]:
    """Typed state columns for one agg (named with the agg-buf convention)."""
    p = f"{AGG_BUF_PREFIX}.{i}"
    if call.fn == "sum":
        sd = _sum_state_dtype(call.dtype)
        return [Field(f"{p}.sum", sd), Field(f"{p}.nonempty", T.BOOLEAN)]
    if call.fn == "avg":
        sd = call.dtype if call.dtype.kind == TypeKind.DECIMAL else T.FLOAT64
        return [Field(f"{p}.sum", sd), Field(f"{p}.count", T.INT64)]
    if call.fn == "count":
        return [Field(f"{p}.count", T.INT64)]
    if call.fn in ("min", "max"):
        return [Field(f"{p}.val", call.dtype), Field(f"{p}.has", T.BOOLEAN)]
    if call.fn == "first":
        return [Field(f"{p}.val", call.dtype), Field(f"{p}.valid", T.BOOLEAN),
                Field(f"{p}.has", T.BOOLEAN)]
    if call.fn == "first_ignores_null":
        return [Field(f"{p}.val", call.dtype), Field(f"{p}.has", T.BOOLEAN)]
    if call.fn in ("collect_list", "collect_set"):
        return [Field(f"{p}.list", collect_state_dtype(call))]
    raise NotImplementedError(f"agg function {call.fn}")


def result_field(call: AggCall) -> Field:
    if call.fn == "count":
        return Field(call.name, T.INT64, nullable=False)
    if call.fn == "avg" and call.dtype.kind != TypeKind.DECIMAL:
        return Field(call.name, T.FLOAT64)
    if call.fn == "sum":
        return Field(call.name, _sum_state_dtype(call.dtype))
    return Field(call.name, call.dtype)


def _first_by_index(values_cols: Sequence[Column], layout, has
                    ) -> Tuple[List[Column], torch.Tensor]:
    """Gather several parallel state columns at each group's first row
    where `has`; returns the gathered columns and ok."""
    cap = has.shape[0]
    iota = torch.arange(cap, dtype=torch.int64, device=has.device)
    idx, ok = seg.seg_first(iota, layout, has, ignores_null=True)
    idx = idx.clamp(0, cap - 1)
    return [c.take(idx) for c in values_cols], ok


def _minmax_string(call: AggCall, x: Column, layout, fn: str
                   ) -> List[Column]:
    """String min/max: order the rows by (group, encoded string) and pick
    each group's first row. Null strings encode to sort last in both
    directions. The rows are already in group order, so group g's run
    keeps its place and starts at `layout.start_idx[g]`."""
    valid = x.valid_mask() & layout.row_mask
    i64_max = (1 << 63) - 1
    # words are 64-bit keys in signed order: ~w reverses it
    keys = [(torch.where(layout.row_mask, layout.gid,
                         torch.full_like(layout.gid, 1 << 30)), 31)]
    for w in string_words(x.data):
        keys.append((torch.where(valid, w if fn == "min" else ~w,
                                 torch.full_like(w, i64_max)), 64))
    ln = x.data.lengths.to(torch.int64)
    keys.append((torch.where(valid, ln if fn == "min" else 0xFFFFFFFF - ln,
                             torch.full_like(ln, 0xFFFFFFFF)), 32))
    perm = sort_permutation(pack_keys(keys))
    picked = x.take(perm[layout.start_idx])
    has = seg.seg_any(valid, layout)
    return [Column(call.dtype, picked.data, None),
            Column(T.BOOLEAN, has, None)]


def _acc_wide_sum(fn: str, sd: DataType, x: Column, valid: torch.Tensor,
                  layout) -> List[Column]:
    """Partial sum or avg state of a wide decimal: the input rescaled to
    the state's scale (a row that WRAPS in the upscale poisons its group,
    Spark's overflow to null: a wrapped residue would defeat the sum's
    overflow shadow), then limb sums; sum keeps a nonempty flag, avg the
    count."""
    live = valid & layout.row_mask
    h, l, rok = i128.rescale_checked(*W.planes(x), sd.scale - x.dtype.scale)
    sh, sl, ok = W.seg_sum_wide(h, l, live, layout, seg)
    ok = ok & ~seg.seg_any(live & ~rok, layout)
    cnt = seg.seg_count(valid, layout)
    if fn == "sum":
        return [W.build(sd, sh, sl, ok), Column(T.BOOLEAN, cnt > 0, None)]
    return [W.build(sd, sh, sl, ok), Column(T.INT64, cnt, None)]


def _minmax_wide(dtype: DataType, x: Column, live: torch.Tensor, layout,
                 fn: str) -> List[Column]:
    mh, ml, has = W.seg_minmax_wide(*W.planes(x), live, layout, seg,
                                    fn == "min")
    return [W.build(dtype, mh, ml, None), Column(T.BOOLEAN, has, None)]


def _merge_sum_wide(cols: List[Column], layout) -> List[Column]:
    """Re-sum wide partial sums: empty partials add nothing, and an
    overflowed partial that contributes poisons its group (a null
    result)."""
    state, ne_col = cols[0], cols[1]
    ne = ne_col.data & layout.row_mask
    h, l = (torch.where(ne, p, 0) for p in W.planes(state))
    sh, sl, ok = W.seg_sum_wide(h, l, ne, layout, seg)
    group_ok = ~seg.seg_any(~(state.valid_mask() | ~ne), layout)
    return [W.build(state.dtype, sh, sl, ok & group_ok),
            Column(T.BOOLEAN, seg.seg_any(ne, layout), None)]


def _first_occurrence(x: Column, gid_key: torch.Tensor) -> torch.Tensor:
    """True at the first row of each distinct (gid, value) pair: rows
    ordered by (gid, value) with a stable sort, run starts marked, the
    marks scattered back to the rows. Rows whose gid_key is the 2^30
    sentinel never mark. Values are equal as Spark's set is: NaN equals
    NaN, -0.0 equals 0.0, strings by all their bytes and their length.
    collect_set's dedup (ref collect_set.rs's per-group HashSet; the JAX
    package sorts the same pairs with one variadic sort)."""
    if x.is_list or x.is_struct:
        # the planner rejects collect_set over nested values
        # (converters._check_agg_call)
        raise NotImplementedError(
            "collect_set over nested value types is not supported")
    cap = x.capacity
    everyone = torch.ones((cap,), dtype=torch.bool, device=x.device)
    keys = [(gid_key, 31)] + encode_column(
        Column(x.dtype, x.data, None), True, True, everyone,
        max_string_words=None)
    words = pack_keys(keys)
    perm = sort_permutation(words)
    neq = torch.zeros((cap,), dtype=torch.bool, device=x.device)
    for w in words:
        ws = w[perm]
        neq = neq | (ws != torch.roll(ws, 1))
    if cap:
        neq[0] = True
    first = neq & (gid_key[perm] < (1 << 30))
    out = torch.zeros_like(first)
    out[perm] = first
    return out


def _stable_front(keep: torch.Tensor) -> torch.Tensor:
    """Row order with the kept rows first, each part in its own order."""
    return torch.sort((~keep).to(torch.uint8), stable=True).indices


def _offsets_of(lens: torch.Tensor) -> torch.Tensor:
    return torch.cat([lens.new_zeros(1),
                      torch.cumsum(lens, 0, dtype=torch.int32)])


def _collect_raw(call: AggCall, x: Column, layout, dedup: bool
                 ) -> List[Column]:
    """collect_list / collect_set over raw rows (already in group order):
    each group's kept values, nulls dropped (and repeats, for a set),
    compacted to the front of the element storage in row order; a
    group's list is its slice (ref agg/collect_list.rs, collect_set.rs)."""
    valid = x.valid_mask() & layout.row_mask
    keep = valid
    if dedup:
        gid_key = torch.where(valid, layout.gid,
                              torch.full_like(layout.gid, 1 << 30))
        keep = keep & _first_occurrence(x, gid_key)
    lens = seg.seg_sum(keep.to(torch.int32), layout, torch.ones_like(keep))
    lens = torch.where(layout.group_mask, lens, torch.zeros_like(lens))
    dt = collect_state_dtype(call)
    elems = x.take(_stable_front(keep))
    return [Column(dt, ListData(_offsets_of(lens),
                                Column(dt.element, elems.data, None)),
                   None)]


def _collect_merge(call: AggCall, lcol: Column, layout, dedup: bool
                   ) -> List[Column]:
    """Merge collect states (rows in group order): the rows' lists laid
    end to end are the groups' element runs; a set drops the repeats
    across its rows, keeping each value's first place."""
    dt = collect_state_dtype(call)
    ld = lcol.data
    cap, ecap = layout.row_mask.shape[0], ld.elements.capacity
    lens_r = torch.where(layout.row_mask & lcol.valid_mask(), ld.lengths(),
                         torch.zeros_like(ld.lengths()))
    _, row, within, live = seg.element_rows(_offsets_of(lens_r), cap, ecap)
    src = (ld.offsets[row].to(torch.int64) + within).clamp(0, ecap - 1)
    elems = ld.elements.take(torch.where(live, src, torch.zeros_like(src)))
    elems = Column(dt.element, elems.data, None)
    egid = torch.where(live, layout.gid[row],
                       torch.full_like(row, 1 << 30))
    if dedup:
        keep = live & _first_occurrence(elems, egid)
        elems = Column(dt.element, elems.take(_stable_front(keep)).data,
                       None)
        glens = torch.zeros((cap + 1,), dtype=torch.int32,
                            device=lcol.device)
        glens.index_add_(0, torch.where(keep, egid, cap),
                         keep.to(torch.int32))
        glens = glens[:cap]
    else:
        glens = seg.seg_sum(lens_r, layout,
                            torch.ones_like(layout.row_mask))
        glens = torch.where(layout.group_mask, glens,
                            torch.zeros_like(glens))
    return [Column(dt, ListData(_offsets_of(glens), elems), None)]


class _AggState(M.MemConsumer):
    """Aggregation state under the memory manager (ref AggTables and its
    MemConsumer impl, agg_tables.rs:57-278: in-memory tables spill to runs
    merged on output). Relief is (1) a collapse of raw rows into state, and
    of several state batches into one, then (2) a spill of the collapsed
    state batches to a host file; `merged` folds the spilled state back
    in."""

    name = "agg"

    def __init__(self, op: "AggExec", manager: M.MemManager) -> None:
        self.op = op
        self.manager = manager
        self.raw: List[ColumnBatch] = []
        self.raw_rows = 0
        self.raw_bytes = 0
        self.states: List[ColumnBatch] = []
        self.state_bytes = 0
        # True while self.states holds state batches made elsewhere (a
        # partial's output): those may carry several rows per group even
        # in one batch, so they are never "already collapsed"
        self.states_external = False
        self.spills: List[M.SpillFile] = []
        self.collapses = 0
        self.spill_files_used = 0
        manager.register(self)

    def mem_used(self) -> int:
        return self.raw_bytes + self.state_bytes

    def spill(self) -> int:
        freed = self._collapse_all()
        if freed or not self.states:
            return freed
        # already collapsed: the state batches go to a host spill file
        freed = self.state_bytes
        sf = M.SpillFile(self.op._state_schema, manager=self.manager)
        self.spills.append(sf)
        for s in self.states:
            sf.write(s)
        self.spill_files_used += 1
        self.states, self.state_bytes = [], 0
        return freed

    def _collapse_all(self) -> int:
        freed = 0
        if self.raw:
            before = self.raw_bytes
            s = self.op._collapse(self.raw, raw_input=True)
            self.raw, self.raw_rows, self.raw_bytes = [], 0, 0
            self._push_state(s)
            freed += max(before - M.batch_nbytes(s), 0)
            self.collapses += 1
        if len(self.states) > 1 or (self.states_external and self.states):
            before = self.state_bytes
            s = self.op._collapse(self.states, raw_input=False)
            self.states, self.state_bytes = [], 0
            self._push_state(s)
            self.states_external = False
            freed += max(before - self.state_bytes, 0)
            self.collapses += 1
        return freed

    def _push_state(self, s: ColumnBatch) -> None:
        self.states.append(s)
        self.state_bytes += M.batch_nbytes(s)

    def add_raw(self, work: ColumnBatch, n: int) -> None:
        # op_lock: serialize against a host-driven release()
        with self.manager.op_lock:
            self.raw.append(work)
            self.raw_rows += n
            self.raw_bytes += M.batch_nbytes(work)
            if self.raw_rows >= self.op.collapse_threshold:
                self._collapse_all()
            self.manager.update_mem_used(self)

    def add_state(self, batch: ColumnBatch) -> None:
        with self.manager.op_lock:
            self._push_state(batch)
            self.states_external = True
            if len(self.states) >= 16:
                self._collapse_all()
            self.manager.update_mem_used(self)

    def merged(self) -> ColumnBatch:
        """The one collapsed state: the in-memory state, then each spilled
        frame read back onto the device it left and collapsed in."""
        self._collapse_all()
        acc = self.states[0] if self.states else None
        for sf in self.spills:
            for chunk in sf.read():
                acc = chunk if acc is None else self.op._collapse(
                    [acc, chunk], raw_input=False)
        return acc

    def close(self) -> None:
        """Also the error path: closing the spill files never masks the
        error being unwound (close_all_quietly)."""
        self.manager.unregister(self)
        self.raw, self.states = [], []
        self.raw_bytes = self.state_bytes = 0
        spills, self.spills = self.spills, []
        M.close_all_quietly(spills, "agg spill")


class AggExec(Operator):
    def __init__(self, child: Operator, group_exprs: Sequence[ir.Expr],
                 group_names: Sequence[str], aggs: Sequence[AggCall],
                 mode: AggMode,
                 collapse_threshold: Optional[int] = None) -> None:
        super().__init__([child])
        self.group_exprs = list(group_exprs)
        self.group_names = list(group_names)
        self.aggs = list(aggs)
        self.mode = mode
        self.collapse_threshold = collapse_threshold or (conf.batch_size * 16)
        self._build_schema()

    # ---- schema plumbing ----
    def _build_schema(self) -> None:
        child_schema = self.children[0].schema
        if self.mode == AggMode.PARTIAL:
            self._group_fns = [compile_expr(e, child_schema)
                               for e in self.group_exprs]
            self._input_fns = [[compile_expr(e, child_schema)
                                for e in call.inputs] for call in self.aggs]
            self._work_jit = not any(
                ir.contains_host_fn(e) for e in list(self.group_exprs) +
                [x for call in self.aggs for x in call.inputs])
            group_fields = [Field(n, infer_dtype(fn, child_schema))
                            for n, fn in zip(self.group_names,
                                             self._group_fns)]
        else:
            # input is group cols + state cols by position
            group_fields = [Field(n, child_schema.fields[i].dtype)
                            for i, n in enumerate(self.group_names)]
        state: List[Field] = []
        for i, call in enumerate(self.aggs):
            state.extend(state_fields(call, i))
        self._group_fields = group_fields
        self._state_fields = state
        if self.mode == AggMode.FINAL:
            out = group_fields + [result_field(c) for c in self.aggs]
        else:
            out = group_fields + state
        self._schema = Schema(out)
        self._state_schema = Schema(group_fields + state)

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("agg", self.mode.value,
                tuple(e.key() for e in self.group_exprs),
                tuple(c.key() for c in self.aggs),
                self.children[0].plan_key())

    # ---- execution ----
    def _check_supported(self) -> None:
        """Raise, before any input is read, for calls with no meaning."""
        for call in self.aggs:
            if call.dtype.is_string_like and call.fn in ("sum", "avg"):
                raise TypeError(f"{call.fn} over {call.dtype}")

    def execute(self, ctx: ExecContext) -> BatchStream:
        self._check_supported()

        def gen():
            state = _AggState(self, M.get_manager(ctx))
            device = None
            try:
                for batch in self.children[0].execute(ctx):
                    ctx.check_running()
                    device = batch.device
                    n = int(to_host(batch.num_rows))
                    if n == 0:
                        continue
                    with self.metrics.timer():
                        if self._is_state_input():
                            state.add_state(batch)
                        else:
                            state.add_raw(self._to_work(batch), n)
                if not (state.raw or state.states or state.spills):
                    if not self.group_exprs:
                        yield self._empty_global_result(
                            device or resolve_device(ctx.device))
                    return
                with self.metrics.timer():
                    merged = state.merged()
                    out = (self._finalize(merged)
                           if self.mode == AggMode.FINAL else merged)
                self.metrics.add("collapses", state.collapses)
                self.metrics.add("spill_count", state.spill_files_used)
                yield truncate(out, max(int(to_host(out.num_rows)), 1))
            finally:
                state.close()

        return count_stream(self, gen())

    def _is_state_input(self) -> bool:
        return self.mode in (AggMode.PARTIAL_MERGE, AggMode.FINAL)

    def _to_work(self, batch: ColumnBatch) -> ColumnBatch:
        """Project child rows into the working layout: group columns, then
        each aggregate's inputs."""
        with cse_scope():
            cols = [fn(batch) for fn in self._group_fns]
            fields = list(self._group_fields)
            for call, fns in zip(self.aggs, self._input_fns):
                for j, fn in enumerate(fns):
                    c = fn(batch)
                    cols.append(c)
                    fields.append(Field(f"in.{call.name}.{j}", c.dtype))
        return batch.with_columns(Schema(fields), cols)

    def _collapse(self, batches: List[ColumnBatch], raw_input: bool
                  ) -> ColumnBatch:
        """Sort the rows of `batches` by the group columns and reduce each
        group to one state row. The JAX package pads the concatenation to
        a compile-service capacity rung first, to bound its jit programs;
        here the bucket capacity of the concatenation is used as it is."""
        big = batches[0] if len(batches) == 1 else concat_batches(batches)
        ngroups = len(self._group_fields)
        sb = sort_batch(big, [SortSpec(i) for i in range(ngroups)])
        layout = seg.group_layout(sb, list(range(ngroups)))
        gcols = [sb.columns[i].take(layout.start_idx) for i in range(ngroups)]
        if raw_input:
            scols = self._accumulate_raw(sb, layout, ngroups)
        else:
            scols = self._merge_state(sb, layout, ngroups)
        return ColumnBatch(self._state_schema, gcols + scols,
                           layout.num_groups, sb.capacity)

    def _accumulate_raw(self, sb: ColumnBatch, layout, ngroups: int
                        ) -> List[Column]:
        """Partial: raw input columns -> state columns."""
        out: List[Column] = []
        ci = ngroups
        for call in self.aggs:
            ins = sb.columns[ci:ci + len(call.inputs)]
            ci += len(call.inputs)
            out.extend(self._acc_one(call, ins, layout))
        return out

    def _acc_one(self, call: AggCall, ins: List[Column], layout
                 ) -> List[Column]:
        fn = call.fn
        if fn == "count":
            valid = None
            for c in ins:
                v = c.valid_mask()
                valid = v if valid is None else (valid & v)
            if valid is None:  # count(*) with no argument
                valid = layout.row_mask
            return [Column(T.INT64, seg.seg_count(valid, layout), None)]
        (x,) = ins
        valid = x.valid_mask()
        if fn in ("sum", "avg"):
            if fn == "sum":
                sd = _sum_state_dtype(call.dtype)
            else:
                sd = (call.dtype if call.dtype.kind == TypeKind.DECIMAL
                      else T.FLOAT64)
            if sd.wide_decimal:
                return _acc_wide_sum(fn, sd, x, valid, layout)
            data = x.data.to(sd.torch_dtype())
            s = seg.seg_sum(torch.where(valid, data, torch.zeros_like(data)),
                            layout, valid)
            cnt = seg.seg_count(valid, layout)
            if fn == "sum":
                return [Column(sd, s, None), Column(T.BOOLEAN, cnt > 0, None)]
            return [Column(sd, s, None), Column(T.INT64, cnt, None)]
        if fn in ("min", "max"):
            if x.is_string:
                return _minmax_string(call, x, layout, fn)
            if call.dtype.wide_decimal:
                return _minmax_wide(call.dtype, x, valid & layout.row_mask,
                                    layout, fn)
            red = seg.seg_min if fn == "min" else seg.seg_max
            val, has = red(x.data, layout, valid)
            return [Column(call.dtype, val, None),
                    Column(T.BOOLEAN, has, None)]
        if fn == "first":
            idx = layout.start_idx
            fvalid = (valid & layout.row_mask)[idx]
            return [Column(call.dtype, x.take(idx).data, None),
                    Column(T.BOOLEAN, fvalid, None),
                    Column(T.BOOLEAN, layout.group_mask, None)]
        if fn == "first_ignores_null":
            if x.is_string:
                (v,), ok = _first_by_index([x], layout, valid)
                return [Column(call.dtype, v.data, None),
                        Column(T.BOOLEAN, ok, None)]
            val, has = seg.seg_first(x.data, layout, valid, ignores_null=True)
            return [Column(call.dtype, val, None),
                    Column(T.BOOLEAN, has, None)]
        if fn in ("collect_list", "collect_set"):
            return _collect_raw(call, x, layout, fn == "collect_set")
        raise NotImplementedError(f"agg function {fn}")

    def _merge_state(self, sb: ColumnBatch, layout, ngroups: int
                     ) -> List[Column]:
        out: List[Column] = []
        ci = ngroups
        ones = torch.ones((sb.capacity,), dtype=torch.bool, device=sb.device)
        for call in self.aggs:
            nstate = len(state_fields(call, 0))
            cols = sb.columns[ci:ci + nstate]
            ci += nstate
            fn = call.fn
            if fn == "count":
                out.append(Column(T.INT64, seg.seg_sum(cols[0].data, layout,
                                                       ones), None))
            elif fn in ("sum", "avg") and cols[0].dtype.wide_decimal:
                if fn == "sum":
                    out += _merge_sum_wide(cols, layout)
                    continue
                everyone = Column(T.BOOLEAN, ones, None)
                scol, _ = _merge_sum_wide([cols[0], everyone], layout)
                out += [scol, Column(T.INT64, seg.seg_sum(
                    cols[1].data, layout, ones), None)]
            elif fn == "sum":
                zero = torch.zeros_like(cols[0].data)
                s = seg.seg_sum(torch.where(cols[1].data, cols[0].data, zero),
                                layout, ones)
                out += [Column(cols[0].dtype, s, None),
                        Column(T.BOOLEAN, seg.seg_any(cols[1].data, layout),
                               None)]
            elif fn == "avg":
                out += [Column(cols[0].dtype,
                               seg.seg_sum(cols[0].data, layout, ones), None),
                        Column(T.INT64,
                               seg.seg_sum(cols[1].data, layout, ones), None)]
            elif fn in ("min", "max") and cols[0].dtype.wide_decimal:
                out += _minmax_wide(cols[0].dtype, cols[0],
                                    cols[1].data & layout.row_mask, layout,
                                    fn)
            elif fn in ("min", "max") and cols[0].is_string:
                out.extend(_minmax_string(
                    call, Column(cols[0].dtype, cols[0].data, cols[1].data),
                    layout, fn))
            elif fn in ("min", "max"):
                red = seg.seg_min if fn == "min" else seg.seg_max
                val, has = red(cols[0].data, layout, cols[1].data)
                out += [Column(cols[0].dtype, val, None),
                        Column(T.BOOLEAN, has, None)]
            elif fn == "first":
                (v, vv), ok = _first_by_index([cols[0], cols[1]], layout,
                                              cols[2].data)
                out += [Column(cols[0].dtype, v.data, None),
                        Column(T.BOOLEAN, vv.data, None),
                        Column(T.BOOLEAN, ok, None)]
            elif fn == "first_ignores_null":
                (v,), ok = _first_by_index([cols[0]], layout, cols[1].data)
                out += [Column(cols[0].dtype, v.data, None),
                        Column(T.BOOLEAN, ok, None)]
            elif fn in ("collect_list", "collect_set"):
                out.extend(_collect_merge(call, cols[0], layout,
                                          fn == "collect_set"))
            else:
                raise NotImplementedError(fn)
        return out

    # ---- finalize ----
    def _finalize(self, state: ColumnBatch) -> ColumnBatch:
        ngroups = len(self._group_fields)
        cols = list(state.columns[:ngroups])
        ci = ngroups
        for call in self.aggs:
            nstate = len(state_fields(call, 0))
            cols.append(self._finalize_one(call,
                                           state.columns[ci:ci + nstate]))
            ci += nstate
        return state.with_columns(self._schema, cols)

    def _finalize_one(self, call: AggCall, scols: List[Column]) -> Column:
        fn = call.fn
        if fn == "count":
            return scols[0]
        if fn == "sum":
            if scols[0].dtype.wide_decimal:
                # Spark nulls a sum beyond the result precision; the
                # segment shadow only catches magnitudes past 1.5e38
                h, l = W.planes(scols[0])
                ok = (scols[1].data & scols[0].valid_mask()
                      & i128.in_precision(h, l, call.dtype.precision))
                return Column(call.dtype, scols[0].data, ok)
            return Column(scols[0].dtype, scols[0].data, scols[1].data)
        if fn == "avg":
            if call.dtype.wide_decimal:
                h, l = W.planes(scols[0])
                cnt = scols[1].data
                qh, ql, ok = W.div_by_count(h, l, cnt, call.dtype, 0)
                return W.build(call.dtype, qh, ql,
                               (cnt > 0) & ok & scols[0].valid_mask())
            s, cnt = scols[0].data, scols[1].data
            ok = cnt > 0
            if call.dtype.kind == TypeKind.DECIMAL:
                q = torch.div(s, cnt.clamp(min=1), rounding_mode="floor")
                return Column(call.dtype,
                              torch.where(ok, q, torch.zeros_like(q)), ok)
            v = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
            return Column(T.FLOAT64, torch.where(ok, v, torch.zeros_like(v)),
                          ok)
        if fn in ("min", "max", "first_ignores_null"):
            return Column(call.dtype, scols[0].data, scols[1].data)
        if fn == "first":
            return Column(call.dtype, scols[0].data,
                          scols[1].data & scols[2].data)
        if fn in ("collect_list", "collect_set"):
            # Spark: a group with nothing collected gets an EMPTY list,
            # not null; the state's list is the result
            return scols[0]
        raise NotImplementedError(fn)

    def _empty_global_result(self, device) -> ColumnBatch:
        """Global aggregate over zero rows: one row of initial state
        (count=0, sum=null, ...), Spark's global-agg-on-empty answer."""
        cap = bucket_capacity(1)
        state = ColumnBatch.empty(self._state_schema, cap,
                                  device=device).with_num_rows(1)
        if self.mode == AggMode.FINAL:
            return self._finalize(state)
        return state
