"""Segment (group-run) utilities over key-sorted batches.

Port of blaze_tpu/ops/segment.py (group_starts, GroupLayout, group_layout
and the per-group reductions). Rows are first sorted by their grouping key
(ops/sort_keys.py); then group boundaries come from neighbour equality,
group ids from a cumulative sum, and every per-group reduction is a
scatter into the group slots [0, num_groups). `segmented_scan` and
`segmented_cumsum` are the window's running values, and `element_rows`
maps list element slots back to their rows.

Two places differ from the JAX code, neither in what they compute:

  * `jnp.nonzero(starts, size=cap)` has a fixed shape; `torch.nonzero`
    waits for the device and returns a data-dependent shape. The start
    index of each group is instead scattered to its gid slot, so a layout
    needs no host pull;
  * `jax.ops.segment_*` drop ids past `num_segments`; here masked rows
    (padding, nulls) go to spare slots past the end, which are cut off.
    There are `_SPARE` of them, one per row modulo `_SPARE`, so that the
    masked rows' atomic adds on the card do not all queue on one address
    (on an H100, one slot made chip_smoke.py's general_agg rep 3-4x
    slower: `chip_accumulate_bench.py --spare-slots 1024 1`).

NaN is handled by explicit flags and sentinels exactly as in the JAX code,
never by the library's NaN behaviour, which differs between the CPU and
CUDA `scatter_reduce_`. The min/max fold (`extreme_slots`,
`fold_extreme`, `extreme_result`) also serves the whole-stage path's
dense carriers, so Spark's NaN order is decided here alone. Float sums add in an order that is not fixed on
CUDA; integer sums, counts and row indices are exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from blaze_tpu_torch.columnar.batch import Column, ColumnBatch

_SPARE = 1024


def _col_neighbor_eq(col: Column) -> torch.Tensor:
    """eq[i] = row i equals row i-1 in this column (eq[0] = False).

    Null == null (Spark grouping: null is its own group); NaN == NaN and
    -0.0 == 0.0 for floats; strings compare their bytes up to the length,
    and the lengths."""
    valid = col.valid_mask()
    vprev = torch.roll(valid, 1)
    if col.is_struct:
        # rows are equal when every child is (validity included)
        data_eq = torch.ones_like(valid)
        for ch in col.data.children:
            data_eq = data_eq & _col_neighbor_eq(ch)
        if data_eq.shape[0]:
            data_eq[0] = True
    elif col.is_string:
        b, ln = col.data.bytes, col.data.lengths
        pos = torch.arange(b.shape[1], dtype=torch.int32, device=b.device)
        in_len = pos[None, :] < ln[:, None]
        data_eq = (ln == torch.roll(ln, 1)) & (
            (b == torch.roll(b, 1, dims=0)) | ~in_len).all(dim=1)
    else:
        prev = torch.roll(col.data, 1)
        data_eq = col.data == prev
        if col.data.dtype.is_floating_point:
            data_eq = data_eq | (torch.isnan(col.data) & torch.isnan(prev))
    eq = torch.where(valid & vprev, data_eq, ~valid & ~vprev)
    if eq.shape[0]:
        eq[0] = False
    return eq


def group_starts(batch: ColumnBatch, key_indices: Sequence[int]
                 ) -> torch.Tensor:
    """True at the first live row of each key run; False at padding rows.
    The batch must be sorted by the keys (padding last)."""
    mask = batch.row_mask()
    if not key_indices:
        # one global group: a start at row 0 if there are rows
        return (torch.arange(batch.capacity, device=batch.device) == 0) & mask
    eq = None
    for i in key_indices:
        e = _col_neighbor_eq(batch.columns[i])
        eq = e if eq is None else (eq & e)
    return ~eq & mask


@dataclasses.dataclass
class GroupLayout:
    """Everything downstream aggregates need about the runs of a sorted
    batch. Per-row fields are indexed by row, per-group fields by group
    slot; all are (cap,)."""
    starts: torch.Tensor      # bool: first row of each group
    gid: torch.Tensor         # int64: group of each row (garbage at padding)
    num_groups: torch.Tensor  # int32 0-d
    start_idx: torch.Tensor   # int64: first row of group g (0 past the end)
    end_idx: torch.Tensor     # int64: last row of group g (0 past the end)
    row_mask: torch.Tensor    # bool: live rows
    group_mask: torch.Tensor  # bool: slots < num_groups
    spare: torch.Tensor       # int64: a spare slot >= cap per row


def group_layout(batch: ColumnBatch, key_indices: Sequence[int]
                 ) -> GroupLayout:
    cap, dev = batch.capacity, batch.device
    mask = batch.row_mask()
    starts = group_starts(batch, key_indices)
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    num_groups = starts.sum(dtype=torch.int32)
    row = torch.arange(cap, dtype=torch.int64, device=dev)
    spare = cap + (row & (_SPARE - 1))
    # each group's first row, scattered to its slot; other rows go to
    # spare slots, unset slots stay 0 (jnp.nonzero's fill_value)
    start_idx = torch.zeros((cap + _SPARE,), dtype=torch.int64, device=dev)
    start_idx.scatter_(0, torch.where(starts, gid, spare), row)
    start_idx = start_idx[:cap]
    # end of group g = start of g+1 minus 1; the last ends at num_rows-1
    nxt = torch.cat([start_idx[1:], start_idx.new_zeros(1)])
    group_mask = row < num_groups
    end_idx = torch.where(row == num_groups - 1,
                          batch.num_rows.to(torch.int64) - 1, nxt - 1)
    end_idx = torch.where(group_mask, end_idx, torch.zeros_like(end_idx))
    return GroupLayout(starts, gid, num_groups, start_idx, end_idx, mask,
                       group_mask, spare)


def segmented_scan(values: torch.Tensor, starts: torch.Tensor,
                   combine: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]) -> torch.Tensor:
    """Inclusive scan of `combine` restarting at each segment start.

    The JAX package runs `lax.associative_scan` over (flag, value) pairs.
    Here the same pairs go through a log-step doubling scan: in round d
    each slot combines with the slot 2^d before it unless a start lies in
    between, ceil(log2(n)) rounds of `torch.where` over a shifted copy.
    Every associative `combine` gives the JAX package's result; float
    sums add in a different order, so they agree within rounding."""
    out, flag = values, starts
    n, d = values.shape[0], 1
    row = torch.arange(n, device=values.device)
    while d < n:
        # slots below d have no partner this round and keep their pair
        prev = torch.cat([out[:d], out[:-d]])
        pflag = torch.cat([torch.zeros_like(flag[:d]), flag[:-d]])
        out = torch.where(flag | (row < d), out, combine(prev, out))
        flag = flag | pflag
        d <<= 1
    return out


def segmented_cumsum(values: torch.Tensor, starts: torch.Tensor
                     ) -> torch.Tensor:
    """Segmented running sum of an integer tensor: the running total less
    the total before the segment's start, exact in wrapping int64 (never
    for floats: a large segment's sum would cancel the small one after
    it)."""
    if values.dtype.is_floating_point:
        raise TypeError("segmented_cumsum is exact only for integers")
    run = torch.cumsum(values.to(torch.int64), 0)
    before = run - values.to(torch.int64)
    return (run - before[last_marked(starts)]).to(values.dtype)


def last_marked(mask: torch.Tensor) -> torch.Tensor:
    """For each row, the index of the last row at or before it where
    `mask` is set (0 before the first): a cumulative count names each
    marked row's slot, the marked rows scatter their index there, and
    every row gathers its count's slot. (`torch.cummax` over the marked
    indices gives the same; on an H100 it took 29% of a window stage's
    device time, chip_smoke.py's runner_nested profile.)"""
    n = mask.shape[0]
    row = torch.arange(n, device=mask.device)
    slot = torch.cumsum(mask.to(torch.int64), 0) - 1
    pos = torch.zeros((n + 1,), dtype=torch.int64, device=mask.device)
    pos.scatter_(0, torch.where(mask, slot, n), row)
    return torch.where(slot >= 0, pos[slot.clamp(min=0)], 0)


def element_rows(offsets: torch.Tensor, cap: int, ecap: int):
    """Map flat element slots back to their owning rows.

    `offsets` is a monotone (>= cap + 1,) offset tensor. Returns (slot,
    row, within, live), int64 and bool (ecap,): for element slot e, the
    row whose range holds it, its position in that range, and whether it
    is below the total element count. Rows past the last are clamped to
    cap - 1, as the JAX package's `searchsorted(side="right")` is."""
    dev = offsets.device
    slot = torch.arange(ecap, dtype=torch.int64, device=dev)
    ends = offsets[1:cap + 1].to(torch.int64).contiguous()
    row = torch.searchsorted(ends, slot, right=True).clamp(0, cap - 1)
    within = slot - offsets[row].to(torch.int64)
    live = slot < offsets[cap].to(torch.int64)
    return slot, row, within, live


def _seg_ids(layout: GroupLayout, extra_mask=None) -> torch.Tensor:
    """Scatter index per row: its gid where it contributes, else a spare
    slot (cut off after the scatter)."""
    mask = layout.row_mask if extra_mask is None else (
        layout.row_mask & extra_mask)
    return torch.where(mask, layout.gid, layout.spare)


def _scatter(values: torch.Tensor, layout: GroupLayout, valid, fill,
             reduce: str) -> torch.Tensor:
    """Per-group `reduce` ("sum", "amin", "amax") of the rows where
    `valid & row_mask`, starting from `fill` in every slot."""
    cap = values.shape[0]
    out = torch.full((cap + _SPARE,), fill, dtype=values.dtype,
                     device=values.device)
    ids = _seg_ids(layout, valid)
    if reduce == "sum":
        out.index_add_(0, ids, values)
    else:
        out.scatter_reduce_(0, ids, values, reduce, include_self=True)
    return out[:cap]


def seg_sum(values: torch.Tensor, layout: GroupLayout,
            valid: torch.Tensor) -> torch.Tensor:
    v = torch.where(valid & layout.row_mask, values,
                    torch.zeros((), dtype=values.dtype, device=values.device))
    return _scatter(v, layout, valid, 0, "sum")


def seg_count(valid: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    return seg_sum(valid.to(torch.int64), layout, torch.ones_like(valid))


def seg_any(flags: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    """Per-group OR."""
    n = seg_sum((flags & layout.row_mask).to(torch.int32), layout,
                torch.ones_like(flags, dtype=torch.bool))
    return n > 0


def _extreme(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def extreme_slots(n: int, dtype: torch.dtype, largest: bool, device):
    """Empty per-slot state of a min (largest=False) or max fold: the
    extremes at the reduction's identity, and for floats the int32 NaN
    flag (None for integers)."""
    ext = torch.full((n,), _extreme(dtype, not largest), dtype=dtype,
                     device=device)
    flag = (torch.zeros((n,), dtype=torch.int32, device=device)
            if dtype.is_floating_point else None)
    return ext, flag


def fold_extreme(ext: torch.Tensor, flag, values: torch.Tensor,
                 contrib: torch.Tensor, ids: torch.Tensor,
                 largest: bool) -> None:
    """Fold rows into per-slot min/max state from extreme_slots, in
    place. `ids` (int64) is each row's slot; rows outside `contrib` add
    only the identity. Spark's order has NaN as the GREATEST value; NaN
    rows never reach the value scatter but set the flag instead: for a
    max, any contributing NaN row; for a min, any contributing non-NaN
    row. The state folds again over later rows (the dense carriers keep
    it across batches)."""
    keep = contrib
    if values.dtype.is_floating_point:
        isnan = torch.isnan(values)
        keep = contrib & ~isnan
        f = contrib & isnan if largest else keep
        flag.scatter_reduce_(0, ids, f.to(torch.int32), "amax",
                             include_self=True)
    ident = _extreme(values.dtype, not largest)
    v = torch.where(keep, values, torch.full_like(values, ident))
    ext.scatter_reduce_(0, ids, v, "amax" if largest else "amin",
                        include_self=True)


def extreme_result(ext: torch.Tensor, flag, any_valid: torch.Tensor,
                   largest: bool) -> torch.Tensor:
    """The folded state as values: 0 where a slot had no valid row; NaN
    for a max that saw a NaN, and for a min whose valid rows were all
    NaN."""
    zero = torch.zeros((), dtype=ext.dtype, device=ext.device)
    out = torch.where(any_valid, ext, zero)
    if flag is None:
        return out
    nan = torch.full_like(ext, float("nan"))
    if largest:
        return torch.where(flag > 0, nan, out)
    return torch.where(flag > 0, out, torch.where(any_valid, nan, zero))


def _seg_extreme(values: torch.Tensor, layout: GroupLayout,
                 valid: torch.Tensor, largest: bool):
    cap = values.shape[0]
    ext, flag = extreme_slots(cap + _SPARE, values.dtype, largest,
                              values.device)
    fold_extreme(ext, flag, values, valid & layout.row_mask,
                 _seg_ids(layout, valid), largest)
    any_valid = seg_any(valid, layout)
    return extreme_result(ext[:cap], None if flag is None else flag[:cap],
                          any_valid, largest), any_valid


def seg_min(values: torch.Tensor, layout: GroupLayout, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group MIN skipping nulls, with Spark's NaN order (NaN only for
    a group whose valid values are all NaN). Returns (values, any_valid)."""
    return _seg_extreme(values, layout, valid, largest=False)


def seg_max(values: torch.Tensor, layout: GroupLayout, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group MAX skipping nulls; a group with a valid NaN is NaN
    (Spark: NaN greatest). Returns (values, any_valid)."""
    return _seg_extreme(values, layout, valid, largest=True)


def seg_first(values: torch.Tensor, layout: GroupLayout, valid: torch.Tensor,
              ignores_null: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """First (or first non-null) value per group (ref agg/first.rs,
    first_ignores_null.rs): the group's first row, or the scatter-min of
    the qualifying row index and a gather. Returns (values, valid|has)."""
    if not ignores_null:
        return (values[layout.start_idx],
                (valid & layout.row_mask)[layout.start_idx])
    cap = values.shape[0]
    live_valid = valid & layout.row_mask
    iota = torch.arange(cap, dtype=torch.int64, device=values.device)
    idx = _scatter(torch.where(live_valid, iota, cap), layout, live_valid,
                   cap, "amin")
    has = idx < cap
    val = values[idx.clamp(0, cap - 1)]
    return torch.where(has, val, torch.zeros_like(val)), has
