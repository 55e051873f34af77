"""Equi-join engine: sort-merge matching + gather expansion.

Port of blaze_tpu/ops/join.py (ref: datafusion-ext-plans
sort_merge_join_exec.rs and broadcast_join_exec.rs, the hash join with its
runtime SMJ fallback). There is no cursor state machine and no hash table;
a join is three dense phases, as in the JAX package:

  1. MATCH: the encoded keys of the key-sorted build side and of a probe
     batch are concatenated (build rows first) and ordered by one stable
     lexicographic sort. A stable sort on the keys alone is the JAX
     package's sort on (keys, side tag): inside a run of equal keys every
     build row already precedes every probe row. Run starts come from a
     shift compare, prefix sums give every run its build offset and its
     build and probe counts, and scatters send them back to the probe
     rows' original positions and to the sorted build rows. The key words
     are ops/sort_keys.py's int64 words, sorted by stable passes from the
     least significant word (CUDA `torch.sort` takes no unsigned keys).
  2. EXPAND: one host read (`metrics.to_host`) of the total output rows a
     probe batch picks the output capacity; `torch.repeat_interleave`
     with that `output_size` gathers the (probe, build) index pairs.
  3. OUTER/SEMI bookkeeping: per-row match counts drive semi/anti/
     existence compaction and the null-extended rows of outer joins;
     matched-build flags accumulate across probe batches for right/full
     outer joins.

Row order is the JAX package's: probe rows in input order, each probe
row's matches in sorted-build order, unmatched build rows last in
sorted-build order. Join keys with nulls never match unless the key is
null-safe (`<=>`): rows carrying a null in a plain key get a per-side tag
in a "disable" key so they cannot share a run across sides. Float keys
match as the sort encoding orders them: NaN equals NaN and -0.0 equals
0.0. String keys are encoded at their full width (join equality is exact;
only ORDER BY keys stop at 64 bytes), and the match phase pads both sides
to one word count, so sides of different width buckets agree. List,
map and struct payload columns go through the expansion's gathers with
`batch.take_rows`, which sizes a list's element storage to the repeated
rows (one host read a list column); the JAX package refuses joins over
list columns.

Naming below is probe/build: SMJ probes with the LEFT child streaming
against the materialized right; BHJ probes with the stream side against
the broadcast build side. The output column order is always left ++
right. The JAX package caches one compiled program per (plan, shape);
the port runs every phase eagerly and needs no cache, so the build side
is one plain `concat_batches`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, bucket_capacity, take_rows,
)
from blaze_tpu_torch.columnar.types import Field, Schema
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.compiler import compile_expr
from blaze_tpu_torch.ops.base import (
    BatchStream, ExecContext, Operator, count_stream,
)
from blaze_tpu_torch.ops.common import concat_batches, slice_batch
from blaze_tpu_torch.ops.sort_keys import (
    Key, encode_column, pack_keys, permute_by_keys, sort_permutation,
)
from blaze_tpu_torch.runtime import compile_service
from blaze_tpu_torch.runtime.metrics import to_host


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    EXISTENCE = "existence"


_SEMI_LIKE = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.EXISTENCE)


@dataclasses.dataclass(frozen=True)
class JoinKey:
    """One equi-join key pair (column indices into each child's schema)."""
    left: int
    right: int
    null_safe: bool = False  # <=> comparison: null matches null

    def key(self) -> tuple:
        return (self.left, self.right, self.null_safe)


# ---------------------------------------------------------------------------
# key encoding shared by both sides
# ---------------------------------------------------------------------------

def _equality_keys(batch: ColumnBatch, cols: Sequence[int],
                   force_flags: Sequence[bool],
                   string_words_n: Optional[Sequence[Optional[int]]] = None,
                   ) -> List[Key]:
    """Encoded keys; both sides must produce identical layouts, so a null
    flag is emitted whenever EITHER side's column carries validity, and
    string keys pad to a common word count."""
    mask = batch.row_mask()
    out: List[Key] = []
    for i, (ci, force) in enumerate(zip(cols, force_flags)):
        col = batch.columns[ci]
        if force and col.validity is None:
            col = Column(col.dtype, col.data,
                         torch.ones((batch.capacity,), dtype=torch.bool,
                                    device=batch.device))
        exact = string_words_n[i] if string_words_n else None
        if col.is_string and exact is None:
            exact = (col.data.width + 7) // 8
        out.extend(encode_column(col, True, True, mask,
                                 exact_string_words=exact))
    return out


def _join_sort_keys(batch: ColumnBatch, cols: Sequence[int],
                    null_safe: Sequence[bool], force_flags: Sequence[bool],
                    side_tag: int,
                    string_words_n: Optional[Sequence[Optional[int]]] = None,
                    ) -> List[Key]:
    """The composite ordering every join phase agrees on: [liveness,
    null-disable, encoded equality keys...]. The build sort and the merged
    match sort both use exactly this order, so build positions stay
    aligned across phases (extra zero words of a wider match layout never
    change the relative order of the build-side sort)."""
    dead = (~batch.row_mask()).to(torch.int64)
    dis = _null_disable(batch, cols, null_safe, side_tag)
    return [(dead, 1), (dis, 2)] + _equality_keys(batch, cols, force_flags,
                                                  string_words_n)


def _null_disable(batch: ColumnBatch, cols: Sequence[int],
                  null_safe: Sequence[bool], side_tag: int) -> torch.Tensor:
    """Key that keeps rows with a null in a plain key out of every
    cross-side run: 0, or 2 + side_tag for such rows."""
    bad = torch.zeros((batch.capacity,), dtype=torch.bool,
                      device=batch.device)
    for ci, ns in zip(cols, null_safe):
        if ns:
            continue
        v = batch.columns[ci].validity
        if v is not None:
            bad = bad | ~v
    return torch.where(bad, 2 + side_tag, 0).to(torch.int64)


def sort_batch_by_keys(batch: ColumnBatch, keys: List[Key]) -> ColumnBatch:
    """sort_batch with caller-provided keys (payload gathered once)."""
    return permute_by_keys(batch, pack_keys(keys))


# ---------------------------------------------------------------------------
# phase 1: match ranges
# ---------------------------------------------------------------------------

def _scatter_to(n: int, index: torch.Tensor, values: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """out[index[i]] = values[i] where keep[i]; zeros elsewhere. Dropped
    rows write to a spare slot n, so no host sync picks them out."""
    out = torch.zeros((n + 1,), dtype=values.dtype, device=values.device)
    out.scatter_(0, torch.where(keep, index, n), values)
    return out[:n]


def match_ranges(build: ColumnBatch, probe: ColumnBatch,
                 build_cols: Sequence[int], probe_cols: Sequence[int],
                 null_safe: Sequence[bool], force_flags: Sequence[bool],
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-probe-row [start, start+count) into key-sorted `build`, plus the
    per-build-row probe-match counts (for outer bookkeeping).

    Returns (start, count) aligned to probe's ORIGINAL row order (zero for
    padding rows) and build_match_count aligned to sorted-build row order
    (zero for padding rows), all int64."""
    capB, capP = build.capacity, probe.capacity
    cap = capB + capP
    dev = probe.device
    # one string word count for both sides, so their layouts agree
    swords: List[Optional[int]] = []
    for bc, pc in zip(build_cols, probe_cols):
        b, p = build.columns[bc], probe.columns[pc]
        swords.append(max((b.data.width + 7) // 8, (p.data.width + 7) // 8)
                      if b.is_string else None)
    bkeys = _join_sort_keys(build, build_cols, null_safe, force_flags, 0,
                            swords)
    pkeys = _join_sort_keys(probe, probe_cols, null_safe, force_flags, 1,
                            swords)
    keys: List[Key] = []
    for (bw, bb), (pw, pb) in zip(bkeys, pkeys):
        if bb != pb:
            raise TypeError(f"join key layouts differ: {bb} vs {pb} bits")
        keys.append((torch.cat([bw, pw]), bb))
    words = pack_keys(keys)
    live = torch.cat([build.row_mask(), probe.row_mask()])
    perm = sort_permutation(words)

    # run boundaries over the encoded words (flags included: exact
    # equality); liveness and the null-disable key take part, so dead rows
    # form their own trailing region and null-key rows split per side
    eq = torch.ones((cap,), dtype=torch.bool, device=dev)
    for w in words:
        s = w[perm]
        eq[1:] &= s[1:] == s[:-1]
    eq[0] = False
    slive = live[perm]
    starts = ~eq & slive
    gid = (torch.cumsum(starts.to(torch.int64), 0) - 1).clamp_(min=0)
    is_build = (perm < capB) & slive
    is_probe = (perm >= capB) & slive
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    total_live = live.sum()

    # run r spans [rs[r], rs[r + 1]); slots past the last run hold the
    # live total, where the dead rows begin (the group-start scatter)
    rs = torch.zeros((cap + 2,), dtype=torch.int64, device=dev) + total_live
    rs.scatter_(0, torch.where(starts, gid, cap + 1), slot)  # cap+1: spare
    r0, r1 = rs[gid], rs[gid + 1]
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    zb = torch.cat([zero, torch.cumsum(is_build.to(torch.int64), 0)])
    zp = torch.cat([zero, torch.cumsum(is_probe.to(torch.int64), 0)])
    row_start = zb[r0]
    row_bcnt = zb[r1] - row_start
    row_pcnt = zp[r1] - zp[r0]

    # back to the probe rows' original positions, and to sorted-build order
    # (the k-th live build row of the merged order is sorted-build row k)
    ppos = perm - capB
    start_p = _scatter_to(capP, ppos, row_start, is_probe)
    cnt_p = _scatter_to(capP, ppos, row_bcnt, is_probe)
    bmatch = _scatter_to(capB, zb[:-1], row_pcnt, is_build)
    return start_p, cnt_p, bmatch


# ---------------------------------------------------------------------------
# phase 2: expansion
# ---------------------------------------------------------------------------

def expand_pairs(start: torch.Tensor, cnt: torch.Tensor, out_cap: int,
                 emit_unmatched: bool,
                 probe_mask: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(probe_idx, build_idx, build_valid, num_out) for the match expansion.

    With `emit_unmatched`, probe rows with no match emit one row whose
    build side is null (left/right outer); padding rows never emit. Slots
    past num_out hold index 0 and build_valid False. out_cap must be at
    least the total."""
    eff = torch.clamp(cnt, min=1) if emit_unmatched else cnt
    if probe_mask is not None:
        eff = torch.where(probe_mask, eff, 0)
    eff = eff.to(torch.int64)
    capP = start.shape[0]
    dev = start.device
    total = eff.sum()
    offs = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                      torch.cumsum(eff, 0)])
    # a spare index capP fills the slots past the total, so output_size is
    # exact and the repeat needs no host sync
    reps = torch.cat([eff, (out_cap - total).reshape(1)])
    probe_idx = torch.repeat_interleave(
        torch.arange(capP + 1, dtype=torch.int64, device=dev), reps,
        output_size=out_cap)
    slot = torch.arange(out_cap, dtype=torch.int64, device=dev)
    live = slot < total
    probe_idx = torch.where(live, probe_idx, 0)
    within = slot - offs[probe_idx]
    build_idx = start.to(torch.int64)[probe_idx] + within
    build_valid = (within < cnt.to(torch.int64)[probe_idx]) & live
    build_idx = torch.where(build_valid, build_idx, 0)
    return probe_idx, build_idx, build_valid, total.to(torch.int32)


def _null_columns(schema: Schema, cap: int, device) -> List[Column]:
    """All-null columns of `schema` (zero data, validity all False)."""
    empty = ColumnBatch.empty(schema, cap, device=device)
    return [Column(f.dtype, c.data,
                   torch.zeros((cap,), dtype=torch.bool, device=device))
            for f, c in zip(schema.fields, empty.columns)]


def _nullable(fields: Sequence[Field]) -> List[Field]:
    return [Field(f.name, f.dtype, True) for f in fields]


def _output_fields(jt: JoinType, lf: List[Field], rf: List[Field],
                   existence_name: str) -> List[Field]:
    if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
        return lf
    if jt == JoinType.EXISTENCE:
        return lf + [Field(existence_name, T.BOOLEAN, nullable=False)]
    # outer sides become nullable
    if jt in (JoinType.RIGHT, JoinType.FULL):
        lf = _nullable(lf)
    if jt in (JoinType.LEFT, JoinType.FULL):
        rf = _nullable(rf)
    return lf + rf


def _rows(batch: Optional[ColumnBatch]) -> int:
    return 0 if batch is None else int(to_host(batch.num_rows))


# ---------------------------------------------------------------------------
# the join operator
# ---------------------------------------------------------------------------

class HashJoinLikeExec(Operator):
    """Shared engine for SMJ and BHJ (they differ in build-side sourcing
    and planner-side thresholds, not in the matching algorithm here)."""

    def __init__(self, left: Operator, right: Operator,
                 keys: Sequence[JoinKey], join_type: JoinType,
                 build_is_left: bool = False,
                 join_filter: Optional[ir.Expr] = None,
                 existence_name: str = "exists") -> None:
        super().__init__([left, right])
        self.keys = list(keys)
        self.join_type = join_type
        self.build_is_left = build_is_left
        self.join_filter = join_filter
        self.existence_name = existence_name
        lf = list(left.schema.fields)
        rf = list(right.schema.fields)
        self._schema = Schema(_output_fields(join_type, lf, rf,
                                             existence_name))

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("join", self.join_type.value, self.build_is_left,
                tuple(k.key() for k in self.keys),
                self.join_filter.key() if self.join_filter else None,
                self.children[0].plan_key(), self.children[1].plan_key())

    # -- probe/build wiring --
    def _probe_build(self) -> Tuple[Operator, Operator, List[int], List[int]]:
        lcols = [k.left for k in self.keys]
        rcols = [k.right for k in self.keys]
        if self.build_is_left:
            return (self.children[1], self.children[0], rcols, lcols)
        return (self.children[0], self.children[1], lcols, rcols)

    def execute(self, ctx: ExecContext) -> BatchStream:
        return count_stream(self, self._gen(ctx))

    def _gen(self, ctx: ExecContext):
        probe_op, build_op, probe_cols, build_cols = self._probe_build()
        jt = self.join_type
        probe_is_left = not self.build_is_left
        build_side_semi = self.build_is_left and jt in _SEMI_LIKE

        build_batches = list(build_op.execute(ctx))
        if build_batches:
            build = concat_batches(build_batches, build_op.schema)
            build_rows = _rows(build)
            compile_service.canonical_batch(build, "join_build",
                                            raw_rows=build_rows)
        else:
            build = ColumnBatch.empty(build_op.schema, device=ctx.device)
            build_rows = 0

        # Runtime build-size fallback (ref broadcast_join_exec.rs:188-249:
        # an oversized collected build side switches the operator from its
        # hash-table strategy to sort-merge). The kernel is already
        # sort-based, so "fall back to SMJ" means bounded-memory build
        # processing: the build side is joined in sorted CHUNKS instead of
        # as one resident sorted batch. Inner and probe-side
        # semi/anti/existence joins merge exactly across chunks; other
        # types keep the resident path.
        if (isinstance(self, BroadcastJoinExec)
                and conf.enable_bhj_fallbacks_to_smj
                and self.join_filter is None
                and not build_side_semi
                and jt in (JoinType.INNER,) + _SEMI_LIKE):
            from blaze_tpu_torch.runtime.memory import batch_nbytes

            if (build_rows > conf.bhj_fallback_rows_threshold
                    or batch_nbytes(build) > conf.bhj_fallback_mem_threshold):
                self.metrics.add("bhj_fallback_to_smj", 1)
                yield from self._gen_chunked_build(
                    ctx, probe_op, build, build_rows, probe_cols, build_cols,
                    jt)
                return

        null_safe = [k.null_safe for k in self.keys]
        # the build sort uses its natural flag layout; a probe batch with
        # validity adds flag keys to the match sort, and an all-ones flag
        # over an all-valid build column is constant, so the composite
        # order stays aligned either way
        build_flags = [build.columns[bc].validity is not None
                       for bc in build_cols]
        build_sorted = self._sort_build(build, build_cols, null_safe,
                                        build_flags)

        build_matched = torch.zeros((build_sorted.capacity,),
                                    dtype=torch.bool,
                                    device=build_sorted.device)
        need_build_matched = build_side_semi or (
            jt == JoinType.FULL
            or (jt == JoinType.RIGHT and probe_is_left)
            or (jt == JoinType.LEFT and not probe_is_left))

        for probe in probe_op.execute(ctx):
            ctx.check_running()
            # per-batch flag layout: either side nullable -> flag key
            force_flags = [
                bf or probe.columns[pc].validity is not None
                for bf, pc in zip(build_flags, probe_cols)]
            with self.metrics.timer("join_time_ns"):
                out, matched, n_out = self._join_batch(
                    probe, build_sorted, probe_cols, build_cols, null_safe,
                    force_flags, probe_is_left, build_side_semi)
            if need_build_matched:
                build_matched = build_matched | matched
            if n_out > 0:
                yield out

        if build_side_semi:
            out = self._build_side_semi_result(build_sorted, build_matched)
            if _rows(out) > 0:
                yield out
        elif need_build_matched:
            out = self._unmatched_build(build_sorted, build_matched,
                                        probe_is_left, probe_op.schema)
            if out is not None:
                yield out

    def _gen_chunked_build(self, ctx: ExecContext, probe_op: Operator,
                           build: ColumnBatch, nrows: int,
                           probe_cols: List[int], build_cols: List[int],
                           jt: JoinType):
        """Bounded-memory join against an oversized build side: the build
        rows are processed in sorted chunks (each chunk's sort stays under
        the fallback threshold). Inner outputs union across chunks; semi/
        anti/existence accumulate per-probe-row match counts and emit
        after the last chunk."""
        from blaze_tpu_torch.runtime.memory import batch_nbytes

        null_safe = [k.null_safe for k in self.keys]
        # chunk rows bound by BOTH thresholds: a byte-triggered fallback
        # (huge rows, few of them) must not end up with one whole-build
        # chunk
        bytes_per_row = max(batch_nbytes(build) // max(build.capacity, 1),
                            1)
        cs_mem = conf.bhj_fallback_mem_threshold // bytes_per_row
        cs = bucket_capacity(int(max(min(
            conf.bhj_fallback_rows_threshold, cs_mem, 1 << 20), 1024)))
        nchunks = (nrows + cs - 1) // cs
        chunks = []
        iota = torch.arange(build.capacity, dtype=torch.int64,
                            device=build.device)
        for i in range(nchunks):
            lo = i * cs
            piece = build.take(iota[lo:lo + cs], min(cs, nrows - lo))
            flags = [piece.columns[bc].validity is not None
                     for bc in build_cols]
            chunks.append(self._sort_build(piece, build_cols, null_safe,
                                           flags))
        semi_like = jt in _SEMI_LIKE
        for probe in probe_op.execute(ctx):
            ctx.check_running()
            cnt_total = torch.zeros((probe.capacity,), dtype=torch.int64,
                                    device=probe.device)
            for piece in chunks:
                force_flags = [
                    piece.columns[bc].validity is not None
                    or probe.columns[pc].validity is not None
                    for bc, pc in zip(build_cols, probe_cols)]
                if semi_like:
                    _, cnt, _ = match_ranges(piece, probe, build_cols,
                                             probe_cols, null_safe,
                                             force_flags)
                    cnt_total = cnt_total + cnt
                    continue
                # INNER: per-chunk pair outputs union exactly
                with self.metrics.timer("join_time_ns"):
                    out, _, n_out = self._join_batch(
                        probe, piece, probe_cols, build_cols, null_safe,
                        force_flags, not self.build_is_left, False)
                if n_out > 0:
                    yield out
            if semi_like:
                out = self._semi_like(probe, cnt_total, jt)
                if _rows(out) > 0:
                    yield out

    def _sort_build(self, build: ColumnBatch, build_cols: List[int],
                    null_safe: List[bool], force_flags: List[bool]
                    ) -> ColumnBatch:
        keys = _join_sort_keys(build, build_cols, null_safe, force_flags, 0)
        return sort_batch_by_keys(build, keys)

    def _build_side_semi_result(self, build_sorted: ColumnBatch,
                                matched: torch.Tensor) -> ColumnBatch:
        """LEFT semi/anti/existence when the LEFT child is the build side."""
        jt = self.join_type
        if jt == JoinType.EXISTENCE:
            cols = build_sorted.columns + [
                Column(T.BOOLEAN, matched & build_sorted.row_mask(), None)]
            return ColumnBatch(self._schema, cols, build_sorted.num_rows,
                               build_sorted.capacity)
        keep = matched if jt == JoinType.LEFT_SEMI else ~matched
        return build_sorted.with_columns(
            self._schema, build_sorted.columns).compact(keep)

    # -- per-probe-batch join --
    def _join_batch(self, probe, build_sorted, probe_cols, build_cols,
                    null_safe, force_flags, probe_is_left, build_side_semi):
        """-> (output batch or None, matched flags of the sorted build
        rows, output rows). The output rows are known on the host where
        they cost no extra read; otherwise they are read once here."""
        jt = self.join_type
        start, cnt, bmatch = match_ranges(build_sorted, probe, build_cols,
                                          probe_cols, null_safe, force_flags)
        matched_now = bmatch > 0

        if self.join_filter is not None and jt != JoinType.INNER:
            return self._join_batch_filtered(probe, build_sorted, start, cnt,
                                             probe_is_left, build_side_semi)
        if build_side_semi:
            return None, matched_now, 0
        if jt in _SEMI_LIKE:
            out = self._semi_like(probe, cnt, jt)
            return out, matched_now, _rows(out)

        emit_unmatched = ((jt == JoinType.LEFT and probe_is_left)
                          or (jt == JoinType.RIGHT and not probe_is_left)
                          or jt == JoinType.FULL)
        out, _, _, _, total = self._expand(probe, build_sorted, start, cnt,
                                           emit_unmatched, probe_is_left,
                                           self._schema)
        if out is None:
            return None, matched_now, 0
        if self.join_filter is not None:
            out = self._apply_inner_filter(out)
            return out, matched_now, _rows(out)
        return out, matched_now, total

    def _expand(self, probe, build_sorted, start, cnt, emit_unmatched,
                probe_is_left, schema):
        """The expansion of one probe batch: (batch or None, probe index,
        build index, build valid, total rows). The total is the batch's one
        host read."""
        eff = torch.clamp(cnt, min=1) if emit_unmatched else cnt
        total = int(to_host(torch.where(probe.row_mask(), eff, 0).sum()))
        if total == 0:
            return None, None, None, None, 0
        out_cap = bucket_capacity(total)
        pidx, bidx, bvalid, num = expand_pairs(
            start, cnt, out_cap, emit_unmatched,
            probe_mask=probe.row_mask())
        pcols = [take_rows(c, pidx) for c in probe.columns]
        bcols = [take_rows(c, bidx, bvalid) for c in build_sorted.columns]
        cols = (pcols + bcols) if probe_is_left else (bcols + pcols)
        return (ColumnBatch(schema, cols, num, out_cap), pidx, bidx, bvalid,
                total)

    def _semi_like(self, probe: ColumnBatch, cnt: torch.Tensor,
                   jt: JoinType) -> ColumnBatch:
        if jt == JoinType.EXISTENCE:
            cols = probe.columns + [Column(T.BOOLEAN, cnt > 0, None)]
            return ColumnBatch(self._schema, cols, probe.num_rows,
                               probe.capacity)
        keep = (cnt > 0) if jt == JoinType.LEFT_SEMI else (cnt == 0)
        return probe.with_columns(self._schema, probe.columns).compact(keep)

    def _apply_inner_filter(self, out: ColumnBatch) -> ColumnBatch:
        """Residual non-equi filter on INNER joins: simple compaction.
        (Non-inner filters take _join_batch_filtered.)"""
        c = compile_expr(self.join_filter, self._schema)(out)
        ok = c.data.to(torch.bool) & c.valid_mask() & out.row_mask()
        return out.compact(ok)

    def _join_batch_filtered(self, probe, build_sorted, start, cnt,
                             probe_is_left, build_side_semi):
        """Join filter on non-inner joins (ref sort_merge_join_exec.rs join
        filter handling): expand matched pairs, evaluate the residual
        predicate, then re-derive per-probe surviving counts and per-build
        matched flags from the SURVIVORS — outer rows whose matches all
        fail the filter revert to null-extended, semi/anti/existence count
        only passing matches."""
        jt = self.join_type
        capP, capB = probe.capacity, build_sorted.capacity
        dev = probe.device
        probe_outer = (not build_side_semi) and (
            (jt == JoinType.LEFT and probe_is_left)
            or (jt == JoinType.RIGHT and not probe_is_left)
            or jt == JoinType.FULL)
        semi_like = (not build_side_semi) and jt in _SEMI_LIKE
        # the filter always sees left-fields + right-fields, whatever the
        # join's OUTPUT schema (semi/anti/existence outputs omit the build
        # side but the predicate references it)
        pair_schema = Schema(list(self.children[0].schema.fields)
                             + list(self.children[1].schema.fields))
        out, pidx, bidx, bvalid, _ = self._expand(
            probe, build_sorted, start, cnt, probe_outer, probe_is_left,
            pair_schema)
        if out is None:
            cnt_ok = torch.zeros((capP,), dtype=torch.int64, device=dev)
            matched_now = torch.zeros((capB,), dtype=torch.bool, device=dev)
        else:
            c = compile_expr(self.join_filter, pair_schema)(out)
            ok = (c.data.to(torch.bool) & c.valid_mask() & out.row_mask()
                  & bvalid)
            ones = ok.to(torch.int64)
            cnt_ok = torch.zeros((capP + 1,), dtype=torch.int64,
                                 device=dev).scatter_add_(
                0, torch.where(ok, pidx, capP), ones)[:capP]
            matched_now = torch.zeros((capB + 1,), dtype=torch.int64,
                                      device=dev).scatter_add_(
                0, torch.where(ok, bidx, capB), ones)[:capB] > 0

        if build_side_semi:
            return None, matched_now, 0
        if semi_like:
            if jt == JoinType.EXISTENCE:
                cols = probe.columns + [Column(T.BOOLEAN, cnt_ok > 0, None)]
                res = ColumnBatch(self._schema, cols, probe.num_rows,
                                  probe.capacity)
            else:
                keep = (cnt_ok > 0) if jt == JoinType.LEFT_SEMI \
                    else (cnt_ok == 0)
                res = probe.with_columns(self._schema,
                                         probe.columns).compact(keep)
            return res, matched_now, _rows(res)

        if out is None:
            return None, matched_now, 0
        # probe-side outer (LEFT/RIGHT/FULL): keep passing pairs, keep the
        # key-unmatched null emissions, and DEMOTE the first pair of probe
        # rows whose matches all failed to a null-extended row
        live = out.row_mask()
        if probe_outer:
            is_first = torch.ones_like(live)
            is_first[1:] = pidx[1:] != pidx[:-1]
            demote = is_first & bvalid & (cnt_ok[pidx] == 0) & live
        else:
            demote = torch.zeros_like(live)
        keep = ok | (live & ~bvalid) | demote
        # build columns become null on demoted rows
        nb = len(build_sorted.schema.fields)
        cols = list(out.columns)
        brange = range(len(cols) - nb, len(cols)) if probe_is_left \
            else range(nb)
        for i in brange:
            cols[i] = Column(cols[i].dtype, cols[i].data,
                             cols[i].valid_mask() & ok)
        res = out.with_columns(self._schema, cols).compact(keep)
        return res, matched_now, _rows(res)

    def _unmatched_build(self, build_sorted, build_matched, probe_is_left,
                         probe_schema) -> Optional[ColumnBatch]:
        keep = (~build_matched) & build_sorted.row_mask()
        picked = build_sorted.compact(keep)
        if _rows(picked) == 0:
            return None
        nulls = _null_columns(probe_schema, picked.capacity, picked.device)
        cols = (nulls + picked.columns) if probe_is_left \
            else (picked.columns + nulls)
        return ColumnBatch(self._schema, cols, picked.num_rows,
                           picked.capacity)


class SortMergeJoinExec(HashJoinLikeExec):
    """Ref: sort_merge_join_exec.rs — the plan-level contract (sorted
    children) is accepted but not required; the kernel sorts the build
    side itself."""


class BroadcastJoinExec(HashJoinLikeExec):
    """Ref: broadcast_join_exec.rs — the build side comes from a
    broadcast; an oversized one takes the chunked build."""


class BroadcastNestedLoopJoinExec(Operator):
    """Ref: broadcast_nested_loop_join_exec.rs — cross/conditional join.

    The cartesian pairs are enumerated in left chunks (probe-row-major),
    the optional condition is evaluated on each chunk, and survivors are
    compacted. Outer variants track per-row match flags across chunks."""

    def __init__(self, left: Operator, right: Operator, join_type: JoinType,
                 condition: Optional[ir.Expr] = None) -> None:
        super().__init__([left, right])
        self.join_type = join_type
        self.condition = condition
        self._schema = Schema(_output_fields(
            join_type, list(left.schema.fields), list(right.schema.fields),
            "exists"))

    @property
    def schema(self) -> Schema:
        return self._schema

    def plan_key(self) -> tuple:
        return ("bnlj", self.join_type.value,
                self.condition.key() if self.condition else None,
                self.children[0].plan_key(), self.children[1].plan_key())

    def execute(self, ctx: ExecContext) -> BatchStream:
        return count_stream(self, self._gen(ctx))

    def _side(self, i: int, ctx: ExecContext) -> ColumnBatch:
        child = self.children[i]
        batches = list(child.execute(ctx))
        if batches:
            return concat_batches(batches, child.schema)
        return ColumnBatch.empty(child.schema, device=ctx.device)

    def _gen(self, ctx: ExecContext):
        ls, rs = self._side(0, ctx), self._side(1, ctx)
        nl, nr = (int(v) for v in to_host(torch.stack(
            [ls.num_rows, rs.num_rows.to(ls.device)])))
        jt = self.join_type

        if nl == 0 or nr == 0:
            if jt in (JoinType.LEFT, JoinType.FULL) and nl > 0:
                yield self._one_side_nulls(ls, rs.schema, left_side=True)
            if jt in (JoinType.RIGHT, JoinType.FULL) and nr > 0:
                yield self._one_side_nulls(rs, ls.schema, left_side=False)
            if jt == JoinType.LEFT_ANTI and nl > 0:
                yield ls.with_columns(self._schema, ls.columns)
            if jt == JoinType.EXISTENCE and nl > 0:
                cols = ls.columns + [Column(
                    T.BOOLEAN, torch.zeros((ls.capacity,), dtype=torch.bool,
                                           device=ls.device), None)]
                yield ColumnBatch(self._schema, cols, ls.num_rows,
                                  ls.capacity)
            return

        # every left row pairs with all right rows: expand the product in
        # LEFT CHUNKS so one expansion stays near 16 batches of rows
        chunk = max(1, (conf.batch_size * 16) // max(nr, 1))
        rmatched_total = torch.zeros((rs.capacity,), dtype=torch.bool,
                                     device=rs.device)
        for lo in range(0, nl, chunk):
            ctx.check_running()
            lc = slice_batch(ls, lo, chunk)
            nc = min(chunk, nl - lo)
            start = torch.zeros((lc.capacity,), dtype=torch.int64,
                                device=lc.device)
            cnt = torch.where(lc.row_mask(), nr, 0).to(torch.int64)
            out, lmatched, rmatched = self._expand_nlj(lc, rs, start, cnt,
                                                       nc * nr)
            rmatched_total = rmatched_total | rmatched
            if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
                keep = lmatched if jt == JoinType.LEFT_SEMI else ~lmatched
                part = lc.with_columns(self._schema,
                                       lc.columns).compact(keep)
                if _rows(part):
                    yield part
                continue
            if jt == JoinType.EXISTENCE:
                cols = lc.columns + [Column(
                    T.BOOLEAN, lmatched & lc.row_mask(), None)]
                yield ColumnBatch(self._schema, cols, lc.num_rows,
                                  lc.capacity)
                continue
            if _rows(out):
                yield out
            if jt in (JoinType.LEFT, JoinType.FULL):
                un = lc.compact((~lmatched) & lc.row_mask())
                if _rows(un):
                    yield self._one_side_nulls(un, rs.schema,
                                               left_side=True)
        if jt in (JoinType.RIGHT, JoinType.FULL):
            un = rs.compact((~rmatched_total) & rs.row_mask())
            if _rows(un):
                yield self._one_side_nulls(un, ls.schema, left_side=False)

    def _expand_nlj(self, ls, rs, start, cnt, total: int):
        """The pairs of one left chunk against all right rows (`total` of
        them, known on the host): (output or None, left matched, right
        matched)."""
        out_cap = bucket_capacity(total)
        pidx, bidx, _, num = expand_pairs(start, cnt, out_cap, False)
        lcols = [take_rows(c, pidx) for c in ls.columns]
        rcols = [take_rows(c, bidx) for c in rs.columns]
        pair_schema = Schema(list(ls.schema.fields) + list(rs.schema.fields))
        out = ColumnBatch(pair_schema, lcols + rcols, num, out_cap)
        if self.condition is not None:
            c = compile_expr(self.condition, pair_schema)(out)
            ok = c.data.to(torch.bool) & c.valid_mask() & out.row_mask()
            lmatched = _any_by_index(pidx, ok, ls.capacity)
            rmatched = _any_by_index(bidx, ok, rs.capacity)
            out = out.compact(ok)
        else:
            lmatched = ls.row_mask()
            rmatched = rs.row_mask()
        if self.join_type in _SEMI_LIKE:
            return None, lmatched, rmatched
        return (out.with_columns(self._schema, out.columns), lmatched,
                rmatched)

    def _one_side_nulls(self, present: ColumnBatch, other_schema: Schema,
                        left_side: bool) -> ColumnBatch:
        nulls = _null_columns(other_schema, present.capacity, present.device)
        cols = (present.columns + nulls) if left_side \
            else (nulls + present.columns)
        return ColumnBatch(self._schema, cols, present.num_rows,
                           present.capacity)


def _any_by_index(idx: torch.Tensor, flag: torch.Tensor,
                  out_size: int) -> torch.Tensor:
    """out[i] = OR of flag[j] where idx[j] == i (one scatter-add; the JAX
    package sorts instead, having no cheap scatter on the TPU)."""
    hits = torch.zeros((out_size,), dtype=torch.int32, device=idx.device)
    return hits.scatter_add_(0, idx, flag.to(torch.int32)) > 0
