"""Whole-stage execution: the dense grouped aggregation and the chain stage.

Port of blaze_tpu/runtime/stage_compiler.py. A stage
`source -> (filter|project|rename)* -> Agg PARTIAL [-> Agg FINAL]` whose
grouping keys are integral with a bounded packed range and whose
aggregates are sum/count/avg/min/max/first/first_ignores_null runs as:

  1. a probe pass over the stage's batches: per-key min/max over live rows,
     a null-key check and each float sum's abs-max (skipped when the
     per-plan memo `_R_MEMO` already holds the dense range and scales);
  2. one eager pass over the batches: filters fold into a row mask, keys
     pack into one int32 dense index, sum/count/avg inputs digitize into
     base-256 digit planes at the probed fixed scales, and the planes
     accumulate per group straight into an exact int64 carry
     (ops/mxu_agg.accumulate_into — the CUDA kernel chain on the card;
     planes past what one launch takes split into launch groups, each
     with its own carry and launch). Beside the carries, each
     min/max/first aggregate keeps a dense per-group carrier that a
     scatter reduction updates every batch;
  3. one recombination per stage (mxu_agg.finalize) and output assembly,
     finalized values for a FINAL root or the partial's typed state
     columns (`state_fields` layout) for a partial-only stage.

Each pass pulls one small tensor to the host: the probe's ranges, then the
(oob, num_rows) flags. The oob flag trips when data left the memoized
range, a key went null or a float overflowed its fixed scale; the stage
then re-probes once. A stage this path cannot run — null keys, a key range
beyond `conf.dense_agg_range`, batches of different shapes, data that
still drifts after the re-probe — falls back: its captured batches replay
through the streaming sort-based AggExec (`_fallback`).

An agg-less `source -> (filter|project|rename)+` stage runs as one chain
stage (`_run_chain_stage`): the chain over every batch with filters as
masks, and all surviving rows compacted into ONE output batch.

The probe, the dense pass and the chain stage are built once per plan
and batch shape and reused across tasks through runtime/jit_cache.py,
under the JAX module's keys; each attempt and each completed stage is
counted in the compile service's stage_attempts / stage_compiled
(runtime/compile_service.py). With conf.enable_input_batch_statistics a
stage that runs here records no per-batch statistics (it has no batch
stream) and warns once, as the JAX module does.

With conf.trace_enabled every attempt, dense group count and fallback is
a trace event (whole_stage_attempt, whole_stage_groups,
whole_stage_fallback) carrying the root operator's fingerprint, as in
the JAX module; with conf.history_dir the group counts and output rows
feed the history store's taps (runtime/history.py), since this path
bypasses count_stream's per-batch row tap.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from blaze_tpu_torch.columnar import types as T
from blaze_tpu_torch.columnar.batch import (
    Column, ColumnBatch, StringData, StructData, bucket_capacity,
    map_tensors,
)
from blaze_tpu_torch.columnar.types import TypeKind
from blaze_tpu_torch.config import conf
from blaze_tpu_torch.exprs import strings as S
from blaze_tpu_torch.ops import mxu_agg
from blaze_tpu_torch.ops import segment as seg
from blaze_tpu_torch.ops.agg import (
    AggExec, AggMode, result_field, state_fields,
)
from blaze_tpu_torch.ops.base import ExecContext, MapLikeOp, Operator
from blaze_tpu_torch.runtime import compile_service, jit_cache, trace
from blaze_tpu_torch.runtime.metrics import to_host

_GROUP_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                TypeKind.INT64, TypeKind.DATE)
# plane fns ride digit planes; min/max/first fns ride dense per-group
# scatter carriers beside the planes' int64 carry
_PLANE_FNS = ("sum", "count", "avg")
_MM_FNS = ("min", "max")
_FIRST_FNS = ("first", "first_ignores_null")
_AGG_FNS = _PLANE_FNS + _MM_FNS + _FIRST_FNS
# scalar value kinds a dense min/max/first carrier can hold
_MM_VALUE_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                   TypeKind.INT64, TypeKind.DATE, TypeKind.TIMESTAMP,
                   TypeKind.DECIMAL, TypeKind.FLOAT32, TypeKind.FLOAT64)

# (plan, batch shape) -> (spans, kmins, scales) of the last probe
_R_MEMO: dict = {}
_BIG = 2 ** 62
_stats_warned = False


def _warn_stats_once() -> None:
    """Per-batch statistics hook into the streaming path's count_stream; a
    whole-stage run has no batch stream. Called only when a stage did run
    here, so plans that never match the pattern raise no false alarm."""
    global _stats_warned
    if conf.enable_input_batch_statistics and not _stats_warned:
        _stats_warned = True
        import logging

        logging.getLogger(__name__).warning(
            "enable_input_batch_statistics records nothing for "
            "whole-stage-compiled stages (single dispatch, no batch "
            "stream); disable the stage compiler to collect stats")


def _walk_chain(node: Operator):
    """Longest row-aligned map chain below `node` (filters fold as masks).
    Returns (chain top-down, source below it); chain may be empty."""
    from blaze_tpu_torch.ops.basic import (
        FilterExec, ProjectExec, RenameColumnsExec,
    )

    chain: List[MapLikeOp] = []
    n = node
    while isinstance(n, MapLikeOp):
        if not n.jit_safe() or not isinstance(
                n, (FilterExec, ProjectExec, RenameColumnsExec)):
            return None
        chain.append(n)
        n = n.child
    return list(reversed(chain)), n


def _build_steps(chain: List[MapLikeOp]):
    """("mask", predicate fns) | ("map", batch fn) per chain op."""
    from blaze_tpu_torch.ops.basic import FilterExec

    steps = []
    for op in chain:
        if isinstance(op, FilterExec):
            steps.append(("mask", list(op._fns)))
        else:
            steps.append(("map", op.make_batch_fn()))
    return steps


def _apply_steps(steps, b: ColumnBatch):
    """-> (batch, mask): run the chain with filters folded as a row mask
    over the (uncompacted) rows; one CSE scope per step."""
    from blaze_tpu_torch.exprs.compiler import cse_scope

    mask = b.row_mask()
    for kind, fn in steps:
        with cse_scope():
            if kind == "map":
                b = fn(b)
            else:
                for pf in fn:
                    c = pf(b)
                    mask = mask & c.data.to(torch.bool) & c.valid_mask()
    return b, mask


def _match(root: Operator):
    """(final, partial, chain(list, top-down), source) or None."""
    final = None
    node = root
    if isinstance(node, AggExec) and node.mode == AggMode.FINAL:
        final = node
        node = node.children[0]
    if not (isinstance(node, AggExec) and node.mode == AggMode.PARTIAL):
        return None
    partial = node
    # final=None is the shuffle-map-side shape: the stage emits the
    # partial's typed STATE columns instead of finalized values
    if final is not None and (
            len(final.group_exprs) != len(partial.group_exprs)
            or [c.fn for c in final.aggs] != [c.fn for c in partial.aggs]):
        return None
    if not (1 <= len(partial.group_exprs) <= 4):
        return None  # composite keys pack into one dense range (below)
    for call in partial.aggs:
        if call.fn not in _AGG_FNS or len(call.inputs) != 1:
            return None
        if call.dtype.wide_decimal:
            return None
        if call.fn in _MM_FNS + _FIRST_FNS and \
                call.dtype.kind not in _MM_VALUE_KINDS:
            return None  # strings keep the streaming path
    if not partial._work_jit:
        return None
    m = _walk_chain(partial.children[0])
    if m is None:
        return None
    chain, n = m
    return final, partial, chain, n


def _match_chain(root: Operator):
    """Agg-less stage: a pure row-aligned map chain over a source.
    Returns (chain top-down, source) or None."""
    m = _walk_chain(root)
    if m is None or not m[0]:
        return None
    return m


def _fallback(root: Operator, batches: List[ColumnBatch], source: Operator,
              ctx: ExecContext) -> ColumnBatch:
    """The general path for a stage whose source is already drained: the
    captured batches replay through the streaming operators."""
    from blaze_tpu_torch.ops.basic import MemorySourceExec
    from blaze_tpu_torch.runtime.executor import collect_streamed

    root.metrics.add("stage_fallbacks", 1)
    trace.event("whole_stage_fallback", op_kind=type(root).__name__,
                fingerprint=_stage_fp(root))
    if conf.history_dir:
        from blaze_tpu_torch.runtime import history

        fp = _stage_fp(root)
        if fp is not None:
            history.observe_groups(fp, type(root).__name__, None,
                                   dense=False)
    src = MemorySourceExec(batches, source.schema)
    return collect_streamed(_rebuild(root, source, src), ctx,
                            batches[0].device)


def _rebuild(root: Operator, source: Operator,
             new_source: Operator) -> Operator:
    """Clone the operator chain with THE stage-source node (identity
    match) swapped for a replayable source.

    Replacing every LEAF instead corrupts any stage whose source subtree
    has several leaves: in the JAX package an agg over a broadcast join
    got its scan AND both broadcast readers replaced by the captured JOIN
    OUTPUT and re-joined it (silently wrong counts)."""
    import copy

    def clone(op: Operator) -> Operator:
        if op is source:
            return new_source
        c = copy.copy(op)
        c.children = [clone(ch) for ch in op.children]
        return c

    return clone(root)


def _meta_like(b: ColumnBatch) -> ColumnBatch:
    """Shape-and-dtype twin of `b` on the meta device (no data)."""
    def t(x):
        return torch.empty_like(x, device="meta")

    cols = [map_tensors(c, t) for c in b.columns]
    return ColumnBatch(b.schema, cols, t(b.num_rows), b.capacity)


def try_run_stage(root: Operator, ctx: ExecContext,
                  chain_ok: bool = True) -> Optional[ColumnBatch]:
    """Run the stage through the whole-stage path, or None when the plan is
    not one of its patterns (the caller then streams it). A matching stage
    that the dense path declines after draining its source falls back to
    the streaming operators over the captured batches.

    chain_ok=False (the shuffle writers): an agg-less chain stage compacts
    the WHOLE stage into one batch, which is fine for a collect but would
    defeat a writer's bounded buffers; agg stages are bounded by their
    group count and run either way."""
    if not conf.enable_stage_compiler:
        return None
    if conf.fault_injection_spec:
        # the whole-stage path bypasses the streaming operators' batch
        # boundaries: chaos specs get the same "op" point here
        from blaze_tpu_torch.runtime import faults

        faults.inject("op." + type(root).__name__)
    compile_service.note_stage_attempt()
    trace.event("whole_stage_attempt", op_kind=type(root).__name__,
                fingerprint=_stage_fp(root))
    m = _match(root)
    if m is None:
        if not chain_ok:
            return None
        mc = _match_chain(root)
        if mc is None:
            return None
        return _run_chain_stage(root, mc[0], mc[1], ctx)
    final, partial, chain, source = m
    gdtypes = [f.dtype for f in partial._group_fields]
    if any(dt.kind not in _GROUP_KINDS for dt in gdtypes):
        return None

    batches = list(source.execute(ctx))
    ctx.check_running()
    if not batches:
        return None
    shape0 = batches[0].shape_key()
    if any(b.shape_key() != shape0 for b in batches[1:]):
        return _fallback(root, batches, source, ctx)
    compile_service.pad_batch_list(batches, "stage_agg")  # notes only

    input_fns = [fns[0] for fns in partial._input_fns]
    # validity presence and value dtypes of each aggregate input decide the
    # plane layout and the carriers; read them off a data-free twin of the
    # first batch
    mb, _ = _apply_steps(_build_steps(chain), _meta_like(batches[0]))
    sum_is_float, has_validity, val_dtypes = [], [], []
    for i, call in enumerate(partial.aggs):
        col = input_fns[i](mb)
        has_validity.append(col.validity is not None)
        # a string input reaches here only under count, which reads its
        # validity alone
        vdt = torch.uint8 if col.is_string else col.data.dtype
        sum_is_float.append(call.fn in ("sum", "avg")
                            and vdt.is_floating_point)
        val_dtypes.append(vdt)
    float_calls = [i for i, f in enumerate(sum_is_float) if f]

    group_fns = list(partial._group_fns)
    calls = list(partial.aggs)
    schema = (final or partial).schema
    is_final = final is not None

    # the cached callables hold the plan's compiled functions and statics,
    # never an operator (whose source may hold a task's batches)
    def make_probe():
        steps = _build_steps(chain)
        return lambda bs: _probe(bs, steps, group_fns, input_fns,
                                 float_calls)

    def make_dense(spans, kmins, scales):
        steps = _build_steps(chain)
        return lambda bs: _run_dense(
            bs, steps, group_fns, calls, schema, is_final, input_fns,
            gdtypes, sum_is_float, has_validity, val_dtypes, spans, kmins,
            scales)

    memo_key = (root.plan_key(), shape0)
    out = None
    nrows = 0
    for _attempt in (0, 1):
        memo = _R_MEMO.get(memo_key)
        if memo is None:
            memo = jit_cache.get_or_compile(
                ("stage_probe", root.plan_key(), shape0, len(batches)),
                make_probe)(batches)
            if memo is None:  # null keys or a range beyond dense_agg_range
                return _fallback(root, batches, source, ctx)
            _R_MEMO[memo_key] = memo
        key = ("stage", root.plan_key(), shape0, len(batches), *memo,
               mxu_agg.f64_chunks())
        out, flags = jit_cache.get_or_compile(
            key, lambda: make_dense(*memo))(batches)
        flags = to_host(flags)  # the stage's one result-side host pull
        nrows = int(flags[1])
        if not bool(flags[0]):
            break
        # data drifted past the memoized range: re-probe once, then (a
        # second trip means null keys or a range past the limit) take the
        # general path
        _R_MEMO.pop(memo_key, None)
        out = None
    if out is None:
        return _fallback(root, batches, source, ctx)
    _warn_stats_once()
    for op in filter(None, (final, partial, *chain)):
        op.metrics.add("output_batches", 1)
    root.metrics.add("output_rows", nrows)
    root.metrics.add("stage_compiled", 1)
    compile_service.note_stage_compiled()
    # observed groupby cardinality: the dense path knows the exact group
    # count from the flags it already pulled
    _note_stage_stats(root, nrows, dense=True)
    return out


def _run_chain_stage(root: Operator, chain: List[MapLikeOp],
                     source: Operator, ctx: ExecContext
                     ) -> Optional[ColumnBatch]:
    """Agg-less scan->filter->project stage: the chain runs over every
    batch with filters as masks, and all surviving rows compact into ONE
    output batch of capacity (batches x capacity). The output is the
    stage's result, which a collect materializes anyway. The JAX package
    stacks the batches into one program (`lax.scan`) padded to a
    compile-service batch-count rung; here the chain runs batch by batch
    and the columns concatenate once."""
    for f in root.schema.fields:  # before draining the source
        if f.dtype.is_nested:
            # compacting list storage across batches: the streaming path,
            # as in the JAX package
            return None
    batches = list(source.execute(ctx))
    ctx.check_running()
    if not batches:
        return None
    shape0 = batches[0].shape_key()
    if any(b.shape_key() != shape0 for b in batches[1:]):
        return _fallback(root, batches, source, ctx)
    compile_service.pad_batch_list(batches, "stage_chain")  # notes only

    schema = root.schema

    def make():
        steps = _build_steps(chain)
        return lambda bs: _chain_program(bs, steps, schema)

    out = jit_cache.get_or_compile(
        ("stage_chain", root.plan_key(), shape0, len(batches)),
        make)(batches)
    _warn_stats_once()
    for op in chain:
        op.metrics.add("output_batches", 1)
    n = int(to_host(out.num_rows))
    root.metrics.add("output_rows", n)
    root.metrics.add("stage_compiled", 1)
    compile_service.note_stage_compiled()
    # chain stages have no group key: record output cardinality only
    _note_stage_stats(root, None, dense=True, rows=n)
    return out


def _chain_program(batches, steps, schema) -> ColumnBatch:
    """The chain over every batch, filters as masks, and the surviving rows
    of all batches compacted into one batch."""
    outs, masks = [], []
    for b in batches:
        ob, mask = _apply_steps(steps, b)
        outs.append(ob)
        masks.append(mask)
    cap = len(batches) * batches[0].capacity
    cols = []
    for i, f in enumerate(schema.fields):
        parts = [ob.columns[i] for ob in outs]
        valid = None
        if any(p.validity is not None for p in parts):
            valid = torch.cat([p.valid_mask() for p in parts])
        if parts[0].is_string:
            # one width: the batches share a shape key; dictionaries
            # expand (each batch may carry its own)
            w = max(p.data.width for p in parts)
            datas = [S.ensure_width(StringData(p.data.bytes, p.data.lengths),
                                    w) for p in parts]
            data = StringData(torch.cat([d.bytes for d in datas]),
                              torch.cat([d.lengths for d in datas]))
        elif parts[0].is_struct:  # a wide decimal's two limb planes
            data = StructData([Column(ch.dtype, torch.cat(
                [p.data.children[k].data for p in parts]))
                for k, ch in enumerate(parts[0].data.children)])
        else:
            data = torch.cat([p.data for p in parts])
        cols.append(Column(f.dtype, data, valid))
    flat = ColumnBatch(schema, cols,
                       torch.tensor(cap, dtype=torch.int32,
                                    device=batches[0].device), cap)
    return flat.compact(torch.cat(masks))


def _stage_fp(root: Operator):
    """Operator fingerprint for whole-stage events/history taps; None
    when neither tracing nor the history store would record it."""
    if not (conf.trace_enabled or conf.history_dir):
        return None
    from blaze_tpu_torch.runtime import history

    return history.op_fingerprint(root)


def _note_stage_stats(root: Operator, groups, dense: bool,
                      rows=None) -> None:
    """Feed the history taps for a whole-stage dispatch: the whole-stage
    path bypasses count_stream's per-batch row tap, so output rows and
    the dense-vs-fallback group cardinality are recorded here."""
    fp = _stage_fp(root)
    if fp is None:
        return
    trace.event("whole_stage_groups", op_kind=type(root).__name__,
                fingerprint=fp, groups=groups, dense=dense)
    if conf.history_dir:
        from blaze_tpu_torch.runtime import history

        history.observe_groups(fp, type(root).__name__, groups, dense)
        n = groups if rows is None else rows
        if n is not None:
            history.observe_rows(root, int(n))


def _probe(batches, steps, group_fns, input_fns, float_calls):
    """Pass 1: per-key min/max + null check + per-float-agg abs-max. Picks
    the smallest power-of-two dense span per key that covers the observed
    keys (composite keys pack into one index k = sum_i (k_i - min_i) *
    stride_i) and a FIXED float scale per float aggregate, so the
    accumulation's carry stays integer. None when keys are null or the
    packed range exceeds conf.dense_agg_range."""
    dev = batches[0].device
    nkeys = len(group_fns)
    big = torch.tensor(_BIG, dtype=torch.int64, device=dev)
    kmins, kmaxs = [big] * nkeys, [-big] * nkeys
    vmaxs = [torch.zeros((), dtype=torch.float64, device=dev)] * len(
        float_calls)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for b in batches:
        b, mask = _apply_steps(steps, b)
        for i, gfn in enumerate(group_fns):
            g = gfn(b)
            gv = g.valid_mask()
            bad = bad | (mask & ~gv).any()
            k = g.data.to(torch.int64)
            ok = mask & gv
            kmins[i] = torch.minimum(kmins[i], torch.where(ok, k, big).min())
            kmaxs[i] = torch.maximum(kmaxs[i], torch.where(ok, k, -big).max())
        for j, ci in enumerate(float_calls):
            vcol = input_fns[ci](b)
            v = vcol.data.to(torch.float64)
            ok = mask & vcol.valid_mask() & torch.isfinite(v)
            av = torch.where(ok, v.abs(), torch.zeros_like(v)).max()
            vmaxs[j] = torch.maximum(vmaxs[j], av)
    # one host pull: int64 ranges, f64 maxima reinterpreted as int64 bits
    parts = [torch.stack(kmins), torch.stack(kmaxs), bad.to(torch.int64)[None]]
    if vmaxs:
        parts.append(torch.stack(vmaxs).view(torch.int64))
    host = to_host(torch.cat(parts)).numpy()
    kmins_v, kmaxs_v = host[:nkeys], host[nkeys:2 * nkeys]
    if host[2 * nkeys]:
        return None  # null grouping keys: dense slots can't hold them
    vmaxs_v = host[2 * nkeys + 1:].view(np.float64)

    # fixed float scales: 2 spare bits of headroom under the digit
    # capacity (8*planes-2) over the probed max, so values drifting up to
    # 4x on later data still digitize; beyond that the oob flag re-probes
    cap_bits = 8.0 * mxu_agg.f64_chunks() - 4.0
    scales = []
    for j, ci in enumerate(float_calls):
        vmax = float(vmaxs_v[j])
        exp = (math.floor(math.log2(vmax)) + 1.0 if vmax > 0.0 else -996.0)
        scales.append((ci, min(cap_bits - exp, 1000.0)))
    spans, kmins = [], []
    for lo, hi in zip(kmins_v, kmaxs_v):
        lo, hi = (0, 0) if lo == _BIG else (int(lo), int(hi))
        # power-of-two headroom per key, so one new key value later does
        # not invalidate the memo
        span, bucket = max(hi - lo + 1, 1), 8
        while bucket < span:
            bucket <<= 1
        spans.append(bucket)
        kmins.append(lo)
    total = 1
    for sp in spans:
        total *= sp
    # keep the TOTAL dense range at >= 512 by widening the last span
    while total < 512:
        spans[-1] <<= 1
        total <<= 1
    if total > int(conf.dense_agg_range):
        return None
    return tuple(spans), tuple(kmins), tuple(scales)


def _pad(a: torch.Tensor, cap: int) -> torch.Tensor:
    if a.shape[0] == cap:
        return a
    return torch.cat([a, torch.zeros((cap - a.shape[0],), dtype=a.dtype,
                                     device=a.device)])


def _spec_costs(calls, sum_is_float, has_validity):
    """(planes, words) of each digitize spec, in _run_dense's spec order:
    the presence count, then per call a count plane for a nullable input
    and the digit planes of a sum (in two int32 words); min/max/first keep
    dense carriers instead."""
    costs = [(1, 1)]
    for i, call in enumerate(calls):
        if has_validity[i]:
            costs.append((1, 1))
        if call.fn in ("sum", "avg"):
            costs.append((mxu_agg.f64_chunks() if sum_is_float[i]
                          else mxu_agg.I64_CHUNKS, 2))
    return costs


def _launch_groups(costs):
    """The specs cut into consecutive runs that each fit one launch of the
    accumulate kernel (_MAX_PLANES planes, _MAX_WORDS words). Each run has
    its own carry and its own launch a batch; the JAX package's XLA
    accumulate has no such limit and takes all planes at once."""
    groups, cur, planes, words = [], [], 0, 0
    for si, (p, w) in enumerate(costs):
        if cur and (planes + p > mxu_agg._MAX_PLANES
                    or words + w > mxu_agg._MAX_WORDS):
            groups.append(cur)
            cur, planes, words = [], 0, 0
        cur.append(si)
        planes += p
        words += w
    groups.append(cur)
    return groups


def _init_carriers(calls, val_dtypes, R: int, dev) -> dict:
    """Dense per-group carriers of the min/max/first aggregates, filled
    with each reduction's identity (the count and presence planes decide
    which slots are real groups). Min/max keep ops/segment's fold state:
    the extremes and, for floats, the NaN flag of Spark's NaN order."""
    carry = {}
    for i, call in enumerate(calls):
        dt = val_dtypes[i]
        if call.fn in _MM_FNS:
            carry[f"mm{i}"], carry[f"nanflag{i}"] = seg.extreme_slots(
                R, dt, call.fn == "max", dev)
        elif call.fn in _FIRST_FNS:
            carry[f"fv{i}"] = torch.zeros((R,), dtype=dt, device=dev)
            carry[f"fok{i}"] = torch.zeros((R,), dtype=torch.bool, device=dev)
            if call.fn == "first":
                carry[f"fvalid{i}"] = torch.zeros((R,), dtype=torch.bool,
                                                  device=dev)
    return carry


def _update_carrier(carry: dict, i: int, call, vcol: Column,
                    inb: torch.Tensor, k: torch.Tensor, R: int) -> None:
    """Fold one batch into call i's carrier, in place: a scatter
    reduction of the batch's rows at their dense slots `k` (int64, in
    [0, R)). Rows outside `inb` carry the identity (min/max) or an
    out-of-range row index (first); min/max fold as ops/segment does."""
    v = vcol.data
    if call.fn in _MM_FNS:
        seg.fold_extreme(carry[f"mm{i}"], carry[f"nanflag{i}"], v,
                         inb & vcol.valid_mask(), k, call.fn == "max")
        return
    # first / first_ignores_null: the batch's first qualifying row per
    # slot, taken where no earlier batch had one
    n = v.shape[0]
    pres = inb if call.fn == "first" else inb & vcol.valid_mask()
    iota = torch.arange(n, dtype=torch.int64, device=v.device)
    idx = torch.full((R,), n, dtype=torch.int64, device=v.device)
    idx.scatter_reduce_(0, k, torch.where(pres, iota, n), "amin",
                        include_self=True)
    bhas = idx < n
    gi = idx.clamp(0, n - 1)
    prev = carry[f"fok{i}"]
    bval = torch.where(bhas, v[gi], torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
    carry[f"fv{i}"] = torch.where(prev, carry[f"fv{i}"], bval)
    if call.fn == "first":
        carry[f"fvalid{i}"] = torch.where(prev, carry[f"fvalid{i}"],
                                          vcol.valid_mask()[gi] & bhas)
    carry[f"fok{i}"] = prev | bhas


def _carrier_columns(carry: dict, i: int, call, has: torch.Tensor,
                     final: bool, cap: int) -> List[Column]:
    """Output columns of call i's carrier: the finalized value, or the
    partial's state columns (min/max: [val, has]; first: [val, valid,
    has]; first_ignores_null: [val, has])."""
    if call.fn in _MM_FNS:
        val = seg.extreme_result(carry[f"mm{i}"], carry[f"nanflag{i}"], has,
                                 call.fn == "max")
        if final:
            return [Column(call.dtype, _pad(val, cap), _pad(has, cap))]
        return [Column(call.dtype, _pad(val, cap), None),
                Column(T.BOOLEAN, _pad(has, cap), None)]
    fok = carry[f"fok{i}"]
    val = torch.where(fok, carry[f"fv{i}"],
                      torch.zeros_like(carry[f"fv{i}"]))
    if call.fn == "first":
        fvalid = carry[f"fvalid{i}"]
        if final:
            return [Column(call.dtype, _pad(val, cap),
                           _pad(fvalid & fok, cap))]
        return [Column(call.dtype, _pad(val, cap), None),
                Column(T.BOOLEAN, _pad(fvalid, cap), None),
                Column(T.BOOLEAN, _pad(fok, cap), None)]
    if final:
        return [Column(call.dtype, _pad(val, cap), _pad(fok, cap))]
    return [Column(call.dtype, _pad(val, cap), None),
            Column(T.BOOLEAN, _pad(fok, cap), None)]


def _run_dense(batches, steps, group_fns, calls, schema, is_final,
               input_fns, gdtypes, sum_is_float, has_validity, val_dtypes,
               spans, kmins, scales):
    """Pass 2: accumulate every batch into the digit-plane carry and the
    min/max/first carriers, then recombine once and assemble the output
    batch: finalized values when `is_final`, else the partial's state
    columns. Returns (batch, flags) with flags = [oob, num_rows] as one
    int32 tensor."""
    dev = batches[0].device
    R = 1
    for sp in spans:
        R *= sp
    strides, acc_s = [], 1
    for sp in reversed(spans):
        strides.append(acc_s)
        acc_s *= sp
    strides = list(reversed(strides))

    costs = _spec_costs(calls, sum_is_float, has_validity)
    groups = _launch_groups(costs)

    # map the probed per-CALL fixed scales onto SPEC indices (the spec
    # list below is: presence, then per call [count?][sum?])
    call_scale = dict(scales)
    spec_fixed_scales = {}
    spec_idx = 1
    for i, call in enumerate(calls):
        if has_validity[i]:
            spec_idx += 1
        if call.fn in ("sum", "avg"):
            if sum_is_float[i] and i in call_scale:
                spec_fixed_scales[spec_idx] = call_scale[i]
            spec_idx += 1
    # ... and onto each launch group's own spec indices
    group_scales = [{j: spec_fixed_scales[si] for j, si in enumerate(g)
                     if si in spec_fixed_scales} for g in groups]

    # int32 twins of the key minima for the packed-index arithmetic
    # (wrapping is benign: out-of-range rows are masked by `inb`)
    kmins32 = [int(np.int64(m).astype(np.int32)) for m in kmins]
    gh = (R + mxu_agg._GL - 1) // mxu_agg._GL
    accs = [torch.zeros((gh, sum(costs[si][0] for si in g), mxu_agg._GL),
                        dtype=torch.int64, device=dev) for g in groups]
    layouts = [None] * len(groups)
    oob = torch.zeros((), dtype=torch.bool, device=dev)
    carry = _init_carriers(calls, val_dtypes, R, dev)
    slots = None
    for b in batches:
        b, live = _apply_steps(steps, b)
        # composite keys pack into one dense index. Bounds are checked
        # exactly in int64; the packed index itself is int32: in-range
        # offsets (< span <= R <= 2^16) are int32-exact
        packed = torch.zeros((b.capacity,), dtype=torch.int32, device=dev)
        inb = live
        keys_valid = live
        null_key = torch.zeros((), dtype=torch.bool, device=dev)
        for i, gfn in enumerate(group_fns):
            g = gfn(b)
            gv = g.valid_mask()
            keys_valid = keys_valid & gv
            null_key = null_key | (live & ~gv).any()
            off64 = g.data.to(torch.int64) - kmins[i]
            inb = inb & gv & (off64 >= 0) & (off64 < spans[i])
            off32 = g.data.to(torch.int32) - kmins32[i]
            packed = packed + off32.clamp(0, spans[i] - 1) * strides[i]
        oob = oob | null_key | (keys_valid & ~inb).any()
        k = packed.clamp(0, R - 1).to(torch.int64) if carry else None
        # every aggregate plane rides one accumulate per launch group;
        # non-nullable inputs reuse the presence plane for their counts
        specs = [("count", torch.ones_like(inb))]
        slots = []  # per call: (sum_spec_idx|None, cnt_spec_idx|None)
        for i, call in enumerate(calls):
            vcol = input_fns[i](b)
            if vcol.validity is None:
                ci = None
            else:
                specs.append(("count", vcol.validity))
                ci = len(specs) - 1
            si = None
            if call.fn in ("sum", "avg"):
                data = vcol.data.to(torch.float64 if sum_is_float[i]
                                    else torch.int64)
                vv = (torch.ones_like(inb) if vcol.validity is None
                      else vcol.validity)
                specs.append(("sum", data, vv))
                si = len(specs) - 1
            elif call.fn in _MM_FNS + _FIRST_FNS:
                _update_carrier(carry, i, call, vcol, inb, k, R)
            slots.append((si, ci))
        for gi, g in enumerate(groups):
            words, recipe, layouts[gi], _, bad_vals = mxu_agg.digitize(
                inb, [specs[si] for si in g], fixed_scales=group_scales[gi])
            # non-finite floats or fixed-scale overflow: flag and re-probe
            oob = oob | bad_vals
            # in place: the kernel adds the batch straight into the carry
            mxu_agg.accumulate_into(accs[gi], packed, inb, words, recipe, R)

    outs = [None] * len(costs)
    for g, acc, layout, gs in zip(groups, accs, layouts, group_scales):
        for si, o in zip(g, mxu_agg.finalize(acc, layout, R, scales=gs)):
            outs[si] = o
    pres = outs[0]
    cap = bucket_capacity(R)
    present = pres > 0
    slot = torch.arange(R, dtype=torch.int64, device=dev)
    cols = []
    for i, gdtype in enumerate(gdtypes):
        ki = torch.div(slot, strides[i], rounding_mode="floor") % spans[i] \
            + kmins[i]
        cols.append(Column(gdtype, _pad(ki.to(gdtype.torch_dtype()), cap),
                           None))
    for i, call in enumerate(calls):
        si, ci = slots[i]
        cnt = pres if ci is None else outs[ci]
        has = cnt > 0
        if call.fn == "count":
            # count's state IS its result (state_fields: [count])
            cols.append(Column(T.INT64, _pad(cnt, cap), None))
            continue
        if call.fn in _MM_FNS + _FIRST_FNS:
            cols.extend(_carrier_columns(carry, i, call, has, is_final,
                                         cap))
            continue
        if is_final:
            if call.fn == "avg":
                if call.dtype.kind == TypeKind.DECIMAL:
                    # decimal avg: unscaled floor-div at the result scale
                    q = torch.div(outs[si], cnt.clamp(min=1),
                                  rounding_mode="floor")
                    q = torch.where(has, q, torch.zeros_like(q))
                    cols.append(Column(call.dtype, _pad(q, cap),
                                       _pad(has, cap)))
                    continue
                v = outs[si].to(torch.float64) / \
                    cnt.clamp(min=1).to(torch.float64)
                cols.append(Column(T.FLOAT64,
                                   _pad(torch.where(has, v,
                                                    torch.zeros_like(v)), cap),
                                   _pad(has, cap)))
            else:  # sum
                cols.append(Column(result_field(call).dtype,
                                   _pad(outs[si], cap), _pad(has, cap)))
            continue
        # partial (shuffle map side): typed STATE columns in the agg-buf
        # layout the FINAL merge consumes by position (state_fields: sum ->
        # [sum, nonempty]; avg -> [sum, count])
        sd = state_fields(call, i)[0].dtype
        cols.append(Column(sd, _pad(outs[si].to(sd.torch_dtype()), cap),
                           None))
        if call.fn == "avg":
            cols.append(Column(T.INT64, _pad(cnt, cap), None))
        else:
            cols.append(Column(T.BOOLEAN, _pad(has, cap), None))
    out = ColumnBatch(schema, cols,
                      torch.tensor(R, dtype=torch.int32, device=dev), cap)
    out = out.compact(_pad(present, cap))
    flags = torch.stack([oob.to(torch.int32), out.num_rows])
    return out, flags
