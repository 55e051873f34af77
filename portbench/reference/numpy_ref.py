"""The plain reference: a traffic mix's plan worked out again in NumPy, and
the comparison that decides `correct`.

It imports nothing of the program (no torch, no `blaze_tpu_torch`, no
JAX). It reads the traffic mix's own steps (the same JSON that the harness
turns into the task's plan) and the generated input columns, as host
arrays, and works the answer out with Spark SQL's semantics: a comparison
with a null is not true, so a filter drops the row; an expression over a
null is null (AND and OR are three-valued); null keys form one group;
sum, avg, min and max skip nulls and are null over a group with no value;
count(1) counts rows.

Each step is worked out by reference/operators/<op>.py
(`evaluate(step, inputs, ctx) -> Relation`), an expression `{"fn": name}`
by reference/exprs/<name>.py (`evaluate(e, rel, ctx)`), both found by
name. The expression language is plan.py's.

`Context(columns, precision="float32")` is the control: the same
reference with every floating-point value, product and sum in float32, the
precision below the float64 that the configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from portbench import spec

# name -> (values, valid); valid is a bool array, or None for no nulls
Columns = Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]

_COMPARE = {"le": np.less_equal, "lt": np.less, "ge": np.greater_equal,
            "gt": np.greater, "eq": np.equal, "neq": np.not_equal}
_ARITH = {"mul": np.multiply, "add": np.add, "sub": np.subtract}
_TYPES = {"bool": np.bool_, "int8": np.int8, "int16": np.int16,
          "int32": np.int32, "int64": np.int64}


@dataclass
class Relation:
    """A step's rows: `cols` name -> (values, valid), each valid a bool
    array. `keys` are the columns that identify a row (an aggregate's
    grouping keys); with none, rows are compared in order. `rel` are the
    columns whose values depend on the order of a floating-point sum, and
    are compared by their relative gap; all others exactly."""
    cols: Dict[str, Tuple[np.ndarray, np.ndarray]]
    n: int
    keys: List[str] = field(default_factory=list)
    rel: Set[str] = field(default_factory=set)


def relation(cols: Columns) -> Relation:
    n = len(next(iter(cols.values()))[0]) if cols else 0
    return Relation({k: (v, np.ones(n, bool) if ok is None else ok)
                     for k, (v, ok) in cols.items()}, n)


class Context:
    """What a step's `evaluate` may use. `columns(table, names)` gives the
    task partition's input columns on the host."""

    def __init__(self, columns: Callable[[str, List[str]], Columns],
                 precision: str = "float64") -> None:
        self.columns = columns
        self.ftype = np.dtype(precision).type

    def type(self, name: str):
        return self.ftype if name.startswith("float") else _TYPES[name]

    def pipeline(self, steps: List[dict]) -> Relation:
        rel = None
        for step in steps:
            op = spec.part("reference/operators", step["op"])
            rel = op.evaluate(step, [] if rel is None else [rel], self)
        return rel

    def expr(self, e: dict, rel: Relation) -> Tuple[np.ndarray, np.ndarray]:
        """(values, valid) of one expression over `rel`; a literal's are
        0-d and broadcast."""
        if "col" in e:
            v, valid = rel.cols[e["col"]]
            if v.dtype.kind == "f":
                v = v.astype(self.ftype)
            return v, valid
        if "lit" in e:
            return np.asarray(e["lit"], self.type(e["type"])), \
                np.ones((), bool)
        if "cast" in e:
            v, valid = self.expr(e["arg"], rel)
            return v.astype(self.type(e["cast"])), valid
        if "fn" in e:
            return spec.part("reference/exprs", e["fn"]).evaluate(e, rel,
                                                                  self)
        if "binary" in e:
            return self._binary(e, rel)
        raise ValueError(f"not an expression: {e!r}")

    def _binary(self, e: dict, rel: Relation):
        left, lv = self.expr(e["left"], rel)
        right, rv = self.expr(e["right"], rel)
        op = e["binary"]
        if op in ("and", "or"):
            # three-valued: false AND null is false, true OR null is true
            lt, rt = left & lv, right & rv
            lf, rf = ~left & lv, ~right & rv
            if op == "and":
                return lt & rt, (lv & rv) | lf | rf
            return lt | rt, (lv & rv) | lt | rt
        fn = _COMPARE.get(op) or _ARITH.get(op)
        if fn is None:
            raise ValueError(f"the reference has no binary op {op!r}; "
                             f"another kind is an {{'fn': ...}} expression")
        return fn(left, right), lv & rv


def evaluate(plan: List[dict], columns: Callable[[str, List[str]], Columns],
             precision: str = "float64") -> Relation:
    """The answer of the plan's steps over one task partition's input."""
    return Context(columns, precision).pipeline(plan)


# a single integer key whose values span at most this many slots is
# grouped by direct indexing; any other grouping sorts
DENSE_SLOTS = 1 << 26


def _dense_span(keys) -> tuple:
    """(lowest valid key, slots) where one integer key spans at most
    DENSE_SLOTS values, else None."""
    if len(keys) != 1 or keys[0][0].dtype.kind not in "iu":
        return None
    v, ok = keys[0]
    if not ok.any():
        return 0, 1
    live = v[ok]
    lo, hi = int(live.min()), int(live.max())
    return (lo, hi - lo + 2) if hi - lo + 2 <= DENSE_SLOTS else None


def group_ids(keys: List[Tuple[np.ndarray, np.ndarray]], n: int):
    """(group id of each of the n rows, group count, the first row of each
    group). Groups are numbered in key order, nulls first; no keys is one
    group."""
    if not keys:
        return np.zeros(n, np.int64), 1, np.zeros(1, np.int64)
    span = _dense_span(keys)
    if span is not None:
        lo, slots = span
        v, ok = keys[0]
        slot = np.where(ok, v.astype(np.int64) - lo + 1, 0)
        present = np.bincount(slot, minlength=slots) > 0
        rank = np.cumsum(present) - 1
        first = np.zeros(slots, np.int64)
        first[slot[::-1]] = np.arange(n)[::-1]  # the last write wins
        return rank[slot], int(present.sum()), first[present]
    sort_cols = []
    for v, valid in reversed(keys):
        sort_cols += [np.where(valid, v, 0), valid]
    order = np.lexsort(sort_cols)
    change = np.zeros(n, bool)
    change[:1] = True
    for v, valid in keys:
        sv, sok = np.where(valid, v, 0)[order], valid[order]
        change[1:] |= (sv[1:] != sv[:-1]) | (sok[1:] != sok[:-1])
    ids = np.empty(n, np.int64)
    ids[order] = np.cumsum(change) - 1
    return ids, int(change.sum()), order[change]


def _pairs(got: Columns, want: Relation):
    """(got's rows, want's rows, unmatched) pairing the two sides' rows:
    by their key columns where `want` has keys (a key on one side only, or
    twice on a side, is unmatched), else by position."""
    ng = len(next(iter(got.values()))[0]) if got else 0
    nw = want.n
    if not want.keys:
        m = min(ng, nw)
        return np.arange(m), np.arange(m), abs(ng - nw)
    # one joint order over both sides' keys: ids equal exactly where the
    # keys are equal (nulls equal to nulls)
    joint = []
    for k in want.keys:
        g, gok = got[k]
        w, wok = want.cols[k]
        joint.append((np.concatenate([g, w]), np.concatenate([gok, wok])))
    ids, groups, _ = group_ids(joint, ng + nw)
    gid, wid = ids[:ng], ids[ng:]
    gcount = np.bincount(gid, minlength=groups)
    wcount = np.bincount(wid, minlength=groups)
    unmatched = int(np.maximum(gcount - 1, 0).sum()
                    + np.maximum(wcount - 1, 0).sum()
                    + ((gcount > 0) != (wcount > 0)).sum())
    gpos = np.zeros(groups, np.int64)
    gpos[gid[::-1]] = np.arange(ng)[::-1]
    wpos = np.zeros(groups, np.int64)
    wpos[wid[::-1]] = np.arange(nw)[::-1]
    on_both = (gcount > 0) & (wcount > 0)
    return gpos[on_both], wpos[on_both], unmatched


def compare(got: Columns, want: Relation) -> Dict[str, float]:
    """The numbers that decide `correct` for one task's answer:

    mismatched   rows on one side only (or a key twice on a side), plus
                 paired rows whose nulls or exact columns differ (counts,
                 minima, maxima, keys, integers; limit 0: an exact
                 comparison); a column the answer lacks mismatches every
                 row;
    sum_rel_err  the largest relative gap of a column in `want.rel` (a
                 float sum or average) over the paired rows,
                 |got - want| / |want| (|got - want| where want is 0);
                 infinite if a value is not finite where the reference's
                 is.
    """
    if any(k not in got for k in want.cols):
        return {"mismatched": float(max(want.n, 1)),
                "sum_rel_err": float("inf")}
    gi, wi, unmatched = _pairs(got, want)
    bad = np.zeros(len(gi), bool)
    rel = 0.0
    for name, (wv, wok) in want.cols.items():
        gv, gok = got[name]
        gv, gok, wv, wok = gv[gi], gok[gi], wv[wi], wok[wi]
        bad |= gok != wok
        both = gok & wok
        if name not in want.rel:
            bad |= both & (gv != wv)
            continue
        a, b = gv[both].astype(np.float64), wv[both].astype(np.float64)
        if len(a):
            with np.errstate(invalid="ignore", divide="ignore"):
                gap = np.abs(a - b) / np.where(b != 0, np.abs(b), 1.0)
            gap = np.where(np.isfinite(gap), gap, np.inf)
            rel = max(rel, float(gap.max()))
    return {"mismatched": float(unmatched + int(bad.sum())),
            "sum_rel_err": rel}
