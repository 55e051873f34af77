"""agg: the grouped aggregation worked out whole, whatever the program's
modes: sum, count, avg, min and max, with Spark's null rules. Its answer's
rows are identified by the grouping keys, and its float sums and averages
depend on the order of addition."""

import numpy as np

from portbench.reference.numpy_ref import Relation, group_ids


def evaluate(step, inputs, ctx):
    if step["modes"][-1] != "final":
        raise ValueError("the reference answers a whole aggregation: its "
                         "last mode must be final")
    rel = inputs[0]
    keys = [rel.cols[k] for k in step["group_by"]]
    ids, groups, first = group_ids(keys, rel.n)
    out = Relation({k: (v[first], ok[first])
                    for k, (v, ok) in zip(step["group_by"], keys)},
                   groups, list(step["group_by"]))
    every = np.ones(groups, bool)
    for a in step["aggs"]:
        fn, name = a["fn"], a["name"]
        if a["arg"] is None:
            if fn != "count":
                raise ValueError(f"{fn} needs an argument")
            out.cols[name] = (np.bincount(ids, minlength=groups), every)
            continue
        v, ok = ctx.expr(a["arg"], rel)
        v, ok = np.broadcast_to(v, (rel.n,)), np.broadcast_to(ok, (rel.n,))
        cnt = np.bincount(ids[ok], minlength=groups)
        has = cnt > 0
        if fn == "count":
            out.cols[name] = (cnt, every)
        elif fn in ("sum", "avg"):
            acc = np.zeros(groups, v.dtype if v.dtype.kind == "f"
                           else np.int64)
            np.add.at(acc, ids[ok], v[ok])
            if fn == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    acc = (acc / cnt.astype(acc.dtype)).astype(ctx.ftype)
            out.cols[name] = (acc, has)
            if acc.dtype.kind == "f":
                out.rel.add(name)
        elif fn in ("min", "max"):
            if v.dtype.kind == "f":
                fill = np.inf if fn == "min" else -np.inf
            else:
                info = np.iinfo(v.dtype)
                fill = info.max if fn == "min" else info.min
            m = np.full(groups, fill, v.dtype)
            (np.minimum if fn == "min" else np.maximum).at(m, ids[ok],
                                                          v[ok])
            out.cols[name] = (m, has)
        else:
            raise ValueError(f"the reference has no aggregate {fn!r}")
    return out
