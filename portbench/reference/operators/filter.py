"""filter: the rows for which every predicate is valid and true."""

import numpy as np

from portbench.reference.numpy_ref import Relation


def evaluate(step, inputs, ctx):
    rel = inputs[0]
    keep = np.ones(rel.n, bool)
    for p in step["predicates"]:
        v, valid = ctx.expr(p, rel)
        keep &= np.broadcast_to(v & valid, (rel.n,))
    return Relation({k: (v[keep], ok[keep])
                     for k, (v, ok) in rel.cols.items()},
                    int(keep.sum()), list(rel.keys), set(rel.rel))
