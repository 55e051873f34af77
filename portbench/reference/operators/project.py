"""project: named expressions over the rows. A column passed through
keeps its place among the keys and the order-dependent columns."""

import numpy as np

from portbench.reference.numpy_ref import Relation


def evaluate(step, inputs, ctx):
    rel = inputs[0]
    out = Relation({}, rel.n)
    for item in step["exprs"]:
        e, name = item["expr"], item["name"]
        v, valid = ctx.expr(e, rel)
        out.cols[name] = (np.broadcast_to(v, (rel.n,)),
                          np.broadcast_to(valid, (rel.n,)))
        if "col" in e:
            if e["col"] in rel.keys:
                out.keys.append(name)
            if e["col"] in rel.rel:
                out.rel.add(name)
    return out
