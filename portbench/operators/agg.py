"""agg: a grouped aggregation, as Spark plans it: one Agg node a mode, in
order, each over the one before.

    {"op": "agg", "modes": ["partial", "final"], "group_by": [<column>],
     "aggs": [{"fn": "sum", "arg": <expr> | null, "type": "float64",
               "name": <name>}, ...]}

`fn` is the proto's AggFunction without `AGG_`, lower-cased; a null `arg`
is the literal 1 (count(1)).
"""

from blaze_tpu_torch.plan import plan_pb2 as pb


def build(step, inputs, ctx):
    root = inputs[0]
    for mode in step["modes"]:
        node = pb.PlanNode()
        node.agg.input.CopyFrom(root)
        node.agg.mode = getattr(pb, "AGG_" + mode.upper())
        for key in step["group_by"]:
            node.agg.grouping.add().CopyFrom(ctx.expr({"col": key}))
            node.agg.grouping_names.append(key)
        for a in step["aggs"]:
            ae = node.agg.aggs.add()
            ae.fn = getattr(pb, "AGG_" + a["fn"].upper())
            arg = a["arg"] if a["arg"] is not None else {"lit": 1,
                                                         "type": "int32"}
            ae.args.add().CopyFrom(ctx.expr(arg))
            ae.result_type.kind = getattr(pb, "TK_" + a["type"].upper())
            ae.name = a["name"]
        root = node
    return root
