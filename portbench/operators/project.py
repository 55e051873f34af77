"""project: named expressions over its input.

    {"op": "project", "exprs": [{"name": <name>, "expr": <expr>}, ...]}
"""

from blaze_tpu_torch.plan import plan_pb2 as pb


def build(step, inputs, ctx):
    node = pb.PlanNode()
    node.projection.input.CopyFrom(inputs[0])
    for item in step["exprs"]:
        node.projection.exprs.add().CopyFrom(ctx.expr(item["expr"]))
        node.projection.names.append(item["name"])
    return node
