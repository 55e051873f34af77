"""filter: the rows of its input for which every predicate is true.

    {"op": "filter", "predicates": [<expr>, ...]}
"""

from blaze_tpu_torch.plan import plan_pb2 as pb


def build(step, inputs, ctx):
    node = pb.PlanNode()
    node.filter.input.CopyFrom(inputs[0])
    for p in step["predicates"]:
        node.filter.predicates.add().CopyFrom(ctx.expr(p))
    return node
