"""A traffic mix's plan as `TaskDefinition` protobuf bytes.

The traffic file gives the stage's plan as data: `"plan"` is a list of
steps, each `{"op": <op>, ...}`, every step taking the one before it as
its input, as Blaze's Spark extension hands a native task

    ffi_reader -> Filter -> Project -> Agg PARTIAL -> Agg FINAL

Each op is built by operators/<op>.py (`build(step, inputs, ctx)`), found
by name; a step with more inputs (a join, a union) holds its others as
lists of steps of their own, which it builds with `ctx.pipeline`. The
plain reference (reference/) reads the same steps.

Expressions are JSON too, the same on both sides:

    {"col": name}                       a column of the step's input
    {"lit": value, "type": t}           a literal of type t
    {"cast": t, "arg": e}               e cast to type t
    {"binary": name, "left": e, "right": e}
                                        a binary operation: name is the
                                        proto's BinaryOp without `OP_`,
                                        lower-cased (add, mul, le, and, ...)
    {"fn": name, ...}                   any other kind: exprs/<name>.py,
                                        `build(e, ctx)`

Types are the proto's TypeKind names without `TK_`, lower-cased (int32,
float64, bool, ...).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from blaze_tpu_torch.plan import plan_pb2 as pb
from portbench import spec

def dtype(name: str) -> pb.DataType:
    t = pb.DataType()
    t.kind = getattr(pb, "TK_" + name.upper())
    return t


class PlanContext:
    """What a step's `build` may use: the tables, the leaves' resources
    and the expression and pipeline builders. `resource(table, columns)`
    registers, once, a provider of a task partition's resident batches of
    those columns, and returns its id."""

    def __init__(self, tables: Dict[str, object],
                 register: Callable[[str, Callable], str]) -> None:
        self.tables = tables
        self._register = register
        self._resources: Dict[tuple, str] = {}

    def resource(self, table: str, columns: List[str]) -> str:
        key = (table, tuple(columns))
        if key not in self._resources:
            t = self.tables[table]
            cols = list(columns)
            self._resources[key] = self._register(
                f"{table}:{','.join(cols)}",
                lambda partition, num_partitions: iter(
                    t.batches_of(partition % t.partitions, cols)))
        return self._resources[key]

    def pipeline(self, steps: List[dict]) -> pb.PlanNode:
        root = None
        for step in steps:
            op = spec.part("operators", step["op"])
            root = op.build(step, [] if root is None else [root], self)
        return root

    def expr(self, e: dict) -> pb.ExprNode:
        node = pb.ExprNode()
        if "col" in e:
            node.column.name = e["col"]
        elif "lit" in e:
            node.literal.dtype.CopyFrom(dtype(e["type"]))
            if e["type"].startswith("float"):
                node.literal.float_value = float(e["lit"])
            else:
                node.literal.int_value = int(e["lit"])
        elif "cast" in e:
            node.cast.child.CopyFrom(self.expr(e["arg"]))
            node.cast.dtype.CopyFrom(dtype(e["cast"]))
        elif "binary" in e:
            node.binary.op = getattr(pb, "OP_" + e["binary"].upper())
            node.binary.left.CopyFrom(self.expr(e["left"]))
            node.binary.right.CopyFrom(self.expr(e["right"]))
        elif "fn" in e:
            node.CopyFrom(spec.part("exprs", e["fn"]).build(e, self))
        else:
            raise ValueError(f"not an expression: {e!r}")
        return node


def task_bytes(root: pb.PlanNode, name: str, partition: int) -> bytes:
    """TaskDefinition bytes of one task of the plan `root`."""
    td = pb.TaskDefinition()
    td.task_id = f"{name}-{partition}"
    td.partition_id = partition
    td.plan.CopyFrom(root)
    return td.SerializeToString()
