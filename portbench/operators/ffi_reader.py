"""ffi_reader: the stage's leaf, the batches that Blaze's FFI export hands
a native task; here task partition p's batches of a table of the
configuration (its partition p modulo its partition count), resident on
the device.

    {"op": "ffi_reader", "table": "store_sales", "columns": [...]}
"""

from blaze_tpu_torch.plan import plan_pb2 as pb
from portbench.plan import dtype


def build(step, inputs, ctx):
    table = ctx.tables[step["table"]]
    node = pb.PlanNode()
    for name in step["columns"]:
        g = node.ffi_reader.schema.fields.add()
        g.name = name
        g.dtype.CopyFrom(dtype(table.types[name]))
        g.nullable = table.schema.field(name).nullable
    node.ffi_reader.export_iter_resource_id = ctx.resource(
        step["table"], step["columns"])
    return node
