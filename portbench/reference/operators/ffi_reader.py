"""ffi_reader: the task partition's columns of the table, as the program
is handed them."""

from portbench.reference.numpy_ref import relation


def evaluate(step, inputs, ctx):
    return relation(ctx.columns(step["table"], step["columns"]))
