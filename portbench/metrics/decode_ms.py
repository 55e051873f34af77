"""decode_ms: the mean host time of a task's plan decode
(`plan/from_proto.decode_task_definition` over its TaskDefinition bytes),
from the harness's own span around the call, over the traced window's
tasks."""


def read(run):
    if not run.decode_s:
        return None
    return 1e3 * sum(run.decode_s) / len(run.decode_s)
