"""host_pulls_per_task: device-to-host copies on the profiler's device
timeline per task completed in the traced window. Each is a read that the
host waits for: the stage's flags and row counts, and the task's two pulls
of its result (its length, then its columns)."""


def read(run):
    t = run.trace
    if t is None or run.tasks == 0 or t.device_ops == 0:
        return None
    return t.dtoh / run.tasks
