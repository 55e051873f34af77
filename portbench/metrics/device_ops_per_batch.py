"""device_ops_per_batch: operations the device ran (kernels, copies and
sets, from the profiler's device timeline) per input batch of the tasks
completed in the traced window."""


def read(run):
    t = run.trace
    if t is None or run.batches == 0 or t.device_ops == 0:
        return None
    return t.device_ops / run.batches
