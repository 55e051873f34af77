"""Executor, whole-stage agg path, metrics and resources (port of blaze_tpu/runtime)."""
