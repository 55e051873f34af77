"""PySpark-facing entry: capture real executed plans and run them here.

Port of blaze_tpu/spark/pyspark_ext.py. The reference injects a Catalyst
rule in-process (BlazeSparkSessionExtension.scala:40-92). This engine
lives out of the JVM, so the integration captures the executed physical
plan's canonical TreeNode JSON and lowers it through plan_json -> the
converters -> local_runner, which runs it on the CUDA card.

pyspark is not a dependency of this engine: nothing here imports it, and
`pyspark_available` says whether the caller can pass a live session.
Usage with a live Spark session:

    from blaze_tpu_torch.spark.pyspark_ext import capture_plan_json, run_sql

    js, version = capture_plan_json(spark, "SELECT ...")  # Catalyst JSON
    plan = decode_plan_json(js, spark_version=version)    # shimmed decode
    batch = run_sql(spark, "SELECT ...")          # or: all in one step
"""

from __future__ import annotations

import importlib.util


def pyspark_available() -> bool:
    return importlib.util.find_spec("pyspark") is not None


def capture_plan_json(spark, sql: str) -> tuple:
    """(plan_json, spark_version) of `sql`'s executed physical plan: the
    artifacts plan_json.decode_plan_json consumes (the version selects the
    decode shim, spark/shims.py)."""
    df = spark.sql(sql)
    return (df._jdf.queryExecution().executedPlan().toJSON(),
            str(spark.version))


def run_sql(spark, sql: str, num_partitions: int = 4):
    """Plan on Spark, execute on this engine on the CUDA card; returns a
    ColumnBatch."""
    from blaze_tpu_torch.spark.local_runner import run_plan
    from blaze_tpu_torch.spark.plan_json import decode_plan_json

    js, version = capture_plan_json(spark, sql)
    plan = decode_plan_json(js, spark_version=version)
    return run_plan(plan, num_partitions=num_partitions, device=None)
