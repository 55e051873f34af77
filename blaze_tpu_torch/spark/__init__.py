"""Driver-side planner and local runner: Spark physical plan -> native
plan protobufs -> stages run in dependency order.

Port of blaze_tpu/spark/ (ref: the spark-extension JVM layer,
BlazeSparkSessionExtension/BlazeConvertStrategy/BlazeConverters): the
two-pass convertibility tagging and its inefficiency fixpoint
(`convert_strategy`), per-operator conversion with fallback by
construction (`converters`), stage splitting at exchanges (`stages`),
dynamic join selection between stages (`aqe`), the shuffle-manager
surface (`shuffle_manager`) and the local multi-stage runner
(`local_runner.run_plan`), with the TPC-DS and validator catalogues on
top. The Spark-facing entry decodes `executedPlan.toJSON()` (`plan_json`,
with the per-version `shims`, and `pyspark_ext` around a live session).
Subtrees that cannot convert run on the row interpreter (`fallback`) and
feed the native pipeline through the FFI bridge; registered Hive, Scala
and Python UDFs go through `hive_udf`, and a scalar function outside the
native registry is wrapped alone (`expr_subtree_fallback`).
"""

from blaze_tpu_torch.spark.plan_model import SparkPlan
from blaze_tpu_torch.spark.convert_strategy import (
    ConvertStrategy, apply_strategy,
)
from blaze_tpu_torch.spark.converters import convert_spark_plan

__all__ = ["SparkPlan", "apply_strategy", "ConvertStrategy",
           "convert_spark_plan"]
