"""Plan contract: the JAX package's protobuf wire format + the port's decoder.

`plan_pb2.py` is a verbatim copy of blaze_tpu/plan/plan_pb2.py (generated
from `plan.proto`, proto package `blaze_tpu.plan`), so the same
`TaskDefinition` bytes decode in both packages; `from_proto.py` is the
decoder.
"""
