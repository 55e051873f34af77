"""Plan contract: the JAX package's protobuf wire format + the port's decoder.

`plan_pb2.py` is a verbatim copy of blaze_tpu/plan/plan_pb2.py (generated
from `plan.proto`, proto package `blaze_tpu.plan`), so the same
`TaskDefinition` bytes decode in both packages; `from_proto.py` is the
decoder, `to_proto.py` the encoder, and `fingerprint.py` hashes a plan's
shape.
"""

from blaze_tpu_torch.plan.fingerprint import (
    fingerprint_operator,
    fingerprint_plan,
    fingerprint_query,
)
from blaze_tpu_torch.plan.from_proto import (
    decode_expr,
    decode_plan,
    decode_task_definition,
)

__all__ = [
    "decode_expr",
    "decode_plan",
    "decode_task_definition",
    "fingerprint_operator",
    "fingerprint_plan",
    "fingerprint_query",
]
