"""Device-mesh parallelism: the in-device-memory shuffle path.

Port of blaze_tpu/parallel. In place of the reference's shuffle transport
when all partitions of a stage live on the devices of one host: instead of
writing per-partition IPC files for Spark's netty to move (SURVEY.md
§2.6), the exchange is a block all_to_all over the host's devices that
never leaves device memory. Other exchanges still use the file/IPC
container (ops/shuffle.py).
"""

from blaze_tpu_torch.parallel.shuffle import (
    mesh_shuffle_batch,
    partition_ids,
    staged_all_to_all,
)

__all__ = ["mesh_shuffle_batch", "partition_ids", "staged_all_to_all"]
