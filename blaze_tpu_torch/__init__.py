"""blaze-tpu on PyTorch and CUDA: the port of `blaze_tpu` to an NVIDIA H100.

The package mirrors `blaze_tpu`'s layout module for module, so each piece
has an obvious counterpart:

  - plan/       plan contract (same protobuf wire format) + decoder
  - exprs/      expression IR and its compiler to torch column functions
  - columnar/   batches of torch tensors with static (bucketed) capacities
  - ops/        physical operators; ops/mxu_agg.py holds the hand-written
                CUDA digit-plane accumulate (csrc/mxu_accumulate.cu)
  - runtime/    executor, whole-stage agg path, metrics, resources

Plain tensor code is eager PyTorch. Tensors live on the device their batch
was made on (`device.resolve_device`): CUDA by default, the CPU only when a
caller asks for it. Nothing here imports jax or anything of `blaze_tpu`.
"""

__version__ = "0.1.0"

from blaze_tpu_torch.config import BlazeConf, conf  # noqa: E402

__all__ = ["BlazeConf", "conf", "__version__"]
