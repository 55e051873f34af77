"""Where the port's tensors live.

Entry points run on the CUDA card unless the caller asks for the CPU. The
device is fixed where a batch is made (`ColumnBatch.from_numpy` and
friends); everything downstream follows its input tensors' device. With no
CUDA device and no explicit request for the CPU, construction raises — the
engine never carries on quietly on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "blaze_tpu_torch needs a CUDA device; pass device='cpu' to "
                "run on the host explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
