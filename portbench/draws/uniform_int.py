"""uniform_int: integers uniform on [low, high], both ends included.

    {"dist": "uniform_int", "low": 1, "high": 100}
"""

import torch


def draw(col: dict, n: int, generator: torch.Generator,
         device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.randint(int(col["low"]), int(col["high"]) + 1, (n,),
                         generator=generator, device=device, dtype=dtype)
