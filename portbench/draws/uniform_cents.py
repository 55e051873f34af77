"""uniform_cents: round(U * (high - low), 2) + low, as the TPC-DS
generator's prices: a float64 on a grid of cents.

    {"dist": "uniform_cents", "low": 0.0, "high": 200.0}
"""

import torch


def draw(col: dict, n: int, generator: torch.Generator,
         device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    u = torch.rand((n,), generator=generator, device=device,
                   dtype=torch.float64)
    span = float(col["high"]) - float(col["low"])
    return (torch.round(u * (span * 100.0)) / 100.0
            + float(col["low"])).to(dtype)
