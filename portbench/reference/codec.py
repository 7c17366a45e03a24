"""A frozen copy of SyzgyDB's linear codec (quantization.go:5-36).

value in [-1, 1] -> code in [0, 2^bits - 1]:
    code  = floor((clamp(value, -1, 1) + 1) / 2 * maxint + 0.5)
    value = code / maxint * 2 - 1

Each step is its own correctly rounded float64 tensor operation, so the
codes are the same on any device.  Nothing here comes from the program.
"""

from __future__ import annotations

import torch

MAXINT = {4: 15, 8: 255, 16: 65535}


def quantize(values: torch.Tensor, bits: int) -> torch.Tensor:
    """float values (any float dtype) -> integer codes (int32)."""
    maxint = MAXINT[bits]
    x = values.to(torch.float64).clamp(-1.0, 1.0)
    x = (x + 1.0) / 2.0 * float(maxint)
    return torch.floor(x + 0.5).to(torch.int32)


def dequantize(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes -> float64 values."""
    return codes.to(torch.float64) / float(MAXINT[bits]) * 2.0 - 1.0
