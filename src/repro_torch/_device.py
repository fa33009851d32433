"""Device and dtype handling at the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that is an error, never a
    silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and repro_torch runs on the "
                "card by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(a, device: torch.device, dtype=torch.float64) -> torch.Tensor:
    """numpy array, sequence or tensor -> tensor of ``dtype`` on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
