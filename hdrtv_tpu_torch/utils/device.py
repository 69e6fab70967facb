"""The device the port's library functions compute on when the caller names
none: the CUDA card, which must exist. The CPU runs them only when asked for
by name (``device="cpu"``), as the tests do."""

from __future__ import annotations

import torch


def compute_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card; without one, a RuntimeError
    (nothing falls back to the CPU unasked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("this computes on CUDA and no CUDA device is available; "
                               "pass device='cpu' to compute on the CPU")
        device = "cuda"
    return torch.device(device)
