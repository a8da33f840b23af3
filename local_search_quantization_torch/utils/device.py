"""The device of an entry point: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def entry_device(device) -> torch.device:
    """The device of an entry point: CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for and there is no CUDA device, rather than
    running on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for but no CUDA device "
                           "is available; pass device='cpu' to run on the CPU")
    return device
