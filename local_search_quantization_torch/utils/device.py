"""The device of an entry point (CUDA unless the caller asks for the CPU),
and host arrays encoded on it a chunk at a time."""

from __future__ import annotations

import numpy as np
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


def encode_in_chunks(fn, X, device, *, chunk: int = 1 << 17, host: bool = False):
    """fn over `chunk`-row pieces of the host array X, each moved to `device`
    as float32, concatenated: the codes on the device, or, with `host`, as a
    host int32 array (each piece copied back as it is done)."""
    pieces = (fn(torch.as_tensor(X[s:s + chunk]).to(device, torch.float32))
              for s in range(0, X.shape[0], chunk))
    if host:
        return np.concatenate([p.detach().cpu().numpy() for p in pieces]).astype(np.int32)
    return torch.cat(list(pieces))
