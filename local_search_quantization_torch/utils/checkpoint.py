"""Model checkpoints in the JAX package's `.npz` format (`utils/checkpoint.py`).

A file holds `__model__` (the class name) plus one array per field, so a
model saved by either package loads in the other. The registry is the
port's own: the JAX one imports the JAX models.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_FIELDS = ("B", "B_norms")


def _registry() -> dict[str, type]:
    from local_search_quantization_torch.models.lsq import LSQModel

    return {"LSQModel": LSQModel}


def lsq_model_to_numpy(model) -> dict[str, np.ndarray]:
    """LSQModel -> {field: ndarray} with the JAX package's dtypes
    (float32 arrays, int32 codes)."""
    out = {}
    for f in model._fields:
        v = getattr(model, f)
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f] = v.astype(np.int32 if f in _INT_FIELDS else np.float32)
    return out


def lsq_model_from_numpy(fields, device="cpu"):
    """{field: array} (e.g. a JAX LSQModel's fields) -> the port's LSQModel,
    tensors on `device` (obj stays a float32 ndarray)."""
    from local_search_quantization_torch.models.lsq import LSQModel

    def conv(f):
        a = np.asarray(fields[f])
        if f == "obj":
            return a.astype(np.float32)
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        return torch.as_tensor(np.array(a)).to(device, dtype)

    return LSQModel(**{f: conv(f) for f in LSQModel._fields})


def save_model(path: str, model) -> None:
    """Save a model NamedTuple to an .npz file."""
    np.savez_compressed(path, __model__=type(model).__name__,
                        **lsq_model_to_numpy(model))


def load_model(path: str, device="cpu"):
    """Load a model saved by either package; tensors land on `device`."""
    with np.load(path, allow_pickle=False) as data:
        name = str(data["__model__"])
        if name not in _registry():
            raise ValueError(f"unknown or unported model type {name!r} in {path}")
        return lsq_model_from_numpy({f: data[f] for f in data.files}, device)
