"""Model checkpoints in the JAX package's `.npz` format (`utils/checkpoint.py`).

A file holds `__model__` (the class name) plus one array per field, so a
model saved by either package loads in the other. The registry is the
port's own: the JAX one imports the JAX models.
"""

from __future__ import annotations

import numpy as np
import torch

from local_search_quantization_torch.utils.device import entry_device

_INT_FIELDS = ("B", "B_norms")
# Fields kept as float32 ndarrays on the host (objective traces).
_HOST_FIELDS = ("obj",)


def _registry() -> dict[str, type]:
    from local_search_quantization_torch.models import (
        ChainQModel,
        LSQModel,
        OPQModel,
        PQModel,
    )

    return {cls.__name__: cls for cls in (PQModel, OPQModel, ChainQModel, LSQModel)}


def model_to_numpy(model) -> dict[str, np.ndarray]:
    """A model NamedTuple -> {field: ndarray} with the JAX package's dtypes
    (float32 arrays, int32 codes)."""
    out = {}
    for f in model._fields:
        v = getattr(model, f)
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f] = v.astype(np.int32 if f in _INT_FIELDS else np.float32)
    return out


def model_from_numpy(name: str, fields, device="cpu"):
    """{field: array} (e.g. a JAX model's fields) -> the port's model of
    class `name`, tensors on `device` (objective traces stay float32
    ndarrays)."""
    cls = _registry().get(name)
    if cls is None:
        raise ValueError(f"unknown or unported model type {name!r}")

    def conv(f):
        a = np.asarray(fields[f])
        if f in _HOST_FIELDS:
            return a.astype(np.float32)
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        return torch.as_tensor(np.array(a)).to(device, dtype)

    return cls(**{f: conv(f) for f in cls._fields})


def lsq_model_to_numpy(model) -> dict[str, np.ndarray]:
    """LSQModel -> {field: ndarray}; see model_to_numpy."""
    return model_to_numpy(model)


def lsq_model_from_numpy(fields, device="cpu"):
    """{field: array} -> the port's LSQModel; see model_from_numpy."""
    return model_from_numpy("LSQModel", fields, device)


def save_model(path: str, model) -> None:
    """Save a model NamedTuple to an .npz file."""
    np.savez_compressed(path, __model__=type(model).__name__, **model_to_numpy(model))


def load_model(path: str, device="cuda"):
    """Load a model saved by either package; tensors land on `device` (the
    GPU unless device="cpu"; raises without a GPU otherwise)."""
    with np.load(path, allow_pickle=False) as data:
        name = str(data["__model__"])
        if name not in _registry():
            raise ValueError(f"unknown or unported model type {name!r} in {path}")
        return model_from_numpy(name, {f: data[f] for f in data.files},
                                entry_device(device))


def save_codes(path: str, B, extra: dict | None = None) -> None:
    """Save base-set codes (+ norm codes, tombstones etc.) as numpy arrays."""
    np.savez_compressed(path, B=np.asarray(B), **(extra or {}))


def load_codes(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return dict(data)
