"""Trainers. LSQ is the only one ported so far."""

from local_search_quantization_torch.models.lsq import LSQModel, train_lsq

__all__ = ["LSQModel", "train_lsq"]
