"""Trainers: PQ, OPQ, ChainQ and LSQ."""

from local_search_quantization_torch.models.chainq import ChainQModel, train_chainq
from local_search_quantization_torch.models.lsq import LSQModel, train_lsq
from local_search_quantization_torch.models.opq import OPQModel, quantize_opq, train_opq
from local_search_quantization_torch.models.pq import PQModel, quantize_pq, train_pq

__all__ = ["ChainQModel", "LSQModel", "OPQModel", "PQModel", "quantize_opq",
           "quantize_pq", "train_chainq", "train_lsq", "train_opq", "train_pq"]
