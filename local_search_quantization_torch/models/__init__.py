"""Trainers: PQ, OPQ, ChainQ, LSQ, RVQ and sparse LSQ."""

from local_search_quantization_torch.models.chainq import ChainQModel, train_chainq
from local_search_quantization_torch.models.lsq import LSQModel, train_lsq
from local_search_quantization_torch.models.opq import OPQModel, quantize_opq, train_opq
from local_search_quantization_torch.models.pq import PQModel, quantize_pq, train_pq
from local_search_quantization_torch.models.rvq import RVQModel, quantize_rvq, train_rvq
from local_search_quantization_torch.models.slsq import SLSQModel, train_lsq_sparse

__all__ = ["ChainQModel", "LSQModel", "OPQModel", "PQModel", "RVQModel", "SLSQModel",
           "quantize_opq", "quantize_pq", "quantize_rvq", "train_chainq", "train_lsq",
           "train_lsq_sparse", "train_opq", "train_pq", "train_rvq"]
