"""Asymmetric-distance (ADC) k-NN query for additive codes (port of `ops/adc.py`).

The per-query LUT build is one einsum; the scan and its exact
(dist, id)-lexicographic top-k run through K2 (`select_kernels.scan_topk`):
the CUDA kernels for CUDA tensors, the plain streaming merge for CPU tensors.
Ids are 0-based int32; a +inf slot carries id -1.

Not ported yet (ROADMAP.md): the PQ/OPQ LUTs, the tournament and native
routes, precision="bf16", and base segmentation above 1<<26 rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from local_search_quantization_torch.ops.select_kernels import (
    lut_scan_block,
    scan_topk,
    scan_topk_reference,
)

__all__ = ["KNNResult", "lsq_query_luts", "lut_scan_block", "linscan_lsq"]


class KNNResult(NamedTuple):
    dists: torch.Tensor  # [nq, k] ascending estimated (squared) distances
    ids: torch.Tensor  # [nq, k] int32, 0-based base indices


def lsq_query_luts(Q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """luts[q, i, c] = -2 * q . C[i, c]: Q [nq, d], C [m, h, d] -> [nq, m, h]."""
    return -2.0 * torch.einsum("qd,ihd->qih", Q, C)


def _scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
               k: int, block: int) -> KNNResult:
    """Streaming exact top-k of one query chunk over [m, n] codes: K2's plain
    version, exactly (dist, id)-lexicographic."""
    return KNNResult(*scan_topk_reference(luts, Bt, extra, k, block=block))


def _run_scan(luts_fn, Q: torch.Tensor, B, *, k: int, extra=None,
              query_chunk: int = 256, base_block: int = 1 << 16,
              topk_method: str = "auto") -> KNNResult:
    """Build the LUTs, lay the codes out as [m, n], scan, and select.

    topk_method: "auto" and "kernel" go to K2's wrapper on every device;
    "exact" is K2's plain streaming merge, run per `query_chunk` queries
    over `base_block`-row blocks. Codes travel as uint8 when h <= 256.
    """
    if topk_method not in ("auto", "kernel", "exact"):
        raise NotImplementedError(
            f"topk_method {topk_method!r} is not ported yet (ROADMAP.md)")
    dev = Q.device
    B = torch.as_tensor(B).to(dev)
    n = B.shape[0]
    luts = luts_fn(Q).contiguous()
    h = luts.shape[2]
    Bt = B.t().to(torch.uint8 if h <= 256 else torch.int32).contiguous()
    if extra is not None:
        extra = torch.as_tensor(extra).to(dev, torch.float32).contiguous()
    k = min(k, n)
    if topk_method == "exact":
        parts = [_scan_topk(luts[s:s + query_chunk], Bt, extra, k, base_block)
                 for s in range(0, luts.shape[0], query_chunk)]
        return KNNResult(torch.cat([p.dists for p in parts]),
                         torch.cat([p.ids for p in parts]))
    return KNNResult(*scan_topk(luts, Bt, extra, k))


def linscan_lsq(B, Q: torch.Tensor, C: torch.Tensor, db_norms, k: int = 10000,
                R: torch.Tensor | None = None, **kw) -> KNNResult:
    """ADC k-NN for additive codes with separately quantized norms.

    dist[q, n] = -2 sum_i q.C[i, B[n, i]] + ||recon_n||^2, a rank-preserving
    surrogate of the squared distance. db_norms: [n] float32.
    """
    Qr = Q @ R if R is not None else Q
    return _run_scan(lambda q: lsq_query_luts(q, C), Qr, B, k=k,
                     extra=db_norms, **kw)
