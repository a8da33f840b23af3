"""Exact re-ranking ("refine") over ADC candidates (port of `refine.py`).

A serving index can keep a scalar-quantized copy of the original vectors and
re-rank the top ADC candidates by exact squared L2 to the stored rows. SQ8
stores per-dimension affine u8 codes (d bytes a vector); "f32" keeps the
vectors as they are. The store's data lives on one torch device, and
`rerank` decodes and measures there, batched over queries.

    rq = RefineStore.build(x_base, kind="sq8", device=dev)
    res = rerank(rq, Q, candidate_ids, k)   # exact top-k of the candidates

Artifacts (`to_arrays`/`from_arrays`) are those of the JAX package, so a
refine.npz written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops.adc import KNNResult
from local_search_quantization_torch.ops.select_kernels import lex_topk

__all__ = ["RefineStore", "rerank"]


def _sq8_codes(X: torch.Tensor, off: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    return torch.clamp(torch.round((X - off) * inv), 0, 255).to(torch.uint8)


@dataclasses.dataclass
class RefineStore:
    """Per-dimension affine-quantized (or raw f32) vector store."""

    kind: str  # "sq8" | "f32"
    data: torch.Tensor  # [n, d] uint8 (sq8) or f32
    off: torch.Tensor  # [d] f32 (zeros for f32)
    scale: torch.Tensor  # [d] f32 (ones for f32; dequant = off + u8 * scale)

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    @property
    def d(self) -> int:
        return int(self.data.shape[1])

    @classmethod
    def build(cls, X, kind: str = "sq8", device="cpu") -> "RefineStore":
        X = torch.as_tensor(np.asarray(X, np.float32) if not isinstance(
            X, torch.Tensor) else X).to(device, torch.float32)
        d = X.shape[1]
        if kind == "f32":
            return cls("f32", X.clone(), torch.zeros(d, device=device),
                       torch.ones(d, device=device))
        if kind != "sq8":
            raise ValueError(f"refine kind must be sq8 or f32, got {kind!r}")
        off = X.amin(dim=0)
        scale = (X.amax(dim=0) - off) / 255.0
        return cls("sq8", _sq8_codes(X, off, scale), off, scale)

    def append(self, X) -> None:
        """Quantize new rows with the FROZEN affine params (values outside the
        original span clip)."""
        X = torch.as_tensor(X).to(self.data.device, torch.float32)
        rows = X if self.kind == "f32" else _sq8_codes(X, self.off, self.scale)
        self.data = torch.cat([self.data, rows])

    def take(self, keep) -> None:
        """Row subset in place (compact); keep is a bool mask [n]."""
        self.data = self.data[torch.as_tensor(keep).to(self.data.device)].contiguous()

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """[..., d] f32 dequantized rows of ids [...]."""
        rows = self.data[ids]
        if self.kind == "f32":
            return rows
        return self.off + rows.float() * self.scale

    def to_arrays(self) -> dict:
        return {"refine_kind": np.bytes_(self.kind),
                "refine_data": self.data.cpu().numpy(),
                "refine_off": self.off.cpu().numpy(),
                "refine_scale": self.scale.cpu().numpy()}

    @classmethod
    def from_arrays(cls, a: dict, device="cpu") -> "RefineStore":
        def dev(x, dtype=None):
            return torch.as_tensor(np.array(x, dtype=dtype)).to(device)

        return cls(bytes(a["refine_kind"]).decode(), dev(a["refine_data"]),
                   dev(a["refine_off"], np.float32), dev(a["refine_scale"], np.float32))


def rerank(store: RefineStore, Q, cand_ids, k: int, *,
           query_chunk: int = 256) -> KNNResult:
    """Exact squared-L2 top-k among each query's candidate ids.

    cand_ids [nq, c] from an ADC stage; -1 entries (sentinel padding) are
    skipped. Output follows the scanners' contract: ascending (dist, id),
    (+inf, -1) past the live candidates; ids int64 on the store's device.
    Distances are TRUE squared L2, comparable across methods but not to the
    first-stage distances. Runs `query_chunk` queries at a time. Counts
    the queries and their candidate slots (`refine_queries`,
    `refine_candidates`) from the shapes, with no sync.
    """
    dev = store.data.device
    Q = torch.as_tensor(Q).to(dev, torch.float32)
    cand_ids = torch.as_tensor(cand_ids).to(dev, torch.int64)
    launch_counts.COUNTS["refine_queries"] += int(cand_ids.shape[0])
    launch_counts.COUNTS["refine_candidates"] += int(cand_ids.numel())
    out_d, out_i = [], []
    for s in range(0, Q.shape[0], query_chunk):
        cq = cand_ids[s:s + query_chunk]
        x = store.decode(cq.clamp(min=0))  # [b, c, d]
        dv = x - Q[s:s + query_chunk, None, :]
        dd, ii = lex_topk((dv * dv).sum(dim=-1), cq, k)  # a -1 id comes back (+inf, -1)
        out_d.append(dd)
        out_i.append(ii)
    if not out_d:
        return KNNResult(torch.empty((0, k), device=dev),
                         torch.empty((0, k), dtype=torch.int64, device=dev))
    return KNNResult(torch.cat(out_d), torch.cat(out_i))
