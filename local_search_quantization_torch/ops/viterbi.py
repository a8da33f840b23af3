"""Exact chain (Viterbi) encoding as batched min-plus dynamic programming
(port of `ops/viterbi.py`).

The forward pass walks the m-1 chain edges; each step is a min-plus
product of the [nc, h] carry with an [h, h] transition table over a block of
vectors. The backtrace gathers the stored argmins in reverse. Plain PyTorch:
the JAX package runs this in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import torch

from local_search_quantization_torch.ops.luts import get_chain_binaries, get_unaries


def _viterbi_block(X: torch.Tensor, C: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """Viterbi-encode one block: X [nc, d] -> codes [nc, m] int32.

    Each step forms total = carry[:, :, None] + bb_i (the [nc, h, h] cost of
    state k at node i-1 moving to j), takes the min over k (lowest k on
    ties), and adds node i's unary after the min (viterbi.py:30-32).
    """
    unaries = get_unaries(X, C)  # [nc, m, h]
    m = C.shape[0]
    carry = unaries[:, 0, :]
    argmins = []
    for i in range(m - 1):
        total = carry[:, :, None] + bb[i][None, :, :]  # [nc, h, h]
        best_k = torch.argmin(total, dim=1)  # [nc, h]
        carry = torch.gather(total, 1, best_k[:, None, :])[:, 0, :] + unaries[:, i + 1, :]
        argmins.append(best_k)
    code = torch.argmin(carry, dim=-1)  # [nc]
    codes = [code]
    for best_k in reversed(argmins):
        code = torch.gather(best_k, 1, code[:, None])[:, 0]
        codes.append(code)
    return torch.stack(codes[::-1], dim=1).to(torch.int32)


def viterbi_encode(X: torch.Tensor, C: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Exact chain decoding of X [n, d] against chain codebooks C [m, h, d]
    (codebook i interacts only with i-1 and i+1): [n, m] int32 codes, the
    per-vector minimizers of the chain objective, on C's device.

    `block` vectors at a time bound the [block, h, h] transient (256 MB f32
    at block=1024, h=256).
    """
    X = torch.as_tensor(X).to(C.device, torch.float32)
    bb = get_chain_binaries(C)  # [m-1, h, h]
    return torch.cat([_viterbi_block(X[s:s + block], C, bb)
                      for s in range(0, X.shape[0], block)])
