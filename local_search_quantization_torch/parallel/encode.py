"""Sharded LSQ training and encoding (port of `parallel/encode.py`).

Encoding is embarrassingly parallel over the database axis (codebooks
replicated, nothing shared inside ICM); the codebook update needs one sum of
the per-shard Gram and A^T X accumulators. The JAX package expresses both
with `shard_map` and `psum`; here each shard runs the single-device code on
its own device, and the sum runs over the shards in shard order on the
mesh's first device, so a result repeats bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from local_search_quantization_torch.ops.icm import ILSResult, encode_route, ils_encode
from local_search_quantization_torch.ops.solver import _ridge_solve, code_gram
from local_search_quantization_torch.parallel.mesh import DATA_AXIS, Mesh, _shards, replicated


def _shard_generators(mesh: Mesh, gen: torch.Generator) -> list[torch.Generator]:
    """One generator a shard, on its device: seeded from one draw of `gen`
    and the shard index (JAX's `fold_in(key, axis_index)`), so the shards'
    streams are decorrelated and a run repeats from `gen`'s state."""
    draw = int(torch.randint(0, 1 << 62, (1,), generator=gen, device=gen.device))
    return [torch.Generator(device=d).manual_seed(
                int(np.random.SeedSequence([draw, s]).generate_state(1, np.uint64)[0]))
            for s, d in enumerate(mesh.devices)]


def sharded_ils_encode(mesh: Mesh, gen: torch.Generator, X, B0, C: torch.Tensor, *,
                       ilsiter: int, icmiter: int, npert: int, randord: bool = True,
                       condition_mode: str = "auto", axis: str = DATA_AXIS) -> ILSResult:
    """ILS-encode a database sharded over the mesh's axis.

    X, B0: per-shard row blocks (`shard_batch`), C [m, h, d]. Each shard runs
    `ops.icm.ils_encode` on its device with its own generator
    (`_shard_generators`), so each shard draws its OWN visit orders: the
    reference's master picks one order a round for every worker
    (encode_icm.jl:151-175). Any visit order is a valid ICM sweep and the
    per-vector accept-if-better guarantee holds either way, but a sharded
    run is NOT bit-comparable to a single-device run from the same
    generator. condition_mode goes through `encode_route`: "auto" is K1 on
    a CUDA mesh and "gather" on a CPU one, "fused" is K5.

    Returns ILSResult whose B and cost are per-shard blocks, like X.
    """
    nshards = _shards(mesh, axis)
    if len(X) != nshards or len(B0) != nshards:
        raise ValueError(f"sharded_ils_encode: X and B0 need {nshards} shards, got "
                         f"{len(X)} and {len(B0)}")
    mode = encode_route(condition_mode, C.shape[0], C.shape[1], mesh.devices[0])
    Bs, costs = [], []
    for g, x, b, c in zip(_shard_generators(mesh, gen), X, B0, replicated(mesh, C)):
        res = ils_encode(g, x, b, c, ilsiter=ilsiter, icmiter=icmiter,
                         npert=npert, randord=randord, condition_mode=mode)
        Bs.append(res.B)
        costs.append(res.cost)
    return ILSResult(Bs, costs)


def sharded_update_codebooks(mesh: Mesh, X, B, h: int, *, ridge: float = 1e-4,
                             n_valid: int | None = None,
                             axis: str = DATA_AXIS) -> torch.Tensor:
    """Codebook least squares from per-shard Gram accumulators and one sum.

    Each shard builds its own G = A^T A and A^T X (`code_gram`); the sum runs
    over the shards in order on the mesh's first device, where the [mh, mh]
    Cholesky solve (`_ridge_solve`) runs once. Returns C [m, h, d] there.

    n_valid: the TRUE row count when the blocks carry `shard_batch`'s padding
    (the repeated last row, which would otherwise be counted twice). Rows at
    global index >= n_valid get code -1, whose one-hot is all zero, so they
    add nothing to G or A^T X.
    """
    nshards = _shards(mesh, axis)
    if len(X) != nshards or len(B) != nshards:
        raise ValueError(f"sharded_update_codebooks: X and B need {nshards} shards, "
                         f"got {len(X)} and {len(B)}")
    home = mesh.devices[0]
    m, d = B[0].shape[1], X[0].shape[1]
    G = AtX = None
    start = 0
    for x, b in zip(X, B):
        if n_valid is not None:
            row = torch.arange(b.shape[0], device=b.device) + start
            b = torch.where((row < n_valid)[:, None], b, -1)
        start += b.shape[0]
        g, a = code_gram(b, x, h)
        G = g.to(home) if G is None else G + g.to(home)
        AtX = a.to(home) if AtX is None else AtX + a.to(home)
    return _ridge_solve(G, AtX, ridge).reshape(m, h, d)


def make_lsq_train_step(mesh: Mesh, h: int, *, ilsiter: int, icmiter: int, npert: int,
                        randord: bool = True, ridge: float = 1e-4,
                        n_valid: int | None = None, axis: str = DATA_AXIS):
    """One sharded LSQ EM step: the codebook solve, then the ILS encode.

    Returns step(gen, X, B) -> (C, B_new, cost) with X, B, B_new and cost as
    per-shard blocks and C on the mesh's first device. Pass n_valid when the
    blocks carry `shard_batch` padding (see `sharded_update_codebooks`).
    """

    def step(gen: torch.Generator, X, B):
        C = sharded_update_codebooks(mesh, X, B, h, ridge=ridge, n_valid=n_valid,
                                     axis=axis)
        res = sharded_ils_encode(mesh, gen, X, B, C, ilsiter=ilsiter, icmiter=icmiter,
                                 npert=npert, randord=randord, axis=axis)
        return C, res.B, res.cost

    return step
