"""Typed configuration for every trainer and pipeline.

The reference hard-codes hyperparameters inside each demo script
(demos/demo_lsq.jl:13-20,34-38); here a single set of
dataclasses carries them, with defaults matching the reference demos.

A copy of `local_search_quantization_tpu.utils.config` (that package imports
JAX on import), so configs mean the same thing in both packages.
"""

from __future__ import annotations

import dataclasses


def _check_mh(m: int, h: int) -> None:
    if m < 1:
        raise ValueError(f"need at least one codebook, got m={m}")
    if h < 2:
        raise ValueError(f"need at least two entries per codebook, got h={h}")


@dataclasses.dataclass(frozen=True)
class PQConfig:
    m: int = 8  # number of codebooks (demo_pq.jl:12)
    h: int = 256  # entries per codebook
    kmeans_maxiter: int = 100
    kmeans_tol: float = 1e-6
    seed: int = 0

    def __post_init__(self):
        _check_mh(self.m, self.h)

    @property
    def bits(self) -> int:
        return self.m * (self.h - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class OPQConfig(PQConfig):
    niter: int = 10  # rotation/assignment alternations (demo_opq.jl)
    init: str = "natural"  # "natural" (R = I) or "random"


@dataclasses.dataclass(frozen=True)
class ChainQConfig:
    # NOTE: no seed — the ChainQ trainer is fully deterministic (structured
    # solve + exact Viterbi; its only stochastic input is the OPQ/PQ
    # initialization, which carries its own seed).
    m: int = 7
    h: int = 256
    niter: int = 10
    ridge: float = 1e-4

    def __post_init__(self):
        _check_mh(self.m, self.h)
        if self.m < 2:
            raise ValueError("ChainQ needs at least two codebooks")


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    """Residual VQ (beyond the reference): m sequential k-means stages."""
    m: int = 7
    h: int = 256
    kmeans_maxiter: int = 25
    seed: int = 0

    def __post_init__(self):
        _check_mh(self.m, self.h)


@dataclasses.dataclass(frozen=True)
class LSQConfig:
    m: int = 7  # codebooks (one byte reserved for the norm; demo_lsq.jl:14)
    h: int = 256
    niter: int = 10  # EM iterations
    ilsiter: int = 8  # ILS rounds per encoding call (demo_lsq.jl:34)
    icmiter: int = 4  # ICM sweeps per ILS round
    npert: int = 4  # codes perturbed per vector per ILS round
    randord: bool = True
    ilsiter_base: int = 16  # ILS rounds when encoding the base set ("LSQ-16")
    codebook_method: str = "cholesky"  # or "lsqr" for reference parity
    ridge: float = 1e-4
    lsqr_niter: int = 32
    # ICM conditioning backend: "auto" = "kernel", the whole-ILS kernel
    # (CUDA on a GPU, its plain PyTorch version on the CPU); "fused" = the
    # per-round ICM sweeps kernel; "gather" / "matmul" = tensor paths.
    condition_mode: str = "auto"
    # Stochastic relaxation (beyond the reference; LSQ++, Martinez et al.
    # ECCV 2018, arXiv:1806.05643): "SR-D" perturbs the data targets of the
    # codebook update, "SR-C" perturbs the updated codebooks, both with
    # residual-scaled noise annealed linearly to zero — escapes the local
    # minima plain LSQ's EM converges to. "none" = reference behavior.
    sr_method: str = "none"
    sr_scale: float = 1.0  # multiplier on the SR noise std (tuning knob)
    seed: int = 0

    def __post_init__(self):
        _check_mh(self.m, self.h)
        if not 0 <= self.npert <= self.m:
            raise ValueError(f"npert must be in [0, m], got {self.npert}")
        if self.sr_method not in ("none", "SR-D", "SR-C"):
            raise ValueError(
                f"sr_method must be none/SR-D/SR-C, got {self.sr_method!r}"
            )
        if not self.sr_scale > 0:
            raise ValueError(f"sr_scale must be > 0, got {self.sr_scale}")


@dataclasses.dataclass(frozen=True)
class SLSQConfig(LSQConfig):
    # Sparse-LSQ: L1-constrained codebook update (reference uses SPGL1 via
    # MATLAB, demos/demo_lsq_sparse.jl:26-46; we use a projected prox solver).
    S: int = 0  # keep top-S entries (0 = d*h, set by trainer)
    tau_scale: float = 0.7  # tau = tau_scale * ||C_init||_1
    prox_iters: int = 100
    prox_lr: float | None = None  # None = 1/L with L estimated from counts
