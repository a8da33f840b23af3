"""The benchmark's corpus: SIFT-statistics vectors made on the device from a seed.

A torch rewrite of the port's `utils/synth.py` (corpus v5), with its
constants copied: cluster centres on a low-rank manifold with concentrated
norms, power-law cluster sizes, per-cluster principal directions
(`basis_mix` 0.4) with a decaying spectrum, sample norms concentrated to a
lognormal around 480, values rounded and clipped to 0..255 as SIFT's are;
queries are 90% planted near-duplicates of base vectors and 10% fresh draws.
The draws are torch's, from `torch.Generator`s on the device, so the arrays
differ from the numpy generator's; the statistics are the same. Gamma draws
of integer shape are sums of exponentials.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

CENTER_NORM, SAMPLE_NORM = 320.0, 480.0
SPREAD = 1.512
NORM_SIGMA = 0.10
BASIS_MIX = 0.4
QUERY_ALPHA = 0.8
PLANTED_FRAC = 0.9
CHUNK = 1 << 15


class Model(NamedTuple):
    centers: torch.Tensor  # [K, d] f32
    w: torch.Tensor  # [K, L] f32 per-cluster direction weights
    Vk: torch.Tensor  # [K, L, d] f32 per-cluster direction banks
    iid: torch.Tensor  # [K] f32 per-dimension noise floor
    cdf: torch.Tensor  # [K] f64 cluster-size CDF


def n_clusters(n_base: int) -> int:
    """~1 cluster per 256 base points, clamped to [64, 4096] (synth's rule)."""
    return int(min(4096, max(64, n_base // 256)))


def _envelope(d: int, device) -> torch.Tensor:
    """SIFT's Gaussian spatial weighting over its 4x4 cells (flat where d is
    not 8 times a square cell count)."""
    if d % 8 == 0:
        ncell = d // 8
        side = int(round(math.sqrt(ncell)))
        if side * side == ncell and side > 1:
            cell = torch.arange(ncell, dtype=torch.float64, device=device)
            r, c = torch.div(cell, side, rounding_mode="floor"), cell % side
            ctr = (side - 1) / 2.0
            w = torch.exp(-((r - ctr) ** 2 + (c - ctr) ** 2) / (2.0 * 1.55 ** 2))
            return w.repeat_interleave(8)
    return torch.ones(d, dtype=torch.float64, device=device)


def _normal(gen, shape, device, dtype=torch.float64):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _gamma_int(gen, shape_k: int, size, device):
    """Gamma(shape_k, 1) for a whole shape_k: a sum of exponentials."""
    u = torch.rand((shape_k, *size), generator=gen, device=device, dtype=torch.float64)
    return -torch.log1p(-u).sum(0)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-9)


def make_model(gen: torch.Generator, d: int, n_base: int, device) -> Model:
    """The cluster model of a corpus whose base has `n_base` rows."""
    K, L, rc = n_clusters(n_base), min(d, 64), min(d, 16)
    env = _envelope(d, device)
    mu = _gamma_int(gen, 2, (d,), device) * env
    mu = mu * (CENTER_NORM / torch.linalg.norm(mu))
    Wc = _unit_rows(_normal(gen, (rc, d), device) * env)
    lamc = torch.arange(1, rc + 1, dtype=torch.float64, device=device) ** -0.7
    uc = _normal(gen, (K, rc), device) * lamc
    uc = uc * (290.0 / torch.clamp(torch.linalg.norm(uc, dim=1), min=1e-9))[:, None]
    uc = uc * torch.abs(1.0 + 0.25 * _normal(gen, (K, 1), device))
    centers = torch.clamp(mu + uc @ Wc, min=0.0)
    target = torch.exp(math.log(CENTER_NORM) + 0.10 * _normal(gen, (K, 1), device))
    centers = _unit_rows(centers) * target
    V = _unit_rows(_normal(gen, (L, d), device) * env)
    lam = torch.arange(1, L + 1, dtype=torch.float64, device=device) ** -1.6
    w = _gamma_int(gen, 1, (K, L), device) * lam
    sigma = SPREAD * target[:, 0]
    w = w * (sigma / torch.clamp(torch.linalg.norm(w, dim=1), min=1e-9))[:, None]
    iid = 0.06 * sigma / math.sqrt(d)
    t = 0.5 * math.pi * BASIS_MIX
    Ek = _unit_rows(_normal(gen, (K, L, d), device, torch.float32) * env.float())
    Vk = _unit_rows(math.cos(t) * V.float()[None] + math.sin(t) * Ek)
    p = torch.arange(1, K + 1, dtype=torch.float64, device=device) ** -0.7
    cdf = torch.cumsum(p / p.sum(), 0)
    return Model(centers.float(), w.float(), Vk, iid.float(), cdf)


def _offsets(model: Model, gen, cids: torch.Tensor) -> torch.Tensor:
    """Per-row offsets from the row's cluster centre: its direction bank
    weighted by power-law weights, plus an iid floor."""
    n, (K, L, d) = cids.shape[0], model.Vk.shape
    out = torch.empty((n, d), dtype=torch.float32, device=cids.device)
    for s in range(0, n, CHUNK):
        c = cids[s:s + CHUNK]
        zw = _normal(gen, (c.shape[0], L), c.device, torch.float32) * model.w[c]
        off = torch.bmm(zw[:, None, :], model.Vk[c])[:, 0, :]
        out[s:s + CHUNK] = off + _normal(gen, (c.shape[0], d), c.device,
                                         torch.float32) * model.iid[c, None]
    return out


def _finish(x: torch.Tensor) -> torch.Tensor:
    """SIFT values are integers in 0..255."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def draw(model: Model, gen: torch.Generator, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n corpus vectors [n, d] f32 and their clusters [n] int64."""
    dev = model.centers.device
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    cids = torch.clamp(torch.searchsorted(model.cdf, u), max=model.cdf.shape[0] - 1)
    x = model.centers[cids] + _offsets(model, gen, cids)
    norm = torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-9)
    target = SAMPLE_NORM * torch.exp(NORM_SIGMA * _normal(gen, (n, 1), dev, torch.float32))
    return _finish(x * (target / norm)), cids


def queries(model: Model, gen: torch.Generator, base: torch.Tensor,
            base_cids: torch.Tensor, n_query: int) -> torch.Tensor:
    """[n_query, d] queries: planted near-duplicates of base rows (the
    matching descriptors of TEXMEX queries), the rest fresh draws, shuffled."""
    dev = base.device
    n_pl = int(round(PLANTED_FRAC * n_query))
    anchors = torch.randperm(base.shape[0], generator=gen, device=dev)[:n_pl]
    alpha = QUERY_ALPHA * torch.exp(0.35 * _normal(gen, (n_pl, 1), dev, torch.float32))
    planted = _finish(base[anchors] + _offsets(model, gen, base_cids[anchors]) * alpha)
    fresh, _ = draw(model, gen, n_query - n_pl)
    q = torch.cat([planted, fresh])
    return q[torch.randperm(n_query, generator=gen, device=dev)]
