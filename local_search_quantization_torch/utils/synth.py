"""Synthetic datasets and random code init.

A copy of `local_search_quantization_tpu.utils.synth` (that package imports
JAX on import); the same seed gives byte-identical arrays in both packages,
which the parity tests check.

`random_codes` mirrors the reference's `randinit`
(src/initializations.jl:2-8). `synthetic_dataset` provides a
SIFT-statistics corpus so every pipeline (and CI) runs end-to-end without
downloading TEXMEX data (src/read/read_datasets.jl:16-34
reads the real files; this is the offline stand-in).

Corpus model (v5 — all constants publishable, no data files. v5 adds
SAMPLE-norm concentration, norm_sigma=0.10: v4 concentrated only CLUSTER
CENTER norms, leaving sample-norm CV at 0.31 vs real SIFT's ~0.10, and the
resulting 1-byte norm-quantizer error inverted LSQ vs OPQ at r@10 at 1M
scale — measured +0.009 r@10 for LSQ-32 with exact f32 norms on the same
codes (scripts/diag_normbyte.py). With v5 the oracle sweep gives
LSQ+normbyte r@10 .889 > OPQ .841 > PQ .791 at unchanged hardness
(lsq_mse/sqnorm 0.083). v3 re-
calibrated the within-cluster spread 3x up, concentrated norms, and moved
planted queries out to alpha=0.8 after the v2 calibration proved too easy:
quantization noise was so far below NN margins that the 1-byte norm
quantization dominated LSQ's ranking and OPQ inverted the papers'
ordering. v4 adds per-cluster principal-direction variation
(basis_mix=0.4 default) and another 1.8x spread after the
scripts/calibrate_corpus.py sweep: at v3's shared direction bank a single
OPQ rotation decorrelated every cluster at once, which real descriptor
manifolds do not allow, and OPQ sat marginally above LSQ — inverting the
papers. At (mix=0.4, 1.8x) the oracle sweep gives LSQ > OPQ > PQ on every
metric including the 1-byte-norm handicap (r@1 .447/.421/.411, r@10
.873/.866/.823) and lsq_mse/sqnorm = 0.087, near real SIFT1M's ~0.15):

The round-1 corpus (isotropic Gaussian mixture, 128 tight clusters) made
exact-NN retrieval intrinsically hard — thousands of same-cluster points at
near-identical distances — compressing recall to ~4x below the papers'
SIFT1M curves. Real SIFT has three properties that v2 reproduces:

1. **Descriptor statistics**: 128 dims = 4x4 spatial cells x 8 orientation
   bins; border cells carry less gradient energy (Gaussian spatial
   weighting in the SIFT descriptor itself), values are nonnegative
   integers with heavy-tailed marginals (gamma-like), and L2 norms
   concentrate (normalize -> clip 0.2 -> renormalize to 512 in the
   original descriptor pipeline).
2. **Cluster structure**: heavy-tailed (power-law) cluster sizes and
   anisotropic within-cluster covariance with a decaying eigenspectrum
   (descriptor manifolds are locally low-dimensional), not isotropic
   blobs.
3. **Query character**: TEXMEX queries are descriptors of the *same
   physical scene points* as base vectors — most queries have a planted
   near-duplicate whose distance is well below the distractor floor.
   This, not cluster tightness, is what makes recall@10 land at
   moderate values for 64-bit codes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


# Bump together with any calibration change (and re-pin the golden recall
# gates in tests/test_golden_recall.py + the fingerprint in
# tests/test_synth_corpus.py): committed quality artifacts are only
# comparable within one corpus version.
CORPUS_VERSION = 5


def corpus_fingerprint() -> str:
    """Short sha256 of a tiny deterministic corpus draw.

    Guards silent corpus drift: any change to the generator's constants or
    sampling structure changes this value, so committed quality artifacts
    (stamped by scripts/repro_paper.py) can be checked against the CURRENT
    generator instead of trusting filenames. Values are rounded to 1e-3
    before hashing so BLAS-level rounding differences in the center
    matmuls don't flip the hash within a platform generation.
    """
    import hashlib

    dd = synthetic_dataset(0, d=128, n_train=64, n_base=512, n_query=8)
    h = hashlib.sha256()
    for a in (dd.train, dd.base, dd.query):
        h.update(np.round(np.asarray(a, np.float64), 3).tobytes())
    h.update(np.asarray(dd.gt, np.int64).tobytes())
    return f"v{CORPUS_VERSION}-{h.hexdigest()[:16]}"


def random_codes(rng, n: int, m: int, h: int) -> np.ndarray:
    """Uniform random codes, [n, m] int32, 0-based."""
    if isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(rng)
    return rng.integers(0, h, size=(n, m), dtype=np.int32)


class SynthData(NamedTuple):
    train: np.ndarray  # [n_train, d]
    base: np.ndarray  # [n_base, d]
    query: np.ndarray  # [n_query, d]
    gt: np.ndarray  # [n_query] true NN in base (0-based)


def _envelope(d: int) -> np.ndarray:
    """Per-dimension scale profile: SIFT's Gaussian spatial weighting over
    the cell grid (4x4 at d=128). Cells only exist when d is a multiple of
    8 with a square cell count; otherwise flat."""
    if d % 8 == 0:
        ncell = d // 8
        side = int(round(np.sqrt(ncell)))
        if side * side == ncell and side > 1:
            r, c = np.divmod(np.arange(ncell), side)
            ctr = (side - 1) / 2.0
            rad2 = (r - ctr) ** 2 + (c - ctr) ** 2
            cell_w = np.exp(-rad2 / (2.0 * 1.55**2))
            return np.repeat(cell_w, 8).astype(np.float64)
    return np.ones(d)


def synthetic_dataset(
    seed: int = 0,
    *,
    d: int = 32,
    n_train: int = 2000,
    n_base: int = 10000,
    n_query: int = 100,
    n_clusters: int | None = None,
    noise: float = 1.0,
    query_alpha: float = 0.8,
    planted_frac: float = 0.9,
    basis_mix: float = 0.4,
    norm_sigma: float | None = 0.10,
) -> SynthData:
    """SIFT-statistics corpus with exact ground truth.

    Args:
      n_clusters: cluster count; None auto-scales with the base size
        (~1 cluster per 256 base points, clamped to [64, 4096]).
      noise: multiplier on the within-cluster spread (1.0 = calibrated so
        64-bit recalls land in the SIFT1M papers' band).
      query_alpha: scale of the planted query-to-anchor offset relative to
        the anchor cluster's spread. Smaller = easier queries.
      planted_frac: fraction of queries generated as near-duplicates of a
        base vector (the TEXMEX matching-descriptor character); the rest
        are fresh corpus samples with no planted match.
      basis_mix: how cluster-SPECIFIC the within-cluster principal
        directions are, in [0, 1]. 0 = every cluster shares one global
        direction bank V (a single OPQ rotation can then decorrelate all
        clusters at once, which makes product quantizers anomalously
        strong — v2 behavior). 1 = fully per-cluster random banks. Real
        descriptor manifolds have locally varying principal directions,
        which is precisely what gives additive (LSQ/AQ) codes their edge
        over rotated product codes on SIFT1M. 0.4 is the calibrated
        default (mix=1.0 is too diverse: it hurts additive codes as much
        as rotated ones and re-inverts the ordering — see the v4 sweep).
      norm_sigma: lognormal sigma of SAMPLE L2 norms (v5). The SIFT
        pipeline L2-renormalizes every descriptor (normalize -> clip 0.2
        -> renormalize), so real SIFT1M norms concentrate tightly
        (CV ~ 0.1); v4 concentrated only the CLUSTER CENTER norms and let
        the 1.512x within-cluster spread leak into sample norms
        (measured CV 0.31, sqnorm CV 0.70). That radial spread is pure
        handicap for the additive methods' 1-byte norm quantizer (256
        k-means bins over a 12x p1..p99 sqnorm range -> p99 error 1.6e-2
        of sqnorm, comparable to 1M-scale NN margins: measured r@10
        -0.009 for LSQ-32, enough to invert the papers' LSQ > OPQ
        ordering at paper scale while exact-norm scans preserve it).
        Each sample is radially rescaled to a lognormal(log nbar,
        norm_sigma) target norm — directions (the tangential structure
        that separates the method families) are untouched. None = v4
        behavior (no sample-norm concentration).
    """
    rng = np.random.default_rng(seed)
    K = n_clusters or int(min(4096, max(64, n_base // 256)))
    L = int(min(d, 64))  # shared anisotropy basis size
    env = _envelope(d)

    # --- Cluster centers: a global mean profile plus LOW-RANK variation
    # (descriptor cluster centers themselves live on a low-dimensional
    # manifold — full-rank random centers would be unquantizably diverse,
    # which is exactly what made the v1 corpus recall-dead), clipped
    # nonneg and rescaled to concentrated SIFT-like norms (~320, ~18%
    # spread).
    # Two distinct norm calibrations, deliberately NOT derived from each
    # other: cluster-CENTER norms target ~320 (real SIFT's center-norm
    # band) while SAMPLE norms concentrate at ~480 in concentrate()
    # below (real SIFT's sample-norm band ~ sqrt(center^2 + offset
    # power) at the v4/v5 spread). Recalibrating either moment changes
    # the corpus: bump the version and re-pin the golden recall gates
    # (tests/test_golden_recall.py) together.
    center_norm, sample_norm = 320.0, 480.0
    rc = int(min(d, 16))  # center-manifold rank
    mu = rng.gamma(2.0, 1.0, size=(d,)) * env
    mu *= center_norm / np.linalg.norm(mu)
    Wc = rng.normal(size=(rc, d)) * env[None, :]
    Wc /= np.maximum(np.linalg.norm(Wc, axis=1, keepdims=True), 1e-9)
    lamc = (np.arange(1, rc + 1, dtype=np.float64)) ** -0.7
    uc = rng.normal(size=(K, rc)) * lamc[None, :]
    uc *= (290.0 / np.maximum(np.linalg.norm(uc, axis=1), 1e-9))[
        :, None
    ] * np.abs(rng.normal(1.0, 0.25, size=(K, 1)))
    centers = np.maximum(mu[None, :] + uc @ Wc, 0.0)
    cn = np.linalg.norm(centers, axis=1, keepdims=True)
    # Concentrated norms (v3: lognormal sigma 0.10, was 0.18): the SIFT
    # pipeline renormalizes + clips descriptors, so real norms cluster
    # tightly. This also calibrates the 1-byte norm-quantization handicap
    # of additive codes (PQ/OPQ LUTs carry EXACT subspace norms; only
    # LSQ pays the norm byte): at sigma 0.18 the sqnorm tail error was
    # comparable to NN margins and erased LSQ's r@1 edge, which real
    # SIFT1M results (with the same 1-byte norms) do not show.
    target = np.exp(rng.normal(np.log(center_norm), 0.10, size=(K, 1)))
    centers = centers / np.maximum(cn, 1e-9) * target

    # --- Shared direction bank with per-cluster power-law weights:
    # x = c + (z * w[cluster]) @ V + iid noise. Rows of V unit-norm, so
    # E||offset||^2 = sum_l w_l^2; w rows are normalized to each cluster's
    # spread budget sigma_k = noise * 1.512 * ||center_k|| (the v4
    # calibration constant — history in the sweep note below).
    V = rng.normal(size=(L, d)) * env[None, :]
    V /= np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-9)
    lam = (np.arange(1, L + 1, dtype=np.float64)) ** -1.6
    w = rng.gamma(1.0, 1.0, size=(K, L)) * lam[None, :]
    # v4 spread calibration: 1.512 (= 1.8x the v3 0.84 = 5.4x the v2
    # 0.28). At 0.28 the corpus was so easy to quantize (LSQ mse/sqnorm
    # ~ 0.5% vs real SIFT1M's ~15-20%) that method separation vanished
    # and a single rotation made product codes anomalously strong
    # (OPQ > LSQ, inverting the papers); at 0.84 OPQ still sat marginally
    # above LSQ. 1.512 with basis_mix=0.4 reproduces the papers' ordering
    # with margin AND a realistic quantization-noise ratio (mse/sqnorm
    # 0.087). Calibration sweep: scripts/calibrate_corpus.py.
    sigma = noise * 1.512 * target[:, 0]  # [K]
    w *= (sigma / np.maximum(np.linalg.norm(w, axis=1), 1e-9))[:, None]
    iid = 0.06 * sigma / np.sqrt(d)  # [K] per-dim iid floor

    # Per-cluster direction banks: V_k = cos(t)*V + sin(t)*E_k, rows
    # renormalized ([K, L, d] f32, ~128 MB at the 1M-base cluster count).
    Vk = None
    if basis_mix > 0.0:
        t = 0.5 * np.pi * float(basis_mix)
        Ek = rng.normal(size=(K, L, d)) * env[None, None, :]
        Ek /= np.maximum(np.linalg.norm(Ek, axis=2, keepdims=True), 1e-9)
        Vk = np.cos(t) * V[None, :, :] + np.sin(t) * Ek
        Vk /= np.maximum(np.linalg.norm(Vk, axis=2, keepdims=True), 1e-9)
        Vk = Vk.astype(np.float32)
        del Ek

    # --- Power-law cluster sizes (Zipf-ish, exponent 0.7).
    p = (np.arange(1, K + 1, dtype=np.float64)) ** -0.7
    p /= p.sum()

    def offsets(cids, scale=1.0, rng=rng):
        n = cids.shape[0]
        if n == 0:  # zero-size draws consume no rng state — safe short-cut
            return np.zeros((0, d), np.float32)
        z = rng.normal(size=(n, L))
        if Vk is None:
            off = (z * w[cids]) @ V
        else:
            # Group rows by cluster: one [n_k, L] @ [L, d] GEMM per
            # cluster (a per-row einsum against Vk[cids] would build an
            # [n, L, d] transient — 32 GB at 1M rows).
            zw = z * w[cids]
            off = np.empty((n, d))
            order = np.argsort(cids, kind="stable")
            sc = cids[order]
            starts = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
            bounds = np.r_[starts, n]
            for a, b in zip(bounds[:-1], bounds[1:]):
                idx = order[a:b]
                off[idx] = zw[idx] @ Vk[sc[a]]
        off += rng.normal(size=(n, d)) * iid[cids, None]
        return off * scale

    def finish(x):
        # SIFT values are nonnegative uint8-range integers.
        return np.clip(np.rint(x), 0.0, 255.0).astype(np.float32)

    def concentrate(x, rng):
        """v5: radially rescale each sample to a lognormal target norm
        (SIFT's own renormalization step; see the norm_sigma doc above).
        Directions are preserved exactly; only the radial coordinate —
        which real SIFT's pipeline pins and which only taxes the 1-byte
        norm quantizer — is concentrated. Planted queries are NOT
        re-concentrated (they are anchor + offset, and a query's own norm
        is a per-query constant in the ranking)."""
        if norm_sigma is None:
            return x
        nrm = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
        tgt = sample_norm * np.exp(
            rng.normal(0.0, norm_sigma, size=(x.shape[0], 1)))
        return x * (tgt / nrm)

    def draw(n, rng=rng):
        cids = rng.choice(K, size=n, p=p)
        x = centers[cids] + offsets(cids, rng=rng)
        return finish(concentrate(x, rng)), cids

    train, _ = draw(n_train)
    base, base_cids = draw(n_base)

    # --- Queries: planted near-duplicates of base vectors (matching
    # descriptors of the same scene point) + a fresh-sample remainder.
    n_pl = int(round(planted_frac * n_query))
    anchors = rng.choice(n_base, size=n_pl, replace=False)
    acids = base_cids[anchors]
    alpha = query_alpha * np.exp(rng.normal(0.0, 0.35, size=(n_pl, 1)))
    q_planted = finish(base[anchors] + offsets(acids, rng=rng) * alpha)
    q_fresh, _ = draw(n_query - n_pl)
    query = np.concatenate([q_planted, q_fresh]) if n_pl < n_query else q_planted
    # Shuffle so planted/fresh are interleaved (chunked eval sees a mix).
    perm = rng.permutation(n_query)
    query = query[perm]

    # Exact NN ground truth, query-chunked GEMM (one matvec per query is
    # BLAS-2 / memory-bound — ~40x slower at 1M x 10k scale).
    gt = np.empty(n_query, np.int64)
    b2 = (base.astype(np.float32) ** 2).sum(1)
    qc = 256
    for s in range(0, n_query, qc):
        d2 = b2[None, :] - 2.0 * query[s : s + qc] @ base.T
        gt[s : s + qc] = np.argmin(d2, axis=1)
    return SynthData(train, base, query, gt)
