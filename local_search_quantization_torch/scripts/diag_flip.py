#!/usr/bin/env python
"""Diagnose an LSQ <-> OPQ recall@10 flip at reduced scale.

Twin of `scripts/diag_flip.py`, with its positional arguments
(`[ntrain nbase nquery niter]`) and `--device`. It runs the repro pipeline
small and separates three candidate causes:

1. encoding quality: per-vector base-cost distributions and the cost of
   each query's true nearest neighbour (the row whose rank sets recall);
2. the norm byte: recall of the exact ||recon||^2 against the 256-bin
   quantized norms, everything else the same;
3. corpus structure: whether the exact distance-to-reconstruction ranking
   (the best any ADC scan can do) already flips.

Training runs on the device (LSQ's encodes through K1 on the GPU); the
rankings are float64 numpy on the host, as in the JAX script.

    python -m local_search_quantization_torch.scripts.diag_flip 2000 20000 200 10
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch.models import (  # noqa: E402
    quantize_opq, train_chainq, train_lsq, train_opq,
)
from local_search_quantization_torch.ops import icm, norms  # noqa: E402
from local_search_quantization_torch.ops.costs import reconstruct  # noqa: E402
from local_search_quantization_torch.ops.subspaces import reconstruct_pq  # noqa: E402
from local_search_quantization_torch.utils.config import (  # noqa: E402
    ChainQConfig, LSQConfig, OPQConfig,
)
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402
from local_search_quantization_torch.utils.synth import (  # noqa: E402
    random_codes, synthetic_dataset,
)


def recall_at(gt, ids, milestones=(1, 10, 100)):
    hit = ids == np.asarray(gt)[:, None]
    any_hit = np.cumsum(hit, axis=1) > 0
    return {f"r@{n}": round(float(np.mean(any_hit[:, n - 1])), 4)
            for n in milestones if n <= ids.shape[1]}


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _ranked_recall(extra, recon64, q64, gt, label):
    """Rank by extra - 2 q.recon in float64 -> recall@{1,10,100}."""
    ids = np.empty((q64.shape[0], 100), np.int64)
    for s in range(0, q64.shape[0], 128):
        d2 = extra[None, :] - 2.0 * q64[s:s + 128] @ recon64.T
        ids[s:s + 128] = np.argsort(d2, axis=1)[:, :100]
    rec = recall_at(gt, ids)
    print(f"[diag] {label}: {rec}")
    return rec


def coststats(x, recon64, gt, label):
    c = ((x.astype(np.float64) - recon64) ** 2).sum(1)
    nn = c[gt]  # cost of each query's true NN
    print(f"[diag] {label} per-vec cost: mean={c.mean():.1f} "
          f"med={np.median(c):.1f} p90={np.percentile(c, 90):.1f} "
          f"p99={np.percentile(c, 99):.1f} | true-NN rows: "
          f"mean={nn.mean():.1f} med={np.median(nn):.1f} "
          f"p90={np.percentile(nn, 90):.1f}")


def main(argv=None) -> dict:
    """The diagnosis; returns {label: recall dict}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="ntrain nbase nquery niter (default 10000 100000 1000 30)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    a = ap.parse_args(argv)
    device = entry_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = list(a.sizes) + [10_000, 100_000, 1_000, 30][len(a.sizes):]
    ntrain, nbase, nquery, niter = sizes[:4]
    seed, h, d = 0, 256, 128
    milestones = (8,)

    print(f"[diag] corpus: train={ntrain} base={nbase} query={nquery} niter={niter}")
    dd = synthetic_dataset(seed, d=d, n_train=ntrain, n_base=nbase, n_query=nquery)
    xq64, gt = dd.query.astype(np.float64), dd.gt
    X = torch.as_tensor(dd.train, device=device)
    out = {}

    # === OPQ m=8 ===
    t = time.time()
    opq = train_opq(X, OPQConfig(m=8, h=h, niter=niter, seed=seed))
    Bb = quantize_opq(torch.as_tensor(dd.base, device=device), opq.R, opq.C_sub)
    recon_rot = _host64(reconstruct_pq(Bb, opq.C_sub, d))
    R64 = _host64(opq.R)
    print(f"[diag] OPQ trained ({time.time() - t:.0f}s) train_mse={float(opq.obj[-1]):.1f}")
    coststats(dd.base.astype(np.float64) @ R64, recon_rot, gt, "OPQ")
    q_rot = xq64 @ R64
    out["OPQ oracle"] = _ranked_recall((recon_rot ** 2).sum(1), recon_rot, q_rot, gt,
                                       "OPQ oracle (exact dist-to-recon)")

    # === LSQ m=7 + norms ===
    t = time.time()
    opq7 = train_opq(X, OPQConfig(m=7, h=h, niter=niter, seed=seed))
    chain = train_chainq(X, opq7.B, opq7.R, ChainQConfig(m=7, h=h, niter=niter))
    cfg = LSQConfig(m=7, h=h, niter=niter, seed=seed)
    lsq = train_lsq(X, chain.B, chain.R, cfg)
    enc = icm.encode_chunked(torch.Generator(device=device).manual_seed(seed + 1), dd.base,
                             random_codes(seed, nbase, 7, h), lsq.C,
                             ilsiter=milestones[-1], icmiter=cfg.icmiter, npert=cfg.npert,
                             randord=cfg.randord, milestones=milestones)
    B_lsq = enc.milestone_B[0]
    print(f"[diag] LSQ trained+encoded ({time.time() - t:.0f}s) train_mse="
          f"{float(lsq.obj[-1]):.1f} base_mse={float(torch.mean(enc.milestone_cost[0])):.1f}")
    recon_lsq = _host64(reconstruct(B_lsq, lsq.C))
    coststats(dd.base.astype(np.float64), recon_lsq, gt, "LSQ")

    # Three rankings, in order of information:
    sq_exact = (recon_lsq ** 2).sum(1)
    out["LSQ oracle"] = _ranked_recall(sq_exact, recon_lsq, xq64, gt,
                                       "LSQ oracle (exact dist-to-recon)")
    dbn = _host64(lsq.cbnorms)[norms.quantize_norms(B_lsq, lsq.C, lsq.cbnorms).cpu().numpy()]
    print(f"[diag] norm-byte quantization: rel-err mean="
          f"{np.abs(dbn - sq_exact).mean() / sq_exact.mean():.2e} "
          f"max={np.abs(dbn - sq_exact).max():.1f} "
          f"(sqnorm spread std={sq_exact.std():.1f})")
    out["LSQ ADC exact norms"] = _ranked_recall(sq_exact, recon_lsq, xq64, gt,
                                                "LSQ ADC exact norms")
    out["LSQ ADC quantized norms"] = _ranked_recall(dbn, recon_lsq, xq64, gt,
                                                    "LSQ ADC quantized norms (production)")
    return out


if __name__ == "__main__":
    main()
