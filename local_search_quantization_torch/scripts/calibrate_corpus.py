#!/usr/bin/env python
"""Sweep the synthetic corpus's knobs and report ORACLE recalls for PQ, OPQ
and LSQ.

Twin of `scripts/calibrate_corpus.py`, with its arguments and `--device`.
Oracle recall (exact float64 distance-to-reconstruction ranking) is the
ceiling of any ADC scan for a fixed encoding, and a cheap calibration
signal. LSQ starts from OPQ's codes (no ChainQ) to keep the sweep fast; its
training and base encodes run ILS in condition mode "auto" (K1 on the GPU).
The rankings themselves are float64 numpy on the host, as in the JAX script.

    python -m local_search_quantization_torch.scripts.calibrate_corpus 0.4 \
        --ntrain 2000 --nbase 20000 --nquery 200
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
    quantize_opq, quantize_pq, train_lsq, train_opq, train_pq,
)
from local_search_quantization_torch.ops import icm, norms  # noqa: E402
from local_search_quantization_torch.ops.costs import reconstruct  # noqa: E402
from local_search_quantization_torch.ops.subspaces import reconstruct_pq  # noqa: E402
from local_search_quantization_torch.utils.config import (  # noqa: E402
    LSQConfig, OPQConfig, PQConfig,
)
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402
from local_search_quantization_torch.utils.synth import (  # noqa: E402
    random_codes, synthetic_dataset,
)


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def recall_oracle(recon64, q64, gt, ns=(1, 10, 100)):
    """Recall of the exact float64 ranking ||recon||^2 - 2 q.recon."""
    r2 = (recon64 ** 2).sum(1)
    return _rank_recall(r2, recon64, q64, gt, ns)


def _rank_recall(extra, recon64, q64, gt, ns=(1, 10, 100)):
    hitrank = np.empty(q64.shape[0], np.int64)
    for s in range(0, q64.shape[0], 128):
        d2 = extra[None, :] - 2.0 * q64[s:s + 128] @ recon64.T
        hitrank[s:s + 128] = (d2 < d2[np.arange(d2.shape[0]), gt[s:s + 128]][:, None]).sum(1)
    return {f"r@{n}": round(float((hitrank < n).mean()), 3) for n in ns}


def one(mix, noise, alpha, ntrain, nbase, nquery, niter, *, device, seed=0, h=256,
        norm_sigma=0.10, d=128) -> dict:
    """One corpus setting: the oracle recalls of PQ, OPQ and LSQ (and LSQ
    with its norm byte), and the three train/base MSEs."""
    t0 = time.time()
    dd = synthetic_dataset(seed, d=d, n_train=ntrain, n_base=nbase, n_query=nquery,
                           noise=noise, query_alpha=alpha, basis_mix=mix,
                           norm_sigma=norm_sigma)
    q64 = dd.query.astype(np.float64)
    X = torch.as_tensor(dd.train, device=device)
    Xb = torch.as_tensor(dd.base, device=device)

    pq = train_pq(X, PQConfig(m=8, h=h, kmeans_maxiter=niter, seed=seed))
    Bb = quantize_pq(Xb, pq.C_sub)
    r_pq = recall_oracle(_host64(reconstruct_pq(Bb, pq.C_sub, d)), q64, dd.gt)

    opq = train_opq(X, OPQConfig(m=8, h=h, niter=niter, seed=seed))
    Bb = quantize_opq(Xb, opq.R, opq.C_sub)
    r_opq = recall_oracle(_host64(reconstruct_pq(Bb, opq.C_sub, d)),
                          q64 @ _host64(opq.R), dd.gt)

    opq7 = train_opq(X, OPQConfig(m=7, h=h, niter=niter, seed=seed))
    lsq = train_lsq(X, opq7.B, opq7.R, LSQConfig(m=7, h=h, niter=niter, seed=seed))
    enc = icm.encode_chunked(torch.Generator(device=device).manual_seed(seed + 1),
                             dd.base, random_codes(seed, nbase, 7, h), lsq.C, ilsiter=8,
                             icmiter=4, npert=4, milestones=(8,))
    recon_lsq = _host64(reconstruct(enc.milestone_B[0], lsq.C))
    r_lsq = recall_oracle(recon_lsq, q64, dd.gt)

    # The production ranking: quantized ||recon||^2 through the norm byte.
    sq = (recon_lsq ** 2).sum(1)
    cb = norms.scalar_kmeans(sq, 256)
    dbn = cb[np.searchsorted((cb[1:] + cb[:-1]) / 2.0, sq)]
    r_lsqn = _rank_recall(dbn, recon_lsq, q64, dd.gt)

    mse = dict(pq=float(pq.error), opq=float(opq.obj[-1]),
               lsq=float(torch.mean(enc.milestone_cost[0])))
    hard = mse["lsq"] / sq.mean()  # SIFT1M at 64 bits sits near ~0.2
    print(f"[cal] d={d} mix={mix} noise={noise} alpha={alpha} ns={norm_sigma} "
          f"({time.time() - t0:.0f}s)\n"
          f"      mse: PQ={mse['pq']:.0f} OPQ={mse['opq']:.0f} "
          f"LSQ={mse['lsq']:.0f} lsq_mse/sqnorm={hard:.3f}\n"
          f"      PQ  {r_pq}\n      OPQ {r_opq}\n      LSQ {r_lsq}\n"
          f"      LSQ+normbyte {r_lsqn}", flush=True)
    return {"mix": mix, "mse": mse, "PQ": r_pq, "OPQ": r_opq, "LSQ": r_lsq,
            "LSQ+normbyte": r_lsqn}


def main(argv=None) -> list[dict]:
    """One sweep point a mix; returns their results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mixes", nargs="+", type=float)
    ap.add_argument("--noise", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.35)
    ap.add_argument("--ntrain", type=int, default=8_000)
    ap.add_argument("--nbase", type=int, default=60_000)
    ap.add_argument("--nquery", type=int, default=800)
    ap.add_argument("--niter", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--norm-sigma", type=float, default=0.10,
                    help="sample-norm lognormal sigma; < 0 = None (corpus v4)")
    ap.add_argument("--d", type=int, default=128,
                    help="descriptor dimension (960 = the GIST1M shape)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    a = ap.parse_args(argv)
    device = entry_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return [one(mix, a.noise, a.alpha, a.ntrain, a.nbase, a.nquery, a.niter, device=device,
                seed=a.seed, norm_sigma=None if a.norm_sigma < 0 else a.norm_sigma,
                d=a.d)
            for mix in a.mixes]


if __name__ == "__main__":
    main()
