#!/usr/bin/env python
"""Reproduce the reference papers' SIFT1M 64-bit recall comparison on the GPU.

Twin of `scripts/repro_paper.py` (the same flags, `--device` in place of
`--platform`): PQ m=8 and OPQ m=8 (64-bit), LSQ m=7 + 1 norm byte with
LSQ-16/LSQ-32 base encodes from one run (milestones), and optionally ChainQ,
RVQ and sparse LSQ (SLSQ1/SLSQ2) rows. With the TEXMEX SIFT1M files on disk
(./data/sift/) this is the real parity run; otherwise it falls back to the
d=128 SIFT-statistics synthetic corpus (announced) so the ordering check,
LSQ >= OPQ >= 0.9 PQ at r@10, the papers' headline claim, still runs.

The stage cache (`--stage-cache`: one model file a stage, the base codes,
a manifest that pins the configuration) and the corpus cache
(`--corpus-cache`: train, base, query, gt, seed) have the JAX script's file
names and formats, so a cache written by either package resumes in the
other. Writes the JSON table (`--out`; "platform" is the torch device type
and the card's name) and exits non-zero if the ordering check fails.

    python -m local_search_quantization_torch.scripts.repro_paper \
        --ntrain 100000 --niter 10 --with-chainq --with-rvq --with-slsq
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch.utils import checkpoint as ckpt  # noqa: E402
from local_search_quantization_torch.utils.device import encode_in_chunks, entry_device  # noqa: E402


def recall_at(gt: np.ndarray, ids: np.ndarray,
              ns=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
                  10000)) -> dict:
    """Recall@N curve to the reference's depth (r@10000 milestones,
    Linscan.jl:104-109); entries beyond ids.shape[1] are skipped."""
    hit = ids == np.asarray(gt)[:, None]  # [nq, k]
    any_hit = np.cumsum(hit, axis=1) > 0  # hit within the first n columns
    out = {}
    for n in ns:
        if n > ids.shape[1]:
            break
        out[f"r@{n}"] = float(np.mean(any_hit[:, n - 1]))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=100_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--bits", type=int, default=64, choices=[64, 128],
                    help="code budget a vector: 64 (PQ/OPQ m=8, additive m=7 + "
                         "norm byte) or 128 (m=16 / m=15 + norm byte)")
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--milestones", default="16,32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sr", default="none", choices=["none", "SR-D", "SR-C"],
                    help="LSQ stochastic relaxation (LSQ++, beyond the reference)")
    ap.add_argument("--sr-scale", type=float, default=1.0,
                    help="multiplier on the SR noise std")
    ap.add_argument("--with-chainq", action="store_true",
                    help="also report ChainQ (m_lsq + norm byte, Viterbi base "
                         "encode) as its own row")
    ap.add_argument("--with-rvq", action="store_true",
                    help="also report RVQ (greedy residual k-means, m_lsq stages "
                         "+ norm byte) as its own row")
    ap.add_argument("--with-slsq", action="store_true",
                    help="also report sparse LSQ (SLSQ1/SLSQ2 at the reference's "
                         "tau/S, demo_lsq_sparse.jl:32-41) from a PQ m_lsq init "
                         "with R = I, with the achieved l0/l1")
    ap.add_argument("--stage-cache", default=None,
                    help="directory caching each trained model and the base "
                         "codes, so an interrupted run resumes at its next "
                         "stage; a manifest pins the configuration")
    ap.add_argument("--out", default="recall_table.json")
    ap.add_argument("--corpus-cache", default=None,
                    help="npz path caching the synthetic corpus")
    ap.add_argument("--synth-d", type=int, default=128,
                    help="synthetic-corpus dimension; only when the named "
                         "dataset is absent")
    ap.add_argument("--scan-mode", default=None, choices=["matmul", "gather"],
                    help="accepted for the JAX script's command lines; both "
                         "compute the same sums here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    return ap.parse_args(argv)


def load_corpus(args):
    """(x_train, x_base, x_query, gt, synthetic): the named dataset, or the
    synthetic corpus, through the corpus cache when one is given."""
    from local_search_quantization_torch.utils.io import dataset_available, read_dataset
    from local_search_quantization_torch.utils.synth import synthetic_dataset

    if args.dataset != "synthetic" and dataset_available(args.dataset):
        return (read_dataset(args.dataset, args.ntrain).astype(np.float32),
                read_dataset(args.dataset + "_base", args.nbase).astype(np.float32),
                read_dataset(args.dataset + "_query", args.nquery).astype(np.float32),
                read_dataset(args.dataset + "_groundtruth", args.nquery)[:, 0], False)
    print(f"[repro] {args.dataset} files NOT on disk — falling back to a "
          f"d={args.synth_d} SIFT-statistics synthetic corpus; the ordering check "
          "still applies, absolute recalls are not the paper's.")
    exp = (args.ntrain, min(args.nbase, 1_000_000), min(args.nquery, 10_000))
    if args.corpus_cache and os.path.exists(args.corpus_cache):
        z = np.load(args.corpus_cache)
        got = (z["train"].shape[0], z["base"].shape[0], z["query"].shape[0])
        if got != exp:
            raise SystemExit(
                f"[repro] corpus cache {args.corpus_cache} holds (ntrain, nbase, "
                f"nquery)={got} but this run requests {exp} — use a fresh cache path")
        if z["train"].shape[1] != args.synth_d:
            raise SystemExit(
                f"[repro] corpus cache {args.corpus_cache} is d={z['train'].shape[1]} "
                f"but this run requests d={args.synth_d} — use a fresh cache path")
        if "seed" in z and int(z["seed"]) != args.seed:
            raise SystemExit(
                f"[repro] corpus cache {args.corpus_cache} was built with seed "
                f"{int(z['seed'])}, run requests {args.seed} — use a fresh cache path")
        print(f"[repro] corpus cache hit: {args.corpus_cache}")
        return z["train"], z["base"], z["query"], z["gt"], True
    dd = synthetic_dataset(args.seed, d=args.synth_d, n_train=exp[0], n_base=exp[1],
                           n_query=exp[2])
    if args.corpus_cache:
        np.savez(args.corpus_cache, train=dd.train, base=dd.base, query=dd.query,
                 gt=dd.gt, seed=args.seed)
        print(f"[repro] corpus cached: {args.corpus_cache}")
    return dd.train, dd.base, dd.query, dd.gt, True


def open_stage_cache(args) -> str | None:
    """Create or check the stage cache's manifest; returns the directory."""
    cache = args.stage_cache
    if not cache:
        return None
    os.makedirs(cache, exist_ok=True)
    manifest = {k: getattr(args, k) for k in (
        "dataset", "ntrain", "nbase", "nquery", "niter", "h", "seed", "milestones",
        "bits")}
    man_path = os.path.join(cache, "manifest.json")
    if not os.path.exists(man_path):
        with open(man_path, "w") as f:
            json.dump(manifest, f)
        return cache
    with open(man_path) as f:
        old = json.load(f)
    # Manifests from before the sr-tagged stage names carried sr/sr_scale and
    # wrote an SR-trained model as plain "lsq.npz": only sr=none ones migrate.
    legacy = {k: old.pop(k) for k in ("sr", "sr_scale") if k in old}
    old.setdefault("bits", 64)  # manifests from before --bits are 64-bit runs
    if legacy.get("sr", "none") != "none":
        raise SystemExit(
            f"[repro] {man_path} is a legacy SR stage cache (sr={legacy['sr']}): its "
            "lsq.npz predates the sr-tagged stage naming and cannot be told apart "
            "from a plain-LSQ stage — use a fresh dir")
    if old != manifest:
        raise SystemExit(f"[repro] stage-cache config mismatch in {man_path}: cached "
                         f"{old}, requested {manifest} — use a fresh dir")
    if legacy:
        with open(man_path, "w") as f:
            json.dump(manifest, f)
    return cache


def main(argv=None) -> dict:
    """The run; returns the table it writes to --out."""
    args = parse_args(argv)
    device = entry_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from local_search_quantization_torch.models import (
        quantize_opq, quantize_pq, train_chainq, train_lsq, train_opq, train_pq,
    )
    from local_search_quantization_torch.ops import adc, icm, norms
    from local_search_quantization_torch.utils.config import (
        ChainQConfig, LSQConfig, OPQConfig, PQConfig,
    )
    from local_search_quantization_torch.utils.synth import corpus_fingerprint, random_codes

    h = args.h
    scan_kw = {"mode": args.scan_mode} if args.scan_mode else {}
    milestones = tuple(int(x) for x in args.milestones.split(","))
    x_train, x_base, x_query, gt, synthetic = load_corpus(args)
    X = torch.as_tensor(x_train, device=device)
    Q = torch.as_tensor(x_query, device=device)

    def encode(fn):
        return encode_in_chunks(fn, x_base, device)

    def recall(res):
        return recall_at(gt, res.ids.cpu().numpy())

    def seconds(t):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return round(time.time() - t, 1)

    # Bit budget -> widths: PQ/OPQ use m_pq byte codes; the additive methods
    # reserve one byte for the quantized norm (demo_lsq.jl:14-19).
    m_pq = args.bits // 8
    m_lsq = m_pq - 1
    platform = device.type + (f" {torch.cuda.get_device_name(device)}"
                              if device.type == "cuda" else "")
    table: dict = {
        "dataset": args.dataset if not synthetic else "synthetic-sift-stats",
        "ntrain": int(x_train.shape[0]), "nbase": int(x_base.shape[0]),
        "nquery": int(x_query.shape[0]), "niter": args.niter,
        "d": int(x_train.shape[1]), "bits": args.bits, "methods": {},
        "platform": platform,
    }
    if synthetic:
        table["corpus_fingerprint"] = corpus_fingerprint()
    if args.sr != "none":
        table["sr"] = args.sr
        table["sr_scale"] = args.sr_scale

    cache = open_stage_cache(args)
    # SR changes only the LSQ stage, so its knobs go in that stage's name.
    sr_tag = "" if args.sr == "none" else (
        f"_{args.sr}" + ("" if args.sr_scale == 1.0 else f"x{args.sr_scale:g}"))

    def cached_model(name, train_fn):
        """Train or load one model stage through the stage cache."""
        if not cache:
            return train_fn()
        p = os.path.join(cache, name + ".npz")
        if os.path.exists(p):
            print(f"[repro] stage-cache hit: {name}")
            return ckpt.load_model(p, device)
        model = train_fn()
        ckpt.save_model(p, model)
        return model

    def report(name, row):
        table["methods"][name] = row
        print(f"[repro] {name} done ({row['wall_s']}s): {row['recall']}")

    # === PQ m=m_pq (demos/demo_pq.jl config) ===
    t = time.time()
    pq = cached_model("pq", lambda: train_pq(X, PQConfig(
        m=m_pq, h=h, kmeans_maxiter=max(25, args.niter), seed=args.seed)))
    res = adc.linscan_pq(encode(lambda x: quantize_pq(x, pq.C_sub)), Q, pq.C_sub,
                         k=args.knn, **scan_kw)
    report("PQ", {"train_mse": float(pq.error), "recall": recall(res),
                  "wall_s": seconds(t)})

    # === OPQ m=m_pq (demos/demo_opq.jl config) ===
    t = time.time()
    opq = cached_model("opq", lambda: train_opq(X, OPQConfig(
        m=m_pq, h=h, niter=args.niter, seed=args.seed)))
    res = adc.linscan_opq(encode(lambda x: quantize_opq(x, opq.R, opq.C_sub)), Q,
                          opq.C_sub, opq.R, k=args.knn, **scan_kw)
    report("OPQ", {"train_mse": float(opq.obj[-1]), "recall": recall(res),
                   "wall_s": seconds(t)})

    # === LSQ m=m_lsq + norm byte (demos/demo_lsq.jl config) ===
    t = time.time()
    opq7 = cached_model("opq7", lambda: train_opq(X, OPQConfig(
        m=m_lsq, h=h, niter=args.niter, seed=args.seed)))
    chain = cached_model("chainq", lambda: train_chainq(
        X, opq7.B, opq7.R, ChainQConfig(m=m_lsq, h=h, niter=args.niter)))
    if args.with_chainq:
        # ChainQ as its own method: Viterbi-exact base encode in the rotated
        # space + norm byte, queried through the additive scan.
        from local_search_quantization_torch.ops import viterbi

        t_cq = time.time()
        B_cq = encode(lambda x: viterbi.viterbi_encode(x @ chain.R, chain.C))
        cbn_cq, _ = norms.train_norm_codebook(B_cq[:100_000], chain.C, h)
        dbn_cq = cbn_cq[norms.quantize_norms(B_cq, chain.C, cbn_cq).long()]
        res = adc.linscan_lsq(B_cq, Q, chain.C, dbn_cq, k=args.knn, R=chain.R, **scan_kw)
        report("ChainQ", {"train_mse": float(chain.obj[-1]), "recall": recall(res),
                          "wall_s": seconds(t_cq)})

    lsq_cfg = LSQConfig(m=m_lsq, h=h, niter=args.niter, seed=args.seed,
                        sr_method=args.sr, sr_scale=args.sr_scale)
    lsq = cached_model("lsq" + sr_tag, lambda: train_lsq(
        X, chain.B, chain.R, lsq_cfg, verbose=True))
    enc_path = os.path.join(cache, f"lsq{sr_tag}_codes.npz") if cache else None
    if enc_path and os.path.exists(enc_path):
        print("[repro] stage-cache hit: lsq base codes")
        z = ckpt.load_codes(enc_path)
        ms_B, ms_cost = z["B"], z["cost"]
    else:
        B0 = random_codes(args.seed, x_base.shape[0], m_lsq, h)
        enc = icm.encode_chunked(
            torch.Generator(device=device).manual_seed(args.seed + 1), x_base, B0, lsq.C,
            ilsiter=milestones[-1], icmiter=lsq_cfg.icmiter, npert=lsq_cfg.npert,
            randord=lsq_cfg.randord, milestones=milestones)
        ms_B, ms_cost = enc.milestone_B.cpu().numpy(), enc.milestone_cost.cpu().numpy()
        if enc_path:
            ckpt.save_codes(enc_path, ms_B, {"cost": ms_cost})
    for s, rounds in enumerate(milestones):
        B_ms = torch.as_tensor(np.asarray(ms_B[s]), device=device)
        dbn = lsq.cbnorms[norms.quantize_norms(B_ms, lsq.C, lsq.cbnorms).long()]
        res = adc.linscan_lsq(B_ms, Q, lsq.C, dbn, k=args.knn, **scan_kw)
        table["methods"][f"LSQ-{rounds}"] = {
            "train_mse": float(lsq.obj[-1]),
            "base_mse": float(np.mean(ms_cost[s])),
            "recall": recall(res), "wall_s": seconds(t),
        }
        print(f"[repro] LSQ-{rounds} done: {table['methods'][f'LSQ-{rounds}']['recall']}")

    # === RVQ (beyond the reference): greedy residual k-means at the additive
    # bit budget (m_lsq stages + norm byte), on the same additive scan.
    if args.with_rvq:
        from local_search_quantization_torch.models import quantize_rvq, train_rvq
        from local_search_quantization_torch.utils.config import RVQConfig

        t = time.time()
        rvq = cached_model("rvq", lambda: train_rvq(X, RVQConfig(
            m=m_lsq, h=h, kmeans_maxiter=max(25, args.niter), seed=args.seed)))
        rvq_path = os.path.join(cache, "rvq_codes.npz") if cache else None
        if rvq_path and os.path.exists(rvq_path):
            print("[repro] stage-cache hit: rvq base codes")
            B_rv = torch.as_tensor(ckpt.load_codes(rvq_path)["B"], device=device)
        else:
            B_rv = encode(lambda x: quantize_rvq(x, rvq.C))
            if rvq_path:
                ckpt.save_codes(rvq_path, B_rv.cpu().numpy(), {})
        dbn_rv = rvq.cbnorms[norms.quantize_norms(B_rv, rvq.C, rvq.cbnorms).long()]
        res = adc.linscan_lsq(B_rv, Q, rvq.C, dbn_rv, k=args.knn, **scan_kw)
        report("RVQ", {"train_mse": float(rvq.obj[-1]), "recall": recall(res),
                       "wall_s": seconds(t)})

    # Write the dense rows now, so a failure in the SLSQ stages (the longest
    # optional tail) cannot lose them; rewritten with the SLSQ rows below.
    with open(args.out, "w") as f:
        json.dump(table, f, indent=2)

    # === Sparse LSQ (demos/demo_lsq_sparse.jl:11-46): m_lsq + norm byte from a
    # PQ m_lsq init with R = I; SLSQ1: S = d*h, tau = 0.7*||C_PQ||_1; SLSQ2:
    # S = d*h + d^2, tau = 0.9. Not in the ordering check: sparsity trades
    # recall for model size.
    if args.with_slsq:
        from local_search_quantization_torch.models import train_lsq_sparse
        from local_search_quantization_torch.utils.config import SLSQConfig

        d = x_train.shape[1]
        pq7 = cached_model("pq7", lambda: train_pq(X, PQConfig(
            m=m_lsq, h=h, kmeans_maxiter=max(25, args.niter), seed=args.seed)))
        R_I = torch.eye(d, device=device)
        for variant, S, tau_scale in (("SLSQ1", d * h, 0.7), ("SLSQ2", d * h + d * d, 0.9)):
            t = time.time()
            cfg_s = SLSQConfig(m=m_lsq, h=h, niter=args.niter, seed=args.seed, S=S,
                               tau_scale=tau_scale)
            sl = cached_model(variant.lower(), lambda cfg_s=cfg_s: train_lsq_sparse(
                X, pq7.B, pq7.C_sub, R_I, cfg_s, verbose=True))
            sp_path = os.path.join(cache, f"{variant.lower()}_codes.npz") if cache else None
            if sp_path and os.path.exists(sp_path):
                print(f"[repro] stage-cache hit: {variant} base codes")
                z_sp = ckpt.load_codes(sp_path)
                B_sp, cost_sp = torch.as_tensor(z_sp["B"], device=device), z_sp["cost"]
            else:
                B0 = random_codes(args.seed + 3, x_base.shape[0], m_lsq, h)
                enc_sp = icm.encode_chunked(
                    torch.Generator(device=device).manual_seed(args.seed + 4), x_base, B0,
                    sl.C, ilsiter=milestones[-1], icmiter=cfg_s.icmiter,
                    npert=cfg_s.npert, randord=cfg_s.randord)
                B_sp, cost_sp = enc_sp.B, enc_sp.cost.cpu().numpy()
                if sp_path:
                    ckpt.save_codes(sp_path, B_sp.cpu().numpy(), {"cost": cost_sp})
            dbn_sp = sl.cbnorms[norms.quantize_norms(B_sp, sl.C, sl.cbnorms).long()]
            res = adc.linscan_lsq(B_sp, Q, sl.C, dbn_sp, k=args.knn, **scan_kw)
            table["methods"][variant] = {
                "train_mse": float(sl.obj[-1]), "base_mse": float(np.mean(cost_sp)),
                "S": int(S), "tau_scale": tau_scale,
                "l0": int(sl.l0[-1]), "l1": float(sl.l1[-1]),
                "dense_l0": int(d * h * m_lsq),
                "recall": recall(res), "wall_s": seconds(t),
            }
            print(f"[repro] {variant} done ({table['methods'][variant]['wall_s']}s, "
                  f"l0={int(sl.l0[-1])}/{d * h * m_lsq}): "
                  f"{table['methods'][variant]['recall']}")

    with open(args.out, "w") as f:
        json.dump(table, f, indent=2)
    print(f"[repro] wrote {args.out}")

    # The papers' headline ordering at equal bits (README.md:164-168), at r@10:
    # strict LSQ >= OPQ, and OPQ within 10% of PQ.
    key = "r@10"
    r_pq = table["methods"]["PQ"]["recall"][key]
    r_opq = table["methods"]["OPQ"]["recall"][key]
    r_lsq = max(table["methods"][f"LSQ-{r}"]["recall"][key] for r in milestones)
    print(f"[repro] {key}: PQ={r_pq:.4f} OPQ={r_opq:.4f} LSQ={r_lsq:.4f}")
    if not (r_lsq >= r_opq and r_opq >= r_pq * 0.90 and r_lsq > r_pq):
        raise SystemExit(f"[repro] ORDERING FAILED: expected LSQ >= OPQ >= PQ at {key}")
    print("[repro] ordering LSQ >= OPQ >= PQ: OK")
    return table


if __name__ == "__main__":
    main()
