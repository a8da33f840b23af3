#!/usr/bin/env python
"""How much recall does LSQ's 1-byte norm quantizer cost?

Twin of `scripts/diag_normbyte.py`: the stage-cached LSQ model and its
deepest milestone's base codes (LSQ-32) of a `repro_paper` run of either
package are scanned twice over the same queries, once with the quantized
norms (the norm byte) and once with the exact float32 norms; the difference
is the norm byte's recall price alone. On the GPU both scans take the
default route (K2); under `--device cpu` the native scanner when it is
built, else the exact route (every f32 route gives the same ids).

    python -m local_search_quantization_torch.scripts.diag_normbyte \
        .cache/stages_v4 .cache/corpus_v4_paperscale.npz
"""

from __future__ import annotations

import argparse
import os
import sys

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch.ops import adc, norms  # noqa: E402
from local_search_quantization_torch.utils import checkpoint as ckpt  # noqa: E402
from local_search_quantization_torch.utils import native  # noqa: E402
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402


def recall_at(gt, ids, ns=(1, 2, 5, 10, 100)):
    return {f"r@{n}": float((ids[:, :n] == gt[:, None]).any(1).mean()) for n in ns}


def main(argv=None) -> dict:
    """Both scans; returns {label: recall dict}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cache", nargs="?", default=".cache/stages_v4",
                    help="a repro_paper stage cache (lsq.npz, lsq_codes.npz)")
    ap.add_argument("corpus", nargs="?", default=".cache/corpus_v4_paperscale.npz",
                    help="the corpus cache of that run (query, gt)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    topk_method = ("native" if native.available() else "auto") if device.type == "cpu" \
        else "auto"
    z = np.load(args.corpus)
    xq, gt = torch.as_tensor(z["query"], device=device), z["gt"]

    lsq = ckpt.load_model(os.path.join(args.cache, "lsq.npz"), device)
    zc = ckpt.load_codes(os.path.join(args.cache, "lsq_codes.npz"))
    B = torch.as_tensor(np.asarray(zc["B"][-1]), device=device)  # LSQ-32

    sq = norms.reconstruction_sqnorms(B, lsq.C)
    dq = lsq.cbnorms[norms.quantize_norms(B, lsq.C, lsq.cbnorms).long()]
    rel = (torch.abs(dq - sq) / torch.clamp(torch.abs(sq), min=1e-9)).cpu().numpy()
    print(f"norm-byte rel err: mean {rel.mean():.2e} p99 {np.quantile(rel, 0.99):.2e}")

    out = {}
    for name, extra in (("quantized(norm byte)", dq), ("exact f32 norms", sq)):
        res = adc.linscan_lsq(B, xq, lsq.C, extra.to(torch.float32), k=1000,
                              topk_method=topk_method)
        out[name] = recall_at(gt, res.ids.cpu().numpy())
        print(f"LSQ-32 {name}: {out[name]}")
    return out


if __name__ == "__main__":
    main()
