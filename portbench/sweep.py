"""Find the served cell's knee: the highest offered rate whose backlog does
not grow over a window.

    python3 -m portbench.sweep --workload sift1m-lsq64.served-1q --seed <n> \\
        --rates 200,400,800,... [--seconds 8]

One server start (the served driver's set-up), then each rate in turn with
the cell's traffic at that rate, the i-th window's arrivals drawn from seed
+ i (a rate given twice measures the spread of its tail). For each rate it prints the requests, how
many failed, the latency p50 and p95 from the due time, the completion
rate, and the backlog's trend: the slope of latency over due time (ms a
second) and the latency of the last tenth of the requests over that of the
first tenth. A backlog that grows shows as a positive slope well above
noise and a last tenth far above the first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from portbench import common
from portbench import run as runmod
from portbench.drivers import served


def trend(recs) -> dict:
    lat = np.array(served.latencies_ms(recs))
    due = np.array([r["due"] for r in recs])
    ok = np.isfinite(lat)
    tenth = max(1, len(lat) // 10)
    slope = float(np.polyfit(due[ok] - due[0], lat[ok], 1)[0]) if ok.sum() > 2 else float("inf")
    done = [r["done"] for r in recs if r["done"] is not None]
    span = (max(done) - min(due)) if done else float("inf")
    return {"requests": len(recs), "failed": int((~ok).sum()),
            "p50_ms": common.percentile(lat.tolist(), 50),
            "p95_ms": common.percentile(lat.tolist(), 95),
            "completed_per_s": len(done) / span,
            "slope_ms_per_s": slope,
            "last_over_first_tenth": float(np.median(lat[-tenth:]) / np.median(lat[:tenth]))}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sift1m-lsq64.served-1q")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    print(f"sweep: {torch.cuda.get_device_name(0)}; nvidia-smi: {common.card_line()}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = runmod.Run(args.workload, args.seed, args.seconds, False,
                         torch.device("cuda", 0), tmp)
        drv = served.Driver(run)
        t = time.perf_counter()
        drv.setup()
        print(f"sweep: set-up {time.perf_counter() - t:.3f} s", flush=True)
        tr = drv.tr
        try:
            for i, rate in enumerate(float(r) for r in args.rates.split(",")):
                plan = served.schedule(rate, args.seconds, tr["sizes"], tr["share_large"],
                                       drv.queries.shape[0], args.seed + i)
                recs = served.open_loop(drv.server, plan, drv.queries, tr["k"], tr["drain_s"])
                print(json.dumps({"rate": rate, **trend(recs)}), flush=True)
        finally:
            drv.server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
