"""Batch search: a closed loop with one caller.

The caller runs `Index.search(Q, k)` on batches of `batch` consecutive
queries of the configuration's query set, cycled in an order of the batches
drawn from the seed (every seed does the same batches, in another order:
a batch's cost depends on which queries share it), each call after the last
returns; the window closes at the first return past `--seconds`, and
the device is synchronised before its clock stops. Traffic parameters
(`workloads/<cell>.json`, "traffic"): `batch`, `k`, and for the check
`kept_every` (one batch in so many keeps its answers, the first drawn from
the seed; the window's first answers are always kept) and `check_queries` (how many of the kept answers the reference
judges, drawn from the seed).

End-to-end: `search_qps`, queries answered over the window's seconds.
Work for the readers: each call's (nq, n, k, m, h) under "searches".

Every driver has this interface: `Driver(run)`, `setup()`, `window(seconds)`,
`end_to_end()`, `memory_peak()`, `release()`, `check()`, and the attributes
`attempted`, `failed` and `TRACES_ITSELF`.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from portbench import check, deploy
from portbench.common import stream_seed


class Driver:
    TRACES_ITSELF = False

    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.cfg, run.wl["traffic"]
        self.attempted = self.failed = 0
        self.control = False  # set by `controls.py`: the bf16 search in its place

    def setup(self) -> None:
        run, cfg = self.run, self.cfg
        self.search_kw = {"precision": "bf16"} if self.control else {}
        data = deploy.make_corpus(cfg, run.device)
        self.index = deploy.build_index(cfg, data, run.device)
        self.query = data.query
        del data
        bs, nq = self.tr["batch"], self.query.shape[0]
        self.batches = [self.query[s:s + bs] for s in range(0, nq - bs + 1, bs)]
        self.order = random.Random(stream_seed(run.seed, "batch-order")).sample(
            range(len(self.batches)), len(self.batches))
        # The scan state's upload, and every shape the window uses.
        for q in self.batches[:2]:
            self.index.search(q, self.tr["k"], **self.search_kw)
        self._sync()

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> None:
        k, idx = self.tr["k"], self.index
        rng = random.Random(stream_seed(self.run.seed, "kept"))
        every = self.tr["kept_every"]
        first = rng.randrange(every)
        self.kept = []  # (batch number, result)
        i = 0
        t0 = time.perf_counter()
        while True:
            b = self.order[i % len(self.order)]
            q = self.batches[b]
            self.attempted += q.shape[0]
            try:
                res = idx.search(q, k, **self.search_kw)
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                self.failed += q.shape[0]
                print(f"batch: search {i} raised {type(e).__name__}: {e}", file=sys.stderr)
                res = None
            if res is not None and (i % every == first or not self.kept):
                self.kept.append((b, res))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.run.work["searches"] = [(self.batches[self.order[j % len(self.order)]].shape[0],
                                      idx.n, k, self.cfg["m"], self.cfg["h"])
                                     for j in range(i)]

    def end_to_end(self) -> dict:
        return {"search_qps": (self.attempted - self.failed) / self.window_s}

    def memory_peak(self) -> int:
        if self.run.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated())

    def release(self) -> None:
        self.state = deploy.index_state(self.index)
        self.kept = [(b, type(r)(r.dists.cpu(), r.ids.cpu())) for b, r in self.kept]
        del self.index, self.batches
        self.query = self.query.cpu()

    def check(self) -> dict:
        """The reference judges `check_queries` answers drawn from the seed
        among the kept batches."""
        rng = random.Random(stream_seed(self.run.seed, "check"))
        bs = self.tr["batch"]
        picks = [(b, r, j) for b, r in self.kept for j in range(bs)]
        picks = rng.sample(picks, min(self.tr["check_queries"], len(picks)))
        if not picks:
            return {"bad_ids": 1, "rank_gap": float("nan"), "dist_gap": float("nan")}
        Q = torch.stack([self.query[b * bs + j] for b, _, j in picks])
        ids = torch.stack([r.ids[j] for _, r, j in picks])
        dists = torch.stack([r.dists[j] for _, r, j in picks])
        return check.answers(self.state, Q, ids, dists, self.tr["k"], self.run.device)
