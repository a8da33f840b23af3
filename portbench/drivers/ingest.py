"""Ingestion: a closed loop of `Index.add`.

Set-up builds the configuration's index (`Index.build`: the trained model
and its base) and a pool of `pool_rows` vectors of the configuration's
distribution, made on the device, in an order drawn from the seed. The window runs cycles: each starts from a fresh copy
of the set-up's index, then adds `adds_per_cycle` batches of `add_rows`
rows, taken from the pool in order; every cycle does the same work, and the
index's buffers grow the same way in each. The window closes at the end of
the first cycle that ends past `--seconds`, so it holds whole cycles. Traffic
parameters (`workloads/<cell>.json`, "traffic"): `pool_rows`, `add_rows`,
`adds_per_cycle`, and for the check `check_rows` (rows whose codes the
reference encoder encodes again) and `check_queries` (added rows searched
for after the window, k=`check_k`, over the last cycle's index).

End-to-end: `index_vps`, rows added over the window's seconds, and
`index_qerr`, the squared reconstruction error of every row added in the
window from the port's codes and codebooks, over their squared norms.
Work for the readers: each add's (rows, m, h, rounds) under "encodes".
"""

from __future__ import annotations

import copy
import random
import sys
import time

import numpy as np
import torch

from portbench import check, corpus, deploy
from portbench.common import stream_seed
from portbench.reference import ils


class Driver:
    TRACES_ITSELF = False

    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.cfg, run.wl["traffic"]
        self.attempted = self.failed = 0
        # Set by `controls.py`: the reference encoder in bfloat16 and the
        # bf16 search in the program's place.
        self.control = False

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        run, cfg, tr = self.run, self.cfg, self.tr
        data = deploy.make_corpus(cfg, run.device)
        self.base = deploy.build_index(cfg, data, run.device)
        pool, _ = corpus.draw(data.model, deploy.data_gen(cfg, "pool", run.device),
                              tr["pool_rows"])
        self.pool = pool[torch.randperm(tr["pool_rows"], device=run.device,
                                        generator=deploy.gen(run.seed, "pool-order", run.device))]
        del pool
        del data
        self.slices = tr["pool_rows"] // tr["add_rows"]
        # The one shape the window adds, on a throwaway copy.
        copy.deepcopy(self.base).add(self.pool[:tr["add_rows"]])
        self._sync()

    def window(self, seconds: float) -> None:
        tr, rows = self.tr, self.tr["add_rows"]
        self.kept = []  # (pool slice, uint8 codes [rows, m]) of every add
        t0 = time.perf_counter()
        while True:
            idx = copy.deepcopy(self.base)
            for j in range(tr["adds_per_cycle"]):
                s = j % self.slices
                self.attempted += rows
                try:
                    ids = idx.add(self.pool[s * rows:(s + 1) * rows])
                except Exception as e:  # noqa: BLE001 - a failed add is counted
                    self.failed += rows
                    print(f"ingest: add raised {type(e).__name__}: {e}", file=sys.stderr)
                    continue
                self.kept.append((s, idx.B[ids[0]:ids[-1] + 1].astype(np.uint8)))
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.last = idx
        self.run.work["encodes"] = [(rows, self.cfg["m"], self.cfg["h"], self.cfg["ilsiter"])
                                    for _ in self.kept]

    def _rows_of(self, s: int) -> torch.Tensor:
        rows = self.tr["add_rows"]
        return self.pool[s * rows:(s + 1) * rows]

    def end_to_end(self) -> dict:
        C = self.base.model.C.detach()
        err = norm = 0.0
        for s, codes in self.kept:
            X = self._rows_of(s)
            err += float(ils.sq_error(X, C, torch.as_tensor(codes)).sum())
            norm += float((X.double() ** 2).sum())
        added = len(self.kept) * self.tr["add_rows"]
        return {"index_vps": added / self.window_s,
                "index_qerr": err / norm if norm else float("nan")}

    def memory_peak(self) -> int:
        if self.run.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated())

    def release(self) -> None:
        """Search the last cycle's index for some of its added rows (the
        answers the check judges), then keep what the reference reads and
        free the program's state."""
        rng = random.Random(stream_seed(self.run.seed, "check"))
        tr, rows = self.tr, self.tr["add_rows"]
        last = self.kept[-tr["adds_per_cycle"]:]
        picks = [(last[rng.randrange(len(last))][0], rng.randrange(rows))
                 for _ in range(tr["check_queries"])] if last else []
        self.Q = (torch.stack([self._rows_of(s)[r] for s, r in picks]) if picks
                  else torch.empty((0, self.cfg["d"]), device=self.pool.device))
        kw = {"precision": "bf16"} if self.control else {}
        res = self.last.search(self.Q, tr["check_k"], **kw) if picks else None
        self.answers = None if res is None else (res.ids.cpu(), res.dists.cpu())
        self.state = deploy.index_state(self.last)
        samples = [(rng.randrange(len(self.kept)), rng.randrange(rows))
                   for _ in range(tr["check_rows"])] if self.kept else []
        self.X = torch.stack([self._rows_of(self.kept[a][0])[r] for a, r in samples]) \
            if samples else None
        self.B = np.stack([self.kept[a][1][r] for a, r in samples]) if samples else None
        self.Q = self.Q.cpu()
        del self.last, self.base, self.pool

    def check(self) -> dict:
        if self.answers is None or self.X is None:
            return {"bad_ids": 1, "rank_gap": float("nan"), "dist_gap": float("nan"),
                    "enc_excess": float("nan")}
        dev, C = self.run.device, self.state["C"].to(self.run.device)
        out = check.answers(self.state, self.Q, *self.answers, self.tr["check_k"], dev)
        B = self.B
        if self.control:
            gen = deploy.gen(self.run.seed, "control-ils", dev)
            B = ils.encode(self.X, C, gen, ilsiter=self.cfg["ilsiter"],
                           dtype=torch.bfloat16).cpu().numpy()
        out.update(check.codes(self.X, B, C, self.cfg["ilsiter"], self.run.seed, dev))
        return out
