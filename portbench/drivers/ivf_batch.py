"""Batch search through the inverted file: a closed loop with one caller.

As `drivers/batch.py`, with `Index.search(Q, k, nprobe=nprobe)` on an index
built by `Index.build` and then `Index.build_ivf` with the configuration's
`ivf` sizes. The corpus and the index are those of the configuration named
by `corpus_of`, from the same seeds. Set-up builds the partition (it counts
in `setup_s`), counts the rows each batch probes by the reference's probes
(`reference.ivf.Lists.rows_probed`), and warms the route. Traffic
parameters: those of `batch.py`, and `nprobe`.

End-to-end: `search_qps`. Work for the readers: each call's (nq, nlist, d,
rows probed, m, h, k) under "ivf_searches". The check judges the kept
answers by `reference.ivf`: `bad_ids`, `probe_miss`, `rank_gap`,
`dist_gap`.
"""

from __future__ import annotations

import random

import torch

from portbench import deploy
from portbench.common import stream_seed
from portbench.drivers import batch
from portbench.reference import adc as adc_ref
from portbench.reference import ivf as ivf_ref


def partition_state(part) -> tuple:
    """What the reference reads of the program's partition, through its
    public attributes: centroids, order, starts, lives (host arrays)."""
    return part.centroids, part.order, part.starts, part.lives


class Driver(batch.Driver):
    def setup(self) -> None:
        run, cfg, tr = self.run, self.cfg, self.tr
        seeded = dict(cfg, name=cfg["corpus_of"])
        data = deploy.make_corpus(seeded, run.device)
        self.index = deploy.build_index(seeded, data, run.device)
        iv = cfg["ivf"]
        self.index.build_ivf(iv["nlist"], sample=iv["sample"], iters=iv["iters"])
        self.query = data.query
        del data
        self.search_kw = {"nprobe": tr["nprobe"]}
        bs, nq = tr["batch"], self.query.shape[0]
        self.batches = [self.query[s:s + bs] for s in range(0, nq - bs + 1, bs)]
        self.order = random.Random(stream_seed(run.seed, "batch-order")).sample(
            range(len(self.batches)), len(self.batches))
        lists = ivf_ref.Lists(*partition_state(self.index.ivf), run.device)
        self.rows = [lists.rows_probed(q, tr["nprobe"]) for q in self.batches]
        del lists
        # The partition's upload, and every shape the window uses.
        for q in self.batches[:2]:
            self.index.search(q, tr["k"], **self.search_kw)
        self._sync()

    def window(self, seconds: float) -> None:
        super().window(seconds)
        calls = len(self.run.work["searches"])
        nlist, tr, cfg = self.index.ivf.nlist, self.tr, self.cfg
        self.run.work["ivf_searches"] = [
            (self.batches[b].shape[0], nlist, cfg["d"], self.rows[b], cfg["m"], cfg["h"],
             tr["k"]) for b in (self.order[j % len(self.order)] for j in range(calls))]

    def release(self) -> None:
        self.part = partition_state(self.index.ivf)
        super().release()

    def check(self) -> dict:
        """The reference judges `check_queries` answers drawn from the seed
        among the kept batches."""
        rng = random.Random(stream_seed(self.run.seed, "check"))
        bs = self.tr["batch"]
        picks = [(b, r, j) for b, r in self.kept for j in range(bs)]
        picks = rng.sample(picks, min(self.tr["check_queries"], len(picks)))
        if not picks:
            return {"bad_ids": 1, "probe_miss": 0, "rank_gap": float("nan"),
                    "dist_gap": float("nan")}
        Q = torch.stack([self.query[b * bs + j] for b, _, j in picks])
        ids = torch.stack([r.ids[j] for _, r, j in picks])
        dists = torch.stack([r.dists[j] for _, r, j in picks])
        dev = self.run.device
        lists = ivf_ref.Lists(*self.part, dev)
        searcher = adc_ref.Searcher(self.state["B"], self.state["C"], self.state["cbnorms"],
                                    dev)
        return ivf_ref.judge(searcher, lists, Q, ids, dists, self.tr["k"], self.tr["nprobe"])
