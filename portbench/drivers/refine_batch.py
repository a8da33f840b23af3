"""Batch search through the inverted file, re-ranked from an SQ8 store: a
closed loop with one caller.

As `drivers/ivf_batch.py`, with `Index.search(Q, k, nprobe=nprobe,
refine=refine)` on an index built by `Index.build`, then `Index.build_ivf`
with the configuration's `ivf` sizes, then `Index.attach_refine` of the
base vectors with the configuration's `refine` kind. Set-up builds the
partition and the store (they count in `setup_s`), keeps what `store_bad`
needs of the base vectors (a sample of `STORE_SAMPLE` rows drawn from the
seed, and the base's per-dimension least and largest values) before they
are freed, counts the rows each batch probes by the reference's probes,
draws the rows of each kept answer that the check may judge, and warms the
route with two calls. Traffic parameters: those of `ivf_batch.py`, and
`refine`.

A kept answer keeps only those rows (`check_queries` of them, one drawn set
a kept call, cycled), as a small copy on the device: a whole [batch, k]
answer would fill the allocator's pool during the window.

End-to-end: `search_qps`. Work for the readers: each call's (nq, nlist, d,
rows probed, m, h, refine * k, candidates a query, k) under
"refine_searches". The check judges the kept rows by `reference.refine`:
`bad_ids`, `cand_miss`, `rank_gap`, `dist_gap`, and the store by
`store_bad`.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from portbench import deploy
from portbench.common import stream_seed
from portbench.drivers import ivf_batch
from portbench.reference import adc as adc_ref
from portbench.reference import ivf as ivf_ref
from portbench.reference import refine as refine_ref

STORE_SAMPLE = 4096
# Row sets drawn for the kept answers, cycled over the kept calls.
KEPT_SETS = 64


class Driver(ivf_batch.Driver):
    def setup(self) -> None:
        run, cfg, tr = self.run, self.cfg, self.tr
        seeded = dict(cfg, name=cfg["corpus_of"])
        data = deploy.make_corpus(seeded, run.device)
        self.index = deploy.build_index(seeded, data, run.device)
        iv = cfg["ivf"]
        self.index.build_ivf(iv["nlist"], sample=iv["sample"], iters=iv["iters"])
        base = data.base
        pick = torch.randperm(base.shape[0], generator=deploy.gen(run.seed, "store-sample",
                                                                   run.device),
                              device=run.device)[:STORE_SAMPLE]
        self.base_sample = (pick.cpu(), base[pick].double().cpu())
        self.base_range = (base.amin(0).double().cpu(), base.amax(0).double().cpu())
        self.index.attach_refine(base, cfg["refine"]["kind"])
        self.query = data.query
        del data, base, pick
        self.search_kw = {"nprobe": tr["nprobe"], "refine": tr["refine"]}
        bs, nq = tr["batch"], self.query.shape[0]
        self.batches = [self.query[s:s + bs] for s in range(0, nq - bs + 1, bs)]
        self.order = random.Random(stream_seed(run.seed, "batch-order")).sample(
            range(len(self.batches)), len(self.batches))
        lists = ivf_ref.Lists(*ivf_batch.partition_state(self.index.ivf), run.device)
        self.rows = [lists.rows_probed(q, tr["nprobe"]) for q in self.batches]
        del lists
        gen = torch.Generator().manual_seed(stream_seed(run.seed, "kept-rows"))
        self.kept_rows = torch.stack([torch.randperm(bs, generator=gen)[:tr["check_queries"]]
                                      for _ in range(KEPT_SETS)]).to(run.device)
        # The partition's and the store's first use, and every shape the
        # window uses.
        for q in (self.batches * 2)[:2]:
            self.index.search(q, tr["k"], **self.search_kw)
        self._sync()

    def window(self, seconds: float) -> None:
        k, idx, kw = self.tr["k"], self.index, self.search_kw
        rng = random.Random(stream_seed(self.run.seed, "kept"))
        every = self.tr["kept_every"]
        first = rng.randrange(every)
        self.kept = []  # (batch number, row set number, dists [s, k], ids [s, k])
        i = 0
        t0 = time.perf_counter()
        while True:
            b = self.order[i % len(self.order)]
            q = self.batches[b]
            self.attempted += q.shape[0]
            try:
                res = idx.search(q, k, **kw)
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                self.failed += q.shape[0]
                print(f"refine_batch: search {i} raised {type(e).__name__}: {e}",
                      file=sys.stderr)
                res = None
            if res is not None and (i % every == first or not self.kept):
                j = len(self.kept) % KEPT_SETS
                rows = self.kept_rows[j]
                self.kept.append((b, j, res.dists.index_select(0, rows),
                                  res.ids.index_select(0, rows)))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        self.window_s = time.perf_counter() - t0
        cfg, tr = self.cfg, self.tr
        nlist = idx.ivf.nlist
        rk = min(tr["refine"] * k, idx.n)
        self.run.work["refine_searches"] = [
            (self.batches[b].shape[0], nlist, cfg["d"], self.rows[b], cfg["m"], cfg["h"], rk,
             rk, k) for b in (self.order[j % len(self.order)] for j in range(i))]

    def release(self) -> None:
        counts = self.run.counts or {}
        print(f"refine_batch: {len(self.run.work['refine_searches'])} calls, "
              f"{self.attempted} queries; refine_queries {counts.get('refine_queries')}, "
              f"refine_candidates {counts.get('refine_candidates')}", file=sys.stderr)
        self.part = ivf_batch.partition_state(self.index.ivf)
        st = self.index.refine
        self.store = (st.data, st.off.cpu(), st.scale.cpu())
        self.state = deploy.index_state(self.index)
        self.kept = [(b, j, d.cpu(), i.cpu()) for b, j, d, i in self.kept]
        self.kept_rows = self.kept_rows.cpu()
        del self.index, self.batches, st
        self.query = self.query.cpu()

    def check(self) -> dict:
        """The reference judges `check_queries` rows drawn from the seed among
        the kept ones, and the store."""
        dev, tr = self.run.device, self.tr
        rng = random.Random(stream_seed(self.run.seed, "check"))
        bs = tr["batch"]
        picks = [(n, s) for n, (_, j, _, _) in enumerate(self.kept)
                 for s in range(self.kept_rows.shape[1])]
        picks = rng.sample(picks, min(tr["check_queries"], len(picks)))
        store = refine_ref.Store(*self.store, dev)
        numbers = {"store_bad": refine_ref.store_bad(store, *self.base_sample,
                                                     *self.base_range)}
        if not picks:
            return dict(numbers, bad_ids=1, cand_miss=0, rank_gap=float("nan"),
                        dist_gap=float("nan"))
        rows = [(self.kept[n], s) for n, s in picks]
        Q = torch.stack([self.query[b * bs + int(self.kept_rows[j][s])]
                         for (b, j, _, _), s in rows])
        ids = torch.stack([i[s] for (_, _, _, i), s in rows])
        dists = torch.stack([d[s] for (_, _, d, _), s in rows])
        lists = ivf_ref.Lists(*self.part, dev)
        searcher = adc_ref.Searcher(self.state["B"], self.state["C"], self.state["cbnorms"],
                                    dev)
        return dict(numbers, **refine_ref.judge(searcher, lists, store, Q, ids, dists, tr["k"],
                                                tr["refine"], tr["nprobe"]))
