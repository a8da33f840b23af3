"""Served queries: an open loop of Poisson arrivals to the port's serve twin.

Set-up builds the configuration's index (`Index.build`), saves it to a
directory under the run's temporary directory and starts the twin on it in
a subprocess (`serve_launch.py`, which runs `scripts.serve.main` with
`--index <dir> --k <k>`), waits for its ready line, and warms every request
shape with `warm_requests` requests of each size. The window sends
requests on a schedule fixed by the traffic and the seed, whether or not
earlier ones were answered: `rate` requests a second over `--seconds`, the
gaps the quantiles of the exponential distribution at that rate in an order
drawn from the seed, `share_large` of them carrying `sizes[1]` queries and
the rest `sizes[0]`, the queries drawn from the configuration's query set.
Every request is a binary frame (`"binary_vectors"`, `"binary": true`) with
distances returned. A request's latency runs from its due time until its
whole response has been read; one that errs or is not answered within
`drain_s` of the last due time counts as missing every limit.

End-to-end: `search_p95_ms`, the 95th percentile of every request's latency.
For the readers: the server's own kernel launches (`run.counts`), the
requests it answered ("served_requests"), and with a trace, the server's
device trace of the window (`run.trace`).
"""

from __future__ import annotations

import gc
import json
import math
import os
import queue
import random
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from portbench import check, common, deploy

LAUNCH = [sys.executable, "-m", "portbench.serve_launch"]


def schedule(rate: float, seconds: float, sizes, share_large: float, n_query: int,
             seed: int) -> list[tuple[float, list[int]]]:
    """[(due offset s, query rows)]: round(rate * seconds) requests whose gaps
    are the exponential distribution's quantiles at `rate`, in an order drawn
    from the seed; the same set of gaps and sizes for every seed."""
    rng = random.Random(common.stream_seed(seed, f"traffic:{rate}"))
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(gaps)
    large = set(rng.sample(range(n), round(share_large * n)))
    out, t = [], 0.0
    for i, g in enumerate(gaps):
        t += g
        nq = sizes[1] if i in large else sizes[0]
        out.append((t, [rng.randrange(n_query) for _ in range(nq)]))
    return out


class Server:
    """The serve twin in a subprocess, spoken to over its pipes."""

    def __init__(self, index_dir: str, k: int, tmp: str, *, trace_out=None,
                 extra=(), device="cuda", cmd=LAUNCH):
        self.report = os.path.join(tmp, "serve_report.json")
        self.stderr_path = os.path.join(tmp, "serve_stderr.txt")
        args = list(cmd) + ["--report", self.report]
        if trace_out:
            args += ["--trace-out", trace_out]
        args += ["--", "--index", index_dir, "--k", str(k), "--device", str(device), *extra]
        self._err = open(self.stderr_path, "w")
        self.proc = subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self._err, cwd=common.ROOT)
        self.responses: queue.Queue = queue.Queue()
        ready = self.proc.stdout.readline()
        if not ready:
            raise RuntimeError(f"the server exited before ready:\n{self.stderr()}")
        self.ready = json.loads(ready)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def stderr(self) -> str:
        if not self._err.closed:
            self._err.flush()
        with open(self.stderr_path) as f:
            return f.read()

    def _read(self) -> None:
        out = self.proc.stdout
        while True:
            line = out.readline()
            if not line:
                self.responses.put(None)
                return
            obj = json.loads(line)
            ids = dists = None
            if isinstance(obj.get("binary"), dict):
                size = obj["nq"] * obj["k"] * 4
                ids = np.frombuffer(out.read(size), "<i4").reshape(obj["nq"], obj["k"])
                if obj["binary"].get("dists"):
                    dists = np.frombuffer(out.read(size), "<f4").reshape(obj["nq"], obj["k"])
            self.responses.put((time.perf_counter(), obj, ids, dists))

    def send(self, rid, vectors: np.ndarray, k: int) -> None:
        head = json.dumps({"id": rid, "binary_vectors": int(vectors.shape[0]), "k": k,
                           "binary": True}).encode() + b"\n"
        self.proc.stdin.write(head + np.ascontiguousarray(vectors, "<f4").tobytes())
        self.proc.stdin.flush()

    def line(self, raw: bytes) -> None:
        self.proc.stdin.write(raw + b"\n")
        self.proc.stdin.flush()

    def next(self, timeout: float):
        return self.responses.get(timeout=timeout)

    def close(self, timeout: float = 120.0) -> tuple[dict, dict]:
        """End the stream; (the server's launch counts, its report)."""
        try:
            self.line(b"EOF")
            self.proc.stdin.close()
        except BrokenPipeError:
            pass
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._reader.join(timeout=30)
            self._err.close()
        from local_search_quantization_torch.scripts.serve import served_launches

        with open(self.report) as f:
            report = json.load(f)
        return served_launches(self.stderr()), report


def open_loop(server: Server, plan, queries: np.ndarray, k: int, drain_s: float) -> list[dict]:
    """Send `plan` [(due offset, rows)] on time from a thread of its own and
    read every response; one record a request: due and done times (done None
    if it never came), its error, its answers. The client's garbage collector
    is held off meanwhile, so that its pauses do not make requests late."""
    recs = [{"due": None, "done": None, "error": None, "rows": rows, "ids": None,
             "dists": None, "sent": None} for _, rows in plan]
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _open_loop(server, plan, queries, k, drain_s, recs)
    finally:
        gc.enable()
        gc.unfreeze()


def _open_loop(server: Server, plan, queries: np.ndarray, k: int, drain_s: float, recs):
    t0 = time.perf_counter() + 0.05

    def sender():
        for i, (off, rows) in enumerate(plan):
            due = t0 + off
            recs[i]["due"] = due
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            recs[i]["sent"] = time.perf_counter()
            server.send(i, queries[rows], k)

    th = threading.Thread(target=sender, daemon=True)
    th.start()
    deadline = t0 + (plan[-1][0] if plan else 0.0) + drain_s
    left = len(plan)
    while left:
        try:
            got = server.next(timeout=max(0.01, deadline - time.perf_counter()))
        except queue.Empty:
            break
        if got is None:
            break
        when, obj, ids, dists = got
        rid = obj.get("id")
        if not isinstance(rid, int) or not 0 <= rid < len(recs) or recs[rid]["done"]:
            continue
        recs[rid].update(done=when, error=obj.get("error"), ids=ids, dists=dists)
        left -= 1
    th.join(timeout=drain_s)
    return recs


def latencies_ms(recs) -> list[float]:
    """Every request's latency from its due time; inf where it erred or never
    came."""
    return [(r["done"] - r["due"]) * 1e3 if r["done"] is not None and r["error"] is None
            else math.inf for r in recs]


class Driver:
    TRACES_ITSELF = True

    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.cfg, run.wl["traffic"]
        self.attempted = self.failed = 0
        self.control = False  # set by `controls.py`: the server's bf16 search
        self.server_cmd = LAUNCH

    def setup(self) -> None:
        run, cfg, tr = self.run, self.cfg, self.tr
        data = deploy.make_corpus(cfg, run.device)
        idx = deploy.build_index(cfg, data, run.device)
        self.state = deploy.index_state(idx)
        self.queries = data.query.cpu().numpy()
        index_dir = os.path.join(run.tmp, "index")
        idx.save(index_dir)
        self.build_peak = (int(torch.cuda.max_memory_allocated())
                           if run.device.type == "cuda" else 0)
        del idx, data
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        self.trace_path = os.path.join(run.tmp, "serve_trace.json") if run.tracing else None
        extra = ["--precision", "bf16"] if self.control else []
        self.server = Server(index_dir, tr["k"], run.tmp, trace_out=self.trace_path,
                             extra=extra, device=run.device.type, cmd=self.server_cmd)
        self.warm = 0
        for nq in tr["sizes"]:
            for i in range(tr["warm_requests"]):
                self.server.send(f"warm-{nq}-{i}", self.queries[:nq], tr["k"])
                self.server.next(timeout=600)
                self.warm += 1

    def window(self, seconds: float) -> None:
        tr, run = self.tr, self.run
        plan = schedule(tr["rate"], seconds, tr["sizes"], tr["share_large"],
                        self.queries.shape[0], run.seed)
        if self.trace_path:
            from portbench.serve_launch import TRACE_START

            self.server.line(TRACE_START)
            self.server.next(timeout=120)
        self.recs = open_loop(self.server, plan, self.queries, tr["k"], tr["drain_s"])
        if self.trace_path:
            from portbench.serve_launch import TRACE_STOP

            self.server.line(TRACE_STOP)
            self.server.next(timeout=300)
        counts, report = self.server.close()
        self.server_peak = report["memory_peak_bytes"]
        self.attempted = len(self.recs)
        self.failed = sum(r["done"] is None or r["error"] is not None for r in self.recs)
        run.counts = counts
        run.work["served_requests"] = self.warm + self.attempted - self.failed
        late = [r["sent"] - r["due"] for r in self.recs if r["sent"] is not None]
        lat = latencies_ms(self.recs)
        t0 = self.recs[0]["due"]
        worst = sorted(range(len(lat)), key=lambda i: -lat[i])[:8]
        print(f"served: {self.attempted} requests, {self.failed} failed, sender late by "
              f"p50 {common.percentile(late, 50) * 1e3:.3f} ms, max {max(late) * 1e3:.3f} ms; "
              f"latency p50 {common.percentile(lat, 50):.3f} ms; worst (due s, queries, ms): "
              + ", ".join(f"({self.recs[i]['due'] - t0:.3f}, {len(self.recs[i]['rows'])}, "
                          f"{lat[i]:.3f})" for i in worst), file=sys.stderr)
        if report["trace"]:
            from portbench.trace import Trace

            print(f"served: trace {os.path.getsize(report['trace'])} bytes", file=sys.stderr)
            run.trace = Trace.load(report["trace"])
            os.remove(report["trace"])

    def end_to_end(self) -> dict:
        return {"search_p95_ms": common.percentile(latencies_ms(self.recs), 95)}

    def memory_peak(self) -> int:
        return max(self.build_peak, self.server_peak)

    def release(self) -> None:
        pass  # the server has exited

    def check(self) -> dict:
        """The reference judges `check_queries` answered queries drawn from the
        seed: the served bytes, decoded."""
        rng = random.Random(common.stream_seed(self.run.seed, "check"))
        picks = [(r, j) for r in self.recs if r["ids"] is not None and r["dists"] is not None
                 for j in range(len(r["rows"]))]
        picks = rng.sample(picks, min(self.tr["check_queries"], len(picks)))
        if not picks:
            return {"bad_ids": 1, "rank_gap": float("nan"), "dist_gap": float("nan")}
        Q = self.queries[[r["rows"][j] for r, j in picks]]
        ids = np.stack([r["ids"][j] for r, j in picks])
        dists = np.stack([r["dists"][j] for r, j in picks])
        return check.answers(self.state, Q, ids, dists, self.tr["k"], self.run.device)
