#!/usr/bin/env python
"""Serving-protocol overhead: the serve twin against direct Index.search, on
the GPU (twin of `benchmarks/bench_serve.py`).

Four response modes over one server:

  json        — JSON request + ids + dists response (the default)
  json-ids    — JSON request, "dists": false (id-only)
  bin         — binary f32 query frame in, binary i32/f32 blocks out
  bin-ids     — binary both ways, ids only

The direct phase (Index.search on the index, results fetched to the host)
runs in this process first and frees its device memory before the server
subprocess starts. An index is built by the build twin (PQ, m=8, h=256,
20,000 training vectors) unless `--index` names an existing directory.
Requests are serialized before the timed loop; each mode reports the best of
three passes, each pass with the query rows rolled.

    python -m local_search_quantization_torch.benchmarks.bench_serve [--n 200000] \
        [--nq 2048] [--k 100] [--batch 256] [--index DIR] [--device cpu]

Prints the card line, the reference's lines (qps and overhead per mode
against direct), then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch.benchmarks._common import (  # noqa: E402
    bench_device,
    card_line,
    device_arg,
    sync,
)
from local_search_quantization_torch.index import Index  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts")
MODES = ("json", "json-ids", "bin", "bin-ids")
NTRAIN = 20_000
TRIALS = 3


def queries(nq: int, d: int = 128) -> np.ndarray:
    """The query stream (the same in every phase, by seed); SIFT-like
    magnitudes. Throughput does not depend on the query content."""
    rng = np.random.default_rng(123)
    return np.clip(rng.normal(120, 40, size=(nq, d)), 0, 255).astype("<f4")


def build_index(path: str, n: int, device: torch.device) -> None:
    subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "build_index.py"), "--method", "pq",
         "--out", path, "--dataset", "synthetic", "--ntrain", str(NTRAIN),
         "--nbase", str(n), "--m", "8", "--h", "256", "--niter", "10",
         "--device", device.type],
        check=True, stdout=subprocess.DEVNULL, timeout=3600)


def direct_qps(index: str, nq: int, k: int, batch: int, device: torch.device,
               precision: str = "f32") -> float:
    """In-process Index.search qps, each batch's results fetched to the host
    as the server fetches them; the index is freed before returning."""
    idx = Index.load(index, device=device)
    Q = queries(nq, idx.d)

    def search(q):
        res = idx.search(q, k, precision=precision)
        return res.ids.cpu(), res.dists.cpu()

    search(Q[:batch])  # warm: code upload
    sync(device)
    t0 = time.perf_counter()
    for s in range(0, nq, batch):
        search(Q[s:s + batch])
    qps = nq / (time.perf_counter() - t0)
    del idx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return qps


def _read_exact(stream, nbytes: int) -> bytes:
    buf = stream.read(nbytes)
    if len(buf) != nbytes:
        raise EOFError(f"binary response cut short ({len(buf)}/{nbytes} bytes)")
    return buf


def read_response(stream) -> dict:
    """One response of the serve protocol from the server's stdout: the
    header line, and for a binary response its blocks as arrays under "ids"
    (<i4) and "dists" (<f4), shape [nq, k]. Raises EOFError when the stream
    ends first."""
    line = stream.readline()
    if not line:
        raise EOFError("the server closed its output")
    resp = json.loads(line)
    if "binary" in resp and "error" not in resp:
        shape = (resp["nq"], resp["k"])
        nbytes = shape[0] * shape[1] * 4
        resp["ids"] = np.frombuffer(_read_exact(stream, nbytes), "<i4").reshape(shape)
        if resp["binary"]["dists"]:
            resp["dists"] = np.frombuffer(_read_exact(stream, nbytes), "<f4").reshape(shape)
    return resp


def pump(proc, Q: np.ndarray, k: int, batch: int, mode: str, trials: int = TRIALS,
         precision: str = "f32") -> float:
    """Request/response pump over the serve protocol: one request written,
    its response read, then the next (writing all first deadlocks on the
    pipe buffers). Requests are serialized outside the timed loop, one
    stream per trial with the rows rolled by the trial index; the best of
    `trials` passes is reported."""
    nq = Q.shape[0]
    rd = proc.stdout
    all_reqs = []
    for t in range(trials + 1):  # +1: stream 0 is the warm pass
        Qt = np.roll(Q, t, axis=0)
        reqs = []
        for i, s in enumerate(range(0, nq, batch)):
            qb = Qt[s:s + batch]
            hdr = {"id": i, "k": k}
            if precision != "f32":
                hdr["precision"] = precision
            payload = b""
            if mode.startswith("bin"):
                hdr["binary_vectors"] = int(qb.shape[0])
                hdr["binary"] = True
                payload = np.ascontiguousarray(qb).tobytes()
            else:
                hdr["vectors"] = qb.tolist()
            if mode.endswith("ids"):
                hdr["dists"] = False
            reqs.append(json.dumps(hdr).encode() + b"\n" + payload)
        all_reqs.append(reqs)

    def roundtrip(r: bytes):
        proc.stdin.write(r)
        proc.stdin.flush()
        resp = read_response(rd)
        if "error" in resp:
            raise RuntimeError(f"server answered an error: {resp}")

    roundtrip(all_reqs[0][0])
    best = float("inf")
    for t in range(trials):
        t0 = time.perf_counter()
        for r in all_reqs[t + 1]:
            roundtrip(r)
        best = min(best, time.perf_counter() - t0)
    return nq / best


def run(index: str, *, nq: int = 2048, k: int = 100, batch: int = 256,
        precision: str = "f32", device="cuda") -> dict:
    """{"direct_qps", "modes": {mode: qps}} for an existing index directory."""
    dev = bench_device(device)
    direct = direct_qps(index, nq, k, batch, dev, precision)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(SCRIPTS, "serve.py"), "--index", index,
         "--k", str(k), "--device", dev.type],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        ready = json.loads(proc.stdout.readline())
        if not ready.get("ready"):
            raise RuntimeError(f"server not ready: {ready}")
        Q = queries(nq, int(ready.get("d", 128)))
        modes = {mode: pump(proc, Q, k, batch, mode, precision=precision)
                 for mode in MODES}
        proc.stdin.write(b"EOF\n")
        proc.stdin.flush()
        if proc.wait(timeout=60) != 0:
            raise RuntimeError(f"server exited with code {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"direct_qps": direct, "modes": modes}


def lines(res: dict, n, nq: int, k: int, batch: int, device: str,
          precision: str) -> list[str]:
    direct = res["direct_qps"]
    out = [f"n={n} nq={nq} k={k} batch={batch} device={device} precision={precision} "
           f"| direct {direct:,.0f} qps"]
    for mode, qps in res["modes"].items():
        out.append(f"  {mode:9s} {qps:,.0f} qps  (overhead {100 * (direct / qps - 1):.0f}%)")
    out.append(json.dumps({"direct_qps": direct, **{
        mode: {"qps": qps, "overhead": direct / qps - 1}
        for mode, qps in res["modes"].items()}}))
    return out


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--index", default=None, help="prebuilt index dir (built if absent)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="scan precision of the direct phase and of every request")
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    with tempfile.TemporaryDirectory() as td:
        index = args.index
        if index is None or not os.path.exists(index):
            index = index or os.path.join(td, "idx")
            build_index(index, args.n, dev)
        res = run(index, nq=args.nq, k=args.k, batch=args.batch,
                  precision=args.precision, device=dev)
        with open(os.path.join(index, "meta.json")) as f:
            n = json.load(f)["n"]
    print("\n".join(lines(res, n, args.nq, args.k, args.batch, dev.type, args.precision)))
    return res


if __name__ == "__main__":
    main()
