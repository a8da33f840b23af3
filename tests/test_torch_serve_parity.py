"""The port's serving twins against the JAX package's scripts, on the CPU.

An LSQ index directory written by the JAX `scripts/build_index.py` is served
by `scripts/serve.py` and by the serve twin with one request stream, and one
written by the build twin likewise: every line gets the same kind of answer
(a result or an error) with the same keys; f32 query responses agree in
their distances (rtol 1e-5, atol 1e-5) and in at least 99% of their ids,
each other id sitting at a tie within that tolerance. The eval twin and the
JAX `eval_index.py` give recall curves within 2/nquery of each other.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from local_search_quantization_torch.benchmarks.bench_serve import read_response

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--method", "lsq", "--dataset", "synthetic", "--synth-d", "16", "--ntrain",
        "400", "--nbase", "1500", "--m", "2", "--h", "16", "--niter", "2", "--ilsiter",
        "2"]
ENV = dict(os.environ, OMP_NUM_THREADS="2")
RTOL = ATOL = 1e-5
NQUERY = 200


def jax_script(name: str, *args: str) -> list[str]:
    return [sys.executable, os.path.join(REPO, "scripts", f"{name}.py"), *args,
            "--platform", "cpu"]


def twin(name: str, *args: str) -> list[str]:
    return [sys.executable, "-m", f"local_search_quantization_torch.scripts.{name}", *args,
            "--device", "cpu"]


COMMANDS = {"jax": jax_script, "twin": twin}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{"jax": dir, "twin": dir}: the same tiny LSQ build by each package."""
    root = tmp_path_factory.mktemp("built")
    procs = {who: subprocess.Popen(cmd("build_index", "--out", str(root / who), *TINY),
                                   cwd=REPO, env=ENV, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE)
             for who, cmd in COMMANDS.items()}
    for who, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (who, err.decode()[-2000:])
    return {who: str(root / who) for who in procs}


def _stream(d: int):
    """(request line, frame) pairs: queries in JSON and binary frames, at
    several k and with the distances off, errors, a delete and a compact (the
    answers after them are comparable: both are deterministic), then an add
    (each package encodes it with its own random stream) and a save."""
    rng = np.random.default_rng(7)
    q = rng.normal(120, 30, size=(20, d)).astype("<f4")
    reqs = [
        ({"id": 1, "vectors": q.tolist()}, b""),
        ({"id": 2, "vectors": q.tolist(), "k": 30}, b""),
        ({"id": 3, "binary_vectors": 20}, q.tobytes()),
        ({"id": 4, "binary_vectors": 20, "k": 30, "binary": True}, q.tobytes()),
        ({"id": 5, "vectors": q.tolist(), "binary": True, "dists": False}, b""),
        ({"id": 6, "vectors": q.tolist(), "k": 30, "dists": False}, b""),
        ({"id": 7, "vectors": q.tolist(), "precision": "bf16"}, b""),
        ({"id": 8, "vectors": q[:1].tolist(), "precision": "fp8"}, b""),
        ({"id": 9, "vectors": [[1.0, 2.0]]}, b""),
        ({"id": 10, "vectors": q[:2].tolist(), "nprobe": 4}, b""),
        ({"id": 11, "vectors": q[:2].tolist(), "refine": 2}, b""),
        ({"id": 12, "op": "frobnicate"}, b""),
        ("{{{not json", b""),
        ({"id": 13, "binary_vectors": 0}, b""),
        ({"id": 14, "op": "delete", "ids": [3, 17, 99]}, b""),
        ({"id": 15, "op": "delete", "ids": [5000]}, b""),
        ({"id": 16, "vectors": q.tolist(), "k": 30}, b""),
        ({"id": 17, "op": "compact"}, b""),
        ({"id": 18, "binary_vectors": 20, "k": 30, "binary": True}, q.tobytes()),
        ({"id": 19, "op": "add", "binary_vectors": 2}, q[:2].tobytes()),
        ({"id": 20, "op": "save"}, b""),
    ]
    return [((r if isinstance(r, str) else json.dumps(r)).encode() + b"\n", f)
            for r, f in reqs]


def _serve_both(idx: str, tmp_path) -> dict:
    """{who: [response, ...]} of both servers, each on its own copy of idx,
    fed the same stream a request at a time."""
    procs = {}
    for who, cmd in COMMANDS.items():
        copy = str(tmp_path / f"serve_{who}")
        shutil.copytree(idx, copy)
        procs[who] = subprocess.Popen(cmd("serve", "--index", copy, "--k", "5"),
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, cwd=REPO, env=ENV)
    out = {who: [] for who in procs}
    try:
        readies = {who: json.loads(p.stdout.readline()) for who, p in procs.items()}
        assert readies["jax"] == readies["twin"], readies
        for line, frame in _stream(readies["jax"]["d"]):
            for p in procs.values():
                p.stdin.write(line + frame)
                p.stdin.flush()
            for who, p in procs.items():
                out[who].append(read_response(p.stdout))
        for p in procs.values():
            p.stdin.write(b"EOF\n")
            p.stdin.close()
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs.values():
            p.kill()
    return out


def _same_answers(a: dict, b: dict, f32: bool) -> None:
    assert ("error" in a) == ("error" in b), (a, b)
    assert set(a) == set(b), (a, b)
    if "error" in a or "ids" not in a:
        return
    ia, ib = np.asarray(a["ids"]), np.asarray(b["ids"])
    assert ia.shape == ib.shape
    if not f32:
        return
    if "dists" in a:
        da, db = np.asarray(a["dists"], np.float32), np.asarray(b["dists"], np.float32)
        np.testing.assert_allclose(da, db, rtol=RTOL, atol=ATOL)
        # An id that differs sits at a tie: the other server has it at a
        # distance within the tolerance, or (cut from its list) ties it
        # across its k-th distance.
        for r, c in zip(*np.nonzero(ia != ib)):
            x, tol = ia[r, c], ATOL + RTOL * abs(da[r, c])
            there = np.flatnonzero(ib[r] == x)
            other = db[r, there[0]] if there.size else db[r, -1]
            assert abs(other - da[r, c]) <= tol, (r, c, x)
    assert (ia == ib).mean() >= 0.99, (ia, ib)


@pytest.mark.parametrize("writer", ["jax", "twin"])
def test_both_servers_answer_one_stream_alike(built, writer, tmp_path):
    out = _serve_both(built[writer], tmp_path)
    reqs = [json.loads(line) if line.startswith(b"{\"") else None
            for line, _ in _stream(16)]
    compared = 0
    for req, a, b in zip(reqs, out["jax"], out["twin"]):
        f32 = (req is not None and req.get("op", "query") == "query"
               and req.get("precision", "f32") == "f32")
        _same_answers(a, b, f32)
        compared += f32 and "error" not in a and "dists" in a
    assert compared >= 4
    # The deterministic mutations land alike; the added rows get the same ids.
    by_id = {r.get("id"): (a, b) for r, a, b in zip(reqs, out["jax"], out["twin"]) if r}
    assert by_id[14][0] == by_id[14][1] == {"id": 14, "deleted": 3, "n": 1500}
    assert by_id[17][0] == by_id[17][1] == {"id": 17, "removed": 3, "n": 1497}
    assert by_id[19][0] == by_id[19][1] == {"id": 19, "added": [1497, 1498], "n": 1499}


def test_eval_twin_matches_the_jax_eval(built, tmp_path):
    tables = {}
    procs = {}
    for who, cmd in COMMANDS.items():
        tables[who] = str(tmp_path / f"{who}.json")
        procs[who] = subprocess.Popen(
            cmd("eval_index", "--index", built["jax"], "--nquery", str(NQUERY), "--knn",
                "100", "--out", tables[who]),
            cwd=REPO, env=ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    for who, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (who, err.decode()[-2000:])
    recs = {}
    for who, path in tables.items():
        with open(path) as f:
            recs[who] = json.load(f)
    a, b = recs["jax"], recs["twin"]
    assert set(a) == set(b) and list(a["recall"]) == list(b["recall"])
    for key in a:
        if key not in ("qps", "recall"):
            assert a[key] == b[key], key
    for n, r in a["recall"].items():
        assert abs(r - b["recall"][n]) <= 2 / NQUERY, (n, r, b["recall"][n])
