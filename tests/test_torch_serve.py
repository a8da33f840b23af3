"""The port's serving command line end to end on the CPU: the build twin writes
an index directory, the serve twin answers over the JSON-lines and
binary-frame protocol of `scripts/serve.py` (subprocesses, `--device cpu`).

Mirrors tests/test_serve.py: build and serve for pq and lsq with parity to
an in-process scan of the as-built codes, binary frames, the two fatal exits
(and the stderr note before a drain), the protocol fuzz, and running the
twins as files from a directory outside the repo (where the server's last
stderr note, its requests' kernel launches, is all zeros). Beside it: `--mesh N`
exits before "ready" naming parallel/, `--method rvq` builds a directory the
JAX package loads, and without a GPU every twin exits
nonzero unless given `--device cpu`. One tiny index per method is built per
module and copied for each test that mutates it.
"""

import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from local_search_quantization_torch.ops import adc
from local_search_quantization_torch.scripts.serve import LAUNCHES_NOTE, served_launches
from local_search_quantization_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "local_search_quantization_torch", "scripts")
TINY = ["--dataset", "synthetic", "--synth-d", "16", "--ntrain", "400", "--m", "2",
        "--h", "16", "--niter", "2", "--ilsiter", "2", "--device", "cpu"]
# Subprocesses get two torch threads, as this module.
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def twin(name: str, *args: str) -> list[str]:
    return [sys.executable, "-m", f"local_search_quantization_torch.scripts.{name}", *args]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{method: index directory} of the tiny pq and lsq builds (1500 rows)."""
    root = tmp_path_factory.mktemp("built")
    procs = {m: subprocess.Popen(twin("build_index", "--method", m, "--out", str(root / m),
                                      "--nbase", "1500", *TINY),
                                 cwd=REPO, env=ENV, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE)
             for m in ("pq", "lsq")}
    for m, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()
    return {m: str(root / m) for m in procs}


@pytest.fixture
def index(built, tmp_path):
    """A fresh copy of a built index directory (a session may save into it)."""
    def copy(method: str) -> str:
        dst = str(tmp_path / f"idx_{method}")
        shutil.copytree(built[method], dst)
        return dst

    return copy


def serve(idx: str, *extra: str, text: bool = True, stderr=None):
    return subprocess.Popen(twin("serve", "--index", idx, "--k", "5", "--device", "cpu",
                                 *extra),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
                            text=text, cwd=REPO, env=ENV)


def test_twins_run_as_files_from_a_non_repo_cwd(tmp_path):
    """Each twin carries its own path shim: build, serve and eval run as
    plain files from a directory that is neither the repo nor theirs."""
    out = str(tmp_path / "idx")
    subprocess.run([sys.executable, os.path.join(SCRIPTS, "build_index.py"), "--method",
                    "pq", "--out", out, "--nbase", "800", *TINY],
                   cwd=str(tmp_path), env=ENV, check=True, capture_output=True,
                   timeout=600)
    assert {"meta.json", "model.npz", "codes.npz"} <= set(os.listdir(out))
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["dataset"] == "synthetic" and meta["build_s"] >= 0 and meta["n"] == 800
    q = np.full((1, 16), 120.0, np.float32)
    served = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "serve.py"), "--index", out, "--k", "3",
         "--device", "cpu"],
        input=json.dumps({"id": 1, "vectors": q.tolist()}) + "\nEOF\n",
        cwd=str(tmp_path), env=ENV, check=True, capture_output=True, text=True,
        timeout=600)
    ready, r1 = (json.loads(line) for line in served.stdout.splitlines())
    assert ready["ready"] and np.shape(r1["ids"]) == (1, 3)
    assert "device cpu" in served.stderr
    # At EOF the server's last stderr note counts its requests' kernel
    # launches: none on the CPU, where every wrapper runs its plain version.
    launches = served_launches(served.stderr)
    assert {"ils_encode", "scan_topk", "scan_select", "scan_key"} <= set(launches)
    assert served.stderr.splitlines()[-1].startswith(LAUNCHES_NOTE)
    assert not any(v for v in launches.values() if isinstance(v, int)), launches
    table = str(tmp_path / "recall.json")
    subprocess.run([sys.executable, os.path.join(SCRIPTS, "eval_index.py"), "--index",
                    out, "--nquery", "50", "--knn", "20", "--device", "cpu", "--out",
                    table], cwd=str(tmp_path), env=ENV, check=True, capture_output=True,
                   timeout=600)
    with open(table) as f:
        rec = json.load(f)
    assert set(rec) == {"index", "dataset", "k", "nprobe", "refine", "precision",
                        "nquery", "qps", "recall"}
    assert list(rec["recall"]) == ["r@1", "r@2", "r@5", "r@10", "r@20"]
    curve = list(rec["recall"].values())
    assert curve == sorted(curve) and curve[-1] > 0.5, curve


@pytest.mark.parametrize("method", ["pq", "lsq"])
def test_build_and_serve(index, method, rng):
    idx = index(method)
    # The as-built snapshot for the parity check: the session's "save"
    # rewrites codes.npz with the mutations.
    model = ckpt.load_model(os.path.join(idx, "model.npz"), device="cpu")
    codes0 = ckpt.load_codes(os.path.join(idx, "codes.npz"))

    p = serve(idx)
    try:
        ready = json.loads(p.stdout.readline())
        assert ready == {"ready": True, "method": method, "n": 1500, "d": 16, "k": 5,
                         "ivf_nlist": None, "refine": None}
        q = rng.normal(120, 30, size=(3, 16)).astype(np.float32)
        xnew = rng.normal(130, 25, size=(2, 16)).astype(np.float32)
        lines = [
            {"id": 1, "vectors": q.tolist()},
            {"id": 2, "vectors": [[1.0]]},
            {"id": 3, "bad": "req"},
            {"id": 4, "vectors": q[:1].tolist(), "k": 2},
            "{{{not json",
            {"op": "add", "id": 6, "vectors": xnew.tolist()},
            # Depth 50: at m=2, h=16 the inserted row's cell can tie with
            # closer reconstructions (see tests/test_serve.py).
            {"id": 7, "vectors": xnew[:1].tolist(), "k": 50},
            {"op": "delete", "id": 8, "ids": [1500]},
            {"id": 9, "vectors": xnew[:1].tolist(), "k": 50},
            {"op": "delete", "id": 10, "ids": [99999]},
            {"op": "save", "id": 11},
            {"id": 12, "vectors": q.tolist(), "precision": "bf16"},
            {"id": 13, "vectors": q[:1].tolist(), "precision": "fp8"},
            {"id": 14, "vectors": q.tolist(), "dists": False},
        ]
        for line in lines:
            p.stdin.write((line if isinstance(line, str) else json.dumps(line)) + "\n")
        p.stdin.write("EOF\n")
        p.stdin.flush()
        (r1, r2, r3, r4, r5, r6, r7, r8, r9, r10, r11, r12, r13, r14) = (
            json.loads(p.stdout.readline()) for _ in range(14))
    finally:
        p.stdin.close()
        assert p.wait(timeout=60) == 0

    assert np.shape(r1["ids"]) == (3, 5)
    for row in r1["dists"]:
        assert row == sorted(row)
    assert "error" in r2 and "error" in r3
    assert np.shape(r4["ids"]) == (1, 2)
    assert "error" in r5 and r5["id"] is None  # never the previous request's id
    assert r6["added"] == [1500, 1501] and r6["n"] == 1502
    assert 1500 in r7["ids"][0], r7["ids"]
    assert r8["deleted"] == 1 and r8["n"] == 1502
    assert 1500 not in r9["ids"][0], r9["ids"]
    assert "error" in r10
    assert r11["saved"].endswith("codes.npz")
    assert np.shape(r12["ids"]) == (3, 5) and 1500 not in np.asarray(r12["ids"]).ravel()
    overlap = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(r12["ids"], r1["ids"])])
    assert overlap >= 0.6, (r12["ids"], r1["ids"])
    assert "error" in r13 and "precision" in r13["error"]
    assert np.shape(r14["ids"]) == (3, 5) and "dists" not in r14
    assert 1500 not in np.asarray(r14["ids"]).ravel()

    # The saved index reloads with the insert and the tombstone.
    p2 = serve(idx)
    try:
        assert json.loads(p2.stdout.readline())["n"] == 1502
        p2.stdin.write(json.dumps({"id": 1, "vectors": xnew[:1].tolist(), "k": 50})
                       + "\nEOF\n")
        p2.stdin.flush()
        assert 1500 not in json.loads(p2.stdout.readline())["ids"][0]
    finally:
        p2.stdin.close()
        assert p2.wait(timeout=60) == 0

    # The pre-mutation responses against an in-process scan of the snapshot.
    if method == "lsq":
        dbn = codes0["cbnorms"][codes0["bnorm"]].astype(np.float32)
        res = adc.linscan_lsq(codes0["B"], torch.as_tensor(q), model.C, dbn, k=5)
    else:
        res = adc.linscan_pq(codes0["B"], torch.as_tensor(q), model.C_sub, k=5)
    np.testing.assert_allclose(np.asarray(r1["dists"], np.float32), res.dists.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (np.asarray(r1["ids"]) == res.ids.numpy()).mean() > 0.9  # up to ties


def test_serve_binary_frames(index, rng):
    """Raw <f4 query frames in, raw <i4/<f4 blocks out, equal to the JSON
    responses, and a framed request that fails validation still consumes
    its payload."""
    p = serve(index("pq"), text=False)
    rd = p.stdout
    try:
        assert json.loads(rd.readline())["ready"]
        q = rng.normal(120, 30, size=(3, 16)).astype("<f4")

        def send(obj, payload=b""):
            p.stdin.write(json.dumps(obj).encode() + b"\n" + payload)
            p.stdin.flush()

        send({"id": 1, "binary_vectors": 3}, q.tobytes())
        r1 = json.loads(rd.readline())
        assert np.shape(r1["ids"]) == (3, 5) and "error" not in r1

        send({"id": 2, "vectors": q.tolist(), "binary": True})
        h2 = json.loads(rd.readline())
        assert h2 == {"id": 2, "nq": 3, "k": 5, "binary": {"ids": "<i4", "dists": "<f4"}}
        ids2 = np.frombuffer(rd.read(15 * 4), "<i4").reshape(3, 5)
        d2 = np.frombuffer(rd.read(15 * 4), "<f4").reshape(3, 5)
        np.testing.assert_array_equal(ids2, np.asarray(r1["ids"]))
        np.testing.assert_array_equal(d2, np.asarray(r1["dists"], np.float32))

        send({"id": 3, "binary_vectors": 3, "binary": True, "dists": False}, q.tobytes())
        h3 = json.loads(rd.readline())
        assert h3["binary"]["dists"] is None
        np.testing.assert_array_equal(
            np.frombuffer(rd.read(15 * 4), "<i4").reshape(3, 5), ids2)

        send({"id": 4, "op": "nope", "binary_vectors": 3}, q.tobytes())
        assert "error" in json.loads(rd.readline())
        send({"id": 5, "vectors": q[:1].tolist(), "k": 2})
        assert np.shape(json.loads(rd.readline())["ids"]) == (1, 2)

        xnew = rng.normal(130, 25, size=(2, 16)).astype("<f4")
        send({"op": "add", "id": 6, "binary_vectors": 2}, xnew.tobytes())
        r6 = json.loads(rd.readline())
        assert r6["added"] == [1500, 1501] and r6["n"] == 1502
        p.stdin.write(b"EOF\n")
        p.stdin.flush()
    finally:
        p.stdin.close()
        assert p.wait(timeout=60) == 0


def test_serve_binary_frame_fatalities(index, rng):
    """A count that is not a non-negative int, and a truncated frame, end the
    server with exit code 1 and a line on stderr; a well-formed over-cap
    count is drained after a note on stderr; a zero count is an error and
    the server lives."""
    idx = index("pq")

    def spawn():
        return serve(idx, "--no-warmup", text=False, stderr=subprocess.PIPE)

    for bad in (-1, "3x", True):
        p = spawn()
        try:
            assert json.loads(p.stdout.readline())["ready"]
            p.stdin.write(json.dumps({"id": 1, "binary_vectors": bad}).encode() + b"\n")
            p.stdin.flush()
            resp = json.loads(p.stdout.readline())
            assert resp["id"] == 1 and "binary_vectors" in resp["error"]
            p.stdin.close()
            assert p.wait(timeout=60) == 1, bad
            assert b"fatal binary_vectors" in p.stderr.read()
        finally:
            p.kill()

    # Over the cap but well formed: a note on stderr before the drain; the
    # client closing mid-drain is a truncation (exit 1).
    p = spawn()
    try:
        assert json.loads(p.stdout.readline())["ready"]
        p.stdin.write(json.dumps({"id": 1, "binary_vectors": 10**9}).encode() + b"\n"
                      + b"x" * 64)
        p.stdin.close()
        assert p.wait(timeout=60) == 1
        err = p.stderr.read().decode()
        note, fatal = err.index("draining 64000000000 bytes"), err.index("truncated")
        assert "512 MB cap (request id 1)" in err and note < fatal, err
    finally:
        p.kill()

    p = spawn()
    try:
        assert json.loads(p.stdout.readline())["ready"]
        p.stdin.write(json.dumps({"id": 1, "binary_vectors": 0}).encode() + b"\n")
        p.stdin.flush()
        assert "out of range" in json.loads(p.stdout.readline())["error"]
        q0 = rng.normal(120, 30, size=(1, 16)).astype("<f4")
        p.stdin.write(json.dumps({"id": 2, "binary_vectors": 1, "k": 3}).encode() + b"\n"
                      + q0.tobytes())
        p.stdin.flush()
        r2 = json.loads(p.stdout.readline())
        assert "error" not in r2 and np.shape(r2["ids"]) == (1, 3)
        p.stdin.write(b"EOF\n")
        p.stdin.close()
        assert p.wait(timeout=60) == 0
        assert b"draining" not in p.stderr.read()
    finally:
        p.kill()

    p = spawn()
    try:
        assert json.loads(p.stdout.readline())["ready"]
        q = rng.normal(120, 30, size=(3, 16)).astype("<f4")
        p.stdin.write(json.dumps({"id": 2, "binary_vectors": 4}).encode() + b"\n"
                      + q.tobytes())
        p.stdin.close()  # promised 4 rows, sent 3
        assert p.wait(timeout=60) == 1
        assert b"truncated" in p.stderr.read()
    finally:
        p.kill()


def test_serve_protocol_fuzz(index, rng):
    """Each malformed, hostile or valid request line gets exactly one JSON
    response and the server survives; blank lines are ignored."""
    p = serve(index("pq"))
    try:
        assert json.loads(p.stdout.readline())["ready"]
        rnd = random.Random(0)
        q = rng.normal(120, 30, size=(2, 16)).astype(np.float32)
        junk_lines = ['{"k":', "nonsense", "[1, 2, 3]", '"a string"', "123", "{}", "null",
                      "true", '{"op": "query"}', '{"op": 5, "vectors": []}']
        hostile_reqs = [
            {"vectors": q.tolist(), "k": -5},
            {"vectors": q.tolist(), "k": 0},
            {"vectors": q.tolist(), "k": 10**9},
            {"vectors": [[1.0, 2.0]]},
            {"vectors": "not-a-matrix"},
            {"vectors": [["x"] * 16]},
            {"vectors": q.tolist(), "nprobe": 4},
            {"vectors": q.tolist(), "refine": 4},
            {"vectors": q.tolist(), "precision": "int8"},
            {"op": "frobnicate", "vectors": q.tolist()},
            {"op": "delete", "ids": [-1]},
            {"op": "delete", "ids": "nope"},
            {"op": "add", "vectors": [[1.0]]},
            {"op": "compact"},
        ]
        n_sent = ok_queries = 0
        for i in range(150):
            roll = rnd.random()
            if roll < 0.1:
                p.stdin.write("\n")
                p.stdin.flush()
                continue
            if roll < 0.35:
                line = rnd.choice(junk_lines)
            elif roll < 0.75:
                line = json.dumps({"id": i, **rnd.choice(hostile_reqs)})
            else:
                line = json.dumps({"id": i, "vectors": q.tolist(),
                                   "k": rnd.choice([1, 3, 5])})
            p.stdin.write(line + "\n")
            p.stdin.flush()
            resp = json.loads(p.stdout.readline())
            n_sent += 1
            assert isinstance(resp, dict)
            if "error" not in resp and "ids" in resp:
                ok_queries += 1
        assert n_sent > 100 and ok_queries > 10
        p.stdin.write(json.dumps({"id": "final", "vectors": q.tolist()}) + "\n")
        p.stdin.flush()
        final = json.loads(p.stdout.readline())
        assert final["id"] == "final" and "ids" in final, final
        p.stdin.write("EOF\n")
        p.stdin.close()
        assert p.wait(timeout=60) == 0
    finally:
        p.kill()


def test_serve_mesh_exits_before_ready_naming_parallel(built):
    out = subprocess.run(twin("serve", "--index", built["pq"], "--device", "cpu",
                              "--mesh", "2"),
                         cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    assert "parallel/" in out.stderr and "not ported" in out.stderr


def test_build_twin_builds_an_rvq_directory_that_jax_loads(tmp_path):
    """`--method rvq` builds (in process): m=2 + norm byte, and the JAX
    package's Index loads the directory and returns the port's ids."""
    from local_search_quantization_tpu.index import Index as JIndex
    from local_search_quantization_torch.index import Index
    from local_search_quantization_torch.scripts import build_index

    out = str(tmp_path / "rvq")
    build_index.main(["--method", "rvq", "--out", out, "--nbase", "500", *TINY])
    ti = Index.load(out, device="cpu")
    assert ti.method == "rvq" and ti.n == 500 and ti.meta["bits"] == 2 * 4 + 8
    ji = JIndex.load(out)
    q = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(ji.search(q, k=5).ids),
                                  ti.search(q, k=5).ids.numpy())


@pytest.mark.parametrize("name", ["build_index", "serve", "eval_index"])
def test_twin_needs_a_gpu_unless_asked_for_the_cpu(name, built, tmp_path):
    """With no CUDA device visible and no --device, each twin exits nonzero
    with entry_device's message and never carries on on the CPU."""
    args = {"build_index": ["--method", "pq", "--out", str(tmp_path / "idx"),
                            "--dataset", "synthetic", "--nbase", "500"],
            "serve": ["--index", built["pq"]],
            "eval_index": ["--index", built["pq"], "--nquery", "10"]}[name]
    out = subprocess.run(twin(name, *args), cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr, out.stderr
    assert '"ready"' not in out.stdout and not os.path.exists(tmp_path / "idx")
