"""CPU runs of each cell at a tiny size, with the cell's own limits: a sound
run comes out correct; the control (the nearest precision below the
configuration's in the program's place) and each fault the cell can have,
planted underneath the timed path, come out not correct. Also: the harness
refuses to run without a card, and loads neither JAX nor the JAX package;
the reference loads nothing of the port.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import check, common, controls
from portbench import run as runmod

TINY = dict(d=16, n_train=3000, n_base=20000, n_query=200, m=4, h=16, niter=2, ilsiter=4)
TRAFFIC = {
    "bigann10m-lsq64.batch-k10": {"batch": 50},
    "sift1m-lsq64.batch-k1000": {"batch": 50, "k": 200},
    "sift1m-lsq64.ingest": {"pool_rows": 8192, "add_rows": 2048, "adds_per_cycle": 3,
                            "check_rows": 2048, "check_queries": 16},
    "sift1m-lsq64.served-1q": {"rate": 50.0, "warm_requests": 2, "check_queries": 16},
}
SEED = 2**31 + 4242


def tiny_run(name, tmp_path, configure=None, seconds=1.0):
    wl = common.workload(name)
    wl = dict(wl, traffic=dict(wl["traffic"], **TRAFFIC[name]))
    cfg = dict(common.config(wl["config"]), **TINY)
    run = runmod.Run(name, SEED, seconds, False, torch.device("cpu"), str(tmp_path), wl=wl,
                     cfg=cfg)
    out = runmod.execute(run, time.perf_counter(), configure=configure)
    return check.verdict(out["numbers"], wl["limits"])[0], out


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_sound_run_is_correct(name, tmp_path):
    ok, out = tiny_run(name, tmp_path)
    assert ok, out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(v > 0 for v in out["e2e"].values()), out["e2e"]


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_control_is_not_correct(name, tmp_path):
    ok, out = tiny_run(name, tmp_path, configure=controls.control_on)
    assert not ok, out["numbers"]


def _altered(search):
    def broken(self, Q, k=100, **kw):
        res = search(self, Q, k, **kw)
        return type(res)(res.dists, (res.ids + 1) % self.n)
    return broken


def _half_left_out(search):
    def broken(self, Q, k=100, **kw):
        h = max(1, Q.shape[0] // 2)
        res = search(self, Q[:h], k, **kw)
        reps = -(-Q.shape[0] // h)
        return type(res)(res.dists.repeat(reps, 1)[:Q.shape[0]],
                         res.ids.repeat(reps, 1)[:Q.shape[0]])
    return broken


@pytest.mark.parametrize("name", ["bigann10m-lsq64.batch-k10", "sift1m-lsq64.batch-k1000"])
@pytest.mark.parametrize("fault", [_altered, _half_left_out])
def test_broken_search_is_not_correct(name, fault, tmp_path, monkeypatch):
    from local_search_quantization_torch.index import Index

    monkeypatch.setattr(Index, "search", fault(Index.search))
    ok, out = tiny_run(name, tmp_path)
    assert not ok, out["numbers"]


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_broken_encoder_is_not_correct(kind, tmp_path, monkeypatch):
    """The encoder broken for the window only: its state returned unchanged
    (the random initial codes), or every code altered where it is made."""
    from local_search_quantization_torch.ops import icm

    real = icm.ils_encode

    def unchanged(gen, X, B0, C, **kw):
        B = B0.to(C.device, torch.int32)
        return icm.ILSResult(B, torch.zeros(B.shape[0], device=C.device))

    def altered(gen, X, B0, C, **kw):
        B = real(gen, X, B0, C, **kw).B
        return icm.ILSResult((B + 1) % C.shape[1], torch.zeros(B.shape[0], device=C.device))

    def configure(driver):
        window = driver.window

        def broken_window(seconds):
            monkeypatch.setattr(icm, "ils_encode", unchanged if kind == "unchanged" else altered)
            try:
                window(seconds)
            finally:
                monkeypatch.setattr(icm, "ils_encode", real)
        driver.window = broken_window

    ok, out = tiny_run("sift1m-lsq64.ingest", tmp_path, configure=configure)
    assert not ok and out["numbers"]["enc_excess"] > 0.5, out["numbers"]


def test_broken_server_is_not_correct(tmp_path):
    def configure(driver):
        driver.server_cmd = [sys.executable, "-m", "portbench.tests.broken_serve"]

    ok, out = tiny_run("sift1m-lsq64.served-1q", tmp_path, configure=configure)
    assert not ok and out["numbers"]["rank_gap"] > 1e-4, out["numbers"]


def _cli(args, cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_exits_nonzero_without_a_card():
    r = _cli(["--workload", "bigann10m-lsq64.batch-k10", "--seed", str(SEED), "--seconds", "1",
              "--trace", "0"], common.ROOT)
    assert r.returncode != 0 and "{" not in r.stdout, (r.returncode, r.stdout, r.stderr)


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(["--workload", "sift1m-lsq64.batch-k1000", "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout, (r.returncode, r.stdout, r.stderr)


def _modules_after(imports: str) -> set[str]:
    code = (f"import sys\n{imports}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(r.stdout.split())


def test_harness_loads_neither_jax_nor_the_jax_package():
    mods = _modules_after(
        "import portbench.run, portbench.check, portbench.controls, portbench.sweep\n"
        "import portbench.serve_launch, portbench.trace, portbench.roofline\n"
        "import portbench.drivers.batch, portbench.drivers.ingest, portbench.drivers.served\n"
        "import portbench.reference.adc, portbench.reference.ils\n"
        "import local_search_quantization_torch.index\n"
        "import local_search_quantization_torch.scripts.serve")
    assert not mods & set(runmod.FORBIDDEN), mods & set(runmod.FORBIDDEN)
    assert "local_search_quantization_torch" in mods


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after("import portbench.reference.adc, portbench.reference.ils")
    assert not mods & (set(runmod.FORBIDDEN) | {"local_search_quantization_torch"}), mods


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card(card):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "sift1m-lsq64.batch-k1000", "--seed", str(SEED), "--seconds", "2",
                        "--trace", "1"], cwd=common.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0, res
