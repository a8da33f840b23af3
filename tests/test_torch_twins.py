"""The port's twins of the remaining demos and scripts, at a tiny size on the
CPU: `demos/demo_{pq,opq,chainq,lsq_sparse}_torch.py` and, in
`local_search_quantization_torch/scripts/`, `repro_paper`, `diag_normbyte`,
`calibrate_corpus` and `diag_flip`.

Each is called in process through `main(argv)` with `--device cpu`; without
it each raises before any work (`torch.cuda.is_available` is patched to
False, so that holds on a machine with a GPU too). The `repro_paper` twin's
table has the rows and sparsity checks of the JAX smoke test
(tests/test_pipelines.py::test_repro_paper_smoke); its stage cache loads with
the JAX package's `checkpoint.load_model`, and the JAX script resumes it to
the same table. One subprocess: the twin run as a file from outside the repo.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from local_search_quantization_torch.scripts import (
    calibrate_corpus,
    diag_flip,
    diag_normbyte,
    repro_paper,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "demos")]

import demo_chainq_torch  # noqa: E402
import demo_lsq_sparse_torch  # noqa: E402
import demo_opq_torch  # noqa: E402
import demo_pq_torch  # noqa: E402

SPARSE = ["--dataset", "synthetic", "--ntrain", "600", "--nbase", "2000", "--nquery", "30",
          "--m", "4", "--h", "16", "--synth-d", "16"]  # the sparse twin takes no --knn
DEMO = SPARSE + ["--knn", "50"]
REPRO = ["--dataset", "synthetic", "--ntrain", "600", "--nbase", "3000", "--nquery", "40",
         "--niter", "2", "--h", "16", "--knn", "40", "--milestones", "2",
         "--with-chainq", "--with-rvq", "--with-slsq"]
ROWS = ("PQ", "OPQ", "ChainQ", "LSQ-2", "RVQ", "SLSQ1", "SLSQ2")
STAGES = ("pq", "opq", "opq7", "chainq", "lsq", "rvq", "pq7", "slsq1", "slsq2")


def _nondecreasing(curve):
    curve = np.asarray(curve)
    return bool((np.diff(curve) >= 0).all()) and curve[-1] > curve[0]


@pytest.mark.parametrize("demo", [demo_pq_torch, demo_opq_torch, demo_chainq_torch],
                         ids=["pq", "opq", "chainq"])
def test_demo_twin_runs_on_the_cpu(demo):
    curve = demo.main(DEMO + ["--niter", "2", "--device", "cpu"]
                      if demo is not demo_pq_torch else DEMO + ["--device", "cpu"])
    assert curve.shape == (50,) and _nondecreasing(curve) and curve[-1] >= 0.9


@pytest.mark.parametrize("variant", ["SLSQ1", "SLSQ2"])
def test_demo_lsq_sparse_twin(variant):
    """Training only (the reference demo's behaviour), then with --nbase:
    sparse codebooks within S, and a recall curve."""
    model, curve = demo_lsq_sparse_torch.main(
        ["--dataset", "synthetic", "--ntrain", "600", "--m", "4", "--h", "16",
         "--niter", "2", "--synth-d", "16", "--variant", variant, "--device", "cpu"])
    S = 16 * 16 + (0 if variant == "SLSQ1" else 16 * 16)
    assert curve is None and model.l0[-1] <= S
    model, curve = demo_lsq_sparse_torch.main(SPARSE + ["--niter", "2", "--variant", variant,
                                                        "--device", "cpu"])
    assert model.l0[-1] <= S and curve.shape == (1000,) and _nondecreasing(curve)


@pytest.fixture(scope="module")
def repro_run(tmp_path_factory):
    """The twin at smoke scale with a stage cache and a corpus cache. The
    ordering check is a paper-scale contract: at this size an inversion is
    sampling noise, so its exit is accepted (the table is written first)."""
    root = tmp_path_factory.mktemp("repro")
    paths = {"stages": str(root / "stages"), "corpus": str(root / "corpus.npz"),
             "out": str(root / "table.json")}
    try:
        repro_paper.main(REPRO + ["--device", "cpu", "--stage-cache", paths["stages"],
                                  "--corpus-cache", paths["corpus"], "--out", paths["out"]])
    except SystemExit as e:
        assert "ORDERING FAILED" in str(e), e
    with open(paths["out"]) as f:
        return paths, json.load(f)


def test_repro_paper_twin_table(repro_run):
    """Every row with a recall curve to r@20, SLSQ's l0 within S and SLSQ1's
    below dense, the torch device as the platform, the corpus cache's keys."""
    paths, table = repro_run
    assert table["platform"] == "cpu" and table["bits"] == 64
    rows = table["methods"]
    for name in ROWS:
        assert name in rows, (name, sorted(rows))
        rec = [rows[name]["recall"][f"r@{n}"] for n in (1, 2, 5, 10, 20)]
        assert (np.diff(rec) >= 0).all(), (name, rec)
    for name in ("SLSQ1", "SLSQ2"):
        assert 0 < rows[name]["l0"] <= rows[name]["S"]
    assert rows["SLSQ1"]["l0"] < rows["SLSQ1"]["dense_l0"]
    with np.load(paths["corpus"]) as z:
        assert sorted(z.files) == ["base", "gt", "query", "seed", "train"]
        assert z["train"].shape == (600, 128) and int(z["seed"]) == 0


def test_repro_paper_twin_stage_cache_resumes_in_jax(repro_run, tmp_path, monkeypatch):
    """Every stage file loads with the JAX package's checkpoint.load_model,
    and the JAX script, run on the twin's stage and corpus caches, hits
    every stage and writes the same recall and train_mse for every row."""
    from local_search_quantization_tpu.utils import checkpoint as jckpt

    paths, table = repro_run
    for stage in STAGES:
        model = jckpt.load_model(os.path.join(paths["stages"], stage + ".npz"))
        assert np.asarray(model.B).shape == (600, 8 if stage in ("pq", "opq") else 7)
    out = str(tmp_path / "jax.json")
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    monkeypatch.setattr(sys, "argv", ["repro_paper.py"] + REPRO + [
        "--scan-mode", "gather", "--stage-cache", paths["stages"],
        "--corpus-cache", paths["corpus"], "--out", out])
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "repro_paper.py"), run_name="__main__")
    except SystemExit as e:
        assert "ORDERING FAILED" in str(e), e
    with open(out) as f:
        jtable = json.load(f)
    for name in ROWS:
        for key in ("recall", "train_mse"):
            assert jtable["methods"][name][key] == table["methods"][name][key], (name, key)


def test_repro_paper_twin_runs_as_a_file_from_outside_the_repo(repro_run, tmp_path):
    """The twin as a plain file from another directory resumes its own
    caches (every stage a hit) to the same table."""
    paths, table = repro_run
    out = str(tmp_path / "again.json")
    script = os.path.join(ROOT, "local_search_quantization_torch", "scripts",
                          "repro_paper.py")
    proc = subprocess.run(
        [sys.executable, script, *REPRO, "--device", "cpu", "--stage-cache",
         paths["stages"], "--corpus-cache", paths["corpus"], "--out", out],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0 or "ORDERING FAILED" in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout.count("stage-cache hit") == len(STAGES) + 4  # + 4 code files
    with open(out) as f:
        again = json.load(f)
    assert again["methods"] == {k: dict(v, wall_s=again["methods"][k]["wall_s"])
                                for k, v in table["methods"].items()}


def test_diag_normbyte_twin_on_the_repro_cache(repro_run):
    """Both scans of the LSQ milestone's codes: the quantized-norm scan is
    the twin's own LSQ-2 row, recall curves never fall."""
    paths, table = repro_run
    out = diag_normbyte.main([paths["stages"], paths["corpus"], "--device", "cpu"])
    q = out["quantized(norm byte)"]
    assert q["r@1"] == table["methods"]["LSQ-2"]["recall"]["r@1"]
    assert q["r@10"] == table["methods"]["LSQ-2"]["recall"]["r@10"]
    for rec in out.values():
        vals = [rec[f"r@{n}"] for n in (1, 2, 5, 10, 100)]
        assert (np.diff(vals) >= 0).all(), rec


def test_calibrate_corpus_twin():
    (res,) = calibrate_corpus.main(["0.4", "--ntrain", "600", "--nbase", "2000",
                                    "--nquery", "40", "--niter", "2", "--d", "16",
                                    "--device", "cpu"])
    for name in ("PQ", "OPQ", "LSQ", "LSQ+normbyte"):
        vals = [res[name][f"r@{n}"] for n in (1, 10, 100)]
        assert (np.diff(vals) >= 0).all() and vals[-1] > 0.5, (name, vals)
    assert res["mse"]["lsq"] > 0


def test_diag_flip_twin_positional_sizes():
    out = diag_flip.main(["600", "2000", "40", "2", "--device", "cpu"])
    assert set(out) == {"OPQ oracle", "LSQ oracle", "LSQ ADC exact norms",
                        "LSQ ADC quantized norms"}
    # The ADC ranking with exact norms is the oracle ranking.
    assert out["LSQ ADC exact norms"] == out["LSQ oracle"]
    for rec in out.values():
        assert rec["r@1"] <= rec["r@10"] <= rec["r@100"]


NO_DEVICE = {
    "demo_pq_torch": lambda: demo_pq_torch.main(DEMO),
    "demo_opq_torch": lambda: demo_opq_torch.main(DEMO),
    "demo_chainq_torch": lambda: demo_chainq_torch.main(DEMO),
    "demo_lsq_sparse_torch": lambda: demo_lsq_sparse_torch.main(SPARSE),
    "repro_paper": lambda: repro_paper.main(REPRO),
    "diag_normbyte": lambda: diag_normbyte.main(["no-such-cache", "no-such-corpus.npz"]),
    "calibrate_corpus": lambda: calibrate_corpus.main(["0.4"]),
    "diag_flip": lambda: diag_flip.main(["600", "2000", "40", "2"]),
}


@pytest.mark.parametrize("twin", sorted(NO_DEVICE))
def test_twin_needs_a_gpu_unless_asked_for_the_cpu(twin, monkeypatch, tmp_path):
    """Without --device, no CUDA device: entry_device's error before any
    work (no data read, nothing written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NO_DEVICE[twin]()
    assert os.listdir(tmp_path) == []
