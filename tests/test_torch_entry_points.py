"""The port's entry points run on the GPU unless the caller asks for the CPU.

Without a CUDA device, `Index.build`, `Index.load`, `checkpoint.load_model`
and the demo raise a clear error instead of running on the CPU unasked;
`device="cpu"` (the demo's `--device cpu`) runs them here. `torch.cuda.is_available` is patched
to False, so the tests hold on a machine with a GPU too.
"""

import os
import sys

import numpy as np
import pytest
import torch

from local_search_quantization_torch.index import Index

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = dict(m=2, h=8, niter=2, seed=0)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(300, 8)).astype(np.float32),
            rng.normal(size=(500, 8)).astype(np.float32))


def test_index_build_needs_a_gpu_unless_asked_for_the_cpu(no_gpu):
    xt, xb = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.build(xt, xb, "pq", **BUILD)
    idx = Index.build(xt, xb, "pq", device="cpu", **BUILD)
    assert idx.device.type == "cpu" and idx.n == 500


def test_index_load_needs_a_gpu_unless_asked_for_the_cpu(no_gpu, tmp_path):
    xt, xb = _data()
    Index.build(xt, xb, "pq", device="cpu", **BUILD).save(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.load(str(tmp_path))
    idx = Index.load(str(tmp_path), device="cpu")
    assert idx.device.type == "cpu" and idx.search(xb[:3], k=5).ids.shape == (3, 5)


def test_load_model_needs_a_gpu_unless_asked_for_the_cpu(no_gpu, tmp_path):
    from local_search_quantization_torch.utils import checkpoint as ckpt

    xt, xb = _data()
    path = str(tmp_path / "model.npz")
    ckpt.save_model(path, Index.build(xt, xb, "pq", device="cpu", **BUILD).model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.load_model(path)
    model = ckpt.load_model(path, device="cpu")
    assert model.C_sub.device.type == "cpu"


def test_demo_needs_a_gpu_unless_asked_for_the_cpu(no_gpu):
    sys.path[:0] = [ROOT, os.path.join(ROOT, "demos")]
    try:
        import demo_lsq_torch as demo
    finally:
        del sys.path[:2]
    argv = ["--dataset", "synthetic", "--ntrain", "300", "--nbase", "400",
            "--nquery", "5", "--m", "4", "--h", "8", "--niter", "1",
            "--milestones", "1", "--knn", "10", "--synth-d", "8"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.run(demo.parse_args(argv))
    out = demo.run(demo.parse_args(argv + ["--device", "cpu"]))
    assert out["model"].C.device.type == "cpu"
