"""The port's whole LSQ slice (train -> encode -> norms -> search -> recall)
against the JAX package's, the demo on the CPU, and the port's independence
from JAX."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.models.lsq import train_lsq as jtrain_lsq
from local_search_quantization_tpu.ops import adc as jadc
from local_search_quantization_tpu.ops import icm as jicm
from local_search_quantization_tpu.ops import norms as jnorms
from local_search_quantization_torch.models.lsq import train_lsq
from local_search_quantization_torch.ops import adc, icm, norms
from local_search_quantization_torch.utils.config import LSQConfig
from local_search_quantization_torch.utils.eval import eval_recall
from local_search_quantization_torch.utils.synth import random_codes, synthetic_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_BASE, N_QUERY, D, M, H, K = 1500, 4000, 100, 32, 4, 32, 100


@pytest.fixture(scope="module")
def slices():
    """Both packages' slice on the same corpus and initial codes."""
    data = synthetic_dataset(0, d=D, n_train=N_TRAIN, n_base=N_BASE, n_query=N_QUERY)
    cfg = LSQConfig(m=M, h=H, niter=4, ilsiter=4, icmiter=2, npert=2)
    B0 = random_codes(0, N_TRAIN, M, H)
    Bb0 = random_codes(1, N_BASE, M, H)

    model = train_lsq(torch.as_tensor(data.train), B0, torch.eye(D), cfg,
                      generator=torch.Generator().manual_seed(0))
    enc = icm.encode_chunked(torch.Generator().manual_seed(1), data.base, Bb0, model.C,
                             ilsiter=6, icmiter=2, npert=2, chunk=1024, milestones=(6,))
    codes = norms.quantize_norms(enc.B, model.C, model.cbnorms)
    res = adc.linscan_lsq(enc.B, torch.as_tensor(data.query), model.C,
                          model.cbnorms[codes.long()], k=K)
    port = dict(obj=model.obj, base=float(enc.cost.mean()),
                recall=eval_recall(data.gt, res.ids.numpy(), K, verbose=False),
                res=res)

    jm = jtrain_lsq(jnp.asarray(data.train), jnp.asarray(B0), jnp.eye(D), cfg,
                    key=jax.random.PRNGKey(0))
    jenc = jicm.encode_chunked(jax.random.PRNGKey(1), data.base, Bb0, jm.C, ilsiter=6,
                               icmiter=2, npert=2, chunk=1024, milestones=(6,))
    jcodes = np.asarray(jnorms.quantize_norms(jenc.B, jm.C, jm.cbnorms))
    jres = jadc.linscan_lsq(jenc.B, data.query, jm.C, np.asarray(jm.cbnorms)[jcodes],
                            k=K, topk_method="exact")
    ref = dict(obj=jm.obj, base=float(np.mean(jenc.cost)),
               recall=eval_recall(data.gt, np.asarray(jres.ids), K, verbose=False))
    return port, ref


def test_slice_objective_trace_tracks_jax(slices):
    """Each iteration's training objective within 5% of JAX's: the two
    differ only in their random streams (perturbations, visit orders)."""
    port, ref = slices
    assert port["obj"].shape == ref["obj"].shape
    np.testing.assert_allclose(port["obj"], ref["obj"], rtol=0.05)
    assert port["obj"][-1] < port["obj"][0]


def test_slice_base_cost_tracks_jax(slices):
    port, ref = slices
    assert abs(port["base"] - ref["base"]) <= 0.04 * ref["base"]


def test_slice_recall_tracks_jax(slices):
    """recall@10 within 0.08 of JAX's on 100 queries (a recall difference
    of 8 queries), and both curves non-decreasing to a high recall@100."""
    port, ref = slices
    assert abs(port["recall"][9] - ref["recall"][9]) <= 0.08
    assert (np.diff(port["recall"]) >= 0).all() and port["recall"][K - 1] >= 0.9
    res = port["res"]
    assert res.ids.shape == (N_QUERY, K) and res.ids.dtype == torch.int32
    assert (res.dists.diff(dim=1) >= 0).all()


def test_demo_runs_on_cpu(tmp_path):
    """demos/demo_lsq_torch.py end to end at a tiny size, with --save-model
    and then --load-model of what it saved."""
    model = os.path.join(tmp_path, "m.npz")
    base = [sys.executable, os.path.join(ROOT, "demos", "demo_lsq_torch.py"),
            "--dataset", "synthetic", "--ntrain", "600", "--nbase", "1500",
            "--nquery", "30", "--m", "4", "--h", "16", "--niter", "2",
            "--milestones", "2,4", "--knn", "50", "--synth-d", "16", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(base + ["--save-model", model], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "=== LSQ-4" in out.stdout and "r@50 = " in out.stdout
    out = subprocess.run(base + ["--load-model", model], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Loaded LSQ model" in out.stdout and "=== LSQ-2" in out.stdout


def test_port_imports_with_jax_blocked():
    """Every module of the port, the demo and chip_smoke.py import with jax
    (and the JAX package) made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['local_search_quantization_tpu'] = None\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'demos')!r}]\n"
        "import local_search_quantization_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import demo_lsq_torch, chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    """No CUDA device (as here), or no repository beside the script: a
    non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), shutil.copy(os.path.join(ROOT, "chip_smoke.py"),
                                                    tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
