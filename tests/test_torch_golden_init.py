"""Why the port's LSQ recall@1 sits below JAX's on the golden gates.

`test_torch_golden.py` pins the port's LSQ recall@1 0.04-0.06 below JAX's,
with its LSQ objectives ~1.2% above JAX's (9995 against 9876 in training).
The two packages draw OPQ's initial centers from different random streams
(torch.Generator, jax.random), so they start ChainQ and LSQ from different
codes. This test gives both packages the same start: JAX's `train_opq` on
the golden corpus, its (B, R) handed as numpy to each package's
`train_chainq` -> `train_lsq` (m=7, h=64, niter=6, as the golden gates).

Result: the gap closes. ChainQ is deterministic and agrees to float32
rounding (objectives within 1e-5 relative, codes identical); LSQ draws its
ILS perturbations from each package's own stream, and every stage's
objective lands within 0.3% of JAX's (0.08% at the end where the port's own
init leaves 1.2%). So the init explains the pinned gap; no stage drifts.

The same holds for RVQ's pinned recall@10: given JAX's k-means++ draws for
each stage, the port's `train_rvq` reproduces JAX's stage objectives to
float32 rounding and JAX's golden recall.
"""

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest
import torch

import test_golden_recall as golden
from local_search_quantization_torch.models import rvq as torch_rvq
from local_search_quantization_torch.models import train_chainq, train_lsq
from local_search_quantization_torch.ops import adc, norms
from local_search_quantization_torch.ops import kmeans as torch_kmeans
from local_search_quantization_torch.utils.config import RVQConfig
from local_search_quantization_torch.utils.config import ChainQConfig, LSQConfig
from local_search_quantization_tpu.models import train_chainq as jax_train_chainq
from local_search_quantization_tpu.models import train_lsq as jax_train_lsq
from local_search_quantization_tpu.models import train_opq as jax_train_opq
from local_search_quantization_tpu.models import train_rvq as jax_train_rvq
from local_search_quantization_tpu.ops import kmeans as jax_kmeans
from local_search_quantization_tpu.utils.config import ChainQConfig as JaxChainQConfig
from local_search_quantization_tpu.utils.config import LSQConfig as JaxLSQConfig
from local_search_quantization_tpu.utils.config import OPQConfig as JaxOPQConfig
from local_search_quantization_tpu.utils.config import RVQConfig as JaxRVQConfig

torch.set_num_threads(2)

M, H, NITER = 7, 64, 6
CHAINQ_RTOL = 1e-5  # deterministic on both sides: float32 rounding only
LSQ_RTOL = 3e-3  # each package's own ILS random stream


@pytest.fixture(scope="module")
def chains():
    data = golden.data.__wrapped__()
    X = data.train
    opq = jax_train_opq(X, JaxOPQConfig(m=M, h=H, niter=NITER, seed=0))
    B0, R0 = np.array(opq.B), np.array(opq.R)  # writable copies for torch
    jc = jax_train_chainq(X, B0, R0, JaxChainQConfig(m=M, h=H, niter=NITER))
    tc = train_chainq(torch.as_tensor(X), torch.as_tensor(B0), torch.as_tensor(R0),
                      ChainQConfig(m=M, h=H, niter=NITER))
    return X, jc, tc


def test_chainq_from_jax_opq_init_matches_jax(chains):
    _, jc, tc = chains
    np.testing.assert_allclose(tc.obj, np.asarray(jc.obj), rtol=CHAINQ_RTOL)
    np.testing.assert_array_equal(tc.B.numpy(), np.asarray(jc.B))


def test_lsq_from_jax_opq_init_closes_the_objective_gap(chains):
    """Each package's LSQ from its own ChainQ of the shared init: the JAX
    trainer in its golden condition mode ("auto", the gather path on the
    CPU), the port in the mode of its pins ("kernel", K1's plain version)."""
    X, jc, tc = chains
    jl = jax_train_lsq(X, np.asarray(jc.B), np.asarray(jc.R),
                       JaxLSQConfig(m=M, h=H, niter=NITER, seed=0))
    tl = train_lsq(torch.as_tensor(X), tc.B, tc.R,
                   LSQConfig(m=M, h=H, niter=NITER, seed=0, condition_mode="kernel"))
    want = np.asarray(jl.obj)
    assert tl.obj.shape == want.shape
    np.testing.assert_allclose(tl.obj, want, rtol=LSQ_RTOL)
    assert tl.obj[-1] < tl.obj[0]


def test_rvq_from_jax_kmeanspp_draws_matches_jax(monkeypatch):
    """The port's `train_rvq` with each stage's k-means++ centers drawn by
    JAX (the key chain of JAX's train_rvq, on the port's residual): stage
    objectives within CHAINQ_RTOL of JAX's, and recall@1/10/100 on the golden
    gate within the band of JAX's golden values, with no pin."""
    import jax.numpy as jnp

    data = golden.data.__wrapped__()
    jm = jax_train_rvq(data.train, JaxRVQConfig(m=M, h=H, kmeans_maxiter=30, seed=0))
    key = jax.random.PRNGKey(0)

    def kmeans_from_jax_draws(gen, X, k, *, maxiter):
        nonlocal key
        key, sub = jax.random.split(key)
        c0 = np.array(jax_kmeans.kmeans_pp_init(sub, jnp.asarray(X.numpy()), k))
        return torch_kmeans.kmeans(None, X, k, maxiter=maxiter, centers=torch.as_tensor(c0))

    monkeypatch.setattr(torch_rvq, "kmeans", kmeans_from_jax_draws)
    tm = torch_rvq.train_rvq(torch.as_tensor(data.train),
                             RVQConfig(m=M, h=H, kmeans_maxiter=30, seed=0))
    np.testing.assert_allclose(tm.obj, np.asarray(jm.obj), rtol=CHAINQ_RTOL)
    B = torch_rvq.quantize_rvq(torch.as_tensor(data.base), tm.C)
    bn = norms.quantize_norms(B, tm.C, tm.cbnorms)
    res = adc.linscan_lsq(B, torch.as_tensor(data.query), tm.C, tm.cbnorms[bn.long()],
                          k=100)
    rec = golden.recall_at(data.gt, res.ids.numpy())
    for n, want in golden.GOLDEN["RVQ"].items():
        assert abs(rec[n] - want) <= golden.BAND, (n, rec[n], want)
