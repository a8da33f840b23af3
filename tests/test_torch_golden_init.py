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
"""

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest
import torch

import test_golden_recall as golden
from local_search_quantization_torch.models import train_chainq, train_lsq
from local_search_quantization_torch.utils.config import ChainQConfig, LSQConfig
from local_search_quantization_tpu.models import train_chainq as jax_train_chainq
from local_search_quantization_tpu.models import train_lsq as jax_train_lsq
from local_search_quantization_tpu.models import train_opq as jax_train_opq
from local_search_quantization_tpu.utils.config import ChainQConfig as JaxChainQConfig
from local_search_quantization_tpu.utils.config import LSQConfig as JaxLSQConfig
from local_search_quantization_tpu.utils.config import OPQConfig as JaxOPQConfig

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
