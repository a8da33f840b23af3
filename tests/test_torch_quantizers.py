"""The rest of the port's quantizer family held to the JAX package: the
batched LSQR codebook solver, the L1-constrained prox solver, sparse LSQ and
RVQ, and their model files.

Given randomness (codes, data, codebooks) goes through both packages from
the same numpy arrays; the trainers draw from their own streams
(torch.Generator against jax.random), so their results are held by
invariants and by a band around JAX's objective.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.models import rvq as jrvq
from local_search_quantization_tpu.models import slsq as jslsq
from local_search_quantization_tpu.models.pq import train_pq as jtrain_pq
from local_search_quantization_tpu.ops import costs as jcosts
from local_search_quantization_tpu.ops import prox as jprox
from local_search_quantization_tpu.ops import solver as jsolver
from local_search_quantization_tpu.utils import checkpoint as jckpt
from local_search_quantization_tpu.utils.config import PQConfig as JPQConfig
from local_search_quantization_tpu.utils.config import RVQConfig as JRVQConfig
from local_search_quantization_tpu.utils.config import SLSQConfig as JSLSQConfig
from local_search_quantization_torch.models import (
    RVQModel,
    SLSQModel,
    quantize_rvq,
    train_lsq_sparse,
    train_pq,
    train_rvq,
)
from local_search_quantization_torch.ops import costs, prox, solver
from local_search_quantization_torch.utils import checkpoint as tckpt
from local_search_quantization_torch.utils.config import PQConfig, RVQConfig, SLSQConfig
from local_search_quantization_torch.utils.synth import synthetic_dataset

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _problem(n=500, d=6, m=3, h=8, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return X, B


def _dense_design(B, h):
    n, m = B.shape
    A = np.zeros((n, m * h), np.float32)
    for i in range(m):
        A[np.arange(n), i * h + B[:, i]] = 1.0
    return A


# --- batched LSQR -----------------------------------------------------------


def test_A_matvec_matches_jax():
    """The additive reconstruction: rtol 1e-6 (m adds of the same rows)."""
    X, B = _problem(m=4, h=16, d=9)
    V = np.random.default_rng(1).normal(size=(4, 16, 9)).astype(np.float32)
    got = solver._A_matvec(_t(V), _t(B)).numpy()
    want = np.asarray(jsolver._A_matvec(jnp.asarray(V), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_At_matvec_matches_jax_on_a_ragged_n():
    """A^T U over n = 8192 + 1001 rows (a partial last chunk): rtol 1e-5."""
    X, B = _problem(n=(1 << 13) + 1001, m=4, h=16, d=5)
    got = solver._At_matvec(_t(X), _t(B), 16).numpy()
    want = np.asarray(jsolver._At_matvec(jnp.asarray(X), jnp.asarray(B), 16))
    assert got.shape == (4, 16, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    small = solver._At_matvec(_t(X), _t(B), 16, chunk=100).numpy()
    np.testing.assert_allclose(small, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_solve_lsqr_matches_jax_and_lstsq():
    """Same B and X, 32 steps: K within 1e-3 of max|K| of JAX's, the
    residual ||A K - X|| within rtol 1e-4 of JAX's, and within rtol 1e-3 of
    numpy's lstsq (tests/test_viterbi_solver.py's check)."""
    X, B = _problem(n=300, d=5, m=3, h=4)
    Kj = np.asarray(jsolver._solve_lsqr(jnp.asarray(B), jnp.asarray(X), 4, 32))
    Kt = solver._solve_lsqr(_t(B), _t(X), 4, 32).numpy()
    np.testing.assert_allclose(Kt, Kj, rtol=0, atol=1e-3 * np.abs(Kj).max())
    A = _dense_design(B, 4)
    r_t = np.linalg.norm(A @ Kt.reshape(12, 5) - X)
    r_j = np.linalg.norm(A @ Kj.reshape(12, 5) - X)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4)
    K, *_ = np.linalg.lstsq(A, X, rcond=None)
    np.testing.assert_allclose(r_t, np.linalg.norm(A @ K - X), rtol=1e-3)


def test_update_codebooks_lsqr_at_training_width():
    """m=4, h=16 through update_codebooks: the residual within rtol 1e-4 of
    JAX's LSQR and no worse than 1e-3 above the Cholesky solve's; "lsmr" is
    "lsqr"; a solve is bit-identical when repeated."""
    X, B = _problem(n=2000, d=12, m=4, h=16)
    Ct = solver.update_codebooks(_t(X), _t(B), 16, method="lsqr")
    Cj = np.asarray(jsolver.update_codebooks(jnp.asarray(X), jnp.asarray(B), 16,
                                             method="lsqr"))
    e_t = float(costs.qerror(_t(X), _t(B), Ct))
    e_j = float(jcosts.qerror(jnp.asarray(X), jnp.asarray(B), jnp.asarray(Cj)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4)
    e_c = float(costs.qerror(_t(X), _t(B), solver.update_codebooks(_t(X), _t(B), 16)))
    assert e_t <= e_c * (1 + 1e-3)
    assert torch.equal(Ct, solver.update_codebooks(_t(X), _t(B), 16, method="lsmr"))
    assert torch.equal(Ct, solver.update_codebooks(_t(X), _t(B), 16, method="lsqr"))
    with pytest.raises(ValueError, match="unknown codebook update method"):
        solver.update_codebooks(_t(X), _t(B), 16, method="qr")


# --- the prox solver --------------------------------------------------------


@pytest.mark.parametrize("tau", [0.5, 2.0, 100.0])
def test_project_l1_ball_matches_jax(tau):
    """Inside the ball (tau=100) K itself, bit for bit; outside, JAX's
    projection within 1e-6 of max|K| (cumsums in another order), on the ball."""
    v = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32)
    got = prox.project_l1_ball(_t(v), tau).numpy()
    want = np.asarray(jprox.project_l1_ball(jnp.asarray(v), jnp.float32(tau)))
    if np.abs(v).sum() <= tau:
        np.testing.assert_array_equal(got, v)
    else:
        np.testing.assert_allclose(np.abs(got).sum(), tau, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(v).max())


def test_inclusive_scan_is_a_cumulative_sum():
    """The projection's fixed-order scan against float64 cumsum (rtol 1e-5)
    at a few lengths, a power of two among them."""
    rng = np.random.default_rng(6)
    for n in (1, 2, 7, 1 << 12, 100_003):
        v = np.abs(rng.normal(size=n)).astype(np.float32)
        got = prox._inclusive_scan(_t(v)).numpy()
        np.testing.assert_allclose(got, np.cumsum(v.astype(np.float64)), rtol=1e-5)


def test_estimate_lipschitz_matches_jax():
    """12 power steps on A^T A: rtol 1e-5."""
    _, B = _problem(n=700, m=3, h=8)
    got = float(prox.estimate_lipschitz(_t(B), 8))
    want = float(jprox.estimate_lipschitz(jnp.asarray(B), 8))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("lr", [None, 2e-3])
def test_solve_l1_constrained_matches_jax(lr):
    """Same B, X, tau and warm start, 60 FISTA steps: within 1e-4 of
    max|K| of JAX's, and inside the ball."""
    X, B = _problem(n=400, d=5, m=3, h=8)
    K0 = np.random.default_rng(4).normal(size=(3, 8, 5)).astype(np.float32)
    tau = np.float32(0.5 * np.abs(K0).sum())
    got = prox.solve_l1_constrained(_t(B), _t(X), 8, tau, _t(K0), iters=60, lr=lr).numpy()
    want = np.asarray(jprox.solve_l1_constrained(jnp.asarray(B), jnp.asarray(X), 8,
                                                 jnp.float32(tau), jnp.asarray(K0),
                                                 iters=60, lr=lr))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(got).sum() <= tau * (1 + 1e-5)


def test_threshold_top_s_matches_jax_with_ties_at_the_cutoff():
    """Identical, also where values tie at the S-th largest |K| (every tie
    stays, as in JAX: S + 2 entries survive S = 5), and S >= size keeps K."""
    K = np.random.default_rng(5).normal(size=(3, 4, 5)).astype(np.float32)
    for S in (1, 7, 59, 60, 100):
        got = prox.threshold_top_s(_t(K), S).numpy()
        np.testing.assert_array_equal(got, np.asarray(jprox.threshold_top_s(jnp.asarray(K), S)))
    T = np.zeros((2, 3, 4), np.float32)
    T.flat[:8] = [5.0, -4.0, 3.0, 2.0, -2.0, 2.0, 1.0, 0.5]
    got = prox.threshold_top_s(_t(T), 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jprox.threshold_top_s(jnp.asarray(T), 5)))
    assert (got != 0).sum() == 6  # 5, -4, 3 and the three tied 2s


# --- RVQ --------------------------------------------------------------------


def _rvq_data():
    rng = np.random.default_rng(42)
    return (rng.normal(size=(2500, 24)) * 3).astype(np.float32)


def test_quantize_rvq_on_jax_codebooks_is_identical():
    """JAX's trained C carried across with the checkpoint conversion: the
    port encodes the training set to JAX's training codes, and a fresh set
    to JAX's codes, both identical."""
    X = _rvq_data()
    jm = jrvq.train_rvq(X, JRVQConfig(m=4, h=32, seed=1))
    tm = tckpt.model_from_numpy("RVQModel", jm._asdict())
    np.testing.assert_array_equal(quantize_rvq(_t(X), tm.C).numpy(), np.asarray(jm.B))
    Y = (np.random.default_rng(7).normal(size=(300, 24)) * 3).astype(np.float32)
    np.testing.assert_array_equal(quantize_rvq(_t(Y), tm.C).numpy(),
                                  np.asarray(jrvq.quantize_rvq(Y, jm.C)))


def test_train_rvq_invariants_and_band():
    """Every stage lowers the residual; quantize_rvq on the training set
    gives the training codes; the traced objective is qerror of the codes
    (rtol 1e-5); the final objective within 3% of JAX's (other k-means++
    draws)."""
    X = _rvq_data()
    tm = train_rvq(_t(X), RVQConfig(m=4, h=32, seed=1))
    assert (np.diff(tm.obj) < 0).all(), tm.obj
    assert tm.B.dtype == torch.int32 and tuple(tm.B.shape) == (2500, 4)
    assert torch.equal(quantize_rvq(_t(X), tm.C), tm.B)
    np.testing.assert_allclose(float(costs.qerror(_t(X), tm.B, tm.C)), tm.obj[-1], rtol=1e-5)
    jm = jrvq.train_rvq(X, JRVQConfig(m=4, h=32, seed=1))
    np.testing.assert_allclose(tm.obj[-1], np.asarray(jm.obj)[-1], rtol=0.03)


# --- sparse LSQ -------------------------------------------------------------


@pytest.fixture(scope="module")
def slsq_setup():
    data = synthetic_dataset(1, d=16, n_train=800, n_base=100, n_query=10)
    cfg = dict(m=4, h=16, niter=3, ilsiter=2, icmiter=2, npert=1, prox_iters=50,
               S=8 * 16, seed=0)
    return data, cfg


def test_train_lsq_sparse_invariants_and_band(slsq_setup):
    """From the port's own PQ init: l0 <= S, l1 <= tau (1 + 1e-5) at every
    iteration, the objective never 5% above its first value (JAX's test),
    valid codes, and the final objective within 15% of JAX's from JAX's
    PQ init (other PQ centers and ILS draws)."""
    data, kw = slsq_setup
    cfg = SLSQConfig(**kw)
    pq = train_pq(_t(data.train), PQConfig(m=4, h=16, seed=0))
    R = np.eye(16, dtype=np.float32)
    model = train_lsq_sparse(_t(data.train), pq.B, pq.C_sub, R, cfg)
    C0 = torch.zeros((4, 16, 16))
    for i, (a, b) in enumerate(((0, 4), (4, 8), (8, 12), (12, 16))):
        C0[i, :, a:b] = pq.C_sub[i, :, :b - a]
    tau = float(torch.sum(torch.abs(C0))) * 0.7
    assert (model.l0 <= cfg.S).all() and (model.l1 <= tau * (1 + 1e-5)).all()
    assert np.isfinite(model.obj).all() and model.obj[-1] <= model.obj[0] * 1.05
    assert model.B.dtype == torch.int32 and int(model.B.max()) < 16
    assert int(torch.sum(model.C != 0)) == int(model.l0[-1])
    jpq = jtrain_pq(data.train, JPQConfig(m=4, h=16, seed=0))
    jm = jslsq.train_lsq_sparse(data.train, jpq.B, jpq.C_sub, R, JSLSQConfig(**kw))
    np.testing.assert_allclose(model.obj[-1], np.asarray(jm.obj)[-1], rtol=0.15)


def test_train_lsq_sparse_from_jax_init_tracks_jax(slsq_setup):
    """Both packages from JAX's PQ init with no ILS round (ilsiter=0: the
    codes stay the init's, so no random stream enters): every objective,
    l0 and l1 within rtol 1e-3 of JAX's."""
    data, kw = slsq_setup
    kw = dict(kw, ilsiter=0)
    jpq = jtrain_pq(data.train, JPQConfig(m=4, h=16, seed=0))
    R = np.eye(16, dtype=np.float32)
    jm = jslsq.train_lsq_sparse(data.train, jpq.B, jpq.C_sub, R, JSLSQConfig(**kw))
    tm = train_lsq_sparse(_t(data.train), _t(jpq.B), _t(jpq.C_sub), R, SLSQConfig(**kw))
    np.testing.assert_allclose(tm.obj, np.asarray(jm.obj), rtol=1e-3)
    np.testing.assert_allclose(tm.l0, np.asarray(jm.l0), rtol=1e-3)
    np.testing.assert_allclose(tm.l1, np.asarray(jm.l1), rtol=1e-3)


# --- model files ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_models(slsq_setup):
    data, kw = slsq_setup
    jpq = jtrain_pq(data.train, JPQConfig(m=4, h=16, seed=0))
    sl = jslsq.train_lsq_sparse(data.train, jpq.B, jpq.C_sub,
                                np.eye(16, dtype=np.float32), JSLSQConfig(**dict(kw, niter=1)))
    return {"RVQModel": jrvq.train_rvq(_rvq_data(), JRVQConfig(m=3, h=16, seed=0)),
            "SLSQModel": sl}


@pytest.mark.parametrize("name", ["RVQModel", "SLSQModel"])
def test_model_files_cross_load_both_ways(name, jax_models, tmp_path):
    """A JAX-written file loads in the port (traces stay host float32), and
    the port's save of it loads in JAX with every field's dtype and value."""
    jm = jax_models[name]
    jpath = os.path.join(tmp_path, "jax.npz")
    jckpt.save_model(jpath, jm)
    tm = tckpt.load_model(jpath, device="cpu")
    assert type(tm) is {"RVQModel": RVQModel, "SLSQModel": SLSQModel}[name]
    for f in tm._fields:
        v = getattr(tm, f)
        if f in ("obj", "l0", "l1"):
            assert isinstance(v, np.ndarray) and v.dtype == np.float32, f
        else:
            assert isinstance(v, torch.Tensor), f
        np.testing.assert_array_equal(np.asarray(v), np.asarray(getattr(jm, f)))
    tpath = os.path.join(tmp_path, "port.npz")
    tckpt.save_model(tpath, tm)
    back = jckpt.load_model(tpath)
    assert type(back).__name__ == name
    for f in jm._fields:
        a, b = np.asarray(getattr(back, f)), np.asarray(getattr(jm, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
