"""The PyTorch port's codebook solver, norm quantizer, LSQ trainer and
checkpoints, held to the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.models.lsq import train_lsq as jtrain_lsq
from local_search_quantization_tpu.ops import icm as jicm
from local_search_quantization_tpu.ops import norms as jnorms
from local_search_quantization_tpu.ops import solver as jsolver
from local_search_quantization_tpu.utils import checkpoint as jckpt
from local_search_quantization_torch.models.lsq import LSQModel, train_lsq
from local_search_quantization_torch.ops import icm as ticm
from local_search_quantization_torch.ops import norms as tnorms
from local_search_quantization_torch.ops import solver as tsolver
from local_search_quantization_torch.utils import checkpoint as tckpt
from local_search_quantization_torch.utils.config import LSQConfig
from local_search_quantization_torch.utils.synth import random_codes, synthetic_dataset

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _data(n=600, d=16, m=4, h=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) * 3.0
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return X, B


def test_update_codebooks_matches_jax_cholesky():
    """Same B and X: C within rtol 1e-3 (two Cholesky solves of one ridge
    system in f32, different factorization order)."""
    X, B = _data()
    Cj = np.asarray(jsolver.update_codebooks(jnp.asarray(X), jnp.asarray(B), 16))
    Ct = tsolver.update_codebooks(_t(X), _t(B), 16).numpy()
    np.testing.assert_allclose(Ct, Cj, rtol=1e-3, atol=1e-3 * np.abs(Cj).max())
    G, AtX = tsolver.code_gram(_t(B), _t(X), 16, chunk=128)
    Gj, AtXj = jsolver.code_gram(jnp.asarray(B), jnp.asarray(X), 16, chunk=128)
    np.testing.assert_array_equal(G.numpy(), np.asarray(Gj))
    np.testing.assert_allclose(AtX.numpy(), np.asarray(AtXj), rtol=1e-5, atol=1e-4)


def test_update_codebooks_lsqr_is_not_ported_yet():
    X, B = _data(n=50)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolver.update_codebooks(_t(X), _t(B), 16, method="lsqr")
    with pytest.raises(ValueError):
        tsolver.update_codebooks(_t(X), _t(B), 16, method="qr")


def test_norms_match_jax():
    """Norm codebook within f32 ulps (host f64 k-means, same seed, over
    squared norms that are summed in another order), and identical norm
    codes from the same codebook; quantize_norms returns one type: an
    int32 tensor on C's device, whether or not it is chunked."""
    X, B = _data(n=3000, h=32)
    C = tsolver.update_codebooks(_t(X), _t(B), 32)
    Cj = jnp.asarray(C.numpy())
    np.testing.assert_allclose(tnorms.reconstruction_sqnorms(_t(B), C).numpy(),
                               np.asarray(jnorms.reconstruction_sqnorms(jnp.asarray(B), Cj)),
                               rtol=1e-6)
    cb_t, codes_t = tnorms.train_norm_codebook(_t(B), C, 32)
    cb_j, codes_j = jnorms.train_norm_codebook(None, jnp.asarray(B), Cj, 32)
    np.testing.assert_allclose(cb_t.numpy(), np.asarray(cb_j), rtol=1e-6)
    assert (codes_t.numpy() != np.asarray(codes_j)).mean() <= 1e-3
    for block in (1 << 16, 1000):
        q_t = tnorms.quantize_norms(_t(B), C, _t(cb_j), block=block)
        q_j = np.asarray(jnorms.quantize_norms(jnp.asarray(B), Cj, cb_j, block=block))
        assert isinstance(q_t, torch.Tensor) and q_t.dtype == torch.int32
        np.testing.assert_array_equal(q_t.numpy(), q_j)


@pytest.mark.parametrize("sr", ["none", "SR-D", "SR-C"])
def test_train_lsq_tracks_jax_objective(sr):
    """From random codes and R = I: the objective trace falls, and its last
    value lands within 4% of the JAX trainer's (different random streams).
    The model's fields have the JAX model's names and dtypes."""
    d = synthetic_dataset(0, d=16, n_train=800, n_base=10, n_query=2)
    cfg = LSQConfig(m=4, h=16, niter=4, ilsiter=3, icmiter=2, npert=2, sr_method=sr)
    B0 = random_codes(0, 800, 4, 16)
    model = train_lsq(_t(d.train), B0, torch.eye(16), cfg,
                      generator=torch.Generator().manual_seed(0))
    jmodel = jtrain_lsq(jnp.asarray(d.train), jnp.asarray(B0), jnp.eye(16), cfg)
    assert model._fields == ("C", "B", "cbnorms", "B_norms", "obj")
    assert model.obj.shape == (4,) and model.obj[-1] < model.obj[0]
    assert abs(model.obj[-1] - jmodel.obj[-1]) <= 0.04 * jmodel.obj[-1]
    assert model.B.dtype == torch.int32 and model.B_norms.dtype == torch.int32


def _small_model():
    d = synthetic_dataset(1, d=16, n_train=400, n_base=10, n_query=2)
    cfg = LSQConfig(m=3, h=8, niter=2, ilsiter=2, icmiter=1, npert=1)
    return d.train, jtrain_lsq(jnp.asarray(d.train), jnp.asarray(random_codes(0, 400, 3, 8)),
                               jnp.eye(16), cfg, key=jax.random.PRNGKey(1))


def test_checkpoint_jax_save_loads_in_port_and_encodes_identically(tmp_path):
    """JAX save_model -> port load_model: the same fields, and the same encode
    on the same randomness as the model's own tensors give."""
    X, jmodel = _small_model()
    path = os.path.join(tmp_path, "jax_lsq.npz")
    jckpt.save_model(path, jmodel)
    model = tckpt.load_model(path, device="cpu")
    assert isinstance(model, LSQModel)
    for f in LSQModel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(model, f)),
                                      np.asarray(getattr(jmodel, f)))
    direct = tckpt.lsq_model_from_numpy(jmodel._asdict())
    B0 = _t(random_codes(2, 400, 3, 8))
    r1 = ticm.ils_encode(torch.Generator().manual_seed(4), _t(X), B0, model.C,
                         ilsiter=2, icmiter=1, npert=1, condition_mode="kernel")
    r2 = ticm.ils_encode(torch.Generator().manual_seed(4), _t(X), B0, direct.C,
                         ilsiter=2, icmiter=1, npert=1, condition_mode="kernel")
    np.testing.assert_array_equal(r1.B.numpy(), r2.B.numpy())
    # And the JAX encoder on the loaded codebooks reaches the same quality.
    jr = jicm.ils_encode(jax.random.PRNGKey(4), jnp.asarray(X), jnp.asarray(B0.numpy()),
                         jnp.asarray(model.C.numpy()), ilsiter=2, icmiter=1, npert=1)
    jmean = float(np.mean(np.asarray(jr.cost)))
    assert abs(float(r1.cost.mean()) - jmean) <= 0.05 * jmean


def test_checkpoint_port_save_loads_in_jax(tmp_path):
    X, jmodel = _small_model()
    model = tckpt.lsq_model_from_numpy(jmodel._asdict())
    path = os.path.join(tmp_path, "torch_lsq.npz")
    tckpt.save_model(path, model)
    back = jckpt.load_model(path)
    assert type(back).__name__ == "LSQModel"
    for f in LSQModel._fields:
        a, b = np.asarray(getattr(back, f)), np.asarray(getattr(jmodel, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unported"):
        np.savez(os.path.join(tmp_path, "rvq.npz"), __model__="RVQModel")
        tckpt.load_model(os.path.join(tmp_path, "rvq.npz"))
