"""The PyTorch port's lookup tables, costs and numpy utilities, held to the JAX package."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch

from local_search_quantization_tpu.ops import costs as jcosts
from local_search_quantization_tpu.ops import luts as jluts
from local_search_quantization_tpu.utils import config as jconfig
from local_search_quantization_tpu.utils import eval as jeval
from local_search_quantization_tpu.utils import io as jio
from local_search_quantization_tpu.utils import synth as jsynth
from local_search_quantization_torch.ops import costs as tcosts
from local_search_quantization_torch.ops import luts as tluts
from local_search_quantization_torch.utils import config as tconfig
from local_search_quantization_torch.utils import eval as teval
from local_search_quantization_torch.utils import io as tio
from local_search_quantization_torch.utils import synth as tsynth

torch.set_num_threads(1)

# f32 products of d=24 terms summed in another order: a few ulps of the
# summands' magnitude.
RTOL, ATOL = 1e-5, 1e-4


def _fixture(n=50, d=24, m=5, h=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = rng.normal(size=(m, h, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return X, C, B


def test_unaries_and_binaries_match_jax():
    X, C, _ = _fixture()
    np.testing.assert_allclose(
        tluts.get_unaries(torch.as_tensor(X), torch.as_tensor(C)).numpy(),
        np.asarray(jluts.get_unaries(jnp.asarray(X), jnp.asarray(C))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tluts.get_binaries(torch.as_tensor(C)).numpy(),
        np.asarray(jluts.get_binaries(jnp.asarray(C))), rtol=RTOL, atol=ATOL)


def test_reconstruct_veccost_qerror_match_jax():
    X, C, B = _fixture()
    Xt, Ct, Bt = torch.as_tensor(X), torch.as_tensor(C), torch.as_tensor(B)
    Xj, Cj, Bj = jnp.asarray(X), jnp.asarray(C), jnp.asarray(B)
    np.testing.assert_allclose(tcosts.reconstruct(Bt, Ct).numpy(),
                               np.asarray(jcosts.reconstruct(Bj, Cj)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tcosts.veccost(Xt, Bt, Ct).numpy(),
                               np.asarray(jcosts.veccost(Xj, Bj, Cj)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tcosts.qerror(Xt, Bt, Ct)),
                               float(jcosts.qerror(Xj, Bj, Cj)), rtol=RTOL)


def test_mrf_cost_equals_veccost():
    from local_search_quantization_torch.ops.icm import cost_from_luts

    X, C, B = _fixture()
    Xt, Ct, Bt = torch.as_tensor(X), torch.as_tensor(C), torch.as_tensor(B)
    mrf = cost_from_luts((Xt * Xt).sum(-1), tluts.get_unaries(Xt, Ct),
                         tluts.get_binaries(Ct), Bt)
    np.testing.assert_allclose(mrf.numpy(), tcosts.veccost(Xt, Bt, Ct).numpy(),
                               rtol=1e-4, atol=1e-3)


def test_synthetic_dataset_is_byte_identical_to_jax_copy():
    a = tsynth.synthetic_dataset(3, d=32, n_train=100, n_base=400, n_query=20)
    b = jsynth.synthetic_dataset(3, d=32, n_train=100, n_base=400, n_query=20)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    np.testing.assert_array_equal(tsynth.random_codes(5, 30, 7, 256),
                                  jsynth.random_codes(5, 30, 7, 256))
    assert tsynth.corpus_fingerprint() == jsynth.corpus_fingerprint()


def test_config_defaults_and_validation_match_jax():
    for name in ("PQConfig", "OPQConfig", "ChainQConfig", "RVQConfig", "LSQConfig",
                 "SLSQConfig"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), name
    for bad in ({"m": 0}, {"h": 1}, {"npert": 9}, {"sr_method": "x"}):
        for mod in (tconfig, jconfig):
            try:
                mod.LSQConfig(**bad)
            except ValueError:
                continue
            raise AssertionError(f"{mod.__name__}.LSQConfig({bad}) did not raise")


def test_eval_recall_matches_jax():
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 50, size=40)
    ids = rng.integers(0, 50, size=(40, 20))
    np.testing.assert_array_equal(teval.eval_recall(gt, ids, 20, verbose=False),
                                  jeval.eval_recall(gt, ids, 20, verbose=False))


def test_vecs_readers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for suffix, dtype, tread, jread in (
            ("fvecs", np.float32, tio.fvecs_read, jio.fvecs_read),
            ("ivecs", np.int32, tio.ivecs_read, jio.ivecs_read),
            ("bvecs", np.uint8, tio.bvecs_read, jio.bvecs_read)):
        a = rng.integers(0, 200, size=(9, 5)).astype(dtype)
        path = os.path.join(tmp_path, "x." + suffix)
        with open(path, "wb") as f:
            for row in a:
                np.int32(5).tofile(f)
                row.tofile(f)
        np.testing.assert_array_equal(tread(path, 4, 3), jread(path, 4, 3))
        np.testing.assert_array_equal(tread(path), a)
    assert not tio.dataset_available("SIFT1M", root=str(tmp_path))
