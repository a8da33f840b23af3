"""The port's OPQ -> ChainQ initialisation chain, held to the JAX package.

Each test hands the same numpy inputs to both packages. Where the JAX
function draws its own randomness (k-means++ seeding, OPQ's initial
centers), the test starts both from the same numpy-made or JAX-made state:
`kmeans(centers=...)`, `_opq_loop(X, C0, B0, R0, ...)`, `train_chainq` from
given (B, R).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.models import chainq as jchainq
from local_search_quantization_tpu.models import opq as jopq
from local_search_quantization_tpu.models import pq as jpq
from local_search_quantization_tpu.ops import adc as jadc
from local_search_quantization_tpu.ops import kmeans as jkmeans
from local_search_quantization_tpu.ops import luts as jluts
from local_search_quantization_tpu.ops import solver as jsolver
from local_search_quantization_tpu.ops import subspaces as jsub
from local_search_quantization_tpu.ops import viterbi as jviterbi
from local_search_quantization_tpu.utils import checkpoint as jckpt
from local_search_quantization_tpu.utils.config import ChainQConfig as JChainQConfig
from local_search_quantization_torch.models import chainq as tchainq
from local_search_quantization_torch.models import opq as topq
from local_search_quantization_torch.models import pq as tpq
from local_search_quantization_torch.ops import adc as tadc
from local_search_quantization_torch.ops import costs as tcosts
from local_search_quantization_torch.ops import kmeans as tkmeans
from local_search_quantization_torch.ops import luts as tluts
from local_search_quantization_torch.ops import solver as tsolver
from local_search_quantization_torch.ops import subspaces as tsub
from local_search_quantization_torch.ops import viterbi as tviterbi
from local_search_quantization_torch.utils import checkpoint as tckpt
from local_search_quantization_torch.utils.config import (
    ChainQConfig,
    LSQConfig,
    OPQConfig,
    PQConfig,
)
from local_search_quantization_torch.utils.synth import synthetic_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def corpus():
    return synthetic_dataset(2, d=30, n_train=1200, n_base=10, n_query=2).train


@pytest.mark.parametrize("d,m", [(30, 4), (32, 8), (13, 5)])
def test_subspaces_match_jax_exactly(d, m):
    """Integer data and codebooks: the padded layout, merge, reconstruction
    and the full-width lift are identical."""
    rng = np.random.default_rng(d)
    n, h = 40, 6
    X = rng.integers(-5, 6, size=(n, d)).astype(np.float32)
    w = tsub.padded_width(d, m)
    assert w == jsub.padded_width(d, m)
    assert tcosts.subspace_slices(d, m) == jsub.subspace_slices(d, m)
    Xs = tsub.split_subspaces(_t(X), m)
    np.testing.assert_array_equal(Xs.numpy(), np.asarray(jsub.split_subspaces(X, m)))
    np.testing.assert_array_equal(tsub.merge_subspaces(Xs, d).numpy(), X)
    C_sub = rng.integers(-3, 4, size=(m, h, w)).astype(np.float32)
    spans = tcosts.subspace_slices(d, m)
    for i, (a, b) in enumerate(spans):
        C_sub[i, :, b - a:] = 0.0  # the padded layout's zero columns
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    R = np.eye(d, dtype=np.float32)[rng.permutation(d)]
    np.testing.assert_array_equal(
        tsub.reconstruct_pq(_t(B), _t(C_sub), d).numpy(),
        np.asarray(jsub.reconstruct_pq(jnp.asarray(B), jnp.asarray(C_sub), d)))
    # The per-row errors are exact integers; the means may differ in the last
    # bit (XLA divides by multiplying with the reciprocal).
    np.testing.assert_allclose(float(tsub.qerror_pq(_t(X), _t(B), _t(C_sub))),
                               float(jsub.qerror_pq(X, jnp.asarray(B), jnp.asarray(C_sub))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tsub.qerror_opq(_t(X), _t(B), _t(C_sub), _t(R))),
        float(jsub.qerror_opq(X, jnp.asarray(B), jnp.asarray(C_sub), jnp.asarray(R))),
        rtol=1e-6)
    np.testing.assert_array_equal(tsub.pq_full_codebooks(_t(C_sub), d).numpy(),
                                  np.asarray(jsub.pq_full_codebooks(jnp.asarray(C_sub), d)))


def test_chain_binaries_and_dims_match_jax_exactly():
    rng = np.random.default_rng(1)
    C = rng.integers(-2, 3, size=(5, 12, 20)).astype(np.float32)
    np.testing.assert_array_equal(tluts.get_chain_binaries(_t(C)).numpy(),
                                  np.asarray(jluts.get_chain_binaries(jnp.asarray(C))))
    for d, m in ((128, 7), (20, 5), (9, 3)):
        assert tsolver.chain_dims(d, m) == jsolver.chain_dims(d, m)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("k,seed", [(12, 0), (40, 1)])
def test_kmeans_from_the_same_centers_matches_jax(k, seed, blocked, monkeypatch):
    """JAX's k-means++ centers handed to the port: identical labels and
    iteration count, centers within rtol 1e-5; also where the port's
    assignment and update go a block of points at a time (the path of a
    coarse quantizer too large for one [points, centers] temporary)."""
    if blocked:
        monkeypatch.setattr(tkmeans, "_BLOCK_ELEMS", 7 * k)  # 7 points a block
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(900, 6)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    centers0 = jkmeans.kmeans_pp_init(key, jnp.asarray(X), k)
    jres = jkmeans.kmeans(key, jnp.asarray(X), k, maxiter=25)
    tres = tkmeans.kmeans(None, _t(X), k, maxiter=25, centers=_t(centers0))
    np.testing.assert_array_equal(tres.assignments.numpy(), np.asarray(jres.assignments))
    np.testing.assert_allclose(tres.centers.numpy(), np.asarray(jres.centers),
                               rtol=1e-5, atol=1e-5)
    assert tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-5)
    assert tres.assignments.dtype == torch.int32


def test_kmeans_batched_and_empty_cluster_repair():
    """Batched runs are independent runs; an empty cluster is re-seeded at
    the highest-cost point, so no center stays empty."""
    rng = np.random.default_rng(3)
    Xs = (rng.normal(size=(3, 300, 4))).astype(np.float32)
    res = tkmeans.kmeans_batched(torch.Generator().manual_seed(5), _t(Xs), 5, maxiter=10)
    gen = torch.Generator().manual_seed(5)
    for i in range(3):
        one = tkmeans.kmeans(gen, _t(Xs[i]), 5, maxiter=10)
        np.testing.assert_array_equal(res.assignments[i].numpy(), one.assignments.numpy())
        assert int(res.iterations[i]) == one.iterations
    X = _t(Xs[0])
    dup = torch.stack([X[0], X[0], X[1], X[2]])  # center 1 can never win: empty
    labels, costs = tkmeans.assign(X, dup)
    assert not (labels == 1).any()
    res = tkmeans.kmeans(None, X, 4, maxiter=1, centers=dup)
    np.testing.assert_array_equal(res.centers[1].numpy(), X[int(torch.argmax(costs))].numpy())
    assert torch.bincount(res.assignments.long(), minlength=4).min() > 0
    gen = torch.Generator().manual_seed(0)
    init = tkmeans.kmeans_pp_init(gen, X, 6)
    assert init.shape == (6, 4)
    assert all(bool((X == c).all(1).any()) for c in init)  # rows of X


def _opq_start(X, m, h, seed=0):
    rng = np.random.default_rng(seed)
    n, d = X.shape
    Xs = np.asarray(jsub.split_subspaces(X, m))
    C0 = np.stack([Xs[i][rng.permutation(n)[:h]] for i in range(m)])
    B0 = np.asarray(jpq._assign_all(jnp.asarray(Xs), jnp.asarray(C0)))
    return C0, B0, np.eye(d, dtype=np.float32)


def test_opq_loop_from_the_same_start_matches_jax(corpus):
    """Same C0/B0/R0: objective trace within rtol 1e-4, >= 99% of the final
    codes equal, and an orthogonal R."""
    X = corpus
    m, h, niter = 4, 16, 5
    C0, B0, R0 = _opq_start(X, m, h)
    jC, jB, jR, jobj = jopq._opq_loop(jnp.asarray(X), jnp.asarray(C0), jnp.asarray(B0),
                                      jnp.asarray(R0), niter, h)
    tC, tB, tR, tobj = topq._opq_loop(_t(X), _t(C0), _t(B0), _t(R0), niter, h)
    assert tobj.shape == (niter + 1,)
    np.testing.assert_allclose(tobj, np.asarray(jobj), rtol=1e-4)
    assert (tB.numpy() == np.asarray(jB)).mean() >= 0.99
    np.testing.assert_allclose((tR.T @ tR).numpy(), np.eye(X.shape[1]), atol=1e-5)
    assert (np.diff(tobj) <= 0).all()


@pytest.mark.parametrize("init", ["natural", "random"])
def test_train_pq_and_opq_track_jax(corpus, init):
    """Own random streams: final errors within 5% of JAX's, OPQ below PQ."""
    X = corpus
    pq = tpq.train_pq(_t(X), PQConfig(m=4, h=16, kmeans_maxiter=20, seed=0))
    jres = jpq.train_pq(X, jpq.PQConfig(m=4, h=16, kmeans_maxiter=20, seed=0))
    assert abs(float(pq.error) - float(jres.error)) <= 0.05 * float(jres.error)
    np.testing.assert_array_equal(tpq.quantize_pq(_t(X), pq.C_sub).numpy(), pq.B.numpy())
    cfg = OPQConfig(m=4, h=16, niter=5, init=init)
    opq = topq.train_opq(_t(X), cfg)
    jo = jopq.train_opq(X, jopq.OPQConfig(m=4, h=16, niter=5, init=init))
    assert abs(float(opq.obj[-1]) - float(jo.obj[-1])) <= 0.05 * float(jo.obj[-1])
    assert float(opq.obj[-1]) < float(pq.error)
    assert opq.B.dtype == torch.int32 and opq.obj.dtype == np.float32
    enc = topq.quantize_opq(_t(X), opq.R, opq.C_sub)
    assert (enc.numpy() == opq.B.numpy()).mean() >= 0.99
    with pytest.raises(ValueError):
        topq.train_opq(_t(X), OPQConfig(m=4, h=16, niter=1, init="other"))


def test_chain_and_struct_updates_match_jax(corpus):
    X = corpus
    n, d = X.shape
    m, h = 5, 12
    B = np.random.default_rng(4).integers(0, h, size=(n, m), dtype=np.int32)
    jC = np.asarray(jsolver.update_codebooks_chain(jnp.asarray(X), jnp.asarray(B), h))
    tC = tsolver.update_codebooks_chain(_t(X), _t(B), h).numpy()
    np.testing.assert_allclose(tC, jC, rtol=1e-3, atol=1e-3 * np.abs(jC).max())
    dim2cb = np.zeros((d, m), bool)
    for i, (a, b) in enumerate(tsolver.chain_dims(d, m)):
        dim2cb[a:b, i] = True
    dim2cb[:3] = True  # a group covered by every codebook
    jS = np.asarray(jsolver.update_codebooks_struct(jnp.asarray(X), jnp.asarray(B), h,
                                                    dim2cb))
    tS = tsolver.update_codebooks_struct(_t(X), _t(B), h, dim2cb).numpy()
    np.testing.assert_allclose(tS, jS, rtol=1e-3, atol=1e-3 * np.abs(jS).max())
    assert (tS.transpose(0, 2, 1)[~dim2cb.T] == 0).all()  # zero outside each span


def test_viterbi_matches_jax_exactly(corpus):
    """The same X and C: identical codes, across a ragged last block, and
    they are the exact chain minimizers (no single-code change helps)."""
    X = corpus[:700]
    rng = np.random.default_rng(5)
    C = np.asarray(jsolver.update_codebooks_chain(
        jnp.asarray(X), jnp.asarray(rng.integers(0, 10, size=(700, 4), dtype=np.int32)), 10))
    jB = np.asarray(jviterbi.viterbi_encode(X, jnp.asarray(C), block=256))
    tB = tviterbi.viterbi_encode(_t(X), _t(C), block=256)
    np.testing.assert_array_equal(tB.numpy(), jB)
    assert tB.dtype == torch.int32
    base = tcosts.veccost(_t(X), tB, _t(C))
    for i in range(4):
        for c in range(10):
            B2 = tB.clone()
            B2[:, i] = c
            assert (tcosts.veccost(_t(X), B2, _t(C)) >= base - 1e-3).all()


def test_train_chainq_from_the_same_start_matches_jax(corpus, capsys):
    """Same (B, R) from one OPQ run: objective trace within rtol 1e-3; the
    inclusive loop records niter+1 entries; verbose prints -2 and -1."""
    X = corpus
    m, h = 4, 16
    C0, B0, R0 = _opq_start(X, m, h, seed=1)
    _, oB, oR, _ = jopq._opq_loop(jnp.asarray(X), jnp.asarray(C0), jnp.asarray(B0),
                                  jnp.asarray(R0), 3, h)
    jm = jchainq.train_chainq(X, oB, oR, JChainQConfig(m=m, h=h, niter=3))
    tm = tchainq.train_chainq(_t(X), _t(oB), _t(oR), ChainQConfig(m=m, h=h, niter=3),
                              verbose=True)
    assert tm.obj.shape == (4,)
    np.testing.assert_allclose(tm.obj, jm.obj, rtol=1e-3)
    out = capsys.readouterr().out.split("\n")
    assert out[0].startswith(" -2 ") and out[1].startswith(" -1 ")
    np.testing.assert_allclose((tm.R.T @ tm.R).numpy(), np.eye(X.shape[1]), atol=1e-5)
    assert float(tcosts.qerror(_t(X) @ tm.R, tm.B, tm.C)) <= tm.obj[-1] * (1 + 1e-5)


def _integer_pq_case(seed, n=1500, nq=9, d=12, m=3, h=8):
    rng = np.random.default_rng(seed)
    Q = rng.integers(-2, 3, size=(nq, d)).astype(np.float32)
    C_sub = rng.integers(-1, 2, size=(m, h, d // m)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    R = np.eye(d, dtype=np.float32)[rng.permutation(d)]
    return Q, C_sub, B, R


def test_pq_and_opq_scans_match_jax_with_ties():
    """Integer queries and codebooks: every LUT entry is exact, distance ties
    are common, and the ids (lowest id first among equals) are identical to
    the JAX package's exact streaming merge."""
    Q, C_sub, B, R = _integer_pq_case(0)
    np.testing.assert_array_equal(
        tadc.pq_query_luts(_t(Q), _t(C_sub)).numpy(),
        np.asarray(jadc.pq_query_luts(jnp.asarray(Q), jnp.asarray(C_sub))))
    jr = jadc.linscan_pq(B, Q, jnp.asarray(C_sub), k=60, topk_method="exact",
                         base_block=512)
    tr = tadc.linscan_pq(_t(B), _t(Q), _t(C_sub), k=60)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_array_equal(tr.dists.numpy(), np.asarray(jr.dists))
    assert (np.diff(np.asarray(jr.dists), axis=1) == 0).any()
    jr = jadc.linscan_opq(B, Q, jnp.asarray(C_sub), R, k=60, topk_method="exact",
                          base_block=512)
    tr = tadc.linscan_opq(_t(B), _t(Q), _t(C_sub), _t(R), k=60, topk_method="exact",
                          base_block=256)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    assert tr.ids.dtype == torch.int32


@pytest.mark.parametrize("name", ["PQModel", "OPQModel", "ChainQModel"])
def test_checkpoints_round_trip_both_ways(tmp_path, corpus, name):
    """A model saved by either package loads in the other with the same
    fields, dtypes and values."""
    X = corpus[:400]
    if name == "PQModel":
        jm = jpq.train_pq(X, jpq.PQConfig(m=4, h=8, kmeans_maxiter=5))
    elif name == "OPQModel":
        jm = jopq.train_opq(X, jopq.OPQConfig(m=4, h=8, niter=2))
    else:
        o = jopq.train_opq(X, jopq.OPQConfig(m=4, h=8, niter=2))
        jm = jchainq.train_chainq(X, o.B, o.R, JChainQConfig(m=4, h=8, niter=2))
    jpath = os.path.join(tmp_path, "jax.npz")
    jckpt.save_model(jpath, jm)
    tm = tckpt.load_model(jpath, device="cpu")
    assert type(tm).__name__ == name and tm._fields == jm._fields
    direct = tckpt.model_from_numpy(name, jm._asdict())
    for f in jm._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)))
        np.testing.assert_array_equal(np.asarray(getattr(direct, f)),
                                      np.asarray(getattr(jm, f)))
    assert tm.B.dtype == torch.int32
    tpath = os.path.join(tmp_path, "torch.npz")
    tckpt.save_model(tpath, tm)
    back = jckpt.load_model(tpath)
    assert type(back).__name__ == name
    for f in jm._fields:
        a, b = np.asarray(getattr(back, f)), np.asarray(getattr(jm, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def test_demo_trains_through_opq_and_chainq():
    """demos/demo_lsq_torch.py's train() runs OPQ -> ChainQ -> LSQ as
    demos/demo_lsq.py does: each stage improves on the one before, and LSQ
    starts from ChainQ's codes (its first objective is at most ChainQ's)."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "demos")]
    try:
        import demo_lsq_torch as demo
    finally:
        del sys.path[:2]
    args = demo.parse_args(["--dataset", "synthetic", "--ntrain", "800", "--m", "4",
                            "--h", "16", "--niter", "3", "--synth-d", "16"])
    x_train = synthetic_dataset(0, d=16, n_train=800, n_base=10, n_query=2).train
    cfg = LSQConfig(m=4, h=16, niter=3)
    lsq, info = demo.train(args, cfg, x_train, torch.device("cpu"))
    opq, chain = info["opq"], info["chain"]
    assert opq.obj.shape == (4,) and chain.obj.shape == (4,)
    assert chain.obj[-1] < opq.obj[-1]
    assert lsq.obj[0] <= chain.obj[-1] * 1.001
    assert lsq.obj[-1] < chain.obj[-1]
    again, info2 = demo.train(args, cfg, x_train, torch.device("cpu"), init=info)
    assert info2["chain"] is chain
    np.testing.assert_array_equal(again.obj, lsq.obj)
