"""The port's `parallel/` (mesh, sharded encode and codebook update, sharded
query) and `Index.search(mesh=)`, held to the JAX package's own sharded
functions on the same numpy inputs.

The port's meshes are ["cpu"] * 8 (and ["cpu"] * 4 with a custom axis), the
counterpart of conftest's 8 virtual CPU devices that the JAX side runs on.
The cases mirror `tests/test_parallel.py` at its sizes. Tolerances:

- codebooks: rtol/atol 2e-3, as `test_parallel.py` holds the sharded update
  to the single-device one (the Gram sums run in another order);
- ILS encodes draw other random streams in the two packages (and per shard),
  so they are held by invariants: no row's cost rises, the mean falls, and
  the port's mean cost lies within 5% of the JAX package's sharded encode
  from the same codes;
- queries: ids exact, distances rtol 1e-5 / atol 1e-4 (the LUT einsums sum
  d products in another order in XLA and in torch); where both packages
  scan the same numpy LUTs, ids and distances are compared exactly, and a
  lexsort oracle over the LUTs pins the (dist, id) tie order.

JAX's `Index.search(mesh=)` pads each shard to its default 32768-row block
with 1024-query chunks, which costs seconds of XLA constant folding a call
on the CPU; its tests here run it with block 256 and 64-query chunks, which
changes the padding only (pad rows are +inf and never returned).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu import parallel as jparallel
from local_search_quantization_tpu.index import Index as JIndex
from local_search_quantization_tpu.ops import solver as jsolver
from local_search_quantization_tpu.parallel import encode as jencode
from local_search_quantization_tpu.parallel import query as jquery
from local_search_quantization_tpu.parallel.mesh import shard_cols as jshard_cols
from local_search_quantization_torch.index import Index as TIndex
from local_search_quantization_torch.ops import adc, costs, launch_counts, solver
from local_search_quantization_torch.parallel import data_mesh, shard_batch
from local_search_quantization_torch.parallel.encode import (
    make_lsq_train_step,
    sharded_ils_encode,
    sharded_update_codebooks,
)
from local_search_quantization_torch.parallel.mesh import mesh_platform, replicated, shard_cols
from local_search_quantization_torch.parallel.query import (
    prepare_sharded_codes,
    sharded_linscan_lsq,
    sharded_linscan_pq,
    sharded_scan_topk,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4
ENCODE_BAND = 0.05


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return jparallel.data_mesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def tmesh():
    return data_mesh(["cpu"] * 8)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cat(blocks) -> np.ndarray:
    return torch.cat([b.cpu() for b in blocks]).numpy()


def _lsq_case(rng, n, nq, d, m, h, scale=0.5):
    C = (rng.normal(size=(m, h, d)) * scale).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = _np(costs.reconstruct(_t(B), _t(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    return C, B, Q, dbn


def _lex_oracle(luts, B, dbn, k):
    m = luts.shape[1]
    full = np.asarray(luts, np.float64)[:, np.arange(m)[:, None], B.T].sum(1) + dbn[None, :]
    ids = np.lexsort((np.broadcast_to(np.arange(B.shape[0]), full.shape), full), axis=1)
    return ids[:, :k], full


def _same(jres, tres, exact=False):
    np.testing.assert_array_equal(_np(tres.ids), np.asarray(jres.ids))
    if exact:
        np.testing.assert_array_equal(_np(tres.dists), np.asarray(jres.dists))
    else:
        np.testing.assert_allclose(_np(tres.dists), np.asarray(jres.dists), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# The mesh and the code_gram repair the sharded update depends on.


def test_data_mesh_needs_a_gpu_unless_given_cpu_entries(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_mesh()
    mesh = data_mesh(["cpu"] * 3, axis="x")
    assert mesh.shape == {"x": 3} and mesh_platform(mesh) == "cpu"
    with pytest.raises(ValueError):
        data_mesh([])
    with pytest.raises(ValueError, match="must all be 'cuda' or all 'cpu'"):
        data_mesh(["cpu", "meta"])


def test_shard_batch_pads_by_repeating_and_shard_cols_is_contiguous(tmesh):
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    blocks = shard_batch(tmesh, x)
    assert len(blocks) == 8 and all(b.shape == (2, 3) for b in blocks)
    np.testing.assert_array_equal(_cat(blocks)[10:], np.repeat(x[-1:], 6, axis=0))
    cols = shard_cols(tmesh, np.arange(48).reshape(3, 16))
    assert all(c.shape == (3, 2) and c.is_contiguous() for c in cols)
    np.testing.assert_array_equal(torch.cat(cols, dim=1).numpy(),
                                  np.arange(48).reshape(3, 16))
    reps = replicated(tmesh, x)
    assert len(reps) == 8 and all(torch.equal(r, torch.as_tensor(x)) for r in reps)


@pytest.mark.parametrize("where", ["codebook 0", "codebook i > 0"])
def test_code_gram_treats_code_minus_one_as_an_all_zero_row(rng, where):
    """A -1 code (a masked pad row) adds nothing to G or A^T X, as in JAX's
    code_gram; a -1 in codebook 0 used to raise, in codebook i > 0 to count
    the previous codebook's last code."""
    n, d, m, h = 20, 5, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    if where == "codebook 0":
        B[[3, 11], 0] = -1
    else:
        B[[3, 11], 1:] = -1
    Gj, Aj = jsolver.code_gram(jnp.asarray(B), jnp.asarray(X), h)
    Gt, At = solver.code_gram(_t(B), _t(X), h, chunk=8)
    np.testing.assert_array_equal(Gt.numpy(), np.asarray(Gj))
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-6, atol=1e-6)
    assert np.trace(Gt.numpy()) == n * m - (2 if where == "codebook 0" else 4)


# ---------------------------------------------------------------------------
# Sharded codebook update, encode and train step (parallel/encode.py).


def test_sharded_codebook_update_matches_single(rng, jmesh, tmesh):
    n, d, m, h = 512, 8, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    CJ = np.asarray(jencode.sharded_update_codebooks(
        jmesh, jparallel.shard_batch(jmesh, jnp.asarray(X)),
        jparallel.shard_batch(jmesh, jnp.asarray(B)), h))
    C1 = solver.update_codebooks(_t(X), _t(B), h).numpy()
    CT = sharded_update_codebooks(tmesh, shard_batch(tmesh, X), shard_batch(tmesh, B), h)
    np.testing.assert_allclose(CT.numpy(), CJ, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(CT.numpy(), C1, rtol=2e-3, atol=2e-3)
    again = sharded_update_codebooks(tmesh, shard_batch(tmesh, X), shard_batch(tmesh, B), h)
    assert torch.equal(again, CT)  # the ordered sum repeats bit for bit


def test_sharded_codebook_update_nondivisible_n(rng, jmesh, tmesh):
    """shard_batch pads by repeating the last row; n_valid masks the repeats
    out of the least squares (code -1), or they are counted twice."""
    n, d, m, h = 500, 8, 3, 8  # 500 % 8 != 0 -> 4 repeated pad rows
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    CJ = np.asarray(jencode.sharded_update_codebooks(
        jmesh, jparallel.shard_batch(jmesh, jnp.asarray(X)),
        jparallel.shard_batch(jmesh, jnp.asarray(B)), h, n_valid=n))
    C1 = solver.update_codebooks(_t(X), _t(B), h).numpy()
    Xs, Bs = shard_batch(tmesh, X), shard_batch(tmesh, B)
    C8 = sharded_update_codebooks(tmesh, Xs, Bs, h, n_valid=n).numpy()
    np.testing.assert_allclose(C8, CJ, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(C8, C1, rtol=2e-3, atol=2e-3)
    biased = sharded_update_codebooks(tmesh, Xs, Bs, h).numpy()
    assert np.abs(biased - C1).max() > np.abs(C8 - C1).max()


@pytest.mark.parametrize("n", [512, 500])
def test_sharded_codebook_update_is_the_single_devices_bit_for_bit_on_integers(rng, tmesh,
                                                                               n):
    """On integer-valued X (as SIFT's), every partial sum of G and A^T X is
    exact in f32 in any order, so the shards' ordered sum gives the single
    device's G and A^T X exactly and the same codebooks; at n=500 the 4 pad
    rows must be masked out exactly (n_valid), not merely nearly."""
    d, m, h = 8, 3, 8
    X = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C1 = solver.update_codebooks(_t(X), _t(B), h)
    CT = sharded_update_codebooks(tmesh, shard_batch(tmesh, X), shard_batch(tmesh, B), h,
                                  n_valid=n)
    assert torch.equal(CT, C1)


ENC = dict(n=512, d=8, m=3, h=8)


@pytest.fixture(scope="module")
def encode_case(jmesh):
    """test_parallel.py's encode inputs, and the JAX package's sharded encode
    of them (its CPU route, "gather"; the modes differ only in how a visit's
    scores are formed)."""
    rng = np.random.default_rng(0)
    n, d, m, h = ENC["n"], ENC["d"], ENC["m"], ENC["h"]
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    res = jencode.sharded_ils_encode(
        jmesh, jax.random.PRNGKey(0), jparallel.shard_batch(jmesh, jnp.asarray(X)),
        jparallel.shard_batch(jmesh, jnp.asarray(B0)),
        jparallel.replicated(jmesh, jnp.asarray(C)),
        ilsiter=2, icmiter=2, npert=1, condition_mode="gather")
    return X, C, B0, np.asarray(res.cost)


@pytest.mark.parametrize("mode", ["gather", "kernel", "fused"])
def test_sharded_ils_encode_improves_as_jaxs(encode_case, tmesh, mode):
    """"kernel" is K1's plain version on the CPU, "fused" K5's."""
    X, C, B0, jcost = encode_case
    cost0 = _np(costs.veccost(_t(X), _t(B0), _t(C)))
    res = sharded_ils_encode(tmesh, torch.Generator().manual_seed(0),
                             shard_batch(tmesh, X), shard_batch(tmesh, B0), _t(C),
                             ilsiter=2, icmiter=2, npert=1, condition_mode=mode)
    B, cost = _cat(res.B), _cat(res.cost)
    assert B.shape == B0.shape and cost.shape == (B0.shape[0],)
    assert (cost <= cost0 + 1e-3).all() and cost.mean() < cost0.mean()
    np.testing.assert_allclose(cost, _np(costs.veccost(_t(X), _t(B), _t(C))),
                               rtol=1e-4, atol=1e-3)
    assert abs(cost.mean() - jcost.mean()) <= ENCODE_BAND * jcost.mean()
    again = sharded_ils_encode(tmesh, torch.Generator().manual_seed(0),
                               shard_batch(tmesh, X), shard_batch(tmesh, B0), _t(C),
                               ilsiter=2, icmiter=2, npert=1, condition_mode=mode)
    np.testing.assert_array_equal(_cat(again.B), B)  # repeats from the generator


def test_lsq_train_step_end_to_end(rng, jmesh, tmesh):
    n, d, m, h = 512, 8, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, (n, m), dtype=np.int32)
    jstep = jencode.make_lsq_train_step(jmesh, h, ilsiter=2, icmiter=2, npert=1)
    CJ, _, jcost = jstep(jax.random.PRNGKey(0), jparallel.shard_batch(jmesh, jnp.asarray(X)),
                         jparallel.shard_batch(jmesh, jnp.asarray(B)))
    step = make_lsq_train_step(tmesh, h, ilsiter=2, icmiter=2, npert=1)
    Xs = shard_batch(tmesh, X)
    C1, B1, cost1 = step(torch.Generator().manual_seed(0), Xs, shard_batch(tmesh, B))
    C2, B2, cost2 = step(torch.Generator().manual_seed(1), Xs, B1)
    np.testing.assert_allclose(C1.numpy(), np.asarray(CJ), rtol=2e-3, atol=2e-3)
    mean1, mean2 = _cat(cost1).mean(), _cat(cost2).mean()
    assert abs(mean1 - np.asarray(jcost).mean()) <= ENCODE_BAND * np.asarray(jcost).mean()
    assert mean2 <= mean1 * 1.001  # EM: full steps never raise the mean objective


# ---------------------------------------------------------------------------
# Sharded queries (parallel/query.py).


def test_sharded_query_matches_single_chip(rng, jmesh, tmesh):
    n, nq, d, m, h, k = 1024, 16, 8, 3, 8, 10
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h)
    multi = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, query_chunk=16, block=64)
    single = adc.linscan_lsq(B, _t(Q), _t(C), _t(dbn), k=k, query_chunk=16,
                             base_block=256, topk_method="exact")
    assert torch.equal(multi.ids, single.ids) and torch.equal(multi.dists, single.dists)
    _same(jquery.sharded_linscan_lsq(jmesh, B, Q, jnp.asarray(C), dbn, k, query_chunk=16,
                                     block=64), multi)


def test_sharded_pq_query_matches_single(rng, jmesh, tmesh):
    from local_search_quantization_tpu.models import train_pq
    from local_search_quantization_tpu.utils.config import PQConfig

    X = rng.normal(size=(400, 16)).astype(np.float32)
    model = train_pq(X, PQConfig(m=4, h=8))
    B, C_sub = np.asarray(model.B), np.asarray(model.C_sub)
    Q = rng.normal(size=(12, 16)).astype(np.float32)
    k = 7
    multi = sharded_linscan_pq(tmesh, B, Q, _t(C_sub), k, query_chunk=16, block=64)
    single = adc.linscan_pq(B, _t(Q), _t(C_sub), k=k, topk_method="exact")
    assert torch.equal(multi.ids, single.ids) and torch.equal(multi.dists, single.dists)
    _same(jquery.sharded_linscan_pq(jmesh, B, Q, model.C_sub, k, query_chunk=16, block=64),
          multi)


def test_sharded_query_bf16_precision_matches_rounded_oracle(rng, jmesh, tmesh):
    """precision="bf16": every route returns the exact lex top-k of the
    bf16-rounded metric, id for id against an f64 oracle over the rounded
    tables, as the JAX package's mesh route does; a DIRECT sharded_scan_topk
    call rounds too."""
    n, nq, d, m, h, k = 2048, 8, 8, 3, 8, 20
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h, scale=1.0)
    luts = adc.lsq_query_luts(_t(Q), _t(C))
    rl = luts.to(torch.bfloat16).float().numpy()
    assert np.any(rl != luts.numpy()), "rounding must actually bite"
    oracle, _ = _lex_oracle(rl, B, dbn, k)
    for method in ("scan", "kernel"):
        multi = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, query_chunk=8, block=256,
                                    method=method, precision="bf16")
        np.testing.assert_array_equal(multi.ids.numpy(), oracle)
    single = adc.linscan_lsq(B, _t(Q), _t(C), _t(dbn), k=k, precision="bf16",
                             topk_method="exact")
    np.testing.assert_array_equal(single.ids.numpy(), oracle)
    with pytest.raises(ValueError, match="precision"):
        sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, precision="fp8")
    # The same numpy LUTs through both packages' direct calls.
    direct = sharded_scan_topk(tmesh, luts, shard_cols(tmesh, np.ascontiguousarray(B.T)),
                               shard_cols(tmesh, dbn), k, block=256, method="scan",
                               precision="bf16")
    np.testing.assert_array_equal(direct.ids.numpy(), oracle)
    jdirect = jquery.sharded_scan_topk(
        jmesh, jparallel.replicated(jmesh, jnp.asarray(luts.numpy())),
        jshard_cols(jmesh, jnp.asarray(np.ascontiguousarray(B.T))),
        jshard_cols(jmesh, jnp.asarray(dbn)), k, block=256, method="scan",
        precision="bf16")
    _same(jdirect, direct, exact=True)


def test_sharded_query_empty_and_custom_axis(rng):
    """nq=0 returns empty results, and the scanners honour a custom axis."""
    jmesh_x = jparallel.data_mesh(jax.devices()[:4], axis="x")
    tmesh_x = data_mesh(["cpu"] * 4, axis="x")
    n, d, m, h = 256, 8, 2, 8
    C_sub = (rng.normal(size=(m, h, d // m)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    empty = sharded_linscan_pq(tmesh_x, B, np.empty((0, d), np.float32), _t(C_sub), 5,
                               block=64, axis="x")
    assert empty.dists.shape == (0, 5) and empty.ids.shape == (0, 5)
    Q = rng.normal(size=(6, d)).astype(np.float32)
    res = sharded_linscan_pq(tmesh_x, B, Q, _t(C_sub), 5, query_chunk=4, block=64,
                             axis="x")
    _same(jquery.sharded_linscan_pq(jmesh_x, B, Q, jnp.asarray(C_sub), 5, query_chunk=4,
                                    block=64, axis="x"), res)
    with pytest.raises(ValueError, match="axis"):
        sharded_linscan_pq(tmesh_x, B, Q, _t(C_sub), 5, block=64)


def test_sharded_query_tiny_shards_k_exceeds_shard(rng, jmesh, tmesh):
    """k above a shard's rows: the shards' (+inf, -1) slots are never offset
    into forged ids; k above n clamps to n."""
    n, nq, d, m, h = 128, 8, 8, 3, 8
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h)
    multi = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, 50, query_chunk=8, block=64)
    ids = multi.ids.numpy()
    assert ids.min() >= 0 and ids.max() < n
    _same(jquery.sharded_linscan_lsq(jmesh, B, Q, jnp.asarray(C), dbn, 50, query_chunk=8,
                                     block=64), multi)
    multi2 = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, 200, query_chunk=8, block=64)
    assert multi2.ids.shape == (nq, n) and multi2.ids.min() >= 0
    oracle, _ = _lex_oracle(adc.lsq_query_luts(_t(Q), _t(C)).numpy(), B, dbn, n)
    np.testing.assert_array_equal(multi2.ids.numpy(), oracle)


def test_sharded_query_kernel_method_matches_scan(rng, jmesh, tmesh):
    """method="kernel" (the select kernels' plain versions on a CPU mesh)
    returns the streaming merge's results, with k above a shard too."""
    n, nq, d, m, h = 1024, 3, 8, 2, 8
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h, scale=1.0)
    for k in (7, 200):  # 200 > shard size 128: sentinel padding per shard
        a = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, query_chunk=4, block=64,
                                method="scan")
        b = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, query_chunk=4, block=64,
                                method="kernel")
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
        assert b.ids.min() >= 0 and b.ids.max() < n
    _same(jquery.sharded_linscan_lsq(jmesh, B, Q, jnp.asarray(C), dbn, 200, query_chunk=4,
                                     block=64, method="kernel"), b)


def test_tie_heavy_route_parity_exact_ids(rng, jmesh, tmesh):
    """On tie-heavy codes (h=4, m=2: 16 distinct codes over 4096 rows) the
    mesh route returns the lexsort oracle's ids, as the single-device
    routes and the JAX package's mesh route do."""
    n, nq, d, m, h, k = 4096, 5, 8, 2, 4, 50
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h)
    oracle, _ = _lex_oracle(adc.lsq_query_luts(_t(Q), _t(C)).numpy(), B, dbn, k)
    routes = {method: sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, query_chunk=8,
                                          block=256, method=method)
              for method in ("auto", "kernel")}
    routes["single kernel"] = adc.linscan_lsq(B, _t(Q), _t(C), _t(dbn), k=k,
                                              topk_method="kernel")
    for name, res in routes.items():
        np.testing.assert_array_equal(res.ids.numpy(), oracle, err_msg=name)
    jres = jquery.sharded_linscan_lsq(jmesh, B, Q, jnp.asarray(C), dbn, k, query_chunk=8,
                                      block=256)
    np.testing.assert_array_equal(np.asarray(jres.ids), oracle)


def test_mesh_deep_k_widen_lex_parity(rng, jmesh, tmesh, monkeypatch):
    """The replace-worst flavour per shard (forced by the variant switch) is
    value-strict; each shard's k+1 widen and grouped rerun restore the
    lexicographic ids (h=2, m=2: 4 distinct values over 512-row shards)."""
    monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", "grouped_unsorted")
    n, nq, d, m, h, k = 4096, 5, 8, 2, 2, 50
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h)
    oracle, full = _lex_oracle(adc.lsq_query_luts(_t(Q), _t(C)).numpy(), B, dbn, k)
    reruns = launch_counts.read()["rerun_widen"]
    multi = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, k, query_chunk=8, block=256,
                                method="kernel")
    assert launch_counts.read()["rerun_widen"] > reruns  # the certificate fired and reran
    np.testing.assert_array_equal(multi.ids.numpy(), oracle)
    np.testing.assert_allclose(multi.dists.numpy(), np.take_along_axis(full, oracle, 1),
                               rtol=1e-4, atol=1e-4)
    jres = jquery.sharded_linscan_lsq(jmesh, B, Q, jnp.asarray(C), dbn, k, query_chunk=8,
                                      block=256, method="kernel")
    np.testing.assert_array_equal(np.asarray(jres.ids), oracle)


def test_sharded_device_state_matches_fresh_upload(rng, jmesh, tmesh):
    n, nq, d, m, h = 1000, 6, 8, 3, 8
    C, B, Q, dbn = _lsq_case(rng, n, nq, d, m, h)
    state = prepare_sharded_codes(tmesh, B, dbn, block=64)
    assert sum(b.shape[1] for b in state[0]) % (8 * 64) == 0
    assert all(b.dtype == torch.uint8 and b.is_contiguous() for b in state[0])
    assert torch.isinf(state[1][-1][n - 1024:]).all()  # the 24 pad rows
    fresh = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, 10, query_chunk=8, block=64)
    cached = sharded_linscan_lsq(tmesh, B, Q, _t(C), dbn, 10, query_chunk=8, block=64,
                                 device_state=state)
    assert torch.equal(cached.ids, fresh.ids) and torch.equal(cached.dists, fresh.dists)
    jstate = jquery.prepare_sharded_codes(jmesh, B, dbn, block=64)
    _same(jquery.sharded_linscan_lsq(jmesh, B, Q, jnp.asarray(C), dbn, 10, query_chunk=8,
                                     block=64, device_state=jstate), cached)
    with pytest.raises(ValueError, match="device_state"):
        sharded_linscan_lsq(tmesh, B[:400], Q, _t(C), dbn[:400], 10, query_chunk=8,
                            block=64, device_state=state)


# ---------------------------------------------------------------------------
# Index.search(mesh=), against the JAX package's.

IDX = dict(m=4, h=16, niter=2, ilsiter=2, seed=0)
METHODS = ("pq", "opq", "chainq", "lsq", "rvq")
# Which package writes each method's directory.
WRITER = {"pq": "jax", "opq": "port", "chainq": "port", "lsq": "port", "rvq": "port"}


@pytest.fixture
def small_jax_mesh_scan(monkeypatch):
    """JAX's Index.search(mesh=) at block 256 and 64-query chunks."""
    for name in ("sharded_linscan_pq", "sharded_linscan_lsq"):
        monkeypatch.setattr(jquery, name, functools.partial(getattr(jquery, name),
                                                            query_chunk=64, block=256))
    monkeypatch.setattr(jquery, "prepare_sharded_codes",
                        functools.partial(jquery.prepare_sharded_codes, block=256))


@pytest.fixture(scope="module")
def index_dirs(tmp_path_factory):
    rng = np.random.default_rng(3)
    xt = rng.normal(size=(600, 16)).astype(np.float32)
    xb = rng.normal(size=(1200, 16)).astype(np.float32)
    xq = rng.normal(size=(8, 16)).astype(np.float32)
    dirs = {}
    for method, writer in WRITER.items():
        path = str(tmp_path_factory.mktemp(f"{writer}_{method}"))
        build = JIndex.build if writer == "jax" else functools.partial(TIndex.build,
                                                                       device="cpu")
        build(xt, xb, method, refine="f32" if method == "lsq" else None, **IDX).save(path)
        dirs[method] = path
    return dirs, xq


@pytest.mark.parametrize("method", METHODS)
def test_index_search_mesh_matches_jax(index_dirs, jmesh, tmesh, method,
                                       small_jax_mesh_scan):
    dirs, xq = index_dirs
    ji, ti = JIndex.load(dirs[method]), TIndex.load(dirs[method], device="cpu")
    tres = ti.search(xq, k=10, mesh=tmesh)
    _same(ji.search(xq, k=10, mesh=jmesh), tres)
    single = ti.search(xq, k=10)
    assert torch.equal(tres.ids, single.ids) and torch.equal(tres.dists, single.dists)
    if method == "lsq":  # refine composes with the mesh
        _same(ji.search(xq, k=5, mesh=jmesh, refine=3), ti.search(xq, k=5, mesh=tmesh,
                                                                  refine=3))


def test_index_mesh_scan_cache_lifecycle(index_dirs, jmesh, tmesh, small_jax_mesh_scan):
    """search(mesh=) reuses the sharded codes while the index is unmutated and
    rebuilds them after a delete, whose id no longer comes back; the JAX
    package's index answers alike at each step. nprobe with a mesh raises."""
    dirs, xq = index_dirs
    ji, idx = JIndex.load(dirs["pq"]), TIndex.load(dirs["pq"], device="cpu")
    res1 = idx.search(xq, k=10, mesh=tmesh)
    assert idx._mesh_scan_cache is not None
    ver0, state0 = idx._mesh_scan_cache[0], idx._mesh_scan_cache[2]
    again = idx.search(xq, k=10, mesh=tmesh)
    assert idx._mesh_scan_cache[2] is state0 and torch.equal(again.ids, res1.ids)
    victim = int(res1.ids[0, 0])
    idx.delete([victim])
    ji.delete([victim])
    res2 = idx.search(xq, k=10, mesh=tmesh)
    assert idx._mesh_scan_cache[0] != ver0
    assert victim not in res2.ids.numpy()[0]
    _same(ji.search(xq, k=10, mesh=jmesh), res2)
    other = data_mesh(["cpu"] * 8)  # an equal but other mesh rebuilds
    idx.search(xq, k=10, mesh=other)
    assert idx._mesh_scan_cache[1] is other
    idx.build_ivf(4, sample=600, iters=2)
    with pytest.raises(ValueError, match="mesh sharding applies to exhaustive scans"):
        idx.search(xq, k=10, nprobe=2, mesh=tmesh)
