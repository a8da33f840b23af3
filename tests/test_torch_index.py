"""The port's `Index` and refine stage, held to the JAX package's.

An index directory written by either package loads in the other, and
`search` returns the same ids on the same queries, with and without the
refine stage. Distances of trained (continuous) models are compared to
1e-5 relative: the LUT einsum sums d products in another order in XLA and
in torch; ids are compared exactly. Mutations (delete, add, compact) keep
the JAX package's id semantics and the (+inf, -1) sentinel contract.
"""

import json
import os

import numpy as np
import pytest
import torch

from local_search_quantization_tpu import refine as jrefine
from local_search_quantization_tpu.index import Index as JIndex
from local_search_quantization_torch import index as tindex
from local_search_quantization_torch import refine as trefine
from local_search_quantization_torch.index import Index as TIndex

torch.set_num_threads(2)

D, M, H, K = 16, 4, 16, 10
BUILD = dict(m=M, h=H, niter=2, ilsiter=2, seed=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(600, D)).astype(np.float32),
            rng.normal(size=(1500, D)).astype(np.float32),
            rng.normal(size=(20, D)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_dirs(data, tmp_path_factory):
    """Directories written by the JAX package's Index.build + save."""
    xt, xb, _ = data
    out = {}
    for method in ("pq", "lsq", "rvq"):
        path = str(tmp_path_factory.mktemp(f"jax_{method}"))
        JIndex.build(xt, xb, method, refine="f32", **BUILD).save(path)
        out[method] = path
    return out


def _assert_same_search(jres, tres):
    np.testing.assert_array_equal(tres.ids.cpu().numpy(), np.asarray(jres.ids))
    np.testing.assert_allclose(tres.dists.cpu().numpy(), np.asarray(jres.dists),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method", ["pq", "lsq", "rvq"])
def test_jax_index_directory_loads_in_the_port(data, jax_dirs, method):
    _, _, xq = data
    ji = JIndex.load(jax_dirs[method])
    ti = TIndex.load(jax_dirs[method], device="cpu")
    assert ti.method == method and ti.n == ji.n and ti.d == D
    np.testing.assert_array_equal(ti.B, ji.B)
    assert ti.B.dtype == np.uint8  # h <= 256: byte codes in host memory
    for f in ji.model._fields:
        want = np.asarray(getattr(ji.model, f))
        np.testing.assert_array_equal(np.asarray(torch.as_tensor(getattr(ti.model, f))),
                                      want)
    assert ti.refine is not None and ti.refine.kind == "f32"
    for refine in (None, 3):
        _assert_same_search(ji.search(xq, k=K, refine=refine),
                            ti.search(xq, k=K, refine=refine))
    assert ti.search(xq, k=K, refine=3).ids.dtype == torch.int64


@pytest.mark.parametrize("method", ["pq", "lsq", "rvq"])
def test_port_index_directory_loads_in_jax(data, tmp_path, method):
    xt, xb, xq = data
    ti = TIndex.build(xt, xb, method, refine="sq8", device="cpu", **BUILD)
    assert ti.meta["bits"] == (16 if method == "pq" else 24) and ti.meta["n"] == 1500
    ti.save(str(tmp_path))
    ji = JIndex.load(str(tmp_path))
    np.testing.assert_array_equal(ji.B, ti.B)
    assert ji.refine is not None and ji.refine.kind == "sq8"
    np.testing.assert_array_equal(ji.refine.data, ti.refine.data.numpy())
    for refine in (None, 3):
        _assert_same_search(ji.search(xq, k=K, refine=refine),
                            ti.search(xq, k=K, refine=refine))
    # The reloaded port index answers as the built one.
    back = TIndex.load(str(tmp_path), device="cpu")
    res, want = back.search(xq, k=K), ti.search(xq, k=K)
    assert torch.equal(res.ids, want.ids) and torch.equal(res.dists, want.dists)


def test_delete_add_compact_keep_jax_id_semantics(data, jax_dirs, tmp_path):
    """The same mutations on a JAX-written pq index in both packages (pq's
    encoder is deterministic): identical ids at every step, tombstones never
    come back, and fewer live rows than k pad with (+inf, -1)."""
    xt, xb, xq = data
    ji, ti = JIndex.load(jax_dirs["pq"]), TIndex.load(jax_dirs["pq"], device="cpu")
    first = ti.search(xq, k=K).ids.numpy()
    gone = np.unique(first[:, :3])
    assert ji.delete(gone) == ti.delete(gone) == gone.size
    jres, tres = ji.search(xq, k=K), ti.search(xq, k=K)
    _assert_same_search(jres, tres)
    assert not np.isin(tres.ids.numpy(), gone).any()
    new = xb[:50] + 0.01
    assert ji.add(new) == ti.add(new) == list(range(1500, 1550))
    np.testing.assert_array_equal(ti.B, ji.B)
    _assert_same_search(ji.search(xq, k=K, refine=2), ti.search(xq, k=K, refine=2))
    np.testing.assert_array_equal(ti.compact(), ji.compact())
    assert ti.n == ji.n == 1550 - gone.size and ti.active == ti.n
    _assert_same_search(ji.search(xq, k=K, refine=2), ti.search(xq, k=K, refine=2))
    # Sentinels: all but 5 rows deleted.
    ji.delete(np.arange(5, ji.n))
    ti.delete(np.arange(5, ti.n))
    jres, tres = ji.search(xq, k=K, refine=2), ti.search(xq, k=K, refine=2)
    _assert_same_search(jres, tres)
    assert (tres.ids.numpy()[:, 5:] == -1).all() and np.isinf(tres.dists.numpy()[:, 5:]).all()
    ti.save(str(tmp_path))
    again = TIndex.load(str(tmp_path), device="cpu")
    assert again.active == 5 and again._tomb.sum() == again.n - 5


def test_lsq_add_encodes_with_a_persisted_seed_and_finds_the_rows(data, jax_dirs,
                                                                  tmp_path):
    new = np.random.default_rng(9).normal(size=(40, D)).astype(np.float32)
    ti = TIndex.load(jax_dirs["lsq"], device="cpu")
    ids = ti.add(new)
    assert ids == list(range(1500, 1540)) and ti.meta["add_seq"] == 1
    found = ti.search(new, k=20).ids.numpy()
    assert np.mean([i in row for i, row in zip(ids, found)]) >= 0.9
    exact = ti.search(new, k=1, refine=20).ids.numpy()[:, 0]
    # f32 refine store: a found row is its own exact nearest neighbour.
    assert np.mean(exact == np.asarray(ids)) >= 0.9
    ti.save(str(tmp_path))
    assert TIndex.load(str(tmp_path), device="cpu").meta["add_seq"] == 1


def test_rvq_add_delete_keep_jax_codes_and_ids(data, jax_dirs, tmp_path):
    """The same add and delete on a JAX-written RVQ index in both packages
    (RVQ's encoder is deterministic): identical codes, norm codes and ids;
    each added row is found by its own vector; a saved directory of the
    port's reloads in JAX with the added rows."""
    _, xb, xq = data
    ji, ti = JIndex.load(jax_dirs["rvq"]), TIndex.load(jax_dirs["rvq"], device="cpu")
    assert ti.method == "rvq" and ti.additive
    new = xb[:40] + 0.01
    assert ji.add(new) == ti.add(new) == list(range(1500, 1540))
    np.testing.assert_array_equal(ti.B, ji.B)
    np.testing.assert_array_equal(ti._bnorm, np.asarray(ji._bnorm))
    found = ti.search(new, k=20).ids.numpy()
    assert np.mean([i in row for i, row in zip(range(1500, 1540), found)]) >= 0.9
    gone = np.arange(1500, 1510)
    assert ji.delete(gone) == ti.delete(gone) == 10
    _assert_same_search(ji.search(xq, k=K, refine=2), ti.search(xq, k=K, refine=2))
    ti.save(str(tmp_path))
    back = JIndex.load(str(tmp_path))
    assert back.method == "rvq" and back.n == 1540
    _assert_same_search(back.search(xq, k=K), ti.search(xq, k=K))


def test_once_unported_surfaces_answer_as_jax(data, jax_dirs, tmp_path):
    """The surfaces that once raised "not ported" work: the mesh search
    returns the single-device ids (`tests/test_torch_parallel.py` holds it to
    JAX's mesh search); RVQ (the cross-load and mutation tests); IVF: a
    partition built by the JAX package loads, searches to the same ids, and
    survives a save."""
    from local_search_quantization_torch.parallel import data_mesh

    xt, xb, xq = data
    ti = TIndex.load(jax_dirs["pq"], device="cpu")
    with pytest.raises(ValueError, match="no IVF partition"):
        ti.search(xq, k=K, nprobe=4)
    sharded, single = ti.search(xq, k=K, mesh=data_mesh(["cpu"] * 3)), ti.search(xq, k=K)
    assert torch.equal(sharded.ids, single.ids) and torch.equal(sharded.dists, single.dists)
    ti.build_ivf(16, sample=1500, iters=2)
    assert ti.ivf.nlist == 16 == ti.meta["ivf_nlist"]
    full = ti.search(xq, k=K, nprobe=16)
    np.testing.assert_array_equal(full.dists.numpy(), ti.search(xq, k=K).dists.numpy())
    ji = JIndex.load(jax_dirs["pq"])
    ji.build_ivf(nlist=8, sample=1500, iters=2)
    ji.save(str(tmp_path))
    assert os.path.exists(os.path.join(str(tmp_path), "ivf.npz"))
    back = TIndex.load(str(tmp_path), device="cpu")
    assert back.ivf is not None and back.ivf.nlist == 8
    jres, tres = ji.search(xq, k=K, nprobe=3), back.search(xq, k=K, nprobe=3)
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), rtol=1e-5,
                               atol=1e-4)
    untied = np.asarray(ji.search(xq, k=K + 1, nprobe=3).dists)
    untied = untied[:, K - 1] < untied[:, K]
    np.testing.assert_array_equal(tres.ids.numpy()[untied], np.asarray(jres.ids)[untied])
    back.save(str(tmp_path))  # save keeps a live partition
    assert TIndex.load(str(tmp_path), device="cpu").ivf is not None
    with pytest.raises(ValueError):
        ti.search(xq[:, :3], k=K)
    with pytest.raises(ValueError):
        ti.search(xq, k=0)
    with pytest.raises(ValueError):
        ti.search(xq, k=K, precision="fp8")


def test_stale_refine_sidecar_is_dropped(data, jax_dirs, tmp_path):
    """codes.npz and refine.npz carry one generation stamp per save; a
    refine store from another save is a crash leftover and is dropped."""
    _, xb, xq = data
    ti = TIndex.load(jax_dirs["lsq"], device="cpu")
    path = str(tmp_path)
    ti.save(path)
    with np.load(os.path.join(path, "refine.npz")) as z:
        arrs = dict(z)
    arrs["gen"] = np.bytes_(b"0" * 32)
    np.savez(os.path.join(path, "refine.npz"), **arrs)
    back = TIndex.load(path, device="cpu")
    assert back.refine is None and "refine" not in back.meta
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["n"] == 1500


def test_bf16_search_matches_jax(data, jax_dirs):
    _, _, xq = data
    ji, ti = JIndex.load(jax_dirs["lsq"]), TIndex.load(jax_dirs["lsq"], device="cpu")
    jres = ji.search(xq, k=K, precision="bf16")
    tres = ti.search(xq, k=K, precision="bf16")
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))


def test_refine_rerank_matches_jax_exactly():
    """SQ8 over integer vectors spanning [0, 255] in every column (scale 1,
    offset 0) decodes exactly, so both packages give identical distances;
    -1 candidates are skipped and short rows pad with (+inf, -1)."""
    rng = np.random.default_rng(1)
    X = rng.integers(0, 256, size=(300, D)).astype(np.float32)
    X[0], X[1] = 0.0, 255.0
    Q = rng.integers(0, 256, size=(6, D)).astype(np.float32)
    cand = rng.integers(0, 300, size=(6, 40)).astype(np.int64)
    cand[0, 5:] = -1
    cand[1] = -1
    for kind in ("sq8", "f32"):
        js = jrefine.RefineStore.build(X, kind)
        ts = trefine.RefineStore.build(X, kind)
        np.testing.assert_array_equal(ts.data.numpy(), js.data)
        want = jrefine.rerank(js, Q, cand, 12)
        got = trefine.rerank(ts, torch.as_tensor(Q), torch.as_tensor(cand), 12,
                             query_chunk=4)
        np.testing.assert_array_equal(got.ids.numpy(), want.ids)
        np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    assert (got.ids.numpy()[0, 5:] == -1).all() and (got.ids.numpy()[1] == -1).all()
    ts.append(X[:3] * 2)  # frozen affine params: values clip
    js.append(X[:3] * 2)
    np.testing.assert_array_equal(ts.data.numpy(), js.data)


def test_scan_cache_gate_and_versioning(data, jax_dirs):
    assert not tindex._scan_cache_enabled(1000, "cpu")
    assert tindex._scan_cache_enabled(1 << 26, "cuda")
    assert not tindex._scan_cache_enabled((1 << 26) + 1, "cuda")
    ti = TIndex.load(jax_dirs["pq"], device="cpu")
    assert ti._device_scan_state() is None  # CPU index: the host route
    v = ti._scan_ver
    ti.delete([0])
    ti.add(data[1][:1])
    ti.compact()
    assert ti._scan_ver == v + 3
