"""The port's IVF layer (`ivf.py`, `Index.build_ivf`, `search(nprobe=)`), held
to the JAX package's on the same numpy inputs from a seed.

- The numpy functions (`topk_lex`, `merge_knn`, `coarse_probes`) are held
  identical to the JAX module's, on inputs with forced ties.
- A partition built and saved by the JAX `Index` loads in the port and
  searches to the same ids and distances (rtol 1e-6: the LUT einsum sums in
  another order in XLA and in torch; ids where the k-th distance is not
  tied), for pq, opq, chainq and lsq; a port-written directory loads in the
  JAX package. `jax.random` and torch draw different k-means seeds, so the
  port's own `build_partition` is held to invariants: every live id once,
  64-aligned segments, ascending ids in a list, a lossless array round trip,
  and a full probe that equals the exhaustive search.
- The device scan (`ivf.DeviceScan`, plain torch; it runs here on the CPU
  device) is held identical to the numpy oracle, ties included.
- Mutations (add -> the tail, delete, compact), the generation stamp, and the
  refusals mirror `tests/test_ivf.py`.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from local_search_quantization_tpu import ivf as jivf
from local_search_quantization_tpu.index import Index as JIndex
from local_search_quantization_torch import ivf as tivf
from local_search_quantization_torch.index import Index as TIndex
from local_search_quantization_torch.ops import adc as tadc
from local_search_quantization_torch.utils import native as tnative

torch.set_num_threads(2)

D, M, H, K, NLIST = 16, 4, 16, 10, 8
BUILD = dict(m=M, h=H, niter=2, ilsiter=2, seed=0)
METHODS = ("pq", "opq", "chainq", "lsq")


def _clustered(rng, n, d, ncl=12, spread=0.35):
    centers = rng.normal(size=(ncl, d)).astype(np.float32) * 3.0
    lab = rng.integers(0, ncl, size=n)
    return (centers[lab] + rng.normal(size=(n, d)).astype(np.float32) * spread).astype(
        np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = _clustered(rng, 3000, D)
    Q = X[rng.integers(0, 3000, 24)] + 0.01
    return X[:800], X, Q.astype(np.float32)


@pytest.fixture(scope="module")
def jax_dirs(data, tmp_path_factory):
    """Directories written by the JAX package: Index.build + build_ivf + save."""
    xt, xb, _ = data
    out = {}
    for method in METHODS:
        path = str(tmp_path_factory.mktemp(f"jax_ivf_{method}"))
        idx = JIndex.build(xt, xb, method, **BUILD)
        idx.build_ivf(nlist=NLIST, sample=2000, iters=10, seed=0)
        idx.save(path)
        out[method] = path
    return out


@pytest.fixture(scope="module")
def port_index(data):
    """A pq index built by the port with its own partition (h=16: ties)."""
    xt, xb, _ = data
    idx = TIndex.build(xt, xb, "pq", device="cpu", **BUILD)
    idx.build_ivf(nlist=NLIST, sample=2000, iters=10, seed=0)
    return idx


def _untied(d, k):
    """Queries whose k-th distance differs from the (k+1)-th of `d` [nq, > k]."""
    return d[:, k - 1] < d[:, k]


def _assert_same_search(jres, tres, untied=None, atol=1e-5):
    jd, ji = np.asarray(jres.dists), np.asarray(jres.ids)
    td, ti = tres.dists.numpy(), tres.ids.numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=atol)
    rows = slice(None) if untied is None else untied
    np.testing.assert_array_equal(ti[rows], ji[rows])


# -- (a) the numpy functions ------------------------------------------------


@pytest.mark.parametrize("n,k,levels", [(50, 7, 3), (200, 64, 2), (5, 9, 2), (300, 300, 4),
                                        (40, 1, 1)])
def test_topk_lex_matches_jax_on_forced_ties(n, k, levels):
    rng = np.random.default_rng(n + k)
    d = rng.integers(0, levels, n).astype(np.float32)
    d[rng.random(n) < 0.2] = np.inf
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    want = jivf.topk_lex(d, ids, k)
    got = tivf.topk_lex(d, ids, k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    live = np.isfinite(d)
    ref = sorted(zip(d[live], ids[live]))[:k]
    assert [i for _, i in ref] == list(got[1][:len(ref)])
    assert (got[1][len(ref):] == -1).all() and np.isinf(got[0][len(ref):]).all()


@pytest.mark.parametrize("k", [5, 12, 30])
def test_merge_knn_matches_jax_on_forced_ties(k):
    rng = np.random.default_rng(k)

    def side(lo):
        d = np.sort(rng.integers(0, 4, (6, 12)).astype(np.float32), axis=1)
        i = rng.integers(lo, lo + 1000, (6, 12)).astype(np.int64)
        d[:, 9:] = np.inf
        i[:, 9:] = -1
        return d, i

    a, b = side(0), side(5000)
    want = jivf.merge_knn(tadc.KNNResult(*a), tadc.KNNResult(*b), k)
    got = tivf.merge_knn(tadc.KNNResult(*a), tadc.KNNResult(*b), k)
    np.testing.assert_array_equal(got.dists, want.dists)
    np.testing.assert_array_equal(got.ids, want.ids)
    # The device path's merge is the same function.
    tt = tivf.merge_knn_device(tadc.KNNResult(torch.as_tensor(a[0]), torch.as_tensor(a[1])),
                               tadc.KNNResult(torch.as_tensor(b[0]), torch.as_tensor(b[1])), k)
    np.testing.assert_array_equal(tt.dists.numpy(), want.dists)
    np.testing.assert_array_equal(tt.ids.numpy(), want.ids)


@pytest.mark.parametrize("nprobe", [1, 3, NLIST, NLIST + 5])
def test_coarse_probes_match_jax(jax_dirs, data, nprobe):
    _, _, Q = data
    jpart = JIndex.load(jax_dirs["pq"]).ivf
    tpart = TIndex.load(jax_dirs["pq"], device="cpu").ivf
    want = jivf.coarse_probes(Q, jpart, nprobe)
    got = tivf.coarse_probes(Q, tpart, nprobe)
    assert got.dtype == np.int32 and got.shape == (Q.shape[0], min(nprobe, NLIST))
    np.testing.assert_array_equal(got, want)
    scan = tivf.DeviceScan(tpart, "cpu")
    np.testing.assert_array_equal(scan.probes(torch.as_tensor(Q), nprobe).numpy(), want)


# -- (b), (c) directories cross the packages --------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_jax_ivf_directory_loads_in_the_port_and_searches_alike(data, jax_dirs, method):
    _, _, Q = data
    ji = JIndex.load(jax_dirs[method])
    ti = TIndex.load(jax_dirs[method], device="cpu")
    assert ti.ivf is not None and ti.ivf.nlist == NLIST == ti.meta["ivf_nlist"]
    for name, value in ji.ivf.to_arrays().items():
        np.testing.assert_array_equal(ti.ivf.to_arrays()[name], value)
    np.testing.assert_array_equal(ti.ivf.pos_of_id, ji.ivf.pos_of_id)
    wide = np.asarray(ji.search(Q, k=K + 1, nprobe=NLIST).dists)
    for p in (1, 3, NLIST):
        untied = _untied(np.asarray(ji.search(Q, k=K + 1, nprobe=p).dists), K)
        tres = ti.search(Q, k=K, nprobe=p)
        assert tres.ids.dtype == torch.int64 and tres.dists.dtype == torch.float32
        _assert_same_search(ji.search(Q, k=K, nprobe=p), tres, untied)
    # At a full probe the distances are the exhaustive scan's.
    np.testing.assert_allclose(ti.search(Q, k=K, nprobe=NLIST).dists.numpy(), wide[:, :K],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ti.search(Q, k=K).dists.numpy(), wide[:, :K],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method", ["pq", "lsq"])
def test_port_ivf_directory_loads_in_jax(data, tmp_path, method):
    xt, xb, Q = data
    ti = TIndex.build(xt, xb, method, device="cpu", **BUILD)
    ti.build_ivf(nlist=NLIST, sample=2000, iters=10, seed=0)
    ti.save(str(tmp_path))
    assert os.path.exists(os.path.join(str(tmp_path), "ivf.npz"))
    with np.load(os.path.join(str(tmp_path), "ivf.npz")) as z:
        want_keys = {"centroids", "order", "starts", "lives", "codes_g", "n_grouped", "emin",
                     "gen"} | ({"extra_g"} if method == "lsq" else set())
        assert set(z.files) == want_keys
        assert z["order"].dtype == np.int64 and z["codes_g"].dtype == np.uint8
    ji = JIndex.load(str(tmp_path))
    assert ji.ivf is not None and ji.ivf.nlist == NLIST
    for p in (1, 3, NLIST):
        untied = _untied(np.asarray(ji.search(Q, k=K + 1, nprobe=p).dists), K)
        _assert_same_search(ji.search(Q, k=K, nprobe=p), ti.search(Q, k=K, nprobe=p), untied)
    back = TIndex.load(str(tmp_path), device="cpu")
    res, want = back.search(Q, k=K, nprobe=3), ti.search(Q, k=K, nprobe=3)
    assert torch.equal(res.ids, want.ids) and torch.equal(res.dists, want.dists)
    # A second save keeps the live partition (it once deleted it).
    back.save(str(tmp_path))
    assert TIndex.load(str(tmp_path), device="cpu").ivf is not None


# -- (d) the port's own partition -------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_build_partition_invariants_and_full_probe(data, method):
    xt, xb, Q = data
    idx = TIndex.build(xt, xb, method, device="cpu", **BUILD)
    idx.build_ivf(nlist=NLIST, sample=2000, iters=10, seed=0)
    part = idx.ivf
    assert part.n_grouped == idx.n == 3000 and part.nlist == NLIST
    live = part.order >= 0
    np.testing.assert_array_equal(np.sort(part.order[live]), np.arange(idx.n))
    assert (part.starts % 64 == 0).all() and part.starts[-1] == part.order.shape[0]
    assert part.lives.sum() == idx.n and (np.diff(part.starts) >= part.lives).all()
    for li in range(NLIST):
        seg = part.order[part.starts[li]:part.starts[li + 1]]
        n_live = int(part.lives[li])
        assert (np.diff(seg[:n_live]) > 0).all() and (seg[n_live:] == -1).all()
    np.testing.assert_array_equal(part.codes_g[part.pos_of_id], idx.B)
    np.testing.assert_array_equal(part.codesT_g, part.codes_g.T)
    # Every row sits in the list of its nearest centroid.
    xhat = idx._reconstructions().numpy()
    sc = part.cnorms[None, :] - 2.0 * (xhat @ part.centroids.T)
    own = np.searchsorted(part.starts, part.pos_of_id, side="right") - 1
    assert (sc[np.arange(idx.n), own] <= sc.min(axis=1) + 1e-3).all()
    again = tivf.IVFPartition.from_arrays(part.to_arrays())
    for f in ("centroids", "cnorms", "order", "starts", "lives", "codes_g", "codesT_g",
              "pos_of_id"):
        np.testing.assert_array_equal(getattr(again, f), getattr(part, f))
    assert again.n_grouped == part.n_grouped and again.emin == np.float32(part.emin)
    if idx.additive:
        np.testing.assert_array_equal(again.extra_g, part.extra_g)
        assert part.emin == idx._dbn.min()
    else:
        assert part.extra_g is None and again.extra_g is None and part.emin == 0.0
    ex = idx.search(Q, k=K + 1)
    iv = idx.search(Q, k=K, nprobe=NLIST)
    np.testing.assert_allclose(iv.dists.numpy(), ex.dists.numpy()[:, :K], rtol=1e-6,
                               atol=1e-5)
    untied = _untied(ex.dists.numpy(), K)
    np.testing.assert_array_equal(iv.ids.numpy()[untied], ex.ids.numpy()[untied, :K])
    # Recall of the exhaustive answer does not fall as nprobe grows.
    want = ex.ids.numpy()[:, :K]
    hits = [np.mean([len(set(a) & set(b)) for a, b in
                     zip(idx.search(Q, k=K, nprobe=p).ids.numpy(), want)])
            for p in (1, 2, 4, NLIST)]
    assert hits == sorted(hits) and hits[0] > 0.5 * K


def test_reconstructions_match_jax(data, jax_dirs):
    for method in METHODS:
        want = JIndex.load(jax_dirs[method])._reconstructions()
        got = TIndex.load(jax_dirs[method], device="cpu")._reconstructions().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nprobe,k", [(1, 5), (3, 10), (NLIST, 40), (2, 700)])
def test_device_scan_is_the_numpy_oracle(port_index, data, nprobe, k):
    """`DeviceScan.search` against `_numpy_scan` on h=16 codes, where equal
    distances are common: identical distances and ids, sentinels included,
    also with tombstones and in small chunks of queries."""
    _, _, Q = data
    part = tivf.IVFPartition.from_arrays(port_index.ivf.to_arrays())
    part.tombstone(np.arange(0, 3000, 7))
    luts = port_index._query_luts(Q).contiguous()
    probes = tivf.coarse_probes(Q, part, nprobe)
    probes[::5, -1] = -1  # unused probe slots
    want = tivf.search(part, luts.numpy(), k, probes, method="numpy")
    scan = tivf.DeviceScan(part, "cpu")
    got = scan.search(luts, k, torch.as_tensor(probes))
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids)
    assert not np.isin(got.ids.numpy(), np.arange(0, 3000, 7)).any()
    small = tivf._DEVICE_CHUNK_ELEMS
    try:
        tivf._DEVICE_CHUNK_ELEMS = 2000  # a chunk of one or two queries
        again = scan.search(luts, k, torch.as_tensor(probes))
    finally:
        tivf._DEVICE_CHUNK_ELEMS = small
    assert torch.equal(again.dists, got.dists) and torch.equal(again.ids, got.ids)


def test_pads_never_returned(port_index, data):
    """k above the probed live rows: sentinel padding, never a pad row."""
    _, _, Q = data
    part = port_index.ivf
    smallest = int(np.argmin(part.lives))
    got = int(part.lives[smallest])
    luts = port_index._query_luts(Q[:4]).contiguous()
    probes = np.full((4, 1), smallest, np.int32)
    for res in (tivf.search(part, luts.numpy(), got + 8, probes),
                tivf.DeviceScan(part, "cpu").search(luts, got + 8, torch.as_tensor(probes))):
        ids, dists = np.asarray(res.ids), np.asarray(res.dists)
        assert (ids[:, got:] == -1).all() and np.isinf(dists[:, got:]).all()
        assert (ids[:, :got] >= 0).all() and np.isfinite(dists[:, :got]).all()


# -- (e) mutations -------------------------------------------------------------


def test_add_delete_compact_keep_the_partition_in_step(data, jax_dirs, tmp_path):
    """The same mutations on a JAX-written pq partition in both packages
    (pq's encoder is deterministic): the tail is found, a deleted row never
    comes back (before and after save/load), compact renumbers in place."""
    xt, xb, Q = data
    ji, ti = JIndex.load(jax_dirs["pq"]), TIndex.load(jax_dirs["pq"], device="cpu")
    new = xb[:3] + 0.01
    assert ji.add(new) == ti.add(new) == [3000, 3001, 3002]
    # These queries sit 0.01 from a base row: L2 LUT terms of magnitude 100
    # cancel to distances near 1, so the einsum's f32 rounding (1e-7 of the
    # terms) shows as 1e-5 of the result: atol 1e-4.
    jres, tres = ji.search(new, k=5, nprobe=1), ti.search(new, k=5, nprobe=1)
    _assert_same_search(jres, tres, _untied(np.asarray(ji.search(new, k=6, nprobe=1).dists),
                                            5), atol=1e-4)
    # The tail is scanned exhaustively: one probed list finds the new rows.
    # (h=16 codes repeat, so a new row ties with the base rows of its code
    # and the lowest ids win: k is wide enough to hold the tie block.)
    found = ti.search(new, k=300, nprobe=1).ids.numpy()
    for i, oid in enumerate((3000, 3001, 3002)):
        assert oid in found[i]
    first = ti.search(Q, k=K, nprobe=NLIST).ids.numpy()
    gone = np.unique(np.concatenate([first[:, 0], [3001]]))
    assert ji.delete(gone) == ti.delete(gone) == gone.size
    for p in (1, NLIST):
        tres = ti.search(Q, k=K, nprobe=p)
        assert not np.isin(tres.ids.numpy(), gone).any()
        _assert_same_search(ji.search(Q, k=K, nprobe=p), tres,
                            _untied(np.asarray(ji.search(Q, k=K + 1, nprobe=p).dists), K))
    ti.save(str(tmp_path))
    back = TIndex.load(str(tmp_path), device="cpu")
    assert back.ivf is not None and back.ivf.n_grouped == 3000 and back.n == 3003
    assert not np.isin(back.search(Q, k=K, nprobe=NLIST).ids.numpy(), gone).any()
    assert 3000 in back.search(new[:1], k=300, nprobe=1).ids.numpy()[0]
    # compact: list assignments kept, survivors renumbered, the tail behind them.
    lists_before = np.searchsorted(ti.ivf.starts, ti.ivf.pos_of_id, side="right") - 1
    np.testing.assert_array_equal(ti.compact(), ji.compact())
    kept = 3000 - (gone < 3000).sum()
    assert ti.ivf.n_grouped == ji.ivf.n_grouped == kept and ti.n == kept + 2
    for name, value in ji.ivf.to_arrays().items():
        np.testing.assert_array_equal(ti.ivf.to_arrays()[name], value)
    lists_after = np.searchsorted(ti.ivf.starts, ti.ivf.pos_of_id, side="right") - 1
    survivors = np.setdiff1d(np.arange(3000), gone)
    np.testing.assert_array_equal(lists_after, lists_before[survivors])
    tivf.IVFPartition.from_arrays(ti.ivf.to_arrays())
    ex, iv = ti.search(Q, k=K + 1), ti.search(Q, k=K, nprobe=NLIST)
    np.testing.assert_allclose(iv.dists.numpy(), ex.dists.numpy()[:, :K], rtol=1e-6,
                               atol=1e-5)
    r = ti.search(np.stack([new[0], new[2]]), k=300, nprobe=NLIST).ids.numpy()
    assert kept in r[0] and kept + 1 in r[1]


def test_refine_composes_with_nprobe(data, jax_dirs):
    _, xb, Q = data
    ji, ti = JIndex.load(jax_dirs["pq"]), TIndex.load(jax_dirs["pq"], device="cpu")
    ji.attach_refine(xb, kind="f32")
    ti.attach_refine(xb, kind="f32")
    jres, tres = ji.search(Q, k=5, nprobe=3, refine=8), ti.search(Q, k=5, nprobe=3, refine=8)
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), rtol=1e-5,
                               atol=1e-4)
    x = xb[tres.ids.numpy()]
    np.testing.assert_allclose(tres.dists.numpy(), ((x - Q[:, None]) ** 2).sum(-1), rtol=1e-5,
                               atol=1e-3)


# -- (f) stale sidecars and refusals ---------------------------------------------


def test_stale_generation_partition_is_dropped_with_a_note(data, jax_dirs, tmp_path, capsys):
    xt, xb, Q = data
    ti = TIndex.load(jax_dirs["pq"], device="cpu")
    p = str(tmp_path / "idx")
    ti.save(p)
    stale = str(tmp_path / "ivf_stale.npz")
    shutil.copy(os.path.join(p, "ivf.npz"), stale)
    victim = int(ti.search(Q[:1], k=1, nprobe=NLIST).ids[0, 0])
    ti.delete([victim])
    ti.save(p)
    shutil.copy(stale, os.path.join(p, "ivf.npz"))  # a crash between the renames
    capsys.readouterr()
    back = TIndex.load(p, device="cpu")
    assert back.ivf is None, "generation-stale partition survived load"
    assert "dropping stale IVF partition" in capsys.readouterr().err
    assert victim not in back.search(Q[:1], k=10).ids[0]
    assert JIndex.load(p).ivf is None  # the JAX package drops it too
    with pytest.raises(ValueError, match="no IVF partition"):
        back.search(Q[:1], k=3, nprobe=2)

    # Legacy saves (no stamp anywhere): the row-count fallback keeps the
    # partition and re-applies the tombstones.
    def strip_gen(fp):
        with np.load(fp) as z:
            arrs = {k: z[k] for k in z.files if k != "gen"}
        np.savez(fp + ".tmp.npz", **arrs)
        os.replace(fp + ".tmp.npz", fp)

    strip_gen(os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "codes.npz"))
    legacy = TIndex.load(p, device="cpu")
    assert legacy.ivf is not None
    assert victim not in legacy.search(Q[:1], k=10, nprobe=NLIST).ids[0]
    legacy.compact()
    legacy.save(p)
    shutil.copy(stale, os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "codes.npz"))
    assert TIndex.load(p, device="cpu").ivf is None  # n_grouped > n: dropped


def test_corrupt_partition_arrays_are_rejected(port_index):
    good = port_index.ivf.to_arrays()
    bad = dict(good)
    bad["lives"] = good["lives"] + 1000  # exceeds the padded segments
    with pytest.raises(ValueError, match="corrupt"):
        tivf.IVFPartition.from_arrays(bad)
    bad = dict(good)
    bad["order"] = good["order"].copy()
    bad["order"][good["order"] >= 0] = 0  # duplicate ids
    with pytest.raises(ValueError, match="corrupt"):
        tivf.IVFPartition.from_arrays(bad)
    bad = dict(good)
    bad["starts"] = good["starts"] + 1  # not 64-aligned, not from 0
    with pytest.raises(ValueError, match="corrupt"):
        tivf.IVFPartition.from_arrays(bad)


@pytest.mark.parametrize("case", ["h over 256", "nlist beyond the sample", "nlist zero"])
def test_build_partition_refusals_mirror_jax(case):
    rng = np.random.default_rng(3)
    xhat = rng.normal(size=(500, 8)).astype(np.float32)
    if case == "h over 256":
        B, kw, match = rng.integers(0, 300, (500, 2)).astype(np.int32), dict(nlist=4), "uint8"
    elif case == "nlist beyond the sample":
        B, kw, match = (rng.integers(0, 16, (500, 2)).astype(np.int32),
                        dict(nlist=200, sample=100), "sample")
    else:
        B, kw, match = rng.integers(0, 16, (500, 2)).astype(np.int32), dict(nlist=0), "nlist"
    with pytest.raises(ValueError, match=match) as jerr:
        jivf.build_partition(B, xhat, None, **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tivf.build_partition(B, xhat, None, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    # The port's own: a tensor on another device than the one named is refused.
    with pytest.raises(ValueError, match="lies on meta"):
        tivf.build_partition(np.zeros((500, 2), np.int32), torch.empty((500, 8), device="meta"),
                             None, nlist=4, device="cpu")


def test_search_refusals_mirror_jax(data, jax_dirs, port_index):
    _, _, Q = data
    ji = JIndex.load(jax_dirs["lsq"])
    ti = TIndex.load(jax_dirs["lsq"], device="cpu")
    for kw, match in ((dict(nprobe=-1), "nprobe must be >= 1"),
                      (dict(nprobe=2, precision="bf16"), "bf16")):
        with pytest.raises(ValueError, match=match):
            ji.search(Q, k=3, **kw)
        with pytest.raises(ValueError, match=match):
            ti.search(Q, k=3, **kw)
    bare = TIndex(ti.method, ti.model, ti.B, bnorm=ti._bnorm, meta=ti.meta, device="cpu")
    with pytest.raises(ValueError, match="no IVF partition"):
        bare.search(Q, k=3, nprobe=2)
    # nprobe None / 0 is the exhaustive scan; tombstoning ids outside the
    # partition (negative, or in the tail) is a no-op.
    assert torch.equal(ti.search(Q, k=3, nprobe=0).ids, ti.search(Q, k=3).ids)
    before = port_index.ivf.extra_g
    port_index.ivf.tombstone(np.array([-1, -5, 10 ** 6]))
    assert port_index.ivf.extra_g is before is None


# -- (g) the native scanner ------------------------------------------------------


def test_native_and_torch_scans_agree(port_index, data):
    if not tnative.has_ivf():
        pytest.skip("native library without lsq_linscan_ivf (make -C native)")
    _, _, Q = data
    part = port_index.ivf
    luts = port_index._query_luts(Q).contiguous()
    probes = tivf.coarse_probes(Q, part, 3)
    nat = tivf.search(part, luts.numpy(), 10, probes)
    oracle = tivf.search(part, luts.numpy(), 10, probes, method="numpy")
    dev = tivf.DeviceScan(part, "cpu").search(luts, 10, torch.as_tensor(probes))
    np.testing.assert_array_equal(nat.dists, oracle.dists)
    np.testing.assert_array_equal(dev.dists.numpy(), nat.dists)
    for q in range(Q.shape[0]):  # ties may pick another row: hold each slot's distance
        for j in range(10):
            pos = part.pos_of_id[nat.ids[q, j]]
            d = sum(float(luts[q, c, part.codes_g[pos, c]]) for c in range(M))
            np.testing.assert_allclose(d, nat.dists[q, j], rtol=1e-6, atol=1e-5)
