"""K2's staged control flow (`select_kernels.k2_staged`) with the plain stages.

On the card `scan_topk` runs three stages (the sampled threshold of
`warm_bound`, `k2_filter`, `k2_select`) and reruns the queries that fail
their certificate through the dense path. Here the same control flow runs
with the stages' plain versions and is held to `scan_topk_reference` (K2's
plain version), and once to the Pallas grouped kernel in interpret mode.
Integer LUTs make distance ties massive; the tolerance is exact equality of
dists and ids throughout, as the contract is the exact (dist, id) top-k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import select_pallas as sp
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops import select_kernels as sk

torch.set_num_threads(2)

PLAIN = dict(prescan=sk._k2_prescan, filt=sk.k2_filter_reference,
             select=sk.k2_select_reference, dense=sk.scan_topk_reference)


def _case(n, nq, m, h, *, integer=True, n_inf=0, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        luts = rng.integers(-4, 5, (nq, m, h)).astype(np.float32)
    else:
        luts = rng.normal(size=(nq, m, h)).astype(np.float32)
    B = rng.integers(0, h, (n, m), dtype=np.int32)
    extra = rng.integers(0, 3, n).astype(np.float32)
    if n_inf:
        extra[rng.choice(n, n_inf, replace=False)] = np.inf
    return luts, B, extra


def _t(luts, B, extra, code=np.uint8):
    return (torch.as_tensor(luts), torch.as_tensor(B.T.astype(code)),
            torch.as_tensor(extra))


def _assert_same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", [
    # (n, nq, m, h, k, integer, n_inf, code dtype)
    (20_000, 6, 4, 16, 300, True, 0, np.uint8),     # massive ties at the k-th value
    (20_000, 5, 4, 32, 200, False, 2_000, np.uint8),  # +inf rows
    (12_000, 1, 4, 16, 100, False, 0, np.uint8),    # nq = 1
    (4_096, 3, 3, 16, 4_096, True, 0, np.uint8),    # k = n
    (10_000, 4, 3, 300, 150, True, 0, np.int32),    # int32 codes (h > 256)
])
def test_k2_staged_plain_stages_match_reference(case):
    n, nq, m, h, k, integer, n_inf, code = case
    luts, Bt, extra = _t(*_case(n, nq, m, h, integer=integer, n_inf=n_inf, seed=n + k),
                         code=code)
    want = sk.scan_topk_reference(luts, Bt, extra, k)
    d, i, failed = sk.k2_staged(luts, Bt, extra, k, chunk=2, **PLAIN)
    _assert_same((d, i), want)
    assert failed == 0  # the dense stage, which is the reference itself, never ran
    assert bool((i >= 0).all() == torch.isfinite(d).all())


def test_k2_staged_too_tight_t0_reruns_dense():
    """A t0 below every distance appends nothing: count < k fails every
    certificate, and the dense path gives the answer."""
    luts, Bt, extra = _t(*_case(20_000, 4, 4, 32, integer=False, seed=1))
    tight = dict(PLAIN, prescan=lambda lq, B, e, k: (
        torch.full((lq.shape[0], 1), -1e30), sk.warm_rank_cap(k)[1]))
    d, i, failed = sk.k2_staged(luts, Bt, extra, 200, chunk=3, **tight)
    assert failed == 4
    _assert_same((d, i), sk.scan_topk_reference(luts, Bt, extra, 200))


def test_k2_staged_overflow_reruns_dense():
    """An append capacity below the rows under t0 (count > cap) voids the
    certificate of those queries only; they rerun dense."""
    luts, Bt, extra = _t(*_case(20_000, 5, 4, 32, integer=False, seed=2))
    t0 = sk.warm_bound(luts, Bt, extra, k=200)[0]
    t0[0] = float("inf")  # query 0 appends every row
    over = dict(PLAIN, prescan=lambda lq, B, e, k: (t0[:lq.shape[0]], 3000))
    d, i, failed = sk.k2_staged(luts, Bt, extra, 200, chunk=5, **over)
    assert failed == 1
    _assert_same((d, i), sk.scan_topk_reference(luts, Bt, extra, 200))


def test_k2_staged_matches_pallas_grouped_kernel():
    """The staged flow with the plain stages gives the grouped Pallas kernel's
    (dist, id) answer, in interpret mode on the same tie-heavy inputs."""
    luts, B, extra = _case(8192, 8, 4, 16, seed=3)
    jd, ji = sp.fused_scan_topk(jnp.asarray(luts), jnp.asarray(B.T), jnp.asarray(extra),
                                k=96, tb=1024, interpret=True, variant="grouped")
    d, i, failed = sk.k2_staged(*_t(luts, B, extra), 96, chunk=8, **PLAIN)
    assert failed == 0
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_k2_filter_reference_appends_rows_below_t0_in_id_order():
    luts, Bt, extra = _t(*_case(5000, 3, 4, 16, n_inf=100, seed=4))
    dist = sk.lut_scan_block(luts, Bt, extra)
    t0 = torch.tensor([[-3.0], [0.0], [float("inf")]])
    cand, count = sk.k2_filter_reference(luts, Bt, extra, t0, 1024, block=700)
    hits = dist < t0
    assert torch.equal(count, hits.sum(1).to(torch.int32))
    for q in range(3):
        ids = torch.nonzero(hits[q])[:, 0][:1024]
        got = cand[q, :ids.numel()]
        assert torch.equal(got & 0xFFFFFFFF, ids)
        assert torch.equal(sk._unmono((got >> 32) & 0xFFFFFFFF), dist[q, ids])
        assert (cand[q, ids.numel():] == -1).all()


def test_k2_select_reference_sorts_keys_and_certifies():
    rng = np.random.default_rng(5)
    d = torch.as_tensor(rng.integers(-5, 6, (4, 64)).astype(np.float32))
    ids = torch.as_tensor(rng.permutation(64 * 4).reshape(4, 64))
    cand = sk._k2_keys(d, ids)
    count = torch.tensor([64, 20, 70, 5], dtype=torch.int32)
    od, oi, ok = sk.k2_select_reference(cand, count, 10, 64)
    assert ok.tolist() == [True, True, False, False]
    for q in range(4):
        f = min(int(count[q]), 64)
        lex = np.lexsort((ids[q, :f].numpy(), d[q, :f].numpy()))
        want_d, want_i = d[q, :f][lex], ids[q, :f][lex].to(torch.int32)
        w = min(f, 10)
        assert torch.equal(od[q, :w], want_d[:w]) and torch.equal(oi[q, :w], want_i[:w])
        assert torch.isinf(od[q, w:]).all() and (oi[q, w:] == -1).all()


def test_mono_keys_follow_float_order():
    x = torch.tensor([-np.inf, -3e38, -2.5, -1e-40, -0.0, 0.0, 1e-40, 1.5, 3e38, np.inf],
                     dtype=torch.float32)
    u = sk._mono(x)
    assert (u.diff() >= 0).all() and (u.diff()[[i for i in range(9) if i != 4]] > 0).all()
    assert torch.equal(sk._unmono(u), x)  # -0.0 comes back as +0.0, equal as floats
    keys = sk._k2_keys(x, torch.arange(10))
    assert torch.equal(torch.sort(keys ^ sk._SIGN64).values ^ sk._SIGN64, keys)


def test_k2_shape_rules():
    assert sk.warm_rank_cap(1000) == (111, 2688)
    assert sk.warm_rank_cap(10_001) == (777, 14848)
    assert sk.k2_group(7, 256, 1) == 16 and sk.k2_group(7, 256, 4) == 16
    assert sk.k2_group(16, 256, 1) == 8 and sk.k2_group(24, 256, 1) == 4
    assert sk.k2_group(64, 256, 1) == 0


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_dense_segments_fill_the_card_and_cover_every_row_once(sms):
    """The dense select's grid (`dense_segments`, `k2_filter`'s rule for its
    row segments): whole tiles; every row in exactly one segment; at least
    2 blocks an SM for nq < 2 * SMs wherever the rows hold that many tiles,
    else one tile a segment; one segment a query at nq >= 2 * SMs."""
    tile = sk._DENSE_TILE
    for n in (1, 4095, 4096, 30_007, 65_537, 1 << 20, (1 << 22) + 13, 10_000_000):
        tiles = -(-n // tile)
        for nq in (1, 2, 3, 21, 26, 131, 2 * sms - 1, 2 * sms, 256, 300, 5000):
            segs, rows = sk.dense_segments(n, nq, sms)
            assert rows >= tile and rows % tile == 0, (n, nq)
            owner = np.r_[np.arange(0, n, 97), n - 1] // rows  # sampled rows' segments
            assert owner.max() == segs - 1 and (segs - 1) * rows < n <= segs * rows, (n, nq)
            if nq >= 2 * sms:
                assert segs == 1, (n, nq)
            elif tiles >= -(-2 * sms // nq):
                assert segs * nq >= 2 * sms, (n, nq)
            else:
                assert (segs, rows) == (tiles, tile), (n, nq)


def test_dense_work_bytes():
    """A 32-byte state and a 2048-bin histogram a query, a 1024-bin
    histogram a (query, segment) and a tie count a (query, tile of a
    segment), in 4-byte words."""
    tile = sk._DENSE_TILE
    assert sk.dense_work_bytes(1, 1, tile) == 32 + 8192 + 4096 + 4
    assert sk.dense_work_bytes(21, 14, 187 * tile) == 21 * (32 + 8192 + 14 * 4096 + 187 * 4)
    assert all(sk.dense_work_bytes(q, *sk.dense_segments(n, q, 132)) % 4 == 0
               for q in (1, 7, 256) for n in (5, 1 << 20))


def test_k2_wrappers_take_the_plain_version_on_the_cpu_only():
    luts, Bt, extra = _t(*_case(3000, 2, 3, 16, seed=6))
    keys = ("scan_topk_dense", "k2_filter", "k2_select", "scan_topk_failed")
    counts = [launch_counts.read()[key] for key in keys]
    want = sk.scan_topk_reference(luts, Bt, extra, 40)
    _assert_same(sk.scan_topk(luts, Bt, extra, 40), want)
    _assert_same(sk.scan_topk_dense(luts, Bt, extra, 40), want)
    t0 = torch.zeros((2, 1))
    cand, count = sk.k2_filter(luts, Bt, extra, t0, 512)
    want_c = sk.k2_filter_reference(luts, Bt, extra, t0, 512)
    assert torch.equal(cand, want_c[0]) and torch.equal(count, want_c[1])
    got = sk.k2_select(cand, count, 40, 512)
    for g, w in zip(got, sk.k2_select_reference(cand, count, 40, 512)):
        assert torch.equal(g, w)
    assert counts == [launch_counts.read()[key] for key in keys]
