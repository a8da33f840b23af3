"""The port's select API and the plain versions of K3 and K4, held to the JAX package.

`select_kernels.fused_scan_topk` and `scan_topk_warm` on CPU tensors run the
plain versions of the kernels (K2 `scan_select_reference` with no bound, K3
`scan_select_reference` with t0, K4 `scan_key_reference`). They are held to
`select_pallas.fused_scan_topk` / `scan_topk_warm` run in interpret mode on
the same numpy inputs. Integer LUTs make the TPU kernels' bf16 hi/lo sums
exact and make distance ties common, so the tolerance is exact equality;
"unsorted" flavours are held on ids only where the k-th value is not tied
with the next (their boundary ties follow arrival order by contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import select_pallas as sp
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops import select_kernels as sk

torch.set_num_threads(2)

NQ, M, H, N = 8, 4, 16, 4096


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(n=N, n_inf=0, seed=0):
    rng = np.random.default_rng(seed)
    luts = rng.integers(-4, 5, size=(NQ, M, H)).astype(np.float32)
    B = rng.integers(0, H, size=(n, M), dtype=np.int32)
    extra = rng.integers(0, 3, size=n).astype(np.float32)
    if n_inf:
        extra[rng.choice(n, n_inf, replace=False)] = np.inf
    full = luts[:, np.arange(M)[:, None], B.T].sum(1) + extra[None, :]
    return luts, B, extra, np.sort(full, axis=1)


def _jax(luts, B, extra, **kw):
    t0 = kw.pop("t0", None)
    return sp.fused_scan_topk(jnp.asarray(luts), jnp.asarray(B.T), jnp.asarray(extra),
                              tb=1024, interpret=True,
                              t0=None if t0 is None else jnp.asarray(t0), **kw)


def _port(luts, B, extra, **kw):
    t0 = kw.pop("t0", None)
    return sk.fused_scan_topk(_t(luts), _t(B.T.astype(np.uint8)), _t(extra),
                              t0=None if t0 is None else _t(t0), **kw)


def _assert_same(jd, ji, td, ti, unsorted, sorted_full):
    """Dists identical; ids identical, or for the unsorted flavours on rows
    whose k-th value is below the (k+1)-th (from the oracle `sorted_full`)."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_array_equal(td.numpy(), jd)
    if not unsorted:
        np.testing.assert_array_equal(ti.numpy(), ji)
        return
    k = jd.shape[1]
    cert = sorted_full[:, k - 1] < sorted_full[:, k]
    np.testing.assert_array_equal(ti.numpy()[cert], ji[cert])


@pytest.mark.parametrize("variant", ["sorted", "unsorted"])
@pytest.mark.parametrize("case", [
    # (n_inf, k, t0 rank or None)
    (0, 64, None),
    (0, 64, 192),      # warm bound above the k-th value
    (300, 64, 40),     # fewer rows below t0 than k: sentinels
    (4000, 150, None),  # fewer finite rows than k
])
def test_k3_plain_matches_pallas_select_kernel(variant, case):
    n_inf, k, rank = case
    luts, B, extra, full = _case(n_inf=n_inf, seed=k + n_inf)
    t0 = None if rank is None else full[:, rank - 1:rank].copy()
    jd, ji = _jax(luts, B, extra, k=k, variant=variant, t0=t0)
    td, ti = _port(luts, B, extra, k=k, variant=variant, t0=t0)
    _assert_same(jd, ji, td, ti, variant == "unsorted", full)
    assert (full[:, 1:] == full[:, :-1]).any()  # ties are present
    if rank is not None:  # only rows below t0 are kept
        assert np.all(np.isinf(td.numpy()) | (td.numpy() < t0))
    if n_inf and N - n_inf < k:
        assert (ti.numpy()[:, N - n_inf:] == -1).all()


def test_k3_sorted_equals_k2_cut_at_t0():
    """K3 "sorted" is K2's answer cut at t0, id for id."""
    luts, B, extra, full = _case(n_inf=100, seed=3)
    t0 = full[:, 99:100].copy()
    k3 = _port(luts, B, extra, k=80, variant="sorted", t0=t0)
    k2 = _port(luts, B, extra, k=80, variant="grouped", t0=t0)
    assert torch.equal(k3[0], k2[0]) and torch.equal(k3[1], k2[1])


@pytest.mark.parametrize("cap,overflow", [(1024, False), (128, True)])
def test_k4_plain_matches_pallas_key_kernel(cap, overflow):
    """(d, i, bad) identical; an overflowing append buffer flags bad in both."""
    luts, B, extra, full = _case(n_inf=300, seed=11)
    t0 = full[:, 191:192].copy()
    jd, ji, jbad = _jax(luts, B, extra, k=64, variant="key", t0=t0, append_cap=cap)
    td, ti, tbad = _port(luts, B, extra, k=64, variant="key", t0=t0, append_cap=cap)
    assert bool(jbad) == bool(tbad) == overflow
    if not overflow:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_k4_plain_version_appends_in_id_order_and_counts_every_hit():
    luts, B, extra, full = _case(n_inf=50, seed=5)
    t0 = full[:, 300:301].copy()
    ids, count = sk.scan_key_reference(_t(luts), _t(B.T), _t(extra), _t(t0), 128)
    d = luts[:, np.arange(M)[:, None], B.T].sum(1) + extra[None, :]  # exact in bf16
    hits = d < t0
    np.testing.assert_array_equal(count.numpy(), hits.sum(1))
    for q in range(NQ):
        want = np.flatnonzero(hits[q])[:128]
        np.testing.assert_array_equal(ids.numpy()[q, :len(want)], want)
        assert (ids.numpy()[q, len(want):] == -1).all()
    # t0 = +inf appends every finite row; -0.0 keys as 0.
    inf = np.full((NQ, 1), np.inf, np.float32)
    _, count = sk.scan_key_reference(_t(luts), _t(B.T), _t(extra), _t(inf), 8)
    assert (count.numpy() == N - 50).all()
    keys = sk._f32_to_key(torch.tensor([-0.0, 0.0, -1.5, 2.0]))
    assert keys[0] == keys[1] == 0 and keys[2] < 0 < keys[3]
    back = sk._key_to_f32(sk._f32_to_key(torch.tensor([-3.25, 7.5, -1e30])))
    assert torch.equal(back, torch.tensor([-3.25, 7.5, -1e30]))


@pytest.mark.parametrize("variant", ["sorted", "unsorted", "key", "grouped",
                                     "grouped_unsorted"])
def test_scan_topk_warm_matches_jax(variant):
    """Warm start with a sound sample rank: the same (d, i) as the JAX
    package's deferred warm path, and the same certificate."""
    luts, B, extra, full = _case(n_inf=300, seed=21)
    kw = dict(k=64, sample_stride=4, min_n=0, min_k=0, deferred=True, variant=variant)
    jd, ji, jbad = sp.scan_topk_warm(jnp.asarray(luts), jnp.asarray(B.T),
                                     jnp.asarray(extra), tb=1024, interpret=True, **kw)
    td, ti, tbad = sk.scan_topk_warm(_t(luts), _t(B.T.astype(np.uint8)), _t(extra), **kw)
    _assert_same(jd, ji, td, ti, variant in ("unsorted", "grouped_unsorted"), full)
    if variant.startswith("grouped"):
        assert tbad is None  # K2 needs no warm bound: it runs cold
    else:
        assert bool(tbad) == bool(jbad) is False


@pytest.mark.parametrize("variant", ["sorted", "key"])
def test_scan_topk_warm_undercapture_reruns_cold(variant):
    """sample_rank=1 under-captures: both packages flag it, and the
    non-deferred form reruns cold to the exact answer."""
    luts, B, extra, full = _case(seed=22)
    kw = dict(k=64, sample_stride=4, min_n=0, min_k=0, sample_rank=1, variant=variant)
    _, _, jbad = sp.scan_topk_warm(jnp.asarray(luts), jnp.asarray(B.T), jnp.asarray(extra),
                                   tb=1024, interpret=True, deferred=True, **kw)
    _, _, tbad = sk.scan_topk_warm(_t(luts), _t(B.T), _t(extra), deferred=True, **kw)
    assert bool(jbad) and bool(tbad)
    jd, ji = sp.scan_topk_warm(jnp.asarray(luts), jnp.asarray(B.T), jnp.asarray(extra),
                               tb=1024, interpret=True, **kw)
    td, ti = sk.scan_topk_warm(_t(luts), _t(B.T), _t(extra), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td.numpy(), full[:, :64])


@pytest.mark.parametrize("variant", ["sorted", "unsorted"])
def test_bf16_precision_rounds_once_and_rejects_the_key_variant(variant):
    """Continuous LUTs, rounded once to bf16: every row is certified, so the
    unsorted flavour is held id for id too."""
    rng = np.random.default_rng(3)
    luts = rng.normal(size=(NQ, M, H)).astype(np.float32) * 7
    B = rng.integers(0, H, size=(2048, M), dtype=np.int32)
    extra = rng.random(2048).astype(np.float32)
    jd, ji = _jax(luts, B, extra, k=50, variant=variant, precision="bf16")
    td, ti = _port(luts, B, extra, k=50, variant=variant, precision="bf16")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    t0 = np.full((NQ, 1), 1e9, np.float32)
    with pytest.raises(ValueError, match="hi-only"):
        _port(luts, B, extra, k=50, variant="key", t0=t0, precision="bf16")
    with pytest.raises(ValueError, match="hi-only"):
        sk.scan_topk_warm(_t(luts), _t(B.T), _t(extra), k=50, variant="key",
                          precision="bf16")
    with pytest.raises(ValueError, match="warm threshold"):
        _port(luts, B, extra, k=50, variant="key")


def test_select_variant_rule_and_override(monkeypatch):
    monkeypatch.delenv("LSQ_TPU_SELECT_VARIANT", raising=False)
    assert sk.select_variant(2048) == "grouped"
    assert sk.select_variant(2049) == "grouped_unsorted"
    for k in (100, 2048, 10_000):
        assert sk.select_variant(k) == sp.select_geometry(k)[0]
    monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", "key")
    assert sk.select_variant(10) == "key" == sp.select_geometry(10)[0]
    monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", "bogus")
    with pytest.raises(ValueError):
        sk.select_variant(10)


def test_select_kernel_fits_and_caps():
    assert sk.select_cap(1) == 128 and sk.select_cap(1000) == 1024
    assert sk.select_cap(10_000) == 10_112
    # K3's buffers at m=7, h=256, uint8 codes, 16 queries a block: what 227 KB
    # leave beside 112 KB of LUTs, two tiles of 512 rows x 11 bytes, 16
    # histograms, counts and thresholds and 1 KB reserved, in 8-byte keys a query.
    assert sk.k3_cap_keys(7, 256, 1, 16) == (
        227 * 1024 - 16 * 7168 - 2 * 512 * 11 - 16 * 1032 - 1024) // (8 * 16) == 695
    assert sk.select_kernel_fits(10_000, 7, 256)
    assert not sk.select_kernel_fits(14_000, 7, 256)
    assert not sk.select_kernel_fits(1000, 16, 4096)
    assert sk.kernel_holds("grouped", 10 ** 6, 7, 256)
    assert not sk.kernel_holds("sorted", 14_000, 7, 256)
    assert not sk.kernel_holds("grouped", 10, 16, 1024)


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    luts, B, extra, full = _case(seed=4)
    before = [launch_counts.read()[key] for key in ("scan_select", "scan_key")]
    d, i = sk.scan_select(_t(luts), _t(B.T), _t(extra), 20, unsorted=True)
    np.testing.assert_array_equal(d.numpy(), full[:, :20])
    sk.scan_key(_t(luts), _t(B.T), _t(extra), _t(full[:, 30:31]), 64)
    assert [launch_counts.read()[key] for key in ("scan_select", "scan_key")] == before
    with pytest.raises(ValueError, match="unsupported device"):
        sk.scan_select(_t(luts).to("meta"), _t(B.T).to("meta"), None, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.scan_key(_t(luts).to("meta"), _t(B.T).to("meta"), None,
                    torch.zeros((NQ, 1), device="meta"), 64)


def test_k3_geometry_follows_what_fits():
    """The queries a K3 block serves fall as `keep` grows: a buffer holds
    keep keys, one step's appends and room for keep/8 more (64 at least)."""
    assert [sk.k3_step(g) for g in (16, 8, 4, 2)] == [512, 1024, 1024, 1024]
    assert sk.k3_geometry(7, 256, 1, 111) == (16, 695)   # the pre-scan at k=1000
    assert sk.k3_geometry(7, 256, 4, 111)[0] == 8        # int32 codes: 16 KB tiles
    assert sk.k3_geometry(7, 256, 1, 777)[0] == 8        # the pre-scan at k=10001
    assert sk.k3_geometry(7, 256, 1, 1000)[0] == 8 == sk.k3_geometry(7, 256, 1, 1024)[0]
    assert sk.k3_geometry(7, 256, 4, 1000)[0] == 4
    assert sk.k3_geometry(7, 256, 1, 10_112)[0] == 2 == sk.k3_geometry(7, 256, 4, 10_112)[0]
    assert sk.k3_geometry(7, 256, 1, 12_000) == (0, 0)
    assert sk.k3_geometry(16, 4096, 1, 100) == (0, 0)    # the LUTs alone do not fit
    for m, h, cb, keep in [(7, 256, 1, 111), (7, 256, 4, 1024), (8, 256, 1, 5000),
                           (4, 16, 1, 10_112), (16, 256, 4, 300), (32, 1024, 1, 10)]:
        g, cap = sk.k3_geometry(m, h, cb, keep)
        if g:
            assert cap == sk.k3_cap_keys(m, h, cb, g) >= keep + sk.k3_step(g) + 64
            assert 8 * g * cap <= 227 * 1024
        bigger = [x for x in (16, 8, 4, 2) if x > g]
        assert all(sk.k3_cap_keys(m, h, cb, x) < keep + sk.k3_step(x) + max(64, keep // 8)
                   for x in bigger)
    assert sk.select_kernel_fits(1000, 7, 256) and not sk.select_kernel_fits(12_000, 7, 256)


@pytest.mark.parametrize("n,nq,g,sms,keep,want", [
    (62_500, 1000, 16, 132, 111, (2, 31_744)),     # the pre-scan: 63 groups x 2, one wave
    (62_500, 1, 16, 132, 111, (31, 2048)),         # one query: spread, 3441 candidates merged
    (62_500, 32, 8, 132, 777, (5, 13_312)),        # the merge's fast width bounds the split
    (1_000_000, 1000, 8, 132, 1000, (1, 1_000_448)),  # 125 groups fill the card: no split
    (1_000_000, 32, 8, 132, 1000, (17, 59_392)),
    (1_000_000, 1, 8, 132, 1000, (98, 10_240)),    # one query over most of the card
    (1_000_000, 1, 2, 132, 10_112, (28, 35_840)),  # deep k: a wide merge either way
    (1000, 2, 16, 132, 5, (1, 1024)),
    (1025, 1, 2, 4, 10, (2, 1024)),
])
def test_k3_segments_fill_the_card(n, nq, g, sms, keep, want):
    segments, rows = sk.k3_segments(n, nq, g, sms, keep)
    assert (segments, rows) == want
    assert rows % 1024 == 0 and (segments - 1) * rows < n <= segments * rows
    groups = -(-nq // g)
    assert segments * groups <= max(groups, 2 * sms + groups)


def _segmented(luts, B, extra, k, t0, rows, keep=None):
    """K3's control flow on the CPU: the per-segment plain version, then the
    merge."""
    keep = k if keep is None else keep
    seg = sk.scan_select_segments_reference(
        _t(luts), _t(B.T.astype(np.uint8)), None if extra is None else _t(extra), keep,
        None if t0 is None else _t(t0), rows)
    assert seg[0].shape == (luts.shape[0], -(-B.shape[0] // rows), keep)
    return sk.merge_segments(*seg, k)


@pytest.mark.parametrize("case", [
    # (n, n_inf, k, t0 rank or None or "tight", rows a segment, nq)
    (4096, 0, 64, None, 1024, NQ),       # ties across segment boundaries
    (4096, 300, 64, 40, 1024, NQ),       # fewer rows below t0 than k; +inf rows
    (4096, 4000, 150, None, 512, NQ),    # fewer finite rows than k
    (3000, 0, 700, None, 512, NQ),       # keep > a segment's rows; ragged last segment
    (4096, 0, 64, None, 256, 1),         # nq = 1
    (4096, 50, 64, "tight", 1024, NQ),   # t0 below every distance: nothing kept
])
def test_k3_segment_merge_matches_reference_and_pallas(case):
    """The segments' top-keeps merged are the top-keep of all rows: identical
    to `scan_select_reference` and to the Pallas `_select_kernel` ("sorted")
    in interpret mode, on integer LUTs where ties are common."""
    n, n_inf, k, rank, rows, nq = case
    luts, B, extra, full = _case(n=n, n_inf=n_inf, seed=n + k)
    luts, full = luts[:nq], full[:nq]
    if rank == "tight":
        t0 = np.full((nq, 1), full.min() - 1, np.float32)
    else:
        t0 = None if rank is None else full[:, rank - 1:rank].copy()
    want = sk.scan_select_reference(_t(luts), _t(B.T.astype(np.uint8)), _t(extra), k,
                                    None if t0 is None else _t(t0))
    got = _segmented(luts, B, extra, k, t0, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jd, ji = sp.fused_scan_topk(jnp.asarray(luts), jnp.asarray(B.T), jnp.asarray(extra),
                                tb=1024, interpret=True, k=k, variant="sorted",
                                t0=None if t0 is None else jnp.asarray(t0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
    assert (full[:, 1:] == full[:, :-1]).any()
    if rank == "tight":
        assert torch.isinf(got[0]).all() and (got[1] == -1).all()


def test_k3_segment_merge_of_a_wider_keep_is_value_exact():
    """ "unsorted": segments keep `select_cap(k)` rows each; the first k of the
    merge are the k smallest distances, and its ids are the reference's
    wherever the k-th value is not tied with the next. No extra term."""
    luts, B, _, _ = _case(seed=9)
    k, keep = 100, sk.select_cap(100)
    want = sk.scan_select_reference(_t(luts), _t(B.T), None, k + 1)
    got = _segmented(luts, B, None, k, None, 1024, keep=keep)
    assert torch.equal(got[0], want[0][:, :k])
    cert = want[0][:, k - 1] < want[0][:, k]
    assert torch.equal(got[1][cert], want[1][cert, :k])


def test_k4_geometry_follows_what_fits_and_the_batch():
    """K4 holds the most queries a block whose bf16 tables fit beside two
    tiles, and no more than the batch needs; a lane always loads 4 or 8
    queries; a tile holds as many steps as fit, 4 at most."""
    assert sk.k4_geometry(7, 256, 1, 1000) == (32, 8, 2)   # the card's shape: 112 KB
    assert sk.k4_geometry(7, 256, 4, 1000) == (32, 8, 2)   # int32 codes: 16 KB a step
    assert sk.k4_tile_steps(7, 256, 1, 32, 8, 2) == 4 and sk.k4_tile_steps(7, 256, 4, 32, 8, 2) == 3
    assert sk.k4_geometry(7, 256, 1, 32)[0] == 32 and sk.k4_geometry(7, 256, 1, 17)[0] == 32
    assert sk.k4_geometry(7, 256, 1, 16)[0] == 16 and sk.k4_geometry(7, 256, 1, 5)[0] == 8
    assert sk.k4_geometry(7, 256, 1, 1)[0] == 4 == sk.k4_geometry(7, 256, 1, 4)[0]
    assert sk.k4_geometry(16, 256, 1, 1000)[0] == 16       # 32 queries: 256 KB of tables
    assert sk.k4_geometry(16, 1024, 1, 1000)[0] == 4       # 128 KB at 4 queries
    assert sk.k4_geometry(16, 1024, 4, 1000) == (4, 4, 1)  # int32 codes, m=16: short steps
    assert sk.k4_geometry(16, 2048, 1, 1000) == (0, 0, 0)  # too large for any block
    assert sk.k4_geometry(3, 41, 4, 1000)[0] == 32         # h odd: the tail is padded
    assert sk.k4_group_elems(3, 41, 4) == 496 and sk.k4_group_elems(7, 256, 32) == 57_344
    assert [sk.k4_step(*g) for g in sk._K4_BUILT] == [512, 512, 1024, 2048, 512]
    # Every built geometry is one that some shape runs.
    assert {sk.k4_geometry(7, 256, 1, nq) for nq in (1000, 16, 8, 4)} | {
        sk.k4_geometry(16, 1024, 4, 1000)} == set(sk._K4_BUILT)
    for m, h, cb, nq in [(7, 256, 1, 1000), (7, 256, 4, 3), (16, 256, 4, 40), (32, 512, 1, 9),
                         (5, 40, 1, 100), (16, 1024, 4, 1000)]:
        g, kq, kr = sk.k4_geometry(m, h, cb, nq)
        steps = sk.k4_tile_steps(m, h, cb, g, kq, kr)
        assert (g, kq, kr) in sk._K4_BUILT and g % kq == 0 and 1 <= steps <= 4
        assert sk.k4_smem_bytes(m, h, cb, g, kq, kr, steps) + 1024 <= 227 * 1024
        assert steps == 4 or sk.k4_smem_bytes(m, h, cb, g, kq, kr, steps + 1) + 1024 > 227 * 1024
        assert sk.k4_group_elems(m, h, g) % 8 == 0 and sk.k4_step(g, kq, kr) % 16 == 0
        bigger = [x for x in (32, 16, 8) if x > g]
        assert all(x >= 2 * nq or all(sk.k4_tile_steps(m, h, cb, *b) == 0
                                      for b in sk._K4_BUILT if b[0] == x) for x in bigger)


@pytest.mark.parametrize("n,nq,g,tile,slots,want", [
    (1_000_000, 1000, 32, 2048, 132, (4, 251_904)),  # 32 groups x 4: one wave of 128 blocks
    (1_000_000, 32, 32, 2048, 132, (123, 8192)),     # one group over the whole card
    (1_000_000, 1, 4, 8192, 132, (123, 8192)),       # a lone query: every tile its own block
    (300_007, 32, 32, 1536, 132, (98, 3072)),
    (1000, 3, 4, 8192, 528, (1, 8192)),
    (20_000, 1, 4, 8192, 4, (3, 8192)),
])
def test_k4_segments_fill_the_card(n, nq, g, tile, slots, want):
    segments, rows = sk.k4_segments(n, nq, g, tile, slots)
    assert (segments, rows) == want
    assert rows % tile == 0 and (segments - 1) * rows < n <= segments * rows
    groups = -(-nq // g)
    assert segments * groups <= max(groups, 2 * slots + groups)


@pytest.mark.parametrize("nq,g", [(8, 4), (5, 4), (3, 8), (33, 32)])
def test_k4_interleave_lays_each_group_out_entry_major(nq, g):
    rng = np.random.default_rng(nq)
    m, h = 3, 5  # m*h*4 entries: no multiple of 8, so a group's tail is padded
    luts = torch.as_tensor(rng.normal(size=(nq, m, h)).astype(np.float32))
    hi = luts.to(torch.bfloat16)  # round to nearest even
    out = sk.k4_interleave(luts, g)
    groups = -(-nq // g)
    assert tuple(out.shape) == (groups, sk.k4_group_elems(m, h, g)) and out.is_contiguous()
    assert out.dtype == torch.bfloat16 and out.shape[1] % 8 == 0
    body = out[:, :m * h * g].reshape(groups, m * h, g).float()
    for q in range(groups * g):
        want = hi[q].reshape(-1).float() if q < nq else torch.zeros(m * h)
        assert torch.equal(body[q // g, :, q % g], want)
    assert (out[:, m * h * g:] == 0).all()


def _mixed_key_case():
    """65,536 rows, 6 queries: three with tables of zeros and ones, whose few
    distinct distances tie with the warm bound so the key certificate fails,
    and three with unit-normal tables, which it certifies."""
    rng = np.random.default_rng(31)
    n = 1 << 16
    luts = rng.normal(size=(6, M, H)).astype(np.float32)
    luts[::2] = rng.integers(0, 2, size=(3, M, H)).astype(np.float32)
    B = rng.integers(0, H, size=(n, M), dtype=np.int32)
    extra = np.zeros(n, np.float32)
    return luts, B, extra


def test_key_variant_certifies_each_query_on_its_own():
    luts, B, extra = _mixed_key_case()
    args = (_t(luts), _t(B.T.astype(np.uint8)), _t(extra))
    d, i, bad = sk.scan_topk_warm_masked(*args, k=512, variant="key")
    assert bad.tolist() == [True, False, True, False, True, False]
    _, _, any_bad = sk.scan_topk_warm(*args, k=512, variant="key", deferred=True)
    assert any_bad.ndim == 0 and bool(any_bad)
    want = sk.scan_topk_reference(*args, 512)
    ok = ~bad
    assert torch.equal(d[ok], want[0][ok]) and torch.equal(i[ok], want[1][ok])
    # The non-deferred form reruns the three failing queries and is exact.
    d2, i2 = sk.scan_topk_warm(*args, k=512, variant="key")
    assert torch.equal(d2, want[0]) and torch.equal(i2, want[1])
    d3, i3, rerun = sk.rerun_uncertified(*args, d, i, bad, k=512, variant="sorted")
    assert rerun == 3 and torch.equal(d3, want[0]) and torch.equal(i3, want[1])
    assert sk.rerun_uncertified(*args, d, i, torch.zeros(6, dtype=torch.bool), k=512,
                                variant="sorted") == (d, i, 0)


@pytest.mark.parametrize("variant,failing", [("key", 3), ("sorted", 3), ("grouped", 0)])
def test_kernel_route_reruns_only_the_queries_that_fail(monkeypatch, variant, failing):
    """The "key" route returns the ids of the "sorted" and the default
    routes, and the "rerun_warm" counter counts the queries that failed their
    certificate (the three whose k-th distance ties with the bound), not the
    batch."""
    from local_search_quantization_torch.ops import adc as tadc
    from local_search_quantization_torch.ops import launch_counts

    luts, B, extra = _mixed_key_case()
    Q = torch.arange(6, dtype=torch.float32)[:, None]

    def run(v):
        monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", v)
        return tadc._run_scan(lambda q: _t(luts)[q[:, 0].long()], Q, B, k=512,
                              extra=extra, topk_method="kernel")

    before = launch_counts.read()["rerun_warm"]
    res = run(variant)
    assert launch_counts.read()["rerun_warm"] - before == failing
    want = run("grouped")
    assert torch.equal(res.ids, want.ids) and torch.equal(res.dists, want.dists)


def test_k4_kernel_compare_is_the_truncated_key_compare():
    """The identity csrc/scan_key.cu rests on (`f32_key_fast`, `fast_bound`):
    (key(x) & M) < (key(t) & M) with M = -(1 << 13) is key'(x) < T, where
    key'(x) = bits ^ ((bits >> 31) & 0x7fffffff) and T = K if K > 0 or K is
    the least int32, else K - 1, for K = key(t) & M: on every bit pattern."""
    rng = np.random.default_rng(0)
    edge = np.array([0, -2 ** 31, 1, -1, 2 ** 31 - 1, -2 ** 31 + 1, 0x7F800000,
                     0xFF800000 - 2 ** 32, 8192, -8192, 8191, -8193, 0x7FC00000])
    bits = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 500_000), edge])
    bound = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 500_000), rng.permutation(edge)])
    for shift in (0, 5):  # also bounds close to the values
        t = bound if shift == 0 else bits + rng.integers(-20_000, 20_000, bits.size)
        t = np.clip(t, -2 ** 31, 2 ** 31 - 1)
        key = sk._f32_to_key(torch.as_tensor(bits).to(torch.int32).view(torch.float32))
        K = sk._f32_to_key(torch.as_tensor(t).to(torch.int32).view(torch.float32)) \
            & sk._KEY_MASK
        want = (key & sk._KEY_MASK) < K
        fast = torch.as_tensor(bits ^ ((bits >> 31) & 0x7FFFFFFF))
        T = torch.where((K > 0) | (K == -2 ** 31), K, K - 1)
        assert torch.equal(fast < T, want) and 0.05 < want.float().mean() < 0.95
