"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no JAX, so it runs on a machine that has only PyTorch (tests/conftest.py
imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from local_search_quantization_torch import _build
from local_search_quantization_torch import ivf as tivf
from local_search_quantization_torch.ops import icm, launch_counts, luts
from local_search_quantization_torch.ops.icm import _condition, cost_from_luts
from local_search_quantization_torch.ops.icm_kernels import (
    DISSECT_VARIANTS,
    _ils_loop,
    binaries_to_j_stacked,
    fused_icm_sweeps,
    fused_icm_sweeps_reference,
    icm_sweeps_dissect,
    icm_sweeps_dissect_reference,
    ils_encode_streamed,
    ils_encode_streamed_reference,
    ils_kernel_fits,
    ils_visits_needed,
)
from local_search_quantization_torch.ops import l2_probe
from local_search_quantization_torch.ops import select_kernels as sk
from local_search_quantization_torch.ops.select_kernels import (
    fused_scan_topk,
    scan_key,
    scan_key_reference,
    scan_select,
    scan_select_reference,
    scan_topk,
    scan_topk_fits,
    scan_topk_reference,
    select_cap,
    select_kernel_fits,
)
from local_search_quantization_torch.utils import kernel_cases

pytestmark = pytest.mark.gpu


def _counts(*keys):
    """The counters `keys` of `launch_counts.read()`, as a list."""
    c = launch_counts.read()
    return [c[key] for key in keys]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(dev, n, d, m, h, R, npert, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32) * 10
        C = rng.normal(size=(m, h, d)).astype(np.float32) * 3
    X, C = torch.as_tensor(X, device=dev), torch.as_tensor(C, device=dev)
    return (luts.get_unaries(X, C), luts.get_binaries(C), (X * X).sum(-1),
            torch.as_tensor(rng.integers(0, h, (n, m), dtype=np.int32), device=dev),
            torch.as_tensor(np.stack([rng.permutation(m) for _ in range(R)])
                            .astype(np.int32), device=dev),
            torch.as_tensor(rng.random((R, n, m), dtype=np.float32), device=dev),
            torch.as_tensor(rng.integers(0, h, (R, n, npert), dtype=np.int32),
                            device=dev))


@pytest.mark.parametrize("shape", [
    # (n, d, m, h, rounds, npert, integer)
    (4096, 32, 7, 64, 3, 3, True),
    (3001, 16, 4, 20, 2, 2, False),  # h < 32: idle lanes; ragged last block
    (2048, 64, 8, 256, 2, 4, False),
    (1024, 16, 3, 300, 2, 1, False),  # 16 a lane, one element each: a masked tail
    (2048, 16, 6, 96, 2, 2, False),  # 4 a lane, one 16-byte load a row
    (1024, 16, 7, 512, 2, 3, False),  # 16 a lane: 4 rows in flight, two chunks at m=7
    (512, 16, 5, 1024, 2, 2, False),  # 32 a lane: 2 rows in flight, two chunks
    (512, 16, 4, 1000, 2, 2, False),  # 32 a lane, one element each
    (2048, 16, 1, 64, 3, 1, False),  # m=1: no pair rows; every visit after the first skipped
    (2048, 16, 2, 256, 3, 2, False),  # m=2: one pair row a visit
    (4096, 32, 7, 256, 3, 4, True),  # 8 a lane, the SIFT lane map
    (2048, 16, 5, 136, 2, 2, False),  # 8 a lane, one 16-byte load a row, idle lanes
])
def test_k1_kernel_matches_plain_version(cuda, shape):
    n, d, m, h, R, npert, integer = shape
    args = _k1_inputs(cuda, n, d, m, h, R, npert, integer)
    before = _counts("ils_encode")[0]
    got = ils_encode_streamed(*args, icmiter=2, milestones=(1, R), with_stats=True)
    want = ils_encode_streamed_reference(*args, icmiter=2, milestones=(1, R),
                                         with_stats=True)
    assert _counts("ils_encode")[0] == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_k1_wrapper_aligns_an_off_boundary_table(cuda):
    """A contiguous f32 table that starts 4 bytes past a 16-byte boundary:
    K1's wrapper splits it into bf16 tables of its own, which are aligned
    (the kernel's entry refuses any other), so K1 gives the plain version's
    outputs."""
    args = list(_k1_inputs(cuda, 2048, 32, 7, 256, 2, 4, False))
    buf = torch.empty(args[1].numel() + 1, device=cuda)
    args[1] = buf[1:].view(args[1].shape).copy_(args[1])
    assert args[1].is_contiguous() and args[1].data_ptr() % 16 == 4
    kw = dict(icmiter=3, milestones=(1, 2), with_stats=True)
    got = ils_encode_streamed(*args, **kw)
    want = ils_encode_streamed_reference(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_k1_skips_visits_and_keeps_every_output_on_a_converging_fixture(cuda):
    """icmiter=8 on continuous data: the rows converge within a round, so
    many visits find their inputs unchanged and K1 skips them; the needed
    count is below the total and all five outputs are the plain version's."""
    R, icmiter = 3, 8
    args = _k1_inputs(cuda, 4096, 32, 7, 256, R, 4, False, seed=4)
    needed = ils_visits_needed(*args, icmiter=icmiter)
    assert 0 < int(needed.sum()) < needed.numel()
    kw = dict(icmiter=icmiter, milestones=(1, 2, R), with_stats=True)
    got = ils_encode_streamed(*args, **kw)
    want = ils_encode_streamed_reference(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def f32_loop(unaries, binaries, xsq, B0, orders, pert_keys, pert_codes, *, icmiter,
             milestones=()):
    """K1's loop on the f32 table, the function K1 had before its table was
    rounded: each visit the unary and then binaries[k, j][B_k] for k != j
    in k order, each round accepted on the exact f32 cost. (B, cost, ms_B,
    ms_cost, stats) as `ils_encode_streamed_reference`."""
    return _ils_loop(unaries, xsq, B0, orders, pert_keys, pert_codes, icmiter,
                     lambda cur, j: _condition(unaries[:, j], binaries[:, j], cur, j),
                     lambda B: cost_from_luts(xsq, unaries, binaries, B), tuple(milestones))


def bf16_decisive_tables(n, m, h, seed):
    """K1's inputs where bf16 rounding decides argmins, as numpy arrays
    (unaries [n, m, h], binaries [m, m, h, h], xsq [n], B0 [n, m]).

    The table is symmetric (b[k, j] = b[j, k]^T) and each entry is an
    integer in [130, 133) plus a residual r = q/64, |q| <= 31: bf16 holds
    the integer exactly and rounds r away (hi = the integer), lo = r is
    exact in bf16, and every f32 sum of these values is exact in any order.
    The unaries are integers in [0, 3). With three integer levels the
    integer parts often tie across candidates, so a visit on the bf16 table
    takes the lowest tied candidate where the f32 table's residuals pick
    another.
    """
    rng = np.random.default_rng(seed)
    b = (rng.integers(130, 133, (m, m, h, h))
         + rng.integers(-31, 32, (m, m, h, h)) / 64).astype(np.float32)
    # Keep the entries with (k, a) <= (j, c) in (codebook, code) order and
    # mirror the rest: b[k, j, a, c] = b[j, k, c, a].
    kh = np.arange(m)[:, None] * h + np.arange(h)[None, :]
    keep = kh[:, None, :, None] <= kh[None, :, None, :]
    b = np.where(keep, b, b.transpose(1, 0, 3, 2))
    u = rng.integers(0, 3, (n, m, h)).astype(np.float32)
    xsq = rng.integers(1000, 2000, n).astype(np.float32)
    return u, b, xsq, rng.integers(0, h, (n, m), dtype=np.int32)


def test_k1_follows_bf16_rounding_on_the_card(cuda):
    """On tables where bf16 rounding decides argmins, K1 gives its plain
    version's five outputs and the f32 loop other codes."""
    n, m, h, R, npert = 2048, 4, 256, 3, 2
    u, b, xsq, B0 = bf16_decisive_tables(n, m, h, seed=1)
    rng = np.random.default_rng(2)
    args = tuple(torch.as_tensor(a, device=cuda) for a in (
        u, b, xsq, B0, np.stack([rng.permutation(m) for _ in range(R)]).astype(np.int32),
        rng.random((R, n, m), dtype=np.float32),
        rng.integers(0, h, (R, n, npert), dtype=np.int32)))
    kw = dict(icmiter=2, milestones=(1, R), with_stats=True)
    got = ils_encode_streamed(*args, **kw)
    want = ils_encode_streamed_reference(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    f32 = f32_loop(*args, icmiter=2, milestones=(1, R))
    assert (f32[0] != got[0]).any()


def test_k1_refuses_milestones_it_would_leave_unwritten_on_the_card(cuda):
    """The audit's repair: K1 snapshots a milestone only at a round the
    encode reaches, into `torch.empty` outputs, so the wrapper refuses
    milestones outside [1, rounds], repeated or out of order before it
    launches; a valid list still gives the plain version's outputs."""
    args = _k1_inputs(cuda, 512, 16, 4, 32, 2, 2, False)
    before = _counts("ils_encode")
    for milestones in ((0,), (3,), (2, 1), (1, 1)):
        with pytest.raises(ValueError, match="milestones"):
            ils_encode_streamed(*args, icmiter=1, milestones=milestones)
    assert _counts("ils_encode") == before
    got = ils_encode_streamed(*args, icmiter=1, milestones=(1, 2))
    want = ils_encode_streamed_reference(*args, icmiter=1, milestones=(1, 2))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_k1_dead_rows_never_accept(cuda):
    args = list(_k1_inputs(cuda, 512, 16, 4, 32, 3, 2, False))
    args[2] = args[2].clone()
    args[2][256:] = -1e30
    B, cost, _, _, stats = ils_encode_streamed(*args, icmiter=1, with_stats=True)
    assert torch.equal(B[256:], args[3][256:])
    assert (stats[:, 1] >= 256).all()


def _k2_inputs(dev, n, nq, m, h, seed, n_inf=0):
    rng = np.random.default_rng(seed)
    lut = torch.as_tensor(rng.integers(-4, 5, (nq, m, h)).astype(np.float32), device=dev)
    B = rng.integers(0, h, (n, m), dtype=np.int32)
    extra = rng.integers(0, 3, n).astype(np.float32)
    if n_inf:
        extra[rng.choice(n, n_inf, replace=False)] = np.inf
    return lut, torch.as_tensor(B.T.copy(), device=dev), torch.as_tensor(extra, device=dev)


@pytest.mark.parametrize("n,nq,m,h,k,n_inf", [
    (200_000, 9, 7, 256, 100, 0),   # tie-heavy integer distances
    (5000, 5, 7, 256, 300, 4800),   # fewer finite rows than k: sentinels
    (70_000, 3, 4, 16, 1000, 0),    # small h: huge tie blocks at the k-th value
    (1000, 2, 3, 300, 1000, 0),     # k == n, int32 codes only (h > 256)
])
def test_k2_kernel_matches_plain_version(cuda, n, nq, m, h, k, n_inf):
    lut, Bt, extra = _k2_inputs(cuda, n, nq, m, h, seed=n, n_inf=n_inf)
    want = scan_topk_reference(lut, Bt, extra, k)
    layouts = (torch.int32,) if h > 256 else (torch.uint8, torch.int32)
    for dtype in layouts:
        staged, dense = _counts("k2_filter", "scan_topk_dense")
        got = scan_topk(lut, Bt.to(dtype).contiguous(), extra, k)
        # n >= 65,536: one filter launch, and a dense one if a query failed
        # its certificate; smaller n: the dense path alone.
        assert _counts("k2_filter")[0] == staged + (n >= 1 << 16)
        if n < 1 << 16:
            assert _counts("scan_topk_dense")[0] == dense + 1
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_k2_continuous_distances_and_no_extra(cuda):
    rng = np.random.default_rng(3)
    lut = torch.as_tensor(rng.normal(size=(40, 7, 256)).astype(np.float32), device=cuda)
    Bt = torch.as_tensor(rng.integers(0, 256, (7, 300_000)).astype(np.uint8), device=cuda)
    want = scan_topk_reference(lut, Bt, None, 1000)
    got = scan_topk(lut, Bt, None, 1000)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


# K2's dense path alone (`scan_topk_dense`): the shapes of a certificate's
# reruns (few queries over many rows, each row cut into segments), one
# segment a query, ties across segment edges, +inf rows and k == n.
_RERUN_N = (1 << 22) + 13  # odd: no whole number of segments


def _dense_same(lut, Bt, extra, k, want=None):
    """scan_topk_dense bit for bit against the plain version, one launch a
    chunk of queries."""
    if want is None:
        want = scan_topk_reference(lut, Bt, extra, k)
    nq, n = lut.shape[0], Bt.shape[1]
    qb = max(1, min(nq, sk._DENSE_QUERIES, sk._SCRATCH_ELEMS // n))
    before = _counts("scan_topk_dense")[0]
    d, i = sk.scan_topk_dense(lut, Bt, extra, k)
    assert _counts("scan_topk_dense")[0] == before + -(-nq // qb)
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])


@pytest.fixture(scope="module")
def dense_rerun():
    """26 queries over 2^22 + 13 rows, uint8 codes. Queries 0, 2, 4, ... each
    have a planted block of 12 rows with one row's codes and extra, spread
    over the base and lowered to the query's smallest distance, as the
    near-duplicates of a corpus tie; the others are continuous. And the
    plain answer at each k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    nq, n, m, h = 26, _RERUN_N, 7, 256
    lut = rng.normal(size=(nq, m, h)).astype(np.float32)
    B = rng.integers(0, h, (m, n), dtype=np.uint8)
    extra = (rng.random(n) * 4).astype(np.float32)
    for q in range(0, nq, 2):
        rows = rng.choice(n, 12, replace=False)
        B[:, rows] = B[:, rows[:1]]
        extra[rows] = extra[rows[0]]
        lut[q, np.arange(m), B[:, rows[0]]] -= 10.0
    lut, Bt, extra = (torch.as_tensor(a, device=dev) for a in (lut, B, extra))
    want = {k: scan_topk_reference(lut, Bt, extra, k) for k in (1, 10, 1000)}
    return lut, Bt, extra, want


@pytest.mark.parametrize("k", [1, 10, 1000])
@pytest.mark.parametrize("nq", [1, 3, 21, 26])
def test_k2_dense_at_the_rerun_shape(cuda, dense_rerun, nq, k):
    lut, Bt, extra, want = dense_rerun
    _dense_same(lut[:nq].contiguous(), Bt, extra, k, (want[k][0][:nq], want[k][1][:nq]))


@pytest.mark.parametrize("n,k", [(65_537, 100), (65_537, 1000), (4000, 1000)])
def test_k2_dense_many_queries(cuda, n, k):
    """300 queries, launched as 256 and then 44: over 65,537 rows a few
    segments a query (2 * SMs > 256), over one tile's 4000 rows one segment
    a query."""
    lut, Bt, extra = _k2_inputs(cuda, n, 300, 7, 256, seed=k)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    segs = sk.dense_segments(n, 256, sms)[0]
    assert segs == 1 if n <= sk._DENSE_TILE else segs > 1
    _dense_same(lut, Bt.to(torch.uint8).contiguous(), extra, k)


@pytest.mark.parametrize("nq,k", [(1, 25), (3, 25), (21, 10)])
def test_k2_dense_tie_block_across_segment_edges(cuda, nq, k):
    """A block of 40 rows with one row's codes and extra, lowered below
    every other row, from 5 rows before the first segment edge past the
    middle of the base: the k-th distance is tied beyond the edge, and the
    k lowest ids of the block are the answer."""
    n = _RERUN_N
    lut, Bt, extra = _k2_inputs(cuda, n, nq, 7, 256, seed=nq)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows = sk.dense_segments(n, nq, sms)[1]
    edge = (n // 2 // rows + 1) * rows
    Bt[:, edge - 5:edge + 35] = Bt[:, edge - 5:edge - 4]
    extra[edge - 5:edge + 35] = -1000.0
    want = scan_topk_reference(lut, Bt, extra, k)
    assert torch.equal(want[1][:, -1], torch.full((nq,), edge - 5 + k - 1, device=cuda,
                                                  dtype=torch.int32))
    _dense_same(lut, Bt.to(torch.uint8).contiguous(), extra, k, want)


@pytest.mark.parametrize("k", [1, 10, 1000])
def test_k2_dense_all_rows_tied(cuda, k):
    n, nq = (1 << 20) + 7, 3
    lut = torch.zeros((nq, 7, 256), device=cuda)
    Bt = torch.randint(0, 256, (7, n), device=cuda, dtype=torch.uint8)
    extra = torch.full((n,), 2.5, device=cuda)
    want = scan_topk_reference(lut, Bt, extra, k)
    assert torch.equal(want[1], torch.arange(k, device=cuda, dtype=torch.int32).expand(nq, k))
    _dense_same(lut, Bt, extra, k, want)


@pytest.mark.parametrize("finite", [0, 500, 5000])
def test_k2_dense_inf_rows(cuda, finite):
    """+inf rows (deleted) everywhere but `finite` rows: at k=1000 the
    finite rows, then (+inf, -1) slots where they are fewer than k."""
    n, nq = (1 << 20) + 3, 5
    lut, Bt, extra = _k2_inputs(cuda, n, nq, 7, 256, seed=finite)
    keep = torch.randperm(n, device=cuda)[:finite]
    extra = torch.where(torch.isin(torch.arange(n, device=cuda), keep), extra, float("inf"))
    _dense_same(lut, Bt.to(torch.uint8).contiguous(), extra, 1000)


@pytest.mark.parametrize("n,m,h,dtype", [(1000, 3, 300, torch.int32),
                                         (4097, 7, 256, torch.uint8)])
def test_k2_dense_k_equals_n(cuda, n, m, h, dtype):
    lut, Bt, extra = _k2_inputs(cuda, n, 2, m, h, seed=n)
    _dense_same(lut, Bt.to(dtype).contiguous(), extra, n)


def test_k2_dense_makes_no_host_sync(cuda):
    """`scan_topk_dense` under `torch.cuda.set_sync_debug_mode("error")`:
    its digits are picked on the card, so the call never waits for it."""
    import warnings

    lut, Bt, extra = _k2_inputs(cuda, 300_000, 21, 7, 256, seed=8)
    Bt = Bt.to(torch.uint8).contiguous()
    want = scan_topk_reference(lut, Bt, extra, 10)
    sk.scan_topk_dense(lut, Bt, extra, 10)  # builds the library
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        # A process's first switch of the mode may itself sync, in torch.
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, i = sk.scan_topk_dense(lut, Bt, extra, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])


def test_k2_dense_rules_mirror_the_library(cuda):
    """The dense path's tile and workspace size in Python agree with
    csrc/scan_topk.cu's."""
    lib = _build.load("scan_topk")
    assert lib.lsq_dense_tile() == sk._DENSE_TILE
    for nq, n in ((1, 4000), (1, 10_000_000), (21, 10_000_000), (256, 1 << 20)):
        segs, rows = sk.dense_segments(n, nq, 132)
        assert lib.lsq_dense_work_bytes(nq, segs, rows) == sk.dense_work_bytes(nq, segs, rows)


def test_wrappers_reject_bad_inputs(cuda):
    lut, Bt, extra = _k2_inputs(cuda, 100, 2, 3, 16, seed=1)
    with pytest.raises(ValueError):
        scan_topk(lut.double(), Bt, extra, 5)
    with pytest.raises(ValueError):
        scan_topk(lut, Bt.t(), extra, 5)  # not contiguous [m, n]
    args = list(_k1_inputs(cuda, 64, 8, 3, 16, 1, 1, True))
    args[3] = args[3].long()
    with pytest.raises(ValueError):
        ils_encode_streamed(*args, icmiter=1)


def _sweeps_inputs(dev, n, d, m, h, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32) * 10
        C = rng.normal(size=(m, h, d)).astype(np.float32) * 3
    X, C = torch.as_tensor(X, device=dev), torch.as_tensor(C, device=dev)
    return (torch.as_tensor(rng.integers(0, h, (n, m), dtype=np.int32), device=dev),
            luts.get_unaries(X, C), luts.get_binaries(C).to(torch.bfloat16),
            torch.as_tensor(rng.permutation(m).astype(np.int32), device=dev))


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("shape", [
    # (n, d, m, h, icmiter, integer)
    (4096, 32, 7, 256, 2, True),
    (3001, 16, 4, 20, 3, False),  # h < 32: idle lanes; ragged last block
    (2048, 64, 8, 256, 4, False),
    (1024, 16, 3, 300, 2, False),  # h > 256: 16 candidates per lane, element-wise loads
    (512, 8, 1, 64, 2, False),  # m = 1: no pair terms
    (2048, 16, 5, 40, 3, False),  # h no multiple of 32: two a lane, lanes 20-31 idle
    (2048, 16, 4, 512, 2, False),  # 16 a lane: two 16-byte loads a row
    (1024, 16, 10, 256, 2, False),  # m - 1 = 9 rows a visit: two chunks of row loads
    (512, 8, 2, 1000, 2, False),  # 32 a lane, a masked tail
])
def test_icm_sweeps_kernels_match_plain_version(cuda, variant, shape):
    n, d, m, h, icmiter, integer = shape
    args = _sweeps_inputs(cuda, n, d, m, h, integer)
    before = _counts(f"icm_sweeps_{variant}")[0]
    got = fused_icm_sweeps(*args, icmiter=icmiter, variant=variant)
    want = fused_icm_sweeps_reference(*args, icmiter=icmiter, variant=variant)
    assert _counts(f"icm_sweeps_{variant}")[0] == before + 1
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got != args[0]).any()


def test_fused_ils_encode_on_the_card_runs_k5_every_round(cuda):
    """ils_encode(condition_mode="fused") on CUDA tensors: one K5 launch per
    ILS round, never K1, and the accept invariant."""
    B0, _, _, _ = _sweeps_inputs(cuda, 2048, 32, 7, 64, False)
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(2048, 32)).astype(np.float32), device=cuda)
    C = torch.as_tensor(rng.normal(size=(7, 64, 32)).astype(np.float32), device=cuda)
    k1, k5 = _counts("ils_encode", "icm_sweeps_v2")
    gen = torch.Generator(device=cuda).manual_seed(0)
    res = icm.ils_encode(gen, X, B0, C, ilsiter=5, icmiter=2, npert=2,
                         condition_mode="fused")
    assert _counts("ils_encode", "icm_sweeps_v2") == [k1, k5 + 5]
    cost0 = icm.cost_from_luts((X * X).sum(-1), luts.get_unaries(X, C),
                               luts.get_binaries(C), B0)
    assert (res.cost <= cost0).all() and (res.cost < cost0).any()


def test_ils_kernel_fits_mirrors_the_library(cuda):
    """The pure shape rule that routes "kernel" to "matmul" agrees with
    the K1 library's own size functions."""
    lib = _build.load("ils_encode")
    for m in (1, 4, 7, 8, 16, 32):
        for h in (16, 256, 512, 1000, 1024, 1025, 2048):
            lib_fits = (lib.lsq_ils_smem_bytes(m, h) <= 227 * 1024
                        and h <= lib.lsq_ils_max_h())
            assert ils_kernel_fits(m, h) == lib_fits, (m, h)


def test_icm_sweeps_wrapper_rejects_bad_inputs(cuda):
    B, u, b, order = _sweeps_inputs(cuda, 64, 8, 3, 16, True)
    with pytest.raises(ValueError):
        fused_icm_sweeps(B, u, b.float(), order, icmiter=1)  # f32 tables
    with pytest.raises(ValueError):
        fused_icm_sweeps(B.long(), u, b, order, icmiter=1)
    with pytest.raises(ValueError):
        fused_icm_sweeps(B, u.transpose(1, 2).contiguous().transpose(1, 2), b, order,
                         icmiter=1)  # not contiguous
    with pytest.raises(ValueError):
        fused_icm_sweeps(B, u, b, order, icmiter=1, variant="v3")


@pytest.mark.parametrize("variant", DISSECT_VARIANTS)
@pytest.mark.parametrize("shape", [
    # (n, d, m, h, icmiter, integer)
    (4096, 32, 7, 256, 2, True),
    (3001, 16, 4, 20, 3, False),  # h < 32: idle lanes; ragged last block
    (1024, 16, 3, 300, 2, False),  # h > 256: 16 candidates per lane
    (2048, 16, 5, 40, 2, False),  # two candidates a lane: the sink's lane order
    (1024, 16, 4, 512, 2, False),  # 16 a lane by vector loads
])
def test_k7_matches_plain_version(cuda, variant, shape):
    """Codes identical; the sink identical for "nowrite", within 1e-5 of the
    plain version (relative, plus 1e-5 of its mean magnitude) for the score
    sums; "full" identical to K5 on the same inputs."""
    n, d, m, h, icmiter, integer = shape
    B, u, b16, order = _sweeps_inputs(cuda, n, d, m, h, integer)
    stacked = binaries_to_j_stacked(b16).contiguous()
    before = launch_counts.read()["dissect"][variant]
    codes, sink = icm_sweeps_dissect(B, u, stacked, order, icmiter=icmiter, variant=variant)
    want_codes, want_sink = icm_sweeps_dissect_reference(B, u, b16, order, icmiter=icmiter,
                                                         variant=variant)
    assert launch_counts.read()["dissect"][variant] == before + 1
    torch.testing.assert_close(codes, want_codes, rtol=0, atol=0)
    if variant in ("noargmin", "mmonly"):
        torch.testing.assert_close(sink, want_sink, rtol=1e-5,
                                   atol=1e-5 * float(want_sink.abs().mean()))
    else:
        torch.testing.assert_close(sink, want_sink, rtol=0, atol=0)
    if variant == "full":
        k5 = fused_icm_sweeps(B, u, b16, order, icmiter=icmiter, variant="v2")
        torch.testing.assert_close(codes, k5, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,wide", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False), (torch.float32, True)])
def test_l2_probe_sums_the_rows_it_claims(cuda, dtype, wide):
    """One run of the probe on an integer table (every sum exact): each
    warp's sum equals the plain version's over the same hashed rows."""
    elems = 512 // torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randint(-2, 3, (12_544, elems), generator=gen, device=cuda).to(dtype)
    before = _counts("l2_gather")[0]
    got = l2_probe.l2_gather(table, warps=2048, rows_per_warp=16, wide=wide, seed=5)
    want = l2_probe.l2_gather_reference(table, warps=2048, rows_per_warp=16, seed=5)
    assert _counts("l2_gather")[0] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    rate = l2_probe.l2_gather_rate(512, 12_544 * 512, dtype, wide=wide, device=cuda,
                                   warps=1024, rows_per_warp=32, reps=2)
    assert rate["gbps"] > 0 and rate["bytes"] == 1024 * 32 * 512


def _kth_t0(lut, Bt, extra, rank):
    """Each query's rank-th smallest distance (1-based) as a [nq, 1] bound."""
    d, _ = scan_select_reference(lut, Bt, extra, rank)
    return d[:, rank - 1:rank].contiguous()


@pytest.mark.parametrize("n,nq,m,h,k,n_inf,warm", [
    (200_000, 9, 7, 256, 100, 0, False),     # tie-heavy integer distances
    (200_000, 9, 7, 256, 1000, 0, True),     # the warm bound, ties at t0
    (5000, 5, 7, 256, 300, 4800, False),     # fewer finite rows than k
    (70_000, 3, 4, 16, 1000, 0, False),      # small h: huge tie blocks
    (300_000, 4, 7, 256, 10_000, 1000, True),  # the deep-k buffer
    (3000, 2, 3, 300, 500, 0, False),        # int32 codes only (h > 256)
    (100_003, 1, 7, 256, 111, 0, False),     # nq = 1; n no multiple of 16: scalar staging
    (100_003, 32, 7, 256, 111, 50, True),    # 16 queries a block, two groups
    (150_000, 17, 7, 256, 1000, 0, False),   # a partial group; a ragged last tile
    (1_000, 3, 7, 256, 2000, 0, False),      # k > n: one short segment
    (40_000, 5, 16, 256, 300, 0, False),     # m = 16: fewer queries a block
])
def test_k3_kernel_matches_plain_version(cuda, n, nq, m, h, k, n_inf, warm):
    """K3 against its plain version: "sorted" identical, and identical to K2
    cut at t0; "unsorted" value-exact, ids identical where the k-th value is
    not tied with the next."""
    lut, Bt, extra = _k2_inputs(cuda, n, nq, m, h, seed=n + k, n_inf=n_inf)
    t0 = _kth_t0(lut, Bt, extra, min(n, k + k // 2 + 7)) if warm else None
    want_d, want_i = scan_select_reference(lut, Bt, extra, min(n, k + 1), t0)
    kk = min(k, n)
    layouts = (torch.int32,) if h > 256 else (torch.uint8, torch.int32)
    for dtype in layouts:
        Bc = Bt.to(dtype).contiguous()
        before = _counts("scan_select")[0]
        d, i = scan_select(lut, Bc, extra, k, t0)
        assert _counts("scan_select")[0] == before + 1
        torch.testing.assert_close(d, want_d[:, :kk], rtol=0, atol=0)
        torch.testing.assert_close(i, want_i[:, :kk], rtol=0, atol=0)
        k2_d, k2_i = fused_scan_topk(lut, Bc, extra, k=k, t0=t0, variant="grouped")
        assert torch.equal(k2_d[:, :kk], d) and torch.equal(k2_i[:, :kk], i)
        ud, ui = scan_select(lut, Bc, extra, k, t0, unsorted=True)
        torch.testing.assert_close(ud, want_d[:, :kk], rtol=0, atol=0)
        if kk < want_d.shape[1]:
            cert = want_d[:, kk - 1] < want_d[:, kk]
            assert torch.equal(ui[cert], want_i[cert, :kk])


def test_k3_continuous_distances_warm_and_strided_sample(cuda):
    rng = np.random.default_rng(5)
    lut = torch.as_tensor(rng.normal(size=(33, 7, 256)).astype(np.float32), device=cuda)
    Bt = torch.as_tensor(rng.integers(0, 256, (7, 400_000)).astype(np.uint8), device=cuda)
    extra = torch.as_tensor(rng.random(400_000).astype(np.float32), device=cuda)
    Bs, es = Bt[:, ::16].contiguous(), extra[::16].contiguous()
    t0 = scan_select(lut, Bs, es, 111)[0][:, 110:111].contiguous()
    for unsorted in (False, True):
        got = scan_select(lut, Bt, extra, 1000, t0, unsorted=unsorted)
        want = scan_select_reference(lut, Bt, extra, 1000, t0)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def _hits(lut, Bt, extra, t0):
    """Every K4 hit of each query, ascending ids (a cap no row can fill)."""
    ids, count = scan_key_reference(lut, Bt, extra, t0, Bt.shape[1])
    return ids, count


@pytest.mark.parametrize("n,nq,m,h,rank,cap", [
    (200_000, 9, 7, 256, 1400, 2560),   # integer ties at t0; no overflow
    (70_000, 5, 4, 16, 800, 1024),      # small h: giant tie blocks
    (100_000, 3, 7, 256, 3000, 1024),   # overflow: count >= cap
    (3000, 2, 3, 300, 200, 512),        # int32 codes only (h > 256)
    (300_007, 1, 7, 256, 1400, 2560),   # nq = 1 (4 queries a block); ragged tiles
    (300_007, 32, 7, 256, 1400, 2560),  # one full group of 32; n no multiple of 16
    (150_000, 70, 7, 256, 900, 2048),   # three groups, the last partial
    (200_001, 33, 5, 40, 700, 2048),    # h = 40: 80-byte rows of a codebook's table
    (50_000, 20, 16, 256, 500, 1024),   # m = 16: 16 queries a block
    (20_000, 6, 16, 1024, 300, 1024),   # int32 codes, wide tables: 4 queries, short steps
])
def test_k4_kernel_matches_plain_version(cuda, n, nq, m, h, rank, cap):
    lut, Bt, extra = _k2_inputs(cuda, n, nq, m, h, seed=n + rank, n_inf=n // 50)
    t0 = _kth_t0(lut, Bt, extra, rank)
    all_ids, all_count = _hits(lut, Bt, extra, t0)
    want_ids, want_count = scan_key_reference(lut, Bt, extra, t0, cap)
    layouts = (torch.int32,) if h > 256 else (torch.uint8, torch.int32)
    for dtype in layouts:
        before = _counts("scan_key")[0]
        ids, count = scan_key(lut, Bt.to(dtype).contiguous(), extra, t0, cap)
        assert _counts("scan_key")[0] == before + 1
        assert torch.equal(count, want_count) and torch.equal(count, all_count)
        filled = torch.clamp(count, max=cap)
        for q in range(nq):
            got = torch.sort(ids[q, :filled[q]])[0]
            assert (ids[q, filled[q]:] == -1).all()
            if count[q] <= cap:
                assert torch.equal(got, want_ids[q, :filled[q]])
            else:  # overflow: cap distinct hits, in no fixed order
                assert torch.isin(got, all_ids[q, :count[q]]).all()
                assert torch.unique(got).numel() == cap
    # The whole key variant (re-rank, sort, certificate) on the card against
    # the same call on CPU copies, which runs the plain version.
    got = fused_scan_topk(lut, Bt, extra, k=rank // 2, t0=t0, variant="key",
                          append_cap=cap)
    want = fused_scan_topk(lut.cpu(), Bt.cpu(), extra.cpu(), k=rank // 2,
                           t0=t0.cpu(), variant="key", append_cap=cap)
    assert bool(got[2]) == bool(want[2])
    if not bool((want_count >= cap).any()):
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    if not bool(want[2]):  # certified: the exact top-k, K2's answer
        exact = scan_select_reference(lut, Bt, extra, rank // 2)
        assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])


# The shape at which `k4_geometry` picks each built geometry: (nq, m, h), and
# whether uint8 codes run there beside int32.
_K4_SHAPE_OF = {(32, 8, 2): (37, 7, 256, True), (16, 4, 4): (13, 7, 256, True),
                (8, 4, 4): (7, 7, 256, True), (4, 4, 4): (3, 7, 256, True),
                (4, 4, 1): (6, 16, 1024, False)}


@pytest.mark.parametrize("geometry", sk._K4_BUILT)
def test_k4_every_built_geometry_matches_plain_version(cuda, geometry, monkeypatch):
    """Each (queries a block, queries a lane, rows a lane) that is built, at a
    shape that runs it and at every tile length it fits there, with and
    without overflow."""
    nq, m, h, bytes_too = _K4_SHAPE_OF[geometry]
    lut, Bt, extra = _k2_inputs(cuda, 120_007, nq, m, h, seed=3, n_inf=500)
    t0 = _kth_t0(lut, Bt, extra, 900)
    for cap in (2048, 256):
        want_ids, want_count = scan_key_reference(lut, Bt, extra, t0, cap)
        for dtype in (torch.uint8, torch.int32) if bytes_too else (torch.int32,):
            codes = Bt.to(dtype).contiguous()
            assert sk.k4_geometry(m, h, codes.element_size(), nq) == geometry
            monkeypatch.setattr(sk, "_K4_MAX_TILE_STEPS", 4)
            fit = sk.k4_tile_steps(m, h, codes.element_size(), *geometry)
            for steps in range(1, fit + 1):
                monkeypatch.setattr(sk, "_K4_MAX_TILE_STEPS", steps)
                ids, count = scan_key(lut, codes, extra, t0, cap)
                assert torch.equal(count, want_count)
                ok = count <= cap
                assert torch.equal(torch.sort(ids[ok], dim=1)[0],
                                   torch.sort(want_ids[ok], dim=1)[0])
                assert ((ids[~ok] >= 0).all()
                        and all(torch.unique(r).numel() == cap for r in ids[~ok]))


def test_k4_shape_rules_mirror_the_library(cuda):
    lib = _build.load("scan_key")
    for g, kq, kr in sk._K4_BUILT:
        assert lib.lsq_key_step(g, kq, kr) == sk.k4_step(g, kq, kr)
        assert lib.lsq_key_threads(g) == sk.k4_threads(g)
        for m, h in ((7, 256), (3, 41), (16, 256), (16, 1024)):
            for code_bytes in (1, 4):
                for steps in (1, 4):
                    assert lib.lsq_key_smem_bytes(
                        sk.k4_group_elems(m, h, g), m, code_bytes, g, kq, kr, steps
                    ) == sk.k4_smem_bytes(m, h, code_bytes, g, kq, kr, steps)
    assert lib.lsq_key_step(32, 4, 1) == 0  # not built


def test_key_route_reruns_only_the_failing_queries_on_the_card(cuda, monkeypatch):
    """Tables of zeros and ones have few distinct distances, so some of their
    queries tie with the warm bound and fail the key certificate;
    unit-normal tables pass: the route's ids are K2's, and the "rerun_warm"
    counter counts the failing queries alone."""
    from local_search_quantization_torch.ops import adc, launch_counts

    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 1 << 17
    luts = torch.randn((40, 7, 256), generator=gen, device=cuda)
    luts[::4] = torch.randint(0, 2, (10, 7, 256), generator=gen, device=cuda).float()
    B = torch.randint(0, 256, (n, 7), generator=gen, device=cuda, dtype=torch.int32)
    Q = torch.arange(40, dtype=torch.float32, device=cuda)[:, None]

    def run(variant):
        monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", variant)
        return adc._run_scan(lambda q: luts[q[:, 0].long()], Q, B.cpu().numpy(), k=1000,
                             topk_method="kernel")

    Bt = B.t().to(torch.uint8).contiguous()
    failing = int(sk.scan_topk_warm_masked(luts, Bt, None, k=1000, variant="key")[2].sum())
    assert 0 < failing <= 10
    before = _counts("rerun_warm", "scan_key")
    res = run("key")
    assert _counts("rerun_warm", "scan_key") == [before[0] + failing, before[1] + 1]
    want = run("grouped")
    assert torch.equal(res.ids, want.ids) and torch.equal(res.dists, want.dists)


def test_k4_t0_inf_appends_every_finite_row_and_flags_overflow(cuda):
    lut, Bt, extra = _k2_inputs(cuda, 20_000, 3, 7, 256, seed=8, n_inf=500)
    t0 = torch.full((3, 1), float("inf"), device=cuda)
    ids, count = scan_key(lut, Bt, extra, t0, 1024)
    assert (count == 19_500).all()
    _, _, bad = fused_scan_topk(lut, Bt, extra, k=100, t0=t0, variant="key",
                                append_cap=1024)
    assert bool(bad)


def test_select_kernel_fits_mirrors_the_library(cuda):
    """The pure K3 and K2 shape rules agree with the libraries' own size
    functions."""
    k2 = _build.load("scan_topk")
    for m in (1, 7, 8, 16):
        for h in (16, 256, 1024, 2048):
            assert scan_topk_fits(m, h) == (k2.lsq_scan_smem_bytes(m, h) <= 227 * 1024)
    lib = _build.load("scan_select")
    assert lib.lsq_select_rows_unit() == sk._K3_ROWS_UNIT
    for g in (16, 8, 4, 2):
        assert lib.lsq_select_step(g) == sk.k3_step(g)
    for m in (1, 4, 7, 8, 16):
        for h in (16, 255, 256, 300, 1024):
            for code_bytes in (1, 4):
                caps = {g: lib.lsq_select_cap_keys(m, h, code_bytes, g) for g in (16, 8, 4, 2)}
                assert caps == {g: sk.k3_cap_keys(m, h, code_bytes, g) for g in caps}
            for k in (1, 100, 1000, 5000, 10_000, 12_000, 14_000):
                need = select_cap(k) + sk.k3_step(2) + 64
                assert select_kernel_fits(k, m, h) == (
                    lib.lsq_select_cap_keys(m, h, 4, 2) >= need), (m, h, k)


def test_select_wrappers_reject_bad_inputs(cuda):
    lut, Bt, extra = _k2_inputs(cuda, 1000, 2, 3, 16, seed=1)
    t0 = torch.zeros((2, 1), device=cuda)
    with pytest.raises(ValueError):
        scan_select(lut.double(), Bt, extra, 5)
    with pytest.raises(ValueError):
        scan_select(lut, Bt, extra, 5, t0[:1])  # t0 not [nq, 1]
    with pytest.raises(ValueError):
        scan_select(lut, Bt.long(), extra, 5)
    big = torch.zeros((1, 7, 1024), device=cuda)
    with pytest.raises(ValueError, match="select_kernel_fits"):
        scan_select(big, torch.zeros((7, 50_000), dtype=torch.int32, device=cuda),
                    None, 20_000)
    with pytest.raises(ValueError):
        scan_key(lut, Bt, extra, t0.double(), 128)
    with pytest.raises(ValueError):
        scan_key(lut, Bt, extra, t0, 0)


def _sorted_keys(cand, count, cap):
    """Each query's first min(count, cap) keys, sorted (unsigned order), as
    a list of tensors."""
    out = []
    for q in range(cand.shape[0]):
        f = min(int(count[q]), cap)
        out.append(torch.sort(cand[q, :f] ^ sk._SIGN64).values ^ sk._SIGN64)
    return out


@pytest.mark.parametrize("n,nq,m,h,rank,cap,n_inf,layouts", [
    (200_000, 9, 7, 256, 1400, 2688, 0, "both"),     # integer ties at t0
    (200_000, 40, 7, 256, 1400, 2688, 100, "both"),  # 40 queries: a partial group
    (70_003, 1, 4, 16, 800, 1024, 0, "both"),        # nq = 1; n not a multiple of 16
    (100_000, 3, 7, 256, 3000, 1024, 0, "uint8"),    # overflow: count > cap
    (65_536, 5, 3, 300, 500, 768, 0, "int32"),       # int32 codes only (h > 256)
    (80_000, 6, 16, 256, 900, 1536, 0, "both"),      # G = 8 (m = 16)
])
def test_k2_filter_matches_plain_version(cuda, n, nq, m, h, rank, cap, n_inf, layouts):
    lut, Bt, extra = _k2_inputs(cuda, n, nq, m, h, seed=n + nq, n_inf=n_inf)
    t0 = _kth_t0(lut, Bt, extra, rank)
    want_c, want_n = sk.k2_filter_reference(lut, Bt, extra, t0, cap)
    dtypes = {"both": (torch.uint8, torch.int32), "uint8": (torch.uint8,),
              "int32": (torch.int32,)}[layouts]
    for dtype in dtypes:
        before = _counts("k2_filter")[0]
        cand, count = sk.k2_filter(lut, Bt.to(dtype).contiguous(), extra, t0, cap)
        assert _counts("k2_filter")[0] == before + 1
        assert torch.equal(count, want_n)
        got, want = _sorted_keys(cand, count, cap), _sorted_keys(want_c, want_n, cap)
        for q in range(nq):
            if count[q] <= cap:
                assert torch.equal(got[q], want[q])
            else:  # overflow: cap distinct keys of rows below t0, in no fixed order
                ids = (got[q] & 0xFFFFFFFF).long()
                assert torch.unique(ids).numel() == cap
                dist = sk.lut_scan_block(lut[q:q + 1], Bt[:, ids], extra[ids])[0]
                assert (dist < t0[q]).all()
                assert torch.equal(sk._unmono((got[q] >> 32) & 0xFFFFFFFF), dist)


@pytest.mark.parametrize("nq,cap,k", [(1000, 2688, 1000), (64, 14848, 10_001),
                                      (7, 100, 30), (3, 1, 1)])
def test_k2_select_matches_a_sort_of_the_same_keys(cuda, nq, cap, k):
    rng = np.random.default_rng(cap)
    d = torch.as_tensor(rng.integers(-50, 50, (nq, cap)).astype(np.float32), device=cuda)
    ids = torch.as_tensor(np.stack([rng.permutation(10 * cap)[:cap] for _ in range(nq)]),
                          device=cuda)
    cand = sk._k2_keys(d, ids)
    count = torch.as_tensor(rng.integers(0, 2 * cap + 2, nq).astype(np.int32), device=cuda)
    count[0] = cap  # full, and below k where cap < k
    before = _counts("k2_select")[0]
    got = sk.k2_select(cand, count, k, cap)
    assert _counts("k2_select")[0] == before + 1
    want = sk.k2_select_reference(cand, count, k, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def k2_1m():
    """1000 queries of continuous LUTs over a 1M-row base, and each k's
    plain answer for all of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    lut = torch.as_tensor(rng.normal(size=(1000, 7, 256)).astype(np.float32), device=dev)
    Bt = torch.as_tensor(rng.integers(0, 256, (7, 1_000_000)).astype(np.uint8), device=dev)
    extra = torch.as_tensor(rng.random(1_000_000).astype(np.float32) * 4, device=dev)
    want = {k: scan_topk_reference(lut, Bt, extra, k) for k in (1000, 10_001)}
    return lut, Bt, extra, want


@pytest.mark.parametrize("k", [1000, 10_001])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k2_at_1m_rows_matches_plain_version_and_k3(cuda, k2_1m, k, dtype):
    """The staged K2 at the main path's shapes, nq = 1, 32 and 1000: dists
    and ids identical to the plain version and to K3 "sorted", and the
    staged path alone taken (one filter and one select launch; no query
    fails its certificate, so the dense path and its [nq, n] scratch stay
    idle)."""
    lut, Bt8, extra, want = k2_1m
    Bt = Bt8.to(dtype).contiguous()
    for nq in (1, 32, 1000):
        keys = ("k2_filter", "k2_select", "scan_topk_dense", "scan_topk_failed")
        before = _counts(*keys)
        d, i = scan_topk(lut[:nq], Bt, extra, k)
        assert _counts(*keys) == [before[0] + 1, before[1] + 1, before[2], before[3]]
        assert torch.equal(d, want[k][0][:nq]) and torch.equal(i, want[k][1][:nq])
        k3 = scan_select(lut[:nq], Bt, extra, k)
        assert torch.equal(d, k3[0]) and torch.equal(i, k3[1])


def test_k2_fit_rules_mirror_the_library(cuda):
    """The Python rules that route K2 between its staged and dense paths
    agree with csrc/scan_topk.cu's own."""
    lib = _build.load("scan_topk")
    assert lib.lsq_k2_tile() == sk._K2_TILE
    assert lib.lsq_k2_select_max() == sk._K2_SELECT_MAX
    for m in (1, 4, 7, 8, 16, 24, 32, 64):
        for h in (16, 256, 300, 1024):
            for code_bytes in (1, 4):
                g = sk.k2_group(m, h, code_bytes)
                assert lib.lsq_k2_group(m, h, code_bytes) == g, (m, h, code_bytes)
                if g:
                    assert lib.lsq_k2_filter_smem_bytes(m, h, code_bytes, g) <= 227 * 1024


def test_serve_twin_on_the_card_answers_as_an_in_process_search(cuda, tmp_path):
    """The serve twin on the card (K2-K4 and the IVF scan built by its
    warm-up) returns, over binary frames and JSON, the ids of `Index.search`
    on the same directory in this process, and its requests launched K2 and
    (with nprobe) the IVF scan by its own count."""
    import json
    import os
    import subprocess
    import sys

    from local_search_quantization_torch.benchmarks.bench_serve import read_response
    from local_search_quantization_torch.index import Index
    from local_search_quantization_torch.scripts.serve import served_launches

    rng = np.random.default_rng(5)
    xt = (rng.normal(size=(3000, 32)) * 10).astype(np.float32)
    xb = (rng.normal(size=(70_000, 32)) * 10).astype(np.float32)
    path = str(tmp_path / "idx")
    built = Index.build(xt, xb, "lsq", m=4, h=64, niter=2, ilsiter=4, device=cuda)
    built.build_ivf(64)
    built.save(path)
    Q = (rng.normal(size=(50, 32)) * 10).astype("<f4")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen([sys.executable, "-m", "local_search_quantization_torch.scripts.serve",
                          "--index", path, "--k", "10"], cwd=root, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        assert json.loads(p.stdout.readline())["ready"]
        p.stdin.write(json.dumps({"id": 1, "binary_vectors": 50, "binary": True,
                                  "dists": False}).encode() + b"\n" + Q.tobytes())
        p.stdin.write(json.dumps({"id": 2, "vectors": Q[:5].tolist(), "k": 3}).encode()
                      + b"\n")
        p.stdin.write(json.dumps({"id": 3, "vectors": Q[:5].tolist(), "k": 3,
                                  "nprobe": 8}).encode() + b"\nEOF\n")
        p.stdin.close()
        head = read_response(p.stdout)
        r2 = read_response(p.stdout)
        r3 = read_response(p.stdout)
        assert p.wait(timeout=120) == 0
        err = p.stderr.read().decode()
    finally:
        p.kill()
    assert head["nq"] == 50 and head["k"] == 10 and head["binary"]["dists"] is None
    assert torch.cuda.get_device_name(0) in err and "scan_topk" in err, err
    assert "ivf_scan" in err, err
    assert served_launches(err)["scan_topk"] > 0, err
    assert served_launches(err)["ivf_scan"] == 1, err
    idx = Index.load(path, device=cuda)
    np.testing.assert_array_equal(head["ids"], idx.search(Q, k=10).ids.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(r2["ids"]), idx.search(Q[:5], k=3).ids.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(r3["ids"]),
                                  idx.search(Q[:5], k=3, nprobe=8).ids.cpu().numpy())


@pytest.mark.parametrize("shards", [3, 4])
@pytest.mark.parametrize("k", [1000, 10_000])
def test_mesh_search_on_the_card_matches_single_device(cuda, shards, k):
    """A mesh of `shards` x cuda:0 over 300,007 rows: each shard's K2 and the
    merge return the single-device route's ids and distances exactly, and
    the sharded codebook update (with a pad row at 3 shards) equals the
    single-device one bit for bit and repeats: X is integer-valued, as SIFT
    is, so every partial sum of G and A^T X is exact in f32 in any order."""
    from local_search_quantization_torch.ops import adc, launch_counts, solver
    from local_search_quantization_torch.parallel import data_mesh, shard_batch
    from local_search_quantization_torch.parallel.encode import sharded_update_codebooks
    from local_search_quantization_torch.parallel.query import sharded_linscan_lsq

    rng = np.random.default_rng(4)
    n, d, m, h = 300_007, 32, 7, 256
    C = torch.as_tensor(rng.normal(size=(m, h, d)).astype(np.float32), device=cuda)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Q = torch.as_tensor(rng.normal(size=(64, d)).astype(np.float32), device=cuda)
    dbn = rng.random(n).astype(np.float32)
    mesh = data_mesh([cuda] * shards)
    launch_counts.zero()
    got = sharded_linscan_lsq(mesh, B, Q, C, dbn, k)
    assert launch_counts.read()["k2_filter"] >= shards  # one K2 a shard at least
    want = adc.linscan_lsq(B, Q, C, torch.as_tensor(dbn, device=cuda), k=k)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists, want.dists)
    X = torch.as_tensor(rng.integers(0, 128, size=(20_000, d)).astype(np.float32),
                        device=cuda)
    Bt = torch.as_tensor(B[:20_000], device=cuda)
    Xs, Bs = shard_batch(mesh, X), shard_batch(mesh, Bt)
    C1 = sharded_update_codebooks(mesh, Xs, Bs, h, n_valid=20_000)
    assert torch.equal(C1, sharded_update_codebooks(mesh, Xs, Bs, h, n_valid=20_000))
    assert torch.equal(C1, solver.update_codebooks(X, Bt, h))


@pytest.mark.parametrize("case", kernel_cases.CASES, ids=[c.name for c in kernel_cases.CASES])
def test_kernel_case_on_the_card(cuda, case):
    """Every case of the catalogue: the kernel launches (none where the case
    leaves the shape to the wrapper's torch form) and gives its plain
    version's outputs."""
    bad, launched = kernel_cases.run_case(case, cuda)
    assert bad is None and (launched > 0) == bool(case.entries)


@pytest.mark.parametrize("fill", ["zero", "ones", "nan"])
def test_kernel_cases_do_not_depend_on_memory_they_did_not_write(cuda, fill):
    """Every case with the allocator's free memory and a tail behind every
    input filled with 0x00 or 0xFF bytes, or in deterministic mode with
    every empty tensor filled: the outputs stay the plain versions'."""
    try:
        torch.use_deterministic_algorithms(fill == "nan")
        for case in kernel_cases.CASES:
            bad, _ = kernel_cases.run_case(case, cuda, fill)
            assert bad is None, f"{case.name}: {bad}"
    finally:
        torch.use_deterministic_algorithms(False)


def test_kernel_cases_under_memcheck(cuda):
    """The catalogue under compute-sanitizer's memcheck, where the toolkit
    has it and it can instrument the card: 0 errors and the pass line."""
    if _build.sanitizer() is None:
        pytest.skip("compute-sanitizer not found in " + ", ".join(_build.sanitizer_paths()))
    res = kernel_cases.sanitize("memcheck")
    if res["refused"]:
        pytest.skip(f"compute-sanitizer cannot instrument this card: {res['refused']}")
    assert res["ok"], res["tail"]


@pytest.fixture(scope="module")
def sync_index():
    """An LSQ index of 2^17 rows at m=7, h=256 on the card (K2's staged path
    takes n >= 65,536), 1,000 queries and 2^17 rows to add."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from local_search_quantization_torch.index import Index

    rng = np.random.default_rng(3)
    xt, xb, q, xa = (rng.normal(size=(n, 32)).astype(np.float32)
                     for n in (4000, 1 << 17, 1000, 1 << 17))
    idx = Index.build(xt, xb, "lsq", m=7, h=256, niter=2, ilsiter=4, device="cuda")
    return idx, torch.as_tensor(q, device="cuda"), torch.as_tensor(xa, device="cuda")


@pytest.mark.parametrize("call", ["search_k10", "search_k1000", "search_upload", "add",
                                  "search_ivf", "search_refine"])
def test_host_syncs_count_every_sync_the_card_flags(cuda, sync_index, call):
    """Under `torch.cuda.set_sync_debug_mode("warn")` one call raises the
    `host_syncs` counter by exactly the number of syncs the card flags: a
    search at k=10 and at k=1000 (K2's certificate), one that uploads the
    scan state again, an add of 2^17 rows (K1's inputs, the codes and
    the norms), a probed search (the IVF route, with the partition built
    and uploaded in the call before), and a probed search re-ranked from an
    SQ8 store (the refine route, the store attached in the call before).
    Each call runs once before, so nothing is built in it."""
    import warnings

    from local_search_quantization_torch.ops import launch_counts

    idx, Q, X = sync_index

    def run():
        if call == "add":
            return idx.add(X)
        if call in ("search_ivf", "search_refine"):
            if idx.ivf is None:
                idx.build_ivf(256)
            if call == "search_ivf":
                return idx.search(Q, k=10, nprobe=8)
            if idx.refine is None or idx.refine.n != idx.n:
                idx.attach_refine(np.random.default_rng(5).normal(
                    size=(idx.n, idx.d)).astype(np.float32))
            return idx.search(Q, k=10, nprobe=8, refine=10)
        if call == "search_upload":
            idx._scan_ver += 1  # as a mutation does: the next search uploads
        return idx.search(Q, k=10 if call == "search_k10" else 1000)

    run()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        # A process's first switch of the mode may itself sync, in torch.
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    launch_counts.zero()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = [f"{w.filename}:{w.lineno}" for w in got if "synchroniz" in str(w.message)]
    counts = launch_counts.read()
    assert counts["host_syncs"] == len(flagged), flagged
    assert counts["add_calls" if call == "add" else "search_calls"] == 1
    if call == "search_ivf":
        # The probed scan's kernel reads nothing back: no sync on the route.
        assert flagged == [] and counts["host_syncs"] == 0
        scan = idx._ivf_device_state()[0]
        probes = scan.probes(Q, 8).cpu().numpy()
        assert counts["ivf_queries"] == Q.shape[0]
        assert counts["ivf_rows_scanned"] == int(idx.ivf.lives[probes].sum())
        assert counts["ivf_scan"] == 1 and counts["ivf_merge"] <= 1
    elif call == "search_refine":
        # The first stage and the re-rank read nothing back either.
        assert flagged == [] and counts["host_syncs"] == 0
        assert counts["refine_queries"] == Q.shape[0]
        assert counts["refine_candidates"] == Q.shape[0] * 100
        assert counts["ivf_queries"] == Q.shape[0] and counts["ivf_scan"] == 1
    else:
        assert len(flagged) >= 1


# ---------------------------------------------------------------------------
# The IVF probed scan (csrc/ivf_scan.cu) against its plain version.


def _ivf_inputs(dev, sizes, nq, p, m, h, extra="norms", dead=0, unused=0, seed=0):
    return kernel_cases._ivf_make(np.asarray(sizes), nq, p, m, h, extra, dead, unused,
                                  seed)(dev)


def _ivf_same(a, k):
    """The kernel's (dists, ids) bit for bit the plain version's, on the
    same CUDA tensors; returns them."""
    luts_, probes, starts, lives, codesT, extra, order, mean_rows = a
    got = tivf.ivf_scan(luts_, k, probes, starts, lives, codesT, extra, order, mean_rows)
    want = tivf.ivf_scan_reference(luts_, k, probes, starts, lives, codesT.t(), extra, order)
    torch.cuda.synchronize()
    assert got.dists.dtype == torch.float32 and got.ids.dtype == torch.int64
    assert torch.equal(got.dists, want.dists)
    assert torch.equal(got.ids, want.ids)
    return got


def _sizes(seed, nlist, lo, hi, empty=0, big=None):
    return kernel_cases._ragged(seed, nlist, lo, hi, empty, big if big is not None else hi)


@pytest.mark.parametrize("nq,p,m,h,k,extra,dead,unused", [
    (33, 12, 7, 256, 10, "norms", 300, 3),  # tombstones and -1 slots
    (33, 12, 7, 256, 10, "none", 0, 0),  # a PQ store: no extra
    (64, 40, 7, 256, 1000, "norms", 50, 5),  # fewer candidates than k for some
    (7, 20, 4, 40, 100, "norms", 10, 2),  # m != 7, h < 256
    (5, 20, 16, 256, 300, "none", 0, 1),  # two batches of code planes
    (9, 20, 9, 16, 33, "norms", 0, 0),  # h = 16, the smallest k of the 256 build
])
def test_ivf_scan_matches_plain_version(cuda, nq, p, m, h, k, extra, dead, unused):
    sizes = _sizes(nq + p + m, 60, 0, 400, empty=5, big=2500)
    _ivf_same(_ivf_inputs(cuda, sizes, nq, p, m, h, extra, dead, unused, seed=k), k)


@pytest.mark.parametrize("k", [1, 10, 1000, 2048])
def test_ivf_scan_one_query_over_every_list(cuda, k):
    """nq = 1, nprobe = nlist: the most slices a query, many of them empty
    of chunks at small k."""
    sizes = _sizes(k, 50, 0, 900, empty=4, big=3000)
    _ivf_same(_ivf_inputs(cuda, sizes, 1, 50, 7, 256, "norms", 40, 0, seed=k), k)


@pytest.mark.parametrize("k", [10, 1000])
def test_ivf_scan_ties_at_the_kth_distance_from_duplicated_codes(cuda, k):
    """3k rows across the lists share one code row and the least extra: the
    k-th distance is tied far beyond k, and the ids decide: the lowest."""
    a = list(_ivf_inputs(cuda, _sizes(3, 40, 100, 600), 17, 40, 7, 256, "norms", 0, 0, 4))
    order, codesT, extra = a[6], a[4], a[5]
    live = torch.nonzero(order >= 0)[:, 0]
    dup = live[torch.randperm(live.numel(), generator=torch.Generator().manual_seed(5))[:3 * k]
               .to(live.device)]
    codesT[:, dup] = codesT[:, live[:1]]
    extra[dup] = -100.0
    got = _ivf_same(a, k)
    want = torch.sort(order[dup]).values[:k]
    assert torch.equal(got.ids[0], want)


def test_ivf_scan_continuous_tables(cuda):
    a = list(_ivf_inputs(cuda, _sizes(8, 80, 0, 700, empty=3), 100, 16, 7, 256, "norms", 100,
                         2, 8))
    a[0] = torch.randn(a[0].shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    a[5] = torch.where(torch.isfinite(a[5]), a[5] * 0.37, a[5])
    for k in (10, 100):
        _ivf_same(a, k)


def test_ivf_scan_at_the_benchmark_cells_proportions(cuda):
    """1000 queries, nprobe 64 of 2048 lists of ~600 rows (the IVF cell's
    list sizes on a smaller store), k=10: ten slices a query and the merge."""
    sizes = _sizes(11, 2048, 300, 900, empty=0, big=11_000)
    launch_counts.zero()
    _ivf_same(_ivf_inputs(cuda, sizes, 1000, 64, 7, 256, "norms", 1000, 0, 12), 10)
    counts = launch_counts.read()
    assert counts["ivf_scan"] == 1 and counts["ivf_merge"] == 1


def test_ivf_scan_refuses_k_above_its_cap(cuda):
    a = _ivf_inputs(cuda, _sizes(1, 10, 0, 100), 2, 3, 7, 256)
    with pytest.raises(ValueError, match="2048"):
        tivf.ivf_scan(a[0], 2049, *a[1:])


def test_ivf_scan_counts_rows_on_the_card_and_makes_no_host_sync(cuda):
    """Under `set_sync_debug_mode("error")` the call never waits; its rows
    reach `ivf_rows_scanned` through the device counter at the read."""
    import warnings

    sizes = _sizes(2, 30, 0, 500, empty=2)
    a = _ivf_inputs(cuda, sizes, 20, 6, 7, 256, "norms", 0, 2, 3)
    tivf.ivf_scan(a[0], 10, *a[1:])  # builds the library, makes the counter
    torch.cuda.synchronize()
    probes = a[1].cpu().numpy()
    rows = int(np.asarray(sizes)[probes[probes >= 0]].sum())
    with warnings.catch_warnings(record=True):
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    launch_counts.zero()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tivf.ivf_scan(a[0], 10, *a[1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts.read()
    assert counts["ivf_rows_scanned"] == rows and counts["ivf_queries"] == 20
    assert counts["host_syncs"] == 0


def test_ivf_route_on_the_card_never_runs_the_plain_scan(cuda, sync_index, monkeypatch):
    """`Index.search(nprobe=)` on a CUDA index launches the kernel on every
    call, at k = 1, 10, 1000 and the cap; the plain scan is never taken."""
    idx, Q, _ = sync_index
    if idx.ivf is None:
        idx.build_ivf(256)

    def plain(*args, **kw):
        raise AssertionError("the plain probed scan ran on the card")
    monkeypatch.setattr(tivf, "ivf_scan_reference", plain)
    for k in (1, 10, 1000, 2048):
        launch_counts.zero()
        res = idx.search(Q[:50], k=k, nprobe=16)
        assert launch_counts.read()["ivf_scan"] == 1
        assert res.ids.dtype == torch.int64 and tuple(res.ids.shape) == (50, k)
    with pytest.raises(ValueError, match="2048"):
        idx.search(Q[:5], k=2049, nprobe=16)


def test_ivf_scan_rules_mirror_the_library(cuda):
    lib = _build.load("ivf_scan")
    assert lib.lsq_ivf_lut_max_bytes() == tivf._IVF_LUT_MAX_BYTES


# ---------------------------------------------------------------------------
# The IVF coarse probes (csrc/ivf_probes.cu) against their plain version, and
# on the route.


def test_ivf_probes_serve_what_the_kernel_wins_and_size_their_workspace(cuda):
    """The kernel serves nprobe <= 64 at d <= 128 (d padded to 32); its
    workspace is [nq, chunks, P] keys and the chunks' bounds, P the least
    power of two >= max(nprobe, 32)."""
    lib = _build.load("ivf_probes")
    assert [lib.lsq_ivf_probes_serves(d, p) for d, p in (
        (128, 64), (100, 1), (1, 64), (128, 65), (129, 64), (960, 64), (128, 0), (0, 1))] == [
        1, 1, 1, 0, 0, 0, 0, 0]
    for nq, chunks, nprobe, P in ((1000, 8, 64, 64), (1, 64, 64, 64), (7, 3, 20, 32),
                                  (33, 4, 33, 64), (2, 5, 1, 32)):
        assert lib.lsq_ivf_probes_work_words(nq, chunks, nprobe) == (
            nq * chunks * P + (nq * (chunks + 1) + 1) // 2)


@pytest.mark.parametrize("nq,nlist,d,nprobe", [
    (1000, 16_384, 128, 64),  # the IVF cell's shape
    (1, 16_384, 128, 64),  # one query served: a chunk a tile
    (130, 3000, 100, 33),  # query tiles ragged, d ragged, P = 64 above nprobe
    (64, 777, 32, 32),  # one full query tile, nlist ragged, the tiles cap the chunks
])
def test_ivf_probes_match_plain_version_at_the_route_shapes(cuda, nq, nlist, d, nprobe):
    case = kernel_cases._probes(f"{nq} {nlist} {d} {nprobe}", nq, nlist, d, nprobe, False, nq + d)
    a = case.make(cuda)
    launch_counts.zero()
    got = case.kernel(a)
    counts = launch_counts.read()
    assert counts["ivf_probes"] == 1 and counts["ivf_probes_wide"] == 0
    bad = case.compare(got, case.plain(a), a)
    assert bad is None, bad


@pytest.mark.parametrize("d,nprobe", [(16, 65), (128, 2048), (960, 64), (129, 1)])
def test_ivf_probes_above_the_kernel_take_the_torch_form_and_count_it(cuda, d, nprobe):
    a = kernel_cases._probes_make(3, 5000, d, True, 9)(cuda)
    launch_counts.zero()
    got = tivf.ivf_probes(*a, nprobe)
    counts = launch_counts.read()
    assert counts["ivf_probes"] == 0 and counts["ivf_probes_wide"] == 1
    want = tivf.coarse_probes_topk(*a, nprobe)
    assert torch.equal(got, want)


def test_ivf_probes_make_no_host_sync(cuda):
    a = kernel_cases._probes_make(100, 4096, 128, False, 10)(cuda)
    tivf.ivf_probes(*a, 64)  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tivf.ivf_probes(*a, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.fixture(scope="module")
def ivf_cell_index():
    """The IVF cell's deployment cut to 200k rows and 1,024 lists on the card
    (d=128, LSQ m=7 h=256 with the norm byte), and its first 200 queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import common, deploy

    cfg = dict(common.config("bigann10m-ivf16k-lsq64"), n_train=20_000, n_base=200_000,
               n_query=200, niter=2, ilsiter=4)
    seeded = dict(cfg, name=cfg["corpus_of"])
    data = deploy.make_corpus(seeded, "cuda")
    idx = deploy.build_index(seeded, data, "cuda")
    idx.build_ivf(1024, sample=1 << 16, iters=5)
    return idx, data.query


def test_ivf_route_probes_on_the_card_with_no_sync_and_one_launch_a_call(cuda, ivf_cell_index):
    """`Index.search(nprobe=64)` under `set_sync_debug_mode("warn")`: no sync
    flagged, and each call adds 1 to `ivf_probes` and 0 to
    `ivf_probes_wide`."""
    import warnings

    idx, Q = ivf_cell_index
    idx.search(Q, k=10, nprobe=64)  # builds the libraries, uploads the partition
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    launch_counts.zero()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                idx.search(Q, k=10, nprobe=64)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = [f"{w.filename}:{w.lineno}" for w in got if "synchroniz" in str(w.message)]
    counts = launch_counts.read()
    assert flagged == [] and counts["host_syncs"] == 0
    assert counts["ivf_probes"] == 3 and counts["ivf_probes_wide"] == 0
    assert counts["ivf_scan"] == 3 and counts["search_calls"] == 3


def test_ivf_route_with_the_kernel_passes_the_cells_judge_as_the_torch_form_did(
        cuda, ivf_cell_index):
    """The route's answers with the kernel's probes and with the torch form
    of the parent's route (`coarse_probes_topk`, then the same scan) both
    pass the IVF cell's judge under its limits; where the two probe sets
    agree, the answers are identical."""
    from portbench import check, common, deploy
    from portbench.drivers.ivf_batch import partition_state
    from portbench.reference import adc as adc_ref
    from portbench.reference import ivf as ivf_ref

    idx, Q = ivf_cell_index
    k, nprobe = 10, 64
    new = idx.search(Q, k=k, nprobe=nprobe)
    scan = idx._ivf_device_state()[0]
    old_probes = tivf.coarse_probes_topk(Q, scan.centroidsT, scan.cnorms, nprobe)
    old = scan.search(idx._query_luts(Q).contiguous(), k, old_probes)
    state = deploy.index_state(idx)
    searcher = adc_ref.Searcher(state["B"], state["C"], state["cbnorms"], cuda)
    lists = ivf_ref.Lists(*partition_state(idx.ivf), cuda)
    limits = common.workload("bigann10m-ivf16k-lsq64.batch-np64-k10")["limits"]
    for res in (new, old):
        numbers = ivf_ref.judge(searcher, lists, Q, res.ids.cpu(), res.dists.cpu(), k, nprobe)
        assert check.verdict(dict(numbers, failed=0), limits)[0], numbers
    same = (torch.sort(scan.probes(Q, nprobe), dim=1).values
            == torch.sort(old_probes, dim=1).values).all(dim=1)
    assert float(same.float().mean()) >= 0.95
    assert torch.equal(new.ids[same], old.ids[same])
    assert torch.equal(new.dists[same], old.dists[same])
