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
from local_search_quantization_torch.ops import icm, luts
from local_search_quantization_torch.ops.icm_kernels import (
    fused_icm_sweeps,
    fused_icm_sweeps_reference,
    ils_encode_streamed,
    ils_encode_streamed_reference,
    ils_kernel_fits,
)
from local_search_quantization_torch.ops.select_kernels import (
    scan_topk,
    scan_topk_reference,
)

pytestmark = pytest.mark.gpu


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
    (1024, 16, 3, 300, 2, 1, False),  # h > 256: 16 candidates per lane
])
def test_k1_kernel_matches_plain_version(cuda, shape):
    n, d, m, h, R, npert, integer = shape
    args = _k1_inputs(cuda, n, d, m, h, R, npert, integer)
    before = ils_encode_streamed.launches
    got = ils_encode_streamed(*args, icmiter=2, milestones=(1, R), with_stats=True)
    want = ils_encode_streamed_reference(*args, icmiter=2, milestones=(1, R),
                                         with_stats=True)
    assert ils_encode_streamed.launches == before + 1
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
        before = scan_topk.launches
        got = scan_topk(lut, Bt.to(dtype).contiguous(), extra, k)
        assert scan_topk.launches == before + 1
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
    (1024, 16, 3, 300, 2, False),  # h > 256: 16 candidates per lane
    (512, 8, 1, 64, 2, False),  # m = 1: no pair terms
])
def test_icm_sweeps_kernels_match_plain_version(cuda, variant, shape):
    n, d, m, h, icmiter, integer = shape
    args = _sweeps_inputs(cuda, n, d, m, h, integer)
    before = fused_icm_sweeps.launches[variant]
    got = fused_icm_sweeps(*args, icmiter=icmiter, variant=variant)
    want = fused_icm_sweeps_reference(*args, icmiter=icmiter, variant=variant)
    assert fused_icm_sweeps.launches[variant] == before + 1
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
    k1, k5 = ils_encode_streamed.launches, fused_icm_sweeps.launches["v2"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    res = icm.ils_encode(gen, X, B0, C, ilsiter=5, icmiter=2, npert=2,
                         condition_mode="fused")
    assert fused_icm_sweeps.launches["v2"] == k5 + 5
    assert ils_encode_streamed.launches == k1
    cost0 = icm.cost_from_luts((X * X).sum(-1), luts.get_unaries(X, C),
                               luts.get_binaries(C), B0)
    assert (res.cost <= cost0).all() and (res.cost < cost0).any()


def test_ils_kernel_fits_mirrors_the_library(cuda):
    """The pure shape rule that routes "kernel" to "matmul" agrees with
    the K1 library's own size functions."""
    import ctypes

    lib = _build.load("ils_encode")
    lib.lsq_ils_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
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
