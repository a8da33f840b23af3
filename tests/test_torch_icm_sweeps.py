"""The port's per-round ICM sweeps (K5, K6) and its "matmul"/"fused" condition
modes, held to the JAX package.

K5 and K6's plain versions (`fused_icm_sweeps_reference`, variants "v2" and
"v1") are held code for code to the Pallas kernels
`icm_pallas.fused_icm_sweeps` run in interpret mode, on an integer fixture
where the TPU kernels' one-hot x bf16 products are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import icm as jicm
from local_search_quantization_tpu.ops import icm_pallas
from local_search_quantization_tpu.ops import luts as jluts
from local_search_quantization_torch.ops import icm as ticm
from local_search_quantization_torch.ops import icm_kernels, launch_counts
from local_search_quantization_torch.ops import luts as tluts
from local_search_quantization_torch.ops.costs import veccost
from local_search_quantization_torch.ops.icm_kernels import (
    binaries_to_j_stacked,
    fused_icm_sweeps,
    fused_icm_sweeps_reference,
    ils_kernel_fits,
)

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _integer_fixture(n=64, d=16, m=4, h=16, seed=0):
    """X in [-3, 3], C in {-1, 0, 1}: every LUT entry is an integer that bf16
    holds exactly, so every sum is exact in any order."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    C = rng.integers(-1, 2, size=(m, h, d)).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return rng, X, C, B0


def _continuous_fixture(n=256, d=16, m=4, h=16, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return rng, X, C, B0


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_sweeps_plain_versions_match_pallas_kernels(variant):
    """The Motivation's fixture (n=64, d=16, m=4, h=16, icmiter=2): codes
    identical to the Pallas kernel in interpret mode, with tile=n."""
    rng, X, C, B0 = _integer_fixture()
    u = jluts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    b16 = jluts.get_binaries(jnp.asarray(C)).astype(jnp.bfloat16)
    order = rng.permutation(4).astype(np.int32)
    jB = icm_pallas.fused_icm_sweeps(jnp.asarray(B0), u, b16, jnp.asarray(order),
                                     icmiter=2, tile=64, interpret=True, variant=variant)
    tb16 = _t(np.asarray(b16.astype(jnp.float32))).to(torch.bfloat16)
    tB = fused_icm_sweeps_reference(_t(B0), _t(u), tb16, _t(order), icmiter=2,
                                    variant=variant)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    assert tB.dtype == torch.int32
    assert (tB.numpy() != B0).any()  # the sweeps did something


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("h", [40, 512])
def test_sweeps_plain_versions_match_pallas_kernels_at_other_widths(variant, h):
    """h=40 (two candidates a lane on the card, lanes 20-31 idle: no multiple
    of 32) and h=512 (16 candidates a lane): codes identical to the Pallas
    kernel in interpret mode on the integer fixture."""
    rng, X, C, B0 = _integer_fixture(n=32, d=8, m=3, h=h, seed=h)
    u = jluts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    b16 = jluts.get_binaries(jnp.asarray(C)).astype(jnp.bfloat16)
    order = rng.permutation(3).astype(np.int32)
    jB = icm_pallas.fused_icm_sweeps(jnp.asarray(B0), u, b16, jnp.asarray(order),
                                     icmiter=2, tile=32, interpret=True, variant=variant)
    tb16 = _t(np.asarray(b16.astype(jnp.float32))).to(torch.bfloat16)
    tB = fused_icm_sweeps_reference(_t(B0), _t(u), tb16, _t(order), icmiter=2,
                                    variant=variant)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    assert (tB.numpy() != B0).any()


def test_sweeps_variants_agree_with_gather_sweeps_on_integer_tables():
    """On exact tables both variants are the gather sweeps of icm.py: the
    orders of summation differ, the sums do not."""
    rng, X, C, B0 = _integer_fixture(n=200, m=5, h=24, seed=3)
    u = tluts.get_unaries(_t(X), _t(C))
    b = tluts.get_binaries(_t(C))
    order = [2, 0, 4, 1, 3]
    want = ticm.icm_sweeps(_t(B0), u, b, order, 3)
    for variant in ("v2", "v1"):
        got = fused_icm_sweeps(_t(B0), u, b.to(torch.bfloat16),
                               torch.tensor(order, dtype=torch.int32), icmiter=3,
                               variant=variant)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_binaries_to_j_stacked_matches_jax():
    _, _, C, _ = _integer_fixture(m=3, h=8)
    b16 = jluts.get_binaries(jnp.asarray(C)).astype(jnp.bfloat16)
    j = icm_pallas.binaries_to_j_stacked(b16)
    t = binaries_to_j_stacked(_t(np.asarray(b16.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    assert t.shape == (3, 24, 8) and (t[1, 8:16] == 0).all()


def test_sweeps_wrapper_routes_cpu_to_plain_version_and_rejects_other_devices():
    rng, X, C, B0 = _integer_fixture(n=32)
    u = tluts.get_unaries(_t(X), _t(C))
    b16 = tluts.get_binaries(_t(C)).to(torch.bfloat16)
    order = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    before = {v: launch_counts.read()[f"icm_sweeps_{v}"] for v in ("v2", "v1")}
    for variant in ("v2", "v1"):
        got = fused_icm_sweeps(_t(B0), u, b16, order, icmiter=1, variant=variant)
        want = fused_icm_sweeps_reference(_t(B0), u, b16, order, icmiter=1,
                                          variant=variant)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert {v: launch_counts.read()[f"icm_sweeps_{v}"] for v in ("v2", "v1")} == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_icm_sweeps(_t(B0).to("meta"), u.to("meta"), b16.to("meta"),
                         order.to("meta"), icmiter=1)
    with pytest.raises(ValueError, match="variant"):
        fused_icm_sweeps(_t(B0), u, b16, order, icmiter=1, variant="v3")


def test_condition_matmul_matches_jax_on_integer_luts():
    rng, X, C, B0 = _integer_fixture(n=50, m=4, h=16, seed=5)
    u = np.asarray(jluts.get_unaries(jnp.asarray(X), jnp.asarray(C)))
    b = np.asarray(jluts.get_binaries(jnp.asarray(C)))
    for j in range(4):
        want = jicm._condition_matmul(jnp.asarray(u[:, j]), jnp.asarray(b[:, j]),
                                      jnp.asarray(B0), j)
        got = ticm._condition_matmul(_t(u[:, j]), _t(b[:, j]), _t(B0), j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32


def test_condition_matmul_rounds_tables_to_bf16_but_sums_in_f32():
    """A table value that bf16 cannot hold is rounded once (as the JAX
    package casts it), and the product is not rounded again to bf16."""
    u = torch.zeros((1, 2))
    tables = torch.zeros((2, 2, 2))
    tables[0] = torch.tensor([[1.0 + 2 ** -10, 3.0], [0.0, 0.0]])
    got = ticm._condition_matmul(u + 1000.0, tables, torch.tensor([[0, 1]]), 1)
    # 1 + 2^-10 rounds to 1 in bf16; 1001 and 1003 are not bf16 values.
    np.testing.assert_array_equal(got.numpy(), [[1001.0, 1003.0]])


def _encode_checks(res, X, C, B0):
    cost0 = veccost(_t(X), _t(B0), _t(C))
    exact = veccost(_t(X), res.B, _t(C))
    assert (exact <= cost0 + 1e-4).all()
    np.testing.assert_allclose(res.cost.numpy(), exact.numpy(), rtol=1e-4, atol=1e-3)
    msc = res.milestone_cost.numpy()
    assert (np.diff(msc, axis=0) <= 0).all() and (res.cost.numpy() <= msc[-1]).all()
    fb, fe = res.frac_better.numpy(), res.frac_equal.numpy()
    assert ((fb >= 0) & (fb <= 1) & (fe >= 0) & (fe <= 1)).all() and fb[0] > 0


@pytest.mark.parametrize("mode", ["matmul", "fused"])
def test_ils_encode_matmul_and_fused_modes(mode):
    """The accept invariant, milestone monotonicity and stats; the mean cost
    within 3% of the JAX encoder's in the same mode (different random
    streams, the same bf16 tables)."""
    rng, X, C, B0 = _continuous_fixture()
    gen = torch.Generator().manual_seed(3)
    res = ticm.ils_encode(gen, _t(X), _t(B0), _t(C), ilsiter=6, icmiter=2,
                          npert=2, condition_mode=mode, milestones=(2, 4, 6),
                          with_stats=True)
    _encode_checks(res, X, C, B0)
    jres = jicm.ils_encode(jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(B0),
                           jnp.asarray(C), ilsiter=6, icmiter=2, npert=2,
                           condition_mode=mode)
    jmean = float(np.mean(np.asarray(jres.cost)))
    assert abs(float(res.cost.mean()) - jmean) <= 0.03 * jmean


def test_fused_encode_runs_k5_plain_version_every_round(monkeypatch):
    """condition_mode="fused" sends each round's sweeps to K5's wrapper with
    the bf16 tables cast once; its codes equal the round loop's with the
    plain version swapped in."""
    rng, X, C, B0 = _continuous_fixture(n=64)
    calls = []

    def spy(B, unaries, binaries_bf16, order, *, icmiter, variant="v2"):
        calls.append(binaries_bf16)
        assert binaries_bf16.dtype == torch.bfloat16 and variant == "v2"
        return fused_icm_sweeps_reference(B, unaries, binaries_bf16, order,
                                          icmiter=icmiter)

    monkeypatch.setattr(icm_kernels, "fused_icm_sweeps", spy)
    res = ticm.encode_chunked(torch.Generator().manual_seed(0), X, B0, _t(C),
                              ilsiter=4, icmiter=2, npert=1, chunk=40,
                              condition_mode="fused")
    assert len(calls) == 2 * 4 and calls[0] is calls[3] and calls[3] is not calls[4]
    assert (veccost(_t(X), res.B, _t(C)) <= veccost(_t(X), _t(B0), _t(C)) + 1e-4).all()


def test_kernel_mode_takes_matmul_where_k1_cannot_hold_the_shape(monkeypatch):
    """The shape rule: m=2, h=1025 is beyond K1 (h > 1024), so "kernel"
    runs the "matmul" path (same codes for the same generator seed) and
    never calls K1's wrapper; a shape K1 holds still goes to K1."""
    assert not ils_kernel_fits(2, 1025) and not ils_kernel_fits(16, 1024)
    assert ils_kernel_fits(7, 256) and ils_kernel_fits(8, 1024)
    assert ticm.encode_route("kernel", 2, 1025, "cpu") == "matmul"
    assert ticm.encode_route("auto", 7, 256, "cuda") == "kernel"
    assert ticm.encode_route("fused", 2, 1025, "cpu") == "fused"
    rng = np.random.default_rng(0)
    X = rng.normal(size=(12, 4)).astype(np.float32)
    C = rng.normal(size=(2, 1025, 4)).astype(np.float32)
    B0 = rng.integers(0, 1025, size=(12, 2), dtype=np.int32)

    def no_k1(*a, **k):
        raise AssertionError("K1 called for a shape it cannot hold")

    monkeypatch.setattr(icm_kernels, "ils_encode_streamed", no_k1)
    kw = dict(ilsiter=2, icmiter=1, npert=1)
    got = ticm.ils_encode(torch.Generator().manual_seed(1), _t(X), _t(B0), _t(C),
                          condition_mode="kernel", **kw)
    want = ticm.ils_encode(torch.Generator().manual_seed(1), _t(X), _t(B0), _t(C),
                           condition_mode="matmul", **kw)
    np.testing.assert_array_equal(got.B.numpy(), want.B.numpy())
    with pytest.raises(AssertionError, match="K1 called"):
        ticm.ils_encode(torch.Generator().manual_seed(1), _t(X[:, :4]), _t(B0 % 8),
                        _t(C[:, :8]), condition_mode="kernel", **kw)
