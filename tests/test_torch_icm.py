"""The PyTorch port's ILS/ICM encoder and its K1 kernel, held to the JAX package.

Inputs are made with numpy from a seed and handed to both packages. K1's
plain version (`ils_encode_streamed_reference`) is held bit for bit to the
Pallas kernel `icm_pallas.fused_ils_encode` run in interpret mode, on an
integer fixture where the TPU kernel's bf16 LUTs and matmul sums are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import icm as jicm
from local_search_quantization_tpu.ops import luts as jluts
from local_search_quantization_tpu.ops.icm_pallas import fused_ils_encode
from local_search_quantization_torch.ops import icm as ticm
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops import luts as tluts
from local_search_quantization_torch.ops.costs import veccost
from local_search_quantization_torch.ops.icm_kernels import (
    ils_encode_streamed,
    ils_encode_streamed_reference,
)

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _integer_fixture(n=64, d=16, m=4, h=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    C = rng.integers(-1, 2, size=(m, h, d)).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return rng, X, C, B0


def _continuous_fixture(n=200, d=16, m=4, h=16, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return rng, X, C, B0


def test_k1_plain_matches_pallas_kernel_bit_for_bit():
    """Same unaries, binaries, visit orders and streamed randomness: identical
    codes, costs, milestones and per-round counts (tile=n, so the kernel's
    [R, npad, m] draws are regenerated exactly)."""
    n, m, h, R, icmiter, npert = 64, 4, 16, 3, 2, 2
    rng, X, C, B0 = _integer_fixture(n=n, m=m, h=h)
    unaries = jluts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    binaries = jluts.get_binaries(jnp.asarray(C))
    xsq = jnp.sum(jnp.asarray(X) ** 2, axis=-1)
    orders = np.stack([rng.permutation(m) for _ in range(R)]).astype(np.int32)
    key = jax.random.PRNGKey(7)
    jB, jcost, jmsB, jmsc, jstats = fused_ils_encode(
        key, jnp.asarray(orders), unaries, binaries, xsq, jnp.asarray(B0),
        ilsiter=R, icmiter=icmiter, npert=npert, tile=n, interpret=True,
        milestones=(1, 3), with_stats=True)
    kk, kc = jax.random.split(key)
    pkeys = jax.random.uniform(kk, (R, n, m), jnp.float32)
    pcodes = jax.random.randint(kc, (R, n, npert), 0, h, dtype=jnp.int32)

    tB, tcost, tmsB, tmsc, tstats = ils_encode_streamed_reference(
        _t(unaries), _t(binaries), _t(xsq), _t(B0), _t(orders), _t(pkeys),
        _t(pcodes), icmiter=icmiter, milestones=(1, 3), with_stats=True)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(tcost.numpy(), np.asarray(jcost))
    np.testing.assert_array_equal(tmsB.numpy(), np.asarray(jmsB))
    np.testing.assert_array_equal(tmsc.numpy(), np.asarray(jmsc))
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    # The fixture must exercise the accept rule, not pass vacuously.
    assert (np.asarray(jB) != B0).any()


def test_k1_wrapper_routes_cpu_to_plain_version_and_rejects_other_devices():
    n, m, h, R, npert = 32, 4, 16, 2, 2
    rng, X, C, B0 = _integer_fixture(n=n, m=m, h=h)
    u = tluts.get_unaries(_t(X), _t(C))
    b = tluts.get_binaries(_t(C))
    xsq = (_t(X) ** 2).sum(-1)
    orders = _t(np.stack([rng.permutation(m) for _ in range(R)]).astype(np.int32))
    pkeys = _t(rng.random((R, n, m), dtype=np.float32))
    pcodes = _t(rng.integers(0, h, (R, n, npert), dtype=np.int32))
    before = launch_counts.read()["ils_encode"]
    got = ils_encode_streamed(u, b, xsq, _t(B0), orders, pkeys, pcodes, icmiter=2)
    want = ils_encode_streamed_reference(u, b, xsq, _t(B0), orders, pkeys, pcodes,
                                         icmiter=2)
    assert launch_counts.read()["ils_encode"] == before  # no kernel on the CPU
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    meta = [t.to("meta") for t in (u, b, xsq, _t(B0), orders, pkeys, pcodes)]
    with pytest.raises(ValueError, match="unsupported device"):
        ils_encode_streamed(*meta, icmiter=2)


def test_icm_sweeps_gather_matches_jax_exactly():
    """Tie-free continuous fixture with the SAME f32 LUTs fed to both: the
    conditioning sums run in the same order, so codes agree exactly."""
    rng, X, C, B0 = _continuous_fixture(n=128, m=5, h=16)
    u = np.asarray(jluts.get_unaries(jnp.asarray(X), jnp.asarray(C)))
    b = np.asarray(jluts.get_binaries(jnp.asarray(C)))
    order = np.array([3, 0, 4, 1, 2], np.int32)
    jB = jicm.icm_sweeps(jnp.asarray(B0), jnp.asarray(u), jnp.asarray(b),
                         jnp.asarray(order), 2)
    tB = ticm.icm_sweeps(_t(B0), _t(u), _t(b), order, 2)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    cj = jicm.cost_from_luts(jnp.sum(jnp.asarray(X) ** 2, -1), jnp.asarray(u),
                             jnp.asarray(b), jB)
    ct = ticm.cost_from_luts((_t(X) ** 2).sum(-1), _t(u), _t(b), tB)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)


def test_perturb_codes_changes_npert_distinct_entries():
    B = torch.zeros((500, 6), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    P = ticm.perturb_codes(gen, B, 3, 1000)
    changed = (P != B).sum(1)
    assert changed.max() <= 3 and changed.float().mean() > 2.9
    assert P.dtype == torch.int32 and int(P.max()) < 1000


@pytest.mark.parametrize("mode", ["kernel", "gather"])
def test_ils_encode_accept_invariant_milestones_and_stats(mode):
    """Final cost <= cost(B0) per row after the exact recheck; milestones
    are non-increasing per row; stats are fractions; the mean cost lands
    within 3% of the JAX encoder's (different random streams)."""
    rng, X, C, B0 = _continuous_fixture(n=256, m=4, h=16)
    gen = torch.Generator().manual_seed(3)
    res = ticm.ils_encode(gen, _t(X), _t(B0), _t(C), ilsiter=6, icmiter=2,
                          npert=2, condition_mode=mode, milestones=(2, 4, 6),
                          with_stats=True)
    cost0 = veccost(_t(X), _t(B0), _t(C))
    exact = veccost(_t(X), res.B, _t(C))
    assert (exact <= cost0 + 1e-4).all()
    np.testing.assert_allclose(res.cost.numpy(), exact.numpy(), rtol=1e-4, atol=1e-3)
    msc = res.milestone_cost.numpy()
    assert (np.diff(msc, axis=0) <= 0).all()
    assert (res.cost.numpy() <= msc[-1]).all()
    assert res.milestone_B.shape == (3, 256, 4)
    fb, fe = res.frac_better.numpy(), res.frac_equal.numpy()
    assert fb.shape == fe.shape == (6,)
    assert ((fb >= 0) & (fb <= 1) & (fe >= 0) & (fe <= 1)).all() and fb[0] > 0
    jres = jicm.ils_encode(jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(B0),
                           jnp.asarray(C), ilsiter=6, icmiter=2, npert=2)
    jmean = float(np.mean(np.asarray(jres.cost)))
    assert abs(float(res.cost.mean()) - jmean) <= 0.03 * jmean


def test_ils_encode_dead_rows_never_accept():
    rng, X, C, B0 = _continuous_fixture(n=64, m=4, h=16)
    gen = torch.Generator().manual_seed(0)
    res = ticm.ils_encode(gen, _t(X), _t(B0), _t(C), ilsiter=3, icmiter=1,
                          npert=1, condition_mode="kernel", with_stats=True,
                          nvalid=40)
    np.testing.assert_array_equal(res.B[40:].numpy(), B0[40:])
    assert (res.frac_better.numpy() <= 1.0).all()


def test_encode_chunked_pads_tail_and_matches_whole_encode_quality():
    """Three chunks with a padded tail: codes for every row, exact costs,
    stats weighted by valid rows, and mean cost within 3% of JAX's
    encode_chunked on the same inputs."""
    rng, X, C, B0 = _continuous_fixture(n=300, m=4, h=16)
    gen = torch.Generator().manual_seed(5)
    res = ticm.encode_chunked(gen, X, B0, _t(C), ilsiter=4, icmiter=2, npert=2,
                              chunk=128, milestones=(2, 4), with_stats=True)
    assert res.B.shape == (300, 4) and res.B.dtype == torch.int32
    exact = veccost(_t(X), res.B, _t(C))
    np.testing.assert_allclose(res.cost.numpy(), exact.numpy(), rtol=1e-4, atol=1e-3)
    assert (exact <= veccost(_t(X), _t(B0), _t(C)) + 1e-4).all()
    np.testing.assert_array_equal(res.milestone_B[-1].numpy(), res.B.numpy())
    assert res.frac_better.shape == (4,) and (res.frac_better <= 1).all()
    jres = jicm.encode_chunked(jax.random.PRNGKey(5), X, B0, jnp.asarray(C),
                               ilsiter=4, icmiter=2, npert=2, chunk=128)
    jmean = float(np.mean(jres.cost))
    assert abs(float(res.cost.mean()) - jmean) <= 0.03 * jmean


def test_resolve_condition_mode():
    """"auto" is K1 for data on a CUDA device and "gather" on the CPU, as
    the JAX package maps it by platform; every mode the JAX package accepts
    passes on either device; an unknown one raises."""
    assert ticm.resolve_condition_mode("auto", "cuda") == "kernel"
    assert ticm.resolve_condition_mode("auto", torch.device("cuda", 0)) == "kernel"
    assert ticm.resolve_condition_mode("auto", "cpu") == "gather"
    assert ticm.resolve_condition_mode("auto", torch.device("cpu")) == "gather"
    assert jicm.resolve_condition_mode("auto", "tpu") == "kernel"
    assert jicm.resolve_condition_mode("auto", "cpu") == "gather"
    for mode in ("kernel", "fused", "gather", "matmul"):
        for dev in ("cpu", "cuda"):
            assert ticm.resolve_condition_mode(mode, dev) == mode
    with pytest.raises(ValueError):
        ticm.resolve_condition_mode("pallas", "cpu")
