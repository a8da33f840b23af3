"""K7, the dissections of K5's ICM visit (`icm_kernels.icm_sweeps_dissect`).

The TPU kernel (`benchmarks/bench_kernel_variants.py`) times K5's visit
with parts taken out. Its "full" variant is K5's function: the plain version
is held code for code to `icm_pallas.fused_icm_sweeps(variant="v2")` in
interpret mode, on an integer fixture where the one-hot x bf16 products are
exact. The other variants are held to their definitions: the codes each
leaves, and the per-row `sink` that keeps its work alive on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import icm_pallas
from local_search_quantization_tpu.ops import luts as jluts
from local_search_quantization_torch.ops import icm as ticm
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops import luts as tluts
from local_search_quantization_torch.ops.icm_kernels import (
    DISSECT_VARIANTS,
    binaries_to_j_stacked,
    candidates_per_lane,
    icm_sweeps_dissect,
    icm_sweeps_dissect_reference,
)

torch.set_num_threads(1)

# The score sums: the plain version adds in the kernel's lane order; the
# independent float64 sums here differ from it by f32 rounding only.
SINK_RTOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _fixture(n=64, d=16, m=4, h=16, seed=0):
    """X in [-3, 3], C in {-1, 0, 1}: every table entry is an integer bf16
    holds exactly, so every sum is exact in any order."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    C = rng.integers(-1, 2, size=(m, h, d)).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    u = tluts.get_unaries(_t(X), _t(C))
    b = tluts.get_binaries(_t(C))
    order = torch.as_tensor(rng.permutation(m).astype(np.int32))
    return X, C, _t(B0), u, b, order


def _visits(order, icmiter):
    return [int(j) for j in order.tolist()] * icmiter


@pytest.mark.parametrize("variant", ["full", "predwrite"])
def test_full_and_predwrite_are_k5_code_for_code(variant):
    """The Pallas K5 in interpret mode (tile=n), on K7's fixture."""
    X, C, B0, _, _, order = _fixture()
    u = jluts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    b16 = jluts.get_binaries(jnp.asarray(C)).astype(jnp.bfloat16)
    jB = icm_pallas.fused_icm_sweeps(jnp.asarray(B0.numpy()), u, b16,
                                     jnp.asarray(order.numpy()), icmiter=2, tile=64,
                                     interpret=True, variant="v2")
    tb16 = _t(np.asarray(b16.astype(jnp.float32))).to(torch.bfloat16)
    codes, sink = icm_sweeps_dissect_reference(B0, _t(u), tb16, order, icmiter=2,
                                               variant=variant)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jB))
    assert codes.dtype == torch.int32 and (codes != B0).any()
    assert sink.dtype == torch.float32 and not sink.any()


@pytest.mark.parametrize("h", [16, 48])
def test_nowrite_keeps_codes_and_sums_the_argmins(h):
    _, _, B0, u, b, order = _fixture(n=80, m=5, h=h, seed=1)
    codes, sink = icm_sweeps_dissect_reference(B0, u, b.to(torch.bfloat16), order,
                                               icmiter=3, variant="nowrite")
    assert torch.equal(codes, B0)
    want = torch.zeros(B0.shape[0])
    for j in _visits(order, 3):  # the state is never written: B0 throughout
        want += torch.argmin(ticm._condition(u[:, j], b[:, j], B0, j), dim=1).float()
    assert torch.equal(sink, want)


def _score_sum(u, b, B, visits, write=None):
    """Float64 sum over the visits of every candidate's score, with `write`
    put in column j after each visit when given."""
    cur = B.long().clone()
    total = torch.zeros(B.shape[0], dtype=torch.float64)
    for j in visits:
        total += ticm._condition(u[:, j].double(), b[:, j].double(), cur, j).sum(dim=1)
        if write is not None:
            cur[:, j] = write
    return cur.int(), total


@pytest.mark.parametrize("variant", ["noargmin", "mmonly"])
@pytest.mark.parametrize("h", [16, 48])
def test_noargmin_and_mmonly_codes_and_score_sums(variant, h):
    X, _, B0, u, b, order = _fixture(n=80, m=5, h=h, seed=2)
    u = u + 0.25 * _t(np.random.default_rng(3).normal(size=u.shape).astype(np.float32))
    codes, sink = icm_sweeps_dissect_reference(B0, u, b.to(torch.bfloat16), order,
                                               icmiter=2, variant=variant)
    want_codes, want = _score_sum(u, b, B0, _visits(order, 2),
                                  write=3 if variant == "noargmin" else None)
    assert torch.equal(codes, want_codes)
    if variant == "noargmin":
        assert (codes == 3).all()  # order is a permutation: every column visited
    np.testing.assert_allclose(sink.double().numpy(), want.numpy(), rtol=SINK_RTOL,
                               atol=SINK_RTOL * float(want.abs().mean()))


def test_sink_sums_in_the_kernels_lane_order():
    """h=40, one scoring visit: two candidates a lane, lane l adds candidates
    2l and 2l + 1 (lanes 20-31 hold none), then the xor butterfly. Scores
    2^24 at candidate 0 and 1 at every other: lane 0's 2^24 swallows its own
    +1 (2^24 + 1 rounds back to 2^24 in f32), lanes 1-19 hold 2 each, and
    they reach lane 0 as 2, 2, 4, 10 and 20: 2^24 + 38, where the sum in
    candidate order stays at 2^24 and the strided lane map (lane l adding
    l and l + 32) gives 2^24 + 30."""
    m, h = 2, 40
    u = torch.zeros((1, m, h))
    u[0, 0, :] = 1.0
    u[0, 0, 0] = 2.0 ** 24
    b = torch.zeros((m, m, h, h), dtype=torch.bfloat16)
    order = torch.tensor([0, 1], dtype=torch.int32)  # visit 1 scores only zeros
    _, sink = icm_sweeps_dissect_reference(torch.zeros((1, m), dtype=torch.int32), u, b,
                                           order, icmiter=1, variant="mmonly")
    assert float(sink[0]) == 2.0 ** 24 + 38


@pytest.mark.parametrize("h,cpl", [(1, 1), (32, 1), (33, 2), (40, 2), (64, 2), (65, 4),
                                   (256, 8), (300, 16), (512, 16), (513, 32), (1024, 32)])
def test_candidates_per_lane_follows_the_kernels_dispatch(h, cpl):
    assert candidates_per_lane(h) == cpl


def test_j_stacked_table_gives_the_same_results():
    _, _, B0, u, b, order = _fixture(n=40, m=3, h=32, seed=4)
    b16 = b.to(torch.bfloat16)
    stacked = binaries_to_j_stacked(b16)
    for variant in DISSECT_VARIANTS:
        a = icm_sweeps_dissect_reference(B0, u, b16, order, icmiter=2, variant=variant)
        s = icm_sweeps_dissect_reference(B0, u, stacked, order, icmiter=2, variant=variant)
        assert all(torch.equal(x, y) for x, y in zip(a, s)), variant


def test_wrapper_routes_cpu_to_plain_version_and_rejects_other_devices():
    _, _, B0, u, b, order = _fixture(n=32)
    b16 = b.to(torch.bfloat16)
    before = launch_counts.read()["dissect"]
    for variant in DISSECT_VARIANTS:
        got = icm_sweeps_dissect(B0, u, b16, order, icmiter=1, variant=variant)
        want = icm_sweeps_dissect_reference(B0, u, b16, order, icmiter=1, variant=variant)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), variant
    assert launch_counts.read()["dissect"] == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        icm_sweeps_dissect(B0.to("meta"), u.to("meta"), b16.to("meta"), order.to("meta"),
                           icmiter=1, variant="full")
    with pytest.raises(ValueError, match="variant"):
        icm_sweeps_dissect(B0, u, b16, order, icmiter=1, variant="nomatmul")
