"""K1's function and its skip of the visits whose inputs did not change,
shown exact on the CPU.

K1's plain version (`ils_encode_streamed_reference`) computes the TPU
kernel's function: visits conditioned on the pairwise table rounded to
bf16, rounds accepted on the hi/lo cost. On tables where bf16 rounding
decides argmins it equals the Pallas kernel (`fused_ils_encode`, interpret
mode) bit for bit, and K1's function before the rounding (the f32 loop,
`f32_loop`) does not.

K1 (`csrc/ils_encode.cu`) skips a visit to codebook j when no other code of
the row changed since j's last visit in the round: its scores would be the
same floats, so its argmin the code j holds. `ils_visits_needed` counts the
visits K1 does. Here a replay of the plain loop, instrumented at every
visit, shows that each visit it leaves out would have kept its code, that
its count is a brute-force count's, and that a replay which skips them ends
with the Pallas kernel's codes. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import luts as jluts
from local_search_quantization_tpu.ops.icm_pallas import fused_ils_encode
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops import luts as tluts
from local_search_quantization_torch.ops.icm_kernels import (
    _k1_functions,
    ils_encode_streamed,
    ils_encode_streamed_reference,
    ils_visits_needed,
    split_hi_lo,
)
from test_torch_kernels_gpu import bf16_decisive_tables, f32_loop

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _inputs(n, d, m, h, R, npert, seed, integer=False):
    """K1's inputs from numpy: (unaries, binaries, xsq, B0, orders, keys, codes)."""
    rng = np.random.default_rng(seed)
    if integer:
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32)
        C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    X, C = _t(X), _t(C)
    return (tluts.get_unaries(X, C), tluts.get_binaries(C), (X * X).sum(-1),
            _t(rng.integers(0, h, (n, m), dtype=np.int32)),
            _t(np.stack([rng.permutation(m) for _ in range(R)]).astype(np.int32)),
            _t(rng.random((R, n, m), dtype=np.float32)),
            _t(rng.integers(0, h, (R, n, npert), dtype=np.int32)))


def _replay(u, b, xsq, B0, orders, pkeys, pcodes, icmiter, on_visit, keep=None):
    """The plain loop of `ils_encode_streamed_reference` (visits on the
    bf16-rounded table, the hi/lo cost), calling on_visit(r, s, j, scores,
    cur) before each visit writes; where `keep` ([rounds, icmiter*m, n]
    bool) is given, a row writes only where it is True, as K1 does. Returns
    the final codes and costs."""
    n, m, _ = u.shape
    rows = torch.arange(n)
    scores_at, cost = _k1_functions(u, b, xsq)
    best = B0.long().clone()
    best_cost = cost(best)
    for r in range(orders.shape[0]):
        cur = best.clone()
        keys = pkeys[r].clone()
        for p in range(pcodes.shape[2]):
            pos = torch.argmin(keys, dim=1)
            keys[rows, pos] = 1e30
            cur[rows, pos] = pcodes[r, :, p].long()
        for s, j in enumerate(orders[r].tolist() * icmiter):
            scores = scores_at(cur, j)
            on_visit(r, s, j, scores, cur)
            new = torch.argmin(scores, dim=1)
            cur[:, j] = new if keep is None else torch.where(keep[r, s], new, cur[:, j])
        newcost = cost(cur)
        better = newcost < best_cost
        best = torch.where(better[:, None], cur, best)
        best_cost = torch.where(better, newcost, best_cost)
    return best.int(), best_cost


def test_a_visit_left_out_would_have_kept_its_code():
    """m=7, h=32, icmiter=6, npert=2, 3 rounds: at every visit that
    `ils_visits_needed` does not count, the argmin of the scores is the code
    the row holds; the count is a brute-force count (a visit is needed when
    it is j's first in the round or another code differs from what it was at
    j's last visit); and the skip engages."""
    n, m, h, R, icmiter, npert = 384, 7, 32, 3, 6, 2
    args = _inputs(n, 16, m, h, R, npert, seed=3)
    needed = ils_visits_needed(*args, icmiter=icmiter)
    assert needed.shape == (R, icmiter * m, n) and needed.dtype == torch.bool
    brute = torch.zeros_like(needed)
    last = {}
    skipped_kept = []

    def on_visit(r, s, j, scores, cur):
        if s < m:  # j's first visit of this round
            brute[r, s] = True
        else:
            others = [k for k in range(m) if k != j]
            brute[r, s] = (cur[:, others] != last[j][:, others]).any(1)
        last[j] = cur.clone()
        left_out = ~needed[r, s]
        skipped_kept.append(bool((torch.argmin(scores, 1)[left_out]
                                  == cur[left_out, j]).all()))

    _replay(*args, icmiter, on_visit)
    assert all(skipped_kept)
    assert torch.equal(needed, brute)
    count, total = int(needed.sum()), needed.numel()
    assert 0 < count < total
    assert needed[:, :m].all()  # the perturbation precedes every round's first sweep


def test_skipping_replay_gives_the_pallas_kernels_codes():
    """A replay that does only the needed visits (what K1 does) ends with
    the codes and costs of the Pallas kernel in interpret mode, on an
    integer fixture where the TPU kernel's bf16 LUTs and sums are exact."""
    n, m, h, R, icmiter, npert = 64, 4, 16, 3, 3, 2
    rng = np.random.default_rng(0)
    X = rng.integers(-3, 4, size=(n, 16)).astype(np.float32)
    C = rng.integers(-1, 2, size=(m, h, 16)).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    unaries = jluts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    binaries = jluts.get_binaries(jnp.asarray(C))
    xsq = jnp.sum(jnp.asarray(X) ** 2, axis=-1)
    orders = np.stack([rng.permutation(m) for _ in range(R)]).astype(np.int32)
    key = jax.random.PRNGKey(11)
    jB, jcost, *_ = fused_ils_encode(key, jnp.asarray(orders), unaries, binaries, xsq,
                                     jnp.asarray(B0), ilsiter=R, icmiter=icmiter,
                                     npert=npert, tile=n, interpret=True)
    kk, kc = jax.random.split(key)
    pkeys = jax.random.uniform(kk, (R, n, m), jnp.float32)
    pcodes = jax.random.randint(kc, (R, n, npert), 0, h, dtype=jnp.int32)
    args = tuple(_t(a) for a in (unaries, binaries, xsq, B0, orders, pkeys, pcodes))
    needed = ils_visits_needed(*args, icmiter=icmiter)
    B, cost = _replay(*args, icmiter, lambda *a: None, keep=needed)
    np.testing.assert_array_equal(B.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    assert not needed.all() and (np.asarray(jB) != B0).any()


@pytest.mark.parametrize("m", [1, 2])
def test_visits_needed_at_one_and_two_codebooks(m):
    """m=1: the first visit of each round is needed and no other (no code
    but j's own, which a visit does not read). m=2: a visit is needed only
    where the other code's visit just before it was (and so could move it)."""
    R, icmiter = 3, 4
    args = _inputs(96, 8, m, 16, R, 1, seed=5)
    needed = ils_visits_needed(*args, icmiter=icmiter)
    assert needed[:, :m].all()
    if m == 1:
        assert not needed[:, 1:].any()
    else:
        assert not needed.all()
        for s in range(2, icmiter * m):
            assert not (needed[:, s] & ~needed[:, s - 1]).any()


def test_visits_needed_runs_the_plain_loop_on_the_plain_versions_inputs():
    """The helper replays the plain version: the rows' first sweeps are all
    needed, and the visits it counts shrink as the rows converge."""
    n, m, h, R, icmiter = 256, 7, 32, 2, 6
    args = _inputs(n, 16, m, h, R, 2, seed=9)
    needed = ils_visits_needed(*args, icmiter=icmiter).float()
    per_sweep = needed.reshape(R, icmiter, m, n).mean(dim=(2, 3))
    assert torch.all(per_sweep[:, 0] == 1)
    assert torch.all(per_sweep[:, -1] < per_sweep[:, 1])


def test_ils_encode_streamed_routes_cpu_to_plain_version_and_checks_its_device():
    args = _inputs(48, 8, 4, 16, 2, 2, seed=2, integer=True)
    want = ils_encode_streamed_reference(*args, icmiter=2, milestones=(1,), with_stats=True)
    before = launch_counts.read()["ils_encode"]
    got = ils_encode_streamed(*args, icmiter=2, milestones=(1,), with_stats=True)
    assert launch_counts.read()["ils_encode"] == before  # no kernel on the CPU
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        ils_encode_streamed(*meta, icmiter=2)


def _pallas_and_streamed(u, b, xsq, B0, R, icmiter, npert, milestones, seed):
    """The Pallas kernel's five outputs (interpret mode, tile = n) and the
    port's inputs for the same draws: (jax outputs, torch args)."""
    n, m, h = u.shape
    rng = np.random.default_rng(seed)
    orders = np.stack([rng.permutation(m) for _ in range(R)]).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    jout = fused_ils_encode(key, jnp.asarray(orders), jnp.asarray(u), jnp.asarray(b),
                            jnp.asarray(xsq), jnp.asarray(B0), ilsiter=R, icmiter=icmiter,
                            npert=npert, tile=n, interpret=True, milestones=milestones,
                            with_stats=True)
    kk, kc = jax.random.split(key)
    pkeys = jax.random.uniform(kk, (R, n, m), jnp.float32)
    pcodes = jax.random.randint(kc, (R, n, npert), 0, h, dtype=jnp.int32)
    return [np.asarray(o) for o in jout], tuple(
        _t(a) for a in (u, b, xsq, B0, orders, pkeys, pcodes))


@pytest.mark.parametrize("n,m,h,R,icmiter,npert", [(64, 4, 16, 3, 2, 2),
                                                   (48, 5, 24, 2, 3, 3)])
def test_k1_plain_is_the_pallas_kernel_where_bf16_rounding_decides(n, m, h, R, icmiter,
                                                                     npert):
    """On `bf16_decisive_tables` the port's K1 plain version gives the
    Pallas kernel's codes, costs, milestones and per-round counts bit for
    bit, and K1's function before its table was rounded (the f32 loop)
    gives other codes on the same inputs: the fixture tells the two apart."""
    u, b, xsq, B0 = bf16_decisive_tables(n, m, h, seed=m)
    hi, lo = split_hi_lo(_t(b))
    assert torch.equal(hi.float(), _t(b).round()) and torch.equal(
        lo.float(), _t(b) - _t(b).round())
    milestones = (1, R)
    jout, args = _pallas_and_streamed(u, b, xsq, B0, R, icmiter, npert, milestones, seed=7)
    port = ils_encode_streamed_reference(*args, icmiter=icmiter, milestones=milestones,
                                         with_stats=True)
    for got, want in zip(port, jout):
        np.testing.assert_array_equal(got.numpy(), want)
    f32 = f32_loop(*args, icmiter=icmiter, milestones=milestones)
    assert (f32[0].numpy() != jout[0]).any() and (f32[2].numpy() != jout[2]).any()
    assert (jout[0] != B0).any()


def test_k1_plain_costs_track_the_pallas_kernel_on_continuous_data():
    """Continuous unaries and tables: the port's returned costs within 1e-5
    relative of the Pallas kernel's (both sum the same bf16-rounded values;
    the TPU kernel's products may add them in another order), milestones
    alike, and the codes of at least 99% of the rows identical."""
    n, d, m, h, R, icmiter, npert = 200, 16, 4, 16, 4, 2, 2
    rng = np.random.default_rng(1)
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    Xj, Cj = jnp.asarray(X), jnp.asarray(C)
    u, b = np.asarray(jluts.get_unaries(Xj, Cj)), np.asarray(jluts.get_binaries(Cj))
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    jout, args = _pallas_and_streamed(u, b, (X * X).sum(-1), B0, R, icmiter, npert, (2,),
                                      seed=3)
    port = ils_encode_streamed_reference(*args, icmiter=icmiter, milestones=(2,),
                                         with_stats=True)
    np.testing.assert_allclose(port[1].numpy(), jout[1], rtol=1e-5)
    np.testing.assert_allclose(port[3].numpy(), jout[3], rtol=1e-5)
    assert (port[0].numpy() == jout[0]).all(1).mean() >= 0.99


@pytest.mark.parametrize("milestones", [(0,), (3,), (2, 1), (1, 1)])
def test_k1_refuses_milestones_it_would_leave_unwritten(milestones):
    """K1 writes a milestone's snapshot only at a round the encode reaches,
    into outputs that start as `torch.empty`: milestones that are not
    strictly increasing rounds in [1, rounds] are refused (ValueError) by
    the wrapper and its plain version alike, before any launch, as the TPU
    wrapper refuses those past the last round, repeated or out of order."""
    args = _inputs(32, 8, 4, 16, 2, 2, seed=3, integer=True)
    with pytest.raises(ValueError, match="milestones"):
        ils_encode_streamed(*args, icmiter=1, milestones=milestones)
    with pytest.raises(ValueError, match="milestones"):
        ils_encode_streamed_reference(*args, icmiter=1, milestones=milestones)
    if milestones != (0,):  # the TPU wrapper does not check the lower end
        u, b, xsq, B0, orders = (a.numpy() for a in args[:5])
        with pytest.raises(AssertionError):
            fused_ils_encode(jax.random.PRNGKey(0), jnp.asarray(orders), jnp.asarray(u),
                             jnp.asarray(b), jnp.asarray(xsq), jnp.asarray(B0), ilsiter=2,
                             icmiter=1, npert=2, tile=32, interpret=True,
                             milestones=milestones)
