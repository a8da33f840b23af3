"""The PyTorch port's ADC query and its K2 kernel, held to the JAX package.

K2's plain version (`scan_topk_reference`) must return the exact
(dist, id)-lexicographic top-k, id for id, as the Pallas kernel
`select_pallas.fused_scan_topk(variant="grouped")` run in interpret mode and
as the JAX `_run_scan`'s exact streaming merge. Integer LUTs make the TPU
kernel's bf16 hi/lo sums exact and make distance ties common.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import adc as jadc
from local_search_quantization_tpu.ops.select_pallas import fused_scan_topk
from local_search_quantization_torch.ops import adc as tadc
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops.select_kernels import scan_topk, scan_topk_reference

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _lex_oracle(luts, B, extra, k):
    """Numpy oracle: full distance matrix, lexsort by (dist, id)."""
    nq, m, _ = luts.shape
    full = luts[:, np.arange(m)[:, None], B.T].sum(1) + extra[None, :]
    ids = np.lexsort((np.broadcast_to(np.arange(B.shape[0]), full.shape), full),
                     axis=1)[:, :k]
    d = np.take_along_axis(full, ids, axis=1)
    return d, np.where(np.isinf(d), -1, ids)


def _integer_case(n, nq, m, h, seed, n_inf=0):
    rng = np.random.default_rng(seed)
    luts = rng.integers(-4, 5, size=(nq, m, h)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    extra = rng.integers(0, 3, size=n).astype(np.float32)
    if n_inf:
        extra[rng.choice(n, n_inf, replace=False)] = np.inf
    return luts, B, extra


@pytest.mark.parametrize("n,k,n_inf", [(3000, 50, 0), (2000, 300, 700),
                                       (200, 150, 120)])
def test_k2_plain_matches_pallas_grouped_kernel_with_ties(n, k, n_inf):
    """Tie-heavy integer distances; +inf rows (some cases have fewer finite
    rows than k, so (+inf, -1) sentinels appear): ids identical."""
    luts, B, extra = _integer_case(n, 12, 4, 16, seed=n, n_inf=n_inf)
    jd, ji = fused_scan_topk(jnp.asarray(luts), jnp.asarray(B.T), jnp.asarray(extra),
                             k=k, tb=1024, interpret=True, variant="grouped")
    td, ti = scan_topk_reference(_t(luts), _t(B.T), _t(extra), k, block=512)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    od, oi = _lex_oracle(luts, B, extra, k)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_array_equal(td.numpy(), od)
    # Ties must be present for the test to mean anything.
    assert (np.diff(od, axis=1) == 0).any()
    if n - n_inf < k:
        assert (ti.numpy()[:, n - n_inf:] == -1).all()


@pytest.mark.parametrize("h", [16, 300])
def test_run_scan_routes_match_jax_exact_merge(h, monkeypatch):
    """Every route of the port's `_run_scan` on CPU tensors (the kernels'
    plain versions) against the JAX `_run_scan`'s exact streaming merge: the
    tournament with its tie certificate, the kernel route under each select
    variant, the exact merge, approx (exact here) and auto. h=300 takes the
    int32 code layout."""
    n, nq, m, k = 1500, 10, 3, 40
    luts, B, extra = _integer_case(n, nq, m, h, seed=h)
    # Each "query" is its own row index into the fixed integer LUTs.
    Q = np.arange(nq, dtype=np.float32)[:, None]
    jres = jadc._run_scan(lambda q: jnp.asarray(luts)[q[:, 0].astype(jnp.int32)], Q, B,
                          k=k, extra=extra, query_chunk=8, base_block=512,
                          topk_method="exact")
    np.testing.assert_array_equal(np.asarray(jres.ids), _lex_oracle(luts, B, extra, k)[1])
    routes = [("exact", None), ("auto", None), ("approx", None), ("tournament", None),
              ("twopass", None)]
    routes += [("kernel", v) for v in ("grouped", "grouped_unsorted", "sorted",
                                       "unsorted", "key")]
    for method, variant in routes:
        if variant is None:
            monkeypatch.delenv("LSQ_TPU_SELECT_VARIANT", raising=False)
        else:
            monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", variant)
        tres = tadc._run_scan(lambda q: _t(luts)[q[:, 0].long()], _t(Q), _t(B), k=k,
                              extra=_t(extra),
                              query_chunk=4, base_block=256, topk_method=method)
        np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
        np.testing.assert_array_equal(tres.dists.numpy(), np.asarray(jres.dists))
        assert tres.ids.dtype == torch.int32


def test_linscan_lsq_matches_jax_on_integer_queries():
    """Whole query path: LUT build, norms as extra, rotation. Integer-valued
    queries and codebooks keep every LUT entry exact in both packages."""
    rng = np.random.default_rng(4)
    n, nq, d, m, h, k = 2500, 16, 8, 4, 16, 30
    Q = rng.integers(-2, 3, size=(nq, d)).astype(np.float32)
    C = rng.integers(-1, 2, size=(m, h, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    norms = rng.integers(0, 20, size=n).astype(np.float32)
    R = np.eye(d, dtype=np.float32)[rng.permutation(d)]
    jres = jadc.linscan_lsq(B, Q, jnp.asarray(C), norms, k=k, R=R,
                            topk_method="exact", base_block=512)
    tres = tadc.linscan_lsq(_t(B), _t(Q), _t(C), _t(norms), k=k, R=_t(R))
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_array_equal(tres.dists.numpy(), np.asarray(jres.dists))
    np.testing.assert_allclose(tadc.lsq_query_luts(_t(Q), _t(C)).numpy(),
                               np.asarray(jadc.lsq_query_luts(jnp.asarray(Q),
                                                              jnp.asarray(C))))


def test_lut_scan_block_matches_jax_gather_mode():
    rng = np.random.default_rng(2)
    luts = rng.normal(size=(5, 3, 8)).astype(np.float32)
    Bt = rng.integers(0, 8, size=(3, 100), dtype=np.int32)
    extra = rng.normal(size=100).astype(np.float32)
    j = jadc.lut_scan_block(jnp.asarray(luts), jnp.asarray(Bt), jnp.asarray(extra),
                            mode="gather")
    t = tadc.lut_scan_block(_t(luts), _t(Bt), _t(extra))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_k2_wrapper_routes_cpu_to_plain_version_and_rejects_other_devices():
    luts, B, extra = _integer_case(500, 3, 4, 16, seed=9)
    keys = ("k2_filter", "k2_select", "scan_topk_dense")
    before = [launch_counts.read()[key] for key in keys]
    d, i = scan_topk(_t(luts), _t(B.T), _t(extra), 20)
    assert [launch_counts.read()[key] for key in keys] == before
    od, oi = _lex_oracle(luts, B, extra, 20)
    np.testing.assert_array_equal(i.numpy(), oi)
    with pytest.raises(ValueError, match="unsupported device"):
        scan_topk(_t(luts).to("meta"), _t(B.T).to("meta"), None, 20)
