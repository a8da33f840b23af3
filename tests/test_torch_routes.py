"""Every scan route of the port's `_run_scan`, held to the JAX package's.

The same luts_fn (each "query" is its row index into fixed integer LUTs),
codes and extra term go through `local_search_quantization_tpu.ops.adc.
_run_scan` (its "kernel" route in Pallas interpret mode) and the port's
`_run_scan` on CPU tensors, where every kernel runs its plain version. Each
route runs at precision "f32" and "bf16" over the whole base, and at "f32"
with a `base_segment` below n and with a pre-uploaded `device_state`. ids
and dists must be identical: integer LUTs (plus quarter steps, exact in
bf16 and f32) make the sums exact and ties common. The native route skips
when the library is not built (make -C native).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from local_search_quantization_tpu.ops import adc as jadc
from local_search_quantization_tpu.utils import native as jnative
from local_search_quantization_torch.ops import adc as tadc
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.utils import native as tnative

torch.set_num_threads(2)

NQ, M, H, N, K = 8, 4, 16, 2000, 40


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    luts = (rng.integers(-4, 5, (NQ, M, H))
            + 0.25 * rng.integers(0, 3, (NQ, M, H))).astype(np.float32)
    B = rng.integers(0, H, (N, M)).astype(np.int32)
    extra = rng.integers(0, 3, N).astype(np.float32)
    extra[rng.choice(N, 100, replace=False)] = np.inf
    Q = np.arange(NQ, dtype=np.float32)[:, None]
    return luts, B, extra, Q


def _assert_same(jres, tres):
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_array_equal(tres.dists.numpy(), np.asarray(jres.dists))
    assert tres.ids.dtype == torch.int32 and tres.dists.dtype == torch.float32


# (label, topk_method, environment, extra keywords)
ROUTES = [
    ("kernel-grouped", "kernel", {"LSQ_TPU_SELECT_VARIANT": "grouped"}, {}),
    ("kernel-grouped_unsorted", "kernel",
     {"LSQ_TPU_SELECT_VARIANT": "grouped_unsorted"}, {}),
    ("kernel-sorted", "kernel", {"LSQ_TPU_SELECT_VARIANT": "sorted"}, {}),
    ("kernel-unsorted", "kernel", {"LSQ_TPU_SELECT_VARIANT": "unsorted"}, {}),
    ("kernel-key", "kernel", {"LSQ_TPU_SELECT_VARIANT": "key"}, {}),
    ("tournament-store", "tournament", {"LSQ_TPU_TOPK_STORE": "1"}, {"query_chunk": 4}),
    ("tournament-recompute", "twopass", {"LSQ_TPU_TOPK_STORE": "0"}, {"query_chunk": 4}),
    ("exact", "exact", {}, {"mode": "gather"}),
    ("approx", "approx", {}, {}),
    ("approx-r", "approx:0.9", {}, {}),
    ("auto", "auto", {}, {}),
    ("native", "native", {}, {}),
]
# Every route at both precisions over the whole base, and at f32 in
# base_segment=700 segments and over a pre-uploaded device_state.
CASES = [(*r, layout, precision) for r in ROUTES
         for layout, precision in (("whole", "f32"), ("whole", "bf16"),
                                   ("segments", "f32"), ("device_state", "f32"))]


@pytest.mark.parametrize("label,method,env,kw,layout,precision", CASES,
                         ids=[f"{c[0]}-{c[4]}-{c[5]}" for c in CASES])
def test_run_scan_route_matches_jax(case, monkeypatch, label, method, env, kw,
                                    layout, precision):
    if label == "native" and not (tnative.available() and jnative.available()):
        pytest.skip("native library not built (make -C native)")
    luts, B, extra, Q = case
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    kw = {"base_block": 512, "topk_method": method, "precision": precision, **kw}
    if label == "kernel-key" and precision == "bf16":
        # Both packages refuse the hi-only key variant at bf16.
        with pytest.raises(ValueError, match="hi-only"):
            jadc._run_scan(lambda q: jnp.asarray(luts)[q[:, 0].astype(jnp.int32)], Q,
                           B, k=K, extra=extra, **kw)
        with pytest.raises(ValueError, match="hi-only"):
            tadc._run_scan(lambda q: _t(luts)[q[:, 0].long()], _t(Q), B, k=K,
                           extra=extra, **kw)
        return
    jkw, tkw = dict(kw), dict(kw)
    if layout == "segments":
        jkw["base_segment"] = tkw["base_segment"] = 700
    elif layout == "device_state":
        jkw["device_state"] = jadc.prepare_device_codes(B, extra, base_block=512)
        tkw["device_state"] = tadc.prepare_device_codes(B, extra, base_block=512, h=H)
    jres = jadc._run_scan(lambda q: jnp.asarray(luts)[q[:, 0].astype(jnp.int32)], Q, B,
                          k=K, extra=extra, **jkw)
    tres = tadc._run_scan(lambda q: _t(luts)[q[:, 0].long()], _t(Q), B, k=K,
                          extra=extra, **tkw)
    _assert_same(jres, tres)


def test_prepare_device_codes_matches_jax(case):
    """The same [m, n_padded] codes and +inf-padded extra as the JAX package,
    uint8 at h <= 256 and int32 above."""
    luts, B, extra, Q = case
    jstate = jadc.prepare_device_codes(B, extra, base_block=512)
    tstate = tadc.prepare_device_codes(B, extra, base_block=512, h=H)
    assert tstate[0].dtype == torch.uint8 and tuple(tstate[0].shape) == (M, 2048)
    np.testing.assert_array_equal(tstate[0].numpy(), np.asarray(jstate[0]))
    np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(jstate[1]))
    assert tadc.prepare_device_codes(B, None, base_block=500, h=300)[0].dtype == torch.int32
    assert tadc.prepare_device_codes(B, None, base_block=500)[1] is None  # no pad


def test_stale_device_state_raises_the_same_error(case):
    luts, B, extra, Q = case
    jstate = jadc.prepare_device_codes(B, extra, base_block=512)
    tstate = tadc.prepare_device_codes(B, extra, base_block=512)
    grown = np.concatenate([B, B[:600]])
    with pytest.raises(ValueError, match="prepared for a different base") as je:
        jadc._run_scan(lambda q: jnp.asarray(luts), Q, grown, k=K, base_block=512,
                       device_state=jstate)
    with pytest.raises(ValueError, match="prepared for a different base") as te:
        tadc._run_scan(lambda q: _t(luts), _t(Q), grown, k=K, base_block=512,
                       device_state=tstate)
    assert str(je.value).split(" (")[0] == str(te.value).split(" (")[0]
    with pytest.raises(ValueError, match="segmented"):
        tadc._run_scan(lambda q: _t(luts), _t(Q), B, k=K, base_block=512,
                       base_segment=1000, device_state=tstate)


def test_tournament_certificate_reruns_tied_queries_and_counts_them(case):
    """Tie-heavy data: the certificate flags queries and their exact rerun
    keeps the answer lexicographic (`launch_counts` counts them)."""
    luts, B, extra, Q = case
    before = launch_counts.read()["rerun_tournament"]
    res = tadc._run_scan(lambda q: _t(luts)[q[:, 0].long()], _t(Q), B, k=K,
                         extra=extra, base_block=512, topk_method="tournament")
    assert launch_counts.read()["rerun_tournament"] > before
    want = tadc._run_scan(lambda q: _t(luts)[q[:, 0].long()], _t(Q), B, k=K,
                          extra=extra, base_block=512, topk_method="exact")
    assert torch.equal(res.ids, want.ids) and torch.equal(res.dists, want.dists)
    # The recompute-mode slack is one shared constant (see adc.TIE_SLACK).
    assert tadc.TIE_SLACK == 3e-5


def test_cuda_auto_route_choice(monkeypatch):
    monkeypatch.delenv("LSQ_TPU_SELECT_VARIANT", raising=False)
    assert tadc.cuda_route(1000, 1_000_000, 7, 256) == "kernel"
    assert tadc.cuda_route(10_000, 1_000_000, 7, 256) == "kernel"  # K2 holds any k
    assert tadc.cuda_route(300_000, 1_000_000, 7, 256) == "exact"  # 4k >= n
    assert tadc.cuda_route(1000, 1_000_000, 16, 1024) == "tournament"  # K2's LUTs
    monkeypatch.setenv("LSQ_TPU_SELECT_VARIANT", "sorted")
    assert tadc.cuda_route(10_000, 1_000_000, 7, 256) == "kernel"
    assert tadc.cuda_route(20_000, 1_000_000, 7, 256) == "tournament"  # K3's buffer


def test_unknown_route_mode_and_precision_raise(case):
    luts, B, extra, Q = case
    for kw in ({"topk_method": "heap"}, {"mode": "onehot"}, {"precision": "fp8"}):
        with pytest.raises(ValueError):
            tadc._run_scan(lambda q: _t(luts), _t(Q), B, k=K, **kw)
