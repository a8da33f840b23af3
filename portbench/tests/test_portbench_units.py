"""CPU tests of the benchmark's parts: traffic and corpus by seed, the metric
arithmetic, the roofline counts, the trace reading, and the plain reference
against brute force.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from portbench import common, corpus, roofline
from portbench.drivers import served
from portbench.reference import adc, ils
from portbench.trace import WINDOW, Trace, idle_pct

BIG_SEED = 2**31 + 977


def test_stream_seeds_split_and_repeat():
    assert common.stream_seed(BIG_SEED, "base") == common.stream_seed(BIG_SEED, "base")
    assert common.stream_seed(BIG_SEED, "base") != common.stream_seed(BIG_SEED, "query")
    assert common.stream_seed(BIG_SEED, "base") != common.stream_seed(BIG_SEED + 1, "base")
    assert 0 <= common.stream_seed(2**40, "x") < 2**63


def test_schedule_is_fixed_by_seed_and_same_set_for_every_seed():
    a = served.schedule(800.0, 3.0, [1, 16], 0.1, 10000, BIG_SEED)
    b = served.schedule(800.0, 3.0, [1, 16], 0.1, 10000, BIG_SEED)
    c = served.schedule(800.0, 3.0, [1, 16], 0.1, 10000, BIG_SEED + 1)
    assert a == b and a != c
    gaps = lambda s: sorted(round(t1 - t0, 9) for (t0, _), (t1, _) in zip([(0.0, [])] + s, s))
    assert gaps(a) == gaps(c)
    assert len(a) == 2400 and sum(len(r) == 16 for _, r in a) == 240
    assert sum(len(r) == 16 for _, r in c) == 240
    # The gaps are the exponential distribution's quantiles: mean 1/rate.
    assert a[-1][0] == pytest.approx(3.0, rel=0.01)


def test_corpus_is_fixed_by_seed():
    def make(seed):
        g = lambda s: torch.Generator().manual_seed(common.stream_seed(seed, s))
        model = corpus.make_model(g("model"), 128, 20000, "cpu")
        base, cids = corpus.draw(model, g("base"), 3000)
        q = corpus.queries(model, g("query"), base, cids, 50)
        return base, q

    b1, q1 = make(BIG_SEED)
    b2, q2 = make(BIG_SEED)
    b3, _ = make(BIG_SEED + 1)
    assert torch.equal(b1, b2) and torch.equal(q1, q2) and not torch.equal(b1, b3)
    # SIFT's values: integers in 0..255; norms concentrated near 480.
    assert torch.equal(b1, b1.round()) and b1.min() >= 0 and b1.max() <= 255
    norms = torch.linalg.norm(b1, dim=1)
    assert 400 < float(norms.median()) < 560 and float(norms.std() / norms.mean()) < 0.2


def test_percentile_counts_failures_as_misses():
    assert common.percentile([1.0] * 95 + [2.0] * 5, 95) == 1.0
    assert common.percentile([1.0] * 94 + [math.inf] * 6, 95) == math.inf
    assert common.percentile(list(range(1, 101)), 95) == 95


def test_latency_runs_from_due_time_and_failures_are_inf():
    recs = [{"due": 10.0, "done": 10.5, "error": None},
            {"due": 11.0, "done": None, "error": None},
            {"due": 12.0, "done": 12.001, "error": "ValueError: x"}]
    lat = served.latencies_ms(recs)
    assert lat[0] == pytest.approx(500.0) and lat[1] == math.inf and lat[2] == math.inf


def test_batch_rate_is_all_work_over_the_whole_window():
    from portbench.drivers import batch

    drv = batch.Driver(types.SimpleNamespace(cfg={}, wl={"traffic": {}}))
    drv.attempted, drv.failed, drv.window_s = 12000, 1000, 2.2
    assert drv.end_to_end()["search_qps"] == pytest.approx(11000 / 2.2)


def test_roofline_counts_match_the_kernel_table():
    # PERF.md section 6: K2 at 1000 queries x 1M rows, k=1000: 0.119 ms of
    # operations (8e9 adds and compares); K1 at n=131072, 4 rounds: 0.294 ms
    # of bytes (0.94 GB of unaries).
    assert roofline.scan_topk_s(1000, 1_000_000, 1000, 7, 256) * 1e3 == pytest.approx(0.1194, abs=1e-3)
    assert roofline.ils_encode_s(131072, 7, 256, 4) * 1e3 == pytest.approx(0.393, abs=2e-3)
    nbytes = 131072 * 7 * 256 * 4 + 7 * 7 * 256 * 256 * 4 + 2 * 131072 * 7 * 4 \
        + 131072 * 8 + 4 * 131072 * 11 * 4 + 4 * 7 * 4
    assert nbytes / roofline.HBM * 1e3 == pytest.approx(0.294, abs=1e-3)
    # At 16 rounds every visit's operations bound it.
    assert roofline.ils_encode_s(131072, 7, 256, 16) == pytest.approx(
        131072 * 16 * 4 * 7 * 256 * 7 / roofline.PEAK_F32)


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 40.0, "dur": 30.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 45.0,
           "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "k2_filter", "ts": 10.0, "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "k2_select", "ts": 30.0, "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150.0, "dur": 10.0}]
    return ev


def test_trace_busy_idle_and_breakdown():
    tr = Trace(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)  # [10, 50] and [70, 80]
    assert tr.device_s() == pytest.approx(60e-6) and tr.device_s("k2_") == pytest.approx(50e-6)
    assert idle_pct(types.SimpleNamespace(trace=tr)) == pytest.approx(50.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ("k2_filter", pytest.approx(30e-6))
    labels = dict(bd["idle_gaps"])
    assert labels["cudaStreamSynchronize"] == pytest.approx(20e-6)  # the gap [50, 70]
    assert idle_pct(types.SimpleNamespace(trace=None)) is None


def test_k2_roofline_reader_counts_the_work():
    from portbench.run import read_metric

    tr = Trace(_events())
    run = types.SimpleNamespace(trace=tr, work={"searches": [(2, 1000, 10, 7, 256)]},
                                counts={"scan_topk_failed": 1})
    want = 100.0 * roofline.scan_topk_s(2, 1000, 10, 7, 256) / 60e-6
    assert read_metric("k2_roofline_pct", run) == pytest.approx(want)
    assert read_metric("k2_rerun_pct", run) == pytest.approx(50.0)
    assert read_metric("device_idle_pct.batch", run) == pytest.approx(50.0)
    empty = types.SimpleNamespace(trace=None, work={}, counts=None)
    for name in ("k2_roofline_pct", "k2_rerun_pct", "k1_roofline_pct",
                 "device_idle_pct.ingest", "launches_per_req.served"):
        assert read_metric(name, empty) is None


def test_launches_per_request_reads_the_servers_counts():
    from portbench.run import read_metric

    counts = {k: 0 for k in ("ils_encode", "icm_sweeps_v2", "icm_sweeps_v1",
                             "icm_sweeps_dissect", "scan_select", "scan_key", "k2_filter",
                             "k2_select", "scan_topk_dense")}
    counts.update(scan_select=10, k2_filter=10, k2_select=10, scan_topk=10)
    run = types.SimpleNamespace(trace=None, work={"served_requests": 10}, counts=counts)
    assert read_metric("launches_per_req.served", run) == pytest.approx(3.0)


def _brute(Q, B, C, cbn):
    """Brute-force ADC distances in numpy float64, norms by argmin."""
    rec = sum(C[i][B[:, i]] for i in range(C.shape[0]))
    sq = (rec * rec).sum(1)
    norm = cbn[np.argmin(np.abs(sq[:, None] - cbn[None, :]), axis=1)]
    return -2.0 * Q @ rec.T + norm[None, :]


@pytest.fixture
def tiny_index():
    rng = np.random.default_rng(5)
    C = rng.normal(size=(4, 16, 8))
    B = rng.integers(0, 16, size=(3000, 4)).astype(np.int32)
    rec = sum(C[i][B[:, i]] for i in range(4))
    cbn = np.sort(np.quantile((rec * rec).sum(1), np.linspace(0.01, 0.99, 16)))
    Q = rng.normal(size=(6, 8))
    return Q, B, C, cbn


def test_reference_search_matches_brute_force(tiny_index):
    Q, B, C, cbn = tiny_index
    D = _brute(Q, B, C, cbn)
    k = 20
    ids = np.argsort(D, axis=1, kind="stable")[:, :k]
    dists = np.take_along_axis(D, ids, 1).astype(np.float32)
    s = adc.Searcher(B, torch.as_tensor(C), torch.as_tensor(cbn), "cpu")
    assert np.allclose(s.topk_hi(s.luts(Q), k).numpy(), np.sort(D, 1)[:, :k])
    got = adc.judge(s, Q, ids, dists, k)
    assert got["bad_ids"] == 0 and got["rank_gap"] < 1e-12 and got["dist_gap"] < 1e-6
    # An answer altered where it is produced: a worse row at rank 0.
    worse = ids.copy()
    worse[0, 0] = np.argsort(D[0])[-1]
    assert adc.judge(s, Q, worse, dists, k)["rank_gap"] > 1e-3
    # A distance off by a norm bin, a repeated id, an id out of range.
    off = dists.copy()
    off[1, 3] += float(np.diff(cbn).min())
    assert adc.judge(s, Q, ids, off, k)["dist_gap"] > 1e-3
    dup = ids.copy()
    dup[2, 1] = dup[2, 0]
    assert adc.judge(s, Q, dup, dists, k)["bad_ids"] == 1
    out = ids.copy()
    out[3, 0] = len(B)
    assert adc.judge(s, Q, out, dists, k)["bad_ids"] == 1


def test_norm_interval_takes_both_entries_at_a_midpoint():
    cbn = torch.tensor([1.0, 3.0, 7.0], dtype=torch.float64)
    sq = torch.tensor([0.5, 1.2, 2.0, 2.9, 5.0, 9.0], dtype=torch.float64)
    lo, hi = adc.norm_interval(sq, cbn)
    assert lo.tolist() == [1.0, 1.0, 1.0, 3.0, 3.0, 7.0]
    assert hi.tolist() == [1.0, 1.0, 3.0, 3.0, 7.0, 7.0]


def test_reference_encoder_beats_random_codes():
    torch.manual_seed(0)
    C = torch.randn(4, 16, 8, dtype=torch.float64) * 3
    Btrue = torch.randint(0, 16, (512, 4))
    X = sum(C[i][Btrue[:, i]] for i in range(4)) + 0.1 * torch.randn(512, 8, dtype=torch.float64)
    g = torch.Generator().manual_seed(1)
    B = ils.encode(X, C, g, ilsiter=8)
    err = float(ils.sq_error(X, C, B).sum())
    rand = float(ils.sq_error(X, C, torch.randint(0, 16, (512, 4))).sum())
    assert err < 0.2 * rand
    direct = ((X - sum(C[i][B[:, i]] for i in range(4))) ** 2).sum()
    assert err == pytest.approx(float(direct))
