"""The IVF route against the benchmark's plain reference (`portbench/reference/
ivf.py`), its spans and counters, and the IVF cell's harness, on the CPU at a
small size on the benchmark's own corpus.

- `ivf.DeviceScan` (on the CPU device) and `Index.search(nprobe=)`'s CPU route
  are judged by the reference, every number within the cell's limits.
- A coarse tie at the nprobe-th list, where either list may be probed,
  passes either way; mutants are flagged: an answer from a list outside the
  possible set, a scan that drops a certain list, LUTs rounded to bf16.
- The three IVF spans are named under a profiler, nested in `index.search`;
  `ivf_queries`, `ivf_rows_scanned` and `host_syncs` advance by exactly the
  expected amounts a call.
- The IVF driver's set-up, window and check run at a toy size: a sound run
  is correct, the bf16-LUT control (`portbench/controls_ivf.py`) is not.
- The four per-layer readers on hand-made traces and counts, and the
  roofline count.
"""

from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest
import torch

from local_search_quantization_torch import ivf as tivf
from local_search_quantization_torch.ops import launch_counts
from portbench import check, common, controls_ivf, deploy, roofline, roofline_ivf, trace
from portbench import run as runmod
from portbench.drivers.ivf_batch import partition_state
from portbench.reference import adc as adc_ref
from portbench.reference import ivf as ivf_ref

torch.set_num_threads(2)

CELL = "bigann10m-ivf16k-lsq64.batch-np64-k10"
TINY = dict(d=16, n_train=3000, n_base=20000, n_query=200, m=4, h=16, niter=2, ilsiter=4,
            ivf={"nlist": 32, "sample": 4096, "iters": 5})
NPROBE, K = 4, 10
LIMITS = common.workload(CELL)["limits"]
IVF_SPANS = {"index.search.ivf.probes", "index.search.ivf.scan", "index.search.ivf.tail"}


def _deploy():
    """The cell's deployment at a toy size: the corpus and index of the
    configuration it names, with a 32-list partition."""
    cfg = dict(common.config("bigann10m-ivf16k-lsq64"), **TINY)
    seeded = dict(cfg, name=cfg["corpus_of"])
    data = deploy.make_corpus(seeded, "cpu")
    idx = deploy.build_index(seeded, data, "cpu")
    idx.build_ivf(32, sample=4096, iters=5)
    return data, idx


@pytest.fixture(scope="module")
def setup():
    """The toy deployment, its first 64 queries, and the reference over it."""
    data, idx = _deploy()
    state = deploy.index_state(idx)
    searcher = adc_ref.Searcher(state["B"], state["C"], state["cbnorms"], "cpu")
    lists = ivf_ref.Lists(*partition_state(idx.ivf), "cpu")
    return idx, data.query[:64], searcher, lists


def _judge(setup, res, Q=None):
    idx, Q0, searcher, lists = setup
    return ivf_ref.judge(searcher, lists, Q0 if Q is None else Q, res.ids, res.dists, K,
                         NPROBE)


def _passes(numbers) -> bool:
    return check.verdict(dict(numbers, failed=0), LIMITS)[0]


def _device_scan(setup, luts=None, probes=None):
    idx, Q, _, _ = setup
    scan = tivf.DeviceScan(idx.ivf, "cpu")
    luts = idx._query_luts(Q) if luts is None else luts
    return scan.search(luts, K, scan.probes(Q, NPROBE) if probes is None else probes)


@pytest.mark.parametrize("route", ["device_scan", "index_cpu"])
def test_probed_routes_pass_the_reference(setup, route):
    idx, Q, _, _ = setup
    res = _device_scan(setup) if route == "device_scan" else idx.search(Q, K, nprobe=NPROBE)
    numbers = _judge(setup, res)
    assert _passes(numbers), numbers
    assert numbers["dist_gap"] < 1e-6


@pytest.mark.parametrize("pick", [0, 1])
def test_a_coarse_tie_at_the_nprobe_th_list_passes_either_way(setup, pick):
    """Two lists with the same centroid tie at the nprobe-th rank of a
    query: the reference may not require either and must accept both."""
    idx, Q, searcher, _ = setup
    q = Q[:1]
    part = tivf.IVFPartition(**{f: getattr(idx.ivf, f) for f in (
        "centroids", "cnorms", "order", "starts", "lives", "codes_g", "codesT_g",
        "extra_g", "pos_of_id", "n_grouped", "emin")})
    part.centroids = part.centroids.copy()
    rank = torch.argsort(ivf_ref.Lists(*partition_state(part), "cpu").scores(q)[0])
    a, b = int(rank[NPROBE - 1]), int(rank[NPROBE])
    part.centroids[b] = part.centroids[a]
    lists = ivf_ref.Lists(*partition_state(part), "cpu")
    certain, possible = lists.sets(q, NPROBE)
    assert not certain[0, a] and not certain[0, b] and possible[0, a] and possible[0, b]
    assert int(certain.sum()) == NPROBE - 1
    probes = torch.cat([rank[:NPROBE - 1], rank[NPROBE + pick - 1:NPROBE + pick]])[None]
    scan = tivf.DeviceScan(part, "cpu")
    res = scan.search(idx._query_luts(q), K, probes)
    numbers = ivf_ref.judge(searcher, lists, q, res.ids, res.dists, K, NPROBE)
    assert _passes(numbers), numbers


def _outside_possible(setup):
    """The last answer of each query swapped for a row of the query's
    farthest list, with that row's exact distance."""
    idx, Q, searcher, lists = setup
    res = _device_scan(setup)
    far = torch.argmax(lists.scores(Q), dim=1)
    ids, dists = res.ids.clone(), res.dists.clone()
    luts = searcher.luts(Q)
    for i, li in enumerate(far.tolist()):
        row = int(lists.ids(torch.arange(lists.nlist) == li)[0])
        lut, lo, _ = searcher.at(luts[i:i + 1], torch.tensor([[row]]))
        ids[i, -1], dists[i, -1] = row, float(lut + lo)
    return type(res)(dists, ids)


def _drops_a_certain_list(setup):
    """Each query's nearest list left out of its probes."""
    idx, Q, _, _ = setup
    probes = tivf.DeviceScan(idx.ivf, "cpu").probes(Q, NPROBE).clone()
    probes[:, 0] = -1
    return _device_scan(setup, probes=probes)


def _bf16_luts(setup):
    idx, Q, _, _ = setup
    return _device_scan(setup, luts=idx._query_luts(Q).to(torch.bfloat16).float())


@pytest.mark.parametrize("mutant,number", [(_outside_possible, "probe_miss"),
                                           (_drops_a_certain_list, "rank_gap"),
                                           (_bf16_luts, "dist_gap")])
def test_mutants_are_flagged(setup, mutant, number):
    numbers = _judge(setup, mutant(setup))
    assert not _passes(numbers), numbers
    assert numbers[number] > LIMITS[number], numbers


def _annotations(path) -> list[dict]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] != trace.WINDOW]


def test_ivf_spans_are_named_under_the_entry_point(tmp_path):
    """With rows added since the partition (a tail), a probed search emits
    the three IVF spans, each inside its `index.search`."""
    data, idx = _deploy()  # its own: the module's index keeps no tail
    idx.add(data.base[:300].numpy())
    path = str(tmp_path / "t.json")
    with trace.capture(path):
        idx.search(data.query[:16], K, nprobe=NPROBE)
    ann = _annotations(path)
    assert IVF_SPANS <= {e["name"] for e in ann}
    parents = [e for e in ann if e["name"] == "index.search"]
    assert len(parents) == 1
    for e in ann:
        if e["name"] in IVF_SPANS:
            assert parents[0]["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                                    <= parents[0]["ts"] + parents[0]["dur"])


def test_device_scan_counters_advance_by_the_expected_amounts(setup, monkeypatch):
    """A call counts its queries, the live rows of the lists it probes, and
    its one host sync; on the CPU no sync is counted, so the sync is counted
    here with every tensor taken for a CUDA one."""
    idx, Q, _, _ = setup
    scan = tivf.DeviceScan(idx.ivf, "cpu")
    probes = scan.probes(Q, NPROBE)
    probes[0, 1] = -1  # an unused probe slot scans nothing
    rows = int(sum(idx.ivf.lives[p] for p in probes.flatten().tolist() if p >= 0))
    luts = idx._query_luts(Q)
    launch_counts.zero()
    for calls in (1, 2):
        scan.search(luts, K, probes)
        got = launch_counts.read()
        assert got["ivf_queries"] == calls * Q.shape[0]
        assert got["ivf_rows_scanned"] == calls * rows
        assert got["host_syncs"] == 0
    monkeypatch.setattr(launch_counts, "_is_cuda", lambda where: True)
    launch_counts.zero()
    scan.search(luts, K, probes)
    scan.search(luts, K, probes[:, :0])  # nothing probed: no read, no sync
    got = launch_counts.read()
    assert got["host_syncs"] == 1 and got["ivf_queries"] == 2 * Q.shape[0]
    assert got["ivf_rows_scanned"] == rows
    launch_counts.zero()
    assert launch_counts.read()["ivf_rows_scanned"] == 0


@pytest.mark.parametrize("k,cap", [(1, 32), (10, 32), (32, 32), (33, 256), (256, 256),
                                   (257, 2048), (1000, 2048), (2048, 2048)])
def test_ivf_kcap_takes_the_least_capacity_that_holds_k(k, cap):
    assert tivf.ivf_kcap(k) == cap


@pytest.mark.parametrize("k", [0, 2049, 10_000])
def test_ivf_kcap_refuses_a_k_beyond_the_kernel_and_names_its_cap(k):
    with pytest.raises(ValueError, match="2048"):
        tivf.ivf_kcap(k)


@pytest.mark.parametrize("nq,p,k,mean_rows,want", [
    (1000, 64, 10, 610.0, 3),  # the IVF cell: about 13k rows a slice
    (10_000, 64, 10, 610.0, 3),  # more queries fill the card alone; rows still cut
    (100, 64, 10, 610.0, 8),  # fewer queries: slices fill the card
    (1, 64, 10, 610.0, 256),  # one query: as many slices as the card wants, to the most
    (33, 12, 10, 184.0, 24),
    (1000, 32, 1000, 977.0, 2),  # chip_smoke path C at k=1000: a slice keeps >= 8k rows
    (10_000, 1024, 1000, 977.0, 3),  # the workspace's keys cap it
    (1000, 64, 2048, 610.0, 2),
    (4, 1, 10, 0.0, 1),  # nothing to scan: one slice
])
def test_ivf_slices_from_the_shapes_the_host_knows(nq, p, k, mean_rows, want):
    got = tivf.ivf_slices(nq, p, k, mean_rows, 132)
    assert got == want
    assert nq * got * k <= max(tivf._IVF_WORK_KEYS, nq * k)


def test_ivf_scan_refuses_a_device_it_has_no_version_for(setup):
    idx, Q, _, _ = setup
    scan = tivf.DeviceScan(idx.ivf, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tivf.ivf_scan(idx._query_luts(Q).to("meta"), K, scan.probes(Q, NPROBE), scan.starts,
                      scan.lives, scan.codesT, scan.extra, scan.order, scan.mean_rows)


def test_device_scan_holds_the_planes_the_plain_version_reads_as_rows(setup):
    """The kernel reads the codes as planes, the plain version as rows of
    their transpose: one upload serves both."""
    idx = setup[0]
    scan = tivf.DeviceScan(idx.ivf, "cpu")
    assert scan.codesT.is_contiguous()
    assert torch.equal(scan.codesT.t(), torch.as_tensor(idx.ivf.codes_g))
    assert scan.mean_rows == pytest.approx(float(idx.ivf.lives.mean()))


def _tiny_run(tmp_path, configure=None):
    wl = common.workload(CELL)
    wl = dict(wl, traffic=dict(wl["traffic"], batch=50, nprobe=NPROBE, check_queries=32))
    cfg = dict(common.config(wl["config"]), **TINY)
    run = runmod.Run(CELL, 2**31 + 4242, 0.5, False, torch.device("cpu"), str(tmp_path),
                     wl=wl, cfg=cfg)
    out = runmod.execute(run, time.perf_counter(), configure=configure)
    return check.verdict(out["numbers"], wl["limits"])[0], out, run


@pytest.mark.parametrize("control", [False, True])
def test_ivf_driver_runs_and_checks_on_the_cpu(tmp_path, control):
    ok, out, run = _tiny_run(tmp_path, controls_ivf.control_on if control else None)
    assert ok != control, out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0 and out["e2e"]["search_qps"] > 0
    searches = run.work["ivf_searches"]
    assert len(searches) == len(run.work["searches"]) >= 1
    assert all(s[:3] == (50, 32, 16) and s[3] > 0 for s in searches)
    if control:
        assert out["numbers"]["dist_gap"] > LIMITS["dist_gap"]


def _events():
    """A 100 us window: two searches [10, 40] and [60, 95] with their scans
    [15, 35] and [65, 90]; the device runs [20, 30] and [70, 80]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 100.0}]
    for a, b in ((10.0, 40.0), (60.0, 95.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "index.search", "ts": a,
                   "dur": b - a})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "index.search.ivf.scan",
                   "ts": a + 5, "dur": b - a - 10})
        ev.append({"ph": "X", "cat": "kernel", "name": "gather", "ts": a + 10, "dur": 10.0})
    return ev


def test_ivf_readers_on_hand_made_traces_and_counts():
    searches = [(1000, 16384, 128, 42_000_000, 7, 256, 10)] * 2
    run = types.SimpleNamespace(trace=trace.Trace(_events()), work={"ivf_searches": searches},
                                counts={"host_syncs": 6, "search_calls": 2})
    # Scans [15, 35] and [65, 90], device [20, 30] and [70, 80]: idle 10 + 15
    # us over 2 scans.
    assert runmod.read_metric("ivf_scan_exposed_ms", run) == pytest.approx(25e-3 / 2)
    assert runmod.read_metric("host_syncs_per_call.ivf", run) == pytest.approx(3.0)
    assert runmod.read_metric("device_idle_pct.ivf", run) == pytest.approx(80.0)
    least = 2 * roofline_ivf.ivf_search_s(*searches[0])
    assert runmod.read_metric("ivf_roofline_pct", run) == pytest.approx(100 * least / 20e-6)
    # Nothing to read: no trace, no spans, no counters, no searches.
    ev = [e for e in _events() if not e["name"].startswith("index.")]
    bare = types.SimpleNamespace(trace=trace.Trace(ev), work={}, counts={"k2_filter": 0})
    for name in ("ivf_scan_exposed_ms", "host_syncs_per_call.ivf", "ivf_roofline_pct"):
        assert runmod.read_metric(name, bare) is None
        assert runmod.read_metric(name, types.SimpleNamespace(trace=None, work={},
                                                              counts=None)) is None


def test_ivf_roofline_counts_the_work():
    """At the cell's shape: the coarse product and the probed rows' bytes,
    on `roofline.py`'s peaks; bytes bound it."""
    nq, nlist, d, rows, m, h, k = 1000, 16384, 128, 42_000_000, 7, 256, 10
    ops = 2 * nq * nlist * d + rows * (m + 1)
    nbytes = nlist * d * 4 + rows * (m + 4) + nq * m * h * 4 + nq * k * 8
    assert roofline_ivf.ivf_search_s(nq, nlist, d, rows, m, h, k) == pytest.approx(
        max(ops / roofline.PEAK_F32, nbytes / roofline.HBM))
    assert nbytes / roofline.HBM > ops / roofline.PEAK_F32


# The coarse probes' plain version (`ivf.coarse_probes_reference`, what
# `DeviceScan.probes` runs on the CPU and the oracle of the card's kernel).


def _probe_inputs(nq, nlist, d, seed, lim):
    """Integer queries and centroids in [-lim, lim]: every score exact in f32
    where d * 3 lim^2 < 2^24."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-lim, lim + 1, (nq, d)).astype(np.float32),
            rng.integers(-lim, lim + 1, (nlist, d)).astype(np.float32))


def test_coarse_probes_reference_is_the_numpy_probes_on_tie_free_data():
    Q, C = _probe_inputs(40, 100, 16, 5, 300)
    s64 = (C.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * Q.astype(np.float64) @ C.T
    assert all(np.unique(row).size == row.size for row in s64)  # no two lists tie
    part = types.SimpleNamespace(centroids=C, cnorms=(C * C).sum(1), nlist=100)
    for nprobe in (1, 17, 100):
        want = tivf.coarse_probes(Q, part, nprobe)
        got = tivf.coarse_probes_reference(torch.as_tensor(Q), torch.as_tensor(C.T.copy()),
                                           torch.as_tensor(part.cnorms), nprobe)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nprobe", [1, 2, 5])
def test_coarse_probes_reference_gives_an_exact_tie_to_the_lower_list(nprobe):
    """Lists 3 and 9 (and 20) have one centroid, on which query 0 lies: they
    tie at the least score, and the lower ids come first; with nprobe 1 the
    tie across the last slot keeps list 3."""
    Q, C = _probe_inputs(4, 30, 8, 6, 3)
    C[9] = C[20] = C[3]
    Q[0] = C[3]
    got = tivf.coarse_probes_reference(torch.as_tensor(Q), torch.as_tensor(C.T.copy()),
                                       torch.as_tensor((C * C).sum(1)), nprobe)
    assert got[0, :min(nprobe, 3)].tolist() == [3, 9, 20][:nprobe]


def test_coarse_probes_reference_returns_every_list_at_nprobe_nlist():
    Q, C = _probe_inputs(9, 70, 12, 7, 3)
    args = (torch.as_tensor(Q), torch.as_tensor(C.T.copy()), torch.as_tensor((C * C).sum(1)))
    for nprobe in (70, 71, 10_000):
        got = tivf.coarse_probes_reference(*args, nprobe)
        assert tuple(got.shape) == (9, 70)
        assert torch.equal(torch.sort(got, dim=1).values, torch.arange(70).expand(9, 70))
    # A list whose score is not finite is never returned: its slot is -1.
    C[4, 0] = np.inf
    got = tivf.coarse_probes_reference(torch.as_tensor(Q), torch.as_tensor(C.T.copy()),
                                       torch.as_tensor((C * C).sum(1)), 70)
    assert (got[:, -1] == -1).all() and not (got == 4).any()


def test_ivf_probes_on_the_cpu_takes_the_plain_version_and_refuses_what_it_has_none_for(setup):
    idx, Q, _, _ = setup
    scan = tivf.DeviceScan(idx.ivf, "cpu")
    assert tuple(scan.centroidsT.shape) == (idx.ivf.centroids.shape[1], idx.ivf.nlist)
    launch_counts.zero()
    got = scan.probes(Q, NPROBE)
    assert torch.equal(got, tivf.coarse_probes_reference(Q, scan.centroidsT, scan.cnorms, NPROBE))
    counts = launch_counts.read()
    assert counts["ivf_probes"] == 0 and counts["ivf_probes_wide"] == 0
    with pytest.raises(ValueError, match="nprobe=0"):
        scan.probes(Q, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tivf.ivf_probes(Q.to("meta"), scan.centroidsT.to("meta"), scan.cnorms.to("meta"), 4)


@pytest.mark.parametrize("nq,nlist,want", [
    (1000, 16384, 8),  # the IVF cell: 16 query tiles x 8 chunks, one wave of 128 blocks
    (1, 16384, 64),  # one query: a chunk a tile of 256 lists
    (7, 1000, 3),  # the tiles cap it: every chunk a whole tile at least
    (1000, 1024, 4),
    (1, 65536, 132),  # a wave of blocks: one a chunk
    (20_000, 16384, 1),  # more query tiles than SMs: one chunk
    (5, 200, 1),  # fewer lists than a tile
])
def test_ivf_probe_plan_from_the_shapes_the_host_knows(nq, nlist, want):
    assert tivf.ivf_probe_plan(nq, nlist, 132) == want
