"""The refine route (`Index.search(nprobe=, refine=)`: the probed ADC first
stage, then `refine.rerank` from an SQ8 store) against the benchmark's plain
reference (`portbench/reference/refine.py`), its span and counters, and the
refine cell's harness, on the CPU at a small size on the benchmark's own
corpus.

- The route is judged by the reference, every number within the cell's
  limits; its first stage's candidates hold every certain candidate and no
  row that is not possible.
- Mutants are flagged: an answer outside the candidates (`cand_miss`), a
  certain candidate dropped (`rank_gap`), the re-rank in bfloat16
  (`dist_gap`), one SQ8 code off by two (`store_bad`).
- The `index.search.refine.rerank` span is named under a profiler, inside
  `index.search`; `refine_queries` and `refine_candidates` advance by
  exactly the queries and candidate slots a call.
- The refine driver's set-up, window and check run at a toy size: a sound
  run is correct, its control (`portbench/controls_refine.py`) is not; the
  IVF cell's driver never enters the refine branch.
- The three per-layer readers on hand-made traces, and the roofline count.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from local_search_quantization_torch import refine as trefine
from local_search_quantization_torch.ops import launch_counts
from portbench import check, common, controls_refine, deploy, roofline, roofline_ivf
from portbench import roofline_refine, trace
from portbench import run as runmod
from portbench.drivers.ivf_batch import partition_state
from portbench.reference import adc as adc_ref
from portbench.reference import ivf as ivf_ref
from portbench.reference import refine as refine_ref

torch.set_num_threads(2)

CELL = "bigann10m-ivf16k-lsq64-sq8.refine-np64-r10-k100-b10k"
IVF_CELL = "bigann10m-ivf16k-lsq64.batch-np64-k10"
TINY = dict(d=16, n_train=3000, n_base=20000, n_query=200, m=4, h=16, niter=2, ilsiter=4,
            ivf={"nlist": 32, "sample": 4096, "iters": 5})
NPROBE, K, REFINE = 4, 10, 5
LIMITS = common.workload(CELL)["limits"]
SEED = 2**31 + 4242


def _deploy():
    """The cell's deployment at a toy size: the corpus and index of the
    configuration it names, a 32-list partition and the SQ8 store of the
    base vectors."""
    cfg = dict(common.config(common.workload(CELL)["config"]), **TINY)
    seeded = dict(cfg, name=cfg["corpus_of"])
    data = deploy.make_corpus(seeded, "cpu")
    idx = deploy.build_index(seeded, data, "cpu")
    idx.build_ivf(32, sample=4096, iters=5)
    idx.attach_refine(data.base, cfg["refine"]["kind"])
    return data, idx


@pytest.fixture(scope="module")
def setup():
    """The toy deployment, its first 48 queries, the reference over it, and
    a sample of base rows with the base's range for `store_bad`."""
    data, idx = _deploy()
    state = deploy.index_state(idx)
    searcher = adc_ref.Searcher(state["B"], state["C"], state["cbnorms"], "cpu")
    lists = ivf_ref.Lists(*partition_state(idx.ivf), "cpu")
    pick = torch.randperm(data.base.shape[0], generator=torch.Generator().manual_seed(7))[:512]
    base = (pick, data.base[pick].double(), data.base.amin(0).double(),
            data.base.amax(0).double())
    return idx, data.query[:48], searcher, lists, base


def _store(idx, data=None):
    st = idx.refine
    return refine_ref.Store(st.data if data is None else data, st.off, st.scale, "cpu")


def _judge(setup, res, store=None):
    idx, Q, searcher, lists, _ = setup
    return refine_ref.judge(searcher, lists, store or _store(idx), Q, res.ids, res.dists, K,
                            REFINE, NPROBE)


def _passes(numbers) -> bool:
    return check.verdict(dict({"store_bad": 0, "failed": 0}, **numbers), LIMITS)[0]


def test_the_refine_route_passes_the_reference(setup):
    idx, Q, _, _, base = setup
    numbers = _judge(setup, idx.search(Q, K, nprobe=NPROBE, refine=REFINE))
    numbers["store_bad"] = refine_ref.store_bad(_store(idx), *base)
    assert _passes(numbers), numbers
    assert numbers["store_bad"] == 0 and numbers["dist_gap"] < 1e-6


def test_the_first_stage_holds_every_certain_candidate_and_only_possible_ones(setup):
    idx, Q, searcher, lists, _ = setup
    first = idx.search(Q, REFINE * K, nprobe=NPROBE)
    luts = searcher.luts(Q)
    for i in range(Q.shape[0]):
        ids, certain, possible = refine_ref.candidates(searcher, lists, Q[i:i + 1],
                                                       luts[i:i + 1], NPROBE, REFINE * K)
        got = set(first.ids[i].tolist()) - {-1}
        assert set(ids[certain.numpy()].tolist()) <= got
        assert got <= set(ids[possible.numpy()].tolist())
        assert bool((certain <= possible).all())


def _outside_candidates(setup):
    """The last answer of each query swapped for a row of its farthest
    list, with that row's true distance."""
    idx, Q, _, lists, _ = setup
    res = idx.search(Q, K, nprobe=NPROBE, refine=REFINE)
    far = torch.argmax(lists.scores(Q), dim=1)
    ids, dists = res.ids.clone(), res.dists.clone()
    for i, li in enumerate(far.tolist()):
        row = int(lists.ids(torch.arange(lists.nlist) == li)[0])
        ids[i, -1] = row
        dists[i, -1] = float(((idx.refine.decode(torch.tensor([row]))[0] - Q[i]) ** 2).sum())
    return type(res)(dists, ids)


def _drops_the_best(setup):
    """Each query's best answer left out: the others move up a rank."""
    idx, Q, _, _, _ = setup
    res = idx.search(Q, K + 1, nprobe=NPROBE, refine=REFINE)
    return type(res)(res.dists[:, 1:], res.ids[:, 1:])


def _bf16_rerank(setup):
    idx, Q, _, _, _ = setup
    first = idx.search(Q, REFINE * K, nprobe=NPROBE)
    return controls_refine.rerank_bf16(idx.refine, Q, first.ids, K)


@pytest.mark.parametrize("mutant,number", [(_outside_candidates, "cand_miss"),
                                           (_drops_the_best, "rank_gap"),
                                           (_bf16_rerank, "dist_gap")])
def test_mutants_are_flagged(setup, mutant, number):
    numbers = _judge(setup, mutant(setup))
    assert not _passes(numbers), numbers
    assert numbers[number] > LIMITS[number], numbers


@pytest.mark.parametrize("step", [2, -2])
def test_a_code_off_by_two_is_flagged(setup, step):
    idx, _, _, _, base = setup
    data = idx.refine.data.clone()
    row, dim = int(base[0][3]), 5
    v = int(data[row, dim])
    data[row, dim] = v + step if 0 <= v + step <= 255 else v - step
    assert refine_ref.store_bad(_store(idx), *base) == 0
    assert refine_ref.store_bad(_store(idx, data), *base) == 1


def test_a_scale_off_by_more_than_rounding_is_flagged(setup):
    idx, _, _, _, base = setup
    st = idx.refine
    scale = st.scale.clone()
    scale[3] *= 1 + 2.0 ** -18
    assert refine_ref.store_bad(refine_ref.Store(st.data, st.off, scale, "cpu"), *base) >= 1


def _annotations(path) -> list[dict]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] != trace.WINDOW]


def test_the_rerank_span_is_named_inside_the_entry_point(setup, tmp_path):
    idx, Q, _, _, _ = setup
    path = str(tmp_path / "t.json")
    with trace.capture(path):
        idx.search(Q[:8], K, nprobe=NPROBE, refine=REFINE)
    ann = _annotations(path)
    names = {e["name"] for e in ann}
    assert {"index.search.refine.rerank", "index.search.ivf.probes",
            "index.search.ivf.scan"} <= names
    outer = [e for e in ann if e["name"] == "index.search"]
    inner = [e for e in ann if e["name"] == "index.search.refine.rerank"]
    assert len(outer) == 1 and len(inner) == 1
    assert outer[0]["ts"] <= inner[0]["ts"] and (inner[0]["ts"] + inner[0]["dur"]
                                                 <= outer[0]["ts"] + outer[0]["dur"])


def test_refine_counters_advance_by_the_queries_and_candidate_slots(setup):
    idx, Q, _, _, _ = setup
    launch_counts.zero()
    for calls in (1, 2):
        idx.search(Q, K, nprobe=NPROBE, refine=REFINE)
        got = launch_counts.read()
        assert got["refine_queries"] == calls * Q.shape[0]
        assert got["refine_candidates"] == calls * Q.shape[0] * REFINE * K
        assert got["search_calls"] == calls and got["host_syncs"] == 0
    # Padded slots count: c is the candidate slots, -1 included.
    launch_counts.zero()
    cand = torch.full((3, 7), -1, dtype=torch.int64)
    cand[:, 0] = 1
    res = trefine.rerank(idx.refine, Q[:3], cand, 2)
    assert res.ids[:, 1].eq(-1).all()
    got = launch_counts.read()
    assert got["refine_queries"] == 3 and got["refine_candidates"] == 21
    launch_counts.zero()
    assert launch_counts.read()["refine_candidates"] == 0


def _tiny_run(tmp_path, cell, traffic, configure=None):
    wl = common.workload(cell)
    wl = dict(wl, traffic=dict(wl["traffic"], **traffic))
    cfg = dict(common.config(wl["config"]), **TINY)
    run = runmod.Run(cell, SEED, 0.5, False, torch.device("cpu"), str(tmp_path), wl=wl, cfg=cfg)
    out = runmod.execute(run, time.perf_counter(), configure=configure)
    return check.verdict(out["numbers"], wl["limits"])[0], out, run


@pytest.mark.parametrize("control", [False, True])
def test_refine_driver_runs_and_checks_on_the_cpu(tmp_path, control):
    ok, out, run = _tiny_run(tmp_path, CELL, {"batch": 50, "k": K, "refine": REFINE,
                                              "nprobe": NPROBE, "check_queries": 32},
                             controls_refine.control_on if control else None)
    assert ok != control, out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0 and out["e2e"]["search_qps"] > 0
    assert out["numbers"]["store_bad"] == 0 and out["numbers"]["cand_miss"] == 0
    searches = run.work["refine_searches"]
    assert 50 * len(searches) == out["attempted"] and searches
    assert all(s[:3] == (50, 32, 16) and s[3] > 0 and s[6:] == (50, 50, K) for s in searches)
    if control:
        assert out["numbers"]["dist_gap"] > LIMITS["dist_gap"]
    else:
        assert run.counts["refine_queries"] == out["attempted"]
        assert run.counts["refine_candidates"] == REFINE * K * out["attempted"]


def test_the_ivf_cell_never_enters_the_refine_branch(tmp_path):
    ok, out, run = _tiny_run(tmp_path, IVF_CELL, {"batch": 50, "nprobe": NPROBE,
                                                  "check_queries": 16})
    assert ok and out["attempted"] > 0, out["numbers"]
    assert run.counts["refine_queries"] == 0 and run.counts["refine_candidates"] == 0


def _events():
    """A 100 us window: two searches [10, 40] and [60, 95] with their
    re-ranks [25, 38] and [75, 93]; the device runs [20, 30] and [70, 80]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 100.0}]
    for a, b in ((10.0, 40.0), (60.0, 95.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "index.search", "ts": a,
                   "dur": b - a})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "index.search.refine.rerank",
                   "ts": a + 15, "dur": b - a - 17})
        ev.append({"ph": "X", "cat": "kernel", "name": "gather", "ts": a + 10, "dur": 10.0})
    return ev


def test_refine_readers_on_hand_made_traces():
    searches = [(10_000, 16384, 128, 390_000_000, 7, 256, 1000, 1000, 100)] * 2
    run = types.SimpleNamespace(trace=trace.Trace(_events()),
                                work={"refine_searches": searches}, counts={})
    # Re-ranks [25, 38] and [75, 93], device [20, 30] and [70, 80]: idle 8 +
    # 13 us over 2 re-ranks.
    assert runmod.read_metric("rerank_exposed_ms", run) == pytest.approx(21e-3 / 2)
    assert runmod.read_metric("device_idle_pct.refine", run) == pytest.approx(80.0)
    least = 2 * roofline_refine.refine_search_s(*searches[0])
    assert runmod.read_metric("refine_roofline_pct", run) == pytest.approx(100 * least / 20e-6)
    # Nothing to read: no trace, no span (the parent's program), no searches.
    ev = [e for e in _events() if not e["name"].startswith("index.")]
    bare = types.SimpleNamespace(trace=trace.Trace(ev), work={}, counts={})
    for name in ("rerank_exposed_ms", "refine_roofline_pct"):
        assert runmod.read_metric(name, bare) is None
    for name in ("rerank_exposed_ms", "refine_roofline_pct", "device_idle_pct.refine"):
        assert runmod.read_metric(name, types.SimpleNamespace(trace=None, work={},
                                                              counts=None)) is None


def test_refine_roofline_counts_the_work():
    """At the cell's shape: the first stage at k = 1000 as the IVF count, plus
    the re-rank's gathered SQ8 rows, candidate ids and answers, on
    `roofline.py`'s peaks; bytes bound the re-rank."""
    nq, nlist, d, rows, m, h, rk, c, k = 10_000, 16384, 128, 390_000_000, 7, 256, 1000, 1000, 100
    nbytes = nq * c * d + nq * c * 8 + nq * k * 12
    assert nbytes == 1_372_000_000
    want = (roofline_ivf.ivf_search_s(nq, nlist, d, rows, m, h, rk)
            + max(3 * nq * c * d / roofline.PEAK_F32, nbytes / roofline.HBM))
    assert roofline_refine.refine_search_s(nq, nlist, d, rows, m, h, rk, c, k) == pytest.approx(
        want)
    assert roofline_refine.rerank_s(nq, c, d, k) == pytest.approx(nbytes / roofline.HBM)
    assert np.isclose(roofline_refine.rerank_s(nq, c, d, k), 4.0955e-4, rtol=1e-4)


def _modules_after(imports: str) -> set[str]:
    code = (f"import sys\n{imports}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(r.stdout.split())


def test_the_refine_harness_loads_no_jax_and_its_reference_nothing_of_the_port():
    mods = _modules_after("import portbench.drivers.refine_batch, portbench.controls_refine\n"
                          "import portbench.roofline_refine, portbench.reference.refine")
    assert not mods & set(runmod.FORBIDDEN), mods & set(runmod.FORBIDDEN)
    mods = _modules_after("import portbench.reference.refine")
    assert not mods & (set(runmod.FORBIDDEN) | {"local_search_quantization_torch"}), mods
