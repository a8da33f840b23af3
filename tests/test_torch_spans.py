"""The port's spans and counters on the CPU, and the benchmark's readers of
them: `Index.add` and `Index.search` emit their spans, nested under the entry
point, on the profiler's clock; a span enters no `record_function` while no
profiler runs; `launch_counts` resets every counter and counts no host sync
on the CPU; the four per-layer readers on hand-made traces and counts.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from local_search_quantization_torch import index as tindex
from local_search_quantization_torch.index import Index
from local_search_quantization_torch.ops import adc as tadc
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops import select_kernels as sk
from local_search_quantization_torch.utils import native, profiling
from portbench import trace
from portbench.run import read_metric

torch.set_num_threads(2)

ADD_SPANS = {"index.add", "index.add.random_codes", "index.add.encode",
             "encode.chunk_inputs", "index.add.codes_to_host", "index.add.norms",
             "index.add.append"}
SEARCH_SPANS = {"index.search", "index.search.luts", "index.search.scan_state",
                "k2.certify"}
NEW_COUNTERS = ("host_syncs", "search_calls", "add_calls", "rerun_warm", "rerun_widen",
                "rerun_tournament")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(n, 16)).astype(np.float32) for n in (600, 1500, 3000, 20))


def _index(data):
    xt, xb, _, _ = data
    return Index.build(xt, xb, "lsq", m=4, h=16, niter=2, ilsiter=2, seed=0, device="cpu")


def _through_k2(monkeypatch):
    """`Index.search` on the CPU through the card's route: the kernel route
    ("auto" takes the exact merge here), with K2's control flow
    (`k2_staged`) over its plain stages."""
    monkeypatch.setattr(native, "available", lambda: False)
    routed = tadc.scan_topk_routed
    monkeypatch.setattr(tadc, "scan_topk_routed",
                        lambda *a, **kw: routed(*a, **dict(kw, topk_method="kernel")))
    monkeypatch.setattr(sk, "scan_topk", lambda luts, Bt, extra, k: sk.k2_staged(
        luts, Bt, extra, min(k, Bt.shape[1]), prescan=sk._k2_prescan,
        filt=sk.k2_filter_reference, select=sk.k2_select_reference,
        dense=sk.scan_topk_reference, chunk=8)[:2])


def _annotations(path) -> list[dict]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] != trace.WINDOW]


def _inside(child: dict, parents: list[dict]) -> bool:
    return any(p["tid"] == child["tid"] and p["ts"] <= child["ts"]
               and child["ts"] + child["dur"] <= p["ts"] + p["dur"] for p in parents)


def test_add_and_search_emit_their_spans_nested_under_the_entry_point(
        data, tmp_path, monkeypatch):
    idx = _index(data)
    _, _, xa, q = data
    _through_k2(monkeypatch)
    monkeypatch.setattr(tindex, "_ENCODE_CHUNK", 1024)  # the chunked encode
    path = str(tmp_path / "t.json")
    with trace.capture(path):
        idx.add(xa)
        got = idx.search(q, k=10)
    ann = _annotations(path)
    assert {e["name"] for e in ann} == ADD_SPANS | SEARCH_SPANS
    for entry, names in (("index.add", ADD_SPANS), ("index.search", SEARCH_SPANS)):
        parents = [e for e in ann if e["name"] == entry]
        assert len(parents) == 1
        for e in ann:
            if e["name"] in names - {entry}:
                assert _inside(e, parents), (e["name"], entry)
    # K2's control flow over its plain stages answers as the CPU's route does.
    monkeypatch.undo()
    want = idx.search(q, k=10)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists, want.dists)


def test_refine_search_spans_the_outer_call_only(data, tmp_path):
    idx = _index(data)
    idx.attach_refine(data[1], "f32")
    path = str(tmp_path / "t.json")
    launch_counts.zero()
    with trace.capture(path):
        idx.search(data[3], k=5, refine=3)
    names = [e["name"] for e in _annotations(path)]
    assert names.count("index.search") == 1 and "index.search.luts" in names
    assert launch_counts.read()["search_calls"] == 1


def test_random_codes_span_names_the_host_at_its_middle(data, tmp_path):
    """The spans land in the window's trace on its clock: the trace's own
    `host_at` names the span at its middle (a numpy draw, no torch call)."""
    idx = _index(data)
    path = str(tmp_path / "t.json")
    with trace.capture(path):
        idx.add(np.tile(data[2], (4, 1)))
    tr = trace.Trace.load(path)
    (a, b), = [(s, e) for n, s, e in zip(tr.host_names, tr.host_start, tr.host_end)
               if n == "index.add.random_codes"]
    assert tr.t0 <= a < b <= tr.t1
    assert tr.host_at((a + b) / 2) == "index.add.random_codes"


def test_span_enters_no_record_function_without_a_profiler(data, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")

    idx = _index(data)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset()
    with profiling.span("phase"):
        pass
    idx.add(data[2])
    idx.search(data[3], k=10)
    rep = profiling.report()
    assert rep["phase"][1] == 1 and rep["index.add"][1] == 1 and rep["index.search"][1] == 1
    profiling.reset()


def test_launch_counts_reset_every_key_and_count_no_sync_on_the_cpu(data):
    for key in NEW_COUNTERS:
        launch_counts.COUNTS[key] += 3
    launch_counts.zero()
    assert all(launch_counts.read()[key] == 0 for key in NEW_COUNTERS)
    idx = _index(data)
    idx.add(data[2])
    idx.search(data[3], k=10)
    got = launch_counts.read()
    assert got["host_syncs"] == 0 and got["add_calls"] == 1 and got["search_calls"] == 1
    assert got["rerun_warm"] == got["rerun_widen"] == got["rerun_tournament"] == 0
    # What counts as a sync: a CUDA side, and for a copy, one side only.
    launch_counts.zero()
    launch_counts.sync(torch.device("cpu"))
    launch_counts.copy(np.zeros(3), "cpu")
    assert launch_counts.read()["host_syncs"] == 0
    launch_counts.sync(torch.device("cuda", 0))
    launch_counts.copy(np.zeros(3), "cuda")
    launch_counts.copy(torch.device("cuda"), torch.device("cuda", 0))
    assert launch_counts.read()["host_syncs"] == 2
    launch_counts.zero()


def _events():
    """A 100 us window: two adds [10, 40] and [60, 95] (the second nesting a
    phase), two searches, [-5, 5] (begun before the window, cut by it) and
    [45, 55]; the device runs [20, 30] and [70, 80]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "index.add", "ts": 10.0, "dur": 30.0},
          {"ph": "X", "cat": "user_annotation", "name": "index.add", "ts": 60.0, "dur": 35.0},
          {"ph": "X", "cat": "user_annotation", "name": "index.add.encode", "ts": 62.0,
           "dur": 20.0},
          {"ph": "X", "cat": "user_annotation", "name": "index.search", "ts": -5.0, "dur": 10.0},
          {"ph": "X", "cat": "user_annotation", "name": "index.search", "ts": 45.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "ils_kernel", "ts": 20.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "ils_kernel", "ts": 70.0, "dur": 10.0}]
    return ev


def test_exposed_ms_readers_intersect_idle_with_the_entry_points():
    run = types.SimpleNamespace(trace=trace.Trace(_events()), counts=None, work={})
    # Idle [0, 20], [30, 70], [80, 100]; adds [10, 40] and [60, 95]: idle
    # 10 + 10 + 10 + 15 = 45 us over 2 adds.
    assert read_metric("add_exposed_ms.ingest", run) == pytest.approx(45e-3 / 2)
    # Searches [-5, 5] (clipped to [0, 5], begun before the window) and
    # [45, 55]: idle 5 + 10 us over the one begun in the window.
    assert read_metric("search_exposed_ms.batch", run) == pytest.approx(15e-3)


@pytest.mark.parametrize("name,calls", [("host_syncs_per_call.ingest", "add_calls"),
                                        ("host_syncs_per_call.batch", "search_calls")])
def test_host_syncs_per_call_readers(name, calls):
    run = types.SimpleNamespace(trace=None, work={},
                                counts={"host_syncs": 24, calls: 2, "scan_topk_failed": 0})
    assert read_metric(name, run) == pytest.approx(12.0)
    run.counts[calls] = 0
    assert read_metric(name, run) is None


@pytest.mark.parametrize("name", ["add_exposed_ms.ingest", "search_exposed_ms.batch",
                                  "host_syncs_per_call.ingest", "host_syncs_per_call.batch"])
def test_readers_find_nothing_in_a_program_without_spans_or_counters(name):
    """A program without the spans and counters (the launch counts alone,
    a trace with no entry-point span) gives no value, and no error."""
    ev = [e for e in _events() if not e["name"].startswith("index.")]
    for tr in (None, trace.Trace(ev)):
        run = types.SimpleNamespace(trace=tr, work={},
                                    counts={"scan_topk_failed": 0, "k2_filter": 3})
        assert read_metric(name, run) is None
