"""The port's bench twins (`local_search_quantization_torch/benchmarks/`), its
profiling helpers, and its import boundary, on the CPU.

Each twin runs at a tiny size with `--device cpu` and prints the lines of
its JAX counterpart: the device line first, then its results; the headline
twin ends with the one-line JSON of bench.py, bench_serve with its own JSON
line. Without a GPU every twin raises unless asked for the CPU. bench_ivf
scans on the host through the native library and raises with its message
where it is not built. No module of the port (its `scripts/` too) imports
JAX, the JAX package or the JAX package's bench scripts.
"""

import ast
import functools
import json
import os
import re

import numpy as np
import pytest
import torch

from local_search_quantization_torch.benchmarks import (
    bench,
    bench_bf16_refine,
    bench_icm_modes,
    bench_icm_phases,
    bench_ils_shapes,
    bench_ivf,
    bench_kernel_variants,
    bench_query,
    bench_scale,
    bench_select,
    bench_serve,
    bench_train_encode,
    bench_viterbi,
)
from local_search_quantization_torch.benchmarks._common import baseline_vecs_per_sec
from local_search_quantization_torch.index import Index
from local_search_quantization_torch.utils import native, profiling
from local_search_quantization_torch.utils.synth import synthetic_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "local_search_quantization_torch")
CPU_LINE = "device: cpu (host wall clock; no card time)"
NUM = r"[0-9.,]+"

TWINS = {
    "bench_kernel_variants": (
        bench_kernel_variants, ["--n", "96", "--d", "8", "--m", "3", "--h", "32",
                                "--rounds", "2"],
        [rf"{re.escape(f'{v:9s}')}: +{NUM} ms/round  \( *{NUM} ns per row-visit\)"
         for v in ("full", "predwrite", "nowrite", "noargmin", "mmonly", "K5 (v2)",
                   "K6 (v1)")]),
    "bench": (
        bench, ["--n", "64", "--d", "8", "--m", "3", "--h", "16", "--k-hi", "4",
                "--trials", "1"],
        [rf"\[bench\] 64 vecs, marginal over 2 ILS rounds \(icm=4, m=3, h=16, d=8, "
         rf"mode=kernel\): T2={NUM} ms T4={NUM} ms on cpu", r"\{.*\}"]),
    "bench_icm_phases": (
        bench_icm_phases, ["--n", "64", "--d", "8", "--m", "3", "--h", "16"],
        [rf"{re.escape(name)} *: +{NUM} ms/iter" for name in (
            "unaries einsum", "veccost", "perturb", "K5 fused kernel (4 icm)",
            "gather sweeps (4)", "matmul sweeps (4)")]),
    "bench_icm_modes": (
        bench_icm_modes, ["--n", "64", "--d", "8", "--m", "3", "--h", "16"],
        [rf"{mode:8s}: +{NUM} vec/s  \({NUM} ms/round\)"
         for mode in ("gather", "matmul", "fused", "kernel")]),
    "bench_ils_shapes": (
        bench_ils_shapes, ["3,16,8", "16,1024", "--n", "64"],
        [rf"m=3 h=16 d=8: +{NUM} vec/s per ILS round \({NUM}x the {NUM}k CUDA "
         rf"estimate at this width\)", r"m=16 h=1024 d=128: does not fit K1"]),
    "bench_viterbi": (
        bench_viterbi, ["--n-lo", "32", "--n-hi", "96", "--h", "16"],
        [rf"viterbi m=7 h=16 block=1024: +{NUM} vec/s \({NUM} T minplus-ops/s; "
         rf"T32={NUM} ms, T96={NUM} ms\)"]),
    "bench_train_encode": (
        bench_train_encode, ["--ntrain", "300", "--nbase", "200", "--h", "8",
                             "--iters", "2"],
        [rf"PQ train 300 x m=8 x 2 iters: first {NUM} s, steady {NUM} s \(error \S+\)",
         rf"OPQ train 300 x m=8 x 2 alternations: first {NUM} s, steady {NUM} s "
         rf"\(objective \S+\)",
         rf"LSQ-16 base encode of 200 vectors: {NUM} s wall \({NUM} vec/s end to end, "
         rf"host arrays in and codes back; first {NUM} s\); mean cost {NUM}"]),
    # The query-side twins; {index} and {cache} are the `made` fixture's.
    "bench_query": (
        bench_query, ["gather", "50", "--n", "5000", "--nq", "16"],
        [rf"mode=gather/exact: {NUM} qps over 5,000 codes \(k=50\) = \S+ code-dists/s  "
         rf"\[first={NUM}s steady={NUM}s\]"]),
    "bench_select": (
        bench_select, ["100", "8", "1024", "--n", "70000"],
        [r"note: the tb/nqt sweeps are the TPU's block geometry, which the port does not "
         r"have; ignored",
         rf"k=100 nq=8 m=7 h=256 sorted f32: cold +{NUM} qps \| warm +{NUM} qps"]),
    "bench_scale": (
        bench_scale, [],
        [rf"\[encode64m\] 256 rows x 2 ILS rounds in {NUM}s = {NUM} vec/s end-to-end "
         rf"\({NUM} vec/s per ILS round\), codes\+cost device-resident",
         *(rf"\[query100m:{run}\] 8 queries x k=1000 over 3,000 codes \(2 host-merged "
           rf"segments\) in {NUM}s = {NUM} qps incl. {NUM} GB H2D code streaming"
           for run in ("cold", "steady")),
         rf"\[k10000\] 4 queries x k=10000 over 12,000 codes \(auto route: CPU\) in "
         rf"{NUM}s = {NUM} qps"]),
    "bench_serve": (
        bench_serve, ["--index", "{index}", "--nq", "64", "--batch", "32", "--k", "10"],
        [rf"n=1500 nq=64 k=10 batch=32 device=cpu precision=f32 \| direct {NUM} qps",
         *(rf"  {re.escape(f'{mode:9s}')} {NUM} qps  \(overhead -?\d+%\)"
           for mode in bench_serve.MODES),
         r"\{\"direct_qps\": .*\}"]),
    "bench_bf16_refine": (
        bench_bf16_refine, ["--cache", "{cache}", "--n", "1500", "--ntrain", "600",
                            "--nq", "20", "--trials", "1"],
        [rf"\{{\"precision\": \"{p}\", \"refine\": {r}, \"k\": {k}, \"qps\": {NUM}, "
         rf"\"true_r@1\": {NUM}, \"true_r@10\": {NUM}\}}"
         for p in ("f32", "bf16") for r in (0, 4) for k in (10, 100)]),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """What the query-side twins read: a tiny PQ index directory for
    bench_serve, a prepared cache for bench_bf16_refine's measure phase."""
    root = tmp_path_factory.mktemp("twins")
    dd = synthetic_dataset(0, d=16, n_train=400, n_base=1500, n_query=1)
    Index.build(dd.train, dd.base, "pq", m=2, h=16, niter=2,
                device="cpu").save(str(root / "index"))
    bench_bf16_refine.prep(str(root / "cache"), n=1500, ntrain=600, nq=20, method="pq",
                           device="cpu")
    return {"index": str(root / "index"), "cache": str(root / "cache")}


# bench_scale's phases at a tiny size: its argv takes only the phase names
# (as the reference's), so the test gives the phase functions their sizes.
SCALE_TINY = {"encode64m": {"n_total": 256, "chunk": 128, "ilsiter": 2},
              "query100m": {"n_total": 3000, "nq": 8, "segment": 2048},
              "k10000": {"n": 12000, "nq": 4}}


def _argv(name: str, made) -> list[str]:
    return [a.format(**made) for a in TWINS[name][1]]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_on_the_cpu_and_prints_its_lines(name, made, capsys, monkeypatch):
    module, _, patterns = TWINS[name]
    if module is bench_scale:
        for phase, sizes in SCALE_TINY.items():
            monkeypatch.setattr(bench_scale, phase,
                                functools.partial(getattr(bench_scale, phase), **sizes))
    module.main(_argv(name, made) + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == CPU_LINE
    assert len(out) == 1 + len(patterns), out
    for line, pattern in zip(out[1:], patterns):
        assert re.fullmatch(pattern, line), (pattern, line)


def test_headline_twin_prints_bench_pys_json_last(capsys):
    _, argv, _ = TWINS["bench"]
    res = bench.main(argv + ["--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "ils_encode_throughput"
    assert last["value"] == round(res["vecs_per_sec"], 1) > 0
    assert last["vs_baseline"] == round(res["vecs_per_sec"] / baseline_vecs_per_sec(3, 4), 3)
    assert last["unit"] == "vectors/sec/cpu (1 ILS round: 4 ICM sweeps, m=3, h=16, d=8)"


def test_baseline_is_bench_pys_estimate():
    """The port's own copy of bench.py's denominator (bench.py:33-46)."""
    assert baseline_vecs_per_sec(7, 4) == 333_000.0
    assert baseline_vecs_per_sec(8, 4) == pytest.approx(333_000.0 * 168 / 224)


def test_ils_shapes_reports_a_failed_shape_and_exits_nonzero(monkeypatch, capsys):
    def boom(m, h, **kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(bench_ils_shapes, "bench_config", boom)
    with pytest.raises(SystemExit) as exit_:
        bench_ils_shapes.main(["7,16", "--device", "cpu"])
    assert exit_.value.code == 1
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        "m=7 h=16 d=128: FAILED — RuntimeError: out of memory")


@pytest.mark.parametrize("name", sorted(TWINS) + ["bench_ivf"])
def test_twin_needs_a_gpu_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = bench_ivf if name == "bench_ivf" else TWINS[name][0]
    argv = [] if name == "bench_ivf" else _argv(name, {"index": "unused", "cache": "unused"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)


def test_ivf_twin_prints_its_lines_or_needs_the_native_library(tmp_path, capsys):
    """The host IVF bench: with the native library, the exhaustive line and
    one row a probe count; without it, utils/native's error."""
    dd = synthetic_dataset(0, d=128, n_train=600, n_base=1000, n_query=20)
    corpus = str(tmp_path / "corpus.npz")
    np.savez(corpus, train=dd.train, base=dd.base, query=dd.query, gt=dd.gt)
    argv = ["--corpus", corpus, "--cache", str(tmp_path / "cache"), "--nq", "20",
            "--nlist", "4", "--sample", "800", "--kmeans-iters", "2", "--k", "10",
            "--device", "cpu"]
    if not native.has_ivf():
        with pytest.raises(RuntimeError, match=re.escape(native.NOT_BUILT)):
            bench_ivf.main(argv)
        return
    res = bench_ivf.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == CPU_LINE
    assert [json.loads(line)["nprobe"] for line in out[-3:]] == [1, 2, 4]
    assert res["exhaustive"]["qps"] > 0 and len(res["sweep"]) == 3


def test_profiling_spans():
    """As tests/test_utils_misc.py holds the JAX package's spans."""
    profiling.reset()
    with profiling.span("phase_a"):
        pass
    with profiling.span("phase_a"):
        pass
    rep = profiling.report()
    assert rep["phase_a"][1] == 2 and rep["phase_a"][0] >= 0.0
    profiling.reset()
    assert profiling.report() == {}


def test_profiling_trace_writes_a_trace_with_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced_phase"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "traced_phase" for e in events)


def _port_files():
    out = []
    for dirpath, _, files in os.walk(PACKAGE):
        out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                for f in files if f.endswith(".py")]
    demos = sorted(os.path.join("demos", f) for f in os.listdir(os.path.join(ROOT, "demos"))
                   if f.endswith("_torch.py"))
    return sorted(out) + demos + ["chip_smoke.py"]


FORBIDDEN = ("jax", "jaxlib", "local_search_quantization_tpu", "bench", "benchmarks")


@pytest.mark.parametrize("path", _port_files())
def test_port_imports_nothing_of_jax_or_its_benchmarks(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
