"""The port's encoder bench twins (`local_search_quantization_torch/benchmarks/`),
its profiling helpers, and its import boundary, on the CPU.

Each twin runs at a tiny size with `--device cpu` and prints the lines of
its JAX counterpart: the device line first, then its results; the headline
twin ends with the one-line JSON of bench.py. Without a GPU every twin
raises unless asked for the CPU. No module of the port imports JAX, the JAX
package or the JAX package's bench scripts.
"""

import ast
import json
import os
import re

import pytest
import torch

from local_search_quantization_torch.benchmarks import (
    bench,
    bench_icm_modes,
    bench_icm_phases,
    bench_ils_shapes,
    bench_kernel_variants,
    bench_train_encode,
    bench_viterbi,
)
from local_search_quantization_torch.benchmarks._common import baseline_vecs_per_sec
from local_search_quantization_torch.utils import profiling

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
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_on_the_cpu_and_prints_its_lines(name, capsys):
    module, argv, patterns = TWINS[name]
    module.main(argv + ["--device", "cpu"])
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


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_needs_a_gpu_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv, _ = TWINS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)


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
    return sorted(out) + ["chip_smoke.py"]


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
