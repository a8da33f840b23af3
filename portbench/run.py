"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: `workloads/<cell>.json` names the
configuration (`configs/<config>.json`), the driver (`drivers/<driver>.py`)
and the traffic's parameters; each per-layer metric is read by
`metrics/<metric>.py`. BENCHMARK.json says which metrics the cell reports.

A run sets up (corpus and index made from the seed, every shape of the cell
warmed), measures for `--seconds` (with `--trace 1` under the profiler),
frees the program's state, then compares what the window produced with the
plain reference (`check.py`). Its last stdout line is one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device` (and with a trace
`breakdown`), and last `checks`, each number compared beside its limit;
those lines end its stderr too. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import common  # noqa: E402

# Top-level module names that must not be loaded in the process that prints
# the result: JAX and the JAX package (compared whole: the port's name begins
# with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "local_search_quantization_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of a cell: what the driver and the metric readers share."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device,
                 tmp: str, wl: dict | None = None, cfg: dict | None = None):
        self.name, self.seed, self.seconds, self.tracing = name, seed, seconds, trace
        self.device, self.tmp = device, tmp
        self.wl = wl if wl is not None else common.workload(name)
        self.cfg = cfg if cfg is not None else common.config(self.wl["config"])
        self.trace = None  # trace.Trace of the window (with --trace 1)
        self.counts = None  # kernel launch counts over the window
        self.work: dict = {}  # what the window did, for the metric readers


def read_metric(name: str, run: Run):
    """`metrics/<name>.py`'s read(run): a number, or None where it finds
    nothing to read."""
    path = os.path.join(common.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def cell_metrics(bench: dict, name: str, kind: str) -> list[dict]:
    return [m for m in bench[kind] if "workloads" not in m or name in m["workloads"]]


def execute(run: Run, t_start: float = T_START, configure=None) -> dict:
    """Set up, measure, check: the end-to-end values, the numbers compared,
    the peak memory and the counts. Used by `main` on the card, and by the
    controls and the tests, which pass `configure(driver)` to switch a path
    of the program on or to break one."""
    import torch

    from local_search_quantization_torch.ops import launch_counts

    driver = importlib.import_module(f"portbench.drivers.{run.wl['driver']}").Driver(run)
    if configure is not None:
        configure(driver)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s", file=sys.stderr, flush=True)
    launch_counts.zero()
    if run.tracing and not driver.TRACES_ITSELF:
        from portbench import trace

        path = os.path.join(run.tmp, "window_trace.json")
        with trace.capture(path):
            driver.window(run.seconds)
        print(f"portbench: trace {os.path.getsize(path)} bytes", file=sys.stderr)
        run.trace = trace.Trace.load(path)
        os.remove(path)
    else:
        driver.window(run.seconds)
    if run.counts is None:
        run.counts = launch_counts.read()
    peak = driver.memory_peak()
    e2e = dict(driver.end_to_end(), setup_s=setup_s)
    driver.release()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    numbers = driver.check()
    numbers["failed"] = driver.failed
    return {"e2e": e2e, "numbers": numbers, "peak": peak, "attempted": driver.attempted,
            "failed": driver.failed}


def result_line(run: Run, out: dict, bench: dict, device: dict) -> tuple[dict, list[str]]:
    from portbench import check

    correct, lines = check.verdict(out["numbers"], run.wl.get("limits", {}))
    metrics = {}
    if run.tracing:
        for m in cell_metrics(bench, run.name, "per_layer"):
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace is not None:
            device = dict(device, busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    else:
        for m in cell_metrics(bench, run.name, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    res = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": device}
    if run.tracing and run.trace is not None:
        res["breakdown"] = run.trace.breakdown()
    limits = run.wl.get("limits", {})
    res["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in out["numbers"].items()}
    return res, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(common.cache_env())
    bench = common.benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {have}: "
              "no result", file=sys.stderr)
        return 3
    print(f"portbench: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s), torch {torch.__version__}; nvidia-smi: {common.card_line()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), tmp)
        out = execute(run)
        found = forbidden_modules()
        if found:
            print(f"portbench: modules that must not load were loaded: {found}",
                  file=sys.stderr)
            return 4
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                  "memory_peak_bytes": out["peak"]}
        res, lines = result_line(run, out, bench, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sys.stdout.flush()
    for line in lines:
        print(f"check: {line}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
