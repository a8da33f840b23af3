"""`ops/launch_counts.py`, the one table of the port's counters, and the seam
of the kernel wrappers around it: `read()`'s keys, a set -> read -> zero
round trip for every counter, and, from the sources, that the counter module
imports nothing of the package, that no function carries a counter of its
own and that only `_build.py` declares a C signature of a `csrc/` library."""

import ast
import os
import re

import pytest
import torch

from local_search_quantization_torch import ivf
from local_search_quantization_torch.ops import icm_kernels, l2_probe, launch_counts
from local_search_quantization_torch.ops import select_kernels
from local_search_quantization_torch.utils import kernel_cases

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "local_search_quantization_torch")

# `read()`'s keys: those it returned before the counters moved into one
# table, "l2_gather", the coarse probes' "ivf_probes" and "ivf_probes_wide", and
# the re-rank's "refine_queries" and "refine_candidates".
READ_KEYS = {"ils_encode", "icm_sweeps_v2", "icm_sweeps_v1", "dissect", "icm_sweeps_dissect",
             "scan_select", "scan_key", "k2_filter", "k2_select", "scan_topk_dense",
             "scan_topk_failed", "scan_topk", "ivf_scan", "ivf_merge", "host_syncs",
             "search_calls", "add_calls", "rerun_warm", "rerun_widen", "rerun_tournament",
             "ivf_queries", "ivf_rows_scanned", "l2_gather", "ivf_probes", "ivf_probes_wide",
             "refine_queries", "refine_candidates"}


def _sources():
    """(path, text) of every Python source of the port, chip_smoke.py and
    the tests."""
    dirs = [_PKG, os.path.join(_ROOT, "tests")]
    paths = [os.path.join(_ROOT, "chip_smoke.py")]
    for top in dirs:
        for base, _, files in os.walk(top):
            paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in sorted(paths):
        with open(path) as f:
            yield os.path.relpath(path, _ROOT), f.read()


def test_read_returns_the_keys_it_returned_and_l2_gather():
    got = launch_counts.read()
    assert set(got) == READ_KEYS
    assert set(got["dissect"]) == set(icm_kernels.DISSECT_VARIANTS)
    assert set(launch_counts.LAUNCHES) <= READ_KEYS


@pytest.mark.parametrize("key", list(launch_counts.COUNTS))
def test_every_counter_is_set_read_and_zeroed(key):
    launch_counts.zero()
    launch_counts.COUNTS[key] += 3
    got = launch_counts.read()
    if key.startswith("dissect."):
        variant = key.split(".", 1)[1]
        assert got["dissect"] == {v: 3 * (v == variant) for v in icm_kernels.DISSECT_VARIANTS}
        assert got["icm_sweeps_dissect"] == 3
        seen = {"dissect", "icm_sweeps_dissect"}
    else:
        assert got[key] == 3
        seen = {key}
        if key in ("k2_filter", "scan_topk_dense"):
            assert got["scan_topk"] == 3
            seen.add("scan_topk")
    assert all(got[k] == 0 for k in READ_KEYS - seen - {"dissect"})
    # Every launch counter is a kernel launch to the catalogue of cases.
    launching = key.startswith("dissect.") or key in launch_counts.LAUNCHES
    assert kernel_cases.kernel_launches() == (3 if launching else 0)
    launch_counts.zero()
    got = launch_counts.read()
    assert all(v == 0 for k, v in got.items() if k != "dissect")
    assert not any(got["dissect"].values())


def test_a_device_counter_is_folded_in_and_zeroed():
    launch_counts.zero()
    launch_counts.device_counter("ivf_rows_scanned", "cpu").add_(5)
    launch_counts.COUNTS["ivf_rows_scanned"] += 2
    assert launch_counts.read()["ivf_rows_scanned"] == 7
    launch_counts.zero()
    assert launch_counts.read()["ivf_rows_scanned"] == 0
    assert int(launch_counts.device_counter("ivf_rows_scanned", torch.device("cpu"))) == 0


def test_launch_counts_imports_nothing_of_the_package():
    with open(launch_counts.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not any(n.startswith("local_search_quantization") for n in names), names
    assert not any(isinstance(n, ast.ImportFrom) and n.level for n in ast.walk(tree))


def test_no_function_keeps_a_counter_of_its_own():
    for module in (icm_kernels, select_kernels, ivf, l2_probe):
        for name, fn in vars(module).items():
            if callable(fn) and getattr(fn, "__module__", None) == module.__name__:
                assert not (set(getattr(fn, "__dict__", {}))
                            & {"launches", "dense_launches", "merge_launches", "failed"}), name
    attr = re.compile(r"\.(launches|dense_launches|merge_launches)\b|\bscan_topk\.failed\b")
    for path, text in _sources():
        assert not attr.search(text), f"{path}: a counter kept as a function attribute"


def test_only_build_declares_the_signatures_of_the_kernel_libraries():
    """Each C entry point of csrc/ is bound once, in `_build.py`; the host
    C++ scanner's bindings (`utils/native.py`) are not a csrc/ library."""
    declares = re.compile(r"\.(argtypes|restype)\s*=")
    allowed = {os.path.join("local_search_quantization_torch", "_build.py"),
               os.path.join("local_search_quantization_torch", "utils", "native.py")}
    found = {path for path, text in _sources() if declares.search(text)}
    assert found == allowed, found - allowed
