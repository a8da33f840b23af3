"""The port's counters, read and reset together: kernel launches, certificate
reruns, host syncs and entry-point calls.

Every counter is a key of `COUNTS`. Each kernel wrapper adds one to its key
where it launches its kernel (on a CUDA tensor) and nowhere else, so on the
CPU every launch count stays 0:

- `ils_encode` (K1), `icm_sweeps_v2`/`icm_sweeps_v1` (K5/K6),
  `dissect.<variant>` (K7, one key a variant), `scan_select` (K3, also K2's
  pre-scan), `scan_key` (K4), `k2_filter`, `k2_select` and `scan_topk_dense`
  (K2's stages and its dense path), `ivf_probes` (the coarse probes: a
  call of the entry point, which launches the scan and then the selection
  among its chunks' candidates), `ivf_scan` and `ivf_merge`
  (the probed scan, and its merge where a query has several slices),
  `l2_gather` (the L2 probe, on no path);
- `ivf_probes_wide`: the calls of `ivf.ivf_probes` on a CUDA tensor that
  took the torch form (a shape the kernel does not serve: nprobe above 64
  or d above 128);
- `scan_topk_failed`: the queries K2 reran on its dense path after a failed
  certificate;
- `host_syncs`: the sites on the `Index.add` and `Index.search` paths where
  the host waits on the card (a `torch.nonzero`, a blocking copy between
  host and card), counted only for CUDA tensors, like the launches (`sync`,
  `copy`);
- `search_calls`, `add_calls`: calls of `Index.search` (the outer call where
  refine recurses) and `Index.add`;
- `rerun_warm`, `rerun_widen`, `rerun_tournament`: the queries rerun by the
  kernel route's warm start, its deep-k widen and the tournament's tie
  certificate (queries, not batches).
- `ivf_queries`, `ivf_rows_scanned`: the queries the probed scan
  (`ivf.ivf_scan`) searched, and the live rows of the lists each probed,
  summed over them. The kernel adds its rows on the card, to a
  `device_counter`, so that the call reads nothing back; `read` folds that
  counter in (one host read, at the read).
- `refine_queries`, `refine_candidates`: the queries `refine.rerank`
  re-ranked, and their candidate slots (nq x c, the -1 pads included),
  added on the host from the shapes alone, with no sync, on any device.

The server reports these at its end; a GPU run reads them around the work it
drives. This module imports nothing of the package, so that every module can
import it.
"""

from __future__ import annotations

import torch

# K7's variants, in the order of its C entry point's `variant` argument.
DISSECT_VARIANTS = ("full", "predwrite", "nowrite", "noargmin", "mmonly")
# `read`'s keys that count the launches of one kernel each; K7's is the sum of
# its variants' keys "dissect.<variant>".
LAUNCHES = ("ils_encode", "icm_sweeps_v2", "icm_sweeps_v1", "icm_sweeps_dissect",
            "scan_select", "scan_key", "k2_filter", "k2_select", "scan_topk_dense",
            "ivf_probes", "ivf_scan", "ivf_merge", "l2_gather")
COUNTS = dict.fromkeys(
    [key for key in LAUNCHES if key != "icm_sweeps_dissect"]
    + [f"dissect.{v}" for v in DISSECT_VARIANTS]
    + ["scan_topk_failed", "ivf_probes_wide", "host_syncs", "search_calls", "add_calls",
       "rerun_warm", "rerun_widen", "rerun_tournament", "ivf_queries", "ivf_rows_scanned",
       "refine_queries", "refine_candidates"], 0)
# Counters a kernel adds to on the card: {(name of a COUNTS key, device): int64 [1]}.
_ON_DEVICE: dict[tuple[str, torch.device], torch.Tensor] = {}


def _is_cuda(where) -> bool:
    if isinstance(where, torch.Tensor):
        return where.is_cuda
    return isinstance(where, (str, torch.device)) and torch.device(where).type == "cuda"


def sync(where) -> None:
    """Count one host sync at a site where the host waits on `where` (a
    device, or a tensor on it): counted for CUDA only."""
    if _is_cuda(where):
        COUNTS["host_syncs"] += 1


def copy(src, dst) -> None:
    """Count the host sync of a blocking copy from `src` to `dst` (each a
    device, a tensor or a host array): one where exactly one side is on a
    CUDA device."""
    if _is_cuda(src) != _is_cuda(dst):
        COUNTS["host_syncs"] += 1


def device_counter(name: str, device) -> torch.Tensor:
    """The int64 [1] tensor on `device` where a kernel adds to the counter
    `name` (a key of `COUNTS`): made once, zeroed by `zero`, added to
    `name` by `read`."""
    key = (name, torch.device(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.zeros(1, dtype=torch.int64, device=key[1])
    return _ON_DEVICE[key]


def zero() -> None:
    """Every counter to 0."""
    for key in COUNTS:
        COUNTS[key] = 0
    for t in _ON_DEVICE.values():
        t.zero_()


def read() -> dict:
    """{counter: count}: every key of `COUNTS` with the device counters
    added, but K7's per-variant counts gathered under "dissect" and summed as
    "icm_sweeps_dissect", and K2's launches as "scan_topk" (k2_filter, once
    a chunk of queries on the staged path, plus the dense launches)."""
    out = {key: n for key, n in COUNTS.items() if not key.startswith("dissect.")}
    out["dissect"] = {v: COUNTS[f"dissect.{v}"] for v in DISSECT_VARIANTS}
    out["icm_sweeps_dissect"] = sum(out["dissect"].values())
    out["scan_topk"] = out["k2_filter"] + out["scan_topk_dense"]
    for (name, _), t in _ON_DEVICE.items():
        out[name] += int(t.item())
    return out
