"""The port's counters, read and reset together: kernel launches, certificate
reruns, host syncs and entry-point calls.

Each kernel wrapper adds one to its counter where it launches its kernel (on
a CUDA tensor) and nowhere else, so on the CPU every launch count stays 0.
The other counters live here (`COUNTS`; host syncs through `sync` and
`copy`):

- `host_syncs`: the sites on the `Index.add` and `Index.search` paths where
  the host waits on the card (a `torch.nonzero`, a blocking copy between
  host and card), counted only for CUDA tensors, like the launches;
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

The server reports these at its end; a GPU run reads them around the work it
drives. This module imports the kernel modules only inside `zero` and `read`,
so they can import it.
"""

from __future__ import annotations

import torch

_SELECT = ("scan_select", "scan_key", "k2_filter", "k2_select")

COUNTS = {"host_syncs": 0, "search_calls": 0, "add_calls": 0, "rerun_warm": 0,
          "rerun_widen": 0, "rerun_tournament": 0, "ivf_queries": 0, "ivf_rows_scanned": 0}
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
    from local_search_quantization_torch import ivf
    from local_search_quantization_torch.ops import icm_kernels, select_kernels

    icm_kernels.ils_encode_streamed.launches = 0
    icm_kernels.fused_icm_sweeps.launches.update(v2=0, v1=0)
    for v in icm_kernels.DISSECT_VARIANTS:
        icm_kernels.icm_sweeps_dissect.launches[v] = 0
    for name in _SELECT:
        getattr(select_kernels, name).launches = 0
    select_kernels.scan_topk.dense_launches = select_kernels.scan_topk.failed = 0
    ivf.ivf_scan.launches = ivf.ivf_scan.merge_launches = 0
    for key in COUNTS:
        COUNTS[key] = 0
    for t in _ON_DEVICE.values():
        t.zero_()


def read() -> dict:
    """{counter: count}: one key a kernel (K7 also per variant under
    "dissect"), with K2's stages and dense path beside their sum, the
    probed scan's and its merge's, then the keys of `COUNTS` with the
    device counters added."""
    from local_search_quantization_torch import ivf
    from local_search_quantization_torch.ops import icm_kernels, select_kernels

    out = {"ils_encode": icm_kernels.ils_encode_streamed.launches,
           "icm_sweeps_v2": icm_kernels.fused_icm_sweeps.launches["v2"],
           "icm_sweeps_v1": icm_kernels.fused_icm_sweeps.launches["v1"],
           "dissect": dict(icm_kernels.icm_sweeps_dissect.launches)}
    # K7 counts its launches per variant; its kernels line counts them all.
    out["icm_sweeps_dissect"] = sum(out["dissect"].values())
    for name in _SELECT:
        out[name] = getattr(select_kernels, name).launches
    # K2's dense path, and the queries rerun there after a failed certificate.
    out["scan_topk_dense"] = select_kernels.scan_topk.dense_launches
    out["scan_topk_failed"] = select_kernels.scan_topk.failed
    # K2 launches its filter (and then its select) once a chunk of queries on
    # the staged path, its dense kernels once a launch on the dense path.
    out["scan_topk"] = out["k2_filter"] + out["scan_topk_dense"]
    # The probed scan launches its merge too where a query has several slices.
    out["ivf_scan"] = ivf.ivf_scan.launches
    out["ivf_merge"] = ivf.ivf_scan.merge_launches
    out.update(COUNTS)
    for (name, _), t in _ON_DEVICE.items():
        out[name] += int(t.item())
    return out
