"""The kernel wrappers' launch counters, read and reset together.

Each wrapper adds one to its counter where it launches its kernel (on a
CUDA tensor) and nowhere else, so on the CPU every count stays 0. The
server reports these at its end; a GPU run reads them around the work it
drives.
"""

from __future__ import annotations

from local_search_quantization_torch.ops import icm_kernels, select_kernels

_SELECT = ("scan_select", "scan_key", "k2_filter", "k2_select")


def zero() -> None:
    """Every counter to 0."""
    icm_kernels.ils_encode_streamed.launches = 0
    icm_kernels.fused_icm_sweeps.launches.update(v2=0, v1=0)
    for v in icm_kernels.DISSECT_VARIANTS:
        icm_kernels.icm_sweeps_dissect.launches[v] = 0
    for name in _SELECT:
        getattr(select_kernels, name).launches = 0
    select_kernels.scan_topk.dense_launches = select_kernels.scan_topk.failed = 0


def read() -> dict:
    """{counter: launches}, one key a kernel (K7 also per variant under
    "dissect"), with K2's stages and dense path beside their sum."""
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
    return out
