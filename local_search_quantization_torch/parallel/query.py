"""Sharded ADC query: each shard's top-k, merged (port of `parallel/query.py`).

Base codes are sharded on the data axis and the per-query LUTs replicated;
each shard scans its rows with the single-device scan (`adc.scan_topk_routed`:
the K2/K3/K4 kernel route on a CUDA shard) and keeps an exact top-k, and one
stable sort over the shards' candidates on the mesh's first device gives the
global result. JAX's all-gather + re-top-k becomes that copy and sort.
"""

from __future__ import annotations

import numpy as np
import torch

from local_search_quantization_torch.ops.adc import (
    KNNResult,
    lsq_query_luts,
    pq_query_luts,
    prepare_device_codes,
    scan_topk_routed,
)
from local_search_quantization_torch.ops.select_kernels import lex_topk
from local_search_quantization_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    _shards,
    replicated,
    shard_cols,
)

_METHODS = {"auto": "auto", "scan": "exact", "kernel": "kernel"}


def _check_precision(precision: str) -> None:
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")


def _queries(Q, R, device) -> torch.Tensor:
    """Q [nq, d] as f32 on `device`, rotated by R when given."""
    Q = torch.as_tensor(Q if isinstance(Q, torch.Tensor)
                        else np.asarray(Q, np.float32)).to(device, torch.float32)
    return Q if R is None else Q @ torch.as_tensor(R).to(device)


def sharded_scan_topk(mesh: Mesh, luts: torch.Tensor, Bt, extra, k: int, *,
                      block: int = 1 << 15, axis: str = DATA_AXIS, method: str = "auto",
                      precision: str = "f32") -> KNNResult:
    """Scan a sharded code database; the global (dist, id)-lexicographic
    top-k per query, on the mesh's first device.

    luts [nq, m, h]; Bt: per-shard [m, shard_n] codes of equal width
    (`shard_cols` of the [m, n] layout, or `prepare_sharded_codes`), shard s
    owning global ids s*shard_n onwards; extra: per-shard [shard_n] blocks or
    None. Pad rows carry +inf extra, as in `adc.prepare_device_codes`.

    method: "scan" = the streaming exact merge per shard (K2's plain
    version); "kernel" = the select kernels per shard (K2, K3 or K4 by
    `select_variant(k)` and `LSQ_TPU_SELECT_VARIANT`; their plain versions
    on a CPU mesh); "auto" = what the single-device scan picks for a shard,
    `adc.cuda_route(min(k, shard_n), shard_n, m, h)` on a CUDA mesh and
    "scan" on the CPU. Each shard runs `adc.scan_topk_routed`, whose warm
    start, certificate and deep-k widen rerun that shard's tied queries, so
    each shard's list is its exact lex top-min(k, shard_n), and `lex_topk`
    merges the shards' lists with no second certificate across shards,
    padding with (+inf, -1) where they hold fewer than k; a -1 id is never
    offset into another shard's range.

    precision="bf16" rounds the LUTs once to bf16 here, so every route and
    rerun scans the same rounded tables.

    JAX's signature also takes `deferred` and `_force_variant`, which served
    its TPU pipeline (a chunked loop that reran tied queries after one bulk
    fetch, on a forced grouped kernel). Here each shard reruns its own tied
    queries on the grouped kernel, so neither has a job and both are left out.
    """
    _check_precision(precision)
    if method not in _METHODS:
        raise ValueError(f"method must be one of {sorted(_METHODS)}, got {method!r}")
    nshards = _shards(mesh, axis)
    if len(Bt) != nshards or (extra is not None and len(extra) != nshards):
        raise ValueError(f"sharded_scan_topk: codes and extra need {nshards} shards")
    shard_n = Bt[0].shape[1]
    if any(b.shape[1] != shard_n for b in Bt):
        raise ValueError("sharded_scan_topk: shards of unequal width")
    if precision == "bf16":
        luts = luts.to(torch.bfloat16).float()
    home = mesh.devices[0]
    kk = min(k, shard_n)
    dists, ids = [], []
    for s, lut in enumerate(replicated(mesh, luts.contiguous())):
        res = scan_topk_routed(lut, Bt[s],
                               None if extra is None else extra[s], kk,
                               topk_method=_METHODS[method],
                               base_block=min(block, shard_n), precision=precision)
        i = res.ids.to(home)
        # A -1 (+inf) slot must stay -1: offset, it would forge an id in
        # another shard's range.
        ids.append(torch.where(i >= 0, i + s * shard_n, -1).to(torch.int32))
        dists.append(res.dists.to(home))
    return KNNResult(*lex_topk(torch.cat(dists, dim=1), torch.cat(ids, dim=1), k))


def prepare_sharded_codes(mesh: Mesh, B, extra=None, *, block: int = 1 << 15,
                          axis: str = DATA_AXIS, h: int | None = None):
    """Pad and shard the code store ONCE for repeated mesh scans.

    Returns the `device_state` of the sharded_linscan_* scanners: per-shard
    contiguous [m, shard_n] codes (uint8 when h <= 256, h defaulting to the
    codes' range, as `adc.prepare_device_codes`) and per-shard extra blocks,
    n padded to a multiple of (shards * block) with zero codes and +inf
    extra. Build it with the mesh, block and axis of the scan calls.

    Staleness: the scanners check only the padded SIZE of a state, so a
    mutation that keeps it (a tombstone in the extra term) serves stale
    results; a direct caller rebuilds after every mutation. `Index.search`
    does, through its mutation counter.
    """
    nshards = _shards(mesh, axis)
    B = torch.as_tensor(B)
    n = B.shape[0]
    Bt, ex = prepare_device_codes(B, extra, base_block=nshards * block, device="cpu",
                                  h=h)
    if ex is None:
        ex = torch.zeros(n, dtype=torch.float32)
    return shard_cols(mesh, Bt, axis), shard_cols(mesh, ex, axis)


def _sharded_linscan(mesh: Mesh, B, Q, C, luts_fn, extra, k: int, *, query_chunk: int,
                     block: int, method: str, axis: str, precision: str = "f32",
                     device_state=None, h: int | None = None) -> KNNResult:
    """The mesh scanners' shared body: pad and shard the codes (or take
    `device_state`), then per chunk of queries build the LUTs on the mesh's
    first device and scan (`sharded_scan_topk`, where precision="bf16"
    rounds them). Results on the mesh's first device."""
    _check_precision(precision)
    nshards = _shards(mesh, axis)
    home = mesh.devices[0]
    n = B.shape[0]
    k = min(k, n)  # padded rows must never be reported as neighbors
    Q = _queries(Q, None, home)
    if Q.shape[0] == 0:
        return KNNResult(torch.empty((0, k), dtype=torch.float32, device=home),
                         torch.empty((0, k), dtype=torch.int32, device=home))
    if device_state is not None:
        exp = n + (-n) % (nshards * block)
        got = sum(b.shape[1] for b in device_state[0])
        if len(device_state[0]) != nshards or got != exp:
            raise ValueError(
                f"sharded device_state was prepared for a different base/mesh/block "
                f"(codes dim {got} in {len(device_state[0])} shards, expected {exp} in "
                f"{nshards}): rebuild with prepare_sharded_codes after any mutation")
        Bs, es = device_state
    else:
        Bs, es = prepare_sharded_codes(mesh, B, extra, block=block, axis=axis, h=h)
    C = torch.as_tensor(C).to(home)
    out_d, out_i = [], []
    for start in range(0, Q.shape[0], query_chunk):
        res = sharded_scan_topk(mesh, luts_fn(Q[start:start + query_chunk], C), Bs, es,
                                k, block=block, method=method, axis=axis,
                                precision=precision)
        out_d.append(res.dists)
        out_i.append(res.ids)
    return KNNResult(torch.cat(out_d), torch.cat(out_i))


def sharded_linscan_pq(mesh: Mesh, B, Q, C_sub, k: int, *, R=None, extra=None,
                       query_chunk: int = 1024, block: int = 1 << 15,
                       method: str = "auto", axis: str = DATA_AXIS,
                       precision: str = "f32", device_state=None) -> KNNResult:
    """Mesh PQ/OPQ scanner: shard the codes, replicate the subspace LUTs.

    Pass R to rotate the queries into code space first (OPQ). `extra`: an
    optional [n] additive term (the +inf tombstones of `Index.delete`),
    zeros by default. precision="bf16" scans LUTs rounded to bf16.
    device_state: `prepare_sharded_codes`' pre-sharded codes.
    """
    Q = _queries(Q, R, mesh.devices[0])
    return _sharded_linscan(mesh, B, Q, C_sub, pq_query_luts, extra, k,
                            query_chunk=query_chunk, block=block, method=method,
                            axis=axis, precision=precision, device_state=device_state,
                            h=C_sub.shape[1])


def sharded_linscan_lsq(mesh: Mesh, B, Q, C, db_norms, k: int, *, R=None,
                        query_chunk: int = 1024, block: int = 1 << 15,
                        method: str = "auto", axis: str = DATA_AXIS,
                        precision: str = "f32", device_state=None) -> KNNResult:
    """Mesh scanner for additive codes (LSQ/ChainQ/RVQ + quantized norms).

    Pass R to rotate the queries into code space first (ChainQ).
    precision="bf16" scans LUTs rounded to bf16. device_state:
    `prepare_sharded_codes`' pre-sharded codes.
    """
    Q = _queries(Q, R, mesh.devices[0])
    db_norms = torch.as_tensor(db_norms if isinstance(db_norms, torch.Tensor)
                               else np.asarray(db_norms, np.float32))
    return _sharded_linscan(mesh, B, Q, C, lsq_query_luts, db_norms, k,
                            query_chunk=query_chunk, block=block, method=method,
                            axis=axis, precision=precision, device_state=device_state,
                            h=C.shape[1])
