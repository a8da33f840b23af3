"""K2: the ADC scan with an exact top-k, as CUDA kernels or their plain version.

Port of `local_search_quantization_tpu.ops.select_pallas.fused_scan_topk`
(kernel `_select_kernel_grouped`). Contract of both versions here:

    dist[q, i] = sum_j luts[q, j, Bt[j, i]] + extra[i]    (j order, then extra)

and the result is the k smallest per query in (dist, id) lexicographic
order, dists ascending [nq, k] f32 and ids [nq, k] int32; +inf rows are
never returned and empty slots are (+inf, -1).

`scan_topk` takes the plain version only for tensors on the CPU; a CUDA
tensor goes to the kernels of `csrc/scan_topk.cu`, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from local_search_quantization_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
# Distance scratch per launch: at most this many f32 elements (1 GiB).
_SCRATCH_ELEMS = 1 << 28


def lut_scan_block(luts: torch.Tensor, Bt_block: torch.Tensor,
                   extra: torch.Tensor | None = None) -> torch.Tensor:
    """[nq, m, h] LUTs x [m, nb] codes -> [nq, nb] distances, summed in j order."""
    Bl = Bt_block.long()
    acc = luts[:, 0, :][:, Bl[0]]
    for j in range(1, luts.shape[1]):
        acc = acc + luts[:, j, :][:, Bl[j]]
    if extra is not None:
        acc = acc + extra[None, :]
    return acc


def scan_topk_reference(luts: torch.Tensor, Bt: torch.Tensor,
                        extra: torch.Tensor | None, k: int, *,
                        block: int = 1 << 16):
    """Plain version of K2: a streaming merge over id-ascending base blocks.

    Each block's distances are appended to the running top-k and a STABLE
    sort keeps the first k, so equal distances stay in ascending id order:
    the result is exactly (dist, id)-lexicographic.
    """
    nq = luts.shape[0]
    n = Bt.shape[1]
    k = min(k, n)
    dev = luts.device
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = None if extra is None else extra[s:s + block]
        tile = lut_scan_block(luts, Bt[:, s:s + block], e)
        ids = torch.arange(s, s + tile.shape[1], device=dev)
        cand_d = torch.cat([best_d, tile], dim=1)
        cand_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=1)
        best_d, pos = torch.sort(cand_d, dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = torch.gather(cand_i, 1, pos[:, :k])
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i.to(torch.int32)


def _sort_lex(d: torch.Tensor, i: torch.Tensor):
    """Sort [nq, k] candidates by (dist, id): by id, then stably by dist."""
    i, pos = torch.sort(i, dim=1)
    d = torch.gather(d, 1, pos)
    d, pos = torch.sort(d, dim=1, stable=True)
    return d, torch.gather(i, 1, pos)


def scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
              k: int):
    """K2: exact lexicographic top-k ADC scan of all queries.

    luts [nq, m, h] f32; Bt [m, n] uint8 or int32 codes (each < h); extra
    [n] f32 or None. Returns (dists [nq, k] f32, ids [nq, k] int32) with
    k = min(k, n). Launches once per block of queries whose [block, n]
    distance scratch fits 1 GiB; counts launches in `scan_topk.launches`.
    """
    dev = luts.device
    if dev.type == "cpu":
        return scan_topk_reference(luts, Bt, extra, k)
    if dev.type != "cuda":
        raise ValueError(f"scan_topk: unsupported device {dev}")
    nq, m, h = luts.shape
    n = Bt.shape[1]
    k = min(k, n)
    if extra is None:
        extra = torch.zeros((n,), dtype=torch.float32, device=dev)
    code_bytes = {torch.uint8: 1, torch.int32: 4}.get(Bt.dtype)
    checks = [
        (luts, luts.dtype == torch.float32, "luts must be f32 [nq, m, h]"),
        (Bt, code_bytes is not None and Bt.shape[0] == m,
         "Bt must be uint8 or int32 [m, n]"),
        (extra, extra.dtype == torch.float32 and tuple(extra.shape) == (n,),
         "extra must be f32 [n]"),
    ]
    for t, ok, msg in checks:
        if not ok or t.device != dev or not t.is_contiguous():
            raise ValueError(f"scan_topk: {msg}, contiguous, on {dev}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n >= 1 << 31:
        raise ValueError("scan_topk: n must be < 2^31")
    lib = _build.load("scan_topk")
    lib.lsq_scan_smem_bytes.argtypes = [_I, _I]
    if lib.lsq_scan_smem_bytes(m, h) > 227 * 1024:
        raise ValueError(f"scan_topk: m*h={m * h} LUTs exceed one block's "
                         "shared memory")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return out_d, out_i
    qb = max(1, min(nq, _SCRATCH_ELEMS // n))
    dist = torch.empty((qb, n), dtype=torch.float32, device=dev)
    lib.lsq_scan_topk.argtypes = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.lsq_scan_topk.restype = _I
    stream = torch.cuda.current_stream(dev).cuda_stream
    for q0 in range(0, nq, qb):
        q1 = min(nq, q0 + qb)
        lq = luts[q0:q1]
        err = lib.lsq_scan_topk(
            lq.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(), q1 - q0,
            m, h, n, k, dist.data_ptr(), out_d[q0:q1].data_ptr(),
            out_i[q0:q1].data_ptr(), stream)
        _build.check(lib, err, "scan_topk kernel launch")
        scan_topk.launches += 1
    return _sort_lex(out_d, out_i)


scan_topk.launches = 0
