"""K1: the whole-ILS encode, as one CUDA launch or its plain PyTorch version.

Port of `local_search_quantization_tpu.ops.icm_pallas.fused_ils_encode`
(kernel `_ils_kernel_pp`). The randomness comes in as tensors, as the TPU
wrapper streams it (icm_pallas.py:718-726), so the CUDA kernel
(`csrc/ils_encode.cu`) and `ils_encode_streamed_reference` compute the same
function on the same inputs and can be compared bit for bit.

`ils_encode_streamed` takes the plain version only for tensors on the CPU; a
CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from local_search_quantization_torch import _build
from local_search_quantization_torch.ops.icm import _condition, cost_from_luts

_P = ctypes.c_void_p
_I = ctypes.c_int


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def ils_encode_streamed_reference(unaries, binaries, xsq, B0, orders,
                                  pert_keys, pert_codes, *, icmiter: int,
                                  milestones=(), with_stats: bool = False):
    """Plain PyTorch version of the K1 kernel, in the kernel's summation order.

    Args:
      unaries [n, m, h] f32, binaries [m, m, h, h] f32, xsq [n] f32,
      B0 [n, m] int, orders [rounds, m] int (visit order per round),
      pert_keys [rounds, n, m] f32, pert_codes [rounds, n, npert] int.
      milestones: 1-based rounds after which to snapshot the best codes.

    Returns (B [n, m] int32, cost [n] f32, ms_B [n_ms, n, m] int32 | None,
    ms_cost [n_ms, n] f32 | None, stats [rounds, 2] f32 | None), where
    stats counts the rows whose proposal was better / equal each round.
    """
    n, m, h = unaries.shape
    rounds, npert = orders.shape[0], pert_codes.shape[2]
    rows = torch.arange(n, device=unaries.device)
    best = B0.long().clone()
    best_cost = cost_from_luts(xsq, unaries, binaries, best)
    ms_at = {r - 1: s for s, r in enumerate(milestones)}
    ms_B = [None] * len(milestones)
    ms_cost = [None] * len(milestones)
    stats = torch.zeros((rounds, 2), dtype=torch.float32)
    for r in range(rounds):
        cur = best.clone()
        keys = pert_keys[r].clone()
        for p in range(npert):
            pos = torch.argmin(keys, dim=1)
            keys[rows, pos] = 1e30
            cur[rows, pos] = pert_codes[r, :, p].long()
        for _ in range(icmiter):
            for j in orders[r].tolist():
                scores = _condition(unaries[:, j], binaries[:, j], cur, j)
                cur[:, j] = torch.argmin(scores, dim=1)
        newcost = cost_from_luts(xsq, unaries, binaries, cur)
        better = newcost < best_cost
        stats[r, 0] = better.sum().item()
        stats[r, 1] = (newcost == best_cost).sum().item()
        best = torch.where(better[:, None], cur, best)
        best_cost = torch.where(better, newcost, best_cost)
        if r in ms_at:
            ms_B[ms_at[r]] = best.int()
            ms_cost[ms_at[r]] = best_cost
    msb = torch.stack(ms_B) if milestones else None
    msc = torch.stack(ms_cost) if milestones else None
    return (best.int(), best_cost, msb, msc,
            stats.to(unaries.device) if with_stats else None)


def ils_encode_streamed(unaries, binaries, xsq, B0, orders, pert_keys,
                        pert_codes, *, icmiter: int, milestones=(),
                        with_stats: bool = False):
    """K1: the whole ILS encode, one kernel launch for a CUDA tensor.

    Same arguments and results as `ils_encode_streamed_reference`, which
    CPU tensors get. Counts its launches in `ils_encode_streamed.launches`.
    """
    dev = unaries.device
    if dev.type == "cpu":
        return ils_encode_streamed_reference(
            unaries, binaries, xsq, B0, orders, pert_keys, pert_codes,
            icmiter=icmiter, milestones=milestones, with_stats=with_stats)
    if dev.type != "cuda":
        raise ValueError(f"ils_encode_streamed: unsupported device {dev}")
    n, m, h = unaries.shape
    rounds, npert = orders.shape[0], pert_codes.shape[2]
    want = {
        "unaries": (unaries, torch.float32, (n, m, h)),
        "binaries": (binaries, torch.float32, (m, m, h, h)),
        "xsq": (xsq, torch.float32, (n,)),
        "B0": (B0, torch.int32, (n, m)),
        "orders": (orders, torch.int32, (rounds, m)),
        "pert_keys": (pert_keys, torch.float32, (rounds, n, m)),
        "pert_codes": (pert_codes, torch.int32, (rounds, n, npert)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"ils_encode_streamed: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if not 1 <= m <= 32 or not 0 <= npert <= m:
        raise ValueError(f"ils_encode_streamed: needs 1 <= m <= 32 and "
                         f"0 <= npert <= m, got m={m}, npert={npert}")
    lib = _build.load("ils_encode")
    lib.lsq_ils_smem_bytes.argtypes = [_I, _I]
    if lib.lsq_ils_smem_bytes(m, h) > 227 * 1024 or h > lib.lsq_ils_max_h():
        raise ValueError(f"ils_encode_streamed: m={m}, h={h} needs more "
                         "shared memory or registers than the kernel has")
    milestones = tuple(milestones)
    n_ms = len(milestones)
    out_b = torch.empty((n, m), dtype=torch.int32, device=dev)
    out_cost = torch.empty((n,), dtype=torch.float32, device=dev)
    ms_b = torch.empty((n_ms, n, m), dtype=torch.int32, device=dev)
    ms_cost = torch.empty((n_ms, n), dtype=torch.float32, device=dev)
    stats = (torch.zeros((rounds, 2), dtype=torch.int32, device=dev)
             if with_stats else None)
    ms_rounds = torch.tensor([r - 1 for r in milestones], dtype=torch.int32,
                             device=dev)
    if n == 0:
        return (out_b, out_cost, ms_b if n_ms else None,
                ms_cost if n_ms else None,
                stats.float() if with_stats else None)
    lib.lsq_ils_encode.argtypes = [_P] * 8 + [_I] * 7 + [_P] * 6
    lib.lsq_ils_encode.restype = _I
    err = lib.lsq_ils_encode(
        _ptr(unaries), _ptr(binaries), _ptr(xsq), _ptr(B0), _ptr(orders),
        _ptr(pert_keys), _ptr(pert_codes), _ptr(ms_rounds),
        n, m, h, rounds, icmiter, npert, n_ms,
        _ptr(out_b), _ptr(out_cost), _ptr(ms_b), _ptr(ms_cost), _ptr(stats),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ils_encode kernel launch")
    ils_encode_streamed.launches += 1
    return (out_b, out_cost, ms_b if n_ms else None, ms_cost if n_ms else None,
            stats.float() if with_stats else None)


ils_encode_streamed.launches = 0
