"""Batched iterated-local-search (ILS) + ICM encoder (port of `ops/icm.py`).

Every step is a whole-batch tensor op, as in the JAX package:

- perturbation: `npert` distinct codebooks per vector re-randomized;
- ICM conditioning: `unaries[:, j] + sum_{k!=j} binaries[k, j][B[:, k], :]`
  as [n, h] row gathers, then an argmin over h (lowest index on ties);
- accept-if-better: exact per-vector `torch.where` on the fp32 cost, the
  invariant that makes the encoding objective non-increasing.

Condition modes:

- `"kernel"` (what "auto" picks for data on a CUDA device) runs the whole
  encode through K1 (`icm_kernels.ils_encode_streamed`): the CUDA kernel for
  CUDA tensors, its plain PyTorch version for CPU tensors. A shape K1
  cannot hold (`icm_kernels.ils_kernel_fits`) takes the "matmul" path
  instead.
- `"fused"` runs the ILS rounds here, each round's ICM sweeps through K5
  (`icm_kernels.fused_icm_sweeps`) against bf16 pairwise tables.
- `"gather"` (what "auto" picks elsewhere, as the JAX package picks it off
  the accelerator) and `"matmul"` are the round-by-round tensor paths: f32
  row gathers, or one masked one-hot product per visit against the tables
  rounded to bf16.

Randomness comes from an explicit `torch.Generator`; its draws are made on
the generator's device and moved to the data's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops.luts import get_binaries, get_unaries
from local_search_quantization_torch.utils.profiling import span


class ILSResult(NamedTuple):
    B: torch.Tensor  # [n, m] int32 codes
    cost: torch.Tensor  # [n] float32 per-vector squared error


class ILSTrace(NamedTuple):
    """ILS result plus the milestone snapshots and per-round accept stats."""

    B: torch.Tensor
    cost: torch.Tensor
    milestone_B: torch.Tensor | None  # [n_ms, n, m] codes after milestones[i] rounds
    milestone_cost: torch.Tensor | None  # [n_ms, n]
    frac_better: torch.Tensor | None  # [ilsiter] fraction of vectors improved per round
    frac_equal: torch.Tensor | None  # [ilsiter] fraction whose proposal cost was equal


def _rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def _randint(gen: torch.Generator, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, device=gen.device,
                         dtype=torch.int32).to(device)


def _randperm(gen: torch.Generator, m: int, device) -> torch.Tensor:
    return torch.randperm(m, generator=gen, device=gen.device,
                          dtype=torch.int32).to(device)


def perturb_codes(gen: torch.Generator, B: torch.Tensor, npert: int,
                  h: int) -> torch.Tensor:
    """Re-randomize `npert` distinct codebook entries of each row of B.

    The positions are the npert largest of m iid uniforms per row, as in the
    JAX gather path (icm.py:59-77).
    """
    n, m = B.shape
    if npert <= 0:
        return B
    u = _rand(gen, (n, m), B.device)
    kth = torch.topk(u, npert, dim=1).values[:, -1:]
    vals = _randint(gen, h, (n, m), B.device).to(B.dtype)
    return torch.where(u >= kth, vals, B)


def _condition(unaries_j: torch.Tensor, binaries_to_j: torch.Tensor,
               B: torch.Tensor, j: int) -> torch.Tensor:
    """Absorb all pairwise terms into the unary of codebook j: [n, h] scores.

    unaries_j [n, h]; binaries_to_j [m, h, h] = binaries[:, j]. Summed in
    the order unary, then k = 0..m-1 with k != j (K6's order).
    """
    acc = unaries_j
    for k in range(B.shape[1]):
        if k != j:
            acc = acc + binaries_to_j[k][B[:, k].long()]
    return acc


def _condition_matmul(unaries_j: torch.Tensor, binaries_to_j: torch.Tensor,
                      B: torch.Tensor, j: int) -> torch.Tensor:
    """The conditioning as one masked one-hot product (icm.py:107-131).

    onehot(B) [n, m*h] with codebook j's block zeroed, times binaries_to_j
    rounded to bf16 and widened back, as an f32 product: [n, h], plus the
    unary. The tables are rounded as the JAX package rounds them; the
    product stays f32, as its preferred_element_type=f32 asks.
    """
    n, m = B.shape
    h = unaries_j.shape[1]
    onehot = torch.zeros((n, m, h), dtype=torch.float32, device=B.device)
    onehot.scatter_(2, B.long()[:, :, None], 1.0)
    onehot[:, j] = 0.0
    lut = binaries_to_j.to(torch.bfloat16).to(torch.float32).reshape(m * h, h)
    return unaries_j + onehot.reshape(n, m * h) @ lut


_CONDITION_FNS = {"gather": _condition, "matmul": _condition_matmul}
_MODES = ("kernel", "fused", "gather", "matmul")


def cost_from_luts(xsq: torch.Tensor, unaries: torch.Tensor,
                   binaries: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """||x||^2 + sum_i unaries[n, i, B_i] + sum_{i<j} binaries[i, j, B_i, B_j].

    The unaries are summed in i order, that sum is added to xsq, and then
    the pairs in (i<j) row-major order.
    """
    n, m = B.shape
    Bl = B.long()
    u = torch.gather(unaries, 2, Bl[:, :, None])[:, :, 0]  # [n, m]
    s = u[:, 0]
    for i in range(1, m):
        s = s + u[:, i]
    total = xsq + s
    for i in range(m):
        for j in range(i + 1, m):
            total = total + binaries[i, j][Bl[:, i], Bl[:, j]]
    return total


def resolve_condition_mode(mode: str, device) -> str:
    """"auto" -> "kernel" for data on a CUDA device, "gather" elsewhere, as
    the JAX package resolves it by platform (icm.py:170-173); "kernel",
    "fused", "gather" and "matmul" pass through. device: where the encode
    runs (a torch.device or its name)."""
    if mode == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "gather"
    if mode not in _MODES:
        raise ValueError(f"condition_mode must be auto or one of {_MODES}, "
                         f"got {mode!r}")
    return mode


def encode_route(mode: str, m: int, h: int, device) -> str:
    """The condition mode `ils_encode` runs for `mode` at shape (m, h) on
    `device`: "kernel" becomes "matmul" where K1 cannot hold the shape
    (icm.py:345-351)."""
    from local_search_quantization_torch.ops.icm_kernels import ils_kernel_fits

    mode = resolve_condition_mode(mode, device)
    if mode == "kernel" and not ils_kernel_fits(m, h):
        return "matmul"
    return mode


def icm_sweeps(B: torch.Tensor, unaries: torch.Tensor, binaries: torch.Tensor,
               order, icmiter: int, *, condition_mode: str = "gather") -> torch.Tensor:
    """`icmiter` full ICM sweeps over the codebooks in `order`.

    B [n, m]; unaries [n, m, h]; binaries [m, m, h, h]; order [m] visit
    permutation shared by all rows; condition_mode "gather" or "matmul".
    Returns new codes with B's dtype.
    """
    cond_fn = _CONDITION_FNS[condition_mode]
    B = B.clone()
    order = [int(j) for j in order]
    for _ in range(icmiter):
        for j in order:
            scores = cond_fn(unaries[:, j, :], binaries[:, j], B, j)
            B[:, j] = torch.argmin(scores, dim=-1).to(B.dtype)
    return B


def ils_encode(gen: torch.Generator, X: torch.Tensor, B0: torch.Tensor,
               C: torch.Tensor, *, ilsiter: int, icmiter: int, npert: int,
               randord: bool = True, condition_mode: str = "gather",
               milestones=None, with_stats: bool = False,
               nvalid: int | None = None) -> ILSResult | ILSTrace:
    """Encode X against codebooks C with `ilsiter` rounds of perturb + ICM.

    milestones: optional strictly increasing 1-based rounds; codes and costs
    are snapshotted after each. with_stats: per-round fractions of rows whose
    proposal was better / equal. nvalid: rows >= nvalid are dead padding
    (xsq floored to -1e30, so they never accept) and are left out of the
    stats. The final cost is elementwise <= cost(B0); milestone costs are
    <= cost(B0) and non-increasing per vector.
    """
    milestones = tuple(milestones) if milestones else ()
    if milestones and (tuple(sorted(set(milestones))) != milestones
                       or milestones[0] < 1 or milestones[-1] > ilsiter):
        raise ValueError(f"milestones must be strictly increasing rounds in "
                         f"[1, {ilsiter}], got {milestones}")
    dev = X.device
    m, h = C.shape[0], C.shape[1]
    condition_mode = encode_route(condition_mode, m, h, dev)
    launch_counts.copy(B0, dev)
    B0 = B0.to(device=dev, dtype=torch.int32).contiguous()
    unaries = get_unaries(X, C)
    binaries = get_binaries(C)
    xsq = torch.sum(X * X, dim=-1)
    n_rows = X.shape[0]
    n_dead = None
    if nvalid is not None:
        xsq = torch.where(torch.arange(n_rows, device=dev) < nvalid, xsq,
                          torch.full_like(xsq, -1e30))
        n_dead = float(n_rows - nvalid)
    cost0 = cost_from_luts(xsq, unaries, binaries, B0)

    def rescale(fb, fc):
        # Per-round counts -> fractions of the valid rows (dead rows never
        # improve and always count as equal).
        if n_dead is None:
            return fb / n_rows, fc / n_rows
        denom = max(float(nvalid), 1.0)
        return fb / denom, torch.clamp(fc - n_dead, min=0.0) / denom

    def finalize(B, ms_B, fb, fc):
        """Exact-fp32 recheck of the final codes and every milestone against
        B0, then milestones chained to the running best (icm.py:309-343)."""
        def recheck(Bc):
            c = cost_from_luts(xsq, unaries, binaries, Bc)
            ok = c < cost0
            return torch.where(ok[:, None], Bc, B0), torch.where(ok, c, cost0)

        B, cost = recheck(B)
        if not milestones and not with_stats:
            return ILSResult(B, cost)
        msB = msC = None
        if milestones:
            chained = [recheck(ms_B[0])]
            for s in range(1, len(milestones)):
                pb, pc = chained[-1]
                nb, nc = recheck(ms_B[s])
                keep = nc < pc
                chained.append((torch.where(keep[:, None], nb, pb),
                                torch.where(keep, nc, pc)))
            msB = torch.stack([p[0] for p in chained])
            msC = torch.stack([p[1] for p in chained])
            lb, lc = chained[-1]
            keep = cost < lc
            B = torch.where(keep[:, None], B, lb)
            cost = torch.where(keep, cost, lc)
        return ILSTrace(B, cost, msB, msC, fb, fc)

    if condition_mode == "kernel":
        from local_search_quantization_torch.ops.icm_kernels import (
            ils_encode_streamed,
        )

        if randord:
            orders = torch.stack([_randperm(gen, m, dev) for _ in range(ilsiter)]) \
                if ilsiter else torch.zeros((0, m), dtype=torch.int32, device=dev)
        else:
            orders = torch.arange(m, dtype=torch.int32, device=dev).repeat(ilsiter, 1)
        pert_keys = _rand(gen, (ilsiter, n_rows, m), dev)
        pert_codes = _randint(gen, h, (ilsiter, n_rows, npert), dev)
        B, _, ms_B, _, stats = ils_encode_streamed(
            unaries, binaries, xsq, B0, orders.contiguous(), pert_keys,
            pert_codes, icmiter=icmiter, milestones=milestones,
            with_stats=with_stats)
        fb = fc = None
        if with_stats:
            fb, fc = rescale(stats[:, 0], stats[:, 1])
        return finalize(B, ms_B, fb, fc)

    if condition_mode == "fused":
        from local_search_quantization_torch.ops.icm_kernels import fused_icm_sweeps

        binaries_bf16 = binaries.to(torch.bfloat16)  # once per encode (icm.py:387)
    B, cost = B0, cost0
    ms_B, ms_cost = [None] * len(milestones), [None] * len(milestones)
    fbs, fcs = [], []
    for r in range(ilsiter):
        order = (_randperm(gen, m, dev) if randord
                 else torch.arange(m, dtype=torch.int32, device=dev))
        Bp = perturb_codes(gen, B, npert, h)
        if condition_mode == "fused":
            Bp = fused_icm_sweeps(Bp, unaries, binaries_bf16, order, icmiter=icmiter)
        else:
            Bp = icm_sweeps(Bp, unaries, binaries, order.tolist(), icmiter,
                            condition_mode=condition_mode)
        newcost = cost_from_luts(xsq, unaries, binaries, Bp)
        better = newcost < cost
        fbs.append(better.sum().float())
        fcs.append((newcost == cost).sum().float())
        B = torch.where(better[:, None], Bp, B)
        cost = torch.where(better, newcost, cost)
        if r + 1 in milestones:
            s = milestones.index(r + 1)
            ms_B[s], ms_cost[s] = B, cost
    fb = fc = None
    if with_stats:
        fb, fc = rescale(torch.stack(fbs) if fbs else torch.zeros(0, device=dev),
                         torch.stack(fcs) if fcs else torch.zeros(0, device=dev))
    if not milestones and not with_stats:
        return ILSResult(B, cost)
    return ILSTrace(B, cost,
                    torch.stack(ms_B) if milestones else None,
                    torch.stack(ms_cost) if milestones else None, fb, fc)


def encode_chunked(gen: torch.Generator, X, B0, C: torch.Tensor, *,
                   ilsiter: int, icmiter: int, npert: int,
                   randord: bool = True, condition_mode: str = "auto",
                   chunk: int = 1 << 17, milestones=None,
                   with_stats: bool = False) -> ILSResult | ILSTrace:
    """ILS-encode a large base set in `chunk`-row pieces.

    The [n, m, h] unary table dominates memory (n=1M, m=7, h=256 -> 7.2 GB
    f32), so the base streams through in chunks. X and B0 may be numpy
    arrays or tensors; each chunk is moved to C's device, and the results
    are tensors there. The tail chunk is padded to `chunk` rows (repeating
    its last row) and the padding is dead (`nvalid`), so the stats stay
    exact; per-round stats are weighted by valid rows.
    """
    milestones = tuple(milestones) if milestones else ()
    dev = C.device
    n = X.shape[0]
    mode = resolve_condition_mode(condition_mode, dev)
    outB, outcost = [], []
    out_msB = [[] for _ in milestones]
    out_msc = [[] for _ in milestones]
    fb_acc = fc_acc = None
    total = 0
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        with span("encode.chunk_inputs"):
            xs, bs = torch.as_tensor(X[start:stop]), torch.as_tensor(B0[start:stop])
            launch_counts.copy(xs, dev)
            launch_counts.copy(bs, dev)
            xs, bs = xs.to(dev, torch.float32), bs.to(dev, torch.int32)
            valid = stop - start
            pad = chunk - valid if valid < chunk and start > 0 else 0
            if pad:
                xs = torch.cat([xs, xs[-1:].expand(pad, -1)])
                bs = torch.cat([bs, bs[-1:].expand(pad, -1)])
        res = ils_encode(gen, xs, bs, C, ilsiter=ilsiter, icmiter=icmiter,
                         npert=npert, randord=randord, condition_mode=mode,
                         milestones=milestones, with_stats=with_stats,
                         nvalid=valid)
        outB.append(res.B[:valid])
        outcost.append(res.cost[:valid])
        for s in range(len(milestones)):
            out_msB[s].append(res.milestone_B[s][:valid])
            out_msc[s].append(res.milestone_cost[s][:valid])
        if with_stats:
            fb, fc = res.frac_better * valid, res.frac_equal * valid
            fb_acc = fb if fb_acc is None else fb_acc + fb
            fc_acc = fc if fc_acc is None else fc_acc + fc
            total += valid
    B, cost = torch.cat(outB), torch.cat(outcost)
    if not milestones and not with_stats:
        return ILSResult(B, cost)
    msB = torch.stack([torch.cat(x) for x in out_msB]) if milestones else None
    msc = torch.stack([torch.cat(x) for x in out_msc]) if milestones else None
    return ILSTrace(B, cost, msB, msc,
                    fb_acc / total if fb_acc is not None else None,
                    fc_acc / total if fc_acc is not None else None)
