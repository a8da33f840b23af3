"""Batched iterated-local-search (ILS) + ICM encoder (port of `ops/icm.py`).

Every step is a whole-batch tensor op, as in the JAX package:

- perturbation: `npert` distinct codebooks per vector re-randomized;
- ICM conditioning: `unaries[:, j] + sum_{k!=j} binaries[k, j][B[:, k], :]`
  as [n, h] row gathers, then an argmin over h (lowest index on ties);
- accept-if-better: exact per-vector `torch.where` on the fp32 cost, the
  invariant that makes the encoding objective non-increasing.

`condition_mode="kernel"` (what "auto" picks on every device) runs the whole
encode through K1 (`icm_kernels.ils_encode_streamed`): the CUDA kernel for
CUDA tensors, its plain PyTorch version for CPU tensors. `"gather"` is the
round-by-round tensor path. Randomness comes from an explicit
`torch.Generator`; its draws are made on the generator's device and moved to
the data's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from local_search_quantization_torch.ops.luts import get_binaries, get_unaries


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
    the order unary, then k = 0..m-1 with k != j (the K1 kernel's order).
    """
    acc = unaries_j
    for k in range(B.shape[1]):
        if k != j:
            acc = acc + binaries_to_j[k][B[:, k].long()]
    return acc


def cost_from_luts(xsq: torch.Tensor, unaries: torch.Tensor,
                   binaries: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """||x||^2 + sum_i unaries[n, i, B_i] + sum_{i<j} binaries[i, j, B_i, B_j].

    The unaries are summed in i order, that sum is added to xsq, and then
    the pairs in (i<j) row-major order, as the K1 kernel does.
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


def resolve_condition_mode(mode: str) -> str:
    """"auto" -> "kernel" on every device; "kernel" and "gather" pass through.

    The JAX package's "matmul" and "fused" modes are TPU matrix-unit routes
    and are not ported.
    """
    if mode == "auto":
        return "kernel"
    if mode not in ("kernel", "gather"):
        raise ValueError(f"condition_mode must be auto/kernel/gather, got {mode!r}")
    return mode


def icm_sweeps(B: torch.Tensor, unaries: torch.Tensor, binaries: torch.Tensor,
               order, icmiter: int) -> torch.Tensor:
    """`icmiter` full ICM sweeps over the codebooks in `order` (gather path).

    B [n, m]; unaries [n, m, h]; binaries [m, m, h, h]; order [m] visit
    permutation shared by all rows. Returns new codes with B's dtype.
    """
    B = B.clone()
    order = [int(j) for j in order]
    for _ in range(icmiter):
        for j in order:
            scores = _condition(unaries[:, j, :], binaries[:, j], B, j)
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
    condition_mode = resolve_condition_mode(condition_mode)
    dev = X.device
    m, h = C.shape[0], C.shape[1]
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

    B, cost = B0, cost0
    ms_B, ms_cost = [None] * len(milestones), [None] * len(milestones)
    fbs, fcs = [], []
    for r in range(ilsiter):
        order = (_randperm(gen, m, dev).tolist() if randord else list(range(m)))
        Bp = perturb_codes(gen, B, npert, h)
        Bp = icm_sweeps(Bp, unaries, binaries, order, icmiter)
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
    mode = resolve_condition_mode(condition_mode)
    outB, outcost = [], []
    out_msB = [[] for _ in milestones]
    out_msc = [[] for _ in milestones]
    fb_acc = fc_acc = None
    total = 0
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        xs = torch.as_tensor(X[start:stop]).to(dev, torch.float32)
        bs = torch.as_tensor(B0[start:stop]).to(dev, torch.int32)
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
