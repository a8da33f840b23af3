"""The ICM kernels, each as CUDA launches or its plain PyTorch version.

- K1 `ils_encode_streamed`: the whole-ILS encode in one launch. Port of
  `local_search_quantization_tpu.ops.icm_pallas.fused_ils_encode` (kernel
  `_ils_kernel_pp`). The randomness comes in as tensors, as the TPU wrapper
  streams it (icm_pallas.py:718-726), and the table is rounded as that
  wrapper rounds it (bf16 visits, a hi/lo cost), so the CUDA kernel
  (`csrc/ils_encode.cu`), `ils_encode_streamed_reference` and the TPU
  kernel compute the same function on the same inputs.
- K5/K6 `fused_icm_sweeps`: one ILS round's `icmiter` ICM sweeps in one
  launch, against bf16 pairwise tables. Port of `icm_pallas.fused_icm_sweeps`
  (kernels `_icm_kernel_v2`, variant "v2", and `_icm_kernel`, variant "v1");
  CUDA in `csrc/icm_sweeps.cu`, plain version `fused_icm_sweeps_reference`.
- K7 `icm_sweeps_dissect`: K5's visit with parts taken out, to time them
  apart (variants "full", "predwrite", "nowrite", "noargmin", "mmonly").
  Port of the kernel in `benchmarks/bench_kernel_variants.py`; CUDA in
  `csrc/icm_sweeps.cu` (`lsq_icm_sweeps_dissect`), plain version
  `icm_sweeps_dissect_reference`.
- `ils_visits_needed`: the row-visits of K1's encode whose inputs changed,
  the ones the kernel does; it skips the rest, whose argmin is the code the
  row already holds.

Each wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor goes to the kernel, or the call raises. Each counts its launches
under its key in `launch_counts`.
"""

from __future__ import annotations

import torch

from local_search_quantization_torch import _build
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops.icm import _condition


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None or t.numel() == 0 else t.data_ptr()


# K1's launch geometry, as csrc/ils_encode.cu sets it: 4 rows per block,
# each with its [m, h] f32 unaries in shared memory (the codes live in
# registers), at most 32 candidates per lane.
_ILS_WARPS, _SMEM_LIMIT, _ILS_MAX_H = 4, 227 * 1024, 1024


def ils_kernel_fits(m: int, h: int) -> bool:
    """Whether K1 takes the shape (m, h): decided before any launch, from
    the same sizes as the library's `lsq_ils_smem_bytes`/`lsq_ils_max_h`,
    with no build. `ils_encode(condition_mode="kernel")` takes the "matmul"
    path for a shape K1 cannot hold."""
    return 1 <= m <= 32 and h <= _ILS_MAX_H and _ILS_WARPS * m * h * 4 <= _SMEM_LIMIT


def split_hi_lo(binaries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (bf16 hi, bf16 lo): hi = bf16(x), lo = bf16(x - f32(hi)), the
    split of the TPU kernel's table (`select_pallas._split_hi_lo`). Rounds
    to nearest even, as JAX's cast does."""
    hi = binaries.to(torch.bfloat16)
    return hi, (binaries - hi.float()).to(torch.bfloat16)


def mrf_cost_hi_lo(xsq, unaries, hi, lo, B) -> torch.Tensor:
    """K1's in-flight MRF cost, the TPU kernel's `_mrf_cost`
    (icm_pallas.py:133-166), on the hi/lo split of the table (widened to
    f32, [m, m, h, h] each):

        (xsq + sum_i u_i) + sum_{j=0}^{m-2} [(sum_{k>j} hi[k, j][B_k, B_j])
                                            + (sum_{k>j} lo[k, j][B_k, B_j])]

    The unaries are summed in i order, each inner sum in k order from its
    first term, and the bracketed terms in j order from 0.
    """
    n, m = B.shape
    Bl = B.long()
    u = torch.gather(unaries, 2, Bl[:, :, None])[:, :, 0]
    s = u[:, 0]
    for i in range(1, m):
        s = s + u[:, i]
    pair = torch.zeros_like(xsq)
    for j in range(m - 1):
        sh = hi[j + 1, j][Bl[:, j + 1], Bl[:, j]]
        sl = lo[j + 1, j][Bl[:, j + 1], Bl[:, j]]
        for k in range(j + 2, m):
            sh = sh + hi[k, j][Bl[:, k], Bl[:, j]]
            sl = sl + lo[k, j][Bl[:, k], Bl[:, j]]
        pair = pair + (sh + sl)
    return (xsq + s) + pair


def _ils_loop(unaries, xsq, B0, orders, pert_keys, pert_codes, icmiter, scores, cost,
              milestones=(), need_out=None):
    """The loop K1 runs, in plain PyTorch: per round, perturb, visit
    (`scores(cur, j)` -> [n, h], argmin with the lowest index on ties),
    then accept where `cost(codes)` is strictly lower. Where `need_out`
    ([rounds, icmiter * m, n] bool) is given, it records the visits whose
    inputs changed. Returns (B, cost, ms_B, ms_cost, stats) as
    `ils_encode_streamed_reference`, stats always."""
    n, m, h = unaries.shape
    rounds, npert = orders.shape[0], pert_codes.shape[2]
    dev = unaries.device
    rows = torch.arange(n, device=dev)
    best = B0.long().clone()
    best_cost = cost(best)
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
        need = torch.ones((n, m), dtype=torch.bool, device=dev)
        for s, j in enumerate(orders[r].tolist() * icmiter):
            new = torch.argmin(scores(cur, j), dim=1)
            if need_out is not None:
                need_out[r, s] = need[:, j]
                need = need | (new != cur[:, j])[:, None]
                need[:, j] = False
            cur[:, j] = new
        newcost = cost(cur)
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
    return best.int(), best_cost, msb, msc, stats.to(dev)


def _k1_functions(unaries, binaries, xsq):
    """K1's visit scores and cost on the table rounded as the TPU kernel
    rounds it: (scores(cur, j), cost(B))."""
    hi, lo = split_hi_lo(binaries)
    bint = binaries_to_j_stacked(hi).float()
    hif, lof = hi.float(), lo.float()
    return (lambda cur, j: _visit_scores(unaries, bint, cur, j),
            lambda B: mrf_cost_hi_lo(xsq, unaries, hif, lof, B))


def _check_milestones(milestones, rounds: int) -> tuple:
    """K1's milestones as a tuple; raises unless they are strictly
    increasing rounds in [1, rounds] (the TPU wrapper asserts the same,
    icm_pallas.py:690-692). Each must be a round the encode reaches: K1
    writes a snapshot only there, and its outputs are `torch.empty`."""
    milestones = tuple(int(r) for r in milestones)
    if milestones and (tuple(sorted(set(milestones))) != milestones
                       or milestones[0] < 1 or milestones[-1] > rounds):
        raise ValueError(f"milestones must be strictly increasing rounds in "
                         f"[1, {rounds}], got {milestones}")
    return milestones


def ils_encode_streamed_reference(unaries, binaries, xsq, B0, orders,
                                  pert_keys, pert_codes, *, icmiter: int,
                                  milestones=(), with_stats: bool = False):
    """Plain PyTorch version of the K1 kernel: the TPU kernel's function
    (`fused_ils_encode`), in the CUDA kernel's summation order.

    The table is split once into hi = bf16(binaries) and its bf16 residual
    lo (`split_hi_lo`). A visit to codebook j scores the candidates c as the
    sum over k != j, in k order from 0, of hi[k, j][B_k, c] widened exactly
    to f32, plus the unary (`_visit_scores`; icm_pallas.py:441-451), and
    takes the lowest c on ties. A round accepts where its cost
    (`mrf_cost_hi_lo`, the TPU kernel's `_mrf_cost`) is strictly lower;
    the costs returned are these in-flight costs.

    Args:
      unaries [n, m, h] f32, binaries [m, m, h, h] f32, xsq [n] f32,
      B0 [n, m] int, orders [rounds, m] int (visit order per round),
      pert_keys [rounds, n, m] f32, pert_codes [rounds, n, npert] int.
      milestones: 1-based rounds after which to snapshot the best codes,
      strictly increasing in [1, rounds] (else ValueError).

    Returns (B [n, m] int32, cost [n] f32, ms_B [n_ms, n, m] int32 | None,
    ms_cost [n_ms, n] f32 | None, stats [rounds, 2] f32 | None), where
    stats counts the rows whose proposal was better / equal each round.
    """
    milestones = _check_milestones(milestones, orders.shape[0])
    scores, cost = _k1_functions(unaries, binaries, xsq)
    out = _ils_loop(unaries, xsq, B0, orders, pert_keys, pert_codes, icmiter, scores,
                    cost, milestones)
    return out if with_stats else out[:4] + (None,)


def ils_visits_needed(unaries, binaries, xsq, B0, orders, pert_keys, pert_codes, *,
                      icmiter: int) -> torch.Tensor:
    """The row-visits of K1's encode whose inputs changed: bool
    [rounds, icmiter * m, n], visit s of round r being codebook
    orders[r, s % m].

    Same inputs as `ils_encode_streamed_reference`, whose loop this replays
    (every visit done, in plain PyTorch on the inputs' device). A visit to j
    reads every code but j's own, so it is needed when it is j's first in
    its round (the perturbation precedes it) or when another code changed
    since j's last visit; K1 skips the others, whose scores are the same
    floats as at j's last visit and whose argmin is the code j holds. The
    sum is the number of visits K1 does on these inputs.
    """
    n, m, h = unaries.shape
    out = torch.zeros((orders.shape[0], icmiter * m, n), dtype=torch.bool,
                      device=unaries.device)
    scores, cost = _k1_functions(unaries, binaries, xsq)
    _ils_loop(unaries, xsq, B0, orders, pert_keys, pert_codes, icmiter, scores, cost,
              need_out=out)
    return out


def _ils_launch(what, unaries, binaries, xsq, B0, orders, pert_keys, pert_codes, icmiter,
                milestones, with_stats):
    """Check K1's inputs on the card and launch it on the table's bf16 hi/lo
    split (`split_hi_lo`, made here once). Returns (the results, as
    `ils_encode_streamed_reference` gives them, and whether it launched:
    not for n == 0)."""
    dev = unaries.device
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
                f"{what}: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if not 1 <= m <= 32 or not 0 <= npert <= m:
        raise ValueError(f"{what}: needs 1 <= m <= 32 and "
                         f"0 <= npert <= m, got m={m}, npert={npert}")
    lib = _build.load("ils_encode")
    if lib.lsq_ils_smem_bytes(m, h) > _SMEM_LIMIT or h > lib.lsq_ils_max_h():
        raise ValueError(f"{what}: m={m}, h={h} needs more "
                         "shared memory or registers than the kernel has")
    milestones = _check_milestones(milestones, rounds)
    n_ms = len(milestones)
    out_b = torch.empty((n, m), dtype=torch.int32, device=dev)
    out_cost = torch.empty((n,), dtype=torch.float32, device=dev)
    ms_b = torch.empty((n_ms, n, m), dtype=torch.int32, device=dev)
    ms_cost = torch.empty((n_ms, n), dtype=torch.float32, device=dev)
    stats = (torch.zeros((rounds, 2), dtype=torch.int32, device=dev)
             if with_stats else None)
    ms_rounds = torch.tensor([r - 1 for r in milestones], dtype=torch.int32,
                             device=dev)
    if n:
        table, lo = split_hi_lo(binaries)
        lib.lsq_ils_encode(_ptr(unaries), _ptr(table), _ptr(lo), _ptr(xsq), _ptr(B0),
                           _ptr(orders), _ptr(pert_keys), _ptr(pert_codes), _ptr(ms_rounds),
                           n, m, h, rounds, icmiter, npert, n_ms,
                           _ptr(out_b), _ptr(out_cost), _ptr(ms_b), _ptr(ms_cost), _ptr(stats),
                           torch.cuda.current_stream(dev).cuda_stream,
                           what=f"{what} kernel launch")
    return (out_b, out_cost, ms_b if n_ms else None, ms_cost if n_ms else None,
            stats.float() if with_stats else None), n > 0


def ils_encode_streamed(unaries, binaries, xsq, B0, orders, pert_keys,
                        pert_codes, *, icmiter: int, milestones=(),
                        with_stats: bool = False):
    """K1: the whole ILS encode, one kernel launch for a CUDA tensor.

    Same arguments and results as `ils_encode_streamed_reference`, which
    CPU tensors get; the f32 table is split into bf16 hi/lo here, once.
    Counts its launches as "ils_encode".
    """
    dev = unaries.device
    if dev.type == "cpu":
        return ils_encode_streamed_reference(
            unaries, binaries, xsq, B0, orders, pert_keys, pert_codes,
            icmiter=icmiter, milestones=milestones, with_stats=with_stats)
    if dev.type != "cuda":
        raise ValueError(f"ils_encode_streamed: unsupported device {dev}")
    out, launched = _ils_launch("ils_encode_streamed", unaries, binaries, xsq, B0, orders,
                                pert_keys, pert_codes, icmiter, milestones, with_stats)
    launch_counts.COUNTS["ils_encode"] += launched
    return out


def binaries_to_j_stacked(binaries: torch.Tensor) -> torch.Tensor:
    """[m, m, h, h] -> [m, m*h, h] with the (j, j) blocks zeroed:
    bint[j][k*h + a, c] = binaries[k, j][a, c] (icm_pallas.py:809-815)."""
    m, _, h, _ = binaries.shape
    mask = (1 - torch.eye(m, dtype=binaries.dtype, device=binaries.device))
    return (binaries.transpose(0, 1) * mask[:, :, None, None]).reshape(m, m * h, h)


_VARIANTS = ("v2", "v1")


def _sweeps_library(name: str, B, unaries, table, table_shape, order):
    """Check the inputs of a sweeps kernel on the card (B and order int32,
    unaries f32, the table bf16 of `table_shape`, all contiguous on the
    unaries' device, 1 <= m <= 32) and load the library; raises where the
    kernels do not hold (m, h)."""
    dev = unaries.device
    n, m = B.shape
    h = unaries.shape[2]
    want = {
        "B": (B, torch.int32, (n, m)),
        "unaries": (unaries, torch.float32, (n, m, h)),
        "table": (table, torch.bfloat16, table_shape),
        "order": (order, torch.int32, (m,)),
    }
    for what, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous {dtype} "
                f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if not 1 <= m <= 32:
        raise ValueError(f"{name}: needs 1 <= m <= 32, got m={m}")
    lib = _build.load("icm_sweeps")
    if lib.lsq_icm_smem_bytes(m, h) > 227 * 1024 or h > lib.lsq_icm_max_h():
        raise ValueError(f"{name}: m={m}, h={h} needs more shared memory or "
                         "registers than the kernel has")
    return lib


def fused_icm_sweeps_reference(B, unaries, binaries_bf16, order, *, icmiter: int,
                               variant: str = "v2") -> torch.Tensor:
    """Plain PyTorch version of K5 ("v2") and K6 ("v1"), in each TPU kernel's
    summation order.

    Each visit to codebook j (in `order`, `icmiter` times over) sets
    B[:, j] = argmin_c over the conditioned scores, lowest c on ties. The
    bf16 table values are widened exactly to f32. "v2" sums the pair rows
    bint[j][k*h + B_k] of the j-stacked table for k != j in k order, then
    adds the unary; "v1" starts from the unary and adds
    binaries[k, j][B_k] for k = 0..m-1, k != j.

    B [n, m] int, unaries [n, m, h] f32, binaries_bf16 [m, m, h, h] bf16,
    order [m] (a permutation). Returns new codes [n, m] int32.
    """
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be one of {_VARIANTS}, got {variant!r}")
    if variant == "v2":
        return _k5_sweeps(B, unaries, binaries_to_j_stacked(binaries_bf16), order, icmiter)
    cur = B.long().clone()
    table = binaries_bf16.float()
    for _ in range(icmiter):
        for j in [int(j) for j in torch.as_tensor(order).tolist()]:
            cur[:, j] = torch.argmin(_condition(unaries[:, j], table[:, j], cur, j), dim=1)
    return cur.to(torch.int32)


def _visit_scores(unaries, bint, cur, j):
    """K5's scores at a visit to codebook j: the pair rows bint[j][k*h + B_k]
    of the j-stacked f32 table summed for k != j in k order, then the unary."""
    n, m = cur.shape
    h = unaries.shape[2]
    cond = torch.zeros((n, h), dtype=torch.float32, device=unaries.device)
    for k in range(m):
        if k != j:
            cond = cond + bint[j][k * h + cur[:, k]]
    return unaries[:, j] + cond


def _k5_sweeps(B, unaries, stacked_bf16, order, icmiter):
    """K5's plain loop on its j-stacked [m, m*h, h] bf16 table."""
    bint = stacked_bf16.float()
    cur = B.long().clone()
    for _ in range(icmiter):
        for j in [int(j) for j in torch.as_tensor(order).tolist()]:
            cur[:, j] = torch.argmin(_visit_scores(unaries, bint, cur, j), dim=1)
    return cur.to(torch.int32)


def fused_icm_sweeps(B, unaries, binaries_bf16, order, *, icmiter: int,
                     variant: str = "v2") -> torch.Tensor:
    """K5 ("v2") or K6 ("v1"): `icmiter` ICM sweeps, one launch for a CUDA tensor.

    Same arguments and result as `fused_icm_sweeps_reference`, which CPU
    tensors get. On the card B and order are int32, unaries f32 and
    binaries_bf16 bf16, all contiguous. Counts its launches per variant, as
    "icm_sweeps_v2" or "icm_sweeps_v1".
    """
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be one of {_VARIANTS}, got {variant!r}")
    dev = unaries.device
    if dev.type == "cpu":
        return fused_icm_sweeps_reference(B, unaries, binaries_bf16, order,
                                          icmiter=icmiter, variant=variant)
    if dev.type != "cuda":
        raise ValueError(f"fused_icm_sweeps: unsupported device {dev}")
    n, m = B.shape
    h = unaries.shape[2]
    lib = _sweeps_library("fused_icm_sweeps", B, unaries, binaries_bf16, (m, m, h, h), order)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    visits = order.repeat(icmiter).contiguous()
    lut = binaries_to_j_stacked(binaries_bf16).contiguous() if variant == "v2" \
        else binaries_bf16
    fn = lib.lsq_icm_sweeps_v2 if variant == "v2" else lib.lsq_icm_sweeps_v1
    fn(_ptr(B), _ptr(unaries), _ptr(lut), _ptr(visits), n, m, h, icmiter * m, _ptr(out),
       torch.cuda.current_stream(dev).cuda_stream, what=f"icm_sweeps_{variant} kernel launch")
    launch_counts.COUNTS[f"icm_sweeps_{variant}"] += 1
    return out


# K7's variants, in the order of the C entry point's `variant` argument.
DISSECT_VARIANTS = launch_counts.DISSECT_VARIANTS
# The code "noargmin" writes in place of the argmin (bench_kernel_variants.py:72).
_NOARGMIN_CODE = 3


def _dissect_table(binaries_bf16: torch.Tensor) -> torch.Tensor:
    """K5's j-stacked [m, m*h, h] table: given as is, or stacked from the
    [m, m, h, h] pairwise table."""
    return binaries_bf16 if binaries_bf16.dim() == 3 else binaries_to_j_stacked(binaries_bf16)


def candidates_per_lane(h: int) -> int:
    """Candidates a lane of the sweeps kernels holds: the least of 1, 2, 4,
    ..., 32 that covers h with 32 lanes (`dispatch` of csrc/icm_sweeps.cu).
    Lane l holds the consecutive candidates l*CPL, ..., l*CPL + CPL - 1."""
    cpl = 1
    while 32 * cpl < h:
        cpl *= 2
    return cpl


def _warp_sum(lanes: torch.Tensor) -> torch.Tensor:
    """Lane 0's value after the kernel's xor-butterfly sum over 32 lanes."""
    idx = torch.arange(32, device=lanes.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def icm_sweeps_dissect_reference(B, unaries, binaries_bf16, order, *, icmiter: int,
                                 variant: str):
    """Plain PyTorch version of K7, in the kernel's summation order.

    Each variant runs K5's visits (`order`, `icmiter` times over) with a
    part taken out; only "full" and "predwrite" are encoders:

    - "full", "predwrite": K5's codes; sink 0.
    - "nowrite": the argmin of every visit, never written: codes B; sink
      the sum of the argmin codes over the visits.
    - "noargmin": the scores, then code 3 written: codes B with every
      visited column 3; sink the scores summed as the kernel sums them.
    - "mmonly": the scores alone: codes B; sink as "noargmin".

    The kernel's score sum: lane l adds its candidates c = l*CPL + t,
    t = 0..CPL-1 (c < h; CPL = `candidates_per_lane(h)`), visit by visit,
    then the 32 lane sums meet in an xor butterfly.

    B [n, m] int, unaries [n, m, h] f32, binaries_bf16 the [m, m, h, h]
    bf16 table or K5's j-stacked [m, m*h, h] one, order [m]. Returns
    (codes [n, m] int32, sink [n] f32).
    """
    if variant not in DISSECT_VARIANTS:
        raise ValueError(f"variant must be one of {DISSECT_VARIANTS}, got {variant!r}")
    n = B.shape[0]
    h = unaries.shape[2]
    dev = unaries.device
    sink = torch.zeros(n, dtype=torch.float32, device=dev)
    if variant in ("full", "predwrite"):
        return _k5_sweeps(B, unaries, _dissect_table(binaries_bf16), order, icmiter), sink
    bint = _dissect_table(binaries_bf16).float()
    cur = B.long().clone()
    lanes = torch.zeros((n, 32), dtype=torch.float32, device=dev)
    cpl = candidates_per_lane(h)
    lane_ids = torch.arange(32, device=dev)
    for _ in range(icmiter):
        for j in [int(j) for j in torch.as_tensor(order).tolist()]:
            scores = _visit_scores(unaries, bint, cur, j)
            if variant == "nowrite":
                sink = sink + torch.argmin(scores, dim=1).float()
                continue
            for t in range(cpl):
                live = lane_ids[lane_ids * cpl + t < h]
                lanes[:, live] = lanes[:, live] + scores[:, live * cpl + t]
            if variant == "noargmin":
                cur[:, j] = _NOARGMIN_CODE
    if variant in ("noargmin", "mmonly"):
        sink = _warp_sum(lanes)
    return cur.to(torch.int32), sink


def icm_sweeps_dissect(B, unaries, binaries_bf16, order, *, icmiter: int, variant: str):
    """K7: one variant of K5's dissected visit, one launch for a CUDA tensor.

    Same arguments and results as `icm_sweeps_dissect_reference`, which CPU
    tensors get. On the card B and order are int32, unaries f32 and the
    table bf16, all contiguous; a table given j-stacked ([m, m*h, h]) is
    used as it is, so a caller that times the kernel stacks it once. Counts
    its launches per variant, as "dissect.<variant>".
    """
    if variant not in DISSECT_VARIANTS:
        raise ValueError(f"variant must be one of {DISSECT_VARIANTS}, got {variant!r}")
    dev = unaries.device
    if dev.type == "cpu":
        return icm_sweeps_dissect_reference(B, unaries, binaries_bf16, order,
                                            icmiter=icmiter, variant=variant)
    if dev.type != "cuda":
        raise ValueError(f"icm_sweeps_dissect: unsupported device {dev}")
    n, m = B.shape
    h = unaries.shape[2]
    lut = _dissect_table(binaries_bf16)
    lib = _sweeps_library("icm_sweeps_dissect", B, unaries, lut, (m, m * h, h), order)
    if h <= _NOARGMIN_CODE:
        raise ValueError(f"icm_sweeps_dissect: needs h > {_NOARGMIN_CODE}, got h={h}")
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    sink = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out, sink
    visits = order.repeat(icmiter).contiguous()
    lib.lsq_icm_sweeps_dissect(
        DISSECT_VARIANTS.index(variant), _ptr(B), _ptr(unaries), _ptr(lut), _ptr(visits),
        n, m, h, icmiter * m, _ptr(out), _ptr(sink), torch.cuda.current_stream(dev).cuda_stream,
        what=f"icm_sweeps_dissect {variant} kernel launch")
    launch_counts.COUNTS[f"dissect.{variant}"] += 1
    return out, sink
