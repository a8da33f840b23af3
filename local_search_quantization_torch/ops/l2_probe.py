"""The L2 gather probe (`csrc/l2_probe.cu`): the rate at which the card serves
random rows of a table that stays in L2.

A measurement tool, not a port of a TPU kernel: K1, K5 and K6 are bound by
the table rows they gather from L2, and this probe measures that rate alone,
so their gathered bytes over it give each a practical bound in time. It is
on no path. `l2_gather` launches the kernel for a CUDA table and runs its
plain version, `l2_gather_reference`, for a CPU one; `l2_gather_rate` times
it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from local_search_quantization_torch import _build
from local_search_quantization_torch.ops import launch_counts

# The kernel's launch shape: 8 warps a block, 4 rows a warp step.
WARPS_PER_BLOCK, ROWS_PER_STEP = 8, 4


def rows_of(seed: int, warps: int, rows_per_warp: int, nrows: int) -> np.ndarray:
    """[warps, rows_per_warp] rows the kernel gathers: murmur3's finalizer
    of (seed ^ counter), counter = warp * rows_per_warp + i (mod 2^32),
    scaled to [0, nrows) by the high half of a 32 x 32-bit product."""
    c = np.arange(warps * rows_per_warp, dtype=np.uint64) & 0xFFFFFFFF
    x = (c ^ np.uint64(seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return ((x * np.uint64(nrows)) >> 32).astype(np.int64).reshape(warps, rows_per_warp)


def l2_gather_reference(table: torch.Tensor, *, warps: int, rows_per_warp: int,
                        seed: int = 0) -> torch.Tensor:
    """Plain version: [warps] f32, each warp's sum of its rows (in another
    order than the kernel's; exact for integer tables)."""
    rows = torch.as_tensor(rows_of(seed, warps, rows_per_warp, table.shape[0]),
                           device=table.device)
    return table.float()[rows].sum(dim=(1, 2))


def l2_gather(table: torch.Tensor, *, warps: int, rows_per_warp: int, wide: bool,
              seed: int = 0) -> torch.Tensor:
    """Gather `rows_per_warp` hashed rows a warp from `table` ([nrows,
    row_elems] bf16 or f32, rows of a multiple of 16 bytes) and sum them:
    [warps] f32. `wide` loads 16 bytes a lane, else one element a lane as
    K1, K5 and K6 do. CPU tables take the plain version; counts its launches
    as "l2_gather" in `launch_counts`."""
    dev = table.device
    if dev.type == "cpu":
        return l2_gather_reference(table, warps=warps, rows_per_warp=rows_per_warp,
                                   seed=seed)
    if dev.type != "cuda":
        raise ValueError(f"l2_gather: unsupported device {dev}")
    if table.dtype not in (torch.bfloat16, torch.float32) or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(f"l2_gather: table must be a contiguous 2-D bf16 or f32 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    nrows, row_elems = table.shape
    esize = table.element_size()
    if (row_elems * esize) % 16 or table.data_ptr() % 16:
        raise ValueError("l2_gather: rows must be 16-byte aligned multiples of 16 bytes")
    if warps % WARPS_PER_BLOCK or rows_per_warp % ROWS_PER_STEP or warps <= 0:
        raise ValueError(f"l2_gather: warps must be a positive multiple of "
                         f"{WARPS_PER_BLOCK} and rows_per_warp of {ROWS_PER_STEP}")
    out = torch.empty((warps,), dtype=torch.float32, device=dev)
    _build.load("l2_probe").lsq_l2_gather(
        table.data_ptr(), esize, int(wide), nrows, row_elems, warps, rows_per_warp,
        seed & 0xFFFFFFFF, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        what="l2_gather kernel launch")
    launch_counts.COUNTS["l2_gather"] += 1
    return out


def l2_gather_rate(row_bytes: int, table_bytes: int, dtype: torch.dtype, *, wide: bool,
                   device="cuda", warps: int = 132 * 64, rows_per_warp: int = 256,
                   reps: int = 20) -> dict:
    """Time the probe on a resident table of `table_bytes` bytes in rows of
    `row_bytes` and return {"gbps", "ms", "bytes"}: the bytes gathered a
    launch over its mean time (CUDA events, after a warm-up that also loads
    the table into L2). Needs a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("l2_gather_rate measures the card: give a CUDA device")
    esize = torch.tensor([], dtype=dtype).element_size()
    nrows = table_bytes // row_bytes
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-2, 3, (nrows, row_bytes // esize), generator=gen,
                          device=dev).to(dtype)

    def run():
        return l2_gather(table, warps=warps, rows_per_warp=rows_per_warp, wide=wide)

    run()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    nbytes = warps * rows_per_warp * row_bytes
    return {"gbps": nbytes / ms / 1e6, "ms": ms, "bytes": nbytes}
