"""Readings that the limits of the refine cell's `correct` are set from, with
the control of the re-rank: as `controls.py`, whose runs it makes.

    python3 -m portbench.controls_refine --workload <refine cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 3]

The configuration re-ranks in float32. The control puts the nearest
precision below it in the re-rank's place for the window: the candidates'
rows decoded to bfloat16, the query rounded to bfloat16, and their squared
L2 measured in bfloat16 (`rerank_bf16`); the first stage, the store and the
check are unchanged. Needs a CUDA card, as a run does.
"""

from __future__ import annotations

import sys

import torch

from portbench import controls


def rerank_bf16(store, Q, cand_ids, k: int, *, query_chunk: int = 256):
    """`refine.rerank` with the decode, the difference and the squared sum
    in bfloat16."""
    from local_search_quantization_torch.ops.adc import KNNResult
    from local_search_quantization_torch.ops.select_kernels import lex_topk

    dev = store.data.device
    Q = torch.as_tensor(Q).to(dev, torch.bfloat16)
    cand_ids = torch.as_tensor(cand_ids).to(dev, torch.int64)
    out_d, out_i = [], []
    for s in range(0, Q.shape[0], query_chunk):
        cq = cand_ids[s:s + query_chunk]
        dv = store.decode(cq.clamp(min=0)).to(torch.bfloat16) - Q[s:s + query_chunk, None, :]
        dd, ii = lex_topk((dv * dv).sum(dim=-1).float(), cq, k)
        out_d.append(dd)
        out_i.append(ii)
    return KNNResult(torch.cat(out_d), torch.cat(out_i))


def control_on(driver) -> None:
    """The configure hook: the window re-ranks through `rerank_bf16`."""
    from local_search_quantization_torch import refine

    window = driver.window

    def bf16_window(seconds):
        real = refine.rerank
        refine.rerank = rerank_bf16
        try:
            window(seconds)
        finally:
            refine.rerank = real

    driver.window = bf16_window


def main(argv=None) -> int:
    controls.control_on = control_on
    return controls.main(argv)


if __name__ == "__main__":
    sys.exit(main())
