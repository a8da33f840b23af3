"""The comparison that decides `correct`: each number the reference reads of
what the timed path produced, held to its limit in the cell's workload file.

Numbers (each a largest reading; lower is better):

- `bad_ids`: answered rows with an id out of range, repeated, or without a
  finite distance. An exact comparison: limit 0.
- `rank_gap`: by how much an answered row's distance lies above the
  reference's at the same rank, as a share of the query's summand magnitude
  (`reference.adc.judge`).
- `dist_gap`: by how much an answered distance lies outside the answered
  row's true distance, likewise.
- `enc_excess`: the squared reconstruction error of the program's codes of a
  sample of rows, over that of the reference encoder's codes of the same
  rows with the same codebooks, less 1 (`reference.ils`).
- `failed`: requests or calls that raised or never came back. Limit 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.common import stream_seed
from portbench.reference import adc, ils


def answers(state: dict, Q, ids, dists, k: int, device) -> dict:
    """`bad_ids`, `rank_gap` and `dist_gap` of answers (ids, dists) [s, k] to
    queries Q [s, d] over the index whose state (`deploy.index_state`) the
    reference reads."""
    searcher = adc.Searcher(state["B"], state["C"], state["cbnorms"], device)
    return adc.judge(searcher, Q, ids, dists, k)


def codes(X: torch.Tensor, B, C, ilsiter: int, seed: int, device,
          dtype=torch.float64) -> dict:
    """`enc_excess` of the program's codes B [s, m] of rows X [s, d]; the
    reference encodes X in `dtype` (its control: bfloat16)."""
    X = X.to(device)
    gen = torch.Generator(device=X.device).manual_seed(stream_seed(seed, "reference-ils"))
    ref = ils.encode(X, C, gen, ilsiter=ilsiter, dtype=dtype)
    prog = ils.sq_error(X, C, torch.as_tensor(np.asarray(B)).to(X.device))
    return {"enc_excess": float(prog.sum() / ils.sq_error(X, C, ref).sum()) - 1.0}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, one line a number: its name, value and limit). A number
    without a limit, or a NaN, fails."""
    ok, lines = True, []
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and not (isinstance(value, float) and math.isnan(value))
                and value <= limit)
        ok = ok and good
        lines.append(f"{name} {value!r} limit {limit!r} {'ok' if good else 'FAIL'}")
    return ok, lines
