"""Readings that the limits of the IVF cell's `correct` are set from, with
the control of the probed route: as `controls.py`, whose runs it makes.

    python3 -m portbench.controls_ivf --workload <ivf cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 3]

The probed scan has no bfloat16 path of its own (`Index.search` refuses
`precision="bf16"` with `nprobe`), so the control rounds the index's query
tables to bfloat16, the nearest precision below the configuration's float32,
where the route makes them (`Index._query_luts`), after set-up: the scan,
the probes and the check are unchanged. Needs a CUDA card, as a run does.
"""

from __future__ import annotations

import sys

import torch

from portbench import controls


def control_on(driver) -> None:
    """The configure hook: after set-up, every table the index makes is
    rounded to bfloat16 and back to float32."""
    setup = driver.setup

    def bf16_setup():
        setup()
        idx = driver.index
        luts = idx._query_luts
        idx._query_luts = lambda Q: luts(Q).to(torch.bfloat16).to(torch.float32)

    driver.setup = bf16_setup


def main(argv=None) -> int:
    controls.control_on = control_on
    return controls.main(argv)


if __name__ == "__main__":
    sys.exit(main())
