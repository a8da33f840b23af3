"""Readings that the limits of `correct` are set from: each number compared,
on sound runs of the program over many seeds and on its control over a few.

    python3 -m portbench.controls --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 3]

A sound run is a run of the cell (`run.execute`) with a short window at the
cell's own load. The control puts the nearest precision below the
configuration's in the program's place: the program's own bfloat16 path of
the search (`Index.search(precision="bf16")`, the serve twin's
`--precision bf16`) where the cell searches, and the reference encoder in
bfloat16 in place of the program's codes where it encodes. Prints one JSON
line a run, then each number's largest sound reading and least control
reading. Needs a CUDA card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from portbench import run as runmod


def control_on(driver) -> None:
    driver.control = True


def readings(name: str, seeds, control_seeds, seconds: float, device) -> dict:
    out = {"sound": [], "control": []}
    for kind, seeds_ in (("sound", seeds), ("control", control_seeds)):
        for seed in seeds_:
            tmp = tempfile.mkdtemp(prefix="portbench-")
            try:
                run = runmod.Run(name, seed, seconds, False, device, tmp)
                res = runmod.execute(run, time.perf_counter(),
                                     configure=control_on if kind == "control" else None)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            line = {"kind": kind, "seed": seed, "numbers": res["numbers"], "e2e": res["e2e"]}
            print(json.dumps(line), flush=True)
            out[kind].append(line)
    return out


def summary(out: dict) -> dict:
    names = out["sound"][0]["numbers"] if out["sound"] else {}
    return {n: {"sound_max": max(r["numbers"][n] for r in out["sound"]),
                "control_min": min((r["numbers"][n] for r in out["control"]), default=None)}
            for n in names}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = readings(args.workload, seeds, cseeds, args.seconds, torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "summary": summary(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
