#!/usr/bin/env python3
"""Read the numbers that set a cell's correctness limits, on the card.

    python3 port_bench/control.py --workload joint.serve --seeds 11,12,13 --control-seeds 11,12,13 \
        --faults altered_answer --fault-seeds 11,12,13 --out build/control.jsonl

For each seed of ``--seeds`` the program's numbers (a sound run: set-up, the
first steps or the compared calls, a window of ``--seconds`` (default none)
and what follows it, the float64 reference),
with the control's beside them on ``--control-seeds`` (the reference in
float32 with TF32 on in the program's place); for each fault of
``--faults`` and each seed of ``--fault-seeds`` the numbers of the program
with that fault planted (each loop under ``loops/`` names the faults it
plants). One JSON line each, to ``--out`` and standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _ints(s: str):
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=0.0, help="a window before the step after it")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from harness.cell import load_benchmark, run_cell

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = load_benchmark()
    jobs = [(s, None, s in args.control_seeds) for s in args.seeds]
    jobs += [(s, f, False) for f in args.faults.split(",") if f for s in args.fault_seeds]
    with open(args.out, "a") as f:
        for seed, fault, control in jobs:
            t = time.perf_counter()
            out = run_cell(bench, args.workload, seed, args.seconds, False, dev, t, fault=fault,
                           window=args.seconds > 0, control=control)
            line = {"workload": args.workload, "seed": seed, "fault": fault, "numbers": out["_numbers"],
                    "control": out.get("_control"), "seconds": time.perf_counter() - t,
                    "card": out["device"]["kind"], "power_limit": out["_notes"]["power_limit"]}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
