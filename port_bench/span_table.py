#!/usr/bin/env python3
"""Where a cell's traced window goes, by annotation.

    python3 port_bench/span_table.py --workload joint.serve --seed 7 --seconds 5

Runs one cell as ``run.py --trace 1`` does (the same set-up, measured
window, traced window and check) and summarises the traced window's events
by annotation as well (``harness/spans.py``): the program's spans, the
benchmark's ``bench.*`` and torch's ``Optimizer.*``, each with its host
time, the device time it launched, the idle time while it was open and the
idle time it is the innermost annotation over, and the kernel launches and
host waits that started while it was open. Prints one JSON line: the run's
``correct``, per-layer ``metrics`` and ``device``, the traced window's
``steps``, ``host_window_s``, ``window_s``, ``busy_s`` and ``idle_s``, the
sum of every annotation's ``self_idle_s``, the ``readings`` that the spans
give by time (:func:`readings`) and the ``spans``. On a card only, as
``run.py``; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402  the benchmark's environment: its caches, one host thread


def readings(t: Dict) -> Dict[str, Optional[float]]:
    """Shares and counts per unit of work (a step or a call) from the span
    summary, each None where its span is absent."""
    s, steps = t["spans"], t["steps"]

    def per_unit(names, key):
        got = [s[n][key] for n in names if n in s]
        return sum(got) / steps if got else None

    def share(name, key, total):
        return 100.0 * s[name][key] / total if name in s and total else None

    return {
        "sampler_idle.train": share("train.sample", "idle_s", t["window_s"]),
        "host_syncs.train": per_unit(("train.sample", "train.step"), "syncs"),
        "rir_share.otf": share("synth.rir", "device_s", t["busy_s"]),
        "closure_idle.serve": share("serve.call", "idle_s", t["window_s"]),
        "host_syncs.serve": per_unit(("serve.call",), "syncs"),
        "launches.serve": per_unit(("serve.call",), "launches"),
    }


def table(bench: dict, cell: str, seed: int, seconds: float, device, t_start: float,
          overrides: Optional[dict] = None) -> Dict:
    """One traced run of ``cell`` with the span summary of its traced
    window."""
    from harness import cell as cells, spans, trace

    kept: Dict = {}
    plain_summarise, plain_window = trace.summarise, cells.traced_window

    def summarise(events):
        out = plain_summarise(events)
        out["spans"] = spans.summarise(events)
        return out

    def traced_window(*args, **kwargs):
        kept.update(plain_window(*args, **kwargs))
        return kept

    trace.summarise, cells.traced_window = summarise, traced_window
    try:
        out = cells.run_cell(bench, cell, seed, seconds, True, device, t_start, overrides=overrides)
    finally:
        trace.summarise, cells.traced_window = plain_summarise, plain_window
    return {
        "workload": cell, "seed": seed, "correct": out["correct"], "metrics": out["metrics"], "device": out["device"],
        "steps": kept["steps"], "host_window_s": kept["host_window_s"], "window_s": kept["window_s"],
        "busy_s": kept["busy_s"], "idle_s": kept["window_s"] - kept["busy_s"],
        "self_idle_sum_s": sum(v["self_idle_s"] for v in kept["spans"].values()),
        "readings": readings(kept), "spans": kept["spans"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0, help="length of the measured window before the traced one")
    args = p.parse_args(argv)
    from harness.cell import load_benchmark, setup_start

    t_start = setup_start()
    import torch

    if not torch.cuda.is_available():
        print("no card: the span table is read on the card only", file=sys.stderr)
        return 2
    out = table(load_benchmark(), args.workload, args.seed, args.seconds, torch.device("cuda", 0), t_start)
    for name, v in sorted(out["spans"].items(), key=lambda kv: -kv[1]["idle_s"]):
        print(f"span {name} {json.dumps(v)}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
