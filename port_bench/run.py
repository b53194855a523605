#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 port_bench/run.py --workload echoed.train --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``). It makes every input and the weights from ``--seed``
on the card, loads, warms up, runs the cell's traffic for ``--seconds``
seconds, checks what the timed path produced against the plain reference
(``port_bench/reference/``), and prints the result as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, the
shares from a traced window after the measured one), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared beside
its limit, which also end standard error. Earlier lines of standard error
give the set-up's parts, the window's steps, the card's clock, power and
temperature before and after the window, and its power limit. Exits
non-zero, printing no result, without the cards the cell asks for, or if
JAX or the JAX package was loaded.

The program's build and kernel caches live in fixed directories inside the
checkout: the port builds its kernels into ``build/kernels/``; Triton's,
torch's extension and CUDA's JIT caches are pointed at
``build/port_bench_cache/``. Torch's host work runs on one thread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "port_bench_cache" / _sub)
# one host thread for torch's CPU work: the step's host side is one Python thread launching kernels
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(BENCH))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="inputs and weights come from it")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: report the per-layer metrics")
    return p.parse_args(argv)


def emit(out: dict) -> None:
    """The run's notes, then the checks, as the last lines of standard
    error; the result as the last line of standard output."""
    notes = out.get("_notes", {})
    for name, at in notes.get("setup_phases_s", {}).items():
        print(f"setup {name} done at {at:.3f} s", file=sys.stderr)
    if notes:
        print(f"window {notes['steps']} steps in {notes['window_s']!r} s; kernels built {notes['kernels_built']}; "
              f"trace read {notes['trace_read_s']!r} s", file=sys.stderr)
        print(f"card before {notes['card_before']} after {notes['card_after']}", file=sys.stderr)
        for name, gaps in out.get("breakdown", {}).items():
            print(f"trace {name} {json.dumps(gaps)}", file=sys.stderr)
        for name, m in out["metrics"].items():
            print(f"metric {name} {m['value']!r} {m['unit']} (power limit {notes['power_limit']})", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {k: v for k, v in out.items() if not k.startswith("_")}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    from harness.cell import forbidden_modules, load_benchmark, run_cell, setup_start

    t_start = setup_start()
    args = parse(argv)
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no card: cuda available {torch.cuda.is_available()}, {torch.cuda.device_count()} of {chips} "
              "device(s); the benchmark measures only on the card", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that the port must not load were loaded: {bad}", file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
