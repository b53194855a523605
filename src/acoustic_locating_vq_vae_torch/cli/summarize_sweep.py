"""Summarize `eval_t60_sweep` output into compact markdown tables.

Reads one or more log/transcript files (or stdin) containing per-cell lines of
the form ``t60=0.4,R=1: {json}`` / ``t60=0.4,snr=10dB: {json}`` — exactly what
`eval_t60_sweep.py` (and the committed protocols `eval_runK.sh` /
`run_ab_levers.sh`) print — and renders one markdown table per metric with
T60 rows and R/SNR columns. Used to transcribe held-out grid evals into
VALIDATION.md without hand-copying numbers. The port's own copy of the JAX
package's ``scripts/summarize_sweep.py`` (no JAX in it), with ``main(argv)``;
``cli.eval_t60_sweep`` prints the same lines.

The reference has no counterpart (its evaluation is matplotlib plots +
raw MSE prints, the reference's scripts/train_location.py:98-116).

Usage:
    python -m acoustic_locating_vq_vae_torch.cli.summarize_sweep stores/runK_eval.log
    python -m acoustic_locating_vq_vae_torch.cli.summarize_sweep --metrics median_abs_radians \
        frac_err_gt_0.1rad rmse_coordinates_m -- stores/runK_eval.log
"""

from __future__ import annotations

import argparse
import json
import re
import sys

__all__ = ["main", "parse_cells", "render"]

CELL_RE = re.compile(
    r"^t60=(?P<t60>[0-9.]+)"
    r"(?:,R=(?P<radius>[0-9.]+))?"
    r"(?:,snr=(?P<snr>-?[0-9.]+)dB)?"
    r":\s*(?P<json>\{.*\})\s*$"
)

DEFAULT_METRICS = [
    "median_abs_radians",
    "frac_err_gt_0.1rad",
    "rmse_coordinates_m",
    "median_abs_radius_m",
]


def parse_cells(lines):
    """Yield (t60, col_label, metrics_dict) for every grid-cell line."""
    for line in lines:
        m = CELL_RE.match(line.strip())
        if not m:
            continue
        col = (
            f"snr={m.group('snr')}dB" if m.group("snr") is not None
            else f"R={m.group('radius')}" if m.group("radius") is not None
            else "—"
        )
        yield m.group("t60"), col, json.loads(m.group("json"))


def fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}" if abs(v) >= 0.01 or v == 0 else f"{v:.2e}"
    return str(v)


def render(cells, metrics) -> str:
    out = []
    for metric in metrics:
        rows: dict[str, dict[str, str]] = {}
        cols: list[str] = []
        for t60, col, data in cells:
            if metric not in data:
                continue
            rows.setdefault(t60, {})[col] = fmt(data[metric])
            if col not in cols:
                cols.append(col)
        if not rows:
            continue
        out.append(f"**{metric}**\n")
        out.append("| T60 | " + " | ".join(cols) + " |")
        out.append("|" + "---|" * (len(cols) + 1))
        for t60 in sorted(rows, key=float):
            out.append(
                f"| {t60} | "
                + " | ".join(rows[t60].get(c, "—") for c in cols)
                + " |"
            )
        out.append("")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="*", help="log files (default: stdin)")
    ap.add_argument("--metrics", nargs="+", default=DEFAULT_METRICS)
    args = ap.parse_args(argv)

    cells = []
    if args.logs:
        for path in args.logs:
            with open(path) as f:
                cells.extend(parse_cells(f))
    else:
        cells.extend(parse_cells(sys.stdin))
    if not cells:
        sys.exit("no grid-cell lines found (expected 't60=...: {json}')")
    print(render(cells, args.metrics))


if __name__ == "__main__":
    main()
